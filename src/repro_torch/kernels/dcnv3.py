"""The DCNv3 core of InternImage (arXiv:2211.05778) with bounded offsets:
each group's channels sampled bilinearly at the K*K taps moved by their
offsets, clamped to ±B, and summed with the softmax of the group's mask
logits as weights (``models.internimage``; ``ops.dcnv3`` is the entry
point).

It replaces no TPU kernel (the JAX package has no DCNv3).  On a CUDA
tensor (fp32) ``dcnv3`` launches ``dv3_kernel`` of ``csrc/dcnv3.cu``; on a
CPU tensor it runs ``dcnv3_plain``, the same arithmetic in the same
order, tap by tap and corner by corner.  There is no fallback from one
to the other: a failed build or launch raises.

Layouts follow ``dcnv3_core_pytorch`` of the official code: v (N, H, W,
C) with G groups of C/G channels; offsets (N, H, W, G*K*K*2), (dx, dy) a
tap; mask logits (N, H, W, G*K*K); the taps run x outer, y inner (tap t
= ix*K + iy samples column x - K//2 + ix and row y - K//2 + iy); stride
1, samples outside the image read zero.  The output is (N, H, W, C).

The kernel stages each output tile's bounded window of v from the input
itself, zero-filled outside the image, where the zero-copy DCL kernels
read a padded copy (``plan.pad_zerocopy``): a DCNv3 layer's input is
written once and read once.  A call's checks and the kernel's plan are
worked out once per shape and kept (``_plan_for``).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

Tensor = torch.Tensor

# Output tile (rows, columns) and groups a block: 15 x 15 positions of 32
# channels staged for 8 x 8 pixels of two 16-channel groups, 52 KB of
# shared memory, four blocks an SM.
TILE_H, TILE_W, GROUP_BLOCK = 8, 8, 2


def load_kernel():
    """Build (first time only) and load the kernel's library."""
    from repro_torch.kernels import _build
    return _build.load("dcnv3")


class _Dv3Plan(ctypes.Structure):
    """``Dv3Plan`` of ``csrc/dcnv3.cu``: the call's shapes and tiles,
    completed by ``dv3_plan``."""
    _fields_ = ([(f, ctypes.c_int) for f in
                 ("n", "h", "w", "c", "groups", "k", "hb")]
                + [("bound", ctypes.c_float)]
                + [(f, ctypes.c_int) for f in
                   ("th", "tw", "gpb", "gc", "band_h", "band_w", "h_tiles",
                    "w_tiles", "chunks", "smem")])


class _Call(NamedTuple):
    plan: _Dv3Plan
    address: int


def tiles(h: int, w: int, groups: int) -> tuple[int, int, int]:
    """The kernel's output tile and groups a block at an (h, w) image of
    ``groups`` groups."""
    return min(TILE_H, h), min(TILE_W, w), min(GROUP_BLOCK, groups)


def check_shapes(v: Tensor, offsets: Tensor, mask_logits: Tensor, *,
                 groups: int, kernel_size: int) -> None:
    """Raise unless the operands have the layouts of the module
    docstring, at the 3x3 kernel InternImage publishes for every size
    (the one the kernel takes)."""
    if kernel_size != 3:
        raise ValueError(f"the DCNv3 op takes kernel_size 3 (got "
                         f"{kernel_size})")
    if v.dim() != 4 or v.shape[-1] % groups:
        raise ValueError(f"v must be (N, H, W, C) with C a multiple of "
                         f"groups={groups} (got {tuple(v.shape)})")
    k2 = kernel_size * kernel_size
    lead = tuple(v.shape[:3])
    for name, t, width in (("offsets", offsets, groups * k2 * 2),
                           ("mask_logits", mask_logits, groups * k2)):
        if tuple(t.shape) != lead + (width,):
            raise ValueError(f"{name} must be {lead + (width,)} for v "
                             f"{tuple(v.shape)}, {groups} groups and K="
                             f"{kernel_size} (got {tuple(t.shape)})")


def dcnv3_plain(v: Tensor, offsets: Tensor, mask_logits: Tensor, *,
                groups: int, kernel_size: int,
                offset_bound: float) -> Tensor:
    """Plain PyTorch version of the kernel, on any device: the softmax
    (summed tap by tap), then for each tap its clamped position and its
    four corners in the order 00, 01, 10, 11, each weighted by the
    bilinear weight times the softmax weight and added to the sum."""
    check_shapes(v, offsets, mask_logits, groups=groups,
                 kernel_size=kernel_size)
    n, h, w, c = v.shape
    k, gc = kernel_size, c // groups
    k2, pad = k * k, k // 2
    dev = v.device
    off = offsets.float().reshape(n, h, w, groups, k2, 2) \
        .clamp(-offset_bound, offset_bound)
    logits = mask_logits.float().reshape(n, h, w, groups, k2)
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    s = e[..., 0]
    for t in range(1, k2):
        s = s + e[..., t]
    a = e / s[..., None]
    flat = v.float().reshape(n, h * w, groups, gc)
    rows = torch.arange(n, device=dev).view(n, 1, 1, 1)
    grp = torch.arange(groups, device=dev).view(1, 1, 1, groups)
    ys = torch.arange(h, device=dev).view(1, h, 1, 1)
    xs = torch.arange(w, device=dev).view(1, 1, w, 1)
    acc = torch.zeros(n, h, w, groups, gc, device=dev)
    for t in range(k2):
        ix, iy = divmod(t, k)
        px = (xs - pad + ix).float() + off[..., t, 0]
        py = (ys - pad + iy).float() + off[..., t, 1]
        x0, y0 = torch.floor(px), torch.floor(py)
        tx, ty = px - x0, py - y0
        ux, uy = 1.0 - tx, 1.0 - ty
        at = a[..., t]
        for dy, dx, wb in ((0, 0, uy * ux), (0, 1, uy * tx),
                           (1, 0, ty * ux), (1, 1, ty * tx)):
            yc, xc = y0.long() + dy, x0.long() + dx
            inside = (yc >= 0) & (yc < h) & (xc >= 0) & (xc < w)
            idx = yc.clamp(0, h - 1) * w + xc.clamp(0, w - 1)
            wgt = torch.where(inside, at * wb, 0.0)
            acc = acc + wgt[..., None] * flat[rows, idx, grp]
    return acc.reshape(n, h, w, c).to(v.dtype)


def dcnv3(v: Tensor, offsets: Tensor, mask_logits: Tensor, *, groups: int,
          kernel_size: int, offset_bound: float) -> Tensor:
    """The DCNv3 core (module docstring): ``dcnv3_plain`` on a CPU tensor,
    the kernel on a CUDA one (fp32, contiguous, v 16-byte aligned),
    counted in ``dcnv3.launches``."""
    if v.device.type == "cpu":
        return dcnv3_plain(v, offsets, mask_logits, groups=groups,
                           kernel_size=kernel_size,
                           offset_bound=offset_bound)
    if v.device.type != "cuda":
        raise ValueError(f"no kernel for device {v.device}")
    call = _plan_for(tuple(v.shape), tuple(offsets.shape),
                     tuple(mask_logits.shape),
                     (v.dtype, offsets.dtype, mask_logits.dtype), groups,
                     kernel_size, float(offset_bound))
    dev = v.device
    ops = (v, offsets, mask_logits)
    if not all(t.is_contiguous() and t.device == dev for t in ops) \
            or v.data_ptr() % 16:
        raise ValueError(f"dcnv3: every operand must be contiguous and on "
                         f"{dev}, v 16-byte aligned")
    lib = load_kernel()
    out = torch.empty_like(v)
    err = lib.dv3_launch(v.data_ptr(), offsets.data_ptr(),
                         mask_logits.data_ptr(), out.data_ptr(),
                         call.address, dev.index,
                         torch._C._cuda_getCurrentRawStream(dev.index))
    if err:
        raise RuntimeError(f"dcnv3 kernel launch failed: "
                           f"{lib.dv3_error_string(err).decode()} ({err})")
    dcnv3.launches += 1
    return out


dcnv3.launches = 0


@functools.lru_cache(maxsize=256)
def _plan_for(v: tuple, off: tuple, msk: tuple, dtypes: tuple, groups: int,
              kernel_size: int, offset_bound: float) -> _Call:
    """The kernel's checks and plan for operands of these shapes and
    dtypes; raises on what the kernel refuses."""
    if any(d != torch.float32 for d in dtypes):
        raise ValueError(f"the DCNv3 kernel takes float32 operands (got "
                         f"{dtypes})")
    check_shapes(*(torch.empty(s, device="meta") for s in (v, off, msk)),
                 groups=groups, kernel_size=kernel_size)
    n, h, w, c = v
    th, tw, gpb = tiles(h, w, groups)
    plan = _Dv3Plan(n=n, h=h, w=w, c=c, groups=groups, k=kernel_size,
                    hb=int(math.ceil(offset_bound)), bound=offset_bound,
                    th=th, tw=tw, gpb=gpb)
    lib = load_kernel()
    err = lib.dv3_plan(ctypes.addressof(plan))
    if err:
        raise ValueError(f"the DCNv3 kernel refuses v {v}, {groups} groups, "
                         f"K={kernel_size}, B={offset_bound} at tiles "
                         f"{th}x{tw}x{gpb}: "
                         f"{lib.dv3_error_string(err).decode()}")
    return _Call(plan, ctypes.addressof(plan))


def traffic_bytes(n: int, h: int, w: int, c: int, groups: int, *,
                  kernel_size: int, offset_bound: float) -> int:
    """The bytes the kernel's blocks load and store: each block's staged
    window (neighbouring windows overlap), the offsets, the mask logits
    and y, all fp32."""
    th, tw, _ = tiles(h, w, groups)
    band = kernel_size + 2 * int(math.ceil(offset_bound))
    blocks = n * -(-h // th) * -(-w // tw)
    window = blocks * (th + band) * (tw + band) * c
    k2 = kernel_size * kernel_size
    return 4 * (window + n * h * w * (c + 3 * groups * k2))


def warm(layers: dict, *, batch: int, offset_bound: float,
         kernel_size: int = 3, device=None):
    """Each named layer's ``{"h", "w", "c", "groups"}`` planned at
    ``batch`` on ``device`` (the kernel built and its plans checked on
    CUDA): ``(tiles, sources)`` as ``plan.warm_tile_cache`` returns them,
    every source ``"analytic"``."""
    out, sources = {}, {}
    for name, d in layers.items():
        out[name] = tiles(d["h"], d["w"], d["groups"])
        sources[name] = "analytic"
        if torch.device(device or "cuda").type == "cuda":
            shape = (batch, d["h"], d["w"], d["c"])
            k2 = kernel_size * kernel_size
            _plan_for(shape, shape[:3] + (d["groups"] * k2 * 2,),
                      shape[:3] + (d["groups"] * k2,),
                      (torch.float32,) * 3, d["groups"], kernel_size,
                      float(offset_bound))
    return out, sources
