"""int8 fused DCL kernels: the quantized datapath and layer chaining.

Counterparts of ``repro.kernels.deform_conv_q``:

* ``deform_conv_fused_zerocopy_q`` — int8 band, fp32 bilinear
  coefficients, patches rounded back to int8, s8 x s8 -> s32 contraction,
  per-M dequant epilogue (``s_x * s_w[m]``), fp32 out;
* ``deform_conv_fused_zerocopy_chain`` — the same with the offset conv
  fused in (computed from the int8 input and int8 offset-conv weights)
  and a requant epilogue that emits int8 on the next layer's grid
  (``emit="int8"``), or dequant + bias in fp32 (``emit="fp32"``, the
  chain tail).

On a CUDA tensor each wrapper launches its hand-written kernel of
``csrc/deform_conv_q.cu`` and counts the launch; on a CPU tensor it runs
the plain PyTorch version beside it, which does the same band-local
arithmetic with the same fp32 roundings and exact integer sums, so the
two agree bit for bit.  A failed launch raises; there is no fallback.

Both kernels run one main body on the s8 tensor cores, which reads its
weights k-contiguous per output channel: the wrappers keep the TPU
plan's layout, ``plan.tile_weights`` (``(C // tile_c, K*K*tile_c, M)``;
the chain's ``(1, K*K*C, M)`` and ``(1, K*K*C, 2*K*K)``), and the kernel
first copies them chunk-major into a workspace.  The grid splits C into
groups where its tiles would leave the card idle (``q_plan``); the
groups' int32 partials go to a workspace and are summed before the
epilogue, so the output is the same bits whatever the grouping.  The
chain computes its offset conv's int32 sums first, into a workspace, so
its ``tile_c`` is a free chunk size (unlike the TPU kernel, which stages
all of C per band).  The workspaces are allocated here, in one
``torch.empty`` a call; a call's checks, grid and workspace layout are
worked out once per shape and kept (``_q_call``, ``_chain_call``), since
the host's launch path is most of a small call's time.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from repro_torch.core.tiling import (Q_GROUP_LEAST, Q_TILE_M, fwd_c_groups,
                                     pix_lanes, q_off_groups)
from repro_torch.kernels.band_pipeline import (BandSpec, contract_int8,
                                               offset_conv_stage,
                                               sample_tiles, tile_bands,
                                               tile_offsets, untile)

Tensor = torch.Tensor

EMITS = ("int8", "fp32")


def load_kernel():
    """Build (first time only) and load the kernels' library."""
    from repro_torch.kernels import _build
    return _build.load("deform_conv_q")


def q_plan(n: int, ho: int, wo: int, c: int, m: int, *, tile_h: int,
           tile_w: int, tile_c: int, tile_m: int) -> dict:
    """The kernels' grid for one call (``core.tiling``'s mirror of
    ``csrc/deform_conv_q.cu``): pixel lanes of the instance, output
    tiles, M tiles, the C groups the main grid splits C into and those of
    the chain's offset conv."""
    return dict(
        lanes=pix_lanes(tile_h, tile_w),
        tiles=n * -(-ho // tile_h) * -(-wo // tile_w),
        m_tiles=-(-m // tile_m),
        c_groups=fwd_c_groups(n, ho, wo, c, m, tile_h=tile_h,
                              tile_w=tile_w, tile_c=tile_c, tile_m=tile_m,
                              least=Q_GROUP_LEAST),
        off_groups=q_off_groups(n, ho, wo, c, tile_h=tile_h, tile_w=tile_w,
                                tile_c=tile_c))


def staging_vec(x_pad: Tensor, tile_c: int) -> int:
    """How the kernels stage their chunks: 1, 16-byte copies (C and
    tile_c multiples of 16, x_pad 16-byte aligned; the weights' workspace
    always is); 0, 4-byte copies."""
    return int(tile_c % 16 == 0 and x_pad.shape[-1] % 16 == 0
               and x_pad.data_ptr() % 16 == 0)


def _expect(name: str, got: tuple, dtype: torch.dtype,
            shape: tuple[int, ...]) -> None:
    """``got``: the tensor's (shape, dtype)."""
    if got[1] != dtype:
        raise ValueError(f"{name} must be {dtype} (got {got[1]})")
    if tuple(got[0]) != shape:
        raise ValueError(f"{name} has shape {tuple(got[0])}; the kernel "
                         f"expects {shape}")


def _check_tiles(x_shape: tuple, *, kernel_size: int, stride: int,
                 dilation: int, offset_bound: float, tile_h: int,
                 tile_w: int, tile_c: int, tile_m: int, ho: int,
                 wo: int) -> None:
    c = x_shape[-1]
    if tile_c < 4 or tile_c % 4 or c % tile_c:
        raise ValueError(
            f"tile_c={tile_c} must be a multiple of 4 that divides C={c}: "
            f"the int8 kernels copy and sample 4-channel words")
    pix_lanes(tile_h, tile_w)                 # raises past 64 pixels
    if not 1 <= tile_m <= Q_TILE_M:
        raise ValueError(f"tile_m={tile_m} outside the kernel's "
                         f"1..{Q_TILE_M}")
    BandSpec(kernel_size, stride, dilation, offset_bound, tile_h,
             tile_w).check_padded(x_shape[1], x_shape[2],
                                  -(-ho // tile_h), -(-wo // tile_w))


def _check_cuda(tensors: tuple[Tensor, ...]) -> None:
    """Every operand contiguous and on x_pad's device (the first), x_pad
    on a 4-byte boundary."""
    x_pad = tensors[0]
    for t in tensors:
        if not t.is_contiguous() or t.device != x_pad.device:
            raise ValueError(f"every operand must be contiguous and on "
                             f"{x_pad.device}")
    if x_pad.data_ptr() % 4:
        raise ValueError("x_pad must start on a 4-byte boundary (the "
                         "kernels read it as 4-channel words)")


class _Call(NamedTuple):
    """One call's checked plan: its ``tile_c`` and ``tile_m``, the
    library's arguments after the pointers (geometry, tiles, C groups;
    the chain's offset-conv groups), the output's shape and dtype, and
    the workspace: its bytes and each piece's byte offset (``None``
    where unused)."""
    tile_c: int
    tile_m: int
    args: tuple
    out_shape: tuple
    out_dtype: torch.dtype
    ws_bytes: int
    ws: tuple


def _workspace(*sizes: int) -> tuple[int, tuple]:
    """The bytes of one buffer that holds pieces of ``sizes`` bytes, each
    on a 256-byte boundary, and each piece's byte offset (``None`` for a
    size of 0)."""
    offsets, total = [], 0
    for size in sizes:
        offsets.append(total if size else None)
        total += -(-size // 256) * 256
    return max(total, 1), tuple(offsets)


def _launch(fn: str, operands: tuple[Tensor, ...], call: _Call) -> Tensor:
    """Allocate the output and the workspace and launch ``fn`` of the
    library on the current stream: ``fn(*operands, out, *workspace
    pieces, *call.args, vec, stream)``; raise if the launch fails.
    Returns the output."""
    x_pad = operands[0]
    dev = x_pad.device
    lib = load_kernel()
    out = torch.empty(call.out_shape, dtype=call.out_dtype, device=dev)
    ws = torch.empty(call.ws_bytes, dtype=torch.uint8, device=dev)
    base = ws.data_ptr()
    with torch.cuda.device(dev):
        err = getattr(lib, fn)(
            *(t.data_ptr() for t in operands), out.data_ptr(),
            *(None if o is None else base + o for o in call.ws), *call.args,
            staging_vec(x_pad, call.tile_c),
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"{fn} kernel launch failed: "
                           f"{lib.dcq_error_string(err).decode()} ({err})")
    return out


def _samples_q(x_pad_q: Tensor, off_t: Tensor, *, kernel_size: int,
               stride: int, dilation: int, offset_bound: float) -> Tensor:
    """int8 patches of every tile, (N, ht, wt, th, tw, K*K, C)."""
    return torch.round(sample_tiles(
        x_pad_q, off_t, kernel_size=kernel_size, stride=stride,
        dilation=dilation, offset_bound=offset_bound)).to(torch.int8)


def deform_conv_fused_zerocopy_q_plain(
        x_pad_q: Tensor, offsets: Tensor, w_tiles_q: Tensor, scale: Tensor,
        *, kernel_size: int, stride: int, dilation: int,
        offset_bound: float, tile_h: int, tile_w: int,
        tile_c: int | None = None, tile_m: int | None = None) -> Tensor:
    """Plain PyTorch version of the int8 dequant kernel, on any device:
    the band-local corner geometry of every tile, the int8 bilinear
    gather, an exact integer contraction and ``acc.float() * scale``
    (``tile_c`` only sets the weights' blocking, ``tile_m`` only the
    kernel's grid)."""
    c = x_pad_q.shape[-1]
    _, ho, wo, _ = offsets.shape
    k2 = kernel_size * kernel_size
    tc = tile_c or c
    m = w_tiles_q.shape[2]
    patches = _samples_q(x_pad_q, tile_offsets(offsets.float(), tile_h,
                                               tile_w),
                         kernel_size=kernel_size, stride=stride,
                         dilation=dilation, offset_bound=offset_bound)
    lead = patches.shape[:5]
    # (C/tc, K*K*tc, M) -> rows tap * C + c, the patches' order.
    w = w_tiles_q.reshape(c // tc, k2, tc, m).permute(1, 0, 2, 3) \
        .reshape(k2 * c, m)
    acc = contract_int8(patches.reshape(-1, k2 * c), w)
    y = acc.float() * scale
    return untile(y.reshape(*lead, m), ho, wo)


def deform_conv_fused_zerocopy_q(
        x_pad_q: Tensor, offsets: Tensor, w_tiles_q: Tensor, scale: Tensor,
        *, kernel_size: int, stride: int, dilation: int,
        offset_bound: float, tile_h: int, tile_w: int,
        tile_c: int | None = None, tile_m: int | None = None) -> Tensor:
    """int8 fused DCL over the whole padded input.

    x_pad_q:   (N, Hp, Wp, C) int8 zero-padded input (``plan.pad_zerocopy``)
    offsets:   (N, Ho, Wo, 2*K*K) fp32 raw offsets (clamped to ±B inside)
    w_tiles_q: (C // tile_c, K*K*tile_c, M) int8 (``plan.tile_weights``)
    scale:     (M,) fp32 combined dequant scale ``s_x * s_w[m]``
    returns:   (N, Ho, Wo, M) fp32

    CPU tensors run the plain version; CUDA tensors launch the kernel and
    count it in ``deform_conv_fused_zerocopy_q.launches``.
    """
    kw = dict(kernel_size=kernel_size, stride=stride, dilation=dilation,
              offset_bound=offset_bound, tile_h=tile_h, tile_w=tile_w)
    operands = (x_pad_q, offsets, w_tiles_q, scale)
    call = _q_call(*((t.shape, t.dtype) for t in operands), tile_c=tile_c,
                   tile_m=tile_m, **kw)
    if x_pad_q.device.type == "cpu":
        return deform_conv_fused_zerocopy_q_plain(
            *operands, tile_c=call.tile_c, tile_m=call.tile_m, **kw)
    if x_pad_q.device.type != "cuda":
        raise ValueError(f"no kernel for device {x_pad_q.device}")
    _check_cuda(operands)
    out = _launch("dcq_forward", operands, call)
    deform_conv_fused_zerocopy_q.launches += 1
    return out


@functools.lru_cache(maxsize=256)
def _q_call(x: tuple, off: tuple, w: tuple, scale: tuple, *,
            kernel_size: int, stride: int, dilation: int,
            offset_bound: float, tile_h: int, tile_w: int,
            tile_c: int | None, tile_m: int | None) -> _Call:
    """The int8 dequant kernel's checks and plan for operands of these
    (shape, dtype) pairs (raises as the wrapper documents)."""
    n, hp, wp, c = x[0]
    _, ho, wo, _ = off[0]
    k2 = kernel_size * kernel_size
    m = w[0][2]
    tc = tile_c or c
    tm = tile_m or min(m, Q_TILE_M)
    _expect("x_pad_q", x, torch.int8, (n, hp, wp, c))
    _expect("offsets", off, torch.float32, (n, ho, wo, 2 * k2))
    kw = dict(kernel_size=kernel_size, stride=stride, dilation=dilation,
              offset_bound=offset_bound, tile_h=tile_h, tile_w=tile_w)
    _check_tiles(x[0], tile_c=tc, tile_m=tm, ho=ho, wo=wo, **kw)
    _expect("w_tiles_q", w, torch.int8, (c // tc, k2 * tc, m))
    _expect("scale", scale, torch.float32, (m,))
    groups = q_plan(n, ho, wo, c, m, tile_h=tile_h, tile_w=tile_w,
                    tile_c=tc, tile_m=tm)["c_groups"]
    # The weights chunk-major; the C groups' int32 partials.
    ws_bytes, ws = _workspace(
        k2 * c * m, 4 * groups * n * ho * wo * m if groups > 1 else 0)
    args = (n, hp, wp, c, ho, wo, m, kernel_size, stride, dilation,
            float(offset_bound), int(math.ceil(offset_bound)), tile_h,
            tile_w, tc, tm, groups)
    return _Call(tc, tm, args, (n, ho, wo, m), torch.float32, ws_bytes, ws)


deform_conv_fused_zerocopy_q.launches = 0


def deform_conv_fused_zerocopy_chain_plain(
        x_pad_q: Tensor, w_tiles_q: Tensor, woff_tiles_q: Tensor,
        off_scale: Tensor, off_bias: Tensor, out_scale: Tensor,
        out_bias: Tensor, *, kernel_size: int, stride: int, dilation: int,
        offset_bound: float, tile_h: int, tile_w: int,
        tile_c: int | None = None, tile_m: int | None = None,
        emit: str = "int8", ho: int, wo: int) -> Tensor:
    """Plain PyTorch version of the chain kernel, on any device: the
    offset conv of every tile's band (``offset_conv_stage``), then the
    int8 sample and exact contraction of the dequant kernel, then
    ``acc.float() * out_scale + out_bias``, rounded (ties to even) and
    clipped to ±127 for ``emit="int8"``."""
    c = x_pad_q.shape[-1]
    k2 = kernel_size * kernel_size
    m = w_tiles_q.shape[2]
    spec = BandSpec(kernel_size, stride, dilation, offset_bound, tile_h,
                    tile_w)
    geom = dict(kernel_size=kernel_size, stride=stride, dilation=dilation,
                offset_bound=offset_bound)
    bands = tile_bands(x_pad_q, ht=-(-ho // tile_h), wt=-(-wo // tile_w),
                       tile_h=tile_h, tile_w=tile_w, stride=stride,
                       band_h=spec.band_h, band_w=spec.band_w)
    off_t = offset_conv_stage(bands, woff_tiles_q[0], off_scale, off_bias,
                              tile_h=tile_h, tile_w=tile_w, **geom)
    patches = _samples_q(x_pad_q, off_t, **geom)
    lead = patches.shape[:5]
    acc = contract_int8(patches.reshape(-1, k2 * c), w_tiles_q[0])
    y = acc.float() * out_scale + out_bias
    if emit == "int8":
        y = torch.clamp(torch.round(y), -127, 127).to(torch.int8)
    return untile(y.reshape(*lead, m), ho, wo)


def deform_conv_fused_zerocopy_chain(
        x_pad_q: Tensor, w_tiles_q: Tensor, woff_tiles_q: Tensor,
        off_scale: Tensor, off_bias: Tensor, out_scale: Tensor,
        out_bias: Tensor, *, kernel_size: int, stride: int, dilation: int,
        offset_bound: float, tile_h: int, tile_w: int,
        tile_c: int | None = None, tile_m: int | None = None,
        emit: str = "int8", ho: int, wo: int) -> Tensor:
    """Chained int8 DCL: fused offset conv + int8 (or fp32) emission.

    x_pad_q:      (N, Hp, Wp, C) int8 zero-padded input
    w_tiles_q:    (1, K*K*C, M) int8 deform weights
    woff_tiles_q: (1, K*K*C, 2*K*K) int8 offset-conv weights
    off_scale:    (2*K*K,) fp32 ``s_x * s_woff``; off_bias: (2*K*K,) fp32
    out_scale:    (M,) fp32 — ``s_x * s_w[m] / s_y`` (``emit="int8"``) or
                  ``s_x * s_w[m]`` (``emit="fp32"``)
    out_bias:     (M,) fp32 — ``b[m] / s_y`` resp. ``b[m]``
    ho, wo:       the output extent
    returns:      (N, ho, wo, M) int8 on the ``s_y`` grid, or fp32

    CPU tensors run the plain version; CUDA tensors launch the kernel and
    count it in ``deform_conv_fused_zerocopy_chain.launches``.
    """
    kw = dict(kernel_size=kernel_size, stride=stride, dilation=dilation,
              offset_bound=offset_bound, tile_h=tile_h, tile_w=tile_w)
    operands = (x_pad_q, w_tiles_q, woff_tiles_q, off_scale, off_bias,
                out_scale, out_bias)
    call = _chain_call(*((t.shape, t.dtype) for t in operands),
                       tile_c=tile_c, tile_m=tile_m, emit=emit, ho=ho,
                       wo=wo, **kw)
    if x_pad_q.device.type == "cpu":
        return deform_conv_fused_zerocopy_chain_plain(
            *operands, tile_c=call.tile_c, tile_m=call.tile_m, emit=emit,
            ho=ho, wo=wo, **kw)
    if x_pad_q.device.type != "cuda":
        raise ValueError(f"no kernel for device {x_pad_q.device}")
    _check_cuda(operands)
    out = _launch("dcc_forward", operands, call)
    deform_conv_fused_zerocopy_chain.launches += 1
    return out


@functools.lru_cache(maxsize=256)
def _chain_call(x: tuple, w: tuple, woff: tuple, off_scale: tuple,
                off_bias: tuple, out_scale: tuple, out_bias: tuple, *,
                kernel_size: int, stride: int, dilation: int,
                offset_bound: float, tile_h: int, tile_w: int,
                tile_c: int | None, tile_m: int | None, emit: str, ho: int,
                wo: int) -> _Call:
    """The chain kernel's checks and plan for operands of these (shape,
    dtype) pairs (raises as the wrapper documents)."""
    if emit not in EMITS:
        raise ValueError(f"unknown emit {emit!r}; expected 'int8' or 'fp32'")
    n, hp, wp, c = x[0]
    k2 = kernel_size * kernel_size
    m = w[0][2]
    tc = tile_c or c
    tm = tile_m or min(m, Q_TILE_M)
    _expect("x_pad_q", x, torch.int8, (n, hp, wp, c))
    _expect("w_tiles_q", w, torch.int8, (1, k2 * c, m))
    _expect("woff_tiles_q", woff, torch.int8, (1, k2 * c, 2 * k2))
    for name, t, size in (("off_scale", off_scale, 2 * k2),
                          ("off_bias", off_bias, 2 * k2),
                          ("out_scale", out_scale, m),
                          ("out_bias", out_bias, m)):
        _expect(name, t, torch.float32, (size,))
    _check_tiles(x[0], kernel_size=kernel_size, stride=stride,
                 dilation=dilation, offset_bound=offset_bound,
                 tile_h=tile_h, tile_w=tile_w, tile_c=tc, tile_m=tm, ho=ho,
                 wo=wo)
    plan = q_plan(n, ho, wo, c, m, tile_h=tile_h, tile_w=tile_w, tile_c=tc,
                  tile_m=tm)
    groups = plan["c_groups"]
    # Both weights chunk-major, the offset conv's int32 sums (at most
    # 1.2 MB at the model's shapes), the C groups' int32 partials.
    ws_bytes, ws = _workspace(
        k2 * c * m, k2 * c * 2 * k2, 4 * n * ho * wo * 2 * k2,
        4 * groups * n * ho * wo * m if groups > 1 else 0)
    args = (int(emit == "int8"), n, hp, wp, c, ho, wo, m, kernel_size,
            stride, dilation, float(offset_bound),
            int(math.ceil(offset_bound)), tile_h, tile_w, tc, tm, groups,
            plan["off_groups"])
    return _Call(tc, tm, args, (n, ho, wo, m),
                 torch.int8 if emit == "int8" else torch.float32, ws_bytes,
                 ws)


deform_conv_fused_zerocopy_chain.launches = 0
