"""Bounded bilinear sampling without the contraction: the DCL's stage 1.

Counterpart of ``repro.kernels.deform_sample``: ``deform_sample_zerocopy``
(TPU kernel 1b, the sample-only plan of ``band_pipeline.forward_call``)
samples every output tile from its window of the zero-padded input;
``deform_sample_banded`` (TPU kernel 3) samples each row tile from the
HBM-materialised bands of ``plan.pad_and_band``.  On a CUDA tensor of
fp32 or bf16 each wrapper launches its hand-written kernel of
``csrc/deform_sample.cu``, on a CPU tensor it runs the plain PyTorch
version below, which does the same band-local arithmetic in the same
order (the kernel rounds every product and sum on its own, and a bf16
result once at the end, so the two agree bit for bit).  There is no
fallback from one to the other: a failed build or launch raises.

Unlike the TPU kernels, the ragged edge needs no padded offsets in the
zero-copy kernel: Ho and Wo need not be tile multiples (the input must
still be padded for ``ceil(Ho / tile_h)`` row tiles, see
``plan.pad_zerocopy``).  The banded kernels keep the JAX contract: the
offsets have ``n_tiles * tile_h`` rows.

A call's checks, grid (``core.tiling.sample_c_groups``) and the kernel's
plan (``ds_plan``) are worked out once per shape and kept
(``_zerocopy_plan``, ``_banded_plan``), and a launch takes the stream's
raw handle and one ctypes call that makes the tensors' device current
itself: the host's launch path is most of a small call's time.
``tile_c`` is the kernel's chunk of channels, any divisor of C.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from repro_torch.core.tiling import sample_c_groups, sample_vec_bytes
from repro_torch.kernels.band_pipeline import (BandSpec, check_banded,
                                               sample_bands, sample_tiles,
                                               tile_offsets, untile)

Tensor = torch.Tensor

DTYPES = (torch.float32, torch.bfloat16)


def load_kernel():
    """Build (first time only) and load the kernels' library."""
    from repro_torch.kernels import _build
    return _build.load("deform_sample")


class _DsPlan(ctypes.Structure):
    """``DsPlan`` of ``csrc/deform_sample.cu``: the call's shapes and
    tiles, completed by ``ds_plan``."""
    _fields_ = ([(f, ctypes.c_int) for f in (
        "n", "hp", "wp", "c", "nt", "ho", "wo", "k", "s", "d", "hb")]
        + [("bound", ctypes.c_float)]
        + [(f, ctypes.c_int) for f in (
            "th", "tw", "tc", "groups", "elt", "vec", "off_bf16", "band_h",
            "band_w", "h_tiles", "w_tiles", "lg_lanes", "smem")])


class _Call(NamedTuple):
    """One call's checked plan: the kernel's (kept alive here, its address
    passed to ``ds_launch``), and the output's shape and dtype."""
    plan: _DsPlan
    address: int
    out_shape: tuple
    out_dtype: torch.dtype


def _check_tile_c(c: int, tile_c: int) -> None:
    if c % tile_c:
        raise ValueError(f"tile_c={tile_c} does not divide C={c}")


def _check_dtypes(name: str, src: tuple, off: tuple) -> None:
    """``src``, ``off``: (shape, dtype) of the source and the offsets."""
    for what, got in ((name, src[1]), ("offsets", off[1])):
        if got not in DTYPES:
            raise ValueError(f"{what} must be float32 or bfloat16 (got "
                             f"{got}): the sampling kernels take no other "
                             f"dtype")


def _plan(fields: dict, src_dtype: torch.dtype, off_dtype: torch.dtype, *,
          kernel_size: int, stride: int, dilation: int,
          offset_bound: float, tile_h: int, tile_w: int, tile_c: int,
          address: int, out_shape: tuple) -> _Call:
    """The kernel's plan for one call: its C groups and vector width
    here, the rest from ``ds_plan``; raises on what the kernel refuses."""
    itemsize = src_dtype.itemsize
    groups = sample_c_groups(fields["n"], fields["ho"], fields["wo"],
                             fields["c"], tile_h=tile_h, tile_w=tile_w,
                             tile_c=tile_c)
    plan = _DsPlan(**fields, k=kernel_size, s=stride, d=dilation,
                   hb=int(math.ceil(offset_bound)), bound=offset_bound,
                   th=tile_h, tw=tile_w, tc=tile_c, groups=groups,
                   elt=itemsize,
                   vec=sample_vec_bytes(tile_c, itemsize, address),
                   off_bf16=int(off_dtype == torch.bfloat16))
    lib = load_kernel()
    err = lib.ds_plan(ctypes.addressof(plan))
    if err:
        raise ValueError(f"the sampling kernel refuses {fields} at tiles "
                         f"{tile_h}x{tile_w}, tile_c={tile_c}: "
                         f"{lib.ds_error_string(err).decode()}")
    return _Call(plan, ctypes.addressof(plan), out_shape, src_dtype)


def _launch(src: Tensor, offsets: Tensor, call: _Call, what: str) -> Tensor:
    """Launch ``ds_launch`` with a checked plan on the device's current
    stream; raise if the launch fails.  Returns the output."""
    dev = src.device
    if not (src.is_contiguous() and offsets.is_contiguous()) \
            or offsets.device != dev:
        raise ValueError(f"{what}: every operand must be contiguous and on "
                         f"{dev}")
    lib = load_kernel()
    out = torch.empty(call.out_shape, dtype=call.out_dtype, device=dev)
    err = lib.ds_launch(src.data_ptr(), offsets.data_ptr(), out.data_ptr(),
                        call.address, dev.index,
                        torch._C._cuda_getCurrentRawStream(dev.index))
    if err:
        raise RuntimeError(f"{what} kernel launch failed: "
                           f"{lib.ds_error_string(err).decode()} ({err})")
    return out


def deform_sample_zerocopy_plain(
        x_pad: Tensor, offsets: Tensor, *, kernel_size: int, stride: int,
        dilation: int, offset_bound: float, tile_h: int, tile_w: int,
        tile_c: int | None = None) -> Tensor:
    """Plain PyTorch version of kernel 1b, on any device: every tile's
    band-local corner geometry, shifted to the padded plane and gathered
    (``tile_c`` only shapes the kernel's grid)."""
    n, _, _, c = x_pad.shape
    _, ho, wo, _ = offsets.shape
    k2 = kernel_size * kernel_size
    _check_tile_c(c, tile_c or c)
    patches = sample_tiles(x_pad, tile_offsets(offsets, tile_h, tile_w),
                           kernel_size=kernel_size, stride=stride,
                           dilation=dilation, offset_bound=offset_bound)
    y = untile(patches.reshape(*patches.shape[:5], k2 * c), ho, wo)
    return y.reshape(n, ho, wo, k2, c).to(x_pad.dtype)


def deform_sample_zerocopy(
        x_pad: Tensor, offsets: Tensor, *, kernel_size: int, stride: int,
        dilation: int, offset_bound: float, tile_h: int, tile_w: int,
        tile_c: int | None = None) -> Tensor:
    """Bounded sampling over the whole padded input (kernel 1b).

    x_pad:   (N, Hp, Wp, C) zero-padded input (``plan.pad_zerocopy``)
    offsets: (N, Ho, Wo, 2*K*K) raw offsets (clamped to ±B inside)
    returns: (N, Ho, Wo, K*K, C) patches in x_pad's dtype

    CPU tensors run the plain version; CUDA tensors (fp32 or bf16, the
    offsets in either, contiguous) launch the kernel and count the launch
    in ``deform_sample_zerocopy.launches``.
    """
    if x_pad.device.type == "cpu":
        return deform_sample_zerocopy_plain(
            x_pad, offsets, kernel_size=kernel_size, stride=stride,
            dilation=dilation, offset_bound=offset_bound, tile_h=tile_h,
            tile_w=tile_w, tile_c=tile_c)
    if x_pad.device.type != "cuda":
        raise ValueError(f"no kernel for device {x_pad.device}")
    call = _zerocopy_plan((x_pad.shape, x_pad.dtype),
                          (offsets.shape, offsets.dtype), kernel_size, stride,
                          dilation, offset_bound, tile_h, tile_w, tile_c,
                          x_pad.data_ptr() % 16)
    out = _launch(x_pad, offsets, call, "deform_sample_zerocopy")
    deform_sample_zerocopy.launches += 1
    return out


@functools.lru_cache(maxsize=256)
def _zerocopy_plan(x: tuple, off: tuple, kernel_size: int, stride: int,
                   dilation: int, offset_bound: float, tile_h: int,
                   tile_w: int, tile_c: int | None, address: int) -> _Call:
    """Kernel 1b's checks and plan for operands of these (shape, dtype)
    pairs and a source at ``address`` modulo 16."""
    n, hp, wp, c = x[0]
    _, ho, wo, _ = off[0]
    k2 = kernel_size * kernel_size
    tc = tile_c or c
    _check_tile_c(c, tc)
    _check_dtypes("x_pad", x, off)
    if off[0][0] != n or off[0][-1] != 2 * k2:
        raise ValueError(f"offsets {tuple(off[0])} do not match x_pad "
                         f"{tuple(x[0])} at K={kernel_size}")
    BandSpec(kernel_size, stride, dilation, offset_bound, tile_h,
             tile_w).check_padded(hp, wp, -(-ho // tile_h), -(-wo // tile_w))
    return _plan(dict(n=n, hp=hp, wp=wp, c=c, nt=0, ho=ho, wo=wo), x[1],
                 off[1], kernel_size=kernel_size, stride=stride,
                 dilation=dilation, offset_bound=offset_bound,
                 tile_h=tile_h, tile_w=tile_w, tile_c=tc, address=address,
                 out_shape=(n, ho, wo, k2, c))


deform_sample_zerocopy.launches = 0


def deform_sample_banded_plain(
        bands: Tensor, offsets: Tensor, *, kernel_size: int, stride: int,
        dilation: int, offset_bound: float, tile_h: int,
        tile_w: int | None = None, tile_c: int | None = None) -> Tensor:
    """Plain PyTorch version of kernel 3, on any device: each band tile
    sampled over the full output width, as the TPU kernel does
    (``tile_w`` and ``tile_c`` only shape the kernel's grid)."""
    _check_tile_c(bands.shape[-1], tile_c or bands.shape[-1])
    patches = sample_bands(bands, offsets, kernel_size=kernel_size,
                           stride=stride, dilation=dilation,
                           offset_bound=offset_bound, tile_h=tile_h)
    return patches.to(bands.dtype)


def deform_sample_banded(
        bands: Tensor, offsets: Tensor, *, kernel_size: int, stride: int,
        dilation: int, offset_bound: float, tile_h: int,
        tile_w: int | None = None, tile_c: int | None = None) -> Tensor:
    """Bounded sampling over pre-banded input (kernel 3).

    bands:   (N, n_tiles, band_h, w_pad, C) from ``plan.pad_and_band``
    offsets: (N, n_tiles * tile_h, Wo, 2*K*K) raw offsets
    returns: (N, n_tiles * tile_h, Wo, K*K, C) patches in bands' dtype

    A block of the kernel takes a band tile's ``tile_h`` rows by
    ``tile_w`` output columns (default: 8, at most Wo) and steps C in
    chunks of ``tile_c``.  CPU tensors run the plain version; CUDA tensors
    (fp32 or bf16, the offsets in either, contiguous) launch the kernel
    and count the launch in ``deform_sample_banded.launches``.
    """
    if bands.device.type == "cpu":
        return deform_sample_banded_plain(
            bands, offsets, kernel_size=kernel_size, stride=stride,
            dilation=dilation, offset_bound=offset_bound, tile_h=tile_h,
            tile_w=tile_w, tile_c=tile_c)
    if bands.device.type != "cuda":
        raise ValueError(f"no kernel for device {bands.device}")
    call = _banded_plan((bands.shape, bands.dtype),
                        (offsets.shape, offsets.dtype), kernel_size, stride,
                        dilation, offset_bound, tile_h, tile_w, tile_c,
                        bands.data_ptr() % 16)
    out = _launch(bands, offsets, call, "deform_sample_banded")
    deform_sample_banded.launches += 1
    return out


@functools.lru_cache(maxsize=256)
def _banded_plan(bands: tuple, off: tuple, kernel_size: int, stride: int,
                 dilation: int, offset_bound: float, tile_h: int,
                 tile_w: int | None, tile_c: int | None,
                 address: int) -> _Call:
    """Kernel 3's checks and plan for operands of these (shape, dtype)
    pairs and a source at ``address`` modulo 16."""
    n, nt, band_h, w_pad, c = bands[0]
    _, ho, wo, _ = off[0]
    k2 = kernel_size * kernel_size
    tc = tile_c or c
    _check_tile_c(c, tc)
    _check_dtypes("bands", bands, off)
    check_banded(torch.empty(bands[0], device="meta"),
                 torch.empty(off[0], device="meta"), kernel_size=kernel_size,
                 stride=stride, dilation=dilation, offset_bound=offset_bound,
                 tile_h=tile_h)
    return _plan(dict(n=n, hp=band_h, wp=w_pad, c=c, nt=nt, ho=ho, wo=wo),
                 bands[1], off[1], kernel_size=kernel_size, stride=stride,
                 dilation=dilation, offset_bound=offset_bound,
                 tile_h=tile_h, tile_w=tile_w or min(8, wo), tile_c=tc,
                 address=address, out_shape=(n, ho, wo, k2, c))


deform_sample_banded.launches = 0
