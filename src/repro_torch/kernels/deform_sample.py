"""Bounded bilinear sampling without the contraction: the DCL's stage 1.

Counterpart of ``repro.kernels.deform_sample``: ``deform_sample_zerocopy``
(TPU kernel 1b, the sample-only plan of ``band_pipeline.forward_call``)
samples every output tile from its window of the zero-padded input;
``deform_sample_banded`` (TPU kernel 3) samples each row tile from the
HBM-materialised bands of ``plan.pad_and_band``.  On a CUDA tensor each
wrapper launches its hand-written kernel of ``csrc/deform_sample.cu``, on
a CPU tensor it runs the plain PyTorch version below, which does the same
band-local arithmetic in the same order (the kernel rounds every product
and sum on its own, so the two agree bit for bit).  There is no fallback
from one to the other: a failed launch raises.

Unlike the TPU kernels, the ragged edge needs no padded offsets in the
zero-copy kernel: Ho and Wo need not be tile multiples (the input must
still be padded for ``ceil(Ho / tile_h)`` row tiles, see
``plan.pad_zerocopy``).  The banded kernels keep the JAX contract: the
offsets have ``n_tiles * tile_h`` rows.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.band_pipeline import (BandSpec, check_banded,
                                               sample_bands, sample_tiles,
                                               tile_offsets, untile)

Tensor = torch.Tensor


def load_kernel():
    """Build (first time only) and load the kernels' library."""
    from repro_torch.kernels import _build
    return _build.load("deform_sample")


def _check_float32(device, **tensors: Tensor) -> None:
    for name, t in tensors.items():
        if t.dtype != torch.float32 or not t.is_contiguous() \
                or t.device != device:
            raise ValueError(f"{name} must be a contiguous float32 tensor on "
                             f"{device}")


def _check_tile_c(c: int, tile_c: int) -> None:
    if c % tile_c:
        raise ValueError(f"tile_c={tile_c} does not divide C={c}")


def _raise_on(err: int, lib, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} kernel launch failed: "
                           f"{lib.ds_error_string(err).decode()} ({err})")


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

    CPU tensors run the plain version; CUDA tensors launch the kernel
    (fp32, contiguous) and count the launch in
    ``deform_sample_zerocopy.launches``.
    """
    if x_pad.device.type == "cpu":
        return deform_sample_zerocopy_plain(
            x_pad, offsets, kernel_size=kernel_size, stride=stride,
            dilation=dilation, offset_bound=offset_bound, tile_h=tile_h,
            tile_w=tile_w, tile_c=tile_c)
    if x_pad.device.type != "cuda":
        raise ValueError(f"no kernel for device {x_pad.device}")
    n, hp, wp, c = x_pad.shape
    _, ho, wo, _ = offsets.shape
    k2 = kernel_size * kernel_size
    tc = tile_c or c
    _check_tile_c(c, tc)
    _check_float32(x_pad.device, x_pad=x_pad, offsets=offsets)
    if offsets.shape[0] != n or offsets.shape[-1] != 2 * k2:
        raise ValueError(f"offsets {tuple(offsets.shape)} do not match "
                         f"x_pad {tuple(x_pad.shape)} at K={kernel_size}")
    BandSpec(kernel_size, stride, dilation, offset_bound, tile_h,
             tile_w).check_padded(hp, wp, -(-ho // tile_h), -(-wo // tile_w))
    lib = load_kernel()
    out = torch.empty((n, ho, wo, k2, c), dtype=torch.float32,
                      device=x_pad.device)
    with torch.cuda.device(x_pad.device):
        err = lib.ds_zerocopy(
            x_pad.data_ptr(), offsets.data_ptr(), out.data_ptr(), n, hp, wp,
            c, ho, wo, kernel_size, stride, dilation, float(offset_bound),
            int(math.ceil(offset_bound)), tile_h, tile_w, tc,
            torch.cuda.current_stream(x_pad.device).cuda_stream)
    _raise_on(err, lib, "deform_sample_zerocopy")
    deform_sample_zerocopy.launches += 1
    return out


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
    ``tile_w`` output columns (default: 8, at most Wo) and
    ``tile_c`` channels.  CPU tensors run the plain version; CUDA tensors
    launch the kernel (fp32, contiguous) and count the launch in
    ``deform_sample_banded.launches``.
    """
    if bands.device.type == "cpu":
        return deform_sample_banded_plain(
            bands, offsets, kernel_size=kernel_size, stride=stride,
            dilation=dilation, offset_bound=offset_bound, tile_h=tile_h,
            tile_w=tile_w, tile_c=tile_c)
    if bands.device.type != "cuda":
        raise ValueError(f"no kernel for device {bands.device}")
    n, nt, band_h, w_pad, c = bands.shape
    _, ho, wo, _ = offsets.shape
    k2 = kernel_size * kernel_size
    tc = tile_c or c
    tw = tile_w or min(8, wo)
    _check_tile_c(c, tc)
    _check_float32(bands.device, bands=bands, offsets=offsets)
    check_banded(bands, offsets, kernel_size=kernel_size, stride=stride,
                 dilation=dilation, offset_bound=offset_bound, tile_h=tile_h)
    lib = load_kernel()
    out = torch.empty((n, ho, wo, k2, c), dtype=torch.float32,
                      device=bands.device)
    with torch.cuda.device(bands.device):
        err = lib.ds_banded(
            bands.data_ptr(), offsets.data_ptr(), out.data_ptr(), n, nt,
            band_h, w_pad, c, wo, kernel_size, stride, dilation,
            float(offset_bound), int(math.ceil(offset_bound)), tile_h, tw,
            tc, torch.cuda.current_stream(bands.device).cuda_stream)
    _raise_on(err, lib, "deform_sample_banded")
    deform_sample_banded.launches += 1
    return out


deform_sample_banded.launches = 0
