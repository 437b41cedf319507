"""Fused bounded DCL forward: bilinear sampling + dynamic convolution.

Counterpart of ``repro.kernels.deform_conv_fused.deform_conv_fused_zerocopy``
(the fp32 plan of ``band_pipeline.forward_call``).  The wrapper takes the
zero-padded input whole, the raw offsets and the channel-blocked weights;
on a CUDA tensor it launches the hand-written kernel of
``csrc/deform_conv_fused.cu``, on a CPU tensor it runs the plain PyTorch
version below, which does the same band-local arithmetic.  There is no
fallback from one to the other: a failed launch raises.

Unlike the TPU kernel, the ragged edge needs no padded offsets: Ho and Wo
need not be tile multiples (the input must still be padded for
``ceil(Ho / tile_h)`` row tiles, see ``plan.pad_zerocopy``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.band_pipeline import (BandSpec, sample_tiles,
                                               tile_offsets, untile)

Tensor = torch.Tensor


def _check(x_pad: Tensor, offsets: Tensor, w_tiles: Tensor, *,
           kernel_size: int, tile_c: int) -> None:
    n, _, _, c = x_pad.shape
    k2 = kernel_size * kernel_size
    if offsets.shape[0] != n or offsets.shape[-1] != 2 * k2:
        raise ValueError(f"offsets {tuple(offsets.shape)} do not match "
                         f"x_pad {tuple(x_pad.shape)} at K={kernel_size}")
    if c % tile_c or tuple(w_tiles.shape[:2]) != (c // tile_c, k2 * tile_c):
        raise ValueError(f"w_tiles {tuple(w_tiles.shape)} is not C={c} "
                         f"blocked by tile_c={tile_c} at K={kernel_size}")


def load_kernel():
    """Build (first time only) and load the kernel's library."""
    from repro_torch.kernels import _build
    return _build.load("deform_conv_fused")


def deform_conv_fused_zerocopy_plain(
        x_pad: Tensor, offsets: Tensor, w_tiles: Tensor, *,
        kernel_size: int, stride: int, dilation: int, offset_bound: float,
        tile_h: int, tile_w: int, tile_c: int | None = None,
        tile_m: int | None = None) -> Tensor:
    """Plain PyTorch version of the kernel, on any device.

    Every tile's corner geometry is computed band-locally (as the kernel
    does), shifted to the padded plane, gathered, and contracted one
    C-chunk at a time with fp32 accumulation (``tile_m`` only shapes the
    kernel's grid)."""
    c = x_pad.shape[-1]
    _, ho, wo, _ = offsets.shape
    k2 = kernel_size * kernel_size
    tc = tile_c or c
    _check(x_pad, offsets, w_tiles, kernel_size=kernel_size, tile_c=tc)
    off_t = tile_offsets(offsets, tile_h, tile_w)
    patches = sample_tiles(x_pad, off_t, kernel_size=kernel_size,
                           stride=stride, dilation=dilation,
                           offset_bound=offset_bound)
    lead = patches.shape[:5]
    patches = patches.reshape(-1, k2, c)
    m = w_tiles.shape[2]
    acc = torch.zeros(patches.shape[0], m, dtype=torch.float32,
                      device=x_pad.device)
    for cs in range(c // tc):
        lhs = patches[:, :, cs * tc:(cs + 1) * tc].reshape(-1, k2 * tc)
        acc = acc + lhs @ w_tiles[cs].float()
    y = untile(acc.reshape(*lead, m), ho, wo)
    return y.to(x_pad.dtype)


def deform_conv_fused_zerocopy(
        x_pad: Tensor, offsets: Tensor, w_tiles: Tensor, *,
        kernel_size: int, stride: int, dilation: int, offset_bound: float,
        tile_h: int, tile_w: int, tile_c: int | None = None,
        tile_m: int | None = None) -> Tensor:
    """Fused DCL over the whole padded input.

    x_pad:   (N, Hp, Wp, C) zero-padded input (``plan.pad_zerocopy``)
    offsets: (N, Ho, Wo, 2*K*K) raw offsets (clamped to ±B inside)
    w_tiles: (C // tile_c, K*K*tile_c, M) from ``plan.tile_weights``
    returns: (N, Ho, Wo, M)

    CPU tensors run the plain version; CUDA tensors launch the kernel
    (fp32, contiguous, ``tile_h * tile_w <= 64``, ``tile_m <= 64``) and
    count the launch in ``deform_conv_fused_zerocopy.launches``.
    """
    if x_pad.device.type == "cpu":
        return deform_conv_fused_zerocopy_plain(
            x_pad, offsets, w_tiles, kernel_size=kernel_size, stride=stride,
            dilation=dilation, offset_bound=offset_bound, tile_h=tile_h,
            tile_w=tile_w, tile_c=tile_c, tile_m=tile_m)
    if x_pad.device.type != "cuda":
        raise ValueError(f"no kernel for device {x_pad.device}")
    from repro_torch.core.tiling import TILE_M_MAX, pix_lanes

    n, hp, wp, c = x_pad.shape
    _, ho, wo, _ = offsets.shape
    m = w_tiles.shape[2]
    tc = tile_c or c
    tm = tile_m or min(m, TILE_M_MAX)
    _check(x_pad, offsets, w_tiles, kernel_size=kernel_size, tile_c=tc)
    for name, t in (("x_pad", x_pad), ("offsets", offsets),
                    ("w_tiles", w_tiles)):
        if t.dtype != torch.float32 or not t.is_contiguous() \
                or t.device != x_pad.device:
            raise ValueError(f"{name} must be a contiguous float32 tensor on "
                             f"{x_pad.device}")
    pix_lanes(tile_h, tile_w)                 # raises past 64 pixels
    if not 1 <= tm <= TILE_M_MAX:
        raise ValueError(f"tile_m={tm} outside the kernel's 1..{TILE_M_MAX}")
    BandSpec(kernel_size, stride, dilation, offset_bound, tile_h,
             tile_w).check_padded(hp, wp, -(-ho // tile_h), -(-wo // tile_w))

    out = torch.empty((n, ho, wo, m), dtype=torch.float32,
                      device=x_pad.device)
    lib = load_kernel()
    with torch.cuda.device(x_pad.device):
        err = lib.dcf_forward(
            x_pad.data_ptr(), offsets.data_ptr(), w_tiles.data_ptr(),
            out.data_ptr(), n, hp, wp, c, ho, wo, m, kernel_size, stride,
            dilation, float(offset_bound), int(math.ceil(offset_bound)),
            tile_h, tile_w, tc, tm,
            torch.cuda.current_stream(x_pad.device).cuda_stream)
    if err:
        raise RuntimeError(f"deform_conv_fused kernel launch failed: "
                           f"{lib.dcf_error_string(err).decode()} ({err})")
    deform_conv_fused_zerocopy.launches += 1
    return out


deform_conv_fused_zerocopy.launches = 0
