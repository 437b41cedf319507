"""Fused backward of the bounded DCL: d_input, d_offsets and d_weights.

Counterpart of ``repro.kernels.deform_conv_bwd.deform_conv_bwd_zerocopy``.
The wrapper takes the zero-padded input whole (``plan.pad_zerocopy`` at
the backward's tiles), the raw offsets, the output cotangent and the
channel-blocked weights; on a CUDA tensor it launches the hand-written
kernels of ``csrc/deform_conv_bwd.cu``, on a CPU tensor it runs the plain
PyTorch version below, which follows the same explicit formulas:

* recompute the patches from the padded plane (band-local corners);
* ``dw = sum P^T g`` per C-chunk;
* ``dP = g W^T``;
* ``d_offsets`` = dP contracted over C against the corner-value
  derivatives, zero where the raw offset lies outside ``[-B, B]``;
* ``d_input`` = ``index_add_`` of the four weighted corners into the
  padded plane.

Unlike the TPU kernel, the cotangent needs no padding to tile multiples:
pixels outside Ho x Wo contribute nothing.  There is no fallback from the
kernel to the plain version: a failed launch raises.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.band_pipeline import (BandSpec, corner_derivatives,
                                               corner_weights, tile_corners,
                                               tile_offsets, tile_pixels,
                                               untile)

Tensor = torch.Tensor


def load_kernel():
    """Build (first time only) and load the kernel's library."""
    from repro_torch.kernels import _build
    return _build.load("deform_conv_bwd")


def _check(x_pad: Tensor, offsets: Tensor, g: Tensor, w_tiles: Tensor, *,
           kernel_size: int, tile_c: int) -> None:
    n, _, _, c = x_pad.shape
    k2 = kernel_size * kernel_size
    if offsets.shape[0] != n or offsets.shape[-1] != 2 * k2:
        raise ValueError(f"offsets {tuple(offsets.shape)} do not match "
                         f"x_pad {tuple(x_pad.shape)} at K={kernel_size}")
    if c % tile_c or tuple(w_tiles.shape[:2]) != (c // tile_c, k2 * tile_c):
        raise ValueError(f"w_tiles {tuple(w_tiles.shape)} is not C={c} "
                         f"blocked by tile_c={tile_c} at K={kernel_size}")
    if tuple(g.shape) != (*offsets.shape[:3], w_tiles.shape[2]):
        raise ValueError(f"cotangent {tuple(g.shape)} does not match the "
                         f"output {(*offsets.shape[:3], w_tiles.shape[2])}")


def deform_conv_bwd_zerocopy_plain(
        x_pad: Tensor, offsets: Tensor, g: Tensor, w_tiles: Tensor, *,
        kernel_size: int, stride: int, dilation: int, offset_bound: float,
        tile_h: int, tile_w: int, tile_c: int | None = None
        ) -> tuple[Tensor, Tensor, Tensor]:
    """Plain PyTorch version of the kernel, on any device.  Ragged pixels
    get a zero cotangent, so they add nothing to dx or dw."""
    n, hp, wp, c = x_pad.shape
    _, ho, wo, _ = offsets.shape
    k2 = kernel_size * kernel_size
    tc = tile_c or c
    _check(x_pad, offsets, g, w_tiles, kernel_size=kernel_size, tile_c=tc)
    m = w_tiles.shape[2]
    off_t = tile_offsets(offsets.float(), tile_h, tile_w)
    idx00, ty, tx = tile_corners(
        x_pad, off_t, kernel_size=kernel_size, stride=stride,
        dilation=dilation, offset_bound=offset_bound)
    lead = idx00.shape[:5]                     # (n, ht, wt, th, tw)
    rows = math.prod(lead[1:])                 # pixels per image
    flat = x_pad.reshape(n, hp * wp, c).float()
    b = torch.arange(n, device=x_pad.device)[:, None]
    idx = idx00.reshape(n, rows * k2)
    corners = [idx, idx + 1, idx + wp, idx + wp + 1]
    v00, v01, v10, v11 = (flat[b, i].reshape(n * rows, k2, c)
                          for i in corners)
    ty = ty.reshape(n * rows, k2, 1)
    tx = tx.reshape(n * rows, k2, 1)
    w00, w01, w10, w11 = corner_weights(ty, tx)
    patches = w00 * v00 + w01 * v01 + w10 * v10 + w11 * v11
    gm = tile_pixels(g.float(), tile_h, tile_w).reshape(n * rows, m)
    dw = torch.empty(c // tc, k2 * tc, m, dtype=torch.float32,
                     device=x_pad.device)
    dp = torch.empty_like(patches)
    for cs in range(c // tc):
        chunk = slice(cs * tc, (cs + 1) * tc)
        lhs = patches[:, :, chunk].reshape(n * rows, k2 * tc)
        dw[cs] = lhs.T @ gm
        dp[:, :, chunk] = (gm @ w_tiles[cs].float().T).reshape(-1, k2, tc)
    d_y, d_x = corner_derivatives(v00, v01, v10, v11, ty, tx)
    doff = torch.stack([(dp * d_y).sum(-1), (dp * d_x).sum(-1)], dim=-1)
    inside = (off_t >= -offset_bound) & (off_t <= offset_bound)
    doff = doff.reshape(*lead, k2, 2) * inside
    doff = untile(doff.reshape(*lead, 2 * k2), ho, wo)
    dx = torch.zeros(n * hp * wp, c, dtype=torch.float32,
                     device=x_pad.device)
    base = (b * (hp * wp)).expand(n, rows * k2)
    for i, wgt in zip(corners, (w00, w01, w10, w11)):
        dx.index_add_(0, (base + i).reshape(-1),
                      (wgt * dp).reshape(-1, c))
    return (dx.reshape(n, hp, wp, c).to(x_pad.dtype),
            doff.to(offsets.dtype), dw)


def deform_conv_bwd_zerocopy(
        x_pad: Tensor, offsets: Tensor, g: Tensor, w_tiles: Tensor, *,
        kernel_size: int, stride: int, dilation: int, offset_bound: float,
        tile_h: int, tile_w: int, tile_c: int | None = None
        ) -> tuple[Tensor, Tensor, Tensor]:
    """Fused backward over the whole padded input.

    x_pad:   (N, Hp, Wp, C) zero-padded input (``plan.pad_zerocopy``)
    offsets: (N, Ho, Wo, 2*K*K) raw offsets
    g:       (N, Ho, Wo, M) output cotangent
    w_tiles: (C // tile_c, K*K*tile_c, M) from ``plan.tile_weights``
    returns: (dx_pad (N, Hp, Wp, C), d_offsets (N, Ho, Wo, 2*K*K),
             dw_tiles in the layout of ``w_tiles``)

    CPU tensors run the plain version; CUDA tensors launch the kernel
    (fp32, contiguous, ``tile_h * tile_w <= 64``, at most
    ``tiling.BWD_MAX_QUADS`` dP tiles) and count the launch in
    ``deform_conv_bwd_zerocopy.launches``.
    """
    if x_pad.device.type == "cpu":
        return deform_conv_bwd_zerocopy_plain(
            x_pad, offsets, g, w_tiles, kernel_size=kernel_size,
            stride=stride, dilation=dilation, offset_bound=offset_bound,
            tile_h=tile_h, tile_w=tile_w, tile_c=tile_c)
    if x_pad.device.type != "cuda":
        raise ValueError(f"no kernel for device {x_pad.device}")
    from repro_torch.core.tiling import (BWD_MAX_QUADS, bwd_dw_splits,
                                         bwd_quads)

    n, hp, wp, c = x_pad.shape
    _, ho, wo, _ = offsets.shape
    m = w_tiles.shape[2]
    tc = tile_c or c
    _check(x_pad, offsets, g, w_tiles, kernel_size=kernel_size, tile_c=tc)
    for name, t in (("x_pad", x_pad), ("offsets", offsets), ("g", g),
                    ("w_tiles", w_tiles)):
        if t.dtype != torch.float32 or not t.is_contiguous() \
                or t.device != x_pad.device:
            raise ValueError(f"{name} must be a contiguous float32 tensor on "
                             f"{x_pad.device}")
    if bwd_quads(tile_h, tile_w, tc, kernel_size=kernel_size) \
            > BWD_MAX_QUADS:                  # raises past 64 pixels too
        raise ValueError(
            f"tile {tile_h}x{tile_w} with tile_c={tc} gives more than "
            f"{BWD_MAX_QUADS} 4x4 dP tiles at K={kernel_size}: take a "
            f"smaller tile_c (the chooser's fp32_bwd tiles fit)")
    BandSpec(kernel_size, stride, dilation, offset_bound, tile_h,
             tile_w).check_padded(hp, wp, -(-ho // tile_h), -(-wo // tile_w))
    splits = bwd_dw_splits(n, ho, wo, c, m, kernel_size=kernel_size,
                           tile_h=tile_h, tile_w=tile_w, tile_c=tc)

    dev = x_pad.device
    dx_pad = torch.empty_like(x_pad)
    d_off = torch.empty_like(offsets)
    dw = torch.empty_like(w_tiles)
    partial = torch.empty((splits, *w_tiles.shape), dtype=torch.float32,
                          device=dev) if splits > 1 else None
    lib = load_kernel()
    with torch.cuda.device(dev):
        err = lib.dcb_backward(
            x_pad.data_ptr(), offsets.data_ptr(), g.data_ptr(),
            w_tiles.data_ptr(), dx_pad.data_ptr(), d_off.data_ptr(),
            dw.data_ptr(), None if partial is None else partial.data_ptr(),
            n, hp, wp, c, ho, wo, m, kernel_size, stride, dilation,
            float(offset_bound), int(math.ceil(offset_bound)), tile_h,
            tile_w, tc, splits, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"deform_conv_bwd kernel launch failed: "
                           f"{lib.dcb_error_string(err).decode()} ({err})")
    deform_conv_bwd_zerocopy.launches += 1
    return dx_pad, d_off, dw


deform_conv_bwd_zerocopy.launches = 0
