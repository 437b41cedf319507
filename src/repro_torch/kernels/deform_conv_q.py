"""int8 fused DCL kernels: the quantized datapath and layer chaining.

Counterparts of ``repro.kernels.deform_conv_q``:

* ``deform_conv_fused_zerocopy_q`` — int8 band, fp32 bilinear
  coefficients, patches rounded back to int8, s8 x s8 -> s32 contraction,
  per-M dequant epilogue (``s_x * s_w[m]``), fp32 out;
* ``deform_conv_fused_zerocopy_chain`` — the same with the offset conv
  fused in (computed from the int8 band and int8 offset-conv weights, so
  no offset reaches device memory) and a requant epilogue that emits int8
  on the next layer's grid (``emit="int8"``), or dequant + bias in fp32
  (``emit="fp32"``, the chain tail).

On a CUDA tensor each wrapper launches its hand-written kernel of
``csrc/deform_conv_q.cu`` and counts the launch; on a CPU tensor it runs
the plain PyTorch version beside it, which does the same band-local
arithmetic with the same fp32 roundings and exact integer sums, so the
two agree bit for bit.  A failed launch raises; there is no fallback.

The chain kernel streams C in ``tile_c`` chunks, twice (offsets first,
then samples; see the source note), so unlike the TPU kernel its
``tile_c`` is a free chunk size.  Its weights keep the TPU plan's layout,
``plan.tile_weights(w, C)``: ``(1, K*K*C, M)`` and ``(1, K*K*C, 2*K*K)``.
"""
from __future__ import annotations

import math

import torch

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


def _expect(name: str, t: Tensor, dtype: torch.dtype,
            shape: tuple[int, ...]) -> None:
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype} (got {t.dtype})")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}; the kernel "
                         f"expects {shape}")


def _check_tiles(x_pad: Tensor, *, kernel_size: int, stride: int,
                 dilation: int, offset_bound: float, tile_h: int,
                 tile_w: int, tile_c: int, tile_m: int, ho: int,
                 wo: int) -> None:
    from repro_torch.core.tiling import TILE_M_MAX, pix_lanes
    c = x_pad.shape[-1]
    if tile_c < 4 or tile_c % 4 or c % tile_c:
        raise ValueError(
            f"tile_c={tile_c} must be a multiple of 4 that divides C={c}: "
            f"the int8 kernels contract packed 4-channel words")
    pix_lanes(tile_h, tile_w)                 # raises past 64 pixels
    if not 1 <= tile_m <= TILE_M_MAX:
        raise ValueError(f"tile_m={tile_m} outside the kernel's "
                         f"1..{TILE_M_MAX}")
    BandSpec(kernel_size, stride, dilation, offset_bound, tile_h,
             tile_w).check_padded(x_pad.shape[1], x_pad.shape[2],
                                  -(-ho // tile_h), -(-wo // tile_w))


def _check_cuda(x_pad: Tensor, **tensors: Tensor) -> None:
    for name, t in dict(x_pad=x_pad, **tensors).items():
        if not t.is_contiguous() or t.device != x_pad.device:
            raise ValueError(f"{name} must be contiguous and on "
                             f"{x_pad.device}")
    if x_pad.data_ptr() % 4:
        raise ValueError("x_pad must start on a 4-byte boundary (the "
                         "kernels read it as 4-channel words)")


def _launch_error(lib, err: int, what: str) -> RuntimeError:
    return RuntimeError(f"{what} kernel launch failed: "
                        f"{lib.dcq_error_string(err).decode()} ({err})")


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
    n, hp, wp, c = x_pad_q.shape
    _, ho, wo, _ = offsets.shape
    k2 = kernel_size * kernel_size
    m = w_tiles_q.shape[2]
    tc = tile_c or c
    tm = tile_m or min(m, 64)
    _expect("x_pad_q", x_pad_q, torch.int8, (n, hp, wp, c))
    _expect("offsets", offsets, torch.float32, (n, ho, wo, 2 * k2))
    kw = dict(kernel_size=kernel_size, stride=stride, dilation=dilation,
              offset_bound=offset_bound, tile_h=tile_h, tile_w=tile_w)
    _check_tiles(x_pad_q, tile_c=tc, tile_m=tm, ho=ho, wo=wo, **kw)
    _expect("w_tiles_q", w_tiles_q, torch.int8, (c // tc, k2 * tc, m))
    _expect("scale", scale, torch.float32, (m,))
    if x_pad_q.device.type == "cpu":
        return deform_conv_fused_zerocopy_q_plain(
            x_pad_q, offsets, w_tiles_q, scale, tile_c=tc, tile_m=tm, **kw)
    if x_pad_q.device.type != "cuda":
        raise ValueError(f"no kernel for device {x_pad_q.device}")
    _check_cuda(x_pad_q, offsets=offsets, w_tiles_q=w_tiles_q, scale=scale)
    out = torch.empty((n, ho, wo, m), dtype=torch.float32,
                      device=x_pad_q.device)
    lib = load_kernel()
    with torch.cuda.device(x_pad_q.device):
        err = lib.dcq_forward(
            x_pad_q.data_ptr(), offsets.data_ptr(), w_tiles_q.data_ptr(),
            scale.data_ptr(), out.data_ptr(), n, hp, wp, c, ho, wo, m,
            kernel_size, stride, dilation, float(offset_bound),
            int(math.ceil(offset_bound)), tile_h, tile_w, tc, tm,
            torch.cuda.current_stream(x_pad_q.device).cuda_stream)
    if err:
        raise _launch_error(lib, err, "deform_conv_fused_q")
    deform_conv_fused_zerocopy_q.launches += 1
    return out


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
    if emit not in EMITS:
        raise ValueError(f"unknown emit {emit!r}; expected 'int8' or 'fp32'")
    n, hp, wp, c = x_pad_q.shape
    k2 = kernel_size * kernel_size
    m = w_tiles_q.shape[2]
    tc = tile_c or c
    tm = tile_m or min(m, 64)
    _expect("x_pad_q", x_pad_q, torch.int8, (n, hp, wp, c))
    _expect("w_tiles_q", w_tiles_q, torch.int8, (1, k2 * c, m))
    _expect("woff_tiles_q", woff_tiles_q, torch.int8, (1, k2 * c, 2 * k2))
    for name, t, size in (("off_scale", off_scale, 2 * k2),
                          ("off_bias", off_bias, 2 * k2),
                          ("out_scale", out_scale, m),
                          ("out_bias", out_bias, m)):
        _expect(name, t, torch.float32, (size,))
    kw = dict(kernel_size=kernel_size, stride=stride, dilation=dilation,
              offset_bound=offset_bound, tile_h=tile_h, tile_w=tile_w)
    _check_tiles(x_pad_q, tile_c=tc, tile_m=tm, ho=ho, wo=wo, **kw)
    if x_pad_q.device.type == "cpu":
        return deform_conv_fused_zerocopy_chain_plain(
            x_pad_q, w_tiles_q, woff_tiles_q, off_scale, off_bias,
            out_scale, out_bias, tile_c=tc, tile_m=tm, emit=emit, ho=ho,
            wo=wo, **kw)
    if x_pad_q.device.type != "cuda":
        raise ValueError(f"no kernel for device {x_pad_q.device}")
    _check_cuda(x_pad_q, w_tiles_q=w_tiles_q, woff_tiles_q=woff_tiles_q,
                off_scale=off_scale, off_bias=off_bias, out_scale=out_scale,
                out_bias=out_bias)
    out = torch.empty((n, ho, wo, m), device=x_pad_q.device,
                      dtype=torch.int8 if emit == "int8" else torch.float32)
    lib = load_kernel()
    with torch.cuda.device(x_pad_q.device):
        err = lib.dcc_forward(
            x_pad_q.data_ptr(), w_tiles_q.data_ptr(),
            woff_tiles_q.data_ptr(), off_scale.data_ptr(),
            off_bias.data_ptr(), out_scale.data_ptr(), out_bias.data_ptr(),
            out.data_ptr(), int(emit == "int8"), n, hp, wp, c, ho, wo, m,
            kernel_size, stride, dilation, float(offset_bound),
            int(math.ceil(offset_bound)), tile_h, tile_w, tc, tm,
            torch.cuda.current_stream(x_pad_q.device).cuda_stream)
    if err:
        raise _launch_error(lib, err, "deform_conv_chain")
    deform_conv_fused_zerocopy_chain.launches += 1
    return out


deform_conv_fused_zerocopy_chain.launches = 0
