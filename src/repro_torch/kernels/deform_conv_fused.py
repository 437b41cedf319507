"""Fused bounded DCL forward: bilinear sampling + dynamic convolution.

Counterpart of ``repro.kernels.deform_conv_fused``: ``deform_conv_fused_
zerocopy`` (TPU kernel 1a, the fp32 and bf16 plans of
``band_pipeline.forward_call``) takes the zero-padded input whole,
``deform_conv_fused_banded`` (TPU kernel 4) the HBM-materialised bands of
``plan.pad_and_band``; both take the raw offsets and the channel-blocked
weights.  On a CUDA tensor each wrapper launches its entry point of the
hand-written kernel of ``csrc/deform_conv_fused.cu``, in its fp32 or its
bf16 instance (the input's and the weights' dtype; offsets fp32 or bf16),
on a CPU tensor it runs the plain PyTorch version below, which does the
same band-local arithmetic: patches gathered in fp32, rounded to the
input's dtype (as the TPU kernel rounds them), contracted with fp32
accumulation, the output rounded once to the input's dtype.  There is no
fallback from one to the other: a failed launch raises.

Unlike the TPU kernel, the ragged edge of the zero-copy kernel needs no
padded offsets: Ho and Wo need not be tile multiples (the input must
still be padded for ``ceil(Ho / tile_h)`` row tiles, see
``plan.pad_zerocopy``).  The banded kernel keeps the JAX contract: the
offsets have ``n_tiles * tile_h`` rows.

Both kernels split C into groups where the output tiles alone would
leave the card idle (``fwd_plan``); the groups' fp32 partials go to a
workspace the wrapper allocates and a second kernel adds them in group
order, so the output is the same bit for bit from call to call.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels._staging import (KERNEL_DTYPES, band_vec,
                                          count_launch)
from repro_torch.kernels.band_pipeline import (BandSpec, check_banded,
                                               sample_bands, sample_tiles,
                                               tile_offsets, untile)

Tensor = torch.Tensor


def _check(x_pad: Tensor, offsets: Tensor, w_tiles: Tensor, *,
           kernel_size: int, tile_c: int) -> None:
    """x_pad (N, Hp, Wp, C), or bands (N, n_tiles, band_h, w_pad, C)."""
    n, c = x_pad.shape[0], x_pad.shape[-1]
    k2 = kernel_size * kernel_size
    if offsets.shape[0] != n or offsets.shape[-1] != 2 * k2:
        raise ValueError(f"offsets {tuple(offsets.shape)} do not match "
                         f"input {tuple(x_pad.shape)} at K={kernel_size}")
    if c % tile_c or tuple(w_tiles.shape[:2]) != (c // tile_c, k2 * tile_c):
        raise ValueError(f"w_tiles {tuple(w_tiles.shape)} is not C={c} "
                         f"blocked by tile_c={tile_c} at K={kernel_size}")


def load_kernel():
    """Build (first time only) and load the kernel's library."""
    from repro_torch.kernels import _build
    return _build.load("deform_conv_fused")


def fwd_plan(n: int, ho: int, wo: int, c: int, m: int, *, tile_h: int,
             tile_w: int, tile_c: int, tile_m: int) -> dict:
    """The kernel's grid for one call (``core.tiling``'s mirror of
    ``csrc/deform_conv_fused.cu``): pixel lanes of the instance, output
    tiles, M tiles and the C groups the grid splits C into."""
    from repro_torch.core import tiling as T
    return dict(
        lanes=T.pix_lanes(tile_h, tile_w),
        tiles=n * -(-ho // tile_h) * -(-wo // tile_w),
        m_tiles=-(-m // tile_m),
        c_groups=T.fwd_c_groups(n, ho, wo, c, m, tile_h=tile_h,
                                tile_w=tile_w, tile_c=tile_c, tile_m=tile_m))


def staging_vec(src: Tensor, w_tiles: Tensor, tile_c: int,
                tile_m: int) -> int:
    """How the kernel stages its chunks, for the source's element size:
    bit 0, W in 16-byte copies (M and tile_m multiples of 16 bytes'
    elements, w_tiles 16-byte aligned); the band as ``_staging.band_vec``."""
    per_16 = 16 // src.element_size()
    w = w_tiles.shape[2] % per_16 == 0 and tile_m % per_16 == 0 \
        and w_tiles.data_ptr() % 16 == 0
    return int(w) | band_vec(src, tile_c)


def _check_launch(src: Tensor, offsets: Tensor, w_tiles: Tensor,
                  names: tuple[str, str, str], tile_h: int, tile_w: int,
                  tm: int) -> None:
    """What the kernel takes: contiguous tensors on one device, the source
    and the weights both float32 or both bfloat16, the offsets either; at
    most 64 pixels and ``FWD_TILE_M`` output channels a block."""
    from repro_torch.core.tiling import FWD_TILE_M, pix_lanes
    for name, t in zip(names, (src, offsets, w_tiles)):
        if t.dtype not in KERNEL_DTYPES or not t.is_contiguous() \
                or t.device != src.device:
            raise ValueError(f"{name} must be a contiguous float32 or "
                             f"bfloat16 tensor on {src.device}")
    if w_tiles.dtype != src.dtype:
        raise ValueError(f"{names[2]} is {w_tiles.dtype} but {names[0]} is "
                         f"{src.dtype}: the kernel takes both float32 or "
                         f"both bfloat16")
    pix_lanes(tile_h, tile_w)                 # raises past 64 pixels
    if not 1 <= tm <= FWD_TILE_M:
        raise ValueError(f"tile_m={tm} outside the kernel's 1..{FWD_TILE_M}")


def _launch(fn: str, src: Tensor, offsets: Tensor, w_tiles: Tensor,
            out: Tensor, plan: dict, dims: tuple, geom: tuple,
            tiles: tuple) -> None:
    """Allocate the C groups' workspace and launch ``fn`` of the library
    on the current stream; raise if the launch fails."""
    lib = load_kernel()
    groups = plan["c_groups"]
    partial = torch.empty((groups, *out.shape), dtype=torch.float32,
                          device=out.device) if groups > 1 else None
    vec = staging_vec(src, w_tiles, tiles[2], tiles[3])
    with torch.cuda.device(src.device):
        err = getattr(lib, fn)(
            src.data_ptr(), offsets.data_ptr(), w_tiles.data_ptr(),
            out.data_ptr(), None if partial is None else partial.data_ptr(),
            *dims, *geom, *tiles, groups, vec, src.element_size(),
            offsets.element_size(),
            torch.cuda.current_stream(src.device).cuda_stream)
    if err:
        raise RuntimeError(f"{fn} kernel launch failed: "
                           f"{lib.dcf_error_string(err).decode()} ({err})")


def deform_conv_fused_zerocopy_plain(
        x_pad: Tensor, offsets: Tensor, w_tiles: Tensor, *,
        kernel_size: int, stride: int, dilation: int, offset_bound: float,
        tile_h: int, tile_w: int, tile_c: int | None = None,
        tile_m: int | None = None) -> Tensor:
    """Plain PyTorch version of the kernel, on any device.

    Every tile's corner geometry is computed band-locally (as the kernel
    does), shifted to the padded plane, gathered in fp32, rounded to
    x_pad's dtype (as the TPU kernel's gather rounds its patches) and
    contracted one C-chunk at a time with fp32 accumulation (``tile_m``
    only shapes the kernel's grid)."""
    c = x_pad.shape[-1]
    _, ho, wo, _ = offsets.shape
    tc = tile_c or c
    _check(x_pad, offsets, w_tiles, kernel_size=kernel_size, tile_c=tc)
    off_t = tile_offsets(offsets, tile_h, tile_w)
    patches = sample_tiles(x_pad, off_t, kernel_size=kernel_size,
                           stride=stride, dilation=dilation,
                           offset_bound=offset_bound)
    y = contract_chunks(patches.to(x_pad.dtype), w_tiles, tc)
    return untile(y, ho, wo).to(x_pad.dtype)


def contract_chunks(patches: Tensor, w_tiles: Tensor, tile_c: int) -> Tensor:
    """(..., K*K, C) patches times the blocked weights (C // tile_c,
    K*K*tile_c, M), one C-chunk at a time with fp32 accumulation, as the
    kernels step C: both operands converted to fp32 (exact from bf16, so
    a bf16 product is exact too).  Returns (..., M) in fp32."""
    *lead, k2, c = patches.shape
    patches = patches.reshape(-1, k2, c)
    acc = torch.zeros(patches.shape[0], w_tiles.shape[2],
                      dtype=torch.float32, device=patches.device)
    for cs in range(c // tile_c):
        lhs = patches[:, :, cs * tile_c:(cs + 1) * tile_c] \
            .reshape(-1, k2 * tile_c).float()
        acc = acc + lhs @ w_tiles[cs].float()
    return acc.reshape(*lead, -1)


def deform_conv_fused_zerocopy(
        x_pad: Tensor, offsets: Tensor, w_tiles: Tensor, *,
        kernel_size: int, stride: int, dilation: int, offset_bound: float,
        tile_h: int, tile_w: int, tile_c: int | None = None,
        tile_m: int | None = None, c_groups: int | None = None) -> Tensor:
    """Fused DCL over the whole padded input.

    x_pad:   (N, Hp, Wp, C) zero-padded input (``plan.pad_zerocopy``)
    offsets: (N, Ho, Wo, 2*K*K) raw offsets (clamped to ±B inside)
    w_tiles: (C // tile_c, K*K*tile_c, M) from ``plan.tile_weights``
    returns: (N, Ho, Wo, M)

    CPU tensors run the plain version; CUDA tensors launch the kernel
    (x_pad and w_tiles both fp32 or both bf16, offsets either, contiguous,
    ``tile_h * tile_w <= 64``, ``tile_m <= 128``; the output in x_pad's
    dtype) and count the launch in ``deform_conv_fused_zerocopy.launches``
    (a bf16 one also in ``.launches_bf16``).

    ``c_groups`` pins the grid's C groups (default ``fwd_plan``'s, from
    this call's tiles): ``distributed.spatial`` passes the unsharded
    call's, so a height shard sums each pixel's C chunks in the groups
    and order the unsharded kernel does.  The plain version sums the
    chunks in order whatever the groups.
    """
    if x_pad.device.type == "cpu":
        return deform_conv_fused_zerocopy_plain(
            x_pad, offsets, w_tiles, kernel_size=kernel_size, stride=stride,
            dilation=dilation, offset_bound=offset_bound, tile_h=tile_h,
            tile_w=tile_w, tile_c=tile_c, tile_m=tile_m)
    if x_pad.device.type != "cuda":
        raise ValueError(f"no kernel for device {x_pad.device}")
    from repro_torch.core.tiling import FWD_TILE_M

    n, hp, wp, c = x_pad.shape
    _, ho, wo, _ = offsets.shape
    m = w_tiles.shape[2]
    tc = tile_c or c
    tm = tile_m or min(m, FWD_TILE_M)
    _check(x_pad, offsets, w_tiles, kernel_size=kernel_size, tile_c=tc)
    _check_launch(x_pad, offsets, w_tiles, ("x_pad", "offsets", "w_tiles"),
                  tile_h, tile_w, tm)
    BandSpec(kernel_size, stride, dilation, offset_bound, tile_h,
             tile_w).check_padded(hp, wp, -(-ho // tile_h), -(-wo // tile_w))

    out = torch.empty((n, ho, wo, m), dtype=x_pad.dtype,
                      device=x_pad.device)
    plan = fwd_plan(n, ho, wo, c, m, tile_h=tile_h, tile_w=tile_w,
                    tile_c=tc, tile_m=tm)
    if c_groups is not None:
        if not 1 <= c_groups <= c // tc:
            raise ValueError(f"c_groups={c_groups} outside 1..{c // tc} "
                             f"(C={c} in chunks of {tc})")
        plan["c_groups"] = c_groups
    _launch("dcf_forward", x_pad, offsets, w_tiles, out, plan,
            (n, hp, wp, c, ho, wo, m),
            (kernel_size, stride, dilation, float(offset_bound),
             int(math.ceil(offset_bound))), (tile_h, tile_w, tc, tm))
    count_launch(deform_conv_fused_zerocopy, x_pad)
    return out


deform_conv_fused_zerocopy.launches = 0
deform_conv_fused_zerocopy.launches_bf16 = 0


def deform_conv_fused_banded_plain(
        bands: Tensor, offsets: Tensor, w_tiles: Tensor, *,
        kernel_size: int, stride: int, dilation: int, offset_bound: float,
        tile_h: int, tile_w: int | None = None, tile_c: int | None = None,
        tile_m: int | None = None) -> Tensor:
    """Plain PyTorch version of kernel 4, on any device: each band tile
    sampled over the full width (``band_pipeline.sample_bands``), rounded
    to the bands' dtype, then contracted one C-chunk at a time with fp32
    accumulation (``tile_w`` and ``tile_m`` only shape the kernel's
    grid)."""
    c = bands.shape[-1]
    tc = tile_c or c
    _check(bands, offsets, w_tiles, kernel_size=kernel_size,
           tile_c=tc)
    patches = sample_bands(bands, offsets, kernel_size=kernel_size,
                           stride=stride, dilation=dilation,
                           offset_bound=offset_bound, tile_h=tile_h)
    return contract_chunks(patches.to(bands.dtype), w_tiles,
                           tc).to(bands.dtype)


def deform_conv_fused_banded(
        bands: Tensor, offsets: Tensor, w_tiles: Tensor, *,
        kernel_size: int, stride: int, dilation: int, offset_bound: float,
        tile_h: int, tile_w: int | None = None, tile_c: int | None = None,
        tile_m: int | None = None) -> Tensor:
    """Fused DCL over pre-banded input (kernel 4).

    bands:   (N, n_tiles, band_h, w_pad, C) from ``plan.pad_and_band``
    offsets: (N, n_tiles * tile_h, Wo, 2*K*K) raw offsets
    w_tiles: (C // tile_c, K*K*tile_c, M) from ``plan.tile_weights``
    returns: (N, n_tiles * tile_h, Wo, M)

    A block of the kernel takes a band tile's ``tile_h`` rows, ``tile_w``
    output columns (default: as many as fit 64 pixels, at most 8) and
    ``tile_m`` output channels (default: up to 128), stepping C in
    ``tile_c`` chunks.  CPU tensors run the plain version; CUDA tensors
    launch the kernel (bands and w_tiles both fp32 or both bf16, offsets
    either, contiguous, ``tile_h * tile_w <= 64``, ``tile_m <= 128``; the
    output in the bands' dtype) and count the launch in
    ``deform_conv_fused_banded.launches`` (a bf16 one also in
    ``.launches_bf16``).
    """
    if bands.device.type == "cpu":
        return deform_conv_fused_banded_plain(
            bands, offsets, w_tiles, kernel_size=kernel_size, stride=stride,
            dilation=dilation, offset_bound=offset_bound, tile_h=tile_h,
            tile_w=tile_w, tile_c=tile_c, tile_m=tile_m)
    if bands.device.type != "cuda":
        raise ValueError(f"no kernel for device {bands.device}")
    from repro_torch.core.tiling import FWD_TILE_M

    n, nt, band_h, w_pad, c = bands.shape
    _, ho, wo, _ = offsets.shape
    m = w_tiles.shape[2]
    tc = tile_c or c
    tm = tile_m or min(m, FWD_TILE_M)
    tw = tile_w or max(1, min(8, wo, 64 // tile_h))
    _check(bands, offsets, w_tiles, kernel_size=kernel_size,
           tile_c=tc)
    _check_launch(bands, offsets, w_tiles, ("bands", "offsets", "w_tiles"),
                  tile_h, tw, tm)
    check_banded(bands, offsets, kernel_size=kernel_size, stride=stride,
                 dilation=dilation, offset_bound=offset_bound, tile_h=tile_h)

    out = torch.empty((n, ho, wo, m), dtype=bands.dtype,
                      device=bands.device)
    plan = fwd_plan(n, ho, wo, c, m, tile_h=tile_h, tile_w=tw, tile_c=tc,
                    tile_m=tm)
    _launch("dcf_forward_banded", bands, offsets, w_tiles, out, plan,
            (n, nt, band_h, w_pad, c, wo, m),
            (kernel_size, stride, dilation, float(offset_bound),
             int(math.ceil(offset_bound))), (tile_h, tw, tc, tm))
    count_launch(deform_conv_fused_banded, bands)
    return out


deform_conv_fused_banded.launches = 0
deform_conv_fused_banded.launches_bf16 = 0
