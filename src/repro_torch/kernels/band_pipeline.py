"""Eq. 6 band geometry and the plain stages shared by the fused kernels and
their plain versions.

Counterpart of the geometry half of ``repro.kernels.band_pipeline``
(``band_geometry``, ``_tap_grid``, ``corner_geometry``, ``BandSpec``, the
fp32 and int8 bilinear gathers and the fused ``offset_conv_stage``).  The
TPU emitter and its staging pipeline have no counterpart here: the CUDA
kernels stage their own bands (``csrc/deform_conv_fused.cu``,
``csrc/deform_conv_q.cu``, ``csrc/deform_sample.cu``).  ``sample_tiles``,
``tile_bands`` and ``untile`` run a stage over every output tile of a
padded plane at once
(``tile_pixels`` and ``tile_offsets`` cut per-pixel tensors into tiles);
``tile_corners``, ``corner_weights`` and ``corner_derivatives`` are the
pieces the plain backward (``deform_conv_bwd``) is built from.
``sample_bands`` is the stage over the materialised bands of the banded
dataflow.

Positions are band-local, as in the TPU kernel: the band of output tile
``(j, w)`` starts at padded row ``j * tile_h * stride`` and column
``w * tile_w * stride``, and tap ``(ky, kx)`` of tile pixel ``(t, u)``
sits at ``(t*S + hb + ky*d, u*S + hb + kx*d)`` plus its clamped offset.
The CUDA kernel does the same float arithmetic, so the plain version and
the kernel agree on every corner index and coefficient.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.core.tiling import band_extent

Tensor = torch.Tensor


def band_geometry(*, kernel_size: int, stride: int, dilation: int,
                  offset_bound: float, tile_h: int) -> tuple[int, int]:
    """(halo, band_h): halo = ceil(B) rows each side; band_h per Eq. 6."""
    hb = int(math.ceil(offset_bound))
    band_h = band_extent(tile_h, kernel_size=kernel_size, stride=stride,
                         dilation=dilation, offset_bound=offset_bound)
    return hb, band_h


def _tap_grid(*, kernel_size: int, stride: int, dilation: int, halo: int,
              tile_h: int, tile_w: int, device=None):
    """Band-local undeformed tap positions of one output tile (int64):
    ``rows`` (tile_h, 1, K*K) and ``cols`` (1, tile_w, K*K)."""
    k, s, d = kernel_size, stride, dilation
    kk = torch.arange(k * k, device=device)
    ky = (kk // k) * d
    kx = (kk % k) * d
    oy = torch.arange(tile_h, device=device) * s + halo
    ox = torch.arange(tile_w, device=device) * s + halo
    rows = oy[:, None, None] + ky[None, None, :]
    cols = ox[None, :, None] + kx[None, None, :]
    return rows, cols


def corner_geometry(off: Tensor, *, kernel_size: int, stride: int,
                    dilation: int, offset_bound: float, tile_h: int,
                    wo: int):
    """Bilinear corner geometry of output tiles in band-local coordinates.

    off: (..., tile_h, wo, K*K, 2) raw offsets, clamped here to ±B as the
    kernels clamp them (``fminf(fmaxf(o, -B), B)``, which takes a NaN to
    -B, so a non-finite input cannot index outside the band).
    Returns (y0, x0, ty, tx), each (..., tile_h, wo, K*K): int64 top-left
    corners and fp32 fractional coefficients.
    """
    hb = int(math.ceil(offset_bound))
    off = off.float()
    off = torch.where(torch.isnan(off), -offset_bound, off) \
        .clamp(-offset_bound, offset_bound)
    rows, cols = _tap_grid(kernel_size=kernel_size, stride=stride,
                           dilation=dilation, halo=hb, tile_h=tile_h,
                           tile_w=wo, device=off.device)
    pos_y = rows.float() + off[..., 0]
    pos_x = cols.float() + off[..., 1]
    y0f = torch.floor(pos_y)
    x0f = torch.floor(pos_x)
    return y0f.long(), x0f.long(), pos_y - y0f, pos_x - x0f


def corner_weights(ty: Tensor, tx: Tensor):
    """Bilinear weights of the corners (00, 01, 10, 11)."""
    return ((1 - ty) * (1 - tx), (1 - ty) * tx, ty * (1 - tx), ty * tx)


def corner_derivatives(v00: Tensor, v01: Tensor, v10: Tensor, v11: Tensor,
                       ty: Tensor, tx: Tensor) -> tuple[Tensor, Tensor]:
    """Derivatives of the bilinear sample by its position, as
    ``repro/kernels/deform_conv_bwd.py`` writes them:
    dval/dpos_y = (1-tx)(v10-v00) + tx(v11-v01) and
    dval/dpos_x = (1-ty)(v01-v00) + ty(v11-v10)."""
    return ((1 - tx) * (v10 - v00) + tx * (v11 - v01),
            (1 - ty) * (v01 - v00) + ty * (v11 - v10))


def gather_bilinear(flat: Tensor, idx00: Tensor, row: int, ty: Tensor,
                    tx: Tensor) -> Tensor:
    """Four-corner bilinear gather from a zero-padded plane.

    flat: (B, L, C) plane with rows of ``row`` elements; idx00, ty, tx:
    (B, P) top-left flat indices and coefficients.  Returns (B, P, C) in
    fp32, corners accumulated in the order (00, 01, 10, 11).
    """
    b = torch.arange(flat.shape[0], device=flat.device)[:, None]

    def corner(idx: Tensor, wgt: Tensor) -> Tensor:
        return flat[b, idx].float() * wgt[..., None]

    w00, w01, w10, w11 = corner_weights(ty, tx)
    out = corner(idx00, w00)
    out = out + corner(idx00 + 1, w01)
    out = out + corner(idx00 + row, w10)
    out = out + corner(idx00 + row + 1, w11)
    return out


def bilinear_from_band(band: Tensor, off: Tensor, *, kernel_size: int,
                       stride: int, dilation: int, offset_bound: float,
                       tile_h: int, wo: int) -> Tensor:
    """Sample one tile's (tile_h, wo, K*K) positions from its band.

    band: (band_h, w_pad, tc) zero-padded rows; off: (tile_h, wo, K*K, 2).
    Returns (tile_h, wo, K*K, tc) in band.dtype.
    """
    k2 = kernel_size * kernel_size
    band_h, w_pad, tc = band.shape
    y0, x0, ty, tx = corner_geometry(
        off, kernel_size=kernel_size, stride=stride, dilation=dilation,
        offset_bound=offset_bound, tile_h=tile_h, wo=wo)
    p = tile_h * wo * k2
    out = gather_bilinear(band.reshape(1, band_h * w_pad, tc),
                          (y0 * w_pad + x0).reshape(1, p), w_pad,
                          ty.reshape(1, p), tx.reshape(1, p))
    return out.reshape(tile_h, wo, k2, tc).to(band.dtype)


def bilinear_int8_from_band(band: Tensor, off: Tensor, *, kernel_size: int,
                            stride: int, dilation: int, offset_bound: float,
                            tile_h: int, wo: int) -> Tensor:
    """Sample an int8 band with fp32 coefficients -> int8 patches, as
    ``repro.kernels.band_pipeline._bilinear_int8_from_band``: the four
    corners in the order (00, 01, 10, 11) with the fp32 gather's
    coefficients, then ``torch.round`` (ties to even).

    band: (band_h, w_pad, tc) int8; off: (tile_h, wo, K*K, 2) raw.
    Returns (tile_h * wo * K*K, tc) int8."""
    k2 = kernel_size * kernel_size
    band_h, w_pad, tc = band.shape
    y0, x0, ty, tx = corner_geometry(
        off, kernel_size=kernel_size, stride=stride, dilation=dilation,
        offset_bound=offset_bound, tile_h=tile_h, wo=wo)
    p = tile_h * wo * k2
    out = gather_bilinear(band.reshape(1, band_h * w_pad, tc),
                          (y0 * w_pad + x0).reshape(1, p), w_pad,
                          ty.reshape(1, p), tx.reshape(1, p))
    return torch.round(out[0]).to(torch.int8)


def contract_int8(lhs: Tensor, rhs: Tensor) -> Tensor:
    """Exact integer product of int8 matrices (..., K) @ (K, M), returned as
    float64.  PyTorch has no int32 matmul on CUDA, and fp32 is exact only
    while |sum| < 2^24; float64 holds every sum of the model's layers
    (|sum| <= 127^2 * K*K * C < 2^53)."""
    return lhs.double() @ rhs.double()


def offset_conv_stage(band: Tensor, woff: Tensor, off_scale: Tensor,
                      off_bias: Tensor, *, kernel_size: int, stride: int,
                      dilation: int, offset_bound: float, tile_h: int,
                      tile_w: int) -> Tensor:
    """Fused offset conv of one or more bands, as
    ``repro.kernels.band_pipeline.offset_conv_stage``: gather the
    undeformed taps (``_tap_grid``) of the whole channel extent, contract
    exactly with the int8 offset-conv weights, then dequantize:
    ``acc.float() * off_scale + off_bias``.

    band: (..., band_h, band_w, C) int8; woff: (K*K*C, 2*K*K) int8 (rows
    tap * C + c); off_scale, off_bias: (2*K*K,) fp32.
    Returns raw fp32 offsets (..., tile_h, tile_w, K*K, 2)."""
    k2 = kernel_size * kernel_size
    *lead, band_h, band_w, c = band.shape
    rows, cols = _tap_grid(kernel_size=kernel_size, stride=stride,
                           dilation=dilation,
                           halo=int(math.ceil(offset_bound)), tile_h=tile_h,
                           tile_w=tile_w, device=band.device)
    idx = (rows * band_w + cols).reshape(-1)
    taps = band.reshape(*lead, band_h * band_w, c)[..., idx, :]
    acc = contract_int8(taps.reshape(*lead, tile_h * tile_w, k2 * c), woff)
    off = acc.float() * off_scale + off_bias
    return off.reshape(*lead, tile_h, tile_w, k2, 2)


def tile_pixels(t: Tensor, tile_h: int, tile_w: int) -> Tensor:
    """(N, Ho, Wo, D) -> (N, ht, wt, tile_h, tile_w, D), zero-padded to
    whole tiles."""
    n, ho, wo, d = t.shape
    ht, wt = -(-ho // tile_h), -(-wo // tile_w)
    t = F.pad(t, (0, 0, 0, wt * tile_w - wo, 0, ht * tile_h - ho))
    return t.reshape(n, ht, tile_h, wt, tile_w, d).permute(0, 1, 3, 2, 4, 5)


def tile_offsets(offsets: Tensor, tile_h: int, tile_w: int) -> Tensor:
    """(N, Ho, Wo, 2*K*K) raw offsets -> (N, ht, wt, tile_h, tile_w, K*K,
    2), zero-padded to whole tiles."""
    off = tile_pixels(offsets, tile_h, tile_w)
    return off.reshape(*off.shape[:5], -1, 2)


def tile_bands(x_pad: Tensor, *, ht: int, wt: int, tile_h: int,
               tile_w: int, stride: int, band_h: int, band_w: int) -> Tensor:
    """Every tile's Eq. 6 band of a padded plane: (N, ht, wt, band_h,
    band_w, C); band (j, w) starts at row j*tile_h*stride and column
    w*tile_w*stride."""
    dev = x_pad.device
    rows = (torch.arange(ht, device=dev)[:, None] * tile_h * stride
            + torch.arange(band_h, device=dev)[None, :])
    cols = (torch.arange(wt, device=dev)[:, None] * tile_w * stride
            + torch.arange(band_w, device=dev)[None, :])
    return x_pad[:, rows[:, None, :, None], cols[None, :, None, :]]


def tile_corners(x_pad: Tensor, off_t: Tensor, *, kernel_size: int,
                 stride: int, dilation: int, offset_bound: float):
    """Top-left corner of every tap of every output tile in the flat
    padded plane, with its fractions: the band-local ``corner_geometry``
    shifted by the tile's band origin.  off_t: (N, ht, wt, tile_h, tile_w,
    K*K, 2) raw offsets (``tile_offsets``).  Returns (idx00, ty, tx), each
    (N, ht, wt, tile_h, tile_w, K*K); the other corners are ``idx00 + 1``,
    ``idx00 + Wp`` and ``idx00 + Wp + 1``."""
    _, hp, wp, _ = x_pad.shape
    _, ht, wt, th, tw, _, _ = off_t.shape
    BandSpec(kernel_size, stride, dilation, offset_bound, th,
             tw).check_padded(hp, wp, ht, wt)
    y0, x0, ty, tx = corner_geometry(
        off_t, kernel_size=kernel_size, stride=stride, dilation=dilation,
        offset_bound=offset_bound, tile_h=th, wo=tw)
    dev = x_pad.device
    row0 = (torch.arange(ht, device=dev) * th * stride).view(ht, 1, 1, 1, 1)
    col0 = (torch.arange(wt, device=dev) * tw * stride).view(1, wt, 1, 1, 1)
    return (y0 + row0) * wp + (x0 + col0), ty, tx


def sample_tiles(x_pad: Tensor, off_t: Tensor, *, kernel_size: int,
                 stride: int, dilation: int, offset_bound: float) -> Tensor:
    """Bilinear samples of every output tile from its band of the padded
    plane, in fp32: the band-local corner geometry of the kernels, shifted
    to the plane.  off_t: (N, ht, wt, tile_h, tile_w, K*K, 2) raw offsets
    (``tile_offsets``).  Returns (N, ht, wt, tile_h, tile_w, K*K, C)."""
    n, hp, wp, c = x_pad.shape
    idx00, ty, tx = tile_corners(
        x_pad, off_t, kernel_size=kernel_size, stride=stride,
        dilation=dilation, offset_bound=offset_bound)
    p = idx00.numel() // n
    patches = gather_bilinear(x_pad.reshape(n, hp * wp, c),
                              idx00.reshape(n, p), wp,
                              ty.reshape(n, p), tx.reshape(n, p))
    return patches.reshape(*idx00.shape, c)


def sample_bands(bands: Tensor, offsets: Tensor, *, kernel_size: int,
                 stride: int, dilation: int, offset_bound: float,
                 tile_h: int) -> Tensor:
    """Bilinear samples of every row tile from its materialised band
    (the banded dataflow), in fp32.  bands: (N, n_tiles, band_h, w_pad,
    C) from ``plan.pad_and_band``; offsets: (N, n_tiles * tile_h, Wo,
    2*K*K) raw.  Each band tile is sampled over the full width, as the
    TPU kernel does: column positions ``ox*S + hb + kx*d`` of the whole
    band.  Returns (N, n_tiles * tile_h, Wo, K*K, C)."""
    n, nt, band_h, w_pad, c = bands.shape
    _, ho, wo, _ = offsets.shape
    k2 = kernel_size * kernel_size
    y0, x0, ty, tx = corner_geometry(
        offsets.reshape(n, nt, tile_h, wo, k2, 2), kernel_size=kernel_size,
        stride=stride, dilation=dilation, offset_bound=offset_bound,
        tile_h=tile_h, wo=wo)
    p = tile_h * wo * k2
    patches = gather_bilinear(bands.reshape(n * nt, band_h * w_pad, c),
                              (y0 * w_pad + x0).reshape(n * nt, p), w_pad,
                              ty.reshape(n * nt, p), tx.reshape(n * nt, p))
    return patches.reshape(n, ho, wo, k2, c)


def check_banded(bands: Tensor, offsets: Tensor, *, kernel_size: int,
                 stride: int, dilation: int, offset_bound: float,
                 tile_h: int) -> None:
    """Raise unless ``bands`` are the Eq. 6 bands of ``tile_h`` rows that
    ``offsets`` (``n_tiles * tile_h`` rows) need."""
    n, nt, band_h, _, _ = bands.shape
    k2 = kernel_size * kernel_size
    if tuple(offsets.shape[:2]) != (n, nt * tile_h) \
            or offsets.shape[-1] != 2 * k2:
        raise ValueError(f"offsets {tuple(offsets.shape)} do not match "
                         f"bands {tuple(bands.shape)} at tile_h={tile_h}, "
                         f"K={kernel_size}")
    want = BandSpec(kernel_size, stride, dilation, offset_bound, tile_h,
                    1).band_h
    if band_h != want:
        raise ValueError(f"bands have {band_h} rows; tile_h={tile_h} needs "
                         f"{want}")


def untile(y: Tensor, ho: int, wo: int) -> Tensor:
    """(N, ht, wt, tile_h, tile_w, M) -> (N, Ho, Wo, M), the ragged edge
    cut off."""
    n, ht, wt, th, tw, m = y.shape
    y = y.permute(0, 1, 3, 2, 4, 5).reshape(n, ht * th, wt * tw, m)
    return y[:, :ho, :wo]


@dataclasses.dataclass(frozen=True)
class BandSpec:
    """Eq. 6 band geometry of one bounded DCL call."""
    kernel_size: int
    stride: int
    dilation: int
    offset_bound: float
    tile_h: int
    tile_w: int

    @property
    def k2(self) -> int:
        return self.kernel_size * self.kernel_size

    @property
    def halo(self) -> int:
        return int(math.ceil(self.offset_bound))

    def _extent(self, tile: int) -> int:
        return band_geometry(kernel_size=self.kernel_size,
                             stride=self.stride, dilation=self.dilation,
                             offset_bound=self.offset_bound, tile_h=tile)[1]

    @property
    def band_h(self) -> int:
        return self._extent(self.tile_h)

    @property
    def band_w(self) -> int:
        return self._extent(self.tile_w)

    def check_padded(self, hp: int, wp: int, h_tiles: int,
                     w_tiles: int) -> None:
        """Raise unless every tile's band lies inside the padded input."""
        s = self.stride
        if (h_tiles - 1) * self.tile_h * s + self.band_h > hp:
            raise ValueError(f"padded input has {hp} rows; {h_tiles} row "
                             f"tiles need {(h_tiles - 1) * self.tile_h * s + self.band_h}")
        if (w_tiles - 1) * self.tile_w * s + self.band_w > wp:
            raise ValueError(f"padded input has {wp} columns; {w_tiles} "
                             f"column tiles need "
                             f"{(w_tiles - 1) * self.tile_w * s + self.band_w}")
