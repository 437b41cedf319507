"""Eq. 6 band geometry shared by the fused kernel and its plain version.

Counterpart of the geometry half of ``repro.kernels.band_pipeline``
(``band_geometry``, ``_tap_grid``, ``corner_geometry``, ``BandSpec`` and
the fp32 bilinear gather).  The TPU emitter and its staging pipeline have
no counterpart here: the CUDA kernel stages its own bands
(``csrc/deform_conv_fused.cu``).

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

    off: (..., tile_h, wo, K*K, 2) raw offsets, clamped here to ±B.
    Returns (y0, x0, ty, tx), each (..., tile_h, wo, K*K): int64 top-left
    corners and fp32 fractional coefficients.
    """
    hb = int(math.ceil(offset_bound))
    off = off.float().clamp(-offset_bound, offset_bound)
    rows, cols = _tap_grid(kernel_size=kernel_size, stride=stride,
                           dilation=dilation, halo=hb, tile_h=tile_h,
                           tile_w=wo, device=off.device)
    pos_y = rows.float() + off[..., 0]
    pos_x = cols.float() + off[..., 1]
    y0f = torch.floor(pos_y)
    x0f = torch.floor(pos_x)
    return y0f.long(), x0f.long(), pos_y - y0f, pos_x - x0f


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

    out = corner(idx00, (1 - ty) * (1 - tx))
    out = out + corner(idx00 + 1, (1 - ty) * tx)
    out = out + corner(idx00 + row, ty * (1 - tx))
    out = out + corner(idx00 + row + 1, ty * tx)
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
