"""Eq. 6 band algebra and the Hopper tile chooser of the fused DCL kernel.

``band_extent`` and ``out_hw`` are the JAX package's geometry, unchanged.
``choose_kernel_tiles`` replaces the TPU chooser, whose budget was a TPU's
vector memory: here a thread block gets at most 227 KB of shared memory
and the card has 132 SMs to fill.  The chooser is a plain function of the
layer's shape and datapath (no cache, no tuning table); ``smem_bytes``,
``q_smem_bytes`` and ``bwd_smem_bytes`` mirror the kernels' own
``*_smem_bytes`` exports (``sample_smem_bytes`` that of the sampling
kernels).  The TPU chooser's scheduling knobs (``cores``,
``dw_flush_every_step``) have no counterpart here.
"""
from __future__ import annotations

import dataclasses
import math

# H100 SXM (NVIDIA's data sheet / Hopper tuning guide).
SM_COUNT = 132
SMEM_PER_BLOCK = 232_448          # 227 KB, dynamic shared memory opt-in

# Register tile of the kernel (src/repro_torch/kernels/csrc/
# deform_conv_fused.cu): a block computes up to PIX_LANES output pixels
# by TILE_M_MAX output channels, 4 x 4 per thread.
TILE_M_MAX = 64
PIX_LANES = (16, 32, 64)


def band_extent(tile: int, *, kernel_size: int, stride: int,
                dilation: int = 1, offset_bound: float) -> int:
    """Eq. 6 band extent along one axis for an output tile of ``tile``
    positions (the +2 covers the bilinear x0+1 corner on each side)."""
    hb = int(math.ceil(float(offset_bound)))
    return (tile - 1) * stride + (kernel_size - 1) * dilation + 2 * hb + 2


def out_hw(h: int, w: int, *, kernel_size: int, stride: int,
           dilation: int = 1) -> tuple[int, int]:
    """'Same'-padded output spatial dims of one DCL invocation."""
    pad = dilation * (kernel_size // 2)
    ho = (h + 2 * pad - dilation * (kernel_size - 1) - 1) // stride + 1
    wo = (w + 2 * pad - dilation * (kernel_size - 1) - 1) // stride + 1
    return ho, wo


def pix_lanes(tile_h: int, tile_w: int) -> int:
    """Pixel lanes of the kernel instantiation that serves a tile."""
    for p in PIX_LANES:
        if tile_h * tile_w <= p:
            return p
    raise ValueError(f"tile {tile_h}x{tile_w} exceeds the kernel's "
                     f"{PIX_LANES[-1]} pixels per block")


def smem_bytes(tile_h: int, tile_w: int, tile_c: int, *, kernel_size: int,
               stride: int, dilation: int, offset_bound: float) -> int:
    """Dynamic shared memory of one block; mirrors ``dcf_smem_bytes`` in
    the CUDA source: the band (channel-major, odd plane stride, rounded
    to 4 floats), the patch tile, the weight tile and the corner
    geometry (index, ty, tx per tap and pixel)."""
    pix = pix_lanes(tile_h, tile_w)
    k2 = kernel_size * kernel_size
    bh = band_extent(tile_h, kernel_size=kernel_size, stride=stride,
                     dilation=dilation, offset_bound=offset_bound)
    bw = band_extent(tile_w, kernel_size=kernel_size, stride=stride,
                     dilation=dilation, offset_bound=offset_bound)
    band = tile_c * ((bh * bw) | 1)
    band = -(-band // 4) * 4
    kk = k2 * tile_c
    return 4 * (band + kk * pix + kk * TILE_M_MAX + 3 * k2 * pix)


def q_smem_bytes(tile_h: int, tile_w: int, tile_c: int, *, kernel_size: int,
                 stride: int, dilation: int, offset_bound: float,
                 chain: bool = False) -> int:
    """Dynamic shared memory of one block of the int8 kernels; mirrors
    ``dcq_smem_bytes`` / ``dcc_smem_bytes`` in ``csrc/deform_conv_q.cu``.
    Everything is counted in 32-bit words of four channels: the band
    (channel-group-major, odd plane stride, rounded to 4 words), the
    patch tile, the weight tile and the corner geometry (index and four
    coefficients per tap and pixel); the chain kernel adds the offset-conv
    weight tile and the offset accumulators."""
    if tile_c % 4:
        raise ValueError(f"tile_c={tile_c}: the int8 kernels contract packed "
                         f"4-channel words, so tile_c must be a multiple "
                         f"of 4")
    pix = pix_lanes(tile_h, tile_w)
    k2 = kernel_size * kernel_size
    bh = band_extent(tile_h, kernel_size=kernel_size, stride=stride,
                     dilation=dilation, offset_bound=offset_bound)
    bw = band_extent(tile_w, kernel_size=kernel_size, stride=stride,
                     dilation=dilation, offset_bound=offset_bound)
    kk4 = k2 * (tile_c // 4)
    band = -(-(tile_c // 4) * ((bh * bw) | 1) // 4) * 4
    words = band + kk4 * pix + kk4 * TILE_M_MAX + 5 * k2 * pix
    if chain:
        words += kk4 * 2 * k2 + pix * 2 * k2
    return 4 * words


# The backward kernel (csrc/deform_conv_bwd.cu): rows of K*K*tile_c per
# d_weights block, output channels of g and W per dP step, output channels
# per d_weights block.
BWD_ROWS = 64
BWD_MC = 16
BWD_TM = 64


def bwd_smem_bytes(tile_h: int, tile_w: int, tile_c: int, *,
                   kernel_size: int, stride: int, dilation: int,
                   offset_bound: float) -> int:
    """Dynamic shared memory of one block of the backward's d_input /
    d_offsets kernel, the larger of its two; mirrors ``dcb_smem_bytes``
    in ``csrc/deform_conv_bwd.cu``: the staged band chunk and the fp32
    d_input band accumulator (channel-major, odd plane stride, rounded to
    4 floats each), the dP chunk (K*K*tile_c rows padded to 4, by the
    pixel lanes), one step of W^T and of g^T (16 output channels, rows
    padded by 4), and per tap and pixel the corner geometry (index, ty,
    tx) and the two d_offsets sums."""
    pix = pix_lanes(tile_h, tile_w)
    k2 = kernel_size * kernel_size
    bh = band_extent(tile_h, kernel_size=kernel_size, stride=stride,
                     dilation=dilation, offset_bound=offset_bound)
    bw = band_extent(tile_w, kernel_size=kernel_size, stride=stride,
                     dilation=dilation, offset_bound=offset_bound)
    band = -(-tile_c * ((bh * bw) | 1) // 4) * 4
    kkp = -(-k2 * tile_c // 4) * 4
    return 4 * (2 * band + kkp * pix + BWD_MC * (kkp + 4)
                + BWD_MC * (pix + 4) + 5 * k2 * pix)


# The sampling kernels (csrc/deform_sample.cu): a block writes tile_c <= 32
# channels of each (pixel, tap), one 128-byte line of fp32 patches.
SAMPLE_TC_MAX = 32
# The banded dataflow's row tile when the caller gives none (the JAX
# ``plan.bounded_forward`` and ``ops.deform_sample`` default).
BANDED_TILE_H = 8


def sample_smem_bytes(tile_h: int, tile_w: int, tile_c: int, *,
                      kernel_size: int, stride: int, dilation: int,
                      offset_bound: float) -> int:
    """Dynamic shared memory of one block of the sampling kernels; mirrors
    ``ds_smem_bytes`` in ``csrc/deform_sample.cu``: the band chunk
    (position-major, channels innermost) and the corner geometry (index,
    ty, tx per tap and pixel)."""
    k2 = kernel_size * kernel_size
    bh = band_extent(tile_h, kernel_size=kernel_size, stride=stride,
                     dilation=dilation, offset_bound=offset_bound)
    bw = band_extent(tile_w, kernel_size=kernel_size, stride=stride,
                     dilation=dilation, offset_bound=offset_bound)
    return 4 * (bh * bw * tile_c + 3 * k2 * tile_h * tile_w)


BWD_ROW_BLOCKS = 5   # 64-row blocks one d_weights block takes, at most
BWD_MAX_QUADS = 3 * 256   # 4x4 dP tiles of a d_input block (3 a thread)


def bwd_quads(tile_h: int, tile_w: int, tile_c: int, *,
              kernel_size: int) -> int:
    """4x4 register tiles of the d_input kernel's dP chunk: rows of
    K*K*tile_c (padded to 4) by pixel lanes, four by four."""
    k2 = kernel_size * kernel_size
    return -(-k2 * tile_c // 4) * (pix_lanes(tile_h, tile_w) // 4)


def bwd_dw_splits(n: int, ho: int, wo: int, c: int, m: int, *,
                  kernel_size: int, tile_h: int, tile_w: int,
                  tile_c: int) -> int:
    """Pixel splits of the backward's d_weights kernel: its grid is
    (C / tile_c) x (groups of up to five 64-row blocks of K*K*tile_c) x
    (64-channel blocks of M) x splits; enough splits for two blocks per
    SM, at most one per output tile."""
    rows = -(-kernel_size * kernel_size * tile_c // BWD_ROWS)
    groups = -(-rows // min(rows, BWD_ROW_BLOCKS))
    base = (c // tile_c) * groups * -(-m // BWD_TM)
    tiles = n * -(-ho // tile_h) * -(-wo // tile_w)
    return max(1, min(tiles, -(-2 * SM_COUNT // base)))


DTYPES = ("fp32", "int8", "int8_chain", "fp32_bwd", "sample", "banded")


@dataclasses.dataclass(frozen=True)
class KernelTiles:
    tile_h: int
    tile_w: int
    tile_c: int
    tile_m: int


def _divisor_at_most(n: int, cap: int) -> int:
    for d in range(min(n, cap), 0, -1):
        if n % d == 0:
            return d
    return 1


def grid_blocks(n: int, ho: int, wo: int, m: int, t: KernelTiles) -> int:
    return (n * -(-ho // t.tile_h) * -(-wo // t.tile_w)
            * -(-m // t.tile_m))


def choose_kernel_tiles(n: int, h: int, w: int, c: int, m: int, *,
                        kernel_size: int, stride: int, dilation: int = 1,
                        offset_bound: float, dtype: str = "fp32",
                        tile_h: int | None = None) -> KernelTiles:
    """Tiles of the fused kernels for one layer shape and datapath
    (``dtype``: ``"fp32"`` for ``deform_conv_fused.cu``, ``"int8"`` and
    ``"int8_chain"`` for the two kernels of ``deform_conv_q.cu``,
    ``"fp32_bwd"`` for the backward of ``deform_conv_bwd.cu``,
    ``"sample"`` for the sampling kernels of ``deform_sample.cu`` and
    ``"banded"`` for the banded forward of ``deform_conv_fused.cu``).

    * ``tile_m``: the largest divisor of M up to the kernel's 64 lanes
      (``"sample"``: ``tile_c``, the channels a block writes).
    * spatial: 8x8 clamped to the output; while the grid has fewer
      blocks than the card has SMs, halve the longer side, down to 16
      pixels per block (the backward's grid counts no M tiles, the
      sampling kernels' counts C / tile_c).  A given ``tile_h`` fixes the
      rows (not clamped to the output: the caller clamps) and only
      ``tile_w`` is halved; ``"banded"`` always fixes them at the bands'
      row tile (default ``BANDED_TILE_H``), so a block covers a whole
      band tile's rows and ``tile_w`` of its columns.
    * ``tile_c``, fp32 and banded: the largest divisor of C up to 32
      whose block fits twice in an SM's shared memory (so two blocks can
      be resident), else the largest that fits once.
    * ``tile_c``, int8: the largest multiple-of-4 divisor of C up to 64
      whose block fits four times in an SM (a quarter of the fp32 bytes
      per channel), else twice, else once.  The chain kernel streams C in
      these chunks too (two passes, see ``deform_conv_q.cu``), so its
      ``tile_c`` is not pinned to C.
    * ``tile_c``, fp32_bwd: as fp32, against the backward's own model
      (``bwd_smem_bytes``), and at most ``BWD_MAX_QUADS`` dP register
      tiles (``bwd_quads``); ``tile_m`` only shapes the forward's grid.
    * ``tile_c``, sample: no contraction, so the block is sized by what it
      writes, ``tile_h * tile_w * K*K * tile_c`` patches: the largest
      divisor of C up to ``SAMPLE_TC_MAX`` whose band chunk fits four
      times in an SM, else twice, else once.
    None fitting raises.
    """
    if dtype not in DTYPES:
        raise ValueError(f"unknown kernel dtype {dtype!r}; expected one of "
                         f"{DTYPES}")
    ho, wo = out_hw(h, w, kernel_size=kernel_size, stride=stride,
                    dilation=dilation)
    if tile_h is None:
        th = BANDED_TILE_H if dtype == "banded" else min(8, ho)
    else:
        th = tile_h
    tw = min(8, wo)
    if dtype == "banded":
        if th > PIX_LANES[-1]:
            raise ValueError(f"tile_h={th}: a banded block covers a whole "
                             f"band tile's rows, at most {PIX_LANES[-1]}")
        tw = min(tw, PIX_LANES[-1] // th)
    geom = dict(kernel_size=kernel_size, stride=stride, dilation=dilation,
                offset_bound=offset_bound)
    if dtype == "sample":
        cands = sorted({_divisor_at_most(c, cap)
                        for cap in (SAMPLE_TC_MAX, 16, 8, 4, 2, 1)},
                       reverse=True)
        # The grid's third axis is C / tile_c (counted at the widest chunk).
        grid_c, grid_t = c, cands[0]
    else:
        tm = _divisor_at_most(m, TILE_M_MAX)
        # The backward's d_input kernel has no M axis in its grid.
        grid_c, grid_t = m, (m if dtype == "fp32_bwd" else tm)
    while (grid_blocks(n, ho, wo, grid_c, KernelTiles(th, tw, 1, grid_t))
           < SM_COUNT and th * tw > 16):
        if th >= tw and tile_h is None and dtype != "banded":
            th = -(-th // 2)
        elif tw > 1:
            tw = -(-tw // 2)
        else:
            break
    if dtype == "sample":
        budgets = (SMEM_PER_BLOCK // 4, SMEM_PER_BLOCK // 2, SMEM_PER_BLOCK)

        def block_bytes(tc):
            return sample_smem_bytes(th, tw, tc, **geom)
    elif dtype in ("fp32", "fp32_bwd", "banded"):
        cands = sorted({_divisor_at_most(c, cap)
                        for cap in (32, 16, 8, 4, 2, 1)}, reverse=True)
        budgets = (SMEM_PER_BLOCK // 2, SMEM_PER_BLOCK)
        model = bwd_smem_bytes if dtype == "fp32_bwd" else smem_bytes
        if dtype == "fp32_bwd":
            cands = [tc for tc in cands if bwd_quads(
                th, tw, tc, kernel_size=kernel_size) <= BWD_MAX_QUADS]

        def block_bytes(tc):
            return model(th, tw, tc, **geom)
    else:
        if c % 4:
            raise ValueError(
                f"C={c}: the int8 kernels contract packed 4-channel words, "
                f"so C must be a multiple of 4")
        cands = sorted({4 * _divisor_at_most(c // 4, cap // 4)
                        for cap in (64, 32, 16, 8, 4)}, reverse=True)
        budgets = (SMEM_PER_BLOCK // 4, SMEM_PER_BLOCK // 2, SMEM_PER_BLOCK)

        def block_bytes(tc):
            return q_smem_bytes(th, tw, tc, chain=dtype == "int8_chain",
                                **geom)
    for budget in budgets:
        for tc in cands:
            if block_bytes(tc) <= budget:
                return KernelTiles(th, tw, tc,
                                   tc if dtype == "sample" else tm)
    raise ValueError(
        f"no channel tile fits {SMEM_PER_BLOCK} bytes of shared memory for "
        f"a {th}x{tw} tile at B={offset_bound}, stride {stride}, dilation "
        f"{dilation}: the Eq. 6 band is too large — train with a smaller "
        f"offset bound")
