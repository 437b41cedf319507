"""Eq. 6 band algebra and the Hopper tile chooser of the fused DCL kernel.

``band_extent`` and ``out_hw`` are the JAX package's geometry, unchanged.
``choose_kernel_tiles`` replaces the TPU chooser, whose budget was a TPU's
vector memory: here a thread block gets at most 227 KB of shared memory
and the card has 132 SMs to fill.  The chooser is a plain function of the
layer's shape and datapath (no cache, no tuning table); ``smem_bytes``,
``q_smem_bytes``, ``bwd_smem_bytes`` and ``bwd_dw_smem_bytes`` mirror the
kernels' own ``*_smem_bytes`` exports at the element size of their
instance (``sample_smem_bytes`` that of the sampling kernels), the
``bwd_*`` planners give the backward kernel its grids and
``fwd_c_groups`` the forward kernels' (fp32, bf16 and int8) C groups.
The TPU chooser's scheduling knobs (``cores``, ``dw_flush_every_step``)
have no counterpart here.

The paper's own buffer algebra (Eqs. 4, 6 and 7: ``receptive_field``,
``input_buffer_size``, ``output_buffer_size``, ``weight_buffer_size``,
with ``LayerShape``, ``TileConfig`` and the paper's ``PAPER_TILES``) is
the JAX package's, unchanged: it describes the paper's FPGA design and
is what ``core.perf_model`` reads.  So are its Sec. 3.2 roofline terms
(``tile_flops``, ``tile_hbm_bytes``, ``two_stage_extra_bytes``,
``TileConfig.onchip_bytes``) and the Eq. 6 inverse
(``max_offset_bound_fitting``), here at one block's shared memory; the
design-space search (``tile_candidates``, ``evaluate_tile``,
``choose_tiles``) runs them at the H100's peaks on a candidate ladder of
this card's.  ``dcl_*_hbm_bytes`` count the bytes the port's kernels
load and store at given tiles (the last section).
"""
from __future__ import annotations

import dataclasses
import functools
import math

# H100 SXM (NVIDIA's data sheet / Hopper tuning guide).
SM_COUNT = 132
SMEM_PER_BLOCK = 232_448          # 227 KB, dynamic shared memory opt-in

# Pixel lanes of the fused forward kernels' instances (fp32 and int8): a
# block computes up to PIX_LANES[-1] output pixels.
PIX_LANES = (16, 32, 64)

# The int8 forward (csrc/deform_conv_q.cu, kernels 1c and 1d): a block of
# 8 warps computes up to PIX_LANES[-1] output pixels by Q_TILE_M output
# channels on the s8 tensor cores, stepping C in chunks of up to Q_TILE_C
# channels (a multiple of 4), Q_STAGES in flight; a chunk of Q_TILE_C_MIN
# channels at a larger pixel tile beats Q_TILE_C at a smaller one.
# K*K*tile_c is padded to whole 32-deep mma steps (``q_rows_pad``), and
# each patch and weight row takes Q_ROW_PAD bytes more.
Q_TILE_M = 128
Q_TILE_C = 32
Q_TILE_C_MIN = 16
Q_STAGES = 2
Q_ROW_PAD = 16

# The fused forward (csrc/deform_conv_fused.cu, kernels 1a and 4, fp32 and
# bf16): a block of 8 warps computes up to PIX_LANES[-1] output pixels by
# FWD_TILE_M output channels on the tensor cores, stepping C in chunks of
# up to FWD_TILE_C channels, two in flight; a chunk of FWD_TILE_C_MIN
# channels at a larger pixel tile beats FWD_TILE_C at a smaller one.
# FWD_SMEM_TWO: the most shared memory a block may take so that two fit an
# SM (228 KB an SM, 1 KB of it reserved a block).  Per element size (4:
# fp32, 2: bf16): FWD_MMA_DEPTH, the rows of one mma step (tf32 m16n8k8,
# bf16 m16n8k16); FWD_P_PAD and FWD_W_PAD, the elements a patch row and a
# weight row take past their data (bank spread: the fp32 W rows are
# XOR-swizzled instead).
FWD_TILE_M = 128
FWD_TILE_C = 8
FWD_TILE_C_MIN = 4
FWD_SMEM_TWO = 233_472 // 2 - 1_024
FWD_MMA_DEPTH = {4: 8, 2: 16}
FWD_P_PAD = {4: 4, 2: 8}
FWD_W_PAD = {4: 0, 2: 8}


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


def spatial_halo_rows(*, kernel_size: int, dilation: int = 1,
                      offset_bound: float) -> int:
    """Input rows each height-shard neighbour contributes to the spatially
    sharded bounded DCL (``distributed.spatial``).

    Output row ``t`` samples input rows ``[t*s - (pad + hb), t*s + pad +
    hb + 1]`` with ``pad = dilation*(K//2)``, ``hb = ceil(B)`` (the Eq. 5
    bound) and the ``+1`` of the bilinear ``x0+1`` corner, so

        halo = dilation*(K//2) + ceil(B) + 1

    which for ``dilation=1`` and odd ``K`` is ``ceil(B) + ceil(K/2)``:
    Eq. 6's locality argument across devices (4 rows at B = 2, K = 3)."""
    if kernel_size < 1 or dilation < 1:
        raise ValueError(f"kernel_size={kernel_size}/dilation={dilation} "
                         f"must be >= 1")
    return dilation * (kernel_size // 2) \
        + int(math.ceil(float(offset_bound))) + 1


# ---------------------------------------------------------------------------
# The paper's buffer algebra (its FPGA design, not the card's)
# ---------------------------------------------------------------------------

def receptive_field(kernel_size: int, offset_bound: float) -> int:
    """Eq. 4: the receptive field of a DCL whose offsets are bounded by
    ``offset_bound``."""
    return int(kernel_size + 2 * math.ceil(float(offset_bound)))


def input_buffer_size(rf: int, stride: int, t_w: int, t_n: int,
                      *, bytes_per_elem: int = 4) -> int:
    """Eq. 6: bytes of input tile (+halo) needed for stall-free
    sampling."""
    return rf * (stride * t_w + rf - stride) * t_n * bytes_per_elem


def output_buffer_size(t_w: int, t_n: int, kernel_size: int,
                       *, bytes_per_elem: int = 4) -> int:
    """Eq. 7: bytes of output buffer (offsets + interpolated inputs)."""
    return t_w * t_n * 2 * kernel_size * kernel_size * bytes_per_elem


def weight_buffer_size(kernel_size: int, t_n: int, t_m: int,
                       *, bytes_per_elem: int = 4) -> int:
    """The weight tile of the dynamic-convolution stage (the paper holds
    every weight of the tile on chip)."""
    return kernel_size * kernel_size * t_n * t_m * bytes_per_elem


@dataclasses.dataclass(frozen=True)
class TileConfig:
    """One loop-tiling point of the paper's accelerator (it fixes T_N =
    512, T_M = 64, T_H = 1, T_W = 8)."""
    t_h: int
    t_w: int
    t_n: int   # input-channel tile
    t_m: int   # output-channel tile

    def onchip_bytes(self, rf: int, stride: int, kernel_size: int,
                     *, bytes_per_elem: int = 4) -> int:
        """On-chip working set of the tile (JAX's ``TileConfig.vmem_bytes``,
        ``repro/core/tiling.py:98``): the Eq. 6 band of ``t_h`` rows, the
        Eq. 7 output buffer, the weight tile and an fp32 accumulator."""
        band_h = rf + stride * (self.t_h - 1)              # Eq. 6 row extent
        inp = band_h * (stride * self.t_w + rf - stride) * self.t_n \
            * bytes_per_elem
        out = output_buffer_size(self.t_w * self.t_h, self.t_n, kernel_size,
                                 bytes_per_elem=bytes_per_elem)
        wgt = weight_buffer_size(kernel_size, self.t_n, self.t_m,
                                 bytes_per_elem=bytes_per_elem)
        acc = self.t_h * self.t_w * self.t_m * 4           # fp32 accumulator
        return inp + out + wgt + acc


PAPER_TILES = TileConfig(t_h=1, t_w=8, t_n=512, t_m=64)

# Element widths of the datapaths the budgets below take by name.
DTYPE_BYTES = {"int8": 1, "bf16": 2, "fp32": 4}


def dtype_bytes(dtype) -> int:
    """Bytes an element of a datapath takes (JAX's ``dtype_bytes``,
    ``repro/core/tiling.py:50``): a name of ``DTYPE_BYTES``, a
    ``torch.dtype`` or anything ``numpy.dtype`` reads."""
    if dtype is None:
        raise ValueError("dtype is None; pass 'int8' | 'bf16' | 'fp32'")
    if isinstance(dtype, str) and dtype in DTYPE_BYTES:
        return DTYPE_BYTES[dtype]
    if isinstance(getattr(dtype, "itemsize", None), int):   # torch.dtype
        return dtype.itemsize
    import numpy as np
    return int(np.dtype(dtype).itemsize)


def max_offset_bound_fitting(kernel_size: int, stride: int, t_w: int,
                             t_n: int, smem_budget: int = SMEM_PER_BLOCK,
                             *, bytes_per_elem: int = 2) -> float:
    """Eq. 6 inverted (JAX's ``max_offset_bound_fitting``,
    ``repro/core/tiling.py:845``): the largest integer offset bound B whose
    input tile (RF = K + 2B rows) still fits ``smem_budget`` bytes, by
    default one thread block's shared memory on the H100.  This couples
    the Eq. 5 bound a model trains with to the chip: 4 at the paper's
    tiles (T_W 8, T_N 512) in bf16, 11 at T_N 128."""
    b = 0
    while True:
        rf = receptive_field(kernel_size, b + 1)
        if input_buffer_size(rf, stride, t_w, t_n,
                             bytes_per_elem=bytes_per_elem) > smem_budget:
            return float(b)
        b += 1
        if b > 4096:
            return float(b)


@dataclasses.dataclass(frozen=True)
class LayerShape:
    """Shape of one DCL invocation (the traffic reports' layer)."""
    h: int
    w: int
    c_in: int
    c_out: int
    kernel_size: int = 3
    stride: int = 1
    offset_bound: float = 2.0

    @property
    def rf(self) -> int:
        return receptive_field(self.kernel_size, self.offset_bound)


# ---------------------------------------------------------------------------
# The paper's Sec. 3.2 design-space exploration at the H100's constants
# ---------------------------------------------------------------------------

def _ladder(top: int) -> list[int]:
    """Channel tiles of the Sec. 3.2 search: 8, 16, 32, ... up to ``top``,
    and ``top`` itself rounded down to a multiple of 8 (at least 8)."""
    out, v = [], 8
    while v < top:
        out.append(v)
        v *= 2
    return sorted({*out, max(8, top // 8 * 8)})


def tile_candidates(shape: LayerShape):
    """The Sec. 3.2 search space on this card (JAX's ``tile_candidates``,
    ``repro/core/tiling.py:138``, re-derived): ``t_h * t_w`` up to the
    fused kernels' ``PIX_LANES[-1]`` pixels a block (powers of two), and
    ``t_n``, ``t_m`` multiples of 8, the k and n of the tf32 ``mma.sync``
    fragment, doubling from 8 up to the layer's C and M (``_ladder``)."""
    pows = [1 << i for i in range(PIX_LANES[-1].bit_length())]
    for t_h in pows:
        for t_w in pows:
            if t_h * t_w > PIX_LANES[-1]:
                continue
            for t_n in _ladder(shape.c_in):
                for t_m in _ladder(shape.c_out):
                    yield TileConfig(t_h, t_w, t_n, t_m)


def tile_flops(shape: LayerShape, t: TileConfig) -> int:
    """Twice the MACs of one tile's dynamic convolution plus its bilinear
    stage (4 corners, a product and a sum each) — JAX's ``tile_flops``
    (``repro/core/tiling.py:151``)."""
    k2 = shape.kernel_size ** 2
    conv = 2 * t.t_h * t.t_w * t.t_m * k2 * t.t_n
    bilinear = t.t_h * t.t_w * k2 * t.t_n * 8
    return conv + bilinear


def tile_hbm_bytes(shape: LayerShape, t: TileConfig,
                   *, bytes_per_elem: int = 2) -> int:
    """Device-memory bytes of one tile of the fused dataflow: its input band
    (with the halo), its weight tile and its output tile; the patches stay
    on chip (JAX's ``tile_hbm_bytes``, ``repro/core/tiling.py:159``)."""
    rf, s = shape.rf, shape.stride
    band_h = rf + s * (t.t_h - 1)
    inp = band_h * (s * t.t_w + rf - s) * t.t_n * bytes_per_elem
    wgt = shape.kernel_size ** 2 * t.t_n * t.t_m * bytes_per_elem
    out = t.t_h * t.t_w * t.t_m * bytes_per_elem
    return inp + wgt + out


def two_stage_extra_bytes(shape: LayerShape, t: TileConfig,
                          *, bytes_per_elem: int = 2) -> int:
    """The patches the paper's two-stage dataflow writes and reads back
    (JAX's ``two_stage_extra_bytes``, ``repro/core/tiling.py:175``)."""
    k2 = shape.kernel_size ** 2
    return 2 * t.t_h * t.t_w * k2 * t.t_n * bytes_per_elem


@dataclasses.dataclass(frozen=True)
class TileChoice:
    """One evaluated point of the search (JAX's ``TileChoice``,
    ``repro/core/tiling.py:183``; ``onchip_bytes`` is its ``vmem_bytes``)."""
    tile: TileConfig
    ctc: float                 # compute-to-communication ratio (flop/byte)
    attainable_flops: float    # min(peak, ctc * device-memory rate)
    onchip_bytes: int

    @property
    def fits(self) -> bool:
        return self.onchip_bytes <= SMEM_PER_BLOCK


def evaluate_tile(shape: LayerShape, t: TileConfig, *, fused: bool = True,
                  smem_budget: int = SMEM_PER_BLOCK) -> TileChoice:
    """The roofline of one tile (JAX's ``evaluate_tile``,
    ``repro/core/tiling.py:194``) at the H100's bf16 peak and memory rate
    (``core.h100``): ``attainable = min(PEAK_BF16_FLOPS, ctc *
    PEAK_HBM_BYTES_PER_S)``, ``fused=False`` adding the two-stage
    dataflow's patch round trip to the bytes; the working set at bf16.
    ``smem_budget`` is taken for JAX's signature (the caller filters)."""
    from repro_torch.core.h100 import PEAK_BF16_FLOPS, PEAK_HBM_BYTES_PER_S
    del smem_budget
    flops = tile_flops(shape, t)
    traffic = tile_hbm_bytes(shape, t)
    if not fused:
        traffic += two_stage_extra_bytes(shape, t)
    ctc = flops / max(traffic, 1)
    return TileChoice(tile=t, ctc=ctc,
                      attainable_flops=min(PEAK_BF16_FLOPS,
                                           ctc * PEAK_HBM_BYTES_PER_S),
                      onchip_bytes=t.onchip_bytes(shape.rf, shape.stride,
                                                  shape.kernel_size,
                                                  bytes_per_elem=2))


def choose_tiles(shape: LayerShape, *, fused: bool = True,
                 smem_budget: int = SMEM_PER_BLOCK) -> TileChoice:
    """The paper's Sec. 3.2 methodology on the H100 (JAX's
    ``choose_tiles``, ``repro/core/tiling.py:208``): among the candidates
    whose working set fits ``smem_budget`` (one block's shared memory),
    the one of highest attainable performance, then highest CTC.

    On the five DCL shapes of ``resnet50_dcn_bounded`` at the 512 bucket
    (B = 2, RF 7; 64² x 128, 64² x 256 stride 2, 32² x 256, 32² x 512
    stride 2, 16² x 512) it picks T_H x T_W = 8 x 8, T_N = 32, T_M = 128
    on every one: CTC 47.4 flop/B at stride 1 and 41.1 at stride 2,
    attainable 158.8 and 137.8 TFLOP/s, working sets of 192,768 and
    208,448 bytes (the two-stage dataflow: CTC 27.6-32.0).  The card's
    ridge is 989e12 / 3.35e12 = 295 flop/B, so every such layer sits far
    below it: the budget forbids the wide channel tiles that would
    amortise a 64-pixel tile's halo and weights (the paper's own point,
    T_N 512, needs 839,680-889,856 bytes at CTC 6.8-7.3)."""
    best: TileChoice | None = None
    for t in tile_candidates(shape):
        c = evaluate_tile(shape, t, fused=fused, smem_budget=smem_budget)
        if c.onchip_bytes > smem_budget:
            continue
        if best is None or (c.attainable_flops, c.ctc) > \
                (best.attainable_flops, best.ctc):
            best = c
    if best is None:
        raise ValueError(
            f"no tile configuration fits the shared-memory budget "
            f"{smem_budget} for {shape}; receptive field {shape.rf} too "
            f"large — train with a larger lambda")
    return best


def pix_lanes(tile_h: int, tile_w: int) -> int:
    """Pixel lanes of the kernel instantiation that serves a tile."""
    for p in PIX_LANES:
        if tile_h * tile_w <= p:
            return p
    raise ValueError(f"tile {tile_h}x{tile_w} exceeds the kernel's "
                     f"{PIX_LANES[-1]} pixels per block")


def _check_itemsize(itemsize: int) -> None:
    if itemsize not in (4, 2):
        raise ValueError(f"element size {itemsize}: the fused DCL kernels "
                         f"take fp32 (4 bytes) or bf16 (2 bytes)")


def fwd_rows_pad(tile_c: int, *, kernel_size: int, itemsize: int = 4) -> int:
    """Rows of the fused forward's patch and weight chunks: K*K*tile_c
    padded to whole mma steps (``FWD_MMA_DEPTH``: 8 deep in fp32, 16 in
    bf16)."""
    _check_itemsize(itemsize)
    step = FWD_MMA_DEPTH[itemsize]
    return -(-kernel_size * kernel_size * tile_c // step) * step


def smem_bytes(tile_h: int, tile_w: int, tile_c: int, *, kernel_size: int,
               stride: int, dilation: int, offset_bound: float,
               itemsize: int = 4) -> int:
    """Dynamic shared memory of one block of the fused forward for
    elements of ``itemsize`` bytes; mirrors ``dcf_smem_bytes`` in
    ``csrc/deform_conv_fused.cu``: two band chunks (``_band_bytes``), two
    weight chunks (``fwd_rows_pad`` rows by ``FWD_TILE_M`` channels +
    ``FWD_W_PAD``), the patch tile (pixel lanes by the padded rows +
    ``FWD_P_PAD``) and the corner geometry (ty, tx, index per tap and
    pixel, 4 bytes each)."""
    pix = pix_lanes(tile_h, tile_w)
    k2 = kernel_size * kernel_size
    band = _band_bytes(tile_h, tile_w, tile_c, kernel_size=kernel_size,
                       stride=stride, dilation=dilation,
                       offset_bound=offset_bound, itemsize=itemsize)
    rows = fwd_rows_pad(tile_c, kernel_size=kernel_size, itemsize=itemsize)
    return 2 * band + itemsize * (
        2 * rows * (FWD_TILE_M + FWD_W_PAD[itemsize])
        + pix * (rows + FWD_P_PAD[itemsize])) + 12 * k2 * pix


def q_rows_pad(tile_c: int, *, kernel_size: int) -> int:
    """Bytes of the int8 kernels' patch and weight rows before their pad:
    K*K*tile_c padded to whole 32-deep s8 mma steps."""
    return -(-kernel_size * kernel_size * tile_c // 32) * 32


def q_smem_bytes(tile_h: int, tile_w: int, tile_c: int, *, kernel_size: int,
                 stride: int, dilation: int, offset_bound: float) -> int:
    """Dynamic shared memory of one block of the int8 kernels (both run
    the same main body); mirrors ``dcq_smem_bytes`` in
    ``csrc/deform_conv_q.cu``: ``Q_STAGES`` band chunks (int8,
    position-major, rounded to 16 bytes), ``Q_STAGES`` weight chunks of
    ``Q_TILE_M`` rows and the patch tile (pixel lanes rows), each row
    ``q_rows_pad`` + ``Q_ROW_PAD`` bytes, and the corner geometry (index,
    ty, tx per tap and pixel)."""
    if tile_c % 4:
        raise ValueError(f"tile_c={tile_c}: the int8 kernels copy and sample "
                         f"4-channel words, so tile_c must be a multiple "
                         f"of 4")
    pix = pix_lanes(tile_h, tile_w)
    bh = band_extent(tile_h, kernel_size=kernel_size, stride=stride,
                     dilation=dilation, offset_bound=offset_bound)
    bw = band_extent(tile_w, kernel_size=kernel_size, stride=stride,
                     dilation=dilation, offset_bound=offset_bound)
    band = -(-bh * bw * tile_c // 16) * 16
    row = q_rows_pad(tile_c, kernel_size=kernel_size) + Q_ROW_PAD
    return Q_STAGES * band + (Q_STAGES * Q_TILE_M + pix) * row \
        + 12 * kernel_size * kernel_size * pix


# The backward kernel (csrc/deform_conv_bwd.cu).  d_input / d_offsets:
# output channels of g and W per dP step (row stride + 4), steps in
# flight (cp.async), dP^T mma tiles (16 pixels x 8 rows) a warp keeps at
# most.  Both kernels: blocks a grid should reach (two an SM: one wave)
# and the share of its waves it should fill.  d_weights: rows of
# K*K*tile_c and output channels a block (its channel width), row strides
# of its g and patch tiles.
BWD_MS = 16
BWD_STAGES = 3
BWD_MAX_WARP_TILES = 9
BWD_TARGET_BLOCKS = 2 * SM_COUNT
BWD_WAVE_FILL = 0.95
# The int8 forward takes a grid that already holds BWD_WAVE_FILL of a wave
# whole (``fwd_c_groups``): a split costs it a reduction launch and the
# partials' traffic, and its blocks are short.
Q_GROUP_LEAST = BWD_WAVE_FILL * BWD_TARGET_BLOCKS
BWD_DW_ROWS = 144
BWD_DW_COLS = 128
_BWD_LD_STEP = BWD_MS + 4
_BWD_LD_G = BWD_DW_COLS + 8
_BWD_LD_P = BWD_DW_ROWS + 8


def _band_bytes(tile_h: int, tile_w: int, tile_c: int, *,
                kernel_size: int, stride: int, dilation: int,
                offset_bound: float, itemsize: int = 4) -> int:
    """The band chunk of the fused forward and of the backward: the Eq. 6
    band's positions with tile_c channels innermost, in elements of
    ``itemsize`` bytes, rounded to 16 bytes."""
    _check_itemsize(itemsize)
    bh = band_extent(tile_h, kernel_size=kernel_size, stride=stride,
                     dilation=dilation, offset_bound=offset_bound)
    bw = band_extent(tile_w, kernel_size=kernel_size, stride=stride,
                     dilation=dilation, offset_bound=offset_bound)
    return -(-bh * bw * tile_c * itemsize // 16) * 16


def bwd_rows_pad(tile_h: int, tile_w: int, tile_c: int, *,
                 kernel_size: int) -> int:
    """Rows of the d_input kernel's dP chunk: K*K*tile_c padded to
    ``512 / pixel lanes``, so its (lanes / 16) x (rows / 8) mma tiles are
    a multiple of 4."""
    unit = 512 // pix_lanes(tile_h, tile_w)
    return -(-kernel_size * kernel_size * tile_c // unit) * unit


def _bwd_mma_tiles(tile_h: int, tile_w: int, tile_c: int, *,
                   kernel_size: int) -> int:
    """dP^T mma tiles of a d_input chunk: (lanes / 16) x (rows / 8)."""
    return (pix_lanes(tile_h, tile_w) // 16) * bwd_rows_pad(
        tile_h, tile_w, tile_c, kernel_size=kernel_size) // 8


def bwd_k_split(tile_h: int, tile_w: int, tile_c: int, *,
                kernel_size: int) -> int:
    """Warp groups that share the d_input kernel's dP tiles, each taking
    alternate halves of every M step: 1 where the mma tiles are a multiple
    of the 8 warps, else 2."""
    tiles = _bwd_mma_tiles(tile_h, tile_w, tile_c, kernel_size=kernel_size)
    return 1 if tiles % 8 == 0 else 2


def bwd_warp_tiles(tile_h: int, tile_w: int, tile_c: int, *,
                   kernel_size: int) -> int:
    """dP^T mma tiles (16 pixels x 8 rows) each warp of a d_input block
    keeps in registers; at most ``BWD_MAX_WARP_TILES``."""
    kw = dict(kernel_size=kernel_size)
    return _bwd_mma_tiles(tile_h, tile_w, tile_c, **kw) \
        * bwd_k_split(tile_h, tile_w, tile_c, **kw) // 8


def bwd_smem_bytes(tile_h: int, tile_w: int, tile_c: int, *,
                   kernel_size: int, stride: int, dilation: int,
                   offset_bound: float, itemsize: int = 4) -> int:
    """Dynamic shared memory of one block of the backward's d_input /
    d_offsets kernel for inputs of ``itemsize`` bytes; mirrors
    ``dcb_smem_bytes`` in ``csrc/deform_conv_bwd.cu``: the staged band
    chunk (``_band_bytes``), ``BWD_STAGES`` M steps of W and g in the
    inputs' type (``bwd_rows_pad`` rows and the pixel lanes, 16 channels
    + 4) or the fp32 dP chunk (lanes by the padded rows + 8 or + 16),
    whichever is larger; per tap and pixel the corner geometry (index,
    ty, tx), the two d_offsets sums and four (dP offset, weight) corner
    entries; per band position an entry start (plus one) and a dx_pad
    offset (4 bytes each)."""
    pix = pix_lanes(tile_h, tile_w)
    pairs = kernel_size * kernel_size * pix
    band = _band_bytes(tile_h, tile_w, tile_c, kernel_size=kernel_size,
                       stride=stride, dilation=dilation,
                       offset_bound=offset_bound, itemsize=itemsize)
    npos = band_extent(tile_h, kernel_size=kernel_size, stride=stride,
                       dilation=dilation, offset_bound=offset_bound) \
        * band_extent(tile_w, kernel_size=kernel_size, stride=stride,
                      dilation=dilation, offset_bound=offset_bound)
    rp = bwd_rows_pad(tile_h, tile_w, tile_c, kernel_size=kernel_size)
    ldr = rp + (8 if rp % 16 == 0 else 16)
    union = max(itemsize * BWD_STAGES * (rp + pix) * _BWD_LD_STEP,
                4 * pix * ldr)
    return band + union + 4 * (13 * pairs + 2 * npos + 1)


def bwd_dw_smem_bytes(tile_h: int, tile_w: int, tile_c: int, *,
                      kernel_size: int, stride: int, dilation: int,
                      offset_bound: float, itemsize: int = 4) -> int:
    """Dynamic shared memory of one block of the backward's d_weights
    kernel for inputs of ``itemsize`` bytes; mirrors
    ``dcb_dw_smem_bytes``: two band chunks (double-buffered), the tap and
    channel of each of its 144 rows, g tiles in the inputs' type (lanes x
    128 channels + 8; two up to 32 lanes, one at 64) and an fp32 patch
    tile (lanes x 144 rows + 8)."""
    pix = pix_lanes(tile_h, tile_w)
    band = _band_bytes(tile_h, tile_w, tile_c, kernel_size=kernel_size,
                       stride=stride, dilation=dilation,
                       offset_bound=offset_bound, itemsize=itemsize)
    g_tiles = 2 if pix <= 32 else 1
    return 2 * band + 8 * BWD_DW_ROWS \
        + pix * (itemsize * g_tiles * _BWD_LD_G + 4 * _BWD_LD_P)


def _wave_fill(blocks: int) -> float:
    """Share of the last of its waves (``BWD_TARGET_BLOCKS`` blocks each,
    two an SM) that a grid of ``blocks`` fills, over all its waves."""
    waves = -(-blocks // BWD_TARGET_BLOCKS)
    return blocks / (waves * BWD_TARGET_BLOCKS)


@functools.lru_cache(maxsize=None)
def _c_groups(tiles: int, chunks: int,
              least: float = BWD_TARGET_BLOCKS) -> int:
    """The groups a grid of ``tiles`` blocks a group splits its
    ``chunks`` C chunks into: 1 when the tiles alone reach ``least``
    blocks, else the fewest groups (at most one a chunk) that reach it and
    fill whole waves of ``BWD_TARGET_BLOCKS`` to ``BWD_WAVE_FILL`` (the
    best fill when none does)."""
    if tiles >= least:
        return 1
    cands = range(min(chunks, math.ceil(least / tiles)), chunks + 1)
    for groups in cands:
        if _wave_fill(tiles * groups) >= BWD_WAVE_FILL:
            return groups
    return max(cands, key=lambda gr: _wave_fill(tiles * gr))


def bwd_c_groups(n: int, ho: int, wo: int, c: int, *, tile_h: int,
                 tile_w: int, tile_c: int) -> int:
    """Groups of C chunks the d_input kernel's grid splits C into, over
    its output tiles (``_c_groups``)."""
    return _c_groups(n * -(-ho // tile_h) * -(-wo // tile_w), c // tile_c)


def fwd_c_groups(n: int, ho: int, wo: int, c: int, m: int, *, tile_h: int,
                 tile_w: int, tile_c: int, tile_m: int,
                 least: float = BWD_TARGET_BLOCKS) -> int:
    """Groups of C chunks the forward kernels' grids split C into, over
    their output tiles times their M tiles (``_c_groups``, as the
    backward); the int8 forward passes ``least=Q_GROUP_LEAST``."""
    return _c_groups(n * -(-ho // tile_h) * -(-wo // tile_w)
                     * -(-m // tile_m), c // tile_c, least)


def q_off_groups(n: int, ho: int, wo: int, c: int, *, tile_h: int,
                 tile_w: int, tile_c: int) -> int:
    """Groups of C chunks the int8 chain's offset conv splits C into (their
    int32 sums meet by atomics): about ``BWD_TARGET_BLOCKS`` blocks over
    the output tiles, at least one chunk a group."""
    tiles = n * -(-ho // tile_h) * -(-wo // tile_w)
    return max(1, min(c // tile_c,
                      (BWD_TARGET_BLOCKS + tiles // 2) // tiles))


def bwd_c_range(chunks: int, groups: int, group: int) -> range:
    """The C chunks of one group, as the backward's d_input kernel and
    the fp32 forward take them."""
    return range(group * chunks // groups, (group + 1) * chunks // groups)


def bwd_dw_grid(c: int, m: int, *, kernel_size: int,
                tile_c: int) -> tuple[int, int, int]:
    """The d_weights grid before the pixel splits: (C chunks, blocks of
    ``BWD_DW_ROWS`` rows of K*K*tile_c, blocks of ``BWD_DW_COLS`` output
    channels)."""
    rows = kernel_size * kernel_size * tile_c
    return (c // tile_c, -(-rows // BWD_DW_ROWS), -(-m // BWD_DW_COLS))


def bwd_dw_splits(n: int, ho: int, wo: int, c: int, m: int, *,
                  kernel_size: int, tile_h: int, tile_w: int,
                  tile_c: int) -> int:
    """Pixel splits of the backward's d_weights kernel (at most one per
    output tile): the fewest whose grid, ``bwd_dw_grid`` x splits, holds
    at least ``BWD_WAVE_FILL`` of a wave and fills whole waves to
    ``BWD_WAVE_FILL``; else enough for one wave."""
    chunks, rows, cols = bwd_dw_grid(c, m, kernel_size=kernel_size,
                                     tile_c=tile_c)
    base = chunks * rows * cols
    tiles = n * -(-ho // tile_h) * -(-wo // tile_w)
    for splits in range(1, tiles + 1):
        blocks = base * splits
        if blocks >= BWD_WAVE_FILL * BWD_TARGET_BLOCKS \
                and _wave_fill(blocks) >= BWD_WAVE_FILL:
            return splits
    return max(1, min(tiles, -(-BWD_TARGET_BLOCKS // base)))


# The sampling kernels (csrc/deform_sample.cu, kernels 1b and 3): a block
# writes one output tile's patches for a group of C chunks, staging each
# band chunk through a ring of SAMPLE_STAGES; a chunk is at most
# SAMPLE_LINE bytes of channels (one 128-byte line a position), and a
# thread moves up to 16 bytes at once.  The grid splits C into
# groups until it holds SAMPLE_TARGET_BLOCKS blocks, one an SM: fewer
# groups walk more chunks a block, through the ring (PERF.md section 6,
# PR 20).
SAMPLE_STAGES = 2
SAMPLE_LINE = 128
SAMPLE_TARGET_BLOCKS = SM_COUNT
# The banded dataflow's row tile when the caller gives none (the JAX
# ``plan.bounded_forward`` and ``ops.deform_sample`` default).
BANDED_TILE_H = 8


def sample_smem_bytes(tile_h: int, tile_w: int, tile_c: int, *,
                      kernel_size: int, stride: int, dilation: int,
                      offset_bound: float, itemsize: int = 4) -> int:
    """Dynamic shared memory of one block of the sampling kernels for
    elements of ``itemsize`` bytes; mirrors ``ds_smem_bytes`` in
    ``csrc/deform_sample.cu``: ``SAMPLE_STAGES`` band chunks
    (position-major, channels innermost, each rounded to 16 bytes), the
    four corner weights (fp32) and the band position and output offset
    (int32) of every (pixel, tap) row, and each staged position's offset
    (int32)."""
    bh = band_extent(tile_h, kernel_size=kernel_size, stride=stride,
                     dilation=dilation, offset_bound=offset_bound)
    bw = band_extent(tile_w, kernel_size=kernel_size, stride=stride,
                     dilation=dilation, offset_bound=offset_bound)
    npos = bh * bw
    rows = tile_h * tile_w * kernel_size * kernel_size
    stage = -(-npos * tile_c * itemsize // 16) * 16
    return SAMPLE_STAGES * stage + 24 * rows + 4 * npos


def sample_vec_bytes(tile_c: int, itemsize: int, address: int = 0) -> int:
    """Bytes a thread of the sampling kernels moves at once: the largest
    power of two up to 16 that divides a chunk's bytes (``tile_c *
    itemsize``) and the source's ``address``, at least one element."""
    for vec in (16, 8, 4, 2):
        if vec >= itemsize and (tile_c * itemsize) % vec == 0 \
                and address % vec == 0:
            return vec
    raise ValueError(f"address {address:#x} is not aligned to its "
                     f"{itemsize}-byte elements")


def sample_c_groups(n: int, ho: int, wo: int, c: int, *, tile_h: int,
                    tile_w: int, tile_c: int) -> int:
    """Groups of C chunks the sampling kernels' grid splits C into: 1 when
    the output tiles alone reach ``SAMPLE_TARGET_BLOCKS`` blocks, else the
    fewest that divide the chunks evenly and reach it (all of them when
    none does)."""
    tiles = n * -(-ho // tile_h) * -(-wo // tile_w)
    chunks = c // tile_c
    need = -(-SAMPLE_TARGET_BLOCKS // tiles)
    return next((g for g in range(min(need, chunks), chunks + 1)
                 if chunks % g == 0), chunks)


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
                        tile_h: int | None = None,
                        itemsize: int = 4) -> KernelTiles:
    """Tiles of the fused kernels for one layer shape and datapath
    (``dtype``: ``"fp32"`` for ``deform_conv_fused.cu``, ``"int8"`` and
    ``"int8_chain"`` for the two kernels of ``deform_conv_q.cu``,
    ``"fp32_bwd"`` for the backward of ``deform_conv_bwd.cu``,
    ``"sample"`` for the sampling kernels of ``deform_sample.cu`` and
    ``"banded"`` for the banded forward of ``deform_conv_fused.cu``).

    * ``tile_m``: the largest divisor of M up to ``FWD_TILE_M`` (int8:
      ``Q_TILE_M``; ``"sample"``: ``tile_c``, the channels a block
      writes; fp32_bwd: unused by the backward).
    * spatial: 8x8 clamped to the output; while the grid has fewer
      blocks than the card has SMs, halve the longer side, down to 16
      pixels per block (the backward's grid counts neither M nor C tiles
      and stops at 32 pixels, since its d_input kernel splits C over the
      grid, ``bwd_c_groups``; the sampling kernels' rule is below).
      A given ``tile_h`` fixes the rows (not clamped to the output: the
      caller clamps) and only ``tile_w`` is halved; ``"banded"`` always
      fixes them at the bands' row tile (default ``BANDED_TILE_H``), so a
      block covers a whole band tile's rows and ``tile_w`` of its columns.
    * fp32 and banded (``_fwd_tiles``): the grid splits C into groups
      (``fwd_c_groups``), so the spatial tile is halved only where its
      block does not fit twice in an SM at any ``tile_c`` from the largest
      divisor of C up to ``FWD_TILE_C`` down to ``FWD_TILE_C_MIN``, or where
      even one group a chunk would leave the grid short of
      ``BWD_TARGET_BLOCKS``; failing that, smaller divisors of C, then
      blocks that fit once.
    * int8 and int8_chain (``_fwd_tiles`` too; both kernels run one
      main body): as fp32, over the multiple-of-4 divisors of C up to
      ``Q_TILE_C`` (``Q_TILE_C_MIN`` and up first) against
      ``q_smem_bytes``, the grid split into C groups by ``fwd_c_groups``.
      The chain's ``tile_c`` is a free chunk size, not C.
    * ``tile_c``, fp32_bwd: as fp32, against the backward's d_input
      model (``bwd_smem_bytes``), with at most ``BWD_MAX_WARP_TILES`` dP
      mma tiles a warp (``bwd_warp_tiles``) and a d_weights block that
      fits once (``bwd_dw_smem_bytes``); ``tile_m`` only shapes the
      forward's grid.
    * sample (``_sample_tiles``): no contraction, so the block is sized
      by what it stages and writes.  ``tile_c``: the largest divisor of C
      whose chunk is at most ``SAMPLE_LINE`` bytes of ``itemsize``-byte
      elements; spatial tiles from 8x8 down to 16 pixels as above (a
      given ``tile_h`` fixes the rows), the first whose block fits twice
      in an SM (``sample_smem_bytes``) and whose tiles times C chunks reach
      ``SAMPLE_TARGET_BLOCKS`` (one block an SM), else the smallest that
      fits twice; failing that, smaller chunks, then blocks that fit
      once.  The grid's C groups are ``sample_c_groups``.
    ``itemsize`` (element bytes: 4 fp32, 2 bf16) sizes the shared memory
    of every datapath but the int8 ones.  None fitting raises.
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
    if dtype in ("fp32", "banded"):
        return _fwd_tiles(
            n, ho, wo, c, m, th, tw, geom,
            rows_fixed=tile_h is not None or dtype == "banded",
            tcs=[_divisor_at_most(c, cap) for cap in (FWD_TILE_C, 4, 2, 1)],
            tc_min=FWD_TILE_C_MIN, tile_m=FWD_TILE_M,
            block_bytes=functools.partial(smem_bytes, itemsize=itemsize))
    if dtype in ("int8", "int8_chain"):
        if c % 4:
            raise ValueError(
                f"C={c}: the int8 kernels copy and sample 4-channel words, "
                f"so C must be a multiple of 4")
        return _fwd_tiles(
            n, ho, wo, c, m, th, tw, geom, rows_fixed=tile_h is not None,
            tcs=[4 * _divisor_at_most(c // 4, cap // 4)
                 for cap in (Q_TILE_C, 16, 8, 4)],
            tc_min=Q_TILE_C_MIN, tile_m=Q_TILE_M, block_bytes=q_smem_bytes)
    if dtype == "sample":
        return _sample_tiles(n, ho, wo, c, th, tw, geom,
                             rows_fixed=tile_h is not None,
                             itemsize=itemsize)
    tm = _divisor_at_most(m, FWD_TILE_M)
    # The backward splits C over its grid (its d_input kernel has no M
    # axis), so its tiles stop at 32 pixels.
    while (grid_blocks(n, ho, wo, m, KernelTiles(th, tw, 1, m)) < SM_COUNT
           and th * tw > 32):
        if th >= tw and tile_h is None:
            th = -(-th // 2)
        elif tw > 1:
            tw = -(-tw // 2)
        else:
            break
    cands = sorted({_divisor_at_most(c, cap)
                    for cap in (32, 16, 8, 4, 2, 1)}, reverse=True)
    cands = [tc for tc in cands
             if bwd_warp_tiles(th, tw, tc, kernel_size=kernel_size)
             <= BWD_MAX_WARP_TILES
             and bwd_dw_smem_bytes(th, tw, tc, itemsize=itemsize, **geom)
             <= SMEM_PER_BLOCK]
    for budget in (SMEM_PER_BLOCK // 2, SMEM_PER_BLOCK):
        for tc in cands:
            if bwd_smem_bytes(th, tw, tc, itemsize=itemsize,
                              **geom) <= budget:
                return KernelTiles(th, tw, tc, tm)
    _no_fit(th, tw, geom)


def _sample_tiles(n: int, ho: int, wo: int, c: int, th: int, tw: int,
                  geom: dict, *, rows_fixed: bool,
                  itemsize: int) -> KernelTiles:
    """The sampling kernels' tiles (see ``choose_kernel_tiles``); their
    ``tile_m`` is their ``tile_c``."""
    shapes = [(th, tw)]
    while th * tw > PIX_LANES[0]:
        if th >= tw and not rows_fixed:
            th = -(-th // 2)
        elif tw > 1:
            tw = -(-tw // 2)
        else:
            break
        shapes.append((th, tw))
    line = SAMPLE_LINE // itemsize
    tcs = sorted({_divisor_at_most(c, cap)
                  for cap in (line, 32, 16, 8, 4, 2, 1) if cap <= line},
                 reverse=True)
    for budget in (FWD_SMEM_TWO, SMEM_PER_BLOCK):
        for tc in tcs:
            fit = [(a, b) for a, b in shapes
                   if sample_smem_bytes(a, b, tc, itemsize=itemsize,
                                        **geom) <= budget]
            for a, b in fit:
                if n * -(-ho // a) * -(-wo // b) * (c // tc) \
                        >= SAMPLE_TARGET_BLOCKS:
                    return KernelTiles(a, b, tc, tc)
            if fit:
                return KernelTiles(*fit[-1], tc, tc)
    _no_fit(shapes[-1][0], shapes[-1][1], geom)


def _no_fit(th: int, tw: int, geom: dict):
    raise ValueError(
        f"no channel tile fits {SMEM_PER_BLOCK} bytes of shared memory for "
        f"a {th}x{tw} tile at B={geom['offset_bound']}, stride "
        f"{geom['stride']}, dilation {geom['dilation']}: the Eq. 6 band is "
        f"too large — train with a smaller offset bound")


def _fwd_tiles(n: int, ho: int, wo: int, c: int, m: int, th: int, tw: int,
               geom: dict, *, rows_fixed: bool, tcs: list[int], tc_min: int,
               tile_m: int, block_bytes) -> KernelTiles:
    """The fused forward kernels' tiles (fp32 and int8; see
    ``choose_kernel_tiles``): spatial tiles from ``th`` x ``tw`` down to 16
    pixels, halving the longer side (only ``tw`` when the rows are fixed),
    each at the largest ``tile_c`` of ``tcs`` whose ``block_bytes`` fit,
    from those of at least ``tc_min`` (then all of them); per budget (two
    blocks an SM, then one), the first tile whose grid, at one group a
    chunk, reaches ``BWD_TARGET_BLOCKS``, else the smallest that fits.
    ``tile_m``: the largest divisor of M up to ``tile_m``."""
    tm = _divisor_at_most(m, tile_m)
    shapes = [(th, tw)]
    while th * tw > PIX_LANES[0]:
        if th >= tw and not rows_fixed:
            th = -(-th // 2)
        elif tw > 1:
            tw = -(-tw // 2)
        else:
            break
        shapes.append((th, tw))
    tcs = sorted(set(tcs), reverse=True)
    least = min(tc_min, tcs[0])
    for budget in (FWD_SMEM_TWO, SMEM_PER_BLOCK):
        for cands in ([tc for tc in tcs if tc >= least], tcs):
            fit = []
            for a, b in shapes:
                tc = next((tc for tc in cands
                           if block_bytes(a, b, tc, **geom) <= budget), None)
                if tc is not None:
                    fit.append(KernelTiles(a, b, tc, tm))
            for t in fit:
                if grid_blocks(n, ho, wo, m, t) * (c // t.tile_c) \
                        >= BWD_TARGET_BLOCKS:
                    return t
            if fit:
                return fit[-1]
    _no_fit(shapes[-1][0], shapes[-1][1], geom)


# The datapaths whose tiles a tuned cache may set (``kernels.plan``) and
# the autotuner searches (``neighbor_kernel_tiles``).
TUNABLE = ("fp32", "int8", "int8_chain", "fp32_bwd")


def tiles_fit(tile_h: int, tile_w: int, tile_c: int, tile_m: int, *, c: int,
              m: int, kernel_size: int, stride: int, dilation: int,
              offset_bound: float, dtype: str = "fp32",
              itemsize: int = 4) -> bool:
    """Whether the kernel of a tunable datapath (``TUNABLE``) takes these
    tiles: positive ints, at most ``PIX_LANES[-1]`` pixels a block,
    channel tiles that divide C and M, and one block's shared memory
    within ``SMEM_PER_BLOCK`` at the datapath's mirror (``smem_bytes``;
    ``q_smem_bytes``, whose tile_c is a multiple of 4; ``bwd_smem_bytes``
    and ``bwd_dw_smem_bytes`` with at most ``BWD_MAX_WARP_TILES`` dP mma
    tiles a warp), and ``tile_m`` within the forward kernels' output
    channels a block."""
    if dtype not in TUNABLE:
        raise ValueError(f"datapath {dtype!r} has no tunable tiles; "
                         f"expected one of {TUNABLE}")
    tiles = (tile_h, tile_w, tile_c, tile_m)
    if not all(isinstance(t, int) and t >= 1 for t in tiles) \
            or tile_h * tile_w > PIX_LANES[-1] or c % tile_c or m % tile_m:
        return False
    geom = dict(kernel_size=kernel_size, stride=stride, dilation=dilation,
                offset_bound=offset_bound)
    if dtype == "fp32":
        return tile_m <= FWD_TILE_M and smem_bytes(
            tile_h, tile_w, tile_c, itemsize=itemsize, **geom) \
            <= SMEM_PER_BLOCK
    if dtype in ("int8", "int8_chain"):
        return tile_c % 4 == 0 and tile_m <= Q_TILE_M and q_smem_bytes(
            tile_h, tile_w, tile_c, **geom) <= SMEM_PER_BLOCK
    return (bwd_warp_tiles(tile_h, tile_w, tile_c, kernel_size=kernel_size)
            <= BWD_MAX_WARP_TILES
            and max(bwd_smem_bytes(tile_h, tile_w, tile_c,
                                   itemsize=itemsize, **geom),
                    bwd_dw_smem_bytes(tile_h, tile_w, tile_c,
                                      itemsize=itemsize, **geom))
            <= SMEM_PER_BLOCK)


def neighbor_kernel_tiles(n: int, h: int, w: int, c: int, m: int,
                          seed: KernelTiles, *, kernel_size: int,
                          stride: int, dilation: int = 1,
                          offset_bound: float, dtype: str = "fp32",
                          itemsize: int = 4,
                          radius: int = 1) -> list[KernelTiles]:
    """The autotuner's candidates around ``seed`` (the chooser's pick,
    always first and never dropped): each of tile_h, tile_w, tile_c and
    tile_m moves up to ``radius`` steps along its ladder (spatial tiles
    powers of two clamped to the output; tile_c the divisors of C the
    datapath's chooser draws from, multiples of 4 for int8; tile_m the
    divisors of M up to the kernels' 128 channels; the backward, which
    has no M tile, keeps the seed's), and the cross product is filtered
    by ``tiles_fit``.  The int8 datapaths keep the seed's spatial tiles:
    they set the band-local frame in which the sampling positions round,
    so another spatial tile can round a patch to another int8 value,
    where channel tiles only regroup exact integer sums (a tuned int8
    plan serves the analytic plan's integers).  ``n`` is the batch,
    unused: the candidates of a shape do not depend on it (the tuner
    keys its entries by it)."""
    del n
    ho, wo = out_hw(h, w, kernel_size=kernel_size, stride=stride,
                    dilation=dilation)
    pows = (1, 2, 4, 8, 16, 32, 64)
    ths = sorted({min(t, ho) for t in pows})
    tws = sorted({min(t, wo) for t in pows})
    if dtype in ("int8", "int8_chain"):
        ths, tws = [seed.tile_h], [seed.tile_w]
        tcs = sorted({4 * _divisor_at_most(c // 4, cap)
                      for cap in (1, 2, 4, 8, 16)})
    else:
        tcs = sorted({_divisor_at_most(c, cap)
                      for cap in (1, 2, 4, 8, 16, 32)})
    tms = [seed.tile_m] if dtype == "fp32_bwd" else sorted(
        {_divisor_at_most(m, cap) for cap in (16, 32, 64, 128)})

    def near(ladder: list[int], v: int) -> list[int]:
        i = min(range(len(ladder)), key=lambda j: abs(ladder[j] - v))
        return ladder[max(0, i - radius):i + radius + 1]

    geom = dict(c=c, m=m, kernel_size=kernel_size, stride=stride,
                dilation=dilation, offset_bound=offset_bound, dtype=dtype,
                itemsize=itemsize)
    seed = KernelTiles(seed.tile_h, seed.tile_w, seed.tile_c, seed.tile_m)
    out = [seed]
    for th in near(ths, seed.tile_h):
        for tw in near(tws, seed.tile_w):
            for tc in near(tcs, seed.tile_c):
                for tm in near(tms, seed.tile_m):
                    kt = KernelTiles(th, tw, tc, tm)
                    if kt not in out and tiles_fit(th, tw, tc, tm, **geom):
                        out.append(kt)
    return out


# ---------------------------------------------------------------------------
# Device-memory traffic of the port's DCL kernels at their tiles
# ---------------------------------------------------------------------------
#
# The counterparts of JAX's ``dcl_*_hbm_bytes`` (``repro/core/tiling.py``
# :249-618, its TPU traffic model).  Each counts the global-memory bytes
# that one call's launches load and store, as the CUDA code performs them,
# walking the grid its wrapper builds: per block the offsets it reads,
# per C chunk the band chunk and weight chunk it stages, its outputs (or
# its C group's fp32/int32 partials), and the reductions that add them.
# Loads of a block's halo and weight chunk that its neighbours load too
# are counted each time: on the H100 most of them hit the 50 MB L2, so
# these bytes sit between ``core.h100``'s floor (each input read once,
# each output written once; always at most this count) and the card's
# real HBM traffic.  The zero-padding of x (``plan.pad_zerocopy``, one
# ``F.pad`` in either dataflow) is not counted.

@dataclasses.dataclass(frozen=True)
class _Grid:
    """The grid of one call as its wrapper builds it: the image count, the
    output rows and columns the kernel computes, the tiles (spatial tiles
    clamped as the dispatch path clamps them), the Eq. 6 band, and the
    source plane's width and total rows (``x_pad``; a band's for the
    banded dataflow)."""
    n: int
    ho: int
    wo: int
    th: int
    tw: int
    tc: int
    tm: int
    band_h: int
    band_w: int
    src_w: int
    src_rows: int          # rows of all source planes of one image
    stride: int

    @property
    def h_tiles(self) -> int:
        return -(-self.ho // self.th)

    @property
    def w_tiles(self) -> int:
        return -(-self.wo // self.tw)

    @property
    def tiles(self) -> int:
        return self.n * self.h_tiles * self.w_tiles

    @property
    def pixels(self) -> int:
        return self.n * self.ho * self.wo

    @property
    def cols(self) -> int:
        """Band columns inside the source plane, over the column tiles
        (the kernels read no column past it)."""
        return sum(max(0, min(self.band_w,
                              self.src_w - wt * self.tw * self.stride))
                   for wt in range(self.w_tiles))


def _grid(shape: LayerShape, kt: KernelTiles, *, batch: int, dilation: int,
          banded: bool = False) -> _Grid:
    """``_Grid`` of one zero-copy call (``plan.pad_zerocopy``'s plane) or
    one banded call (``plan.pad_and_band``'s bands of ``tile_h`` rows; the
    offsets padded to whole row tiles)."""
    k, s = shape.kernel_size, shape.stride
    geom = dict(kernel_size=k, stride=s, dilation=dilation,
                offset_bound=shape.offset_bound)
    ho, wo = out_hw(shape.h, shape.w, kernel_size=k, stride=s,
                    dilation=dilation)
    p0 = dilation * (k // 2) + int(math.ceil(float(shape.offset_bound)))
    tw = min(kt.tile_w, wo)
    if banded:
        th = kt.tile_h
        nt = -(-ho // th)
        band_h = band_extent(th, **geom)
        return _Grid(batch, nt * th, wo, th, tw, kt.tile_c, kt.tile_m,
                     band_h, band_extent(tw, **geom), shape.w + 2 * p0 + 1,
                     nt * band_h, s)
    th = min(kt.tile_h, ho)
    band_h, band_w = band_extent(th, **geom), band_extent(tw, **geom)
    # plan.pad_zerocopy: p0 on the top/left, to the last band on the
    # bottom/right.
    rows = p0 + shape.h + max(0, (-(-ho // th) - 1) * th * s + band_h
                              - p0 - shape.h)
    cols = p0 + shape.w + max(0, (-(-wo // tw) - 1) * tw * s + band_w
                              - p0 - shape.w)
    return _Grid(batch, ho, wo, th, tw, kt.tile_c, kt.tile_m, band_h,
                 band_w, cols, rows, s)


def _band_reads(g: _Grid, c: int, e: int, m_tiles: int) -> int:
    """The band chunks a kernel stages: one Eq. 6 window of its source per
    (tile, M tile, C chunk)."""
    return g.n * g.h_tiles * m_tiles * g.cols * g.band_h * c * e


def _band_gather_bytes(g: _Grid, c: int, e: int) -> int:
    """``plan.pad_and_band``'s gather: the band rows it reads from the
    padded plane and the bands it writes."""
    return 2 * g.n * g.src_rows * g.src_w * c * e


def _fwd_bytes(g: _Grid, c: int, m: int, k2: int, e: int, oe: int) -> int:
    """Kernels 1a and 4 (``dcf_kernel``, ``dcf_reduce_kernel``) at element
    size ``e`` and offsets of ``oe``: grid (tiles x M tiles x C groups,
    ``fwd_c_groups``)."""
    m_tiles = -(-m // g.tm)
    groups = fwd_c_groups(g.n, g.ho, g.wo, c, m, tile_h=g.th, tile_w=g.tw,
                          tile_c=g.tc, tile_m=g.tm)
    band = _band_reads(g, c, e, m_tiles)
    wgt = g.tiles * k2 * c * m * e
    offs = g.pixels * 2 * k2 * oe * m_tiles * groups
    if groups == 1:
        return band + wgt + offs + g.pixels * m * e
    # Each group's fp32 partial, then the reduction reads them all.
    return band + wgt + offs + g.pixels * m * (4 * groups + 4 * groups + e)


def _q_bytes(g: _Grid, c: int, m: int, k2: int, *, chain: bool,
             out_b: int) -> int:
    """Kernels 1c and 1d (``deform_conv_q.cu``): the weights made
    chunk-major (``dqt_kernel``), the chain's offset conv (``dco_kernel``,
    its C groups ``q_off_groups``, summed by atomics into zeroed int32
    sums), the main body (grid as 1a's, C groups at ``Q_GROUP_LEAST``;
    fp32 offsets, or the int32 sums with their scale and bias, per tap and
    pixel) and its epilogue (scale, and the chain's bias, per output) or
    the reduction of its int32 partials."""
    m_tiles = -(-m // g.tm)
    groups = fwd_c_groups(g.n, g.ho, g.wo, c, m, tile_h=g.th, tile_w=g.tw,
                          tile_c=g.tc, tile_m=g.tm, least=Q_GROUP_LEAST)
    n_off = 2 * k2
    total = 2 * k2 * c * (m + (n_off if chain else 0))          # dqt
    if chain:
        og = q_off_groups(g.n, g.ho, g.wo, c, tile_h=g.th, tile_w=g.tw,
                          tile_c=g.tc)
        total += _band_reads(g, c, 1, 1) + g.tiles * n_off * k2 * c
        total += g.pixels * n_off * 4 * (1 if og == 1 else 1 + 2 * og)
    total += _band_reads(g, c, 1, m_tiles) + g.tiles * k2 * c * m
    total += g.pixels * k2 * (24 if chain else 8) * m_tiles * groups
    epi = 8 if chain else 4
    if groups == 1:
        return total + g.pixels * m * (epi + out_b)
    return total + g.pixels * m * (4 * groups + 4 * groups + epi + out_b)


def _bwd_bytes(g: _Grid, c: int, m: int, k: int, e: int, oe: int) -> int:
    """Kernel 2 (``deform_conv_bwd.cu``): the zeroed fp32 d_input, the
    d_input / d_offsets kernel (grid tiles x ``bwd_c_groups``; per chunk
    the band, W and g, and one fp32 atomic a band position and channel —
    counted at the most, every position; group 0 writes the corner
    geometry), the d_offsets reduction of the C groups' partials, the
    d_weights kernel (C chunks x ``BWD_DW_ROWS`` row blocks x
    ``BWD_DW_COLS`` channel blocks x ``bwd_dw_splits``; per tile the band,
    g, and the geometry) and its reduction, and bf16's rounding of d_input
    from its fp32 workspace."""
    k2, pix = k * k, pix_lanes(g.th, g.tw)
    groups = bwd_c_groups(g.n, g.ho, g.wo, c, tile_h=g.th, tile_w=g.tw,
                          tile_c=g.tc)
    chunks, row_blocks, col_blocks = bwd_dw_grid(c, m, kernel_size=k,
                                                 tile_c=g.tc)
    splits = bwd_dw_splits(g.n, g.ho, g.wo, c, m, kernel_size=k,
                           tile_h=g.th, tile_w=g.tw, tile_c=g.tc)
    npos = g.band_h * g.band_w
    dx_count = g.n * g.src_rows * g.src_w * c
    total = 4 * dx_count                                        # memset
    # d_input / d_offsets.
    total += g.pixels * 2 * k2 * oe * groups
    total += g.tiles * 3 * k2 * pix * 4
    total += g.tiles * (k2 * c * m + npos * c) * e + g.pixels * m * e * \
        (c // g.tc) + g.tiles * npos * c * 8
    if groups == 1:
        total += g.pixels * 2 * k2 * 2 * oe
    else:
        total += g.pixels * 2 * k2 * (4 * groups + 4 * groups + 2 * oe)
    # d_weights.
    kk = k2 * g.tc
    rstep = 4 if g.tc % 4 == 0 else 1
    live = sum(-(-min(BWD_DW_ROWS, kk - r0) // rstep)
               for r0 in range(0, kk, BWD_DW_ROWS))
    g_cols = sum(min(BWD_DW_COLS, m - m0) for m0 in range(0, m, BWD_DW_COLS))
    total += chunks * row_blocks * col_blocks * g.tiles * npos * g.tc * e
    total += chunks * row_blocks * g.pixels * g_cols * e
    total += chunks * col_blocks * live * (g.tiles * pix * 4 + g.pixels * 8)
    total += splits * k2 * c * m * 4
    if splits > 1:
        total += k2 * c * m * (4 * splits + 4)
    if e == 2:
        total += dx_count * (4 + 2)
    return total


def _sample_bytes(g: _Grid, c: int, k2: int, e: int, oe: int) -> int:
    """Kernels 1b and 3 (``ds_kernel``): grid tiles x ``sample_c_groups``;
    per block the offsets, per chunk the band chunk's columns inside the
    source plane, and the patches written."""
    groups = sample_c_groups(g.n, g.ho, g.wo, c, tile_h=g.th, tile_w=g.tw,
                             tile_c=g.tc)
    return (g.pixels * 2 * k2 * oe * groups
            + g.n * g.h_tiles * g.cols * g.band_h * c * e
            + g.pixels * k2 * c * e)


def _check_dataflow(dataflow: str) -> bool:
    """True for the banded (``"materialized_band"``) dataflow."""
    if dataflow not in ("zero_copy", "materialized_band"):
        raise ValueError(f"unknown dataflow {dataflow!r}")
    return dataflow == "materialized_band"


def dcl_dataflow_hbm_bytes(shape: LayerShape, t, *,
                           dataflow: str = "zero_copy", batch: int = 1,
                           dilation: int = 1,
                           bytes_per_elem: int = 4) -> int:
    """The input dataflow's bytes of one DCL call (JAX's
    ``dcl_dataflow_hbm_bytes``, ``repro/core/tiling.py:249``).

    ``"zero_copy"``: the band chunks kernel 1a (or, at 1 byte an element,
    1c) stages, one Eq. 6 window of ``x_pad`` per (tile, M tile, C
    chunk).  ``"materialized_band"``: ``plan.pad_and_band``'s gather (the
    rows it reads, the overlapping bands it writes) and kernel 4's reads
    of those bands, one window of a band per (band tile, column tile, M
    tile, C chunk)."""
    banded = _check_dataflow(dataflow)
    g = _grid(shape, t, batch=batch, dilation=dilation, banded=banded)
    e, c = bytes_per_elem, shape.c_in
    return _band_reads(g, c, e, -(-shape.c_out // g.tm)) \
        + (_band_gather_bytes(g, c, e) if banded else 0)


def dcl_total_hbm_bytes(shape: LayerShape, t, *,
                        dataflow: str = "zero_copy", batch: int = 1,
                        dilation: int = 1, bytes_per_elem: int = 4,
                        offset_bytes_per_elem: int | None = None,
                        out_bytes_per_elem: int | None = None,
                        fused_offsets: bool = False) -> int:
    """Every byte one DCL forward call's launches move (JAX's
    ``dcl_total_hbm_bytes``, ``repro/core/tiling.py:293``).

    ``bytes_per_elem`` 4 or 2: kernel 1a (``"zero_copy"``) or
    ``pad_and_band`` and kernel 4 (``"materialized_band"``) in fp32 or
    bf16, offsets of ``offset_bytes_per_elem`` (default the same), the
    output in the input's dtype.  ``bytes_per_elem`` 1: the int8 kernels
    (zero-copy only): 1c (fp32 offsets, fp32 output) or, with
    ``fused_offsets``, 1d, whose offsets come from its own offset conv and
    whose output is int8 (``out_bytes_per_elem`` 1, the default) or fp32
    (4, a chain's tail)."""
    banded = _check_dataflow(dataflow)
    k2, c, m = shape.kernel_size ** 2, shape.c_in, shape.c_out
    g = _grid(shape, t, batch=batch, dilation=dilation, banded=banded)
    if bytes_per_elem == 1:
        if banded:
            raise ValueError("the int8 kernels read the zero-copy plane only")
        return _q_bytes(g, c, m, k2, chain=fused_offsets,
                        out_b=(out_bytes_per_elem or 1) if fused_offsets
                        else 4)
    if fused_offsets:
        raise ValueError("only the int8 chain (bytes_per_elem=1) fuses the "
                         "offset conv")
    return _fwd_bytes(g, c, m, k2, bytes_per_elem,
                      offset_bytes_per_elem or bytes_per_elem) \
        + (_band_gather_bytes(g, c, bytes_per_elem) if banded else 0)


def dcl_chain_hbm_bytes(shape: LayerShape, t, *, layers: int = 2,
                        batch: int = 1, dilation: int = 1,
                        chained: bool = True) -> int:
    """The kernels' bytes of ``layers`` int8 DCLs back to back (JAX's
    ``dcl_chain_hbm_bytes``, ``repro/core/tiling.py:338``; C_in must equal
    C_out).  ``chained``: kernel 1d a layer, emitting int8 into the next
    layer and fp32 at the tail.  ``chained=False``: kernel 1c a layer (fp32
    offsets in, fp32 out).  The quantize passes and the per-layer path's
    offset conv run as PyTorch operations outside these kernels and are
    not counted."""
    if shape.c_in != shape.c_out:
        raise ValueError(
            f"chained layers hand the tensor over verbatim, so C_in "
            f"must equal C_out (got {shape.c_in} != {shape.c_out})")
    kw = dict(batch=batch, dilation=dilation, bytes_per_elem=1)
    if not chained:
        return layers * dcl_total_hbm_bytes(shape, t, **kw)
    return (layers - 1) * dcl_total_hbm_bytes(shape, t, fused_offsets=True,
                                              **kw) \
        + dcl_total_hbm_bytes(shape, t, fused_offsets=True,
                              out_bytes_per_elem=4, **kw)


def spatial_halo_bytes(shape: LayerShape, *, shards: int,
                       dilation: int = 1, bytes_per_elem: int = 4) -> int:
    """Bytes a device receives in one height-sharded DCL's halo exchange
    (JAX's ``spatial_halo_bytes``, ``repro/core/tiling.py:436``):
    ``2 * halo_rows * W * C`` (``distributed.spatial.exchange_halo``; an
    edge shard's missing halo is zeros made in place), 0 at one shard."""
    if shards < 1:
        raise ValueError(f"shards={shards} must be >= 1")
    if shards == 1:
        return 0
    halo = spatial_halo_rows(kernel_size=shape.kernel_size,
                             dilation=dilation,
                             offset_bound=shape.offset_bound)
    return 2 * halo * shape.w * shape.c_in * bytes_per_elem


def dcl_spatial_hbm_bytes(shape: LayerShape, t, *, shards: int,
                          dataflow: str = "zero_copy", batch: int = 1,
                          dilation: int = 1, bytes_per_elem: int = 4) -> int:
    """One device's bytes of a height-sharded DCL call (JAX's
    ``dcl_spatial_hbm_bytes``, ``repro/core/tiling.py:452``): its shard's
    call (``H / shards`` rows through ``dcl_total_hbm_bytes``) and the halo
    rows it receives (``spatial_halo_bytes``).  ``shape`` is the whole
    layer; ``H % (stride * shards)`` must be 0."""
    if shards < 1:
        raise ValueError(f"shards={shards} must be >= 1")
    if shape.h % (shape.stride * shards) != 0:
        raise ValueError(
            f"shards={shards} does not evenly divide H={shape.h} at "
            f"stride={shape.stride}; a height shard needs equal row blocks "
            f"(H % (stride*shards) == 0)")
    local = dataclasses.replace(shape, h=shape.h // shards)
    return (dcl_total_hbm_bytes(local, t, dataflow=dataflow, batch=batch,
                                dilation=dilation,
                                bytes_per_elem=bytes_per_elem)
            + spatial_halo_bytes(shape, shards=shards, dilation=dilation,
                                 bytes_per_elem=bytes_per_elem))


def dcl_backward_hbm_bytes(shape: LayerShape, t, *,
                           dataflow: str = "zero_copy", batch: int = 1,
                           dilation: int = 1, bytes_per_elem: int = 4,
                           offset_bytes_per_elem: int | None = None) -> int:
    """Every byte kernel 2's launches move in one DCL backward call (JAX's
    ``dcl_backward_hbm_bytes``, ``repro/core/tiling.py:477``, without its
    ``cores``), fp32 or bf16 (``bytes_per_elem``).  Both dataflows run the
    zero-copy backward (``plan.bounded_backward``), so ``dataflow`` only
    checks its name.  d_input's atomics are counted as a read and a write
    of every band position and channel a chunk; a position no corner
    reaches adds nothing, so that term is the most the data can ask."""
    _check_dataflow(dataflow)
    g = _grid(shape, t, batch=batch, dilation=dilation)
    return _bwd_bytes(g, shape.c_in, shape.c_out, shape.kernel_size,
                      bytes_per_elem,
                      offset_bytes_per_elem or bytes_per_elem)


def dcl_train_hbm_bytes(shape: LayerShape, t, *,
                        dataflow: str = "zero_copy", batch: int = 1,
                        dilation: int = 1, bytes_per_elem: int = 4,
                        bwd_tiles=None) -> int:
    """One training call's bytes: the forward (``dcl_total_hbm_bytes`` at
    ``t``) and kernel 2 at ``bwd_tiles`` (default ``t``; the port resolves
    the backward's own tiles, ``"fp32_bwd"``) — JAX's
    ``dcl_train_hbm_bytes`` (``repro/core/tiling.py:602``)."""
    kw = dict(dataflow=dataflow, batch=batch, dilation=dilation,
              bytes_per_elem=bytes_per_elem)
    return (dcl_total_hbm_bytes(shape, t, **kw)
            + dcl_backward_hbm_bytes(shape, t if bwd_tiles is None
                                     else bwd_tiles, **kw))


def dcl_sample_hbm_bytes(shape: LayerShape, t, *,
                         dataflow: str = "zero_copy", batch: int = 1,
                         dilation: int = 1, bytes_per_elem: int = 4,
                         offset_bytes_per_elem: int | None = None) -> int:
    """Every byte one sampling call moves: kernel 1b (``"zero_copy"``) or
    ``pad_and_band`` and kernel 3 (``"materialized_band"``); ``t``'s
    ``tile_m`` is unused.  The JAX package has no such model."""
    banded = _check_dataflow(dataflow)
    g = _grid(shape, t, batch=batch, dilation=dilation, banded=banded)
    e = bytes_per_elem
    return _sample_bytes(g, shape.c_in, shape.kernel_size ** 2, e,
                         offset_bytes_per_elem or e) \
        + (_band_gather_bytes(g, shape.c_in, e) if banded else 0)
