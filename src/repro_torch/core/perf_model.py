"""The paper's calibrated FPGA model, the DCL traffic reports of the
port's kernels, and the runtime health of the Eq. 5 bound (counterpart of
``repro.core.perf_model``).

**The FPGA model** reproduces the paper's Fig. 3 / Fig. 8 / Fig. 9 from an
analytic model of two accelerators on the paper's Virtex-7 class design,
unchanged from the JAX package (it describes the paper's hardware, not a
TPU and not the H100):

* **conventional** — Wei et al. DAC'17 [22]: a systolic CNN accelerator
  with no DCL-aware input buffering.  Bilinear samples that miss the
  on-chip buffer issue irregular DRAM reads that stall the pipeline.
* **ours** — the paper's accelerator: the Eq. 5-trained model has a
  bounded receptive field, the Eq. 6-sized input buffer provably holds
  every sample, all reads hit on-chip, and the two stages are pipelined.

It is calibrated against the paper's published numbers (13.8 MB
stall-free buffer at lambda=0, 12.68x RF compression at lambda=0.005,
5.28x-17.25x speedup for N in {128, 256, 512}, 1.39x energy saving).
Offset magnitudes are modelled as a half-normal distribution whose scale
is set by the trained ``o_max`` for each lambda (paper Fig. 7); the
buffer hit rate of a capacity-C buffer is the CDF of the coverage radius
that C buys via Eq. 6.

**The traffic reports** (``dataflow_traffic_report``,
``parallel_training_report``, ``spatial_sharding_report``) are re-derived
for the port's kernels: every byte count is the bytes of a work of
``core.h100`` (each input read once, each output written once) at the
tiles the port's chooser resolves, times are those bytes at the H100's
HBM rate, and bytes that cross between cards (the halo exchange, the
gradient sum) are priced at NVLink 4's rate in one direction
(``h100.NVLINK_BYTES_PER_S``).

**The health report** (``bound_saturation``, ``runtime_health_report``)
takes the offsets as a tensor on any device (or anything
``torch.as_tensor`` takes) and returns Python floats.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core import h100
from repro_torch.core.tiling import (PAPER_TILES, LayerShape, TileConfig,
                                     band_extent, choose_kernel_tiles,
                                     input_buffer_size, out_hw,
                                     receptive_field, spatial_halo_rows)

# Calibration constants
# ---------------------------------------------------------------------------

# Trained network-max offset per lambda (paper Fig. 6/7; lambda=0 chosen so
# Eq. 6 gives the paper's 13.8 MB stall-free buffer with their tiling).
O_MAX_BY_LAMBDA: dict[float, float] = {
    0.0: 37.5,      # RF = 3 + 2*38 = 79  -> Eq.6 ~= 13.8 MB @ T_W=8, T_N=512
    0.005: 1.6,     # RF = 7; 79/6.23 ... combined with tail mass ~= 12.68x
    0.0075: 1.2,    # RF = 7
    0.01: 0.9,      # RF = 5
}

# Half-normal scale as a fraction of the observed max (tail calibration):
# P(|o| > o_max) ~ 1e-4 for the validation set => o_max ~= 3.9 sigma.
_SIGMA_FRACTION = 1.0 / 3.9

KERNEL_SIZE = 3
FREQ_HZ = 200e6                   # paper-class HLS design frequency
PE_MACS_PER_CYCLE = 2596 // 2     # ~2596 DSPs, 2 DSP per fp32 MAC
DRAM_BW_BYTES_PER_S = 12.8e9      # DDR3-1600 x1 channel
ONCHIP_BW_BYTES_PER_S = 4e9       # paper: "bandwidth between on-chip buffers was 4GB/s"
DRAM_RANDOM_LATENCY_CYCLES = 130  # queueing + tRC row-cycle penalty @200 MHz
DRAM_BURST_CYCLES = 1.0           # per 64-B burst once the row is open
DRAM_BURST_BYTES = 64
T_M_PASS = 64                     # output-channel tile (the paper's T_M)

# Energy constants (Micron TN-41-01-class DDR3 + 28 nm on-chip estimates).
E_DRAM_PJ_PER_BYTE_SEQ = 70.0
E_DRAM_PJ_PER_BYTE_RAND = 120.0   # row-miss overhead on irregular access
E_BRAM_PJ_PER_BYTE = 2.5          # at the reference 416 KiB capacity
E_MAC_PJ = 4.5                    # fp32 MAC @28nm
BRAM_REF_BYTES = 416 * 1024       # BRAM pJ/B scales ~sqrt(capacity/ref)

CONV_BUFFER_BYTES = 416 * 1024    # conventional [22] input-buffer capacity


def sigma_for_lambda(lam: float) -> float:
    if lam not in O_MAX_BY_LAMBDA:
        # interpolate in log-space of o_max over known lambdas
        ks = sorted(O_MAX_BY_LAMBDA)
        lo = max([k for k in ks if k <= lam], default=ks[0])
        hi = min([k for k in ks if k >= lam], default=ks[-1])
        if lo == hi:
            o = O_MAX_BY_LAMBDA[lo]
        else:
            t = (lam - lo) / (hi - lo)
            o = math.exp((1 - t) * math.log(O_MAX_BY_LAMBDA[lo])
                         + t * math.log(O_MAX_BY_LAMBDA[hi]))
    else:
        o = O_MAX_BY_LAMBDA[lam]
    return o * _SIGMA_FRACTION


def o_max_for_lambda(lam: float) -> float:
    return sigma_for_lambda(lam) / _SIGMA_FRACTION


def halfnormal_cdf(x: float, sigma: float) -> float:
    if sigma <= 0:
        return 1.0
    return math.erf(x / (sigma * math.sqrt(2.0)))


# ---------------------------------------------------------------------------
# Fig. 3 — input-buffer efficiency vs capacity
# ---------------------------------------------------------------------------

def rf_compression(lam: float, *, baseline_lam: float = 0.0) -> float:
    """Paper abstract: 12.6x receptive-field compression (real-valued RF,
    RF = K + 2*o_max, between lambda=0 and the given lambda)."""
    rf0 = KERNEL_SIZE + 2 * o_max_for_lambda(baseline_lam)
    rf1 = KERNEL_SIZE + 2 * o_max_for_lambda(lam)
    return rf0 / rf1


def coverage_radius(capacity_bytes: int, *, t_w: int = PAPER_TILES.t_w,
                    t_n: int = PAPER_TILES.t_n, stride: int = 1,
                    bytes_per_elem: int = 4) -> float:
    """Largest offset radius r such that the Eq. 6 buffer for
    RF = K + 2*ceil(r) fits in ``capacity_bytes``."""
    r = 0
    while True:
        rf = receptive_field(KERNEL_SIZE, r + 1)
        if input_buffer_size(rf, stride, t_w, t_n,
                             bytes_per_elem=bytes_per_elem) > capacity_bytes:
            return float(r)
        r += 1
        if r > 1 << 14:
            return float(r)


def buffer_efficiency(capacity_bytes: int, lam: float, **kw) -> float:
    """Fig. 3: % of bilinear-interpolation reads served by the buffer."""
    r = coverage_radius(capacity_bytes, **kw)
    return halfnormal_cdf(r + 0.5, sigma_for_lambda(lam))


def stall_free_capacity(lam: float, *, t_w: int = PAPER_TILES.t_w,
                        t_n: int = PAPER_TILES.t_n, stride: int = 1,
                        bytes_per_elem: int = 4) -> int:
    """Buffer bytes needed for (numerically) stall-free operation —
    paper: 13.8 MB at lambda=0, ~3% of that after regularization."""
    rf = receptive_field(KERNEL_SIZE, o_max_for_lambda(lam))
    return input_buffer_size(rf, stride, t_w, t_n,
                             bytes_per_elem=bytes_per_elem)


# ---------------------------------------------------------------------------
# Fig. 8 — cycle model
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DCLWorkload:
    """One DCL invocation (paper evaluates ResNet-50 DCLs by N)."""
    h: int = 56
    w: int = 56
    n: int = 256          # input channels (the paper's N)
    m: int = 256          # output channels
    kernel_size: int = KERNEL_SIZE
    stride: int = 1

    @property
    def out_pixels(self) -> int:
        return (self.h // self.stride) * (self.w // self.stride)

    @property
    def macs(self) -> int:
        k2 = self.kernel_size ** 2
        conv = self.out_pixels * k2 * self.n * self.m
        bilinear = self.out_pixels * k2 * self.n * 4
        return conv + bilinear


def _miss_rate(wl: DCLWorkload, lam: float, capacity: int) -> float:
    """Fraction of bilinear corner reads that miss a capacity-C input
    buffer when the layer is tiled T_N = N (the coverage radius shrinks
    as N grows — deeper layers cache fewer rows)."""
    r = coverage_radius(capacity, t_n=wl.n)
    return 1.0 - halfnormal_cdf(r + 0.5, sigma_for_lambda(lam))


def cycles_ours(wl: DCLWorkload, lam: float) -> float:
    """Bounded-RF accelerator: fully pipelined; all samples hit on-chip.

    The PE array is provisioned for the paper's T_N = 512 channel tile,
    so at N < 512 it is underutilized — this is exactly why the paper's
    Fig. 8 speedup grows with N ("improved by increasing the number of
    data reuses").  Interpolated patches are computed ONCE and reused
    across every output-channel pass.
    """
    util = min(1.0, wl.n / PAPER_TILES.t_n)
    comp = wl.macs / (PE_MACS_PER_CYCLE * util)
    bytes_seq = (wl.h * wl.w * wl.n + wl.out_pixels * wl.m
                 + wl.kernel_size ** 2 * wl.n * wl.m) * 4
    mem = bytes_seq / DRAM_BW_BYTES_PER_S * FREQ_HZ
    # Residual misses for the Eq. 6-sized buffer of the trained bound
    # (numerically ~0: the buffer is sized to cover the trained o_max).
    miss = 1.0 - buffer_efficiency(stall_free_capacity(lam), lam)
    stall = wl.out_pixels * wl.kernel_size ** 2 * 4 * miss \
        * DRAM_RANDOM_LATENCY_CYCLES
    return max(comp, mem) + stall


def cycles_conventional(wl: DCLWorkload, lam: float) -> float:
    """[22]-style accelerator: no DCL-aware buffering.  Every buffer miss
    issues an irregular DRAM read (row-miss latency + channel bursts) and
    stalls the pipeline; misses recur on EVERY output-channel tile pass
    because interpolated patches are not reused (M/T_M passes)."""
    comp = wl.macs / PE_MACS_PER_CYCLE        # [22] tiles T_N to the layer
    miss = _miss_rate(wl, lam, CONV_BUFFER_BYTES)
    passes = math.ceil(wl.m / T_M_PASS)
    misses = wl.out_pixels * wl.kernel_size ** 2 * 4 * miss * passes
    bursts = math.ceil(wl.n * 4 / DRAM_BURST_BYTES)
    stall_per_miss = DRAM_RANDOM_LATENCY_CYCLES + bursts * DRAM_BURST_CYCLES
    return comp + misses * stall_per_miss


def speedup(n_channels: int, lam_ours: float, lam_conv: float = 0.0,
            **kw) -> float:
    """Fig. 8: 'combination of our algorithm and accelerator' (ours @
    lam_ours) vs the conventional accelerator running the unregularized
    model (lam_conv = 0)."""
    wl = DCLWorkload(n=n_channels, m=n_channels, **kw)
    return cycles_conventional(wl, lam_conv) / cycles_ours(wl, lam_ours)


# ---------------------------------------------------------------------------
# Fig. 9 — energy model
# ---------------------------------------------------------------------------

def _common_dynamic_energy(wl: DCLWorkload) -> float:
    """Energy both designs pay: MACs, sequential in/weight/out streaming,
    and the stage-1 -> stage-2 patch round-trip through DRAM.  NOTE: the
    paper's OWN accelerator also stores interpolated inputs to DRAM
    between stages (their Fig. 4); the fused kernels remove that round
    trip beyond the paper — not claimed here."""
    seq_bytes = (wl.h * wl.w * wl.n + wl.out_pixels * wl.m
                 + wl.kernel_size ** 2 * wl.n * wl.m) * 4
    patch_bytes = 2 * wl.out_pixels * wl.kernel_size ** 2 * wl.n * 4
    return (seq_bytes + patch_bytes) * E_DRAM_PJ_PER_BYTE_SEQ \
        + wl.macs * E_MAC_PJ


def _bram_pj_per_byte(capacity_bytes: int) -> float:
    """Larger SRAMs cost more per access (longer word/bit lines)."""
    return E_BRAM_PJ_PER_BYTE * math.sqrt(
        max(capacity_bytes, BRAM_REF_BYTES) / BRAM_REF_BYTES)


def energy_ours(wl: DCLWorkload, lam: float) -> float:
    """pJ for one DCL on the bounded-RF accelerator: all sampling reads
    hit the Eq. 6-sized on-chip buffer.  At lam=0 that buffer is 13.8 MB
    — the 'large on-chip buffer systems cause high energy consumption'
    the paper warns about — captured by capacity-scaled pJ/B."""
    onchip_bytes = wl.out_pixels * wl.kernel_size ** 2 * wl.n * 4 * 4
    cap = stall_free_capacity(lam)
    return _common_dynamic_energy(wl) + onchip_bytes * _bram_pj_per_byte(cap)


def energy_conventional(wl: DCLWorkload, lam: float) -> float:
    """pJ for the [22]-style dataflow.  Missed sample lines are fetched
    from DRAM with row-miss (irregular) pricing; the fetched line is
    inserted into the buffer so later output-channel passes hit on-chip
    (the ENERGY view; the TIME view in ``cycles_conventional`` still
    stalls every pass on pipeline refill)."""
    miss = _miss_rate(wl, lam, CONV_BUFFER_BYTES)
    misses = wl.out_pixels * wl.kernel_size ** 2 * 4 * miss
    rand_bytes = misses * math.ceil(wl.n * 4 / DRAM_BURST_BYTES) \
        * DRAM_BURST_BYTES
    onchip_bytes = wl.out_pixels * wl.kernel_size ** 2 * wl.n * 4 * 4
    return (_common_dynamic_energy(wl)
            + rand_bytes * E_DRAM_PJ_PER_BYTE_RAND
            + onchip_bytes * E_BRAM_PJ_PER_BYTE)


def energy_ratio(n_channels: int, lam_ours: float, lam_conv: float = 0.0,
                 **kw) -> float:
    """Fig. 9: energy of conventional (unregularized model) over ours."""
    wl = DCLWorkload(n=n_channels, m=n_channels, **kw)
    return energy_conventional(wl, lam_conv) / energy_ours(wl, lam_ours)


# ---------------------------------------------------------------------------
# DCL traffic of the port's kernels (core.h100's works)
# ---------------------------------------------------------------------------

def _input_bytes(n: int, shape: LayerShape, itemsize: int) -> int:
    """The input term of kernel 1a's work: x read once."""
    return n * shape.h * shape.w * shape.c_in * itemsize


def _band_bytes(n: int, shape: LayerShape, tile_h: int, dilation: int,
                itemsize: int) -> int:
    """The input term of kernel 4's work: the materialised bands of
    ``tile_h``-row tiles (``plan.pad_and_band``), as ``h100.banded_work``
    counts them."""
    ho, _ = out_hw(shape.h, shape.w, kernel_size=shape.kernel_size,
                   stride=shape.stride, dilation=dilation)
    band_h = band_extent(tile_h, kernel_size=shape.kernel_size,
                         stride=shape.stride, dilation=dilation,
                         offset_bound=shape.offset_bound)
    p0 = dilation * (shape.kernel_size // 2) \
        + int(math.ceil(shape.offset_bound))
    return n * -(-ho // tile_h) * band_h * (shape.w + 2 * p0 + 1) \
        * shape.c_in * itemsize


def dataflow_traffic_report(*, h: int = 64, w: int = 64, c: int = 128,
                            m: int = 128, batch: int = 4, tile_h: int = 8,
                            offset_bound: float = 2.0, kernel_size: int = 3,
                            stride: int = 1,
                            bytes_per_elem: int = 4) -> dict:
    """Bytes of one bounded DCL through the port's kernels, each the bytes
    of a ``core.h100`` work (each input read once, each output written
    once):

    * forward: kernel 1a (``zero_copy_total_bytes``, ``forward_work``)
      against kernel 4 over ``tile_h``-row bands
      (``materialized_band_total_bytes``, ``banded_work``); their input
      terms (x, or the bands) are ``zero_copy_bytes`` and
      ``materialized_band_bytes``, and ``ratio`` is band over zero-copy;
    * backward: kernel 2 (``backward_work``) on both dataflows — the port's
      banded forward has kernel 2 as its backward too, so ``bwd_ratio``
      is 1; ``*_train_bytes`` add forward and backward;
    * int8: kernel 1c (``int8_work``; fp32 offsets in, fp32 out):
      ``zero_copy_bytes_q`` is its input term at 1 byte an element,
      ``q_ratio`` the fp32 input term over it, ``zero_copy_total_bytes_q``
      the whole work and ``q_total_ratio`` kernel 1a's over it;
    * the chain: two chained layers on kernel 1d (``int8_work(chain=True,
      emit="int8")``, ``chain_bytes``) against two calls of kernel 1c
      (``chain_per_layer_bytes``; the per-layer path's offset conv and
      quantize pass are layers outside the kernels and not counted, so
      this is its least traffic); ``total_bytes_q_fused_offsets`` is one
      chained layer.  Chaining needs C_in = C_out: a non-square layer is
      modelled by its square analogue, as in JAX.

    ``tiles`` are the fp32 forward's chooser tiles
    (``tiling.choose_kernel_tiles``) and ``tiles_int8`` the int8
    kernel's; ``tiles_banded`` kernel 4's at ``tile_h`` rows.  The JAX
    report's Megacore keys (``cores``, ``*_per_core``, ``*_mc_total``,
    ``bwd_per_core_ratio``) have no counterpart: the card has no
    Megacore batch split.  ``bytes_per_elem`` (4 or 2) sets the fp32 or
    bf16 instance of kernels 1a, 4 and 2."""
    shape = LayerShape(h=h, w=w, c_in=c, c_out=m, kernel_size=kernel_size,
                       stride=stride, offset_bound=offset_bound)
    g = dict(kernel_size=kernel_size, stride=stride, dilation=1)
    dims = (batch, h, w, c, m)
    item = dict(itemsize=bytes_per_elem)
    tiles = choose_kernel_tiles(*dims, offset_bound=offset_bound,
                                dtype="fp32", itemsize=bytes_per_elem, **g)
    tiles_b = choose_kernel_tiles(*dims, offset_bound=offset_bound,
                                  dtype="banded", tile_h=tile_h,
                                  itemsize=bytes_per_elem, **g)
    tiles_q = choose_kernel_tiles(*dims, offset_bound=offset_bound,
                                  dtype="int8", **g)
    fwd = h100.forward_work(*dims, **g, **item)
    band = h100.banded_work(*dims, **g, offset_bound=offset_bound,
                            tile_h=tile_h, **item)
    bwd = h100.backward_work(*dims, **g, **item)
    q = h100.int8_work(*dims, **g)
    zero_in = _input_bytes(batch, shape, bytes_per_elem)
    band_in = _band_bytes(batch, shape, tile_h, 1, bytes_per_elem)
    zero_in_q = _input_bytes(batch, shape, 1)
    cc = (batch, h, w, c, c)
    chain_one = h100.int8_work(*cc, **g, chain=True, emit="int8")["bytes"]
    per_layer = h100.int8_work(*cc, **g)["bytes"]
    return {
        "tiles": tiles,
        "tiles_banded": tiles_b,
        "zero_copy_bytes": zero_in,
        "materialized_band_bytes": band_in,
        "ratio": band_in / max(zero_in, 1),
        "zero_copy_bwd_bytes": bwd["bytes"],
        "materialized_band_bwd_bytes": bwd["bytes"],
        "bwd_ratio": 1.0,
        "zero_copy_train_bytes": fwd["bytes"] + bwd["bytes"],
        "materialized_band_train_bytes": band["bytes"] + bwd["bytes"],
        "train_ratio": (band["bytes"] + bwd["bytes"])
        / max(fwd["bytes"] + bwd["bytes"], 1),
        "zero_copy_total_bytes": fwd["bytes"],
        "materialized_band_total_bytes": band["bytes"],
        "zero_copy_bytes_q": zero_in_q,
        "q_ratio": zero_in / max(zero_in_q, 1),
        "zero_copy_total_bytes_q": q["bytes"],
        "q_total_ratio": fwd["bytes"] / max(q["bytes"], 1),
        "tiles_int8": tiles_q,
        "chain_layers": 2,
        "chain_per_layer_bytes": 2 * per_layer,
        "chain_bytes": 2 * chain_one,
        "chain_ratio": per_layer / max(chain_one, 1),
        "total_bytes_q_fused_offsets": chain_one,
    }


def parallel_training_report(*, h: int = 64, w: int = 64, c: int = 128,
                             m: int = 128, batch: int = 8,
                             offset_bound: float = 2.0,
                             kernel_size: int = 3, stride: int = 1,
                             devices: int = 4,
                             bytes_per_elem: int = 4) -> dict:
    """Data-parallel training of one bounded DCL over ``devices`` cards.

    Each card runs kernels 1a and 2 (``h100.training_work``) on
    ``batch/devices`` samples from its own HBM; the d_weights sum crosses
    NVLink each step, charged as a ring all-reduce (2x the fp32 d_weights
    bytes, reduce-scatter then all-gather) at NVLink 4's rate in one
    direction.  ``device_speedup`` is the HBM-time ratio t(1)/t(devices)
    with that sum charged.  The JAX report's Megacore level (``cores``,
    ``bwd_bytes_per_core``, ``bwd_bytes_mc_total``, ``bwd_per_core_ratio``,
    ``core_speedup_*``) has no counterpart on the card."""
    if batch % devices:
        raise ValueError(
            f"devices={devices} must divide batch={batch} — the same "
            f"constraint kernels.ops.check_batch_split enforces")
    g = dict(kernel_size=kernel_size, stride=stride, dilation=1,
             itemsize=bytes_per_elem)
    tiles = choose_kernel_tiles(batch, h, w, c, m, kernel_size=kernel_size,
                                stride=stride, offset_bound=offset_bound,
                                dtype="fp32_bwd", itemsize=bytes_per_elem)
    bwd_1 = h100.backward_work(batch, h, w, c, m, **g)["bytes"]
    dw_bytes = kernel_size ** 2 * c * m * 4
    per_dev = batch // devices
    train_1 = h100.training_work(batch, h, w, c, m, **g)["bytes"]
    train_dev = h100.training_work(per_dev, h, w, c, m, **g)["bytes"]
    t_single = train_1 / h100.PEAK_HBM_BYTES_PER_S
    t_dev = train_dev / h100.PEAK_HBM_BYTES_PER_S \
        + 2 * dw_bytes / h100.NVLINK_BYTES_PER_S
    return {
        "tiles": tiles,
        "devices": devices,
        "bwd_bytes_seq": bwd_1,
        "dw_stationary_bytes": bwd_1 - dw_bytes,
        "train_bytes_single": train_1,
        "train_bytes_per_device": train_dev,
        "dw_psum_bytes": dw_bytes,
        "modeled_step_sec_single": t_single,
        "modeled_step_sec_sharded": t_dev,
        "device_speedup": t_single / max(t_dev, 1e-30),
    }


def spatial_halo_bytes(shape: LayerShape, *, shards: int,
                       dilation: int = 1, bytes_per_elem: int = 4) -> int:
    """Halo rows one interior height shard receives a layer:
    ``2 * halo_rows * W * C`` elements (one block from each neighbour,
    ``distributed.spatial.exchange_halo``); none at one shard."""
    if shards < 1:
        raise ValueError(f"shards={shards} must be >= 1")
    if shards == 1:
        return 0
    halo = spatial_halo_rows(kernel_size=shape.kernel_size,
                             dilation=dilation,
                             offset_bound=shape.offset_bound)
    return 2 * halo * shape.w * shape.c_in * bytes_per_elem


def spatial_sharding_report(shape: LayerShape | None = None, *,
                            shards: tuple[int, ...] = (1, 2, 4),
                            dilation: int = 1,
                            bytes_per_elem: int = 4) -> dict:
    """Single-image latency of one bounded DCL height-sharded over
    ``shards`` cards (``distributed.spatial``).

    The default shape is a megapixel-class early layer (1024x1024x64 ->
    64, B = 2.0).  Per shard count ``s`` each card runs kernel 1a
    (``h100.forward_work``) on its ``H/s`` rows at the chooser's local
    tiles (``tiles_{s}shard``) and receives ``halo_bytes_{s}shard``
    (``spatial_halo_bytes``) from its neighbours;
    ``fwd_hbm_bytes_{s}shard`` is its work's bytes plus the halo it
    reads.  ``modeled_us_{s}shard`` charges the work at HBM rate and the
    halo at NVLink 4's rate in one direction, so
    ``modeled_speedup_{s}shard`` undershoots ``traffic_ratio_{s}shard``
    by the exchange."""
    if shape is None:
        shape = LayerShape(h=1024, w=1024, c_in=64, c_out=64,
                           offset_bound=2.0)
    halo = spatial_halo_rows(kernel_size=shape.kernel_size,
                             dilation=dilation,
                             offset_bound=shape.offset_bound)
    g = dict(kernel_size=shape.kernel_size, stride=shape.stride,
             dilation=dilation)

    def work(h: int) -> int:
        return h100.forward_work(1, h, shape.w, shape.c_in, shape.c_out,
                                 itemsize=bytes_per_elem, **g)["bytes"]

    base = work(shape.h)
    t_single = base / h100.PEAK_HBM_BYTES_PER_S
    out = {"shape": shape, "halo_rows": halo, "fwd_hbm_bytes_single": base,
           "modeled_us_single": t_single * 1e6}
    for s in shards:
        h_loc = shape.h // s
        halo_b = spatial_halo_bytes(shape, shards=s, dilation=dilation,
                                    bytes_per_elem=bytes_per_elem)
        per_dev = work(h_loc) + halo_b
        t_dev = (per_dev - halo_b) / h100.PEAK_HBM_BYTES_PER_S \
            + halo_b / h100.NVLINK_BYTES_PER_S
        out[f"tiles_{s}shard"] = choose_kernel_tiles(
            1, h_loc, shape.w, shape.c_in, shape.c_out,
            offset_bound=shape.offset_bound, dtype="fp32",
            itemsize=bytes_per_elem, **g)
        out[f"fwd_hbm_bytes_{s}shard"] = per_dev
        out[f"halo_bytes_{s}shard"] = halo_b
        out[f"traffic_ratio_{s}shard"] = base / max(per_dev, 1)
        out[f"modeled_us_{s}shard"] = t_dev * 1e6
        out[f"modeled_speedup_{s}shard"] = t_single / max(t_dev, 1e-30)
    return out


# ---------------------------------------------------------------------------
# Runtime health: bound saturation
# ---------------------------------------------------------------------------
#
# The whole dataflow is only as correct as the Eq. 5 bound: an
# out-of-distribution input whose offsets hit the clamp makes the kernel
# silently saturate where unbounded reference math would have sampled
# farther away.  The fraction of offset components clamped at B is a
# cheap health metric on the (N, Ho, Wo, 2*K*K) offsets a layer already
# produced, on whatever device they lie.

def bound_saturation(offsets, offset_bound: float, *,
                     atol: float = 1e-6) -> float:
    """Fraction of offset components with |o| >= B (the Eq. 5 clamp).

    ``offsets`` is a tensor on any device (or anything
    ``torch.as_tensor`` takes) of raw offset-conv outputs, compared in
    fp32; components within ``atol`` of the bound count as clamped (the
    kernel's clip makes |o| == B exactly).  0.0 for an empty tensor."""
    if offset_bound is None or offset_bound <= 0:
        raise ValueError(
            f"bound_saturation needs a positive offset_bound (got "
            f"{offset_bound!r}); the unbounded baseline has no clamp to "
            f"saturate")
    off = torch.as_tensor(offsets).detach().float()
    if off.numel() == 0:
        return 0.0
    edge = torch.tensor(offset_bound - atol, dtype=torch.float32)
    return int((off.abs() >= edge.to(off.device)).sum()) / off.numel()


def runtime_health_report(offsets, offset_bound: float, *,
                          threshold: float = 0.05) -> dict:
    """Gate ``bound_saturation`` against a deployment threshold.

    A healthy Eq. 5-trained model keeps the trained offsets well inside
    B (the half-normal tail puts ~1e-4 of the mass at o_max); a clamp
    fraction above ``threshold`` means the input distribution has
    drifted past what the bound was trained for — the signal to fall
    back down the serving engine's degradation ladder or retrain the
    bound."""
    frac = bound_saturation(offsets, offset_bound)
    return {"offset_bound": float(offset_bound),
            "bound_saturation": frac,
            "threshold": float(threshold),
            "healthy": frac <= threshold}
