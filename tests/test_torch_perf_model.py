"""Port parity: ``repro_torch.core.perf_model`` and the paper's buffer
algebra in ``repro_torch.core.tiling`` against the JAX package.

* The FPGA model (the paper's Virtex-7 design) is the JAX package's,
  unchanged: every function equals JAX's over a grid of lambda, N and
  buffer capacity (relative 1e-12), and the port passes JAX's five claims
  against the paper's published numbers.
* The health report equals JAX's on the same seeded offsets.
* The traffic reports are re-derived for the port's kernels: each byte
  count is the sum of ``core.h100``'s works, and the structural claims of
  JAX's tests hold (zero-copy below banded, the chain below two per-layer
  calls, the int8 input ratio, the halo exchange charged).
"""
import numpy as np
import pytest
import torch

from repro.core import perf_model as JPM
from repro.core import tiling as JTiling
from repro_torch.core import h100
from repro_torch.core import perf_model as pm
from repro_torch.core import tiling

REL = 1e-12
LAMS = (0.0, 0.0025, 0.005, 0.0075, 0.01, 0.02)
NS = (64, 128, 256, 512)
CAPS = (64 << 10, 416 << 10, 512 << 10, 4 << 20, 16 << 20)


def _eq(got, want):
    assert got == pytest.approx(want, rel=REL, abs=0.0), (got, want)


# ---------------------------------------------------------------------------
# The FPGA model against JAX's
# ---------------------------------------------------------------------------

def test_calibration_constants_equal_jax():
    for name in ("O_MAX_BY_LAMBDA", "_SIGMA_FRACTION", "KERNEL_SIZE",
                 "FREQ_HZ", "PE_MACS_PER_CYCLE", "DRAM_BW_BYTES_PER_S",
                 "ONCHIP_BW_BYTES_PER_S", "DRAM_RANDOM_LATENCY_CYCLES",
                 "DRAM_BURST_CYCLES", "DRAM_BURST_BYTES", "T_M_PASS",
                 "E_DRAM_PJ_PER_BYTE_SEQ", "E_DRAM_PJ_PER_BYTE_RAND",
                 "E_BRAM_PJ_PER_BYTE", "E_MAC_PJ", "BRAM_REF_BYTES",
                 "CONV_BUFFER_BYTES"):
        assert getattr(pm, name) == getattr(JPM, name), name


def test_buffer_algebra_equals_jax():
    assert tiling.PAPER_TILES.__dict__ == JTiling.PAPER_TILES.__dict__
    for k in (1, 3, 5):
        for b in (0.0, 0.9, 1.6, 2.0, 37.5):
            assert tiling.receptive_field(k, b) \
                == JTiling.receptive_field(k, b)
    for rf, s, tw, tn in ((7, 1, 8, 512), (79, 1, 8, 512), (5, 2, 16, 64)):
        for bpe in (1, 2, 4):
            assert tiling.input_buffer_size(rf, s, tw, tn,
                                            bytes_per_elem=bpe) \
                == JTiling.input_buffer_size(rf, s, tw, tn,
                                             bytes_per_elem=bpe)
            assert tiling.output_buffer_size(tw, tn, 3, bytes_per_elem=bpe) \
                == JTiling.output_buffer_size(tw, tn, 3, bytes_per_elem=bpe)
            assert tiling.weight_buffer_size(3, tn, 64, bytes_per_elem=bpe) \
                == JTiling.weight_buffer_size(3, tn, 64, bytes_per_elem=bpe)
    shape = tiling.LayerShape(h=56, w=56, c_in=256, c_out=128,
                              offset_bound=1.6)
    jshape = JTiling.LayerShape(h=56, w=56, c_in=256, c_out=128,
                                offset_bound=1.6)
    assert shape.rf == jshape.rf == 7


@pytest.mark.parametrize("lam", LAMS)
def test_lambda_functions_equal_jax(lam):
    _eq(pm.sigma_for_lambda(lam), JPM.sigma_for_lambda(lam))
    _eq(pm.o_max_for_lambda(lam), JPM.o_max_for_lambda(lam))
    _eq(pm.rf_compression(lam), JPM.rf_compression(lam))
    _eq(pm.stall_free_capacity(lam), JPM.stall_free_capacity(lam))
    for x in (0.0, 0.5, 1.0, 3.0):
        _eq(pm.halfnormal_cdf(x, pm.sigma_for_lambda(lam)),
            JPM.halfnormal_cdf(x, JPM.sigma_for_lambda(lam)))


@pytest.mark.parametrize("cap", CAPS)
def test_buffer_functions_equal_jax(cap):
    for tn in NS:
        _eq(pm.coverage_radius(cap, t_n=tn), JPM.coverage_radius(cap, t_n=tn))
    for lam in LAMS:
        _eq(pm.buffer_efficiency(cap, lam), JPM.buffer_efficiency(cap, lam))


@pytest.mark.parametrize("n", NS)
def test_cycle_and_energy_functions_equal_jax(n):
    wl, jwl = pm.DCLWorkload(n=n, m=n), JPM.DCLWorkload(n=n, m=n)
    assert wl.macs == jwl.macs and wl.out_pixels == jwl.out_pixels
    for lam in LAMS:
        _eq(pm.cycles_ours(wl, lam), JPM.cycles_ours(jwl, lam))
        _eq(pm.cycles_conventional(wl, lam),
            JPM.cycles_conventional(jwl, lam))
        _eq(pm.speedup(n, lam), JPM.speedup(n, lam))
        _eq(pm.energy_ours(wl, lam), JPM.energy_ours(jwl, lam))
        _eq(pm.energy_conventional(wl, lam),
            JPM.energy_conventional(jwl, lam))
        _eq(pm.energy_ratio(n, lam), JPM.energy_ratio(n, lam))


# JAX's tests/test_perf_model.py, on the port.

def test_stall_free_capacity_matches_paper():
    assert pm.stall_free_capacity(0.0) == pytest.approx(13.8e6, rel=0.05)
    frac = pm.stall_free_capacity(0.005) / pm.stall_free_capacity(0.0)
    assert frac < 0.05


def test_rf_compression_matches_paper():
    assert pm.rf_compression(0.005) == pytest.approx(12.6, rel=0.03)


def test_speedup_matches_paper():
    s128 = pm.speedup(128, 0.005)
    s512 = pm.speedup(512, 0.005)
    assert s128 == pytest.approx(5.28, rel=0.08)
    assert s512 == pytest.approx(17.25, rel=0.05)
    assert s128 < pm.speedup(256, 0.005) < s512


def test_energy_matches_paper():
    ratios = [pm.energy_ratio(n, 0.005) for n in (128, 256, 512)]
    assert ratios[-1] == pytest.approx(1.39, rel=0.08)
    assert all(r > 1.0 for r in ratios)
    r0 = pm.energy_ratio(512, 0.0)
    assert 1.0 < r0 < ratios[-1]


def test_buffer_efficiency_curve_shape():
    caps = [64 << 10, 512 << 10, 4 << 20, 16 << 20]
    eff0 = [pm.buffer_efficiency(c, 0.0) for c in caps]
    eff5 = [pm.buffer_efficiency(c, 0.005) for c in caps]
    assert all(a <= b + 1e-9 for a, b in zip(eff0, eff0[1:]))
    assert eff5[1] > 0.99
    assert eff0[1] < 0.6
    assert eff0[-1] > 0.97


# ---------------------------------------------------------------------------
# The health report against JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_health_report_equals_jax(seed):
    rng = np.random.RandomState(seed)
    bound = 2.0
    offs = (rng.randn(2, 9, 11, 18) * (0.5 + seed)).astype(np.float32)
    offs[0, :3] = np.clip(offs[0, :3] * 4, -bound, bound)  # on the clamp
    offs[1, 0, 0, :4] = bound - 5e-7                       # within atol
    want = JPM.bound_saturation(offs, bound)
    assert 0 < want < 1
    for t in (torch.from_numpy(offs), torch.from_numpy(offs).double(),
              torch.from_numpy(offs).permute(3, 2, 1, 0)):
        got = pm.bound_saturation(t, bound)
        assert isinstance(got, float) and got == want
    assert pm.bound_saturation(offs, bound) == want   # array-likes too
    for thr in (0.01, 0.05, 0.5):
        assert pm.runtime_health_report(torch.from_numpy(offs), bound,
                                        threshold=thr) \
            == JPM.runtime_health_report(offs, bound, threshold=thr)
    assert pm.bound_saturation(torch.zeros(0), bound) == 0.0
    with pytest.raises(ValueError, match="positive offset_bound"):
        pm.bound_saturation(torch.from_numpy(offs), None)


# ---------------------------------------------------------------------------
# The traffic reports of the port's kernels
# ---------------------------------------------------------------------------

GEOM = dict(kernel_size=3, stride=1, dilation=1)


@pytest.mark.parametrize("bpe", [4, 2])
def test_dataflow_report_bytes_are_the_works(bpe):
    rep = pm.dataflow_traffic_report(h=64, w=64, c=128, m=128, batch=4,
                                     tile_h=8, offset_bound=2.0,
                                     bytes_per_elem=bpe)
    dims = (4, 64, 64, 128, 128)
    fwd = h100.forward_work(*dims, **GEOM, itemsize=bpe)["bytes"]
    band = h100.banded_work(*dims, **GEOM, offset_bound=2.0, tile_h=8,
                            itemsize=bpe)["bytes"]
    bwd = h100.backward_work(*dims, **GEOM, itemsize=bpe)["bytes"]
    q = h100.int8_work(*dims, **GEOM)["bytes"]
    chain = h100.int8_work(*dims, **GEOM, chain=True, emit="int8")["bytes"]
    assert rep["zero_copy_total_bytes"] == fwd
    assert rep["materialized_band_total_bytes"] == band
    assert rep["zero_copy_bwd_bytes"] == rep["materialized_band_bwd_bytes"] \
        == bwd
    assert rep["zero_copy_train_bytes"] == fwd + bwd
    assert rep["materialized_band_train_bytes"] == band + bwd
    assert rep["zero_copy_total_bytes_q"] == q
    assert rep["chain_per_layer_bytes"] == 2 * q
    assert rep["chain_bytes"] == 2 * chain
    assert rep["total_bytes_q_fused_offsets"] == chain
    # The structural claims of JAX's tests.
    assert rep["zero_copy_bytes"] < rep["materialized_band_bytes"]
    assert rep["ratio"] > 1 and rep["train_ratio"] > 1
    assert rep["zero_copy_total_bytes"] < rep["materialized_band_total_bytes"]
    assert rep["chain_bytes"] < rep["chain_per_layer_bytes"]
    assert rep["total_bytes_q_fused_offsets"] < rep["zero_copy_total_bytes_q"]
    assert rep["q_ratio"] == bpe
    if bpe == 4:
        assert rep["zero_copy_total_bytes_q"] < rep["zero_copy_total_bytes"]
    assert rep["tiles"] == tiling.choose_kernel_tiles(
        *dims, **GEOM, offset_bound=2.0, itemsize=bpe)
    assert rep["tiles_banded"].tile_h == 8


def test_dataflow_report_keys_are_jax_s_but_megacore():
    """Every key of the JAX report is kept except the Megacore split,
    which the card does not have."""
    jrep = JPM.dataflow_traffic_report(h=64, w=64, c=128, m=128, batch=4,
                                       tile_h=8, offset_bound=2.0)
    rep = pm.dataflow_traffic_report(h=64, w=64, c=128, m=128, batch=4,
                                     tile_h=8, offset_bound=2.0)
    megacore = {"cores", "zero_copy_bwd_bytes_per_core",
                "zero_copy_bwd_bytes_mc_total", "bwd_per_core_ratio"}
    assert set(jrep) - set(rep) == megacore
    assert set(rep) - set(jrep) == {"tiles_banded"}
    # The int8 input term is the fp32 one at a quarter, as in JAX.
    assert rep["q_ratio"] == jrep["q_ratio"] == 4.0
    # A non-square layer's chain is its square analogue's.
    ns = pm.dataflow_traffic_report(h=32, w=32, c=64, m=96, batch=2)
    sq = pm.dataflow_traffic_report(h=32, w=32, c=64, m=64, batch=2)
    assert ns["chain_bytes"] == sq["chain_bytes"]


def test_parallel_training_report_charges_the_gradient_sum():
    rep = pm.parallel_training_report(h=64, w=64, c=128, m=128, batch=8,
                                      devices=4)
    dims = (64, 64, 128, 128)
    one = h100.training_work(8, *dims, **GEOM)["bytes"]
    per = h100.training_work(2, *dims, **GEOM)["bytes"]
    dw = 9 * 128 * 128 * 4
    assert rep["train_bytes_single"] == one
    assert rep["train_bytes_per_device"] == per
    assert rep["dw_psum_bytes"] == dw
    assert rep["bwd_bytes_seq"] == h100.backward_work(8, *dims,
                                                      **GEOM)["bytes"]
    assert rep["dw_stationary_bytes"] == rep["bwd_bytes_seq"] - dw
    assert rep["modeled_step_sec_sharded"] == pytest.approx(
        per / h100.PEAK_HBM_BYTES_PER_S + 2 * dw / h100.NVLINK_BYTES_PER_S)
    # The sum over NVLink keeps the speedup below the device count.
    assert 1 < rep["device_speedup"] < 4
    jrep = JPM.parallel_training_report(h=64, w=64, c=128, m=128, batch=8,
                                        devices=4)
    assert set(jrep) - set(rep) == {
        "cores", "bwd_bytes_per_core", "bwd_bytes_mc_total",
        "bwd_per_core_ratio", "core_speedup_compute_bound",
        "core_speedup_hbm_bound"}
    with pytest.raises(ValueError, match="must divide"):
        pm.parallel_training_report(batch=6, devices=4)


def test_spatial_report_charges_the_halo():
    rep = pm.spatial_sharding_report()
    shape = tiling.LayerShape(h=1024, w=1024, c_in=64, c_out=64,
                              offset_bound=2.0)
    assert rep["halo_rows"] == 4 == tiling.spatial_halo_rows(
        kernel_size=3, offset_bound=2.0)
    for s in (1, 2, 4):
        halo = 0 if s == 1 else 2 * 4 * 1024 * 64 * 4
        assert rep[f"halo_bytes_{s}shard"] == halo \
            == pm.spatial_halo_bytes(shape, shards=s)
        assert rep[f"fwd_hbm_bytes_{s}shard"] == h100.forward_work(
            1, 1024 // s, 1024, 64, 64, **GEOM)["bytes"] + halo
    assert rep["traffic_ratio_1shard"] == rep["modeled_speedup_1shard"] == 1
    assert rep["traffic_ratio_2shard"] >= 1.5
    assert rep["modeled_speedup_2shard"] >= 1.5
    assert rep["modeled_speedup_4shard"] > rep["modeled_speedup_2shard"]
    for s in (2, 4):   # the exchange, at NVLink's rate, costs time
        assert rep[f"modeled_speedup_{s}shard"] \
            < rep[f"traffic_ratio_{s}shard"]
    jrep = JPM.spatial_sharding_report()
    assert set(rep) == set(jrep)
    assert rep["halo_bytes_2shard"] == jrep["halo_bytes_2shard"]
