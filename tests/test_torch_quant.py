"""Port parity: ``repro_torch.quant`` (qtypes, calibration, the fake-quant
references) against ``repro.quant``.

Inputs are made with numpy from a seed and fed to both packages.
Tolerances: the int8 grid exactly (same fp32 division, ties to even);
scale tables rtol 1e-5 (the two fp32 forwards differ at ~1e-6); the
fake-quant references <= 1 LSB of the output grid (their samples come
from two fp32 gathers, so a patch exactly at a rounding tie may go
either way).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import resnet_dcn as JR
from repro.quant import calibrate as JC
from repro.quant import qat as JQAT
from repro.quant import qtypes as JQ
from repro_torch.convert import params_from_jax
from repro_torch.models import resnet_dcn as TR
from repro_torch.quant import calibrate as TC
from repro_torch.quant import qat as TQAT
from repro_torch.quant import qtypes as TQ

torch.set_num_threads(2)

SMALL = dict(stage_sizes=(1, 1, 1, 1), widths=(16, 32, 64, 128),
             stem_width=8, num_dcn=2, num_classes=4, img_size=32,
             offset_bound=2.0)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


# -- qtypes --------------------------------------------------------------------

@pytest.mark.parametrize("axis", [None, -1, 0])
def test_compute_scale_matches_jax(axis):
    x = np.random.RandomState(0).randn(3, 5, 7).astype(np.float32) * 3
    x[0, 0, 0] = 0.0
    want = np.asarray(JQ.compute_scale(jnp.asarray(x), axis=axis))
    got = TQ.compute_scale(_t(x), axis=axis).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    z = np.zeros((4,), np.float32)            # all-zero: the EPS floor
    np.testing.assert_array_equal(TQ.compute_scale(_t(z)).numpy(),
                                  np.asarray(JQ.compute_scale(jnp.asarray(z))))


def test_quantize_values_rounds_ties_to_even_as_jax():
    x = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, 127.4, 127.6,
                  -127.6, 300.0, -300.0, 0.49999997, 3.5, -3.5],
                 np.float32)
    want = np.asarray(JQ.quantize_values(jnp.asarray(x), jnp.float32(1.0)))
    got = TQ.quantize_values(_t(x), torch.tensor(1.0)).numpy()
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got[:6], [0, 2, 2, 0, -2, -2])        # not floor(x + 0.5)
    np.testing.assert_array_equal(got[6:12], [126, 127, 127, -127, 127,
                                              -127])


@pytest.mark.parametrize("axis", [None, -1])
def test_quantize_roundtrip_matches_jax(axis):
    x = np.random.RandomState(1).randn(4, 6, 6, 16).astype(np.float32)
    jq = JQ.quantize(jnp.asarray(x), axis=axis)
    tq = TQ.quantize(_t(x), axis=axis)
    assert tq.values.dtype == torch.int8 and tq.shape == (4, 6, 6, 16)
    np.testing.assert_array_equal(tq.values.numpy(), np.asarray(jq.values))
    np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq.scale))
    deq = tq.dequantize()
    np.testing.assert_array_equal(deq.numpy(), np.asarray(jq.dequantize()))
    # round-to-nearest onto the grid: error <= scale / 2 everywhere
    assert float(((deq - _t(x)).abs() / tq.scale).max()) <= 0.5 + 1e-6


def test_quantize_with_calibrated_per_channel_scale():
    x = np.random.RandomState(2).randn(5, 8).astype(np.float32)
    s = np.linspace(0.01, 0.03, 8).astype(np.float32)
    jq = JQ.quantize(jnp.asarray(x), axis=-1, scale=jnp.asarray(s))
    tq = TQ.quantize(_t(x), axis=-1, scale=s)
    assert tuple(tq.scale.shape) == (1, 8)
    np.testing.assert_array_equal(tq.values.numpy(), np.asarray(jq.values))


def test_fake_quant_forward_matches_jax():
    x = np.random.RandomState(3).randn(64).astype(np.float32) * 5
    for s in (0.1, 0.03):
        want = np.asarray(JQ.fake_quant(jnp.asarray(x), jnp.float32(s)))
        np.testing.assert_array_equal(TQ.fake_quant(_t(x), s).numpy(), want)
    want = np.asarray(JQ.fake_quant_absmax(jnp.asarray(x)))
    np.testing.assert_array_equal(TQ.fake_quant_absmax(_t(x)).numpy(), want)


# -- observers and calibration -------------------------------------------------

def test_observers_match_jax():
    rng = np.random.RandomState(4)
    xs = [(rng.randn(40_000) * 3).astype(np.float32) for _ in range(3)]
    pairs = [(JC.AbsMaxObserver(), TC.AbsMaxObserver()),
             (JC.PercentileObserver(99.0), TC.PercentileObserver(99.0))]
    for x in xs:
        for jo, to in pairs:
            jo.update(jnp.asarray(x))
            to.update(_t(x))
    for jo, to in pairs:
        assert to.updates == jo.updates == 3
        assert to.scale() == pytest.approx(jo.scale(), rel=1e-6)
    assert 0 < pairs[1][1].scale() < pairs[0][1].scale()
    assert TC.PercentileObserver().scale() == JC.PercentileObserver().scale()
    with pytest.raises(ValueError, match="unknown observer"):
        TC.make_observer("minmax")


def _np_tree(tree):
    return {k: _np_tree(v) if isinstance(v, dict) else v.numpy()
            for k, v in tree.items()}


def _jax_tapped_forward(cfg):
    """A ``forward`` for ``repro.quant.calibrate_resnet_dcn`` that runs
    the JAX model under one ``jax.jit`` and then feeds the tapped
    activations to the observers (eager JAX is slow here)."""
    def activations(params, images):
        acts = {}
        JR.forward(params, cfg, images,
                   tap=lambda name, v: acts.__setitem__(name, v))
        return acts
    jitted = jax.jit(activations)

    def forward(params, cfg_, images, *, tap):
        for name, v in sorted(jitted(params, images).items()):
            tap(name, v)
    return forward


@pytest.fixture(scope="module")
def calibrated():
    # The JAX sweep runs its XLA reference path (the Pallas kernel agrees
    # with it to ~1e-6); the port's runs its kernel path's plain version.
    tcfg = TR.ResNetDCNConfig(**SMALL, use_kernel=True)
    np_params = _np_tree(TR.init_params(tcfg, seed=0, device="cpu"))
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    jcfg = JR.ResNetDCNConfig(**SMALL)
    rng = np.random.RandomState(5)
    batches = [rng.randn(2, 32, 32, 3).astype(np.float32) for _ in range(2)]
    forward = _jax_tapped_forward(jcfg)
    tables = {}
    for obs in ("absmax", "percentile"):
        jt = JC.calibrate_resnet_dcn(jparams, jcfg, batches, observer=obs,
                                     percentile=99.0, forward=forward)
        tt = TC.calibrate_resnet_dcn(
            params_from_jax(np_params, device="cpu"), tcfg, batches,
            observer=obs, percentile=99.0, device="cpu")
        tables[obs] = (jt, tt)
    return tables


@pytest.mark.parametrize("observer", ["absmax", "percentile"])
def test_calibrate_resnet_dcn_matches_jax(calibrated, observer):
    jt, tt = calibrated[observer]
    assert set(tt) == set(jt) == {"s2b0", "s3b0", "_meta"}
    assert tt["_meta"] == jt["_meta"]
    for name in ("s2b0", "s3b0"):
        assert set(tt[name]) == set(jt[name]) == {
            "x_scale", "w_scale", "w_offset_scale", "y_scale"}
        for key in ("x_scale", "y_scale", "w_scale", "w_offset_scale"):
            np.testing.assert_allclose(tt[name][key], jt[name][key],
                                       rtol=1e-5)


def test_scale_tables_load_in_both_packages(calibrated, tmp_path):
    jt, tt = calibrated["absmax"]
    TC.save_scale_table(tt, str(tmp_path / "torch.json"))
    JC.save_scale_table(jt, str(tmp_path / "jax.json"))
    assert JC.load_scale_table(str(tmp_path / "torch.json")) == \
        json.loads(json.dumps(tt))
    assert TC.load_scale_table(str(tmp_path / "jax.json")) == \
        JC.load_scale_table(str(tmp_path / "jax.json"))


def test_calibrate_without_dcls_raises():
    cfg = TR.ResNetDCNConfig(**dict(SMALL, num_dcn=0))
    params = TR.init_params(cfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="no DCL activations"):
        TC.calibrate_resnet_dcn(params, cfg,
                                [np.zeros((1, 32, 32, 3), np.float32)],
                                device="cpu")


# -- fake-quant references -----------------------------------------------------

def _dcl_arrays(seed, n=2, h=10, w=9, c=8, m=8, k=3, s=1, d=1, b=2.0):
    rng = np.random.RandomState(seed)
    pad = d * (k // 2)
    ho = (h + 2 * pad - d * (k - 1) - 1) // s + 1
    wo = (w + 2 * pad - d * (k - 1) - 1) // s + 1
    return dict(
        x=rng.randn(n, h, w, c).astype(np.float32),
        off=(rng.randn(n, ho, wo, 2 * k * k) * 1.5).astype(np.float32),
        w=(rng.randn(k * k, c, m) * 0.2).astype(np.float32),
        w_off=(rng.randn(k * k, c, 2 * k * k) * 0.1).astype(np.float32),
        b_off=(rng.randn(2 * k * k) * 0.5).astype(np.float32),
        b=(rng.randn(m) * 0.1).astype(np.float32))


@pytest.mark.parametrize("s,d", [(1, 1), (2, 1), (1, 2)])
def test_fake_quant_dcl_reference_matches_jax(s, d):
    a = _dcl_arrays(10 + s + d, s=s, d=d)
    kw = dict(kernel_size=3, stride=s, dilation=d, offset_bound=2.0)
    want = np.asarray(JQAT.fake_quant_dcl_reference(
        jnp.asarray(a["x"]), jnp.asarray(a["off"]), jnp.asarray(a["w"]),
        **kw))
    got = TQAT.fake_quant_dcl_reference(_t(a["x"]), _t(a["off"]),
                                        _t(a["w"]), **kw).numpy()
    lsb = (np.asarray(JQ.compute_scale(jnp.asarray(a["x"])))
           * np.asarray(JQ.compute_scale(jnp.asarray(a["w"]), axis=-1))
           .reshape(-1))
    assert got.shape == want.shape
    assert float((np.abs(got - want) / lsb).max()) <= 1.0


@pytest.mark.parametrize("y_scale", [None, 0.05])
def test_fake_quant_dcl_chain_reference_matches_jax(y_scale):
    a = _dcl_arrays(20)
    sx = float(np.abs(a["x"]).max() / 127)
    kw = dict(kernel_size=3, offset_bound=2.0, x_scale=sx, y_scale=y_scale)
    jy, joff = JQAT.fake_quant_dcl_chain_reference(
        *(jnp.asarray(a[k]) for k in ("x", "w", "w_off", "b_off", "b")),
        **kw)
    ty, toff = TQAT.fake_quant_dcl_chain_reference(
        *(_t(a[k]) for k in ("x", "w", "w_off", "b_off", "b")), **kw)
    np.testing.assert_allclose(toff.numpy(), np.asarray(joff),
                               rtol=1e-5, atol=1e-5)
    sw = np.abs(a["w"]).max(axis=(0, 1)) / 127
    lsb = y_scale if y_scale is not None else sx * sw
    assert float((np.abs(ty.numpy() - np.asarray(jy)) / lsb).max()) <= 1.0
    with pytest.raises(ValueError, match="x_scale"):
        TQAT.fake_quant_dcl_chain_reference(
            *(_t(a[k]) for k in ("x", "w", "w_off", "b_off")),
            offset_bound=2.0)


def test_model_config_quant_field_is_the_jax_one():
    fields = {f.name for f in dataclasses.fields(TR.ResNetDCNConfig)}
    assert "quant" in fields
    assert TR.ResNetDCNConfig().quant == JR.ResNetDCNConfig().quant == "none"
