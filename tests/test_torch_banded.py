"""Port parity: the sampling entry point and the banded dataflow of
``repro_torch`` against the JAX package.

* ``ops.deform_sample`` (zero-copy: kernel 1b; banded: kernel 3;
  unbounded: the plain gather) on the sweep geometries of
  ``tests/test_kernels.py``, and the plain versions of kernels 1b and 3
  against the Pallas kernels on the same padded input or bands;
* ``plan.pad_and_band``, bit for bit;
* ``ops.deform_conv(dataflow="banded")`` (kernel 4) and its gradients
  (kernel 2, as in JAX) against the JAX banded path, and the plain
  version of kernel 4 against the Pallas kernel on the same bands;
* a narrow ResNet-DCN with ``dataflow="banded"``: its forward and one
  Trainer step against the JAX model and Trainer;
* the JAX package's errors: int8 or int8_chain with the banded dataflow,
  an unknown dataflow, channel tiles that do not divide C.

The JAX side runs its Pallas kernels in interpret mode, as its own tests
do.  Tolerances: sampling 1e-6 absolute (the same band-local fp32
arithmetic; the unbounded gather's positions differ in the last bit),
the fused forward 1e-5 (another summation order), gradients 1e-4 (as
``tests/test_deform_conv_grad.py``), the model 1e-4 of max|ref| and the
Trainer step 1e-4 relative.  The CUDA kernels are held against the plain
versions by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.tiling import out_hw
from repro.data import DetectionDataConfig as JDataCfg
from repro.data import detection_batch as j_detection_batch
from repro import optim as JOPT
from repro.kernels import deform_conv_fused as JF
from repro.kernels import deform_sample as JS
from repro.kernels import ops as JO
from repro.kernels import plan as JP
from repro.models import layers as JL
from repro.models import resnet_dcn as JR
from repro.train import Trainer as JTrainer
from repro.train import TrainerConfig as JTrainerConfig
from repro_torch import optim as TOPT
from repro_torch import tree as T
from repro_torch.convert import params_from_jax
from repro_torch.data import DetectionDataConfig, detection_batch
from repro_torch.kernels import deform_conv_fused as TF
from repro_torch.kernels import deform_sample as TS
from repro_torch.kernels import ops as TO
from repro_torch.kernels import plan as TP
from repro_torch.models import layers as TL
from repro_torch.models import resnet_dcn as TRN
from repro_torch.train import Trainer, TrainerConfig

torch.set_num_threads(2)

SAMPLE_ATOL = 1e-6
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)

# tests/test_kernels.py CASES: (H, W, C, M, K, stride, dil, bound, tile_h,
# tile_c); stride 2, dilation 2 at K = 5, ragged H against tile_h,
# tile_c < C.
CASES = [
    (16, 20, 8, 16, 3, 1, 1, 2.0, 4, None),
    (16, 20, 8, 16, 3, 1, 1, 2.0, 4, 4),
    (16, 20, 8, 8, 3, 2, 1, 1.5, 4, None),
    (16, 20, 8, 8, 5, 1, 2, 2.0, 5, None),
    (15, 17, 4, 8, 3, 1, 1, 3.0, 4, 2),
    (8, 8, 16, 32, 3, 1, 1, 0.5, 8, 8),
]
# The zero-copy kernels' sampling positions are local to their output
# tile, so both sides are given the same tile_w: then every tap has the
# same fp32 position on both.
TILE_W = 4

SMALL = dict(stage_sizes=(1, 1, 1, 1), widths=(16, 32, 64, 128),
             stem_width=8, num_dcn=2, num_classes=4, img_size=32,
             offset_bound=2.0)
DATA = dict(img_size=32, global_batch=2, num_classes=4, seed=3)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a, copy=True)).requires_grad_(grad)


def _case_arrays(case, seed):
    h, w, c, m, k, s, d, bound, th, tc = case
    rng = np.random.RandomState(seed)
    ho, wo = out_hw(h, w, kernel_size=k, stride=s, dilation=d)
    x = rng.randn(2, h, w, c).astype(np.float32)
    off = (rng.randn(2, ho, wo, 2 * k * k) * 3.0).astype(np.float32)
    wd = (rng.randn(k * k, c, m) * 0.2).astype(np.float32)
    return x, off, wd


def _ids(case):
    h, w, c, m, k, s, d, bound, th, tc = case
    return f"{h}x{w}x{c}->{m}_k{k}s{s}d{d}_B{bound}_th{th}_tc{tc}"


# -- ops.deform_sample ---------------------------------------------------------

@pytest.mark.parametrize("dataflow", ["zero_copy", "banded", "unbounded"])
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_deform_sample_matches_jax(case, dataflow):
    h, w, c, m, k, s, d, bound, th, tc = case
    x, off, _ = _case_arrays(case, seed=int(sum(case[:8])) % 97)
    kw = dict(kernel_size=k, stride=s, dilation=d, tile_h=th, tile_c=tc,
              offset_bound=None if dataflow == "unbounded" else bound)
    if dataflow != "unbounded":
        kw["dataflow"] = dataflow
    if dataflow == "zero_copy":
        kw["tile_w"] = TILE_W
    want = np.asarray(JO.deform_sample(jnp.asarray(x), jnp.asarray(off),
                                       **kw))
    before = (TS.deform_sample_zerocopy.launches,
              TS.deform_sample_banded.launches)
    got = TO.deform_sample(_t(x), _t(off), device="cpu", **kw).numpy()
    assert (TS.deform_sample_zerocopy.launches,
            TS.deform_sample_banded.launches) == before   # no kernel on CPU
    assert got.shape == want.shape == off.shape[:3] + (k * k, c)
    np.testing.assert_allclose(got, want, rtol=0, atol=SAMPLE_ATOL)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_plain_sample_kernels_match_pallas(case):
    """Kernels 1b and 3, plain versions, against the Pallas kernels on the
    same padded input and the same bands: the same fp32 operations (XLA
    may fuse them, so not bit for bit)."""
    h, w, c, m, k, s, d, bound, th, tc = case
    x, off, _ = _case_arrays(case, seed=5)
    ho, wo = off.shape[1], off.shape[2]
    geom = dict(kernel_size=k, stride=s, dilation=d, offset_bound=bound)
    th_z, tw_z = min(th, ho), min(TILE_W, wo)
    jspec = JP.DCSpec(k, s, d, bound, th_z, tw_z, tc, c, "zero_copy", True)
    jxp, joff, _ = JP.zerocopy_inputs(
        jspec, jnp.asarray(x), jnp.asarray(off),
        jnp.zeros((k * k, c, 1), jnp.float32), th_z, tw_z, tc or c)
    zc = np.asarray(JS.deform_sample_zerocopy(
        jxp, joff, tile_h=th_z, tile_w=tw_z, tile_c=tc, interpret=True,
        **geom))[:, :ho, :wo]
    txp = TP.pad_zerocopy(_t(x), tile_h=th_z, tile_w=tw_z, ho=ho, wo=wo,
                          **geom)
    got = TS.deform_sample_zerocopy(txp, _t(off), tile_h=th_z, tile_w=tw_z,
                                    tile_c=tc, **geom).numpy()
    np.testing.assert_allclose(got, zc, rtol=0, atol=SAMPLE_ATOL)

    pad_h = (-ho) % th
    joff_b = jnp.pad(jnp.asarray(off), ((0, 0), (0, pad_h), (0, 0), (0, 0)))
    jbands, _ = JP.pad_and_band(jnp.asarray(x), tile_h=th, ho=ho + pad_h,
                                **geom)
    banded = np.asarray(JS.deform_sample_banded(
        jbands, joff_b, tile_h=th, tile_c=tc, interpret=True, **geom))
    got = TS.deform_sample_banded(_t(jbands), _t(joff_b), tile_h=th,
                                  tile_w=3, tile_c=tc, **geom).numpy()
    np.testing.assert_allclose(got, banded, rtol=0, atol=SAMPLE_ATOL)


def test_fused_equals_sample_then_contraction():
    """The fused banded forward equals the sampled patches contracted with
    the weights (tests/test_kernels.py::test_fused_equals_two_stage)."""
    rng = np.random.RandomState(3)
    x = rng.randn(1, 12, 12, 8).astype(np.float32)
    off = (rng.randn(1, 12, 12, 18) * 2).astype(np.float32)
    wd = (rng.randn(9, 8, 16) * 0.2).astype(np.float32)
    for dataflow in ("zero_copy", "banded"):
        kw = dict(offset_bound=1.5, tile_h=4, dataflow=dataflow,
                  device="cpu")
        fused = TO.deform_conv(_t(x), _t(off), _t(wd), **kw)
        patches = TO.deform_sample(_t(x), _t(off), **kw)
        two = torch.einsum("nhwkc,kcm->nhwm", patches, _t(wd))
        np.testing.assert_allclose(fused.numpy(), two.numpy(), **FWD_TOL)


# -- plan.pad_and_band -----------------------------------------------------------

@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_pad_and_band_is_bit_equal_to_jax(case):
    h, w, c, m, k, s, d, bound, th, tc = case
    x, off, _ = _case_arrays(case, seed=1)
    ho = off.shape[1] + (-off.shape[1]) % th
    kw = dict(kernel_size=k, stride=s, dilation=d, offset_bound=bound,
              tile_h=th, ho=ho)
    jb, jn = JP.pad_and_band(jnp.asarray(x), **kw)
    tb, tn = TP.pad_and_band(_t(x), **kw)
    assert tn == jn and tb.is_contiguous()
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


# -- ops.deform_conv(dataflow="banded") ----------------------------------------

@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_banded_deform_conv_matches_jax(case):
    h, w, c, m, k, s, d, bound, th, tc = case
    x, off, wd = _case_arrays(case, seed=11)
    kw = dict(kernel_size=k, stride=s, dilation=d, offset_bound=bound,
              tile_h=th, tile_c=tc, dataflow="banded")
    want = np.asarray(JO.deform_conv(jnp.asarray(x), jnp.asarray(off),
                                     jnp.asarray(wd), **kw))
    before = TF.deform_conv_fused_banded.launches
    got = TO.deform_conv(_t(x), _t(off), _t(wd), device="cpu", **kw)
    assert TF.deform_conv_fused_banded.launches == before
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **FWD_TOL)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_plain_banded_kernel_matches_pallas(case):
    h, w, c, m, k, s, d, bound, th, tc = case
    x, off, wd = _case_arrays(case, seed=13)
    ho = off.shape[1]
    geom = dict(kernel_size=k, stride=s, dilation=d, offset_bound=bound)
    pad_h = (-ho) % th
    joff = jnp.pad(jnp.asarray(off), ((0, 0), (0, pad_h), (0, 0), (0, 0)))
    jbands, _ = JP.pad_and_band(jnp.asarray(x), tile_h=th, ho=ho + pad_h,
                                **geom)
    jwt = JP.tile_weights(jnp.asarray(wd), tc or c)
    want = np.asarray(JF.deform_conv_fused_banded(
        jbands, joff, jwt, tile_h=th, tile_c=tc, interpret=True, **geom))
    got = TF.deform_conv_fused_banded(
        _t(jbands), _t(joff), TP.tile_weights(_t(wd), tc or c), tile_h=th,
        tile_w=2, tile_c=tc, tile_m=min(m, 8), **geom).numpy()
    assert got.shape == want.shape == (2, ho + pad_h, off.shape[2], m)
    np.testing.assert_allclose(got, want, **FWD_TOL)


def _sin_grads(fn, *args):
    return torch.autograd.grad(torch.sin(fn(*args)).sum(), args)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_banded_gradients_match_jax(case):
    """tests/test_deform_conv_grad.py:59-70 over the banded forward: the
    backward is kernel 2 on both sides."""
    h, w, c, m, k, s, d, bound, th, tc = case
    x, off, wd = _case_arrays(case, seed=17)
    kw = dict(kernel_size=k, stride=s, dilation=d, offset_bound=bound,
              tile_h=th, dataflow="banded")

    def jloss(a, o, ww):
        return jnp.sum(jnp.sin(JO.deform_conv(a, o, ww, **kw)))
    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(off), jnp.asarray(wd))
    got = _sin_grads(lambda a, o, ww: TO.deform_conv(
        a, o, ww, device="cpu", **kw), _t(x, True), _t(off, True),
        _t(wd, True))
    for name, g_, j in zip(("d_input", "d_offsets", "d_weights"), got,
                           want):
        np.testing.assert_allclose(g_.numpy(), np.asarray(j), err_msg=name,
                                   **GRAD_TOL)


# -- the JAX package's errors ----------------------------------------------------

def _both_raise(match, jfn, tfn):
    with pytest.raises(ValueError, match=match):
        jfn()
    with pytest.raises(ValueError, match=match):
        tfn()


def test_int8_with_banded_raises_as_in_jax():
    x, off, wd = _case_arrays(CASES[0], seed=2)
    kw = dict(offset_bound=2.0, precision="int8", dataflow="banded")
    _both_raise("zero-copy dataflow",
                lambda: JO.deform_conv(jnp.asarray(x), jnp.asarray(off),
                                       jnp.asarray(wd), **kw),
                lambda: TO.deform_conv(_t(x), _t(off), _t(wd), device="cpu",
                                       **kw))


def test_int8_chain_with_banded_raises_as_in_jax():
    jp = JL.init_tree(jax.random.PRNGKey(0), JL.dcl_def(8, 8))
    x = np.random.RandomState(0).randn(1, 8, 8, 8).astype(np.float32)
    kw = dict(offset_bound=2.0, use_kernel=True, quant="int8_chain",
              quant_scales={"x_scale": 0.05}, dataflow="banded")
    _both_raise("zero-copy",
                lambda: JL.dcl_apply(jp, jnp.asarray(x), **kw),
                lambda: TL.dcl_apply(params_from_jax(jp, device="cpu"),
                                     _t(x), device="cpu", **kw))


@pytest.mark.parametrize("op", ["deform_conv", "deform_sample"])
def test_unknown_dataflow_raises_as_in_jax(op):
    x, off, wd = _case_arrays(CASES[0], seed=2)
    args = (x, off, wd) if op == "deform_conv" else (x, off)
    kw = dict(offset_bound=2.0, dataflow="strided")
    _both_raise("unknown dataflow",
                lambda: getattr(JO, op)(*map(jnp.asarray, args), **kw),
                lambda: getattr(TO, op)(*map(_t, args), device="cpu", **kw))
    with pytest.raises(ValueError, match="unknown dataflow"):
        TP.bounded_forward(TP.DCSpec(3, 1, 1, 2.0, dataflow="strided"),
                           *map(_t, (x, off, wd)))


@pytest.mark.parametrize("dataflow", ["zero_copy", "banded"])
def test_deform_sample_checks_channel_tiles_as_in_jax(dataflow):
    x, off, _ = _case_arrays(CASES[0], seed=2)          # C = 8
    kw = dict(offset_bound=2.0, tile_c=3, dataflow=dataflow)
    _both_raise("tile_c=3 does not divide C=8",
                lambda: JO.deform_sample(jnp.asarray(x), jnp.asarray(off),
                                         **kw),
                lambda: TO.deform_sample(_t(x), _t(off), device="cpu",
                                         **kw))


def test_dispatch_hook_sees_the_dataflow():
    x, off, wd = _case_arrays(CASES[0], seed=2)
    seen = []
    with TO.dispatch_hook_scope(seen.append):
        for dataflow in ("zero_copy", "banded"):
            TO.deform_conv(_t(x), _t(off), _t(wd), offset_bound=2.0,
                           dataflow=dataflow, device="cpu")
    assert [ctx["dataflow"] for ctx in seen] == ["zero_copy", "banded"]


# -- a narrow ResNet-DCN on the banded dataflow ----------------------------------

def _perturbed(seed=0):
    params = jax.tree_util.tree_map(np.asarray, JR.init_params(
        jax.random.PRNGKey(seed), JR.ResNetDCNConfig(**SMALL)))
    rng = np.random.RandomState(seed)
    for block in params.values():
        if "dcl" in block:
            dcl = block["dcl"]
            c = dcl["w_offset"].shape[2]
            dcl["w_offset"] = (rng.randn(*dcl["w_offset"].shape)
                               / np.sqrt(4.5 * c)).astype(np.float32)
            dcl["b_offset"] = (rng.randn(*dcl["b_offset"].shape)
                               * 0.5).astype(np.float32)
    return params


def test_banded_model_forward_matches_jax():
    jcfg = JR.ResNetDCNConfig(**SMALL, use_kernel=True, dataflow="banded")
    tcfg = TRN.ResNetDCNConfig(**SMALL, use_kernel=True, dataflow="banded")
    params = _perturbed()
    images = np.random.RandomState(1).randn(2, 32, 32, 3) \
        .astype(np.float32)
    ref, ref_omax = JR.forward(jax.tree_util.tree_map(jnp.asarray, params),
                               jcfg, jnp.asarray(images))
    before = TF.deform_conv_fused_banded.launches
    got, got_omax = TRN.forward(params_from_jax(params, device="cpu"), tcfg,
                                torch.from_numpy(images), device="cpu")
    assert TF.deform_conv_fused_banded.launches == before
    for key in ("cls", "box", "features"):
        r = np.asarray(ref[key])
        g = got[key].numpy()
        assert g.shape == r.shape and np.isfinite(g).all()
        assert np.abs(g - r).max() <= 1e-4 * np.abs(r).max(), key
    assert max(float(v) for v in got_omax.values()) > SMALL["offset_bound"]
    assert set(got_omax) == set(ref_omax)


def test_banded_config_reaches_every_dcl(monkeypatch):
    """The rungs' and the launcher's ``dataclasses.replace`` keep the
    dataflow: every DCL of the served fp32_kernel rung takes it."""
    from repro_torch.serve import DCLServeConfig, DCLServingEngine
    seen = []
    real = TO.deform_conv

    def spy(*a, **kw):
        seen.append(kw.get("dataflow"))
        return real(*a, **kw)
    monkeypatch.setattr(TO, "deform_conv", spy)
    cfg = TRN.ResNetDCNConfig(**SMALL, dataflow="banded")
    engine = DCLServingEngine(
        params_from_jax(_perturbed(), device="cpu"), cfg,
        DCLServeConfig(buckets=(32,), slots=2, quant="fp32_kernel"),
        device="cpu")
    assert engine.plans[32] and all(
        tiles[0] == TP.BANDED_TILE_H for tiles in engine.plans[32].values())
    for img in np.random.RandomState(0).randn(2, 32, 32, 3):
        engine.submit(img.astype(np.float32))
    engine.run_until_drained()
    assert [r.outcome for r in engine.completed] == ["ok", "ok"]
    assert seen == ["banded"] * SMALL["num_dcn"]


def test_banded_trainer_step_matches_jax(tmp_path):
    """One SGD step of the Eq. 5 objective with the banded forward (kernel
    4, plain on the CPU) and kernel 2's backward, against the JAX Trainer
    on the same config (no mesh, as tests/test_torch_train.py)."""
    lr = 0.01
    jcfg = JR.ResNetDCNConfig(**SMALL, use_kernel=True, dataflow="banded")
    tcfg = TRN.ResNetDCNConfig(**SMALL, use_kernel=True, dataflow="banded")
    jt = JTrainer(
        loss_fn=lambda p, b: JR.train_loss(p, jcfg, b, lam=0.1),
        params=jax.tree_util.tree_map(jnp.asarray, _perturbed()),
        optimizer=JOPT.sgd(JOPT.constant(lr), momentum=0.9,
                           weight_decay=1e-4),
        mesh=None, param_specs=None,
        batch_fn=lambda s: j_detection_batch(JDataCfg(**DATA), s),
        config=JTrainerConfig(total_steps=1, ckpt_every=100,
                              ckpt_dir=str(tmp_path / "jax"), log_every=1))
    jt.run()
    data = DetectionDataConfig(**DATA)
    tt = Trainer(
        loss_fn=lambda p, b: TRN.train_loss(p, tcfg, b, lam=0.1,
                                            device="cpu"),
        params=params_from_jax(_perturbed(), device="cpu"),
        optimizer=TOPT.sgd(TOPT.constant(lr), momentum=0.9,
                           weight_decay=1e-4),
        batch_fn=lambda s: detection_batch(data, s),
        config=TrainerConfig(total_steps=1, ckpt_every=100,
                             ckpt_dir=str(tmp_path / "torch"), log_every=1),
        device="cpu")
    tt.run()
    jh = [h for h in jt.history if "loss" in h]
    th = [h for h in tt.history if "loss" in h]
    assert len(jh) == len(th) == 1
    np.testing.assert_allclose(th[0]["loss"], jh[0]["loss"], rtol=1e-4)
    np.testing.assert_allclose(th[0]["grad_norm"], jh[0]["grad_norm"],
                               rtol=1e-4)

    def flat(tree):
        return np.concatenate([np.asarray(a, np.float32).ravel() for a in
                               jax.tree_util.tree_leaves(tree)])
    p0 = flat(_perturbed())
    jp = flat(jax.tree_util.tree_map(np.asarray, jt.params))
    tp = np.concatenate([t.detach().numpy().ravel()
                         for t in T.leaves(tt.params)])
    assert np.linalg.norm(tp - jp) <= 1e-4 * np.linalg.norm(jp)
    assert np.linalg.norm((tp - p0) - (jp - p0)) \
        <= 1e-3 * np.linalg.norm(jp - p0)
    assert tt.telemetry["skipped"] == 0


def test_banded_config_field_defaults_to_zero_copy():
    assert TRN.ResNetDCNConfig().dataflow == JR.ResNetDCNConfig().dataflow \
        == "zero_copy"
    assert dataclasses.replace(TRN.ResNetDCNConfig(dataflow="banded"),
                               use_kernel=True).dataflow == "banded"
