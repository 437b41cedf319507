"""Port parity: the gradients of the bounded DCL and of the training
objective of ``repro_torch`` against the JAX package.

* the plain version of the fused backward (``deform_conv_bwd``) against
  the JAX backward kernel (Pallas, interpret mode) at the same tiles;
* ``torch.autograd`` through ``ops.deform_conv`` (the autograd function
  over the kernels' plain versions) against ``jax.grad`` through the JAX
  kernel path, and against autograd through the plain forward;
* Eq. 5 (``rf_regularizer``), ``detection_loss`` and ``train_loss`` on
  the small ResNet-DCN, values and gradients, against
  ``jax.value_and_grad`` (both on their kernel paths);
* ``dcl_apply(quant="qat")`` against the JAX QAT layer.

Tolerance rtol = atol = 1e-4 for gradients (as
``tests/test_deform_conv_grad.py``): the same arithmetic, summed in
another order.  The CUDA kernel is held against the plain version by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rf_regularizer as JRF
from repro.core.tiling import out_hw
from repro.kernels import ops as JO
from repro.kernels import plan as JP
from repro.kernels.deform_conv_bwd import deform_conv_bwd_zerocopy as JBWD
from repro.models import layers as JL
from repro.models import resnet_dcn as JR
from repro_torch.convert import params_from_jax
from repro_torch.core import rf_regularizer as TRF
from repro_torch.core.deform_conv import conv2d
from repro_torch.kernels import ops as TO
from repro_torch.kernels import plan as TP
from repro_torch.kernels import ref as TR
from repro_torch.kernels.deform_conv_bwd import (
    deform_conv_bwd_zerocopy, deform_conv_bwd_zerocopy_plain)
from repro_torch.models import layers as TL
from repro_torch.models import resnet_dcn as TRN

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)

# (k, s, d, B, H, W, C, M, th, tw, tc): the edge geometries of
# tests/test_torch_kernels.py — ragged Ho/Wo, stride 2, dilation 2,
# tile_c < C; offsets drawn at 2x B so the clamp bites.
CASES = {
    "s1": (3, 1, 1, 2.0, 8, 8, 8, 8, 4, 4, 8),
    "s1_ragged_csteps": (3, 1, 1, 2.0, 9, 11, 8, 6, 4, 4, 4),
    "s2_ragged": (3, 2, 1, 2.0, 12, 9, 8, 8, 4, 2, 8),
    "dilation2": (3, 1, 2, 1.5, 10, 10, 8, 8, 3, 5, 4),
    "k5_s2": (5, 2, 1, 1.0, 11, 11, 4, 4, 2, 3, 2),
}

SMALL = dict(stage_sizes=(1, 1, 1, 1), widths=(16, 32, 64, 128),
             stem_width=8, num_dcn=2, num_classes=4, img_size=32,
             offset_bound=2.0)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a, copy=True)).requires_grad_(grad)


def _inputs(k, h, w, c, m, s, d, b, seed):
    rng = np.random.RandomState(seed)
    ho, wo = out_hw(h, w, kernel_size=k, stride=s, dilation=d)
    x = rng.randn(2, h, w, c).astype(np.float32)
    off = (rng.randn(2, ho, wo, 2 * k * k) * 2 * b).astype(np.float32)
    wd = (rng.randn(k * k, c, m) * 0.2).astype(np.float32)
    g = rng.randn(2, ho, wo, m).astype(np.float32)
    return x, off, wd, g


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_backward_matches_pallas(case):
    k, s, d, b, h, w, c, m, th, tw, tc = CASES[case]
    x, off, wd, g = _inputs(k, h, w, c, m, s, d, b, seed=len(case))
    ho, wo = off.shape[1], off.shape[2]
    jspec = JP.DCSpec(k, s, d, b, th, tw, tc, m, "zero_copy", True)
    jxp, joff, jwt, jg = JP.zerocopy_inputs(
        jspec, jnp.asarray(x), jnp.asarray(off), jnp.asarray(wd), th, tw,
        tc, extra=jnp.asarray(g))
    kw = dict(kernel_size=k, stride=s, dilation=d, offset_bound=b,
              tile_h=th, tile_w=tw, tile_c=tc)
    jdx, jdoff, jdw = (np.asarray(a) for a in JBWD(
        jxp, joff, jg, jwt, interpret=True, **kw))

    tspec = TP.DCSpec(k, s, d, b, th, tw, tc, m)
    txp, toff, twt = TP.zerocopy_inputs(tspec, _t(x), _t(off), _t(wd),
                                        th, tw, tc)
    before = deform_conv_bwd_zerocopy.launches
    dx, doff, dw = deform_conv_bwd_zerocopy(txp, toff, _t(g), twt, **kw)
    assert deform_conv_bwd_zerocopy.launches == before   # no kernel on CPU
    assert dx.shape == txp.shape and dw.shape == twt.shape
    np.testing.assert_allclose(dx.numpy(), jdx, err_msg="dx", **TOL)
    np.testing.assert_allclose(doff.numpy(), jdoff[:, :ho, :wo],
                               err_msg="d_off", **TOL)
    np.testing.assert_allclose(dw.numpy(), jdw, err_msg="dw", **TOL)
    # The clamp's VJP zeroes the offsets beyond B, and only those.
    outside = np.abs(off) > b
    assert outside.any() and not doff.numpy()[outside].any()


def test_plain_backward_ignores_the_ragged_cotangent():
    """Pixels outside Ho x Wo add nothing: the cotangent is not padded,
    and the result does not depend on what the tiles would have held."""
    k, s, d, b, h, w, c, m, th, tw, tc = CASES["s1_ragged_csteps"]
    x, off, wd, g = _inputs(k, h, w, c, m, s, d, b, seed=3)
    spec = TP.DCSpec(k, s, d, b, th, tw, tc, m)
    xp, op, wt = TP.zerocopy_inputs(spec, _t(x), _t(off), _t(wd), th, tw, tc)
    kw = dict(kernel_size=k, stride=s, dilation=d, offset_bound=b,
              tile_h=th, tile_w=tw, tile_c=tc)
    got = deform_conv_bwd_zerocopy_plain(xp, op, _t(g), wt, **kw)
    whole = deform_conv_bwd_zerocopy_plain(xp, op, _t(g), wt,
                                           **dict(kw, tile_h=9, tile_w=11))
    for a, name in zip(range(2), ("dx", "d_off")):
        np.testing.assert_allclose(got[a].numpy(), whole[a].numpy(),
                                   err_msg=name, **TOL)
    np.testing.assert_allclose(
        TP.untile_weights(got[2], k).numpy(),
        TP.untile_weights(whole[2], k).numpy(), **TOL)
    with pytest.raises(ValueError, match="cotangent"):
        deform_conv_bwd_zerocopy_plain(xp, op, _t(g[:, :-1]), wt, **kw)


def test_untile_weights_inverts_tile_weights():
    w = torch.arange(9 * 12 * 5, dtype=torch.float32).reshape(9, 12, 5)
    for tc in (1, 3, 4, 12):
        assert torch.equal(TP.untile_weights(TP.tile_weights(w, tc), 3), w)


def _sin_grads(fn, *args):
    y = fn(*args)
    return torch.autograd.grad(torch.sin(y).sum(), args)


@pytest.mark.parametrize("case", sorted(CASES))
def test_ops_gradients_match_jax_and_plain_forward(case):
    k, s, d, b, h, w, c, m, th, tw, tc = CASES[case]
    x, off, wd, _ = _inputs(k, h, w, c, m, s, d, b, seed=10 + len(case))
    kw = dict(kernel_size=k, stride=s, dilation=d, offset_bound=b)

    def jloss(a, o, ww):
        return jnp.sum(jnp.sin(JO.deform_conv(a, o, ww, tile_h=th,
                                              tile_w=tw, **kw)))
    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(off), jnp.asarray(wd))

    args = (_t(x, True), _t(off, True), _t(wd, True))
    got = _sin_grads(lambda a, o, ww: TO.deform_conv(
        a, o, ww, tile_h=th, tile_w=tw, tile_c=tc, device="cpu", **kw),
        *args)
    plain = _sin_grads(lambda a, o, ww: TR.deform_conv_fused_ref(
        a, o, ww, **kw), *args)
    for name, g_, j, p in zip(("d_input", "d_offsets", "d_weights"), got,
                              want, plain):
        np.testing.assert_allclose(g_.numpy(), np.asarray(j),
                                   err_msg=f"{name} vs jax", **TOL)
        np.testing.assert_allclose(g_.numpy(), p.numpy(),
                                   err_msg=f"{name} vs plain forward", **TOL)


def test_ops_gradient_flows_to_the_inputs_that_need_it():
    x, off, wd, _ = _inputs(3, 6, 6, 4, 4, 1, 1, 2.0, seed=1)
    xt, ot, wt = _t(x, True), _t(off), _t(wd)
    y = TO.deform_conv(xt, ot, wt, offset_bound=2.0, device="cpu")
    y.sum().backward()
    assert xt.grad is not None and xt.grad.abs().sum() > 0
    assert ot.grad is None and wt.grad is None
    # The backward is a kernel, differentiable once: its outputs carry no
    # graph of their own.
    dx, = torch.autograd.grad(
        TO.deform_conv(xt, ot, wt, offset_bound=2.0, device="cpu").sum(),
        xt, create_graph=True)
    assert not dx.requires_grad


def test_conv2d_same_stride2_backward_matches_jax():
    """XLA's asymmetric SAME padding (0, 1) of a 3x3 stride-2 conv on an
    even extent carries through the backward."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 8, 8, 3).astype(np.float32)
    w = rng.randn(3, 3, 3, 5).astype(np.float32)
    from repro.core.deform_conv import conv2d as jconv
    want = jax.grad(lambda a, b_: jnp.sum(jnp.sin(jconv(a, b_, stride=2))),
                    argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    got = _sin_grads(lambda a, b_: conv2d(a, b_, stride=2), _t(x, True),
                     _t(w, True))
    for g_, j in zip(got, want):
        np.testing.assert_allclose(g_.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-5)


def test_max_pool_gradient_over_relu_zeros_matches_jax():
    """XLA's select_and_scatter and ``max_pool2d`` break ties between equal
    window maxima differently; after a ReLU the ties are zeros, whose
    gradient the ReLU then zeroes in both, so the input gradient agrees."""
    rng = np.random.RandomState(1)
    x = rng.randn(2, 9, 9, 4).astype(np.float32)
    x[x < 0.5] = -1.0                   # most windows: all zeros after ReLU
    c = rng.randn(2, 5, 5, 4).astype(np.float32)

    def jloss(a):
        h = jax.nn.relu(a)
        p = jax.lax.reduce_window(h, -jnp.inf, jax.lax.max, (1, 3, 3, 1),
                                  (1, 2, 2, 1),
                                  [(0, 0), (1, 1), (1, 1), (0, 0)])
        return jnp.sum(p * c)
    want = jax.grad(jloss)(jnp.asarray(x))

    xt = _t(x, True)
    h = torch.relu(xt)
    p = torch.nn.functional.max_pool2d(h.permute(0, 3, 1, 2), 3, 2,
                                       padding=1).permute(0, 2, 3, 1)
    (p * _t(c)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


# -- Eq. 5 ------------------------------------------------------------------

@pytest.mark.parametrize("smoothness", [0.0, 0.5])
def test_regularized_loss_and_offset_max_match_jax(smoothness):
    o = np.array([1.2, 3.5, 3.4, 0.2], np.float32)
    task = np.float32(2.5)

    def jfn(t, om):
        return JRF.regularized_loss(t, list(om), 0.3, smoothness=smoothness)
    jv, jg = jax.value_and_grad(jfn, argnums=(0, 1))(jnp.asarray(task),
                                                     jnp.asarray(o))
    tt, ot = _t(task, True), _t(o, True)
    tv = TRF.regularized_loss(tt, list(ot.unbind()), 0.3,
                              smoothness=smoothness)
    tv.backward()
    np.testing.assert_allclose(float(tv), float(jv), rtol=1e-6)
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(jg[0]), rtol=1e-6)
    np.testing.assert_allclose(ot.grad.numpy(), np.asarray(jg[1]), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(
        float(TRF.network_offset_max(_t(o), smoothness=smoothness)),
        float(JRF.network_offset_max(jnp.asarray(o), smoothness=smoothness)),
        rtol=1e-6)
    # lambda = 0 is the task loss itself; lambda outside [0, 1) raises.
    assert TRF.regularized_loss(tt, [ot[0]], 0.0) is tt
    for lam in (-0.1, 1.0):
        with pytest.raises(ValueError, match="lambda"):
            TRF.regularized_loss(tt, [ot[0]], lam)


def test_offset_stats_match_jax():
    layers = [{"a": 1.0, "b": 2.5}, {"a": 3.0, "b": 0.5}, {}]
    j, t = JRF.OffsetStats(), TRF.OffsetStats()
    for d in layers:
        j.update({k: jnp.float32(v) for k, v in d.items()})
        t.update({k: torch.tensor(v) for k, v in d.items()})
    assert t.per_image_max == j.per_image_max == [2.5, 3.0]
    assert t.network_max() == j.network_max() == 3.0
    assert t.histogram(bins=4) == j.histogram(bins=4)
    other, jother = TRF.OffsetStats(), JRF.OffsetStats()
    other.update({"a": torch.tensor(12.0)})
    jother.update({"a": jnp.float32(12.0)})
    assert t.compression_vs(other) == j.compression_vs(jother) == 3.0


# -- the small model --------------------------------------------------------

def _perturbed_params(cfg, seed=0):
    params = jax.tree_util.tree_map(np.asarray, JR.init_params(
        jax.random.PRNGKey(seed), cfg))
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


def _batch(seed=3):
    from repro.data import DetectionDataConfig, detection_batch
    return detection_batch(DetectionDataConfig(img_size=32, global_batch=2,
                                               num_classes=4, seed=seed), 0)


def _flat_torch(tree):
    from repro_torch.tree import leaves
    return np.concatenate([t.grad.numpy().ravel() for t in leaves(tree)])


@pytest.fixture(scope="module")
def model_grads():
    """One value_and_grad of the Eq. 5 objective (lambda = 0.1, the
    paper's hard max) on both kernel paths."""
    jcfg = JR.ResNetDCNConfig(**SMALL, use_kernel=True)
    tcfg = TRN.ResNetDCNConfig(**SMALL, use_kernel=True)
    params = _perturbed_params(jcfg)
    batch = _batch()
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: JR.train_loss(p, jcfg, {k: jnp.asarray(v) for k, v
                                          in batch.items()}, lam=0.1),
        has_aux=True))(jax.tree_util.tree_map(jnp.asarray, params))
    tp = params_from_jax(params, device="cpu")
    from repro_torch.tree import leaves
    for t in leaves(tp):
        t.requires_grad_(True)
    tl, tm = TRN.train_loss(tp, tcfg, {k: torch.from_numpy(v) for k, v
                                       in batch.items()},
                            lam=0.1, device="cpu")
    tl.backward()
    return jl, jm, jg, tl, tm, tp


def test_train_loss_value_and_grad_match_jax(model_grads):
    from jax.flatten_util import ravel_pytree
    jl, jm, jg, tl, tm, tp = model_grads
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for key in ("bce", "ce", "l1", "o_max"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                   rtol=1e-5, err_msg=key)
    assert float(tm["o_max"]) > SMALL["offset_bound"]   # the clamp bites
    jflat = np.asarray(ravel_pytree(jg)[0])
    tflat = _flat_torch(tp)
    assert np.linalg.norm(tflat - jflat) <= 1e-4 * np.linalg.norm(jflat)
    np.testing.assert_allclose(tflat, jflat, rtol=1e-3, atol=1e-4)


def test_detection_loss_matches_jax():
    rng = np.random.RandomState(4)
    outputs = {"cls": rng.randn(2, 3, 3, 5).astype(np.float32) * 3,
               "box": rng.randn(2, 3, 3, 4).astype(np.float32)}
    targets = {"obj": (rng.rand(2, 3, 3) > 0.6).astype(np.float32),
               "cls": rng.randint(0, 4, (2, 3, 3)).astype(np.int32),
               "box": rng.rand(2, 3, 3, 4).astype(np.float32)}
    (jl, jm), jg = jax.value_and_grad(
        lambda o: JR.detection_loss(o, {k: jnp.asarray(v) for k, v
                                        in targets.items()}),
        has_aux=True)({k: jnp.asarray(v) for k, v in outputs.items()})
    to = {k: _t(v, True) for k, v in outputs.items()}
    tl, tm = TRN.detection_loss(to, {k: torch.from_numpy(v) for k, v
                                     in targets.items()})
    tl.backward()
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    for key in ("bce", "ce", "l1"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                   rtol=1e-6)
    for key in outputs:
        np.testing.assert_allclose(to[key].grad.numpy(), np.asarray(jg[key]),
                                   rtol=1e-5, atol=1e-7)


# -- QAT --------------------------------------------------------------------

@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("scales", [None, "calibrated"])
def test_qat_dcl_matches_jax(use_kernel, scales):
    rng = np.random.RandomState(5)
    c, m = 8, 6
    x = rng.randn(2, 9, 9, c).astype(np.float32)
    params = {"w_offset": (rng.randn(3, 3, c, 18) * 0.3).astype(np.float32),
              "b_offset": (rng.randn(18) * 0.5).astype(np.float32),
              "w_deform": (rng.randn(3, 3, c, m) * 0.3).astype(np.float32),
              "b_deform": rng.randn(m).astype(np.float32)}
    qs = None if scales is None else {
        "x_scale": 0.02, "w_scale": list(np.full(m, 0.004, np.float32))}
    kw = dict(stride=1, offset_bound=2.0, use_kernel=use_kernel)

    def jloss(p, a):
        y, o_max = JL.dcl_apply(p, a, quant="qat", quant_scales=qs, **kw)
        return jnp.sum(jnp.sin(y)) + o_max, y
    (_, jy), jg = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))

    tp = {k: _t(v, True) for k, v in params.items()}
    tx = _t(x, True)
    ty, o_max = TL.dcl_apply(tp, tx, quant="qat", quant_scales=qs,
                             device="cpu", **kw)
    (torch.sin(ty).sum() + o_max).backward()
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg[1]), **TOL)
    for k in params:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jg[0][k]),
                                   err_msg=k, **TOL)


def test_qat_dcl_apply_wrapper_matches_jax():
    rng = np.random.RandomState(6)
    x = rng.randn(1, 7, 7, 4).astype(np.float32)
    params = {"w_offset": np.zeros((3, 3, 4, 18), np.float32),
              "b_offset": (rng.randn(18) * 0.7).astype(np.float32),
              "w_deform": (rng.randn(3, 3, 4, 4) * 0.3).astype(np.float32),
              "b_deform": np.zeros(4, np.float32)}
    from repro.quant.qat import qat_dcl_apply as jq
    from repro_torch.quant.qat import qat_dcl_apply as tq
    jy, _ = jq({k: jnp.asarray(v) for k, v in params.items()},
               jnp.asarray(x), offset_bound=2.0, use_kernel=True)
    ty, _ = tq({k: _t(v) for k, v in params.items()}, _t(x),
               offset_bound=2.0, use_kernel=True, device="cpu")
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-4,
                               atol=1e-4)


def test_small_model_trains_through_qat():
    """The QAT objective differentiates end to end through the backward
    (every DCL parameter gets a gradient)."""
    cfg = TRN.ResNetDCNConfig(**SMALL, use_kernel=True, quant="qat")
    tp = params_from_jax(_perturbed_params(cfg), device="cpu")
    for block in tp.values():
        for t in (block.get("dcl") or {}).values():
            t.requires_grad_(True)
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    loss, _ = TRN.train_loss(tp, cfg, batch, lam=0.1, device="cpu")
    loss.backward()
    for name in ("s2b0", "s3b0"):
        for k, t in tp[name]["dcl"].items():
            assert t.grad is not None and torch.isfinite(t.grad).all(), k
