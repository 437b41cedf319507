"""Port parity: the fused DCL kernel surface (plain version of the kernel,
plan, ops, dcl_apply) of ``repro_torch`` against the JAX package.

The JAX side runs its Pallas kernel in interpret mode, as its own tests
do.  Tolerance rtol = atol = 1e-5: the same gather, contracted in another
summation order.  The CUDA kernel itself is held against the plain
version by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.tiling import out_hw
from repro.kernels import deform_conv_fused as JF
from repro.kernels import ops as JO
from repro.kernels import plan as JP
from repro.kernels import ref as JR
from repro.models import layers as JL
from repro_torch.kernels import deform_conv_fused as TF
from repro_torch.kernels import ops as TO
from repro_torch.kernels import plan as TP
from repro_torch.kernels import ref as TR
from repro_torch.models import layers as TL

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)

# (k, s, d, B, H, W, C, M, th, tw, tc): stride 1/2, dilation 2, ragged
# Ho/Wo, c_steps > 1, offsets saturating the clamp (drawn at 2x B).
CASES = {
    "s1": (3, 1, 1, 2.0, 8, 8, 8, 8, 4, 4, 8),
    "s1_ragged_csteps": (3, 1, 1, 2.0, 9, 11, 8, 6, 4, 4, 4),
    "s2_ragged": (3, 2, 1, 2.0, 12, 9, 8, 8, 4, 2, 8),
    "dilation2": (3, 1, 2, 1.5, 10, 10, 8, 8, 3, 5, 4),
    "k5_s2": (5, 2, 1, 1.0, 11, 11, 4, 4, 2, 3, 2),
}


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _inputs(k, h, w, c, m, s, d, b, seed):
    rng = np.random.RandomState(seed)
    ho, wo = out_hw(h, w, kernel_size=k, stride=s, dilation=d)
    x = rng.randn(2, h, w, c).astype(np.float32)
    off = (rng.randn(2, ho, wo, 2 * k * k) * 2 * b).astype(np.float32)
    wd = rng.randn(k * k, c, m).astype(np.float32)
    return x, off, wd


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_kernel_matches_pallas_and_ref(case):
    k, s, d, b, h, w, c, m, th, tw, tc = CASES[case]
    x, off, wd = _inputs(k, h, w, c, m, s, d, b, seed=len(case))
    ho, wo = off.shape[1], off.shape[2]
    jspec = JP.DCSpec(k, s, d, b, th, tw, tc, m, "zero_copy", True)
    jxp, joff, jwt = JP.zerocopy_inputs(jspec, jnp.asarray(x),
                                        jnp.asarray(off), jnp.asarray(wd),
                                        th, tw, tc)
    kw = dict(kernel_size=k, stride=s, dilation=d, offset_bound=b,
              tile_h=th, tile_w=tw, tile_c=tc, tile_m=m)
    pallas = np.asarray(JF.deform_conv_fused_zerocopy(
        jxp, joff, jwt, interpret=True, **kw))[:, :ho, :wo]
    ref = np.asarray(JR.deform_conv_fused_ref(
        jnp.asarray(x), jnp.asarray(off), jnp.asarray(wd), kernel_size=k,
        stride=s, dilation=d, offset_bound=b))

    tspec = TP.DCSpec(k, s, d, b, th, tw, tc, m)
    txp, toff, twt = TP.zerocopy_inputs(tspec, _t(x), _t(off), _t(wd),
                                        th, tw, tc)
    got = TF.deform_conv_fused_zerocopy(txp, toff, twt, **kw).numpy()
    assert got.shape == (2, ho, wo, m)
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(got, ref, **TOL)
    # The port pads the input exactly as the JAX package does.
    np.testing.assert_array_equal(txp.numpy(), np.asarray(jxp))
    np.testing.assert_array_equal(twt.numpy(), np.asarray(jwt))


def test_plain_kernel_saturates_clamp():
    """Offsets far past ±B give the same result as offsets at ±B."""
    k, s, d, b, h, w, c, m, th, tw, tc = CASES["s1"]
    x, off, wd = _inputs(k, h, w, c, m, s, d, b, seed=3)
    spec = TP.DCSpec(k, s, d, b, th, tw, tc, m)
    far = np.sign(off) * 50.0
    at_b = np.sign(off) * b
    outs = []
    for o in (far, at_b):
        xp, op, wt = TP.zerocopy_inputs(spec, _t(x), _t(o.astype(np.float32)),
                                        _t(wd), th, tw, tc)
        outs.append(TF.deform_conv_fused_zerocopy(
            xp, op, wt, kernel_size=k, stride=s, dilation=d,
            offset_bound=b, tile_h=th, tile_w=tw, tile_c=tc).numpy())
    np.testing.assert_array_equal(outs[0], outs[1])


@pytest.mark.parametrize("case", ["s1_ragged_csteps", "s2_ragged",
                                  "dilation2"])
def test_ops_deform_conv_matches_jax(case):
    k, s, d, b, h, w, c, m, _, _, _ = CASES[case]
    x, off, wd = _inputs(k, h, w, c, m, s, d, b, seed=7)
    ref = np.asarray(JO.deform_conv(
        jnp.asarray(x), jnp.asarray(off), jnp.asarray(wd), kernel_size=k,
        stride=s, dilation=d, offset_bound=b, interpret=True))
    got = TO.deform_conv(_t(x), _t(off), _t(wd), kernel_size=k, stride=s,
                         dilation=d, offset_bound=b, device="cpu").numpy()
    np.testing.assert_allclose(got, ref, **TOL)
    plain = TR.deform_conv_fused_ref(_t(x), _t(off), _t(wd), kernel_size=k,
                                     stride=s, dilation=d, offset_bound=b)
    np.testing.assert_allclose(got, plain.numpy(), **TOL)


def test_ops_deform_conv_unbounded_matches_jax():
    x, off, wd = _inputs(3, 7, 8, 4, 5, 1, 1, 1.0, seed=9)
    ref = np.asarray(JO.deform_conv(jnp.asarray(x), jnp.asarray(off),
                                    jnp.asarray(wd)))
    got = TO.deform_conv(_t(x), _t(off), _t(wd), device="cpu").numpy()
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("stride,use_kernel", [(1, True), (2, True),
                                               (1, False), (2, False)])
def test_dcl_apply_matches_jax(stride, use_kernel):
    rng = np.random.RandomState(stride)
    c, m = 8, 8
    params = {
        "w_offset": (rng.randn(3, 3, c, 18) * 0.4).astype(np.float32),
        "b_offset": (rng.randn(18) * 0.5).astype(np.float32),
        "w_deform": (rng.randn(3, 3, c, m) * 0.3).astype(np.float32),
        "b_deform": rng.randn(m).astype(np.float32),
    }
    x = rng.randn(2, 10, 10, c).astype(np.float32)
    yj, oj = JL.dcl_apply({k: jnp.asarray(v) for k, v in params.items()},
                          jnp.asarray(x), stride=stride, offset_bound=2.0,
                          use_kernel=use_kernel)
    yt, ot = TL.dcl_apply({k: _t(v) for k, v in params.items()}, _t(x),
                          stride=stride, offset_bound=2.0,
                          use_kernel=use_kernel, device="cpu")
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
    np.testing.assert_allclose(float(ot), float(oj), **TOL)


def test_tile_weights_matches_jax():
    w = np.random.RandomState(0).randn(9, 12, 5).astype(np.float32)
    for tc in (1, 3, 4, 12):
        np.testing.assert_array_equal(
            TP.tile_weights(_t(w), tc).numpy(),
            np.asarray(JP.tile_weights(jnp.asarray(w), tc)))
    with pytest.raises(ValueError, match="does not divide"):
        TP.tile_weights(_t(w), 5)


def test_reference_forward_matches_jax_ref():
    x, off, wd = _inputs(3, 9, 9, 4, 4, 2, 1, 2.0, seed=2)
    kw = dict(kernel_size=3, stride=2, dilation=1, offset_bound=2.0)
    ref = np.asarray(JR.deform_conv_fused_ref(jnp.asarray(x),
                                              jnp.asarray(off),
                                              jnp.asarray(wd), **kw))
    np.testing.assert_allclose(
        TR.deform_conv_fused_ref(_t(x), _t(off), _t(wd), **kw).numpy(),
        ref, **TOL)


# -- validation and the device rule -------------------------------------------

def test_deform_conv_without_cuda_and_without_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, off, wd = _inputs(3, 6, 6, 4, 4, 1, 1, 2.0, seed=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TO.deform_conv(_t(x), _t(off), _t(wd), offset_bound=2.0)


def test_deform_conv_rejects_tensors_off_its_device():
    x, off, wd = _inputs(3, 6, 6, 4, 4, 1, 1, 2.0, seed=1)
    with pytest.raises(ValueError, match="lies on"):
        TO.deform_conv(_t(x), _t(off), _t(wd), offset_bound=2.0,
                       device="meta")


@pytest.mark.parametrize("kw,match", [
    (dict(tile_c=3), "does not divide C"),
    (dict(tile_m=3), "does not divide M"),
    (dict(tile_c=3, offset_bound=None), "does not divide C"),
    (dict(tile_m=3, offset_bound=None), "does not divide M"),
])
def test_deform_conv_validation_raises(kw, match):
    x, off, wd = _inputs(3, 6, 6, 4, 4, 1, 1, 2.0, seed=1)
    kw = dict(dict(offset_bound=2.0), **kw)
    with pytest.raises(ValueError, match=match):
        TO.deform_conv(_t(x), _t(off), _t(wd), device="cpu", **kw)


def test_dispatch_hook_sees_bounded_calls_and_can_abort():
    x, off, wd = _inputs(3, 6, 6, 4, 4, 1, 1, 2.0, seed=1)
    seen = []
    with TO.dispatch_hook_scope(seen.append):
        TO.deform_conv(_t(x), _t(off), _t(wd), offset_bound=2.0,
                       device="cpu")
    assert len(seen) == 1 and seen[0]["op"] == "deform_conv"
    TO.deform_conv(_t(x), _t(off), _t(wd), offset_bound=2.0, device="cpu")
    assert len(seen) == 1                      # the hook was removed

    def boom(ctx):
        raise RuntimeError("injected")
    with TO.dispatch_hook_scope(boom), pytest.raises(RuntimeError,
                                                     match="injected"):
        TO.deform_conv(_t(x), _t(off), _t(wd), offset_bound=2.0,
                       device="cpu")


def test_underpadded_input_raises():
    x, off, wd = _inputs(3, 8, 8, 4, 4, 1, 1, 2.0, seed=1)
    with pytest.raises(ValueError, match="padded input"):
        TF.deform_conv_fused_zerocopy(
            _t(x), _t(off), TP.tile_weights(_t(wd), 4), kernel_size=3,
            stride=1, dilation=1, offset_bound=2.0, tile_h=4, tile_w=4)


def test_dcl_apply_without_bound_runs_the_reference():
    rng = np.random.RandomState(4)
    params = {"w_offset": (rng.randn(3, 3, 4, 18) * 0.3).astype(np.float32),
              "b_offset": np.zeros(18, np.float32),
              "w_deform": rng.randn(3, 3, 4, 4).astype(np.float32),
              "b_deform": np.zeros(4, np.float32)}
    x = rng.randn(1, 6, 6, 4).astype(np.float32)
    yj, _ = JL.dcl_apply({k: jnp.asarray(v) for k, v in params.items()},
                         jnp.asarray(x), use_kernel=True)
    yt, _ = TL.dcl_apply({k: _t(v) for k, v in params.items()}, _t(x),
                         use_kernel=True, device="cpu")
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
