"""Port parity: ResNet-50-DCN of ``repro_torch`` against the JAX model.

JAX params are converted with ``params_from_jax``; the offset convs are
perturbed (numpy, seeded) so every DCL tap interpolates and some clamp.
The whole small model runs through the JAX kernel path (Pallas, interpret
mode) and through the port's kernel path (plain version on the CPU);
tolerance 1e-4 * max|ref| for the head outputs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import resnet_dcn as JR
from repro_torch.configs import resnet50_dcn as TC
from repro_torch.convert import params_from_jax
from repro_torch.models import resnet_dcn as TRN

torch.set_num_threads(2)

SMALL = dict(stage_sizes=(1, 1, 1, 1), widths=(16, 32, 64, 128),
             stem_width=8, num_dcn=2, num_classes=4, img_size=32,
             offset_bound=2.0)


def perturbed_jax_params(cfg, seed=0):
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


@pytest.fixture(scope="module")
def small():
    jcfg = JR.ResNetDCNConfig(**SMALL, use_kernel=True)
    tcfg = TRN.ResNetDCNConfig(**SMALL, use_kernel=True)
    params = perturbed_jax_params(jcfg)
    images = np.random.RandomState(1).randn(2, 32, 32, 3) \
        .astype(np.float32)
    return jcfg, tcfg, params, images


@pytest.mark.parametrize("use_kernel", [True, False])
def test_forward_matches_jax(small, use_kernel):
    jcfg, tcfg, params, images = small
    jcfg = dataclasses.replace(jcfg, use_kernel=use_kernel)
    tcfg = dataclasses.replace(tcfg, use_kernel=use_kernel)
    ref, ref_omax = JR.forward(jax.tree_util.tree_map(jnp.asarray, params),
                               jcfg, jnp.asarray(images))
    got, got_omax = TRN.forward(params_from_jax(params, device="cpu"), tcfg,
                                torch.from_numpy(images), device="cpu")
    for key in ("cls", "box", "features"):
        r = np.asarray(ref[key])
        g = got[key].numpy()
        assert g.shape == r.shape
        assert np.isfinite(g).all()
        assert np.abs(g - r).max() <= 1e-4 * np.abs(r).max(), key
    assert set(got_omax) == set(ref_omax) == {"s2b0", "s3b0"}
    for name in ref_omax:
        np.testing.assert_allclose(float(got_omax[name]),
                                   float(ref_omax[name]), rtol=1e-4)
    # The perturbation makes the clamp bite: some raw offsets exceed B.
    assert max(float(v) for v in got_omax.values()) > SMALL["offset_bound"]


def test_group_norm_matches_jax():
    rng = np.random.RandomState(0)
    for c in (8, 48, 96):            # 48 and 96: groups step down to 24/32
        x = rng.randn(2, 5, 4, c).astype(np.float32) * 3 + 1
        p = {"scale": rng.randn(c).astype(np.float32),
             "bias": rng.randn(c).astype(np.float32)}
        ref = np.asarray(JR.group_norm(
            jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}))
        got = TRN.group_norm(torch.from_numpy(x),
                             {k: torch.from_numpy(v) for k, v in p.items()})
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cfg_name", ["resnet50_dcn", "resnet50_dcn_bounded"])
def test_param_tree_matches_jax(cfg_name):
    """Same tree names and shapes at full width, without materialising."""
    from repro.configs import resnet50_dcn as JC
    tcfg = TC.get(cfg_name)
    jcfg = {"resnet50_dcn": JC.CONFIG,
            "resnet50_dcn_bounded": JC.CONFIG_BOUNDED}[cfg_name]
    jshapes = jax.tree_util.tree_map(
        lambda d: tuple(d.shape), JR.model_def(jcfg),
        is_leaf=lambda d: hasattr(d, "axes"))

    def shapes(d):
        return {k: shapes(v) for k, v in d.items()} if isinstance(d, dict) \
            else tuple(d.shape)
    assert shapes(TRN.model_def(tcfg)) == jshapes
    for f in ("stage_sizes", "widths", "stem_width", "num_dcn",
              "offset_bound", "num_classes", "img_size"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    assert sum(tcfg.is_dcn(i) for i in range(tcfg.total_blocks)) == 12


def test_init_params_is_seeded_and_on_the_named_device():
    cfg = TRN.ResNetDCNConfig(**SMALL)
    a = TRN.init_params(cfg, seed=3, device="cpu")
    b = TRN.init_params(cfg, seed=3, device="cpu")
    c = TRN.init_params(cfg, seed=4, device="cpu")
    wa, wb, wc = (p["s2b0"]["dcl"]["w_deform"] for p in (a, b, c))
    assert torch.equal(wa, wb) and not torch.equal(wa, wc)
    assert wa.device.type == "cpu"
    assert not a["s2b0"]["dcl"]["w_offset"].any()    # zero-init offsets


def test_forward_rejects_images_off_its_device(small):
    _, tcfg, params, images = small
    with pytest.raises(ValueError, match="lies on"):
        TRN.forward(params_from_jax(params, device="cpu"), tcfg,
                    torch.from_numpy(images), device="meta")


def test_unknown_arch_raises():
    with pytest.raises(ValueError, match="unknown arch"):
        TC.get("tinyllama-1.1b")


def test_params_from_jax_copies_read_only_buffers():
    arr = np.arange(6, dtype=np.float32).reshape(2, 3)
    arr.setflags(write=False)
    out = params_from_jax({"a": {"b": arr}}, device="cpu")
    out["a"]["b"].add_(1)
    assert arr[0, 0] == 0 and out["a"]["b"][0, 0] == 1
