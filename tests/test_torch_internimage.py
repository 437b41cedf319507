"""InternImage-B with bounded DCNv3 offsets in the port: the registry's
entry and CPU preset, ``conv2d``'s groups, the model on its two paths,
and serving through ``DCLServingEngine`` and the launcher on the CPU
(the ``fp32_kernel`` rung runs the kernel's plain version there)."""
import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.core.deform_conv import conv2d
from repro_torch.launch import serve as launch
from repro_torch.models import internimage as I
from repro_torch.models import registry as reg
from repro_torch.models import resnet_dcn as R
from repro_torch.obs.trace import Tracer, tracer_scope
from repro_torch.serve import DCLServeConfig, DCLServingEngine
from repro_torch.serve.dcl_engine import bucket_layer_dims, model_family

ARCH = "internimage_b_bounded"


@pytest.fixture(scope="module")
def model():
    cfg = reg.reduced_config(reg.get(ARCH))
    params = I.init_params(cfg, seed=3, device="cpu")
    # Non-zero offset and mask projections, so taps move and weigh apart.
    gen = torch.Generator().manual_seed(4)
    for name, p in params.items():
        if "dcn" in p:
            for proj in ("offset", "mask"):
                w = p["dcn"][proj]["w"]
                w.copy_(torch.randn(w.shape, generator=gen) * 0.3)
    return cfg, params


def _images(n, side=64, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.random((side, side, 3), dtype=np.float32) for _ in range(n)]


def test_registry_lists_the_published_config():
    assert ARCH in reg.det_names()
    cfg = reg.get(ARCH).config
    assert (cfg.channels, cfg.depths, cfg.groups) == (
        112, (4, 4, 21, 4), (7, 14, 28, 56))
    assert cfg.offset_bound == 2.0 and cfg.img_size == 512
    assert set(reg.get(ARCH).shapes) == {"train_det", "infer_det"}
    n = sum(int(np.prod(d.shape)) for d in _leaves(I.model_def(cfg)))
    head = sum(int(np.prod(d.shape)) for d in _leaves(
        R.head_def(896, cfg.num_classes)))
    assert 94e6 < n - head < 96e6                   # about 95 M
    # The dry run's cells stay the LMs' and the ResNet-DCN detectors'.
    assert all(a != ARCH for a, _ in reg.runnable_cells())


def _leaves(tree):
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k])
    else:
        yield tree


def test_cpu_preset_keeps_16_channels_a_group():
    cfg = reg.reduced_config(reg.get(ARCH))
    assert (cfg.channels, cfg.depths, cfg.groups, cfg.img_size) == (
        32, (1, 1, 2, 1), (2, 4, 8, 16), 64)
    assert all(cfg.width(s) // g == 16 for s, g in enumerate(cfg.groups))
    assert cfg.offset_bound == 2.0
    dims = bucket_layer_dims(cfg, 64)
    assert dims["s0b0"] == dict(h=16, w=16, c=32, groups=2)
    assert dims["s3b0"] == dict(h=2, w=2, c=256, groups=16)


def test_conv2d_groups_is_a_depthwise_convolution():
    x = torch.randn(2, 7, 9, 6)
    w = torch.randn(3, 3, 1, 6)
    y = conv2d(x, w, padding=1, groups=6)
    per = [F.conv2d(x[..., c][:, None], w[..., 0, c][None, None],
                    padding=1)[:, 0] for c in range(6)]
    torch.testing.assert_close(y, torch.stack(per, -1))
    dense = torch.randn(3, 3, 6, 4)
    assert torch.equal(conv2d(x, dense), conv2d(x, dense, groups=1))


def test_forward_paths_agree(model):
    cfg, params = model
    x = torch.as_tensor(np.stack(_images(3)))
    plain, stats = I.forward(params, cfg, x, device="cpu")
    kern, _ = I.forward(params, dataclasses.replace(cfg, use_kernel=True),
                        x, device="cpu")
    assert stats == {}
    assert plain["cls"].shape == (3, 2, 2, cfg.num_classes + 1)
    assert plain["box"].shape == (3, 2, 2, 4)
    assert plain["features"].shape == (3, 2, 2, 256)
    for k in ("cls", "box"):
        assert torch.equal(plain[k], kern[k])


def test_engine_serves_the_cpu_preset(model):
    cfg, params = model
    eng = DCLServingEngine(params, cfg,
                           DCLServeConfig(buckets=(64,), slots=2,
                                          quant="fp32_kernel"),
                           device="cpu")
    assert model_family(cfg) is I and eng.rungs == ("fp32_kernel",
                                                    "fp32_ref")
    assert set(eng.plans[64]) == set(bucket_layer_dims(cfg, 64))
    imgs = _images(4, seed=1)
    reqs = [eng.submit(im) for im in imgs]
    eng.run_until_drained()
    assert eng.counters == {"ok": 4} and eng.steps == 2
    expect, _ = I.forward(params, cfg, torch.as_tensor(np.stack(imgs)),
                          device="cpu")
    for i, r in enumerate(reqs):
        assert r.outcome == "ok" and r.ladder == "fp32_kernel"
        np.testing.assert_allclose(r.result["cls"], expect["cls"][i].numpy(),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(r.result["box"], expect["box"][i].numpy(),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("rung", ["int8_chain", "int8"])
def test_int8_engine_raises_at_construction(model, rung):
    cfg, params = model
    with pytest.raises(ValueError, match=f"'{rung}'.*{cfg.name}"):
        DCLServingEngine(params, cfg, DCLServeConfig(buckets=(64,), slots=2,
                                                     quant=rung),
                         device="cpu")


def test_spatial_bucket_raises_at_construction(model):
    cfg, params = model
    with pytest.raises(ValueError, match="spatial_shards"):
        DCLServingEngine(params, cfg, DCLServeConfig(
            buckets=(64,), slots=2, quant="fp32_kernel",
            spatial_shards=((64, 2),)), device="cpu", devices=["cpu"] * 2)


def test_model_family_refuses_other_configs():
    with pytest.raises(TypeError, match="ModelConfig"):
        model_family(reg.get("tinyllama-1.1b").config)


def test_divergence_rows_price_every_dcnv3_dispatch(model):
    cfg, params = model
    with tracer_scope(Tracer()):
        eng = DCLServingEngine(params, cfg,
                               DCLServeConfig(buckets=(64,), slots=2,
                                              quant="fp32_kernel"),
                               device="cpu")
        for im in _images(2):
            eng.submit(im)
        eng.run_until_drained()
    rows = eng.telemetry()["divergence"]["dispatches"]
    assert {r["op"] for r in rows} == {"dcnv3"}
    assert sum(r["n"] for r in rows) == sum(cfg.depths)
    assert all(r["bound_s"] > 0 and r["bound_by"] == "bytes" for r in rows)


def test_launcher_serves_internimage_on_cpu(capsys):
    args = launch.build_parser().parse_args(
        ["--arch", ARCH, "--reduced", "--buckets", "64", "--requests", "4",
         "--slots", "2", "--device", "cpu"])
    cfg = launch.detection_config(args)
    assert isinstance(cfg, I.InternImageConfig) and cfg.channels == 32
    eng, images, seconds = launch.serve_detection(cfg, args)
    assert eng.scfg.quant == "fp32_kernel" and eng.counters == {"ok": 4}
    assert "served 4/4" in launch.report(eng, seconds)
    launch.main(["--arch", ARCH, "--reduced", "--buckets", "64",
                 "--requests", "2", "--slots", "2", "--device", "cpu"])
    assert "on fp32_kernel" in capsys.readouterr().out
