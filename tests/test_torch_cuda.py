"""The port's CUDA kernel on the card, held against its plain version.

Imports neither JAX nor the JAX package, so it runs on a machine with a
GPU and no JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Without a GPU every test skips (the kernel has no CPU mode).  Tolerance:
``max|kernel - plain| <= 1e-5 * max|plain|`` (the same gather and
corner arithmetic, contracted in another order); TF32 off.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core.tiling import out_hw
from repro_torch.kernels import ops, plan
from repro_torch.kernels.deform_conv_fused import (
    deform_conv_fused_zerocopy, deform_conv_fused_zerocopy_plain)
from repro_torch.models import resnet_dcn as R

pytestmark = pytest.mark.cuda

RTOL = 1e-5

# (k, s, d, B, H, W, C, M, th, tw, tc): stride 1/2, dilation 2, ragged
# Ho/Wo, c_steps > 1, M below the kernel's 64 lanes, 16/32/64-pixel tiles.
CASES = {
    "s1": (3, 1, 1, 2.0, 16, 16, 32, 64, 8, 8, 16),
    "s1_ragged_csteps": (3, 1, 1, 2.0, 9, 11, 8, 6, 4, 4, 4),
    "s2_ragged": (3, 2, 1, 2.0, 12, 9, 8, 8, 4, 2, 8),
    "dilation2": (3, 1, 2, 1.5, 10, 10, 8, 8, 3, 5, 4),
    "k5_s2": (5, 2, 1, 1.0, 11, 11, 4, 4, 2, 3, 2),
    "tile32_m96": (3, 1, 1, 2.0, 12, 12, 16, 96, 4, 8, 16),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(k, h, w, c, m, s, d, b, seed, device):
    rng = np.random.RandomState(seed)
    ho, wo = out_hw(h, w, kernel_size=k, stride=s, dilation=d)
    x = rng.randn(2, h, w, c).astype(np.float32)
    off = (rng.randn(2, ho, wo, 2 * k * k) * 2 * b).astype(np.float32)
    wd = (rng.randn(k * k, c, m) / np.sqrt(k * k * c)).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (x, off, wd))


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain(case, cuda):
    k, s, d, b, h, w, c, m, th, tw, tc = CASES[case]
    x, off, wd = _inputs(k, h, w, c, m, s, d, b, len(case), cuda)
    tm = min(m, 64)
    spec = plan.DCSpec(k, s, d, b, th, tw, tc, tm)
    xp, op, wt = plan.zerocopy_inputs(spec, x, off, wd, th, tw, tc)
    kw = dict(kernel_size=k, stride=s, dilation=d, offset_bound=b,
              tile_h=th, tile_w=tw, tile_c=tc, tile_m=tm)
    before = deform_conv_fused_zerocopy.launches
    got = deform_conv_fused_zerocopy(xp, op, wt, **kw)
    torch.cuda.synchronize()
    assert deform_conv_fused_zerocopy.launches == before + 1
    want = deform_conv_fused_zerocopy_plain(xp, op, wt, **kw)
    assert got.shape == want.shape
    assert (got - want).abs().max().item() <= RTOL * want.abs().max().item()


def test_invalid_tiles_raise_before_launch(cuda):
    x, off, wd = _inputs(3, 8, 8, 4, 4, 1, 1, 2.0, 0, cuda)
    spec = plan.DCSpec(3, 1, 1, 2.0, 8, 8, 4, 4)
    xp, op, wt = plan.zerocopy_inputs(spec, x, off, wd, 8, 8, 4)
    before = deform_conv_fused_zerocopy.launches
    with pytest.raises(ValueError):
        deform_conv_fused_zerocopy(xp, op, wt, kernel_size=3, stride=1,
                                   dilation=1, offset_bound=2.0, tile_h=8,
                                   tile_w=9, tile_c=4)
    with pytest.raises(ValueError):
        deform_conv_fused_zerocopy(xp, op, wt, kernel_size=3, stride=1,
                                   dilation=1, offset_bound=2.0, tile_h=8,
                                   tile_w=8, tile_c=4, tile_m=128)
    assert deform_conv_fused_zerocopy.launches == before


def test_deform_conv_refuses_gradients(cuda):
    x, off, wd = _inputs(3, 6, 6, 4, 4, 1, 1, 2.0, 1, cuda)
    x.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="training slice"):
        ops.deform_conv(x, off, wd, offset_bound=2.0)
    with torch.no_grad():
        assert ops.deform_conv(x, off, wd, offset_bound=2.0).is_cuda


def test_small_model_kernel_path_matches_plain_path(cuda):
    cfg = R.ResNetDCNConfig(stage_sizes=(1, 1, 1, 1),
                            widths=(16, 32, 64, 128), stem_width=8,
                            num_dcn=2, num_classes=4, img_size=32,
                            offset_bound=2.0, use_kernel=True)
    params = R.init_params(cfg, seed=0, device=cuda)
    gen = torch.Generator().manual_seed(1)
    for block in params.values():
        if "dcl" in block:
            d = block["dcl"]
            d["w_offset"] = (torch.randn(d["w_offset"].shape, generator=gen)
                             * 0.1).to(cuda)
    images = torch.randn(2, 32, 32, 3, generator=gen).to(cuda)
    before = deform_conv_fused_zerocopy.launches
    with torch.no_grad():
        got, _ = R.forward(params, cfg, images)
        want, _ = R.forward(params, dataclasses.replace(cfg, use_kernel=False),
                            images)
    assert deform_conv_fused_zerocopy.launches == before + 2
    for key in ("cls", "box"):
        scale = want[key].abs().max().item()
        assert (got[key] - want[key]).abs().max().item() <= 1e-4 * scale


def test_engine_fails_a_batch_whose_kernel_keeps_failing(cuda):
    """On the card the engine never serves a batch by the plain path: a
    kernel that keeps failing retires it ``failed``."""
    from repro_torch.serve import DCLServeConfig, DCLServingEngine
    cfg = R.ResNetDCNConfig(stage_sizes=(1, 1, 1, 1),
                            widths=(16, 32, 64, 128), stem_width=8,
                            num_dcn=2, num_classes=4, img_size=32,
                            offset_bound=2.0, use_kernel=True)
    eng = DCLServingEngine(R.init_params(cfg, seed=0, device=cuda), cfg,
                           DCLServeConfig(buckets=(32,), slots=2),
                           device=cuda)
    assert eng.rungs == ("fp32_kernel",)

    def always(ctx):
        raise RuntimeError("kernel launch failed")
    with ops.dispatch_hook_scope(always):
        r = eng.submit(np.zeros((32, 32, 3), np.float32))
        eng.run_until_drained()
    assert r.outcome == "failed" and not r.degraded
    r2 = eng.submit(np.ones((32, 32, 3), np.float32))
    eng.run_until_drained()
    assert r2.outcome == "ok" and r2.ladder == "fp32_kernel"
