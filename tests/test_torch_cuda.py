"""The port's CUDA kernels on the card, held against their plain versions.

Imports neither JAX nor the JAX package, so it runs on a machine with a
GPU and no JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Without a GPU every test skips (the kernels have no CPU mode).
Tolerances: fp32 forward kernels (1a, 4) ``max|kernel - plain| <= 1e-5 *
max|plain|`` (the same gather and corner arithmetic, contracted in
another order), TF32 off; the backward kernel ``1e-4 * max|plain|`` per
cotangent (its fp32 atomics and split partial sums reorder the sums);
int8 kernels exact (``torch.equal``: the same fp32 roundings and exact
integer sums); the sampling kernels (1b, 3) 1e-6 absolute (the plain
version's roundings in its order); the matmul 1e-5 * max|plain| in fp32
and one bf16 step (2^-7 * max|plain|) in bf16.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core.tiling import out_hw
from repro_torch.kernels import ops, plan, ref
from repro_torch.kernels import deform_conv_q as Q
from repro_torch.kernels.deform_conv_bwd import (
    deform_conv_bwd_zerocopy, deform_conv_bwd_zerocopy_plain)
from repro_torch.kernels.deform_conv_fused import (
    deform_conv_fused_zerocopy, deform_conv_fused_zerocopy_plain)
from repro_torch.models import resnet_dcn as R
from repro_torch.quant.qtypes import compute_scale, quantize_values

pytestmark = pytest.mark.cuda

RTOL = 1e-5
BWD_RTOL = 1e-4     # fp32 atomics add in a run-dependent order

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
    """Gradients of the fp32 bounded path flow through the backward kernel
    (one launch per backward); the int8 datapath still refuses them."""
    x, off, wd = _inputs(3, 6, 6, 4, 4, 1, 1, 2.0, 1, cuda)
    for t in (x, off, wd):
        t.requires_grad_(True)
    before = deform_conv_bwd_zerocopy.launches
    y = ops.deform_conv(x, off, wd, offset_bound=2.0)
    got = torch.autograd.grad(torch.sin(y).sum(), (x, off, wd))
    torch.cuda.synchronize()
    assert deform_conv_bwd_zerocopy.launches == before + 1
    want = torch.autograd.grad(
        torch.sin(ref.deform_conv_fused_ref(x, off, wd, offset_bound=2.0))
        .sum(), (x, off, wd))
    for g, r in zip(got, want):
        assert (g - r).abs().max().item() <= BWD_RTOL * r.abs().max().item()
    with pytest.raises(NotImplementedError, match="quant='qat'"):
        ops.deform_conv(x, off, wd, offset_bound=2.0, precision="int8")
    with torch.no_grad():
        assert ops.deform_conv(x, off, wd, offset_bound=2.0,
                               precision="int8").is_cuda


# Backward-only geometries, same layout: 128 output tiles (2 x 8 x 8), so
# C is split into 3 groups of uneven size (1, 1, 2 chunks); tile_c = 8 (72
# rows of K*K*tile_c, padded to 96, two warp groups); M = 44 (not a
# multiple of 8); C = 20 with tile_c = 5 and M = 30 (W and g rows not
# 16-byte aligned: staged element by element).
BWD_CASES = {
    "c_groups_128_tiles": (3, 1, 1, 2.0, 32, 32, 128, 64, 4, 4, 32),
    "tc8_72_rows": (3, 1, 1, 2.0, 12, 12, 16, 32, 4, 4, 8),
    "m44": (3, 1, 1, 2.0, 12, 12, 16, 44, 4, 8, 16),
    "c20_tc5_m30_unaligned": (3, 1, 1, 2.0, 10, 10, 20, 30, 4, 4, 5),
}


def _bwd_case(case, device):
    k, s, d, b, h, w, c, m, th, tw, tc = {**CASES, **BWD_CASES}[case]
    x, off, wd = _inputs(k, h, w, c, m, s, d, b, len(case), device)
    ho, wo = off.shape[1], off.shape[2]
    g = torch.randn(2, ho, wo, m, generator=torch.Generator().manual_seed(
        len(case))).to(device)
    spec = plan.DCSpec(k, s, d, b, th, tw, tc, None)
    xp, op, wt = plan.zerocopy_inputs(spec, x, off, wd, th, tw, tc)
    kw = dict(kernel_size=k, stride=s, dilation=d, offset_bound=b,
              tile_h=th, tile_w=tw, tile_c=tc)
    return xp, op, g, wt, kw


@pytest.mark.parametrize("case", sorted(CASES) + sorted(BWD_CASES))
def test_backward_kernel_matches_plain(case, cuda):
    xp, op, g, wt, kw = _bwd_case(case, cuda)
    before = deform_conv_bwd_zerocopy.launches
    got = deform_conv_bwd_zerocopy(xp, op, g, wt, **kw)
    torch.cuda.synchronize()
    assert deform_conv_bwd_zerocopy.launches == before + 1
    want = deform_conv_bwd_zerocopy_plain(xp, op, g, wt, **kw)
    for name, a, r in zip(("dx", "d_off", "dw"), got, want):
        assert a.shape == r.shape, name
        assert (a - r).abs().max().item() <= BWD_RTOL * r.abs().max().item(), \
            name
    # Non-contiguous cotangent (autograd may hand one over) is refused.
    with pytest.raises(ValueError, match="contiguous"):
        deform_conv_bwd_zerocopy(
            xp, op, g.transpose(1, 2).contiguous().transpose(1, 2), wt, **kw)
    assert deform_conv_bwd_zerocopy.launches == before + 1


@pytest.mark.parametrize("case", ["c_groups_128_tiles", "tile32_m96",
                                  "s1_ragged_csteps"])
def test_backward_kernel_is_deterministic(case, cuda):
    """d_weights (fixed-order split sums) and d_offsets (fixed-order sums
    over channel parts and C groups) are bit for bit the same from call to
    call; only d_input adds with atomics."""
    xp, op, g, wt, kw = _bwd_case(case, cuda)
    _, doff_a, dw_a = deform_conv_bwd_zerocopy(xp, op, g, wt, **kw)
    _, doff_b, dw_b = deform_conv_bwd_zerocopy(xp, op, g, wt, **kw)
    torch.cuda.synchronize()
    assert torch.equal(dw_a, dw_b)
    assert torch.equal(doff_a, doff_b)


def test_small_model_training_step_matches_plain_path(cuda):
    """One Eq. 5 training step of the small model: gradients through the
    kernels (2 forward and 2 backward launches) against the same step with
    the plain versions in place."""
    from repro_torch.data import DetectionDataConfig, detection_batch
    from repro_torch.kernels import deform_conv_fused as F
    from repro_torch.tree import leaves
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
    for t in leaves(params):
        t.requires_grad_(True)
    batch = {k: torch.from_numpy(v).to(cuda) for k, v in detection_batch(
        DetectionDataConfig(img_size=32, global_batch=2, num_classes=4),
        0).items()}

    def grads():
        loss, _ = R.train_loss(params, cfg, batch, lam=0.005)
        return loss, torch.autograd.grad(loss, leaves(params))
    fwd, bwd = F.deform_conv_fused_zerocopy.launches, \
        deform_conv_bwd_zerocopy.launches
    saved = (plan.deform_conv_fused_zerocopy, plan.deform_conv_bwd_zerocopy,
             torch.backends.cudnn.deterministic)
    torch.backends.cudnn.deterministic = True    # the same offsets twice
    try:
        loss, got = grads()
        torch.cuda.synchronize()
        assert F.deform_conv_fused_zerocopy.launches == fwd + 2
        assert deform_conv_bwd_zerocopy.launches == bwd + 2
        plan.deform_conv_fused_zerocopy = F.deform_conv_fused_zerocopy_plain
        plan.deform_conv_bwd_zerocopy = deform_conv_bwd_zerocopy_plain
        want_loss, want = grads()
    finally:
        (plan.deform_conv_fused_zerocopy, plan.deform_conv_bwd_zerocopy,
         torch.backends.cudnn.deterministic) = saved
    assert abs(loss.item() - want_loss.item()) <= 1e-5 * abs(want_loss.item())
    flat = torch.cat([g.reshape(-1) for g in got])
    ref_flat = torch.cat([g.reshape(-1) for g in want])
    assert (flat - ref_flat).norm() <= 1e-4 * ref_flat.norm()


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
                           DCLServeConfig(buckets=(32,), slots=2,
                                          quant="fp32_kernel"),
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


# -- int8 kernels --------------------------------------------------------------

# (k, s, d, B, H, W, C, M, th, tw, tc): ragged, two C chunks, M < 64 lanes;
# stride 2 with a 3x5 tile.
Q_CASES = {
    "s1_ragged_csteps": (3, 1, 1, 2.0, 9, 11, 8, 6, 4, 4, 4),
    "s2_dilation1": (3, 2, 1, 1.5, 13, 11, 16, 72, 3, 5, 8),
}


def _q_args(case, kernel, cuda, emit="int8"):
    k, s, d, b, h, w, c, m, th, tw, tc = Q_CASES[case]
    x, off, wd = _inputs(k, h, w, c, m, s, d, b, 7, cuda)
    gen = torch.Generator().manual_seed(8)
    ho, wo = out_hw(h, w, kernel_size=k, stride=s, dilation=d)
    sx, sw = compute_scale(x), compute_scale(wd, axis=-1)
    xp = plan.pad_zerocopy(quantize_values(x, sx), kernel_size=k, stride=s,
                           dilation=d, offset_bound=b, tile_h=th, tile_w=tw,
                           ho=ho, wo=wo)
    kw = dict(kernel_size=k, stride=s, dilation=d, offset_bound=b,
              tile_h=th, tile_w=tw, tile_c=tc, tile_m=min(m, 64))
    wq = quantize_values(wd, sw)
    if kernel == "dcq":
        return (xp, off, plan.tile_weights(wq, tc),
                (sx * sw).reshape(m).contiguous()), kw
    woff = torch.randn(k * k, c, 2 * k * k, generator=gen).to(cuda)
    woq = quantize_values(woff, compute_scale(woff, axis=-1))
    acc_std = (k * k * c) ** 0.5 * 40 * 73          # offsets of ~1.5 px
    off_scale = torch.full((2 * k * k,), 1.5 / acc_std, device=cuda)
    off_bias = (torch.randn(2 * k * k, generator=gen) * 0.5).to(cuda)
    # y of std ~60 on the emission grid, so the requant rounds and clips.
    out_scale = torch.full((m,), 60.0 / ((k * k * c) ** 0.5 * 20 * 47),
                           device=cuda)
    out_bias = (torch.randn(m, generator=gen) * 2).to(cuda)
    kw.update(emit=emit, ho=ho, wo=wo)
    return (xp, plan.tile_weights(wq, c), plan.tile_weights(woq, c),
            off_scale, off_bias, out_scale, out_bias), kw


@pytest.mark.parametrize("kernel", ["dcq", "dcc_int8", "dcc_fp32"])
@pytest.mark.parametrize("case", sorted(Q_CASES))
def test_int8_kernels_equal_plain(case, kernel, cuda):
    if kernel == "dcq":
        fn, plain = (Q.deform_conv_fused_zerocopy_q,
                     Q.deform_conv_fused_zerocopy_q_plain)
        args, kw = _q_args(case, "dcq", cuda)
    else:
        fn, plain = (Q.deform_conv_fused_zerocopy_chain,
                     Q.deform_conv_fused_zerocopy_chain_plain)
        args, kw = _q_args(case, "dcc", cuda, emit=kernel[4:])
    before = fn.launches
    got = fn(*args, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = plain(*args, **kw)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)
    if kernel == "dcc_int8":       # the requant really rounds and clips
        assert 0 < (got.abs() == 127).float().mean().item() < 0.5


@pytest.mark.parametrize("kernel", ["dcq", "dcc"])
@pytest.mark.parametrize("bad", ["float_input", "non_contiguous", "tile_c"])
def test_int8_kernels_refuse_bad_inputs_before_launch(kernel, bad, cuda):
    fn = Q.deform_conv_fused_zerocopy_q if kernel == "dcq" \
        else Q.deform_conv_fused_zerocopy_chain
    args, kw = _q_args("s1_ragged_csteps", kernel, cuda)
    args = list(args)
    if bad == "float_input":
        args[0] = args[0].float()
    elif bad == "non_contiguous":
        args[0] = args[0].transpose(1, 2).contiguous().transpose(1, 2)
    else:
        kw = dict(kw, tile_c=2)
    before = fn.launches
    with pytest.raises(ValueError):
        fn(*args, **kw)
    assert fn.launches == before


def test_int8_chain_engine_step_runs_the_chain_kernel_only(cuda):
    """One engine step of a full-depth (narrow) model on int8_chain
    launches the chain kernel once per DCL and no other DCL kernel."""
    from repro_torch.quant.calibrate import calibrate_resnet_dcn
    from repro_torch.serve import DCLServeConfig, DCLServingEngine
    cfg = R.ResNetDCNConfig(widths=(64, 128, 256, 512), stem_width=16,
                            num_classes=4, img_size=64, offset_bound=2.0,
                            use_kernel=True)
    params = R.init_params(cfg, seed=0, device=cuda)
    images = np.random.RandomState(0).randn(2, 64, 64, 3).astype(np.float32)
    table = calibrate_resnet_dcn(params, cfg, [images], device=cuda)
    eng = DCLServeConfig(buckets=(64,), slots=2)
    assert eng.quant == "int8_chain"
    eng = DCLServingEngine(params, cfg, eng, scale_table=table, device=cuda)
    counted = (deform_conv_fused_zerocopy, Q.deform_conv_fused_zerocopy_q,
               Q.deform_conv_fused_zerocopy_chain)
    for fn in counted:
        fn.launches = 0
    r = eng.submit(images[0])
    eng.step()
    torch.cuda.synchronize()
    assert r.outcome == "ok" and r.ladder == "int8_chain"
    assert [fn.launches for fn in counted] == [0, 0, 12]


def test_trainer_retry_replays_on_the_kernels(cuda, tmp_path):
    """A step that raises is replayed from the checkpoint through the same
    kernels: every computed step launches both DCL kernels twice."""
    from repro_torch.data import DetectionDataConfig, detection_batch
    from repro_torch.kernels import deform_conv_fused as F
    from repro_torch.optim import constant, sgd
    from repro_torch.train import Trainer, TrainerConfig
    cfg = R.ResNetDCNConfig(stage_sizes=(1, 1, 1, 1),
                            widths=(16, 32, 64, 128), stem_width=8,
                            num_dcn=2, num_classes=4, img_size=32,
                            offset_bound=2.0, use_kernel=True)
    data = DetectionDataConfig(img_size=32, global_batch=2, num_classes=4)
    fired = []

    def fault(step):
        if step == 1 and not fired:
            fired.append(step)
            raise RuntimeError("injected")
    tr = Trainer(loss_fn=lambda p, b: R.train_loss(p, cfg, b, lam=0.005),
                 params=R.init_params(cfg, seed=0, device=cuda),
                 optimizer=sgd(constant(0.005)),
                 batch_fn=lambda s: detection_batch(data, s),
                 config=TrainerConfig(total_steps=3, ckpt_every=1,
                                      ckpt_dir=str(tmp_path)),
                 fault_hook=fault, device=cuda)
    fwd, bwd = F.deform_conv_fused_zerocopy.launches, \
        deform_conv_bwd_zerocopy.launches
    tr.run()
    torch.cuda.synchronize()
    assert tr.telemetry["recovered"] == 1 and tr.step == 3
    assert F.deform_conv_fused_zerocopy.launches == fwd + 2 * 3
    assert deform_conv_bwd_zerocopy.launches == bwd + 2 * 3


# -- sampling (1b, 3), banded forward (4), matmul (5) ---------------------------

SAMPLE_ATOL = 1e-6      # the same roundings in the same order: expect 0
MM_RTOL = 1e-5          # fp32 sums over k in another order than cuBLAS
BF16_RTOL = 2.0 ** -7   # one bf16 step at the largest output


@pytest.mark.parametrize("case", sorted(CASES))
def test_sample_kernels_match_plain(case, cuda):
    from repro_torch.kernels import deform_sample as S
    k, s, d, b, h, w, c, m, th, tw, tc = CASES[case]
    x, off, _ = _inputs(k, h, w, c, m, s, d, b, len(case), cuda)
    ho, wo = off.shape[1], off.shape[2]
    geom = dict(kernel_size=k, stride=s, dilation=d, offset_bound=b)
    xp = plan.pad_zerocopy(x, tile_h=th, tile_w=tw, ho=ho, wo=wo, **geom)
    kw = dict(tile_h=th, tile_w=tw, tile_c=tc, **geom)
    before = S.deform_sample_zerocopy.launches
    got = S.deform_sample_zerocopy(xp, off, **kw)
    torch.cuda.synchronize()
    assert S.deform_sample_zerocopy.launches == before + 1
    want = S.deform_sample_zerocopy_plain(xp, off, **kw)
    assert got.shape == want.shape == (2, ho, wo, k * k, c)
    assert (got - want).abs().max().item() <= SAMPLE_ATOL

    spec = plan.DCSpec(k, s, d, b, th, dataflow="banded")
    bands, off_b = plan.banded_inputs(spec, x, off, th)
    kw = dict(tile_h=th, tile_w=tw, tile_c=tc, **geom)
    before = S.deform_sample_banded.launches
    got = S.deform_sample_banded(bands, off_b, **kw)
    torch.cuda.synchronize()
    assert S.deform_sample_banded.launches == before + 1
    want = S.deform_sample_banded_plain(bands, off_b, **kw)
    assert got.shape == want.shape
    assert (got - want).abs().max().item() <= SAMPLE_ATOL


@pytest.mark.parametrize("case", sorted(CASES))
def test_banded_kernel_matches_plain(case, cuda):
    from repro_torch.kernels import deform_conv_fused as F
    k, s, d, b, h, w, c, m, th, tw, tc = CASES[case]
    x, off, wd = _inputs(k, h, w, c, m, s, d, b, len(case), cuda)
    spec = plan.DCSpec(k, s, d, b, th, dataflow="banded")
    bands, off_b = plan.banded_inputs(spec, x, off, th)
    kw = dict(kernel_size=k, stride=s, dilation=d, offset_bound=b,
              tile_h=th, tile_w=max(1, min(tw, 64 // th)), tile_c=tc,
              tile_m=min(m, 64))
    wt = plan.tile_weights(wd, tc)
    before = F.deform_conv_fused_banded.launches
    got = F.deform_conv_fused_banded(bands, off_b, wt, **kw)
    torch.cuda.synchronize()
    assert F.deform_conv_fused_banded.launches == before + 1
    want = F.deform_conv_fused_banded_plain(bands, off_b, wt, **kw)
    assert got.shape == want.shape
    assert (got - want).abs().max().item() <= RTOL * want.abs().max().item()
    # Through ops, against the zero-copy path: the same function, each
    # within RTOL of its plain version.
    y = ops.deform_conv(x, off, wd, kernel_size=k, stride=s, dilation=d,
                        offset_bound=b, dataflow="banded")
    z = ops.deform_conv(x, off, wd, kernel_size=k, stride=s, dilation=d,
                        offset_bound=b)
    assert (y - z).abs().max().item() <= 2 * RTOL * z.abs().max().item()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(8, 8, 8), (300, 200, 100), (1, 7, 3),
                                   (257, 129, 65), (512, 1024, 256)])
def test_matmul_kernel_matches_plain(shape, dtype, cuda):
    from repro_torch.kernels import matmul as MM
    m, k, n = shape
    gen = torch.Generator().manual_seed(m * 31 + n)
    x = torch.randn(m, k, generator=gen).to(cuda, getattr(torch, dtype))
    w = torch.randn(k, n, generator=gen).to(cuda, getattr(torch, dtype))
    before = MM.matmul.launches
    got = ops.matmul(x, w, block_m=128, block_n=128, block_k=128)
    torch.cuda.synchronize()
    assert MM.matmul.launches == before + 1
    want = MM.matmul_plain(x, w)
    assert got.dtype == want.dtype == x.dtype and got.shape == (m, n)
    tol = MM_RTOL if dtype == "float32" else BF16_RTOL
    assert (got.float() - want.float()).abs().max().item() \
        <= tol * want.float().abs().max().item()
    with pytest.raises(ValueError, match="both float32 or both bfloat16"):
        ops.matmul(x, w.double())
    assert MM.matmul.launches == before + 1


@pytest.mark.parametrize("case", ["bf16 4096^3", "bf16 257x129x65",
                                  "fp32 misaligned", "bf16 misaligned"])
def test_matmul_kernel_instances(case, cuda):
    """The tensor-core bf16 instance at a size that is not launch-bound and
    at a ragged one; a view offset by one element (not 16-byte aligned)
    takes the element-wise loads in both dtypes."""
    from repro_torch.kernels import matmul as MM
    dtype = torch.float32 if case.startswith("fp32") else torch.bfloat16
    m, k, n = {"bf16 4096^3": (4096, 4096, 4096),
               "bf16 257x129x65": (257, 129, 65)}.get(case, (300, 256, 192))
    gen = torch.Generator().manual_seed(len(case))
    x = torch.randn(m * k + 1, generator=gen).to(cuda, dtype)
    x = x[1:].view(m, k) if "misaligned" in case else x[:-1].view(m, k)
    w = torch.randn(k, n, generator=gen).to(cuda, dtype)
    want_instance = {"bf16 4096^3": "128x128 aligned",
                     "bf16 257x129x65": "128x128 element-wise",
                     "fp32 misaligned": "64x64 element-wise",
                     "bf16 misaligned": "128x128 element-wise"}[case]
    assert MM.instance(x, w) == want_instance
    before = MM.matmul.launches
    got = MM.matmul(x, w)
    torch.cuda.synchronize()
    assert MM.matmul.launches == before + 1
    want = MM.matmul_plain(x, w)
    tol = MM_RTOL if dtype == torch.float32 else BF16_RTOL
    assert got.dtype == dtype and got.shape == (m, n)
    assert (got.float() - want.float()).abs().max().item() \
        <= tol * want.float().abs().max().item()


def test_banded_small_model_training_step_matches_plain_path(cuda):
    """One Eq. 5 training step of the small model on the banded dataflow:
    2 launches of kernel 4 and 2 of kernel 2, none of kernel 1a, and the
    gradients of the same step with the plain versions in place."""
    from repro_torch.data import DetectionDataConfig, detection_batch
    from repro_torch.kernels import deform_conv_fused as F
    from repro_torch.tree import leaves
    cfg = R.ResNetDCNConfig(stage_sizes=(1, 1, 1, 1),
                            widths=(16, 32, 64, 128), stem_width=8,
                            num_dcn=2, num_classes=4, img_size=32,
                            offset_bound=2.0, use_kernel=True,
                            dataflow="banded")
    params = R.init_params(cfg, seed=0, device=cuda)
    gen = torch.Generator().manual_seed(1)
    for block in params.values():
        if "dcl" in block:
            d = block["dcl"]
            d["w_offset"] = (torch.randn(d["w_offset"].shape, generator=gen)
                             * 0.1).to(cuda)
    for t in leaves(params):
        t.requires_grad_(True)
    batch = {k: torch.from_numpy(v).to(cuda) for k, v in detection_batch(
        DetectionDataConfig(img_size=32, global_batch=2, num_classes=4),
        0).items()}

    def grads():
        loss, _ = R.train_loss(params, cfg, batch, lam=0.005)
        return loss, torch.autograd.grad(loss, leaves(params))
    counts = (F.deform_conv_fused_banded.launches,
              deform_conv_bwd_zerocopy.launches,
              F.deform_conv_fused_zerocopy.launches)
    saved = (plan.deform_conv_fused_banded, plan.deform_conv_bwd_zerocopy,
             torch.backends.cudnn.deterministic)
    torch.backends.cudnn.deterministic = True    # the same offsets twice
    try:
        loss, got = grads()
        torch.cuda.synchronize()
        assert (F.deform_conv_fused_banded.launches,
                deform_conv_bwd_zerocopy.launches,
                F.deform_conv_fused_zerocopy.launches) == (
                    counts[0] + 2, counts[1] + 2, counts[2])
        plan.deform_conv_fused_banded = F.deform_conv_fused_banded_plain
        plan.deform_conv_bwd_zerocopy = deform_conv_bwd_zerocopy_plain
        want_loss, want = grads()
    finally:
        (plan.deform_conv_fused_banded, plan.deform_conv_bwd_zerocopy,
         torch.backends.cudnn.deterministic) = saved
    assert abs(loss.item() - want_loss.item()) <= 1e-5 * abs(want_loss.item())
    flat = torch.cat([g.reshape(-1) for g in got])
    ref_flat = torch.cat([g.reshape(-1) for g in want])
    assert (flat - ref_flat).norm() <= 1e-4 * ref_flat.norm()


# Kernel 6: the six cases of tests/test_flash_attention.py, with its
# tolerances (elementwise: atol + rtol * |plain|).
FA_CASES = [
    # (b, sq, sk, kv, g, dh, causal, softcap)
    (1, 128, 128, 1, 1, 32, True, None),
    (2, 64, 64, 2, 2, 16, True, None),
    (1, 100, 100, 1, 2, 16, True, None),
    (1, 64, 64, 2, 1, 32, False, None),
    (1, 96, 96, 1, 1, 16, True, 8.0),
    (1, 32, 160, 1, 1, 16, False, None),
]
FA_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# bf16 is also held to a relative L2 error (chip_smoke.py's
# FA_BF16_REL_L2): at long Sk a typical |o| is below the 2e-2 atol.
FA_BF16_REL_L2 = 1e-2
# tinyllama's prefill heads (KV 4, G 8, Dh 64, causal): (B, S, dtype).
FA_TINYLLAMA = [(1, 512, "bfloat16"), (4, 512, "bfloat16"),
                (1, 2048, "bfloat16"), (4, 2048, "bfloat16"),
                (1, 4096, "bfloat16"), (1, 2048, "float32")]


def _fa_inputs(b, sq, sk, kv, g, dh, dtype, seed, device):
    gen = torch.Generator().manual_seed(seed)
    dt = getattr(torch, dtype)
    return (torch.randn(b, sq, kv, g, dh, generator=gen).to(device, dt),
            torch.randn(b, sk, kv, dh, generator=gen).to(device, dt),
            torch.randn(b, sk, kv, dh, generator=gen).to(device, dt))


def _fa_check(got, want, dtype):
    tol = FA_TOL[dtype]
    assert got.dtype == want.dtype and got.shape == want.shape
    err = (got.float() - want.float()).abs()
    assert (err <= tol + tol * want.float().abs()).all(), err.max().item()
    if dtype == "bfloat16":
        rel = (err.norm() / want.float().norm()).item()
        assert rel <= FA_BF16_REL_L2, rel


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", range(len(FA_CASES)),
                         ids=lambda i: f"case{i}")
def test_flash_attention_kernel_matches_plain(case, dtype, cuda):
    from repro_torch.kernels import flash_attention as FA
    b, sq, sk, kv, g, dh, causal, cap = FA_CASES[case]
    q, k, v = _fa_inputs(b, sq, sk, kv, g, dh, dtype, case, cuda)
    before = FA.flash_attention.launches
    got = FA.flash_attention(q, k, v, causal=causal, softcap=cap,
                             block_q=32, block_k=32)
    torch.cuda.synchronize()
    assert FA.flash_attention.launches == before + 1
    _fa_check(got, FA.flash_attention_plain(q, k, v, causal=causal,
                                            softcap=cap), dtype)
    # The head-major entry on the same heads (K/V broadcast over G).
    qh = q.permute(0, 2, 3, 1, 4).reshape(b * kv * g, sq, dh)
    kh, vh = (t[:, :, :, None].expand(b, sk, kv, g, dh)
              .permute(0, 2, 3, 1, 4).reshape(b * kv * g, sk, dh)
              for t in (k, v))
    before = FA.flash_attention_bh.launches
    got_bh = FA.flash_attention_bh(qh, kh, vh, causal=causal, softcap=cap)
    torch.cuda.synchronize()
    assert FA.flash_attention_bh.launches == before + 1
    _fa_check(got_bh, FA.flash_attention_bh_plain(qh, kh, vh, causal=causal,
                                                  softcap=cap), dtype)


@pytest.mark.parametrize("b,s,dtype", FA_TINYLLAMA,
                         ids=lambda x: str(x))
def test_flash_attention_kernel_at_tinyllama_prefill(b, s, dtype, cuda):
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import layers as L
    q, k, v = _fa_inputs(b, s, s, 4, 8, 64, dtype, s + b, cuda)
    got = FA.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    _fa_check(got, FA.flash_attention_plain(q, k, v, causal=True), dtype)
    if dtype == "float32":      # the LM's own attention, as the JAX test
        pos = torch.arange(s, device=cuda).expand(b, s)
        want = L.attention(q, k, v, pos, pos, window=None, softcap=None,
                           impl="dense")
        assert ((got - want).abs() <= 3e-5 + 3e-5 * want.abs()).all()


# Head dims 128 and 256 at (1, 2048), causal: deepseek-7b's MHA, glm4-9b's
# GQA, recurrentgemma-9b's MQA (the widest head, the kernel's 32-row K/V
# tiles): (kv, g, dh, dtype).
FA_WIDE_HEADS = [(32, 1, 128, "float32"), (2, 16, 128, "float32"),
                 (1, 16, 256, "float32"), (1, 16, 256, "bfloat16")]


@pytest.mark.parametrize("kv,g,dh,dtype", FA_WIDE_HEADS,
                         ids=lambda x: str(x))
def test_flash_attention_kernel_at_wide_heads(kv, g, dh, dtype, cuda):
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import layers as L
    s = 2048
    q, k, v = _fa_inputs(1, s, s, kv, g, dh, dtype, dh + g, cuda)
    got = FA.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    _fa_check(got, FA.flash_attention_plain(q, k, v, causal=True), dtype)
    if dtype == "float32":
        pos = torch.arange(s, device=cuda).expand(1, s)
        want = L.attention(q, k, v, pos, pos, window=None, softcap=None,
                           impl="dense")
        assert ((got - want).abs() <= 3e-5 + 3e-5 * want.abs()).all()


def test_flash_attention_empty_shapes_launch_nothing(cuda):
    """No query row or no head: an empty output, and no launch counted."""
    from repro_torch.kernels import flash_attention as FA
    before = (FA.flash_attention.launches, FA.flash_attention_bh.launches)
    for b, sq in ((1, 0), (0, 8)):
        q, k, v = _fa_inputs(b, sq, 8, 2, 2, 16, "float32", 0, cuda)
        assert FA.flash_attention(q, k, v).shape == (b, sq, 2, 2, 16)
        qh, kh, vh = q[:, :, 0, 0], k[:, :, 0], v[:, :, 0]
        assert FA.flash_attention_bh(qh, kh, vh).shape == (b, sq, 16)
    assert (FA.flash_attention.launches,
            FA.flash_attention_bh.launches) == before


def test_flash_attention_refuses_before_or_at_launch(cuda):
    from repro_torch.kernels import flash_attention as FA
    q, k, v = _fa_inputs(1, 8, 8, 1, 2, 16, "float32", 0, cuda)
    before = FA.flash_attention.launches
    with pytest.raises(ValueError, match="all float32 or all bfloat16"):
        FA.flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="head dims up to 256"):
        FA.flash_attention(*_fa_inputs(1, 8, 8, 1, 1, 320, "float32", 0,
                                       cuda))
    # Sq above 65535 query tiles of 64 rows: the launch itself is refused
    # (grid.y), and the wrapper raises instead of returning garbage.
    sq = 65536 * 64 + 1
    big_q = torch.zeros(1, sq, 1, 1, 16, device=cuda)
    kk, vv = (torch.zeros(1, 1, 1, 16, device=cuda) for _ in range(2))
    with pytest.raises(RuntimeError, match="launch failed"):
        FA.flash_attention(big_q, kk, vv, causal=False)
    assert FA.flash_attention.launches == before
    torch.cuda.synchronize()                 # the context is still sound
    got = FA.flash_attention(q, k, v)
    _fa_check(got, FA.flash_attention_plain(q, k, v), "float32")


# The bf16 tensor-core instance: head dims 16, 20 (rows of 40 bytes: no
# cp.async), 64, 80 (cp.async, zero-padded to the 128 instance), 128 and
# 256, ragged Sq and Sk, softcap, and inputs whose base pointer is not
# 16-byte aligned; (b, sq, sk, kv, g, dh, causal, softcap, offset).
# offset "row" views q and k one row into a larger buffer, "element" one
# element.
FA_BF16 = [
    (1, 77, 77, 1, 2, 16, True, None, None),
    (1, 130, 200, 1, 1, 20, False, None, "row"),
    (2, 100, 150, 2, 3, 64, True, None, None),
    (1, 300, 300, 2, 2, 64, True, None, "element"),
    (1, 129, 191, 2, 4, 128, True, 30.0, None),
    (1, 200, 330, 1, 4, 256, True, None, None),
    (1, 96, 96, 1, 1, 256, False, 8.0, "element"),
    (1, 70, 90, 2, 2, 80, True, None, None),
]


def _offset_view(t, how):
    """t's values in a view one row (dim 1) or one element into a larger
    contiguous buffer."""
    b = t.shape[0]
    if how == "row":
        assert b == 1
        buf = torch.cat([torch.zeros_like(t[:, :1]), t], dim=1)
        return buf[:, 1:]
    buf = torch.cat([t.new_zeros(1), t.reshape(-1)])
    return buf[1:].view(t.shape)


@pytest.mark.parametrize("case", range(len(FA_BF16)),
                         ids=lambda i: f"bf16_{i}")
def test_flash_attention_bf16_tensor_core_kernel(case, cuda):
    from repro_torch.kernels import flash_attention as FA
    b, sq, sk, kv, g, dh, causal, cap, offset = FA_BF16[case]
    q, k, v = _fa_inputs(b, sq, sk, kv, g, dh, "bfloat16", 40 + case, cuda)
    if offset:
        q, k = _offset_view(q, offset), _offset_view(k, offset)
        assert q.is_contiguous() and q.data_ptr() % 16 != 0
    before = FA.flash_attention.launches
    got = FA.flash_attention(q, k, v, causal=causal, softcap=cap)
    torch.cuda.synchronize()
    assert FA.flash_attention.launches == before + 1
    _fa_check(got, FA.flash_attention_plain(q, k, v, causal=causal,
                                            softcap=cap), "bfloat16")


# The split over K: Sq = 1 and Sq = 16 against long keys, tinyllama's
# heads (KV 4, G 8, Dh 64) and a ragged Sk, in both dtypes; (b, sq, sk,
# causal).
FA_SPLIT = [(1, 1, 2048, False), (1, 16, 4096, False), (2, 16, 1000, True),
            (1, 1, 8192, False)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,sq,sk,causal", FA_SPLIT, ids=lambda x: str(x))
def test_flash_attention_split_path(b, sq, sk, causal, dtype, cuda):
    from repro_torch.kernels import flash_attention as FA
    q, k, v = _fa_inputs(b, sq, sk, 4, 8, 64, dtype, sk + sq, cuda)
    splits = FA.kernel_splits(q, k)
    assert splits == FA._plan_splits(b * 32, sk) > 1
    before = FA.flash_attention.launches
    got = FA.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert FA.flash_attention.launches == before + 1     # split + combine
    _fa_check(got, FA.flash_attention_split_plain(q, k, v, splits=splits,
                                                  causal=causal), dtype)
    _fa_check(got, FA.flash_attention_plain(q, k, v, causal=causal), dtype)
    # Fixed-order combine, no atomics: the same bits on every call.
    assert torch.equal(FA.flash_attention(q, k, v, causal=causal), got)
