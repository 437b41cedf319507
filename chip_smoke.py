#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. environment: torch/CUDA versions, the card's name and power limit;
2. build: nvcc builds every kernel source of ``src/repro_torch/kernels/
   csrc`` for sm_90a (one nvcc per source, in parallel);
3. kernel vs plain: the fused DCL kernel against its plain PyTorch
   version on the card, at every distinct DCL shape of resnet50_dcn_bounded
   at buckets 256 and 512 and batch 4 and at edge geometries (ragged
   output, dilation 2, stride 2), with offsets of which ~18% exceed ±B;
   tolerance ``max|kernel - plain| <= 1e-5 * max|plain|``; times from CUDA
   events, also of the input preparation (padding, weight blocking);
4. serve: full-width resnet50_dcn_bounded (random seeded params, offset
   conv perturbed so taps interpolate) through the port's serving engine
   at buckets 256/512, 4 slots, 8 requests; every request must be ``ok``
   on ``fp32_kernel``, the kernel must launch 12 times per engine step,
   and ``cls``/``box`` must match the plain path on the card within
   ``1e-3 * max|ref|``.  Each bucket's forward is timed with CUDA events.
5. int8 kernels vs plain on the card: the int8 dequant kernel (dcq) and
   the int8 chain kernel (dcc, int8 emission) at every distinct DCL shape
   of both buckets at batch 4, and at edge geometries (ragged output,
   dilation 2 with B = 1.5, stride 2 on an odd extent, fp32 emission, an
   int8 input handed over verbatim), offsets beyond ±B in a share of
   taps; each must equal its plain version exactly (``torch.equal``).
6. int8 serve: the same model, calibrated on the card, served on
   ``int8_chain`` and on ``int8`` (cuDNN deterministic, so every path
   feeds the same offsets); every request ``ok`` on its rung, 12 launches
   of the rung's kernel per step and none of the other two, ``cls``/``box``
   within ``1e-3 * max|ref|`` of the same rung with the plain versions in
   place of the kernels, and the relative error of ``cls`` against
   ``fp32_kernel`` at most 0.1.  The three rungs' forwards are timed per
   bucket in turns (CUDA events), beside their device time from
   ``torch.profiler``.

The kernels line gives ``ms``, ``plain_ms`` and ``bound_ms`` per served
run: each shape's phase-3 (phase-5) time times the launches of that shape
in the run of phase 4 (of the kernel's rung in phase 6), summed.

TF32 is off for every fp32 matmul and convolution.  Without a GPU, or
without the rest of the repository beside it, the script prints no result
and exits 2.  Details go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out" / "chip_smoke.json"

# H100 SXM, NVIDIA's data sheet: fp32 on CUDA cores, int8 on the tensor
# cores (dense), HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_INT8_OPS = 1979e12
PEAK_HBM_BYTES_PER_S = 3.35e12
KERNEL_RTOL = 1e-5
SERVE_RTOL = 1e-3
INT8_VS_FP32_MAX = 0.1      # relative norm error of cls, int8 vs fp32_kernel
BATCH = 4
BUCKETS = "256,512"
K, B = 3, 2.0


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()


def time_ms(fn, *, reps: int, iters: int) -> float:
    """Median over ``reps`` of the mean time of ``iters`` calls (CUDA
    events), after two warm-up calls."""
    import torch
    fn()
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def check_kernel(case: dict, gen) -> dict:
    """Kernel vs plain on one geometry; returns the record."""
    import torch

    from repro_torch.core.tiling import out_hw, smem_bytes
    from repro_torch.kernels import _build, plan
    from repro_torch.kernels.deform_conv_fused import (
        deform_conv_fused_zerocopy, deform_conv_fused_zerocopy_plain)

    n, h, w, c, m = case["n"], case["h"], case["w"], case["c"], case["m"]
    s, d = case["stride"], case["dilation"]
    ho, wo = out_hw(h, w, kernel_size=K, stride=s, dilation=d)
    th, tw, tc, tm = plan.resolve_tiles(n, h, w, c, m, kernel_size=K,
                                        stride=s, dilation=d,
                                        offset_bound=B)
    th, tw = min(th, ho), min(tw, wo)
    x = torch.randn(n, h, w, c, device="cuda", generator=gen)
    off = torch.randn(n, ho, wo, 2 * K * K, device="cuda",
                      generator=gen) * 1.5
    wd = torch.randn(K * K, c, m, device="cuda", generator=gen) \
        / (K * K * c) ** 0.5
    spec = plan.DCSpec(K, s, d, B, th, tw, tc, tm)
    xp, offp, wt = plan.zerocopy_inputs(spec, x, off, wd, th, tw, tc)
    kw = dict(kernel_size=K, stride=s, dilation=d, offset_bound=B,
              tile_h=th, tile_w=tw, tile_c=tc, tile_m=tm)
    y = deform_conv_fused_zerocopy(xp, offp, wt, **kw)
    torch.cuda.synchronize()
    yp = deform_conv_fused_zerocopy_plain(xp, offp, wt, **kw)
    err = (y - yp).abs().max().item()
    scale = yp.abs().max().item()
    lib = _build.load("deform_conv_fused")
    smem_c = lib.dcf_smem_bytes(K, s, d, 2, th, tw, tc)
    smem_py = smem_bytes(th, tw, tc, kernel_size=K, stride=s, dilation=d,
                         offset_bound=B)
    ms = time_ms(lambda: deform_conv_fused_zerocopy(xp, offp, wt, **kw),
                 reps=7, iters=10)
    plain_ms = time_ms(
        lambda: deform_conv_fused_zerocopy_plain(xp, offp, wt, **kw),
        reps=3, iters=3)
    prep_ms = time_ms(lambda: plan.zerocopy_inputs(spec, x, off, wd,
                                                   th, tw, tc),
                      reps=5, iters=10)
    flops = 2 * n * ho * wo * K * K * c * m
    nbytes = 4 * (n * h * w * c + n * ho * wo * 2 * K * K + K * K * c * m
                  + n * ho * wo * m)
    bound_ms = max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES_PER_S) \
        * 1e3
    rec = dict(case, ho=ho, wo=wo, tiles=[th, tw, tc, tm],
               smem_bytes=smem_c, max_abs_err=err, max_abs_plain=scale,
               clamped_share=(off.abs() > B).float().mean().item(),
               ms=ms, plain_ms=plain_ms, prep_ms=prep_ms,
               bound_ms=bound_ms,
               bound_by="operations" if flops / PEAK_FP32_FLOPS
               >= nbytes / PEAK_HBM_BYTES_PER_S else "bytes",
               flops=flops, bytes=nbytes)
    ok = err <= KERNEL_RTOL * scale and smem_c == smem_py
    print(f"  {case['label']:<28} tiles {th}x{tw} tc={tc} tm={tm} "
          f"smem={smem_c} err={err:.3e} (max|plain|={scale:.3f}) "
          f"kernel={ms:.4f} ms plain={plain_ms:.3f} ms "
          f"prep={prep_ms:.4f} ms bound={bound_ms:.4f} ms "
          f"per_step={case.get('per_step', {})} {'ok' if ok else 'FAIL'}")
    if smem_c != smem_py:
        fail(f"{case['label']}: shared memory {smem_c} (kernel) != "
             f"{smem_py} (chooser)")
    if err > KERNEL_RTOL * scale:
        fail(f"{case['label']}: max|kernel - plain| = {err} exceeds "
             f"{KERNEL_RTOL} * {scale}")
    return rec


def perturb_offsets(params, seed: int):
    """Seeded offset-conv weights and biases for every DCL, scaled so the
    offsets are a few pixels and a share of them exceeds ±B."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    for block in params.values():
        if "dcl" not in block:
            continue
        dcl = block["dcl"]
        c = dcl["w_offset"].shape[2]
        std = 1.0 / (K * K * c * 0.5) ** 0.5
        dcl["w_offset"] = (torch.randn(dcl["w_offset"].shape, generator=gen)
                           * std).to(dcl["w_offset"].device)
        dcl["b_offset"] = (torch.randn(dcl["b_offset"].shape, generator=gen)
                           * 0.5).to(dcl["b_offset"].device)
    return params


def serve(record: dict) -> tuple[int, dict]:
    import numpy as np
    import torch

    from repro_torch.configs.resnet50_dcn import CONFIG_BOUNDED
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launch
    from repro_torch.models import resnet_dcn as R

    cfg = dataclasses.replace(CONFIG_BOUNDED, use_kernel=True)
    print(f"  config {cfg.name}: stages {cfg.stage_sizes}, widths "
          f"{cfg.widths}, {cfg.num_dcn} DCLs, B={cfg.offset_bound}, "
          f"{cfg.num_classes} classes")
    params = perturb_offsets(R.init_params(cfg, seed=0, device="cuda"), 1)
    args = serve_args(cfg, "fp32_kernel")
    launch.serve_detection(cfg, args, params=params)        # warm-up

    reset_counts()
    engine, images, seconds = launch.serve_detection(cfg, args,
                                                     params=params)
    counts = read_counts()
    launches = counts["deform_conv_fused"]
    if counts["deform_conv_fused_q"] or counts["deform_conv_chain"]:
        fail(f"the fp32_kernel run launched an int8 kernel: {counts}")
    print(launch.report(engine, seconds))
    reqs = engine.completed
    n_dcl = sum(cfg.is_dcn(i) for i in range(cfg.total_blocks))
    bad = [r for r in reqs if r.outcome != "ok" or r.ladder != "fp32_kernel"
           or r.degraded]
    if len(reqs) != 8 or bad:
        fail(f"requests not all ok on fp32_kernel: "
             f"{[(r.uid, r.outcome, r.ladder, r.degraded, r.error) for r in reqs]}")
    if launches != n_dcl * engine.steps or launches == 0:
        fail(f"kernel launched {launches} times in {engine.steps} steps; "
             f"expected {n_dcl} per step")
    print(f"  kernel launches in the served run: {launches} = {n_dcl} x "
          f"{engine.steps} steps")

    # Plain path on the card, same batches; clamp share from the kernel
    # path's offsets (these launches are not counted).
    ref_cfg = dataclasses.replace(cfg, use_kernel=False)
    worst = 0.0
    clamped = []
    real_deform_conv = ops.deform_conv

    def recording_deform_conv(x, offsets, w, **kw):
        clamped.append((offsets.abs() > B).float().mean().item())
        return real_deform_conv(x, offsets, w, **kw)

    for bucket in sorted({r.bucket for r in reqs}):
        rows = [r for r in reqs if r.bucket == bucket]
        x = engine.batch_array(bucket, rows)
        with torch.no_grad():
            ref, _ = R.forward(params, ref_cfg, x, device="cuda")
            ops.deform_conv = recording_deform_conv
            try:
                R.forward(params, cfg, x, device="cuda")
            finally:
                ops.deform_conv = real_deform_conv
        for key in ("cls", "box"):
            r_np = ref[key].cpu().numpy()
            got = np.stack([r.result[key] for r in rows])
            err = float(np.abs(got - r_np[:len(rows)]).max())
            scale = float(np.abs(r_np).max())
            rel = err / scale
            worst = max(worst, rel)
            print(f"  bucket {bucket} {key}: max|kernel path - plain path| "
                  f"= {err:.3e} (max|ref|={scale:.3f}, rel {rel:.2e})")
            if not np.isfinite(got).all() or err > SERVE_RTOL * scale:
                fail(f"bucket {bucket} {key} off the plain path: {err} > "
                     f"{SERVE_RTOL} * {scale}")
    # Where a step's time goes: each bucket's forward on the kernel path
    # and on the plain path (CUDA events), beside the DCL kernels' own
    # time from phase 3.
    fwd_ms: dict[str, dict[str, float]] = {}
    for bucket in sorted({r.bucket for r in reqs}):
        xb = engine.batch_array(bucket, [r for r in reqs
                                         if r.bucket == bucket])
        with torch.no_grad():
            fwd_ms[str(bucket)] = {
                name: time_ms(lambda c=c: R.forward(params, c, xb,
                                                    device="cuda"),
                              reps=5, iters=2)
                for name, c in (("kernel_path", cfg),
                                ("plain_path", ref_cfg))}
        print(f"  {bucket}-bucket forward, batch {BATCH}: kernel path "
              f"{fwd_ms[str(bucket)]['kernel_path']:.3f} ms, plain path "
              f"{fwd_ms[str(bucket)]['plain_path']:.3f} ms")
    steps_per_bucket = engine.telemetry()["steps_per_bucket"]
    device_ms = sum(fwd_ms[b]["kernel_path"] * n
                    for b, n in steps_per_bucket.items())
    lats = sorted(r.latency_s() for r in reqs)
    share = statistics.mean(clamped)
    if share <= 0.0:
        fail("no offset exceeded ±B: the serve run tests no clamp")
    record["serve"] = dict(
        requests=len(reqs), steps=engine.steps, launches=launches,
        steps_per_bucket=steps_per_bucket, seconds=seconds,
        images_per_s=len(reqs) / seconds,
        p50_latency_ms=lats[len(lats) // 2] * 1e3,
        max_latency_ms=lats[-1] * 1e3, clamped_share=share,
        worst_rel_err=worst, cls_shape=list(reqs[0].result["cls"].shape),
        forward_ms=fwd_ms, forward_ms_in_run=device_ms)
    print(f"  clamped offsets {share:.3f}; smoke readings of {len(reqs)} "
          f"requests in {engine.steps} steps (not a serving benchmark): "
          f"wall {seconds * 1e3:.2f} ms, of which the steps' forwards "
          f"{device_ms:.2f} ms (CUDA events), p50 latency "
          f"{record['serve']['p50_latency_ms']:.2f} ms, "
          f"{record['serve']['images_per_s']:.2f} images/s")
    return launches, record, params


def serve_args(cfg, rung: str):
    from repro_torch.launch import serve as launch
    return launch.build_parser().parse_args(
        ["--arch", cfg.name, "--buckets", BUCKETS, "--requests", "8",
         "--slots", str(BATCH), "--device", "cuda", "--seed", "0",
         "--quant", rung])


def counted():
    from repro_torch.kernels import deform_conv_q as Q
    from repro_torch.kernels.deform_conv_fused import \
        deform_conv_fused_zerocopy
    return {"deform_conv_fused": deform_conv_fused_zerocopy,
            "deform_conv_fused_q": Q.deform_conv_fused_zerocopy_q,
            "deform_conv_chain": Q.deform_conv_fused_zerocopy_chain}


def reset_counts() -> None:
    for fn in counted().values():
        fn.launches = 0


def read_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in counted().items()}


class plain_kernels:
    """Within the block the int8 plans call the plain versions in place of
    the int8 kernels (the same rung's plain path)."""

    def __enter__(self):
        from repro_torch.kernels import deform_conv_q as Q
        from repro_torch.kernels import plan
        self.saved = (plan.deform_conv_fused_zerocopy_q,
                      plan.deform_conv_fused_zerocopy_chain)
        plan.deform_conv_fused_zerocopy_q = \
            Q.deform_conv_fused_zerocopy_q_plain
        plan.deform_conv_fused_zerocopy_chain = \
            Q.deform_conv_fused_zerocopy_chain_plain

    def __exit__(self, *exc):
        from repro_torch.kernels import plan
        (plan.deform_conv_fused_zerocopy_q,
         plan.deform_conv_fused_zerocopy_chain) = self.saved


def device_profile(fn, top: int = 6) -> tuple[float | None, list]:
    """torch.profiler over one call of ``fn`` (after one warm-up): the
    device time summed over its kernels and copies (ms), None when the
    profiler saw none, and the ``top`` entries by device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))
    # Device-side events only (kernels, copies, sets): the host ops that
    # launched them carry the same time again.
    events = sorted((e for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=dev_us, reverse=True)
    total = sum(dev_us(e) for e in events) / 1e3
    return (total or None), [(e.key[:60], round(dev_us(e) / 1e3, 4))
                             for e in events[:top]]


def check_q_kernel(case: dict, gen) -> dict:
    """An int8 kernel vs its plain version on one geometry (``torch.equal``
    or fail); returns the record."""
    import torch

    from repro_torch.core.deform_conv import conv2d
    from repro_torch.core.tiling import out_hw, q_smem_bytes
    from repro_torch.kernels import deform_conv_q as Q
    from repro_torch.kernels import plan
    from repro_torch.quant.qtypes import compute_scale, quantize_values

    kind, emit = case["kind"], case.get("emit", "int8")
    chain = kind == "dcc"
    n, h, w, c, m = case["n"], case["h"], case["w"], case["c"], case["m"]
    s, d, b = case["stride"], case["dilation"], case.get("bound", B)
    k2 = K * K
    ho, wo = out_hw(h, w, kernel_size=K, stride=s, dilation=d)
    th, tw, tc, tm = plan.resolve_tiles(
        n, h, w, c, m, kernel_size=K, stride=s, dilation=d,
        offset_bound=b, dtype="int8_chain" if chain else "int8")
    th, tw = min(th, ho), min(tw, wo)
    x = torch.randn(n, h, w, c, device="cuda", generator=gen)
    wd = torch.randn(k2, c, m, device="cuda", generator=gen) / (k2 * c) ** 0.5
    sx, sw = compute_scale(x), compute_scale(wd, axis=-1)
    xq, wq = quantize_values(x, sx), quantize_values(wd, sw)
    xp = plan.pad_zerocopy(xq, kernel_size=K, stride=s, dilation=d,
                           offset_bound=b, tile_h=th, tile_w=tw, ho=ho,
                           wo=wo)
    kw = dict(kernel_size=K, stride=s, dilation=d, offset_bound=b,
              tile_h=th, tile_w=tw, tile_c=tc, tile_m=tm)
    lib = Q.load_kernel()
    if chain:
        woff = torch.randn(k2, c, 2 * k2, device="cuda", generator=gen)
        woq = quantize_values(woff, compute_scale(woff, axis=-1))
        # Offset-conv sums of std ~1.5 px once dequantized, so a share of
        # the taps clamps; read back through an exact float64 conv.
        acc = conv2d(xq.double(), woq.double().reshape(K, K, c, 2 * k2),
                     stride=s, dilation=d)
        off_scale = torch.full((2 * k2,), 1.5 / acc.std().item(),
                               device="cuda")
        off_bias = torch.randn(2 * k2, device="cuda", generator=gen) * 0.5
        off = acc.float() * off_scale + off_bias
        # Emission of std ~40 on the int8 grid (rounds and clips).
        y_std = (k2 * c) ** 0.5 * 0.8 * xq.float().std() * wq.float().std()
        out_scale = torch.full((m,), 40.0 / y_std.item(), device="cuda")
        out_bias = torch.randn(m, device="cuda", generator=gen)
        args = (xp, plan.tile_weights(wq, c), plan.tile_weights(woq, c),
                off_scale, off_bias, out_scale, out_bias)
        kw.update(emit=emit, ho=ho, wo=wo)
        fn, plain = (Q.deform_conv_fused_zerocopy_chain,
                     Q.deform_conv_fused_zerocopy_chain_plain)
        smem_c = lib.dcc_smem_bytes(K, s, d, math.ceil(b), th, tw, tc)
    else:
        off = torch.randn(n, ho, wo, 2 * k2, device="cuda",
                          generator=gen) * 1.5
        args = (xp, off, plan.tile_weights(wq, tc),
                (sx * sw).reshape(m).contiguous())
        fn, plain = (Q.deform_conv_fused_zerocopy_q,
                     Q.deform_conv_fused_zerocopy_q_plain)
        smem_c = lib.dcq_smem_bytes(K, s, d, math.ceil(b), th, tw, tc)
    smem_py = q_smem_bytes(th, tw, tc, kernel_size=K, stride=s, dilation=d,
                           offset_bound=b, chain=chain)
    y = fn(*args, **kw)
    torch.cuda.synchronize()
    yp = plain(*args, **kw)
    equal = torch.equal(y, yp)
    err = (y.float() - yp.float()).abs().max().item()
    if case.get("verbatim"):
        # ops.deform_conv_chain: an int8 input on the x_scale grid is taken
        # as it is and gives the fp32 head's emission.
        from repro_torch.kernels import ops
        ck = dict(kernel_size=K, stride=s, dilation=d, offset_bound=b,
                  x_scale=sx, w_scale=sw.reshape(m), y_scale=0.5 * sx,
                  emit="int8", device="cuda")
        woff_f = woq.float()
        head = ops.deform_conv_chain(x, wd, woff_f, off_bias, out_bias, **ck)
        verbatim = ops.deform_conv_chain(xq, wd, woff_f, off_bias,
                                         out_bias, **ck)
        with plain_kernels():
            want = ops.deform_conv_chain(xq, wd, woff_f, off_bias,
                                         out_bias, **ck)
        equal = equal and torch.equal(head, verbatim) \
            and torch.equal(verbatim, want)
    ms = time_ms(lambda: fn(*args, **kw), reps=7, iters=10)
    plain_ms = time_ms(lambda: plain(*args, **kw), reps=3, iters=2)
    ops_n = 2 * n * ho * wo * k2 * c * (m + (2 * k2 if chain else 0))
    out_b = 1 if emit == "int8" and chain else 4
    nbytes = (n * h * w * c + k2 * c * m + n * ho * wo * m * out_b + 4 * m
              + (k2 * c * 2 * k2 + 4 * (4 * k2 + m) if chain
                 else 4 * n * ho * wo * 2 * k2))
    bound_ms = max(ops_n / PEAK_INT8_OPS, nbytes / PEAK_HBM_BYTES_PER_S) * 1e3
    rec = dict(case, ho=ho, wo=wo, tiles=[th, tw, tc, tm], smem_bytes=smem_c,
               equal=equal, max_abs_err=err,
               max_abs_plain=yp.float().abs().max().item(),
               clamped_share=(off.abs() > b).float().mean().item(),
               ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
               bound_by="operations" if ops_n / PEAK_INT8_OPS
               >= nbytes / PEAK_HBM_BYTES_PER_S else "bytes",
               flops=ops_n, bytes=nbytes)
    print(f"  {kind} {case['label']:<28} tiles {th}x{tw} tc={tc} tm={tm} "
          f"smem={smem_c} equal={equal} err={err:.1e} "
          f"clamped={rec['clamped_share']:.3f} kernel={ms:.4f} ms "
          f"plain={plain_ms:.3f} ms bound={bound_ms:.5f} ms "
          f"per_step={case.get('per_step', {})} "
          f"{'ok' if equal and smem_c == smem_py else 'FAIL'}")
    if smem_c != smem_py:
        fail(f"{kind} {case['label']}: shared memory {smem_c} (kernel) != "
             f"{smem_py} (chooser)")
    if not equal:
        fail(f"{kind} {case['label']}: kernel != plain version "
             f"(max abs difference {err})")
    return rec


def serve_int8(record: dict, params) -> dict[str, int]:
    """Phase 6: calibrate on the card, serve on int8_chain and on int8."""
    import numpy as np
    import torch

    from repro_torch.configs.resnet50_dcn import CONFIG_BOUNDED
    from repro_torch.launch import serve as launch
    from repro_torch.models import resnet_dcn as R
    from repro_torch.quant.calibrate import scale_table_on

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    cfg = dataclasses.replace(CONFIG_BOUNDED, use_kernel=True)
    n_dcl = sum(cfg.is_dcn(i) for i in range(cfg.total_blocks))
    t0 = time.monotonic()
    table = launch.calibrate(cfg, params, serve_args(cfg, "int8_chain"))
    print(f"  calibrated {len(table) - 1} DCLs on the card in "
          f"{time.monotonic() - t0:.1f} s (absmax, 2 images per bucket)")
    scales = scale_table_on(table, "cuda")      # as the engine holds them
    own = {"int8_chain": "deform_conv_chain", "int8": "deform_conv_fused_q"}
    launches = {}
    batches = {}
    record["serve_int8"] = {}
    fwd_cfgs = {rung: dataclasses.replace(cfg, quant=q)
                for rung, q in (("int8_chain", "int8_chain"),
                                ("int8", "int8"), ("fp32_kernel", "none"))}
    for rung in ("int8_chain", "int8"):
        args = serve_args(cfg, rung)
        launch.serve_detection(cfg, args, params=params,
                               scale_table=table)                # warm-up
        reset_counts()
        engine, _, seconds = launch.serve_detection(
            cfg, args, params=params, scale_table=table)
        counts = read_counts()
        print(launch.report(engine, seconds))
        reqs = engine.completed
        bad = [r for r in reqs if r.outcome != "ok" or r.ladder != rung
               or r.degraded]
        if len(reqs) != 8 or bad:
            fail(f"requests not all ok on {rung}: "
                 f"{[(r.uid, r.outcome, r.ladder, r.error) for r in reqs]}")
        want = {name: (n_dcl * engine.steps if name == own[rung] else 0)
                for name in counts}
        if counts != want or counts[own[rung]] == 0:
            fail(f"{rung}: launches {counts} in {engine.steps} steps; "
                 f"expected {want}")
        print(f"  launches in the {rung} run: {counts} ({n_dcl} x "
              f"{engine.steps} steps of {own[rung]})")
        launches[own[rung]] = counts[own[rung]]
        worst = 0.0
        rel_fp32 = []
        rel_ref = []
        rel_noise = []
        for bucket in sorted({r.bucket for r in reqs}):
            rows = [r for r in reqs if r.bucket == bucket]
            x = engine.batch_array(bucket, rows)
            with torch.no_grad():
                with plain_kernels():
                    plain, _ = R.forward(params, fwd_cfgs[rung], x,
                                         quant_scales=scales, device="cuda")
                fp32, _ = R.forward(params, fwd_cfgs["fp32_kernel"], x,
                                    device="cuda")
                ref, _ = R.forward(
                    params, dataclasses.replace(fwd_cfgs[rung],
                                                use_kernel=False),
                    x, quant_scales=scales, device="cuda")
                # How far fp32 itself moves under a 1e-3 relative input
                # perturbation: the model's own sensitivity, for scale.
                noise = torch.randn(x.shape, generator=torch.Generator(
                    device="cuda").manual_seed(5), device="cuda")
                fp32_noisy, _ = R.forward(params, fwd_cfgs["fp32_kernel"],
                                          x * (1 + 1e-3 * noise),
                                          device="cuda")
            for key in ("cls", "box"):
                p_np = plain[key].cpu().numpy()[:len(rows)]
                got = np.stack([r.result[key] for r in rows])
                err = float(np.abs(got - p_np).max())
                scale = float(np.abs(p_np).max())
                worst = max(worst, err / scale)
                print(f"  {rung} bucket {bucket} {key}: max|kernel path - "
                      f"plain path| = {err:.3e} (max|ref|={scale:.3f})")
                if not np.isfinite(got).all() or err > SERVE_RTOL * scale:
                    fail(f"{rung} bucket {bucket} {key} off the plain path: "
                         f"{err} > {SERVE_RTOL} * {scale}")
            got = np.stack([r.result["cls"] for r in rows])
            for into, other, base in ((rel_fp32, fp32, got),
                                      (rel_ref, ref, got),
                                      (rel_noise, fp32, fp32_noisy)):
                o = other["cls"].cpu().numpy()[:len(rows)]
                if not isinstance(base, np.ndarray):
                    base = base["cls"].cpu().numpy()[:len(rows)]
                into.append(float(np.linalg.norm(base - o)
                                  / np.linalg.norm(o)))
            print(f"  {rung} bucket {bucket} cls: relative error vs "
                  f"fp32_kernel {rel_fp32[-1]:.4f}, vs the fake-quant "
                  f"reference path {rel_ref[-1]:.2e}; fp32_kernel under a "
                  f"1e-3 input perturbation moves {rel_noise[-1]:.4f}")
            if rel_fp32[-1] > INT8_VS_FP32_MAX:
                fail(f"{rung} bucket {bucket}: cls {rel_fp32[-1]:.4f} from "
                     f"fp32_kernel, above {INT8_VS_FP32_MAX}")
            batches[bucket] = x
        lats = sorted(r.latency_s() for r in reqs)
        record["serve_int8"][rung] = dict(
            requests=len(reqs), steps=engine.steps, launches=counts,
            steps_per_bucket=engine.telemetry()["steps_per_bucket"],
            seconds=seconds, images_per_s=len(reqs) / seconds,
            p50_latency_ms=lats[len(lats) // 2] * 1e3,
            worst_rel_err_vs_plain=worst, cls_rel_err_vs_fp32=rel_fp32,
            cls_rel_err_vs_reference=rel_ref,
            fp32_cls_moves_under_1e3_input_noise=rel_noise)
    # Where a step's time goes: each bucket's forward on the three rungs,
    # timed in turns (CUDA events), and each one's device time from
    # torch.profiler.
    record["forward_ms"] = {}
    for bucket, x in sorted(batches.items()):
        fns = {name: (lambda c=c: R.forward(params, c, x, quant_scales=scales,
                                            device="cuda"))
               for name, c in fwd_cfgs.items()}
        # The same rung reading the JSON table's floats, as a caller who
        # does not put the table on the card would.
        fns["int8_chain_host_scales"] = lambda: R.forward(
            params, fwd_cfgs["int8_chain"], x, quant_scales=table,
            device="cuda")
        row: dict = {}
        with torch.no_grad():
            for name, fn in fns.items():
                row[f"{name}_device_busy"], row[f"{name}_top"] = \
                    device_profile(fn)
            turns: dict[str, list[float]] = {name: [] for name in fns}
            for _ in range(7):
                for name, fn in fns.items():
                    turns[name].append(time_ms(fn, reps=1, iters=3))
        for name in fns:
            row[name] = statistics.median(turns[name])
            row[f"{name}_turns"] = turns[name]
            busy = row[f"{name}_device_busy"]
            share = "not measured" if busy is None \
                else f"{1 - busy / row[name]:.0%}"
            print(f"  {bucket}-bucket forward, batch {BATCH}, {name}: "
                  f"median {row[name]:.3f} ms of 7 turns (min "
                  f"{min(turns[name]):.3f}), device busy "
                  f"{busy if busy is None else round(busy, 3)} ms by "
                  f"torch.profiler, idle {share}; top "
                  f"{row[f'{name}_top'][:4]}")
        record["forward_ms"][str(bucket)] = row
    record["scale_table"] = table
    return launches


def per_run(shapes: list[dict], steps_per_bucket: dict, launches: int,
            peak: float, what: str) -> tuple[dict, str]:
    """Sum of each main-path shape's time (and work) times its launches in
    the served run; fails unless the shapes account for every launch."""
    for r in shapes:
        r["launches_in_run"] = sum(n * steps_per_bucket.get(b, 0)
                                   for b, n in r["per_step"].items())
    if sum(r["launches_in_run"] for r in shapes) != launches:
        fail(f"{what}: the shapes account for "
             f"{sum(r['launches_in_run'] for r in shapes)} launches, the "
             f"served run made {launches}")
    run = {k: sum(r[k] * r["launches_in_run"] for r in shapes)
           for k in ("ms", "plain_ms", "flops", "bytes")}
    run["bound_ms"] = max(run["flops"] / peak,
                          run["bytes"] / PEAK_HBM_BYTES_PER_S) * 1e3
    bound_by = "operations" if run["flops"] / peak \
        >= run["bytes"] / PEAK_HBM_BYTES_PER_S else "bytes"
    return run, bound_by


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside the script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    t_start = time.monotonic()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smi()
    record: dict = {"card": card}

    print("== 1. environment")
    print(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} device(s)")
    print(f"  nvidia-smi: {card}")
    print(f"  TF32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn {torch.backends.cudnn.allow_tf32}")

    print("== 2. build")
    from repro_torch.kernels import _build
    t0 = time.monotonic()
    built = _build.build_all()
    print(f"  nvcc {' '.join(_build.NVCC_FLAGS)}: {sorted(built)} in "
          f"{time.monotonic() - t0:.1f} s")
    for name, log in _build.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    record["build_s"] = time.monotonic() - t0

    print("== 3. kernel vs plain on the card")
    from repro_torch.configs.resnet50_dcn import CONFIG_BOUNDED
    from repro_torch.serve import bucket_layer_dims
    # {shape: {bucket: DCLs of that shape in one step of the bucket}}
    per_step: dict[tuple, dict[str, int]] = {}
    for bucket in BUCKETS.split(","):
        for dims in bucket_layer_dims(CONFIG_BOUNDED, int(bucket)).values():
            key = (dims["h"], dims["w"], dims["c"], dims["m"],
                   dims["stride"])
            counts = per_step.setdefault(key, {})
            counts[bucket] = counts.get(bucket, 0) + 1
    cases = [dict(label=f"{h}x{w}x{c}->{m} s{s}", n=BATCH, h=h, w=w, c=c,
                  m=m, stride=s, dilation=1, per_step=cnt)
             for (h, w, c, m, s), cnt in per_step.items()]
    cases += [
        dict(label="ragged 17x23x64->64 s1", n=2, h=17, w=23, c=64, m=64,
             stride=1, dilation=1),
        dict(label="dilation2 20x20x64->64", n=2, h=20, w=20, c=64, m=64,
             stride=1, dilation=2),
        dict(label="ragged 15x15x32->48 s2", n=1, h=15, w=15, c=32, m=48,
             stride=2, dilation=1),
    ]
    gen = torch.Generator(device="cuda").manual_seed(0)
    record["shapes"] = [check_kernel(c, gen) for c in cases]
    main_path = [r for r in record["shapes"] if r.get("per_step")]
    print("  no single PyTorch call computes the bounded deformable conv, "
          "so there is no library time to compare with")

    print("== 4. serve")
    launches, record, params = serve(record)
    run, bound_by = per_run(main_path, record["serve"]["steps_per_bucket"],
                            launches, PEAK_FP32_FLOPS, "deform_conv_fused")
    run["prep_ms"] = sum(r["prep_ms"] * r["launches_in_run"]
                         for r in main_path)
    record["run"] = run
    kernels = {"kernels": [{
        "name": "deform_conv_fused",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/deform_conv_fused.cu",
        "replaces": "src/repro/kernels/band_pipeline.py:644",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in record["shapes"]),
        "ms": run["ms"],
        "plain_ms": run["plain_ms"],
        "bound_ms": run["bound_ms"],
        "bound_by": bound_by,
        "library_ms": None,
    }]}
    fwd = record["serve"]["forward_ms_in_run"]
    print(f"  (ms, plain_ms and bound_ms are per served run: the sum over "
          f"its {launches} DCL launches, {run['ms'] / fwd:.0%} of its "
          f"steps' {fwd:.3f} ms of forward; input preparation "
          f"{run['prep_ms']:.3f} ms)")

    print("== 5. int8 kernels vs plain on the card (exact)")
    q_cases = []
    for kind in ("dcq", "dcc"):
        q_cases += [dict(kind=kind, label=f"{h}x{w}x{c}->{m} s{s}", n=BATCH,
                         h=h, w=w, c=c, m=m, stride=s, dilation=1,
                         per_step=cnt)
                    for (h, w, c, m, s), cnt in per_step.items()]
        q_cases += [
            dict(kind=kind, label="ragged 17x23x64->64 s1", n=2, h=17, w=23,
                 c=64, m=64, stride=1, dilation=1),
            dict(kind=kind, label="dilation2 B1.5 20x20x64->64", n=2, h=20,
                 w=20, c=64, m=64, stride=1, dilation=2, bound=1.5),
            dict(kind=kind, label="odd s2 15x15x32->48", n=1, h=15, w=15,
                 c=32, m=48, stride=2, dilation=1),
        ]
    q_cases += [
        dict(kind="dcc", label="emit fp32 32x32x128->128", n=BATCH, h=32,
             w=32, c=128, m=128, stride=1, dilation=1, emit="fp32"),
        dict(kind="dcc", label="int8 input verbatim 16x16x64", n=2, h=16,
             w=16, c=64, m=64, stride=1, dilation=1, verbatim=True),
    ]
    record["q_shapes"] = [check_q_kernel(c, gen) for c in q_cases]
    print("  no single PyTorch call computes either int8 function, so "
          "there is no library time to compare with")

    print("== 6. int8 serve")
    q_launches = serve_int8(record, params)
    sources = {"deform_conv_fused_q": ("dcq", "int8", 74),
               "deform_conv_chain": ("dcc", "int8_chain", 108)}
    for name, (kind, rung, line) in sources.items():
        shapes = [r for r in record["q_shapes"]
                  if r["kind"] == kind and r.get("per_step")]
        run_q, by = per_run(
            shapes, record["serve_int8"][rung]["steps_per_bucket"],
            q_launches[name], PEAK_INT8_OPS, name)
        record[f"run_{name}"] = run_q
        kernels["kernels"].append({
            "name": name,
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/deform_conv_q.cu",
            "replaces": f"src/repro/kernels/band_pipeline.py:644 (via "
                        f"src/repro/kernels/deform_conv_q.py:{line})",
            "launches": q_launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in record["q_shapes"]
                               if r["kind"] == kind),
            "ms": run_q["ms"],
            "plain_ms": run_q["plain_ms"],
            "bound_ms": run_q["bound_ms"],
            "bound_by": by,
            "library_ms": None,
        })
        print(f"  {name} per served {rung} run: {q_launches[name]} launches, "
              f"kernel {run_q['ms']:.3f} ms, plain {run_q['plain_ms']:.3f} "
              f"ms, bound {run_q['bound_ms']:.4f} ms ({by})")

    record["kernels"] = kernels["kernels"]
    record["seconds"] = time.monotonic() - t_start
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps(record, indent=2))
    print(f"  details in {OUT.relative_to(ROOT)}; "
          f"{record['seconds']:.0f} s in all")
    print(card)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
