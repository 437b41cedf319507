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

7. backward kernel vs plain on the card: the fused backward (TPU kernel 2)
   at the five distinct DCL shapes of a training step of
   resnet50_dcn_bounded at batch 8 and 512, and at edge geometries
   (ragged output, dilation 2 with B = 1.5, stride 2 on an odd extent;
   every case has tile_c < C), offsets beyond ±B in a share of taps;
   tolerance ``max|kernel - plain| <= 1e-4 * max|plain|`` for each of dx,
   d_offsets and dw (fp32 atomics reorder the sums); the autograd function
   on the card against autograd through the plain forward, same
   tolerance; both kernels' shared memory against the chooser's mirrors;
   times from CUDA events, each sub-kernel's from ``torch.profiler``.
   Each case prints its plan (C groups, the d_weights channel width, the
   instance: pixel lanes, mma tiles a warp, k-split, 16-byte or
   element-wise loads) and two bounds with the kernel's share of each:
   fp32 on the CUDA cores and the kernel's own 3xTF32 products at the
   TF32 rate (the lower is the row's bound).  Kernel 2's time a training
   step (the five shapes times their DCLs a step) is printed beside the
   36.876 ms of its CUDA-core design (``PERF.md`` section 6) and half of
   it, 18.4 ms; no gate on time.
8. train: full-width resnet50_dcn_bounded through
   ``launch.train.train_detection`` for 6 steps (batch 8, 512x512, Eq. 5
   at lambda = 0.005, offset convs perturbed as in phase 4, cuDNN
   deterministic); every loss finite, no step skipped, 12 launches of the
   forward kernel and 12 of the backward kernel per step and none of the
   int8 kernels; step 0's loss within 1e-4 relative of the same step with
   the plain versions in place; its gradients within a relative norm of
   1e-3 of the same step with the plain backward in place, and, with both
   plain versions in place, within the plain path's own spread (see
   ``train``); 4 steps plus a resumed run to 6 within a relative norm of
   1e-4 of the uninterrupted run (params).  Step time (host clock
   and CUDA events), its forward/backward split and the device-busy share
   from ``torch.profiler``, and kernel 2's share of the device time.

9. sampling, banded forward and matmul kernels vs plain on the card:
   kernel 1b (zero-copy sampling) and kernel 3 (banded sampling) at the
   five DCL shapes of the 512 bucket at batch 4 and at a ragged H and a
   dilation-2 case, within 1e-6 absolute, beside the time of
   ``F.grid_sample`` computing the same function (held to the plain
   version within 1e-5 * max|plain|); kernel 4 (the banded fused forward)
   at every distinct DCL shape of both buckets and the same two edge
   cases, within 1e-5 * max|plain|; kernel 5 (matmul) at 256^3, 512^3,
   4096^3 and 257x129x65 in fp32 (1e-5 * max|plain|) and 512^3 and
   4096^3 in bf16 (one bf16 step, 2^-7 * max|plain|), beside
   ``torch.matmul``, each case naming the instance it ran (tile, aligned
   16-byte or element-wise loads).  Then the
   entry points as a user calls them: ``ops.deform_sample`` on both
   dataflows and ``ops.deform_conv(dataflow=...)`` on both at the five
   shapes (sample + einsum within 1e-5 * max|fused| of the fused output)
   and ``ops.matmul`` at the six matmul cases, counting launches.
10. serve banded: phase 4's model and requests with ``dataflow="banded"``
   on ``fp32_kernel``; every request ``ok``, 12 launches of kernel 4 per
   step and none of 1a, ``cls``/``box`` within ``1e-3 * max|ref|`` of the
   plain path and within ``1e-4 * max|zc|`` of phase 4's zero-copy
   results for the same requests; forwards of both dataflows timed in
   turns.
11. train banded: phase 8's settings with ``dataflow="banded"`` for 2
   steps; 12 launches of kernel 4 and 12 of kernel 2 per step, none of
   1a; losses finite, no step skipped; step 0's loss within 1e-5 relative
   of phase 8's zero-copy step 0 and its gradients within phase 8's gate
   (the plain path's own spread) of the plain path's; step time, device
   idle share and kernel 2's share of the device time.

12. flash attention (kernel 6) vs plain on the card: the six cases of
   ``tests/test_flash_attention.py`` in fp32 and bf16 (tolerance
   ``atol = rtol`` = 2e-5 / 2e-2, elementwise); tinyllama's prefill heads
   (KV 4, G 8, Dh 64, causal) at (B, S) = (1, 512), (4, 512), (1, 2048),
   (4, 2048), (1, 4096) in bf16 and (1, 2048) in fp32, also against the
   LM's ``attention(impl="dense")`` (3e-5 in fp32); deepseek-7b's MHA and
   glm4-9b's GQA heads (Dh 128) at (1, 2048) in bf16 and fp32, and
   recurrentgemma-9b's MQA heads (Dh 256) at (1, 2048) in both, the fp32
   ones also against ``attention(impl="dense")``; softcap 30 at (1, 1024);
   cross shapes Sq=1/Sk=2048 and Sq=100/Sk=1000; (1, 8192) fp32 causal,
   also against ``attention(impl="chunked")`` (3e-5); three decode-like
   cross cases at tinyllama's heads that take the split over K (bf16
   Sq=1/Sk=8192 and Sq=16/Sk=4096, fp32 Sq=1/Sk=2048), summed apart so
   the bf16 totals stay on the 15 bf16 cases before them.  Each case prints
   its split count, every split case is also held to
   ``flash_attention_split_plain`` with the same count (and prints the
   combine kernel's share of its device time), every bf16 case is also
   held to a relative L2 error of 1e-2 against each plain version, and
   each prints
   the kernel's, the plain version's and ``F.scaled_dot_product_attention``'s
   time (CUDA events, median; SDPA held to the plain version within the
   same tolerance; none for softcap) beside its bound and error, and the
   kernel's time with the calls queued behind a busy device (the small
   cases' back-to-back time is the host's launch path); then
   every case once through ``flash_attention`` as a user calls it, with
   one launch per case counted (the split kernel and its combine are
   one).
13. LM serving at full width: tinyllama-1.1b (22 layers, d 2048, vocab
   32000, bf16 compute on fp32 params from seed 0) (a) through the
   launcher's ``serve_lm`` with its defaults (8 requests of 4-12 tokens,
   4 slots, cache 128, 16 new tokens); (b) through the ``ServingEngine``:
   8 prompts of 128-1024 tokens, 32 new tokens, 4 slots, cache 2048; each
   request's served bf16 logits are held to a teacher-forced
   ``forward(mode="train")`` over prompt + output in bf16 and in fp32
   (relative norms): served vs teacher-forced bf16 within 2e-2 or the
   teacher-forced bf16 logits' own distance to fp32, whichever is larger;
   served and teacher-forced bf16 equally far from fp32 within 2e-3; both
   within 4e-2 of fp32; and the teacher-forced argmax must equal the
   served token wherever its top-2 margin exceeds 2e-2 of the row's
   largest |logit|; (c) 4 of those prompts served with ``dtype=float32``
   must equal naive greedy decoding token for token.  Prefill time per
   prompt length, decode-step time (CUDA events), tokens/s, the device
   idle share of decode steps and the share of their weight casts
   (``torch.profiler``), peak memory.  The LM path runs no kernel of the
   port (its attention is plain PyTorch, as the JAX model's is XLA): the
   phase counts 0 launches of every kernel.

The kernels line gives ``ms``, ``plain_ms`` and ``bound_ms`` per main-path
run: each shape's phase-3 (phase-5, phase-7, phase-9) time times the
launches of that shape in the run of phase 4 (of the kernel's rung in
phase 6, of phase 8's 6 training steps, of phase 10 for kernel 4, of
phase 9's entry-point run for 1b, 3 and 5, of phase 12's run for 6),
summed.

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
BWD_RTOL = 1e-4             # per cotangent: fp32 atomics reorder the sums
SERVE_RTOL = 1e-3
TRAIN_LOSS_RTOL = 1e-4      # step-0 loss, kernels vs plain versions
TRAIN_GRAD_RTOL = 1e-3      # step-0 gradients (relative norm), see train()
RESUME_RTOL = 1e-4          # 4 + resumed 2 steps vs 6 (relative norm)
TRAIN_BATCH = 8
TRAIN_STEPS = 6
INT8_VS_FP32_MAX = 0.1      # relative norm error of cls, int8 vs fp32_kernel
SAMPLE_ATOL = 1e-6          # sampling kernels: the plain version's roundings
LIBRARY_RTOL = 1e-5         # grid_sample vs the plain sampling (its grid
                            # is normalised, so positions move ~1e-6 px)
BF16_RTOL = 2.0 ** -7       # one bf16 step at the largest output
BANDED_VS_ZC_RTOL = 1e-4    # served banded vs zero-copy (summation order)
BANDED_LOSS_RTOL = 1e-5     # step-0 loss, banded vs zero-copy
BANDED_TRAIN_STEPS = 2
MM_SHAPES = [(256, 256, 256, "float32"), (512, 512, 512, "float32"),
             (4096, 4096, 4096, "float32"), (257, 129, 65, "float32"),
             (512, 512, 512, "bfloat16"), (4096, 4096, 4096, "bfloat16")]
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 494.7e12  # dense TF32 on the tensor cores
# Kernel 2 a training step as first written on CUDA cores (PERF.md §6),
# and half of it.
BWD_STEP_MS_BEFORE = 36.876
BWD_STEP_MS_HALF = 18.4
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
    if any(n for name, n in counts.items() if name != "deform_conv_fused"):
        fail(f"the fp32_kernel run launched another kernel: {counts}")
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
    return launches, record, params, reqs


def serve_args(cfg, rung: str):
    from repro_torch.launch import serve as launch
    return launch.build_parser().parse_args(
        ["--arch", cfg.name, "--buckets", BUCKETS, "--requests", "8",
         "--slots", str(BATCH), "--device", "cuda", "--seed", "0",
         "--quant", rung])


def counted():
    from repro_torch.kernels import deform_conv_fused as F
    from repro_torch.kernels import deform_conv_q as Q
    from repro_torch.kernels import deform_sample as S
    from repro_torch.kernels.deform_conv_bwd import deform_conv_bwd_zerocopy
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bh)
    from repro_torch.kernels.matmul import matmul
    return {"deform_conv_fused": F.deform_conv_fused_zerocopy,
            "deform_conv_fused_q": Q.deform_conv_fused_zerocopy_q,
            "deform_conv_chain": Q.deform_conv_fused_zerocopy_chain,
            "deform_conv_bwd": deform_conv_bwd_zerocopy,
            "deform_sample_zerocopy": S.deform_sample_zerocopy,
            "deform_sample_banded": S.deform_sample_banded,
            "deform_conv_banded": F.deform_conv_fused_banded,
            "matmul": matmul,
            "flash_attention": flash_attention,
            "flash_attention_bh": flash_attention_bh}


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


def device_events(fn) -> list[tuple[str, float]]:
    """torch.profiler over one call of ``fn`` (after one warm-up): each
    device-side event (kernels, copies, sets) with its device time (ms),
    longest first."""
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
    # Device-side events only: the host ops that launched them carry the
    # same time again.
    events = sorted((e for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=dev_us, reverse=True)
    return [(e.key, dev_us(e) / 1e3) for e in events]


def device_profile(fn, top: int = 6) -> tuple[float | None, list]:
    """``device_events`` summed (ms; None when the profiler saw none), and
    the ``top`` entries by device time."""
    events = device_events(fn)
    total = sum(ms for _, ms in events)
    return (total or None), [(k[:60], round(ms, 4)) for k, ms in events[:top]]


def kernel2_share(events: list[tuple[str, float]]) -> tuple[float, float]:
    """Kernel 2's device time among ``events`` (its four launches: the
    d_input, d_weights and two reduction kernels, ``dcb_*``) and its share
    of their total."""
    k2 = sum(ms for k, ms in events if "dcb_" in k)
    total = sum(ms for _, ms in events)
    return k2, (k2 / total if total else float("nan"))


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


def check_bwd_kernel(case: dict, gen) -> dict:
    """The backward kernel vs its plain version on one geometry, and the
    autograd function vs autograd through the plain forward; returns the
    record."""
    import torch

    from repro_torch.core.tiling import (bwd_dw_smem_bytes, bwd_smem_bytes,
                                         out_hw)
    from repro_torch.kernels import ops, plan, ref
    from repro_torch.kernels.deform_conv_bwd import (
        bwd_plan, deform_conv_bwd_zerocopy, deform_conv_bwd_zerocopy_plain,
        load_kernel, staging_vec)

    n, h, w, c, m = case["n"], case["h"], case["w"], case["c"], case["m"]
    s, d, b = case["stride"], case["dilation"], case.get("bound", B)
    k2 = K * K
    ho, wo = out_hw(h, w, kernel_size=K, stride=s, dilation=d)
    th, tw, tc, _ = plan.resolve_tiles(n, h, w, c, m, kernel_size=K,
                                       stride=s, dilation=d, offset_bound=b,
                                       tile_c=case.get("tile_c"),
                                       dtype="fp32_bwd")
    th, tw = min(th, ho), min(tw, wo)
    x = torch.randn(n, h, w, c, device="cuda", generator=gen)
    off = torch.randn(n, ho, wo, 2 * k2, device="cuda", generator=gen) * 1.5
    wd = torch.randn(k2, c, m, device="cuda", generator=gen) / (k2 * c) ** 0.5
    g = torch.randn(n, ho, wo, m, device="cuda", generator=gen)
    spec = plan.DCSpec(K, s, d, b, th, tw, tc, None)
    xp, offp, wt = plan.zerocopy_inputs(spec, x, off, wd, th, tw, tc)
    kw = dict(kernel_size=K, stride=s, dilation=d, offset_bound=b,
              tile_h=th, tile_w=tw, tile_c=tc)
    got = deform_conv_bwd_zerocopy(xp, offp, g, wt, **kw)
    torch.cuda.synchronize()
    want = deform_conv_bwd_zerocopy_plain(xp, offp, g, wt, **kw)
    names = ("dx", "d_off", "dw")
    errs = {nm: (a - r).abs().max().item() for nm, a, r in
            zip(names, got, want)}
    scales = {nm: r.abs().max().item() for nm, r in zip(names, want)}
    # The autograd function on the card (forward and backward kernels)
    # against autograd through the plain forward, for y . g.
    leaves = [t.clone().requires_grad_(True) for t in (x, off, wd)]
    ag = torch.autograd.grad(
        (ops.deform_conv(*leaves, offset_bound=b, stride=s, dilation=d)
         * g).sum(), leaves)
    ap = torch.autograd.grad(
        (ref.deform_conv_fused_ref(*leaves, offset_bound=b, stride=s,
                                   dilation=d) * g).sum(), leaves)
    auto = {nm: (a - r).abs().max().item() / r.abs().max().item()
            for nm, a, r in zip(("d_input", "d_offsets", "d_weights"), ag,
                                ap)}
    # Kernel 2 is up to four launches (d_input/d_offsets, d_weights, the
    # reductions of the d_offsets and d_weights partials) beside a memset:
    # their device times.
    _, parts = device_profile(
        lambda: deform_conv_bwd_zerocopy(xp, offp, g, wt, **kw))
    lib = load_kernel()
    geom = dict(kernel_size=K, stride=s, dilation=d, offset_bound=b)
    smem_c = (lib.dcb_smem_bytes(K, s, d, math.ceil(b), th, tw, tc),
              lib.dcb_dw_smem_bytes(K, s, d, math.ceil(b), th, tw, tc))
    smem_py = (bwd_smem_bytes(th, tw, tc, **geom),
               bwd_dw_smem_bytes(th, tw, tc, **geom))
    kplan = bwd_plan(n, ho, wo, c, m, kernel_size=K, tile_h=th, tile_w=tw,
                     tile_c=tc)
    vec = staging_vec(xp, g, wt, tc)
    kplan["loads"] = ("W/g 16-byte" if vec & 1 else "W/g element-wise") \
        + (", band 16-byte" if vec & 2 else ", band element-wise")
    ms = time_ms(lambda: deform_conv_bwd_zerocopy(xp, offp, g, wt, **kw),
                 reps=5, iters=5)
    plain_ms = time_ms(
        lambda: deform_conv_bwd_zerocopy_plain(xp, offp, g, wt, **kw),
        reps=3, iters=2)
    p = n * ho * wo
    flops = 2 * 2 * p * k2 * c * m        # dw = P^T g and dP = g W^T
    nbytes = 4 * (2 * n * h * w * c + 2 * p * 2 * k2 + p * m + 2 * k2 * c * m)
    byte_ms = nbytes / PEAK_HBM_BYTES_PER_S * 1e3
    # Two bounds: the fp32 flops on the CUDA cores, and the three tf32
    # products of each fp32 product (3xTF32) at the dense TF32 rate, the
    # kernel's own arithmetic; the lower is the row's bound.
    fp32_ms = max(flops / PEAK_FP32_FLOPS * 1e3, byte_ms)
    tf32x3_ms = max(3 * flops / PEAK_TF32_FLOPS * 1e3, byte_ms)
    bound_ms = min(fp32_ms, tf32x3_ms)
    rec = dict(case, ho=ho, wo=wo, tiles=[th, tw, tc], smem_bytes=smem_c,
               plan=kplan, max_abs_err=max(errs.values()), errs=errs,
               max_abs_plain=scales, autograd_rel_err=auto, parts_ms=parts,
               clamped_share=(off.abs() > b).float().mean().item(),
               ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
               bound_fp32_ms=fp32_ms, bound_3xtf32_ms=tf32x3_ms,
               bound_by="operations" if bound_ms > byte_ms else "bytes",
               flops=flops, bytes=nbytes)
    ok = all(errs[nm] <= BWD_RTOL * scales[nm] for nm in names) \
        and max(auto.values()) <= BWD_RTOL and smem_c == smem_py
    print(f"  {case['label']:<28} tiles {th}x{tw} tc={tc} smem={smem_c} "
          + " ".join(f"{nm}={errs[nm]:.2e}/{scales[nm]:.2f}" for nm in names)
          + f" autograd={max(auto.values()):.1e} "
          f"clamped={rec['clamped_share']:.3f} kernel={ms:.4f} ms "
          f"plain={plain_ms:.3f} ms bound fp32={fp32_ms:.4f} ms "
          f"({fp32_ms / ms:.1%}) 3xTF32={tf32x3_ms:.4f} ms "
          f"({tf32x3_ms / ms:.1%}) per_step={case.get('per_step', {})} "
          f"{'ok' if ok else 'FAIL'}")
    print(f"    plan: C groups {kplan['c_groups']} x {kplan['tiles']} tiles, "
          f"d_weights {kplan['dw_cols']} channels a block, grid "
          f"{kplan['dw_grid']} x {kplan['dw_splits']} splits; instance "
          f"{kplan['lanes']} pixel lanes, {kplan['warp_tiles']} mma tiles a "
          f"warp, k-split {kplan['k_split']}, {kplan['loads']}")
    print(f"    launches: "
          f"{[(k.split('::')[-1].split('(')[0], v) for k, v in parts[:5]]}")
    if smem_c != smem_py:
        fail(f"backward {case['label']}: shared memory {smem_c} (kernel: "
             f"d_input, d_weights) != {smem_py} (chooser)")
    for nm in names:
        if errs[nm] > BWD_RTOL * scales[nm]:
            fail(f"backward {case['label']} {nm}: max|kernel - plain| = "
                 f"{errs[nm]} exceeds {BWD_RTOL} * {scales[nm]}")
    if max(auto.values()) > BWD_RTOL:
        fail(f"backward {case['label']}: autograd through the kernels is "
             f"{auto} from autograd through the plain forward")
    return rec


class plain_training_kernels:
    """Within the block the fp32 plan calls the plain versions of the
    forward kernel (``fwd``) and/or the backward kernel (``bwd``), and
    ``ops.deform_conv`` takes ``tile_c`` when one is given (another fp32
    summation order of the same function)."""

    def __init__(self, *, fwd: bool, bwd: bool, tile_c: int | None = None):
        self.fwd, self.bwd, self.tile_c = fwd, bwd, tile_c

    def __enter__(self):
        from repro_torch.kernels import deform_conv_bwd, deform_conv_fused
        from repro_torch.kernels import ops, plan
        self.saved = (plan.deform_conv_fused_zerocopy,
                      plan.deform_conv_bwd_zerocopy, ops.deform_conv)
        if self.fwd:
            plan.deform_conv_fused_zerocopy = \
                deform_conv_fused.deform_conv_fused_zerocopy_plain
        if self.bwd:
            plan.deform_conv_bwd_zerocopy = \
                deform_conv_bwd.deform_conv_bwd_zerocopy_plain
        if self.tile_c is not None:
            real, tc = ops.deform_conv, self.tile_c
            ops.deform_conv = lambda *a, **kw: real(*a, **dict(kw, tile_c=tc))

    def __exit__(self, *exc):
        from repro_torch.kernels import ops, plan
        (plan.deform_conv_fused_zerocopy, plan.deform_conv_bwd_zerocopy,
         ops.deform_conv) = self.saved


def train(record: dict) -> tuple[int, dict]:
    """Phase 8: train full-width resnet50_dcn_bounded on the card.
    Returns the backward kernel's launches in the 6-step run, and step 0
    (loss of the kernel path, gradients of both paths, the gate of the
    kernel path against the plain path) for phase 11."""
    import shutil

    import numpy as np
    import torch

    from repro_torch.configs.resnet50_dcn import CONFIG_BOUNDED
    from repro_torch.data import DetectionDataConfig, detection_batch
    from repro_torch.launch import train as launch
    from repro_torch.models import resnet_dcn as R
    from repro_torch.tree import leaves

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    cfg = CONFIG_BOUNDED
    ckpt = ROOT / "build" / "smoke_train"
    shutil.rmtree(ckpt, ignore_errors=True)

    def args(steps: int, where: str):
        return launch.build_parser().parse_args(
            ["--arch", cfg.name, "--full", "--steps", str(steps),
             "--global-batch", str(TRAIN_BATCH), "--ckpt", str(ckpt / where),
             "--ckpt-every", "100", "--log-every", "1", "--seed", "0",
             "--device", "cuda"])

    def params():
        return perturb_offsets(R.init_params(tcfg, seed=0, device="cuda"), 1)

    tcfg = launch.train_config(cfg, args(1, "x"))
    n_dcl = sum(tcfg.is_dcn(i) for i in range(tcfg.total_blocks))
    print(f"  config {tcfg.name}: stages {tcfg.stage_sizes}, widths "
          f"{tcfg.widths}, {n_dcl} DCLs, B={tcfg.offset_bound}, "
          f"{tcfg.img_size}x{tcfg.img_size}, batch {TRAIN_BATCH}, "
          f"use_kernel={tcfg.use_kernel}")
    reset_counts()
    t0 = time.monotonic()
    trainer = launch.train_detection(cfg, args(TRAIN_STEPS, "full"),
                                     params=params())
    wall = time.monotonic() - t0
    counts = read_counts()
    losses = [h["loss"] for h in trainer.history if "loss" in h]
    print(f"  {TRAIN_STEPS} steps in {wall:.2f} s; losses "
          f"{[round(v, 5) for v in losses]}; telemetry {trainer.telemetry}; "
          f"launches {counts}")
    want = {name: (n_dcl * TRAIN_STEPS if name in ("deform_conv_fused",
                                                   "deform_conv_bwd") else 0)
            for name in counts}
    if counts != want:
        fail(f"training launched {counts}; expected {want}")
    if len(losses) != TRAIN_STEPS or not np.isfinite(losses).all() \
            or trainer.telemetry != {"skipped": 0, "recovered": 0,
                                     "retries": 0, "preempted": False}:
        fail(f"training: losses {losses}, telemetry {trainer.telemetry}")

    # Resume: 4 steps, then a new run to 6 from the step-4 checkpoint.
    launch.train_detection(cfg, args(4, "resumed"), params=params())
    resumed = launch.train_detection(cfg, args(TRAIN_STEPS, "resumed"),
                                     params=params())
    flat = torch.cat([p.detach().reshape(-1) for p in leaves(trainer.params)])
    flat_r = torch.cat([p.detach().reshape(-1)
                        for p in leaves(resumed.params)])
    resume_rel = ((flat_r - flat).norm() / flat.norm()).item()
    p0 = torch.cat([p.reshape(-1) for p in leaves(params())])
    moved = ((flat - p0).norm() / p0.norm()).item()
    r_losses = [h["loss"] for h in resumed.history if "loss" in h]
    print(f"  resumed at step 4: losses {[round(v, 5) for v in r_losses]}; "
          f"params vs the uninterrupted run: relative norm {resume_rel:.2e} "
          f"(the 6 steps moved them {moved:.2e})")
    if resume_rel > RESUME_RTOL or len(r_losses) != 2:
        fail(f"resumed run is {resume_rel} from the uninterrupted run")

    # Step 0 against the same step with the plain versions in place.  The
    # gradient of bilinear sampling jumps where a tap crosses an integer
    # position, so at full depth fp32-order differences in the forward move
    # a few taps across and the whole-path gradients differ by more than
    # 1e-3 even between two plain runs.  Hence: the backward kernel is held
    # to 1e-3 against the plain backward on the same forward; the whole
    # path (both plain versions) to the plain path's own spread, measured
    # here under another fp32 order (tile_c = 8) and under a 1e-7 relative
    # perturbation of the images.
    data = DetectionDataConfig(img_size=tcfg.img_size,
                               global_batch=TRAIN_BATCH,
                               num_classes=tcfg.num_classes, seed=0)
    batch = {k: torch.from_numpy(v).to("cuda")
             for k, v in detection_batch(data, 0).items()}
    noise = torch.randn(
        batch["images"].shape, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(7))
    p_step0 = params()
    for t in leaves(p_step0):
        t.requires_grad_(True)

    taps: dict[str, list] = {}

    def loss_and_grads(*, fwd=False, bwd=False, tile_c=None, images=None,
                       record=None):
        from repro_torch.kernels import ops
        b_ = batch if images is None else dict(batch, images=images)
        with plain_training_kernels(fwd=fwd, bwd=bwd, tile_c=tile_c):
            inner = ops.deform_conv
            if record is not None:
                def recording(x, offsets, w, **kw):
                    taps.setdefault(record, []).append(offsets.detach())
                    return inner(x, offsets, w, **kw)
                ops.deform_conv = recording
            loss, _ = R.train_loss(p_step0, tcfg, b_, lam=0.005,
                                   device="cuda")
            ops.deform_conv = inner
            gs = torch.autograd.grad(loss, leaves(p_step0))
        return loss.item(), torch.cat([g.reshape(-1) for g in gs])

    def crossings() -> tuple[int, int]:
        """Unclamped offset coordinates whose integer part differs between
        the kernel path and the plain path, and all offset coordinates."""
        n_cross = n_all = 0
        for a, b_ in zip(taps["kernel"], taps["plain"]):
            inside = (a.abs() < B) & (b_.abs() < B)
            n_cross += ((torch.floor(a) != torch.floor(b_)) & inside) \
                .sum().item()
            n_all += a.numel()
        return n_cross, n_all

    def rel(a, b_):
        return ((a - b_).norm() / b_.norm()).item()
    loss_k, g_k = loss_and_grads(record="kernel")
    _, g_kp = loss_and_grads(bwd=True)
    loss_p, g_p = loss_and_grads(fwd=True, bwd=True, record="plain")
    n_cross, n_taps = crossings()
    _, g_order = loss_and_grads(fwd=True, bwd=True, tile_c=8)
    _, g_noise = loss_and_grads(fwd=True, bwd=True,
                                images=batch["images"] * (1 + 1e-7 * noise))
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    bwd_rel = rel(g_k, g_kp)
    path_rel = rel(g_k, g_p)
    spread = max(rel(g_order, g_p), rel(g_noise, g_p))
    print(f"  step 0 vs the plain versions: loss {loss_k:.6f} vs "
          f"{loss_p:.6f} (rel {loss_rel:.2e}); gradients: backward kernel "
          f"vs plain backward (same forward) {bwd_rel:.2e}; whole path "
          f"{path_rel:.2e}, plain path vs itself under another fp32 order "
          f"{rel(g_order, g_p):.2e} and under 1e-7 input noise "
          f"{rel(g_noise, g_p):.2e}; {n_cross} of {n_taps} offsets cross an "
          f"integer between the two paths; first logged loss "
          f"{losses[0]:.6f}")
    if loss_rel > TRAIN_LOSS_RTOL or abs(losses[0] - loss_k) \
            > TRAIN_LOSS_RTOL * abs(loss_p):
        fail(f"step 0 loss off the plain path: rel {loss_rel}")
    if bwd_rel > TRAIN_GRAD_RTOL:
        fail(f"step 0 gradients through the backward kernel are {bwd_rel} "
             f"from the plain backward's")
    if path_rel > max(TRAIN_GRAD_RTOL, spread):
        fail(f"step 0 gradients of the kernel path are {path_rel} from the "
             f"plain path's, beyond its own spread {spread}")

    # Where a step's time goes: forward / backward split (CUDA events),
    # the whole step, and its device-busy share (torch.profiler).
    def fwd_bwd():
        e0, e1, e2 = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        e0.record()
        loss, _ = R.train_loss(p_step0, tcfg, batch, lam=0.005,
                               device="cuda")
        e1.record()
        torch.autograd.grad(loss, leaves(p_step0))
        e2.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1), e1.elapsed_time(e2)
    fwd_bwd()
    split = [fwd_bwd() for _ in range(5)]
    fwd_ms = statistics.median(f for f, _ in split)
    bwd_ms = statistics.median(b_ for _, b_ in split)
    step_batch = trainer._device_batch(0)
    step_ms = time_ms(lambda: trainer._one_step(step_batch), reps=3, iters=2)
    events = device_events(lambda: trainer._one_step(step_batch))
    busy = sum(ms for _, ms in events) or None
    top = [(k[:60], round(ms, 4)) for k, ms in events[:6]]
    k2_ms, k2_share = kernel2_share(events)
    share = "not measured" if busy is None else f"{1 - busy / step_ms:.0%}"
    host_ms = [t * 1e3 for t in trainer.step_seconds]
    # The same step with cuDNN free to pick non-deterministic algorithms
    # (the launcher's setting; the checks above need determinism).
    torch.backends.cudnn.deterministic = False
    free_ms = time_ms(lambda: trainer._one_step(step_batch), reps=3, iters=2)
    free_events = device_events(lambda: trainer._one_step(step_batch))
    free_busy = sum(ms for _, ms in free_events) or None
    free_top = [(k[:60], round(ms, 4)) for k, ms in free_events[:6]]
    free_k2_ms, free_k2_share = kernel2_share(free_events)
    torch.backends.cudnn.deterministic = True
    print(f"  step (forward + backward + SGD), batch {TRAIN_BATCH}: "
          f"{step_ms:.3f} ms (CUDA events); forward {fwd_ms:.3f} ms, "
          f"backward {bwd_ms:.3f} ms; device busy "
          f"{busy if busy is None else round(busy, 3)} ms by torch.profiler, "
          f"idle {share}; host-clock steps {[round(t, 2) for t in host_ms]} "
          f"ms; top {top[:5]}")
    free = free_busy if free_busy is None else round(free_busy, 3)
    print(f"  the same step, cuDNN not deterministic: {free_ms:.3f} ms, "
          f"device busy {free} ms; top {free_top[:5]}")
    print(f"  kernel 2 (dcb_* launches) in the step's device time: "
          f"{k2_ms:.3f} ms ({k2_share:.1%}) with cuDNN deterministic, "
          f"{free_k2_ms:.3f} ms ({free_k2_share:.1%}) without")
    record["train"] = dict(
        steps=TRAIN_STEPS, batch=TRAIN_BATCH, img_size=tcfg.img_size,
        wall_s=wall, losses=losses, telemetry=trainer.telemetry,
        launches=counts, host_step_ms=host_ms,
        median_host_step_ms=trainer.median_step_sec() * 1e3,
        resume_rel=resume_rel, moved_rel=moved, resumed_losses=r_losses,
        step0_loss=[loss_k, loss_p], step0_loss_rel=loss_rel,
        step0_grad_rel_backward=bwd_rel, step0_grad_rel_path=path_rel,
        step0_grad_plain_spread=[rel(g_order, g_p), rel(g_noise, g_p)],
        step0_offsets_crossing=[n_cross, n_taps],
        step_ms=step_ms, forward_ms=fwd_ms,
        backward_ms=bwd_ms, device_busy_ms=busy, device_top=top,
        step_ms_cudnn_free=free_ms, device_busy_ms_cudnn_free=free_busy,
        device_top_cudnn_free=free_top, kernel2_device_ms=k2_ms,
        kernel2_device_share=k2_share, kernel2_device_ms_cudnn_free=free_k2_ms,
        kernel2_device_share_cudnn_free=free_k2_share)
    step0 = dict(loss=loss_k, loss_plain=loss_p, grads=g_k, grads_plain=g_p,
                 gate=max(TRAIN_GRAD_RTOL, spread))
    return counts["deform_conv_bwd"], step0


def grid_sample_inputs(x, off, *, stride: int, dilation: int, bound: float):
    """``F.grid_sample``'s input (NCHW) and grid (N, Ho, Wo*K*K, 2) for the
    bounded sampling of x at the clamped offsets: the positions of the
    unpadded image, normalised for ``align_corners=True`` (computed in
    float64, then rounded once to fp32)."""
    import torch
    n, h, w, _ = x.shape
    _, ho, wo, _ = off.shape
    k2 = K * K
    pad = dilation * (K // 2)
    o = off.double().reshape(n, ho, wo, k2, 2).clamp(-bound, bound)
    kk = torch.arange(k2, device=x.device)
    oy = torch.arange(ho, device=x.device)[:, None, None] * stride \
        - pad + (kk // K)[None, None, :] * dilation
    ox = torch.arange(wo, device=x.device)[None, :, None] * stride \
        - pad + (kk % K)[None, None, :] * dilation
    py = oy.double() + o[..., 0]
    px = ox.double() + o[..., 1]
    grid = torch.stack((2 * px / (w - 1) - 1, 2 * py / (h - 1) - 1), -1)
    return (x.permute(0, 3, 1, 2).contiguous(),
            grid.reshape(n, ho, wo * k2, 2).float().contiguous())


def grid_sample_patches(xc, grid, ho: int, wo: int):
    """(N, C, Ho, Wo*K*K) from grid_sample -> (N, Ho, Wo, K*K, C)."""
    import torch.nn.functional as F
    y = F.grid_sample(xc, grid, mode="bilinear", padding_mode="zeros",
                      align_corners=True)
    n, c = y.shape[:2]
    return y.reshape(n, c, ho, wo, K * K).permute(0, 2, 3, 4, 1)


def check_sample_kernels(case: dict, gen) -> list[dict]:
    """Kernels 1b and 3 vs their plain versions on one geometry, at the
    tiles ``ops.deform_sample`` picks, and ``F.grid_sample`` computing the
    same function; returns the two records."""
    import torch

    from repro_torch.core.tiling import out_hw, sample_smem_bytes
    from repro_torch.kernels import deform_sample as S
    from repro_torch.kernels import plan

    n, h, w, c = case["n"], case["h"], case["w"], case["c"]
    s, d, b = case["stride"], case["dilation"], case.get("bound", B)
    k2 = K * K
    ho, wo = out_hw(h, w, kernel_size=K, stride=s, dilation=d)
    geom = dict(kernel_size=K, stride=s, dilation=d, offset_bound=b)
    x = torch.randn(n, h, w, c, device="cuda", generator=gen)
    off = torch.randn(n, ho, wo, 2 * k2, device="cuda", generator=gen) * 1.5
    lib = S.load_kernel()
    xc, grid = grid_sample_inputs(x, off, stride=s, dilation=d, bound=b)
    lib_out = grid_sample_patches(xc, grid, ho, wo)
    library_ms = time_ms(lambda: grid_sample_patches(xc, grid, ho, wo),
                         reps=7, iters=10)

    th, tw, tc, _ = plan.resolve_tiles(n, h, w, c, c, tile_h=8,
                                       dtype="sample", **geom)
    th, tw = min(th, ho), min(tw, wo)
    xp = plan.pad_zerocopy(x, tile_h=th, tile_w=tw, ho=ho, wo=wo, **geom)
    spec = plan.DCSpec(K, s, d, b, 8, dataflow="banded")
    thb, twb, tcb, _ = plan.banded_tiles(spec, x, off, c, dtype="sample")
    bands, offb = plan.banded_inputs(spec, x, off, thb)
    runs = {
        "deform_sample_zerocopy": (
            S.deform_sample_zerocopy, S.deform_sample_zerocopy_plain,
            (xp, off.contiguous()), dict(tile_h=th, tile_w=tw, tile_c=tc),
            [th, tw, tc]),
        "deform_sample_banded": (
            S.deform_sample_banded, S.deform_sample_banded_plain,
            (bands, offb), dict(tile_h=thb, tile_w=twb, tile_c=tcb),
            [thb, twb, tcb]),
    }
    recs = []
    for name, (fn, plain, args, tiles, tl) in runs.items():
        kw = dict(tiles, **geom)
        y = fn(*args, **kw)
        torch.cuda.synchronize()
        yp = plain(*args, **kw)
        err = (y - yp).abs().max().item()
        scale = yp.abs().max().item()
        lib_err = (lib_out - yp[:, :ho]).abs().max().item()
        ms = time_ms(lambda: fn(*args, **kw), reps=7, iters=10)
        plain_ms = time_ms(lambda: plain(*args, **kw), reps=3, iters=2)
        smem_c = lib.ds_smem_bytes(K, s, d, math.ceil(b), tl[0], tl[1],
                                   tl[2])
        smem_py = sample_smem_bytes(tl[0], tl[1], tl[2], kernel_size=K,
                                    stride=s, dilation=d, offset_bound=b)
        flops = 7 * y.numel()      # four products and three sums a sample
        nbytes = 4 * (args[0].numel() + args[1].numel() + y.numel())
        bound_ms = max(flops / PEAK_FP32_FLOPS,
                       nbytes / PEAK_HBM_BYTES_PER_S) * 1e3
        rec = dict(case, kernel=name, ho=ho, wo=wo, tiles=tl,
                   smem_bytes=smem_c, max_abs_err=err, max_abs_plain=scale,
                   library_err=lib_err,
                   clamped_share=(off.abs() > b).float().mean().item(),
                   ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=bound_ms,
                   bound_by="operations" if flops / PEAK_FP32_FLOPS
                   >= nbytes / PEAK_HBM_BYTES_PER_S else "bytes",
                   flops=flops, bytes=nbytes)
        ok = err <= SAMPLE_ATOL and smem_c == smem_py \
            and lib_err <= LIBRARY_RTOL * scale
        print(f"  {name:<22} {case['label']:<26} tiles {tl[0]}x{tl[1]} "
              f"tc={tl[2]} smem={smem_c} err={err:.1e} "
              f"grid_sample err={lib_err:.1e} (max|plain|={scale:.2f}) "
              f"kernel={ms:.4f} ms plain={plain_ms:.3f} ms "
              f"grid_sample={library_ms:.4f} ms bound={bound_ms:.4f} ms "
              f"{'ok' if ok else 'FAIL'}")
        if smem_c != smem_py:
            fail(f"{name} {case['label']}: shared memory {smem_c} (kernel) "
                 f"!= {smem_py} (chooser)")
        if err > SAMPLE_ATOL:
            fail(f"{name} {case['label']}: max|kernel - plain| = {err} "
                 f"exceeds {SAMPLE_ATOL}")
        if lib_err > LIBRARY_RTOL * scale:
            fail(f"{name} {case['label']}: grid_sample is {lib_err} from "
                 f"the plain version: not the same function")
        recs.append(rec)
    return recs


def check_banded_kernel(case: dict, gen) -> dict:
    """Kernel 4 vs its plain version on one geometry, at the tiles of the
    banded plan; returns the record."""
    import torch

    from repro_torch.core.tiling import out_hw, smem_bytes
    from repro_torch.kernels import deform_conv_fused as F
    from repro_torch.kernels import plan

    n, h, w, c, m = case["n"], case["h"], case["w"], case["c"], case["m"]
    s, d, b = case["stride"], case["dilation"], case.get("bound", B)
    ho, wo = out_hw(h, w, kernel_size=K, stride=s, dilation=d)
    x = torch.randn(n, h, w, c, device="cuda", generator=gen)
    off = torch.randn(n, ho, wo, 2 * K * K, device="cuda",
                      generator=gen) * 1.5
    wd = torch.randn(K * K, c, m, device="cuda", generator=gen) \
        / (K * K * c) ** 0.5
    spec = plan.DCSpec(K, s, d, b, dataflow="banded")
    th, tw, tc, tm = plan.banded_tiles(spec, x, off, m, dtype="banded")
    bands, offb = plan.banded_inputs(spec, x, off, th)
    wt = plan.tile_weights(wd, tc)
    kw = dict(kernel_size=K, stride=s, dilation=d, offset_bound=b,
              tile_h=th, tile_w=tw, tile_c=tc, tile_m=tm)
    y = F.deform_conv_fused_banded(bands, offb, wt, **kw)
    torch.cuda.synchronize()
    yp = F.deform_conv_fused_banded_plain(bands, offb, wt, **kw)
    err = (y - yp).abs().max().item()
    scale = yp.abs().max().item()
    smem_c = F.load_kernel().dcf_smem_bytes(K, s, d, math.ceil(b), th, tw,
                                            tc)
    smem_py = smem_bytes(th, tw, tc, kernel_size=K, stride=s, dilation=d,
                         offset_bound=b)
    ms = time_ms(lambda: F.deform_conv_fused_banded(bands, offb, wt, **kw),
                 reps=7, iters=10)
    plain_ms = time_ms(
        lambda: F.deform_conv_fused_banded_plain(bands, offb, wt, **kw),
        reps=3, iters=2)
    prep_ms = time_ms(lambda: (plan.banded_inputs(spec, x, off, th),
                               plan.tile_weights(wd, tc)), reps=5, iters=10)
    flops = 2 * n * offb.shape[1] * wo * K * K * c * m
    nbytes = 4 * (bands.numel() + offb.numel() + wt.numel() + y.numel())
    bound_ms = max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES_PER_S) \
        * 1e3
    rec = dict(case, ho=ho, wo=wo, tiles=[th, tw, tc, tm], smem_bytes=smem_c,
               bands_bytes=4 * bands.numel(), input_bytes=4 * x.numel(),
               max_abs_err=err, max_abs_plain=scale,
               clamped_share=(off.abs() > b).float().mean().item(),
               ms=ms, plain_ms=plain_ms, prep_ms=prep_ms, bound_ms=bound_ms,
               bound_by="operations" if flops / PEAK_FP32_FLOPS
               >= nbytes / PEAK_HBM_BYTES_PER_S else "bytes",
               flops=flops, bytes=nbytes)
    ok = err <= KERNEL_RTOL * scale and smem_c == smem_py
    print(f"  {case['label']:<28} tiles {th}x{tw} tc={tc} tm={tm} "
          f"smem={smem_c} bands/input "
          f"{bands.numel() / x.numel():.2f}x err={err:.3e} "
          f"(max|plain|={scale:.3f}) kernel={ms:.4f} ms "
          f"plain={plain_ms:.3f} ms prep={prep_ms:.4f} ms "
          f"bound={bound_ms:.4f} ms per_step={case.get('per_step', {})} "
          f"{'ok' if ok else 'FAIL'}")
    if smem_c != smem_py:
        fail(f"banded {case['label']}: shared memory {smem_c} (kernel) != "
             f"{smem_py} (chooser)")
    if err > KERNEL_RTOL * scale:
        fail(f"banded {case['label']}: max|kernel - plain| = {err} exceeds "
             f"{KERNEL_RTOL} * {scale}")
    return rec


def check_matmul(m: int, k: int, n: int, dtype: str, gen) -> dict:
    """Kernel 5 vs its plain version and ``torch.matmul``; the record."""
    import torch

    from repro_torch.kernels import matmul as MM
    x = torch.randn(m, k, device="cuda", generator=gen).to(
        getattr(torch, dtype))
    w = torch.randn(k, n, device="cuda", generator=gen).to(
        getattr(torch, dtype))
    instance = MM.instance(x, w)
    y = MM.matmul(x, w)
    torch.cuda.synchronize()
    yp = MM.matmul_plain(x, w)
    err = (y.float() - yp.float()).abs().max().item()
    scale = yp.float().abs().max().item()
    tol = KERNEL_RTOL if dtype == "float32" else BF16_RTOL
    big = m * n * k > 1e9
    ms = time_ms(lambda: MM.matmul(x, w), reps=5, iters=3 if big else 20)
    plain_ms = time_ms(lambda: MM.matmul_plain(x, w), reps=5,
                       iters=3 if big else 20)
    library_ms = time_ms(lambda: torch.matmul(x, w), reps=5,
                         iters=3 if big else 20)
    flops = 2 * m * n * k
    peak = PEAK_FP32_FLOPS if dtype == "float32" else PEAK_BF16_FLOPS
    nbytes = x.element_size() * (m * k + k * n + m * n)
    bound_ms = max(flops / peak, nbytes / PEAK_HBM_BYTES_PER_S) * 1e3
    label = f"{m}x{k}x{n} {dtype}"
    rec = dict(label=label, m=m, k=k, n=n, dtype=dtype, instance=instance,
               max_abs_err=err,
               max_abs_plain=scale, ms=ms, plain_ms=plain_ms,
               library_ms=library_ms, bound_ms=bound_ms,
               bound_by="operations" if flops / peak
               >= nbytes / PEAK_HBM_BYTES_PER_S else "bytes",
               flops=flops, op_ms=flops / peak * 1e3, bytes=nbytes)
    print(f"  matmul {label:<24} [{instance}] err={err:.2e} "
          f"(max|plain|={scale:.2f}) "
          f"kernel={ms:.4f} ms plain={plain_ms:.4f} ms "
          f"torch.matmul={library_ms:.4f} ms bound={bound_ms:.4f} ms "
          f"({flops / ms / 1e9:.1f} TFLOP/s) "
          f"{'ok' if err <= tol * scale else 'FAIL'}")
    if err > tol * scale:
        fail(f"matmul {label}: max|kernel - plain| = {err} exceeds "
             f"{tol} * {scale}")
    return rec


def entry_points(cases: list[dict], gen) -> dict[str, int]:
    """Phase 9's main path: ``ops.deform_sample`` on both dataflows and
    ``ops.deform_conv`` on both at each case, sample + einsum against the
    fused output, and ``ops.matmul`` at every matmul case, as a user calls
    them.  Returns the launches counted in that run."""
    import torch

    from repro_torch.core.tiling import out_hw
    from repro_torch.kernels import ops

    inputs = []
    for case in cases:
        n, h, w, c, s = (case["n"], case["h"], case["w"], case["c"],
                         case["stride"])
        ho, wo = out_hw(h, w, kernel_size=K, stride=s)
        inputs.append((case, torch.randn(n, h, w, c, device="cuda",
                                         generator=gen),
                       torch.randn(n, ho, wo, 2 * K * K, device="cuda",
                                   generator=gen) * 1.5,
                       torch.randn(K * K, c, c, device="cuda", generator=gen)
                       / (K * K * c) ** 0.5))
    mm_inputs = [(torch.randn(m, k, device="cuda", generator=gen).to(
        getattr(torch, dt)), torch.randn(k, n, device="cuda",
                                          generator=gen).to(getattr(torch, dt)))
        for m, k, n, dt in MM_SHAPES]
    torch.cuda.synchronize()
    reset_counts()
    worst = {}
    for case, x, off, wd in inputs:
        kw = dict(offset_bound=B, stride=case["stride"], device="cuda")
        for dataflow in ("zero_copy", "banded"):
            patches = ops.deform_sample(x, off, dataflow=dataflow, **kw)
            fused = ops.deform_conv(x, off, wd, dataflow=dataflow, **kw)
            two = torch.einsum("nhwkc,kcm->nhwm", patches, wd)
            rel = ((two - fused).abs().max() / fused.abs().max()).item()
            worst[dataflow] = max(worst.get(dataflow, 0.0), rel)
            if rel > KERNEL_RTOL or patches.shape[-2:] != (K * K, x.shape[-1]):
                fail(f"{case['label']} {dataflow}: sample + einsum is {rel} "
                     f"(relative) from the fused forward")
    for x, w in mm_inputs:
        y = ops.matmul(x, w)
        if y.dtype != x.dtype or not torch.isfinite(y.float()).all():
            fail(f"ops.matmul {tuple(x.shape)} x {tuple(w.shape)}: "
                 f"{y.dtype}, finite {torch.isfinite(y.float()).all()}")
    torch.cuda.synchronize()
    counts = read_counts()
    want = {name: 0 for name in counts}
    want.update(deform_sample_zerocopy=len(cases),
                deform_sample_banded=len(cases),
                deform_conv_fused=len(cases), deform_conv_banded=len(cases),
                matmul=len(MM_SHAPES))
    print(f"  entry points: launches {counts}; sample + einsum vs fused, "
          f"worst relative {worst}")
    if counts != want:
        fail(f"the entry-point run launched {counts}; expected {want}")
    return counts


def serve_banded(record: dict, params, zc_reqs) -> int:
    """Phase 10: phase 4's model and requests on the banded dataflow.
    Returns kernel 4's launches in the served run."""
    import numpy as np
    import torch

    from repro_torch.configs.resnet50_dcn import CONFIG_BOUNDED
    from repro_torch.launch import serve as launch
    from repro_torch.models import resnet_dcn as R

    cfg = dataclasses.replace(CONFIG_BOUNDED, use_kernel=True,
                              dataflow="banded")
    n_dcl = sum(cfg.is_dcn(i) for i in range(cfg.total_blocks))
    args = serve_args(cfg, "fp32_kernel")
    launch.serve_detection(cfg, args, params=params)        # warm-up
    reset_counts()
    engine, _, seconds = launch.serve_detection(cfg, args, params=params)
    counts = read_counts()
    print(launch.report(engine, seconds))
    reqs = engine.completed
    bad = [r for r in reqs if r.outcome != "ok" or r.ladder != "fp32_kernel"
           or r.degraded]
    if len(reqs) != 8 or bad:
        fail(f"banded requests not all ok on fp32_kernel: "
             f"{[(r.uid, r.outcome, r.ladder, r.error) for r in reqs]}")
    want = {name: (n_dcl * engine.steps if name == "deform_conv_banded"
                   else 0) for name in counts}
    if counts != want:
        fail(f"the banded run launched {counts} in {engine.steps} steps; "
             f"expected {want}")
    print(f"  launches in the banded run: {counts}")
    zc = {r.uid: r.result for r in zc_reqs}
    ref_cfg = dataclasses.replace(cfg, use_kernel=False)
    zc_cfg = dataclasses.replace(cfg, dataflow="zero_copy")
    errs = {}
    fwd_ms = {}
    for bucket in sorted({r.bucket for r in reqs}):
        rows = [r for r in reqs if r.bucket == bucket]
        x = engine.batch_array(bucket, rows)
        with torch.no_grad():
            ref, _ = R.forward(params, ref_cfg, x, device="cuda")
        for key in ("cls", "box"):
            got = np.stack([r.result[key] for r in rows])
            r_np = ref[key].cpu().numpy()[:len(rows)]
            z_np = np.stack([zc[r.uid][key] for r in rows])
            err = float(np.abs(got - r_np).max())
            scale = float(np.abs(r_np).max())
            err_zc = float(np.abs(got - z_np).max())
            scale_zc = float(np.abs(z_np).max())
            errs[f"{bucket}/{key}"] = dict(vs_plain=err / scale,
                                           vs_zero_copy=err_zc / scale_zc)
            print(f"  bucket {bucket} {key}: vs plain path {err:.3e} "
                  f"(max|ref|={scale:.3f}); vs phase 4's zero-copy "
                  f"{err_zc:.3e} (rel {err_zc / scale_zc:.2e})")
            if not np.isfinite(got).all() or err > SERVE_RTOL * scale:
                fail(f"banded bucket {bucket} {key} off the plain path: "
                     f"{err} > {SERVE_RTOL} * {scale}")
            if err_zc > BANDED_VS_ZC_RTOL * scale_zc:
                fail(f"banded bucket {bucket} {key} off the zero-copy "
                     f"result: {err_zc} > {BANDED_VS_ZC_RTOL} * {scale_zc}")
        # Both dataflows' forwards, timed in turns.
        fns = {"banded": lambda: R.forward(params, cfg, x, device="cuda"),
               "zero_copy": lambda: R.forward(params, zc_cfg, x,
                                              device="cuda")}
        turns: dict[str, list[float]] = {name: [] for name in fns}
        with torch.no_grad():
            busy, top = device_profile(fns["banded"])
            for _ in range(5):
                for name, fn in fns.items():
                    turns[name].append(time_ms(fn, reps=1, iters=3))
        row = {name: statistics.median(t) for name, t in turns.items()}
        row.update(turns=turns, banded_device_busy=busy, banded_top=top)
        fwd_ms[str(bucket)] = row
        share = "not measured" if busy is None \
            else f"{1 - busy / row['banded']:.0%}"
        print(f"  {bucket}-bucket forward, batch {BATCH}: banded "
              f"{row['banded']:.3f} ms, zero-copy {row['zero_copy']:.3f} ms "
              f"(median of 5 turns); banded device busy "
              f"{busy if busy is None else round(busy, 3)} ms, idle {share}; "
              f"top {top[:4]}")
    lats = sorted(r.latency_s() for r in reqs)
    record["serve_banded"] = dict(
        requests=len(reqs), steps=engine.steps, launches=counts,
        steps_per_bucket=engine.telemetry()["steps_per_bucket"],
        plans=engine.telemetry()["plans"], seconds=seconds,
        p50_latency_ms=lats[len(lats) // 2] * 1e3, errors=errs,
        forward_ms=fwd_ms)
    return counts["deform_conv_banded"]


def train_banded(record: dict, step0: dict) -> None:
    """Phase 11: phase 8's training settings on the banded dataflow."""
    import shutil

    import numpy as np
    import torch

    from repro_torch.configs.resnet50_dcn import CONFIG_BOUNDED
    from repro_torch.data import DetectionDataConfig, detection_batch
    from repro_torch.launch import train as launch
    from repro_torch.models import resnet_dcn as R
    from repro_torch.tree import leaves

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    cfg = dataclasses.replace(CONFIG_BOUNDED, dataflow="banded")
    ckpt = ROOT / "build" / "smoke_train_banded"
    shutil.rmtree(ckpt, ignore_errors=True)
    args = launch.build_parser().parse_args(
        ["--arch", cfg.name, "--full", "--steps", str(BANDED_TRAIN_STEPS),
         "--global-batch", str(TRAIN_BATCH), "--ckpt", str(ckpt),
         "--ckpt-every", "100", "--log-every", "1", "--seed", "0",
         "--device", "cuda"])
    tcfg = launch.train_config(cfg, args)
    n_dcl = sum(tcfg.is_dcn(i) for i in range(tcfg.total_blocks))

    def params():
        return perturb_offsets(R.init_params(tcfg, seed=0, device="cuda"), 1)
    reset_counts()
    t0 = time.monotonic()
    trainer = launch.train_detection(cfg, args, params=params())
    wall = time.monotonic() - t0
    counts = read_counts()
    losses = [h["loss"] for h in trainer.history if "loss" in h]
    print(f"  config {tcfg.name} dataflow={tcfg.dataflow}: "
          f"{BANDED_TRAIN_STEPS} steps in {wall:.2f} s; losses "
          f"{[round(v, 5) for v in losses]}; telemetry {trainer.telemetry}; "
          f"launches {counts}")
    per = n_dcl * BANDED_TRAIN_STEPS
    want = {name: (per if name in ("deform_conv_banded", "deform_conv_bwd")
                   else 0) for name in counts}
    if counts != want:
        fail(f"banded training launched {counts}; expected {want}")
    if len(losses) != BANDED_TRAIN_STEPS or not np.isfinite(losses).all() \
            or trainer.telemetry != {"skipped": 0, "recovered": 0,
                                     "retries": 0, "preempted": False}:
        fail(f"banded training: losses {losses}, telemetry "
             f"{trainer.telemetry}")

    # Step 0 against phase 8's zero-copy step 0 (the same params and batch).
    data = DetectionDataConfig(img_size=tcfg.img_size,
                               global_batch=TRAIN_BATCH,
                               num_classes=tcfg.num_classes, seed=0)
    batch = {k: torch.from_numpy(v).to("cuda")
             for k, v in detection_batch(data, 0).items()}
    p0 = params()
    for t in leaves(p0):
        t.requires_grad_(True)
    loss, _ = R.train_loss(p0, tcfg, batch, lam=0.005, device="cuda")
    g = torch.cat([t.reshape(-1) for t in
                   torch.autograd.grad(loss, leaves(p0))])
    loss_rel = abs(loss.item() - step0["loss"]) / abs(step0["loss"])
    rel_plain = ((g - step0["grads_plain"]).norm()
                 / step0["grads_plain"].norm()).item()
    rel_zc = ((g - step0["grads"]).norm() / step0["grads"].norm()).item()
    print(f"  step 0: loss {loss.item():.6f} vs zero-copy "
          f"{step0['loss']:.6f} (rel {loss_rel:.2e}); gradients vs the "
          f"plain path {rel_plain:.2e} (phase 8's gate "
          f"{step0['gate']:.2e}), vs the zero-copy kernel path "
          f"{rel_zc:.2e}; first logged loss {losses[0]:.6f}")
    if loss_rel > BANDED_LOSS_RTOL or abs(losses[0] - step0["loss"]) \
            > BANDED_LOSS_RTOL * abs(step0["loss"]):
        fail(f"banded step 0 loss is {loss_rel} from the zero-copy step 0")
    if rel_plain > step0["gate"]:
        fail(f"banded step 0 gradients are {rel_plain} from the plain "
             f"path's, beyond phase 8's gate {step0['gate']}")
    step_batch = trainer._device_batch(0)
    step_ms = time_ms(lambda: trainer._one_step(step_batch), reps=3, iters=2)
    events = device_events(lambda: trainer._one_step(step_batch))
    busy = sum(ms for _, ms in events) or None
    top = [(k[:60], round(ms, 4)) for k, ms in events[:6]]
    k2_ms, k2_share = kernel2_share(events)
    share = "not measured" if busy is None else f"{1 - busy / step_ms:.0%}"
    print(f"  banded step (forward + backward + SGD), batch {TRAIN_BATCH}: "
          f"{step_ms:.3f} ms (CUDA events, cuDNN deterministic); device "
          f"busy {busy if busy is None else round(busy, 3)} ms, idle "
          f"{share}; kernel 2 {k2_ms:.3f} ms of it ({k2_share:.1%}); top "
          f"{top[:5]}")
    record["train_banded"] = dict(
        steps=BANDED_TRAIN_STEPS, wall_s=wall, losses=losses,
        telemetry=trainer.telemetry, launches=counts,
        host_step_ms=[t * 1e3 for t in trainer.step_seconds],
        step0_loss=loss.item(), step0_loss_rel=loss_rel,
        step0_grad_rel_plain=rel_plain, step0_grad_rel_zero_copy=rel_zc,
        step_ms=step_ms, device_busy_ms=busy, device_top=top,
        kernel2_device_ms=k2_ms, kernel2_device_share=k2_share)


# ---------------------------------------------------------------------------
# Phase 12: flash attention (kernel 6)
# ---------------------------------------------------------------------------

FA_TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # tests/test_flash_attention.py
# bf16 cases are also held to a relative L2 error: at Sk in the thousands
# a typical |o| (~sqrt(e / Sk)) is below FA_TOL's 2e-2 atol, so the
# elementwise test alone could pass a split left out of the combine
# (PERF.md section 2 has the readings).
FA_BF16_REL_L2 = 1e-2
LM_ATTN_TOL = 3e-5      # the LM's attention vs the kernel, fp32 (same test)
FA_JAX_CASES = [
    # (b, sq, sk, kv, g, dh, causal, softcap): tests/test_flash_attention.py
    (1, 128, 128, 1, 1, 32, True, None),
    (2, 64, 64, 2, 2, 16, True, None),
    (1, 100, 100, 1, 2, 16, True, None),
    (1, 64, 64, 2, 1, 32, False, None),
    (1, 96, 96, 1, 1, 16, True, 8.0),
    (1, 32, 160, 1, 1, 16, False, None),
]


def fa_cases() -> list[dict]:
    def case(label, b, sq, sk, kv, g, dh, causal, cap, dtype, **kw):
        return dict(label=label, b=b, sq=sq, sk=sk, kv=kv, g=g, dh=dh,
                    causal=causal, softcap=cap, dtype=dtype, **kw)
    cases = [case(f"test case {i} {dt}", *c, dt)
             for i, c in enumerate(FA_JAX_CASES)
             for dt in ("float32", "bfloat16")]
    cases += [case(f"tinyllama ({b}, {s}) {dt}", b, s, s, 4, 8, 64, True,
                   None, dt, vs="dense")
              for b, s, dt in [(1, 512, "bfloat16"), (4, 512, "bfloat16"),
                               (1, 2048, "bfloat16"), (4, 2048, "bfloat16"),
                               (1, 4096, "bfloat16"), (1, 2048, "float32")]]
    cases += [case("deepseek-7b MHA (1, 2048) bfloat16", 1, 2048, 2048, 32,
                   1, 128, True, None, "bfloat16"),
              case("glm4-9b GQA (1, 2048) bfloat16", 1, 2048, 2048, 2, 16,
                   128, True, None, "bfloat16"),
              case("deepseek-7b MHA (1, 2048) float32", 1, 2048, 2048, 32,
                   1, 128, True, None, "float32", vs="dense"),
              case("glm4-9b GQA (1, 2048) float32", 1, 2048, 2048, 2, 16,
                   128, True, None, "float32", vs="dense"),
              case("recurrentgemma-9b MQA Dh 256 (1, 2048) float32", 1, 2048,
                   2048, 1, 16, 256, True, None, "float32", vs="dense"),
              case("recurrentgemma-9b MQA Dh 256 (1, 2048) bfloat16", 1,
                   2048, 2048, 1, 16, 256, True, None, "bfloat16"),
              case("grok-1 softcap 30 (1, 1024) bfloat16", 1, 1024, 1024, 8,
                   6, 128, True, 30.0, "bfloat16"),
              case("cross Sq=1 Sk=2048 bfloat16", 1, 1, 2048, 4, 8, 64,
                   False, None, "bfloat16"),
              case("cross Sq=100 Sk=1000 bfloat16", 1, 100, 1000, 4, 8, 64,
                   False, None, "bfloat16"),
              case("tinyllama (1, 8192) float32", 1, 8192, 8192, 4, 8, 64,
                   True, None, "float32", vs="chunked")]
    # Decode-like shapes that take the split over K, kept out of the bf16
    # totals of the 15 bf16 cases above.
    cases += [case("cross Sq=1 Sk=8192 bfloat16", 1, 1, 8192, 4, 8, 64,
                   False, None, "bfloat16", decode=True),
              case("cross Sq=16 Sk=4096 bfloat16", 1, 16, 4096, 4, 8, 64,
                   False, None, "bfloat16", decode=True),
              case("cross Sq=1 Sk=2048 float32", 1, 1, 2048, 4, 8, 64,
                   False, None, "float32", decode=True)]
    return cases


def fa_work(c: dict) -> tuple[int, int]:
    """(operations, bytes) the function needs: 4 * Dh per (query, key)
    pair the mask keeps, for every query head; q, k, v read and the output
    written once."""
    sq, sk = c["sq"], c["sk"]
    if c["causal"]:
        m = min(sq, sk)
        pairs = m * (m + 1) // 2 + (sq - m) * sk
    else:
        pairs = sq * sk
    heads = c["b"] * c["kv"] * c["g"]
    elem = 4 if c["dtype"] == "float32" else 2
    nbytes = elem * c["dh"] * (2 * heads * sq + 2 * c["b"] * c["kv"] * sk)
    return 4 * heads * pairs * c["dh"], nbytes


def sdpa(q, k, v, causal: bool):
    """F.scaled_dot_product_attention on the GQA layout (views only):
    q (B, Sq, KV, G, Dh) -> (B, KV*G, Sq, Dh), k/v -> (B, KV, Sk, Dh)."""
    import torch.nn.functional as F
    b, sq, kv, g, dh = q.shape
    o = F.scaled_dot_product_attention(
        q.reshape(b, sq, kv * g, dh).transpose(1, 2), k.transpose(1, 2),
        v.transpose(1, 2), is_causal=causal, enable_gqa=True)
    return o.transpose(1, 2).reshape(b, sq, kv, g, dh)


def within(got, want, tol: float) -> bool:
    return bool(((got.float() - want.float()).abs()
                 <= tol + tol * want.float().abs()).all())


def rel_l2(got, want) -> float:
    """||got - want|| / ||want|| over the whole tensor, in fp32."""
    want = want.float()
    return ((got.float() - want).norm() / want.norm()).item()


def queued_ms(fn, calls: int = 10) -> float:
    """Device time of one call of ``fn`` (ms): CUDA events around ``calls``
    calls enqueued behind a kernel that keeps the device busy ~10 ms, so
    the host's launch path, which bounds small calls timed back to back,
    hides behind device work."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def kernel_device_ms(fn, calls: int = 10) -> dict:
    """torch.profiler over ``calls`` calls of ``fn`` (after one warm-up):
    device ms a call of each kernel of ``flash_attention.cu``, by name.
    One short call alone leaves the profiler with no kernel record."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None) or getattr(
            e, "cuda_time_total", 0)
        name = re.search(r"fa_(tc_kernel|kernel|combine)[^(]*", e.key)
        if t and name:
            out[name.group(0)] = out.get(name.group(0), 0.0) + t / 1e3 / calls
    return out


def check_flash(c: dict, gen) -> tuple[dict, tuple]:
    """Kernel 6 vs its plain version (and SDPA, and the LM's attention
    where the case asks) on one case; the record and the inputs."""
    import torch

    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import layers as LY
    dt = getattr(torch, c["dtype"])
    b, sq, sk, kv, g, dh = (c[k] for k in ("b", "sq", "sk", "kv", "g", "dh"))
    q = torch.randn(b, sq, kv, g, dh, device="cuda", generator=gen).to(dt)
    k = torch.randn(b, sk, kv, dh, device="cuda", generator=gen).to(dt)
    v = torch.randn(b, sk, kv, dh, device="cuda", generator=gen).to(dt)
    kw = dict(causal=c["causal"], softcap=c["softcap"])
    tol = FA_TOL[c["dtype"]]
    splits = FA.kernel_splits(q, k)
    y = FA.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    yp = FA.flash_attention_plain(q, k, v, **kw)
    err = (y.float() - yp.float()).abs().max().item()
    ok = within(y, yp, tol) and y.dtype == dt and bool(
        torch.isfinite(y.float()).all())
    # bf16 also passes FA_BF16_REL_L2 against each plain version.
    l2_limit = FA_BF16_REL_L2 if c["dtype"] == "bfloat16" else float("inf")
    l2 = rel_l2(y, yp)
    ok = ok and l2 <= l2_limit
    split_err = split_l2 = None
    if splits > 1:
        ysp = FA.flash_attention_split_plain(q, k, v, splits=splits, **kw)
        split_err = (y.float() - ysp.float()).abs().max().item()
        split_l2 = rel_l2(y, ysp)
        ok = ok and within(y, ysp, tol) and split_l2 <= l2_limit
    big = sq * sk * b * kv * g > 1e8
    reps, iters = 5, (3 if big else 20)
    ms = time_ms(lambda: FA.flash_attention(q, k, v, **kw), reps=reps,
                 iters=iters)
    plain_ms = time_ms(lambda: FA.flash_attention_plain(q, k, v, **kw),
                       reps=3, iters=1 if big else 5)
    queued = queued_ms(lambda: FA.flash_attention(q, k, v, **kw))
    rec = dict(c, splits=splits, split_err=split_err, max_abs_err=err,
               rel_l2=l2, split_rel_l2=split_l2,
               max_abs_plain=yp.float().abs().max().item(), ms=ms,
               queued_ms=queued, plain_ms=plain_ms, library_ms=None)
    combine = ""
    if splits > 1:
        # The combine's share of the device time of a call (torch.profiler
        # over 10 calls: its sums can read low, the ratio is what is kept).
        per_kernel = kernel_device_ms(lambda: FA.flash_attention(q, k, v,
                                                                 **kw))
        busy = sum(per_kernel.values())
        comb = sum(t for name, t in per_kernel.items() if "fa_combine" in name)
        rec.update(profile_kernels=per_kernel, combine_ms=comb,
                   combine_share=comb / busy if busy else None)
        combine = (f" combine {comb * 1e3:.2f} of {busy * 1e3:.2f} us a call "
                   f"(torch.profiler)" if busy else
                   " combine: not measured (torch.profiler saw no kernel)")
    if c["softcap"] is None:
        ys = sdpa(q, k, v, c["causal"])
        rec["library_err"] = (ys.float() - yp.float()).abs().max().item()
        rec["library_ms"] = time_ms(lambda: sdpa(q, k, v, c["causal"]),
                                    reps=reps, iters=iters)
        rec["library_queued_ms"] = queued_ms(
            lambda: sdpa(q, k, v, c["causal"]))
        if not within(ys, yp, tol):
            fail(f"{c['label']}: SDPA is {rec['library_err']} from the "
                 f"plain version, beyond {tol} (not the same function?)")
    if c.get("vs"):
        pos = torch.arange(sq, device="cuda").expand(b, sq)
        lm = LY.attention(q, k, v, pos, pos, window=None, softcap=None,
                          impl=c["vs"])
        rec["lm_err"] = (y.float() - lm.float()).abs().max().item()
        lm_tol = LM_ATTN_TOL if c["dtype"] == "float32" else tol
        ok = ok and within(y, lm, lm_tol)
    ops, nbytes = fa_work(c)
    peak = PEAK_FP32_FLOPS if c["dtype"] == "float32" else PEAK_BF16_FLOPS
    rec.update(flops=ops, bytes=nbytes, op_ms=ops / peak * 1e3,
               byte_ms=nbytes / PEAK_HBM_BYTES_PER_S * 1e3)
    rec["bound_ms"] = max(rec["op_ms"], rec["byte_ms"])
    rec["bound_by"] = "operations" if rec["op_ms"] >= rec["byte_ms"] \
        else "bytes"
    lib = "-" if rec["library_ms"] is None else \
        f"{rec['library_ms']:.4f} ms (queued {rec['library_queued_ms']:.4f})"
    print(f"  {c['label']:<38} splits={splits} err={err:.2e} "
          f"rel_l2={l2:.2e}"
          + (f" vs split_plain {split_err:.2e} rel_l2={split_l2:.2e}"
             if split_err is not None else "")
          + f" kernel={ms:.4f} ms (queued {queued:.4f} ms) "
          f"plain={plain_ms:.4f} ms sdpa={lib} "
          f"bound={rec['bound_ms']:.4f} ms ({rec['bound_by']}, "
          f"{ops / ms / 1e9:.2f} TFLOP/s)"
          + (f" vs {c['vs']} {rec['lm_err']:.2e}" if c.get("vs") else "")
          + combine + f" {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{c['label']}: max|kernel - plain| = {err}, vs the LM's "
             f"attention {rec.get('lm_err')}, vs the split plain version "
             f"{split_err} (tolerance {tol}); relative L2 {l2}, vs the "
             f"split plain version {split_l2} (limit {l2_limit})")
    return rec, (q, k, v, y)


def flash_phase(record: dict, gen) -> dict:
    """Phase 12; returns the kernels-line row of kernel 6."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as FA
    lib = FA.load_kernel()
    spills, entry = {}, None
    for line in _build.build_log.get("flash_attention", "").splitlines():
        if "entry function" in line or "registers" in line \
                or "spill" in line:
            print(f"  ptxas: {line.strip()}")
        if "entry function" in line:
            entry = line.split("'")[1]
        elif "spill stores" in line and entry:
            spills[entry] = int(line.split("bytes spill stores")[0]
                                .split(",")[-1])
    # The bf16 instance at Dh 256 keeps a 16 x 256 fp32 accumulator a
    # warp: 128 registers a thread.
    tc256 = [n for n in spills if "fa_tc_kernelILi256E" in n]
    record["flash_bf16_dh256_spill_bytes"] = [spills[n] for n in tc256]
    print(f"  ptxas: the bf16 instance at Dh 256 spills "
          f"{[spills[n] for n in tc256]} bytes (stores)")
    for dtype, name in ((0, "float32"), (1, "bfloat16")):
        smem = {dh: lib.fa_smem_bytes(dh, dtype)
                for dh in (16, 20, 32, 64, 128, 256)}
        print(f"  shared memory per block, {name}: {smem}")
    cases = fa_cases()
    results = [check_flash(c, gen) for c in cases]
    record["flash_shapes"] = [r for r, _ in results]
    # The main path: every case once through the entry point.
    torch.cuda.synchronize()
    reset_counts()
    for (rec, (q, k, v, y)) in results:
        out = FA.flash_attention(q, k, v, causal=rec["causal"],
                                 softcap=rec["softcap"])
        if not torch.equal(out, y):
            fail(f"{rec['label']}: the entry point's output differs from "
                 f"the checked one")
    torch.cuda.synchronize()
    counts = read_counts()
    want = {name: 0 for name in counts}
    want["flash_attention"] = len(cases)
    print(f"  entry point: launches {counts}")
    if counts != want:
        fail(f"the flash-attention run launched {counts}; expected {want}")
    shapes = record["flash_shapes"]
    op_ms = sum(r["op_ms"] for r in shapes)
    byte_ms = sum(r["byte_ms"] for r in shapes)
    # SDPA computes no softcap: ``library_ms`` sums the cases without one,
    # and ``ms_where_library`` the kernel's time on the same cases; the
    # bf16 totals are the LM's serving dtype, where SDPA runs its flash
    # path (fp32 with GQA takes its math path).
    with_lib = [r for r in shapes if r["library_ms"] is not None]
    bf16_lib = [r for r in with_lib if r["dtype"] == "bfloat16"
                and not r.get("decode")]
    decode = [r for r in shapes if r.get("decode")]
    run = dict(ms=sum(r["ms"] for r in shapes),
               plain_ms=sum(r["plain_ms"] for r in shapes),
               library_ms=sum(r["library_ms"] for r in with_lib),
               library_cases=len(with_lib),
               ms_where_library=sum(r["ms"] for r in with_lib),
               bf16_cases=len(bf16_lib),
               bf16_ms=sum(r["ms"] for r in bf16_lib),
               bf16_queued_ms=sum(r["queued_ms"] for r in bf16_lib),
               bf16_library_ms=sum(r["library_ms"] for r in bf16_lib),
               bf16_library_queued_ms=sum(r["library_queued_ms"]
                                          for r in bf16_lib),
               decode_cases=len(decode),
               decode_ms=sum(r["ms"] for r in decode),
               decode_queued_ms=sum(r["queued_ms"] for r in decode),
               decode_plain_ms=sum(r["plain_ms"] for r in decode),
               decode_library_ms=sum(r["library_ms"] for r in decode
                                     if r["library_ms"] is not None),
               bound_ms=max(op_ms, byte_ms),
               bf16_max_rel_l2=max(r["rel_l2"] for r in shapes
                                   if r["dtype"] == "bfloat16"),
               bf16_max_split_rel_l2=max(
                   (r["split_rel_l2"] for r in shapes
                    if r["dtype"] == "bfloat16" and r["split_rel_l2"]
                    is not None), default=None))
    record["run_flash_attention"] = run
    print(f"  flash_attention per entry-point run ({len(cases)} cases): "
          f"kernel {run['ms']:.3f} ms, plain {run['plain_ms']:.3f} ms, "
          f"bound {run['bound_ms']:.4f} ms; on the {len(with_lib)} cases "
          f"SDPA computes: kernel {run['ms_where_library']:.3f} ms, SDPA "
          f"{run['library_ms']:.3f} ms; on the {len(bf16_lib)} bf16 ones: "
          f"kernel {run['bf16_ms']:.3f} ms (queued "
          f"{run['bf16_queued_ms']:.3f} ms), SDPA "
          f"{run['bf16_library_ms']:.3f} ms (queued "
          f"{run['bf16_library_queued_ms']:.3f} ms); on the {len(decode)} "
          f"decode-like split cases: kernel {run['decode_ms']:.4f} ms "
          f"(queued {run['decode_queued_ms']:.4f} ms), "
          f"plain {run['decode_plain_ms']:.4f} ms, SDPA "
          f"{run['decode_library_ms']:.4f} ms; bf16 relative L2 at most "
          f"{run['bf16_max_rel_l2']:.2e} vs plain, "
          f"{run['bf16_max_split_rel_l2']:.2e} vs split_plain (limit "
          f"{FA_BF16_REL_L2})")
    return {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:113",
        "launches": counts["flash_attention"],
        "max_abs_err": max(r["max_abs_err"] for r in shapes),
        "ms": run["ms"],
        "plain_ms": run["plain_ms"],
        "bound_ms": run["bound_ms"],
        "bound_by": "operations" if op_ms >= byte_ms else "bytes",
        "library_ms": run["library_ms"],
        **{key: run[key] for key in ("library_cases", "ms_where_library",
                                     "bf16_cases", "bf16_ms",
                                     "bf16_library_ms", "decode_cases",
                                     "decode_ms")},
    }


# ---------------------------------------------------------------------------
# Phase 13: LM serving at full width
# ---------------------------------------------------------------------------

LM_ARCH = "tinyllama-1.1b"
LM_RTOL = 2e-2              # bf16 served logits vs teacher-forced forward
LM_EXCESS = 2e-3            # served vs teacher-forced bf16, distance to fp32
LM_BF16_MAX = 4e-2          # bf16 logits vs the fp32 forward (PERF.md §2)
LM_PROMPTS = [128, 256, 384, 512, 640, 768, 896, 1024]
LM_NEW = 32
LM_CACHE = 2048


class recording:
    """Within the block the serving engine's prefill and decode steps keep
    their logits (host copies): ``prefills`` in admission order,
    ``decodes`` as (uids of the active slots, logits)."""

    def __init__(self, engine):
        self.engine = engine
        self.prefills, self.decodes = [], []

    def __enter__(self):
        from repro_torch.serve import engine as E
        self.saved = (E.prefill, E.decode_step)
        pre, dec = self.saved

        def prefill(*a, **kw):
            logits, caches = pre(*a, **kw)
            self.prefills.append(logits[0].float().cpu())
            return logits, caches

        def decode_step(*a, **kw):
            logits, caches = dec(*a, **kw)
            self.decodes.append(([r.uid if r else None
                                  for r in self.engine.active],
                                 logits.float().cpu()))
            return logits, caches
        E.prefill, E.decode_step = prefill, decode_step
        return self

    def __exit__(self, *exc):
        from repro_torch.serve import engine as E
        E.prefill, E.decode_step = self.saved

    def served(self, reqs) -> dict:
        """uid -> (n_tokens, V) logits behind each served token."""
        out = {r.uid: [p[None]] for r, p in zip(reqs, self.prefills)}
        for uids, logits in self.decodes:
            for slot, uid in enumerate(uids):
                if uid is not None:
                    out[uid].append(logits[slot][None])
        return {uid: __import__("torch").cat(rows) for uid, rows in
                out.items()}


def busy_share(fn) -> tuple[float, float, int, list]:
    """torch.profiler over one call of ``fn`` (after a warm-up): (host
    wall ms, device busy ms, kernel launches, device entries by time as
    (name, ms)); device busy sums the device-side events."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        wall = (time.monotonic() - t0) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))
    events = sorted((e for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=dev_us, reverse=True)
    busy = sum(dev_us(e) for e in events) / 1e3
    launches = sum(e.count for e in prof.key_averages()
                   if "LaunchKernel" in e.key)
    return wall, busy, launches, [(e.key, dev_us(e) / 1e3) for e in events]


def lm_phase(record: dict) -> None:
    """Phase 13."""
    import numpy as np
    import torch

    from repro_torch.launch import serve as launch
    from repro_torch.models import registry as reg
    from repro_torch.models import transformer as TF
    from repro_torch.serve import Request, ServeConfig, ServingEngine

    cfg = reg.get(LM_ARCH).config
    rec = record["lm"] = {"arch": LM_ARCH,
                          "params": cfg.param_count()}
    print(f"  config {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, "
          f"{cfg.n_heads} heads / {cfg.kv_heads} KV, Dh {cfg.hd}, vocab "
          f"{cfg.vocab}, {cfg.param_count() / 1e9:.3f}B params (fp32), "
          f"compute {cfg.dtype}")

    # (a) the launcher's LM branch with its defaults.
    args = launch.build_parser().parse_args(
        ["--arch", LM_ARCH, "--device", "cuda", "--seed", "0"])
    reset_counts()
    t0 = time.monotonic()
    engine, steps, seconds = launch.serve_lm(cfg, args)
    rec["launcher_wall_s"] = time.monotonic() - t0
    rec["launcher_serve_s"] = seconds
    counts = read_counts()
    print(launch.report_lm(engine, steps, seconds))
    print(f"  serve_lm: {rec['launcher_wall_s']:.2f} s in all, of which "
          f"{rec['launcher_wall_s'] - seconds:.2f} s drawing the params on "
          f"the CPU and moving them; launches {counts}")
    done = sorted((r.uid, len(r.output)) for r in engine.completed)
    if done != [(i, args.max_new_tokens) for i in range(args.requests)]:
        fail(f"serve_lm completed {done}")
    if any(counts.values()):
        fail(f"the LM path launched a kernel: {counts}")
    params = engine.params
    del engine

    # (b) the engine at long prompts, its logits kept.
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, cfg.vocab, n).astype(np.int32)
               for n in LM_PROMPTS]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    engine = ServingEngine(params, cfg, ServeConfig(slots=BATCH,
                                                    cache_len=LM_CACHE),
                           device="cuda")
    reqs = [Request(uid=i, prompt=p, max_new_tokens=LM_NEW)
            for i, p in enumerate(prompts)]
    for r in reqs:
        engine.submit(r)
    with recording(engine) as log:
        t0 = time.monotonic()
        engine.run_until_drained()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    rec["engine_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    toks = sum(len(r.output) for r in engine.completed)
    rec.update(engine_s=wall, tokens=toks, tokens_per_s=toks / wall)
    print(f"  engine: {len(engine.completed)} requests / {toks} tokens in "
          f"{wall:.3f} s ({toks / wall:.1f} tok/s, prefills included); "
          f"peak memory {rec['engine_peak_gb']:.2f} GB")
    if sorted((r.uid, len(r.output)) for r in engine.completed) \
            != [(i, LM_NEW) for i in range(len(prompts))]:
        fail("the engine did not serve every request its token count")
    served = log.served(reqs)
    # bf16 at full depth: the served and teacher-forced bf16 logits (the
    # same tokens through other shapes) differ by ~2e-2 (relative norm),
    # and each lies ~3e-2 from the fp32 forward (PERF.md).  So the served
    # logits are held to the bf16 path's own error: no farther from the
    # teacher-forced bf16 logits than those are from the fp32 forward on
    # the same params, and as far from that fp32 forward as the
    # teacher-forced bf16 logits are, give or take LM_EXCESS; and the bf16
    # path's own error is capped at LM_BF16_MAX, above its readings.
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    rows = []
    under, checked = 0, 0
    with torch.inference_mode():
        for r in reqs:
            seq = torch.as_tensor(np.concatenate(
                [r.prompt, np.asarray(r.output[:-1], np.int32)]),
                dtype=torch.long, device="cuda")[None]
            p = len(r.prompt)
            tf, ex = (TF.forward(params, c, tokens=seq, mode="train")[0]
                      [0, p - 1:].float().cpu() for c in (cfg, cfg32))
            got = served[r.uid]
            d = dict(uid=r.uid, prompt=p,
                     served_tf=((got - tf).norm() / tf.norm()).item(),
                     served_fp32=((got - ex).norm() / ex.norm()).item(),
                     tf_fp32=((tf - ex).norm() / ex.norm()).item())
            rows.append(d)
            top2 = tf.topk(2, dim=-1).values
            sure = (top2[:, 0] - top2[:, 1]) > LM_RTOL * tf.abs().amax(-1)
            agree = tf.argmax(-1) == torch.as_tensor(r.output)
            under += int((~sure).sum())
            checked += int(sure.sum())
            print(f"  request {r.uid} (prompt {p}): served vs teacher-forced "
                  f"bf16 {d['served_tf']:.3e}; vs the fp32 forward: served "
                  f"{d['served_fp32']:.3e}, teacher-forced bf16 "
                  f"{d['tf_fp32']:.3e}")
            if d["served_tf"] > max(LM_RTOL, d["tf_fp32"]) \
                    or abs(d["served_fp32"] - d["tf_fp32"]) > LM_EXCESS \
                    or max(d["tf_fp32"], d["served_fp32"]) > LM_BF16_MAX:
                fail(f"request {r.uid}: the served logits stray beyond the "
                     f"bf16 path's own error: {d}")
            if not bool(agree[sure].all()):
                bad = (~agree & sure).nonzero().flatten().tolist()
                fail(f"request {r.uid}: argmax of the teacher-forced "
                     f"logits disagrees with the served token at {bad}")
    rec.update(logits=rows, argmax_checked=checked,
               argmax_under_margin=under)
    print(f"  served vs teacher-forced bf16 logits: worst relative norm "
          f"{max(d['served_tf'] for d in rows):.3e} (gate: the bf16 "
          f"path's own error, worst {max(d['tf_fp32'] for d in rows):.3e} "
          f"from fp32, or {LM_RTOL}); the engine's "
          f"excess over teacher-forced bf16, vs fp32: worst "
          f"{max(abs(d['served_fp32'] - d['tf_fp32']) for d in rows):.1e} "
          f"(<= {LM_EXCESS}); bf16 vs fp32 at most {LM_BF16_MAX}; argmax equal at all {checked} positions with "
          f"a top-2 margin above {LM_RTOL} * max|logit|, {under} under it")

    # Where the time goes: prefill per prompt length, the decode step.
    prefill_ms = {}
    with torch.inference_mode():
        for p in prompts:
            t = torch.as_tensor(p, dtype=torch.long, device="cuda")[None]
            prefill_ms[len(p)] = time_ms(
                lambda: TF.prefill(params, cfg, t, cache_len=LM_CACHE),
                reps=3, iters=1)
        caches, pos = engine.caches, torch.full((BATCH,), 1100,
                                                device="cuda")
        tok = torch.zeros(BATCH, dtype=torch.long, device="cuda")
        decode_ms = time_ms(lambda: TF.decode_step(params, cfg, tok, caches,
                                                   pos), reps=5, iters=5)
        steps = 8
        wall_ms, busy_ms, n_launch, top = busy_share(lambda: [
            TF.decode_step(params, cfg, tok, caches, pos)[0].argmax(-1)
            .tolist() for _ in range(steps)])
    cast_ms = sum(ms for key, ms in top if "copy" in key.lower())
    top = [(key[:70], round(ms / steps, 4)) for key, ms in top[:8]]
    rec.update(prefill_ms=prefill_ms, decode_ms=decode_ms,
               decode_wall_ms=wall_ms / steps, decode_busy_ms=busy_ms / steps,
               decode_idle=1 - busy_ms / wall_ms,
               decode_copy_ms=cast_ms / steps, decode_top=top,
               decode_launches=n_launch / steps)
    print(f"  prefill (1 prompt, CUDA events): "
          f"{ {n: round(ms, 3) for n, ms in prefill_ms.items()} } ms")
    print(f"  decode step (4 slots, cache {LM_CACHE}): {decode_ms:.3f} ms "
          f"(CUDA events); under torch.profiler {wall_ms / steps:.3f} ms "
          f"wall, {busy_ms / steps:.3f} ms device busy, idle "
          f"{1 - busy_ms / wall_ms:.1%}; {n_launch / steps:.0f} kernel "
          f"launches a step; dtype casts and copies {cast_ms / steps:.3f} "
          f"ms a step")
    print(f"  decode step's top device entries (ms a step): {top[:6]}")
    del engine, caches

    # (c) fp32: the engine equals naive greedy decoding.
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    engine = ServingEngine(params, cfg32, ServeConfig(slots=BATCH,
                                                      cache_len=LM_CACHE),
                           device="cuda")
    for i, p in enumerate(prompts[:4]):
        engine.submit(Request(uid=i, prompt=p, max_new_tokens=LM_NEW))
    t0 = time.monotonic()
    engine.run_until_drained()
    with torch.inference_mode():
        for r in engine.completed:
            cur = torch.as_tensor(r.prompt, dtype=torch.long,
                                  device="cuda")[None]
            ref = []
            for _ in range(len(r.output)):
                logits, _, _ = TF.forward(params, cfg32, tokens=cur,
                                          mode="train")
                nxt = int(logits[0, -1].argmax())
                ref.append(nxt)
                cur = torch.cat([cur, torch.tensor([[nxt]], device="cuda")],
                                1)
            if r.output != ref:
                fail(f"fp32 request {r.uid}: served {r.output} but greedy "
                     f"decoding gives {ref}")
    rec["fp32_greedy_s"] = time.monotonic() - t0
    print(f"  fp32: {len(engine.completed)} requests x {LM_NEW} tokens "
          f"equal naive greedy decoding token for token "
          f"({rec['fp32_greedy_s']:.1f} s)")
    if any(read_counts().values()):
        fail(f"the LM path launched a kernel: {read_counts()}")


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
    launches, record, params, zc_reqs = serve(record)
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

    print("== 7. backward kernel vs plain on the card")
    # {shape: {"512": DCLs of that shape in one training step}}
    bwd_step: dict[tuple, dict[str, int]] = {}
    for dims in bucket_layer_dims(CONFIG_BOUNDED, 512).values():
        key = (dims["h"], dims["w"], dims["c"], dims["m"], dims["stride"])
        cnt = bwd_step.setdefault(key, {})
        cnt["512"] = cnt.get("512", 0) + 1
    b_cases = [dict(label=f"{h}x{w}x{c}->{m} s{s}", n=TRAIN_BATCH, h=h,
                    w=w, c=c, m=m, stride=s, dilation=1, per_step=cnt)
               for (h, w, c, m, s), cnt in bwd_step.items()]
    b_cases += [
        dict(label="ragged 17x23x64->64 s1", n=2, h=17, w=23, c=64, m=64,
             stride=1, dilation=1),
        dict(label="dilation2 B1.5 20x20x64->64", n=2, h=20, w=20, c=64,
             m=64, stride=1, dilation=2, bound=1.5),
        dict(label="odd s2 15x15x32->48 tc16", n=1, h=15, w=15, c=32,
             m=48, stride=2, dilation=1, tile_c=16),
    ]
    record["bwd_shapes"] = [check_bwd_kernel(c, gen) for c in b_cases]
    if any(r["tiles"][2] >= r["c"] for r in record["bwd_shapes"]):
        fail("a backward case has tile_c = C: the C loop is untested")
    step = [r for r in record["bwd_shapes"] if r.get("per_step")]
    k2_step = {k: sum(r[k] * r["per_step"]["512"] for r in step)
               for k in ("ms", "bound_fp32_ms", "bound_3xtf32_ms")}
    record["bwd_step_ms"] = k2_step
    print(f"  kernel 2 a training step ({sum(r['per_step']['512'] for r in step)}"
          f" DCLs): {k2_step['ms']:.3f} ms; CUDA-core design: "
          f"{BWD_STEP_MS_BEFORE} ms, half of it {BWD_STEP_MS_HALF} ms; bounds fp32 "
          f"{k2_step['bound_fp32_ms']:.4f} ms "
          f"({k2_step['bound_fp32_ms'] / k2_step['ms']:.1%}), 3xTF32 "
          f"{k2_step['bound_3xtf32_ms']:.4f} ms "
          f"({k2_step['bound_3xtf32_ms'] / k2_step['ms']:.1%})")
    print("  no single PyTorch call computes the bounded deformable conv's "
          "backward, so there is no library time to compare with")

    print("== 8. train")
    bwd_launches, step0 = train(record)
    shapes = [r for r in record["bwd_shapes"] if r.get("per_step")]
    # Bounds per run: the 3xTF32 products at the TF32 rate (the lower,
    # the row's bound) and the fp32 flops on the CUDA cores.
    run_b, by = per_run(shapes, {"512": TRAIN_STEPS}, bwd_launches,
                        PEAK_TF32_FLOPS / 3, "deform_conv_bwd")
    run_fp32, _ = per_run(shapes, {"512": TRAIN_STEPS}, bwd_launches,
                          PEAK_FP32_FLOPS, "deform_conv_bwd")
    run_b["bound_fp32_ms"] = run_fp32["bound_ms"]
    record["run_deform_conv_bwd"] = run_b
    kernels["kernels"].append({
        "name": "deform_conv_bwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/deform_conv_bwd.cu",
        "replaces": "src/repro/kernels/deform_conv_bwd.py:304",
        "launches": bwd_launches,
        "max_abs_err": max(r["max_abs_err"] for r in record["bwd_shapes"]),
        "ms": run_b["ms"],
        "plain_ms": run_b["plain_ms"],
        "bound_ms": run_b["bound_ms"],
        "bound_by": by,
        "bound_note": "3xTF32 (three tf32 products a product) at 494.7 "
                      "TFLOP/s; bound_fp32_ms: fp32 on the CUDA cores",
        "bound_fp32_ms": run_b["bound_fp32_ms"],
        "library_ms": None,
    })
    per_step_ms = run_b["ms"] / TRAIN_STEPS
    print(f"  deform_conv_bwd per {TRAIN_STEPS}-step run: {bwd_launches} "
          f"launches, kernel {run_b['ms']:.3f} ms, plain "
          f"{run_b['plain_ms']:.3f} ms, bound {run_b['bound_ms']:.4f} ms "
          f"(3xTF32, {by}; fp32 CUDA cores {run_b['bound_fp32_ms']:.4f} "
          f"ms); per step {per_step_ms:.3f} ms of the backward's "
          f"{record['train']['backward_ms']:.3f} ms")

    print("== 9. sampling, banded forward and matmul kernels vs plain on "
          "the card")
    five: dict[tuple, dict] = {}
    for dims in bucket_layer_dims(CONFIG_BOUNDED, 512).values():
        h, w, c, m, s = (dims["h"], dims["w"], dims["c"], dims["m"],
                         dims["stride"])
        five.setdefault((h, w, c, m, s), dict(
            label=f"{h}x{w}x{c}->{m} s{s}", n=BATCH, h=h, w=w, c=c, m=m,
            stride=s, dilation=1))
    five_cases = list(five.values())
    edge = [
        dict(label="ragged 17x23x64->64 s1", n=2, h=17, w=23, c=64, m=64,
             stride=1, dilation=1),
        dict(label="dilation2 B1.5 20x20x64->64", n=2, h=20, w=20, c=64,
             m=64, stride=1, dilation=2, bound=1.5),
    ]
    record["sample_shapes"] = [r for case in five_cases + edge
                               for r in check_sample_kernels(case, gen)]
    banded_cases = [dict(label=f"{h}x{w}x{c}->{m} s{s}", n=BATCH, h=h, w=w,
                         c=c, m=m, stride=s, dilation=1, per_step=cnt)
                    for (h, w, c, m, s), cnt in per_step.items()] + edge
    record["banded_shapes"] = [check_banded_kernel(case, gen)
                               for case in banded_cases]
    print("  no single PyTorch call computes the banded fused forward, so "
          "there is no library time to compare with")
    record["mm_shapes"] = [check_matmul(*shape, gen) for shape in MM_SHAPES]
    entry = entry_points(five_cases, gen)
    record["entry_point_launches"] = entry
    five_labels = {case["label"] for case in five_cases}
    for name, replaces in (
            ("deform_sample_zerocopy",
             "src/repro/kernels/band_pipeline.py:644 (via "
             "src/repro/kernels/deform_sample.py:52)"),
            ("deform_sample_banded", "src/repro/kernels/deform_sample.py:107")):
        shapes = [dict(r, per_step={"run": 1}) for r in record["sample_shapes"]
                  if r["kernel"] == name and r["label"] in five_labels]
        run_s, by = per_run(shapes, {"run": 1}, entry[name],
                            PEAK_FP32_FLOPS, name)
        run_s["library_ms"] = sum(r["library_ms"] for r in shapes)
        record[f"run_{name}"] = run_s
        kernels["kernels"].append({
            "name": name,
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/deform_sample.cu",
            "replaces": replaces,
            "launches": entry[name],
            "max_abs_err": max(r["max_abs_err"] for r in
                               record["sample_shapes"] if r["kernel"] == name),
            "ms": run_s["ms"],
            "plain_ms": run_s["plain_ms"],
            "bound_ms": run_s["bound_ms"],
            "bound_by": by,
            "library_ms": run_s["library_ms"],
        })
        print(f"  {name} per entry-point run: {entry[name]} launches, kernel "
              f"{run_s['ms']:.3f} ms, plain {run_s['plain_ms']:.3f} ms, "
              f"grid_sample {run_s['library_ms']:.3f} ms, bound "
              f"{run_s['bound_ms']:.4f} ms ({by})")

    print("== 10. serve banded")
    banded_launches = serve_banded(record, params, zc_reqs)
    shapes = [r for r in record["banded_shapes"] if r.get("per_step")]
    run_4, by = per_run(shapes, record["serve_banded"]["steps_per_bucket"],
                        banded_launches, PEAK_FP32_FLOPS,
                        "deform_conv_banded")
    run_4["prep_ms"] = sum(r["prep_ms"] * r["launches_in_run"]
                           for r in shapes)
    record["run_deform_conv_banded"] = run_4
    kernels["kernels"].append({
        "name": "deform_conv_banded",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/deform_conv_fused.cu",
        "replaces": "src/repro/kernels/deform_conv_fused.py:130",
        "launches": banded_launches,
        "max_abs_err": max(r["max_abs_err"] for r in record["banded_shapes"]),
        "ms": run_4["ms"],
        "plain_ms": run_4["plain_ms"],
        "bound_ms": run_4["bound_ms"],
        "bound_by": by,
        "library_ms": None,
    })
    print(f"  deform_conv_banded per served run: {banded_launches} launches, "
          f"kernel {run_4['ms']:.3f} ms, plain {run_4['plain_ms']:.3f} ms, "
          f"bound {run_4['bound_ms']:.4f} ms ({by}); bands and weights "
          f"prepared in {run_4['prep_ms']:.3f} ms")

    print("== 11. train banded")
    train_banded(record, step0)
    del step0

    mm = record["mm_shapes"]
    op_ms = sum(r["op_ms"] for r in mm)
    byte_ms = sum(r["bytes"] for r in mm) / PEAK_HBM_BYTES_PER_S * 1e3
    record["run_matmul"] = run_mm = dict(
        ms=sum(r["ms"] for r in mm), plain_ms=sum(r["plain_ms"] for r in mm),
        library_ms=sum(r["library_ms"] for r in mm),
        bound_ms=max(op_ms, byte_ms))
    kernels["kernels"].append({
        "name": "matmul",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/matmul.cu",
        "replaces": "src/repro/kernels/matmul.py:63",
        "launches": entry["matmul"],
        "max_abs_err": max(r["max_abs_err"] for r in mm),
        "ms": run_mm["ms"],
        "plain_ms": run_mm["plain_ms"],
        "bound_ms": run_mm["bound_ms"],
        "bound_by": "operations" if op_ms >= byte_ms else "bytes",
        "library_ms": run_mm["library_ms"],
    })
    print(f"  matmul per entry-point run: {entry['matmul']} launches, kernel "
          f"{run_mm['ms']:.3f} ms, plain {run_mm['plain_ms']:.3f} ms, "
          f"torch.matmul {run_mm['library_ms']:.3f} ms, bound "
          f"{run_mm['bound_ms']:.4f} ms")

    print("== 12. flash attention (kernel 6) vs plain on the card")
    kernels["kernels"].append(flash_phase(record, gen))

    print("== 13. LM serving at full width")
    lm_phase(record)

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
