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

The kernels line gives ``ms``, ``plain_ms`` and ``bound_ms`` per served
run: each shape's phase-3 time times the launches of that shape in the
run of phase 4, summed.

TF32 is off for every fp32 matmul and convolution.  Without a GPU, or
without the rest of the repository beside it, the script prints no result
and exits 2.  Details go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out" / "chip_smoke.json"

# H100 SXM, NVIDIA's data sheet: fp32 on CUDA cores, HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES_PER_S = 3.35e12
KERNEL_RTOL = 1e-5
SERVE_RTOL = 1e-3
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
    from repro_torch.kernels.deform_conv_fused import \
        deform_conv_fused_zerocopy
    from repro_torch.launch import serve as launch
    from repro_torch.models import resnet_dcn as R

    cfg = dataclasses.replace(CONFIG_BOUNDED, use_kernel=True)
    print(f"  config {cfg.name}: stages {cfg.stage_sizes}, widths "
          f"{cfg.widths}, {cfg.num_dcn} DCLs, B={cfg.offset_bound}, "
          f"{cfg.num_classes} classes")
    params = perturb_offsets(R.init_params(cfg, seed=0, device="cuda"), 1)
    args = launch.build_parser().parse_args(
        ["--arch", cfg.name, "--buckets", BUCKETS, "--requests", "8",
         "--slots", str(BATCH), "--device", "cuda", "--seed", "0"])
    launch.serve_detection(cfg, args, params=params)        # warm-up

    deform_conv_fused_zerocopy.launches = 0
    engine, images, seconds = launch.serve_detection(cfg, args,
                                                     params=params)
    launches = deform_conv_fused_zerocopy.launches
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
    return launches, record


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
    launches, record = serve(record)

    # Launches of each shape in the served run, from the steps it took.
    steps_per_bucket = record["serve"]["steps_per_bucket"]
    for r in main_path:
        r["launches_in_run"] = sum(n * steps_per_bucket.get(b, 0)
                                   for b, n in r["per_step"].items())
    if sum(r["launches_in_run"] for r in main_path) != launches:
        fail(f"phase-3 shapes account for "
             f"{sum(r['launches_in_run'] for r in main_path)} launches, "
             f"the served run made {launches}")
    run = {k: sum(r[k] * r["launches_in_run"] for r in main_path)
           for k in ("ms", "plain_ms", "prep_ms", "flops", "bytes")}
    run["bound_ms"] = max(run["flops"] / PEAK_FP32_FLOPS,
                          run["bytes"] / PEAK_HBM_BYTES_PER_S) * 1e3
    bound_by = "operations" if run["flops"] / PEAK_FP32_FLOPS \
        >= run["bytes"] / PEAK_HBM_BYTES_PER_S else "bytes"
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
    record["kernels"] = kernels["kernels"]
    record["seconds"] = time.monotonic() - t_start
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps(record, indent=2))
    fwd = record["serve"]["forward_ms_in_run"]
    print(f"  (ms, plain_ms and bound_ms are per served run: the sum over "
          f"its {launches} DCL launches, {run['ms'] / fwd:.0%} of its "
          f"steps' {fwd:.3f} ms of forward; input preparation "
          f"{run['prep_ms']:.3f} ms; details in "
          f"{OUT.relative_to(ROOT)}; {record['seconds']:.0f} s in all)")
    print(card)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
