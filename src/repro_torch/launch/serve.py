"""Serve a DCL detection model through the port's engine, at full width.

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch resnet50_dcn_bounded --buckets 256,512 --requests 8 \
        [--slots 4] [--quant fp32_kernel] [--deadline 30] [--device cuda] \
        [--telemetry OUT.json]

Params are random, from ``--seed``.  The device defaults to ``cuda``; with
no GPU the launcher raises unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import resnet50_dcn as configs
from repro_torch.models import resnet_dcn as R
from repro_torch.serve import LADDER, DCLServeConfig, DCLServingEngine


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True, choices=sorted(configs.ARCHS))
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--buckets", default="256,512",
                    help="comma-separated square shape buckets")
    ap.add_argument("--quant", default="fp32_kernel", choices=LADDER)
    ap.add_argument("--deadline", type=float, default=None,
                    help="per-request deadline in seconds")
    ap.add_argument("--queue-capacity", type=int, default=64)
    ap.add_argument("--shed-policy", default="reject_new",
                    choices=("reject_new", "shed_oldest"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    ap.add_argument("--telemetry", default=None,
                    help="write engine telemetry JSON here")
    return ap


def serve_detection(cfg: R.ResNetDCNConfig, args, *, params=None):
    """Build the engine, submit ``args.requests`` seeded images spread
    over the buckets, drain it.  Returns ``(engine, images, seconds)``;
    ``params`` replaces the seeded init when given."""
    if cfg.offset_bound is None:
        cfg = dataclasses.replace(cfg, offset_bound=2.0)
    cfg = dataclasses.replace(cfg, use_kernel=True)
    buckets = tuple(int(b) for b in args.buckets.split(","))
    if params is None:
        params = R.init_params(cfg, seed=args.seed, device=args.device)
    engine = DCLServingEngine(
        params, cfg,
        DCLServeConfig(buckets=buckets, slots=args.slots, quant=args.quant,
                       queue_capacity=args.queue_capacity,
                       shed_policy=args.shed_policy,
                       default_deadline=args.deadline),
        device=args.device)
    rng = np.random.RandomState(args.seed)
    images = [rng.randn(b, b, 3).astype(np.float32)
              for b in (buckets[i % len(buckets)]
                        for i in range(args.requests))]
    for img in images:
        engine.submit(img)
    t0 = time.monotonic()
    engine.run_until_drained()
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    return engine, images, time.monotonic() - t0


def report(engine: DCLServingEngine, seconds: float) -> str:
    ok = [r for r in engine.completed if r.outcome == "ok"]
    lats = sorted(r.latency_s() for r in ok)
    dev = engine.device
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    lines = [f"served {len(ok)}/{len(engine.completed)} requests in "
             f"{engine.steps} batched steps ({seconds:.3f}s, "
             f"{len(ok) / max(seconds, 1e-9):.2f} images/s on {where})"]
    if lats:
        lines.append(f"  p50 latency {lats[len(lats) // 2] * 1e3:.1f} ms, "
                     f"max {lats[-1] * 1e3:.1f} ms")
    lines.append(f"  counters: {engine.counters}")
    return "\n".join(lines)


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    engine, _, seconds = serve_detection(configs.get(args.arch), args)
    print(report(engine, seconds))
    if args.telemetry:
        from repro_torch.obs.metrics import dump_telemetry
        dump_telemetry(args.telemetry, engine.telemetry())
        print(f"  telemetry -> {args.telemetry}")


if __name__ == "__main__":
    main()
