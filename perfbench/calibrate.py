"""Readings that set the benchmark's numbers, many seeds in one process
(one import, one kernel build).

    python3 perfbench/calibrate.py readings --workload <cell> \
        --seeds 12 --controls 3 --seconds 3 [--first-seed N]
    python3 perfbench/calibrate.py knee --workload <open cell> \
        --rates 120,150,180 --seconds 10

``readings`` runs the cell's program on each seed and then the control
(the reference one precision down in the program's place) on
``--controls`` more (``--fault half_batch`` plants that fault in the
program first), and prints one JSON line a run: its comparison's
numbers, its end-to-end values and notes.  A limit lies between the
program's largest reading and the control's smallest.  ``knee`` runs an
open-loop cell at each rate in turn (the traffic file's other
parameters kept) and prints the p95 latency, the requests served a
second and the backlog when the arrivals stop; the knee is the highest
rate whose backlog stays at a step or two.
"""
import time

T0 = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import pb_spec  # noqa: E402
import run as runner  # noqa: E402


def _line(kind, seed, outcome, **extra):
    print(json.dumps({
        "kind": kind, "seed": seed, "correct": outcome.correct,
        "checks": {k: v for k, (v, _) in outcome.checks.items()},
        "values": outcome.values, "attempted": outcome.attempted,
        "failed": outcome.failed, "notes": outcome.notes,
        "memory_peak_bytes": outcome.memory_peak_bytes, **extra},
        default=float), flush=True)


def plant_half_batch() -> None:
    """The training loss of the first half of each batch: half the
    batch left out, the mean taken over the rest."""
    from repro_torch.models import resnet_dcn as R
    train_loss = R.train_loss

    def half(params, cfg, batch, **kw):
        n = batch["images"].shape[0] // 2
        return train_loss(params, cfg, {k: v[:n] for k, v in batch.items()},
                          **kw)

    R.train_loss = half


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("mode", choices=("readings", "knee"))
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=3_000_000_001)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--rates", default="")
    ap.add_argument("--fault", choices=("half_batch",), default=None,
                    help="plant a fault in the program for every seed")
    args = ap.parse_args(argv)

    root = pb_spec.ROOT
    runner._environment(root)
    doc = pb_spec.load_benchmark(root)
    cell = pb_spec.workload(doc, args.workload)
    cfg = pb_spec.config(doc, cell["config"], root)
    traffic = pb_spec.traffic(cell["traffic"], root)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    driver = pb_spec.driver(cfg)
    if args.fault == "half_batch":
        plant_half_batch()
    print(json.dumps({"card": torch.cuda.get_device_name(0),
                      "power_limit": runner.power_limit()}), flush=True)
    if args.mode == "readings":
        for i in range(args.seeds + args.controls):
            seed = args.first_seed + 7919 * i
            control = i >= args.seeds
            out = driver.run(cfg, traffic, seed=seed, seconds=args.seconds,
                             trace=False, device="cuda",
                             t0=time.monotonic(), control=control)
            kind = "control" if control else (args.fault or "program")
            _line(kind, seed, out)
    else:
        for rate in (float(r) for r in args.rates.split(",")):
            out = driver.run(cfg, dict(traffic, rate_per_s=rate),
                             seed=args.first_seed, seconds=args.seconds,
                             trace=False, device="cuda",
                             t0=time.monotonic())
            _line("knee", args.first_seed, out, rate_per_s=rate,
                  served_per_s=(out.attempted - out.failed) / args.seconds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
