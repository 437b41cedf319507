"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The cell, its configuration and its
traffic mix are found by name from ``BENCHMARK.json``; the configuration
names the driver module that runs it (``pb_dcn``).  ``--trace 0`` reports
the cell's end-to-end metrics, ``--trace 1`` its per-layer metrics from
a ``torch.profiler`` trace of the window.  The last line of standard
output is one JSON object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` also ``breakdown``, and last
``checks``: each number the comparison held beside its limit); the last
lines of standard error repeat the checks.

Exits 2 without a result when CUDA is missing or has fewer devices than
the cell asks for, 3 when JAX or the JAX package was loaded.  The
program is the package under ``src/`` of the checkout; its kernels build
into the checkout's ``build/`` directory.

``--control 1`` puts the reference, one precision below the stated one,
in the program's place before the comparison, which must then fail: a
check of the comparison, never part of the benchmark's runs.
"""
import time

T0 = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import pb_guard  # noqa: E402
import pb_spec  # noqa: E402


def _environment(root) -> None:
    """Caches inside the checkout at fixed paths; no JAX from libraries
    that would load it on their own."""
    os.environ["USE_FLAX"] = "0"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton_cache")
    src = str(root / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def assemble(doc: dict, cell: dict, outcome, *, trace: bool,
             device: dict) -> dict:
    """The result line of a run (module docstring)."""
    name = cell["name"]
    metrics = {}
    if trace:
        for m in pb_spec.metrics_of(doc, "per_layer", name):
            value = pb_spec.reader(m["name"])(outcome.run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        t = outcome.run.trace
        device = dict(device, busy_s=t["busy_s"], window_s=t["window_s"])
    else:
        for m in pb_spec.metrics_of(doc, "end_to_end", name):
            if m["name"] not in outcome.values:
                raise KeyError(f"cell {name!r} measured no {m['name']!r}")
            metrics[m["name"]] = {"value": outcome.values[m["name"]],
                                  "unit": m["unit"]}
    line = {"correct": outcome.correct, "attempted": outcome.attempted,
            "failed": outcome.failed, "metrics": metrics, "device": device}
    if trace:
        line["breakdown"] = {"device_ops": t["device_ops"],
                             "idle_gaps": t["idle_gaps"]}
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in outcome.checks.items()}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    root = pb_spec.ROOT
    _environment(root)
    doc = pb_spec.load_benchmark(root)
    cell = pb_spec.workload(doc, args.workload)
    cfg = pb_spec.config(doc, cell["config"], root)
    traffic = pb_spec.traffic(cell["traffic"], root)

    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        print(f"cell {cell['name']!r} needs {cell['chips']} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    driver = pb_spec.driver(cfg)
    bad = pb_guard.forbidden_modules(sys.modules)
    if bad:
        print(f"forbidden modules loaded at set-up: {bad}", file=sys.stderr)
        return 3
    outcome = driver.run(cfg, traffic, seed=args.seed, seconds=args.seconds,
                         trace=bool(args.trace), device="cuda", t0=T0,
                         control=bool(args.control))
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"],
              "memory_peak_bytes": outcome.memory_peak_bytes}
    line = assemble(doc, cell, outcome, trace=bool(args.trace),
                    device=device)
    bad = pb_guard.forbidden_modules(sys.modules)
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    print(json.dumps({"notes": outcome.notes,
                      "power_limit": power_limit()}), file=sys.stderr)
    for k, (v, lim) in outcome.checks.items():
        print(f"check {k}: {v!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
