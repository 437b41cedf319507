"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration, whose file is
the ``file`` of its entry in ``configs``, and a traffic mix, which is
``perfbench/traffic/<traffic>.json``.  A per-layer metric's reader is
``perfbench/metrics/<name>.py``, or, for a metric ``<stem>.<suffix>``,
``perfbench/metrics/<stem>.py``: the suffix names the cells a quantity
is split over, and one reader serves them all.  Each reader defines
``read(run) -> float | None``.

A configuration names its driver module (``"driver"``, found on the
import path beside this file), which runs the configuration's cells and
defines:

* ``run(cfg, traffic, *, seed, seconds, trace, device, t0,
  control=False) -> Outcome``: one run of a cell (``pb_dcn`` documents
  the ``Outcome`` and the ``Run`` its readers read);
* ``cpu_config(cfg) -> cfg``: the configuration cut for the CPU tests,
  with its limits there;
* ``cpu_traffic(traffic) -> traffic``: the traffic shrunk for those
  tests.

So a configuration of another architecture joins the benchmark with new
files only: its driver, its plain reference, its configuration file and
any readers of its own.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import pathlib
import re

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = ("command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer")


def load_benchmark(root: pathlib.Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def problems(doc: dict) -> list[str]:
    """What in ``doc`` breaks the character rules on names and units,
    or leaves a name twice (empty when nothing does)."""
    out = []
    if tuple(sorted(doc)) != tuple(sorted(TOP_KEYS)):
        out.append(f"top-level keys {sorted(doc)} != {sorted(TOP_KEYS)}")
    names = []
    for c in doc.get("configs", []):
        names.append(("config", c["name"]))
        names += [("reduced key", k) for k in c.get("reduced", [])]
    for w in doc.get("workloads", []):
        names += [("workload", w["name"]), ("config", w["config"]),
                  ("traffic", w["traffic"])]
    for kind in ("end_to_end", "per_layer"):
        for m in doc.get(kind, []):
            names.append(("metric", m["name"]))
            if not UNIT_RE.match(m["unit"]):
                out.append(f"unit {m['unit']!r} of {m['name']!r}")
            if m["better"] not in ("lower", "higher"):
                out.append(f"better {m['better']!r} of {m['name']!r}")
    for what, name in names:
        if not NAME_RE.match(name):
            out.append(f"{what} name {name!r}")
    for kind in ("configs", "workloads"):
        seen = [e["name"] for e in doc.get(kind, [])]
        out += [f"{kind} {n!r} twice" for n in set(seen)
                if seen.count(n) > 1]
    metrics = [m["name"] for k in ("end_to_end", "per_layer")
               for m in doc.get(k, [])]
    out += [f"metric {n!r} twice" for n in set(metrics)
            if metrics.count(n) > 1]
    return out


def workload(doc: dict, name: str) -> dict:
    for w in doc["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                   f"{[w['name'] for w in doc['workloads']]}")


def metrics_of(doc: dict, kind: str, cell: str) -> list[dict]:
    """The ``kind`` ("end_to_end" or "per_layer") metrics a cell
    reports: those without ``workloads`` and those that list it."""
    return [m for m in doc[kind]
            if "workloads" not in m or cell in m["workloads"]]


def config(doc: dict, name: str, root: pathlib.Path = ROOT) -> dict:
    for c in doc["configs"]:
        if c["name"] == name:
            with open(root / c["file"]) as f:
                return json.load(f)
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def driver(cfg: dict):
    """The driver module a configuration names (module docstring)."""
    return importlib.import_module(cfg["driver"])


def traffic(name: str, root: pathlib.Path = ROOT) -> dict:
    with open(root / "perfbench" / "traffic" / f"{name}.json") as f:
        return json.load(f)


def reader(name: str, root: pathlib.Path = ROOT):
    """The ``read`` function of a per-layer metric (module docstring)."""
    base = root / "perfbench" / "metrics"
    for stem in (name, name.split(".", 1)[0]):
        path = base / f"{stem}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(
                f"pb_metric_{stem.replace('.', '_').replace('-', '_')}",
                path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise FileNotFoundError(f"no reader for metric {name!r} under {base}")
