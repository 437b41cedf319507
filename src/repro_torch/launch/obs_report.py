"""Render the port's observability artifacts (counterpart of
``repro.launch.obs_report``, the same sections):

    PYTHONPATH=src python -m repro_torch.launch.obs_report \
        [--trace trace.jsonl] [--metrics TEL.json] [--divergence TEL.json]

* ``--trace``: a ``Tracer.export_jsonl`` dump — top span names by total
  time (count, total, self time, mean, max; JAX's table with the self
  column added) and the instant events' counts (fault firings among
  them).  A span's self time is its duration less the part its child
  spans cover;
* ``--metrics``: a ``MetricsRegistry.snapshot``, bare or under
  ``"metrics"`` of a telemetry file (the serving engine's): counters,
  gauges and the histograms' p50/p99 per label set;
* ``--divergence``: a ``DivergenceTracker.report``, bare or under
  ``"divergence"`` of a telemetry file: per dispatch key its count,
  best time and clock, modeled bytes (each input once), the bytes its
  launches move at its tiles (``traffic_MB``), the H100 bound and the
  share of it reached (in place of the TPU traffic model's implied
  bandwidth), what
  each clock measures (``device``: the CUDA stream's time between the
  dispatch's events, host enqueue gaps included), then any named ratio
  pairs.

An engine telemetry file holds both of the last two.  The ``summarize_*``
functions return row lists; nothing prints before ``main``.
"""
from __future__ import annotations

import argparse
import json
import pathlib

__all__ = ["load_divergence", "load_metrics", "load_trace", "main",
           "summarize_divergence", "summarize_metrics", "summarize_trace"]


def load_trace(path) -> list[dict]:
    return [json.loads(line) for line in
            pathlib.Path(path).read_text().splitlines() if line.strip()]


def load_metrics(path) -> dict:
    """A registry snapshot, bare or under ``"metrics"`` (the embedded one
    wins: engine telemetry also has a top-level ``counters`` view)."""
    doc = json.loads(pathlib.Path(path).read_text())
    if isinstance(doc.get("metrics"), dict):
        return doc["metrics"]
    if "histograms" in doc or "counters" in doc:
        return doc
    raise ValueError(f"{path} holds neither a metrics snapshot nor a "
                     f"telemetry dump with a 'metrics' key")


def load_divergence(path) -> dict:
    """A divergence report, bare or under ``"divergence"``."""
    doc = json.loads(pathlib.Path(path).read_text())
    if "dispatches" in doc or "pairs" in doc:
        return doc
    if isinstance(doc.get("divergence"), dict):
        return doc["divergence"]
    raise ValueError(f"{path} holds neither a divergence report nor a "
                     f"document with a 'divergence' key")


def _children_cover(records: list[dict]) -> dict:
    """{span_id: seconds of the span that its child spans cover}, each
    child clipped to its parent and overlaps counted once."""
    kids: dict = {}
    for r in records:
        if r.get("parent_id") is not None and r.get("t1") is not None:
            kids.setdefault(r["parent_id"], []).append((r["t0"], r["t1"]))
    out = {}
    for r in records:
        if r["span_id"] not in kids:
            continue
        covered, end = 0.0, r["t0"]
        for a, b in sorted(kids[r["span_id"]]):
            a, b = max(a, end), min(b, r["t1"])
            if b > a:
                covered, end = covered + b - a, b
        out[r["span_id"]] = covered
    return out


def summarize_trace(records: list[dict], *, top: int = 10) -> list[str]:
    """Top span names by total duration (with their self time), then the
    event counts."""
    finished = [r for r in records
                if r.get("type") == "span" and r.get("dur_s") is not None]
    cover = _children_cover(finished)
    spans: dict[str, dict] = {}
    events: dict[str, int] = {}
    for r in finished:
        s = spans.setdefault(r["name"], {"n": 0, "total": 0.0, "self": 0.0,
                                         "max": 0.0})
        s["n"] += 1
        s["total"] += r["dur_s"]
        s["self"] += r["dur_s"] - cover.get(r["span_id"], 0.0)
        s["max"] = max(s["max"], r["dur_s"])
    for r in records:
        if r.get("type") == "event":
            events[r["name"]] = events.get(r["name"], 0) + 1
    rows = [f"{'span':<28}{'n':>6}{'total_s':>10}{'self_s':>10}"
            f"{'mean_ms':>10}{'max_ms':>10}"]
    for name, s in sorted(spans.items(),
                          key=lambda kv: -kv[1]["total"])[:top]:
        rows.append(f"{name:<28}{s['n']:>6}{s['total']:>10.3f}"
                    f"{s['self']:>10.3f}"
                    f"{s['total'] / s['n'] * 1e3:>10.2f}"
                    f"{s['max'] * 1e3:>10.2f}")
    if events:
        rows += ["", f"{'event':<28}{'n':>6}"]
        rows += [f"{name:<28}{events[name]:>6}" for name in sorted(events)]
    return rows


def _fmt_labels(labels: dict) -> str:
    if not labels:
        return "-"
    return ",".join(f"{k}={v}" for k, v in sorted(labels.items()))


def summarize_metrics(snapshot: dict) -> list[str]:
    """Counters and gauges, then the per-label histogram table."""
    rows: list[str] = []
    for section in ("counters", "gauges"):
        for name, m in sorted(snapshot.get(section, {}).items()):
            for v in m.get("values", []):
                rows.append(f"{name}{{{_fmt_labels(v['labels'])}}} = "
                            f"{v['value']:g}")
    hists = snapshot.get("histograms", {})
    if hists:
        rows += ["", f"{'histogram':<30}{'labels':<34}{'n':>6}"
                     f"{'p50_ms':>9}{'p99_ms':>9}{'mean_ms':>9}"]
        for name, m in sorted(hists.items()):
            for v in m.get("values", []):
                n = v["count"]
                mean = v["sum"] / n if n else float("nan")
                rows.append(
                    f"{name:<30}{_fmt_labels(v['labels']):<34}{n:>6}"
                    f"{v['p50'] * 1e3:>9.2f}{v['p99'] * 1e3:>9.2f}"
                    f"{mean * 1e3:>9.2f}")
    return rows


def _num(v, scale: float = 1.0) -> float:
    return float("nan") if v is None else v * scale


# What a divergence row's time is, on each clock.
_CLOCKS = {
    "device": "the CUDA stream's time between the dispatch's two events "
              "(its input preparation, its launches and any gap in which "
              "the stream idles while the host enqueues them)",
    "host": "the host's clock around the call",
}


def summarize_divergence(report: dict) -> list[str]:
    """Per dispatch key: count, best ms (and its clock), the bound's MB
    (each input read once), the MB its launches move at its tiles
    (``traffic_MB``), the H100 bound and the share of it reached; then the
    ratio pairs."""
    rows: list[str] = []
    disp = report.get("dispatches", [])
    if disp:
        rows.append(f"{'dispatch key':<52}{'n':>5}{'best_ms':>10}"
                    f"{'clock':>8}{'modeled_MB':>12}{'traffic_MB':>12}"
                    f"{'bound_ms':>10}{'share':>8}  bound by")
        for d in disp:
            rows.append(
                f"{d['key']:<52}{d['n']:>5}{d['best_s'] * 1e3:>10.4f}"
                f"{d.get('clock', '-'):>8}"
                f"{_num(d.get('modeled_bytes'), 1e-6):>12.3f}"
                f"{_num(d.get('traffic_bytes'), 1e-6):>12.3f}"
                f"{_num(d.get('bound_s'), 1e3):>10.4f}"
                f"{_num(d.get('share')):>8.1%}  "
                f"{d.get('bound_by') or '-'}")
        rows += [f"clock {c}: {_CLOCKS[c]}" for c in _CLOCKS
                 if any(d.get("clock") == c for d in disp)]
    pairs = report.get("pairs", [])
    if pairs:
        if disp:
            rows.append("")
        rows.append(f"{'pair':<44}{'modeled':>9}{'measured':>10}"
                    f"{'diverge':>9}  flag")
        for p in pairs:
            rows.append(
                f"{p['name']:<44}{p['modeled_ratio']:>8.2f}x"
                f"{p['measured_ratio']:>9.2f}x{p['divergence']:>8.2f}x"
                f"  {'ANOMALOUS' if p.get('anomalous') else 'ok'}")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="summarize repro_torch.obs trace/metrics/divergence "
                    "artifacts")
    ap.add_argument("--trace", help="span/event JSONL "
                    "(Tracer.export_jsonl)")
    ap.add_argument("--metrics", help="metrics snapshot JSON, bare or a "
                    "telemetry file with a 'metrics' key")
    ap.add_argument("--divergence", help="divergence report JSON, bare or "
                    "a telemetry file with a 'divergence' key")
    ap.add_argument("--top", type=int, default=10,
                    help="span names to show (default 10)")
    args = ap.parse_args(argv)
    if not (args.trace or args.metrics or args.divergence):
        ap.error("pass at least one of --trace/--metrics/--divergence")

    def emit(title: str, rows: list[str]) -> None:
        print(f"== {title} ==")
        for row in rows or ["(empty)"]:
            print(row)
        print()

    if args.trace:
        emit(f"trace {args.trace}",
             summarize_trace(load_trace(args.trace), top=args.top))
    if args.metrics:
        emit(f"metrics {args.metrics}",
             summarize_metrics(load_metrics(args.metrics)))
    if args.divergence:
        emit(f"divergence {args.divergence}",
             summarize_divergence(load_divergence(args.divergence)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
