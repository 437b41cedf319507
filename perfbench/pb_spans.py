"""Device idle under the program's own spans, the quantity of the
readers ``build_idle``, ``launch_idle`` and ``optimizer_idle``.

The program's spans (``repro_torch.obs.trace``) open a
``record_function`` range of their name while a profiler records, so
``pb_trace.reduce`` labels an idle gap by the innermost of them open on
the host at the gap's middle, beside the benchmark's own spans.  The
reduction keeps the ``TOP`` largest labels: a label missing from a full
list may hold idle that was cut off.
"""
from __future__ import annotations

import inspect

import pb_trace

TOP = inspect.signature(pb_trace.reduce).parameters["top"].default
# Labels the benchmark opens itself (``pb_dcn``), and the reduction's
# label of idle under no span.
BENCH_LABELS = frozenset({"outside any span", "bench/step", "bench/fill",
                          "bench/idle", "train/step", "train/data",
                          "train/forward"})


def idle_share(run, labels) -> float | None:
    """Seconds of the traced window's idle labelled by one of ``labels``
    over the window, in %.  None without a trace, where the program
    opened no span of its own (every label is the benchmark's), or where
    no label is listed and the list is full; 0.0 where no label is
    listed in a shorter one."""
    t = run.trace
    if t is None or t["window_s"] <= 0:
        return None
    gaps = dict(t["idle_gaps"])
    if set(gaps) <= BENCH_LABELS:
        return None
    hits = [s for name, s in gaps.items() if name in labels]
    if not hits:
        return 0.0 if len(gaps) < TOP else None
    return 100.0 * sum(hits) / t["window_s"]
