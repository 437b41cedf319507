"""The traced run: ``torch.profiler`` over the measured window, the
benchmark's own host spans, and the reduction of the device trace.

Spans are ``record_function`` ranges opened by the benchmark around its
calls into the program; they appear in the trace's host timeline on the
same clock as the device's kernels.  The window itself is the span
``bench/window``.  The reduction reads, within that window: the device's
busy time (the union of its kernels, copies and fills), each kernel
name's device time, the DCL kernels' time (``pb_yard.is_dcl_kernel``) and
the idle gaps, each labelled by the innermost benchmark span that was
open on the host at the gap's middle.
"""
from __future__ import annotations

import contextlib
import json
import os
import tempfile

import pb_yard

WINDOW = "bench/window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Spans:
    """Host spans and the profiler; every method is a no-op when the
    run is not traced."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self._prof = None
        self._open: dict[str, object] = {}

    def span(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        import torch
        return torch.profiler.record_function(name)

    def begin(self, name: str) -> None:
        """Open a span that a later ``end(name)`` closes (on this thread)."""
        if self.enabled:
            import torch
            rf = torch.profiler.record_function(name)
            rf.__enter__()
            self._open[name] = rf

    def end(self, name: str) -> None:
        rf = self._open.pop(name, None)
        if rf is not None:
            rf.__exit__(None, None, None)

    def start(self) -> None:
        """Start the profiler and open the window span."""
        if not self.enabled:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.start()
        self.begin(WINDOW)

    def stop(self, sync) -> dict | None:
        """Close the window, wait for the device (``sync()``), stop the
        profiler and reduce its trace (``reduce``)."""
        if not self.enabled:
            return None
        self.end(WINDOW)
        for name in list(self._open):
            self.end(name)
        sync()
        self._prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json", prefix="pb-trace-")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        self._prof = None
        return reduce(events)


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _label_gaps(spans: list[tuple[float, float, str]],
                gaps: list[tuple[float, float]]) -> dict[str, float]:
    """Seconds of ``gaps`` by the innermost span open at each gap's
    middle, in one sweep (the benchmark's spans nest)."""
    marks = [(a, 1, i) for i, (a, _, _) in enumerate(spans)]
    marks += [(b, -1, i) for i, (_, b, _) in enumerate(spans)]
    marks += [((a + b) / 2, 0, i) for i, (a, b) in enumerate(gaps)]
    marks.sort(key=lambda m: (m[0], m[1]))
    stack: list[int] = []
    out: dict[str, float] = {}
    for _, kind, i in marks:
        if kind == 1:
            stack.append(i)
        elif kind == -1:
            if i in stack:
                stack.remove(i)
        else:
            a, b = gaps[i]
            label = spans[stack[-1]][2] if stack else "outside any span"
            out[label] = out.get(label, 0.0) + (b - a) * 1e-6
    return out


def reduce(events: list[dict], top: int = 10) -> dict:
    """Busy and window seconds, device seconds by kernel name (the
    ``top`` largest), DCL kernel seconds and launches, and idle gaps by
    host span (the ``top`` largest sums)."""
    host = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
            if e.get("cat") == "user_annotation" and "dur" in e]
    window = [(a, b) for a, b, n in host if n == WINDOW]
    if not window:
        raise ValueError(f"the trace holds no {WINDOW!r} span")
    w0, w1 = window[0]
    spans = [s for s in host if s[2] != WINDOW]
    dev, by_name = [], {}
    dcl_s, dcl_launches = 0.0, 0
    for e in events:
        if e.get("cat") not in DEVICE_CATS or "dur" not in e:
            continue
        a, b = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
        if b <= a:
            continue
        dev.append((a, b))
        name = e["name"]
        by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-6
        if e["cat"] == "kernel" and pb_yard.is_dcl_kernel(name):
            dcl_s += (b - a) * 1e-6
            dcl_launches += 1
    busy = _union(dev)
    busy_s = sum(b - a for a, b in busy) * 1e-6
    edges = [w0] + [t for ab in busy for t in ab] + [w1]
    gaps = _label_gaps(spans, [(a, b) for a, b in zip(edges[0::2],
                                                      edges[1::2]) if b > a])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": busy_s,
            "dcl_s": dcl_s, "dcl_launches": dcl_launches,
            "device_ops": [[n[:160], s] for n, s in ops],
            "idle_gaps": sorted(([n, s] for n, s in gaps.items()),
                                key=lambda kv: -kv[1])[:top]}
