"""Hierarchical span tracer (what the serving engine uses of
``repro.obs.trace``, with profiler ranges added; the port imports
nothing of the JAX package).

A :class:`Tracer` hands out :class:`Span` context managers; spans nest
via an explicit stack (the enclosing open span becomes the parent).  The
clock is injectable, so tests drive spans on a fake clock.  Disabled
tracers record nothing: outside a profiler ``span()`` returns one shared
no-op singleton.
The process-global default tracer is disabled; ``tracer_scope`` opts in.

While a ``torch.profiler`` records, every span also opens a
``record_function`` range of its name, so the span lies on the profiler's
clock beside the device's kernels (a ``user_annotation`` of the host
timeline).  A disabled tracer then hands out a span that enters and
exits the range alone and records nothing; outside a profiler it still
hands out ``NOOP_SPAN``, at the cost of one check that no profiler is on
(~0.1 us on a CPU core, where entering a range costs ~15 us whether a
profiler records or not).
Exports: JSONL (one record a span or event) and Chrome trace-event JSON
(``ph: "X"`` spans, ``ph: "i"`` instants, timestamps in microseconds,
loadable in Perfetto).
"""
from __future__ import annotations

import contextlib
import itertools
import json
import pathlib
import time

from torch.autograd import _profiler_enabled
from torch.profiler import record_function

__all__ = ["NOOP_SPAN", "Span", "Tracer", "get_tracer", "set_tracer",
           "tracer_scope"]


class Span:
    """One timed region.  Use as a context manager (``with tracer.span``)
    or drive manually: ``sp = tracer.span(...).start(); ...; sp.end()``.
    """

    __slots__ = ("_tracer", "name", "span_id", "parent_id", "t0", "t1",
                 "attrs", "_range")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self.span_id = next(tracer._ids)
        self.parent_id: int | None = None
        self.t0: float | None = None
        self.t1: float | None = None
        self._range = None

    def start(self) -> "Span":
        tr = self._tracer
        self.parent_id = tr._stack[-1].span_id if tr._stack else None
        tr._stack.append(self)
        self._range = _open_range(self.name)
        self.t0 = tr.clock()
        return self

    def end(self) -> None:
        if self.t1 is not None or self.t0 is None:
            return                       # never started / already ended
        tr = self._tracer
        self.t1 = tr.clock()
        _close_range(self._range)
        self._range = None
        if tr._stack and tr._stack[-1] is self:
            tr._stack.pop()
        elif self in tr._stack:          # out-of-order end: drop anyway
            tr._stack.remove(self)
        tr.spans.append(self)

    def set_attr(self, **attrs) -> "Span":
        """Attach attributes after the fact (e.g. a step's outcome)."""
        self.attrs.update(attrs)
        return self

    @property
    def duration(self) -> float:
        if self.t0 is None or self.t1 is None:
            return float("nan")
        return self.t1 - self.t0

    def __enter__(self) -> "Span":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.end()
        return False

    def record(self) -> dict:
        return {"type": "span", "name": self.name, "span_id": self.span_id,
                "parent_id": self.parent_id, "t0": self.t0, "t1": self.t1,
                "dur_s": self.duration, "attrs": self.attrs}


class _NoopSpan:
    """Shared do-nothing span — the disabled-tracer fast path.  One
    instance serves every call site; nothing is allocated or timed."""

    __slots__ = ()
    name = "noop"
    duration = float("nan")

    def start(self) -> "_NoopSpan":
        return self

    def end(self) -> None:
        pass

    def set_attr(self, **attrs) -> "_NoopSpan":
        return self

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


NOOP_SPAN = _NoopSpan()


def _open_range(name: str):
    """A profiler range of ``name``, entered, while a profiler records;
    else None."""
    if not _profiler_enabled():
        return None
    rf = record_function(name)
    rf.__enter__()
    return rf


def _close_range(rf) -> None:
    if rf is not None:
        rf.__exit__(None, None, None)


class _RangeSpan:
    """A disabled tracer's span while a profiler records: the range of
    its name and nothing in the tracer."""

    __slots__ = ("name", "_range")
    duration = float("nan")

    def __init__(self, name: str):
        self.name = name
        self._range = None

    def start(self) -> "_RangeSpan":
        if self._range is None:
            self._range = _open_range(self.name)
        return self

    def end(self) -> None:
        _close_range(self._range)
        self._range = None

    def set_attr(self, **attrs) -> "_RangeSpan":
        return self

    def __enter__(self) -> "_RangeSpan":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.end()
        return False


class Tracer:
    """See module docstring.  ``spans`` holds finished spans in end
    order; ``events`` holds instant events in emission order."""

    def __init__(self, *, clock=time.monotonic, enabled: bool = True):
        self.clock = clock
        self.enabled = enabled
        self.spans: list[Span] = []
        self.events: list[dict] = []
        self._stack: list[Span] = []
        self._ids = itertools.count(1)

    # -- recording -----------------------------------------------------
    def span(self, name: str, **attrs):
        """A new child span of the innermost open span (entered lazily:
        the parent is resolved at ``start()``/``__enter__`` time).  A
        disabled tracer's is ``NOOP_SPAN``, or the profiler's range alone
        while a profiler records (module docstring)."""
        if not self.enabled:
            return _RangeSpan(name) if _profiler_enabled() else NOOP_SPAN
        return Span(self, name, attrs)

    def event(self, name: str, **attrs) -> None:
        """An instant event at the current clock, parented like a span."""
        if not self.enabled:
            return
        self.events.append({
            "type": "event", "name": name, "ts": self.clock(),
            "parent_id": self._stack[-1].span_id if self._stack else None,
            "attrs": attrs})

    def clear(self) -> None:
        self.spans.clear()
        self.events.clear()
        self._stack.clear()

    # -- export --------------------------------------------------------
    def records(self) -> list[dict]:
        """All finished spans + events as plain dicts."""
        return [s.record() for s in self.spans] + list(self.events)

    def export_jsonl(self, path) -> pathlib.Path:
        """One JSON record a line (what ``launch.obs_report --trace``
        reads).  Returns the written path."""
        p = pathlib.Path(path)
        p.write_text("".join(json.dumps(r, default=str) + "\n"
                             for r in self.records()))
        return p

    def to_chrome(self) -> dict:
        """Chrome trace-event JSON (Perfetto-loadable): ``ph: "X"``
        complete events for spans, ``ph: "i"`` instants for events,
        timestamps/durations in microseconds."""
        out = []
        for s in self.spans:
            out.append({"name": s.name, "ph": "X", "pid": 0, "tid": 0,
                        "ts": (s.t0 or 0.0) * 1e6,
                        "dur": max(s.duration, 0.0) * 1e6,
                        "args": {str(k): str(v)
                                 for k, v in s.attrs.items()}})
        for e in self.events:
            out.append({"name": e["name"], "ph": "i", "s": "t",
                        "pid": 0, "tid": 0, "ts": e["ts"] * 1e6,
                        "args": {str(k): str(v)
                                 for k, v in e["attrs"].items()}})
        return {"traceEvents": out, "displayTimeUnit": "ms"}

    def export_chrome(self, path) -> pathlib.Path:
        p = pathlib.Path(path)
        p.write_text(json.dumps(self.to_chrome()))
        return p


# ---------------------------------------------------------------------------
# Process-global default tracer — DISABLED until something opts in
# (tests via tracer_scope).  Instrumented code
# paths call get_tracer() at use time so a scoped tracer is honored
# even by objects constructed earlier.
# ---------------------------------------------------------------------------

_tracer = Tracer(enabled=False)


def get_tracer() -> Tracer:
    return _tracer


def set_tracer(tracer: Tracer) -> Tracer:
    """Install the process-global tracer; returns the previous one."""
    global _tracer
    prev, _tracer = _tracer, tracer
    return prev


@contextlib.contextmanager
def tracer_scope(tracer: Tracer):
    """Scoped :func:`set_tracer` with guaranteed restore."""
    prev = set_tracer(tracer)
    try:
        yield tracer
    finally:
        set_tracer(prev)
