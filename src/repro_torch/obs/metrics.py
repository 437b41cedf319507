"""Labeled metrics registry: counters, gauges and fixed-bucket latency
histograms (a copy of what the serving engine uses of
``repro.obs.metrics``; the port imports nothing of the JAX package).

Histograms never retain samples: observations land in fixed
geometrically-spaced buckets (``DEFAULT_LATENCY_BUCKETS``, ~10 per
decade from 10 us to ~2 min), and ``quantile()`` interpolates inside
the bucket the requested rank falls in — p50/p99 at bucket resolution
with O(buckets) memory per label set.

Exports: :meth:`MetricsRegistry.snapshot` (plain-JSON dict),
:meth:`MetricsRegistry.prometheus_text` (text exposition: cumulative
``_bucket{le=...}`` samples plus ``_sum``/``_count``, which
:func:`parse_prometheus_text` reads back) and :func:`dump_telemetry`
(the JSON sink).  ``get_registry`` is the process-wide registry, a fresh
one until ``set_registry`` / ``registry_scope`` replace it.
"""
from __future__ import annotations

import contextlib
import json
import math
import pathlib

__all__ = ["DEFAULT_LATENCY_BUCKETS", "Counter", "Gauge", "Histogram",
           "MetricsRegistry", "dump_telemetry", "get_registry",
           "parse_prometheus_text", "registry_scope", "set_registry"]

# ~10 buckets per decade, 10 us .. ~126 s; dispatch latencies and
# request latencies both live comfortably inside this range.
DEFAULT_LATENCY_BUCKETS = tuple(
    round(10.0 ** (k / 10.0), 12) for k in range(-50, 22))


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Metric:
    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self._values: dict[tuple, float] = {}

    def inc(self, amount: float = 1, **labels) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease "
                             f"(inc by {amount})")
        key = _label_key(labels)
        self._values[key] = self._values.get(key, 0) + amount

    def value(self, **labels) -> float:
        return self._values.get(_label_key(labels), 0)

    def items(self):
        """(label_key, value) pairs; label_key is a sorted tuple of
        (name, value) string pairs."""
        return self._values.items()


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self._values: dict[tuple, float] = {}

    def set(self, value: float, **labels) -> None:
        self._values[_label_key(labels)] = value

    def inc(self, amount: float = 1, **labels) -> None:
        key = _label_key(labels)
        self._values[key] = self._values.get(key, 0) + amount

    def value(self, **labels) -> float:
        return self._values.get(_label_key(labels), 0)

    def items(self):
        return self._values.items()


class Histogram(_Metric):
    """Fixed-bucket histogram; the implicit overflow bucket (+Inf)
    rides at the end of each counts list."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: tuple[float, ...] = DEFAULT_LATENCY_BUCKETS):
        super().__init__(name, help)
        self.bounds = tuple(sorted(float(b) for b in buckets))
        if not self.bounds:
            raise ValueError(f"histogram {name} needs at least one "
                             f"finite bucket bound")
        self._counts: dict[tuple, list[int]] = {}
        self._sums: dict[tuple, float] = {}

    def _bucket_index(self, value: float) -> int:
        import bisect
        return bisect.bisect_left(self.bounds, value)

    def observe(self, value: float, **labels) -> None:
        key = _label_key(labels)
        counts = self._counts.get(key)
        if counts is None:
            counts = self._counts[key] = [0] * (len(self.bounds) + 1)
            self._sums[key] = 0.0
        counts[self._bucket_index(value)] += 1
        self._sums[key] += value

    def count(self, **labels) -> int:
        return sum(self._counts.get(_label_key(labels), ()))

    def sum(self, **labels) -> float:
        return self._sums.get(_label_key(labels), 0.0)

    def bucket_width(self, value: float) -> float:
        """Width of the bucket ``value`` falls in: the resolution bound
        of :meth:`quantile` near that value."""
        i = self._bucket_index(value)
        if i >= len(self.bounds):
            return float("inf")
        lo = self.bounds[i - 1] if i > 0 else 0.0
        return self.bounds[i] - lo

    def quantile(self, q: float, **labels) -> float:
        """q-th quantile by linear interpolation inside the covering
        bucket (no samples retained).  Accurate to one bucket width;
        nan with no observations; the overflow bucket clamps to the
        largest finite bound."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile q={q} must be in [0, 1]")
        counts = self._counts.get(_label_key(labels))
        if counts is None:
            return float("nan")
        n = sum(counts)
        if n == 0:
            return float("nan")
        rank = max(1, math.ceil(q * n))
        cum = 0
        for i, cnt in enumerate(counts):
            if cnt == 0:
                continue
            if cum + cnt >= rank:
                if i >= len(self.bounds):          # overflow bucket
                    return self.bounds[-1]
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = self.bounds[i]
                return lo + (hi - lo) * (rank - cum) / cnt
            cum += cnt
        return self.bounds[-1]

    def items(self):
        return self._counts.items()

    def label_stats(self, key: tuple) -> dict:
        counts = self._counts[key]
        n = sum(counts)
        return {"labels": dict(key), "counts": list(counts),
                "sum": self._sums[key], "count": n,
                "p50": self.quantile(0.50, **dict(key)),
                "p99": self.quantile(0.99, **dict(key))}


class MetricsRegistry:
    """Get-or-create registry; re-requesting a name with a different
    metric kind is an error, not a silent shadow."""

    def __init__(self):
        self._metrics: dict[str, _Metric] = {}

    def _get(self, cls, name: str, help: str, **kwargs):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name, help, **kwargs)
        elif not isinstance(m, cls):
            raise ValueError(
                f"metric {name!r} already registered as {m.kind}, "
                f"requested as {cls.kind}")
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: tuple[float, ...] = DEFAULT_LATENCY_BUCKETS
                  ) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def metrics(self):
        return self._metrics.values()

    # -- export --------------------------------------------------------
    def snapshot(self) -> dict:
        """Plain-JSON dict of every metric."""
        out: dict = {"counters": {}, "gauges": {}, "histograms": {}}
        for m in self._metrics.values():
            if isinstance(m, Histogram):
                out["histograms"][m.name] = {
                    "help": m.help, "buckets": list(m.bounds),
                    "values": [m.label_stats(k) for k in sorted(
                        m._counts)]}
            else:
                section = "counters" if isinstance(m, Counter) else "gauges"
                out[section][m.name] = {
                    "help": m.help,
                    "values": [{"labels": dict(k), "value": v}
                               for k, v in sorted(m.items())]}
        return out


    def prometheus_text(self) -> str:
        """Prometheus text exposition (histograms as cumulative
        ``_bucket{le=...}`` + ``_sum`` + ``_count``)."""
        def fmt_labels(pairs) -> str:
            if not pairs:
                return ""
            body = ",".join(f'{k}="{v}"' for k, v in pairs)
            return "{" + body + "}"

        def fmt_num(v: float) -> str:
            if isinstance(v, float) and v == int(v) and abs(v) < 1e15:
                return str(int(v))
            return repr(v)

        lines: list[str] = []
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            if isinstance(m, Histogram):
                for key in sorted(m._counts):
                    counts = m._counts[key]
                    cum = 0
                    for bound, cnt in zip(m.bounds, counts):
                        cum += cnt
                        lines.append(
                            f"{name}_bucket"
                            f"{fmt_labels(key + (('le', repr(bound)),))}"
                            f" {cum}")
                    total = cum + counts[-1]
                    lines.append(
                        f"{name}_bucket"
                        f"{fmt_labels(key + (('le', '+Inf'),))} {total}")
                    lines.append(f"{name}_sum{fmt_labels(key)} "
                                 f"{repr(m._sums[key])}")
                    lines.append(f"{name}_count{fmt_labels(key)} {total}")
            else:
                for key, v in sorted(m.items()):
                    lines.append(f"{name}{fmt_labels(key)} {fmt_num(v)}")
        return "\n".join(lines) + "\n"


def parse_prometheus_text(text: str) -> dict:
    """Parse the exposition back into ``{(name, label_key): value}`` —
    the test-side half of the round-trip.  Only the subset
    :meth:`MetricsRegistry.prometheus_text` emits is supported."""
    out: dict = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        sample, value = line.rsplit(" ", 1)
        labels: tuple = ()
        if "{" in sample:
            name, rest = sample.split("{", 1)
            body = rest.rstrip("}")
            if body:
                pairs = []
                for part in body.split(","):
                    k, v = part.split("=", 1)
                    pairs.append((k, v.strip('"')))
                labels = tuple(sorted(pairs))
        else:
            name = sample
        out[(name, labels)] = float(value)
    return out

def _json_default(o):
    """Coerce the numpy scalars/arrays telemetry records accumulate."""
    import numpy as np
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not JSON-serializable: {type(o).__name__}")


def dump_telemetry(path, record: dict, extra: dict | None = None, *,
                   registry: MetricsRegistry | None = None) -> pathlib.Path:
    """Write a telemetry record, plus the ``extra`` keys, as JSON (numpy
    scalars and arrays coerced to plain JSON); ``registry`` attaches its
    snapshot under ``"metrics"``.  Returns the written path."""
    rec = dict(record)
    if extra:
        rec.update(extra)
    if registry is not None:
        rec["metrics"] = registry.snapshot()
    p = pathlib.Path(path)
    p.write_text(json.dumps(rec, indent=2, default=_json_default))
    return p


# ---------------------------------------------------------------------------
# The process-wide default registry.  Subsystems that need isolation (two
# serving engines in one process, each Trainer) construct their own.
# ---------------------------------------------------------------------------

_registry = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _registry


def set_registry(registry: MetricsRegistry) -> MetricsRegistry:
    global _registry
    prev, _registry = _registry, registry
    return prev


@contextlib.contextmanager
def registry_scope(registry: MetricsRegistry):
    prev = set_registry(registry)
    try:
        yield registry
    finally:
        set_registry(prev)
