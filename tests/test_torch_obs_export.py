"""The port's metrics and trace exports against the JAX package's: the
Prometheus text and its parser, the histogram's count, sum and bucket
width, the process registry (``get_registry`` / ``registry_scope``, the
one ``DispatchRecorder()`` records into), the tracer's ``clear`` and
Chrome export, and the small names ``AdmissionQueue.head_bucket`` and
``optim.chain_clip``.  The metric tests are ``tests/test_obs.py``'s,
run on the port's classes."""
import json
import math

import numpy as np
import pytest
import torch

from _fakeclock import FakeClock
from repro import obs as jobs
from repro.serve.admission import AdmissionConfig as JAdmissionConfig
from repro.serve.admission import AdmissionQueue as JAdmissionQueue
from repro.serve.admission import DetRequest as JDetRequest
from repro_torch import obs, optim
from repro_torch.obs import (DispatchRecorder, Histogram, MetricsRegistry,
                             get_registry, parse_prometheus_text,
                             registry_scope, set_registry)
from repro_torch.serve.admission import (AdmissionConfig, AdmissionQueue,
                                         DetRequest)


def _traced(pkg):
    clock = FakeClock()
    tr = pkg.Tracer(clock=clock)
    with tr.span("work", kind="demo"):
        clock.advance(0.5)
        tr.event("mark", at="mid")
    return tr


def test_trace_exports(tmp_path):
    """``tests/test_obs.py``'s export test on the port, and the Chrome
    events equal the JAX tracer's on the same fake clock."""
    tr = _traced(obs)
    p = tr.export_jsonl(tmp_path / "trace.jsonl")
    recs = [json.loads(line) for line in p.read_text().splitlines()]
    assert {r["type"] for r in recs} == {"span", "event"}
    chrome = tr.to_chrome()
    assert {e["ph"] for e in chrome["traceEvents"]} == {"X", "i"}
    x = next(e for e in chrome["traceEvents"] if e["ph"] == "X")
    assert x["dur"] == pytest.approx(0.5e6)   # microseconds
    assert chrome == _traced(jobs).to_chrome()
    back = json.loads(tr.export_chrome(tmp_path / "t.json").read_text())
    assert back == chrome
    tr.clear()
    assert tr.records() == [] and tr.to_chrome()["traceEvents"] == []


def test_histogram_quantiles_within_one_bucket_width():
    rng = np.random.default_rng(7)
    samples = np.abs(rng.lognormal(mean=-4.0, sigma=1.5, size=500))
    h = Histogram("lat")
    for s in samples:
        h.observe(float(s))
    exact = sorted(samples)
    for q in (0.5, 0.9, 0.99):
        idx = min(len(exact) - 1, max(0, math.ceil(q * len(exact)) - 1))
        ex = exact[idx]
        got = h.quantile(q)
        assert abs(got - ex) <= h.bucket_width(ex) + 1e-12, (q, got, ex)
    assert h.count() == 500
    assert h.sum() == pytest.approx(float(np.sum(samples)))
    assert h.bucket_width(1e9) == float("inf")


def test_histogram_edge_cases():
    h = Histogram("lat")
    assert math.isnan(h.quantile(0.5))
    assert h.count() == 0 and h.sum() == 0.0
    h.observe(1e9)                               # overflow bucket
    assert h.quantile(0.99) == h.bounds[-1]      # clamped
    with pytest.raises(ValueError):
        h.quantile(1.5)


def test_counter_and_gauge_labels():
    reg = MetricsRegistry()
    c = reg.counter("req_total")
    c.inc(outcome="ok")
    c.inc(outcome="ok")
    c.inc(outcome="shed")
    assert c.value(outcome="ok") == 2
    assert c.value(outcome="missing") == 0
    with pytest.raises(ValueError):
        c.inc(-1)
    g = reg.gauge("depth")
    g.set(3, q="a")
    assert g.value(q="a") == 3
    g.inc(q="a")
    g.inc(-2.5, q="a")
    assert g.value(q="a") == 1.5
    with pytest.raises(ValueError):
        reg.gauge("req_total")                   # kind conflict
    assert [m.name for m in reg.metrics()] == ["req_total", "depth"]


def _exposed(pkg):
    reg = pkg.MetricsRegistry()
    reg.counter("jobs_total", "jobs").inc(5, kind="batch")
    reg.gauge("depth").set(2.5)
    h = reg.histogram("lat_seconds", "latency")
    for v in (0.001, 0.002, 0.002, 0.4):
        h.observe(v, op="fwd")
    return reg.prometheus_text()


def test_prometheus_round_trip():
    """``tests/test_obs.py``'s round trip on the port; the text is the
    JAX registry's, and each package's parser reads the other's."""
    text = _exposed(obs)
    parsed = parse_prometheus_text(text)
    assert parsed[("jobs_total", (("kind", "batch"),))] == 5
    assert parsed[("depth", ())] == 2.5
    assert parsed[("lat_seconds_count", (("op", "fwd"),))] == 4
    assert parsed[("lat_seconds_sum", (("op", "fwd"),))] == \
        pytest.approx(0.405)
    buckets = sorted(
        ((float(dict(k[1])["le"]), v) for k, v in parsed.items()
         if k[0] == "lat_seconds_bucket" and dict(k[1])["le"] != "+Inf"))
    counts = [v for _, v in buckets]
    assert counts == sorted(counts) and counts[-1] == 4
    assert parsed[("lat_seconds_bucket",
                   (("le", "+Inf"), ("op", "fwd")))] == 4
    jtext = _exposed(jobs)
    assert text == jtext
    assert jobs.parse_prometheus_text(text) == parsed


def test_process_registry_and_scope():
    """The process registry is one ``MetricsRegistry`` until replaced;
    ``registry_scope`` restores the previous one; ``DispatchRecorder()``
    records into it, as JAX's does."""
    first = get_registry()
    assert isinstance(first, MetricsRegistry) and get_registry() is first
    mine = MetricsRegistry()
    with registry_scope(mine) as got:
        assert got is mine and get_registry() is mine
        rec = DispatchRecorder()
        assert rec.registry is mine
        assert "kernel_dispatch_seconds" in [m.name for m in mine.metrics()]
    assert get_registry() is first
    prev = set_registry(mine)
    try:
        assert prev is first and DispatchRecorder().registry is mine
    finally:
        set_registry(prev)
    own = MetricsRegistry()
    assert DispatchRecorder(registry=own).registry is own


def test_head_bucket_and_chain_clip_equal_jax():
    """``head_bucket`` is the oldest queued request's bucket (None when
    empty), as JAX's; ``chain_clip`` returns the optimizer itself."""
    q = AdmissionQueue(AdmissionConfig(capacity=8))
    jq = JAdmissionQueue(JAdmissionConfig(capacity=8))
    assert q.head_bucket() is None and jq.head_bucket() is None
    for uid, bucket in enumerate((128, 64, 128)):
        img = np.zeros((bucket, bucket, 3), np.float32)
        q.offer(DetRequest(uid=uid, image=img, bucket=bucket))
        jq.offer(JDetRequest(uid=uid, image=img, bucket=bucket))
        assert q.head_bucket() == jq.head_bucket() == 128
    q.take(128, 1)
    jq.take(128, 1)
    assert q.head_bucket() == jq.head_bucket() == 64
    opt = optim.adamw(optim.constant(1e-3))
    assert optim.chain_clip(opt) is opt
    w = {"w": torch.ones(2)}
    assert optim.chain_clip(opt).init(w).keys() == {"m", "v"}
