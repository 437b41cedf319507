"""The port's ``obs.divergence`` (dispatch keys, the H100 pricing of a
dispatch, the tracker, the recorder and ``ops``' finish protocol), the
serving engine's ``divergence`` / ``plan_cache`` / ``plan_sources``
telemetry and ``launch.obs_report``; held against the JAX package where
both compute the same thing (keys, ratio pairs, the trace and metrics
summaries)."""
import json
import logging

import numpy as np
import pytest
import torch

from _fakeclock import FakeClock
from repro.launch import obs_report as jreport
from repro.obs import DivergenceTracker as JTracker
from repro.obs.divergence import key_from_context as j_key
from repro_torch.core import h100
from repro_torch.kernels import ops
from repro_torch.launch import obs_report
from repro_torch.models import resnet_dcn as R
from repro_torch.obs import (DispatchRecorder, DivergenceTracker,
                             MetricsRegistry, Tracer, dump_telemetry,
                             key_from_context, modeled_bound_ms,
                             modeled_dispatch_bytes, price_dispatch,
                             tracer_scope)
from repro_torch.serve import DCLServeConfig, DCLServingEngine

torch.set_num_threads(2)

CTX = dict(op="deform_conv", precision="fp32", dataflow="zero_copy",
           shape=(2, 16, 16, 32), m=48, offset_bound=2.0, kernel_size=3,
           stride=1, dilation=1, device="cpu", itemsize=4,
           offset_itemsize=4, tiles=(None,) * 4)


def _dcl(seed=0, n=1, h=8, c=8, m=8):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(n, h, h, c, generator=g),
            torch.randn(n, h, h, 18, generator=g),
            torch.randn(9, c, m, generator=g) * 0.1)


# -- keys and prices ----------------------------------------------------

@pytest.mark.parametrize("ctx", [
    CTX, dict(CTX, precision="int8"),
    dict(CTX, op="deform_conv_chain", emit="int8"),
], ids=["fp32", "int8", "chain"])
def test_key_fields_match_jax(ctx):
    key, jkey = key_from_context(ctx), j_key(ctx)
    assert (key.op, key.shape, key.dtype, key.quant) == \
        (jkey.op, jkey.shape, jkey.dtype, jkey.quant)
    assert key.m == 48 and key.stride == 1
    assert f"{key.op}[2x16x16x32->48 s1]" in key.label()
    assert key_from_context({"op": "x", "shape": (1, 2)}) is None


def test_bf16_key_and_unpriceable_context():
    assert key_from_context(dict(CTX, itemsize=2)).dtype == "bf16"
    assert modeled_dispatch_bytes({"op": "x"}) is None
    assert modeled_bound_ms(dict(CTX, shape=(1, 2, 3))) is None


def test_fp32_price_is_the_kernels_line_bound():
    """The bytes and both bounds ``chip_smoke.py``'s phase 3 prints."""
    n, h, w, c, m, k2 = 2, 16, 16, 32, 48, 9
    p = n * h * w
    flops = 2 * p * k2 * c * m
    nbytes = 4 * (n * h * w * c + p * 2 * k2 + k2 * c * m + p * m)
    byte_s = nbytes / h100.PEAK_HBM_BYTES_PER_S
    want = min(max(flops / h100.PEAK_FP32_FLOPS, byte_s),
               max(3 * flops / h100.PEAK_TF32_FLOPS, byte_s))
    price = price_dispatch(CTX)
    assert price["bytes"] == nbytes and price["ops"] == flops
    assert price["bound_s"] == pytest.approx(want, rel=1e-12)
    assert modeled_dispatch_bytes(CTX) == nbytes
    assert modeled_bound_ms(CTX) == pytest.approx(want * 1e3, rel=1e-12)
    assert len(price["tiles"]) == 4


def test_int8_prices():
    n, h, c, m, k2 = 2, 16, 32, 48, 9
    p, samples = n * h * h, n * h * h * k2 * c
    q = price_dispatch(dict(CTX, precision="int8"))
    assert q["ops"] == 2 * samples * m
    assert q["bytes"] == n * h * h * c + k2 * c * m + 4 * p * m + 4 * m \
        + 4 * p * 2 * k2
    floors = (q["ops"] / h100.PEAK_INT8_OPS,
              q["bytes"] / h100.PEAK_HBM_BYTES_PER_S,
              h100.SAMPLE_OPS * samples / h100.CUDA_CORE_LANE_OPS)
    assert q["bound_s"] == pytest.approx(max(floors), rel=1e-12)
    assert q["bytes"] < price_dispatch(CTX)["bytes"]   # the int8 band
    chain = price_dispatch(dict(CTX, op="deform_conv_chain", emit="int8"))
    assert chain["ops"] == 2 * samples * (m + 2 * k2)
    assert chain["bytes"] == n * h * h * c + k2 * c * m + p * m + 4 * m \
        + k2 * c * 2 * k2 + 4 * (4 * k2 + m)


def test_bf16_banded_and_training_prices():
    bf = price_dispatch(dict(CTX, itemsize=2, offset_itemsize=2))
    assert bf["bytes"] * 2 == price_dispatch(CTX)["bytes"]
    assert bf["bound_s"] == pytest.approx(max(
        bf["ops"] / h100.PEAK_BF16_FLOPS,
        bf["bytes"] / h100.PEAK_HBM_BYTES_PER_S))
    banded = price_dispatch(dict(CTX, dataflow="banded"))
    assert banded["tiles"][0] == 8 and banded["bytes"] > \
        price_dispatch(CTX)["bytes"]        # the bands repeat the overlap
    train = price_dispatch(dict(CTX, objective="training"))
    fwd = h100.forward_work(2, 16, 16, 32, 48, kernel_size=3, stride=1,
                            dilation=1)
    bwd = h100.backward_work(2, 16, 16, 32, 48, kernel_size=3, stride=1,
                             dilation=1)
    assert train["bound_s"] == pytest.approx(fwd["bound_s"]
                                             + bwd["bound_s"])
    assert bwd["ops"] == 2 * fwd["ops"]


def test_a_runs_bound_is_its_summed_works():
    """``h100.total``: each additive quantity summed over the calls, then
    bounded as one, as ``chip_smoke.py``'s kernels line takes a run's
    bound; the split-fp32 bound is the lower unit's."""
    geom = dict(kernel_size=3, stride=1, dilation=1)
    a = h100.forward_work(2, 16, 16, 32, 48, **geom)
    b = h100.forward_work(4, 8, 8, 64, 64, **geom)
    run = h100.total([(a, 3), (b, 2)])
    assert run["bytes"] == 3 * a["bytes"] + 2 * b["bytes"]
    assert run["ops"] == 3 * a["ops"] + 2 * b["ops"]
    byte_s = run["bytes"] / h100.PEAK_HBM_BYTES_PER_S
    assert run["bound_fp32_s"] == pytest.approx(
        max(run["ops"] / h100.PEAK_FP32_FLOPS, byte_s), rel=1e-12)
    assert run["bound_3xtf32_s"] == pytest.approx(
        max(3 * run["ops"] / h100.PEAK_TF32_FLOPS, byte_s), rel=1e-12)
    assert run["bound_s"] == min(run["bound_fp32_s"], run["bound_3xtf32_s"])
    q = h100.int8_work(2, 16, 16, 32, 48, chain=True, **geom)
    q_run = h100.total([(q, 4)])
    assert q_run["samples"] == 4 * q["samples"]
    assert q_run["bound_s"] == pytest.approx(4 * q["bound_s"], rel=1e-12)
    with pytest.raises(ValueError, match="kinds"):
        h100.total([(a, 1), (q, 1)])
    mm = h100.rate_work(100.0, 1e9, h100.PEAK_BF16_FLOPS)
    assert mm["bound_by"] == "operations" and mm["bound_s"] == \
        pytest.approx(1e9 / h100.PEAK_BF16_FLOPS)


@pytest.mark.parametrize("n,h,w,c,m,stride,dilation,itemsize", [
    (2, 16, 16, 32, 48, 1, 1, 4), (2, 17, 23, 8, 8, 1, 1, 4),
    (1, 15, 15, 8, 16, 2, 1, 2), (2, 20, 20, 8, 8, 1, 2, 2),
], ids=["even", "ragged", "odd_s2_bf16", "dilation2_bf16"])
def test_banded_work_counts_the_kernels_tensors(n, h, w, c, m, stride,
                                                 dilation, itemsize):
    """Kernel 4's bytes are those of the bands, padded offsets, blocked
    weights and whole-row-tile outputs a call holds; its products cover
    the padded rows it computes."""
    from repro_torch.core.tiling import out_hw
    from repro_torch.kernels import plan
    dt = torch.float32 if itemsize == 4 else torch.bfloat16
    ho, wo = out_hw(h, w, kernel_size=3, stride=stride, dilation=dilation)
    x = torch.zeros(n, h, w, c, dtype=dt)
    off = torch.zeros(n, ho, wo, 18, dtype=dt)
    spec = plan.DCSpec(3, stride, dilation, 2.0, dataflow="banded")
    th, _, tc, _ = plan.banded_tiles(spec, x, off, m, dtype="banded")
    bands, offb = plan.banded_inputs(spec, x, off, th)
    wt = plan.tile_weights(torch.zeros(9, c, m, dtype=dt), tc)
    rows = offb.shape[1]
    held = itemsize * (bands.numel() + offb.numel() + wt.numel()
                       + n * rows * wo * m)
    work = h100.banded_work(n, h, w, c, m, kernel_size=3, stride=stride,
                            dilation=dilation, offset_bound=2.0, tile_h=th,
                            itemsize=itemsize)
    assert work["bytes"] == held
    assert work["ops"] == 2 * n * rows * wo * 9 * c * m


def test_pricing_counts_no_resolution():
    """A priced dispatch takes the tiles the dispatcher would (here an
    installed cache's entry) without counting a resolution."""
    from repro_torch.kernels import plan
    from repro_torch.tune import TileCache, tile_cache_scope
    cache = TileCache()
    cache.put({"tiles": [4, 4, 8, 16]}, n=2, h=16, w=16, c=32, m=48,
              offset_bound=2.0, objective="forward", dtype=None,
              platform="cpu")
    plan.reset_tuned_stats()
    with tile_cache_scope(cache):
        price = price_dispatch(CTX)
    assert price["tiles"] == [4, 4, 8, 16]
    info = plan.tile_cache_info()
    assert (info["tuned_hits"], info["analytic_resolves"],
            info["tuned_incompatible"]) == (0, 0, 0)


# -- tracker ------------------------------------------------------------

def test_ratio_pairs_match_jax():
    port, jax_ = DivergenceTracker(), JTracker()
    for t in (port, jax_):
        t.record_pair("fwd", modeled_ratio=1.8, measured_ratio=1.5)
        t.record_pair("bwd", modeled_ratio=1.92, measured_ratio=0.8,
                      note="inverted")
        t.annotate_pair("bwd", measured_ratio_post_tuning=1.1)
    assert port.report()["pairs"] == jax_.report()["pairs"]
    assert port.report()["pairs"][1]["anomalous"]
    assert port.annotate_pair("missing") is None


def test_tracker_share_is_bound_over_best():
    t = DivergenceTracker()
    key = key_from_context(CTX)
    price = price_dispatch(CTX)
    t.observe(key, price, 4 * price["bound_s"], clock="device")
    t.observe(key, None, 2 * price["bound_s"], clock="device")
    (row,) = t.report()["dispatches"]
    assert row["n"] == 2 and row["clock"] == "device"
    assert row["share"] == pytest.approx(0.5)
    assert row["mean_s"] == pytest.approx(3 * price["bound_s"])
    assert row["modeled_bytes"] == price["bytes"]
    assert t.price(key) is price


# -- the recorder and ops' finish protocol ---------------------------------

def test_recorder_times_a_real_dispatch():
    reg, tracer, tracker = MetricsRegistry(), Tracer(), DivergenceTracker()
    rec = DispatchRecorder(registry=reg, tracer=tracer, tracker=tracker)
    x, off, w = _dcl()
    with ops.dispatch_hook_scope(rec):
        out = ops.deform_conv(x, off, w, offset_bound=2.0, device="cpu")
    assert out.shape == (1, 8, 8, 8)
    assert reg.counter("kernel_dispatch_total").value(
        op="deform_conv", quant="none", outcome="ok") == 1
    h = reg.histogram("kernel_dispatch_seconds")
    assert h.label_stats((("op", "deform_conv"), ("quant", "none")))[
        "count"] == 1
    (span,) = [s for s in tracer.spans if s.name == "kernel/dispatch"]
    assert span.attrs["outcome"] == "ok" and span.attrs["clock"] == "host"
    (row,) = tracker.report()["dispatches"]
    assert row["clock"] == "host" and row["best_s"] > 0
    assert 0 < row["share"] and row["modeled_bytes"] > 0
    assert rec.flush() == 0                 # nothing pending on the CPU


def test_chained_hook_runs_first_and_its_raise_aborts_untimed():
    calls = []

    def chaos(ctx):
        calls.append(ctx["op"])
        raise RuntimeError("injected")
    reg = MetricsRegistry()
    rec = DispatchRecorder(registry=reg, next_hook=chaos,
                           tracker=DivergenceTracker())
    x, off, w = _dcl()
    with ops.dispatch_hook_scope(rec), pytest.raises(RuntimeError,
                                                     match="injected"):
        ops.deform_conv(x, off, w, offset_bound=2.0, device="cpu")
    assert calls == ["deform_conv"]
    assert reg.counter("kernel_dispatch_total").value(
        op="deform_conv", quant="none", outcome="ok") == 0
    assert rec.tracker.report()["dispatches"] == []


def test_finish_sees_the_result_or_the_error(monkeypatch):
    seen = []

    def hook(ctx):
        return lambda out=None, error=None: seen.append((out, error))
    x, off, w = _dcl()
    with ops.dispatch_hook_scope(hook):
        y = ops.deform_conv(x, off, w, offset_bound=2.0, device="cpu")
        assert seen[-1][0] is y and seen[-1][1] is None
        from repro_torch.kernels import plan

        def boom(*a, **k):
            raise RuntimeError("kernel exploded")
        monkeypatch.setattr(plan, "int8_forward", boom)
        with pytest.raises(RuntimeError, match="exploded"):
            ops.deform_conv(x, off, w, offset_bound=2.0, precision="int8",
                            device="cpu")
    assert seen[-1][0] is None and "exploded" in str(seen[-1][1])


def test_a_raising_finish_is_logged_and_ignored(caplog):
    def hook(ctx):
        def finish(out=None, error=None):
            raise ValueError("broken instrument")
        return finish
    x, off, w = _dcl()
    want = ops.deform_conv(x, off, w, offset_bound=2.0, device="cpu")
    with ops.dispatch_hook_scope(hook), \
            caplog.at_level(logging.WARNING, logger="repro_torch.kernels"):
        got = ops.deform_conv(x, off, w, offset_bound=2.0, device="cpu")
    assert torch.equal(got, want)
    assert any("broken instrument" in r.message for r in caplog.records)
    assert ops.get_dispatch_hook() is None


def test_chain_dispatch_is_recorded():
    tracker = DivergenceTracker()
    rec = DispatchRecorder(tracker=tracker)
    x, _, w = _dcl(c=8, m=8)
    g = torch.Generator().manual_seed(1)
    w_off = torch.randn(9, 8, 18, generator=g) * 0.05
    with ops.dispatch_hook_scope(rec):
        ops.deform_conv_chain(x, w, w_off, torch.zeros(18),
                              offset_bound=2.0, x_scale=0.05, emit="fp32",
                              device="cpu")
    (row,) = tracker.report()["dispatches"]
    assert row["quant"] == "int8_chain" and row["dtype"] == "int8"


# -- the engine's telemetry ---------------------------------------------

SMALL = dict(stage_sizes=(1, 1, 1, 1), widths=(16, 32, 64, 128),
             stem_width=8, num_dcn=2, num_classes=4, img_size=32,
             offset_bound=2.0)


@pytest.fixture(scope="module")
def served():
    cfg = R.ResNetDCNConfig(**SMALL, use_kernel=True)
    params = R.init_params(cfg, seed=0, device="cpu")
    eng = DCLServingEngine(params, cfg,
                           DCLServeConfig(buckets=(32,), slots=2,
                                          quant="fp32_kernel"),
                           device="cpu")
    rng = np.random.RandomState(0)
    for _ in range(3):
        eng.submit(rng.randn(32, 32, 3).astype(np.float32))
    with tracer_scope(Tracer()):        # dispatches are timed when tracing
        eng.run_until_drained()
    return eng


def test_engine_telemetry_carries_divergence_and_plans(served):
    tel = served.telemetry()
    rows = tel["divergence"]["dispatches"]
    assert len(rows) == 2                        # two DCL shapes
    assert sum(r["n"] for r in rows) == 2 * served.steps
    assert {r["clock"] for r in rows} == {"host"}
    assert all(r["share"] > 0 and r["bound_s"] > 0 for r in rows)
    assert tel["plan_sources"] == {"32": {"s2b0": "analytic",
                                          "s3b0": "analytic"}}
    info = tel["plan_cache"]
    assert info["tuned_hits"] == 0 and not info["tuned_cache"]["installed"]
    # Priced at the tiles the engine's plans resolved.
    assert sorted(tuple(r["tiles"]) for r in rows) == \
        sorted(served.plans[32].values())
    snap = tel["metrics"]["counters"]["kernel_dispatch_total"]["values"]
    assert sum(v["value"] for v in snap) == 2 * served.steps


def test_engine_fake_clock_gives_no_share():
    cfg = R.ResNetDCNConfig(**SMALL, use_kernel=True)
    eng = DCLServingEngine(R.init_params(cfg, seed=0, device="cpu"), cfg,
                           DCLServeConfig(buckets=(32,), slots=2,
                                          quant="fp32_kernel"),
                           device="cpu", clock=FakeClock())
    eng.submit(np.zeros((32, 32, 3), np.float32))
    with tracer_scope(Tracer()):
        eng.run_until_drained()
    rows = eng.telemetry()["divergence"]["dispatches"]
    assert rows and all(r["best_s"] == 0 and r["share"] is None
                        for r in rows)


# -- obs_report -----------------------------------------------------------

def _trace(tmp_path):
    clock = FakeClock()
    tr = Tracer(clock=clock)
    with tr.span("serve/step", bucket=32):
        clock.advance(0.2)
        tr.event("fault/slow_step")
    with tr.span("serve/step", bucket=32):
        clock.advance(0.1)
    return tr, tr.export_jsonl(tmp_path / "trace.jsonl")


def _without_self(rows: list[str]) -> list[str]:
    """The summary's rows with the span table's ``self_s`` column (the
    port's addition, 10 characters after ``total_s``) taken out."""
    n = rows.index("") if "" in rows else len(rows)
    return [r[:44] + r[54:] for r in rows[:n]] + rows[n:]


def test_trace_export_and_summary_match_jax(tmp_path):
    tr, path = _trace(tmp_path)
    recs = obs_report.load_trace(path)
    assert {r["type"] for r in recs} == {"span", "event"}
    rows = obs_report.summarize_trace(recs)
    assert rows[0].split()[2:4] == ["total_s", "self_s"]
    assert _without_self(rows) == jreport.summarize_trace(recs)
    assert any("serve/step" in r and "2" in r for r in rows)
    assert any("fault/slow_step" in r for r in rows)


def test_trace_summary_gives_self_time(tmp_path):
    """Self time: a span's duration less what its children cover, each
    child clipped to its parent and overlaps counted once."""
    def span(sid, name, t0, t1, parent=None):
        return {"type": "span", "name": name, "span_id": sid,
                "parent_id": parent, "t0": t0, "t1": t1, "dur_s": t1 - t0,
                "attrs": {}}
    recs = [span(2, "serve/batch", 0.1, 0.3, 1),
            span(3, "serve/forward", 0.2, 0.6, 1),   # overlaps batch
            span(4, "kernel/dispatch", 0.25, 0.35, 3),
            span(1, "serve/step", 0.0, 1.0),
            span(6, "serve/batch", 1.1, 1.2, 5),
            span(5, "serve/step", 1.0, 1.5),
            {"type": "event", "name": "serve/admit", "ts": 0.0,
             "parent_id": None, "attrs": {"uid": 0}}]
    path = tmp_path / "made.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in recs))
    rows = obs_report.summarize_trace(obs_report.load_trace(path))
    table = {r.split()[0]: r.split()[1:] for r in rows[1:] if r}
    # serve/step: 1.5 s, children cover 0.5 + 0.1; forward 0.4 less 0.1.
    assert table["serve/step"][:3] == ["2", "1.500", "0.900"]
    assert table["serve/forward"][:3] == ["1", "0.400", "0.300"]
    assert table["serve/batch"][:3] == ["2", "0.300", "0.300"]
    assert table["kernel/dispatch"][:3] == ["1", "0.100", "0.100"]


def test_metrics_summary_matches_jax(tmp_path):
    reg = MetricsRegistry()
    reg.counter("serve_requests_total").inc(5, outcome="ok", bucket="32")
    reg.gauge("serve_queue_depth").set(2)
    h = reg.histogram("serve_latency_seconds")
    for v in (0.01, 0.02, 0.03):
        h.observe(v, bucket="32", outcome="ok")
    path = dump_telemetry(tmp_path / "tel.json", {"counters": {"ok": 5}},
                          extra={"steps": np.int64(2)}, registry=reg)
    doc = json.loads(path.read_text())
    assert doc["steps"] == 2 and doc["counters"] == {"ok": 5}
    snap = obs_report.load_metrics(path)
    assert obs_report.summarize_metrics(snap) == \
        jreport.summarize_metrics(snap)
    assert any("serve_requests_total" in r and "= 5" in r
               for r in obs_report.summarize_metrics(snap))


def test_divergence_summary_renders_engine_telemetry(served, tmp_path,
                                                     capsys):
    path = dump_telemetry(tmp_path / "serve.json", served.telemetry())
    report = obs_report.load_divergence(path)
    rows = obs_report.summarize_divergence(report)
    assert "share" in rows[0] and "bound_ms" in rows[0]
    assert sum("deform_conv[2x" in r for r in rows) == 2
    pairs = {"pairs": [DivergenceTracker().record_pair(
        "bwd", modeled_ratio=1.92, measured_ratio=0.8)]}
    assert obs_report.summarize_divergence(pairs) == \
        jreport.summarize_divergence(pairs)
    _, trace = _trace(tmp_path)
    assert obs_report.main(["--trace", str(trace), "--metrics", str(path),
                            "--divergence", str(path)]) == 0
    out = capsys.readouterr().out
    assert "== divergence" in out and "kernel_dispatch_total" in out
    plain = tmp_path / "plain.json"
    plain.write_text(json.dumps({"x": 1}))
    with pytest.raises(ValueError, match="divergence"):
        obs_report.load_divergence(plain)


def test_divergence_summary_says_what_each_clock_measures():
    rows = [dict(key="k", n=1, best_s=1e-3, clock=clock, modeled_bytes=1,
                 bound_s=1e-5, share=0.01, bound_by="bytes")
            for clock in ("device", "host")]
    lines = obs_report.summarize_divergence({"dispatches": rows[:1]})
    assert lines[-1].startswith("clock device: the CUDA stream's time")
    assert "host enqueues" in lines[-1]
    lines = obs_report.summarize_divergence({"dispatches": rows})
    assert [ln.split(":")[0] for ln in lines[-2:]] == ["clock device",
                                                       "clock host"]


def test_recorder_with_tracer_scope_records_spans():
    with tracer_scope(Tracer()) as tr:
        x, off, w = _dcl()
        with ops.dispatch_hook_scope(DispatchRecorder()):
            ops.deform_conv(x, off, w, offset_bound=2.0, device="cpu")
    assert [s.name for s in tr.spans] == ["kernel/dispatch"]
