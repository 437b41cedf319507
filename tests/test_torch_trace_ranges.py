"""The port's spans on the profiler's clock (``obs.trace``): a disabled
tracer outside a profiler hands out ``NOOP_SPAN``, under a profiler every
span is a ``record_function`` range; the serving engine's and the
Trainer's spans nest as their docstrings say; the engine times its
dispatches only while its tracer is enabled; a step's span carries the
uids of its requests."""
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import optim as TOPT
from repro_torch import tree as T
from repro_torch.data import DetectionDataConfig, detection_batch
from repro_torch.kernels import ops
from repro_torch.models import resnet_dcn as R
from repro_torch.obs import NOOP_SPAN, DispatchRecorder, Tracer, tracer_scope
from repro_torch.obs.trace import get_tracer
from repro_torch.serve import DCLServeConfig, DCLServingEngine
from repro_torch.train import Trainer, TrainerConfig

torch.set_num_threads(2)

SMALL = dict(stage_sizes=(1, 1, 1, 1), widths=(16, 32, 64, 128),
             stem_width=8, num_dcn=2, num_classes=4, img_size=32,
             offset_bound=2.0)
SERVE_PARTS = ["serve/batch", "serve/forward", "serve/readback",
               "serve/retire"]
TRAIN_PARTS = ["train/forward", "train/backward", "train/sentinel",
               "train/optimizer", "train/sync"]


@pytest.fixture(scope="module")
def model():
    cfg = R.ResNetDCNConfig(**SMALL, use_kernel=True)
    return cfg, R.init_params(cfg, seed=0, device="cpu")


def _engine(model):
    cfg, params = model
    eng = DCLServingEngine(params, cfg,
                           DCLServeConfig(buckets=(32,), slots=2,
                                          quant="fp32_kernel"),
                           device="cpu")
    rng = np.random.RandomState(0)
    for _ in range(2):
        eng.submit(rng.randn(32, 32, 3).astype(np.float32))
    return eng


def _trainer(model, tmp_path):
    cfg, params = model
    data = DetectionDataConfig(img_size=32, global_batch=2, num_classes=4,
                               seed=3)
    return Trainer(
        loss_fn=lambda p, b: R.train_loss(p, cfg, b, lam=0.1, device="cpu"),
        params=T.tree_map(torch.clone, params),
        optimizer=TOPT.sgd(TOPT.constant(0.01), momentum=0.9),
        batch_fn=lambda s: detection_batch(data, s),
        config=TrainerConfig(total_steps=1, ckpt_every=100,
                             ckpt_dir=str(tmp_path), log_every=1),
        device="cpu")


def _ranges(fn, tmp_path) -> list[tuple[str, float, float]]:
    """(name, start, end) of every ``user_annotation`` event a CPU
    profiler records around ``fn()``, in start order."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return sorted(((e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") == "user_annotation" and "dur" in e),
                  key=lambda r: r[1])


def _inside(ranges, outer: str, parts: list[str]) -> list[str]:
    """The names of ``parts`` that lie inside the first ``outer`` range,
    in start order."""
    _, a, b = next(r for r in ranges if r[0] == outer)
    return [n for n, s, e in ranges if n in parts and a <= s and e <= b]


def test_disabled_tracer_outside_a_profiler_hands_out_the_noop_span():
    tr = Tracer(enabled=False)
    assert tr.span("serve/step", step=0) is NOOP_SPAN
    assert get_tracer().span("train/step") is NOOP_SPAN
    with profile(activities=[ProfilerActivity.CPU]):
        inside = tr.span("serve/step")
    assert inside is not NOOP_SPAN
    with inside as sp:                  # a range alone, nothing recorded
        sp.set_attr(outcome="ok")
    assert tr.records() == []


def test_engine_step_ranges_nest_in_order(model, tmp_path):
    eng = _engine(model)
    ranges = _ranges(eng.step, tmp_path)
    assert _inside(ranges, "serve/step", SERVE_PARTS) == SERVE_PARTS
    assert not get_tracer().records()   # the default tracer stays off


def test_trainer_step_ranges_nest(model, tmp_path):
    ranges = _ranges(_trainer(model, tmp_path / "ckpt").run, tmp_path)
    names = [r[0] for r in ranges]
    assert {"train/step", "train/data", "train/compute"} <= set(names)
    inside = _inside(ranges, "train/compute", TRAIN_PARTS)
    assert inside == TRAIN_PARTS
    # The batch's own sync lies in the step, before the computation.
    assert _inside(ranges, "train/step", ["train/sync"]) == \
        ["train/sync"] * 2


def test_enabled_tracer_records_and_ranges_the_same_spans(model, tmp_path):
    eng = _engine(model)
    with tracer_scope(Tracer()) as tr:
        ranges = _ranges(eng.step, tmp_path)
    recorded = [s.name for s in sorted(tr.spans, key=lambda s: s.t0)]
    ranged = [n for n, _, _ in ranges]
    assert recorded[:1] + [n for n in recorded if n in SERVE_PARTS] == \
        ["serve/step"] + SERVE_PARTS
    assert sorted(recorded) == sorted(ranged)
    step = next(s for s in tr.spans if s.name == "serve/step")
    assert all(s.parent_id == step.span_id for s in tr.spans
               if s.name in SERVE_PARTS)
    assert step.attrs["step"] == 0 and step.attrs["bucket"] == 32


def test_plain_engine_times_no_dispatch(model, monkeypatch):
    made = []
    init = DispatchRecorder.__init__

    def counted(self, *a, **kw):
        made.append(self)
        init(self, *a, **kw)

    monkeypatch.setattr(DispatchRecorder, "__init__", counted)
    for traced in (False, True):
        seen = []
        eng = _engine(model)
        with ops.dispatch_hook_scope(lambda ctx: seen.append(ctx["op"])), \
                tracer_scope(Tracer(enabled=traced)):
            eng.run_until_drained()
        # The outer hook sees every dispatch (two DCLs a step) either way.
        assert eng.steps and len(seen) == 2 * eng.steps
        rows = eng.telemetry()["divergence"]["dispatches"]
        assert len(made) == (eng.steps if traced else 0)
        assert sum(r["n"] for r in rows) == (2 * eng.steps if traced else 0)


def test_step_span_carries_its_requests_uids(model):
    with tracer_scope(Tracer()) as tr:
        eng = _engine(model)
        eng.run_until_drained()
    recs = tr.records()
    (step,) = [r for r in recs
               if r["type"] == "span" and r["name"] == "serve/step"]

    def uids(name):
        return sorted(r["attrs"]["uid"] for r in recs
                      if r["type"] == "event" and r["name"] == name)

    assert sorted(step["attrs"]["uids"]) == uids("serve/admit") == \
        uids("serve/retire") == sorted(r.uid for r in eng.completed)
    assert len(step["attrs"]["uids"]) == 2


def test_launcher_telemetry_keeps_its_divergence_rows(tmp_path, capsys):
    from repro_torch.launch import obs_report
    from repro_torch.launch import serve as launch
    path = tmp_path / "tel.json"
    launch.main(["--arch", "resnet50_dcn_bounded", "--buckets", "64",
                 "--requests", "4", "--slots", "2", "--reduced",
                 "--device", "cpu", "--telemetry", str(path)])
    assert not get_tracer().enabled          # the scope is closed again
    rows = obs_report.load_divergence(path)["dispatches"]
    assert rows and sum(r["n"] for r in rows) == 2 * 2   # 2 steps x 2 DCLs
    assert obs_report.main(["--divergence", str(path)]) == 0
    out = capsys.readouterr().out
    assert all(r["key"] in out for r in rows)
