"""The port's chaos harness (``repro_torch.resilience``) against the JAX
package's: the same schedules from the same seeds, checkpoints corrupted
byte for byte alike and rejected alike by both restores, the serve seams,
the Trainer's recovery through ``ChaosHooks``, a serving chaos run whose
per-request outcomes equal the JAX engine's under the same plan (the
requests it leaves alone within 1e-5 of JAX's and bit-equal to a clean
run), the card's ladder (a dispatch fault retried on its rung or
``failed``, never degraded), and a training chaos run bit-equal to the
run that sees only its non-finite step."""
import json
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _fakeclock import FakeClock
from repro import checkpoint as JC
from repro import resilience as JRS
from repro.checkpoint.checkpoint import \
    CheckpointCorruptError as JCorrupt
from repro.models import resnet_dcn as JR
from repro.serve import DCLServeConfig as JServeConfig
from repro.serve import DCLServingEngine as JEngine
from repro_torch import checkpoint as TC
from repro_torch.checkpoint.checkpoint import CheckpointCorruptError
from repro_torch.data import DetectionDataConfig, detection_batch
from repro_torch.kernels import ops
from repro_torch.models import resnet_dcn as R
from repro_torch.obs import Tracer, dump_telemetry, tracer_scope
from repro_torch.optim import constant, sgd
from repro_torch.resilience import (FAULT_KINDS, ChaosHooks,
                                    DataPipelineHiccup, DeviceLost,
                                    FaultEvent, FaultInjected, FaultPlan,
                                    KernelDispatchFault, corrupt_checkpoint)
from repro_torch.serve import (OUTCOMES, DCLServeConfig, DCLServingEngine,
                               ladder)
from repro_torch.train import Trainer, TrainerConfig
from repro_torch.tree import leaves

torch.set_num_threads(2)

KINDS = ("nonfinite_grads", "ckpt_corrupt", "step_crash", "data_hiccup")
CHAOS_SEED = 20260808


# -- plans ----------------------------------------------------------------

def _events(plan):
    return [(e.step, e.kind, e.mode) for e in plan.events]


@pytest.mark.parametrize("seed", [0, 7, 8, 1234, CHAOS_SEED])
@pytest.mark.parametrize("total,min_step,kinds", [
    (20, 2, KINDS), (8, 2, KINDS), (12, 1, ("step_crash", "data_hiccup")),
    (10, 3, ("ckpt_corrupt", "nonfinite_grads", "ckpt_corrupt")),
])
def test_random_plans_equal_jax(seed, total, min_step, kinds):
    ours = FaultPlan.random(seed, total_steps=total, kinds=kinds,
                            min_step=min_step)
    theirs = JRS.FaultPlan.random(seed, total_steps=total, kinds=kinds,
                                  min_step=min_step)
    assert _events(ours) == _events(theirs)
    assert ours.summary() == theirs.summary()
    steps = [e.step for e in ours.events]
    assert steps == sorted(steps) and min(steps) >= min_step


def test_plan_validation_and_kinds():
    assert FAULT_KINDS == JRS.FAULT_KINDS
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultEvent(step=1, kind="meteor_strike")
    with pytest.raises(ValueError, match="window per fault kind"):
        FaultPlan.random(0, total_steps=3, kinds=KINDS[:3])
    a = FaultPlan.random(7, total_steps=20, min_step=2)
    assert a == FaultPlan.random(7, total_steps=20, min_step=2)
    assert a != FaultPlan.random(8, total_steps=20, min_step=2)
    assert a.kinds() == set(KINDS)
    assert [i for i, _ in a.at(a.events[1].step)] == [1]


# -- checkpoint corruption -------------------------------------------------

@pytest.mark.parametrize("mode", ["truncate_leaf", "bad_manifest"])
def test_corruption_is_alike_and_both_restores_fall_back(tmp_path, mode):
    tree = {"w": np.arange(12, dtype=np.float32).reshape(3, 4),
            "b": np.ones(4, np.float32)}
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    for step in (1, 2):
        JC.save_checkpoint(ours, step, {k: v * step
                                        for k, v in tree.items()})
    shutil.copytree(ours, theirs)
    assert corrupt_checkpoint(ours, mode=mode).name == "step_00000002"
    JRS.corrupt_checkpoint(theirs, mode=mode)
    for f in sorted((ours / "step_00000002").iterdir()):
        assert f.read_bytes() == (theirs / "step_00000002" /
                                  f.name).read_bytes(), f.name
    like_t = {k: torch.zeros(v.shape) for k, v in tree.items()}
    got, step = TC.restore_checkpoint(ours, like_t)
    jgot, jstep = JC.restore_checkpoint(theirs, {k: jnp.zeros(v.shape)
                                                 for k, v in tree.items()})
    assert step == jstep == 1
    assert np.array_equal(got["w"].numpy(), np.asarray(jgot["w"]))
    with pytest.raises(CheckpointCorruptError):
        TC.restore_checkpoint(ours, like_t, step=2)
    with pytest.raises(JCorrupt):
        JC.restore_checkpoint(theirs, tree, step=2)
    with pytest.raises(ValueError, match="corruption mode"):
        corrupt_checkpoint(ours, mode="bit_flip")
    with pytest.raises(FileNotFoundError):
        corrupt_checkpoint(tmp_path / "empty")


# -- seams ---------------------------------------------------------------------

def test_hooks_are_one_shot_and_poison_only_float_leaves(tmp_path):
    plan = FaultPlan(events=(FaultEvent(step=1, kind="data_hiccup"),
                             FaultEvent(step=1, kind="nonfinite_grads")))
    hooks = ChaosHooks(plan, ckpt_dir=tmp_path)
    with pytest.raises(DataPipelineHiccup):
        hooks.fault_hook(1)
    hooks.fault_hook(1)                          # consumed
    batch = {"images": np.ones((2, 2), np.float32),
             "labels": np.ones((2,), np.int32)}
    poisoned = hooks.batch_hook(1, batch)
    assert torch.isnan(poisoned["images"]).all()
    assert poisoned["labels"] is batch["labels"]
    assert np.isfinite(hooks.batch_hook(1, batch)["images"]).all()
    assert {f["kind"] for f in hooks.fired} == {"data_hiccup",
                                                "nonfinite_grads"}
    hooks.dump_telemetry(tmp_path / "t.json", extra={"note": "t"})
    rec = json.loads((tmp_path / "t.json").read_text())
    assert rec["note"] == "t" and len(rec["fired"]) == 2
    assert rec["plan"]["events"][0]["kind"] == "data_hiccup"
    assert issubclass(DeviceLost, FaultInjected)


def test_serve_seams_match_jax():
    events = (FaultEvent(step=2, kind="slow_step", mode="0.25"),
              FaultEvent(step=0, kind="malformed_request"),
              FaultEvent(step=0, kind="bucket_miss_storm", mode="2"),
              FaultEvent(step=0, kind="dispatch_fault"))
    jevents = tuple(JRS.FaultEvent(e.step, e.kind, e.mode) for e in events)

    class Req:
        def __init__(self, image):
            self.image = image
    img = np.zeros((32, 32, 3), np.float32)
    seen = {}
    for name, hooks in (("port", ChaosHooks(FaultPlan(events=events))),
                        ("jax", JRS.ChaosHooks(JRS.FaultPlan(jevents)))):
        slept = []
        hooks.sleep = slept.append
        hooks.serve_step_hook(1)
        hooks.serve_step_hook(2, {"bucket": 32})
        hooks.serve_step_hook(2)
        shapes = [np.shape(hooks.admit_hook(Req(img)).image)
                  for _ in range(4)]
        with pytest.raises(RuntimeError, match="kernel-dispatch"):
            hooks.dispatch_hook({"op": "deform_conv"})
        hooks.dispatch_hook({"op": "deform_conv"})     # consumed
        seen[name] = (slept, shapes, [f["kind"] for f in hooks.fired])
    assert seen["port"] == seen["jax"]
    assert seen["port"][0] == [0.25]
    assert seen["port"][1] == [(5,), (33, 35, 3), (33, 35, 3), (32, 32, 3)]


# -- the Trainer through the hooks --------------------------------------

def _loss_fn(p, b):
    pred = b["x"] @ p["w"]
    return ((pred - b["y"]) ** 2).mean(), {}


def _batch_fn(step):
    x = np.random.RandomState(step).randn(4, 3).astype(np.float32)
    return {"x": x, "y": x @ np.ones((3, 2), np.float32)}


def _trainer(ckpt_dir, *, total=6, hooks=None, **cfg_kw):
    g = torch.Generator().manual_seed(42)
    tr = Trainer(loss_fn=_loss_fn,
                 params={"w": torch.randn(3, 2, generator=g) * 0.1},
                 optimizer=sgd(constant(0.1)), batch_fn=_batch_fn,
                 config=TrainerConfig(total_steps=total, ckpt_every=1,
                                      ckpt_dir=str(ckpt_dir), log_every=1,
                                      **cfg_kw),
                 fault_hook=None if hooks is None else hooks.fault_hook,
                 batch_hook=None if hooks is None else hooks.batch_hook,
                 device="cpu")
    if hooks is not None:
        hooks.bind(tr)
    return tr


def test_nonfinite_step_is_skipped(tmp_path):
    hooks = ChaosHooks(FaultPlan(events=(FaultEvent(2, "nonfinite_grads"),)))
    tr = _trainer(tmp_path, hooks=hooks)
    hist = tr.run()
    assert tr.step == 6 and tr.telemetry["skipped"] == 1
    assert torch.isfinite(tr.params["w"]).all()
    assert [h["step"] for h in hist if "skipped" in h.get("event", "")] \
        == [2]


def test_crash_and_corruption_replay_bit_exact(tmp_path):
    free = _trainer(tmp_path / "free", total=8)
    free.run()
    for mode in ("truncate_leaf", "bad_manifest"):
        hooks = ChaosHooks(FaultPlan(events=(
            FaultEvent(3, "ckpt_corrupt", mode),
            FaultEvent(5, "step_crash"), FaultEvent(6, "data_hiccup"))))
        tr = _trainer(tmp_path / mode, total=8, hooks=hooks)
        tr.run()
        assert tr.telemetry["recovered"] == 3
        assert torch.equal(tr.params["w"], free.params["w"])


def test_retry_exhaustion_and_no_checkpoint_reraise(tmp_path):
    def always(step):
        if step >= 2:
            raise DeviceLost(f"persistent failure at step {step}")
    tr = _trainer(tmp_path / "a")
    tr.fault_hook = always
    with pytest.raises(DeviceLost, match="persistent"):
        tr.run()
    assert tr.telemetry["retries"] - tr.telemetry["recovered"] == 1
    hooks = ChaosHooks(FaultPlan(events=(FaultEvent(0, "step_crash"),)))
    with pytest.raises(DeviceLost):
        _trainer(tmp_path / "b", hooks=hooks).run()


# -- serving chaos -------------------------------------------------------------

BUCKET = 32
N_REQUESTS = 10
SMALL = dict(stage_sizes=(1, 1, 1, 1), widths=(16, 32, 64, 128),
             stem_width=8, num_dcn=2, num_classes=4, img_size=BUCKET,
             offset_bound=2.0)


def _serve_plan(pkg):
    rng = np.random.default_rng(CHAOS_SEED)
    slow_at = int(rng.integers(1, 3))
    return pkg.FaultPlan(events=(
        pkg.FaultEvent(step=slow_at, kind="slow_step", mode="1.0"),
        pkg.FaultEvent(step=0, kind="malformed_request"),
        pkg.FaultEvent(step=0, kind="bucket_miss_storm", mode="2"),
        pkg.FaultEvent(step=0, kind="dispatch_fault"),
    ), seed=CHAOS_SEED)


def _images():
    rng = np.random.RandomState(CHAOS_SEED % 2**31)
    return [rng.randn(BUCKET, BUCKET, 3).astype(np.float32)
            for _ in range(N_REQUESTS)]


@pytest.fixture(scope="module")
def model():
    cfg = R.ResNetDCNConfig(**SMALL, use_kernel=True)
    return cfg, R.init_params(cfg, seed=0, device="cpu")


def _run(model, pkg=None, *, jax=False, quant="fp32_kernel", uids=None,
         cuda_ladder=False, **serve_kw):
    cfg, params = model
    clock = FakeClock()
    hooks = None if pkg is None else pkg.ChaosHooks(_serve_plan(pkg))
    if hooks is not None:
        hooks.sleep = clock.advance
    kw = dict(clock=clock,
              step_hook=None if hooks is None else hooks.serve_step_hook,
              admit_hook=None if hooks is None else hooks.admit_hook)
    if jax:
        jparams = {k: {kk: jnp.asarray(vv.numpy()) if torch.is_tensor(vv)
                       else {k3: jnp.asarray(v3.numpy())
                             for k3, v3 in vv.items()}
                       for kk, vv in v.items()} for k, v in params.items()}
        eng = JEngine(jparams, JR.ResNetDCNConfig(**SMALL, use_kernel=True),
                      JServeConfig(buckets=(BUCKET,), slots=2, quant=quant,
                                   **serve_kw), **kw)
        from repro.kernels import ops as jops
        scope = jops.dispatch_hook_scope
    else:
        eng = DCLServingEngine(params, cfg, DCLServeConfig(
            buckets=(BUCKET,), slots=2, quant=quant, **serve_kw),
            device="cpu", **kw)
        scope = ops.dispatch_hook_scope
        if cuda_ladder:
            eng.rungs = ladder(quant, torch.device("cuda"))
    images = _images()
    for uid in uids if uids is not None else range(N_REQUESTS):
        eng.submit(images[uid], uid=uid,
                   deadline=0.5 if uid >= N_REQUESTS - 2 else None)
    if hooks is None:
        eng.run_until_drained()
    else:
        with scope(hooks.dispatch_hook):
            eng.run_until_drained()
    return eng, hooks


def _by_uid(eng):
    return {r.uid: r for r in eng.completed}


def test_serve_chaos_matches_the_jax_engine(model):
    tracer = Tracer()
    with tracer_scope(tracer):
        eng, hooks = _run(model, _resilience(), max_retries=0)
    jeng, jhooks = _run(model, JRS, jax=True, max_retries=0)
    ours, theirs = _by_uid(eng), _by_uid(jeng)
    assert len(ours) == N_REQUESTS and not len(eng.queue)
    assert {u: (r.outcome, r.ladder, r.degraded, r.retries)
            for u, r in ours.items()} == \
        {u: (r.outcome, r.ladder, r.degraded, r.retries)
         for u, r in theirs.items()}
    assert all(r.outcome in OUTCOMES and r.outcome not in
               ("pending", "failed") for r in ours.values())
    assert [f["kind"] for f in hooks.fired] == \
        [f["kind"] for f in jhooks.fired]
    assert [ours[u].outcome for u in (0, 1, 2)] == \
        ["malformed", "unbucketable", "unbucketable"]
    degraded = [r for r in ours.values() if r.degraded]
    assert degraded and all(r.ladder == "fp32_ref" and r.outcome == "ok"
                            for r in degraded)
    assert {r.uid for r in ours.values()
            if r.outcome == "deadline_exceeded"} <= {8, 9}
    names = {e["name"] for e in tracer.events}
    assert {"fault/slow_step", "fault/dispatch_fault",
            "fault/malformed_request", "fault/bucket_miss_storm"} <= names
    # The requests the plan left alone: within 1e-5 of JAX's, and equal
    # to the same requests served in a clean engine.
    clean = _by_uid(_run(model, uids=range(3, N_REQUESTS))[0])
    untouched = [u for u, r in ours.items() if r.outcome == "ok"
                 and not r.degraded and not r.retries]
    assert untouched
    for u in untouched:
        for key in ("cls", "box"):
            want = np.asarray(theirs[u].result[key])
            got = ours[u].result[key]
            assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
            assert np.array_equal(got, clean[u].result[key])


def _resilience():
    from repro_torch import resilience
    return resilience


@pytest.mark.parametrize("retries,outcome", [(2, "ok"), (0, "failed")])
def test_dispatch_fault_on_the_card_ladder_never_degrades(model, retries,
                                                          outcome):
    eng, hooks = _run(model, _resilience(), max_retries=retries,
                      cuda_ladder=True)
    hit = [r for r in eng.completed if r.retries]
    assert hit and all(r.outcome == outcome and not r.degraded
                       and r.ladder in (None, "fp32_kernel") for r in hit)
    assert not any(r.degraded for r in eng.completed)
    if outcome == "failed":
        assert all("KernelDispatchFault" in r.error for r in hit)
    assert "dispatch_fault" in [f["kind"] for f in hooks.fired]
    assert issubclass(KernelDispatchFault, FaultInjected)


# -- training chaos ------------------------------------------------------------

def test_training_chaos_is_bit_exact_to_the_skip_only_run(model, tmp_path):
    cfg, _ = model
    data = DetectionDataConfig(img_size=BUCKET, global_batch=2,
                               num_classes=4, seed=5)
    plan = FaultPlan.random(CHAOS_SEED, total_steps=8, kinds=KINDS,
                            min_step=2)
    skip_only = FaultPlan(events=tuple(
        e for e in plan.events if e.kind == "nonfinite_grads"))

    def run(name, hooks):
        tr = Trainer(
            loss_fn=lambda p, b: R.train_loss(p, cfg, b, lam=0.1,
                                              device="cpu"),
            params=R.init_params(cfg, seed=0, device="cpu"),
            optimizer=sgd(constant(0.05), momentum=0.9),
            batch_fn=lambda s: detection_batch(data, s),
            config=TrainerConfig(total_steps=8, ckpt_every=1,
                                 ckpt_dir=str(tmp_path / name),
                                 log_every=1, max_retries=5),
            fault_hook=hooks.fault_hook, batch_hook=hooks.batch_hook,
            device="cpu")
        hooks.bind(tr)
        hist = tr.run()
        return tr, hist
    oracle, _ = run("oracle", ChaosHooks(skip_only))
    hooks = ChaosHooks(plan)
    tracer = Tracer()
    with tracer_scope(tracer):
        tr, hist = run("chaos", hooks)
    assert tr.step == 8
    fired = {f["kind"] for f in hooks.fired}
    assert fired == set(KINDS)
    assert tr.telemetry["skipped"] == 1 and tr.telemetry["recovered"] >= 2
    events = [h["event"] for h in hist if "event" in h]
    assert any("corrupt" in e for e in events)
    assert all(torch.equal(a, b) for a, b in zip(
        leaves(tr.params), leaves(oracle.params)))
    assert {f"fault/{k}" for k in fired} <= {e["name"]
                                             for e in tracer.events}
    path = dump_telemetry(tmp_path / "chaos.json", hooks.telemetry(),
                          extra={"seed": CHAOS_SEED,
                                 "trainer_telemetry": tr.telemetry},
                          registry=tr.metrics)
    rec = json.loads(path.read_text())
    skipped = sum(v["value"] for v in rec["metrics"]["counters"][
        "train_steps_skipped_total"]["values"])
    assert skipped == rec["trainer_telemetry"]["skipped"] == 1
