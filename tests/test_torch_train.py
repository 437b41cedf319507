"""Port parity: the training path of ``repro_torch`` (optimizers,
schedules, data, checkpoints, Trainer, launcher) against the JAX package.

Inputs come from numpy with a seed and go through both.  Tolerances:
optimizer states and schedules rtol 1e-5 (the same formulas, float32
against float32 or float64 step constants); the Trainer on the small
ResNet-DCN 1e-4 relative (kernel-path gradients summed in another
order); data arrays exactly equal.
"""
import dataclasses
import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as JC
from repro import optim as JOPT
from repro.data import DetectionDataConfig as JDataCfg
from repro.data import detection_batch as j_detection_batch
from repro.models import resnet_dcn as JR
from repro.train import Trainer as JTrainer
from repro.train import TrainerConfig as JTrainerConfig
from repro_torch import checkpoint as TC
from repro_torch import optim as TOPT
from repro_torch import tree as T
from repro_torch.convert import params_from_jax
from repro_torch.data import DetectionDataConfig, detection_batch
from repro_torch.launch import train as launch
from repro_torch.models import resnet_dcn as TRN
from repro_torch.obs.trace import Tracer, tracer_scope
from repro_torch.train import NonFiniteDivergence, Trainer, TrainerConfig

torch.set_num_threads(2)

SMALL = dict(stage_sizes=(1, 1, 1, 1), widths=(16, 32, 64, 128),
             stem_width=8, num_dcn=2, num_classes=4, img_size=32,
             offset_bound=2.0)
DATA = dict(img_size=32, global_batch=2, num_classes=4, seed=3)


def _np_tree(tree):
    return {k: _np_tree(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict)
            else torch.from_numpy(np.array(v, copy=True))
            for k, v in tree.items()}


def _flat(tree):
    return np.concatenate([np.asarray(x, np.float32).ravel()
                           for x in jax.tree_util.tree_leaves(_np_tree(tree))])


# -- optimizers and schedules ------------------------------------------------

def _opt_problem(seed=0):
    rng = np.random.RandomState(seed)
    params = {"a": {"w": rng.randn(4, 3).astype(np.float32),
                    "b": rng.randn(3).astype(np.float32)},
              "k": rng.randn(2, 3, 5).astype(np.float32)}
    grads = [jax.tree_util.tree_map(
        lambda p: (rng.randn(*p.shape) * 3).astype(np.float32), params)
        for _ in range(3)]
    return params, grads


@pytest.mark.parametrize("name", ["sgd", "adamw", "adafactor"])
def test_optimizers_match_jax_over_three_steps(name):
    params, grads = _opt_problem()
    sched = (JOPT.warmup_cosine(0.1, 2, 10), TOPT.warmup_cosine(0.1, 2, 10))
    make = {"sgd": lambda m, s: m.sgd(s, momentum=0.9, weight_decay=1e-2,
                                      max_norm=5.0),
            "adamw": lambda m, s: m.adamw(s),
            "adafactor": lambda m, s: m.adafactor(s, weight_decay=1e-2)}[name]
    jopt, topt = make(JOPT, sched[0]), make(TOPT, sched[1])
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = jopt.init(jp)
    tp = _torch_tree(params)
    ts = topt.init(tp)
    for step, g in enumerate(grads):
        jp, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp,
                             jnp.asarray(step))
        with torch.no_grad():
            tp2, ts2 = topt.update(_torch_tree(g), ts, tp, step)
        assert tp2 is tp and ts2 is ts              # updated in place
    np.testing.assert_allclose(_flat(tp), _flat(jp), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_flat(ts), _flat(js), rtol=1e-5, atol=1e-6)
    assert [p for p, _ in T.leaves_with_paths(ts)] == [
        tuple(k.key for k in path)
        for path, _ in jax.tree_util.tree_leaves_with_path(js)]


def test_global_norm_and_clipping_match_jax():
    _, grads = _opt_problem(1)
    g = grads[0]
    np.testing.assert_allclose(
        float(TOPT.global_norm(_torch_tree(g))),
        float(JOPT.global_norm(jax.tree_util.tree_map(jnp.asarray, g))),
        rtol=1e-6)
    from repro.optim.optimizers import _clipped as jclip
    from repro_torch.optim.optimizers import _clipped as tclip
    np.testing.assert_allclose(
        _flat(tclip(_torch_tree(g), 2.0)),
        _flat(jclip(jax.tree_util.tree_map(jnp.asarray, g), 2.0)),
        rtol=1e-6)


def test_schedules_match_jax():
    for j, t in ((JOPT.constant(3e-3), TOPT.constant(3e-3)),
                 (JOPT.warmup_cosine(3e-3, 10, 50),
                  TOPT.warmup_cosine(3e-3, 10, 50)),
                 (JOPT.warmup_cosine(1.0, 0, 5, final_frac=0.0),
                  TOPT.warmup_cosine(1.0, 0, 5, final_frac=0.0))):
        for step in range(0, 60, 3):
            np.testing.assert_allclose(t(step), float(j(jnp.asarray(step))),
                                       rtol=1e-6, atol=1e-9)


def test_default_optimizer_matches_jax():
    for arch, n in (("resnet50_dcn_bounded", 10**7), ("glm4-9b", 9e9),
                    ("grok-1", 316e9)):
        assert TOPT.default_optimizer_for(arch, n).name \
            == JOPT.default_optimizer_for(arch, n).name
    # The paper's SGD: lr 0.005, momentum 0.9, weight decay 1e-4.
    params, grads = _opt_problem(2)
    jopt = JOPT.default_optimizer_for("resnet50_dcn", 1)
    topt = TOPT.default_optimizer_for("resnet50_dcn", 1)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jp, _ = jopt.update(jax.tree_util.tree_map(jnp.asarray, grads[0]),
                        jopt.init(jp), jp, jnp.asarray(0))
    tp = _torch_tree(params)
    with torch.no_grad():
        topt.update(_torch_tree(grads[0]), topt.init(tp), tp, 0)
    np.testing.assert_allclose(_flat(tp), _flat(jp), rtol=1e-6, atol=1e-7)


# -- data --------------------------------------------------------------------

@pytest.mark.parametrize("cfg", [dict(), dict(img_size=64, global_batch=4,
                                              num_classes=8, seed=5)])
def test_detection_batch_equals_jax(cfg):
    for step in (0, 1, 17):
        for host, hosts in ((0, 1), (1, 2)):
            want = j_detection_batch(JDataCfg(**cfg), step, host_id=host,
                                     num_hosts=hosts)
            got = detection_batch(DetectionDataConfig(**cfg), step,
                                  host_id=host, num_hosts=hosts)
            assert set(got) == set(want)
            for k in want:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(ValueError, match="does not split"):
        detection_batch(DetectionDataConfig(global_batch=3), 0, num_hosts=2)


# -- checkpoints -------------------------------------------------------------

def _bundle(seed=0, step=3):
    rng = np.random.RandomState(seed)
    return {"params": {"w": torch.from_numpy(rng.randn(3, 4).astype(
                           np.float32)),
                       "h": torch.from_numpy(rng.randn(5).astype(
                           np.float32)).to(torch.bfloat16)},
            "opt": {"mu": {"w": torch.zeros(3, 4), "h": torch.ones(5)}},
            "ef": None, "step": torch.tensor(step, dtype=torch.int32)}


def _equal(a, b):
    pa, pb = T.leaves_with_paths(a), T.leaves_with_paths(b)
    return [p for p, _ in pa] == [p for p, _ in pb] and all(
        x.dtype == y.dtype and torch.equal(x, y)
        for (_, x), (_, y) in zip(pa, pb))


def test_checkpoint_round_trip_and_layout(tmp_path):
    tree = _bundle()
    path = TC.save_checkpoint(tmp_path, 3, tree)
    assert path.name == "step_00000003"
    manifest = json.loads((path / "manifest.json").read_text())
    assert manifest["paths"] == [["opt", "mu", "h"], ["opt", "mu", "w"],
                                 ["params", "h"], ["params", "w"], ["step"]]
    assert [e["dtype"] for e in manifest["leaves"]] == [
        "float32", "float32", "bfloat16", "float32", "int32"]
    assert sorted(p.name for p in path.iterdir()) == [
        "000.npy", "001.npy", "002.npy", "003.npy", "004.npy",
        "manifest.json"]
    restored, step = TC.restore_checkpoint(tmp_path, _bundle(seed=1, step=0))
    assert step == 3 and _equal(restored, tree)
    # The JAX package reads the same layout, by leaf order.
    jtree, jstep = JC.restore_checkpoint(
        tmp_path, {"opt": {"mu": {"h": np.zeros(5, np.float32),
                                  "w": np.zeros((3, 4), np.float32)}},
                   "params": {"h": np.zeros(5, jnp.bfloat16),
                              "w": np.zeros((3, 4), np.float32)},
                   "step": np.int32(0)})
    np.testing.assert_array_equal(np.asarray(jtree["params"]["w"]),
                                  tree["params"]["w"].numpy())
    assert int(jtree["step"]) == 3 and jstep == 3
    # Another structure is refused, not mistaken for corruption.
    other = _bundle()
    other["params"]["v"] = other["params"].pop("w")
    with pytest.raises(ValueError, match="another structure"):
        TC.restore_checkpoint(tmp_path, other)


def test_checkpoint_keep_k_and_tmp_sweep(tmp_path):
    for s in range(5):
        TC.save_checkpoint(tmp_path, s, _bundle(step=s), keep=2)
    assert TC.checkpoint.complete_steps(tmp_path) == [4, 3]
    stale = tmp_path / "step_00000009.tmp"
    stale.mkdir()
    (stale / "000.npy").write_bytes(b"partial")
    mgr = TC.CheckpointManager(tmp_path, keep=2)
    assert not stale.exists() and mgr.latest_step() == 4
    mgr.save(5, _bundle(step=5))
    mgr.wait()
    assert TC.checkpoint.complete_steps(tmp_path) == [5, 4]
    restored, step = mgr.restore(_bundle(step=0))
    assert step == 5 and int(restored["step"]) == 5


def test_corrupt_leaf_falls_back_to_the_previous_step(tmp_path, caplog):
    TC.save_checkpoint(tmp_path, 1, _bundle(seed=1, step=1))
    path = TC.save_checkpoint(tmp_path, 2, _bundle(seed=2, step=2))
    leaf = path / "003.npy"
    leaf.write_bytes(leaf.read_bytes()[:-8] + b"\0" * 8)      # bit-rot
    restored, step = TC.restore_checkpoint(tmp_path, _bundle())
    assert step == 1 and _equal(restored, _bundle(seed=1, step=1))
    assert "failed verification" in caplog.text
    with pytest.raises(TC.CheckpointCorruptError, match="CRC32"):
        TC.restore_checkpoint(tmp_path, _bundle(), step=2)
    (path / "001.npy").unlink()
    with pytest.raises(TC.CheckpointCorruptError, match="missing"):
        TC.restore_checkpoint(tmp_path, _bundle(), step=2)


def test_async_write_error_is_raised_by_wait(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    mgr = TC.CheckpointManager(blocker / "ckpt")
    mgr.save(1, _bundle())
    with pytest.raises(OSError):
        mgr.wait()


def test_restore_a_params_checkpoint_written_by_jax(tmp_path):
    cfg = JR.ResNetDCNConfig(**SMALL)
    params = JR.init_params(jax.random.PRNGKey(4), cfg)
    JC.save_checkpoint(tmp_path, 7, params)
    like = TRN.init_params(TRN.ResNetDCNConfig(**SMALL), seed=0,
                           device="cpu")
    restored, step = TC.restore_checkpoint(tmp_path, like)
    assert step == 7
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                           device="cpu")
    assert _equal(restored, want)
    # Without key paths the restore goes by order and shape.
    bad = dict(like)
    bad["head"] = dict(bad["head"], cls=torch.zeros(1, 1, 256, 9))
    with pytest.raises(ValueError, match="shape"):
        TC.restore_checkpoint(tmp_path, bad)


# -- the Trainer -------------------------------------------------------------

def _perturbed(seed=0):
    params = jax.tree_util.tree_map(np.asarray, JR.init_params(
        jax.random.PRNGKey(seed), JR.ResNetDCNConfig(**SMALL)))
    rng = np.random.RandomState(seed)
    for block in params.values():
        if "dcl" in block:
            dcl = block["dcl"]
            c = dcl["w_offset"].shape[2]
            dcl["w_offset"] = (rng.randn(*dcl["w_offset"].shape)
                               / np.sqrt(4.5 * c)).astype(np.float32)
            dcl["b_offset"] = (rng.randn(*dcl["b_offset"].shape)
                               * 0.5).astype(np.float32)
    return params


def _torch_trainer(tmp_path, *, params=None, steps=3, lr=0.01,
                   use_kernel=True, **kw):
    cfg = TRN.ResNetDCNConfig(**SMALL, use_kernel=use_kernel)
    data = DetectionDataConfig(**DATA)
    cfg_kw = dict(total_steps=steps, ckpt_every=1, ckpt_dir=str(tmp_path),
                  log_every=1)
    cfg_kw.update({k: kw.pop(k) for k in list(kw) if k in
                   {f.name for f in dataclasses.fields(TrainerConfig)}})
    return Trainer(
        loss_fn=lambda p, b: TRN.train_loss(p, cfg, b, lam=0.1,
                                            device="cpu"),
        params=params_from_jax(params if params is not None
                               else _perturbed(), device="cpu"),
        optimizer=TOPT.sgd(TOPT.constant(lr), momentum=0.9,
                           weight_decay=1e-4),
        batch_fn=lambda s: detection_batch(data, s),
        config=TrainerConfig(**cfg_kw), device="cpu", **kw)


def _jax_run(tmp_path, *, microbatches=1, use_kernel=True, steps=3):
    cfg = JR.ResNetDCNConfig(**SMALL, use_kernel=use_kernel)
    data = JDataCfg(**DATA)
    tr = JTrainer(
        loss_fn=lambda p, b: JR.train_loss(p, cfg, b, lam=0.1),
        params=jax.tree_util.tree_map(jnp.asarray, _perturbed()),
        optimizer=JOPT.sgd(JOPT.constant(0.01), momentum=0.9,
                           weight_decay=1e-4),
        mesh=None, param_specs=None,
        batch_fn=lambda s: j_detection_batch(data, s),
        config=JTrainerConfig(total_steps=steps, ckpt_every=100,
                              ckpt_dir=str(tmp_path), log_every=1,
                              microbatches=microbatches))
    tr.run()
    return tr


def _params_np(trainer):
    return _flat(T.tree_map(lambda t: t.detach(), trainer.params))


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_trainer_matches_jax_trainer(tmp_path):
    """Three SGD steps of the Eq. 5 objective on the kernel paths.  The
    JAX Trainer runs without a mesh: on this host's one-CPU mesh its
    kernel path fails inside shard_map and degrades to XLA."""
    jt = _jax_run(tmp_path / "jax")
    tt = _torch_trainer(tmp_path / "torch")
    tt.run()
    jl = [h["loss"] for h in jt.history if "loss" in h]
    tl = [h["loss"] for h in tt.history if "loss" in h]
    assert len(tl) == len(jl) == 3
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    jg = [h["grad_norm"] for h in jt.history if "loss" in h]
    tg = [h["grad_norm"] for h in tt.history if "loss" in h]
    np.testing.assert_allclose(tg, jg, rtol=1e-4)
    p0 = _flat(_perturbed())
    jp = _flat(jax.tree_util.tree_map(np.asarray, jt.params))
    tp = _params_np(tt)
    assert _rel(tp, jp) <= 1e-4
    assert _rel(tp - p0, jp - p0) <= 1e-3          # the update itself
    assert tt.telemetry == {"skipped": 0, "recovered": 0, "retries": 0,
                            "preempted": False}
    assert len(tt.step_seconds) == 3 and tt.median_step_sec() > 0


def test_microbatches_match_jax_trainer(tmp_path):
    jt = _jax_run(tmp_path / "jax", microbatches=2, use_kernel=False,
                  steps=2)
    tt = _torch_trainer(tmp_path / "torch", microbatches=2, steps=2)
    tt.run()
    np.testing.assert_allclose(
        [h["loss"] for h in tt.history if "loss" in h],
        [h["loss"] for h in jt.history if "loss" in h], rtol=1e-4)
    assert _rel(_params_np(tt),
                _flat(jax.tree_util.tree_map(np.asarray, jt.params))) <= 1e-4
    with pytest.raises(ValueError, match="microbatches"):
        _torch_trainer(tmp_path / "bad", microbatches=3).run()


def _poison(step_to_poison):
    def hook(step, batch):
        if step_to_poison is None or step == step_to_poison:
            batch = dict(batch, images=np.full_like(batch["images"], np.nan))
        return batch
    return hook


def test_poisoned_batch_is_skipped_without_touching_state(tmp_path):
    tr = _torch_trainer(tmp_path, steps=3, batch_hook=_poison(1))
    seen = {}

    def fault_hook(step):
        seen[step] = (_params_np(tr), _flat(T.tree_map(
            lambda t: t.detach(), tr.opt_state)))
    tr.fault_hook = fault_hook
    tr.run()
    assert tr.telemetry["skipped"] == 1
    # Step 1 was a no-op on every state leaf; step 2 was taken.
    np.testing.assert_array_equal(seen[1][0], seen[2][0])
    np.testing.assert_array_equal(seen[1][1], seen[2][1])
    assert not np.array_equal(seen[2][0], _params_np(tr))
    events = [h["event"] for h in tr.history if "event" in h]
    assert events[0].startswith("skipped: non-finite step")


def test_nonfinite_divergence_raises(tmp_path):
    tr = _torch_trainer(tmp_path, steps=5, max_skips=2,
                        batch_hook=_poison(None))
    with pytest.raises(NonFiniteDivergence, match="2 consecutive"):
        tr.run()
    assert tr.telemetry["skipped"] == 2 and tr.telemetry["retries"] == 0


def test_retry_after_a_fault_replays_from_the_checkpoint(tmp_path):
    want = _torch_trainer(tmp_path / "clean", steps=4)
    want.run()
    fired = []

    def fault_hook(step):
        if step == 2 and not fired:
            fired.append(step)
            raise RuntimeError("injected node failure")
    sleeps = []
    tr = _torch_trainer(tmp_path / "faulty", steps=4, fault_hook=fault_hook,
                        retry_backoff=0.5, sleep=sleeps.append)
    tr.run()
    assert tr.telemetry == {"skipped": 0, "recovered": 1, "retries": 1,
                            "preempted": False}
    assert sleeps == [0.5]
    assert any(h.get("event", "").startswith("recovered: injected")
               for h in tr.history)
    assert _rel(_params_np(tr), _params_np(want)) <= 1e-6
    # Without a checkpoint there is nothing to replay from.
    def boom(step):
        raise RuntimeError("boom")
    tr = _torch_trainer(tmp_path / "none", steps=2, ckpt_every=100,
                        fault_hook=boom)
    with pytest.raises(RuntimeError, match="boom"):
        tr.run()


def test_retry_waits_for_the_checkpoint_in_flight(tmp_path, monkeypatch):
    """A fault right after an asynchronous save replays from that save,
    not from nothing: the writer is slowed so it is still in flight."""
    import time as _time
    from repro_torch.checkpoint import checkpoint as ck
    real = ck.save_checkpoint

    def slow(*a, **kw):
        _time.sleep(0.5)
        return real(*a, **kw)
    monkeypatch.setattr(ck, "save_checkpoint", slow)
    fired = []

    def fault_hook(step):
        if step == 1 and not fired:
            fired.append(step)
            raise RuntimeError("injected right after the step-1 save")
    tr = _torch_trainer(tmp_path, steps=2, fault_hook=fault_hook)
    tr.run()
    assert tr.telemetry["recovered"] == 1 and tr.step == 2


def test_resume_matches_an_uninterrupted_run(tmp_path):
    want = _torch_trainer(tmp_path / "a", steps=4)
    want.run()
    first = _torch_trainer(tmp_path / "b", steps=2)
    first.run()
    second = _torch_trainer(tmp_path / "b", steps=4,
                            params=jax.tree_util.tree_map(
                                lambda x: x * 0, _perturbed()))
    assert second.try_resume() and second.step == 2
    second.run()
    assert _rel(_params_np(second), _params_np(want)) <= 1e-6
    assert _rel(_flat(T.tree_map(lambda t: t.detach(), second.opt_state)),
                _flat(T.tree_map(lambda t: t.detach(),
                                 want.opt_state))) <= 1e-6


def test_sigterm_saves_and_exits(tmp_path):
    tr = _torch_trainer(tmp_path, steps=5, ckpt_every=100)
    tr.fault_hook = lambda step: (os.kill(os.getpid(), signal.SIGTERM)
                                  if step == 1 else None)
    hist = tr.run()
    assert tr.step == 2 and tr.telemetry["preempted"]
    assert hist[-2]["event"].startswith("preempted: checkpoint saved at "
                                        "step 2")
    assert TC.latest_step(tmp_path) == 2


def test_trainer_spans_and_refusals(tmp_path):
    tracer = Tracer()
    with tracer_scope(tracer):
        _torch_trainer(tmp_path, steps=1).run()
    names = {s.name for s in tracer.spans}
    assert {"train/step", "train/data", "train/compute",
            "train/checkpoint", "ckpt/save"} <= names
    step = next(s for s in tracer.spans if s.name == "train/step")
    assert step.attrs["finite"] is True
    # int8_ef is ported (test_torch_compression.py); another raises.
    with pytest.raises(ValueError, match="unknown grad_compression"):
        _torch_trainer(tmp_path, grad_compression="int4_ef")
    assert _torch_trainer(tmp_path, grad_compression="int8_ef").ef_state


# -- the launcher ------------------------------------------------------------

def test_train_detection_on_the_reduced_config(tmp_path):
    ap = launch.build_parser()
    args = ap.parse_args(["--arch", "resnet50_dcn_bounded", "--steps", "2",
                          "--global-batch", "2", "--device", "cpu",
                          "--log-every", "1", "--ckpt", str(tmp_path)])
    from repro_torch.configs import resnet50_dcn as configs
    cfg = launch.train_config(configs.get(args.arch), args)
    assert cfg.stage_sizes == (1, 1, 1, 1) and cfg.widths == (32, 64, 128,
                                                               256)
    assert cfg.use_kernel and cfg.offset_bound == 2.0 and cfg.img_size == 64
    from repro.models import registry as reg
    jred = reg.reduced_config(reg.get("resnet50_dcn_bounded"))
    for f in ("stage_sizes", "widths", "stem_width", "num_dcn",
              "num_classes", "img_size", "offset_bound"):
        assert getattr(cfg, f) == getattr(jred, f), f
    tr = launch.train_detection(configs.get(args.arch), args)
    losses = [h["loss"] for h in tr.history if "loss" in h]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert tr.opt.name == "sgd" and TC.latest_step(tmp_path) == 2
    # A second run resumes and goes on to its new last step.
    args.steps = 3
    tr = launch.train_detection(configs.get(args.arch), args)
    assert tr.step == 3 and [h["step"] for h in tr.history
                             if "loss" in h] == [2]
