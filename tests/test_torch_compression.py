"""Port parity: ``repro_torch.distributed.compression`` and the Trainer's
``grad_compression="int8_ef"`` against the JAX package.

Gradient trees are made with numpy from a seed.  ``ef_compress_grads`` is
held bit for bit to JAX's over 3 steps of error feedback (the same fp32
operations: absmax / 127 + 1e-12, a division, round half to even);
``compressed_psum`` to a numpy oracle of its shared-grid formula (exact:
int8 payloads add in int32).  The Trainer with ``int8_ef`` is held to
JAX's within 1e-4 of the largest |param| after 3 steps on a model whose
gradients both compute alike; on the ResNet-DCN, whose gradients differ
in their last bits, by the relative norm (see that test).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as JOPT
from repro.data import DetectionDataConfig as JDataCfg
from repro.data import detection_batch as j_detection_batch
from repro.distributed.compression import ef_compress_grads as j_ef
from repro.distributed.compression import init_ef_state as j_init_ef
from repro.models import resnet_dcn as JR
from repro.train import Trainer as JTrainer
from repro.train import TrainerConfig as JTrainerConfig
from repro_torch import checkpoint as TC
from repro_torch import optim as TOPT
from repro_torch import tree as T
from repro_torch.convert import params_from_jax
from repro_torch.data import DetectionDataConfig, detection_batch
from repro_torch.distributed.compression import (_quantize, compressed_psum,
                                                 ef_compress_grads,
                                                 init_ef_state)
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch
from repro_torch.models import resnet_dcn as TRN
from repro_torch.train import Trainer, TrainerConfig
from repro_torch.train.trainer import checkpoint_bundle

torch.set_num_threads(2)

SMALL = dict(stage_sizes=(1, 1, 1, 1), widths=(16, 32, 64, 128),
             stem_width=8, num_dcn=2, num_classes=4, img_size=32,
             offset_bound=2.0)
DATA = dict(img_size=32, global_batch=2, num_classes=4, seed=3)


def _grad_tree(rng, scale):
    return {"a": {"w": (rng.randn(4, 3) * scale).astype(np.float32),
                  "b": (rng.randn(3) * scale * 1e-3).astype(np.float32)},
            "k": (rng.randn(2, 3, 5) * scale * 50).astype(np.float32),
            "z": np.zeros((3,), np.float32)}


def _to_torch(tree):
    return T.tree_map(lambda a: torch.from_numpy(np.array(a, copy=True)),
                      tree)


def _equal_trees(got, want):
    for (pg, g), (pw, w) in zip(T.leaves_with_paths(got),
                                T.leaves_with_paths(want)):
        assert pg == pw
        assert torch.equal(g, torch.from_numpy(np.asarray(w))), pg


@pytest.mark.parametrize("scale", [1e-3, 1.0, 7e2])
def test_ef_compress_grads_equals_jax_over_three_steps(scale):
    rng = np.random.RandomState(int(scale * 1000) % 997)
    grads = [_grad_tree(rng, scale) for _ in range(3)]
    j_state = j_init_ef(jax.tree_util.tree_map(jnp.asarray, grads[0]))
    t_state = init_ef_state(_to_torch(grads[0]))
    _equal_trees(t_state, jax.tree_util.tree_map(np.asarray, j_state))
    for g in grads:
        jd, j_state = j_ef(jax.tree_util.tree_map(jnp.asarray, g), j_state)
        td, t_state = ef_compress_grads(_to_torch(g), t_state)
        _equal_trees(td, jax.tree_util.tree_map(np.asarray, jd))
        _equal_trees(t_state, jax.tree_util.tree_map(np.asarray, j_state))


def test_quantize_rounds_half_to_even_and_clips():
    x = torch.tensor([127.0, -127.0, 0.5 * 127 / 127, 1.5, 2.5, -0.5])
    q, scale = _quantize(x)
    assert scale.item() == pytest.approx(1.0 + 1e-12)
    assert q.tolist() == [127, -127, 0, 2, 2, 0]
    assert q.dtype == torch.int8


def _psum_oracle(xs):
    xs = [np.asarray(x, np.float32) for x in xs]
    scale = np.float32(max(np.float32(np.abs(x).max()) / np.float32(127.0)
                           + np.float32(1e-12) for x in xs))
    qs = [np.clip(np.round(x / scale), -127, 127).astype(np.int32)
          for x in xs]
    return np.sum(qs, axis=0).astype(np.float32) * scale


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_compressed_psum_matches_the_shared_grid_oracle(shards):
    rng = np.random.RandomState(shards)
    xs = [(rng.randn(6, 5) * (i + 1)).astype(np.float32)
          for i in range(shards)]
    got = compressed_psum([torch.from_numpy(x) for x in xs])
    want = _psum_oracle(xs)
    assert len(got) == shards
    for g in got:
        assert np.array_equal(g.numpy(), want)
    # Shard-symmetric: the order of the shards does not move the sum.
    rev = compressed_psum([torch.from_numpy(x) for x in xs[::-1]])
    assert torch.equal(rev[0], got[0])
    # Within half a grid step a shard of the true sum.
    step = float(np.abs(np.stack(xs)).max()) / 127
    assert np.abs(want - np.sum(xs, 0)).max() <= 0.5 * step * shards + 1e-6


# -- the Trainer ---------------------------------------------------------------

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


def _flat(tree):
    return np.concatenate([np.asarray(x, np.float32).ravel()
                           for x in jax.tree_util.tree_leaves(tree)])


def _torch_trainer(tmp_path, *, steps=3, compression="int8_ef", **kw):
    cfg = TRN.ResNetDCNConfig(**SMALL, use_kernel=True)
    data = DetectionDataConfig(**DATA)
    return Trainer(
        loss_fn=lambda p, b: TRN.train_loss(p, cfg, b, lam=0.1,
                                            device="cpu"),
        params=params_from_jax(_perturbed(), device="cpu"),
        optimizer=TOPT.sgd(TOPT.constant(0.01), momentum=0.9,
                           weight_decay=1e-4),
        batch_fn=lambda s: detection_batch(data, s),
        config=TrainerConfig(total_steps=steps, ckpt_every=1,
                             ckpt_dir=str(tmp_path), log_every=1,
                             grad_compression=compression),
        device="cpu", **kw)


@pytest.fixture(scope="module")
def jax_ef_run(tmp_path_factory):
    cfg = JR.ResNetDCNConfig(**SMALL, use_kernel=True)
    data = JDataCfg(**DATA)
    tr = JTrainer(
        loss_fn=lambda p, b: JR.train_loss(p, cfg, b, lam=0.1),
        params=jax.tree_util.tree_map(jnp.asarray, _perturbed()),
        optimizer=JOPT.sgd(JOPT.constant(0.01), momentum=0.9,
                           weight_decay=1e-4),
        mesh=None, param_specs=None,
        batch_fn=lambda s: j_detection_batch(data, s),
        config=JTrainerConfig(total_steps=3, ckpt_every=100,
                              ckpt_dir=str(tmp_path_factory.mktemp("j")),
                              log_every=1, grad_compression="int8_ef"))
    tr.run()
    return tr


def _linear_batch(step):
    rng = np.random.RandomState(100 + step)
    return {"x": rng.randint(-3, 4, (8, 6)).astype(np.float32),
            "y": rng.randint(-3, 4, (8, 4)).astype(np.float32)}


def _linear_params():
    rng = np.random.RandomState(7)
    return {"lin": {"w": (rng.randint(-8, 9, (6, 4)) / 8).astype(np.float32),
                    "b": (rng.randint(-8, 9, (4,)) / 8).astype(np.float32)}}


def test_int8_ef_trainer_matches_jax(tmp_path):
    """The Trainer's int8_ef step (compression after the sentinel, the ef
    state carried, SGD with momentum) on a least-squares model whose
    gradients both packages compute alike, 3 steps: params within 1e-4 of
    the largest |param| of JAX's Trainer, and the ef state too."""
    def j_loss(p, b):
        r = b["x"] @ p["lin"]["w"] + p["lin"]["b"] - b["y"]
        return jnp.mean(jnp.sum(r * r, -1)), {}

    def t_loss(p, b):
        r = b["x"] @ p["lin"]["w"] + p["lin"]["b"] - b["y"]
        return torch.mean(torch.sum(r * r, -1)), {}

    kw = dict(total_steps=3, ckpt_every=100, log_every=1,
              grad_compression="int8_ef")
    jt = JTrainer(loss_fn=j_loss,
                  params=jax.tree_util.tree_map(jnp.asarray,
                                                _linear_params()),
                  optimizer=JOPT.sgd(JOPT.constant(0.05), momentum=0.9,
                                     weight_decay=1e-4),
                  mesh=None, param_specs=None, batch_fn=_linear_batch,
                  config=JTrainerConfig(ckpt_dir=str(tmp_path / "j"), **kw))
    jt.run()
    tt = Trainer(loss_fn=t_loss, params=_to_torch(_linear_params()),
                 optimizer=TOPT.sgd(TOPT.constant(0.05), momentum=0.9,
                                    weight_decay=1e-4),
                 batch_fn=_linear_batch, device="cpu",
                 config=TrainerConfig(ckpt_dir=str(tmp_path / "t"), **kw))
    tt.run()
    jl = [h["loss"] for h in jt.history if "loss" in h]
    tl = [h["loss"] for h in tt.history if "loss" in h]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    jg = [h["grad_norm"] for h in jt.history if "loss" in h]
    tg = [h["grad_norm"] for h in tt.history if "loss" in h]
    np.testing.assert_allclose(tg, jg, rtol=1e-5)
    jp = _flat(jax.tree_util.tree_map(np.asarray, jt.params))
    tp = _flat(T.tree_map(lambda t: t.detach().numpy(), tt.params))
    assert np.abs(tp - jp).max() <= 1e-4 * np.abs(jp).max()
    je = _flat(jax.tree_util.tree_map(np.asarray, jt.ef_state))
    te = _flat(T.tree_map(lambda t: t.numpy(), tt.ef_state))
    assert np.abs(te).max() > 0
    assert np.abs(te - je).max() <= 1e-4 * np.abs(jp).max()


def test_int8_ef_resnet_dcn_trainer_tracks_jax(tmp_path, jax_ef_run):
    """3 steps of the Eq. 5 objective on the kernel paths with int8_ef.
    The two packages' gradients differ in their last bits (the kernel
    path against JAX's XLA path on this host), and a value that close to
    a rounding boundary lands on the neighbouring int8 step, which moves
    its param by lr x absmax / 127: ~1% of the params differ by such a
    step after 3 steps, so the run is held by its relative norm (reads
    1.0e-3), beside the compression's own effect on it (7e-3 from the
    uncompressed run), and step 0 before any rounding differs."""
    tt = _torch_trainer(tmp_path)
    tt.run()
    jt = jax_ef_run
    jh = [h for h in jt.history if "loss" in h]
    th = [h for h in tt.history if "loss" in h]
    assert len(jh) == len(th) == 3
    assert th[0]["loss"] == pytest.approx(jh[0]["loss"], rel=1e-5)
    # The sentinel reads the uncompressed norm, in both.
    assert th[0]["grad_norm"] == pytest.approx(jh[0]["grad_norm"], rel=1e-4)
    np.testing.assert_allclose([h["loss"] for h in th],
                               [h["loss"] for h in jh], rtol=2e-3)
    jp = _flat(jax.tree_util.tree_map(np.asarray, jt.params))
    tp = _flat(T.tree_map(lambda t: t.detach().numpy(), tt.params))
    rel = np.linalg.norm(tp - jp) / np.linalg.norm(jp)
    plain = _torch_trainer(tmp_path / "plain", compression=None)
    plain.run()
    pp = _flat(T.tree_map(lambda t: t.detach().numpy(), plain.params))
    moved = np.linalg.norm(tp - pp) / np.linalg.norm(pp)
    assert rel <= 2e-3 and moved >= 2.5 * rel, (rel, moved)


def test_non_finite_step_keeps_the_ef_state(tmp_path):
    def poison(step, batch):
        if step == 1:
            batch = dict(batch, images=np.full_like(batch["images"], np.nan))
        return batch
    tt = _torch_trainer(tmp_path, steps=2, batch_hook=poison)
    tt.cfg.total_steps = 1
    tt.run()
    ef1 = T.tree_map(lambda t: t.clone(), tt.ef_state)
    assert any(t.abs().max() > 0 for t in T.leaves(ef1))
    tt.cfg.total_steps = 2
    tt.run()
    assert tt.telemetry["skipped"] == 1
    assert all(torch.equal(a, b) for a, b in zip(T.leaves(tt.ef_state),
                                                 T.leaves(ef1)))


def test_ef_state_is_checkpointed_and_resumed(tmp_path):
    tt = _torch_trainer(tmp_path, steps=2)
    tt.run()
    bundle = TC.restore_checkpoint(tmp_path, tt._bundle())[0]
    assert set(bundle) == {"params", "opt", "ef", "step"}
    assert all(torch.equal(a, b) for a, b in zip(T.leaves(bundle["ef"]),
                                                 T.leaves(tt.ef_state)))
    fresh = _torch_trainer(tmp_path, steps=2)
    assert all(t.abs().max() == 0 for t in T.leaves(fresh.ef_state))
    assert fresh.try_resume() and fresh.step == 2
    assert all(torch.equal(a, b) for a, b in zip(T.leaves(fresh.ef_state),
                                                 T.leaves(tt.ef_state)))
    empty = checkpoint_bundle({"w": torch.zeros(2)}, {}, 0)
    assert empty["ef"] is None


def test_launcher_trains_with_int8_ef_and_serve_restores_it(tmp_path, capsys):
    argv = ["--arch", "resnet50_dcn_bounded", "--steps", "2",
            "--global-batch", "2", "--device", "cpu", "--log-every", "1",
            "--ckpt", str(tmp_path), "--grad-compression", "int8_ef"]
    launch.main(argv)
    out = capsys.readouterr().out
    assert "mesh={'data': 1, 'model': 1}" in out
    assert out.count("'loss'") == 2
    args = launch.build_parser().parse_args(argv)
    assert args.grad_compression == "int8_ef"
    cfg = launch.train_config(
        __import__("repro_torch.configs.resnet50_dcn",
                   fromlist=["get"]).get(args.arch), args)
    like = TRN.init_params(cfg, seed=9, device="cpu")
    restored, step = launch_serve.restore_params(tmp_path, like, args.arch)
    assert step == 2
    saved = TC.restore_checkpoint(tmp_path, checkpoint_bundle(
        like, launch.train_optimizer(args.arch, like, 1).init(like), 0,
        init_ef_state(like)))[0]
    assert any(t.abs().max() > 0 for t in T.leaves(saved["ef"]))
    assert all(torch.equal(a, b) for a, b in
               zip(T.leaves(restored), T.leaves(saved["params"])))


def test_unknown_grad_compression_raises(tmp_path):
    with pytest.raises(ValueError, match="unknown grad_compression"):
        _torch_trainer(tmp_path, compression="int4")
    assert dataclasses.fields(TrainerConfig)
