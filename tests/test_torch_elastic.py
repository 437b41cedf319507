"""Elastic restart in the port (counterpart of ``tests/test_elastic.py``
and ``examples/elastic_restart.py``): a small LM trains on a (data=2,
model=2) mesh and checkpoints; a new Trainer on a (data=4, model=2) mesh
resumes from that checkpoint, its params and optimizer state laid out on
the new mesh (``Trainer.try_resume``: ``CheckpointManager.restore`` with
the bundle's shardings), and trains on.  The result is held against a
straight run on (4, 2) at JAX's own oracle (rtol 5e-4, atol 5e-5: the
first steps ran on another mesh, so partial sums met in another order).
The checkpoint carries no mesh, so a flat Trainer restores it too.

The meshes repeat the CPU in one process (JAX's example needs a process
a device count; the port's single-controller mesh does not).
"""
import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.data import LMDataConfig, lm_batch
from repro_torch.distributed import sharding as TS
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.optim import adamw, constant
from repro_torch.train import Trainer, TrainerConfig

torch.set_num_threads(2)

CFG = TT.ModelConfig(name="elastic", n_layers=2, d_model=32, n_heads=4,
                     kv_heads=2, d_ff=64, vocab=32, dtype=torch.float32)
DATA = LMDataConfig(vocab=32, seq_len=32, global_batch=8, seed=11)


def _mesh(shape):
    devs = np.empty(shape, dtype=object)
    devs[...] = torch.device("cpu")
    return TS.Mesh(devs, ("data", "model"))


def _build(ckpt, mesh, total_steps=20):
    specs = None
    if mesh is not None:
        with TS.use_rules(mesh=mesh):
            specs = TL.spec_tree(TT.param_defs(CFG))
    return Trainer(
        loss_fn=lambda p, b: TT.loss_fn(p, CFG, b),
        params=TT.init_params(CFG, seed=0, device="cpu"),
        optimizer=adamw(constant(3e-3)),
        batch_fn=lambda s: lm_batch(DATA, s),
        config=TrainerConfig(total_steps=total_steps, ckpt_every=10,
                             ckpt_dir=str(ckpt), log_every=5),
        device="cpu" if mesh is None else None, mesh=mesh,
        param_specs=specs)


def _whole(tree):
    return [t.detach() for t in T.leaves(TS.gather_tree(tree))]


def test_checkpoint_on_2x2_resumes_on_4x2_like_a_straight_run(tmp_path):
    first = _build(tmp_path / "elastic", _mesh((2, 2)), total_steps=10)
    first.run()
    assert first.step == 10 and first.ckpt.latest_step() == 10
    wq = first.params["layers"]["m0"]["attn"]["wq"]
    assert wq.grid == (1, 2, 2, 1)

    resumed = _build(tmp_path / "elastic", _mesh((4, 2)))
    assert resumed.try_resume() and resumed.step == 10
    wq = resumed.params["layers"]["m0"]["attn"]["wq"]
    m = resumed.opt_state["m"]["layers"]["m0"]["attn"]["wq"]
    assert wq.grid == m.grid == (1, 4, 2, 1)
    for got, want in zip(_whole(resumed.params), _whole(first.params)):
        assert torch.equal(got, want)
    resumed.run()
    assert resumed.step == 20

    straight = _build(tmp_path / "straight", _mesh((4, 2)))
    straight.run()
    for got, want in zip(_whole(resumed.params), _whole(straight.params)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=5e-4,
                                   atol=5e-5)
    for got, want in zip(_whole(resumed.opt_state),
                         _whole(straight.opt_state)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=5e-4,
                                   atol=5e-5)


def test_a_sharded_checkpoint_restores_into_a_flat_trainer(tmp_path):
    sharded = _build(tmp_path, _mesh((2, 2)), total_steps=10)
    sharded.run()
    flat = _build(tmp_path, None)
    assert flat.try_resume() and flat.step == 10
    assert not any(TS.is_placed(x) for x in T.leaves(
        flat.params, is_leaf=TS.is_placed))
    for got, want in zip(_whole(flat.params), _whole(sharded.params)):
        assert torch.equal(got, want)
    for got, want in zip(_whole(flat.opt_state), _whole(sharded.opt_state)):
        assert torch.equal(got, want)
    # and back onto a third mesh, laid out by the shardings given
    mesh = _mesh((1, 4))
    with TS.use_rules(mesh=mesh):
        specs = TL.spec_tree(TT.param_defs(CFG))
    restored, step = flat.ckpt.restore(
        flat._bundle(), step=10,
        shardings={"params": TS.shardings_of(specs, mesh)})
    assert step == 10
    emb = restored["params"]["embed"]["embedding"]
    assert TS.is_placed(emb) and emb.grid == (4, 1)
    for got, want in zip(_whole(restored["params"]),
                         _whole(sharded.params)):
        assert torch.equal(got, want)
