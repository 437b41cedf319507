"""Port parity: LM training in ``repro_torch`` (``lm_batch``, the chunked
cross entropy, ``transformer.loss_fn`` and its gradient under each
``remat`` mode, the Trainer and the LM branch of ``launch.train``)
against the JAX package.

Inputs come from numpy with a seed; JAX params are converted with
``repro_torch.convert.params_from_jax``.  Tolerances: data arrays bit
for bit; losses 1e-5 relative; gradients 1e-4 relative norm per leaf
(the same math summed in another order, through a backward); remat
modes 1e-6 (the same products recomputed); Trainer loss histories 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as JOPT
from repro.data import LMDataConfig as JLMDataConfig
from repro.data import lm_batch as j_lm_batch
from repro.models import layers as JL
from repro.models import registry as JReg
from repro.models import transformer as JT
from repro.train import Trainer as JTrainer
from repro.train import TrainerConfig as JTrainerConfig
from repro_torch import checkpoint as TC
from repro_torch import optim as TOPT
from repro_torch import tree as T
from repro_torch.convert import params_from_jax
from repro_torch.data import LMDataConfig, lm_batch
from repro_torch.launch import train as launch
from repro_torch.models import layers as TL
from repro_torch.models import registry as TReg
from repro_torch.models import transformer as TT
from repro_torch.train import Trainer, TrainerConfig

torch.set_num_threads(2)

ARCHS = ["tinyllama-1.1b", "deepseek-7b", "glm4-9b", "recurrentgemma-9b"]


def _perturbed(tree, seed):
    """A numpy copy of a JAX param tree whose zero-init leaves (norm
    scales, biases) are random, so the test sees them."""
    rng = np.random.RandomState(seed)

    def go(node):
        if isinstance(node, dict):
            return {k: go(node[k]) for k in sorted(node)}
        a = np.array(node)
        if not a.any():
            a = (rng.randn(*a.shape) * 0.1).astype(a.dtype)
        return a
    return go(tree)


def _configs(name):
    return (JReg.reduced_config(JReg.get(name)),
            TReg.reduced_config(TReg.get(name)))


def _params(jcfg, seed=0):
    tree = _perturbed(JT.init_params(jax.random.PRNGKey(seed), jcfg), seed)
    return jax.tree_util.tree_map(jnp.asarray, tree), \
        params_from_jax(tree, device="cpu")


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _grads(params, fn):
    """(value, grads as a list in flatten order) of ``fn(params)``."""
    leaves = [t.detach().requires_grad_(True) for t in T.leaves(params)]
    tree = T.from_paths(list(zip(
        [p for p, _ in T.leaves_with_paths(params)], leaves)))
    value = fn(tree)
    if isinstance(value, tuple):
        loss, aux = value
        value = (loss.detach(), {k: v.detach() for k, v in aux.items()})
    else:
        loss = value
        value = value.detach()
    return value, [g.detach() for g in torch.autograd.grad(loss, leaves)]


def _batch(vocab, b, s, seed, mask=False):
    rng = np.random.RandomState(seed)
    out = {"tokens": rng.randint(0, vocab, (b, s)).astype(np.int32),
           "targets": rng.randint(0, vocab, (b, s)).astype(np.int32)}
    if mask:
        out["mask"] = (rng.rand(b, s) < 0.7).astype(np.float32)
    return out


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("codebooks", [1, 4])
@pytest.mark.parametrize("step", [0, 1, 7])
def test_lm_batch_equals_jax(codebooks, step):
    kw = dict(vocab=97, seq_len=24, global_batch=6, codebooks=codebooks,
              seed=3)
    want = j_lm_batch(JLMDataConfig(**kw), step, host_id=1, num_hosts=2)
    got = lm_batch(LMDataConfig(**kw), step, host_id=1, num_hosts=2)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])
    shape = (3, 24) if codebooks == 1 else (3, 24, 4)
    assert got["tokens"].shape == shape
    with pytest.raises(ValueError, match="split"):
        lm_batch(LMDataConfig(**kw), step, num_hosts=4)


# ---------------------------------------------------------------------------
# The chunked cross entropy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [7, 16, 33])
@pytest.mark.parametrize("tied", [True, False])
@pytest.mark.parametrize("masked,softcap", [(False, None), (True, 5.0)])
def test_chunked_cross_entropy_matches_jax(s, tied, masked, softcap):
    rng = np.random.RandomState(s + 2 * tied)
    b, d, v = 2, 12, 40
    x = rng.randn(b, s, d).astype(np.float32)
    w = (rng.randn(*((v, d) if tied else (d, v))) * 0.5).astype(np.float32)
    batch = _batch(v, b, s, seed=s, mask=masked)
    mask = batch.get("mask")
    kw = dict(tied=tied, logit_scale=0.7, softcap=softcap, chunk=8)

    def jfn(x, w):
        return JL.chunked_cross_entropy(
            x, w, jnp.asarray(batch["targets"]),
            None if mask is None else jnp.asarray(mask), **kw)
    want, (jgx, jgw) = jax.value_and_grad(jfn, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))

    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    got = TL.chunked_cross_entropy(
        tx, tw, torch.from_numpy(batch["targets"]),
        None if mask is None else torch.from_numpy(mask), **kw)
    gx, gw = torch.autograd.grad(got, (tx, tw))
    got = got.detach()
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))
    assert _rel(gx, jgx) <= 1e-5 and _rel(gw, jgw) <= 1e-5

    # The dense CE of the full logits, in both packages.
    logits = TL._softcap((tx.detach() @ (tw.detach().T if tied
                                         else tw.detach())) * 0.7, softcap)
    dense = TL.cross_entropy(logits, torch.from_numpy(batch["targets"]),
                             None if mask is None
                             else torch.from_numpy(mask))
    jdense = JL.cross_entropy(jnp.asarray(logits.numpy()),
                              jnp.asarray(batch["targets"]),
                              None if mask is None else jnp.asarray(mask))
    assert abs(float(dense) - float(got)) <= 1e-5 * abs(float(got))
    assert abs(float(dense) - float(jdense)) <= 1e-5 * abs(float(jdense))


def test_chunked_cross_entropy_recomputes_its_blocks():
    """Autograd keeps no (B, chunk, V) block: the saved tensors of a
    chunked CE are its inputs, of a dense one the logits too."""
    x = torch.randn(2, 32, 4, requires_grad=True)
    w = torch.randn(64, 4, requires_grad=True)
    t = torch.randint(0, 64, (2, 32))
    sizes = []

    def pack(tensor):
        sizes.append(tensor.numel())
        return tensor
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        TL.chunked_cross_entropy(x, w, t, tied=True, chunk=8)
    assert max(sizes) < 2 * 8 * 64
    sizes.clear()
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        TL.cross_entropy(x @ w.T, t)
    assert max(sizes) >= 2 * 32 * 64


# ---------------------------------------------------------------------------
# loss_fn and its gradient, remat
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ARCHS)
def test_loss_fn_and_gradient_match_jax(name):
    jcfg, tcfg = _configs(name)
    jp, tp = _params(jcfg, seed=1)
    batch = _batch(jcfg.vocab, 2, 19, seed=4, mask=True)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, jaux), jg = jax.value_and_grad(
        lambda p: JT.loss_fn(p, jcfg, jb), has_aux=True)(jp)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    (tloss, taux), tg = _grads(tp, lambda p: TT.loss_fn(p, tcfg, tb))
    assert abs(float(tloss) - float(jloss)) <= 1e-5 * float(jloss)
    assert abs(float(taux["ce"]) - float(jaux["ce"])) <= 1e-5 * float(
        jaux["ce"])
    assert float(taux["moe_aux"]) == float(jaux["moe_aux"]) == 0.0
    jleaves = jax.tree_util.tree_leaves_with_path(jg)
    assert len(jleaves) == len(tg)
    for (path, jleaf), g in zip(jleaves, tg):
        assert _rel(g, jleaf) <= 1e-4, jax.tree_util.keystr(path)


@pytest.mark.parametrize("name", ["tinyllama-1.1b", "recurrentgemma-9b"])
def test_remat_modes_give_equal_gradients(name):
    _, tcfg = _configs(name)
    _, tp = _params(JReg.reduced_config(JReg.get(name)), seed=2)
    tb = {k: torch.from_numpy(v)
          for k, v in _batch(tcfg.vocab, 2, 21, seed=5).items()}
    out = {}
    for remat in ("none", "full", "dots"):
        cfg = dataclasses.replace(tcfg, remat=remat)
        out[remat] = _grads(tp, lambda p: TT.loss_fn(p, cfg, tb))
    (loss0, _), g0 = out["none"]
    for remat in ("full", "dots"):
        (loss, _), g = out[remat]
        assert abs(float(loss) - float(loss0)) <= 1e-6 * float(loss0)
        assert max(_rel(a, b) for a, b in zip(g, g0)) <= 1e-6, remat
    with pytest.raises(ValueError, match="remat"):
        TT.loss_fn(tp, dataclasses.replace(tcfg, remat="some"), tb)


def test_remat_recomputes_what_its_mode_says():
    """Weight products (``mm``) run in the forward and backward of one
    loss: 'full' recomputes them in the backward, 'dots' keeps them as
    'none' does, and both checkpointed modes re-run every period's layers
    once more."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten.mm.default:
                self.mm += 1
            return func(*args, **(kwargs or {}))

    _, tcfg = _configs("tinyllama-1.1b")
    _, tp = _params(JReg.reduced_config(JReg.get("tinyllama-1.1b")))
    tb = {k: torch.from_numpy(v)
          for k, v in _batch(tcfg.vocab, 2, 16, seed=6).items()}
    mm, layers = {}, {}
    real = TT._LAYER_APPLY["attn"]

    def counted(*a, **kw):
        layers[remat] += 1
        return real(*a, **kw)
    for remat in ("none", "dots", "full"):
        layers[remat] = 0
        with Count() as count:
            count.mm = 0
            TT._LAYER_APPLY["attn"] = counted
            try:
                _grads(tp, lambda p: TT.loss_fn(
                    p, dataclasses.replace(tcfg, remat=remat), tb))
            finally:
                TT._LAYER_APPLY["attn"] = real
        mm[remat] = count.mm
    assert mm["none"] == mm["dots"] < mm["full"], mm
    n = tcfg.n_layers
    assert layers == {"none": n, "dots": 2 * n, "full": 2 * n}, layers


def test_forward_returns_the_final_normed_hidden_state():
    jcfg, tcfg = _configs("glm4-9b")
    jp, tp = _params(jcfg, seed=3)
    toks = np.random.RandomState(9).randint(0, jcfg.vocab, (2, 10))
    want, _, _ = JT.forward(jp, jcfg, tokens=jnp.asarray(toks),
                            return_hidden=True)
    got, caches, _ = TT.forward(tp, tcfg, tokens=torch.as_tensor(toks),
                                return_hidden=True)
    assert got.shape == (2, 10, tcfg.d_model) and caches is None
    assert _rel(got.detach(), want) <= 1e-5
    logits, _, _ = TT.forward(tp, tcfg, tokens=torch.as_tensor(toks))
    assert _rel(TT._logits(tp, tcfg, got).detach(), logits.detach()) == 0


def test_unknown_layer_kind_raises_value_error():
    """A pattern of a mixer kind neither package knows raises ValueError
    naming it, in the params' and in the caches' definitions, as JAX's
    ``_layer_def`` does."""
    jcfg, tcfg = _configs("tinyllama-1.1b")
    jbad = dataclasses.replace(jcfg, pattern=("attn", "mamba"))
    tbad = dataclasses.replace(tcfg, pattern=("attn", "mamba"))
    with pytest.raises(ValueError, match="mamba"):
        JT.model_def(jbad)
    with pytest.raises(ValueError, match="mamba"):
        TT.model_def(tbad)
    with pytest.raises(ValueError, match="mamba"):
        TT.init_params(tbad, device="cpu")
    with pytest.raises(ValueError, match="mamba"):
        TT.init_cache(tbad, 1, 8, device="cpu")


# ---------------------------------------------------------------------------
# The Trainer on an LM, as JAX's system tests run it
# ---------------------------------------------------------------------------

def _small_cfg():
    return TT.ModelConfig(name="t", n_layers=2, d_model=32, n_heads=4,
                          kv_heads=2, d_ff=64, vocab=32,
                          dtype=torch.float32)


def _trainer(tmp, dcfg, *, steps, micro=1, seed=0):
    cfg = _small_cfg()
    return Trainer(
        loss_fn=lambda p, b: TT.loss_fn(p, cfg, b),
        params=TT.init_params(cfg, seed=seed, device="cpu"),
        optimizer=TOPT.adamw(TOPT.constant(3e-3)),
        batch_fn=lambda s: lm_batch(dcfg, s),
        config=TrainerConfig(total_steps=steps, ckpt_every=5, ckpt_dir=tmp,
                             log_every=5, microbatches=micro),
        device="cpu")


def _flat(tree):
    return np.concatenate([t.detach().numpy().ravel()
                           for t in T.leaves(tree)])


def test_training_converges(tmp_path):
    dcfg = LMDataConfig(vocab=32, seq_len=32, global_batch=8, seed=1)
    tr = _trainer(str(tmp_path), dcfg, steps=30)
    losses = [h["loss"] for h in tr.run() if "loss" in h]
    assert losses[-1] < losses[0] * 0.9, losses


def test_resume_is_exact(tmp_path):
    """20 straight steps == (10 steps, checkpoint, restore, 10 steps)."""
    dcfg = LMDataConfig(vocab=32, seq_len=16, global_batch=4, seed=7)
    a = _trainer(str(tmp_path / "a"), dcfg, steps=20)
    a.run()
    _trainer(str(tmp_path / "b"), dcfg, steps=10).run()
    b = _trainer(str(tmp_path / "b"), dcfg, steps=20, seed=123)
    assert b.try_resume() and b.step == 10
    b.run()
    np.testing.assert_allclose(_flat(b.params), _flat(a.params), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(_flat(b.opt_state), _flat(a.opt_state),
                               rtol=1e-6, atol=1e-6)


def test_grad_accumulation_matches_large_batch(tmp_path):
    """microbatches=2 over batch 8 ~= batch 8 (same data): JAX's bound on
    the last loss, and the first step's loss is the same mean."""
    dcfg = LMDataConfig(vocab=32, seq_len=16, global_batch=8, seed=5)
    one = _trainer(str(tmp_path / "m1"), dcfg, steps=6)
    two = _trainer(str(tmp_path / "m2"), dcfg, steps=6, micro=2)
    one.run()
    two.run()
    assert abs(one.last_loss - two.last_loss) < 0.35
    assert abs(one.history[0]["loss"] - two.history[0]["loss"]) <= 1e-5


def _launch_args(tmp_path, *extra):
    return launch.build_parser().parse_args(
        ["--arch", "tinyllama-1.1b", "--device", "cpu", "--ckpt",
         str(tmp_path), "--log-every", "1", "--global-batch", "4",
         "--seq-len", "16", *extra])


def test_train_lm_matches_jax_trainer(tmp_path):
    """Five steps of the launcher's LM branch (reduced tinyllama-1.1b,
    AdamW under the warm-up cosine) against JAX's Trainer with the same
    optimizer, data and params."""
    jcfg, _ = _configs("tinyllama-1.1b")
    tree = _perturbed(JT.init_params(jax.random.PRNGKey(0), jcfg), 0)
    args = _launch_args(tmp_path / "torch", "--steps", "5")
    data = JLMDataConfig(vocab=jcfg.vocab, seq_len=16, global_batch=4)
    jt = JTrainer(
        loss_fn=lambda p, b: JT.loss_fn(p, jcfg, b),
        params=jax.tree_util.tree_map(jnp.asarray, tree),
        optimizer=JOPT.default_optimizer_for(
            args.arch, jcfg.param_count(), JOPT.warmup_cosine(3e-3, 10, 5)),
        mesh=None, param_specs=None,
        batch_fn=lambda s: j_lm_batch(data, s),
        config=JTrainerConfig(total_steps=5, ckpt_every=100,
                              ckpt_dir=str(tmp_path / "jax"), log_every=1))
    jt.run()
    tt = launch.train_lm(TReg.get(args.arch).config, args,
                         params=params_from_jax(tree, device="cpu"))
    assert tt.opt.name == "adamw"
    jl = [h["loss"] for h in jt.history if "loss" in h]
    tl = [h["loss"] for h in tt.history if "loss" in h]
    assert len(tl) == len(jl) == 5
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    want = np.concatenate([np.asarray(a).ravel() for a in
                           jax.tree_util.tree_leaves(jt.params)])
    assert _rel(_flat(tt.params), want) <= 1e-4


def test_lm_launcher_trains_and_resumes_on_the_cpu(tmp_path, capsys):
    launch.main(["--arch", "tinyllama-1.1b", "--device", "cpu", "--steps",
                 "4", "--ckpt", str(tmp_path), "--log-every", "1"])
    out = capsys.readouterr().out
    assert "tinyllama-1.1b (reduced)" in out and "resumed" not in out
    assert out.count("'loss'") == 4 and TC.latest_step(tmp_path) == 4
    launch.main(["--arch", "tinyllama-1.1b", "--device", "cpu", "--steps",
                 "6", "--ckpt", str(tmp_path), "--log-every", "1"])
    out = capsys.readouterr().out
    assert "resumed from step 4" in out and out.count("'loss'") == 2
    args = _launch_args(tmp_path / "rg", "--arch", "recurrentgemma-9b",
                        "--steps", "2")
    tr = launch.train_lm(TReg.get(args.arch).config, args)
    assert tr.params["layers"]["m0"]["rec"]["w_a"].shape == (2, 64, 64)
    losses = [h["loss"] for h in tr.history if "loss" in h]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert tr.telemetry["skipped"] == 0
