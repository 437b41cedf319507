"""Port parity: multi-codebook heads (musicgen-medium) and prepended
frontend embeddings (pixtral-12b) in ``repro_torch.models.transformer``,
their registry entries, the LM launchers' handling of them, against the
JAX package.

Inputs come from numpy with a seed; JAX params are converted with
``repro_torch.convert.params_from_jax``.  Tolerances: fp32 1e-5 relative
to the largest value (logits, caches, losses); gradients 1e-4 per leaf
(relative norm); Trainer loss histories 1e-4.
"""
import ast
import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as JOPT
from repro.data import LMDataConfig as JLMDataConfig
from repro.data import lm_batch as j_lm_batch
from repro.launch import serve as j_serve_launch
from repro.models import registry as JReg
from repro.models import transformer as JT
from repro.train import Trainer as JTrainer
from repro.train import TrainerConfig as JTrainerConfig
from repro_torch import tree as T
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as serve_launch
from repro_torch.launch import train as train_launch
from repro_torch.models import layers as TL
from repro_torch.models import registry as TReg
from repro_torch.models import transformer as TT

torch.set_num_threads(2)

RTOL = 1e-5
MUSIC, PIXTRAL = "musicgen-medium", "pixtral-12b"


def _close(got, want, rtol=RTOL):
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                     else got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got / scale, want / scale, rtol=rtol,
                               atol=rtol)


def _rel(got, want):
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                     else got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _perturbed(tree, seed):
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


def _grads(params, fn):
    """((loss, metrics) detached, grads as a list in flatten order)."""
    leaves = [t.detach().requires_grad_(True) for t in T.leaves(params)]
    tree = T.from_paths(list(zip(
        [p for p, _ in T.leaves_with_paths(params)], leaves)))
    loss, aux = fn(tree)
    grads = torch.autograd.grad(loss, leaves)
    return (loss.detach(), {k: v.detach() for k, v in aux.items()}), \
        [g.detach() for g in grads]


def _frontend(b, p, d, seed):
    return np.random.RandomState(seed).randn(b, p, d).astype(np.float32)


# ---------------------------------------------------------------------------
# musicgen-medium: (B, S, CB) tokens, (CB, V, D) embedding, (CB, D, V) heads
# ---------------------------------------------------------------------------

def test_codebook_model_matches_jax():
    """forward logits (B, S, CB, V); prefill and 5 decode steps with
    (B, CB) tokens returning (B, CB, V), each against JAX and against the
    teacher-forced forward."""
    jcfg, tcfg = _configs(MUSIC)
    assert tcfg.codebooks == 4
    jdefs, tdefs = JT.model_def(jcfg), TT.model_def(tcfg)
    assert tdefs.keys() == jdefs.keys() and "unembed" not in tdefs
    assert tdefs["embed"]["embedding"].shape == (4, 128, 64)
    assert tdefs["heads"]["unembedding"].shape == (4, 64, 128)
    assert tdefs["embed"]["embedding"].scale \
        == jdefs["embed"]["embedding"].scale == 0.02
    jp, tp = _params(jcfg)
    toks = np.random.RandomState(6).randint(0, jcfg.vocab, (2, 16, 4))
    want, _, _ = JT.forward(jp, jcfg, tokens=jnp.asarray(toks))
    full, caches, _ = TT.forward(tp, tcfg, tokens=torch.as_tensor(toks))
    assert full.shape == (2, 16, 4, 128) and caches is None
    _close(full, want)

    jl, jc = JT.prefill(jp, jcfg, jnp.asarray(toks[:, :11]), cache_len=24)
    tl, tc = TT.prefill(tp, tcfg, torch.as_tensor(toks[:, :11]),
                        cache_len=24)
    assert tl.shape == (2, 4, 128)
    _close(tl, jl)
    _close(tl, full[:, 10].numpy())
    for key in ("k", "v"):
        _close(tc["layers"]["m0"][key], jc["layers"]["m0"][key])
    for i in range(11, 16):
        pos = np.array([i, i])
        jl, jc = JT.decode_step(jp, jcfg, jnp.asarray(toks[:, i]), jc,
                                jnp.asarray(pos, jnp.int32))
        tl, tc = TT.decode_step(tp, tcfg, torch.as_tensor(toks[:, i]), tc,
                                torch.as_tensor(pos))
        assert tl.shape == (2, 4, 128)
        _close(tl, jl)
        _close(tl, full[:, i].numpy())


def test_codebook_embeddings_sum_in_order():
    """The embedding sums each codebook's row in order 0..CB-1 (bf16 sums
    round as JAX's do), before the embedding scale."""
    _, tcfg = _configs(MUSIC)
    cfg = dataclasses.replace(tcfg, dtype=torch.bfloat16, embed_scale=True)
    tp = TT.init_params(cfg, device="cpu")
    toks = torch.randint(0, 128, (2, 5, 4),
                         generator=torch.Generator().manual_seed(0))
    emb = tp["embed"]["embedding"]
    want = emb[0][toks[..., 0]].to(torch.bfloat16)
    for i in range(1, 4):
        want = want + emb[i][toks[..., i]].to(torch.bfloat16)
    want = want * torch.tensor(8.0, dtype=torch.bfloat16)
    assert torch.equal(TT._embed(tp, cfg, toks, None), want)


def test_codebook_loss_fn_and_gradient_match_jax():
    jcfg, tcfg = _configs(MUSIC)
    jp, tp = _params(jcfg, seed=1)
    rng = np.random.RandomState(4)
    batch = {"tokens": rng.randint(0, 128, (2, 19, 4)).astype(np.int32),
             "targets": rng.randint(0, 128, (2, 19, 4)).astype(np.int32),
             "mask": (rng.rand(2, 19) < 0.7).astype(np.float32)}
    (jloss, jaux), jg = jax.value_and_grad(
        lambda p: JT.loss_fn(p, jcfg, {k: jnp.asarray(v)
                                       for k, v in batch.items()}),
        has_aux=True)(jp)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    (tloss, taux), tg = _grads(tp, lambda p: TT.loss_fn(p, tcfg, tb))
    assert abs(float(tloss) - float(jloss)) <= RTOL * float(jloss)
    # the mean of the per-codebook chunked CE of the hidden state
    hidden, _, _ = TT.forward(tp, tcfg, tokens=tb["tokens"],
                              return_hidden=True)
    w = tp["heads"]["unembedding"]
    per = [float(TL.chunked_cross_entropy(hidden, w[i], tb["targets"][..., i],
                                          tb["mask"], tied=False))
           for i in range(4)]
    assert float(taux["ce"]) == pytest.approx(sum(per) / 4, rel=1e-6)
    jleaves = jax.tree_util.tree_leaves_with_path(jg)
    assert len(jleaves) == len(tg)
    for (path, jleaf), g in zip(jleaves, tg):
        assert _rel(g, jleaf) <= 1e-4, jax.tree_util.keystr(path)


def test_serve_lm_refuses_codebooks_as_the_jax_launcher_does():
    args = serve_launch.build_parser().parse_args(
        ["--arch", MUSIC, "--device", "cpu", "--reduced"])
    cfg = TReg.reduced_config(TReg.get(MUSIC))
    with pytest.raises(SystemExit) as err:
        serve_launch.serve_lm(cfg, args)
    msg = str(err.value)
    assert msg.startswith("the slot engine tracks one token per slot")
    # the JAX launcher's message, word for word
    tree = ast.parse(inspect.getsource(j_serve_launch.main))
    said = [node.exc.args[0].value for node in ast.walk(tree)
            if isinstance(node, ast.Raise) and isinstance(node.exc, ast.Call)
            and getattr(node.exc.func, "id", None) == "SystemExit"]
    assert said == [msg]


def test_train_lm_on_codebooks_matches_jax_trainer(tmp_path):
    """Three steps of the launcher's LM branch on the reduced
    musicgen-medium ((B, S, 4) ``lm_batch`` data) against JAX's Trainer
    with the same optimizer, data and params; the losses finite and none
    skipped."""
    jcfg, _ = _configs(MUSIC)
    tree = _perturbed(JT.init_params(jax.random.PRNGKey(0), jcfg), 0)
    args = train_launch.build_parser().parse_args(
        ["--arch", MUSIC, "--device", "cpu", "--ckpt",
         str(tmp_path / "torch"), "--log-every", "1", "--global-batch", "4",
         "--seq-len", "16", "--steps", "3"])
    data = JLMDataConfig(vocab=jcfg.vocab, seq_len=16, global_batch=4,
                         codebooks=4)
    jt = JTrainer(
        loss_fn=lambda p, b: JT.loss_fn(p, jcfg, b),
        params=jax.tree_util.tree_map(jnp.asarray, tree),
        optimizer=JOPT.default_optimizer_for(
            MUSIC, jcfg.param_count(), JOPT.warmup_cosine(3e-3, 10, 3)),
        mesh=None, param_specs=None,
        batch_fn=lambda s: j_lm_batch(data, s),
        config=JTrainerConfig(total_steps=3, ckpt_every=100,
                              ckpt_dir=str(tmp_path / "jax"), log_every=1))
    jt.run()
    tt = train_launch.train_lm(TReg.get(MUSIC).config, args,
                               params=params_from_jax(tree, device="cpu"))
    jl = [h["loss"] for h in jt.history if "loss" in h]
    tl = [h["loss"] for h in tt.history if "loss" in h]
    assert len(tl) == 3 and np.isfinite(tl).all()
    assert tt.telemetry["skipped"] == 0
    np.testing.assert_allclose(tl, jl, rtol=1e-4)


# ---------------------------------------------------------------------------
# pixtral-12b: (B, P, D) frontend embeddings before the tokens
# ---------------------------------------------------------------------------

def test_frontend_model_matches_jax():
    """forward with a (B, 5, D) frontend (logits at every position, the
    frontend's included); prefill with the frontend (caches hold P + S
    positions) and 4 decode steps at positions after both, against JAX
    and against the teacher-forced forward."""
    jcfg, tcfg = _configs(PIXTRAL)
    assert tcfg.frontend_embeds
    jp, tp = _params(jcfg)
    fe = _frontend(2, 5, 64, seed=1)
    toks = np.random.RandomState(6).randint(0, jcfg.vocab, (2, 15))
    want, _, _ = JT.forward(jp, jcfg, tokens=jnp.asarray(toks),
                            frontend=jnp.asarray(fe))
    full, _, _ = TT.forward(tp, tcfg, tokens=torch.as_tensor(toks),
                            frontend=torch.from_numpy(fe))
    assert full.shape == (2, 20, 128)
    _close(full, want)

    jl, jc = JT.prefill(jp, jcfg, jnp.asarray(toks[:, :11]), cache_len=24,
                        frontend=jnp.asarray(fe))
    tl, tc = TT.prefill(tp, tcfg, torch.as_tensor(toks[:, :11]),
                        cache_len=24, frontend=torch.from_numpy(fe))
    _close(tl, jl)
    _close(tl, full[:, 15].numpy())
    for key in ("k", "v"):
        _close(tc["layers"]["m0"][key], jc["layers"]["m0"][key])
    assert not tc["layers"]["m0"]["k"][:, :, 16:].any()
    for i in range(11, 15):
        pos = np.array([5 + i, 5 + i])
        jl, jc = JT.decode_step(jp, jcfg, jnp.asarray(toks[:, i]), jc,
                                jnp.asarray(pos, jnp.int32))
        tl, tc = TT.decode_step(tp, tcfg, torch.as_tensor(toks[:, i]), tc,
                                torch.as_tensor(pos))
        _close(tl, jl)
        _close(tl, full[:, 5 + i].numpy())


def test_frontend_loss_fn_and_gradient_match_jax():
    """The loss counts the text positions only: it equals the chunked CE
    of the hidden state sliced after the frontend; gradients reach the
    frontend's path as JAX's do."""
    jcfg, tcfg = _configs(PIXTRAL)
    jp, tp = _params(jcfg, seed=2)
    rng = np.random.RandomState(5)
    batch = {"tokens": rng.randint(0, 128, (2, 13)).astype(np.int32),
             "targets": rng.randint(0, 128, (2, 13)).astype(np.int32),
             "frontend": _frontend(2, 6, 64, seed=3)}
    (jloss, _), jg = jax.value_and_grad(
        lambda p: JT.loss_fn(p, jcfg, {k: jnp.asarray(v)
                                       for k, v in batch.items()}),
        has_aux=True)(jp)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    (tloss, taux), tg = _grads(tp, lambda p: TT.loss_fn(p, tcfg, tb))
    assert abs(float(tloss) - float(jloss)) <= RTOL * float(jloss)
    hidden, _, _ = TT.forward(tp, tcfg, tokens=tb["tokens"],
                              frontend=tb["frontend"], return_hidden=True)
    assert hidden.shape == (2, 19, 64)
    text = TL.chunked_cross_entropy(hidden[:, 6:], tp["unembed"]["unembedding"],
                                    tb["targets"], tied=False)
    assert float(taux["ce"]) == float(text) == float(tloss)
    jleaves = jax.tree_util.tree_leaves_with_path(jg)
    assert len(jleaves) == len(tg)
    for (path, jleaf), g in zip(jleaves, tg):
        assert _rel(g, jleaf) <= 1e-4, jax.tree_util.keystr(path)


def test_train_lm_feeds_pixtral_text_only(tmp_path):
    """As the JAX launcher does, ``train_lm`` trains the VLM backbone on
    token batches without a frontend."""
    args = train_launch.build_parser().parse_args(
        ["--arch", PIXTRAL, "--device", "cpu", "--ckpt", str(tmp_path),
         "--log-every", "1", "--global-batch", "2", "--seq-len", "16",
         "--steps", "2"])
    tr = train_launch.train_lm(TReg.get(PIXTRAL).config, args)
    losses = [h["loss"] for h in tr.history if "loss" in h]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert tr.telemetry["skipped"] == 0


# ---------------------------------------------------------------------------
# The registry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [MUSIC, PIXTRAL])
def test_full_config_matches_the_jax_registry(name):
    jspec, tspec = JReg.get(name), TReg.get(name)
    jcfg, tcfg = jspec.config, tspec.config
    assert tcfg.param_count() == jcfg.param_count()
    for f in ("n_layers", "d_model", "n_heads", "kv_heads", "d_ff", "vocab",
              "hd", "norm", "act", "mlp_bias", "rope_theta",
              "tie_embeddings", "codebooks", "frontend_embeds", "remat"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    assert tspec.family == jspec.family and tspec.source == jspec.source
    jred, tred = JReg.reduced_config(jspec), TReg.reduced_config(tspec)
    assert tred.param_count() == jred.param_count()
    assert (tred.codebooks, tred.frontend_embeds) \
        == (jred.codebooks, jred.frontend_embeds)
