"""Port parity: the MoE family of ``repro_torch`` (``models/moe.py``, MoE
layers in ``models/transformer.py`` with their load-balancing loss,
dbrx-132b and grok-1-314b in the registry, the Trainer and the serving
engine) against the JAX package.

Inputs come from numpy with a seed; JAX params are converted with
``repro_torch.convert.params_from_jax``.  Tolerances: fp32 1e-5 relative
to the largest value (outputs, logits, aux losses, losses); gradients
1e-4 per leaf (relative norm); Trainer loss histories 1e-4.  Expert
choices, their capacity slots and which choices drop are equal, not
close.  Prefill and decode agree with the teacher-forced forward only
where the forward drops nothing, so those checks run at a drop-free
capacity factor (8, as JAX's own test).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro import optim as JOPT
from repro.data import LMDataConfig as JLMDataConfig
from repro.data import lm_batch as j_lm_batch
from repro.models import layers as JL
from repro.models import moe as JM
from repro.models import registry as JReg
from repro.models import transformer as JT
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServingEngine as JEngine
from repro.train import Trainer as JTrainer
from repro.train import TrainerConfig as JTrainerConfig
from repro_torch import tree as T
from repro_torch.convert import params_from_jax
from repro_torch.launch import train as train_launch
from repro_torch.models import layers as TL
from repro_torch.models import moe as TM
from repro_torch.models import registry as TReg
from repro_torch.models import transformer as TT
from repro_torch.serve import Request, ServeConfig, ServingEngine

torch.set_num_threads(2)

RTOL = 1e-5
ARCHS = ["dbrx-132b", "grok-1-314b"]


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


def _moe(e=4, k=2, d=16, f=32, cap=1.25, kind="swiglu", softcap=None,
         seed=0):
    kw = dict(d_model=d, d_ff=f, num_experts=e, top_k=k,
              capacity_factor=cap, kind=kind, router_softcap=softcap)
    jcfg, tcfg = JM.MoEConfig(**kw), TM.MoEConfig(**kw)
    tree = {k: np.array(v) for k, v in JL.init_tree(
        jax.random.PRNGKey(seed), JM.moe_def(jcfg)).items()}
    return jcfg, tcfg, tree


def _both(tree):
    return ({k: jnp.asarray(v) for k, v in tree.items()},
            params_from_jax(tree, device="cpu"))


def _grads(params, fn):
    """(value, grads as a list in flatten order) of ``fn(params)``; a
    value (loss, metrics) comes back detached."""
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


# ---------------------------------------------------------------------------
# moe_apply
# ---------------------------------------------------------------------------

CASES = {
    # name: (moe kwargs, x shape, full_capacity)
    "capacity_1.25": (dict(), (2, 16, 16), False),
    "tiny_capacity_drops": (dict(k=1, cap=0.01), (1, 64, 16), False),
    "one_expert_a_token": (dict(k=1, cap=1.0), (2, 24, 16), False),
    "all_experts": (dict(k=4, cap=1.0), (2, 12, 16), False),
    "full_capacity": (dict(cap=0.01), (2, 9, 16), True),
    "router_softcap": (dict(softcap=0.05), (2, 16, 16), False),
}


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_apply_matches_jax(kind, case):
    kw, shape, full = CASES[case]
    jcfg, tcfg, tree = _moe(kind=kind, **kw)
    jp, tp = _both(tree)
    x = np.random.RandomState(len(case)).randn(*shape).astype(np.float32)
    jy, jaux = JM.moe_apply(jp, jnp.asarray(x), jcfg, full_capacity=full)
    ty, taux = TM.moe_apply(tp, torch.from_numpy(x), tcfg,
                            full_capacity=full)
    assert ty.dtype == torch.float32 and taux.dtype == torch.float32
    _close(ty, jy)
    assert abs(float(taux) - float(jaux)) <= RTOL * abs(float(jaux))


def test_zero_router_breaks_ties_to_the_lower_expert():
    """All probabilities equal: ``jax.lax.top_k`` takes experts 0..k-1 in
    order; so does the port, and its output equals JAX's (the choices, the
    slots and the drops all follow from the order)."""
    jcfg, tcfg, tree = _moe(e=4, k=2, cap=1.0)
    tree["w_router"] = np.zeros_like(tree["w_router"])
    jp, tp = _both(tree)
    x = np.random.RandomState(2).randn(2, 16, 16).astype(np.float32)
    _, _, experts = TM.route(tp, torch.from_numpy(x), tcfg)
    assert (experts == torch.tensor([0, 1])).all()
    _, jidx = jax.lax.top_k(jnp.full((2, 16, 4), 0.25), 2)
    np.testing.assert_array_equal(experts.numpy(), np.asarray(jidx))
    jy, jaux = JM.moe_apply(jp, jnp.asarray(x), jcfg)
    ty, taux = TM.moe_apply(tp, torch.from_numpy(x), tcfg)
    _close(ty, jy)
    assert float(taux) == pytest.approx(float(jaux), rel=RTOL)
    # cap = 8: tokens 0-7 fill experts 0 and 1; tokens 8-15 drop.
    norms = ty.norm(dim=-1)
    assert bool((norms[:, :8] > 0).all()) and not norms[:, 8:].any()


def test_dispatch_is_token_major_and_drops_the_later_choices():
    """Choices are flattened token by token, each token's k in a row; a
    choice's slot is its expert's count of earlier choices; past the
    capacity it goes to the spare row."""
    experts = torch.tensor([[[0, 1], [1, 0], [0, 2], [1, 2]]])
    slot, keep = TM.dispatch_slots(experts, e=3, cap=2)
    #        t0: e0 e1   t1: e1 e0   t2: e0 e2   t3: e1 e2
    assert slot.tolist() == [[0, 2, 3, 1, 6, 4, 6, 5]]
    assert keep.tolist() == [[True, True, True, True, False, True, False,
                              True]]


@pytest.mark.parametrize("kind", ["swiglu", "gelu"])
def test_moe_gradient_matches_jax(kind):
    jcfg, tcfg, tree = _moe(kind=kind, cap=1.0)
    jp, tp = _both(tree)
    x = np.random.RandomState(5).randn(2, 16, 16).astype(np.float32)

    def jloss(p):
        y, aux = JM.moe_apply(p, jnp.asarray(x), jcfg)
        return jnp.sum(jnp.square(y)) + 0.01 * aux

    def tloss(p):
        y, aux = TM.moe_apply(p, torch.from_numpy(x), tcfg)
        return torch.sum(y.square()) + 0.01 * aux
    jv, jg = jax.value_and_grad(jloss)(jp)
    tv, tg = _grads(tp, tloss)
    assert float(tv) == pytest.approx(float(jv), rel=RTOL)
    jleaves = jax.tree_util.tree_leaves_with_path(jg)
    for (path, j), t in zip(jleaves, tg):
        assert _rel(t, j) <= 1e-4, jax.tree_util.keystr(path)


# ---------------------------------------------------------------------------
# JAX's tests/test_moe.py on the port
# ---------------------------------------------------------------------------

def _torch_moe(e=4, k=2, d=16, f=32, cap=1.25):
    cfg = TM.MoEConfig(d_model=d, d_ff=f, num_experts=e, top_k=k,
                       capacity_factor=cap)
    return cfg, TL.init_tree(TM.moe_def(cfg), torch.Generator().manual_seed(0),
                             torch.device("cpu"))


def test_output_shape_and_grad():
    cfg, params = _torch_moe()
    x = torch.randn(2, 8, 16, generator=torch.Generator().manual_seed(1))
    y, aux = TM.moe_apply(params, x, cfg)
    assert y.shape == x.shape and np.isfinite(float(aux))
    _, g = _grads(params, lambda p: (lambda y, aux: torch.sum(y.square())
                                     + 0.01 * aux)(*TM.moe_apply(p, x, cfg)))
    gn = float(torch.sqrt(sum(t.square().sum() for t in g)))
    assert np.isfinite(gn) and gn > 0
    # the router receives gradient (it is the load-balance control)
    names = [p for p, _ in T.leaves_with_paths(params)]
    assert float(g[names.index(("w_router",))].abs().max()) > 0


def test_capacity_formula():
    cfg, _ = _torch_moe(e=8, k=2, cap=1.25)
    assert TM._capacity(1024, cfg) == int(1024 * 2 * 1.25 / 8)
    assert TM._capacity(1, cfg) >= cfg.top_k
    jcfg = JM.MoEConfig(d_model=16, d_ff=32, num_experts=8, top_k=2)
    for tokens in (1, 7, 100, 2048):
        assert TM._capacity(tokens, cfg) == JM._capacity(tokens, jcfg)


def test_uniform_router_no_drops():
    cfg, params = _torch_moe(e=4, k=1, cap=4.0)
    params["w_router"] = torch.zeros_like(params["w_router"])
    x = torch.randn(1, 16, 16, generator=torch.Generator().manual_seed(2))
    y, _ = TM.moe_apply(params, x, cfg)
    assert float(y[0].norm(dim=-1).min()) > 0


def test_tiny_capacity_drops_tokens():
    cfg, params = _torch_moe(e=4, k=1, cap=0.01)
    x = torch.randn(1, 64, 16, generator=torch.Generator().manual_seed(3))
    y, _ = TM.moe_apply(params, x, cfg)
    # capacity = max(1, ...) = 1 an expert -> at most 4 tokens survive
    assert int((y[0].norm(dim=-1) > 1e-6).sum()) <= 4


def test_moe_flops_scale_with_active_params():
    """The products of the block scale with capacity x experts (active
    params), not with tokens x experts x capacity (a one-hot dispatch):
    within 8x of the active compute, as JAX's HLO count is held."""
    cfg, params = _torch_moe(e=4, k=1, d=32, f=64, cap=1.0)
    with FlopCounterMode(display=False) as count:
        TM.moe_apply(params, torch.ones(1, 256, 32), cfg)
    t = 256
    expert_flops = 2 * 3 * t * 1.0 * 32 * 64
    router_flops = 2 * t * 32 * 4
    assert count.get_total_flops() < 8 * (expert_flops + router_flops)
    assert count.get_total_flops() == expert_flops + router_flops


# ---------------------------------------------------------------------------
# The reduced dbrx-132b and grok-1-314b
# ---------------------------------------------------------------------------

def _configs(name, cap=None):
    jcfg = JReg.reduced_config(JReg.get(name))
    tcfg = TReg.reduced_config(TReg.get(name))
    if cap is not None:
        jcfg = dataclasses.replace(
            jcfg, moe=dataclasses.replace(jcfg.moe, capacity_factor=cap))
        tcfg = dataclasses.replace(
            tcfg, moe=dataclasses.replace(tcfg.moe, capacity_factor=cap))
    return jcfg, tcfg


def _params(jcfg, seed=0):
    tree = _perturbed(JT.init_params(jax.random.PRNGKey(seed), jcfg), seed)
    return jax.tree_util.tree_map(jnp.asarray, tree), \
        params_from_jax(tree, device="cpu")


@pytest.mark.parametrize("name", ARCHS)
def test_reduced_forward_and_aux_match_jax(name):
    """The train forward at the published capacity factor (1.25, so some
    choices drop): logits and the summed aux loss."""
    jcfg, tcfg = _configs(name)
    assert tcfg.moe == TM.MoEConfig(**dataclasses.asdict(jcfg.moe))
    assert TT.model_def(tcfg).keys() == JT.model_def(jcfg).keys()
    jp, tp = _params(jcfg)
    assert tp["layers"]["m0"]["ffn"]["w_up"].shape == (2, 4, 64, 128)
    toks = np.random.RandomState(6).randint(0, jcfg.vocab, (2, 23))
    want, _, jaux = JT.forward(jp, jcfg, tokens=jnp.asarray(toks))
    got, _, taux = TT.forward(tp, tcfg, tokens=torch.as_tensor(toks))
    _close(got, want)
    assert float(taux) > 0
    assert abs(float(taux) - float(jaux)) <= RTOL * float(jaux)


@pytest.mark.parametrize("name", ARCHS)
def test_reduced_prefill_and_decode_match_jax(name):
    """Prefill (every cache leaf) and 5 decode steps against JAX, and
    against the teacher-forced forward, at a drop-free factor."""
    jcfg, tcfg = _configs(name, cap=8.0)
    jp, tp = _params(jcfg, seed=1)
    toks = np.random.RandomState(7).randint(0, jcfg.vocab, (2, 16))
    full, _, _ = TT.forward(tp, tcfg, tokens=torch.as_tensor(toks))
    jl, jc = JT.prefill(jp, jcfg, jnp.asarray(toks[:, :11]), cache_len=24)
    tl, tc = TT.prefill(tp, tcfg, torch.as_tensor(toks[:, :11]),
                        cache_len=24)
    _close(tl, jl)
    _close(tl, full[:, 10].numpy())
    jleaves = jax.tree_util.tree_leaves_with_path(jc)
    tleaves = T.leaves_with_paths(tc)
    assert [tuple(k.key for k in p) for p, _ in jleaves] \
        == [p for p, _ in tleaves]
    for (_, j), (_, t) in zip(jleaves, tleaves):
        _close(t, j)
    for i in range(11, 16):
        pos = np.array([i, i])
        jl, jc = JT.decode_step(jp, jcfg, jnp.asarray(toks[:, i]), jc,
                                jnp.asarray(pos, jnp.int32))
        tl, tc = TT.decode_step(tp, tcfg, torch.as_tensor(toks[:, i]), tc,
                                torch.as_tensor(pos))
        _close(tl, jl)
        _close(tl, full[:, i].numpy())


@pytest.mark.parametrize("name", ARCHS)
def test_loss_fn_and_gradient_match_jax(name):
    jcfg, tcfg = _configs(name)
    jp, tp = _params(jcfg, seed=2)
    rng = np.random.RandomState(4)
    batch = {"tokens": rng.randint(0, jcfg.vocab, (2, 19)).astype(np.int32),
             "targets": rng.randint(0, jcfg.vocab, (2, 19)).astype(np.int32),
             "mask": (rng.rand(2, 19) < 0.7).astype(np.float32)}
    (jloss, jaux), jg = jax.value_and_grad(
        lambda p: JT.loss_fn(p, jcfg, {k: jnp.asarray(v)
                                       for k, v in batch.items()}),
        has_aux=True)(jp)
    (tloss, taux), tg = _grads(tp, lambda p: TT.loss_fn(
        p, tcfg, {k: torch.from_numpy(v) for k, v in batch.items()}))
    assert abs(float(tloss) - float(jloss)) <= RTOL * float(jloss)
    assert abs(float(taux["moe_aux"]) - float(jaux["moe_aux"])) \
        <= RTOL * float(jaux["moe_aux"])
    assert float(tloss) == pytest.approx(
        float(taux["ce"]) + tcfg.moe_aux_coef * float(taux["moe_aux"]),
        rel=1e-6)
    jleaves = jax.tree_util.tree_leaves_with_path(jg)
    assert len(jleaves) == len(tg)
    for (path, jleaf), g in zip(jleaves, tg):
        assert _rel(g, jleaf) <= 1e-4, jax.tree_util.keystr(path)


def test_train_lm_matches_jax_trainer(tmp_path):
    """Three steps of the launcher's LM branch (reduced dbrx-132b, AdamW
    under the warm-up cosine) against JAX's Trainer with the same
    optimizer, data and params."""
    name = "dbrx-132b"
    jcfg, _ = _configs(name)
    tree = _perturbed(JT.init_params(jax.random.PRNGKey(0), jcfg), 0)
    args = train_launch.build_parser().parse_args(
        ["--arch", name, "--device", "cpu", "--ckpt",
         str(tmp_path / "torch"), "--log-every", "1", "--global-batch", "4",
         "--seq-len", "16", "--steps", "3"])
    data = JLMDataConfig(vocab=jcfg.vocab, seq_len=16, global_batch=4)
    jt = JTrainer(
        loss_fn=lambda p, b: JT.loss_fn(p, jcfg, b),
        params=jax.tree_util.tree_map(jnp.asarray, tree),
        optimizer=JOPT.default_optimizer_for(
            name, jcfg.param_count(), JOPT.warmup_cosine(3e-3, 10, 3)),
        mesh=None, param_specs=None,
        batch_fn=lambda s: j_lm_batch(data, s),
        config=JTrainerConfig(total_steps=3, ckpt_every=100,
                              ckpt_dir=str(tmp_path / "jax"), log_every=1))
    jt.run()
    tt = train_launch.train_lm(TReg.get(name).config, args,
                               params=params_from_jax(tree, device="cpu"))
    assert tt.opt.name == "adamw"
    jl = [h["loss"] for h in jt.history if "loss" in h]
    tl = [h["loss"] for h in tt.history if "loss" in h]
    assert len(tl) == len(jl) == 3
    np.testing.assert_allclose(tl, jl, rtol=1e-4)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def _requests(make, vocab, lengths, max_new):
    rng = np.random.RandomState(8)
    return [make(uid=i, prompt=rng.randint(0, vocab, n).astype(np.int32),
                 max_new_tokens=m)
            for i, (n, m) in enumerate(zip(lengths, max_new))]


@functools.lru_cache(maxsize=None)
def _jax_engine_tokens(name: str, slots: int) -> dict:
    jcfg, _ = _configs(name)
    jp, _ = _params(jcfg, seed=3)
    jeng = JEngine(jp, jcfg, JServeConfig(slots=slots, cache_len=24))
    for r in _requests(JRequest, jcfg.vocab, [5, 9, 5, 9], [3, 7, 5, 40]):
        jeng.submit(r)
    return {r.uid: r.output for r in jeng.run_until_drained()}


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("slots", [1, 2])
def test_engine_serves_the_jax_engines_tokens(name, slots):
    """Both engines at the published capacity factor (prefill may drop,
    decode does not): the same tokens per request."""
    jcfg, tcfg = _configs(name)
    _, tp = _params(jcfg, seed=3)
    teng = ServingEngine(tp, tcfg, ServeConfig(slots=slots, cache_len=24),
                         device="cpu")
    for r in _requests(Request, tcfg.vocab, [5, 9, 5, 9], [3, 7, 5, 40]):
        teng.submit(r)
    got = {r.uid: r.output for r in teng.run_until_drained()}
    assert got == _jax_engine_tokens(name, slots)
    assert len(got[3]) == 24 - 9          # retired on a full cache


# ---------------------------------------------------------------------------
# The registry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ARCHS)
def test_full_config_matches_the_jax_registry(name):
    jspec, tspec = JReg.get(name), TReg.get(name)
    jcfg, tcfg = jspec.config, tspec.config
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.active_param_count() == jcfg.active_param_count()
    assert dataclasses.asdict(tcfg.moe) == dataclasses.asdict(jcfg.moe)
    for f in ("attn_softcap", "logits_softcap", "embed_scale",
              "tie_embeddings", "norm", "act", "rope_theta"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    assert tspec.family == jspec.family == "moe"
    assert tspec.source == jspec.source
    jred, tred = JReg.reduced_config(jspec), TReg.reduced_config(tspec)
    assert dataclasses.asdict(tred.moe) == dataclasses.asdict(jred.moe)
    assert tred.param_count() == jred.param_count()
    assert tred.active_param_count() == jred.active_param_count()
