"""Port parity: the RWKV-6 family of ``repro_torch`` (``models/rwkv6.py``,
the 'rwkv6' layer kind of ``models/transformer.py`` with its caches,
rwkv6-3b in the registry, the serving engine and both LM launchers)
against the JAX package.

Inputs come from numpy with a seed; JAX params are converted with
``repro_torch.convert.params_from_jax``.  Tolerances: the blocks and the
WKV scan fp32 1e-5 relative to the largest value (the same sums in
another order); the chunked scan against the step recurrence 5e-4, JAX's
own test's bound (exp-factorised within a chunk); whole-model logits 1e-5
relative norm: the per-head group norm scales up the fp32 rounding of
both packages where a head's WKV output is small, and at one position of
the seed-0 forward the two differ by more than 1e-5 of the largest
logit; gradients 1e-4 per leaf (relative norm).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro.models import registry as JReg
from repro.models import rwkv6 as JR
from repro.models import transformer as JT
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServingEngine as JEngine
from repro_torch import tree as T
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as serve_launch
from repro_torch.launch import train as train_launch
from repro_torch.models import registry as TReg
from repro_torch.models import rwkv6 as TR
from repro_torch.models import transformer as TT
from repro_torch.serve import Request, ServeConfig, ServingEngine

torch.set_num_threads(2)

RTOL = 1e-5
NAME = "rwkv6-3b"


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
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _perturbed(tree, seed):
    """A numpy copy of a JAX param tree whose zero-init leaves (the lerp
    coefficients, decay bias, bonus, norm scales) are random."""
    rng = np.random.RandomState(seed)

    def go(node):
        if isinstance(node, dict):
            return {k: go(node[k]) for k in sorted(node)}
        a = np.array(node)
        if not a.any():
            a = (rng.randn(*a.shape) * 0.1).astype(a.dtype)
        return a
    return go(tree)


def _block(defs_fn, seed=0):
    jcfg = JR.RWKVConfig(d_model=64, d_ff=96, head_dim=16, decay_lora_rank=8)
    tcfg = TR.RWKVConfig(d_model=64, d_ff=96, head_dim=16, decay_lora_rank=8)
    tree = _perturbed(JL.init_tree(jax.random.PRNGKey(seed),
                                   getattr(JR, defs_fn)(jcfg)), seed)
    return jcfg, tcfg, {k: jnp.asarray(v) for k, v in tree.items()}, \
        params_from_jax(tree, device="cpu")


def _configs(dtype=None):
    jcfg = JReg.reduced_config(JReg.get(NAME))
    tcfg = TReg.reduced_config(TReg.get(NAME))
    if dtype is not None:
        jcfg = dataclasses.replace(jcfg, dtype=getattr(jnp, dtype))
        tcfg = dataclasses.replace(tcfg, dtype=getattr(torch, dtype))
    return jcfg, tcfg


def _params(jcfg, seed=0):
    tree = _perturbed(JT.init_params(jax.random.PRNGKey(seed), jcfg), seed)
    return jax.tree_util.tree_map(jnp.asarray, tree), \
        params_from_jax(tree, device="cpu")


def _wkv_inputs(s, seed, b=2, h=3, dh=8, state=False):
    """JAX's hypothesis test's draw: unit normal r, k, v; log-decays
    -exp(0.5 N) clamped; a bonus of scale 0.1."""
    rng = np.random.RandomState(seed)
    r, k, v = (rng.randn(b, s, h, dh).astype(np.float32) for _ in range(3))
    lw = np.clip(-np.exp(rng.randn(b, s, h, dh) * 0.5), -2.5,
                 -1e-6).astype(np.float32)
    u = (rng.randn(h, dh) * 0.1).astype(np.float32)
    s0 = rng.randn(b, h, dh, dh).astype(np.float32) if state else None
    return r, k, v, lw, u, s0


# ---------------------------------------------------------------------------
# The blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("defs_fn", ["time_mix_def", "channel_mix_def"])
def test_defs_match_jax(defs_fn):
    jcfg, tcfg, _, _ = _block(defs_fn)
    jdefs, tdefs = getattr(JR, defs_fn)(jcfg), getattr(TR, defs_fn)(tcfg)
    assert sorted(jdefs) == sorted(tdefs)
    for k in jdefs:
        assert tdefs[k].shape == jdefs[k].shape, k
        assert tdefs[k].init == jdefs[k].init, k
        assert tdefs[k].scale == jdefs[k].scale, k
    assert (TR.LOG_DECAY_MIN, TR.LOG_DECAY_MAX, TR.CHUNK) \
        == (JR.LOG_DECAY_MIN, JR.LOG_DECAY_MAX, JR.CHUNK)
    assert tcfg.n_heads == jcfg.n_heads == 4


@pytest.mark.parametrize("s", [32, 64, 96])
@pytest.mark.parametrize("carried", [False, True])
def test_wkv_chunked_matches_jax(s, carried):
    r, k, v, lw, u, s0 = _wkv_inputs(s, seed=s, state=carried)
    jo, jS = JR.wkv_chunked(*map(jnp.asarray, (r, k, v, lw, u)),
                            state=None if s0 is None else jnp.asarray(s0))
    to, tS = TR.wkv_chunked(*map(torch.from_numpy, (r, k, v, lw, u)),
                            state=None if s0 is None
                            else torch.from_numpy(s0))
    assert to.dtype == tS.dtype == torch.float32
    _close(to, jo)
    _close(tS, jS)


@pytest.mark.parametrize("s", [32, 64, 96])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_wkv_chunked_equals_step_recurrence(s, seed):
    """JAX's ``test_wkv_chunked_equals_recurrence`` on the port: the chunked
    scan equals the step recurrence, token by token, within its 5e-4; and
    the port's step equals JAX's step."""
    r, k, v, lw, u, _ = _wkv_inputs(s, seed=100 + seed, b=1, h=2)
    rt, kt, vt, lwt, ut = map(torch.from_numpy, (r, k, v, lw, u))
    st = torch.zeros(1, 2, 8, 8)
    js = jnp.zeros((1, 2, 8, 8))
    outs = []
    for t in range(s):
        o, st = TR.wkv_step(rt[:, t], kt[:, t], vt[:, t], lwt[:, t], ut, st)
        jo, js = JR.wkv_step(*(jnp.asarray(a[:, t]) for a in (r, k, v, lw)),
                             jnp.asarray(u), js)
        _close(o, jo)
        outs.append(o)
    _close(st, js)
    got, S = TR.wkv_chunked(rt, kt, vt, lwt, ut, chunk=32)
    np.testing.assert_allclose(got.numpy(), torch.stack(outs, 1).numpy(),
                               rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(S.numpy(), st.numpy(), rtol=5e-4, atol=5e-4)


def test_wkv_state_crosses_calls_and_chunks():
    """64 tokens in one call equal 32 and 32 with the state carried, and
    a chunk of 16 gives the chunk of 32's result: the state crosses chunk
    boundaries exactly as it crosses calls."""
    r, k, v, lw, u, s0 = map(torch.from_numpy, _wkv_inputs(64, seed=7,
                                                           state=True))
    o, S = TR.wkv_chunked(r, k, v, lw, u, state=s0)
    o1, S1 = TR.wkv_chunked(r[:, :32], k[:, :32], v[:, :32], lw[:, :32], u,
                            state=s0)
    o2, S2 = TR.wkv_chunked(r[:, 32:], k[:, 32:], v[:, 32:], lw[:, 32:], u,
                            state=S1)
    _close(torch.cat([o1, o2], 1), o.numpy())
    _close(S2, S.numpy())
    o16, S16 = TR.wkv_chunked(r, k, v, lw, u, state=s0, chunk=16)
    _close(o16, o.numpy())
    _close(S16, S.numpy())


@pytest.mark.parametrize("s", [33, 50])
def test_padded_prefill_matches_jax(s):
    """A sequence that is no multiple of the chunk: JAX pads k = v = 0
    and lw = 0 (decay 1), so the final WKV state is the unpadded one; the
    port's output, shift and WKV state equal JAX's, and the state equals
    the step recurrence's after ``s`` tokens."""
    jcfg, tcfg, jp, tp = _block("time_mix_def", seed=s)
    x = np.random.RandomState(s).randn(2, s, 64).astype(np.float32)
    jy, (jsh, jS) = JR.time_mix_apply(jp, jnp.asarray(x), jcfg)
    ty, (tsh, tS) = TR.time_mix_apply(tp, torch.from_numpy(x), tcfg)
    _close(ty, jy)
    _close(tsh, jsh)
    _close(tS, jS)
    sh, st = torch.zeros(2, 64), torch.zeros(2, 4, 16, 16)
    for t in range(s):
        _, (sh, st) = TR.time_mix_step(tp, torch.from_numpy(x[:, t]), tcfg,
                                       shift_state=sh, wkv_state=st)
    np.testing.assert_allclose(tS.numpy(), st.numpy(), rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("with_state", [False, True])
def test_time_mix_apply_and_step_match_jax(with_state):
    jcfg, tcfg, jp, tp = _block("time_mix_def", seed=3)
    rng = np.random.RandomState(3)
    x = rng.randn(2, 13, 64).astype(np.float32)
    sh = rng.randn(2, 64).astype(np.float32) if with_state else None
    S0 = rng.randn(2, 4, 16, 16).astype(np.float32) if with_state else None
    jy, (jsh, jS) = JR.time_mix_apply(
        jp, jnp.asarray(x), jcfg,
        shift_state=None if sh is None else jnp.asarray(sh),
        wkv_state=None if S0 is None else jnp.asarray(S0))
    ty, (tsh, tS) = TR.time_mix_apply(
        tp, torch.from_numpy(x), tcfg,
        shift_state=None if sh is None else torch.from_numpy(sh),
        wkv_state=None if S0 is None else torch.from_numpy(S0))
    _close(ty, jy)
    _close(tS, jS)
    np.testing.assert_array_equal(tsh.numpy(), x[:, -1])
    jy1, (jsh1, jS1) = JR.time_mix_step(jp, jnp.asarray(x[:, 0]), jcfg,
                                        shift_state=jsh, wkv_state=jS)
    ty1, (tsh1, tS1) = TR.time_mix_step(tp, torch.from_numpy(x[:, 0]), tcfg,
                                        shift_state=tsh, wkv_state=tS)
    _close(ty1, jy1)
    _close(tS1, jS1)
    _close(tsh1, jsh1)


def test_channel_mix_apply_and_step_match_jax():
    jcfg, tcfg, jp, tp = _block("channel_mix_def", seed=4)
    rng = np.random.RandomState(4)
    x = rng.randn(2, 9, 64).astype(np.float32)
    sh = rng.randn(2, 64).astype(np.float32)
    for state in (None, sh):
        jy, jsh = JR.channel_mix_apply(
            jp, jnp.asarray(x), jcfg,
            shift_state=None if state is None else jnp.asarray(state))
        ty, tsh = TR.channel_mix_apply(
            tp, torch.from_numpy(x), tcfg,
            shift_state=None if state is None else torch.from_numpy(state))
        _close(ty, jy)
        _close(tsh, jsh)
    jy1, _ = JR.channel_mix_step(jp, jnp.asarray(x[:, 3]), jcfg,
                                 shift_state=jnp.asarray(sh))
    ty1, tsh1 = TR.channel_mix_step(tp, torch.from_numpy(x[:, 3]), tcfg,
                                    shift_state=torch.from_numpy(sh))
    _close(ty1, jy1)
    np.testing.assert_array_equal(tsh1.numpy(), x[:, 3])


def test_log_decay_is_clamped():
    _, _, _, tp = _block("time_mix_def")
    for w0 in (-40.0, 0.0, 5.0):
        p = dict(tp, decay_w0=torch.full((64,), w0))
        lw = TR._log_decay(p, torch.randn(2, 5, 64))
        assert lw.dtype == torch.float32
        assert float(lw.min()) >= TR.LOG_DECAY_MIN
        assert float(lw.max()) <= np.float32(TR.LOG_DECAY_MAX)
    assert float(TR._log_decay(dict(tp, decay_w0=torch.full((64,), 5.0)),
                               torch.randn(1, 1, 64)).max()) \
        == pytest.approx(TR.LOG_DECAY_MIN)


# ---------------------------------------------------------------------------
# The reduced rwkv6-3b
# ---------------------------------------------------------------------------

def test_reduced_model_matches_jax():
    """forward (train) logits, prefill logits and every cache leaf, and 5
    decode steps, each against the JAX model on the same params."""
    jcfg, tcfg = _configs()
    assert tcfg.pattern == ("rwkv6",) and tcfg.n_periods == 2
    assert TT.model_def(tcfg).keys() == JT.model_def(jcfg).keys()
    jp, tp = _params(jcfg)
    toks = np.random.RandomState(6).randint(0, jcfg.vocab, (2, 11))
    want, _, jaux = JT.forward(jp, jcfg, tokens=jnp.asarray(toks))
    got, caches, taux = TT.forward(tp, tcfg, tokens=torch.as_tensor(toks))
    assert caches is None and float(taux) == float(jaux) == 0.0
    assert _rel(got, want) <= RTOL

    jl, jc = JT.prefill(jp, jcfg, jnp.asarray(toks), cache_len=24)
    tl, tc = TT.prefill(tp, tcfg, torch.as_tensor(toks), cache_len=24)
    assert _rel(tl, jl) <= RTOL
    jleaves = jax.tree_util.tree_leaves_with_path(jc)
    tleaves = T.leaves_with_paths(tc)
    assert [tuple(k.key for k in p) for p, _ in jleaves] \
        == [p for p, _ in tleaves]
    for (path, j), (_, t) in zip(jleaves, tleaves):
        assert _rel(t, j) <= RTOL, path
    assert tc["layers"]["m0"]["wkv"].shape == (2, 2, 4, 16, 16)
    pos = np.array([11, 11])
    tok = np.asarray(jl).argmax(-1)
    for _ in range(5):
        jl, jc = JT.decode_step(jp, jcfg, jnp.asarray(tok, jnp.int32), jc,
                                jnp.asarray(pos, jnp.int32))
        tl, tc = TT.decode_step(tp, tcfg, torch.as_tensor(tok), tc,
                                torch.as_tensor(pos))
        assert _rel(tl, jl) <= RTOL
        tok, pos = np.asarray(jl).argmax(-1), pos + 1
    for key in ("shift_tm", "wkv", "shift_cm"):
        assert _rel(tc["layers"]["m0"][key], jc["layers"]["m0"][key]) <= RTOL


def test_reduced_model_in_bf16_keeps_the_cache_dtypes():
    """bf16 compute on fp32 params: logits within phase 13's bf16 cap
    (4e-2, relative norm) of JAX's bf16 logits; the shift states are
    bf16 and the WKV state fp32, in the prefill's caches and in zero
    caches alike."""
    jcfg, tcfg = _configs("bfloat16")
    jp, tp = _params(jcfg, seed=1)
    toks = np.random.RandomState(7).randint(0, jcfg.vocab, (2, 13))
    want, _, _ = JT.forward(jp, jcfg, tokens=jnp.asarray(toks))
    got, _, _ = TT.forward(tp, tcfg, tokens=torch.as_tensor(toks))
    assert got.dtype == torch.float32 and _rel(got, want) <= 4e-2
    _, jc = JT.prefill(jp, jcfg, jnp.asarray(toks), cache_len=16)
    _, tc = TT.prefill(tp, tcfg, torch.as_tensor(toks), cache_len=16)
    zeros = TT.init_cache(tcfg, 3, 16, device="cpu")
    for tree in (tc["layers"]["m0"], zeros["layers"]["m0"]):
        assert tree["shift_tm"].dtype == tree["shift_cm"].dtype \
            == torch.bfloat16
        assert tree["wkv"].dtype == torch.float32
    assert str(jc["layers"]["m0"]["wkv"].dtype) == "float32"
    assert zeros["layers"]["m0"]["wkv"].shape == (2, 3, 4, 16, 16)


def test_loss_fn_and_gradient_match_jax():
    jcfg, tcfg = _configs()
    jp, tp = _params(jcfg, seed=1)
    rng = np.random.RandomState(4)
    batch = {"tokens": rng.randint(0, jcfg.vocab, (2, 19)).astype(np.int32),
             "targets": rng.randint(0, jcfg.vocab, (2, 19)).astype(np.int32),
             "mask": (rng.rand(2, 19) < 0.7).astype(np.float32)}
    (jloss, jaux), jg = jax.value_and_grad(
        lambda p: JT.loss_fn(p, jcfg, {k: jnp.asarray(v)
                                       for k, v in batch.items()}),
        has_aux=True)(jp)
    leaves = [t.requires_grad_(True) for t in T.leaves(tp)]
    tloss, taux = TT.loss_fn(tp, tcfg, {k: torch.from_numpy(v)
                                        for k, v in batch.items()})
    tg = torch.autograd.grad(tloss, leaves)
    tloss = tloss.detach()
    assert abs(float(tloss) - float(jloss)) <= 1e-5 * float(jloss)
    assert float(taux["moe_aux"]) == float(jaux["moe_aux"]) == 0.0
    jleaves = jax.tree_util.tree_leaves_with_path(jg)
    assert len(jleaves) == len(tg)
    for (path, jleaf), g in zip(jleaves, tg):
        assert _rel(g, jleaf) <= 1e-4, jax.tree_util.keystr(path)


# ---------------------------------------------------------------------------
# Serving and training
# ---------------------------------------------------------------------------

def _requests(make, vocab, lengths, max_new):
    rng = np.random.RandomState(8)
    return [make(uid=i, prompt=rng.randint(0, vocab, n).astype(np.int32),
                 max_new_tokens=m)
            for i, (n, m) in enumerate(zip(lengths, max_new))]


@functools.lru_cache(maxsize=None)
def _jax_engine_tokens(slots: int) -> dict:
    jcfg, _ = _configs()
    jp, _ = _params(jcfg, seed=2)
    jeng = JEngine(jp, jcfg, JServeConfig(slots=slots, cache_len=24))
    for r in _requests(JRequest, jcfg.vocab, [5, 9, 33, 3], [3, 7, 5, 40]):
        jeng.submit(r)
    return {r.uid: r.output for r in jeng.run_until_drained()}


@pytest.mark.parametrize("slots", [1, 2])
def test_engine_serves_the_jax_engines_tokens(slots):
    """Both engines on the same params and requests (prompts of 3-33
    tokens, one past a chunk, one retired on a full cache) emit the same
    tokens; a slot's recurrent state is replaced when a new request takes
    it."""
    jcfg, tcfg = _configs()
    _, tp = _params(jcfg, seed=2)
    teng = ServingEngine(tp, tcfg, ServeConfig(slots=slots, cache_len=24),
                         device="cpu")
    for r in _requests(Request, tcfg.vocab, [5, 9, 33, 3], [3, 7, 5, 40]):
        teng.submit(r)
    got = {r.uid: r.output for r in teng.run_until_drained()}
    assert got == _jax_engine_tokens(slots)
    assert len(got[3]) == 24 - 3          # retired on a full cache
    assert teng.caches["layers"]["m0"]["wkv"].dtype == torch.float32


def test_serve_lm_and_train_lm_on_the_cpu(tmp_path):
    args = serve_launch.build_parser().parse_args(
        ["--arch", NAME, "--device", "cpu", "--requests", "3",
         "--max-new-tokens", "4", "--slots", "2", "--reduced"])
    cfg = TReg.reduced_config(TReg.get(args.arch))
    engine, steps, seconds = serve_launch.serve_lm(cfg, args)
    assert sorted(r.uid for r in engine.completed) == [0, 1, 2]
    assert "served 3 requests / 12 tokens" in serve_launch.report_lm(
        engine, steps, seconds)
    targs = train_launch.build_parser().parse_args(
        ["--arch", NAME, "--device", "cpu", "--ckpt", str(tmp_path),
         "--log-every", "1", "--global-batch", "2", "--seq-len", "40",
         "--steps", "2"])
    tr = train_launch.train_lm(TReg.get(NAME).config, targs)
    assert tr.params["layers"]["m0"]["tm"]["w_r"].shape == (2, 64, 64)
    losses = [h["loss"] for h in tr.history if "loss" in h]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert tr.telemetry["skipped"] == 0


# ---------------------------------------------------------------------------
# The registry
# ---------------------------------------------------------------------------

def test_full_config_matches_the_jax_registry():
    jspec, tspec = JReg.get(NAME), TReg.get(NAME)
    jcfg, tcfg = jspec.config, tspec.config
    assert tcfg.param_count() == jcfg.param_count()
    assert round(tcfg.param_count() / 1e9, 3) == 3.073
    assert tcfg.active_param_count() == jcfg.active_param_count()
    assert dataclasses.asdict(tcfg.rwkv) == dataclasses.asdict(jcfg.rwkv)
    assert tspec.family == jspec.family == "ssm"
    assert tspec.long_context_ok and tspec.source == jspec.source
    jred, tred = JReg.reduced_config(jspec), TReg.reduced_config(tspec)
    assert dataclasses.asdict(tred.rwkv) == dataclasses.asdict(jred.rwkv)
    assert tred.param_count() == jred.param_count()
