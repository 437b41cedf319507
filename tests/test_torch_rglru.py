"""Port parity: the RG-LRU family of ``repro_torch`` (``models/rglru.py``,
the mixed (rglru, rglru, attn) pattern of ``models/transformer.py``,
recurrentgemma-9b in the registry, the serving engine's recurrent
caches and ``serve_lm``) against the JAX package.

Inputs come from numpy with a seed; JAX params are converted with
``repro_torch.convert.params_from_jax``.  Tolerances: fp32 1e-5 relative
to the largest value (the same recurrence composed in another order:
JAX's ``associative_scan`` against the port's doubling scan); the scan
against the step recurrence 2e-4, JAX's own test's bound; bf16 2e-2
(relative norm).
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
from repro.models import rglru as JR
from repro.models import transformer as JT
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServingEngine as JEngine
from repro_torch import tree as T
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as launch
from repro_torch.models import registry as TReg
from repro_torch.models import rglru as TR
from repro_torch.models import transformer as TT
from repro_torch.serve import Request, ServeConfig, ServingEngine

torch.set_num_threads(2)

RTOL = 1e-5
NAME = "recurrentgemma-9b"


def _close(got, want, rtol=RTOL):
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                     else got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got / scale, want / scale, rtol=rtol,
                               atol=rtol)


def _rel_norm(got, want):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


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


def _block(d=16, dr=24, seed=0):
    jcfg, tcfg = JR.RGLRUConfig(d, dr), TR.RGLRUConfig(d, dr)
    tree = _perturbed(JL.init_tree(jax.random.PRNGKey(seed),
                                   JR.rglru_block_def(jcfg)), seed)
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


# ---------------------------------------------------------------------------
# The block
# ---------------------------------------------------------------------------

def test_block_def_matches_jax():
    jcfg, tcfg, jp, tp = _block()
    jdefs, tdefs = JR.rglru_block_def(jcfg), TR.rglru_block_def(tcfg)
    assert sorted(jdefs) == sorted(tdefs)
    for k in jdefs:
        assert tdefs[k].shape == jdefs[k].shape, k
        assert tdefs[k].init == jdefs[k].init, k
        assert tdefs[k].scale == jdefs[k].scale, k
    assert TR.LRU_C == JR.LRU_C and TR.CONV_WIDTH == JR.CONV_WIDTH


@pytest.mark.parametrize("s", [1, 5, 37, 64])
@pytest.mark.parametrize("carried", [False, True])
def test_rg_lru_scan_matches_jax(s, carried):
    _, _, jp, tp = _block(dr=24, seed=s)
    rng = np.random.RandomState(s)
    x = rng.randn(3, s, 24).astype(np.float32)
    h0 = rng.randn(3, 24).astype(np.float32) if carried else None
    jy, jh = JR.rg_lru_scan(jp, jnp.asarray(x),
                            None if h0 is None else jnp.asarray(h0))
    ty, th = TR.rg_lru_scan(tp, torch.from_numpy(x),
                            None if h0 is None else torch.from_numpy(h0))
    assert ty.dtype == torch.float32 and th.dtype == torch.float32
    _close(ty, jy)
    _close(th, jh)


@pytest.mark.parametrize("with_state", [False, True])
def test_rglru_block_apply_matches_jax(with_state):
    jcfg, tcfg, jp, tp = _block(seed=3)
    rng = np.random.RandomState(3)
    x = rng.randn(2, 13, 16).astype(np.float32)
    state = None
    if with_state:
        state = {"h": rng.randn(2, 24).astype(np.float32),
                 "conv": rng.randn(2, 3, 24).astype(np.float32)}
    jy, jst = JR.rglru_block_apply(
        jp, jnp.asarray(x), jcfg,
        state=None if state is None else
        {k: jnp.asarray(v) for k, v in state.items()})
    ty, tst = TR.rglru_block_apply(
        tp, torch.from_numpy(x), tcfg,
        state=None if state is None else
        {k: torch.from_numpy(v) for k, v in state.items()})
    _close(ty, jy)
    for k in ("h", "conv"):
        _close(tst[k], jst[k])
    jy1, jst1 = JR.rglru_block_step(jp, jnp.asarray(x[:, 0]), jcfg,
                                    state=jst)
    ty1, tst1 = TR.rglru_block_step(tp, torch.from_numpy(x[:, 0]), tcfg,
                                    state=tst)
    _close(ty1, jy1)
    for k in ("h", "conv"):
        _close(tst1[k], jst1[k])


def test_rglru_scan_equals_step():
    """JAX's ``test_rglru_scan_equals_step`` on the port: the block over
    20 tokens equals 20 decode steps from a fresh state."""
    cfg = TR.RGLRUConfig(d_model=16, d_rnn=16)
    gen = torch.Generator().manual_seed(0)
    from repro_torch.models.layers import init_tree
    params = init_tree(TR.rglru_block_def(cfg), gen, torch.device("cpu"))
    x = torch.randn(2, 20, 16, generator=gen)
    y_scan, state = TR.rglru_block_apply(params, x, cfg)
    st = {"h": torch.zeros(2, 16), "conv": torch.zeros(2, 3, 16)}
    outs = []
    for t in range(20):
        o, st = TR.rglru_block_step(params, x[:, t], cfg, state=st)
        outs.append(o)
    np.testing.assert_allclose(y_scan.numpy(), torch.stack(outs, 1).numpy(),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(state["h"].numpy(), st["h"].numpy(),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(state["conv"].numpy(), st["conv"].numpy())


def test_rglru_decay_bounded():
    """RG-LRU is contractive (|a_t| <= 1): finite at 512 steps of inputs
    10x the unit scale, and so is its gradient."""
    cfg = TR.RGLRUConfig(d_model=8, d_rnn=8)
    from repro_torch.models.layers import init_tree
    gen = torch.Generator().manual_seed(0)
    params = init_tree(TR.rglru_block_def(cfg), gen, torch.device("cpu"))
    x = (torch.randn(1, 512, 8, generator=gen) * 10).requires_grad_(True)
    y, h = TR.rg_lru_scan(params, x)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
    a, _ = TR._decay_and_input(params, x)
    assert bool((a <= 1).all()) and bool((a > 0).all())
    g, = torch.autograd.grad(y.sum(), x)
    assert bool(torch.isfinite(g).all())


def test_scan_is_log_depth():
    """The doubling scan runs ceil(log2 S) steps, not one a token."""
    _, _, _, tp = _block()
    calls = []
    real = torch.cat

    def cat(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    torch.cat = cat
    try:
        TR.rg_lru_scan(tp, torch.randn(1, 2048, 24))
    finally:
        torch.cat = real
    assert len(calls) == 2 * 11 - 1          # b every step, a but the last


# ---------------------------------------------------------------------------
# The reduced recurrentgemma-9b
# ---------------------------------------------------------------------------

def test_reduced_model_matches_jax():
    """forward (train) logits, prefill logits and every cache leaf (the
    two recurrent prefix layers, the stacked periods), and 5 decode
    steps, each against the JAX model on the same params."""
    jcfg, tcfg = _configs()
    assert tcfg.prefix == ("rglru", "rglru") and tcfg.n_periods == 2
    assert TT.model_def(tcfg).keys() == JT.model_def(jcfg).keys()
    jp, tp = _params(jcfg)
    toks = np.random.RandomState(6).randint(0, jcfg.vocab, (2, 21))
    want, _, _ = JT.forward(jp, jcfg, tokens=jnp.asarray(toks), mode="train")
    got, caches, _ = TT.forward(tp, tcfg, tokens=torch.as_tensor(toks),
                                mode="train")
    assert caches is None
    _close(got, want)

    # cache_len = window, as served (ROADMAP Queue C item 1); the prompt
    # is longer, so the ring is rolled.
    jl, jc = JT.prefill(jp, jcfg, jnp.asarray(toks), cache_len=16)
    tl, tc = TT.prefill(tp, tcfg, torch.as_tensor(toks), cache_len=16)
    _close(tl, jl)
    jleaves = jax.tree_util.tree_leaves_with_path(jc)
    tleaves = T.leaves_with_paths(tc)
    assert [tuple(k.key for k in p) for p, _ in jleaves] \
        == [p for p, _ in tleaves]
    for (_, j), (_, t) in zip(jleaves, tleaves):
        _close(t, j)
    assert tc["prefix0"]["h"].shape == (2, 64)
    assert tc["layers"]["m2"]["k"].shape == (2, 2, 16, 1, 16)   # window 16
    pos = np.array([21, 21])
    tok = np.asarray(jl).argmax(-1)
    for _ in range(5):
        jl, jc = JT.decode_step(jp, jcfg, jnp.asarray(tok, jnp.int32), jc,
                                jnp.asarray(pos, jnp.int32))
        tl, tc = TT.decode_step(tp, tcfg, torch.as_tensor(tok), tc,
                                torch.as_tensor(pos))
        _close(tl, jl)
        tok, pos = np.asarray(jl).argmax(-1), pos + 1
    for key in ("h", "conv"):
        _close(tc["prefix1"][key], jc["prefix1"][key])
        _close(tc["layers"]["m0"][key], jc["layers"]["m0"][key])


def test_reduced_model_in_bf16_keeps_the_cache_dtypes():
    """bf16 compute on fp32 params.  Over 8 layers, two of them
    recurrences, the bf16 roundings of either package move the logits
    ~2.5e-2 (relative norm) from an fp32 forward, and the two packages
    round in other places: so the port's bf16 logits are held within
    4e-2 of JAX's (phase 13's bf16 cap) and no farther from the fp32
    forward than JAX's are, give or take 10%.  The recurrent state ``h``
    stays fp32 and the conv taps are bf16, in the prefill's caches and the
    zero caches alike."""
    jcfg, tcfg = _configs("bfloat16")
    jp, tp = _params(jcfg, seed=1)
    toks = np.random.RandomState(7).randint(0, jcfg.vocab, (2, 13))
    want, _, _ = JT.forward(jp, jcfg, tokens=jnp.asarray(toks), mode="train")
    got, _, _ = TT.forward(tp, tcfg, tokens=torch.as_tensor(toks),
                           mode="train")
    exact, _, _ = TT.forward(tp, _configs()[1], tokens=torch.as_tensor(toks),
                             mode="train")
    assert _rel_norm(got, want) <= 4e-2
    assert _rel_norm(got, exact.numpy()) \
        <= 1.1 * _rel_norm(np.asarray(want), exact.numpy())
    _, jc = JT.prefill(jp, jcfg, jnp.asarray(toks), cache_len=16)
    _, tc = TT.prefill(tp, tcfg, torch.as_tensor(toks), cache_len=16)
    zeros = TT.init_cache(tcfg, 3, 16, device="cpu")
    for tree in (tc, zeros):
        assert tree["prefix0"]["h"].dtype == torch.float32
        assert tree["prefix0"]["conv"].dtype == torch.bfloat16
        assert tree["layers"]["m1"]["h"].dtype == torch.float32
        assert tree["layers"]["m2"]["k"].dtype == torch.bfloat16
    assert str(jc["prefix0"]["h"].dtype) == "float32"
    assert _rel_norm(tc["layers"]["m0"]["h"],
                     np.asarray(jc["layers"]["m0"]["h"])) <= 2e-2
    assert zeros["layers"]["m0"]["conv"].shape == (2, 3, 3, 64)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def _requests(make, vocab, lengths, max_new):
    rng = np.random.RandomState(8)
    return [make(uid=i, prompt=rng.randint(0, vocab, n).astype(np.int32),
                 max_new_tokens=m)
            for i, (n, m) in enumerate(zip(lengths, max_new))]


LENGTHS, MAX_NEW = [5, 9, 7, 3, 5], [4, 6, 3, 5, 40]


@functools.lru_cache(maxsize=None)
def _jax_greedy() -> dict:
    """Each request of ``_requests`` decoded greedily by the JAX model's
    forward over the whole sequence, token by token, as the engine at
    cache_len 16 would serve it (retired at its token count or a full
    cache)."""
    jcfg, _ = _configs()
    jp, _ = _params(jcfg, seed=2)
    # One compiled forward over 16 tokens: the model is causal, so the
    # logits at a position ignore the padding after it.
    fwd = jax.jit(lambda p, t: JT.forward(p, jcfg, tokens=t)[0])
    out = {}
    for r in _requests(JRequest, jcfg.vocab, LENGTHS, MAX_NEW):
        seq, toks = list(r.prompt), []
        while True:
            padded = np.zeros((1, 16), np.int32)
            padded[0, :len(seq)] = seq
            logits = fwd(jp, jnp.asarray(padded))
            toks.append(int(np.asarray(logits[0, len(seq) - 1]).argmax()))
            seq.append(toks[-1])
            if len(toks) >= r.max_new_tokens or len(seq) >= 16:
                break
        out[r.uid] = toks
    return out


@pytest.mark.parametrize("slots", [1, 2])
def test_engine_serves_the_jax_models_greedy_tokens(slots):
    """The slot engine (prompts of 3-9 tokens, cache_len = window = 16,
    one request retired on a full cache) emits, request by request, the
    tokens of greedy decoding with the JAX model's forward; the recurrent
    state of a slot is replaced, not carried, when a new request takes
    it.  (JAX's own engine decodes other tokens here: see the next
    test.)"""
    jcfg, tcfg = _configs()
    _, tp = _params(jcfg, seed=2)
    teng = ServingEngine(tp, tcfg, ServeConfig(slots=slots, cache_len=16),
                         device="cpu")
    for r in _requests(Request, tcfg.vocab, LENGTHS, MAX_NEW):
        teng.submit(r)
    got = {r.uid: r.output for r in teng.run_until_drained()}
    assert got == _jax_greedy()
    assert [len(got[i]) for i in range(4)] == MAX_NEW[:4]
    assert len(got[4]) == 16 - 5        # retired on a full cache
    assert teng.caches["prefix0"]["h"].dtype == torch.float32


def test_jax_decode_attends_unwritten_window_slots():
    """A fault of the reference the port does not share: before a
    windowed layer's ring cache fills, JAX's ``attn_decode`` gives its
    unwritten slots negative positions inside the window and attends to
    their zero keys, so its decode leaves its own forward.  The port's
    decode equals the JAX forward; the JAX decode does not."""
    jcfg, tcfg = _configs()
    jp, tp = _params(jcfg, seed=2)
    toks = np.random.RandomState(11).randint(0, jcfg.vocab, (1, 7))
    want, _, _ = JT.forward(jp, jcfg, tokens=jnp.asarray(toks))
    _, jc = JT.prefill(jp, jcfg, jnp.asarray(toks[:, :6]), cache_len=16)
    jl, _ = JT.decode_step(jp, jcfg, jnp.asarray(toks[:, 6], jnp.int32), jc,
                           jnp.asarray([6], jnp.int32))
    _, tc = TT.prefill(tp, tcfg, torch.as_tensor(toks[:, :6]), cache_len=16)
    tl, _ = TT.decode_step(tp, tcfg, torch.as_tensor(toks[:, 6]), tc,
                           torch.as_tensor([6]))
    _close(tl, np.asarray(want)[:, -1])
    assert _rel_norm(np.asarray(jl), np.asarray(want)[:, -1]) > 1e-2
    # The JAX engine's tokens follow its decode, not the greedy ones.
    jeng = JEngine(jp, jcfg, JServeConfig(slots=2, cache_len=16))
    for r in _requests(JRequest, jcfg.vocab, LENGTHS, MAX_NEW):
        jeng.submit(r)
    assert {r.uid: r.output for r in jeng.run_until_drained()} \
        != _jax_greedy()


def test_write_slot_writes_recurrent_rows_in_their_dtypes():
    _, tcfg = _configs("bfloat16")
    tp = TT.init_params(tcfg, device="cpu")
    eng = ServingEngine(tp, tcfg, ServeConfig(slots=3, cache_len=16),
                        device="cpu")
    one = T.tree_map(lambda t: torch.full_like(t, 1.5),
                     TT.init_cache(tcfg, 1, 16, device="cpu"))
    eng._write_slot(1, one)
    for tree, axis in ((eng.caches["prefix1"], 0),
                       (eng.caches["layers"]["m0"], 1)):
        for key, dtype in (("h", torch.float32), ("conv", torch.bfloat16)):
            t = tree[key]
            assert t.dtype == dtype
            rows = t.unbind(axis)
            assert bool((rows[1] == 1.5).all())
            assert not rows[0].any() and not rows[2].any()


def test_serve_lm_on_the_cpu_with_the_reduced_config():
    args = launch.build_parser().parse_args(
        ["--arch", NAME, "--device", "cpu", "--requests", "3",
         "--max-new-tokens", "4", "--slots", "2", "--reduced",
         "--cache-len", "16"])
    cfg = TReg.reduced_config(TReg.get(args.arch))
    engine, steps, seconds = launch.serve_lm(cfg, args)
    assert sorted(r.uid for r in engine.completed) == [0, 1, 2]
    assert all(len(r.output) == 4 for r in engine.completed)
    assert "served 3 requests / 12 tokens" in launch.report_lm(
        engine, steps, seconds)


# ---------------------------------------------------------------------------
# The registry
# ---------------------------------------------------------------------------

def test_full_config_matches_the_jax_registry():
    jspec, tspec = JReg.get(NAME), TReg.get(NAME)
    jcfg, tcfg = jspec.config, tspec.config
    assert tcfg.param_count() == jcfg.param_count()
    assert round(tcfg.param_count() / 1e9, 3) == 9.396
    for f in ("n_layers", "d_model", "n_heads", "kv_heads", "d_ff", "vocab",
              "hd", "act", "window", "embed_scale", "tie_embeddings",
              "pattern", "remat", "prefix", "n_periods"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    assert (tcfg.rglru.d_model, tcfg.rglru.d_rnn) == (4096, 4096)
    assert tcfg.dtype == torch.bfloat16 and tspec.family == "hybrid"
    assert tspec.long_context_ok and tspec.source == jspec.source
    jred, tred = JReg.reduced_config(jspec), TReg.reduced_config(tspec)
    assert (tred.rglru.d_model, tred.rglru.d_rnn, tred.window) \
        == (jred.rglru.d_model, jred.rglru.d_rnn, jred.window) == (64, 64, 16)
    assert tred.param_count() == jred.param_count()
    assert NAME in TReg.names()
