"""Port parity: the dense LM path of ``repro_torch`` (layers, transformer,
registry, serving engine, launcher) against the JAX package.

Inputs and the params' perturbations are made with numpy from a seed; JAX
params are converted with ``repro_torch.convert.params_from_jax``.
Tolerances: fp32 1e-5 relative to the largest value (the same math summed
in another order), bf16 2e-2 (relative norm).  The reduced configs are the
registry's ``reduced_config`` of tinyllama-1.1b, deepseek-7b and glm4-9b:
GQA 4/1, MHA, and glm4's QKV bias with half-rotary heads.
"""
import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro.models import registry as JReg
from repro.models import transformer as JT
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServingEngine as JEngine
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as launch
from repro_torch.models import layers as TL
from repro_torch.models import registry as TReg
from repro_torch.models import transformer as TT
from repro_torch.serve import Request, ServeConfig, ServingEngine

torch.set_num_threads(2)

RTOL = 1e-5
ARCHS = ["tinyllama-1.1b", "deepseek-7b", "glm4-9b"]


def _close(got, want, rtol=RTOL):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
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


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


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


def _configs(name, dtype=None):
    jcfg = JReg.reduced_config(JReg.get(name))
    tcfg = TReg.reduced_config(TReg.get(name))
    if dtype is not None:
        jcfg = dataclasses.replace(jcfg, dtype=getattr(jnp, dtype))
        tcfg = dataclasses.replace(tcfg, dtype=getattr(torch, dtype))
    return jcfg, tcfg


def _params(jcfg, seed=0):
    tree = _perturbed(JT.init_params(jax.random.PRNGKey(seed), jcfg), seed)
    return jax.tree_util.tree_map(jnp.asarray, tree), \
        params_from_jax(tree, device="cpu")


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def test_rms_norm_gains_one_plus_scale():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 32).astype(np.float32)
    scale = (rng.randn(32) * 0.3).astype(np.float32)
    want = JL.rms_norm(jnp.asarray(x), jnp.asarray(scale))
    got = TL.rms_norm(torch.from_numpy(x), torch.from_numpy(scale))
    _close(got, want)
    # Not torch.nn.RMSNorm's convention (gain = scale) but gain 1 + scale.
    nn = torch.nn.functional.rms_norm(torch.from_numpy(x), (32,),
                                      torch.from_numpy(1 + scale), eps=1e-6)
    _close(got, nn.numpy())
    assert not np.allclose(got.numpy(), torch.nn.functional.rms_norm(
        torch.from_numpy(x), (32,), torch.from_numpy(scale), eps=1e-6))


def test_layer_norm_matches_jax():
    rng = np.random.RandomState(1)
    x, s, b = (rng.randn(*shape).astype(np.float32)
               for shape in [(3, 4, 24), (24,), (24,)])
    params = {"scale": s, "bias": b}
    want = JL.apply_norm({k: jnp.asarray(v) for k, v in params.items()},
                         jnp.asarray(x), "layer")
    got = TL.apply_norm({k: torch.from_numpy(v) for k, v in params.items()},
                        torch.from_numpy(x), "layer")
    _close(got, want)


@pytest.mark.parametrize("fraction", [1.0, 0.5])
def test_apply_rope_matches_jax(fraction):
    rng = np.random.RandomState(2)
    x = rng.randn(2, 9, 3, 16).astype(np.float32)
    pos = rng.randint(0, 5000, (2, 9)).astype(np.int32)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta=10000.0,
                         fraction=fraction)
    got = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                        theta=10000.0, fraction=fraction)
    _close(got, want)
    if fraction < 1:       # the second half of each head passes unrotated
        np.testing.assert_array_equal(got.numpy()[..., 8:], x[..., 8:])


def test_qkv_with_bias_and_half_rope_matches_jax():
    cfg = dict(d_model=32, n_heads=4, kv_heads=2, head_dim=8,
               qkv_bias=True, rope_fraction=0.5)
    jcfg, tcfg = JL.AttnConfig(**cfg), TL.AttnConfig(**cfg)
    tree = _perturbed(JL.init_tree(jax.random.PRNGKey(0),
                                   JL.attn_def(jcfg)), 3)
    rng = np.random.RandomState(3)
    x = rng.randn(2, 7, 32).astype(np.float32)
    pos = np.broadcast_to(np.arange(7, dtype=np.int32), (2, 7))
    want = JL._qkv({k: jnp.asarray(v) for k, v in tree.items()},
                   jnp.asarray(x), jcfg, jnp.asarray(pos))
    got = TL._qkv(params_from_jax(tree, device="cpu"), torch.from_numpy(x),
                  tcfg, torch.from_numpy(pos.copy()))
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("impl,window,softcap", [
    ("dense", None, None), ("dense", 8, 5.0), ("chunked", None, 5.0),
    ("chunked", 8, None), ("window", 8, None), ("auto", None, None)])
def test_attention_matches_jax(impl, window, softcap):
    rng = np.random.RandomState(4)
    b, s, kv, g, dh = 2, 40, 2, 2, 8
    q = rng.randn(b, s, kv, g, dh).astype(np.float32)
    k, v = (rng.randn(b, s, kv, dh).astype(np.float32) for _ in range(2))
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    kw = dict(window=window, softcap=softcap, impl=impl)
    want = JL.attention(*(jnp.asarray(a) for a in (q, k, v, pos, pos)), **kw)
    got = TL.attention(*(torch.from_numpy(np.array(a))
                         for a in (q, k, v, pos, pos)), **kw)
    _close(got, want)


@pytest.mark.parametrize("name", sorted(TL.ACTS))
def test_activation_matches_jax(name):
    x = np.linspace(-4, 4, 101).astype(np.float32)
    jax_acts = dict(gelu=jax.nn.gelu, silu=jax.nn.silu, relu=jax.nn.relu,
                    relu2=JL.ACTS["relu2"])
    _close(TL.ACTS[name](torch.from_numpy(x)), jax_acts[name](x))


def test_attn_apply_matches_jax():
    cfg = dict(d_model=32, n_heads=4, kv_heads=1, head_dim=8, out_bias=True,
               qk_norm=True, window=5, softcap=10.0)
    jcfg, tcfg = JL.AttnConfig(**cfg), TL.AttnConfig(**cfg)
    tree = _perturbed(JL.init_tree(jax.random.PRNGKey(2),
                                   JL.attn_def(jcfg)), 4)
    x = np.random.RandomState(4).randn(2, 9, 32).astype(np.float32)
    pos = np.broadcast_to(np.arange(9, dtype=np.int32), (2, 9))
    want = JL.attn_apply({k: jnp.asarray(v) for k, v in tree.items()},
                         jnp.asarray(x), jcfg, positions=jnp.asarray(pos))
    got = TL.attn_apply(params_from_jax(tree, device="cpu"),
                        torch.from_numpy(x), tcfg,
                        positions=torch.from_numpy(pos.copy()))
    _close(got, want)


@pytest.mark.parametrize("kind,bias", [("swiglu", False), ("geglu", True),
                                       ("gelu", True), ("relu2", False)])
def test_mlp_apply_matches_jax(kind, bias):
    jcfg = JL.MLPConfig(d_model=16, d_ff=48, kind=kind, bias=bias)
    tcfg = TL.MLPConfig(d_model=16, d_ff=48, kind=kind, bias=bias)
    tree = _perturbed(JL.init_tree(jax.random.PRNGKey(1), JL.mlp_def(jcfg)),
                      5)
    x = np.random.RandomState(5).randn(2, 3, 16).astype(np.float32)
    want = JL.mlp_apply({k: jnp.asarray(v) for k, v in tree.items()},
                        jnp.asarray(x), jcfg)
    got = TL.mlp_apply(params_from_jax(tree, device="cpu"),
                       torch.from_numpy(x), tcfg)
    _close(got, want)


# ---------------------------------------------------------------------------
# The reduced dense models
# ---------------------------------------------------------------------------

# Options of ModelConfig the three dense configs leave off: tied and
# soft-capped logits, layer norm, parallel blocks, biases, qk-norm and a
# sliding window, whose cache is a ring (prefill rolls it, decode wraps).
VARIANTS = {
    "tied_layernorm_parallel": dict(
        tie_embeddings=True, norm="layer", parallel_block=True, act="gelu",
        mlp_bias=True, out_bias=True, qk_norm=True, embed_scale=True,
        attn_softcap=20.0, logits_softcap=30.0, logit_scale=0.5),
    "window_ring_cache": dict(window=8, act="relu2"),
}


def _as_ring(jk, n_pos: int, ring: int):
    """JAX's K/V cache (position p at row p % rows, rows = cache_len) as
    the port's: a windowed layer keeps a ring of ``min(cache_len,
    window)`` rows, position p at row p % ring; unwritten rows zero."""
    jk = np.asarray(jk, np.float32)
    rows = jk.shape[2]
    out = np.zeros(jk.shape[:2] + (ring,) + jk.shape[3:], np.float32)
    for p in range(max(0, n_pos - ring), n_pos):
        out[:, :, p % ring] = jk[:, :, p % rows]
    return out


@pytest.mark.parametrize("name", ARCHS + sorted(VARIANTS))
def test_reduced_model_matches_jax(name):
    """forward (train) logits, prefill logits and caches, and 5 decode
    steps, each against the JAX model on the same params.  A windowed
    layer's cache is the port's ring of ``min(cache_len, window)`` rows,
    which the engine's slots hold (JAX packs ``cache_len`` rows): it is
    held against JAX's rows of the same positions."""
    if name in VARIANTS:
        jcfg, tcfg = _configs("tinyllama-1.1b")
        jcfg = dataclasses.replace(jcfg, **VARIANTS[name])
        tcfg = dataclasses.replace(tcfg, **VARIANTS[name])
    else:
        jcfg, tcfg = _configs(name)
    assert TT.model_def(tcfg).keys() == JT.model_def(jcfg).keys()
    jp, tp = _params(jcfg)
    toks = np.random.RandomState(6).randint(0, jcfg.vocab, (2, 11))
    want, _, _ = JT.forward(jp, jcfg, tokens=jnp.asarray(toks), mode="train")
    got, caches, _ = TT.forward(tp, tcfg, tokens=torch.as_tensor(toks),
                                mode="train")
    assert caches is None
    _close(got, want)

    jl, jc = JT.prefill(jp, jcfg, jnp.asarray(toks), cache_len=24)
    tl, tc = TT.prefill(tp, tcfg, torch.as_tensor(toks), cache_len=24)
    _close(tl, jl)
    ring = min(24, tcfg.window) if tcfg.window else 24
    for key in ("k", "v"):
        _close(tc["layers"]["m0"][key],
               _as_ring(jc["layers"]["m0"][key], 11, ring))
    pos = np.array([11, 11])
    tok = np.asarray(jl).argmax(-1)
    for _ in range(5):
        jl, jc = JT.decode_step(jp, jcfg, jnp.asarray(tok, jnp.int32), jc,
                                jnp.asarray(pos, jnp.int32))
        tl, tc = TT.decode_step(tp, tcfg, torch.as_tensor(tok), tc,
                                torch.as_tensor(pos))
        _close(tl, jl)
        tok, pos = np.asarray(jl).argmax(-1), pos + 1
    _close(tc["layers"]["m0"]["k"], _as_ring(jc["layers"]["m0"]["k"], 16,
                                             ring))


def test_reduced_model_in_bf16_within_tolerance():
    """bf16 compute on fp32 params (the served dtype): forward logits and
    the bf16 prefill caches within 2e-2 of JAX (relative norm); the caches
    convert as bf16."""
    jcfg, tcfg = _configs("tinyllama-1.1b", dtype="bfloat16")
    jp, tp = _params(jcfg, seed=1)
    toks = np.random.RandomState(7).randint(0, jcfg.vocab, (2, 13))
    want, _, _ = JT.forward(jp, jcfg, tokens=jnp.asarray(toks), mode="train")
    got, _, _ = TT.forward(tp, tcfg, tokens=torch.as_tensor(toks),
                           mode="train")
    assert got.dtype == torch.float32
    assert _rel_norm(got, want) <= 2e-2
    _, jc = JT.prefill(jp, jcfg, jnp.asarray(toks), cache_len=16)
    _, tc = TT.prefill(tp, tcfg, torch.as_tensor(toks), cache_len=16)
    conv = params_from_jax(_np_tree(jc), device="cpu")
    assert conv["layers"]["m0"]["k"].dtype == torch.bfloat16
    assert tc["layers"]["m0"]["k"].dtype == torch.bfloat16
    for key in ("k", "v"):
        assert _rel_norm(tc["layers"]["m0"][key],
                         np.asarray(jc["layers"]["m0"][key], np.float32)) \
            <= 2e-2


def test_converted_bf16_leaves_keep_their_bits():
    jcfg, tcfg = _configs("glm4-9b", dtype="bfloat16")
    jc = JT.init_cache(jcfg, 2, 8)
    jc = jax.tree_util.tree_map(
        lambda a: (a + jnp.arange(a.size, dtype=jnp.float32)
                   .reshape(a.shape) / 7).astype(a.dtype), jc)
    got = params_from_jax(_np_tree(jc), device="cpu")
    want = np.asarray(jc["layers"]["m0"]["v"]).view(np.uint16)
    t = got["layers"]["m0"]["v"]
    assert t.dtype == torch.bfloat16 and t.shape == want.shape
    np.testing.assert_array_equal(t.view(torch.int16).numpy()
                                  .view(np.uint16), want)
    zeros = TT.init_cache(tcfg, 2, 8, device="cpu")
    assert zeros["layers"]["m0"]["v"].shape == t.shape
    assert zeros["layers"]["m0"]["v"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def _requests(make, vocab, lengths, max_new):
    rng = np.random.RandomState(8)
    return [make(uid=i, prompt=rng.randint(0, vocab, n).astype(np.int32),
                 max_new_tokens=m)
            for i, (n, m) in enumerate(zip(lengths, max_new))]


@pytest.mark.parametrize("slots", [1, 2])
def test_engine_serves_the_jax_engines_tokens(slots):
    """Both engines on the same params and requests (prompts of 5 and 9
    tokens, 3-7 new tokens, one hitting a full cache) emit the same
    tokens per request."""
    jcfg, tcfg = _configs("glm4-9b")
    jp, tp = _params(jcfg, seed=2)
    lengths, max_new = [5, 9, 5, 9], [3, 7, 5, 40]
    jeng = JEngine(jp, jcfg, JServeConfig(slots=slots, cache_len=24))
    teng = ServingEngine(tp, tcfg, ServeConfig(slots=slots, cache_len=24),
                         device="cpu")
    for r in _requests(JRequest, jcfg.vocab, lengths, max_new):
        jeng.submit(r)
    for r in _requests(Request, tcfg.vocab, lengths, max_new):
        teng.submit(r)
    want = {r.uid: r.output for r in jeng.run_until_drained()}
    got = {r.uid: r.output for r in teng.run_until_drained()}
    assert got == want
    assert [len(got[i]) for i in range(3)] == max_new[:3]
    assert len(got[3]) == 24 - 9        # retired on a full cache
    assert all(r.done for r in teng.completed) and not teng.queue


def test_serve_lm_on_the_cpu_with_a_reduced_config():
    args = launch.build_parser().parse_args(
        ["--arch", "tinyllama-1.1b", "--device", "cpu", "--requests", "3",
         "--max-new-tokens", "4", "--slots", "2"])
    assert (args.cache_len, launch.build_parser().parse_args(
        ["--arch", "tinyllama-1.1b"]).max_new_tokens) == (128, 16)
    cfg = TReg.reduced_config(TReg.get(args.arch))
    engine, steps, seconds = launch.serve_lm(cfg, args)
    assert sorted(r.uid for r in engine.completed) == [0, 1, 2]
    assert all(len(r.output) == 4 for r in engine.completed)
    lengths = [len(r.prompt) for r in engine.completed]
    assert all(4 <= n < 12 for n in lengths)
    assert steps >= 3 * 3 // 2 and seconds > 0
    assert "served 3 requests / 12 tokens" in launch.report_lm(
        engine, steps, seconds)


# ---------------------------------------------------------------------------
# Registry, configs, device rule
# ---------------------------------------------------------------------------

# The families ported after the dense ones: RWKV-6, MoE,
# multi-codebook heads and frontend embeddings (each has its own file of
# parity tests beside this one).
LATER = ["rwkv6-3b", "dbrx-132b", "grok-1-314b", "musicgen-medium",
         "pixtral-12b"]


@pytest.mark.parametrize("name", ARCHS + LATER)
def test_full_configs_match_the_jax_registry(name):
    jcfg, tcfg = JReg.get(name).config, TReg.get(name).config
    assert tcfg.param_count() == jcfg.param_count()
    for f in ("n_layers", "d_model", "n_heads", "kv_heads", "d_ff", "vocab",
              "hd", "qkv_bias", "rope_fraction", "tie_embeddings", "window"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    assert tcfg.dtype == torch.bfloat16
    assert TReg.get(name).shapes == {
        k: TReg.ShapeSpec(**v.__dict__)
        for k, v in JReg.get(name).shapes.items()}


def test_registry_holds_every_jax_lm_but_command_r():
    """Every LM of the JAX registry is in the port's, command-r-35b too
    since the port has its mesh (``test_torch_pipeline.py`` holds it);
    an unknown arch raises naming the registry."""
    jax_lms = {n for n in JReg.names()
               if isinstance(JReg.get(n).config, JT.ModelConfig)}
    assert set(TReg.names()) == jax_lms
    assert set(ARCHS + LATER + ["recurrentgemma-9b", "command-r-35b"]) \
        == set(TReg.names())
    assert TReg.get("command-r-35b").config.d_model == 8192
    with pytest.raises(KeyError, match="not in the port's registry"):
        TReg.get("command-r-36b")


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    cfg = TReg.reduced_config(TReg.get("deepseek-7b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TT.init_params(cfg)
    params = TT.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(params, cfg, ServeConfig())
    args = argparse.Namespace(seed=0, device=None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch.serve_lm(cfg, args)
    from repro_torch.launch import train as train_launch
    args = train_launch.build_parser().parse_args(
        ["--arch", "tinyllama-1.1b", "--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_launch.train_lm(TReg.get(args.arch).config, args)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TT.init_params(TReg.reduced_config(TReg.get("recurrentgemma-9b")))
