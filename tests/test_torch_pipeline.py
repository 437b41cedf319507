"""Port parity: ``repro_torch.distributed.pipeline``,
``repro_torch.models.pipelined`` and command-r-35b against the JAX package.

GPipe runs in-process on a 1-, 2- and 4-stage mesh of the CPU (a mesh may
repeat a device); JAX's ``gpipe_forward`` runs on its one-device mesh.
Inputs and the params' perturbations are made with numpy from a seed.
Tolerances: fp32 1e-5 relative to the largest value (the same math
summed in another order); the GPipe schedule against sequential
execution 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed.pipeline import bubble_fraction as j_bubble
from repro.distributed.pipeline import gpipe_forward as j_gpipe
from repro.models import registry as JReg
from repro.models import transformer as JT
from repro_torch.convert import params_from_jax
from repro_torch.distributed.pipeline import bubble_fraction, gpipe_forward
from repro_torch.distributed.sharding import Mesh
from repro_torch.models import pipelined as TP
from repro_torch.models import registry as TReg
from repro_torch.models import transformer as TT

torch.set_num_threads(2)

RTOL = 1e-5
ARCH = "command-r-35b"


def _close(got, want, rtol=RTOL):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got / scale, want / scale, rtol=rtol,
                               atol=rtol)


def _perturbed(tree, seed):
    """A numpy copy of a JAX param tree whose zero-init leaves are random."""
    rng = np.random.RandomState(seed)

    def go(node):
        if isinstance(node, dict):
            return {k: go(node[k]) for k in sorted(node)}
        a = np.array(node)
        if not a.any():
            a = (rng.randn(*a.shape) * 0.1).astype(a.dtype)
        return a
    return go(tree)


@pytest.fixture(scope="module")
def command_r():
    jcfg = JReg.reduced_config(JReg.get(ARCH))
    tcfg = TReg.reduced_config(TReg.get(ARCH))
    tree = _perturbed(JT.init_params(jax.random.PRNGKey(0), jcfg), 0)
    return (jcfg, tcfg, jax.tree_util.tree_map(jnp.asarray, tree),
            params_from_jax(tree, device="cpu"))


def _stage_fn(w, x):
    return torch.tanh(x @ w)


@pytest.mark.parametrize("stages,micro", [(1, 4), (2, 4), (4, 3), (4, 6)])
def test_gpipe_equals_sequential_execution(stages, micro):
    rng = np.random.RandomState(stages * 10 + micro)
    d = 8
    ws = torch.from_numpy((rng.randn(stages, d, d) / np.sqrt(d))
                          .astype(np.float32))
    xs = torch.from_numpy(rng.randn(micro, 2, d).astype(np.float32))
    mesh = Mesh(["cpu"] * stages, ("stage",))
    ys = gpipe_forward(_stage_fn, ws, xs, mesh=mesh)
    ref = xs
    for s in range(stages):
        ref = _stage_fn(ws[s], ref)
    assert ys.shape == ref.shape
    np.testing.assert_allclose(ys.numpy(), ref.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_gpipe_stage_runs_each_microbatch_once():
    calls = []

    def fn(w, x):
        calls.append(int(w))
        return x + w

    mesh = Mesh(["cpu"] * 3, ("stage",))
    xs = torch.zeros(5, 2)
    ys = gpipe_forward(fn, torch.tensor([1.0, 10.0, 100.0]), xs, mesh=mesh)
    # No bubble work: 5 microbatches x 3 stages, JAX's 7 ticks x 3 minus
    # the 6 discarded pairs.
    assert sorted(calls) == [1] * 5 + [10] * 5 + [100] * 5
    assert torch.equal(ys, torch.full((5, 2), 111.0))


def test_gpipe_matches_jax_on_one_stage():
    rng = np.random.RandomState(0)
    d = 8
    ws = (rng.randn(1, d, d) / np.sqrt(d)).astype(np.float32)
    xs = rng.randn(4, 2, d).astype(np.float32)
    want = j_gpipe(lambda w, x: jnp.tanh(x @ w), jnp.asarray(ws),
                   jnp.asarray(xs), mesh=jax.make_mesh((1,), ("stage",)))
    got = gpipe_forward(_stage_fn, torch.from_numpy(ws), torch.from_numpy(xs),
                        mesh=Mesh(["cpu"], ("stage",)))
    _close(got, want)


def test_bubble_fraction_matches_jax():
    for s, m in [(1, 8), (4, 4), (2, 30), (2, 4), (8, 1)]:
        assert bubble_fraction(s, m) == j_bubble(s, m)
    assert bubble_fraction(4, 4) == 3 / 7


def test_command_r_is_registered_at_its_published_widths():
    cfg = TReg.get(ARCH).config
    jcfg = JReg.get(ARCH).config
    for f in ("n_layers", "d_model", "n_heads", "kv_heads", "d_ff", "vocab",
              "head_dim", "norm", "act", "parallel_block", "qkv_bias",
              "mlp_bias", "use_rope", "rope_theta", "tie_embeddings",
              "logit_scale", "remat"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.d_ff,
            cfg.vocab) == (40, 8192, 64, 8, 22528, 256000)
    assert cfg.parallel_block and cfg.tie_embeddings
    assert cfg.logit_scale == 0.0625 and cfg.norm == "layer"
    assert cfg.param_count() == jcfg.param_count()
    assert ARCH in TReg.names()


def test_reduced_command_r_forward_prefill_decode_match_jax(command_r):
    jcfg, tcfg, jp, tp = command_r
    rng = np.random.RandomState(3)
    toks = rng.randint(0, jcfg.vocab, (2, 12)).astype(np.int32)
    want, _, _ = JT.forward(jp, jcfg, tokens=jnp.asarray(toks))
    with torch.no_grad():
        got, _, _ = TT.forward(tp, tcfg, tokens=torch.from_numpy(toks).long())
    _close(got, want)
    jl, jc = JT.prefill(jp, jcfg, jnp.asarray(toks[:, :8]), cache_len=16)
    with torch.no_grad():
        tl, tc = TT.prefill(tp, tcfg, torch.from_numpy(toks[:, :8]).long(),
                            cache_len=16)
    _close(tl, jl)
    pos = np.full((2,), 8, np.int32)
    for i in range(3):
        jl, jc = JT.decode_step(jp, jcfg, jnp.asarray(toks[:, 8 + i]), jc,
                                jnp.asarray(pos + i))
        with torch.no_grad():
            tl, tc = TT.decode_step(
                tp, tcfg, torch.from_numpy(toks[:, 8 + i]).long(), tc,
                torch.from_numpy(pos + i).long())
        _close(tl, jl)


@pytest.mark.parametrize("stages,micro", [(2, 2), (2, 4)])
def test_pipelined_forward_matches_jax_forward(command_r, stages, micro):
    """The reduced command-r-35b (4 layers, parallel block, tied embeddings,
    logit scale) through 2 stages of the CPU mesh."""
    jcfg, tcfg, jp, tp = command_r
    rng = np.random.RandomState(4)
    toks = rng.randint(0, jcfg.vocab, (4, 10)).astype(np.int32)
    want, _, _ = JT.forward(jp, jcfg, tokens=jnp.asarray(toks))
    with torch.no_grad():
        got = TP.pipelined_forward(
            tp, tcfg, torch.from_numpy(toks).long(),
            mesh=Mesh(["cpu"] * stages, ("stage",)), n_stages=stages,
            microbatches=micro)
        flat, _, _ = TT.forward(tp, tcfg, tokens=torch.from_numpy(toks).long())
    _close(got, want)
    _close(got, flat.numpy(), rtol=1e-6)


def test_pipelined_forward_asserts_as_jax(command_r):
    _, tcfg, _, tp = command_r
    toks = torch.zeros(4, 6, dtype=torch.long)
    mesh = Mesh(["cpu"] * 3, ("stage",))
    with pytest.raises(AssertionError):              # 2 periods, 3 stages
        TP.split_stage_params(tp, tcfg, 3)
    with pytest.raises(AssertionError):              # 4 % 3 microbatches
        TP.pipelined_forward(tp, tcfg, toks, mesh=Mesh(["cpu"] * 2,
                                                       ("stage",)),
                             n_stages=2, microbatches=3)
    prefixed = dataclasses.replace(tcfg, n_layers=5, pattern=("attn", "attn"))
    with pytest.raises(AssertionError, match="prefix"):
        TP.split_stage_params(tp, prefixed, 2)
    del mesh
    split = TP.split_stage_params(tp, tcfg, 2)
    assert split["m0"]["attn"]["wq"].shape[:2] == (2, tcfg.n_periods // 2)
