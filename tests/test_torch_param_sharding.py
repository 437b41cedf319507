"""Port parity: the LM's params laid out on the device mesh by their specs
(``distributed.sharding.place``), the tensor-parallel layer paths
(heads, ``ff`` and vocab over 'model', FSDP over 'embed'; MoE per expert
shard or ``ff`` block with a split batch, the RG-LRU per ``rnn`` block,
RWKV-6 per head shard or with its heads met), the optimizer and
error-feedback state placed like their params (Adafactor's factored
moments reduced across blocks), and the Trainer on a mesh, against the
flat port and the JAX package.

Every mesh repeats the CPU (``Mesh`` of one device, in-process), the
single-controller stand-in of a multi-device mesh.  GSPMD does not change
the function, so JAX's single-device results are the reference, as in
the port's other mesh tests.  Tolerances: placement round trips
``torch.equal``; losses 1e-5 relative and gradients 1e-4 relative norm
per leaf (``test_torch_lm_train``'s); Trainer params 1e-5 relative norm
of the flat port (the shards change only summation orders) and 1e-4 of
JAX's Trainer.
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
from repro.distributed import sharding as JS
from repro.models import layers as JL
from repro.models import registry as JReg
from repro.models import transformer as JT
from repro.train import Trainer as JTrainer
from repro.train import TrainerConfig as JTrainerConfig
from repro_torch import optim as TOPT
from repro_torch import tree as T
from repro_torch.convert import params_from_jax
from repro_torch.data import LMDataConfig, lm_batch
from repro_torch.distributed import sharding as TS
from repro_torch.launch import dryrun
from repro_torch.launch import train as launch
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import layers as TL
from repro_torch.models import registry as TReg
from repro_torch.models import transformer as TT
from repro_torch.train import Trainer, TrainerConfig

torch.set_num_threads(2)

MESHES = [(1, 2), (2, 2), (1, 4), (2, 4), (1, 3)]


def _mesh(shape):
    devs = np.empty(shape, dtype=object)
    devs[...] = torch.device("cpu")
    return TS.Mesh(devs, ("data", "model"))


def _shaped(name, **kw):
    """A registry LM's reduced config with some widths changed: both
    packages' configs."""
    return (dataclasses.replace(JReg.reduced_config(JReg.get(name)), **kw),
            dataclasses.replace(TReg.reduced_config(TReg.get(name)), **kw))


# Reduced configs of the shapes the sharding rules treat apart: GQA with
# KV 1 (tinyllama), KV 2 (glm4-shaped), KV = heads (deepseek-7b), 6 heads
# that 4-way and 3-way axes cannot split (musicgen-shaped, 4 codebooks)
# and tied embeddings (command-r-shaped).
CONFIGS = {
    "tinyllama": lambda: _shaped("tinyllama-1.1b"),
    "glm4_kv2": lambda: _shaped("glm4-9b", n_heads=8, kv_heads=2,
                                head_dim=8),
    "deepseek": lambda: _shaped("deepseek-7b"),
    "musicgen_6heads": lambda: _shaped("musicgen-medium", n_heads=6,
                                       kv_heads=6, head_dim=8, d_model=48),
    "command_r_tied": lambda: _shaped("command-r-35b"),
    # MoE (4 experts, top 2): dbrx's experts -> model (expert-parallel),
    # grok's tensor-parallel experts (GeGLU); the RG-LRU hybrid (d_rnn
    # 64); RWKV-6 (4 heads of 16).
    "dbrx_ep": lambda: _shaped("dbrx-132b"),
    "grok_tp": lambda: _shaped("grok-1-314b"),
    "recurrentgemma": lambda: _shaped("recurrentgemma-9b"),
    "rwkv6": lambda: _shaped("rwkv6-3b"),
}
# Rules a config is placed and run under (the registry's overrides).
RULES = {"dbrx_ep": {**TS.DEFAULT_RULES, "experts": "model"}}


def _perturbed(tree, seed):
    """A numpy copy of a JAX param tree whose zero-init leaves are
    random, so the test sees them."""
    rng = np.random.RandomState(seed)

    def go(node):
        if isinstance(node, dict):
            return {k: go(node[k]) for k in sorted(node)}
        a = np.array(node)
        if not a.any():
            a = (rng.randn(*a.shape) * 0.1).astype(a.dtype)
        return a
    return go(tree)


def _params(jcfg, seed=0):
    tree = _perturbed(JT.init_params(jax.random.PRNGKey(seed), jcfg), seed)
    return jax.tree_util.tree_map(jnp.asarray, tree), \
        params_from_jax(tree, device="cpu")


def _specs(tcfg, mesh, rules=None):
    with TS.use_rules(rules, mesh=mesh):
        return TL.spec_tree(TT.param_defs(tcfg))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _batch(tcfg, b, s, seed, mask=True):
    rng = np.random.RandomState(seed)
    shape = (b, s) if tcfg.codebooks == 1 else (b, s, tcfg.codebooks)
    out = {"tokens": rng.randint(0, tcfg.vocab, shape).astype(np.int32),
           "targets": rng.randint(0, tcfg.vocab, shape).astype(np.int32)}
    if mask:
        out["mask"] = (rng.rand(b, s) < 0.7).astype(np.float32)
    return out


def _placed_grads(placed, fn):
    """(value, gradient tree laid out as ``placed``) of ``fn(params)``,
    the gradient of every block."""
    tree = T.tree_map(lambda t: t.detach().requires_grad_(True), placed)
    blocks = T.leaves(tree)
    value = fn(tree)
    loss = value[0] if isinstance(value, tuple) else value
    gs = torch.autograd.grad(loss, blocks, allow_unused=True)
    by_id = {id(b): torch.zeros_like(b) if g is None else g
             for b, g in zip(blocks, gs)}
    return value, T.tree_map(lambda b: by_id[id(b)], tree)


def _storages(tree):
    return [b.untyped_storage().data_ptr() for b in T.leaves(tree)]


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_place_and_gather_round_trip(name, shape):
    """Every leaf placed by its spec and gathered back is ``torch.equal``
    to it; no two blocks (nor a block and its source) share storage; a
    block lies where its spec puts it; ``placement_summary`` per device
    equals ``tree_shard_bytes`` of the same specs, and the first
    position holds exactly that."""
    _, tcfg = CONFIGS[name]()
    params = TT.init_params(tcfg, seed=3, device="cpu")
    mesh = _mesh(shape)
    specs = _specs(tcfg, mesh)
    placed = TS.place_tree(params, specs, mesh)
    for (path, p), (_, q) in zip(
            T.leaves_with_paths(params),
            T.leaves_with_paths(TS.gather_tree(placed))):
        assert torch.equal(p, q), path
    ptrs = _storages(placed)
    assert len(set(ptrs)) == len(ptrs)
    assert not set(ptrs) & set(_storages(params))
    summary = TS.placement_summary(placed, mesh)
    meta = TL.meta_tree(TT.param_defs(tcfg))
    want = dryrun.tree_shard_bytes(meta, specs, mesh)
    assert summary["per_device"] == want
    assert summary["held"][(0, 0)] == want
    assert sum(summary["held"].values()) == sum(
        p.numel() * 4 for p in T.leaves(params))
    for path, x in T.leaves_with_paths(placed, is_leaf=TS.is_placed):
        if TS.is_placed(x):
            assert "/".join(path) in summary["split"]
            for index, blk in x.blocks.items():
                assert tuple(blk.shape) == x.block_shape()
                assert blk.device == x.device_of(index)
        else:
            assert "/".join(path) in summary["whole"]


def test_placement_on_both_axes_gives_each_device_an_eighth():
    """tinyllama-shaped leaves on (data=2, model=4): a leaf split over
    both axes puts 1/8 of itself on each of the 8 positions."""
    _, tcfg = CONFIGS["tinyllama"]()
    tcfg = dataclasses.replace(tcfg, n_heads=8, kv_heads=4, head_dim=8)
    params = TT.init_params(tcfg, seed=0, device="cpu")
    mesh = _mesh((2, 4))
    specs = _specs(tcfg, mesh)
    placed = TS.place_tree(params, specs, mesh)
    wq = placed["layers"]["m0"]["attn"]["wq"]
    assert wq.spec == (None, "data", "model", None)
    assert wq.grid == (1, 2, 4, 1) and len(wq.blocks) == 8
    held = TS.placement_summary({"wq": wq})["held"]
    assert set(held.values()) == {wq.shape.numel() * 4 // 8}
    assert len(held) == 8


def test_gather_is_differentiable_and_takes_blocks_at_coordinates():
    mesh = _mesh((2, 4))
    t = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
    p = TS.place(t, ("data", "model"), mesh)
    assert torch.equal(TS.gather(p, at={"model": 1}), t[:, 3:6])
    assert torch.equal(TS.gather(p, at={"data": 1, "model": 3}),
                       t[4:, 9:])
    with pytest.raises(ValueError, match="divide"):
        TS.place(t, ("data", None), _mesh((3, 1)))
    leaf = T.tree_map(lambda b: b.requires_grad_(True), p)
    (TS.gather(leaf, at={"model": 2}) * 2).sum().backward()
    for index, blk in leaf.blocks.items():
        want = 2.0 if index[1] == 2 else None
        assert (blk.grad is None) if want is None \
            else bool((blk.grad == want).all())
    whole = TS.place(t, (None, None), mesh)
    assert isinstance(whole, torch.Tensor) and torch.equal(whole, t)
    assert whole.untyped_storage().data_ptr() \
        != t.untyped_storage().data_ptr()


# ---------------------------------------------------------------------------
# The tensor-parallel rules, against JAX's
# ---------------------------------------------------------------------------

LMS = [n for n in TReg.names()
       if not n.startswith("resnet50_dcn")]


@pytest.mark.parametrize("tp", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("name", LMS)
def test_tp_rules_equal_jax(name, tp):
    """``heads_tp_size``, ``effective_kv_heads`` and
    ``seq_parallel_attention`` of every registry LM on a (data=16,
    model=tp) mesh equal JAX's under a stand-in mesh of the same axes."""
    jcfg = JReg.get(name).config
    tcfg = TReg.get(name).config
    if not hasattr(tcfg, "attn_cfg"):
        pytest.fail(f"{name} is not an LM")
    mesh = _mesh((16, tp))
    with JS.use_rules(mesh=mesh):
        want = (JL.heads_tp_size(), JL.effective_kv_heads(jcfg.attn_cfg()),
                JL.seq_parallel_attention(jcfg.attn_cfg()))
    with TS.use_rules(mesh=mesh):
        got = (TL.heads_tp_size(), TL.effective_kv_heads(tcfg.attn_cfg()),
               TL.seq_parallel_attention(tcfg.attn_cfg()))
    assert got == want
    assert TL.heads_tp_size() == 1          # off-mesh
    assert TL.effective_kv_heads(tcfg.attn_cfg()) == tcfg.kv_heads


# ---------------------------------------------------------------------------
# Forward, loss and gradient on a mesh, against JAX
# ---------------------------------------------------------------------------

LOSS_CASES = [("tinyllama", (2, 2)), ("tinyllama", (1, 4)),
              ("glm4_kv2", (2, 4)), ("deepseek", (2, 4)),
              ("musicgen_6heads", (1, 4)), ("command_r_tied", (1, 4)),
              ("dbrx_ep", (2, 2)), ("grok_tp", (2, 2)),
              ("recurrentgemma", (1, 4)), ("rwkv6", (1, 2)),
              ("rwkv6", (1, 8))]

# How each case's MoE, RG-LRU and RWKV-6 blocks run (``shard_plan``).
PLANS = {("dbrx_ep", (2, 2)): {"moe": "2 expert shards of 2 experts",
                               "data_shards": 2},
         ("grok_tp", (2, 2)): {"moe": "2 ff blocks of 64 a expert",
                               "data_shards": 2},
         ("recurrentgemma", (1, 4)): {"rglru": "4 rnn blocks of 16"},
         ("rwkv6", (1, 2)): {"rwkv6": "2 head shards of 2 heads; 2 ff "
                                      "blocks of 64"},
         ("rwkv6", (1, 8)): {"rwkv6": "8 channel blocks of 8, the heads "
                                      "met for the WKV; 8 ff blocks of 16"}}


@pytest.mark.parametrize("name,shape", LOSS_CASES,
                         ids=[f"{n}-{s[0]}x{s[1]}" for n, s in LOSS_CASES])
def test_loss_and_gradient_on_a_mesh_equal_jax(name, shape):
    """Placed params on a mesh: the forward logits, ``loss_fn`` (its CE
    and MoE aux) and its gradient (gathered) against JAX's single-device
    ``jax.value_and_grad`` (loss 1e-5, each leaf 1e-4), and the layers
    ran per shard: the heads, ``ff`` or vocab split where they divide,
    query rows where the heads do not, the MoE, RG-LRU and RWKV-6 blocks
    as ``PLANS`` says (none of them whole)."""
    jcfg, tcfg = CONFIGS[name]()
    jp, tp = _params(jcfg, seed=1)
    batch = _batch(tcfg, 4, 19, seed=4)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, jaux), jg = jax.value_and_grad(
        lambda p: JT.loss_fn(p, jcfg, jb), has_aux=True)(jp)
    jlogits = JT.forward(jp, jcfg, tokens=jb["tokens"])[0]
    mesh = _mesh(shape)
    rules = RULES.get(name)
    placed = TS.place_tree(tp, _specs(tcfg, mesh, rules), mesh)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with TS.use_rules(rules, mesh=mesh):
        (tloss, taux), tg = _placed_grads(
            placed, lambda p: TT.loss_fn(p, tcfg, tb))
        tlogits = TT.forward(placed, tcfg, tokens=tb["tokens"])[0]
        seq_par = TL.seq_parallel_attention(tcfg.attn_cfg())
        plan = TT.shard_plan(tcfg, 4)
    assert seq_par == (tcfg.n_heads % shape[1] != 0)
    assert plan["whole"] == []
    for key, want in PLANS.get((name, shape), {}).items():
        assert plan[key] == want, key
    assert abs(float(tloss) - float(jloss)) <= 1e-5 * float(jloss)
    assert abs(float(taux["ce"]) - float(jaux["ce"])) <= 1e-5 * float(
        jaux["ce"])
    assert abs(float(taux["moe_aux"]) - float(jaux["moe_aux"])) \
        <= 1e-5 * abs(float(jaux["moe_aux"]))
    assert _rel(tlogits.detach(), jlogits) <= 1e-5
    jleaves = jax.tree_util.tree_leaves_with_path(jg)
    tleaves = T.leaves(TS.gather_tree(tg))
    assert len(jleaves) == len(tleaves)
    for (path, jleaf), g in zip(jleaves, tleaves):
        assert _rel(g, jleaf) <= 1e-4, jax.tree_util.keystr(path)


def test_prefill_cache_replicates_kv_as_repeat_interleave():
    """tinyllama-shaped (8 heads, KV 2) on (1, 8): KV 2 does not split 8
    ways, so each query head's shard carries its KV head: the prefill
    cache is ``repeat_interleave`` of the flat one (not ``repeat``), the
    logits and three decode steps equal the flat ones."""
    _, tcfg = CONFIGS["tinyllama"]()
    tcfg = dataclasses.replace(tcfg, n_heads=8, kv_heads=2, head_dim=8)
    params = TT.init_params(tcfg, seed=2, device="cpu")
    toks = torch.from_numpy(_batch(tcfg, 2, 12, seed=1)["tokens"])
    mesh = _mesh((1, 8))
    placed = TS.place_tree(params, _specs(tcfg, mesh), mesh)
    with torch.no_grad():
        flat_logits, flat_c = TT.prefill(params, tcfg, toks, cache_len=16)
        with TS.use_rules(mesh=mesh):
            assert TL.effective_kv_heads(tcfg.attn_cfg()) == 8
            logits, caches = TT.prefill(placed, tcfg, toks, cache_len=16)
            zero = TT.init_cache(tcfg, 2, 16, device="cpu")
        assert zero["layers"]["m0"]["k"].shape[3] == 8
        for key in ("k", "v"):
            got = caches["layers"]["m0"][key]
            want = torch.repeat_interleave(flat_c["layers"]["m0"][key], 4,
                                           dim=3)
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
            assert not torch.allclose(
                got, flat_c["layers"]["m0"][key].repeat(1, 1, 1, 4, 1))
        scale = float(flat_logits.abs().max())
        assert float((logits - flat_logits).abs().max()) <= 1e-5 * scale
        pos = torch.full((2,), 12)
        nxt = flat_logits.argmax(-1)
        for _ in range(3):
            want, flat_c = TT.decode_step(params, tcfg, nxt, flat_c, pos)
            with TS.use_rules(mesh=mesh):
                got, caches = TT.decode_step(placed, tcfg, nxt, caches, pos)
            assert float((got - want).abs().max()) <= 1e-5 * float(
                want.abs().max())
            nxt, pos = want.argmax(-1), pos + 1


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_recomputes_under_the_forward_mesh_on_another_thread(remat):
    """A checkpointed period recomputes in the backward, which a CUDA
    device's autograd engine runs on a thread of its own, where no rules
    are set: it recomputes under its forward's rules, mesh and shard
    coordinates all the same (here the backward runs on a new thread)."""
    import threading
    _, tcfg = CONFIGS["tinyllama"]()
    tcfg = dataclasses.replace(tcfg, remat=remat)
    params = TT.init_params(tcfg, seed=4, device="cpu")
    mesh = _mesh((2, 2))
    placed = T.tree_map(lambda t: t.requires_grad_(True),
                        TS.place_tree(params, _specs(tcfg, mesh), mesh))
    blocks = T.leaves(placed)
    tb = {k: torch.from_numpy(v)
          for k, v in _batch(tcfg, 2, 12, seed=2).items()}
    with TS.use_rules(mesh=mesh):
        same = torch.autograd.grad(TT.loss_fn(placed, tcfg, tb)[0], blocks)
        loss = TT.loss_fn(placed, tcfg, tb)[0]
    out = {}
    worker = threading.Thread(
        target=lambda: out.update(g=torch.autograd.grad(loss, blocks)))
    worker.start()
    worker.join()
    assert len(out["g"]) == len(same)
    for a, b in zip(out["g"], same):
        assert torch.equal(a, b)


def test_vocab_parallel_embedding_is_exact():
    """Each vocab block looks up its ids and masks the rest: the sum of
    the blocks' rows is bit-equal to the flat lookup, in bf16 too."""
    emb = torch.randn(40, 6)
    ids = torch.tensor([[0, 9, 10, 39], [20, 21, 5, 30]])
    mesh = _mesh((1, 4))
    placed = TS.place(emb, ("model", None), mesh)
    for dtype in (torch.float32, torch.bfloat16):
        with TS.use_rules(mesh=mesh):
            got = TL.embed_rows(placed, ids, dtype)
        assert torch.equal(got, emb[ids].to(dtype))


def test_global_norm_counts_a_replicated_leaf_once():
    """``global_norm`` of placed gradients equals the flat one: a leaf
    split in blocks counts each block, a replicated leaf (one block on
    the first device) once; the clip scales every block alike."""
    _, tcfg = CONFIGS["deepseek"]()
    grads = TT.init_params(tcfg, seed=5, device="cpu")
    mesh = _mesh((2, 4))
    placed = TS.place_tree(grads, _specs(tcfg, mesh), mesh)
    assert any(not TS.is_placed(x) for x in T.leaves(
        placed, is_leaf=TS.is_placed))
    flat = TOPT.global_norm(grads)
    assert torch.allclose(TOPT.global_norm(placed), flat, rtol=1e-6)
    clipped = TOPT.optimizers._clipped(placed, 0.5 * float(flat))
    assert torch.allclose(TOPT.global_norm(clipped), 0.5 * flat, rtol=1e-5)


@pytest.mark.parametrize("name", ["dbrx_ep", "grok_tp"])
def test_moe_aux_is_combined_from_the_shards_sums(name):
    """On (data=2, model=2) the batch splits and each data shard routes
    its rows: the aux loss taken once from the shards' summed
    ``moe_stats`` meets JAX's single-device aux (1e-5), while adding the
    shards' own aux losses, the old rule, misses it."""
    jcfg, tcfg = CONFIGS[name]()
    jp, tp = _params(jcfg, seed=2)
    toks = _batch(tcfg, 4, 19, seed=6)["tokens"]
    jaux = float(JT.forward(jp, jcfg, tokens=jnp.asarray(toks))[2])
    mesh = _mesh((2, 2))
    rules = RULES.get(name)
    placed = TS.place_tree(tp, _specs(tcfg, mesh, rules), mesh)
    tt = torch.from_numpy(toks)
    with torch.no_grad():
        with TS.use_rules(rules, mesh=mesh):
            assert len(TS.data_shards(4)) == 2
            got = float(TT.forward(placed, tcfg, tokens=tt)[2])
        added = sum(float(TT.forward(tp, tcfg, tokens=tt[lo:lo + 2])[2])
                    for lo in (0, 2))
    assert abs(got - jaux) <= 1e-5 * jaux
    assert abs(added - jaux) > 1e-2 * jaux


# Leaves of (2, 2)-mesh specs that split each axis of a factored leaf,
# both, a leading one (3-D), and a vector (unfactored).
ADAFACTOR_LEAVES = {"cols": ((6, 8), (None, "model")),
                    "rows": ((6, 8), ("data", None)),
                    "both": ((6, 8), ("data", "model")),
                    "lead": ((4, 6, 8), ("model", None, "data")),
                    "vector": ((8,), ("model",))}


@pytest.mark.parametrize("case", sorted(ADAFACTOR_LEAVES))
def test_adafactor_on_placed_leaves_equals_flat_and_jax(case):
    """3 Adafactor steps on a leaf placed on (2, 2) with the state placed
    by ``opt_state_specs``: the blocks' statistics meet as the whole
    leaf's, so the params equal flat Adafactor's (1e-6) and JAX's
    ``adafactor`` (1e-5), clip and weight decay included."""
    shape, spec = ADAFACTOR_LEAVES[case]
    rng = np.random.RandomState(3)
    w0 = rng.randn(*shape).astype(np.float32)
    grads = [rng.randn(*shape).astype(np.float32) * (i + 1)
             for i in range(3)]
    mesh = _mesh((2, 2))
    kw = dict(weight_decay=0.01, max_norm=None)

    def port(placed):
        opt = TOPT.adafactor(TOPT.constant(1e-2), **kw)
        w = torch.from_numpy(w0.copy())
        p = {"w": TS.place(w, spec, mesh) if placed else w}
        state = opt.init(p)
        if placed:
            assert TS.is_placed(p["w"])
            want = TOPT.opt_state_specs(opt, {"w": spec})["f"]["w"]
            for k, leaf in state["f"]["w"].items():
                assert (leaf.spec if TS.is_placed(leaf) else None) in (
                    want[k], None)
        for i, g in enumerate(grads):
            gt = torch.from_numpy(g)
            with torch.no_grad():
                opt.update({"w": TS.place(gt, spec, mesh) if placed
                            else gt}, state, p, i)
        return TS.gather(p["w"]).numpy()

    jopt = JOPT.adafactor(JOPT.constant(1e-2), **kw)
    jw = {"w": jnp.asarray(w0)}
    jstate = jopt.init(jw)
    for i, g in enumerate(grads):
        jw, jstate = jopt.update({"w": jnp.asarray(g)}, jstate, jw,
                                 jnp.asarray(i))
    got, flat = port(True), port(False)
    assert _rel(got, flat) <= 1e-6
    assert _rel(got, jw["w"]) <= 1e-5


def test_default_optimizer_trains_dbrx_on_a_mesh(tmp_path):
    """``default_optimizer_for('dbrx-132b')`` is Adafactor (132B
    params); the reduced dbrx, placed on (data=2, model=2) under its
    ``experts -> model`` rules, trains 2 steps with it through the
    Trainer equal to the flat Trainer (1e-5)."""
    _, tcfg = CONFIGS["dbrx_ep"]()
    n = TReg.get("dbrx-132b").config.param_count()
    assert TOPT.default_optimizer_for("dbrx-132b", n).name == "adafactor"
    params = TT.init_params(tcfg, seed=7, device="cpu")
    data = dict(vocab=tcfg.vocab, seq_len=12, global_batch=4, seed=1)
    mesh = _mesh((2, 2))
    rules = RULES["dbrx_ep"]

    def run(where, on_mesh):
        return Trainer(
            loss_fn=lambda p, b: TT.loss_fn(p, tcfg, b),
            params=T.tree_map(torch.clone, params),
            optimizer=TOPT.default_optimizer_for("dbrx-132b", n,
                                                 TOPT.constant(1e-2)),
            batch_fn=lambda s: lm_batch(LMDataConfig(**data), s),
            config=TrainerConfig(total_steps=2, ckpt_every=100,
                                 ckpt_dir=str(tmp_path / where),
                                 log_every=1),
            device="cpu" if not on_mesh else None,
            mesh=mesh if on_mesh else None,
            param_specs=_specs(tcfg, mesh, rules) if on_mesh else None,
            rules=rules if on_mesh else None)
    mt, flat = run("mesh", True), run("flat", False)
    w = mt.params["layers"]["m0"]["ffn"]["w_up"]
    assert TS.is_placed(w) and w.spec == (None, "model", "data", None)
    assert TS.is_placed(mt.opt_state["f"]["layers"]["m0"]["ffn"]["w_up"]
                        ["vr"])
    mt.run()
    flat.run()
    np.testing.assert_allclose(
        [h["loss"] for h in mt.history if "loss" in h],
        [h["loss"] for h in flat.history if "loss" in h], rtol=1e-5)
    assert _rel(_flat_np(mt.params), _flat_np(flat.params)) <= 1e-5


def test_opt_state_specs_equal_jax():
    _, tcfg = CONFIGS["command_r_tied"]()
    mesh = _mesh((2, 4))
    specs = _specs(tcfg, mesh)
    jspecs = jax.tree_util.tree_map(lambda s: JS.P(*s), specs,
                                    is_leaf=lambda x: isinstance(x, tuple))
    for name in ("sgd", "adamw", "adafactor"):
        opt = getattr(TOPT, name)(TOPT.constant(1e-3))
        jopt = getattr(JOPT, name)(JOPT.constant(1e-3))
        got = TOPT.opt_state_specs(opt, specs)
        want = jax.tree_util.tree_map(
            tuple, JOPT.opt_state_specs(jopt, jspecs),
            is_leaf=lambda x: isinstance(x, JS.P))
        assert got == want, name


# ---------------------------------------------------------------------------
# The Trainer on a mesh
# ---------------------------------------------------------------------------

def _trainer_cfg():
    return TT.ModelConfig(name="t", n_layers=2, d_model=32, n_heads=4,
                          kv_heads=2, d_ff=64, vocab=32,
                          dtype=torch.float32)


def _jtrainer_cfg():
    return JT.ModelConfig(name="t", n_layers=2, d_model=32, n_heads=4,
                          kv_heads=2, d_ff=64, vocab=32,
                          dtype=jnp.float32)


DATA = dict(vocab=32, seq_len=16, global_batch=8, seed=3)
TRAIN_STEPS = 3

VARIANTS = {"sgd": dict(opt="sgd"), "adamw": dict(opt="adamw"),
            "int8_ef": dict(opt="adamw", compression="int8_ef"),
            "microbatches2": dict(opt="adamw", micro=2)}


def _opt(pkg, name):
    if name == "sgd":
        return pkg.sgd(pkg.constant(0.05), momentum=0.9,
                       weight_decay=1e-4)
    return pkg.adamw(pkg.constant(3e-3))


def _port_trainer(tmp, tree, variant, mesh=None, steps=TRAIN_STEPS):
    cfg = _trainer_cfg()
    v = VARIANTS[variant]
    specs = None if mesh is None else _specs(cfg, mesh)
    return Trainer(
        loss_fn=lambda p, b: TT.loss_fn(p, cfg, b),
        params=params_from_jax(tree, device="cpu"),
        optimizer=_opt(TOPT, v["opt"]),
        batch_fn=lambda s: lm_batch(LMDataConfig(**DATA), s),
        config=TrainerConfig(total_steps=steps, ckpt_every=100,
                             ckpt_dir=str(tmp), log_every=1,
                             microbatches=v.get("micro", 1),
                             grad_compression=v.get("compression")),
        device="cpu" if mesh is None else None, mesh=mesh,
        param_specs=specs)


def _flat_np(tree):
    return np.concatenate([np.asarray(t.detach(), np.float32).ravel()
                           for t in T.leaves(TS.gather_tree(tree))])


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_trainer_on_a_mesh_equals_flat_and_jax(tmp_path, variant):
    """``TRAIN_STEPS`` Trainer steps on (data=2, model=2) with placed
    params against the flat port Trainer (1e-5: only summation orders
    differ) and JAX's Trainer (1e-4); the params, optimizer state and
    error-feedback state are placed and own their storage, and the
    checkpoint the mesh Trainer writes restores into the flat one."""
    jcfg = _jtrainer_cfg()
    tree = _perturbed(JT.init_params(jax.random.PRNGKey(0), jcfg), 0)
    v = VARIANTS[variant]
    jt = JTrainer(
        loss_fn=lambda p, b: JT.loss_fn(p, jcfg, b),
        params=jax.tree_util.tree_map(jnp.asarray, tree),
        optimizer=_opt(JOPT, v["opt"]), mesh=None, param_specs=None,
        batch_fn=lambda s: j_lm_batch(JLMDataConfig(**DATA), s),
        config=JTrainerConfig(total_steps=TRAIN_STEPS, ckpt_every=100,
                              ckpt_dir=str(tmp_path / "jax"), log_every=1,
                              microbatches=v.get("micro", 1),
                              grad_compression=v.get("compression")))
    jt.run()
    mesh = _mesh((2, 2))
    mt = _port_trainer(tmp_path / "mesh", tree, variant, mesh)
    wq = mt.params["layers"]["m0"]["attn"]["wq"]
    assert TS.is_placed(wq) and wq.grid == (1, 2, 2, 1)
    assert TS.is_placed(mt.opt_state[next(iter(mt.opt_state))]
                        ["layers"]["m0"]["attn"]["wq"])
    ptrs = _storages({"p": mt.params, "o": mt.opt_state, "e": mt.ef_state})
    assert len(set(ptrs)) == len(ptrs)
    mt.run()
    assert mt.batch_specs["tokens"] == ("data", None)
    flat = _port_trainer(tmp_path / "flat", tree, variant)
    flat.run()
    jl = [h["loss"] for h in jt.history if "loss" in h]
    ml = [h["loss"] for h in mt.history if "loss" in h]
    fl = [h["loss"] for h in flat.history if "loss" in h]
    assert len(ml) == len(jl) == TRAIN_STEPS
    np.testing.assert_allclose(ml, fl, rtol=1e-5)
    np.testing.assert_allclose(ml, jl, rtol=1e-4)
    want = np.concatenate([np.asarray(a).ravel() for a in
                           jax.tree_util.tree_leaves(jt.params)])
    assert _rel(_flat_np(mt.params), _flat_np(flat.params)) <= 1e-5
    assert _rel(_flat_np(mt.params), want) <= 1e-4
    # The mesh Trainer's checkpoint is mesh-free: a flat Trainer resumes.
    back = _port_trainer(tmp_path / "mesh", tree, variant)
    assert back.try_resume() and back.step == TRAIN_STEPS
    assert _rel(_flat_np(back.params), _flat_np(mt.params)) == 0.0


def test_a_shared_block_would_double_the_update():
    """Why blocks own their storage: two blocks placed on a repeated
    device are distinct tensors, so one in-place AdamW step moves each
    once, as on distinct devices."""
    mesh = _mesh((1, 2))
    w = torch.randn(4, 6)
    p = {"w": T.tree_map(lambda b: b.requires_grad_(True),
                         TS.place(w, (None, "model"), mesh))}
    opt = TOPT.sgd(TOPT.constant(0.5), momentum=0.0)
    state = opt.init(p)
    g = T.tree_map(torch.ones_like, p)
    with torch.no_grad():
        opt.update(g, state, p, 0)
    assert torch.equal(TS.gather(p["w"]).detach(), w - 0.5)


def test_lm_launcher_on_a_repeated_cpu_host_mesh(tmp_path, monkeypatch,
                                                  capsys):
    """``launch.train --arch tinyllama-1.1b`` (reduced) on a (data=2,
    model=1) host mesh of the CPU: the params are placed by their specs
    (FSDP over 'data'), the batch splits over 'data', the losses equal a
    one-device run's and a second run resumes from the checkpoint."""
    monkeypatch.setattr(launch, "host_mesh",
                        lambda args: make_host_mesh(["cpu"] * 2))
    base = ["--arch", "tinyllama-1.1b", "--device", "cpu", "--log-every",
            "1", "--global-batch", "4", "--seq-len", "16"]
    launch.main(base + ["--steps", "3", "--ckpt", str(tmp_path / "m")])
    out = capsys.readouterr().out
    assert "mesh={'data': 2, 'model': 1}" in out
    args = launch.build_parser().parse_args(
        base + ["--steps", "3", "--ckpt", str(tmp_path / "m2")])
    tr = launch.train_lm(TReg.get("tinyllama-1.1b").config, args)
    emb = tr.params["embed"]["embedding"]
    wq = tr.params["layers"]["m0"]["attn"]["wq"]
    assert not TS.is_placed(emb)            # ('vocab', None): model 1
    assert TS.is_placed(wq) and wq.spec[1] == "data"
    monkeypatch.setattr(launch, "host_mesh",
                        lambda args: make_host_mesh(["cpu"]))
    flat = launch.train_lm(TReg.get("tinyllama-1.1b").config,
                           launch.build_parser().parse_args(
                               base + ["--steps", "3", "--ckpt",
                                       str(tmp_path / "f")]))
    np.testing.assert_allclose(
        [h["loss"] for h in tr.history if "loss" in h],
        [h["loss"] for h in flat.history if "loss" in h], rtol=1e-5)
    monkeypatch.setattr(launch, "host_mesh",
                        lambda args: make_host_mesh(["cpu"] * 2))
    launch.main(base + ["--steps", "4", "--ckpt", str(tmp_path / "m")])
    assert "resumed from step 3" in capsys.readouterr().out
