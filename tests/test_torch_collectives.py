"""The bytes a mesh step moves between positions: ``sharding.move`` /
``count_crossings`` (what the port's mesh code moves, counted where it
moves it) against ``launch.collectives`` (the dry run's count from the
specs and shapes alone), kind by kind, on repeated-CPU meshes of the
reduced registry configs: training (with and without remat, with
microbatches), the logits, prefill and decode, for the dense, MoE
(expert- and tensor-parallel), RG-LRU, RWKV-6 (whole heads and heads
met), multi-codebook and tied-embedding families; and the DCL height
shard's halo exchange.  Also the crossing rules themselves."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import tree as T
from repro_torch.distributed import sharding as TS
from repro_torch.kernels import ops
from repro_torch.launch import collectives as C
from repro_torch.models import layers as TL
from repro_torch.models import registry as TReg
from repro_torch.models import transformer as TT
from repro_torch.distributed.spatial import halo_rows

torch.set_num_threads(2)

EP = {**TS.DEFAULT_RULES, "experts": "model"}


def _mesh(shape, names=("data", "model")):
    devs = np.empty(shape, dtype=object)
    devs[...] = torch.device("cpu")
    return TS.Mesh(devs, names)


def _counted(cfg, mesh, rules, mode, b, s, micro):
    """The step on placed params under ``count_crossings``."""
    with TS.use_rules(rules, mesh=mesh):
        specs = TL.spec_tree(TT.param_defs(cfg))
    placed = TS.place_tree(TT.init_params(cfg, seed=1, device="cpu"),
                           specs, mesh)
    if mode == "train":
        placed = T.tree_map(lambda t: t.requires_grad_(True), placed)
    g = torch.Generator().manual_seed(0)
    shape = (b, s) if cfg.codebooks == 1 else (b, s, cfg.codebooks)
    toks = torch.randint(0, cfg.vocab, shape, generator=g)
    with TS.use_rules(rules, mesh=mesh):
        if mode == "decode":
            with torch.no_grad():
                _, caches = TT.prefill(placed, cfg, toks, cache_len=32)
        with TS.count_crossings() as counter:
            if mode == "train":
                rows = b // micro
                for i in range(micro):
                    part = toks[i * rows:(i + 1) * rows]
                    loss = TT.loss_fn(placed, cfg, {"tokens": part,
                                                    "targets": part})[0]
                    torch.autograd.grad(loss, T.leaves(placed))
            else:
                with torch.no_grad():
                    if mode == "forward":
                        TT.forward(placed, cfg, tokens=toks)
                    elif mode == "prefill":
                        TT.prefill(placed, cfg, toks, cache_len=32)
                    else:
                        TT.decode_step(placed, cfg, toks[:, -1], caches,
                                       torch.full((b,), s))
    return counter.summary()


CASES = [
    ("tinyllama-1.1b", (2, 2), None, "train", 1, "full"),
    ("tinyllama-1.1b", (2, 4), None, "train", 2, "dots"),
    ("dbrx-132b", (2, 2), EP, "train", 1, "full"),
    ("grok-1-314b", (2, 2), None, "train", 1, "none"),
    ("recurrentgemma-9b", (1, 4), None, "train", 1, "full"),
    ("rwkv6-3b", (1, 2), None, "train", 1, "none"),
    ("rwkv6-3b", (2, 8), None, "train", 1, "full"),
    ("musicgen-medium", (1, 4), None, "train", 1, "none"),
    ("command-r-35b", (2, 2), None, "train", 1, "none"),
    ("grok-1-314b", (1, 4), None, "forward", 1, "none"),
    ("dbrx-132b", (2, 2), EP, "prefill", 1, "none"),
    ("dbrx-132b", (2, 2), EP, "decode", 1, "none"),
    ("recurrentgemma-9b", (2, 4), None, "decode", 1, "none"),
    ("rwkv6-3b", (1, 8), None, "decode", 1, "none"),
]


@pytest.mark.parametrize(
    "name,shape,rules,mode,micro,remat", CASES,
    ids=[f"{c[0]}-{c[1][0]}x{c[1][1]}-{c[3]}-{c[5]}" for c in CASES])
def test_counted_crossings_equal_the_analytic_count(name, shape, rules,
                                                    mode, micro, remat):
    """Kind by kind, count and bytes: every FSDP gather (twice in a
    rematerialised period), its gradient's reduce-scatter and all-reduce,
    the partial sums, the vocab combine, the expert exchange."""
    cfg = dataclasses.replace(TReg.reduced_config(TReg.get(name)),
                              remat=remat)
    mesh = _mesh(shape)
    b, s = 4, 19
    got = _counted(cfg, mesh, rules, mode, b, s, micro)
    want = C.lm_collectives(cfg, mesh, mode=mode, batch=b, seq=s,
                            rules=rules, micro=micro).summary()
    assert got == want
    assert got["total_bytes"] > 0
    if mode == "train" and shape[0] > 1:
        assert got["reduce-scatter"]["bytes"] > 0
    if rules is EP:
        assert got["all-to-all"]["count"] > 0


def test_a_mesh_of_one_position_moves_nothing():
    cfg = TReg.reduced_config(TReg.get("tinyllama-1.1b"))
    got = _counted(cfg, _mesh((1, 1)), None, "train", 2, 8, 1)
    assert got["total_bytes"] == 0 == got["total_count"]


def test_fetch_crossings_rules():
    """A block read where it lies crosses nothing; one read elsewhere
    along its split axes is an all-gather, its gradient a reduce-scatter
    back; a gradient taken away from the one copy, along an axis the spec
    does not split, is summed into it (an all-reduce)."""
    mesh = _mesh((2, 4))
    spec = ("data", None)                  # replicated over 'model'
    assert TS.fetch_crossings(spec, mesh, (0, 0), (0, 0)) == (None, ())
    fwd, back = TS.fetch_crossings(spec, mesh, (1, 0), (0, 2))
    assert fwd == ("all-gather", (1, 2), (0, 2))
    assert back == (("reduce-scatter", (0, 2), (1, 2)),
                    ("all-reduce", (1, 2), (1, 0)))
    # A whole leaf: only its gradient crosses, from any other position.
    assert TS.fetch_crossings((None,), mesh, (0,), (1, 3)) == (
        None, (("all-reduce", (1, 3), (0, 0)),))


def test_move_counts_by_position_and_its_gradient_back():
    mesh = _mesh((1, 2))
    t = torch.ones(3, 4, requires_grad=True)
    with TS.use_rules(mesh=mesh), TS.count_crossings() as c:
        y = TS.move(t, "cpu", (0, 1), (0, 0), "all-gather")
        y.sum().backward()
        TS.move(t, "cpu", (0, 0), (0, 0), "all-reduce")   # no crossing
    assert c.pairs == {("all-gather", (0, 1), (0, 0)): [1, 48],
                       ("reduce-scatter", (0, 0), (0, 1)): [1, 48]}
    assert torch.equal(t.grad, torch.ones(3, 4))
    s = c.summary()
    assert s["total_bytes"] == 96 and s["total_count"] == 2
    with pytest.raises(ValueError, match="unknown collective"):
        c.add("broadcast", (0,), (1,), 1)


@pytest.mark.parametrize("shards,backward", [(2, False), (4, False),
                                              (2, True)])
def test_halo_exchange_is_counted_as_collective_permute(shards, backward):
    """The DCL height shard: each neighbour's halo rows, and in the
    backward the exchange again and each halo's gradient rows back, are
    ``spatial_collectives``' count."""
    rng = np.random.RandomState(0)
    n, h, w, c, m, bound = 2, 32, 16, 8, 8, 2.0
    x = torch.from_numpy(rng.randn(n, h, w, c).astype(np.float32))
    off = torch.from_numpy((rng.rand(n, h, w, 18) * 4 - 2)
                           .astype(np.float32))
    wgt = torch.from_numpy((0.1 * rng.randn(9, c, m)).astype(np.float32))
    if backward:
        x.requires_grad_()
    with TS.use_rules(mesh=_mesh((shards,), ("model",))), \
            TS.count_crossings() as counter:
        y = ops.deform_conv(x, off, wgt, offset_bound=bound,
                            shard_spatial=True, device="cpu")
        if backward:
            y.sum().backward()
    want = C.spatial_collectives(
        batch_blocks=1, block_rows=n, shards=shards, width=w, channels=c,
        itemsize=4, halo=halo_rows(kernel_size=3, dilation=1,
                                   offset_bound=bound), backward=backward)
    assert counter.summary() == want
    assert want["collective-permute"]["count"] > 0


@pytest.mark.parametrize("bound,shards", [(2.0, 2), (2.0, 4), (None, 2)])
def test_detector_step_counts_every_params_gradient_sum(bound, shards):
    """A detector's training step on a data mesh (the bounded detector and
    the unbounded one): every layer runs per data shard, so every param's
    gradient comes back from every data shard but the first (an
    all-reduce of the leaf), as ``dcn_collectives`` counts; inference
    moves none."""
    from repro_torch.data import DetectionDataConfig, detection_batch
    from repro_torch.models import resnet_dcn as R
    cfg = R.ResNetDCNConfig(
        stage_sizes=(1, 1, 1, 1), widths=(16, 32, 64, 128), stem_width=8,
        num_dcn=2, num_classes=4, img_size=32, offset_bound=bound,
        use_kernel=True)
    params = T.tree_map(lambda t: t.requires_grad_(True),
                        R.init_params(cfg, seed=0, device="cpu"))
    batch = {k: torch.as_tensor(np.asarray(v)) for k, v in detection_batch(
        DetectionDataConfig(img_size=32, global_batch=4, num_classes=4,
                            seed=3), 0).items()}
    mesh = _mesh((shards,), ("data",))
    with TS.use_rules(mesh=mesh), TS.count_crossings() as counter:
        loss, _ = R.train_loss(params, cfg, batch, lam=0.1, device="cpu")
        torch.autograd.grad(loss, T.leaves(params), allow_unused=True)
    want = C.dcn_collectives(cfg, mesh, batch=4, train=True).summary()
    assert counter.summary() == want
    leaves = T.leaves(params)
    assert want["all-reduce"]["count"] == len(leaves) * (shards - 1)
    assert want["all-reduce"]["bytes"] == (shards - 1) * sum(
        t.numel() * 4 for t in leaves)
    assert want["total_count"] == want["all-reduce"]["count"]
    assert C.dcn_collectives(cfg, mesh, batch=4, train=False) \
        .summary()["total_count"] == 0


def test_qat_detector_keeps_the_batch_whole_and_counts_its_dcls_sums():
    """QAT on absmax scales (a max over the whole batch) keeps the batch
    whole on a data mesh: only the DCL kernel calls split it, and each
    DCL's d_weights comes back from the second batch shard, as
    ``dcn_collectives`` counts."""
    from repro_torch.data import DetectionDataConfig, detection_batch
    from repro_torch.models import resnet_dcn as R
    cfg = R.ResNetDCNConfig(
        stage_sizes=(1, 1, 1, 1), widths=(16, 32, 64, 128), stem_width=8,
        num_dcn=2, num_classes=4, img_size=32, offset_bound=2.0,
        use_kernel=True, quant="qat")
    params = T.tree_map(lambda t: t.requires_grad_(True),
                        R.init_params(cfg, seed=0, device="cpu"))
    batch = {k: torch.as_tensor(np.asarray(v)) for k, v in detection_batch(
        DetectionDataConfig(img_size=32, global_batch=4, num_classes=4,
                            seed=3), 0).items()}
    mesh = _mesh((2,), ("data",))
    seen = []
    with TS.use_rules(mesh=mesh), TS.count_crossings() as counter, \
            ops.dispatch_hook_scope(lambda ctx: seen.append(ctx["shards"])):
        loss, _ = R.train_loss(params, cfg, batch, lam=0.1, device="cpu")
        torch.autograd.grad(loss, T.leaves(params), allow_unused=True)
    assert seen == [(2, 1)] * 2
    want = C.dcn_collectives(cfg, mesh, batch=4, train=True).summary()
    assert counter.summary() == want
    assert want["all-reduce"]["count"] == want["total_count"] == 2
