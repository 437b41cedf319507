"""Port parity: the data-parallel detector (``models.resnet_dcn`` under a
(data=n) mesh), every layer on its data shard, against the JAX package.

JAX's Trainer puts the batch on the mesh's 'batch' axes and GSPMD runs
every layer of the detector on its batch shard, with the loss the global
one.  The port runs each data shard's whole network at its mesh
coordinates and builds the loss from the shards' sums.  The reference is
JAX's single-device ``resnet_dcn.forward`` and ``jax.value_and_grad`` of
``train_loss`` on the whole batch (its kernel path, interpret mode), as
JAX's own sharded-training tests do not run on one CPU.  Meshes repeat
the CPU: (data=2) and (data=4), so a batch of 4 gives shards of 2 rows
and of 1.  Inputs come from numpy with a seed.

Tolerances: ``cls``/``box`` within 1e-5 * max|ref|; the loss 1e-5
relative; each leaf's gradient within 1e-4 of its norm, a leaf whose
gradient is zero in exact arithmetic (the DCL's ``b_deform``: the
GroupNorm after it removes any per-channel bias) within 1e-4 of the
whole gradient's norm, since both sides hold rounding noise there; the
saved-activation bytes of each position at most 1/n of the flat step's
plus 5%.
"""
import functools
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import resnet_dcn as JR
from repro_torch import optim as TOPT
from repro_torch import tree as T
from repro_torch.convert import params_from_jax
from repro_torch.data import DetectionDataConfig, detection_batch
from repro_torch.distributed import sharding as TS
from repro_torch.kernels import ops
from repro_torch.models import resnet_dcn as R
from repro_torch.train import Trainer, TrainerConfig

from _cpu_rows import rows_round_alike

torch.set_num_threads(2)

SMALL = dict(stage_sizes=(1, 1, 1, 1), widths=(16, 32, 64, 128),
             stem_width=8, num_dcn=2, img_size=32, offset_bound=2.0,
             use_kernel=True)
DATA = dict(img_size=32, global_batch=4, num_classes=16, seed=3)
LAM = 0.1
SHARDS = [2, 4]


@functools.lru_cache(maxsize=None)
def _perturbed(seed=0):
    """Seeded params (the port's init, as numpy: the two packages share
    the tree and its layouts) with offset convs that move the taps past
    the bound.  Callers copy them."""
    params = T.tree_map(lambda t: t.numpy(), R.init_params(
        R.ResNetDCNConfig(**SMALL), seed=seed, device="cpu"))
    rng = np.random.RandomState(seed)
    for block in params.values():
        if "dcl" in block:
            dcl = block["dcl"]
            c = dcl["w_offset"].shape[2]
            dcl["w_offset"] = (rng.randn(*dcl["w_offset"].shape)
                               / np.sqrt(4.5 * c)).astype(np.float32)
            dcl["b_offset"] = (rng.randn(*dcl["b_offset"].shape)
                               * 0.5).astype(np.float32)
    return params


def _batches():
    """The seeded batch, and a copy whose positive cells all lie in the
    first row (so in the first data shard at n = 2 and n = 4)."""
    batch = detection_batch(DetectionDataConfig(**DATA), 0)
    skew = {k: v.copy() for k, v in batch.items()}
    skew["obj"][1:] = 0.0
    return {"even": batch, "skewed": skew}


@pytest.fixture(scope="module")
def ref():
    """JAX on one device: the outputs, and the loss, metrics and gradient
    of Eq. 5 (lambda 0.1) for each batch."""
    jcfg = JR.ResNetDCNConfig(**SMALL)
    params = _perturbed()
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    batches = _batches()
    out = jax.jit(lambda p, x: JR.forward(p, jcfg, x)[0])(
        jp, jnp.asarray(batches["even"]["images"]))
    vg = jax.jit(jax.value_and_grad(
        lambda p, b: JR.train_loss(p, jcfg, b, lam=LAM), has_aux=True))
    losses = {}
    for name, b in batches.items():
        (loss, metrics), grads = vg(jp, {k: jnp.asarray(v)
                                         for k, v in b.items()})
        losses[name] = (float(loss), {k: float(v) for k, v in
                                      metrics.items()},
                        [np.asarray(g) for g in
                         jax.tree_util.tree_leaves(grads)])
    return {"params": params, "batches": batches,
            "out": {k: np.asarray(out[k]) for k in ("cls", "box")},
            "loss": losses}


def _port(params):
    return T.tree_map(lambda t: t.requires_grad_(True),
                      params_from_jax(params, device="cpu"))


def _tensors(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _mesh(n):
    return TS.Mesh(["cpu"] * n, ("data",))


def _step(params, batch, n, **kw):
    """Loss, metrics and gradient of one step on a (data=n) mesh."""
    cfg = R.ResNetDCNConfig(**SMALL, **kw)
    with TS.use_rules(mesh=_mesh(n)):
        loss, metrics = R.train_loss(params, cfg, _tensors(batch), lam=LAM,
                                     device="cpu")
        grads = torch.autograd.grad(loss, T.leaves(params))
    return loss, metrics, grads


@pytest.mark.parametrize("n", SHARDS)
def test_outputs_match_jax(ref, n):
    params = _port(ref["params"])
    cfg = R.ResNetDCNConfig(**SMALL)
    seen = []
    with TS.use_rules(mesh=_mesh(n)), torch.no_grad(), \
            ops.dispatch_hook_scope(lambda ctx: seen.append(ctx["shape"])):
        out, _ = R.forward(params, cfg,
                           _tensors(ref["batches"]["even"])["images"],
                           device="cpu")
    assert [s[0] for s in seen] == [4 // n] * (2 * n)
    for key in ("cls", "box"):
        want = ref["out"][key]
        assert out[key].shape == want.shape
        assert np.abs(out[key].numpy() - want).max() \
            <= 1e-5 * np.abs(want).max(), key


def _check_grads(got, want):
    whole = np.sqrt(sum(float(np.sum(w.astype(np.float64) ** 2))
                        for w in want))
    for i, (g, w) in enumerate(zip(got, want)):
        err = float(np.linalg.norm(g.numpy() - w))
        norm = float(np.linalg.norm(w))
        if norm > 1e-6 * whole:
            assert err <= 1e-4 * norm, (i, err, norm)
        else:
            assert err <= 1e-4 * whole, (i, err, whole)


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("batch", ["even", "skewed"])
def test_loss_and_gradients_match_jax(ref, n, batch):
    """(b) and (c): on the skewed batch a mean of the shards' losses
    misses JAX's loss (the shards without positives clamp ``n_pos`` to 1
    and halve the CE and L1), and the loss from the shards' sums meets
    it."""
    params = _port(ref["params"])
    jl, jm, jg = ref["loss"][batch]
    loss, metrics, grads = _step(params, ref["batches"][batch], n)
    assert abs(loss.item() - jl) <= 1e-5 * abs(jl)
    for key in ("bce", "ce", "l1", "o_max"):
        assert abs(float(metrics[key]) - jm[key]) <= 1e-5 * abs(jm[key]), key
    _check_grads(grads, jg)
    if batch == "skewed":
        cfg = R.ResNetDCNConfig(**SMALL)
        rows = _tensors(ref["batches"][batch])
        per = 4 // n
        with torch.no_grad():
            means = [float(R.train_loss(params, cfg, {
                k: v[i * per:(i + 1) * per] for k, v in rows.items()},
                lam=LAM, device="cpu")[0]) for i in range(n)]
        assert abs(np.mean(means) - jl) > 1e-2 * abs(jl)


@pytest.mark.parametrize("n", SHARDS)
def test_o_max_is_the_global_max_and_its_gradient_one_shards(ref, n):
    """(d): each DCL's ``o_max`` is the max of the shards' maxima (JAX's
    global one), and Eq. 5's gradient reaches only the rows of the shard
    that holds it (every layer is per row: GroupNorm normalises each
    image on its own)."""
    params = _port(ref["params"])
    cfg = R.ResNetDCNConfig(**SMALL)
    batch = _tensors(ref["batches"]["even"])
    images = batch["images"].clone().requires_grad_(True)
    with TS.use_rules(mesh=_mesh(n)):
        _, metrics = R.train_loss(params, cfg, dict(batch, images=images),
                                  lam=LAM, device="cpu")
        g, = torch.autograd.grad(metrics["o_max"], images)
    jm = ref["loss"]["even"][1]
    assert abs(float(metrics["o_max"]) - jm["o_max"]) <= 1e-5 * jm["o_max"]
    per = 4 // n
    touched = {i // per for i in range(4) if float(g[i].abs().max()) > 0}
    assert len(touched) == 1
    owner, = touched
    with torch.no_grad():
        _, om = R.forward(params, cfg,
                          batch["images"][owner * per:(owner + 1) * per],
                          device="cpu")
    assert float(torch.stack(list(om.values())).amax()) \
        == float(metrics["o_max"])


@pytest.mark.parametrize("n", SHARDS)
def test_each_dcl_dispatch_sees_its_shards_rows(ref, n):
    """(e): a step makes 2 DCL dispatches a data shard, each of batch
    N/n, which split nothing further and say they run in one of n data
    shards."""
    params = _port(ref["params"])
    seen = []
    with ops.dispatch_hook_scope(lambda ctx: seen.append(
            (ctx["shape"][0], ctx["shards"]))):
        _step(params, ref["batches"]["even"], n)
    assert seen == [(4 // n, (1, 1, n))] * (2 * n)


@pytest.mark.parametrize("n", SHARDS)
def test_saved_activations_split_over_the_positions(ref, n):
    """(f): what autograd saves for the backward, by mesh position: each
    holds at most 1/n of the flat step's bytes, plus 5%."""
    params = _port(ref["params"])
    cfg = R.ResNetDCNConfig(**SMALL)
    batch = _tensors(ref["batches"]["even"])
    with TS.saved_bytes(T.leaves(params)) as flat:
        R.train_loss(params, cfg, batch, lam=LAM, device="cpu")
    with TS.use_rules(mesh=_mesh(n)), \
            TS.saved_bytes(T.leaves(params)) as held:
        R.train_loss(params, cfg, batch, lam=LAM, device="cpu")
    assert sorted(held) == [(i,) for i in range(n)]
    total = flat[()]
    for pos, nbytes in held.items():
        assert nbytes <= 1.05 * total / n, (pos, nbytes, total)
    assert sum(held.values()) >= total


def test_shard_batch_true_refuses_a_batch_that_does_not_divide(ref):
    """(g)."""
    params = _port(ref["params"])
    cfg = R.ResNetDCNConfig(**SMALL, shard_batch=True)
    batch = {k: v[:3] for k, v in _tensors(ref["batches"]["even"]).items()}
    with TS.use_rules(mesh=_mesh(2)), pytest.raises(
            ValueError, match="does not divide the mesh batch axes"):
        R.train_loss(params, cfg, batch, lam=LAM, device="cpu")
    with TS.use_rules(mesh=_mesh(2)), pytest.raises(
            ValueError, match="does not divide the mesh batch axes"):
        R.forward(params, cfg, batch["images"], device="cpu")
    # shard_batch=False keeps the batch whole: one dispatch a DCL.
    seen = []
    with ops.dispatch_hook_scope(lambda ctx: seen.append(ctx["shards"])):
        _step(_port(ref["params"]), ref["batches"]["even"], 2,
              shard_batch=False)
    assert seen == [(1, 1)] * 2


def test_microbatches_split_each_microbatch_over_the_shards(tmp_path):
    """The Trainer's microbatch axis comes first: each of 2 microbatches
    of 2 rows splits into 2 data shards of one row; one step matches the
    flat Trainer's, both run where a row rounds alike at any batch
    (``_cpu_rows.rows_round_alike``)."""
    data = DetectionDataConfig(**DATA)
    cfg = R.ResNetDCNConfig(**SMALL)

    def trainer(mesh, path):
        return Trainer(
            loss_fn=lambda p, b: R.train_loss(p, cfg, b, lam=LAM,
                                              device="cpu"),
            params=params_from_jax(_perturbed(), device="cpu"),
            optimizer=TOPT.sgd(TOPT.constant(0.01)),
            batch_fn=lambda s: detection_batch(data, s),
            config=TrainerConfig(total_steps=1, ckpt_every=100,
                                 ckpt_dir=str(path), log_every=1,
                                 microbatches=2),
            device="cpu", mesh=mesh)
    seen = []
    mesh = trainer(_mesh(2), tmp_path / "mesh")
    flat = trainer(None, tmp_path / "flat")
    with rows_round_alike():
        with ops.dispatch_hook_scope(lambda ctx: seen.append(
                (ctx["shape"][0], ctx["shards"]))):
            mesh.run()
        flat.run()
    assert seen == [(1, (1, 1, 2))] * 8
    assert mesh.batch_specs["images"] == ("data", None, None, None)
    a = np.concatenate([t.detach().numpy().ravel()
                        for t in T.leaves(mesh.params)])
    b = np.concatenate([t.detach().numpy().ravel()
                        for t in T.leaves(flat.params)])
    assert np.linalg.norm(a - b) <= 1e-6 * np.linalg.norm(b)


def test_saved_bytes_keeps_no_graph_alive():
    """A tensor autograd saves as its node's own output (``exp`` saves
    its result) is freed with the graph when counted by
    ``saved_bytes``: the hook keeps no reference that closes a cycle
    through the node."""
    x = torch.ones(1000, requires_grad=True)
    with TS.saved_bytes() as held:
        y = torch.exp(x)
    assert held == {(): 4000}
    alive = weakref.ref(y)
    del y
    gc.collect()
    assert alive() is None
