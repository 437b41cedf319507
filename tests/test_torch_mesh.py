"""Port parity: the device mesh of ``repro_torch`` (``distributed.sharding``,
``launch.mesh``), the batch-sharded DCL kernel path (``kernels.ops``) and
the data-parallel Trainer, against the JAX package.

Meshes repeat the CPU (``Mesh(["cpu"] * 4, ...)``): every shard, move and
sum runs in-process, as JAX's forced host devices do.  JAX's sharding
functions read only ``mesh.axis_names`` and ``mesh.devices.shape``, so
they take the port's ``Mesh`` itself.  Inputs come from numpy with a
seed.  Tolerances: rules and specs entry for entry; batch-sharded outputs
``torch.equal`` at pinned tiles, gradients 1e-5 relative (d_weights sums
its shards in another order); the data-parallel Trainer (every layer
per data shard) 1e-5 relative to the port's single-device Trainer after
3 steps, both run where a CPU row rounds alike at any batch
(``_cpu_rows``), and both within 2e-4 of JAX's single-device Trainer
(see that test for the reading).
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as JOPT
from repro.data import DetectionDataConfig as JDataCfg
from repro.data import detection_batch as j_detection_batch
from repro.distributed import sharding as JS
from repro.models import resnet_dcn as JR
from repro.train import Trainer as JTrainer
from repro.train import TrainerConfig as JTrainerConfig
from repro_torch import optim as TOPT
from repro_torch import tree as T
from repro_torch.convert import params_from_jax
from repro_torch.data import DetectionDataConfig, detection_batch
from repro_torch.distributed import sharding as S
from repro_torch.distributed.sharding import Mesh, use_rules
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import resnet_dcn as TRN
from repro_torch.train import Trainer, TrainerConfig

from _cpu_rows import rows_round_alike

torch.set_num_threads(2)

SMALL = dict(stage_sizes=(1, 1, 1, 1), widths=(16, 32, 64, 128),
             stem_width=8, num_dcn=2, num_classes=4, img_size=32,
             offset_bound=2.0)
DATA = dict(img_size=32, global_batch=4, num_classes=4, seed=3)


def _mesh(shape, names):
    return Mesh(np.full(shape, "cpu", dtype=object), names)


MESHES = {
    "data16_model16": _mesh((16, 16), ("data", "model")),
    "pod2_data16_model16": _mesh((2, 16, 16), ("pod", "data", "model")),
    "data4_model1": _mesh((4, 1), ("data", "model")),
    "data2_model2": _mesh((2, 2), ("data", "model")),
    "model2": _mesh((2,), ("model",)),
}
SPECS = [
    ((256, 22528), ("embed", "ff")),
    ((2048, 24, 64), ("embed", "heads", None)),
    ((256, 4096), ("batch", "seq")),
    ((2, 4096), ("batch", "seq")),
    ((64, 32), ("heads", "kv")),
    ((8, 8), ("embed", "ff")),
    ((6, 32, 32, 3), ("batch", "spatial", None, "conv_in")),
    ((8, 7), ("vocab", "experts")),
    ((4, 16, 8), ("batch", "seq_sp", "rnn")),
]


@pytest.mark.parametrize("mesh", sorted(MESHES) + [None])
def test_logical_spec_matches_jax_entry_for_entry(mesh):
    m = MESHES.get(mesh)
    for shape, axes in SPECS:
        for rules in (None, S.SERVE_RULES):
            got = S.logical_spec(shape, axes, mesh=m, rules=rules)
            want = JS.logical_spec(shape, axes, mesh=m, rules=rules)
            assert got == tuple(want), (shape, axes)
            assert isinstance(got, tuple) and len(got) == len(shape)


def test_logical_spec_reads_the_active_rules():
    m = MESHES["data16_model16"]
    with use_rules(mesh=m), JS.use_rules(mesh=m):
        assert S.logical_spec((256, 4096), ("batch", "seq")) == tuple(
            JS.logical_spec((256, 4096), ("batch", "seq"))) == ("data", None)
    assert S.current_rules() is None


@pytest.mark.parametrize("count", [1, 10**6, 2 * 10**9, 7 * 10**10,
                                   35 * 10**9])
def test_serve_rules_for_matches_jax(count):
    assert S.serve_rules_for(count) == JS.serve_rules_for(count)
    assert S.serve_rules_for(count, tp=4, bytes_per_param=4) == \
        JS.serve_rules_for(count, tp=4, bytes_per_param=4)
    assert S.DEFAULT_RULES == JS.DEFAULT_RULES
    assert S.SERVE_RULES == JS.SERVE_RULES


@pytest.mark.parametrize("mesh", sorted(MESHES) + [None])
def test_batch_mesh_axes_matches_jax(mesh):
    m = MESHES.get(mesh)
    with use_rules(mesh=m), JS.use_rules(mesh=m):
        got, want = S.batch_mesh_axes(), JS.batch_mesh_axes()
    if want is None:
        assert got is None
    else:
        assert got[0] is m and got[1:] == want[1:]
    assert S.batch_mesh_axes() is None


def test_rules_are_thread_local():
    seen = []
    with use_rules(mesh=MESHES["model2"]):
        t = threading.Thread(target=lambda: seen.append(S.current_rules()))
        t.start()
        t.join()
        assert S.current_rules()[1] is MESHES["model2"]
    assert seen == [None]


def test_mesh_layout_and_repeated_devices():
    m = Mesh(np.array(["cpu"] * 4, dtype=object).reshape(2, 2),
             ("data", "model"))
    assert m.shape == {"data": 2, "model": 2} and m.size == 4
    assert m.first_device == torch.device("cpu")
    assert m.device_at({"model": 1}) == torch.device("cpu")
    assert len(m.shard_devices(("data", "model"))) == 4
    assert m.shard_devices(()) == [torch.device("cpu")]
    with pytest.raises(ValueError, match="no axis"):
        m.device_at({"stage": 0})
    with pytest.raises(ValueError, match="axis names"):
        Mesh(["cpu"] * 2, ("data", "model"))
    with pytest.raises(ValueError, match="repeated"):
        Mesh(np.full((1, 1), "cpu", dtype=object), ("data", "data"))
    x = torch.ones(3)
    assert S.logical_constraint(x, "batch") is x


def test_host_and_production_meshes():
    if not torch.cuda.is_available():
        host = make_host_mesh()
        assert host.shape == {"data": 1, "model": 1}
        assert host.first_device == torch.device("cpu")
    four = make_host_mesh(["cpu"] * 4)
    assert four.shape == {"data": 4, "model": 1}
    with pytest.raises(ValueError, match="needs 256 devices, got 4"):
        make_production_mesh(["cpu"] * 4)
    with pytest.raises(ValueError, match="needs 512 devices"):
        make_production_mesh(["cpu"] * 256, multi_pod=True)
    prod = make_production_mesh(["cpu"] * 256)
    assert prod.shape == {"data": 16, "model": 16}
    pods = make_production_mesh(["cpu"] * 512, multi_pod=True)
    assert pods.axis_names == ("pod", "data", "model")


# -- the batch-sharded kernel path ------------------------------------------

def _dcl_inputs(n=4, h=16, w=16, c=8, m=8, seed=0):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(n, h, w, c).astype(np.float32))
    # ~1/3 of the taps beyond ±B = 2: the kernels clamp them.
    off = torch.from_numpy((rng.rand(n, h, w, 18) * 6 - 3)
                           .astype(np.float32))
    wt = torch.from_numpy((0.1 * rng.randn(9, c, m)).astype(np.float32))
    return x, off, wt


PIN = dict(tile_h=4, tile_w=8, tile_c=8, tile_m=8)


@pytest.mark.parametrize("shards", [2, 4])
def test_batch_sharded_deform_conv_equals_unsharded(shards):
    x, off, wt = _dcl_inputs()
    kw = dict(offset_bound=2.0, device="cpu", **PIN)
    seen = []

    def hook(ctx):
        seen.append(ctx["shards"])

    leaves = [t.clone().requires_grad_() for t in (x, off, wt)]
    ref = ops.deform_conv(*leaves, **kw)
    g_ref = torch.autograd.grad(torch.sin(ref).sum(), leaves)
    with use_rules(mesh=make_host_mesh(["cpu"] * shards)), \
            ops.dispatch_hook_scope(hook):
        y = ops.deform_conv(*leaves, **kw)
        assert y.grad_fn.name() == "BatchShardedDeformConvBackward"
        g = torch.autograd.grad(torch.sin(y).sum(), leaves)
    assert seen == [(shards, 1)]
    assert torch.equal(y, ref)
    for a, b in zip(g, g_ref):
        assert (a - b).abs().max() <= 1e-5 * b.abs().max()
    assert torch.equal(g[0], g_ref[0]) and torch.equal(g[1], g_ref[1])


def test_batch_shard_resolution_and_refusals():
    x, off, wt = _dcl_inputs(n=3)
    kw = dict(offset_bound=2.0, device="cpu")
    with pytest.raises(ValueError, match="no mesh maps the 'batch'"):
        ops.deform_conv(x, off, wt, shard_batch=True, **kw)
    mesh = make_host_mesh(["cpu"] * 2)
    with use_rules(mesh=mesh):
        # Auto: 3 does not divide 2, so the call runs whole.
        assert ops.resolve_batch_shard(3) is None
        assert ops.resolve_batch_shard(4).axes == ("data",)
        assert ops.resolve_batch_shard(4, shard_batch=False) is None
        with pytest.raises(ValueError, match=r"batch N=3 does not divide "
                                             r"the mesh batch axes"):
            ops.deform_conv(x, off, wt, shard_batch=True, **kw)
        with pytest.raises(ValueError, match="requires the bounded fp32"):
            ops.deform_conv(x, off, wt, shard_batch=True, precision="int8",
                            **kw)
        with pytest.raises(ValueError, match="requires the bounded fp32"):
            ops.deform_conv(x, off, wt, shard_batch=True, device="cpu")
    # A (1, 1) mesh has no axis to shard over.
    with use_rules(mesh=make_host_mesh(["cpu"])):
        assert ops.resolve_batch_shard(4) is None
    ops.check_batch_split(4, shards=2)
    with pytest.raises(ValueError, match="total size 4"):
        ops.check_batch_split(6, shards=4, axes=("pod", "data"))


# -- the data-parallel Trainer ------------------------------------------------

def _perturbed(seed=0):
    params = jax.tree_util.tree_map(np.asarray, JR.init_params(
        jax.random.PRNGKey(seed), JR.ResNetDCNConfig(**SMALL)))
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


def _flat(tree):
    return np.concatenate([np.asarray(x, np.float32).ravel()
                           for x in jax.tree_util.tree_leaves(tree)])


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    cfg = JR.ResNetDCNConfig(**SMALL, use_kernel=True)
    data = JDataCfg(**DATA)
    tr = JTrainer(
        loss_fn=lambda p, b: JR.train_loss(p, cfg, b, lam=0.1),
        params=jax.tree_util.tree_map(jnp.asarray, _perturbed()),
        optimizer=JOPT.sgd(JOPT.constant(0.01), momentum=0.9,
                           weight_decay=1e-4),
        mesh=None, param_specs=None,
        batch_fn=lambda s: j_detection_batch(data, s),
        config=JTrainerConfig(total_steps=3, ckpt_every=100,
                              ckpt_dir=str(tmp_path_factory.mktemp("j")),
                              log_every=1))
    tr.run()
    return tr


def _torch_trainer(tmp_path, mesh, **kw):
    cfg = TRN.ResNetDCNConfig(**SMALL, use_kernel=True)
    data = DetectionDataConfig(**DATA)
    return Trainer(
        loss_fn=lambda p, b: TRN.train_loss(p, cfg, b, lam=0.1,
                                            device="cpu"),
        params=params_from_jax(_perturbed(), device="cpu"),
        optimizer=TOPT.sgd(TOPT.constant(0.01), momentum=0.9,
                           weight_decay=1e-4),
        batch_fn=lambda s: detection_batch(data, s),
        config=TrainerConfig(total_steps=3, ckpt_every=100,
                             ckpt_dir=str(tmp_path), log_every=1),
        device="cpu", mesh=mesh, **kw)


@pytest.mark.parametrize("shards", [2, 4])
def test_data_parallel_trainer_matches_jax(tmp_path, jax_run, shards):
    mesh = make_host_mesh(["cpu"] * shards)
    tt = _torch_trainer(tmp_path, mesh)
    seen = []
    with ops.dispatch_hook_scope(lambda ctx: seen.append(ctx["shards"])), \
            rows_round_alike():
        tt.run()
    # Every layer runs per data shard: both DCLs of each of the 3 steps
    # ran once in each of the `shards` data shards, on its rows alone.
    assert seen == [(1, 1, shards)] * (6 * shards)
    assert tt.batch_specs["images"] == ("data", None, None, None)
    jl = [h["loss"] for h in jax_run.history if "loss" in h]
    tl = [h["loss"] for h in tt.history if "loss" in h]
    assert len(tl) == len(jl) == 3
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    p0 = _flat(_perturbed())
    jp = _flat(jax.tree_util.tree_map(np.asarray, jax_run.params))
    tp = _flat(T.tree_map(lambda t: t.detach().numpy(), tt.params))
    flat = _torch_trainer(tmp_path / "flat", None)
    with rows_round_alike():
        flat.run()
    fp = _flat(T.tree_map(lambda t: t.detach().numpy(), flat.params))
    # The shards change only the order the gradients are summed in.
    assert _rel(tp, fp) <= 1e-5
    # At batch 4 the port's single-device Trainer itself lies 1.04e-4
    # (params) and 1.48e-3 (the update) from JAX's: the kernel path's
    # band-local frames against JAX's XLA path on this host, where
    # d_offsets jumps as a tap crosses an integer (test_torch_train holds
    # batch 2 at 1e-4 / 1e-3).  The gates leave that reading 2x room.
    assert _rel(tp, jp) <= 2e-4
    assert _rel(tp - p0, jp - p0) <= 2e-3          # the update itself


def test_trainer_mesh_checks(tmp_path):
    mesh = make_host_mesh(["cpu"] * 2)
    specs = T.tree_map(lambda p: (None,) * p.ndim,
                       params_from_jax(_perturbed(), device="cpu"))
    tt = _torch_trainer(tmp_path, mesh, param_specs=specs)
    assert tt.param_specs is specs and tt.mesh is mesh
    bad = T.tree_map(lambda s: s[:-1] if s else (None,), specs)
    with pytest.raises(ValueError, match="does not fit a param"):
        _torch_trainer(tmp_path, mesh, param_specs=bad)
    # An odd batch stays whole on the mesh (no batch split).
    tt._device_batch(0)
    odd = {"images": np.zeros((3, 32, 32, 3), np.float32)}
    tt.batch_fn = lambda s: odd
    assert tt._device_batch(0)["images"].shape[0] == 3
    assert tt.batch_specs["images"] == (None, None, None, None)
