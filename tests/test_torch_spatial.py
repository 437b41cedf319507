"""Port parity: the height-sharded bounded DCL of ``repro_torch``
(``distributed.spatial``, ``ops.deform_conv(shard_spatial=True)``, the
plans, the layer refusals and the serving engine's spatial buckets)
against the port's unsharded path and the JAX package.

Meshes repeat the CPU, so every shard, halo exchange and kernel call
runs in-process.  Offsets are drawn so about a third of the taps exceed
±B (the kernels clamp them), which puts samples in the rows next to the
shard seams.  Tolerances: with pinned tiles (tile_h dividing the shard's
rows), fp32 and int8 ``torch.equal`` to the port's unsharded path (the
same band-local arithmetic on the same rows); fp32 within 1e-5 of the
largest |y| of JAX's single-device ``ops.deform_conv`` (interpret mode),
int8 within one output LSB of it (offsets on the 1/8 grid, as
``test_torch_int8.py``); gradients within 1e-4 of JAX's ``jax.grad`` (the
halo rows' d_input is summed from two shards); the chooser's shard-local
tiles within 1e-5 of the largest |y|.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.tiling import spatial_halo_rows as j_halo
from repro.distributed import spatial as JSP
from repro.kernels import ops as JO
from repro_torch.core.tiling import spatial_halo_rows
from repro_torch.distributed import spatial as SP
from repro_torch.distributed.sharding import Mesh, use_rules
from repro_torch.kernels import ops, plan
from repro_torch.models import layers as TL
from repro_torch.models import resnet_dcn as R
from repro_torch.obs import Tracer, tracer_scope
from repro_torch.obs.divergence import key_from_context, price_dispatch
from repro_torch.quant.calibrate import calibrate_resnet_dcn
from repro_torch.serve import DCLServeConfig, DCLServingEngine
from repro_torch.serve.dcl_engine import bucket_layer_dims

torch.set_num_threads(2)

B = 2.0
PIN = dict(tile_h=4, tile_w=8, tile_c=8, tile_m=8)


def _mesh(n, names=("model",)):
    return Mesh(np.full((n,) if len(names) == 1 else n, "cpu",
                        dtype=object), names)


def _inputs(n=1, h=32, w=32, c=8, m=8, seed=0, grid=False):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, h, w, c).astype(np.float32)
    off = (rng.rand(n, h, w, 18) * 6 - 3).astype(np.float32)
    if grid:
        off = np.round(off * 8) / 8
    wgt = (0.1 * rng.randn(9, c, m)).astype(np.float32)
    return x, off, wgt


def _t(*arrays):
    return [torch.from_numpy(np.array(a, copy=True)) for a in arrays]


@pytest.fixture(scope="module")
def arrays():
    x, off, wgt = _inputs()
    assert 0.2 < float(np.mean(np.abs(off) > B)) < 0.5
    return x, off, wgt


@pytest.fixture(scope="module")
def jax_fp32(arrays):
    x, off, wgt = arrays
    return np.asarray(JO.deform_conv(*map(jnp.asarray, arrays),
                                     offset_bound=B, **PIN))


def _sharded(shards, *args, names=("model",), **kw):
    with use_rules(mesh=_mesh(shards, names)):
        return ops.deform_conv(*args, offset_bound=B, shard_spatial=True,
                               device="cpu", **kw)


# -- the halo algebra and the split checks -------------------------------------

@pytest.mark.parametrize("k,d,b", [(3, 1, 2.0), (3, 1, 1.5), (3, 2, 2.0),
                                   (5, 1, 0.0), (1, 1, 3.0)])
def test_halo_rows_match_jax(k, d, b):
    want = j_halo(kernel_size=k, dilation=d, offset_bound=b)
    assert spatial_halo_rows(kernel_size=k, dilation=d,
                             offset_bound=b) == want
    assert SP.halo_rows(kernel_size=k, dilation=d, offset_bound=b) == want
    assert spatial_halo_rows(kernel_size=3, offset_bound=2.0) == 4
    with pytest.raises(ValueError):
        spatial_halo_rows(kernel_size=0, offset_bound=1.0)


@pytest.mark.parametrize("h,shards,stride,min_rows", [
    (30, 4, 1, None), (32, 4, 2, 4), (12, 4, 1, 4), (16, 2, 2, None),
    (32, 0, 1, None), (8, 1, 1, 4)])
def test_check_height_split_raises_jaxs_errors(h, shards, stride, min_rows):
    kw = dict(shards=shards, stride=stride, min_rows=min_rows)
    try:
        JSP.check_height_split(h, **kw)
        want = None
    except ValueError as e:
        want = str(e).replace("shard_map", "path")
    if want is None:
        SP.check_height_split(h, **kw)
    else:
        with pytest.raises(ValueError) as got:
            SP.check_height_split(h, **kw)
        assert str(got.value).split(";")[0] == want.split(";")[0]


# -- the forward --------------------------------------------------------------

@pytest.mark.parametrize("shards", [1, 2, 4])
def test_fp32_pinned_equals_unsharded_and_jax(arrays, jax_fp32, shards):
    x, off, wgt = _t(*arrays)
    ref = ops.deform_conv(x, off, wgt, offset_bound=B, device="cpu", **PIN)
    y = _sharded(shards, x, off, wgt, **PIN)
    assert torch.equal(y, ref)
    scale = np.abs(jax_fp32).max()
    assert np.abs(y.numpy() - jax_fp32).max() <= 1e-5 * scale
    # The seam rows (each shard's first and last) see clamped taps.
    assert y.shape == ref.shape == (1, 32, 32, 8)


def test_fp32_chooser_tiles_within_1e5(arrays):
    x, off, wgt = _t(*arrays)
    ref = ops.deform_conv(x, off, wgt, offset_bound=B, device="cpu")
    y = _sharded(4, x, off, wgt)
    assert (y - ref).abs().max() <= 1e-5 * ref.abs().max()


@pytest.mark.parametrize("shards", [2, 4])
def test_int8_pinned_equals_unsharded_and_within_one_lsb_of_jax(shards):
    arrays = _inputs(seed=1, grid=True)
    x, off, wgt = _t(*arrays)
    kw = dict(precision="int8", **PIN)
    ref = ops.deform_conv(x, off, wgt, offset_bound=B, device="cpu", **kw)
    y = _sharded(shards, x, off, wgt, **kw)
    assert torch.equal(y, ref)
    want = np.asarray(JO.deform_conv(*map(jnp.asarray, arrays),
                                     offset_bound=B, **kw))
    lsb = (np.abs(arrays[0]).max() / 127) * \
        (np.abs(arrays[2]).max(axis=(0, 1)) / 127)
    assert float((np.abs(y.numpy() - want) / lsb).max()) <= 1.0


def test_int8_scales_are_global():
    """A per-shard absmax would quantize each shard on its own grid: make
    one shard's activations 10x the other's."""
    x, off, wgt = _inputs(h=16, seed=2)
    x[:, 8:] *= 10
    x, off, wgt = _t(x, off, wgt)
    ref = ops.deform_conv(x, off, wgt, offset_bound=B, device="cpu",
                          precision="int8", **PIN)
    assert torch.equal(_sharded(2, x, off, wgt, precision="int8", **PIN),
                       ref)


def test_stride2_and_2d_mesh():
    x, off, wgt = _t(*_inputs(n=2, h=16, w=16, seed=3))
    off2 = off[:, ::2, ::2].contiguous()
    ref = ops.deform_conv(x, off2, wgt, offset_bound=B, stride=2,
                          device="cpu", tile_h=2, tile_w=8, tile_c=8)
    y = _sharded(4, x, off2, wgt, stride=2, tile_h=2, tile_w=8, tile_c=8)
    assert torch.equal(y, ref)
    ref = ops.deform_conv(x, off, wgt, offset_bound=B, device="cpu", **PIN)
    seen = []
    with ops.dispatch_hook_scope(lambda ctx: seen.append(ctx["shards"])):
        y = _sharded((2, 2), x, off, wgt, names=("data", "model"),
                     shard_batch=True, **PIN)
    assert torch.equal(y, ref) and seen == [(2, 2)]


# -- the gradient --------------------------------------------------------------

@pytest.mark.parametrize("shards", [2, 4])
def test_gradients_match_jax_grad(arrays, shards):
    def loss_j(a, b, c):
        return jnp.sum(jnp.sin(JO.deform_conv(a, b, c, offset_bound=B,
                                              **PIN)))
    want = jax.grad(loss_j, argnums=(0, 1, 2))(*map(jnp.asarray, arrays))
    leaves = [t.requires_grad_() for t in _t(*arrays)]
    y = _sharded(shards, *leaves, **PIN)
    assert y.grad_fn.name() == "DeformConvSpatialBackward"
    got = torch.autograd.grad(torch.sin(y).sum(), leaves)
    ref = torch.autograd.grad(torch.sin(ops.deform_conv(
        *leaves, offset_bound=B, device="cpu", **PIN)).sum(), leaves)
    for name, g, r, w in zip(("dx", "doff", "dw"), got, ref, want):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-4 * np.abs(w).max(), name
        assert (g - r).abs().max() <= 1e-5 * r.abs().max(), name


# -- refusals --------------------------------------------------------------------

def test_refusals_name_their_cause():
    x, off, wgt = _t(*_inputs())
    with pytest.raises(ValueError, match="no mesh maps the 'spatial'"):
        ops.deform_conv(x, off, wgt, offset_bound=B, shard_spatial=True,
                        device="cpu")
    with use_rules(mesh=_mesh(4)):
        with pytest.raises(ValueError, match="requires a trained "
                                             "offset_bound"):
            ops.deform_conv(x, off, wgt, shard_spatial=True, device="cpu")
        with pytest.raises(ValueError, match="only the zero-copy"):
            ops.deform_conv(x, off, wgt, offset_bound=B, shard_spatial=True,
                            dataflow="banded", device="cpu")
        with pytest.raises(ValueError, match="does not evenly divide"):
            ops.deform_conv(x[:, :30], off[:, :30], wgt, offset_bound=B,
                            shard_spatial=True, device="cpu")
        with pytest.raises(ValueError, match="thinner than the 4-row halo"):
            ops.deform_conv(x[:, :12], off[:, :12], wgt, offset_bound=B,
                            shard_spatial=True, device="cpu")
        # Off (None/False) is never sharded.
        assert SP.resolve_spatial_shard(32, shard_spatial=None) is None
    with use_rules(mesh=_mesh((2, 2), ("data", "model")),
                   rules={"batch": "model", "spatial": "model"}):
        with pytest.raises(ValueError, match="already used by the batch"):
            SP.resolve_spatial_shard(32, offset_bound=B, shard_spatial=True,
                                     batch_axes=("model",))
    with use_rules(mesh=_mesh((2, 2), ("data", "model")),
                   rules={"spatial": ("data", "model")}):
        with pytest.raises(ValueError, match="exactly one mesh axis"):
            SP.spatial_mesh_axes()


def test_dcl_apply_refuses_chain_and_reference_paths():
    rng = np.random.RandomState(0)
    params = {k: torch.from_numpy((rng.randn(*s) * 0.1).astype(np.float32))
              for k, s in (("w_offset", (3, 3, 8, 18)), ("b_offset", (18,)),
                           ("w_deform", (3, 3, 8, 8)), ("b_deform", (8,)))}
    x = torch.from_numpy(rng.randn(1, 16, 16, 8).astype(np.float32))
    kw = dict(offset_bound=B, use_kernel=True, device="cpu")
    scales = {"x_scale": 0.05, "y_scale": 0.05}
    for flag in ("shard_spatial", "shard_batch"):
        with pytest.raises(ValueError, match=f"{flag}=True is not supported "
                                             f"by the chained int8"):
            TL.dcl_apply(params, x, quant="int8_chain", quant_scales=scales,
                         **kw, **{flag: True})
    with pytest.raises(ValueError, match="requires the bounded kernel"):
        TL.dcl_apply(params, x, offset_bound=B, use_kernel=False,
                     shard_spatial=True, device="cpu")
    with pytest.raises(ValueError, match="requires the bounded fp32"):
        TL.dcl_apply(params, x, quant="int8", shard_batch=True, **kw)
    with use_rules(mesh=_mesh(2)):
        y, _ = TL.dcl_apply(params, x, shard_spatial=True, **kw)
    y0, _ = TL.dcl_apply(params, x, **kw)
    assert (y - y0).abs().max() <= 1e-5 * y0.abs().max()


# -- plans and pricing ------------------------------------------------------------

def test_plans_resolve_at_the_shard_height():
    dims = {"a": dict(h=32, w=32, c=8, m=8), "b": dict(h=16, w=16, c=8, m=8,
                                                       stride=2)}
    tiles, src = plan.warm_tile_cache(dims, batch=2, offset_bound=B,
                                      spatial_shards=2)
    local, _ = plan.warm_tile_cache(
        {"a": dict(h=16, w=32, c=8, m=8),
         "b": dict(h=8, w=16, c=8, m=8, stride=2)}, batch=2, offset_bound=B)
    assert tiles == local and set(src.values()) == {"analytic"}
    assert plan.tile_source(2, 32, 32, 8, 8, offset_bound=B,
                            spatial_shards=2) == "analytic"
    with pytest.raises(ValueError, match="layer 'b'.*thinner"):
        plan.warm_tile_cache(dims, batch=2, offset_bound=B, spatial_shards=8)
    with pytest.raises(ValueError, match="layer 'a'.*does not evenly"):
        plan.warm_tile_cache({"a": dict(h=30, w=32, c=8, m=8)}, batch=2,
                             offset_bound=B, spatial_shards=4)


def test_a_sharded_dispatch_is_priced_as_all_its_shards():
    ctx = dict(op="deform_conv", precision="fp32", dataflow="zero_copy",
               shape=(4, 64, 64, 128), m=128, offset_bound=B, kernel_size=3,
               stride=1, dilation=1, device="cpu", itemsize=4,
               offset_itemsize=4, tiles=(None,) * 4)
    flat = price_dispatch(ctx)
    split = price_dispatch(dict(ctx, shards=(1, 4)))
    assert key_from_context(dict(ctx, shards=(1, 4))).label().endswith(
        "@1x4shard")
    assert key_from_context(ctx).label().endswith("/none")
    # The same pixels and products; the weights read once a shard.
    assert split["ops"] == flat["ops"]
    k2cm = 9 * 128 * 128 * 4
    assert split["bytes"] == flat["bytes"] + 3 * k2cm
    assert split["bound_s"] >= flat["bound_s"]


# -- the serving engine -----------------------------------------------------------

SHALLOW = dict(stage_sizes=(1, 1), widths=(16, 32), stem_width=8,
               num_dcn=2, num_classes=4, img_size=32, offset_bound=2.0,
               use_kernel=True)


@pytest.fixture(scope="module")
def shallow():
    cfg = R.ResNetDCNConfig(**SHALLOW)
    params = R.init_params(cfg, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for block in params.values():
        if "dcl" in block:
            d = block["dcl"]
            d["w_offset"] = torch.randn(d["w_offset"].shape, generator=gen) \
                / (4.5 * d["w_offset"].shape[2]) ** 0.5
            d["b_offset"] = torch.randn(d["b_offset"].shape,
                                        generator=gen) * 0.5
    rng = np.random.RandomState(0)
    table = calibrate_resnet_dcn(
        params, cfg, [rng.randn(2, 32, 32, 3).astype(np.float32)],
        device="cpu")
    return cfg, params, table


def _serve(shallow, quant, shards, devices=("cpu",) * 2):
    cfg, params, table = shallow
    eng = DCLServingEngine(
        params, cfg, DCLServeConfig(buckets=(32,), slots=2, quant=quant,
                                    spatial_shards=shards),
        scale_table=table, device="cpu", devices=list(devices))
    reqs = [eng.submit(np.random.RandomState(7 + i).randn(32, 32, 3)
                       .astype(np.float32)) for i in range(3)]
    eng.run_until_drained()
    return eng, reqs


@pytest.mark.parametrize("quant", ["fp32_kernel", "int8", "int8_chain"])
def test_engine_spatial_bucket_matches_the_flat_engine(shallow, quant):
    dims = bucket_layer_dims(R.ResNetDCNConfig(**SHALLOW), 32)
    assert [d["h"] for d in dims.values()] == [8, 8]
    flat, fr = _serve(shallow, "int8" if quant == "int8_chain" else quant,
                      ())
    seen = []
    with ops.dispatch_hook_scope(lambda ctx: seen.append(ctx["shards"])), \
            tracer_scope(Tracer()):     # dispatches are timed when tracing
        eng, sr = _serve(shallow, quant, ((32, 2),))
    assert seen == [(1, 2)] * 4                     # 2 steps x 2 DCLs
    rung = "fp32_kernel" if quant == "fp32_kernel" else "int8"
    for a, b in zip(sr, fr):
        assert a.outcome == b.outcome == "ok"
        assert a.ladder == rung and not a.degraded
        for key in ("cls", "box"):
            got, want = a.result[key], b.result[key]
            tol = 1e-5 if rung == "fp32_kernel" else 2e-2
            assert np.abs(got - want).max() <= tol * np.abs(want).max()
    tel = eng.telemetry()
    assert tel["engine"]["spatial_shards"] == [[32, 2]]
    assert set(tel["plan_sources"]["32"].values()) == {"analytic@2shard"}
    rows = tel["divergence"]["dispatches"]
    assert len(rows) == 2 and sum(r["n"] for r in rows) == 4
    assert all(r["key"].endswith("@1x2shard") and r["bound_s"] > 0
               for r in rows)


def test_engine_spatial_construction_errors(shallow):
    cfg, params, table = shallow
    with pytest.raises(ValueError, match="exceeds the 2 available"):
        DCLServingEngine(params, cfg, DCLServeConfig(
            buckets=(32,), slots=2, quant="fp32_kernel",
            spatial_shards=((32, 8),)), device="cpu", devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="exceeds the 1 available"):
        DCLServingEngine(params, cfg, DCLServeConfig(
            buckets=(32,), slots=2, quant="fp32_kernel",
            spatial_shards=((32, 2),)), device="cpu")
    with pytest.raises(ValueError, match="s0b0.*thinner than the 4-row"):
        DCLServingEngine(params, cfg, DCLServeConfig(
            buckets=(32,), slots=2, quant="fp32_kernel",
            spatial_shards=((32, 4),)), device="cpu", devices=["cpu"] * 4)
    unbounded = dataclasses.replace(cfg, offset_bound=None)
    with pytest.raises(ValueError, match="needs a trained offset_bound"):
        DCLServingEngine(params, unbounded, DCLServeConfig(
            buckets=(32,), slots=2, quant="fp32_ref",
            spatial_shards=((32, 2),)), device="cpu", devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="not in buckets"):
        DCLServeConfig(buckets=(32,), spatial_shards=((64, 2),))
    with pytest.raises(ValueError, match="must be >= 1"):
        DCLServeConfig(buckets=(32,), spatial_shards=((32, 0),))
    with pytest.raises(ValueError, match="pairs"):
        DCLServeConfig(buckets=(32,), spatial_shards=((32,),))
    assert DCLServeConfig(buckets=(32, 64), spatial_shards=((64, 2),)) \
        .spatial_shards_for(32) == 1
