"""Port parity: the int8 DCL datapath (kernels 1c and 1d: their plain
versions, plan, ops, ``dcl_apply``, the model) of ``repro_torch`` against
the JAX package, whose Pallas kernels run in interpret mode.

Tolerances, with their reasons:

* the plain kernels at the JAX kernels' tiles: exact.  Both sample band by
  band with the same fp32 operations and contract integers exactly, so
  the int8 patches, the int32 sums and the emitted int8 agree; the fp32
  epilogues agree to one fp32 rounding (XLA may fuse ``acc * s + b``);
* through ``ops`` (each package picks its own tiles, so the band-local
  frames differ and a patch at a rounding tie may round the other way):
  <= 1 LSB of the output grid with offsets on the 1/8 grid (exact in any
  frame, as ``tests/test_quant.py`` arranges), and of the emission grid
  for the chain, whose share of differing elements is printed;
* the small model: relative norm of ``cls`` < 1e-4, the JAX package's own
  kernel-vs-reference bar (``tests/test_quant.py``).
"""
import dataclasses
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import band_pipeline as JB
from repro.kernels import deform_conv_q as JQK
from repro.kernels import ops as JO
from repro.kernels import plan as JP
from repro.models import layers as JL
from repro.models import resnet_dcn as JR
from repro.quant import qtypes as JQ
from repro_torch.convert import params_from_jax
from repro_torch.core import tiling as TT
from repro_torch.kernels import band_pipeline as TB
from repro_torch.kernels import deform_conv_q as TQK
from repro_torch.kernels import ops as TO
from repro_torch.models import layers as TL
from repro_torch.models import resnet_dcn as TR
from repro_torch.quant.qtypes import QTensor

torch.set_num_threads(2)

# (name, H, W, C, M, K, stride, dil, bound, off_scale): tests/test_quant.py
EDGE_CASES = [
    ("ragged_h", 13, 16, 4, 8, 3, 1, 1, 2.0, 1.0),
    ("ragged_w", 16, 18, 4, 8, 3, 1, 1, 2.0, 1.0),
    ("ragged_hw", 11, 13, 4, 4, 3, 1, 1, 1.5, 1.0),
    ("stride2", 16, 16, 4, 8, 3, 2, 1, 2.0, 1.0),
    ("dilation2", 16, 16, 4, 8, 3, 1, 2, 2.0, 1.0),
    ("clamp_hit", 12, 12, 4, 8, 3, 1, 1, 1.0, 4.0),
    ("stride2_ragged_clamp", 15, 13, 4, 4, 3, 2, 1, 1.5, 4.0),
    ("multi_c_chunk", 16, 16, 8, 8, 3, 1, 1, 2.0, 1.0),
]
# (name, H, W, C, M, K, stride, dil, bound): tests/test_chain.py
GEOMS = [
    ("base", 16, 16, 8, 8, 3, 1, 1, 2.0),
    ("ragged", 13, 15, 4, 8, 3, 1, 1, 2.0),
    ("stride2", 16, 16, 4, 8, 3, 2, 1, 2.0),
    ("dilation2", 16, 16, 4, 4, 3, 1, 2, 1.5),
]


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _rng(name):
    return np.random.RandomState(zlib.crc32(name.encode()) % (2 ** 31))


def _out_hw(h, w, k, s, d):
    pad = d * (k // 2)
    return ((h + 2 * pad - d * (k - 1) - 1) // s + 1,
            (w + 2 * pad - d * (k - 1) - 1) // s + 1)


def _edge_arrays(case, grid):
    name, h, w, c, m, k, s, d, b, osc = case
    rng = _rng(name)
    ho, wo = _out_hw(h, w, k, s, d)
    x = rng.randn(2, h, w, c).astype(np.float32)
    off = (rng.randn(2, ho, wo, 2 * k * k) * osc).astype(np.float32)
    if grid:
        off = np.round(off * 8) / 8
    wgt = (rng.randn(k * k, c, m) * 0.2).astype(np.float32)
    return x, off, wgt


def _chain_layer(name, c, m, k):
    rng = _rng(name)
    k2 = k * k
    lay = {"w": rng.randn(k2, c, m) * 0.2,
           "w_off": rng.randn(k2, c, 2 * k2) * 0.1,
           "b_off": rng.randn(2 * k2) * 0.5,
           "b": rng.randn(m) * 0.1}
    return {key: v.astype(np.float32) for key, v in lay.items()}


def _absmax(a, axis=None):
    if axis is None:
        return float(np.abs(a).max() / 127)
    return (np.abs(a).max(axis=tuple(range(a.ndim - 1))) / 127) \
        .astype(np.float32)


# -- plain stages --------------------------------------------------------------

@pytest.mark.parametrize("grid", [True, False])
def test_bilinear_int8_from_band_matches_jax(grid):
    rng = np.random.RandomState(1)
    k, s, d, b, th, tw, tc = 3, 1, 1, 2.0, 4, 5, 8
    bh = TT.band_extent(th, kernel_size=k, stride=s, offset_bound=b)
    bw = TT.band_extent(tw, kernel_size=k, stride=s, offset_bound=b)
    band = rng.randint(-127, 128, size=(bh, bw, tc)).astype(np.int8)
    off = (rng.randn(th, tw, k * k, 2) * 1.6).astype(np.float32)
    if grid:
        off = np.round(off * 8) / 8
    kw = dict(kernel_size=k, stride=s, dilation=d, offset_bound=b,
              tile_h=th, wo=tw)
    want = np.asarray(JB._bilinear_int8_from_band(jnp.asarray(band),
                                                  jnp.asarray(off), **kw))
    got = TB.bilinear_int8_from_band(_t(band), _t(off), **kw).numpy()
    assert got.dtype == np.int8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("s,d", [(1, 1), (2, 1), (1, 2)])
def test_offset_conv_stage_matches_jax(s, d):
    rng = np.random.RandomState(2 + s + d)
    k, b, th, tw, c = 3, 2.0, 3, 4, 8
    k2 = k * k
    bh = TT.band_extent(th, kernel_size=k, stride=s, dilation=d,
                        offset_bound=b)
    bw = TT.band_extent(tw, kernel_size=k, stride=s, dilation=d,
                        offset_bound=b)
    band = rng.randint(-127, 128, size=(bh, bw, c)).astype(np.int8)
    woff = rng.randint(-127, 128, size=(k2 * c, 2 * k2)).astype(np.int8)
    scale = (rng.rand(2 * k2) * 1e-4).astype(np.float32)
    bias = rng.randn(2 * k2).astype(np.float32)
    plan = JB.DCLPlan(band=JB.BandSpec(k, s, d, b, th, tw), tile_c=c,
                      tile_m=8, band_dtype="int8", acc_dtype="int32",
                      epilogue="requant", fuse_offsets=True)
    want = np.asarray(JB.offset_conv_stage(
        plan, jnp.asarray(band), jnp.asarray(woff)[None],
        jnp.asarray(scale)[None], jnp.asarray(bias)[None]))
    got = TB.offset_conv_stage(_t(band), _t(woff), _t(scale), _t(bias),
                               kernel_size=k, stride=s, dilation=d,
                               offset_bound=b, tile_h=th, tile_w=tw)
    assert tuple(got.shape) == want.shape == (th, tw, k2, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


# -- kernel 1c -----------------------------------------------------------------

def _q_inputs(case, grid):
    """The JAX plan's int8 inputs of one edge case at 4x4 tiles."""
    name, h, w, c, m, k, s, d, b, _ = case
    x, off, wgt = _edge_arrays(case, grid)
    ho, wo = off.shape[1], off.shape[2]
    th, tw, tc = min(4, ho), min(4, wo), 4
    sx = JQ.compute_scale(jnp.asarray(x))
    sw = JQ.compute_scale(jnp.asarray(wgt), axis=-1)
    ph, pw = (-ho) % th, (-wo) % tw
    xp = JP.pad_zerocopy(JQ.quantize_values(jnp.asarray(x), sx),
                         kernel_size=k, stride=s, dilation=d,
                         offset_bound=b, tile_h=th, tile_w=tw, ho=ho + ph,
                         wo=wo + pw)
    wt = JP.tile_weights(JQ.quantize_values(jnp.asarray(wgt), sw), tc)
    scale = (sx * sw).reshape(1, m)
    kw = dict(kernel_size=k, stride=s, dilation=d, offset_bound=b,
              tile_h=th, tile_w=tw, tile_c=tc, tile_m=m)
    return xp, off, wt, scale, kw


@pytest.mark.parametrize("grid", [True, False], ids=["grid8", "free"])
@pytest.mark.parametrize("case", EDGE_CASES, ids=lambda c: c[0])
def test_plain_q_kernel_matches_pallas(case, grid):
    xp, off, wt, scale, kw = _q_inputs(case, grid)
    ho, wo = off.shape[1], off.shape[2]
    offp = jnp.pad(jnp.asarray(off), ((0, 0), (0, (-ho) % kw["tile_h"]),
                                      (0, (-wo) % kw["tile_w"]), (0, 0)))
    want = np.asarray(JQK.deform_conv_fused_zerocopy_q(
        xp, offp, wt, scale, interpret=True, **kw))[:, :ho, :wo]
    got = TQK.deform_conv_fused_zerocopy_q(
        _t(xp), _t(off), _t(wt), _t(scale).reshape(-1), **kw).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    lsb = np.asarray(scale).reshape(-1)
    err = np.abs(got - want) / lsb
    if grid:
        np.testing.assert_array_equal(got, want)
    assert float(err.max()) <= 1.0, float(err.max())


@pytest.mark.parametrize("case", [EDGE_CASES[i] for i in (0, 3, 4, 6, 7)],
                         ids=lambda c: c[0])
def test_ops_int8_matches_jax(case):
    name, h, w, c, m, k, s, d, b, _ = case
    x, off, wgt = _edge_arrays(case, grid=True)
    kw = dict(kernel_size=k, stride=s, dilation=d, offset_bound=b,
              precision="int8")
    want = np.asarray(JO.deform_conv(jnp.asarray(x), jnp.asarray(off),
                                     jnp.asarray(wgt), **kw))
    got = TO.deform_conv(_t(x), _t(off), _t(wgt), device="cpu", **kw)
    lsb = _absmax(x) * _absmax(wgt, -1)
    assert float((np.abs(got.numpy() - want) / lsb).max()) <= 1.0


def test_ops_int8_calibrated_scales_and_close_to_fp32():
    x, off, wgt = _edge_arrays(("scales",) + EDGE_CASES[0][1:], grid=True)
    sx, sw = _absmax(x), _absmax(wgt, -1)
    kw = dict(offset_bound=2.0, device="cpu")
    coarse = TO.deform_conv(_t(x), _t(off), _t(wgt), precision="int8",
                            x_scale=2 * sx, w_scale=sw, **kw).numpy()
    want = np.asarray(JO.deform_conv(
        jnp.asarray(x), jnp.asarray(off), jnp.asarray(wgt), offset_bound=2.0,
        precision="int8", x_scale=jnp.float32(2 * sx),
        w_scale=jnp.asarray(sw)))
    assert float((np.abs(coarse - want) / (2 * sx * sw)).max()) <= 1.0
    fine = TO.deform_conv(_t(x), _t(off), _t(wgt), precision="int8", **kw)
    fp32 = TO.deform_conv(_t(x), _t(off), _t(wgt), **kw)
    assert float((fine - fp32).norm() / fp32.norm()) < 0.05


# -- kernel 1d -----------------------------------------------------------------

def _chain_kwargs(geom, x, lay):
    name, h, w, c, m, k, s, d, b = geom
    sx = _absmax(x)
    return dict(kernel_size=k, stride=s, dilation=d, offset_bound=b,
                x_scale=sx, w_scale=_absmax(lay["w"], -1),
                w_offset_scale=_absmax(lay["w_off"], -1), y_scale=0.9 * sx)


def _both_chains(geom, emit, **tiles):
    name, h, w, c, m, k, s, d, b = geom
    x = _rng(name).randn(2, h, w, c).astype(np.float32)
    lay = _chain_layer(name, c, m, k)
    kw = dict(_chain_kwargs(geom, x, lay), emit=emit, **tiles)
    if emit == "fp32":
        kw["y_scale"] = None
    jkw = {key: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for key, v in kw.items()}
    names = ("w", "w_off", "b_off", "b")
    want = np.asarray(JO.deform_conv_chain(
        jnp.asarray(x), *(jnp.asarray(lay[n]) for n in names), **jkw))
    got = TO.deform_conv_chain(_t(x), *(_t(lay[n]) for n in names),
                               device="cpu", **kw).numpy()
    return got, want, kw


@pytest.mark.parametrize("geom", GEOMS, ids=lambda g: g[0])
def test_plain_chain_matches_jax_at_its_tiles(geom):
    """At the JAX kernel's spatial tiles the int8 emission is identical
    (the port streams C in chunks of its own; integer sums do not care)."""
    got, want, kw = _both_chains(geom, "int8", tile_h=4, tile_w=4)
    assert got.dtype == want.dtype == np.int8
    np.testing.assert_array_equal(got, want)
    got, want, kw = _both_chains(geom, "fp32", tile_h=4, tile_w=4)
    lsb = kw["x_scale"] * kw["w_scale"]
    assert float((np.abs(got - want) / lsb).max()) <= 1.0


@pytest.mark.parametrize("geom", GEOMS, ids=lambda g: g[0])
def test_chain_matches_jax_ops(geom):
    got, want, _ = _both_chains(geom, "int8")
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    print(f"{geom[0]}: {np.mean(diff > 0):.5f} of the int8 emission differs "
          f"(max {diff.max()} LSB)")
    assert diff.max() <= 1


def test_chain_int8_input_consumed_verbatim_and_tile_c_free():
    geom = GEOMS[0]
    name, h, w, c, m, k, s, d, b = geom
    x = _rng("verbatim").randn(2, h, w, c).astype(np.float32)
    lay = _chain_layer(name, c, m, k)
    kw = dict(_chain_kwargs(geom, x, lay), emit="int8", device="cpu")
    args = [_t(lay[n]) for n in ("w", "w_off", "b_off", "b")]
    head = TO.deform_conv_chain(_t(x), *args, **kw)
    xq = torch.clamp(torch.round(_t(x) / kw["x_scale"]), -127, 127) \
        .to(torch.int8)
    verbatim = TO.deform_conv_chain(xq, *args, **kw)
    assert head.dtype == torch.int8
    assert torch.equal(head, verbatim)
    # Two passes over C chunks: any chunk size gives the same emission.
    assert torch.equal(head, TO.deform_conv_chain(_t(x), *args, tile_c=4,
                                                  **kw))


def test_chain_value_errors():
    name, h, w, c, m, k, s, d, b = GEOMS[0]
    x = _t(_rng(name).randn(2, h, w, c).astype(np.float32))
    lay = [_t(v) for v in _chain_layer(name, c, m, k).values()]
    kw = dict(offset_bound=b, device="cpu")
    with pytest.raises(ValueError, match="y_scale"):
        TO.deform_conv_chain(x, *lay[:3], x_scale=1.0, emit="int8", **kw)
    with pytest.raises(ValueError, match="x_scale"):
        TO.deform_conv_chain(x, *lay[:3], x_scale=None, emit="fp32", **kw)
    with pytest.raises(ValueError, match="unknown emit"):
        TO.deform_conv_chain(x, *lay[:3], x_scale=1.0, emit="bf16", **kw)
    with pytest.raises(ValueError, match="offset_bound"):
        TO.deform_conv_chain(x, *lay[:3], x_scale=1.0, emit="fp32",
                             offset_bound=None, device="cpu")
    with pytest.raises(ValueError, match="multiple of 4"):
        TO.deform_conv_chain(x, *lay[:3], x_scale=1.0, emit="fp32",
                             tile_c=2, **kw)


# -- wrappers, tiles, ops validation -------------------------------------------

def _small_q_args():
    xp, off, wt, scale, kw = _q_inputs(EDGE_CASES[0], grid=True)
    return _t(xp), _t(off), _t(wt), _t(scale).reshape(-1), kw


@pytest.mark.parametrize("bad", ["float_x", "float_w", "f64_scale",
                                 "tile_c", "tile_m", "pixels"])
def test_q_wrapper_rejects_what_the_kernel_does_not_take(bad):
    xp, off, wt, scale, kw = _small_q_args()
    if bad == "float_x":
        xp = xp.float()
    elif bad == "float_w":
        wt = wt.float()
    elif bad == "f64_scale":
        scale = scale.double()
    elif bad == "tile_c":
        kw = dict(kw, tile_c=2)
    elif bad == "tile_m":
        kw = dict(kw, tile_m=TT.Q_TILE_M + 1)
    else:
        kw = dict(kw, tile_h=9, tile_w=8)
    with pytest.raises(ValueError):
        TQK.deform_conv_fused_zerocopy_q(xp, off, wt, scale, **kw)


def test_chain_wrapper_rejects_float_input_and_unknown_emit():
    name, h, w, c, m, k, s, d, b = GEOMS[0]
    x = _t(_rng(name).randn(2, h, w, c).astype(np.float32))
    xq = torch.zeros(2, 26, 26, c, dtype=torch.int8)
    w8 = torch.zeros(1, 9 * c, m, dtype=torch.int8)
    wo8 = torch.zeros(1, 9 * c, 18, dtype=torch.int8)
    f18, fm = torch.ones(18), torch.ones(m)
    kw = dict(kernel_size=3, stride=1, dilation=1, offset_bound=b,
              tile_h=4, tile_w=4, ho=h, wo=w)
    assert TQK.deform_conv_fused_zerocopy_chain(
        xq, w8, wo8, f18, f18, fm, fm, **kw).shape == (2, h, w, m)
    with pytest.raises(ValueError, match="int8"):
        TQK.deform_conv_fused_zerocopy_chain(x, w8, wo8, f18, f18, fm, fm,
                                             **kw)
    with pytest.raises(ValueError, match="unknown emit"):
        TQK.deform_conv_fused_zerocopy_chain(xq, w8, wo8, f18, f18, fm, fm,
                                             emit="int4", **kw)


@pytest.mark.parametrize("dtype", ["int8", "int8_chain"])
def test_int8_chooser_fits_and_packs_words(dtype):
    from repro_torch.configs.resnet50_dcn import CONFIG_BOUNDED
    from repro_torch.serve import bucket_layer_dims
    for bucket in (256, 512):
        for dims in bucket_layer_dims(CONFIG_BOUNDED, bucket).values():
            kt = TT.choose_kernel_tiles(
                4, dims["h"], dims["w"], dims["c"], dims["m"],
                kernel_size=3, stride=dims["stride"], offset_bound=2.0,
                dtype=dtype)
            assert kt.tile_c % 4 == 0 and dims["c"] % kt.tile_c == 0
            smem = TT.q_smem_bytes(kt.tile_h, kt.tile_w, kt.tile_c,
                                   kernel_size=3, stride=dims["stride"],
                                   dilation=1, offset_bound=2.0)
            assert smem <= TT.SMEM_PER_BLOCK // 2
    with pytest.raises(ValueError, match="multiple of 4"):
        TT.choose_kernel_tiles(1, 8, 8, 6, 8, kernel_size=3, stride=1,
                               offset_bound=2.0, dtype=dtype)
    with pytest.raises(ValueError, match="unknown kernel dtype"):
        TT.choose_kernel_tiles(1, 8, 8, 8, 8, kernel_size=3, stride=1,
                               offset_bound=2.0, dtype="bf16")


def test_ops_int8_validation():
    x, off, wgt = _edge_arrays(EDGE_CASES[0], grid=True)
    with pytest.raises(ValueError, match="offset_bound"):
        TO.deform_conv(_t(x), _t(off), _t(wgt), precision="int8",
                       device="cpu")
    with pytest.raises(ValueError, match="precision"):
        TO.deform_conv(_t(x), _t(off), _t(wgt), offset_bound=2.0,
                       precision="int4", device="cpu")
    seen = []
    with TO.dispatch_hook_scope(seen.append):
        TO.deform_conv(_t(x), _t(off), _t(wgt), offset_bound=2.0,
                       precision="int8", device="cpu")
    assert seen[0]["op"] == "deform_conv" and seen[0]["precision"] == "int8"


# -- layers --------------------------------------------------------------------

def _grid_dcl_params(seed, c, m):
    """DCL params and input on dyadic grids, so the fp32 offset conv is
    exact in any summation order and the offsets are exact in any frame:
    both packages then sample identical int8 patches."""
    rng = np.random.RandomState(seed)
    params = {
        "w_offset": np.round(rng.randn(3, 3, c, 18) * 8) / 64,
        "b_offset": np.round(rng.randn(18) * 8) / 8,
        "w_deform": rng.randn(3, 3, c, m) * 0.3,
        "b_deform": rng.randn(m),
    }
    x = np.round(rng.randn(2, 10, 10, c) * 4) / 4
    return ({k: v.astype(np.float32) for k, v in params.items()},
            x.astype(np.float32))


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("use_kernel", [True, False])
def test_dcl_apply_int8_matches_jax(stride, use_kernel):
    params, x = _grid_dcl_params(stride, 8, 8)
    scales = {"x_scale": _absmax(x), "w_scale": list(
        _absmax(params["w_deform"], -1).astype(float))}
    kw = dict(stride=stride, offset_bound=2.0, use_kernel=use_kernel,
              quant="int8", quant_scales=scales)
    yj, oj = JL.dcl_apply({k: jnp.asarray(v) for k, v in params.items()},
                          jnp.asarray(x), **kw)
    yt, ot = TL.dcl_apply({k: _t(v) for k, v in params.items()}, _t(x),
                          device="cpu", **kw)
    lsb = scales["x_scale"] * np.asarray(scales["w_scale"])
    assert float((np.abs(yt.numpy() - np.asarray(yj)) / lsb).max()) <= 1.0
    np.testing.assert_allclose(float(ot), float(oj), rtol=1e-6)


def _chain_table(params, x, y_scale=True):
    entry = {"x_scale": _absmax(x),
             "w_scale": list(_absmax(params["w_deform"], -1).astype(float)),
             "w_offset_scale": list(
                 _absmax(params["w_offset"], -1).astype(float))}
    if y_scale:
        entry["y_scale"] = 0.05
    return entry


@pytest.mark.parametrize("use_kernel", [True, False])
def test_dcl_apply_int8_chain_matches_jax(use_kernel):
    params, x = _grid_dcl_params(7, 8, 8)
    scales = _chain_table(params, x)
    kw = dict(offset_bound=2.0, use_kernel=use_kernel, quant="int8_chain",
              quant_scales=scales)
    yj, oj = JL.dcl_apply({k: jnp.asarray(v) for k, v in params.items()},
                          jnp.asarray(x), **kw)
    yt, ot = TL.dcl_apply({k: _t(v) for k, v in params.items()}, _t(x),
                          device="cpu", **kw)
    if use_kernel:
        assert isinstance(yt, QTensor) and ot is None and oj is None
        assert yt.values.dtype == torch.int8
        assert float(yt.scale) == pytest.approx(0.05)
        diff = np.abs(yt.values.numpy().astype(int)
                      - np.asarray(yj.values).astype(int))
    else:
        diff = np.abs(yt.numpy() - np.asarray(yj)) / 0.05
        np.testing.assert_allclose(float(ot), float(oj), rtol=1e-5)
    assert diff.max() <= 1


def _two_layers():
    c = 8
    ps, xs = zip(*(_grid_dcl_params(20 + i, c, c) for i in range(2)))
    x = xs[0]
    t0 = _chain_table(ps[0], x)
    t1 = dict(_chain_table(ps[1], x, y_scale=False), x_scale=0.05)
    return list(ps), x, [t0, t1]


def test_dcl_chain_apply_two_layers_matches_jax():
    params, x, tables = _two_layers()
    kw = dict(scales_seq=tables, offset_bound=2.0, use_kernel=True)
    yj, oj = JL.dcl_chain_apply(
        [{k: jnp.asarray(v) for k, v in p.items()} for p in params],
        jnp.asarray(x), **kw)
    yt, ot = TL.dcl_chain_apply([{k: _t(v) for k, v in p.items()}
                                 for p in params], _t(x), device="cpu", **kw)
    assert yt.dtype == torch.float32 and ot == [None, None]
    lsb = 0.05 * np.asarray(tables[1]["w_scale"])
    assert float((np.abs(yt.numpy() - np.asarray(yj)) / lsb).max()) <= 1.0
    # The inter-layer tensor is the int8 emission, handed over verbatim.
    tp = [{k: _t(v) for k, v in p.items()} for p in params]
    y0, _ = TL.dcl_apply(tp[0], _t(x), offset_bound=2.0, use_kernel=True,
                         quant="int8_chain", quant_scales=tables[0],
                         device="cpu")
    assert isinstance(y0, QTensor) and y0.values.dtype == torch.int8
    y1, _ = TL.dcl_apply(tp[1], y0, offset_bound=2.0, use_kernel=True,
                         quant="int8_chain", quant_scales=tables[1],
                         device="cpu")
    assert torch.equal(y1, yt)


def test_chain_layer_compat_errors():
    params, x, tables = _two_layers()
    tp = [{k: _t(v) for k, v in p.items()} for p in params]
    kw = dict(offset_bound=2.0, device="cpu")
    broken = [dict(tables[0]), dict(tables[1])]
    del broken[0]["y_scale"]
    with pytest.raises(ValueError, match="has no y_scale"):
        TL.dcl_chain_apply(tp, _t(x), scales_seq=broken, **kw)
    broken = [dict(tables[0]), dict(tables[1], x_scale=0.1)]
    with pytest.raises(ValueError, match="disagree on the exchange grid"):
        TL.dcl_chain_apply(tp, _t(x), scales_seq=broken, **kw)
    with pytest.raises(ValueError, match="C_out=8 channels .* C_in=4"):
        TL.check_chain_compat(tables, couts=[8, 8], cins=[8, 4])
    with pytest.raises(ValueError, match="scale-table entries"):
        TL.dcl_chain_apply(tp, _t(x), scales_seq=tables[:1], **kw)
    with pytest.raises(ValueError, match="quant_scales"):
        TL.dcl_apply(tp[0], _t(x), quant="int8_chain", **kw)
    with pytest.raises(ValueError, match="offset_bound"):
        TL.dcl_apply(tp[0], _t(x), quant="int8_chain",
                     quant_scales=tables[0], device="cpu")
    # quant="qat" trains (fake-quant over the fp32 path); it runs here.
    y, o_max = TL.dcl_apply(tp[0], _t(x), quant="qat", **kw)
    assert y.shape[:3] == x.shape[:3] and torch.isfinite(y).all()
    assert float(o_max) > 0
    with pytest.raises(ValueError, match="unknown quant mode"):
        TL.dcl_apply(tp[0], _t(x), quant="int4", **kw)


# -- the model -----------------------------------------------------------------

SMALL = dict(stage_sizes=(1, 1, 1, 1), widths=(16, 32, 64, 128),
             stem_width=8, num_dcn=2, num_classes=4, img_size=32,
             offset_bound=2.0)


@pytest.fixture(scope="module")
def small_model():
    from repro.quant import calibrate_resnet_dcn
    from test_torch_quant import _jax_tapped_forward, _np_tree
    params = _np_tree(TR.init_params(TR.ResNetDCNConfig(**SMALL), seed=0,
                                     device="cpu"))
    rng = np.random.RandomState(0)
    for block in params.values():          # taps interpolate, some clamp
        if "dcl" in block:
            dcl = block["dcl"]
            c = dcl["w_offset"].shape[2]
            dcl["w_offset"] = (rng.randn(*dcl["w_offset"].shape)
                               / np.sqrt(4.5 * c)).astype(np.float32)
            dcl["b_offset"] = (rng.randn(18) * 0.5).astype(np.float32)
    jcfg = JR.ResNetDCNConfig(**SMALL, use_kernel=True)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    images = np.random.RandomState(3).randn(2, 32, 32, 3).astype(np.float32)
    ref_cfg = dataclasses.replace(jcfg, use_kernel=False)
    table = calibrate_resnet_dcn(jparams, ref_cfg, [images],
                                 forward=_jax_tapped_forward(ref_cfg))
    return jcfg, params, jparams, images, table


@pytest.mark.parametrize("quant", ["int8", "int8_chain"])
def test_resnet_forward_int8_matches_jax_kernel_path(small_model, quant):
    jcfg, params, jparams, images, table = small_model
    jcfg = dataclasses.replace(jcfg, quant=quant)
    ref = jax.jit(lambda p, x: JR.forward(p, jcfg, x,
                                          quant_scales=table)[0])(
        jparams, jnp.asarray(images))
    tcfg = TR.ResNetDCNConfig(**SMALL, use_kernel=True, quant=quant)
    with torch.no_grad():
        got, _ = TR.forward(params_from_jax(params, device="cpu"), tcfg,
                            torch.from_numpy(images), quant_scales=table,
                            device="cpu")
    for key in ("cls", "box"):
        r = np.asarray(ref[key])
        g = got[key].numpy()
        assert g.shape == r.shape and np.isfinite(g).all()
        rel = float(np.linalg.norm(g - r) / np.linalg.norm(r))
        assert rel < 1e-4, (key, rel)
