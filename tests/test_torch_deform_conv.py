"""Port parity: reference DCL maths, Eq. 6 band geometry and the Hopper
tile chooser of ``repro_torch`` against the JAX package.

Inputs are made with numpy from a seed and fed to both packages.
Tolerances: gathers <= 1e-6 abs (the same fp32 operations in the same
order); contractions rtol = atol = 1e-5 (other summation orders);
geometry exact.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import deform_conv as JD
from repro.core import tiling as JT
from repro.kernels import band_pipeline as JB
from repro_torch.core import deform_conv as TD
from repro_torch.core import tiling as TT
from repro_torch.kernels import band_pipeline as TB

torch.set_num_threads(2)

GATHER_ATOL = 1e-6
TOL = dict(rtol=1e-5, atol=1e-5)

GEOMS = [  # (kernel_size, stride, dilation, offset_bound)
    (3, 1, 1, 2.0), (3, 2, 1, 2.0), (3, 1, 2, 1.5), (1, 1, 1, 1.0),
    (5, 2, 1, 0.5)]


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


@pytest.mark.parametrize("stride,padding,h,w", [
    (1, "SAME", 8, 8), (2, "SAME", 8, 8), (2, "SAME", 9, 7),
    (2, 3, 16, 16), (1, 1, 6, 5)])
def test_conv2d_matches_lax(stride, padding, h, w):
    rng = np.random.RandomState(stride * 10 + h)
    k = 7 if padding == 3 else 3
    x = rng.randn(2, h, w, 5).astype(np.float32)
    wt = rng.randn(k, k, 5, 6).astype(np.float32)
    ref = np.asarray(JD.conv2d(jnp.asarray(x), jnp.asarray(wt),
                               stride=stride, padding=padding))
    got = TD.conv2d(_t(x), _t(wt), stride=stride, padding=padding).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, **TOL)


def test_conv2d_same_stride2_is_asymmetric():
    """XLA pads (0, 1) here; a symmetric padding=1 would differ."""
    rng = np.random.RandomState(1)
    x = rng.randn(1, 8, 8, 4).astype(np.float32)
    wt = rng.randn(3, 3, 4, 4).astype(np.float32)
    got = TD.conv2d(_t(x), _t(wt), stride=2)
    sym = TD.conv2d(_t(x), _t(wt), stride=2, padding=1)
    assert (got - sym).abs().max() > 1e-2


@pytest.mark.parametrize("n,h,w,c,p", [(1, 5, 6, 3, 40), (2, 9, 4, 8, 77)])
def test_bilinear_sample_matches(n, h, w, c, p):
    rng = np.random.RandomState(h * w)
    x = rng.randn(n, h, w, c).astype(np.float32)
    py = rng.uniform(-2, h + 1, (n, p)).astype(np.float32)
    px = rng.uniform(-2, w + 1, (n, p)).astype(np.float32)
    ref = np.asarray(JD.bilinear_sample(jnp.asarray(x), jnp.asarray(py),
                                        jnp.asarray(px)))
    got = TD.bilinear_sample(_t(x), _t(py), _t(px)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=GATHER_ATOL)


@pytest.mark.parametrize("k,s,d,b", GEOMS)
def test_sample_patches_matches(k, s, d, b):
    rng = np.random.RandomState(k + 3 * s + 7 * d)
    cfg_j = JD.DCLConfig(in_channels=4, out_channels=1, kernel_size=k,
                         stride=s, dilation=d)
    cfg_t = TD.DCLConfig(in_channels=4, out_channels=1, kernel_size=k,
                         stride=s, dilation=d)
    x = rng.randn(2, 9, 10, 4).astype(np.float32)
    ho, wo = JT.out_hw(9, 10, kernel_size=k, stride=s, dilation=d)
    off = (rng.randn(2, ho, wo, k * k, 2) * 2).astype(np.float32)
    ref = np.asarray(JD.sample_patches(jnp.asarray(x), jnp.asarray(off),
                                       cfg_j))
    got = TD.sample_patches(_t(x), _t(off), cfg_t).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=GATHER_ATOL)


@pytest.mark.parametrize("k,s,d,b", GEOMS[:3] + [(3, 1, 1, None)])
def test_dcl_forward_matches(k, s, d, b):
    rng = np.random.RandomState(11 * k + s)
    c, m = 6, 5
    params = {
        "w_offset": (rng.randn(k, k, c, 2 * k * k) * 0.3).astype(np.float32),
        "b_offset": (rng.randn(2 * k * k) * 0.5).astype(np.float32),
        "w_deform": rng.randn(k, k, c, m).astype(np.float32),
        "b_deform": rng.randn(m).astype(np.float32),
    }
    x = rng.randn(2, 8, 9, c).astype(np.float32)
    kw = dict(in_channels=c, out_channels=m, kernel_size=k, stride=s,
              dilation=d, offset_bound=b)
    yj, sj = JD.dcl_forward({k_: jnp.asarray(v) for k_, v in params.items()},
                            jnp.asarray(x), JD.DCLConfig(**kw))
    yt, st = TD.dcl_forward({k_: _t(v) for k_, v in params.items()}, _t(x),
                            TD.DCLConfig(**kw))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
    assert st.keys() == sj.keys() == {"o_max", "rf_dynamic"}
    np.testing.assert_allclose(float(st["o_max"]), float(sj["o_max"]),
                               **TOL)
    assert isinstance(st["rf_dynamic"], torch.Tensor)
    assert float(st["rf_dynamic"]) == float(sj["rf_dynamic"])
    y_only = TD.dcl_forward({k_: _t(v) for k_, v in params.items()}, _t(x),
                            TD.DCLConfig(**kw), return_stats=False)
    want = JD.dcl_forward({k_: jnp.asarray(v) for k_, v in params.items()},
                          jnp.asarray(x), JD.DCLConfig(**kw),
                          return_stats=False)
    assert isinstance(y_only, torch.Tensor)
    assert torch.equal(y_only, yt)
    np.testing.assert_allclose(y_only.numpy(), np.asarray(want), **TOL)


def test_receptive_field_and_offset_abs_max():
    assert TD.receptive_field(3, 2.0) == JD.receptive_field(3, 2.0) == 7
    assert TD.receptive_field(3, 1.2) == JD.receptive_field(3, 1.2)
    o = np.random.RandomState(0).randn(3, 4).astype(np.float32)
    assert float(TD.offset_abs_max(_t(o))) == float(
        JD.offset_abs_max(jnp.asarray(o)))
    cfg = TD.DCLConfig(4, 4, kernel_size=3, dilation=2, offset_bound=2.0)
    assert cfg.pad == 2 and cfg.taps == 9 and cfg.static_rf() == 7


# -- Eq. 6 geometry (exact) ---------------------------------------------------

@pytest.mark.parametrize("tile", [1, 4, 8, 17])
@pytest.mark.parametrize("k,s,d,b", GEOMS)
def test_band_extent_and_out_hw_exact(tile, k, s, d, b):
    kw = dict(kernel_size=k, stride=s, dilation=d)
    assert TT.band_extent(tile, offset_bound=b, **kw) == JT.band_extent(
        tile, offset_bound=b, **kw)
    for h, w in ((16, 16), (17, 23), (5, 9)):
        assert TT.out_hw(h, w, **kw) == JT.out_hw(h, w, **kw)
    tb = TB.BandSpec(k, s, d, b, tile, tile + 1)
    jb = JB.BandSpec(k, s, d, b, tile, tile + 1)
    assert (tb.band_h, tb.band_w, tb.halo, tb.k2) == (
        jb.band_h, jb.band_w, jb.halo, jb.k2)


@pytest.mark.parametrize("k,s,d,b", GEOMS)
def test_corner_geometry_exact(k, s, d, b):
    rng = np.random.RandomState(k * s * d)
    th, wo = 3, 5
    off = (rng.randn(th, wo, k * k, 2) * 1.5 * b).astype(np.float32)
    kw = dict(kernel_size=k, stride=s, dilation=d, offset_bound=b,
              tile_h=th, wo=wo)
    ref = JB.corner_geometry(jnp.asarray(off), **kw)
    got = TB.corner_geometry(_t(off), **kw)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("k,s,d,b", GEOMS[:3])
def test_bilinear_from_band_matches(k, s, d, b):
    rng = np.random.RandomState(5)
    th, wo, tc = 2, 3, 4
    spec = TB.BandSpec(k, s, d, b, th, wo)
    band = rng.randn(spec.band_h, spec.band_w, tc).astype(np.float32)
    off = (rng.randn(th, wo, k * k, 2) * 2).astype(np.float32)
    kw = dict(kernel_size=k, stride=s, dilation=d, offset_bound=b,
              tile_h=th, wo=wo)
    ref = np.asarray(JB._bilinear_from_band(jnp.asarray(band),
                                            jnp.asarray(off), **kw))
    got = TB.bilinear_from_band(_t(band), _t(off), **kw).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=GATHER_ATOL)


# -- Hopper tile chooser ------------------------------------------------------

RESNET50_512 = [  # (h, c, stride) of the DCLs of resnet50_dcn_bounded
    (64, 128, 1), (64, 256, 2), (32, 256, 1), (32, 512, 2), (16, 512, 1)]


@pytest.mark.parametrize("h,c,s", RESNET50_512)
@pytest.mark.parametrize("n", [1, 4])
def test_chooser_fits_shared_memory_and_fills_the_card(h, c, s, n):
    kw = dict(kernel_size=3, stride=s, dilation=1, offset_bound=2.0)
    t = TT.choose_kernel_tiles(n, h, h, c, c, **kw)
    assert c % t.tile_c == 0 and c % t.tile_m == 0
    assert t.tile_m <= TT.FWD_TILE_M and t.tile_h * t.tile_w <= 64
    smem = TT.smem_bytes(t.tile_h, t.tile_w, t.tile_c, **kw)
    assert smem <= TT.FWD_SMEM_TWO                 # two blocks per SM
    ho, wo = TT.out_hw(h, h, kernel_size=3, stride=s)
    groups = TT.fwd_c_groups(n, ho, wo, c, c, tile_h=t.tile_h,
                             tile_w=t.tile_w, tile_c=t.tile_c,
                             tile_m=t.tile_m)
    blocks = TT.grid_blocks(n, ho, wo, c, t) * groups
    # Either the grid (with its C groups) holds two blocks an SM, or no
    # smaller tile (>= 16 pixels) could at one group a chunk.
    floor = TT.grid_blocks(n, ho, wo, c, TT.KernelTiles(4, 4, 1, t.tile_m)) \
        * (c // t.tile_c)
    assert blocks >= TT.BWD_TARGET_BLOCKS or floor < TT.BWD_TARGET_BLOCKS


def test_chooser_raises_when_no_band_fits():
    with pytest.raises(ValueError, match="shared memory"):
        TT.choose_kernel_tiles(1, 64, 64, 8, 8, kernel_size=3, stride=2,
                               dilation=8, offset_bound=200.0)


def test_smem_bytes_formula():
    # band 15x15 x tc=16 (twice), K=3: W 144 rows x 128 channels (twice),
    # patch tile 64 pixel lanes x (144 + 4), geometry 3 x 9 x 64
    want = 4 * (2 * 16 * 225 + 2 * 144 * 128 + 64 * 148 + 3 * 9 * 64)
    assert TT.smem_bytes(8, 8, 16, kernel_size=3, stride=1, dilation=1,
                         offset_bound=2.0) == want
    # tc=4: 36 rows padded to 40; a 4x4 tile's 11x11 band, 16 lanes
    want = 4 * (2 * 4 * 121 + 2 * 40 * 128 + 16 * 44 + 3 * 9 * 16)
    assert TT.smem_bytes(4, 4, 4, kernel_size=3, stride=1, dilation=1,
                         offset_bound=2.0) == want
    assert TT.pix_lanes(4, 4) == 16 and TT.pix_lanes(4, 8) == 32
    with pytest.raises(ValueError):
        TT.pix_lanes(9, 8)
    assert math.ceil(2.0) == TB.BandSpec(3, 1, 1, 2.0, 8, 8).halo


@pytest.mark.parametrize("use_bias", [True, False])
def test_init_dcl_params_and_use_bias_match_jax(use_bias):
    """The port's ``init_dcl_params`` (a seed where JAX takes a key) makes
    JAX's params: the same names and shapes, zero offset conv and biases
    (none without ``use_bias``), He-init deform weights; and the same
    params, an offset conv added, give the same layer in both packages."""
    import jax
    kw = dict(in_channels=16, out_channels=24, kernel_size=3,
              offset_bound=2.0, use_bias=use_bias)
    jp = JD.init_dcl_params(jax.random.PRNGKey(0), JD.DCLConfig(**kw))
    tp = TD.init_dcl_params(TD.DCLConfig(**kw), seed=0, device="cpu")
    assert sorted(tp) == sorted(jp)
    for name, v in jp.items():
        assert tuple(tp[name].shape) == v.shape
        assert tp[name].dtype == torch.float32
        assert name == "w_deform" or not tp[name].any()
    want = math.sqrt(2.0 / (9 * 16))
    for w in (np.asarray(jp["w_deform"]), tp["w_deform"].numpy()):
        assert abs(w.std() / want - 1) < 0.1
    rng = np.random.RandomState(0)
    tp["w_offset"] = torch.from_numpy(
        rng.randn(3, 3, 16, 18).astype(np.float32) * 0.1)
    x = rng.randn(2, 9, 9, 16).astype(np.float32)
    y_j = JD.dcl_forward({k: jnp.asarray(v.numpy()) for k, v in tp.items()},
                         jnp.asarray(x), JD.DCLConfig(**kw),
                         return_stats=False)
    y_t = TD.dcl_forward(tp, torch.from_numpy(x), TD.DCLConfig(**kw),
                         return_stats=False)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **TOL)
