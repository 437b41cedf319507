"""The design-space half of ``core.tiling`` on the CPU: the paper's Sec. 3.2
algebra and Eq. 6 inverse against the JAX package's, the H100 chooser
(``choose_tiles``) on the five DCL shapes of ``resnet50_dcn_bounded``, and
the traffic model of the port's kernels (``dcl_*_hbm_bytes``) against a
count that walks each kernel's grid block by block, as the CUDA code of
``kernels/csrc`` performs its loads and stores, with the wrappers' own
planners (``fwd_plan``, ``q_plan``, ``bwd_plan``, ``sample_c_groups``)
and padding (``plan.pad_zerocopy``, ``plan.pad_and_band``).  Then the
model against ``core.h100``'s floors, and the tuner's candidate cap
against JAX's."""
import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import tiling as J
from repro.tune import autotune as jtune
from repro_torch.core import h100
from repro_torch.core import tiling as T
from repro_torch.distributed.spatial import halo_rows
from repro_torch.kernels import plan
from repro_torch.kernels.deform_conv_bwd import bwd_plan
from repro_torch.kernels.deform_conv_fused import fwd_plan
from repro_torch.kernels.deform_conv_q import q_plan
from repro_torch.tune import autotune

K, B = 3, 2.0
# The five DCL shapes of resnet50_dcn_bounded at the 512 bucket: (h, c, s).
RESNET50_512 = [(64, 128, 1), (64, 256, 2), (32, 256, 1), (32, 512, 2),
                (16, 512, 1)]
FIVE = [T.LayerShape(h=h, w=h, c_in=c, c_out=c, stride=s, offset_bound=B)
        for h, c, s in RESNET50_512]
FIVE_IDS = [f"{h}x{c}s{s}" for h, c, s in RESNET50_512]


# -- the paper's algebra, equal to JAX's -------------------------------------

def _grid_points():
    rng = np.random.RandomState(0)
    shapes = [(56, 56, 512, 512, 3, 1, 2.0), (64, 64, 128, 128, 3, 2, 1.5),
              (17, 23, 64, 48, 5, 1, 3.0), (16, 16, 512, 256, 3, 1, 0.5)]
    tiles = [(1, 8, 512, 64), (4, 16, 256, 128)] + [
        tuple(int(v) for v in (rng.choice([1, 2, 8]), rng.choice([4, 8, 32]),
                               rng.choice([8, 96, 256]),
                               rng.choice([8, 64, 200])))
        for _ in range(2)]
    return [(s, t) for s in shapes for t in tiles]


@pytest.mark.parametrize("shape,tile", _grid_points())
def test_paper_algebra_equals_jax(shape, tile):
    h, w, c, m, k, s, b = shape
    js = J.LayerShape(h=h, w=w, c_in=c, c_out=m, kernel_size=k, stride=s,
                      offset_bound=b)
    ts = T.LayerShape(h=h, w=w, c_in=c, c_out=m, kernel_size=k, stride=s,
                      offset_bound=b)
    jt, tt = J.TileConfig(*tile), T.TileConfig(*tile)
    assert T.tile_flops(ts, tt) == J.tile_flops(js, jt)
    for bpe in (1, 2, 4):
        assert T.tile_hbm_bytes(ts, tt, bytes_per_elem=bpe) == \
            J.tile_hbm_bytes(js, jt, bytes_per_elem=bpe)
        assert T.two_stage_extra_bytes(ts, tt, bytes_per_elem=bpe) == \
            J.two_stage_extra_bytes(js, jt, bytes_per_elem=bpe)
        assert tt.onchip_bytes(ts.rf, s, k, bytes_per_elem=bpe) == \
            jt.vmem_bytes(js.rf, s, k, bytes_per_elem=bpe)
    mine = T.evaluate_tile(ts, tt)
    assert mine.ctc == J.evaluate_tile(js, jt).ctc
    assert mine.onchip_bytes == J.evaluate_tile(js, jt).vmem_bytes


@pytest.mark.parametrize("dtype", ["int8", "bf16", "fp32", "float32",
                                   np.float16, torch.bfloat16, torch.int8,
                                   torch.float32])
def test_dtype_bytes_equals_jax(dtype):
    """Names and numpy dtypes as JAX reads them; a ``torch.dtype`` as JAX
    reads its name."""
    name = str(dtype).split(".")[1] if isinstance(dtype, torch.dtype) \
        else dtype
    assert T.dtype_bytes(dtype) == J.dtype_bytes(name)
    with pytest.raises(ValueError):
        T.dtype_bytes(None)


@given(k=st.sampled_from([1, 3, 5, 7]), s=st.sampled_from([1, 2]),
       tw=st.sampled_from([1, 4, 8, 16, 64]),
       tn=st.sampled_from([8, 32, 128, 512]),
       budget=st.integers(1 << 10, 1 << 22),
       bpe=st.sampled_from([1, 2, 4]))
@settings(max_examples=30, deadline=None)
def test_max_offset_bound_fitting_equals_jax(k, s, tw, tn, budget, bpe):
    got = T.max_offset_bound_fitting(k, s, tw, tn, budget,
                                     bytes_per_elem=bpe)
    assert got == J.max_offset_bound_fitting(k, s, tw, tn,
                                             vmem_budget=budget,
                                             bytes_per_elem=bpe)


def test_max_offset_bound_fitting_at_the_h100_default():
    """One block's shared memory holds the paper's tiles' band up to B = 4
    (RF 11: 202,752 B; RF 13: 266,240 B does not fit)."""
    assert T.max_offset_bound_fitting(3, 1, 8, 512) == 4.0
    assert T.max_offset_bound_fitting(3, 1, 8, 128) == 11.0
    assert T.input_buffer_size(11, 1, 8, 512, bytes_per_elem=2) \
        <= T.SMEM_PER_BLOCK < T.input_buffer_size(13, 1, 8, 512,
                                                   bytes_per_elem=2)


# -- Sec. 3.2 on the H100 ----------------------------------------------------

@pytest.mark.parametrize("shape", FIVE, ids=FIVE_IDS)
def test_choose_tiles_is_the_fitting_argmax(shape):
    choice = T.choose_tiles(shape)
    assert choice.fits and choice.onchip_bytes <= T.SMEM_PER_BLOCK
    points = [T.evaluate_tile(shape, t) for t in T.tile_candidates(shape)]
    fitting = [p for p in points if p.fits]
    assert choice == max(fitting, key=lambda p: (p.attainable_flops, p.ctc))
    assert all(p.tile.t_h * p.tile.t_w <= T.PIX_LANES[-1]
               and p.tile.t_n % 8 == 0 and p.tile.t_m % 8 == 0
               and p.tile.t_n <= shape.c_in and p.tile.t_m <= shape.c_out
               for p in points)
    for p in points:
        assert p.ctc > T.evaluate_tile(shape, p.tile, fused=False).ctc
    # Far below the card's ridge; far above the paper's point, which does
    # not fit a block.
    ridge = h100.PEAK_BF16_FLOPS / h100.PEAK_HBM_BYTES_PER_S
    assert choice.ctc < ridge / 4
    paper = T.evaluate_tile(shape, T.PAPER_TILES)
    assert not paper.fits and choice.ctc > 5 * paper.ctc


def test_choose_tiles_refuses_an_unbounded_band():
    shape = T.LayerShape(h=56, w=56, c_in=512, c_out=512,
                         offset_bound=4096.0)
    with pytest.raises(ValueError, match="larger lambda"):
        T.choose_tiles(shape, smem_budget=1 << 20)


# -- the traffic model against a walk of each kernel's grid -------------------

def _band(th, tw, k, s, d, b):
    hb = math.ceil(b)
    return ((th - 1) * s + (k - 1) * d + 2 * hb + 2,
            (tw - 1) * s + (k - 1) * d + 2 * hb + 2)


def _tiles(n, ho, wo, th, tw):
    """Every output tile (image, row tile, column tile) with its valid
    pixels, in grid order."""
    out = []
    for i in range(n):
        for jt in range(-(-ho // th)):
            for wt in range(-(-wo // tw)):
                valid = [p for p in range(th * tw)
                         if jt * th + p // tw < ho and wt * tw + p % tw < wo]
                out.append((i, jt, wt, valid))
    return out


def _chunks(chunks, groups, grp):
    return range(grp * chunks // groups, (grp + 1) * chunks // groups)


def walk_fwd(n, wp, ho, wo, c, m, th, tw, tc, tm, k, s, d, b, e, oe):
    """dcf_kernel + dcf_reduce_kernel (deform_conv_fused.cu): returns
    (band bytes, all bytes)."""
    band_h, band_w = _band(th, tw, k, s, d, b)
    groups = fwd_plan(n, ho, wo, c, m, tile_h=th, tile_w=tw, tile_c=tc,
                      tile_m=tm)["c_groups"]
    band = total = 0
    for _, _, wt, valid in _tiles(n, ho, wo, th, tw):
        cols = sum(1 for q in range(band_w) if wt * tw * s + q < wp)
        for mt in range(-(-m // tm)):
            m_live = min(tm, m - mt * tm)
            for grp in range(groups):
                total += len(valid) * 2 * k * k * oe
                for _ in _chunks(c // tc, groups, grp):
                    band += band_h * cols * tc * e
                    total += k * k * tc * m_live * e
                total += len(valid) * m_live * (e if groups == 1 else 4)
    if groups > 1:
        total += n * ho * wo * m * (4 * groups + e)
    return band, band + total


def walk_q(n, ho, wo, c, m, th, tw, tc, tm, k, s, d, b, chain, out_b):
    """deform_conv_q.cu: dqt_kernel, dco_kernel (chain), dcq_kernel,
    dcq_reduce_kernel."""
    k2, n_off = k * k, 2 * k * k
    band_h, band_w = _band(th, tw, k, s, d, b)
    p = q_plan(n, ho, wo, c, m, tile_h=th, tile_w=tw, tile_c=tc, tile_m=tm)
    groups, og = p["c_groups"], p["off_groups"]
    chunks, rows = c // tc, k2 * tc
    mats = [m, n_off] if chain else [m]
    total = 0
    for mat_m in mats:
        for _ in range(chunks):
            for r0 in range(0, rows, 64):
                for m0 in range(0, max(mats), 64):
                    if m0 < mat_m:
                        total += 2 * min(64, rows - r0) * min(64, mat_m - m0)
    tiles = _tiles(n, ho, wo, th, tw)
    if chain:
        if og > 1:
            total += n * ho * wo * n_off * 4
        for *_, valid in tiles:
            for grp in range(og):
                for _ in _chunks(chunks, og, grp):
                    total += band_h * band_w * tc + n_off * k2 * tc
                total += len(valid) * n_off * (4 if og == 1 else 8)
    epi = 8 if chain else 4
    for *_, valid in tiles:
        for mt in range(-(-m // tm)):
            m_live = min(tm, m - mt * tm)
            for grp in range(groups):
                total += len(valid) * k2 * (24 if chain else 8)
                for _ in _chunks(chunks, groups, grp):
                    total += band_h * band_w * tc + m_live * k2 * tc
                total += len(valid) * m_live * (
                    out_b + epi if groups == 1 else 4)
    if groups > 1:
        total += n * ho * wo * m * (4 * groups + epi + out_b)
    return total


def walk_bwd(n, hp, wp, ho, wo, c, m, th, tw, tc, k, s, d, b, e, oe):
    """deform_conv_bwd.cu: the memset, dcb_input_kernel,
    dcb_doff_reduce_kernel, dcb_weight_kernel, dcb_reduce_kernel and
    (bf16) dcb_round_kernel; d_input's atomics at every band position."""
    k2 = k * k
    band_h, band_w = _band(th, tw, k, s, d, b)
    npos, kk = band_h * band_w, k2 * tc
    p = bwd_plan(n, ho, wo, c, m, kernel_size=k, tile_h=th, tile_w=tw,
                 tile_c=tc)
    groups, splits, pix = p["c_groups"], p["dw_splits"], p["lanes"]
    tiles = _tiles(n, ho, wo, th, tw)
    total = 4 * n * hp * wp * c
    for *_, valid in tiles:
        for grp in range(groups):
            total += len(valid) * 2 * k2 * oe
            if grp == 0:
                total += 3 * k2 * pix * 4
            for _ in _chunks(c // tc, groups, grp):
                for ms in range(-(-m // 16)):
                    for q in range(4):
                        got = max(0, min(4, m - ms * 16 - 4 * q))
                        total += (kk + len(valid)) * got * e
                total += npos * tc * (e + 8)
            total += len(valid) * 2 * k2 * (2 * oe if groups == 1 else 4)
    if groups > 1:
        total += n * ho * wo * 2 * k2 * (4 * groups + 2 * oe)
    rstep = 4 if tc % 4 == 0 else 1
    for _ in range(c // tc):
        for r0 in range(0, kk, 144):
            for m0 in range(0, m, 128):
                for split in range(splits):
                    for t in range(split, len(tiles), splits):
                        valid = set(tiles[t][3])
                        total += npos * tc * e
                        for px in range(pix):
                            if px in valid:
                                total += min(128, m - m0) * e
                            for r in range(0, 144, rstep):
                                if r0 + r < kk:
                                    total += 4 + (8 if px in valid else 0)
                    total += min(144, kk - r0) * min(128, m - m0) * 4
    if splits > 1:
        total += k2 * c * m * (4 * splits + 4)
    if e == 2:
        total += n * hp * wp * c * 6
    return total


def walk_sample(n, wp, ho, wo, c, th, tw, tc, k, s, d, b, e, oe):
    """ds_kernel (deform_sample.cu)."""
    band_h, band_w = _band(th, tw, k, s, d, b)
    groups = T.sample_c_groups(n, ho, wo, c, tile_h=th, tile_w=tw,
                               tile_c=tc)
    total = 0
    for _, _, wt, valid in _tiles(n, ho, wo, th, tw):
        cols = sum(1 for q in range(band_w) if wt * tw * s + q < wp)
        for grp in range(groups):
            total += len(valid) * 2 * k * k * oe
            for _ in _chunks(c // tc, groups, grp):
                total += band_h * cols * tc * e + len(valid) * k * k * tc * e
    return total


# (n, h, w, c, m, stride, dilation, bound, tile_c): per datapath two
# shapes, one whose C splits into groups and one that does not.
SMALL = [(2, 10, 9, 16, 24, 1, 1, 1.0, 4), (1, 12, 12, 8, 8, 2, 1, 2.0, 8)]
SMALL_IDS = ["10x9x16->24", "12x12x8->8s2"]


def _zero_copy(n, h, w, c, m, s, d, b, tc, dtype, tm=None):
    """The dispatch path's clamped tiles, x_pad's shape and the output
    extent of one zero-copy call."""
    kt = T.choose_kernel_tiles(n, h, w, c, m, kernel_size=K, stride=s,
                               dilation=d, offset_bound=b, dtype=dtype)
    ho, wo = T.out_hw(h, w, kernel_size=K, stride=s, dilation=d)
    th, tw = min(kt.tile_h, ho), min(kt.tile_w, wo)
    xp = plan.pad_zerocopy(torch.zeros(n, h, w, c), kernel_size=K, stride=s,
                           dilation=d, offset_bound=b, tile_h=th, tile_w=tw,
                           ho=ho, wo=wo)
    tiles = T.KernelTiles(th, tw, tc, tm or min(m, T.FWD_TILE_M))
    shape = T.LayerShape(h=h, w=w, c_in=c, c_out=m, stride=s,
                         offset_bound=b)
    return shape, tiles, xp.shape, ho, wo


@pytest.mark.parametrize("case", SMALL, ids=SMALL_IDS)
@pytest.mark.parametrize("e,oe", [(4, 4), (2, 2), (2, 4)])
def test_forward_traffic_walks_kernel_1a(case, e, oe):
    n, h, w, c, m, s, d, b, tc = case
    shape, kt, (_, _, wp, _), ho, wo = _zero_copy(n, h, w, c, m, s, d, b,
                                                  tc, "fp32", tm=16)
    band, total = walk_fwd(n, wp, ho, wo, c, m, kt.tile_h, kt.tile_w, tc,
                           kt.tile_m, K, s, d, b, e, oe)
    kw = dict(batch=n, dilation=d, bytes_per_elem=e)
    assert T.dcl_total_hbm_bytes(shape, kt, offset_bytes_per_elem=oe,
                                 **kw) == total
    assert T.dcl_dataflow_hbm_bytes(shape, kt, **kw) == band


@pytest.mark.parametrize("case", SMALL, ids=SMALL_IDS)
@pytest.mark.parametrize("e", [4, 2])
def test_banded_traffic_walks_pad_and_band_and_kernel_4(case, e):
    n, h, w, c, m, s, d, b, tc = case
    th = 4
    kt = T.choose_kernel_tiles(n, h, w, c, m, kernel_size=K, stride=s,
                               dilation=d, offset_bound=b, dtype="banded",
                               tile_h=th)
    ho, wo = T.out_hw(h, w, kernel_size=K, stride=s, dilation=d)
    bands, nt = plan.pad_and_band(torch.zeros(n, h, w, c), kernel_size=K,
                                  stride=s, dilation=d, offset_bound=b,
                                  tile_h=th, ho=ho)
    tw = min(kt.tile_w, wo)
    band, total = walk_fwd(n, bands.shape[3], nt * th, wo, c, m, th, tw, tc,
                           16, K, s, d, b, e, e)
    gather = 2 * bands.numel() * e
    shape = T.LayerShape(h=h, w=w, c_in=c, c_out=m, stride=s,
                         offset_bound=b)
    tiles = T.KernelTiles(th, tw, tc, 16)
    kw = dict(dataflow="materialized_band", batch=n, dilation=d,
              bytes_per_elem=e)
    assert T.dcl_total_hbm_bytes(shape, tiles, **kw) == total + gather
    assert T.dcl_dataflow_hbm_bytes(shape, tiles, **kw) == band + gather
    assert T.dcl_total_hbm_bytes(shape, tiles, **kw) > T.dcl_total_hbm_bytes(
        shape, tiles, batch=n, dilation=d, bytes_per_elem=e)


@pytest.mark.parametrize("case", SMALL, ids=SMALL_IDS)
@pytest.mark.parametrize("chain,emit", [(False, 4), (True, 1), (True, 4)],
                         ids=["1c", "1d-int8", "1d-fp32"])
def test_int8_traffic_walks_kernels_1c_1d(case, chain, emit):
    n, h, w, c, m, s, d, b, tc = case
    shape, kt, _, ho, wo = _zero_copy(n, h, w, c, m, s, d, b, tc,
                                      "int8_chain" if chain else "int8",
                                      tm=16)
    want = walk_q(n, ho, wo, c, m, kt.tile_h, kt.tile_w, tc, kt.tile_m, K,
                  s, d, b, chain, emit)
    assert T.dcl_total_hbm_bytes(shape, kt, batch=n, dilation=d,
                                 bytes_per_elem=1, fused_offsets=chain,
                                 out_bytes_per_elem=emit) == want


@pytest.mark.parametrize("case", SMALL, ids=SMALL_IDS)
@pytest.mark.parametrize("e,oe", [(4, 4), (2, 2)])
def test_backward_traffic_walks_kernel_2(case, e, oe):
    n, h, w, c, m, s, d, b, tc = case
    shape, kt, (_, hp, wp, _), ho, wo = _zero_copy(n, h, w, c, m, s, d, b,
                                                   tc, "fp32_bwd")
    want = walk_bwd(n, hp, wp, ho, wo, c, m, kt.tile_h, kt.tile_w, tc, K, s,
                    d, b, e, oe)
    kw = dict(batch=n, dilation=d, bytes_per_elem=e)
    assert T.dcl_backward_hbm_bytes(shape, kt, offset_bytes_per_elem=oe,
                                    **kw) == want
    # Training: the forward at its own tiles, kernel 2 at these.
    fshape, fkt, (_, _, fwp, _), _, _ = _zero_copy(n, h, w, c, m, s, d, b,
                                                   tc, "fp32")
    _, fwd = walk_fwd(n, fwp, ho, wo, c, m, fkt.tile_h, fkt.tile_w, tc,
                      fkt.tile_m, K, s, d, b, e, e)
    assert T.dcl_train_hbm_bytes(shape, fkt, bwd_tiles=kt, **kw) == \
        fwd + want


@pytest.mark.parametrize("case", SMALL, ids=SMALL_IDS)
@pytest.mark.parametrize("banded", [False, True], ids=["1b", "3"])
def test_sample_traffic_walks_kernels_1b_3(case, banded):
    n, h, w, c, m, s, d, b, tc = case
    ho, wo = T.out_hw(h, w, kernel_size=K, stride=s, dilation=d)
    shape = T.LayerShape(h=h, w=w, c_in=c, c_out=c, stride=s,
                         offset_bound=b)
    if banded:
        th, tw = 4, min(8, wo)
        bands, nt = plan.pad_and_band(torch.zeros(n, h, w, c), kernel_size=K,
                                      stride=s, dilation=d, offset_bound=b,
                                      tile_h=th, ho=ho)
        want = walk_sample(n, bands.shape[3], nt * th, wo, c, th, tw, tc, K,
                           s, d, b, 4, 4) + 2 * bands.numel() * 4
        kt = T.KernelTiles(th, tw, tc, tc)
    else:
        shape, kt, (_, _, wp, _), _, _ = _zero_copy(n, h, w, c, c, s, d, b,
                                                    tc, "sample", tm=tc)
        want = walk_sample(n, wp, ho, wo, c, kt.tile_h, kt.tile_w, tc, K, s,
                           d, b, 4, 4)
    assert T.dcl_sample_hbm_bytes(
        shape, kt, batch=n, dilation=d,
        dataflow="materialized_band" if banded else "zero_copy") == want


@pytest.mark.parametrize("shards", [1, 2])
def test_spatial_traffic_is_the_shards_call_and_its_halo(shards):
    n, h, w, c, m, s, d, b, tc = 1, 16, 10, 8, 8, 1, 1, 2.0, 4
    shape = T.LayerShape(h=h, w=w, c_in=c, c_out=m, stride=s,
                         offset_bound=b)
    _, kt, (_, _, wp, _), ho, wo = _zero_copy(n, h // shards, w, c, m, s, d,
                                              b, tc, "fp32")
    _, local = walk_fwd(n, wp, ho, wo, c, m, kt.tile_h, kt.tile_w, tc,
                        kt.tile_m, K, s, d, b, 4, 4)
    halo = 0 if shards == 1 else 2 * halo_rows(
        kernel_size=K, dilation=d, offset_bound=b) * w * c * 4
    assert T.dcl_spatial_hbm_bytes(shape, kt, shards=shards, batch=n) == \
        local + halo
    with pytest.raises(ValueError, match="evenly divide"):
        T.dcl_spatial_hbm_bytes(shape, kt, shards=3)


@pytest.mark.parametrize("layers", [1, 3])
def test_chain_traffic_is_its_layers_kernels(layers):
    n, h, w, c, s, d, b, tc = 1, 10, 9, 16, 1, 1, 1.0, 8
    shape, kt, _, ho, wo = _zero_copy(n, h, w, c, c, s, d, b, tc,
                                      "int8_chain", tm=16)
    args = (n, ho, wo, c, c, kt.tile_h, kt.tile_w, tc, kt.tile_m, K, s, d, b)
    chained = (layers - 1) * walk_q(*args, True, 1) + walk_q(*args, True, 4)
    assert T.dcl_chain_hbm_bytes(shape, kt, layers=layers, batch=n) == \
        chained
    assert T.dcl_chain_hbm_bytes(shape, kt, layers=layers, batch=n,
                                 chained=False) == \
        layers * walk_q(*args, False, 4)
    with pytest.raises(ValueError, match="C_in"):
        T.dcl_chain_hbm_bytes(T.LayerShape(8, 8, 8, 16), kt)


# -- the model against core.h100's floors --------------------------------------

@pytest.mark.parametrize("shape", FIVE, ids=FIVE_IDS)
def test_traffic_is_at_least_the_bound_for_every_candidate(shape):
    n, h, c, s = 4, shape.h, shape.c_in, shape.stride
    geom = dict(kernel_size=K, stride=s, dilation=1)
    kw = dict(batch=n)
    floors = {
        "fp32": (h100.forward_work(n, h, h, c, c, **geom)["bytes"],
                 lambda kt: T.dcl_total_hbm_bytes(shape, kt, **kw)),
        "int8": (h100.int8_work(n, h, h, c, c, **geom)["bytes"],
                 lambda kt: T.dcl_total_hbm_bytes(shape, kt, bytes_per_elem=1,
                                                  **kw)),
        "int8_chain": (
            h100.int8_work(n, h, h, c, c, chain=True, emit="int8",
                           **geom)["bytes"],
            lambda kt: T.dcl_total_hbm_bytes(shape, kt, bytes_per_elem=1,
                                             fused_offsets=True, **kw)),
        "fp32_bwd": (h100.backward_work(n, h, h, c, c, **geom)["bytes"],
                     lambda kt: T.dcl_backward_hbm_bytes(shape, kt, **kw)),
    }
    for dtype, (floor, traffic) in floors.items():
        tg = dict(kernel_size=K, stride=s, offset_bound=B, dtype=dtype)
        seed = T.choose_kernel_tiles(n, h, h, c, c, **tg)
        cands = T.neighbor_kernel_tiles(n, h, h, c, c, seed, **tg)
        assert len(cands) > 1
        assert all(traffic(kt) >= floor for kt in cands), dtype
    kb = T.choose_kernel_tiles(n, h, h, c, c, kernel_size=K, stride=s,
                               offset_bound=B, dtype="banded")
    banded = T.dcl_total_hbm_bytes(shape, kb, dataflow="materialized_band",
                                   **kw)
    assert banded >= h100.banded_work(n, h, h, c, c, offset_bound=B,
                                      tile_h=kb.tile_h, **geom)["bytes"]
    assert banded > T.dcl_total_hbm_bytes(shape, kb, **kw)
    ks = T.choose_kernel_tiles(n, h, h, c, c, kernel_size=K, stride=s,
                               offset_bound=B, dtype="sample")
    assert T.dcl_sample_hbm_bytes(shape, ks, **kw) >= \
        h100.sample_work(n, h, h, c, **geom)["bytes"]


# -- the tuner's candidate cap --------------------------------------------------

@pytest.mark.parametrize("dtype", ["fp32", "int8", "fp32_bwd"])
def test_cap_candidates_picks_as_jax_does(dtype):
    h, c, s = 32, 256, 1
    shape = T.LayerShape(h=h, w=h, c_in=c, c_out=c, stride=s,
                         offset_bound=B)
    tg = dict(kernel_size=K, stride=s, offset_bound=B, dtype=dtype)
    seed = T.choose_kernel_tiles(4, h, h, c, c, **tg)
    cands = T.neighbor_kernel_tiles(4, h, h, c, c, seed, **tg)
    objective = "training" if dtype == "fp32_bwd" else "forward"
    fwd = T.choose_kernel_tiles(4, h, h, c, c, kernel_size=K, stride=s,
                                offset_bound=B, dtype="fp32")

    def key(kt):
        return autotune._traffic_key(
            shape, kt, batch=4, dilation=1, objective=objective,
            dtype=None if dtype == "fp32_bwd" else dtype, fwd_tiles=fwd)
    for cap in (None, 1, 2, 5, 12, len(cands) + 3):
        got = autotune._cap_candidates(cands, cap, key)
        assert got == jtune._cap_candidates(cands, cap, key)
        assert got[0] == seed


# -- the wiring: divergence rows and the report ----------------------------------

CTX = dict(op="deform_conv", precision="fp32", dataflow="zero_copy",
           shape=(2, 16, 16, 32), m=48, offset_bound=2.0, kernel_size=3,
           stride=1, dilation=1, device="cpu", itemsize=4,
           offset_itemsize=4, tiles=(None,) * 4)


@pytest.mark.parametrize("ctx", [
    CTX, dict(CTX, itemsize=2, offset_itemsize=2),
    dict(CTX, dataflow="banded"), dict(CTX, precision="int8"),
    dict(CTX, op="deform_conv_chain", emit="int8"),
    dict(CTX, op="deform_conv_chain", emit="fp32"),
    dict(CTX, objective="training"), dict(CTX, shards=(2, 1)),
    dict(CTX, shards=(1, 2), spatial_shards=2),
], ids=["fp32", "bf16", "banded", "int8", "chain", "chain-fp32",
        "training", "batch-shards", "height-shards"])
def test_price_carries_traffic_at_least_the_bound(ctx):
    from repro_torch.obs import price_dispatch
    price = price_dispatch(ctx)
    assert price["traffic_bytes"] >= price["bytes"] > 0
    if ctx is CTX:
        shape = T.LayerShape(h=16, w=16, c_in=32, c_out=48, offset_bound=B)
        assert price["traffic_bytes"] == T.dcl_total_hbm_bytes(
            shape, T.KernelTiles(*price["tiles"]), batch=2)


def test_engine_divergence_rows_and_report_carry_traffic():
    from repro_torch.configs.resnet50_dcn import CONFIG_BOUNDED
    from repro_torch.launch import obs_report
    from repro_torch.models import registry
    from repro_torch.models import resnet_dcn as R
    from repro_torch.obs import Tracer, tracer_scope
    from repro_torch.serve import DCLServeConfig, DCLServingEngine
    cfg = registry.reduced_config(CONFIG_BOUNDED)
    eng = DCLServingEngine(R.init_params(cfg, seed=0, device="cpu"), cfg,
                           DCLServeConfig(buckets=(64,), slots=2,
                                          quant="fp32_kernel"),
                           device="cpu")
    rng = np.random.RandomState(0)
    for _ in range(2):
        eng.submit(rng.randn(64, 64, 3).astype(np.float32))
    with tracer_scope(Tracer()):        # dispatches are timed when tracing
        eng.run_until_drained()
    report = eng.telemetry()["divergence"]
    rows = report["dispatches"]
    assert len(rows) == 2
    assert all(r["traffic_bytes"] >= r["modeled_bytes"] > 0 for r in rows)
    lines = obs_report.summarize_divergence(report)
    head = lines[0].split()
    assert head[head.index("modeled_MB") + 1] == "traffic_MB"
    for r in rows:
        line = next(ln for ln in lines if ln.startswith(r["key"]))
        assert f"{r['traffic_bytes'] * 1e-6:.3f}" in line.split()
