"""The int8 forward kernels' plan and decomposition, on the CPU.

``csrc/deform_conv_q.cu`` (TPU kernels 1c and 1d) runs only on the card;
what can be held here is (a) its chooser and C-group planner
(``choose_kernel_tiles`` for ``"int8"`` / ``"int8_chain"``,
``fwd_c_groups`` at ``least=Q_GROUP_LEAST``) and the shared-memory mirror ``q_smem_bytes``, at every
DCL shape of both serving buckets (batch 4) and the edge geometries of
``chip_smoke.py`` phase 5; (b) the exact magic-number conversions of its
patch build (a band byte to fp32, a sample to int8) against
``torch.round``, ties and +-127.5 included; (c) a plain emulation of its
decomposition: the chain's offset stage into a buffer, band-local patches
built with those conversions, the weights chunk-major as the kernel's
``dqt_kernel`` lays them out, int32 partials of C groups summed in group
order (of the offset conv's groups too), then the epilogue.  The
emulation must equal the plain versions bit for bit (``torch.equal``) at
every grouping, and, at the JAX kernels' tiles, equal the JAX package's
kernels (interpret mode) on offsets of the 1/8 grid and lie within 1 LSB
of them on free offsets, as ``tests/test_torch_int8.py`` holds the plain
versions.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import deform_conv_q as JQK
from repro.kernels import plan as JP
from repro.quant import qtypes as JQ
from repro_torch.configs.resnet50_dcn import CONFIG_BOUNDED
from repro_torch.core import tiling as T
from repro_torch.kernels import deform_conv_q as Q
from repro_torch.kernels import plan
from repro_torch.kernels.band_pipeline import tile_corners, tile_offsets
from repro_torch.quant.qtypes import compute_scale, quantize_values
from repro_torch.serve import bucket_layer_dims

torch.set_num_threads(2)

K, B = 3, 2.0

# ---------------------------------------------------------------------------
# (a) The chooser and the C groups.
# ---------------------------------------------------------------------------

# (bucket, h, w, c, m, stride): C groups of the main grid and of the
# chain's offset conv at batch 4, 8x8 tiles, tile_c 16, 128 output
# channels a block (256 main blocks each: one wave, 97% full).
SERVING = {
    (256, 32, 32, 128, 128, 1): (4, 4),
    (256, 32, 32, 256, 256, 2): (8, 16),
    (256, 16, 16, 256, 256, 1): (8, 16),
    (256, 16, 16, 512, 512, 2): (16, 32),
    (256, 8, 8, 512, 512, 1): (16, 32),
    (512, 64, 64, 128, 128, 1): (1, 1),
    (512, 64, 64, 256, 256, 2): (2, 4),
    (512, 32, 32, 256, 256, 1): (2, 4),
    (512, 32, 32, 512, 512, 2): (4, 17),
    (512, 16, 16, 512, 512, 1): (4, 17),
}

# chip_smoke.py phase 5's edge geometries: (n, h, w, c, m, stride,
# dilation, B, tile_c or None) -> ((tile_h, tile_w, tile_c, tile_m),
# C groups, shared memory).
EDGES = {
    "ragged 17x23x64->64": ((2, 17, 23, 64, 64, 1, 1, 2.0, None),
                            ((4, 4, 32, 64), 2, 92160)),
    "dilation2 B1.5 20x20x64->64": ((2, 20, 20, 64, 64, 1, 2, 1.5, None),
                                    ((4, 4, 32, 64), 2, 95232)),
    "odd s2 15x15x32->48": ((1, 15, 15, 32, 48, 2, 1, 2.0, None),
                            ((4, 4, 32, 48), 1, 96960)),
    "4-byte s2 tc8": ((1, 15, 15, 32, 48, 2, 1, 2.0, 8),
                      ((4, 4, 8, 48), 4, 35328)),
    "1 group 4-byte 64x64x24->200": ((4, 64, 64, 24, 200, 1, 1, 2.0, None),
                                     ((8, 8, 24, 100), 1, 94528)),
    "int8 input verbatim 16x16x64": ((2, 16, 16, 64, 64, 1, 1, 2.0, None),
                                     ((4, 4, 32, 64), 2, 92160)),
}


def test_serving_shapes_are_the_model_s():
    shapes = {(bucket, d["h"], d["w"], d["c"], d["m"], d["stride"])
              for bucket in (256, 512)
              for d in bucket_layer_dims(CONFIG_BOUNDED, bucket).values()}
    assert shapes == set(SERVING)


@pytest.mark.parametrize("dtype", ["int8", "int8_chain"])
@pytest.mark.parametrize("shape", sorted(SERVING))
def test_q_chooser_at_serving_shapes(shape, dtype):
    _, h, w, c, m, s = shape
    t = T.choose_kernel_tiles(4, h, w, c, m, kernel_size=K, stride=s,
                              offset_bound=B, dtype=dtype)
    assert (t.tile_h, t.tile_w, t.tile_c, t.tile_m) == (8, 8, 16, 128)
    ho, wo = T.out_hw(h, w, kernel_size=K, stride=s)
    groups = T.fwd_c_groups(4, ho, wo, c, m, tile_h=8, tile_w=8,
                            tile_c=16, tile_m=128, least=T.Q_GROUP_LEAST)
    assert groups == SERVING[shape][0]
    blocks = T.grid_blocks(4, ho, wo, m, t) * groups
    assert blocks >= T.BWD_WAVE_FILL * T.BWD_TARGET_BLOCKS
    assert T._wave_fill(blocks) >= T.BWD_WAVE_FILL
    # Two blocks an SM.
    smem = T.q_smem_bytes(8, 8, 16, kernel_size=K, stride=s, dilation=1,
                          offset_bound=B)
    assert smem == (70432 if s == 1 else 78720) <= T.FWD_SMEM_TWO
    tiles = 4 * -(-ho // 8) * -(-wo // 8)
    assert Q.q_plan(4, ho, wo, c, m, tile_h=8, tile_w=8, tile_c=16,
                    tile_m=128) == dict(
        lanes=64, tiles=tiles, m_tiles=m // 128, c_groups=groups,
        off_groups=SERVING[shape][1])


@pytest.mark.parametrize("dtype", ["int8", "int8_chain"])
@pytest.mark.parametrize("label", sorted(EDGES))
def test_q_chooser_at_phase5_edges(label, dtype):
    (n, h, w, c, m, s, d, b, tc), (tiles, groups, smem) = EDGES[label]
    ho, wo = T.out_hw(h, w, kernel_size=K, stride=s, dilation=d)
    th, tw, tc, tm = plan.resolve_tiles(n, h, w, c, m, kernel_size=K,
                                        stride=s, dilation=d,
                                        offset_bound=b, tile_c=tc,
                                        dtype=dtype)
    th, tw = min(th, ho), min(tw, wo)
    assert (th, tw, tc, tm) == tiles
    assert Q.q_plan(n, ho, wo, c, m, tile_h=th, tile_w=tw, tile_c=tc,
                    tile_m=tm)["c_groups"] == groups
    got = T.q_smem_bytes(th, tw, tc, kernel_size=K, stride=s, dilation=d,
                         offset_bound=b)
    assert got == smem <= T.SMEM_PER_BLOCK


def test_q_smem_bytes_counts_the_kernel_s_buffers():
    """Two int8 band chunks (rounded to 16 bytes), two weight chunks of
    128 rows and the patch tile, each row K*K*tile_c padded to 32 + 16
    bytes, and 12 bytes of corner geometry a (tap, pixel)."""
    band = -(-15 * 15 * 16 // 16) * 16          # 8x8 tile, stride 1, B = 2
    row = T.q_rows_pad(16, kernel_size=3) + 16
    assert row == 176 and T.q_rows_pad(32, kernel_size=3) == 288
    assert T.q_rows_pad(4, kernel_size=3) == 64
    assert T.q_smem_bytes(8, 8, 16, kernel_size=3, stride=1, dilation=1,
                          offset_bound=2.0) \
        == 2 * band + (2 * 128 + 64) * row + 12 * 9 * 64
    with pytest.raises(ValueError, match="multiple of 4"):
        T.q_smem_bytes(8, 8, 6, kernel_size=3, stride=1, dilation=1,
                       offset_bound=2.0)


def test_int8_c_groups_take_a_near_full_wave_whole():
    """256 blocks (97% of a two-an-SM wave) take no split at the int8
    forward's threshold, where the backward's would split them in two;
    small grids split to fill a wave, and a grid that cannot fill one
    takes every chunk."""
    def groups(n, ho, wo, c, m, th, tc, tm):
        return T.fwd_c_groups(n, ho, wo, c, m, tile_h=th, tile_w=th,
                              tile_c=tc, tile_m=tm, least=T.Q_GROUP_LEAST)
    assert T._c_groups(256, 8) == 2
    assert T.fwd_c_groups(4, 64, 64, 128, 128, tile_h=8, tile_w=8,
                          tile_c=16, tile_m=128) == 2
    assert groups(4, 64, 64, 128, 128, 8, 16, 128) == 1
    assert groups(4, 8, 8, 512, 512, 8, 16, 128) == 16
    assert groups(1, 4, 4, 32, 8, 4, 8, 8) == 4
    assert groups(8, 64, 64, 128, 128, 8, 16, 128) == 1


@pytest.mark.parametrize("kind", ["dcq", "dcc_int8", "dcc_fp32"])
def test_call_plan_fills_the_c_signature(kind):
    """The wrappers' cached plan (``_q_call`` / ``_chain_call``) gives the
    library exactly the arguments its C signature takes, in one
    workspace whose pieces are 256-byte aligned and do not overlap, and
    is worked out once per shape."""
    from repro_torch.kernels import _build
    n, h, w, c, m, s = 2, 16, 16, 64, 48, 1
    k2 = K * K
    ho, wo = T.out_hw(h, w, kernel_size=K, stride=s)
    th, tw, tc, tm = plan.resolve_tiles(n, h, w, c, m, kernel_size=K,
                                        stride=s, dilation=1, offset_bound=B,
                                        dtype="int8")
    hp = plan.pad_zerocopy(torch.zeros(1, h, w, 4), kernel_size=K, stride=s,
                           dilation=1, offset_bound=B, tile_h=th, tile_w=tw,
                           ho=ho, wo=wo).shape[1]
    geom = dict(kernel_size=K, stride=s, dilation=1, offset_bound=B,
                tile_h=th, tile_w=tw, tile_c=tc, tile_m=tm)
    i8, f32 = torch.int8, torch.float32
    x = ((n, hp, hp, c), i8)
    if kind == "dcq":
        fn, operands = "dcq_forward", 4
        specs = (x, ((n, ho, wo, 2 * k2), f32), ((c // tc, k2 * tc, m), i8),
                 ((m,), f32))
        call = Q._q_call(*specs, **geom)
        pieces = [k2 * c * m]
    else:
        fn, operands = "dcc_forward", 7
        specs = (x, ((1, k2 * c, m), i8), ((1, k2 * c, 2 * k2), i8),
                 ((2 * k2,), f32), ((2 * k2,), f32), ((m,), f32),
                 ((m,), f32))
        call = Q._chain_call(*specs, emit=kind[4:], ho=ho, wo=wo, **geom)
        assert call.out_dtype == (i8 if kind == "dcc_int8" else f32)
        pieces = [k2 * c * m, k2 * c * 2 * k2, 4 * n * ho * wo * 2 * k2]
        hits = Q._chain_call.cache_info().hits
        assert Q._chain_call(*specs, emit=kind[4:], ho=ho, wo=wo,
                             **geom) is call
        assert Q._chain_call.cache_info().hits == hits + 1
    groups = Q.q_plan(n, ho, wo, c, m, tile_h=th, tile_w=tw, tile_c=tc,
                      tile_m=tm)["c_groups"]
    assert groups > 1
    pieces.append(4 * groups * n * ho * wo * m)
    assert call.out_shape == (n, ho, wo, m)
    # Pointers: the operands, out and the workspace pieces; then the
    # arguments, the staging flag and the stream.
    argtypes = _build.SIGNATURES["deform_conv_q"][fn][1]
    assert len(argtypes) == operands + 1 + len(call.ws) + len(call.args) + 2
    assert len(call.ws) == len(pieces)
    assert all(t is _build._P for t in argtypes[:operands + 1 + len(pieces)])
    floats = [i for i, t in enumerate(argtypes) if t is not _build._P
              and t is not _build._I]
    assert [type(a) for a in call.args] == [
        float if operands + 1 + len(pieces) + i in floats else int
        for i in range(len(call.args))]
    ends = [o + size for o, size in zip(call.ws, pieces)]
    assert all(o % 256 == 0 for o in call.ws)
    assert all(e <= o for e, o in zip(ends, call.ws[1:]))
    assert ends[-1] <= call.ws_bytes


def chunk_major(w_tiles, tile_c):
    """What ``dqt_kernel`` makes of weights in the TPU plan's layout
    (C // tile_w, K*K*tile_w, M): (C // tile_c, M, K*K*tile_c), the
    weights of chunk cs and output channel m contiguous, k = tap * tile_c
    + channel."""
    chunks, rows, m = w_tiles.shape
    w = plan.untile_weights(w_tiles, K)                 # (K*K, C, M)
    c = w.shape[1]
    return w.reshape(K * K, c // tile_c, tile_c, m).permute(1, 3, 0, 2) \
        .reshape(c // tile_c, m, K * K * tile_c)


def test_chunk_major_is_the_weights_k_contiguous_per_chunk():
    w = torch.randint(-127, 128, (9, 24, 40), dtype=torch.int8)
    for tile_w in (4, 8, 24):
        for tc in (4, 8, 12, 24):
            got = chunk_major(plan.tile_weights(w, tile_w), tc)
            assert got.shape == (24 // tc, 40, 9 * tc)
            for cs in range(24 // tc):
                # Row m of chunk cs: tap-major, the chunk's channels inside.
                want = w[:, cs * tc:(cs + 1) * tc, :].permute(2, 0, 1)
                assert torch.equal(got[cs], want.reshape(40, 9 * tc))


# ---------------------------------------------------------------------------
# (b) The magic-number conversions of the patch build.
# ---------------------------------------------------------------------------

MAGIC_BYTE = 8388736.0       # 2^23 + 128
MAGIC_ROUND = 12582912.0     # 1.5 * 2^23


def _byte_f32(q: torch.Tensor) -> torch.Tensor:
    """int8 -> fp32 as the kernel converts a band byte: the bits
    0x4B000000 | (byte ^ 0x80) are the float 2^23 + 128 + v."""
    u = (q.to(torch.int32) & 0xff) ^ 0x80
    return (u | 0x4B000000).view(torch.float32) - MAGIC_BYTE


def _round_i8(v: torch.Tensor) -> torch.Tensor:
    """fp32 -> int8 as the kernel rounds a sample: the low byte of
    v + 1.5 * 2^23, an fp32 add that rounds to nearest, ties to even."""
    low = (v + MAGIC_ROUND).view(torch.int32) & 0xff
    return (low - ((low & 0x80) << 1)).to(torch.int8)


def test_magic_byte_to_fp32_is_exact():
    q = torch.arange(-128, 128, dtype=torch.int32).to(torch.int8)
    assert torch.equal(_byte_f32(q), q.float())


def test_magic_round_matches_torch_round_on_ties_and_at_127_5():
    ties = torch.arange(-128, 128, dtype=torch.float32) + 0.5
    near = torch.cat([torch.nextafter(ties, ties + 1),
                      torch.nextafter(ties, ties - 1)])
    gen = torch.Generator().manual_seed(0)
    free = (torch.rand(100_000, generator=gen) * 255 - 127.5)
    for v in (ties, near, free, torch.tensor([-127.5, 127.5, -0.5, 0.5,
                                               -0.0, 1.5, 2.5])):
        # As bytes: the patch is stored as the low byte of the rounded
        # value; +-127.5 round to +-128 (even), whose byte is 0x80 both ways.
        want = (torch.round(v).to(torch.int64) & 0xff).to(torch.int32)
        got = (_round_i8(v).to(torch.int32) & 0xff)
        assert torch.equal(got, want)
    inside = free[free.abs() <= 127]
    assert torch.equal(_round_i8(inside), torch.round(inside).to(torch.int8))
    # The epilogue does not use the magic form: rint, then the clip.
    y = torch.tensor([-127.5, 127.5, -126.5, 126.5, 300.0, -1e9])
    assert torch.equal(torch.clamp(torch.round(y), -127, 127),
                       torch.tensor([-127.0, 127.0, -126.0, 126.0, 127.0,
                                     -127.0]))


# ---------------------------------------------------------------------------
# (c) The kernels' decomposition, emulated.
# ---------------------------------------------------------------------------

def _offset_stage(x_pad, woff_tiles, off_scale, off_bias, *, s, d, b, ho,
                  wo, tc, groups):
    """dco_kernel then the main body's read: the offset conv's int32 sums
    of the undeformed taps (padded rows oy*s + hb + ky*d) over each of
    ``groups`` groups of tile_c chunks, added (the kernel's atomics), then
    dequantized in fp32; returns (N, Ho, Wo, 2*K*K)."""
    hb = int(np.ceil(b))
    kk = torch.arange(K * K)
    rows = (torch.arange(ho) * s + hb)[:, None] + (kk // K) * d
    cols = (torch.arange(wo) * s + hb)[:, None] + (kk % K) * d
    taps = x_pad[:, rows[:, None, :], cols[None, :, :]]  # (N, Ho, Wo, K*K, C)
    woff = plan.untile_weights(woff_tiles, K)            # (K*K, C, 2*K*K)
    chunks = x_pad.shape[-1] // tc
    acc = torch.zeros(taps.shape[:3] + (woff.shape[2],), dtype=torch.int32)
    for grp in range(groups):
        cs = T.bwd_c_range(chunks, groups, grp)
        sl = slice(cs.start * tc, cs.stop * tc)
        part = taps[..., sl].reshape(*taps.shape[:3], -1).long() \
            @ woff[:, sl].reshape(-1, woff.shape[2]).long()
        acc = acc + part.to(torch.int32)
    return acc.float() * off_scale + off_bias


def _patches(x_pad, off, *, s, d, b, th, tw):
    """The patch build: band-local corner geometry, corner bytes to fp32
    by the magic form, products and sums in fp32 in the order (00, 01,
    10, 11), rounded to int8 by the magic form.  (N*tiles*th*tw, K*K, C)."""
    n, hp, wp, c = x_pad.shape
    idx00, ty, tx = tile_corners(x_pad, tile_offsets(off, th, tw),
                                 kernel_size=K, stride=s, dilation=d,
                                 offset_bound=b)
    idx, ty, tx = (t.reshape(n, -1) for t in (idx00, ty, tx))
    uy, ux = 1 - ty, 1 - tx
    flat = x_pad.reshape(n, hp * wp, c)
    rows = torch.arange(n)[:, None]

    def corner(shift, wgt):
        return _byte_f32(flat[rows, idx + shift]) * wgt[..., None]
    v = corner(0, uy * ux)
    v = v + corner(1, uy * tx)
    v = v + corner(wp, ty * ux)
    v = v + corner(wp + 1, ty * tx)
    return _round_i8(v).reshape(-1, K * K, c)


def emulate(x_pad, w_tiles, out_scale, out_bias=None, *, off=None,
            woff=None, emit="fp32", s, d, b, th, tw, tc, tm, ho, wo,
            groups=None):
    """The CUDA kernels' decomposition in plain PyTorch: offsets (given,
    or the chain's offset stage), patches, the chunk-major weights
    contracted one C chunk at a time into int32 partials of ``groups`` C groups
    (the kernels' by default), the partials summed in group order, then
    the epilogue; returns (N, Ho, Wo, M)."""
    n, _, _, c = x_pad.shape
    m = w_tiles.shape[2]
    if woff is not None:
        off = _offset_stage(x_pad, *woff, s=s, d=d, b=b, ho=ho, wo=wo, tc=tc,
                            groups=T.q_off_groups(n, ho, wo, c, tile_h=th,
                                                  tile_w=tw, tile_c=tc))
    p = _patches(x_pad, off, s=s, d=d, b=b, th=th, tw=tw).long()
    w_ck = chunk_major(w_tiles, tc).long()
    chunks = c // tc
    groups = groups or Q.q_plan(n, ho, wo, c, m, tile_h=th, tile_w=tw,
                                tile_c=tc, tile_m=tm)["c_groups"]
    acc = torch.zeros(p.shape[0], m, dtype=torch.int32)
    for grp in range(groups):
        part = torch.zeros(p.shape[0], m, dtype=torch.int64)
        for cs in T.bwd_c_range(chunks, groups, grp):
            part += p[:, :, cs * tc:(cs + 1) * tc].reshape(p.shape[0], -1) \
                @ w_ck[cs].T
        acc = acc + part.to(torch.int32)
    y = acc.float() * out_scale
    if out_bias is not None:
        y = y + out_bias
    if emit == "int8":
        y = torch.clamp(torch.round(y), -127, 127).to(torch.int8)
    ht, wt = -(-ho // th), -(-wo // tw)
    y = y.reshape(n, ht, wt, th, tw, m).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(n, ht * th, wt * tw, m)[:, :ho, :wo]


def _inputs(label, kind, emit="int8", tiles=None):
    """Quantized inputs of one phase-5 edge geometry at batch 1 (the
    chooser's tiles unless ``tiles``), and both calls' arguments."""
    (_, h, w, c, m, s, d, b, tc), _ = EDGES[label]
    n = 1
    ho, wo = T.out_hw(h, w, kernel_size=K, stride=s, dilation=d)
    th, tw, tc, tm = tiles or plan.resolve_tiles(
        n, h, w, c, m, kernel_size=K, stride=s, dilation=d, offset_bound=b,
        tile_c=tc, dtype="int8_chain" if kind == "dcc" else "int8")
    th, tw = min(th, ho), min(tw, wo)
    gen = torch.Generator().manual_seed(len(label))
    x = torch.randn(n, h, w, c, generator=gen)
    wd = torch.randn(K * K, c, m, generator=gen)
    sx, sw = compute_scale(x), compute_scale(wd, axis=-1)
    xp = plan.pad_zerocopy(quantize_values(x, sx), kernel_size=K, stride=s,
                           dilation=d, offset_bound=b, tile_h=th, tile_w=tw,
                           ho=ho, wo=wo)
    wq = quantize_values(wd, sw)
    geom = dict(s=s, d=d, b=b, th=th, tw=tw, tc=tc, tm=tm, ho=ho, wo=wo)
    kw = dict(kernel_size=K, stride=s, dilation=d, offset_bound=b,
              tile_h=th, tile_w=tw, tile_c=tc, tile_m=tm)
    if kind == "dcq":
        off = torch.randn(n, ho, wo, 2 * K * K, generator=gen) * 1.5
        scale = (sx * sw).reshape(m)
        wt = plan.tile_weights(wq, tc)
        return ((xp, off, wt, scale), kw,
                dict(args=(xp, wt, scale), off=off, **geom))
    woff = torch.randn(K * K, c, 2 * K * K, generator=gen)
    woq = quantize_values(woff, compute_scale(woff, axis=-1))
    acc_std = (K * K * c) ** 0.5 * 40 * 73              # offsets ~1.5 px
    off_scale = torch.full((2 * K * K,), 1.5 / acc_std)
    off_bias = torch.randn(2 * K * K, generator=gen) * 0.5
    out_scale = torch.full((m,), 60.0 / ((K * K * c) ** 0.5 * 20 * 47))
    out_bias = torch.randn(m, generator=gen) * 2
    wt, wot = plan.tile_weights(wq, c), plan.tile_weights(woq, c)
    kw.update(emit=emit, ho=ho, wo=wo)
    return ((xp, wt, wot, off_scale, off_bias, out_scale, out_bias), kw,
            dict(args=(xp, wt, out_scale, out_bias),
                 woff=(wot, off_scale, off_bias), emit=emit, **geom))


@pytest.mark.parametrize("kind", ["dcq", "dcc_int8", "dcc_fp32"])
@pytest.mark.parametrize("label", sorted(EDGES))
def test_emulation_equals_plain_at_every_grouping(label, kind):
    kernel = kind[:3]
    args, kw, em = _inputs(label, kernel, emit=kind[4:] or "int8")
    plain = Q.deform_conv_fused_zerocopy_q_plain if kernel == "dcq" \
        else Q.deform_conv_fused_zerocopy_chain_plain
    want = plain(*args, **kw)
    emu_args = em.pop("args")
    chunks = args[0].shape[-1] // em["tc"]
    for groups in sorted({None, 1, chunks, max(1, chunks // 2)},
                         key=lambda g: g or 0):
        got = emulate(*emu_args, groups=groups, **em)
        assert got.dtype == want.dtype and torch.equal(got, want), groups
    if kind == "dcc_int8":       # the requant really rounds and clips
        assert 0 < (want.abs() == 127).float().mean().item() < 0.5


# tests/test_torch_int8.py's EDGE_CASES that the JAX kernel runs fast: (H,
# W, C, M, stride, dilation, B, offset scale).
JAX_CASES = {
    "ragged_hw": (11, 13, 4, 4, 1, 1, 1.5, 1.0),
    "stride2_ragged_clamp": (15, 13, 4, 4, 2, 1, 1.5, 4.0),
    "multi_c_chunk": (16, 16, 8, 8, 1, 1, 2.0, 1.0),
}


@pytest.mark.parametrize("grid", [True, False], ids=["grid8", "free"])
@pytest.mark.parametrize("case", sorted(JAX_CASES))
def test_emulated_dcq_matches_jax_kernel(case, grid):
    """Kernel 1c's decomposition against the Pallas kernel (interpret
    mode) at its 4x4 tiles and tile_c 4, each chunk its own C group here:
    identical on offsets of the 1/8 grid, within 1 LSB on free ones."""
    h, w, c, m, s, d, b, osc = JAX_CASES[case]
    rng = np.random.RandomState(len(case))
    ho, wo = T.out_hw(h, w, kernel_size=K, stride=s, dilation=d)
    x = rng.randn(1, h, w, c).astype(np.float32)
    off = (rng.randn(1, ho, wo, 2 * K * K) * osc).astype(np.float32)
    if grid:
        off = np.round(off * 8) / 8
    wgt = (rng.randn(K * K, c, m) * 0.2).astype(np.float32)
    th, tw = min(4, ho), min(4, wo)
    sx = JQ.compute_scale(jnp.asarray(x))
    sw = JQ.compute_scale(jnp.asarray(wgt), axis=-1)
    ph, pw = (-ho) % th, (-wo) % tw
    xp = JP.pad_zerocopy(JQ.quantize_values(jnp.asarray(x), sx),
                         kernel_size=K, stride=s, dilation=d, offset_bound=b,
                         tile_h=th, tile_w=tw, ho=ho + ph, wo=wo + pw)
    wq = JQ.quantize_values(jnp.asarray(wgt), sw)
    scale = (sx * sw).reshape(1, m)
    offp = jnp.pad(jnp.asarray(off), ((0, 0), (0, ph), (0, pw), (0, 0)))
    want = np.asarray(JQK.deform_conv_fused_zerocopy_q(
        xp, offp, JP.tile_weights(wq, 4), scale, kernel_size=K, stride=s,
        dilation=d, offset_bound=b, tile_h=th, tile_w=tw, tile_c=4,
        tile_m=m, interpret=True))[:, :ho, :wo]
    got = emulate(torch.from_numpy(np.asarray(xp)),
                  plan.tile_weights(torch.from_numpy(np.asarray(wq)), 4),
                  torch.from_numpy(np.asarray(scale)).reshape(m),
                  off=torch.from_numpy(off), s=s, d=d, b=b, th=th, tw=tw,
                  tc=4, tm=m, ho=ho, wo=wo, groups=c // 4).numpy()
    lsb = np.asarray(scale).reshape(-1)
    if grid:
        np.testing.assert_array_equal(got, want)
    assert float((np.abs(got - want) / lsb).max()) <= 1.0


@pytest.mark.parametrize("case", ["ragged_hw", "multi_c_chunk"])
def test_emulated_chain_matches_jax_kernel(case):
    """Kernel 1d's decomposition (the offset stage into a buffer, then
    chunks of 4 channels in as many C groups) against the Pallas chain
    kernel at its 4x4 tiles (all of C a band): the int8 emission
    identical."""
    h, w, c, m, s, d, b, _ = JAX_CASES[case]
    rng = np.random.RandomState(7 + len(case))
    k2 = K * K
    ho, wo = T.out_hw(h, w, kernel_size=K, stride=s, dilation=d)
    th, tw = min(4, ho), min(4, wo)
    x = rng.randn(1, h, w, c).astype(np.float32)
    wq = JQ.quantize_values(jnp.asarray(rng.randn(k2, c, m) * 0.2),
                            jnp.float32(0.01))
    woq = JQ.quantize_values(jnp.asarray(rng.randn(k2, c, 2 * k2) * 0.1),
                             jnp.float32(0.002))
    sx = JQ.compute_scale(jnp.asarray(x))
    ph, pw = (-ho) % th, (-wo) % tw
    xp = JP.pad_zerocopy(JQ.quantize_values(jnp.asarray(x), sx),
                         kernel_size=K, stride=s, dilation=d, offset_bound=b,
                         tile_h=th, tile_w=tw, ho=ho + ph, wo=wo + pw)
    off_scale = np.full((1, 2 * k2), 0.02, np.float32)
    off_bias = (rng.randn(1, 2 * k2) * 0.5).astype(np.float32)
    out_scale = np.full((1, m), 0.05, np.float32)
    out_bias = (rng.randn(1, m) * 2).astype(np.float32)
    want = np.asarray(JQK.deform_conv_fused_zerocopy_chain(
        xp, JP.tile_weights(wq, c), JP.tile_weights(woq, c),
        jnp.asarray(off_scale), jnp.asarray(off_bias),
        jnp.asarray(out_scale), jnp.asarray(out_bias), kernel_size=K,
        stride=s, dilation=d, offset_bound=b, tile_h=th, tile_w=tw,
        tile_m=m, emit="int8", ho=ho + ph, wo=wo + pw,
        interpret=True))[:, :ho, :wo]

    def t(a):
        return torch.from_numpy(np.array(a, copy=True))
    got = emulate(t(xp), plan.tile_weights(t(wq), 4),
                  t(out_scale).reshape(m), t(out_bias).reshape(m),
                  woff=(plan.tile_weights(t(woq), c),
                        t(off_scale).reshape(-1), t(off_bias).reshape(-1)),
                  emit="int8", s=s, d=d, b=b, th=th, tw=tw, tc=4, tm=m,
                  ho=ho, wo=wo, groups=c // 4).numpy()
    assert got.dtype == want.dtype == np.int8 and np.abs(want).max() > 8
    np.testing.assert_array_equal(got, want)
