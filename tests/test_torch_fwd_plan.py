"""The fp32 forward kernel's plan and product arithmetic, on the CPU.

``csrc/deform_conv_fused.cu`` (TPU kernels 1a and 4) runs only on the
card; what can be held here is (a) its planner, the ``core.tiling``
mirrors the wrappers launch it with, at the five DCL shapes of both
serving buckets (batch 4), of a training step (batch 8, 512x512) and the
edge geometries ``chip_smoke.py`` phase 3 adds, for the zero-copy and the
banded dataflow; (b) the kernel's index arithmetic (warp tiles, the
swizzled weight layout, the patch tile's stride); (c) a plain emulation
of its split-fp32 tensor-core products ("3xTF32") with its fixed C-group
reduction, held to ``contract_chunks`` within phase 3's
``1e-5 * max|plain|``, against a single-pass TF32 product that lies at
least 10x further off; (d) the int8 kernels' tiles at the serving
shapes, pinned (their planner is held in ``tests/test_torch_q_plan.py``);
and (e) the bf16 instance's plan: its shared-memory mirror, rows padded to
16-deep mma steps with ldmatrix-friendly strides, its staging, the tiles
at both buckets and the training shapes, and a plain emulation of its
bf16 products with the fixed C-group order against ``contract_chunks``.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import tiling as T
from repro_torch.kernels import plan
from repro_torch.kernels.deform_conv_fused import contract_chunks, fwd_plan

K, B = 3, 2.0
KERNEL_RTOL = 1e-5           # chip_smoke.py phases 3 and 9
THREADS = 256                # csrc/deform_conv_fused.cu kThreads

# (label, n, h, w, c, m, stride, dilation, bound)
RESNET50_512 = [(64, 128, 1), (64, 256, 2), (32, 256, 1), (32, 512, 2),
                (16, 512, 1)]
SERVING = [(f"{b}: {h * b // 512}x{h * b // 512}x{c}->{c} s{s}", 4,
            h * b // 512, h * b // 512, c, c, s, 1, B)
           for b in (256, 512) for h, c, s in RESNET50_512]
TRAINING = [(f"train: {h}x{h}x{c}->{c} s{s}", 8, h, h, c, c, s, 1, B)
            for h, c, s in RESNET50_512]
EDGE = [
    ("ragged 17x23x64->64 s1", 2, 17, 23, 64, 64, 1, 1, B),
    ("dilation2 20x20x64->64", 2, 20, 20, 64, 64, 1, 2, B),
    ("ragged 15x15x32->48 s2", 1, 15, 15, 32, 48, 2, 1, B),
]
CASES = {c[0]: c[1:] for c in SERVING + TRAINING + EDGE}


def _tiles(label, dtype):
    """The tiles and plan a call at ``label`` launches with, as
    ``plan.spec_tiles`` (zero-copy) and ``plan.banded_tiles`` resolve
    them."""
    n, h, w, c, m, s, d, b = CASES[label]
    ho, wo = T.out_hw(h, w, kernel_size=K, stride=s, dilation=d)
    geom = dict(kernel_size=K, stride=s, dilation=d, offset_bound=b)
    t = T.choose_kernel_tiles(n, h, w, c, m, dtype=dtype, **geom)
    if dtype == "fp32":
        th, tw = min(t.tile_h, ho), min(t.tile_w, wo)
    else:                          # the bands' rows: whole row tiles
        th, tw = t.tile_h, min(t.tile_w, wo)
        ho = -(-ho // th) * th
    p = fwd_plan(n, ho, wo, c, m, tile_h=th, tile_w=tw, tile_c=t.tile_c,
                 tile_m=t.tile_m)
    return dict(n=n, ho=ho, wo=wo, c=c, m=m, th=th, tw=tw, tc=t.tile_c,
                tm=t.tile_m, geom=geom, plan=p, rows=t.tile_h)


def _halvings(th, tw, rows_fixed):
    """The chooser's spatial tiles from th x tw down to 16 pixels."""
    out = [(th, tw)]
    while th * tw > 16:
        if th >= tw and not rows_fixed:
            th = -(-th // 2)
        elif tw > 1:
            tw = -(-tw // 2)
        else:
            break
        out.append((th, tw))
    return out


@pytest.mark.parametrize("dtype", ["fp32", "banded"])
@pytest.mark.parametrize("label", list(CASES))
def test_forward_plan_fits_fills_the_card_and_covers_every_chunk(label,
                                                                  dtype):
    q = _tiles(label, dtype)
    p, c, tc = q["plan"], q["c"], q["tc"]
    chunks = c // tc
    assert c % tc == 0 and 1 <= q["tm"] <= T.FWD_TILE_M
    assert q["m"] % q["tm"] == 0 and q["th"] * q["tw"] <= T.PIX_LANES[-1]
    if dtype == "banded":
        assert q["rows"] == T.BANDED_TILE_H
    # Two blocks fit an SM's shared memory.
    smem = T.smem_bytes(q["th"], q["tw"], tc, **q["geom"])
    assert smem <= T.FWD_SMEM_TWO
    # The grid (pixel tiles x M tiles x C groups) reaches two blocks an SM,
    # or no legal tile could: not even the 16-pixel tiles of the chooser's
    # walk at one group a chunk.
    blocks = p["tiles"] * p["m_tiles"] * p["c_groups"]
    if blocks < T.BWD_TARGET_BLOCKS:
        n, ho, wo, m = q["n"], q["ho"], q["wo"], q["m"]
        best = max(n * -(-ho // a) * -(-wo // b) * -(-m // q["tm"]) * chunks
                   for a, b in _halvings(8 if dtype == "banded" else
                                         min(8, ho), min(8, wo),
                                         dtype == "banded")
                   if T.smem_bytes(a, b, tc, **q["geom"]) <= T.FWD_SMEM_TWO)
        assert best < T.BWD_TARGET_BLOCKS and p["c_groups"] == chunks
    # One group where the tiles alone reach the target; else the last wave
    # of two blocks an SM at least 95% full, or every chunk a group.
    if p["tiles"] * p["m_tiles"] >= T.BWD_TARGET_BLOCKS:
        assert p["c_groups"] == 1
    else:
        waves = -(-blocks // T.BWD_TARGET_BLOCKS)
        assert blocks >= T.BWD_WAVE_FILL * waves * T.BWD_TARGET_BLOCKS \
            or p["c_groups"] == chunks
    # The C groups cover the C chunks exactly once, none empty.
    ranges = [T.bwd_c_range(chunks, p["c_groups"], g)
              for g in range(p["c_groups"])]
    assert all(len(r) for r in ranges)
    assert [cs for r in ranges for cs in r] == list(range(chunks))


@pytest.mark.parametrize("label", [c[0] for c in SERVING + TRAINING])
def test_main_path_shapes_take_the_large_tiles(label):
    """The ResNet-50-DCN shapes take 128 output channels and 64 pixels a
    block, on both dataflows, at tile_c 8 (4 at stride 2, where an 8x8
    tile's band at tile_c 8 does not fit twice an SM)."""
    for dtype in ("fp32", "banded"):
        q = _tiles(label, dtype)
        s = CASES[label][5]
        assert (q["tm"], q["tc"]) == (128, 8 if s == 1 else 4), dtype
        assert q["th"] * q["tw"] == 64, dtype
        assert q["plan"]["tiles"] * q["plan"]["m_tiles"] \
            * q["plan"]["c_groups"] >= T.BWD_TARGET_BLOCKS


def test_smem_mirror_at_the_chip_cases():
    """``smem_bytes`` (the chooser's mirror of ``dcf_smem_bytes``) at the
    instances phase 3 launches: two band chunks, two weight chunks of
    K*K*tc rows padded to 8 by 128 channels, the patch tile (rows + 4)
    and the geometry."""
    for label in CASES:
        for dtype in ("fp32", "banded"):
            q = _tiles(label, dtype)
            g = q["geom"]
            bh = T.band_extent(q["th"], kernel_size=K, stride=g["stride"],
                               dilation=g["dilation"],
                               offset_bound=g["offset_bound"])
            bw = T.band_extent(q["tw"], kernel_size=K, stride=g["stride"],
                               dilation=g["dilation"],
                               offset_bound=g["offset_bound"])
            rows = -(-K * K * q["tc"] // 8) * 8
            lanes = T.pix_lanes(q["th"], q["tw"])
            band = -(-bh * bw * q["tc"] // 4) * 4
            want = 4 * (2 * band + 2 * rows * 128 + lanes * (rows + 4)
                        + 3 * K * K * lanes)
            assert T.smem_bytes(q["th"], q["tw"], q["tc"], **g) == want


# ---------------------------------------------------------------------------
# (b) The kernel's index arithmetic.
# ---------------------------------------------------------------------------

def _warps(pix):
    """csrc Warps<PIX>: warps along pixels and channels, 16-row and 8-col
    mma tiles a warp."""
    wp = 2 if pix >= 32 else 1
    wn = 8 // wp
    return wp, wn, pix // 16 // wp, 128 // wn // 8


@pytest.mark.parametrize("pix", T.PIX_LANES)
def test_warps_cover_the_output_tile_once(pix):
    wp, wn, mt, nt = _warps(pix)
    count = np.zeros((pix, 128), dtype=int)
    for warp in range(THREADS // 32):
        prow = (warp // wn) * (pix // wp)
        ncol = (warp % wn) * (128 // wn)
        for lane in range(32):
            gid, tig = lane >> 2, lane & 3
            for i in range(mt):
                for j in range(nt):
                    for e in range(4):
                        count[prow + i * 16 + gid + (e >> 1) * 8,
                              ncol + j * 8 + 2 * tig + (e & 1)] += 1
    assert (count == 1).all()


def test_swizzled_weights_are_a_bijection_and_free_of_bank_conflicts():
    """W[row][col] lives at row * 128 + (((col / 4) ^ 2 (row % 4)) * 4 +
    col % 4: 16-byte groups stay whole, every row is a permutation, and
    the 32 lanes of each B fragment (row kb + tig or + 4, column nb + gid)
    read 32 distinct banks."""
    def at(row, col):
        return row * 128 + ((((col >> 2) ^ ((row & 3) << 1)) << 2)
                            | (col & 3))
    for row in range(16):
        cols = [at(row, c) - row * 128 for c in range(128)]
        assert sorted(cols) == list(range(128))
        for q in range(32):
            assert [at(row, 4 * q + e) for e in range(4)] == \
                list(range(at(row, 4 * q), at(row, 4 * q) + 4))
    for kb in (0, 8, 72):
        for nb in range(0, 128, 8):
            for dk in (0, 4):
                banks = {at(kb + (lane & 3) + dk, nb + (lane >> 2)) % 32
                         for lane in range(32)}
                assert len(banks) == 32


@pytest.mark.parametrize("tc", [1, 2, 4, 5, 8, 16])
def test_patch_tile_rows_pad_and_stride(tc):
    """Rows of K*K*tc padded to whole 8-deep steps; the stride (+4) puts
    the eight rows of an A fragment on distinct banks."""
    rows = T.fwd_rows_pad(tc, kernel_size=K)
    assert rows % 8 == 0 and 0 <= rows - K * K * tc < 8
    ld = rows + 4
    for kb in range(0, rows, 8):
        banks = {((lane >> 2) * ld + kb + (lane & 3)) % 32
                 for lane in range(32)}
        assert len(banks) == 32


# ---------------------------------------------------------------------------
# (c) The kernel's product arithmetic, emulated in plain PyTorch.
# ---------------------------------------------------------------------------

def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round fp32 to tf32 as ``split_tf32`` does: to nearest, ties away
    from zero, on the 13 low mantissa bits."""
    u = x.contiguous().view(torch.int32)
    return ((u + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = tf32(x)
    return hi, tf32(x - hi)


def contract_3xtf32(patches, w_tiles, tile_c, groups, *, single=False):
    """(P, K*K, C) patches times the blocked weights as the kernel does:
    each C group sums its chunks in order (per chunk a_lo b_hi, a_hi b_lo,
    a_hi b_hi, small terms first; ``single``: one tf32 product instead),
    and the groups' partials are added in group order from zero."""
    pix, k2, c = patches.shape
    chunks = c // tile_c
    out = torch.zeros(pix, w_tiles.shape[2])
    for g in range(groups):
        acc = torch.zeros_like(out)
        for cs in T.bwd_c_range(chunks, groups, g):
            a = patches[:, :, cs * tile_c:(cs + 1) * tile_c] \
                .reshape(pix, k2 * tile_c)
            b = w_tiles[cs]
            if single:
                acc = acc + tf32(a) @ tf32(b)
                continue
            ah, al = split(a)
            bh, bl = split(b)
            acc = acc + al @ bh
            acc = acc + ah @ bl
            acc = acc + ah @ bh
        out = out + acc
    return out


@pytest.mark.parametrize("label", [c[0] for c in SERVING + TRAINING])
def test_split_tf32_contraction_meets_the_fp32_tolerance(label):
    """At the shape's full contraction (K*K*C rows, its tile_c and C
    groups) and reduced pixels and channels: the 3xTF32 emulation lies
    within 1e-5 * max|plain| of ``contract_chunks``; a single TF32 pass
    lies at least 10x further off, so the gate would catch one."""
    q = _tiles(label, "fp32")
    c, tc, groups = q["c"], q["tc"], q["plan"]["c_groups"]
    rng = np.random.RandomState(sum(map(ord, label)))
    pixels, m = 48, 24
    # Patches: bilinear mixes of unit-normal inputs, as the kernel builds
    # them from the band.
    t = rng.rand(pixels, K * K, c, 2).astype(np.float32)
    v = rng.randn(4, pixels, K * K, c).astype(np.float32)
    patches = torch.from_numpy(
        (1 - t[..., 0]) * (1 - t[..., 1]) * v[0]
        + (1 - t[..., 0]) * t[..., 1] * v[1]
        + t[..., 0] * (1 - t[..., 1]) * v[2] + t[..., 0] * t[..., 1] * v[3])
    wd = torch.from_numpy((rng.randn(K * K, c, m) / np.sqrt(K * K * c))
                          .astype(np.float32))
    w_tiles = plan.tile_weights(wd, tc)
    want = contract_chunks(patches, w_tiles, tc)
    scale = want.abs().max().item()
    err3 = (contract_3xtf32(patches, w_tiles, tc, groups) - want) \
        .abs().max().item()
    err1 = (contract_3xtf32(patches, w_tiles, tc, groups, single=True)
            - want).abs().max().item()
    assert err3 <= KERNEL_RTOL * scale, (err3, scale)
    assert err1 >= 10 * err3, (err1, err3)


def test_group_order_is_fixed():
    """The emulated reduction is a function of the inputs alone: the same
    call gives the same bits, and another group count moves them only
    within the tolerance."""
    rng = np.random.RandomState(3)
    patches = torch.from_numpy(rng.randn(16, 9, 32).astype(np.float32))
    w_tiles = plan.tile_weights(torch.from_numpy(
        rng.randn(9, 32, 8).astype(np.float32) / 17), 8)
    a = contract_3xtf32(patches, w_tiles, 8, 4)
    assert torch.equal(a, contract_3xtf32(patches, w_tiles, 8, 4))
    b = contract_3xtf32(patches, w_tiles, 8, 1)
    assert (a - b).abs().max() <= KERNEL_RTOL * b.abs().max()


# ---------------------------------------------------------------------------
# (d) The int8 kernels' tiles: one main body for both, 8x8 pixels by 128
#     output channels at tile_c 16 (two blocks an SM) at every main-path
#     shape; C groups fill the grid (tests/test_torch_q_plan.py).
# ---------------------------------------------------------------------------

INT8_TILES = {  # (dtype, bucket, h, c, stride): (tile_h, tile_w, tc, tm)
    ("int8", 256, 32, 128, 1): (8, 8, 16, 128),
    ("int8", 256, 32, 256, 2): (8, 8, 16, 128),
    ("int8", 256, 16, 256, 1): (8, 8, 16, 128),
    ("int8", 256, 16, 512, 2): (8, 8, 16, 128),
    ("int8", 256, 8, 512, 1): (8, 8, 16, 128),
    ("int8", 512, 64, 128, 1): (8, 8, 16, 128),
    ("int8", 512, 64, 256, 2): (8, 8, 16, 128),
    ("int8", 512, 32, 256, 1): (8, 8, 16, 128),
    ("int8", 512, 32, 512, 2): (8, 8, 16, 128),
    ("int8", 512, 16, 512, 1): (8, 8, 16, 128),
    ("int8_chain", 256, 32, 128, 1): (8, 8, 16, 128),
    ("int8_chain", 256, 32, 256, 2): (8, 8, 16, 128),
    ("int8_chain", 256, 16, 256, 1): (8, 8, 16, 128),
    ("int8_chain", 256, 16, 512, 2): (8, 8, 16, 128),
    ("int8_chain", 256, 8, 512, 1): (8, 8, 16, 128),
    ("int8_chain", 512, 64, 128, 1): (8, 8, 16, 128),
    ("int8_chain", 512, 64, 256, 2): (8, 8, 16, 128),
    ("int8_chain", 512, 32, 256, 1): (8, 8, 16, 128),
    ("int8_chain", 512, 32, 512, 2): (8, 8, 16, 128),
    ("int8_chain", 512, 16, 512, 1): (8, 8, 16, 128),
}


@pytest.mark.parametrize("key", sorted(INT8_TILES))
def test_int8_tiles_are_pinned(key):
    dtype, _, h, c, s = key
    t = T.choose_kernel_tiles(4, h, h, c, c, kernel_size=K, stride=s,
                              dilation=1, offset_bound=B, dtype=dtype)
    assert (t.tile_h, t.tile_w, t.tile_c, t.tile_m) == INT8_TILES[key]
    assert T.Q_TILE_M == 128 and T.PIX_LANES == (16, 32, 64)


# ---------------------------------------------------------------------------
# (e) The bf16 instance (chip_smoke.py phase 14).
# ---------------------------------------------------------------------------

BF16_RTOL = 2.0 ** -7        # one bf16 step, chip_smoke.py phase 14


def _tiles_bf16(label, dtype):
    """``_tiles`` at bf16's element size."""
    n, h, w, c, m, s, d, b = CASES[label]
    ho, wo = T.out_hw(h, w, kernel_size=K, stride=s, dilation=d)
    geom = dict(kernel_size=K, stride=s, dilation=d, offset_bound=b)
    t = T.choose_kernel_tiles(n, h, w, c, m, dtype=dtype, itemsize=2, **geom)
    th = min(t.tile_h, ho) if dtype == "fp32" else t.tile_h
    tw = min(t.tile_w, wo)
    return t, th, tw, geom


def test_bf16_smem_mirror_at_the_chip_cases():
    """``smem_bytes(itemsize=2)`` mirrors ``dcf_smem_bytes`` of the bf16
    instance: two bf16 band chunks (rounded to 16 bytes), two bf16 weight
    chunks of K*K*tc rows padded to 16 by 128 + 8 channels, the bf16 patch
    tile (rows + 8) and the fp32 geometry; the fp32 mirror is unchanged."""
    for label in CASES:
        for dtype in ("fp32", "banded"):
            t, th, tw, g = _tiles_bf16(label, dtype)
            tc = t.tile_c
            bh = T.band_extent(th, **g)
            bw = T.band_extent(tw, **g)
            rows = -(-K * K * tc // 16) * 16
            lanes = T.pix_lanes(th, tw)
            band = -(-2 * bh * bw * tc // 16) * 16
            want = 2 * band + 2 * (2 * rows * 136 + lanes * (rows + 8)) \
                + 12 * K * K * lanes
            assert T.smem_bytes(th, tw, tc, itemsize=2, **g) == want
            assert T.smem_bytes(th, tw, tc, **g) \
                == T.smem_bytes(th, tw, tc, itemsize=4, **g)
    with pytest.raises(ValueError, match="element size"):
        T.smem_bytes(8, 8, 8, kernel_size=K, stride=1, dilation=1,
                     offset_bound=B, itemsize=1)


@pytest.mark.parametrize("tc", [1, 2, 4, 5, 8, 16])
def test_bf16_rows_pad_to_16_and_ldmatrix_rows_spread(tc):
    """K*K*tc rows padded to whole 16-deep bf16 mma steps; a patch row of
    rows + 8 bf16 (16 mod 32 bytes) and a weight row of 136 bf16 (272
    bytes) put the eight 16-byte rows an ldmatrix reads on eight distinct
    16-byte bank groups, each row 16-byte aligned."""
    rows = T.fwd_rows_pad(tc, kernel_size=K, itemsize=2)
    assert rows % 16 == 0 and 0 <= rows - K * K * tc < 16
    assert T.fwd_rows_pad(tc, kernel_size=K) % 8 == 0
    for stride in (2 * (rows + T.FWD_P_PAD[2]),
                   2 * (T.FWD_TILE_M + T.FWD_W_PAD[2])):
        assert stride % 16 == 0
        assert len({(r * stride) % 128 // 16 for r in range(8)}) == 8


def test_bf16_staging_takes_the_widest_copy():
    """The bf16 band goes 8, 4 or 2 channels a copy (16, 8 or 4 bytes) as
    tile_c, C and the address allow, else element by element; W 16 bytes
    where M and tile_m are multiples of 8.  fp32 keeps its 4-channel
    copies."""
    from repro_torch.kernels.deform_conv_fused import staging_vec
    wt = torch.zeros(2, 72, 16, dtype=torch.bfloat16)
    for c, tc, want in ((16, 8, 4), (16, 4, 2), (12, 4, 2), (4, 2, 8),
                        (6, 2, 8), (20, 5, 0), (16, 16, 4)):
        x = torch.zeros(1, 4, 4, c, dtype=torch.bfloat16)
        assert staging_vec(x, wt, tc, 16) == want | 1, (c, tc)
    x = torch.zeros(1, 4, 4, 16, dtype=torch.bfloat16)
    assert staging_vec(x, wt, 8, 12) == 4            # tile_m not 8k: W
    moved = torch.zeros(x.numel() + 1, dtype=torch.bfloat16)[1:]
    assert staging_vec(moved.view(x.shape), wt, 8, 16) == 1   # 2 bytes off
    x32 = torch.zeros(1, 4, 4, 16)
    assert staging_vec(x32, wt.float(), 8, 16) == 3
    assert staging_vec(x32, wt.float(), 2, 16) == 1


@pytest.mark.parametrize("dtype", [torch.float64, torch.float16])
def test_other_dtypes_take_the_fp32_tiles_on_the_cpu(dtype):
    """Only bf16 sizes the chooser at 2 bytes: float64 and float16 inputs,
    which only the plain versions take (on the CPU; the card refuses
    them), get the fp32 instance's tiles, and ``ops.deform_conv`` without
    explicit tiles runs them in both dataflows, near the fp32 call on the
    same values."""
    from repro_torch.kernels import ops
    assert plan.kernel_itemsize(torch.zeros(1, dtype=torch.bfloat16)) == 2
    rng = np.random.RandomState(7)
    x32, off32, w32 = (torch.from_numpy(rng.randn(*shape).astype(np.float32))
                       .to(dtype).float()
                       for shape in ((2, 12, 12, 16), (2, 12, 12, 2 * K * K),
                                     (K * K, 16, 24)))
    x, off, w = (t.to(dtype) for t in (x32, off32, w32))
    spec = plan.DCSpec(K, 1, 1, B)
    assert plan.spec_tiles(spec, x, off, w) \
        == plan.spec_tiles(spec, x32, off32, w32)
    assert plan.spec_tiles(spec, x, off, w, dtype="fp32_bwd") \
        == plan.spec_tiles(spec, x32, off32, w32, dtype="fp32_bwd")
    assert plan.banded_tiles(spec, x, off, 24, dtype="banded") \
        == plan.banded_tiles(spec, x32, off32, 24, dtype="banded")
    tol = 1e-5 if dtype == torch.float64 else 2.0 ** -9
    for dataflow in ("zero_copy", "banded"):
        y = ops.deform_conv(x, off, w, offset_bound=B, dataflow=dataflow,
                            device="cpu")
        want = ops.deform_conv(x32, off32, w32, offset_bound=B,
                               dataflow=dataflow, device="cpu")
        assert y.dtype == dtype and y.shape == want.shape
        assert (y.float() - want).abs().max().item() \
            <= tol * want.abs().max().item(), dataflow


@pytest.mark.parametrize("label", list(CASES))
def test_bf16_tiles_fit_twice_and_fill_the_card(label):
    """At both buckets, the training shapes and the edge cases, on both
    dataflows: the bf16 block fits twice an SM, and the main-path shapes
    take 64 pixels by 128 channels at tile_c 8 (stride 2 too: its bf16
    band fits) with a grid of two blocks an SM."""
    for dtype in ("fp32", "banded"):
        t, th, tw, g = _tiles_bf16(label, dtype)
        n, h, w, c, m = CASES[label][:5]
        assert T.smem_bytes(th, tw, t.tile_c, itemsize=2, **g) \
            <= T.FWD_SMEM_TWO
        if label.startswith(("256", "512", "train")):
            assert (th * tw, t.tile_c, t.tile_m) == (64, 8, 128), dtype
            ho, wo = T.out_hw(h, w, **{k: g[k] for k in
                                       ("kernel_size", "stride",
                                        "dilation")})
            p = fwd_plan(n, ho, wo, c, m, tile_h=th, tile_w=tw,
                         tile_c=t.tile_c, tile_m=t.tile_m)
            assert p["tiles"] * p["m_tiles"] * p["c_groups"] \
                >= T.BWD_TARGET_BLOCKS


def contract_bf16(patches, w_tiles, tile_c, groups):
    """The bf16 instance's products, emulated: bf16 patches times bf16
    weights, each product exact in fp32, every chunk summed into its C
    group's fp32 accumulator in order, the groups' partials added in group
    order from zero, y rounded once to bf16."""
    pix, k2, c = patches.shape
    chunks = c // tile_c
    out = torch.zeros(pix, w_tiles.shape[2])
    for g in range(groups):
        acc = torch.zeros_like(out)
        for cs in T.bwd_c_range(chunks, groups, g):
            a = patches[:, :, cs * tile_c:(cs + 1) * tile_c] \
                .reshape(pix, k2 * tile_c).double()
            acc = acc + (a @ w_tiles[cs].double()).float()
        out = out + acc
    return out.bfloat16()


@pytest.mark.parametrize("label", [c[0] for c in SERVING + TRAINING])
def test_bf16_products_with_the_fixed_group_order(label):
    """At the shape's full contraction (its bf16 tile_c and C groups) and
    reduced pixels and channels: the emulated kernel within one bf16 step
    of ``contract_chunks`` on the same bf16 patches, the same bits from
    call to call, and exactly the plain rounding wherever the two fp32
    sums round alike."""
    t, th, tw, g = _tiles_bf16(label, "fp32")
    n, h, w, c, m = CASES[label][:5]
    ho, wo = T.out_hw(h, w, kernel_size=K, stride=g["stride"],
                      dilation=g["dilation"])
    groups = fwd_plan(n, ho, wo, c, m, tile_h=th, tile_w=tw,
                      tile_c=t.tile_c, tile_m=t.tile_m)["c_groups"]
    rng = np.random.RandomState(sum(map(ord, label)))
    patches = torch.from_numpy(rng.randn(48, K * K, c).astype(np.float32)) \
        .bfloat16()
    w_tiles = plan.tile_weights(torch.from_numpy(
        (rng.randn(K * K, c, 24) / np.sqrt(K * K * c)).astype(np.float32))
        .bfloat16(), t.tile_c)
    want = contract_chunks(patches, w_tiles, t.tile_c).bfloat16()
    got = contract_bf16(patches, w_tiles, t.tile_c, groups)
    assert torch.equal(got, contract_bf16(patches, w_tiles, t.tile_c,
                                          groups))
    scale = want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() \
        <= BF16_RTOL * scale
    assert (got != want).float().mean().item() < 0.01
