"""The backward kernel's plan and product arithmetic, on the CPU.

``csrc/deform_conv_bwd.cu`` (TPU kernel 2) runs only on the card; what can
be held here is (a) its planner, the ``core.tiling`` mirrors the wrapper
launches it with, at the five DCL shapes of a ResNet-50-DCN training step
(batch 8, 512x512) and the three edge geometries ``chip_smoke.py`` phase 7
adds, and (b) a plain emulation of its split-fp32 tensor-core products
("3xTF32": a = hi + lo with hi, lo rounded to tf32, a.b ~ a_lo b_hi +
a_hi b_lo + a_hi b_hi, accumulated in fp32), held to the fp32 product
within phase 7's ``1e-4 * max|plain|``, against a single-pass TF32 product
that lies at least 10x further off; and (c) the bf16 instance: its
shared-memory mirrors and tiles at the training shapes, and its shorter
products (dP = g W^T one bf16 mma, whose products of bf16 values are exact
in fp32; dw = P^T g two tf32 passes, P split, g exact in tf32) held to
the fp32 product.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import tiling as T
from repro_torch.kernels import plan
from repro_torch.kernels.deform_conv_bwd import bwd_plan

K, B = 3, 2.0
BWD_RTOL = 1e-4              # chip_smoke.py phase 7, per cotangent
SMEM_MAX = 232_448           # 227 KB a block

# (label, n, h, w, c, m, stride, dilation, bound, tile_c)
TRAINING = [
    ("64x64x128->128 s1", 8, 64, 64, 128, 128, 1, 1, B, None),
    ("64x64x256->256 s2", 8, 64, 64, 256, 256, 2, 1, B, None),
    ("32x32x256->256 s1", 8, 32, 32, 256, 256, 1, 1, B, None),
    ("32x32x512->512 s2", 8, 32, 32, 512, 512, 2, 1, B, None),
    ("16x16x512->512 s1", 8, 16, 16, 512, 512, 1, 1, B, None),
]
EDGE = [
    ("ragged 17x23x64->64 s1", 2, 17, 23, 64, 64, 1, 1, B, None),
    ("dilation2 B1.5 20x20x64->64", 2, 20, 20, 64, 64, 1, 2, 1.5, None),
    ("odd s2 15x15x32->48 tc16", 1, 15, 15, 32, 48, 2, 1, B, 16),
]
CASES = {c[0]: c[1:] for c in TRAINING + EDGE}


def _plan(label):
    n, h, w, c, m, s, d, b, tc = CASES[label]
    ho, wo = T.out_hw(h, w, kernel_size=K, stride=s, dilation=d)
    th, tw, tc, _ = plan.resolve_tiles(n, h, w, c, m, kernel_size=K,
                                       stride=s, dilation=d, offset_bound=b,
                                       tile_c=tc, dtype="fp32_bwd")
    th, tw = min(th, ho), min(tw, wo)     # as plan.spec_tiles clamps them
    geom = dict(kernel_size=K, stride=s, dilation=d, offset_bound=b)
    return dict(n=n, ho=ho, wo=wo, c=c, m=m, th=th, tw=tw, tc=tc,
                geom=geom, plan=bwd_plan(n, ho, wo, c, m, kernel_size=K,
                                         tile_h=th, tile_w=tw, tile_c=tc))


@pytest.mark.parametrize("label", list(CASES))
def test_backward_plan_fills_the_card_and_covers_every_output(label):
    q = _plan(label)
    p, c, m, tc = q["plan"], q["c"], q["m"], q["tc"]
    chunks = c // tc
    # The d_input grid (tiles x C groups) reaches two blocks an SM
    # wherever C allows.
    blocks = p["tiles"] * p["c_groups"]
    assert blocks >= T.BWD_TARGET_BLOCKS or p["c_groups"] == chunks
    if q["plan"]["tiles"] < T.BWD_TARGET_BLOCKS:
        assert p["c_groups"] > 1 or chunks == 1
    # Both kernels fit a block's shared memory; d_input fits twice an SM.
    smem = T.bwd_smem_bytes(q["th"], q["tw"], tc, **q["geom"])
    assert smem <= SMEM_MAX // 2
    assert T.bwd_dw_smem_bytes(q["th"], q["tw"], tc, **q["geom"]) <= SMEM_MAX
    # The C groups cover the C chunks exactly once, none empty.
    ranges = [T.bwd_c_range(chunks, p["c_groups"], g)
              for g in range(p["c_groups"])]
    assert all(len(r) for r in ranges)
    assert [cs for r in ranges for cs in r] == list(range(chunks))
    # The d_weights grid covers every (row of K*K*tile_c, output channel)
    # exactly once, per chunk.
    n_chunks, row_blocks, col_blocks = p["dw_grid"]
    assert n_chunks == chunks and p["dw_cols"] == T.BWD_DW_COLS >= 128
    rows = K * K * tc
    count = np.zeros((rows, m), dtype=int)
    for rb in range(row_blocks):
        for cb in range(col_blocks):
            count[rb * T.BWD_DW_ROWS:(rb + 1) * T.BWD_DW_ROWS,
                  cb * T.BWD_DW_COLS:(cb + 1) * T.BWD_DW_COLS] += 1
    assert (count == 1).all()
    # Pixel splits: at most one a tile; where the tiles allow, at least
    # 90% of a wave of two blocks an SM, and whole waves 90% full.
    dw_blocks = n_chunks * row_blocks * col_blocks * p["dw_splits"]
    waves = -(-dw_blocks // T.BWD_TARGET_BLOCKS)
    assert 1 <= p["dw_splits"] <= p["tiles"]
    assert p["dw_splits"] == p["tiles"] or (
        dw_blocks >= T.BWD_WAVE_FILL * T.BWD_TARGET_BLOCKS
        and dw_blocks >= T.BWD_WAVE_FILL * waves * T.BWD_TARGET_BLOCKS)


def _warp_tiles(lanes: int, rows_pad: int, k_split: int, tpw: int):
    """The dP^T mma tiles (pixel tile, 8-row tile) each warp of a d_input
    block takes, per k-split group: the kernel's index arithmetic."""
    wg = 8 // k_split
    per_pt = (rows_pad // 8) // tpw
    out = {}
    for warp in range(8):
        kgrp, wi = warp // wg, warp % wg
        pt, j0 = wi // per_pt, (wi % per_pt) * tpw
        out[warp] = (kgrp, [(pt, j0 + j) for j in range(tpw)])
    return out


@pytest.mark.parametrize("label", list(CASES) + ["k5 2x3 tc2", "tc8 4x4",
                                                 "tc5 4x4", "tc16 8x8"])
def test_every_warp_takes_the_same_dp_tiles_once(label):
    """Each k-split group of warps covers the chunk's (pixels / 16) x
    (padded rows / 8) mma tiles exactly once, every warp the same number,
    at most ``BWD_MAX_WARP_TILES``."""
    extra = {"k5 2x3 tc2": (5, 2, 3, 2), "tc8 4x4": (3, 4, 4, 8),
             "tc5 4x4": (3, 4, 4, 5), "tc16 8x8": (3, 8, 8, 16)}
    if label in extra:
        k, th, tw, tc = extra[label]
    else:
        q = _plan(label)
        k, th, tw, tc = K, q["th"], q["tw"], q["tc"]
    lanes = T.pix_lanes(th, tw)
    rp = T.bwd_rows_pad(th, tw, tc, kernel_size=k)
    ks = T.bwd_k_split(th, tw, tc, kernel_size=k)
    tpw = T.bwd_warp_tiles(th, tw, tc, kernel_size=k)
    assert rp >= k * k * tc and tpw <= T.BWD_MAX_WARP_TILES
    want = {(pt, j) for pt in range(lanes // 16) for j in range(rp // 8)}
    got = _warp_tiles(lanes, rp, ks, tpw)
    for grp in range(ks):
        tiles = [t for kg, ts in got.values() if kg == grp for t in ts]
        assert sorted(tiles) == sorted(want)


# ---------------------------------------------------------------------------
# (b) The kernel's product arithmetic, emulated in plain PyTorch.
# ---------------------------------------------------------------------------

def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round fp32 to tf32 as ``split_tf32`` does: to nearest, ties away
    from zero, on the 13 low mantissa bits (integer arithmetic on the
    bits)."""
    u = x.contiguous().view(torch.int32)
    return ((u + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = tf32(x)
    return hi, tf32(x - hi)


def product_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernel's mma_3xtf32: small terms first, each product
    of two tf32 values exact in fp32, fp32 sums."""
    ah, al = split(a)
    bh, bl = split(b)
    return al @ bh + ah @ bl + ah @ bh


def test_tf32_rounding():
    x = torch.tensor([1.0, 1 + 2 ** -11, 1 + 2 ** -12, -(1 + 2 ** -11),
                      3.0e-3, -7.5e4], dtype=torch.float32)
    r = tf32(x)
    assert r[0] == 1.0
    assert r[1] == 1 + 2 ** -10                # a tie rounds away from 0
    assert r[2] == 1.0
    assert r[3] == -(1 + 2 ** -10)
    assert (r.view(torch.int32) & 0x1FFF).eq(0).all()
    rng = np.random.RandomState(0)
    v = torch.from_numpy(rng.randn(10000).astype(np.float32)) * 100
    assert ((v - tf32(v)).abs() <= 2 ** -11 * v.abs()).all()
    hi, lo = split(v)
    assert ((v - hi - lo).abs() <= 2 ** -21 * v.abs()).all()


@pytest.mark.parametrize("label", [c[0] for c in TRAINING])
def test_split_tf32_products_meet_the_fp32_tolerance(label):
    """dP = g W^T (contraction over M) and dw = P^T g (contraction over
    every pixel of the step) at the shape's full contraction lengths and
    reduced output widths: the 3xTF32 emulation lies within phase 7's
    1e-4 * max|plain| of the fp32 product; a single-pass TF32 product lies
    at least 10x further off, so the gate would catch one."""
    n, h, w, c, m, s, d, b, _ = CASES[label]
    ho, wo = T.out_hw(h, w, kernel_size=K, stride=s, dilation=d)
    pixels = n * ho * wo
    rng = np.random.RandomState(sum(map(ord, label)))
    rows, cols = 48, 40                       # reduced K*K*tile_c, pixels
    g = torch.from_numpy(rng.randn(pixels, m).astype(np.float32))
    wt = torch.from_numpy((rng.randn(rows, m) / np.sqrt(K * K * c))
                          .astype(np.float32))
    # Patches: bilinear mixes of unit-normal inputs, as the kernel
    # rebuilds them from the band.
    t = rng.rand(pixels, rows, 2).astype(np.float32)
    v = rng.randn(4, pixels, rows).astype(np.float32)
    patches = torch.from_numpy(
        (1 - t[..., 0]) * (1 - t[..., 1]) * v[0]
        + (1 - t[..., 0]) * t[..., 1] * v[1]
        + t[..., 0] * (1 - t[..., 1]) * v[2] + t[..., 0] * t[..., 1] * v[3])
    gd = g[:, :cols]
    for name, a, bm in (("dP = g W^T", g[:cols], wt.T),
                        ("dw = P^T g", patches.T, gd)):
        want = a @ bm
        scale = want.abs().max().item()
        err3 = (product_3xtf32(a, bm) - want).abs().max().item()
        err1 = (tf32(a) @ tf32(bm) - want).abs().max().item()
        assert err3 <= BWD_RTOL * scale, (name, err3, scale)
        assert err1 >= 10 * err3, (name, err1, err3)


# ---------------------------------------------------------------------------
# (c) The bf16 instance (chip_smoke.py phase 14).
# ---------------------------------------------------------------------------

def _plan_bf16(label):
    n, h, w, c, m, s, d, b, tc = CASES[label]
    ho, wo = T.out_hw(h, w, kernel_size=K, stride=s, dilation=d)
    th, tw, tc, _ = plan.resolve_tiles(n, h, w, c, m, kernel_size=K,
                                       stride=s, dilation=d, offset_bound=b,
                                       tile_c=tc, dtype="fp32_bwd",
                                       itemsize=2)
    return dict(n=n, ho=ho, wo=wo, c=c, m=m, th=min(th, ho), tw=min(tw, wo),
                tc=tc, geom=dict(kernel_size=K, stride=s, dilation=d,
                                 offset_bound=b))


@pytest.mark.parametrize("label", list(CASES))
def test_bf16_backward_mirrors_and_tiles(label):
    """``bwd_smem_bytes`` / ``bwd_dw_smem_bytes`` at itemsize 2 mirror the
    bf16 kernels: the bf16 band (16-byte rounded), the W / g steps in bf16
    or the fp32 dP chunk, whichever is larger, the fp32 sort and geometry;
    the d_weights kernel's bf16 bands and g tiles beside its fp32 patch
    tile.  The chooser's bf16 tiles fit (d_input twice an SM, d_weights
    once) within the warp-tile limit, and the grid fills the card as in
    fp32."""
    q = _plan_bf16(label)
    th, tw, tc, g = q["th"], q["tw"], q["tc"], q["geom"]
    lanes = T.pix_lanes(th, tw)
    pairs = K * K * lanes
    bh = T.band_extent(th, **g)
    bw = T.band_extent(tw, **g)
    band = -(-2 * bh * bw * tc // 16) * 16
    rp = T.bwd_rows_pad(th, tw, tc, kernel_size=K)
    ldr = rp + (8 if rp % 16 == 0 else 16)
    union = max(2 * 3 * (rp + lanes) * 20, 4 * lanes * ldr)
    assert T.bwd_smem_bytes(th, tw, tc, itemsize=2, **g) \
        == band + union + 4 * (13 * pairs + 2 * bh * bw + 1)
    g_tiles = 2 if lanes <= 32 else 1
    assert T.bwd_dw_smem_bytes(th, tw, tc, itemsize=2, **g) \
        == 2 * band + 8 * 144 + lanes * (2 * g_tiles * 136 + 4 * 152)
    assert T.bwd_smem_bytes(th, tw, tc, itemsize=2, **g) <= SMEM_MAX // 2
    assert T.bwd_dw_smem_bytes(th, tw, tc, itemsize=2, **g) <= SMEM_MAX
    assert T.bwd_warp_tiles(th, tw, tc, kernel_size=K) \
        <= T.BWD_MAX_WARP_TILES
    p = bwd_plan(q["n"], q["ho"], q["wo"], q["c"], q["m"], kernel_size=K,
                 tile_h=th, tile_w=tw, tile_c=tc)
    chunks = q["c"] // tc
    assert p["tiles"] * p["c_groups"] >= T.BWD_TARGET_BLOCKS \
        or p["c_groups"] == chunks
    # The fp32 mirrors are the itemsize-4 ones.
    assert T.bwd_smem_bytes(th, tw, tc, **g) \
        == T.bwd_smem_bytes(th, tw, tc, itemsize=4, **g)


@pytest.mark.parametrize("label", [c[0] for c in TRAINING])
def test_bf16_products_take_fewer_tf32_passes(label):
    """The bf16 instance runs dP = g W^T as one bf16 mma (every product
    of two bf16 values exact in fp32, so only the fp32 sums' order
    differs from the fp32 product) and dw = P^T g as two tf32 passes (g
    is exact in tf32; g P_lo + g P_hi, the patches P fp32), within phase
    7's 1e-4 * max|plain|; dropping P_lo lies at least 10x further off."""
    n, h, w, c, m, s, d, b, _ = CASES[label]
    ho, wo = T.out_hw(h, w, kernel_size=K, stride=s, dilation=d)
    pixels = n * ho * wo
    rng = np.random.RandomState(sum(map(ord, label)) + 1)
    rows, cols = 48, 40
    g = torch.from_numpy(rng.randn(pixels, m).astype(np.float32)) \
        .bfloat16().float()
    wt = torch.from_numpy((rng.randn(rows, m) / np.sqrt(K * K * c))
                          .astype(np.float32)).bfloat16().float()
    assert torch.equal(tf32(g), g) and torch.equal(tf32(wt), wt)
    prods = g[:cols, None, :] * wt[None]
    assert torch.equal(prods.double(),
                       g[:cols, None, :].double() * wt[None].double())
    dp = g[:cols] @ wt.T
    assert (prods.sum(-1) - dp).abs().max().item() \
        <= BWD_RTOL * dp.abs().max().item()
    t = rng.rand(pixels, rows, 2).astype(np.float32)
    v = torch.from_numpy(rng.randn(4, pixels, rows).astype(np.float32)) \
        .bfloat16().float().numpy()
    patches = torch.from_numpy(
        (1 - t[..., 0]) * (1 - t[..., 1]) * v[0]
        + (1 - t[..., 0]) * t[..., 1] * v[1]
        + t[..., 0] * (1 - t[..., 1]) * v[2] + t[..., 0] * t[..., 1] * v[3])
    gd = g[:, :cols]
    want = patches.T @ gd
    ph, pl = split(patches.T)
    two = ph @ gd + pl @ gd
    one = ph @ gd
    scale = want.abs().max().item()
    err2 = (two - want).abs().max().item()
    err1 = (one - want).abs().max().item()
    assert err2 <= BWD_RTOL * scale, (err2, scale)
    assert err1 >= 10 * err2, (err1, err2)
