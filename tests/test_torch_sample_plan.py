"""The sampling kernels' plan, on the CPU, and their bf16 instances'
plain versions against the JAX package.

``csrc/deform_sample.cu`` (TPU kernels 1b and 3) runs only on the card;
what can be held here is (a) the ``"sample"`` chooser and the mirrors the
wrappers launch the kernel with (``sample_smem_bytes``,
``sample_vec_bytes``, ``sample_c_groups``, the ``DsPlan`` layout) at the
five DCL shapes of the 512 bucket (batch 4) in fp32 and bf16, on both
dataflows; (b) the bf16 instances' plain versions, which the kernel
equals bit for bit on the card: ``ops.deform_sample`` in bf16 against
the JAX ``ops.deform_sample`` in bf16 on the sweep of
``tests/test_kernels.py`` at its bf16 tolerance (``rtol = atol = 3e-2``),
and the plain kernels 1b and 3 against the Pallas kernels (interpret
mode) on the same bf16 padded input and bands, within one bf16 step of
the largest output (``2**-8 * max|want|``: each side rounds its fp32 sum
once, XLA may fuse the sum in another order).  Inputs come from numpy
with a seed, cast to bf16 the same way on both sides.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import deform_sample as JS
from repro.kernels import ops as JO
from repro.kernels import plan as JP
from repro_torch.core import tiling as T
from repro_torch.kernels import _build
from repro_torch.kernels import deform_sample as TS
from repro_torch.kernels import ops as TO
from repro_torch.kernels import plan as TP

torch.set_num_threads(2)

K, B = 3, 2.0
BF16_TOL = dict(rtol=3e-2, atol=3e-2)        # tests/test_kernels.py TOL
RESNET50_512 = [(64, 128, 1), (64, 256, 2), (32, 256, 1), (32, 512, 2),
                (16, 512, 1)]
ITEMSIZE = {"fp32": 4, "bf16": 2}
DTYPE = {"fp32": torch.float32, "bf16": torch.bfloat16}
# tests/test_torch_banded.py CASES: (H, W, C, M, K, stride, dil, bound,
# tile_h, tile_c), with its zero-copy TILE_W.
CASES = [
    (16, 20, 8, 16, 3, 1, 1, 2.0, 4, None),
    (16, 20, 8, 16, 3, 1, 1, 2.0, 4, 4),
    (16, 20, 8, 8, 3, 2, 1, 1.5, 4, None),
    (16, 20, 8, 8, 5, 1, 2, 2.0, 5, None),
    (15, 17, 4, 8, 3, 1, 1, 3.0, 4, 2),
    (8, 8, 16, 32, 3, 1, 1, 0.5, 8, 8),
]
TILE_W = 4


def _ids(case):
    h, w, c, m, k, s, d, bound, th, tc = case
    return f"{h}x{w}x{c}_k{k}s{s}d{d}_B{bound}_th{th}_tc{tc}"


def _call_tiles(h, c, s, dt, dataflow):
    """The tiles and grid a batch-4 ``ops.deform_sample`` call at (h, c,
    s) launches with, as the entry point resolves them."""
    n = 4
    geom = dict(kernel_size=K, stride=s, dilation=1, offset_bound=B)
    ho, wo = T.out_hw(h, h, kernel_size=K, stride=s)
    if dataflow == "zero_copy":
        th, tw, tc, _ = TP.resolve_tiles(n, h, h, c, c, tile_h=8,
                                         dtype="sample",
                                         itemsize=ITEMSIZE[dt], **geom)
        th, tw = min(th, ho), min(tw, wo)
    else:
        x = torch.empty(n, h, h, c, dtype=DTYPE[dt], device="meta")
        off = torch.empty(n, ho, wo, 2 * K * K, device="meta")
        spec = TP.DCSpec(K, s, 1, B, 8, dataflow="banded")
        th, tw, tc, _ = TP.banded_tiles(spec, x, off, c, dtype="sample")
        ho = -(-ho // th) * th
    groups = T.sample_c_groups(n, ho, wo, c, tile_h=th, tile_w=tw,
                               tile_c=tc)
    blocks = n * -(-ho // th) * -(-wo // tw) * groups
    return dict(th=th, tw=tw, tc=tc, groups=groups, blocks=blocks,
                geom=geom, rows=th)


# -- (a) the chooser and the mirrors --------------------------------------------

@pytest.mark.parametrize("dataflow", ["zero_copy", "banded"])
@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("h,c,s", RESNET50_512)
def test_sample_chooser_fits_and_fills_the_card(h, c, s, dt, dataflow):
    t = _call_tiles(h, c, s, dt, dataflow)
    item = ITEMSIZE[dt]
    # One 128-byte line of channels a position, 16-byte vectors.
    assert c % t["tc"] == 0 and t["tc"] * item == T.SAMPLE_LINE
    assert T.sample_vec_bytes(t["tc"], item) == 16
    smem = T.sample_smem_bytes(t["rows"], t["tw"], t["tc"], itemsize=item,
                               **t["geom"])
    assert smem <= T.FWD_SMEM_TWO                     # two blocks an SM
    assert (c // t["tc"]) % t["groups"] == 0          # even C groups
    assert t["blocks"] >= T.SAMPLE_TARGET_BLOCKS >= T.SM_COUNT
    assert t["th"] == 8 and 2 <= t["tw"] <= 8


def test_sample_chooser_pins_the_main_path():
    """8x8 tiles at stride 1, 8x4 at stride 2 (an 8x8 band of stride 2
    does not fit twice), C split into the fewest groups that give one
    block an SM; bf16 halves the chunks, so its 16x16x512 tiles halve to
    reach that grid."""
    got = {dt: [(t["th"], t["tw"], t["tc"], t["groups"]) for t in
                (_call_tiles(h, c, s, dt, "zero_copy")
                 for h, c, s in RESNET50_512)] for dt in ITEMSIZE}
    assert got["fp32"] == [(8, 8, 32, 1), (8, 4, 32, 2), (8, 8, 32, 4),
                           (8, 4, 32, 8), (8, 8, 32, 16)]
    assert got["bf16"] == [(8, 8, 64, 1), (8, 4, 64, 2), (8, 8, 64, 4),
                           (8, 4, 64, 8), (8, 4, 64, 8)]


def test_sample_smem_bytes_follows_the_kernel():
    """Two stages of the band chunk (rounded to 16 bytes), 24 bytes a
    (pixel, tap) row (four fp32 weights, band position, output offset)
    and 4 a staged position; the stage count is the kernel's."""
    src = (_build.CSRC / "deform_sample.cu").read_text()
    assert f"constexpr int kStages = {T.SAMPLE_STAGES};" in src
    assert "24LL * rows" in src and "4LL * npos" in src
    geom = dict(kernel_size=3, stride=1, dilation=1, offset_bound=2.0)
    # 8x8 tile: band 15x15 = 225 positions, 576 rows.
    assert T.sample_smem_bytes(8, 8, 32, **geom) \
        == 2 * 225 * 128 + 24 * 576 + 4 * 225
    assert T.sample_smem_bytes(8, 8, 64, itemsize=2, **geom) \
        == T.sample_smem_bytes(8, 8, 32, **geom)
    # 3 fp32 / bf16 channels: 2700 / 1350 bytes a stage, rounded to 16.
    assert T.sample_smem_bytes(8, 8, 3, **geom) \
        == 2 * 2704 + 24 * 576 + 4 * 225
    assert T.sample_smem_bytes(8, 8, 3, itemsize=2, **geom) \
        == 2 * 1360 + 24 * 576 + 4 * 225
    # Stride 2, 8x4: band 22x14.
    geom["stride"] = 2
    assert T.sample_smem_bytes(8, 4, 32, **geom) \
        == 2 * 308 * 128 + 24 * 288 + 4 * 308


@pytest.mark.parametrize("tc,fp32,bf16", [(2, 8, 4), (4, 16, 8),
                                          (8, 16, 16), (128, 16, 16)])
def test_sample_vec_bytes(tc, fp32, bf16):
    """The vector width at C = tile_c of 2, 4, 8 and 128, and at a source
    4 or 2 bytes past a 16-byte boundary."""
    assert T.sample_vec_bytes(tc, 4) == fp32
    assert T.sample_vec_bytes(tc, 2) == bf16
    assert T.sample_vec_bytes(tc, 4, address=4) == 4
    assert T.sample_vec_bytes(tc, 2, address=4) == 4
    assert T.sample_vec_bytes(tc, 2, address=6) == 2
    with pytest.raises(ValueError, match="aligned"):
        T.sample_vec_bytes(tc, 4, address=2)


def test_sample_c_groups():
    """1 when the tiles alone reach the target; else the fewest groups
    that divide the chunks and reach it; at most one a chunk."""
    target = T.SAMPLE_TARGET_BLOCKS
    assert T.sample_c_groups(4, 128, 128, 64, tile_h=8, tile_w=8,
                             tile_c=32) == 1
    # 4 x 4 tiles, 8 chunks: 9 groups would reach it, so all 8.
    assert T.sample_c_groups(4, 16, 16, 256, tile_h=8, tile_w=8,
                             tile_c=32) == 8
    # 4 x 16 tiles, 8 chunks: 3 groups would reach it, 4 divide evenly.
    assert T.sample_c_groups(4, 32, 32, 256, tile_h=8, tile_w=8,
                             tile_c=32) == 4
    assert 4 * 16 * 4 >= target > 4 * 16 * 2
    # Too few chunks to reach it: one group a chunk.
    assert T.sample_c_groups(1, 8, 8, 64, tile_h=8, tile_w=8,
                             tile_c=32) == 2


def test_sample_chooser_smaller_chunks_then_one_block():
    """A band too large for two blocks an SM at a 128-byte chunk takes a
    smaller chunk; too large at any chunk for two, one; too large for
    one, it raises."""
    geom = dict(kernel_size=3, stride=2, dilation=4, offset_bound=6.0)
    t = T.choose_kernel_tiles(1, 64, 64, 64, 64, dtype="sample", **geom)
    assert t.tile_c < 32 and t.tile_h * t.tile_w == 16
    assert T.sample_smem_bytes(t.tile_h, t.tile_w, t.tile_c, **geom) \
        <= T.FWD_SMEM_TWO
    geom = dict(kernel_size=3, stride=2, dilation=4, offset_bound=50.0)
    t = T.choose_kernel_tiles(1, 64, 64, 64, 64, dtype="sample", **geom)
    assert t.tile_c == 1 and T.FWD_SMEM_TWO < T.sample_smem_bytes(
        t.tile_h, t.tile_w, t.tile_c, **geom) <= T.SMEM_PER_BLOCK
    with pytest.raises(ValueError, match="shared memory"):
        T.choose_kernel_tiles(1, 64, 64, 8, 8, dtype="sample",
                              kernel_size=3, stride=2, dilation=8,
                              offset_bound=200.0)


def test_plan_struct_matches_the_kernel_s():
    """``_DsPlan`` lists ``DsPlan``'s fields in order, all 4 bytes."""
    src = (_build.CSRC / "deform_sample.cu").read_text()
    body = re.search(r"struct DsPlan \{(.*?)\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    fields = [name.strip() for decl in body.split(";") if decl.strip()
              for name in decl.split(None, 1)[1].split(",")]
    assert [f for f, _ in TS._DsPlan._fields_] == fields
    assert TS._DsPlan.bound.size == 4 and \
        TS._DsPlan.smem.offset == 4 * (len(fields) - 1)


def test_plan_refuses_other_dtypes_before_building():
    kw = dict(kernel_size=3, stride=1, dilation=1, offset_bound=2.0,
              tile_h=4, tile_w=4, tile_c=None, address=0)
    x = ((1, 13, 13, 4), torch.float16)
    off = ((1, 4, 4, 18), torch.float32)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        TS._zerocopy_plan(x, off, **kw)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        TS._zerocopy_plan((x[0], torch.float32), (off[0], torch.float16),
                          **kw)


# -- (b) bf16 against the JAX package -------------------------------------------

def _case_arrays(case, seed):
    h, w, c, m, k, s, d, bound, th, tc = case
    rng = np.random.RandomState(seed)
    ho, wo = T.out_hw(h, w, kernel_size=k, stride=s, dilation=d)
    x = rng.randn(2, h, w, c).astype(np.float32)
    off = (rng.randn(2, ho, wo, 2 * k * k) * 3.0).astype(np.float32)
    return x, off


def _bf16(a):
    """(JAX, torch) bf16 copies of a float32 numpy array (both round to
    nearest even)."""
    return (jnp.asarray(a).astype(jnp.bfloat16),
            torch.from_numpy(a).to(torch.bfloat16))


def _np(t):
    return np.asarray(t.float() if isinstance(t, torch.Tensor)
                      else t.astype(jnp.float32))


@pytest.mark.parametrize("dataflow", ["zero_copy", "banded"])
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_deform_sample_bf16_matches_jax(case, dataflow):
    h, w, c, m, k, s, d, bound, th, tc = case
    x, off = _case_arrays(case, seed=int(sum(case[:8])) % 89)
    (jx, tx), (joff, toff) = _bf16(x), _bf16(off)
    kw = dict(kernel_size=k, stride=s, dilation=d, tile_h=th, tile_c=tc,
              offset_bound=bound, dataflow=dataflow)
    if dataflow == "zero_copy":
        kw["tile_w"] = TILE_W
    want = JO.deform_sample(jx, joff, **kw)
    got = TO.deform_sample(tx, toff, device="cpu", **kw)
    assert got.dtype == torch.bfloat16
    assert got.shape == want.shape == off.shape[:3] + (k * k, c)
    np.testing.assert_allclose(_np(got), _np(want), **BF16_TOL)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_plain_bf16_sample_kernels_match_pallas(case):
    h, w, c, m, k, s, d, bound, th, tc = case
    x, off = _case_arrays(case, seed=7)
    (jx, tx), (joff, toff) = _bf16(x), _bf16(off)
    ho, wo = off.shape[1], off.shape[2]
    geom = dict(kernel_size=k, stride=s, dilation=d, offset_bound=bound)
    th_z, tw_z = min(th, ho), min(TILE_W, wo)
    jspec = JP.DCSpec(k, s, d, bound, th_z, tw_z, tc, c, "zero_copy", True)
    jxp, joff_z, _ = JP.zerocopy_inputs(
        jspec, jx, joff, jnp.zeros((k * k, c, 1), jnp.bfloat16), th_z, tw_z,
        tc or c)
    want = _np(JS.deform_sample_zerocopy(
        jxp, joff_z, tile_h=th_z, tile_w=tw_z, tile_c=tc, interpret=True,
        **geom))[:, :ho, :wo]
    txp = TP.pad_zerocopy(tx, tile_h=th_z, tile_w=tw_z, ho=ho, wo=wo, **geom)
    got = TS.deform_sample_zerocopy(txp, toff, tile_h=th_z, tile_w=tw_z,
                                    tile_c=tc, **geom)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=2.0 ** -8 * np.abs(want).max())

    pad_h = (-ho) % th
    joff_b = jnp.pad(joff, ((0, 0), (0, pad_h), (0, 0), (0, 0)))
    jbands, _ = JP.pad_and_band(jx, tile_h=th, ho=ho + pad_h, **geom)
    want = _np(JS.deform_sample_banded(jbands, joff_b, tile_h=th, tile_c=tc,
                                       interpret=True, **geom))
    tbands = torch.from_numpy(_np(jbands).copy()).to(torch.bfloat16)
    toff_b = torch.from_numpy(_np(joff_b).copy()).to(torch.bfloat16)
    got = TS.deform_sample_banded(tbands, toff_b, tile_h=th, tile_w=3,
                                  tile_c=tc, **geom)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=2.0 ** -8 * np.abs(want).max())
