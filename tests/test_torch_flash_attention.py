"""Port parity: ``repro_torch.kernels.flash_attention`` (TPU kernel 6)
against the JAX package.

On CPU tensors the port's wrappers run their plain version; the JAX kernel
runs in interpret mode, as ``tests/test_flash_attention.py`` runs it, on
that file's six cases.  Inputs are made with numpy from a seed and handed
to both.  Tolerances: fp32 1e-5 relative to the largest output (the
online softmax and the dense oracle sum in other orders), bf16 2e-2 (both
outputs rounded to bf16 from fp32 sums).  The CUDA kernel is held against
the plain version by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as JF
from repro.kernels import ref as JR
from repro.models import layers as JL
from repro_torch.kernels import flash_attention as TF
from repro_torch.kernels import ref as TR
from repro_torch.models import layers as TL

torch.set_num_threads(2)

RTOL = {"float32": 1e-5, "bfloat16": 2e-2}

CASES = [
    # (b, sq, sk, kv, g, dh, block_q, block_k, causal, softcap), as in
    # tests/test_flash_attention.py
    (1, 128, 128, 1, 1, 32, 64, 64, True, None),
    (2, 64, 64, 2, 2, 16, 32, 32, True, None),
    (1, 100, 100, 1, 2, 16, 32, 32, True, None),     # ragged vs blocks
    (1, 64, 64, 2, 1, 32, 64, 64, False, None),      # non-causal
    (1, 96, 96, 1, 1, 16, 32, 32, True, 8.0),        # softcap (grok-style)
    (1, 32, 160, 1, 1, 16, 32, 32, False, None),     # Sq != Sk (cross)
]


def _qkv(b, sq, sk, kv, g, dh, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, sq, kv, g, dh).astype(np.float32),
            rng.randn(b, sk, kv, dh).astype(np.float32),
            rng.randn(b, sk, kv, dh).astype(np.float32))


def _t(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


def _j(a, dtype):
    return jnp.asarray(a, getattr(jnp, dtype))


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _close(got, want, dtype):
    got, want = _np(got), _np(want)
    scale = np.abs(want).max()
    assert got.shape == want.shape
    np.testing.assert_allclose(got / scale, want / scale, rtol=RTOL[dtype],
                               atol=RTOL[dtype])


@functools.lru_cache(maxsize=None)
def _jax_case(i: int, dtype: str):
    """Inputs and the JAX kernel's and oracle's outputs for CASES[i]."""
    b, sq, sk, kv, g, dh, bq, bk, causal, cap = CASES[i]
    q, k, v = _qkv(b, sq, sk, kv, g, dh, seed=100 + i)
    jq, jk, jv = (_j(a, dtype) for a in (q, k, v))
    kern = JF.flash_attention(jq, jk, jv, causal=causal, softcap=cap,
                              block_q=bq, block_k=bk)
    ref = JR.flash_attention_ref(jq, jk, jv, causal=causal, softcap=cap)
    return (q, k, v), _np(kern), _np(ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("i", range(len(CASES)), ids=lambda i: f"case{i}")
def test_plain_path_matches_jax_kernel_and_oracle(i, dtype):
    b, sq, sk, kv, g, dh, bq, bk, causal, cap = CASES[i]
    (q, k, v), kern, ref = _jax_case(i, dtype)
    tq, tk, tv = (_t(a, dtype) for a in (q, k, v))
    before = TF.flash_attention.launches
    got = TF.flash_attention(tq, tk, tv, causal=causal, softcap=cap,
                             block_q=bq, block_k=bk)
    assert TF.flash_attention.launches == before       # no kernel on the CPU
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _close(got, kern, dtype)
    _close(got, ref, dtype)
    _close(TR.flash_attention_ref(tq, tk, tv, causal=causal, softcap=cap),
           ref, dtype)


# (case, splits): 1, 2, 3 and ceil(Sk / 64) key ranges where Sk has that
# many 64-key units.  Case 0 at 2 splits has a range wholly past the
# causal limit of rows 0..63; case 2 (Sk 100) and case 5 (Sk 160) end in a
# ragged range.
SPLIT_CASES = sorted({(i, s) for i, c in enumerate(CASES)
                      for s in (1, 2, 3, -(-c[2] // 64))
                      if s <= -(-c[2] // 64)})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("i,splits", SPLIT_CASES,
                         ids=lambda x: str(x))
def test_split_plain_matches_jax_kernel_and_oracle(i, splits, dtype):
    """The plain version of the split-over-K path against the JAX kernel
    (interpret mode) and the oracle, at the JAX test's tolerances."""
    b, sq, sk, kv, g, dh, bq, bk, causal, cap = CASES[i]
    (q, k, v), kern, ref = _jax_case(i, dtype)
    tq, tk, tv = (_t(a, dtype) for a in (q, k, v))
    got = TF.flash_attention_split_plain(tq, tk, tv, splits=splits,
                                         causal=causal, softcap=cap)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    tol = {"float32": 2e-5, "bfloat16": 2e-2}[dtype]
    for want in (kern, ref):
        np.testing.assert_allclose(_np(got), want, rtol=tol, atol=tol)


def test_split_ranges_are_contiguous_64_key_units():
    assert TF._split_ranges(100, 2) == [(0, 64), (64, 100)]
    ranges = TF._split_ranges(2048, 9)
    assert ranges[0][0] == 0 and ranges[-1][1] == 2048
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(r[0] % 64 == 0 and r[1] > r[0] for r in ranges)
    for bad in (0, 33):
        with pytest.raises(ValueError, match="splits must lie"):
            TF._split_ranges(2048, bad)


@pytest.mark.parametrize("blocks,sk,want", [
    (132, 4096, 1), (1024, 8192, 1), (5000, 64, 1),   # the grid fills the SMs
    (32, 2048, 9), (32, 8192, 9),                      # Sq <= 64, 32 heads
    (131, 4096, 3), (4, 10 ** 6, 66),
    (1, 100, 2), (2, 64, 1), (24, 150, 3),             # capped by Sk's units
])
def test_plan_splits(blocks, sk, want):
    assert TF._plan_splits(blocks, sk) == want


def test_plan_splits_never_exceeds_the_key_units():
    for blocks in range(1, 300, 7):
        for sk in (1, 63, 64, 65, 700, 2048, 8192):
            n = TF._plan_splits(blocks, sk)
            assert 1 <= n <= -(-sk // 64)
            assert n == 1 or blocks < 132


def test_kernel_splits_at_decode_and_prefill_shapes():
    """tinyllama's heads (KV 4, G 8): Sq = 1 runs 32 blocks, so 9 ranges;
    a 2048-token prefill fills the card and is not split."""
    def splits(b, sq, sk):
        return TF.kernel_splits(torch.zeros(b, sq, 4, 8, 64),
                                torch.zeros(b, sk, 4, 64))
    assert splits(1, 1, 2048) == 9
    assert splits(1, 16, 4096) == 9
    assert splits(1, 1, 100) == 2
    assert splits(1, 2048, 2048) == 1


# chip_smoke.py and tests/test_torch_cuda.py hold bf16 flash attention to
# a relative L2 error of 1e-2 besides the elementwise 2e-2.
BF16_REL_L2 = 1e-2


def _rel_l2(got, want):
    want = want.float()
    return ((got.float() - want).norm() / want.norm()).item()


@pytest.mark.parametrize("sq,sk", [(1, 8192), (16, 4096)])
def test_bf16_rel_l2_limit_rejects_a_split_left_out(sq, sk):
    """At chip_smoke.py's decode shapes (tinyllama's heads, not causal) a
    typical |o| is near the 2e-2 atol.  The relative L2 limit passes the
    split plain version and rejects, by a wide margin, a combine that
    leaves out any one of the splits."""
    q, k, v = (_t(a, "bfloat16") for a in _qkv(1, sq, sk, 4, 8, 64, sk))
    want = TF.flash_attention_plain(q, k, v, causal=False)
    splits = TF.kernel_splits(q, k)
    got = TF.flash_attention_split_plain(q, k, v, splits=splits,
                                         causal=False)
    assert _rel_l2(got, want) <= BF16_REL_L2
    for a, b in TF._split_ranges(sk, splits):
        keep = torch.cat([torch.arange(a), torch.arange(b, sk)])
        left_out = TF.flash_attention_plain(q, k[:, keep], v[:, keep],
                                            causal=False)
        assert _rel_l2(left_out, want) > 10 * BF16_REL_L2


def test_head_major_entry_matches_jax():
    q, k, v = _qkv(3, 70, 90, 1, 1, 32, seed=7)
    q, k, v = q[:, :, 0, 0], k[:, :, 0], v[:, :, 0]
    want = JF.flash_attention_bh(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=True, block_q=32,
                                 block_k=32)
    got = TF.flash_attention_bh(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), causal=True,
                                block_q=32, block_k=32)
    assert got.shape == (3, 70, 32)
    _close(got, want, "float32")


def test_block_shape_invariance():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 128, 128, 1, 2, 16, 0))
    outs = [TF.flash_attention(q, k, v, block_q=bq, block_k=bk)
            for bq, bk in [(32, 32), (64, 128), (128, 64)]]
    for o in outs[1:]:
        assert torch.equal(o, outs[0])


def test_plain_query_slices_change_no_result(monkeypatch):
    """The plain version slices long query sets; the rows are the same."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 50, 40, 2, 2, 16, 1))
    whole = TF.flash_attention(q, k, v, causal=True)
    monkeypatch.setattr(TF, "_PLAIN_SCORES", 2 * 2 * 2 * 40 * 7)
    sliced = TF.flash_attention(q, k, v, causal=True)
    torch.testing.assert_close(sliced, whole, rtol=0, atol=0)


@pytest.mark.parametrize("sq,sk", [(48, 80), (80, 48)])
def test_causal_with_sq_ne_sk_is_top_left_aligned(sq, sk):
    q, k, v = _qkv(1, sq, sk, 2, 2, 16, seed=sq)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    kern = JF.flash_attention(jq, jk, jv, causal=True, block_q=32,
                              block_k=32)
    got = TF.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                             causal=True, block_q=32, block_k=32)
    _close(got, kern, "float32")
    # Row i attends keys 0..i: query row 0 sees key 0 alone.
    np.testing.assert_allclose(_np(got)[0, 0], v[0, 0][:, None]
                               .repeat(2, 1), rtol=1e-6, atol=1e-6)


def test_matches_both_packages_dense_attention():
    """Kernel 6's function is the LM attention layer's: the same inputs
    through the port's flash entry point, the port's ``attention(impl=
    "dense")`` and the JAX package's agree (3e-5, as the JAX test)."""
    b, s, kv, g, dh = 2, 64, 2, 2, 16
    q, k, v = _qkv(b, s, s, kv, g, dh, seed=3)
    pos = np.broadcast_to(np.arange(s), (b, s))
    want = JL.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        jnp.asarray(pos), jnp.asarray(pos), window=None,
                        softcap=None, impl="dense")
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    tpos = torch.from_numpy(pos.copy())
    dense = TL.attention(tq, tk, tv, tpos, tpos, window=None, softcap=None,
                         impl="dense")
    got = TF.flash_attention(tq, tk, tv, causal=True, block_q=32,
                             block_k=32)
    for x in (dense, got):
        np.testing.assert_allclose(_np(x), np.asarray(want), rtol=3e-5,
                                   atol=3e-5)


@pytest.mark.parametrize("impl", ["chunked", "window"])
def test_rows_whose_first_key_block_is_fully_masked_stay_finite(impl):
    """A sliding window masks every key of the first blocks for late
    query rows: the finite -1e30 mask keeps those rows exact (no NaN), in
    both packages."""
    b, s, kv, g, dh, w = 1, 96, 1, 2, 16, 8
    q, k, v = _qkv(b, s, s, kv, g, dh, seed=5)
    pos = np.broadcast_to(np.arange(s), (b, s))
    args = [jnp.asarray(a) for a in (q, k, v, pos, pos)]
    targs = [torch.from_numpy(np.array(a))
             for a in (q, k, v, pos, pos)]
    if impl == "chunked":
        want = JL._sdpa_chunked(*args, w, None, block=16)
        got = TL._sdpa_chunked(*targs, w, None, block=16)
    else:
        want = JL.attention(*args, window=w, softcap=None, impl="window")
        got = TL.attention(*targs, window=w, softcap=None, impl="window")
    assert torch.isfinite(got).all()
    _close(got, want, "float32")
    dense = TL.attention(*targs, window=w, softcap=None, impl="dense")
    _close(got, dense, "float32")


def test_rejects_what_it_cannot_compute():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 8, 8, 1, 2, 16, 2))
    with pytest.raises(ValueError, match="all float32 or all bfloat16"):
        TF.flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="all float32 or all bfloat16"):
        TF.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="expected q"):
        TF.flash_attention(q, k[:, :, :, :8], v)
    with pytest.raises(ValueError, match="expected q"):
        TF.flash_attention_bh(q, k, v)
    with pytest.raises(ValueError, match="softcap must be positive"):
        TF.flash_attention(q, k, v, softcap=0.0)
    with pytest.raises(ValueError, match="positive"):
        TF.flash_attention(q, k, v, block_q=0)
    with pytest.raises(ValueError, match="no kernel"):
        TF.flash_attention(*(t.to("meta") for t in (q, k, v)))
