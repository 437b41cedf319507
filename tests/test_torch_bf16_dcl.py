"""Port parity: the bf16 bounded DCL (``ops.deform_conv`` on bf16 inputs,
forward and gradient) of ``repro_torch`` against the JAX package.

Inputs are made with numpy from a seed, rounded once to bf16 and fed to
both packages; the JAX side runs its Pallas kernels in interpret mode, as
its own tests do.  The cases are ``tests/test_kernels.py``'s
``test_deform_conv_fused_sweep`` cases.

Tolerances:

* forward: per element ``2**-7 * max|ref|`` (one bf16 step at the largest
  output), and at most 0.5% of the outputs unequal.  Both sides round
  each bilinear patch to bf16 (``band_pipeline.py:170`` in JAX) and
  contract the rounded values with fp32 accumulation; what is left is the
  fp32 summation order, which moves a rounding in a few outputs;
* gradient: d_offsets and d_weights per element ``2**-7 * max|ref|``;
  d_input too, with up to 60% of its elements unequal: JAX's kernel 2
  adds each tile's fp32 d_input band into a bf16 ``dx_pad`` by
  read-modify-write, tile after tile (``deform_conv_bwd.py:226-231``), so
  an overlapping halo is rounded once per visit, where the port sums in
  fp32 and rounds once.  The share grows with the halos' overlap: 10-36%
  at K = 3, 44% at B = 3, 51% at K = 5 with dilation 2 (each input row
  lies in up to four row tiles' bands).  So the port's d_input must also
  lie at least as close as JAX's to the fp32 gradient of the same
  bf16-valued inputs (JAX's fp32 kernels).  All three meet JAX's own
  bf16 tolerance (``TOL`` of ``tests/test_kernels.py``, 3e-2).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.tiling import out_hw
from repro.kernels import ops as JO
from repro_torch.kernels import band_pipeline as TB
from repro_torch.kernels import deform_conv_fused as TF
from repro_torch.kernels import ops as TO
from repro_torch.kernels import plan as TP

torch.set_num_threads(2)

BF16_STEP = 2.0 ** -7          # one bf16 step, relative to max|ref|
FWD_UNEQUAL = 0.005            # share of forward outputs that may differ
DX_UNEQUAL = 0.6               # share of d_input elements that may differ
JAX_TOL = dict(rtol=3e-2, atol=3e-2)   # tests/test_kernels.py TOL[bf16]

# tests/test_kernels.py CASES: (H, W, C, M, K, stride, dil, bound, tile_h,
# tile_c).
CASES = [
    (16, 20, 8, 16, 3, 1, 1, 2.0, 4, None),
    (16, 20, 8, 16, 3, 1, 1, 2.0, 4, 4),
    (16, 20, 8, 8, 3, 2, 1, 1.5, 4, None),
    (16, 20, 8, 8, 5, 1, 2, 2.0, 5, None),
    (15, 17, 4, 8, 3, 1, 1, 3.0, 4, 2),
    (8, 8, 16, 32, 3, 1, 1, 0.5, 8, 8),
]
# The zero-copy kernels' positions are local to their output tile, so both
# sides take the same tile_w (tests/test_torch_banded.py).
TILE_W = 4


def _ids(case):
    h, w, c, m, k, s, d, bound, th, tc = case
    return f"{h}x{w}x{c}->{m}_k{k}s{s}d{d}_B{bound}_th{th}_tc{tc}"


def _pair(a, dtype):
    """The fp32 array ``a`` rounded once to ``dtype``, for both packages."""
    j = jnp.asarray(a).astype(dtype)
    return j, torch.from_numpy(np.asarray(j.astype(jnp.float32))).to(
        getattr(torch, jnp.dtype(dtype).name))


def _inputs(case, seed, off_dtype=jnp.bfloat16):
    h, w, c, m, k, s, d, bound, th, tc = case
    rng = np.random.RandomState(seed)
    ho, wo = out_hw(h, w, kernel_size=k, stride=s, dilation=d)
    x = rng.randn(2, h, w, c).astype(np.float32)
    off = (rng.randn(2, ho, wo, 2 * k * k) * 3.0).astype(np.float32)
    wd = (rng.randn(k * k, c, m) * 0.2).astype(np.float32)
    g = rng.randn(2, ho, wo, m).astype(np.float32)
    return (_pair(x, jnp.bfloat16), _pair(off, off_dtype),
            _pair(wd, jnp.bfloat16), _pair(g, jnp.bfloat16))


def _kw(case, dataflow):
    h, w, c, m, k, s, d, bound, th, tc = case
    kw = dict(kernel_size=k, stride=s, dilation=d, offset_bound=bound,
              tile_h=th, tile_c=tc, dataflow=dataflow)
    if dataflow == "zero_copy":
        kw["tile_w"] = TILE_W
    return kw


def _np(t):
    return np.asarray(t.float() if isinstance(t, torch.Tensor)
                      else t.astype(jnp.float32), np.float32)


def _one_step(got, want):
    """(max|got - want| / max|want|, share of unequal elements)."""
    got, want = _np(got), _np(want)
    return (np.abs(got - want).max() / np.abs(want).max(),
            float(np.mean(got != want)))


@pytest.mark.parametrize("dataflow", ["zero_copy", "banded"])
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_bf16_deform_conv_matches_jax(case, dataflow):
    (jx, tx), (jo, to), (jw, tw), _ = _inputs(case, seed=sum(case[:5]))
    kw = _kw(case, dataflow)
    want = JO.deform_conv(jx, jo, jw, interpret=True, **kw)
    got = TO.deform_conv(tx, to, tw, device="cpu", **kw)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert tuple(got.shape) == want.shape
    err, unequal = _one_step(got, want)
    assert err <= BF16_STEP, err
    assert unequal <= FWD_UNEQUAL, unequal


@pytest.mark.parametrize("dataflow", ["zero_copy", "banded"])
def test_bf16_deform_conv_with_fp32_offsets_matches_jax(dataflow):
    case = CASES[1]
    (jx, tx), (jo, to), (jw, tw), _ = _inputs(case, seed=5,
                                              off_dtype=jnp.float32)
    kw = _kw(case, dataflow)
    want = JO.deform_conv(jx, jo, jw, interpret=True, **kw)
    got = TO.deform_conv(tx, to, tw, device="cpu", **kw)
    assert got.dtype == torch.bfloat16
    err, unequal = _one_step(got, want)
    assert err <= BF16_STEP and unequal <= FWD_UNEQUAL, (err, unequal)


GRAD_CASES = [(case, "zero_copy") for case in CASES] + [(CASES[1], "banded")]


@pytest.mark.parametrize("case,dataflow", GRAD_CASES,
                         ids=[f"{_ids(c)}-{f}" for c, f in GRAD_CASES])
def test_bf16_gradients_match_jax(case, dataflow):
    """The gradient of sum(y * g) for a bf16 cotangent g: kernel 2's plain
    version against JAX's kernel 2 (one kernel whichever forward ran)."""
    (jx, tx), (jo, to), (jw, tw), (jg, tg) = _inputs(case, seed=3 + case[2])
    kw = _kw(case, dataflow)

    def jloss(a, o, ww):
        y = JO.deform_conv(a, o, ww, interpret=True, **kw)
        return jnp.sum(y.astype(jnp.float32) * jg.astype(jnp.float32))
    want = jax.grad(jloss, argnums=(0, 1, 2))(jx, jo, jw)
    f32 = [a.astype(jnp.float32) for a in (jx, jo, jw)]
    dx32 = _np(jax.grad(jloss)(*f32))
    leaves = [t.clone().requires_grad_(True) for t in (tx, to, tw)]
    y = TO.deform_conv(*leaves, device="cpu", **kw)
    got = torch.autograd.grad((y.float() * tg.float()).sum(), leaves)
    shares = {}
    for name, a, r in zip(("d_input", "d_offsets", "d_weights"), got, want):
        assert a.dtype == torch.bfloat16 and r.dtype == jnp.bfloat16, name
        err, shares[name] = _one_step(a, r)
        assert err <= BF16_STEP, (name, err)
        np.testing.assert_allclose(_np(a), _np(r), err_msg=name, **JAX_TOL)
    assert shares["d_input"] < DX_UNEQUAL, shares
    assert np.abs(_np(got[0]) - dx32).max() \
        <= np.abs(_np(want[0]) - dx32).max()


def _old_plain_forward(xp, off, wt, *, kernel_size, stride, dilation,
                       offset_bound, tile_h, tile_w, tile_c):
    """The plain zero-copy forward as it was before the patches were
    rounded to x's dtype: fp32 patches contracted as they are."""
    patches = TB.sample_tiles(xp, TB.tile_offsets(off, tile_h, tile_w),
                              kernel_size=kernel_size, stride=stride,
                              dilation=dilation, offset_bound=offset_bound)
    y = TF.contract_chunks(patches, wt, tile_c)
    return TB.untile(y, off.shape[1], off.shape[2])


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_fp32_plain_forward_is_unchanged(case):
    """Rounding the patches to x's dtype is the identity in fp32: both
    plain forwards give the same bits as before."""
    h, w, c, m, k, s, d, bound, th, tc = case
    rng = np.random.RandomState(sum(case[:5]))
    ho, wo = out_hw(h, w, kernel_size=k, stride=s, dilation=d)
    x = torch.from_numpy(rng.randn(2, h, w, c).astype(np.float32))
    off = torch.from_numpy(
        (rng.randn(2, ho, wo, 2 * k * k) * 3.0).astype(np.float32))
    wd = torch.from_numpy((rng.randn(k * k, c, m) * 0.2).astype(np.float32))
    tc = tc or c
    geom = dict(kernel_size=k, stride=s, dilation=d, offset_bound=bound)
    spec = TP.DCSpec(k, s, d, bound, th, TILE_W, tc)
    tw_ = min(TILE_W, wo)
    xp, op, wt = TP.zerocopy_inputs(spec, x, off, wd, th, tw_, tc)
    got = TF.deform_conv_fused_zerocopy_plain(xp, op, wt, tile_h=th,
                                              tile_w=tw_, tile_c=tc, **geom)
    old = _old_plain_forward(xp, op, wt, tile_h=th, tile_w=tw_, tile_c=tc,
                             **geom)
    assert got.dtype == torch.float32 and torch.equal(got, old)
    bands, op_b = TP.banded_inputs(spec, x, off, th)
    got_b = TF.deform_conv_fused_banded_plain(
        bands, op_b, TP.tile_weights(wd, tc), tile_h=th, tile_c=tc, **geom)
    old_b = TF.contract_chunks(
        TB.sample_bands(bands, op_b, tile_h=th, **geom),
        TP.tile_weights(wd, tc), tc)
    assert torch.equal(got_b, old_b)
