"""``ops.dcnv3``, the DCNv3 core with bounded offsets (``kernels.dcnv3``).

On the CPU its plain version is held against a per-tap loop written here
in float64 (groups 2 and 7, ragged extents, offsets past the bound, taps
outside the image, the softmax over taps), and the dispatch is held to
its context and price.  On the card (``-m cuda``) the ``dv3_`` kernel is
held against the plain version on the CPU at one layer of each
InternImage-B stage's published shape (C 112 / 224 / 448 / 896 at 128² /
64² / 32² / 16², batch 2) and a ragged one, with offsets past the bound:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_dcnv3.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import h100
from repro_torch.kernels import dcnv3 as K
from repro_torch.kernels import ops
from repro_torch.obs.divergence import price_dispatch

B = 2.0


def _inputs(n, h, w, c, groups, *, seed, offset_std=1.5, device="cpu"):
    """v, offsets (std ``offset_std`` px, so some pass ±B) and mask
    logits, drawn with numpy."""
    rng = np.random.default_rng(seed)
    k2 = 9
    v = rng.standard_normal((n, h, w, c)).astype(np.float32)
    off = (rng.standard_normal((n, h, w, groups * k2 * 2))
           * offset_std).astype(np.float32)
    logits = rng.standard_normal((n, h, w, groups * k2)).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (v, off, logits))


def per_tap_loop(v, off, logits, *, groups, bound, k=3):
    """The DCNv3 core in float64, tap by tap: tap t = ix*k + iy samples
    (y - k//2 + iy + dy, x - k//2 + ix + dx), (dx, dy) clamped to ±bound,
    with zero outside the image, weighted by the softmax of its group's
    logits."""
    v, off, logits = (np.asarray(a, np.float64) for a in (v, off, logits))
    n, h, w, c = v.shape
    gc, k2 = c // groups, k * k
    off = np.clip(off.reshape(n, h, w, groups, k2, 2), -bound, bound)
    lg = logits.reshape(n, h, w, groups, k2)
    m = np.exp(lg - lg.max(-1, keepdims=True))
    m /= m.sum(-1, keepdims=True)
    vp = np.zeros((n, h + 2, w + 2, groups, gc))      # a zero border:
    vp[:, 1:-1, 1:-1] = v.reshape(n, h, w, groups, gc)  # corners reach it
    out = np.zeros((n, h, w, groups, gc))
    ni, yi, xi, gi = np.meshgrid(np.arange(n), np.arange(h), np.arange(w),
                                 np.arange(groups), indexing="ij")
    for t in range(k2):
        ix, iy = divmod(t, k)
        px = xi - k // 2 + ix + off[..., t, 0]
        py = yi - k // 2 + iy + off[..., t, 1]
        x0, y0 = np.floor(px).astype(int), np.floor(py).astype(int)
        fx, fy = px - x0, py - y0
        for cy, cx, wb in ((0, 0, (1 - fy) * (1 - fx)), (0, 1, (1 - fy) * fx),
                           (1, 0, fy * (1 - fx)), (1, 1, fy * fx)):
            yy, xx = y0 + cy, x0 + cx
            inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            val = vp[ni, np.clip(yy, -1, h) + 1, np.clip(xx, -1, w) + 1, gi]
            out += (m[..., t] * wb * inside)[..., None] * val
    return out.reshape(n, h, w, c)


CASES = {"groups2": (2, 9, 9, 32, 2), "groups7_ragged": (2, 11, 13, 112, 7),
         "gc4": (1, 6, 5, 12, 3)}


@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_plain_matches_per_tap_loop(case):
    n, h, w, c, g = CASES[case]
    v, off, logits = _inputs(n, h, w, c, g, seed=list(CASES).index(case))
    assert (off.abs() > B).any()
    y = ops.dcnv3(v, off, logits, groups=g, offset_bound=B, device="cpu")
    assert y.shape == v.shape and y.dtype == torch.float32
    ref = per_tap_loop(v, off, logits, groups=g, bound=B)
    np.testing.assert_allclose(y.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_offsets_past_the_bound_are_clamped():
    v, off, logits = _inputs(2, 8, 10, 32, 2, seed=3, offset_std=4.0)
    clamped = off.clamp(-B, B)
    assert (off != clamped).float().mean() > 0.3
    y = ops.dcnv3(v, off, logits, groups=2, offset_bound=B, device="cpu")
    assert torch.equal(y, ops.dcnv3(v, clamped, logits, groups=2,
                                    offset_bound=B, device="cpu"))
    # A wider bound samples elsewhere.
    assert not torch.allclose(y, ops.dcnv3(v, off, logits, groups=2,
                                           offset_bound=3.0, device="cpu"))


def test_samples_outside_the_image_read_zero():
    n, h, w, c, g = 1, 7, 7, 16, 1
    v = torch.ones(n, h, w, c)
    logits = torch.zeros(n, h, w, g * 9)
    # Every tap moved 2 pixels up and left: the top-left pixel's taps all
    # land outside the image; a pixel 3 from the top-left edges reads ones
    # at every tap, whose softmax weights sum to 1.
    off = torch.full((n, h, w, g * 18), -2.0)
    y = ops.dcnv3(v, off, logits, groups=g, offset_bound=B, device="cpu")
    assert torch.equal(y[0, 0, 0], torch.zeros(c))
    torch.testing.assert_close(y[0, 3:, 3:], torch.ones(4, 4, c))
    # Half a pixel past the left edge: the column inside weighs half.
    off = torch.zeros(n, h, w, g * 18)
    off[..., 0::2] = -0.5                        # dx of every tap
    logits[..., :3] = 50.0                       # taps ix = 0 take it all
    y = ops.dcnv3(v, off, logits, groups=g, offset_bound=B, device="cpu")
    torch.testing.assert_close(y[0, 3, 1], torch.full((c,), 0.5))


def test_softmax_over_each_groups_taps():
    n, h, w, c, g = 1, 6, 6, 32, 2
    v, off, logits = _inputs(n, h, w, c, g, seed=5)
    y = ops.dcnv3(v, off, logits, groups=g, offset_bound=B, device="cpu")
    # A constant added to one group's logits leaves the softmax as it is.
    shifted = logits.clone()
    shifted[..., :9] += 7.0
    torch.testing.assert_close(
        ops.dcnv3(v, off, shifted, groups=g, offset_bound=B, device="cpu"),
        y, rtol=1e-5, atol=1e-6)
    # One dominant tap: the output is that tap's bilinear sample alone,
    # here the pixel itself (centre tap t = 4, zero offsets).
    zero = torch.zeros_like(off)
    peaked = torch.zeros_like(logits)
    peaked[..., 4::9] = 60.0
    y = ops.dcnv3(v, zero, peaked, groups=g, offset_bound=B, device="cpu")
    torch.testing.assert_close(y, v, rtol=1e-6, atol=1e-6)
    # Equal logits: the mean of the 3x3 neighbourhood (zero outside).
    y = ops.dcnv3(v, zero, torch.zeros_like(logits), groups=g,
                  offset_bound=B, device="cpu")
    box = torch.nn.functional.avg_pool2d(v.permute(0, 3, 1, 2), 3, 1, 1,
                                         count_include_pad=True)
    torch.testing.assert_close(y, box.permute(0, 2, 3, 1), rtol=1e-5,
                               atol=1e-6)


def test_taps_run_x_outer_y_inner():
    """Tap 1 is (ix 0, iy 1): one pixel left of the centre column, on the
    centre row; tap 3 is (ix 1, iy 0): the centre column, one row up."""
    n, h, w, c, g = 1, 5, 5, 4, 1
    v = torch.arange(h * w, dtype=torch.float32).reshape(1, h, w, 1) \
        .expand(n, h, w, c).contiguous()
    zero = torch.zeros(n, h, w, 18)
    for tap, (dy, dx) in ((1, (0, -1)), (3, (-1, 0))):
        logits = torch.zeros(n, h, w, 9)
        logits[..., tap] = 60.0
        y = ops.dcnv3(v, zero, logits, groups=g, offset_bound=B,
                      device="cpu")
        assert float(y[0, 2, 2, 0]) == pytest.approx(
            float(v[0, 2 + dy, 2 + dx, 0]), abs=1e-5)


def test_wrong_layouts_raise():
    v, off, logits = _inputs(1, 4, 4, 32, 2, seed=1)
    with pytest.raises(ValueError, match="offsets must be"):
        ops.dcnv3(v, off[..., :-2], logits, groups=2, offset_bound=B,
                  device="cpu")
    with pytest.raises(ValueError, match="multiple of groups"):
        ops.dcnv3(v, off, logits, groups=3, offset_bound=B, device="cpu")
    # Operands laid out for a 5x5 kernel: only 3x3 is taken.
    v5 = torch.zeros(1, 6, 6, 32)
    with pytest.raises(ValueError, match="kernel_size 3"):
        ops.dcnv3(v5, torch.zeros(1, 6, 6, 2 * 25 * 2),
                  torch.zeros(1, 6, 6, 2 * 25), groups=2, kernel_size=5,
                  offset_bound=B, device="cpu")


def test_dispatch_context_and_price():
    v, off, logits = _inputs(2, 8, 8, 32, 2, seed=2)
    seen = []

    def hook(ctx):
        seen.append(dict(ctx))

    with ops.dispatch_hook_scope(hook):
        ops.dcnv3(v, off, logits, groups=2, offset_bound=B, device="cpu")
    (ctx,) = seen
    assert ctx["op"] == "dcnv3" and ctx["shape"] == (2, 8, 8, 32)
    assert ctx["groups"] == 2 and ctx["offset_bound"] == B
    price = price_dispatch(ctx)
    work = h100.dcnv3_work(2, 8, 8, 32, 2)
    assert price["bound_s"] == work["bound_s"] > 0
    assert price["bytes"] == 4 * (2 * 128 * 32 + 128 * 2 * 27)
    assert price["tiles"] == [8, 8, 2]
    assert price["traffic_bytes"] > price["bytes"]


def test_published_bytes_and_bound():
    """InternImage-B at 512², a forward of 32: 10.18 GB through the DCNv3
    core, bound by bytes at 3.04 ms."""
    layers = [(128, 112, 4), (64, 224, 4), (32, 448, 21), (16, 896, 4)]
    works = [(h100.dcnv3_work(32, e, e, c, c // 16), d)
             for e, c, d in layers]
    total = h100.total(works)
    assert total["bytes"] == pytest.approx(10.18e9, rel=1e-3)
    assert total["bound_by"] == "bytes"
    assert total["bound_s"] == pytest.approx(3.04e-3, rel=1e-3)


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


# One layer of each InternImage-B stage at 512² (batch 2), and a ragged
# extent with an odd group count.
CARD_CASES = {"stage0": (2, 128, 128, 112, 7), "stage1": (2, 64, 64, 224, 14),
              "stage2": (2, 32, 32, 448, 28), "stage3": (2, 16, 16, 896, 56),
              "ragged": (3, 13, 21, 112, 7)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CARD_CASES), ids=list(CARD_CASES))
def test_kernel_matches_plain(case, cuda):
    n, h, w, c, g = CARD_CASES[case]
    v, off, logits = _inputs(n, h, w, c, g, seed=11)
    assert (off.abs() > B).any()
    before = K.dcnv3.launches
    y = ops.dcnv3(v.to(cuda), off.to(cuda), logits.to(cuda), groups=g,
                  offset_bound=B, device=cuda)
    torch.cuda.synchronize()
    assert K.dcnv3.launches == before + 1
    ref = K.dcnv3_plain(v, off, logits, groups=g, kernel_size=3,
                        offset_bound=B)
    torch.testing.assert_close(y.cpu(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_kernel_refuses_gradients(cuda):
    v, off, logits = _inputs(1, 8, 8, 32, 2, seed=4, device=cuda)
    v.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="no backward kernel"):
        ops.dcnv3(v, off, logits, groups=2, offset_bound=B, device=cuda)
