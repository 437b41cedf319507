"""The H100's published peaks and the work of one DCL kernel call: the
least time the card could take for it (its bound).

The one source of the bounds: ``chip_smoke.py`` takes every bound of its
kernels line and of its per-shape rows from here, and ``obs.divergence``
prices every instrumented dispatch with the same functions.  Peaks:
NVIDIA's data sheet for the H100 SXM (dense rates, 700 W).

A *work* is a dict of additive quantities — ``bytes`` (each input read
once and each output written once, at the element size the kernel reads
and writes), ``ops`` and the seconds its operations take on each unit
that may run them — with its ``kind`` and its bound (``bound``):

* ``"split"`` — 1a and 4 (the fused forward) and 2 (the backward: dP =
  g Wᵀ and dw = Pᵀ g) in fp32: fp32 flops on the CUDA cores
  (``fp32_s``) or its own 3xTF32 products, three tf32 products a product
  (``tf32x3_s``), whichever is lower;
* ``"int8"`` — 1c and 1d: the largest of three floors, the int8
  products on the tensor cores (``int8_s``), the bytes, and the bilinear
  patch build on the CUDA cores (``sample_s``: ``SAMPLE_OPS`` fp32
  operations a sample);
* ``"rate"`` — one time for all its operations (``op_s``): the bf16
  instances of 1a and 4 (bf16 products), of 2 (dP one bf16 pass, dw two
  tf32 passes), the DCNv3 core (``dcnv3_work``: fp32 on the CUDA cores)
  and any kernel priced at one peak (``rate_work``).

Every bound is the larger of the operations' time and the bytes' time.
``total`` sums the works of many calls (a shape's times its launches)
and bounds the sum, so a run's bound is that of its summed bytes and
operations.  Kernel 4 reads the bands that ``plan.pad_and_band``
materialises and computes and writes whole row tiles.  Bytes that cross
between cards (a halo exchange, a gradient sum) are priced at
``NVLINK_BYTES_PER_S``, NVLink 4's rate in one direction (the same data
sheet).  Imports no torch.
"""
from __future__ import annotations

import math

from repro_torch.core.tiling import band_extent, out_hw

PEAK_FP32_FLOPS = 67e12           # fp32 outside the tensor cores
PEAK_TF32_FLOPS = 494.7e12        # dense TF32 on the tensor cores
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_HBM_BYTES_PER_S = 3.35e12
# NVLink 4 between two H100 SXM cards: 900 GB/s a card in both directions
# together (18 links of 50 GB/s), so 450 GB/s each way.
NVLINK_BYTES_PER_S = 450e9
# The int8 kernels' patch build: fp32 operations a bilinear sample (4
# products, 3 sums, no FMA), at one a lane a clock on the CUDA cores.
SAMPLE_OPS = 7
CUDA_CORE_LANE_OPS = 132 * 128 * 1.98e9

# The DCNv3 core's fp32 operations a (channel, tap): the bilinear sample
# (``SAMPLE_OPS``), its softmax weight's product and the sum over taps.
DCNV3_OPS = SAMPLE_OPS + 2

# The quantities ``total`` adds; the rest of a work is derived.
ADDITIVE = ("bytes", "ops", "samples", "fp32_s", "tf32x3_s", "int8_s",
            "sample_s", "op_s")


def bound(work: dict) -> dict:
    """``work`` with its bound: ``byte_s``, ``op_s`` (the operations'
    time on the cheaper unit for ``"split"``, the larger floor for
    ``"int8"``), ``bound_s`` (the larger of the two), ``bound_by``, and
    for ``"split"`` both units' bounds (``bound_fp32_s``,
    ``bound_3xtf32_s``)."""
    out = {k: work[k] for k in ("kind", *ADDITIVE) if k in work}
    byte_s = out["bytes"] / PEAK_HBM_BYTES_PER_S
    kind = out["kind"]
    if kind == "split":
        out["bound_fp32_s"] = max(out["fp32_s"], byte_s)
        out["bound_3xtf32_s"] = max(out["tf32x3_s"], byte_s)
        out["op_s"] = min(out["fp32_s"], out["tf32x3_s"])
    elif kind == "int8":
        out["op_s"] = max(out["int8_s"], out["sample_s"])
    elif kind != "rate":
        raise ValueError(f"unknown kind of work {kind!r}")
    out.update(byte_s=byte_s, bound_s=max(out["op_s"], byte_s),
               bound_by="operations" if out["op_s"] >= byte_s else "bytes")
    return out


def total(parts) -> dict:
    """The bounded work of several calls: ``(work, count)`` pairs of one
    kind, each additive quantity summed ``count`` times."""
    parts = [(w, n) for w, n in parts]
    kinds = {w["kind"] for w, _ in parts}
    if len(kinds) != 1:
        raise ValueError(f"cannot total works of kinds {sorted(kinds)}")
    (kind,) = kinds
    keys = [k for k in ADDITIVE if k in parts[0][0]]
    return bound(dict(kind=kind, **{k: sum(w[k] * n for w, n in parts)
                                    for k in keys}))


def rate_work(nbytes: float, ops: float, peak: float) -> dict:
    """A kernel whose ``ops`` run at one ``peak`` rate (per second)."""
    return bound(dict(kind="rate", bytes=nbytes, ops=ops, op_s=ops / peak))


def split_work(flops: float, nbytes: float) -> dict:
    """Kernels 1a, 4 and 2 in fp32: the fp32 CUDA cores or 3xTF32."""
    return bound(dict(kind="split", bytes=nbytes, ops=flops,
                      fp32_s=flops / PEAK_FP32_FLOPS,
                      tf32x3_s=3 * flops / PEAK_TF32_FLOPS))


def int8_floors(ops: float, nbytes: float, samples: float) -> dict:
    """Kernels 1c and 1d: the int8 products, the bytes and the patch
    build."""
    return bound(dict(kind="int8", bytes=nbytes, ops=ops, samples=samples,
                      int8_s=ops / PEAK_INT8_OPS,
                      sample_s=SAMPLE_OPS * samples / CUDA_CORE_LANE_OPS))


def forward_work(n: int, h: int, w: int, c: int, m: int, *,
                 kernel_size: int, stride: int, dilation: int,
                 itemsize: int = 4, offset_itemsize: int | None = None
                 ) -> dict:
    """Kernel 1a (zero-copy fused forward), fp32 or bf16 (``itemsize``
    2): x, offsets, w read, y written."""
    ho, wo = out_hw(h, w, kernel_size=kernel_size, stride=stride,
                    dilation=dilation)
    k2, p = kernel_size * kernel_size, n * ho * wo
    flops = 2 * p * k2 * c * m
    nbytes = itemsize * (n * h * w * c + k2 * c * m + p * m) \
        + (offset_itemsize or itemsize) * p * 2 * k2
    if itemsize == 2:
        return rate_work(nbytes, flops, PEAK_BF16_FLOPS)
    return split_work(flops, nbytes)


def banded_work(n: int, h: int, w: int, c: int, m: int, *,
                kernel_size: int, stride: int, dilation: int,
                offset_bound: float, tile_h: int, itemsize: int = 4,
                offset_itemsize: int | None = None) -> dict:
    """Kernel 4 (banded fused forward): the materialised bands (row tiles
    of ``tile_h``), the offsets, products and outputs of whole row
    tiles."""
    ho, wo = out_hw(h, w, kernel_size=kernel_size, stride=stride,
                    dilation=dilation)
    k2 = kernel_size * kernel_size
    tiles = -(-ho // tile_h)
    band_h = band_extent(tile_h, kernel_size=kernel_size, stride=stride,
                         dilation=dilation, offset_bound=offset_bound)
    p0 = dilation * (kernel_size // 2) + int(math.ceil(offset_bound))
    rows = n * tiles * tile_h * wo
    flops = 2 * rows * k2 * c * m
    nbytes = itemsize * (n * tiles * band_h * (w + 2 * p0 + 1) * c
                         + k2 * c * m + rows * m) \
        + (offset_itemsize or itemsize) * rows * 2 * k2
    if itemsize == 2:
        return rate_work(nbytes, flops, PEAK_BF16_FLOPS)
    return split_work(flops, nbytes)


def backward_work(n: int, h: int, w: int, c: int, m: int, *,
                  kernel_size: int, stride: int, dilation: int,
                  itemsize: int = 4, offset_itemsize: int | None = None
                  ) -> dict:
    """Kernel 2: x, offsets, g, w read; dx, d_offsets, dw (fp32) written;
    dP = g Wᵀ and dw = Pᵀ g."""
    ho, wo = out_hw(h, w, kernel_size=kernel_size, stride=stride,
                    dilation=dilation)
    k2, p = kernel_size * kernel_size, n * ho * wo
    flops = 2 * 2 * p * k2 * c * m
    off_b = offset_itemsize or itemsize
    if itemsize == 2:
        half = flops / 2
        nbytes = 2 * (2 * n * h * w * c + p * m + k2 * c * m) \
            + off_b * 2 * p * 2 * k2 + 4 * k2 * c * m
        return bound(dict(kind="rate", bytes=nbytes, ops=3 * half,
                          op_s=half / PEAK_BF16_FLOPS
                          + 2 * half / PEAK_TF32_FLOPS))
    nbytes = 4 * (2 * n * h * w * c + p * m + 2 * k2 * c * m) \
        + off_b * 2 * p * 2 * k2
    return split_work(flops, nbytes)


def int8_work(n: int, h: int, w: int, c: int, m: int, *, kernel_size: int,
              stride: int, dilation: int, chain: bool = False,
              emit: str = "fp32") -> dict:
    """Kernels 1c (``chain=False``: fp32 offsets in, fp32 out) and 1d
    (the offset conv fused in; int8 or fp32 emission): the int8 input and
    weights, the scales and biases."""
    ho, wo = out_hw(h, w, kernel_size=kernel_size, stride=stride,
                    dilation=dilation)
    k2, p = kernel_size * kernel_size, n * ho * wo
    samples = p * k2 * c
    ops = 2 * samples * (m + (2 * k2 if chain else 0))
    out_b = 1 if chain and emit == "int8" else 4
    nbytes = n * h * w * c + k2 * c * m + p * m * out_b + 4 * m \
        + (k2 * c * 2 * k2 + 4 * (4 * k2 + m) if chain else 4 * p * 2 * k2)
    return int8_floors(ops, nbytes, samples)


def sample_work(n: int, h: int, w: int, c: int, *, kernel_size: int,
                stride: int, dilation: int, itemsize: int = 4,
                offset_itemsize: int | None = None) -> dict:
    """Kernels 1b and 3 (sampling, no contraction): x and the offsets
    read, the (N, Ho, Wo, K*K, C) patches written; ``SAMPLE_OPS`` fp32
    operations a sample on the CUDA cores."""
    ho, wo = out_hw(h, w, kernel_size=kernel_size, stride=stride,
                    dilation=dilation)
    k2, p = kernel_size * kernel_size, n * ho * wo
    nbytes = itemsize * (n * h * w * c + p * k2 * c) \
        + (offset_itemsize or itemsize) * p * 2 * k2
    return rate_work(nbytes, SAMPLE_OPS * p * k2 * c, PEAK_FP32_FLOPS)


def training_work(n: int, h: int, w: int, c: int, m: int, **kw) -> dict:
    """One training call of the bounded DCL: kernel 1a, then kernel 2 after
    it (their bounds add)."""
    fwd = forward_work(n, h, w, c, m, **kw)
    bwd = backward_work(n, h, w, c, m, **kw)
    return dict(bytes=fwd["bytes"] + bwd["bytes"],
                ops=fwd["ops"] + bwd["ops"],
                bound_s=fwd["bound_s"] + bwd["bound_s"],
                bound_by=bwd["bound_by"])


def dcnv3_work(n: int, h: int, w: int, c: int, groups: int,
               kernel_size: int = 3) -> dict:
    """The DCNv3 core (``ops.dcnv3``, stride 1): the input v (N, H, W, C),
    the offsets (2 K*K a group and pixel) and the mask logits (K*K a group
    and pixel) read once, y (N, H, W, C) written once, all fp32;
    ``DCNV3_OPS`` fp32 operations a channel and tap on the CUDA cores
    (the softmax and the tap geometry, once a group, are left out)."""
    k2, p = kernel_size * kernel_size, n * h * w
    nbytes = 4 * (2 * p * c + p * groups * 3 * k2)
    return rate_work(nbytes, DCNV3_OPS * p * c * k2, PEAK_FP32_FLOPS)
