"""Quantization-aware training of the DCL and the fake-quant references
of the int8 kernels (counterpart of ``repro.quant.qat``).

QAT fake-quantizes the deform-conv operands (activation per tensor,
weights per output channel, ``qtypes.fake_quant`` with its STE backward)
outside ``ops.deform_conv``, so the fp32 kernels run forward and
backward unchanged on the quantized grid: ``qat_quantize_inputs`` and
``qat_dcl_apply``, and ``dcl_apply(quant="qat")``.

``fake_quant_dcl_reference`` and ``fake_quant_dcl_chain_reference`` are
the ``use_kernel=False`` branches of ``dcl_apply`` for the ``int8`` and
``int8_chain`` modes and the independent oracles of the kernels: they
sample in the global frame (``kernels.ref.deform_sample_ref``) rather
than band by band.  The integer contractions run in float64, which is
exact for every layer of the model (|sum| <= 127^2 * K^2 * C < 2^53; fp32
would be exact only for C < 116).
"""
from __future__ import annotations

import torch

from repro_torch.quant.qtypes import (QMAX, compute_scale, fake_quant,
                                      fake_quant_absmax)

Tensor = torch.Tensor


def _f32(v, device) -> Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def qat_quantize_inputs(x: Tensor, w: Tensor, *, x_scale=None,
                        w_scale=None) -> tuple[Tensor, Tensor]:
    """Fake-quantize one DCL's (input plane, deform weights) pair.

    x: (N, H, W, C), per-tensor scale; w: (..., M), per-output-channel
    scales.  Scales default to the absmax observers (outside the
    gradient); calibrated values override."""
    dev = x.device
    xq = fake_quant_absmax(x) if x_scale is None \
        else fake_quant(x, _f32(x_scale, dev))
    if w_scale is None:
        wq = fake_quant_absmax(w, axis=-1)
    else:
        s = _f32(w_scale, dev)
        if s.ndim == 1:
            s = s.reshape((1,) * (w.ndim - 1) + (-1,))
        wq = fake_quant(w, s)
    return xq, wq


def qat_dcl_apply(params, x: Tensor, *, scales=None, **dcl_kwargs):
    """Fake-quant wrapper around ``models.layers.dcl_apply``: quantizes
    the deform-conv operands and delegates to the unmodified layer, so
    the plain path and the kernel path (``use_kernel=True``) both see the
    fake-quantized values.  ``scales`` is one calibration-table entry
    (``{"x_scale", "w_scale"}``); None means absmax."""
    from repro_torch.models.layers import dcl_apply

    x_scale = scales.get("x_scale") if scales else None
    w_scale = scales.get("w_scale") if scales else None
    xq, wq = qat_quantize_inputs(x, params["w_deform"], x_scale=x_scale,
                                 w_scale=w_scale)
    return dcl_apply(dict(params, w_deform=wq), xq, **dcl_kwargs)


def _contract(patches: Tensor, w: Tensor) -> Tensor:
    """Patches (N, Ho, Wo, K*K, C) by weights (K*K, C, M) in float64,
    rounded once to fp32 (exact for integer-valued operands)."""
    return torch.einsum("nhwkc,kcm->nhwm", patches.double(),
                        w.double()).float()


def fake_quant_dcl_chain_reference(x: Tensor, w: Tensor, w_offset: Tensor,
                                   b_offset: Tensor,
                                   b_deform: Tensor | None = None, *,
                                   kernel_size: int = 3, stride: int = 1,
                                   dilation: int = 1,
                                   offset_bound: float | None = None,
                                   x_scale=None, w_scale=None,
                                   w_offset_scale=None, y_scale=None
                                   ) -> tuple[Tensor, Tensor]:
    """Fake-quant oracle of the chained int8 kernel.

    Input and weights fake-quantize onto their grids; the offsets come
    from the quantized offset conv plus the fp32 bias; the sampled
    patches re-round onto the activation grid; the output (bias folded
    first) fake-quantizes onto ``y_scale`` when given (``None`` is the
    fp32 chain tail).  Returns ``(y, offsets)``.
    """
    from repro_torch.core.deform_conv import conv2d
    from repro_torch.kernels.ref import deform_sample_ref

    k = kernel_size
    k2 = k * k
    cin = x.shape[-1]
    cout = w.shape[-1]
    if x_scale is None:
        raise ValueError(
            "the chain reference needs x_scale: chained layers exchange "
            "values on a pinned activation grid (calibrate first)")
    dev = x.device
    sx = _f32(x_scale, dev)
    xq = fake_quant(x, sx)
    if w_scale is None:
        wq = fake_quant_absmax(w, axis=-1)
    else:
        wq = fake_quant(w, _f32(w_scale, dev).reshape(1, 1, cout))
    if w_offset_scale is None:
        woq = fake_quant_absmax(w_offset, axis=-1)
    else:
        woq = fake_quant(w_offset,
                         _f32(w_offset_scale, dev).reshape(1, 1, 2 * k2))
    offsets = conv2d(xq, woq.reshape(k, k, cin, 2 * k2), stride=stride,
                     dilation=dilation, padding=dilation * (k // 2))
    offsets = offsets + _f32(b_offset, dev)
    patches = deform_sample_ref(
        xq, offsets, kernel_size=k, stride=stride, dilation=dilation,
        offset_bound=offset_bound)
    patches_q = fake_quant(patches, sx)
    y = _contract(patches_q, wq)
    if b_deform is not None:
        y = y + _f32(b_deform, dev)
    if y_scale is not None:
        y = fake_quant(y, _f32(y_scale, dev))
    return y.to(x.dtype), offsets


def fake_quant_dcl_reference(x: Tensor, offsets: Tensor, w: Tensor, *,
                             kernel_size: int = 3, stride: int = 1,
                             dilation: int = 1,
                             offset_bound: float | None = None,
                             x_scale=None, w_scale=None) -> Tensor:
    """Fake-quant oracle of the int8 kernel: quantize x per-tensor and w
    per-channel, sample the integer plane with fp32 coefficients, re-round
    the patches, contract exactly and rescale by ``s_x * s_w[m]``."""
    from repro_torch.kernels.ref import deform_sample_ref

    dev = x.device
    sx = compute_scale(x) if x_scale is None else _f32(x_scale, dev)
    sw = compute_scale(w, axis=-1) if w_scale is None \
        else _f32(w_scale, dev).reshape(1, 1, -1)
    xq = torch.clamp(torch.round(x.float() / sx), -QMAX, QMAX)
    wq = torch.clamp(torch.round(w.float() / sw), -QMAX, QMAX)
    patches = deform_sample_ref(
        xq, offsets, kernel_size=kernel_size, stride=stride,
        dilation=dilation, offset_bound=offset_bound)
    y = _contract(torch.round(patches), wq)
    return (y * sx * sw.reshape(1, 1, 1, -1)).to(x.dtype)
