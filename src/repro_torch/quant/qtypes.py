"""Symmetric int8 quantization primitives of the DCL datapath
(counterpart of ``repro.quant.qtypes``).

Conventions, shared by the int8 kernels, their plain versions and the
fake-quant references:

* symmetric, zero-point-free: ``q = round(clip(x / s, -127, 127))``,
  ``x ~= q * s``.  Zero maps to 0, so zero padding commutes with
  quantization;
* per-tensor scale for activations, per-output-channel scales for
  weights (``axis=-1``);
* rounding is ``torch.round``, which rounds ties to even like
  ``jnp.round`` (``floor(x + 0.5)`` would not).

``fake_quant`` carries the straight-through estimator of the JAX
package's custom VJP: identity inside the representable range, zero
outside, no gradient to the scale.
"""
from __future__ import annotations

import dataclasses

import torch

Tensor = torch.Tensor

QMAX = 127.0            # symmetric int8 range [-127, 127]
EPS = 1e-12


def _scale_shape(shape: tuple[int, ...], axis: int | None) -> tuple[int, ...]:
    if axis is None:
        return ()
    axis = axis % len(shape)
    return tuple(shape[i] if i == axis else 1 for i in range(len(shape)))


def compute_scale(x: Tensor, *, axis: int | None = None) -> Tensor:
    """Symmetric absmax scale: per-tensor (``axis=None``, a 0-d tensor) or
    per-channel (keepdims shape ``(1, ..., C, ..., 1)``), fp32."""
    xf = x.float().abs()
    if axis is None:
        amax = xf.amax()
    else:
        ax = axis % x.ndim
        red = tuple(i for i in range(x.ndim) if i != ax)
        amax = xf.amax(dim=red, keepdim=True) if red else xf
    return torch.clamp_min(amax, EPS) / QMAX


def quantize_values(x: Tensor, scale: Tensor) -> Tensor:
    """x -> int8 values on the symmetric grid (``scale`` broadcasts)."""
    q = torch.round(x.float() / scale)
    return torch.clamp(q, -QMAX, QMAX).to(torch.int8)


@dataclasses.dataclass(frozen=True)
class QTensor:
    """int8 ``values`` + fp32 ``scale``; ``axis`` is the per-channel axis
    (None = per-tensor)."""
    values: Tensor          # int8
    scale: Tensor           # fp32, 0-d or keepdims per-channel shape
    axis: int | None = None

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.values.shape)

    def dequantize(self, dtype: torch.dtype = torch.float32) -> Tensor:
        return (self.values.float() * self.scale).to(dtype)


def quantize(x: Tensor, *, axis: int | None = None,
             scale=None) -> QTensor:
    """Quantize to a symmetric int8 ``QTensor``; ``scale`` overrides the
    absmax observer (e.g. a calibrated table entry)."""
    if scale is None:
        s = compute_scale(x, axis=axis)
    else:
        s = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
    if axis is not None and s.ndim == 1:
        s = s.reshape(_scale_shape(tuple(x.shape), axis))
    return QTensor(values=quantize_values(x, s), scale=s, axis=axis)


class _FakeQuant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, s):
        q = torch.clamp(torch.round(x.float() / s), -QMAX, QMAX)
        ctx.save_for_backward(x.float().abs() <= s * QMAX)
        return (q * s).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        inside, = ctx.saved_tensors
        return g * inside.to(g.dtype), None


def fake_quant(x: Tensor, scale) -> Tensor:
    """Quantize-dequantize onto the int8 grid.  Backward: the STE —
    the cotangent passes where ``|x| <= scale * 127`` and is zero
    outside; ``scale`` gets none (scales are observed, not learned)."""
    s = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
    return _FakeQuant.apply(x, s.detach())


def fake_quant_absmax(x: Tensor, *, axis: int | None = None) -> Tensor:
    """Fake-quantize on the absmax scale observed from ``x`` itself
    (the observer is outside the gradient)."""
    return fake_quant(x, compute_scale(x.detach(), axis=axis))
