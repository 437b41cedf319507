"""Parameter declarations and the DCL layer (counterpart of the conv-side
of ``repro.models.layers``).

Params are nested dicts of tensors, declared once as a ``ParamDef`` tree
and materialised by ``init_tree`` from an explicit ``torch.Generator``.
Leaves are drawn in sorted-key order (the order JAX flattens dicts in);
the numbers differ from ``jax.random``, so parity tests convert JAX
params with ``repro_torch.convert.params_from_jax`` instead.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping

import torch

from repro_torch.core.deform_conv import (DCLConfig, conv2d, dcl_forward,
                                          offset_abs_max)
from repro_torch.kernels import ops

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class ParamDef:
    """Declarative parameter: shape and init scheme."""
    shape: tuple[int, ...]
    init: str = "normal"          # normal | zeros | ones
    scale: float | None = None    # stddev override (default: 1/sqrt(fan-in))


def _fan_in(shape: tuple[int, ...]) -> int:
    return int(shape[0]) if len(shape) <= 1 else int(math.prod(shape[:-1]))


def init_param(gen: torch.Generator, d: ParamDef) -> Tensor:
    if d.init == "zeros":
        return torch.zeros(d.shape)
    if d.init == "ones":
        return torch.ones(d.shape)
    if d.init != "normal":
        raise ValueError(f"unknown init {d.init!r}")
    scale = d.scale if d.scale is not None else 1.0 / math.sqrt(
        _fan_in(d.shape))
    return torch.randn(d.shape, generator=gen) * scale


def init_tree(defs, gen: torch.Generator, device: torch.device) -> Any:
    """Materialise a ParamDef tree on ``device`` (drawn on the CPU, so a
    seed gives the same params on every device)."""
    if isinstance(defs, ParamDef):
        return init_param(gen, defs).to(device)
    return {k: init_tree(defs[k], gen, device) for k in sorted(defs)}


def dcl_def(cin: int, cout: int, k: int = 3) -> dict[str, ParamDef]:
    """One DCL: offset conv (zero-init — offsets start on the regular
    grid) and the deform conv weights."""
    return {
        "w_offset": ParamDef((k, k, cin, 2 * k * k), init="zeros"),
        "b_offset": ParamDef((2 * k * k,), init="zeros"),
        "w_deform": ParamDef((k, k, cin, cout)),
        "b_deform": ParamDef((cout,), init="zeros"),
    }


def dcl_apply(params: Mapping[str, Tensor], x: Tensor, *,
              kernel_size: int = 3, stride: int = 1, dilation: int = 1,
              offset_bound: float | None = None, use_kernel: bool = False,
              device: str | torch.device | None = None
              ) -> tuple[Tensor, Tensor]:
    """One DCL forward pass -> (y, o_max).

    ``use_kernel=True`` with a trained ``offset_bound`` runs the offset
    conv, then the fused kernel (``ops.deform_conv``); otherwise the
    plain reference ``dcl_forward``.  ``o_max`` (Eq. 3) is taken from the
    raw offsets either way.
    """
    cin = x.shape[-1]
    cout = params["w_deform"].shape[-1]
    cfg = DCLConfig(in_channels=cin, out_channels=cout,
                    kernel_size=kernel_size, stride=stride,
                    dilation=dilation, offset_bound=offset_bound,
                    dtype=x.dtype)
    k = kernel_size
    if use_kernel and offset_bound is not None:
        offsets = conv2d(x, params["w_offset"].to(x.dtype), stride=stride,
                         dilation=dilation, padding=cfg.pad)
        offsets = offsets + params["b_offset"].to(x.dtype)
        o_max = offset_abs_max(offsets)
        w = params["w_deform"].to(x.dtype).reshape(k * k, cin, cout)
        y = ops.deform_conv(x, offsets, w, kernel_size=k, stride=stride,
                            dilation=dilation, offset_bound=offset_bound,
                            device=device)
        return y + params["b_deform"].to(x.dtype), o_max
    y, stats = dcl_forward(params, x, cfg)
    return y, stats["o_max"]
