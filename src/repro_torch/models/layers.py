"""Parameter declarations and the DCL layer (counterpart of the conv-side
of ``repro.models.layers``: ``dcl_apply`` with its fp32, ``qat``,
``int8`` and ``int8_chain`` datapaths, and the int8 -> int8 chain
helpers).

Params are nested dicts of tensors, declared once as a ``ParamDef`` tree
and materialised by ``init_tree`` from an explicit ``torch.Generator``.
Leaves are drawn in sorted-key order (the order JAX flattens dicts in);
the numbers differ from ``jax.random``, so parity tests convert JAX
params with ``repro_torch.convert.params_from_jax`` instead.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Sequence

import torch

from repro_torch.core.deform_conv import (DCLConfig, conv2d, dcl_forward,
                                          offset_abs_max)
from repro_torch.kernels import ops
from repro_torch.kernels.ref import deform_conv_fused_ref
from repro_torch.quant.qat import (fake_quant_dcl_chain_reference,
                                   fake_quant_dcl_reference,
                                   qat_quantize_inputs)
from repro_torch.quant.qtypes import QTensor

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


QUANT_MODES = ("none", "qat", "int8", "int8_chain")


def dcl_apply(params: Mapping[str, Tensor], x, *,
              kernel_size: int = 3, stride: int = 1, dilation: int = 1,
              offset_bound: float | None = None, use_kernel: bool = False,
              dataflow: str = "zero_copy", quant: str = "none",
              quant_scales: Mapping[str, Any] | None = None,
              device: str | torch.device | None = None):
    """One DCL forward pass -> (y, o_max).

    ``use_kernel=True`` with a trained ``offset_bound`` runs the offset
    conv, then the fused kernel (``ops.deform_conv``) under ``dataflow``
    (``"zero_copy"`` or the legacy ``"banded"``); otherwise the plain
    reference ``dcl_forward``.  ``o_max`` (Eq. 3) is taken from the raw
    offsets either way.

    ``quant`` selects the quantized datapaths:

    * ``"qat"`` — training: fake-quantize the deform-conv operands
      (activation per tensor, weights per output channel, STE backward)
      and run the fp32 machinery on the quantized grid (the kernel path
      through ``ops.deform_conv`` and its backward kernel, else the plain
      ``deform_conv_fused_ref``); the offset conv and every gradient stay
      fp32.  Scales are absmax unless ``quant_scales`` pins them.
    * ``"int8"`` — the offset conv stays fp32 (the address path is never
      quantized); the kernel path runs ``ops.deform_conv(precision=
      "int8")``, the plain path the fake-quant reference.  Scales come
      from ``quant_scales`` (``{"x_scale", "w_scale"}``, a calibration
      table entry), else absmax.
    * ``"int8_chain"`` — the offset conv is fused into the kernel and the
      output is emitted int8 (a ``QTensor`` on the table's ``y_scale``)
      when the table has a ``y_scale``; see ``_dcl_chain_layer``.
    """
    if quant not in QUANT_MODES:
        raise ValueError(f"unknown quant mode {quant!r}; expected one of "
                         f"{QUANT_MODES}")
    if quant == "int8_chain":
        if dataflow != "zero_copy":
            raise ValueError(
                f"quant='int8_chain' supports only the zero-copy "
                f"dataflow (got {dataflow!r}); the fused offset stage "
                f"and int8 emission are band-pipeline plans")
        return _dcl_chain_layer(params, x, kernel_size=kernel_size,
                                stride=stride, dilation=dilation,
                                offset_bound=offset_bound,
                                use_kernel=use_kernel,
                                quant_scales=quant_scales, device=device)
    cin = x.shape[-1]
    cout = params["w_deform"].shape[-1]
    cfg = DCLConfig(in_channels=cin, out_channels=cout,
                    kernel_size=kernel_size, stride=stride,
                    dilation=dilation, offset_bound=offset_bound,
                    dtype=x.dtype)
    k = kernel_size
    kernel_ok = use_kernel and offset_bound is not None
    if quant in ("int8", "qat") or kernel_ok:
        offsets = conv2d(x, params["w_offset"].to(x.dtype), stride=stride,
                         dilation=dilation, padding=cfg.pad)
        offsets = offsets + params["b_offset"].to(x.dtype)
        o_max = offset_abs_max(offsets)
        w = params["w_deform"].to(x.dtype).reshape(k * k, cin, cout)
        scales = quant_scales or {}
        if quant == "qat":
            xq, wq = qat_quantize_inputs(x, w, x_scale=scales.get("x_scale"),
                                         w_scale=scales.get("w_scale"))
            if kernel_ok:
                y = ops.deform_conv(xq, offsets, wq, kernel_size=k,
                                    stride=stride, dilation=dilation,
                                    offset_bound=offset_bound,
                                    dataflow=dataflow, device=device)
            else:
                y = deform_conv_fused_ref(xq, offsets, wq, kernel_size=k,
                                          stride=stride, dilation=dilation,
                                          offset_bound=offset_bound)
        elif quant == "int8" and kernel_ok:
            # The dataflow passes through, so a banded config raises in
            # ops instead of running zero-copy.
            y = ops.deform_conv(x, offsets, w, kernel_size=k, stride=stride,
                                dilation=dilation, offset_bound=offset_bound,
                                dataflow=dataflow, precision="int8",
                                x_scale=scales.get("x_scale"),
                                w_scale=scales.get("w_scale"), device=device)
        elif quant == "int8":
            y = fake_quant_dcl_reference(
                x, offsets, w, kernel_size=k, stride=stride,
                dilation=dilation, offset_bound=offset_bound,
                x_scale=scales.get("x_scale"), w_scale=scales.get("w_scale"))
        else:
            y = ops.deform_conv(x, offsets, w, kernel_size=k, stride=stride,
                                dilation=dilation, offset_bound=offset_bound,
                                dataflow=dataflow, device=device)
        return y + params["b_deform"].to(x.dtype), o_max
    y, stats = dcl_forward(params, x, cfg)
    return y, stats["o_max"]


def _dcl_chain_layer(params: Mapping[str, Tensor], x, *, kernel_size: int,
                     stride: int, dilation: int, offset_bound: float | None,
                     use_kernel: bool,
                     quant_scales: Mapping[str, Any] | None, device):
    """``quant="int8_chain"`` body of ``dcl_apply`` — one chained DCL.

    x is a fp32 tensor (the chain head, quantized onto the table's
    ``x_scale``) or a ``QTensor`` handed over by the previous chained
    layer, taken verbatim after checking that it was emitted on this
    layer's ``x_scale``.  Returns ``(y, o_max)``: y is a ``QTensor`` on the
    ``y_scale`` grid (kernel path with a calibrated ``y_scale``) or fp32
    (the chain tail, or the reference path); ``o_max`` is None on the
    kernel path, whose offsets never leave the kernel.
    """
    if offset_bound is None:
        raise ValueError(
            "quant='int8_chain' requires a trained offset_bound — the "
            "fused offset-conv stage exists because Eq. 6 bounds the "
            "band (train with the Eq. 5 regularizer first)")
    scales = quant_scales or {}
    x_scale = scales.get("x_scale")
    if x_scale is None:
        raise ValueError(
            "quant='int8_chain' requires calibrated quant_scales with at "
            "least x_scale (repro_torch.quant.calibrate_resnet_dcn records "
            "x/w/w_offset/y scales per DCL block): chained layers "
            "exchange int8 values on a pinned activation grid")
    w_scale = scales.get("w_scale")
    wo_scale = scales.get("w_offset_scale")
    y_scale = scales.get("y_scale")
    cin = x.shape[-1]
    cout = params["w_deform"].shape[-1]
    k = kernel_size
    w = params["w_deform"].float().reshape(k * k, cin, cout)
    w_off = params["w_offset"].float().reshape(k * k, cin, 2 * k * k)

    if use_kernel:
        if isinstance(x, QTensor):
            carried = float(x.scale)
            if not math.isclose(carried, float(x_scale), rel_tol=1e-6):
                raise ValueError(
                    f"int8 input was emitted on scale {carried} but the "
                    f"layer's calibration table decodes x_scale="
                    f"{float(x_scale)} — the consumer's x_scale must BE "
                    f"the producer's y_scale (recalibrate the pair "
                    f"together)")
        xin = x.values if isinstance(x, QTensor) else x.float()
        emit = "int8" if y_scale is not None else "fp32"
        y = ops.deform_conv_chain(
            xin, w, w_off, params["b_offset"], params["b_deform"],
            kernel_size=k, stride=stride, dilation=dilation,
            offset_bound=offset_bound, x_scale=x_scale, w_scale=w_scale,
            w_offset_scale=wo_scale, y_scale=y_scale, emit=emit,
            device=device)
        if emit == "int8":
            y = QTensor(values=y, scale=torch.as_tensor(
                y_scale, dtype=torch.float32, device=y.device))
        return y, None

    xin = x.dequantize() if isinstance(x, QTensor) else x.float()
    y, offsets = fake_quant_dcl_chain_reference(
        xin, w, w_off, params["b_offset"], params["b_deform"],
        kernel_size=k, stride=stride, dilation=dilation,
        offset_bound=offset_bound, x_scale=x_scale, w_scale=w_scale,
        w_offset_scale=wo_scale, y_scale=y_scale)
    return y, offset_abs_max(offsets)


def check_chain_compat(scales_seq: Sequence[Mapping[str, Any]],
                       couts: Sequence[int] | None = None,
                       cins: Sequence[int] | None = None) -> None:
    """Raise unless adjacent chained layers can hand each other int8
    tensors: producer ``i`` emits on its ``y_scale``, consumer ``i+1``
    decodes on its ``x_scale`` (the same number), and, where channel
    extents are given, producer C_out equals consumer C_in."""
    for i in range(len(scales_seq) - 1):
        ys = scales_seq[i].get("y_scale")
        xs = scales_seq[i + 1].get("x_scale")
        if ys is None:
            raise ValueError(
                f"chained layer {i} has no y_scale: the int8 emission "
                f"grid must be calibrated (calibrate_resnet_dcn records "
                f"it from the DCL output observer) before layer {i + 1} "
                f"can consume the tensor")
        if xs is None or not math.isclose(float(ys), float(xs),
                                          rel_tol=1e-6):
            raise ValueError(
                f"adjacent chained layers disagree on the exchange "
                f"grid: layer {i} emits on y_scale={ys} but layer "
                f"{i + 1} decodes on x_scale={xs} — recalibrate the "
                f"pair together (the consumer's x_scale IS the "
                f"producer's y_scale)")
        if couts is not None and cins is not None \
                and couts[i] != cins[i + 1]:
            raise ValueError(
                f"chained layer {i} emits C_out={couts[i]} channels but "
                f"layer {i + 1} expects C_in={cins[i + 1]} — int8 "
                f"chaining hands the tensor over verbatim, so the "
                f"channel extents must match")


def dcl_chain_apply(params_seq: Sequence[Mapping[str, Tensor]], x, *,
                    scales_seq: Sequence[Mapping[str, Any]],
                    kernel_size: int = 3, stride: int = 1,
                    dilation: int = 1, offset_bound: float | None = None,
                    use_kernel: bool = True,
                    device: str | torch.device | None = None):
    """Run back-to-back DCLs chained int8 -> int8: layer ``i`` emits a
    ``QTensor`` on its ``y_scale`` and layer ``i+1`` takes it verbatim.
    The chain head is quantized once and the tail (a table without
    ``y_scale``) emits fp32.  Returns ``(y, o_maxes)``; the o_maxes are
    None on the kernel path."""
    if len(params_seq) != len(scales_seq):
        raise ValueError(
            f"got {len(params_seq)} chained layers but "
            f"{len(scales_seq)} scale-table entries")
    check_chain_compat(
        scales_seq,
        couts=[p["w_deform"].shape[-1] for p in params_seq],
        cins=[p["w_deform"].shape[-2] for p in params_seq])
    o_maxes = []
    y = x
    for params, scales in zip(params_seq, scales_seq):
        y, o_max = dcl_apply(params, y, kernel_size=kernel_size,
                             stride=stride, dilation=dilation,
                             offset_bound=offset_bound,
                             use_kernel=use_kernel, quant="int8_chain",
                             quant_scales=scales, device=device)
        o_maxes.append(o_max)
    return y, o_maxes
