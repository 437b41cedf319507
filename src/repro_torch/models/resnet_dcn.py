"""ResNet-50 backbone with deformable convolutional layers + dense
detection head (counterpart of ``repro.models.resnet_dcn``).

The last ``num_dcn`` 3x3 convolutions of the bottlenecks are DCLs (12 by
default: c3's last 3, all 6 of c4, all 3 of c5); norms are GroupNorm(32);
layout NHWC; the dense head (``head_def``, ``dense_head``) is shared
with ``models.internimage``.  ``use_kernel=True`` routes every DCL
through the fused kernels (the fp32 forward and backward kernels when
training; the forward over ``dataflow``, ``"zero_copy"`` or the legacy
``"banded"``); the plain
path (``dcl_forward``, or the fake-quant references under ``quant``) is
the parity reference.  ``quant`` picks the DCL datapath: ``"none"``
(fp32), ``"qat"`` (fake-quant training over the fp32 kernels), ``"int8"``
or ``"int8_chain"``, whose DCL output is emitted int8 and dequantized by
the block before its GroupNorm.  ``forward(tap=)`` is the calibration
hook; ``detection_loss`` and ``train_loss`` are the training objective
(Eq. 5 over a dense detection loss).

Data parallelism (JAX's GSPMD propagation of a batch laid out on the
mesh's 'batch' axes, with every param replicated).  Under an active mesh
whose 'batch' axes divide the batch (``sharding.data_shards``), every
layer runs per data shard: each shard takes its rows to its device and
runs the whole network there under ``sharding.at_coords``, its params
fetched through ``sharding.gather`` (a copy of the one the port holds at
the first position, whose gradient comes back to it as an all-reduce,
which ``sharding.count_crossings`` counts).  The results meet in shard
order on the first shard's device.  ``train_loss`` is the global loss,
built there from the shards' sums, and each DCL's ``o_max`` is the max
of the shards' maxima.  ``shard_batch`` governs the split (None = auto,
True = require, False = never).  A forward with a ``tap`` and a DCL that
quantizes on absmax scales (``quant`` "qat" or "int8" without a scale
table: a max over the whole batch) keep the batch whole, as off a mesh;
their DCL kernel calls then split the batch themselves
(``kernels.ops.resolve_batch_shard``).  ``shard_spatial`` splits every
DCL call's height over the mesh's 'spatial' axis, inside a data shard at
its coordinates.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch import tree as T
from repro_torch.core.deform_conv import conv2d
from repro_torch.device import check_on, resolve_device
from repro_torch.distributed.sharding import (at_coords, batch_mesh_axes,
                                              data_shards, gather, is_placed)
from repro_torch.kernels import deform_conv_fused, deform_conv_q, plan
from repro_torch.kernels.ops import resolve_batch_shard
from repro_torch.models.layers import ParamDef, dcl_apply, dcl_def, init_tree
from repro_torch.quant.qtypes import QTensor

Tensor = torch.Tensor

GN_GROUPS = 32
HEAD_WIDTH = 256


@dataclasses.dataclass(frozen=True)
class ResNetDCNConfig:
    name: str = "resnet50_dcn"
    stage_sizes: tuple[int, ...] = (3, 4, 6, 3)
    widths: tuple[int, ...] = (256, 512, 1024, 2048)
    stem_width: int = 64
    num_dcn: int = 12              # last N 3x3 convs become DCLs
    offset_bound: float | None = None
    num_classes: int = 16
    img_size: int = 256
    dtype: Any = torch.float32
    use_kernel: bool = False       # route DCLs through the fused kernel
    dataflow: str = "zero_copy"    # kernel dataflow: zero_copy | banded
    quant: str = "none"            # none | qat | int8 | int8_chain
    # The kernel path over the active mesh (distributed.sharding): the
    # batch split over its 'batch' axes (None = auto, True = require,
    # False = never) and the height split over its 'spatial' axis with
    # the bounded halo exchange (None/False = off, True = require).
    shard_batch: bool | None = None
    shard_spatial: bool | None = None

    @property
    def total_blocks(self) -> int:
        return sum(self.stage_sizes)

    def is_dcn(self, block_index: int) -> bool:
        """block_index counts bottleneck blocks from 0 (first c2 block)."""
        return block_index >= self.total_blocks - self.num_dcn


def _conv_def(kh, kw, cin, cout):
    return ParamDef((kh, kw, cin, cout), (None, None, None, "conv_out"))


def _gn_def(c):
    return {"scale": ParamDef((c,), (None,), init="ones"),
            "bias": ParamDef((c,), (None,), init="zeros")}


def group_norm(x: Tensor, params, *, groups: int = GN_GROUPS,
               eps: float = 1e-5) -> Tensor:
    """GroupNorm over NHWC with population variance; the group count
    steps down from ``groups`` until it divides C."""
    n, h, w, c = x.shape
    g = min(groups, c)
    while c % g:
        g -= 1
    xf = x.float().reshape(n, h, w, g, c // g)
    mu = xf.mean(dim=(1, 2, 4), keepdim=True)
    var = xf.var(dim=(1, 2, 4), keepdim=True, correction=0)
    y = ((xf - mu) * torch.rsqrt(var + eps)).reshape(n, h, w, c)
    return (y * params["scale"] + params["bias"]).to(x.dtype)


def _block_def(cfg: ResNetDCNConfig, cin, width, block_index, *,
               downsample: bool):
    mid = width // 4
    d = {
        "conv1": _conv_def(1, 1, cin, mid), "gn1": _gn_def(mid),
        "gn2": _gn_def(mid),
        "conv3": _conv_def(1, 1, mid, width), "gn3": _gn_def(width),
    }
    if cfg.is_dcn(block_index):
        d["dcl"] = dcl_def(mid, mid)
    else:
        d["conv2"] = _conv_def(3, 3, mid, mid)
    if downsample or cin != width:
        d["proj"] = _conv_def(1, 1, cin, width)
        d["gn_proj"] = _gn_def(width)
    return d


def model_def(cfg: ResNetDCNConfig) -> dict:
    defs: dict[str, Any] = {
        "stem": {"conv": _conv_def(7, 7, 3, cfg.stem_width),
                 "gn": _gn_def(cfg.stem_width)},
    }
    cin = cfg.stem_width
    bi = 0
    for s, (n_blocks, width) in enumerate(zip(cfg.stage_sizes, cfg.widths)):
        for b in range(n_blocks):
            defs[f"s{s}b{b}"] = _block_def(cfg, cin, width, bi,
                                           downsample=(b == 0))
            cin = width
            bi += 1
    defs["head"] = head_def(cfg.widths[-1], cfg.num_classes)
    return defs


def head_def(cin: int, num_classes: int) -> dict:
    """The dense single-scale detection head on ``cin`` channels (both
    detector families serve it): conv 3x3 -> ``HEAD_WIDTH``, GroupNorm,
    ReLU, then 1x1 convs to ``num_classes + 1`` logits (the first is
    objectness) and 4 box values."""
    return {
        "conv": _conv_def(3, 3, cin, HEAD_WIDTH), "gn": _gn_def(HEAD_WIDTH),
        "cls": _conv_def(1, 1, HEAD_WIDTH, num_classes + 1),
        "box": _conv_def(1, 1, HEAD_WIDTH, 4),
    }


def dense_head(params, x: Tensor) -> tuple[Tensor, Tensor]:
    """``(cls, box)`` of the head of ``head_def`` on features x (NHWC)."""
    h = conv2d(x, params["conv"].to(x.dtype))
    h = F.relu(group_norm(h, params["gn"]))
    cls = conv2d(h, params["cls"].to(x.dtype))
    box = conv2d(h, params["box"].to(x.dtype))
    return cls, box


def bucket_layer_dims(cfg: ResNetDCNConfig, res: int) -> dict[str, dict]:
    """Dims of every DCL invocation at input resolution ``res``."""
    dims: dict[str, dict] = {}
    e = res // 4                       # stride-2 stem + stride-2 maxpool
    bi = 0
    for s, (n_blocks, width) in enumerate(zip(cfg.stage_sizes, cfg.widths)):
        for b in range(n_blocks):
            stride = 2 if (b == 0 and s > 0) else 1
            if cfg.is_dcn(bi):
                mid = width // 4
                dims[f"s{s}b{b}"] = dict(h=e, w=e, c=mid, m=mid,
                                         stride=stride)
            e //= stride
            bi += 1
    return dims


# The serving rungs of this family, top first (``serve.dcl_engine``'s
# ladder), and the tile chooser's datapath of each that runs a kernel.
RUNGS = ("int8_chain", "int8", "fp32_kernel", "fp32_ref")
RUNG_DTYPE = {"int8_chain": "int8_chain", "int8": "int8",
              "fp32_kernel": "fp32"}


def rung_configs(cfg: ResNetDCNConfig) -> dict[str, ResNetDCNConfig]:
    """The config each of ``RUNGS`` serves."""
    return {
        "int8_chain": dataclasses.replace(cfg, quant="int8_chain",
                                          use_kernel=True),
        "int8": dataclasses.replace(cfg, quant="int8", use_kernel=True),
        "fp32_kernel": dataclasses.replace(cfg, quant="none",
                                           use_kernel=True),
        "fp32_ref": dataclasses.replace(cfg, quant="none",
                                        use_kernel=False),
    }


def warm_plans(cfg: ResNetDCNConfig, bucket: int, *, rung: str, slots: int,
               device, spatial_shards: int = 1):
    """The tile plans of ``rung``'s kernel for every DCL at ``bucket`` and
    batch ``slots``, its library built on CUDA: ``(tiles, sources)`` of
    ``plan.warm_tile_cache``, a spatial bucket's at the shard-local height
    (sources ``"...@Nshard"``); ``None`` for a rung without a kernel or an
    unbounded config.  The fp32 rung of a banded config plans for the
    banded forward (kernel 4, in the library of kernel 1a)."""
    dtype = RUNG_DTYPE.get(rung)
    if cfg.offset_bound is None or dtype is None:
        return None
    if dtype == "fp32" and cfg.dataflow == "banded":
        dtype = "banded"
    if torch.device(device).type == "cuda":
        (deform_conv_fused if dtype in ("fp32", "banded")
         else deform_conv_q).load_kernel()
    tiles, sources = plan.warm_tile_cache(
        bucket_layer_dims(cfg, bucket), batch=slots,
        offset_bound=cfg.offset_bound, dtype=dtype, device=device,
        spatial_shards=spatial_shards)
    suffix = f"@{spatial_shards}shard" if spatial_shards > 1 else ""
    return tiles, {k: v + suffix for k, v in sources.items()}


def init_params(cfg: ResNetDCNConfig, *, seed: int = 0,
                device: str | torch.device | None = None):
    """Seeded params on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    return init_tree(model_def(cfg), gen, dev)


def _apply_block(params, x: Tensor, cfg: ResNetDCNConfig, *, stride: int,
                 is_dcn: bool, device, name: str = "", tap=None,
                 quant_scales=None):
    h = conv2d(x, params["conv1"].to(x.dtype))
    h = F.relu(group_norm(h, params["gn1"]))
    o_max = None
    if is_dcn:
        if tap is not None:
            tap(name, h)
        h, o_max = dcl_apply(params["dcl"], h, stride=stride,
                             offset_bound=cfg.offset_bound,
                             use_kernel=cfg.use_kernel,
                             dataflow=cfg.dataflow, quant=cfg.quant,
                             quant_scales=quant_scales,
                             shard_batch=cfg.shard_batch,
                             shard_spatial=cfg.shard_spatial, device=device)
        if isinstance(h, QTensor):
            # int8_chain emission: the DCL output left the kernel as int8;
            # the GroupNorm consumer decodes it here.
            h = h.dequantize(cfg.dtype)
        if tap is not None:
            tap(f"{name}/out", h)
    else:
        h = conv2d(h, params["conv2"].to(x.dtype), stride=stride)
    h = F.relu(group_norm(h, params["gn2"]))
    h = conv2d(h, params["conv3"].to(x.dtype))
    h = group_norm(h, params["gn3"])
    if "proj" in params:
        x = conv2d(x, params["proj"].to(x.dtype), stride=stride)
        x = group_norm(x, params["gn_proj"])
    return F.relu(x + h), o_max


def _data_shards(cfg: ResNetDCNConfig, n: int, *, tap=None,
                 quant_scales=None) -> list[tuple[dict, int, int]] | None:
    """``(coords, lo, hi)`` of the data shards a batch of ``n`` rows runs
    in (``sharding.data_shards``), or None: the batch runs whole.  A
    ``tap`` and absmax scales keep it whole (module docstring);
    ``shard_batch=True`` with no split raises, naming the sizes."""
    absmax = cfg.quant in ("qat", "int8") and not quant_scales
    if cfg.shard_batch is False or tap is not None or absmax:
        return None
    shards = data_shards(n)
    if shards is None and cfg.shard_batch:
        resolve_batch_shard(n, shard_batch=True)
    return shards


def _pieces(shards, batch: dict) -> list[tuple[Any, dict]]:
    """``(scope, rows)`` of each data shard: ``at_coords`` of its place
    and each leaf's rows on its device; one unscoped piece for a whole
    batch."""
    if shards is None:
        return [(contextlib.nullcontext(), batch)]
    mesh = batch_mesh_axes()[0]
    return [(at_coords(coords), {k: v[lo:hi].to(mesh.device_at(coords))
                                 for k, v in batch.items()})
            for coords, lo, hi in shards]


def _max_of(o_maxes: list[dict], home) -> dict[str, Tensor]:
    """Each DCL's ``o_max`` (Eq. 3, a max over the batch): the max of the
    shards' maxima, on ``home``."""
    if len(o_maxes) == 1:
        return o_maxes[0]
    return {k: torch.stack([o[k].to(home) for o in o_maxes]).amax()
            for k in o_maxes[0]}


def forward(params, cfg: ResNetDCNConfig, images: Tensor, *, tap=None,
            quant_scales=None, device: str | torch.device | None = None):
    """images: (N, H, W, 3) on ``device`` -> (outputs, o_max per DCL).

    ``tap(name, x)`` sees every DCL block's input and, as
    ``"<name>/out"``, its output (the calibration hook; the batch stays
    whole, so it sees the whole batch's activations, as JAX's eager tap
    does).  ``quant_scales`` is a calibration scale table
    ``{block_name: {...}}`` for the int8 datapaths; None means absmax
    scales (``int8`` only).  Under a data mesh each data shard runs the
    network on its rows (module docstring) and the outputs meet, in
    shard order, on the first shard's device.
    """
    dev = resolve_device(device)
    check_on(dev, images=images)
    shards = _data_shards(cfg, images.shape[0], tap=tap,
                          quant_scales=quant_scales)
    outs = []
    for scope, rows in _pieces(shards, {"images": images}):
        x = rows["images"]
        with scope:
            outs.append(_forward_shard(params, cfg, x, tap=tap,
                                       quant_scales=quant_scales,
                                       device=dev))
    if len(outs) == 1:
        return outs[0]
    home = outs[0][0]["cls"].device
    return ({k: torch.cat([o[0][k].to(home) for o in outs], 0)
             for k in outs[0][0]}, _max_of([o[1] for o in outs], home))


def _forward_shard(params, cfg: ResNetDCNConfig, images: Tensor, *, tap,
                   quant_scales, device):
    """``forward`` of one data shard (or of the whole batch) on
    ``images``' device, every param fetched there (``sharding.gather``)."""
    params = T.tree_map(lambda p: gather(p, device=images.device), params,
                        is_leaf=is_placed)
    x = images.to(cfg.dtype)
    x = conv2d(x, params["stem"]["conv"].to(x.dtype), stride=2, padding=3)
    x = F.relu(group_norm(x, params["stem"]["gn"]))
    x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, padding=1) \
        .permute(0, 2, 3, 1)

    o_maxes: dict[str, Tensor] = {}
    bi = 0
    for s, (n_blocks, _) in enumerate(zip(cfg.stage_sizes, cfg.widths)):
        for b in range(n_blocks):
            stride = 2 if (b == 0 and s > 0) else 1
            name = f"s{s}b{b}"
            scales = quant_scales.get(name) if quant_scales else None
            x, o_max = _apply_block(params[name], x, cfg, stride=stride,
                                    is_dcn=cfg.is_dcn(bi), device=device,
                                    name=name, tap=tap,
                                    quant_scales=scales)
            if o_max is not None:
                o_maxes[name] = o_max
            bi += 1

    cls, box = dense_head(params["head"], x)
    return {"cls": cls, "box": box, "features": x}, o_maxes


def _loss_sums(outputs: dict, targets: dict) -> dict:
    """One shard's terms of ``detection_loss`` as sums: the objectness
    BCE over its cells and the cell count, the positive cells, the class
    CE and the box L1 over them."""
    cls_logits = outputs["cls"].float()
    box_pred = outputs["box"].float()
    obj_logit = cls_logits[..., 0]
    cls_logit = cls_logits[..., 1:]
    obj = targets["obj"].float()
    bce = (obj_logit.clamp_min(0) - obj_logit * obj
           + torch.log1p(torch.exp(-obj_logit.abs()))).sum()
    logp = F.log_softmax(cls_logit, dim=-1)
    gold = torch.gather(logp, -1, targets["cls"].long()[..., None])[..., 0]
    l1 = ((box_pred - targets["box"].float()).abs() * obj[..., None]).sum()
    return {"bce": bce, "cells": obj_logit.numel(), "pos": obj.sum(),
            "ce": -(gold * obj).sum(), "l1": l1}


def _loss_from_sums(sums: dict) -> tuple[Tensor, dict]:
    """``detection_loss`` from the batch's sums: the BCE mean over every
    cell, the CE and L1 over every positive cell (at least one)."""
    bce = sums["bce"] / sums["cells"]
    n_pos = torch.clamp_min(sums["pos"], 1.0)
    ce = sums["ce"] / n_pos
    l1 = sums["l1"] / n_pos
    return bce + ce + 0.5 * l1, {"bce": bce, "ce": ce, "l1": l1}


def detection_loss(outputs: dict, targets: dict) -> tuple[Tensor, dict]:
    """Dense single-scale detection loss.

    targets: obj (N, Hc, Wc) {0, 1}, cls (N, Hc, Wc) int64, box
    (N, Hc, Wc, 4).  Sigmoid BCE on objectness, cross-entropy on the class
    of positive cells, L1 on their boxes: ``bce + ce + 0.5 * l1``.
    """
    return _loss_from_sums(_loss_sums(outputs, targets))


def train_loss(params, cfg: ResNetDCNConfig, batch: dict, *,
               lam: float = 0.0, smoothness: float = 0.0,
               quant_scales=None, device: str | torch.device | None = None):
    """The paper's objective: Eq. 5 over the detection loss.  With
    ``cfg.quant="qat"`` it is the quantization-aware objective.  ``batch``
    holds tensors on ``device``: images (N, H, W, 3) and the targets of
    ``detection_loss``.  Returns ``(loss, metrics)``, all global values:
    under a data mesh each shard adds its ``detection_loss`` sums, which
    meet on the first shard's device before the one division (never a
    mean of the shards' losses), and Eq. 5 takes each DCL's ``o_max`` as
    the max of the shards' maxima."""
    from repro_torch.core.rf_regularizer import regularized_loss
    dev = resolve_device(device)
    check_on(dev, images=batch["images"])
    shards = _data_shards(cfg, batch["images"].shape[0],
                          quant_scales=quant_scales)
    sums, maxima = None, []
    for scope, rows in _pieces(shards, batch):
        x = rows["images"]
        with scope:
            outputs, o_maxes = _forward_shard(params, cfg, x, tap=None,
                                              quant_scales=quant_scales,
                                              device=dev)
            part = _loss_sums(outputs, rows)
        maxima.append(o_maxes)
        # The shards' sums meet on the first shard's device.
        sums = part if sums is None else {
            k: v + (part[k].to(v.device) if isinstance(v, Tensor)
                    else part[k]) for k, v in sums.items()}
    task, metrics = _loss_from_sums(sums)
    o_maxes = _max_of(maxima, task.device)
    if lam > 0.0 and o_maxes:
        loss = regularized_loss(task, list(o_maxes.values()), lam,
                                smoothness=smoothness)
    else:
        loss = task
    metrics = dict(metrics)
    if o_maxes:
        metrics["o_max"] = torch.stack(list(o_maxes.values())).amax()
    return loss, metrics
