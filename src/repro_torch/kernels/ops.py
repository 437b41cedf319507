"""Public entry points of the kernels (counterpart of
``repro.kernels.ops``).

* ``deform_conv`` with ``offset_bound`` given (the Eq. 5-trained model):
  the fused kernel (``precision="fp32"``, ``plan.bounded_forward``) in
  the inputs' dtype, fp32 or bf16 (x and w in bf16, offsets in either;
  the patches rounded to bf16, fp32 sums, the output in bf16), over
  either dataflow (``dataflow="zero_copy"``, kernel 1a, or ``"banded"``,
  kernel 4 over the bands of ``plan.pad_and_band``), or the int8 kernel
  with its dequant epilogue (``precision="int8"``, ``plan.int8_forward``,
  zero-copy only);
* ``deform_sample``: stage 1 alone, the patches (kernel 1b zero-copy,
  kernel 3 banded; the plain gather when unbounded);
* ``deform_conv`` with ``offset_bound`` None (the lambda=0 baseline): the
  plain gather of ``core.deform_conv`` — there is no kernel for unbounded
  offsets;
* ``deform_conv_chain``: one chained int8 layer, offset conv fused into
  the kernel, int8 or fp32 emission (``plan.chain_forward``);
* ``matmul``: the tiled fp32-accumulating product (kernel 5);
* ``dcnv3``: the DCNv3 core of InternImage with bounded offsets
  (``kernels.dcnv3``: the ``dv3_`` kernel on CUDA, its plain version on
  the CPU), inference only.

The device of the call is explicit (``device=None`` means ``cuda``) and
the tensors must lie on it; the tensors' device then picks the kernel
(CUDA) or its plain version (CPU).  A kernel failure raises: unlike the
JAX package there is no fallback to a reference path.

The bounded path (fp32 and bf16) is differentiable through
``BoundedDeformConv`` (the counterpart of the JAX custom VJP): its forward
is ``plan.bounded_forward`` and its backward the fused backward kernel
(``plan.bounded_backward``; in bf16 its math in fp32, each gradient
rounded once to its input's dtype), on both devices and for both
dataflows, as in JAX: the gradient is a property of the function, not of
the dataflow.
The int8, chain and DCNv3 paths are inference only: on CUDA an input that
needs a gradient raises there (quantized models train with ``quant="qat"``).

On a device mesh (``distributed.sharding.use_rules(mesh=...)``) the
bounded call shards: ``shard_batch`` splits the batch over the mesh's
'batch' axes (``resolve_batch_shard``; ``BatchShardedDeformConv`` sums
d_weights over the shards), ``shard_spatial=True`` splits the height over
the 'spatial' axis with the bounded halo exchange
(``distributed.spatial``).  Each shard runs the kernels of the unsharded
call on its block, on its device.  A call made inside a model's data
shard (``sharding.data_shard``: ``models.resnet_dcn`` runs every layer of
a data-parallel detector per shard, as JAX's GSPMD does) is given the
shard's rows and splits them no further: its batch shard is off
(``shard_batch=True`` is met by the model's split and does not raise),
and a height split runs at the data shard's coordinates.

The dispatch context's ``shape`` is the call's own input; its ``shards``
entry is ``(batch blocks, height shards)`` of the call's own split, and a
call inside a data shard appends a third entry, the number of data
shards the model split the batch into: ``(1, 1, 2)`` is one DCL call of
the rows of one of 2 data shards, ``(2, 1)`` a call that split a whole
batch into 2 blocks itself.

``dispatch_hook_scope`` installs a callable that sees a context dict
before each bounded dispatch of either op; raising from it aborts the
call.  It is the fault-injection seam the serving engine's ladder is
tested through, and the timing seam of ``obs.DispatchRecorder``: a hook
may return ``finish(out=None, error=None)``, which is called after the
call, on success or failure; a ``finish`` that raises is logged and
ignored.

``meta`` tensors (the dry run of ``launch.dryrun``) take a shape-only path
in ``deform_conv`` and ``deform_conv_chain``: the output (and, through
autograd, each input's gradient) is an empty ``meta`` tensor of the
kernel's shape and dtype; no kernel, plan or shard runs.  The path is
chosen by the tensors' device alone, so CPU and CUDA calls never take it.
``work_scope`` installs a sink whose ``begin(phase, context)`` and
``end(phase, context)`` bracket each bounded call of either op —
``"forward"`` around the call, ``"backward"`` around its backward node
when its gradient is taken — on every device, so a dry run and a real
run price the same calls and can leave out what runs inside them
(``launch.dryrun`` prices each call with ``core.h100``'s works).
"""
from __future__ import annotations

import contextlib
import dataclasses
import logging

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from repro_torch.core.deform_conv import DCLConfig, sample_patches
from repro_torch.core.tiling import out_hw
from repro_torch.device import check_on, resolve_device
from repro_torch.distributed import spatial as _spatial
from repro_torch.distributed.sharding import (Mesh, batch_mesh_axes,
                                              data_shard, move)
from repro_torch.kernels import dcnv3 as _dcnv3
from repro_torch.kernels import plan as _plan
from repro_torch.kernels.deform_sample import (deform_sample_banded,
                                               deform_sample_zerocopy)
from repro_torch.kernels.matmul import matmul  # noqa: F401  (re-export)

Tensor = torch.Tensor

_log = logging.getLogger("repro_torch.kernels")

_dispatch_hook = None
_work_sink = None


def get_dispatch_hook():
    """The installed dispatch hook (None when there is none)."""
    return _dispatch_hook


@contextlib.contextmanager
def dispatch_hook_scope(hook):
    """Install ``hook(context)`` around a block, restoring the previous
    hook afterwards."""
    global _dispatch_hook
    prev, _dispatch_hook = _dispatch_hook, hook
    try:
        yield
    finally:
        _dispatch_hook = prev


@contextlib.contextmanager
def work_scope(sink):
    """Install a work sink (see the module docstring) around a block,
    restoring the previous one afterwards."""
    global _work_sink
    prev, _work_sink = _work_sink, sink
    try:
        yield
    finally:
        _work_sink = prev


def _priced(context: dict, run):
    """``run()`` between the installed sink's ``begin("forward",
    context)`` and ``end``; when the result's gradient is taken, its
    backward node runs between ``begin("backward", context)`` and
    ``end``."""
    sink = _work_sink
    if sink is None:
        return run()
    sink.begin("forward", context)
    try:
        y = run()
    finally:
        sink.end("forward", context)
    node = getattr(y, "grad_fn", None)
    if node is not None:
        node.register_prehook(lambda g: sink.begin("backward", context))
        node.register_hook(lambda gi, go: sink.end("backward", context))
    return y


class _MetaDeformConv(torch.autograd.Function):
    """The shape-only deform conv of ``meta`` tensors: it keeps what the
    kernel path keeps for its backward (x, offsets, w) and returns empty
    tensors of the output's and the gradients' shapes."""

    @staticmethod
    def forward(ctx, x, offsets, w, shape, dtype):
        ctx.save_for_backward(x, offsets, w)
        return x.new_empty(shape, dtype=dtype)

    @staticmethod
    @once_differentiable
    def backward(ctx, gy):
        x, offsets, w = ctx.saved_tensors
        need = ctx.needs_input_grad
        return (torch.empty_like(x) if need[0] else None,
                torch.empty_like(offsets) if need[1] else None,
                torch.empty_like(w) if need[2] else None, None, None)


def _finish(finish, **result) -> None:
    """Close a hook's measurement; observability never breaks the call."""
    if not callable(finish):
        return
    try:
        finish(**result)
    except Exception as e:  # noqa: BLE001 — logged, the call stands
        _log.warning("dispatch finish hook raised %s: %s",
                     type(e).__name__, e)


def _dispatch(context: dict, run):
    """``run()`` between the installed hook (whose raise aborts the call)
    and the ``finish`` it returned."""
    finish = _dispatch_hook(context) if _dispatch_hook is not None else None
    try:
        out = run()
    except Exception as e:
        _finish(finish, error=e)
        raise
    _finish(finish, out=out)
    return out


def check_channel_tiles(c: int, m: int, tile_c: int | None,
                        tile_m: int | None = None) -> None:
    """Reject channel tiles that do not divide the layer."""
    if tile_c is not None and c % tile_c != 0:
        raise ValueError(
            f"tile_c={tile_c} does not divide C={c}; the fused kernel steps "
            f"the channel axis in contiguous tile_c chunks — pass a divisor "
            f"of C (or tile_c=None for the chooser)")
    if tile_m is not None and m % tile_m != 0:
        raise ValueError(
            f"tile_m={tile_m} does not divide M={m}; pass a divisor of M "
            f"(or tile_m=None for the chooser)")


def _refuse_grad(dev: torch.device, op: str, *tensors: Tensor,
                 why: str | None = None) -> None:
    if dev.type == "cuda" and torch.is_grad_enabled() and any(
            t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{op} " + (why or "is the int8 inference datapath and has no "
                        "gradient: quantized models train with quant='qat' "
                        "(fake-quant over the fp32 kernels)")
            + "; run it under torch.no_grad()")


class BoundedDeformConv(torch.autograd.Function):
    """The bounded deform conv (fp32 or bf16) with the fused backward
    kernel.

    Saves only ``(x, offsets, w)``, as the JAX custom VJP does: the
    backward recomputes the patches from the Eq. 6 band."""

    @staticmethod
    def forward(ctx, spec, x, offsets, w):
        ctx.spec = spec
        ctx.save_for_backward(x, offsets, w)
        return _plan.bounded_forward(spec, x, offsets, w)

    @staticmethod
    @once_differentiable
    def backward(ctx, gy):
        x, offsets, w = ctx.saved_tensors
        dx, doff, dw = _plan.bounded_backward(ctx.spec, x, offsets, w,
                                              gy.contiguous())
        need = ctx.needs_input_grad
        return (None, dx if need[1] else None, doff if need[2] else None,
                dw if need[3] else None)


def check_batch_split(n: int, *, shards: int,
                      axes: tuple[str, ...] = ()) -> None:
    """Reject a batch that does not split into ``shards`` equal blocks,
    naming the sizes, instead of a shape error deep in a shard."""
    if n % shards != 0:
        raise ValueError(
            f"batch N={n} does not divide the mesh batch axes {axes} (total "
            f"size {shards}); the sharded kernel path needs equal "
            f"per-device shards — pad the batch to a multiple of {shards} "
            f"or pass shard_batch=False")


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """Mesh context of one batch-sharded deform_conv call."""
    mesh: Mesh
    axes: tuple[str, ...]

    def devices(self) -> list[torch.device]:
        """One device per batch block, the first axis major."""
        return self.mesh.shard_devices(self.axes)

    def positions(self) -> list[tuple[int, ...]]:
        """The mesh index of each batch block (``devices``' order)."""
        sizes = [self.mesh.shape[a] for a in self.axes]
        return [tuple(dict(zip(self.axes, idx)).get(a, 0)
                      for a in self.mesh.axis_names)
                for idx in np.ndindex(*sizes)]


def resolve_batch_shard(n: int, *,
                        shard_batch: bool | None = None) -> ShardSpec | None:
    """Whether (and how) to shard the batch axis over the active mesh.

    * ``None`` (auto): shard iff a mesh is active under
      ``distributed.sharding.use_rules`` and its batch-mapped axes (size
      > 1) divide ``n``; otherwise run unsharded;
    * ``True``: require it — no active mesh or a non-dividing batch
      raises a ``ValueError`` naming the sizes;
    * ``False``: never shard.

    Inside a data shard (``sharding.data_shard``) it is None whatever
    ``shard_batch`` says: the call's batch is already the shard's rows."""
    if shard_batch is False or data_shard() is not None:
        return None
    got = batch_mesh_axes()
    if got is None:
        if shard_batch:
            raise ValueError(
                "shard_batch=True but no mesh maps the 'batch' logical axis "
                "— activate one with distributed.sharding.use_rules("
                "mesh=...) (axes of size > 1 required)")
        return None
    mesh, axes, size = got
    if n % size != 0:
        if shard_batch:
            check_batch_split(n, shards=size, axes=axes)
        return None
    return ShardSpec(mesh=mesh, axes=axes)


class BatchShardedDeformConv(torch.autograd.Function):
    """The bounded deform conv over batch shards: each shard's forward and
    backward kernels on its block and device, d_input and d_offsets
    concatenated like their primals, d_weights (the weights are
    replicated) the sum of the shards' in shard order."""

    @staticmethod
    def forward(ctx, spec, shard, x, offsets, w):
        ctx.spec, ctx.shard = spec, shard
        ctx.save_for_backward(x, offsets, w)
        devs = shard.devices()
        return torch.cat([
            _plan.bounded_forward(spec, xb.to(d), ob.to(d), w.to(d))
            .to(x.device)
            for d, xb, ob in zip(devs, x.chunk(len(devs)),
                                 offsets.chunk(len(devs)))], 0)

    @staticmethod
    @once_differentiable
    def backward(ctx, gy):
        x, offsets, w = ctx.saved_tensors
        devs = ctx.shard.devices()
        pos = ctx.shard.positions()
        dxs, doffs, dw = [], [], None
        for d, at, xb, ob, gb in zip(devs, pos, x.chunk(len(devs)),
                                     offsets.chunk(len(devs)),
                                     gy.chunk(len(devs))):
            dx, doff, dwp = _plan.bounded_backward(
                ctx.spec, xb.to(d), ob.to(d), w.to(d), gb.to(d).contiguous())
            dxs.append(dx.to(x.device))
            doffs.append(doff.to(offsets.device))
            # The replicated weights' gradient summed over the batch
            # shards: an all-reduce (``sharding.count_crossings``).
            dwp = move(dwp, w.device, at, pos[0], "all-reduce")
            dw = dwp if dw is None else dw + dwp
        need = ctx.needs_input_grad
        return (None, None, torch.cat(dxs, 0) if need[2] else None,
                torch.cat(doffs, 0) if need[3] else None,
                dw if need[4] else None)


def deform_sample(x: Tensor, offsets: Tensor, *, kernel_size: int = 3,
                  stride: int = 1, dilation: int = 1,
                  offset_bound: float | None = None,
                  tile_h: int | None = 8, tile_w: int | None = None,
                  tile_c: int | None = None, dataflow: str = "zero_copy",
                  device: str | torch.device | None = None) -> Tensor:
    """Stage 1: bilinear patch sampling.

    x: (N, H, W, C); offsets: (N, Ho, Wo, 2*K*K) raw offset-conv output.
    Returns (N, Ho, Wo, K*K, C) in x's dtype (the kernels take fp32 and
    bf16 inputs, offsets in either).  Unbounded (``offset_bound`` None): the
    plain gather of ``core.deform_conv.sample_patches``, offsets as they
    are.  Bounded: the offsets are clamped to ±B and sampled by kernel 1b
    from the zero-padded input (``dataflow="zero_copy"``; unspecified
    tiles from the ``"sample"`` chooser) or by kernel 3 from the bands of
    ``plan.pad_and_band`` (``"banded"``; ``tile_h`` rows per band, default
    8).
    """
    dev = resolve_device(device)
    check_on(dev, x=x, offsets=offsets)
    n, h, w, c = x.shape
    ho, wo = offsets.shape[1], offsets.shape[2]
    k2 = kernel_size * kernel_size
    if offset_bound is None:
        cfg = DCLConfig(in_channels=c, out_channels=1,
                        kernel_size=kernel_size, stride=stride,
                        dilation=dilation)
        return sample_patches(x, offsets.reshape(n, ho, wo, k2, 2), cfg)
    check_channel_tiles(c, c, tile_c)
    _plan.check_dataflow(dataflow)
    geom = dict(kernel_size=kernel_size, stride=stride, dilation=dilation,
                offset_bound=offset_bound)
    if dataflow == "banded":
        spec = _plan.DCSpec(tile_h=tile_h, tile_w=tile_w, tile_c=tile_c,
                            dataflow=dataflow, **geom)
        th, tw, tc, _ = _plan.banded_tiles(spec, x, offsets, c,
                                           dtype="sample")
        bands, offsets_p = _plan.banded_inputs(spec, x, offsets, th)
        patches = deform_sample_banded(bands, offsets_p, tile_h=th,
                                       tile_w=tw, tile_c=tc, **geom)
        return patches[:, :ho]
    th, tw, tc, _ = _plan.resolve_tiles(
        n, h, w, c, c, tile_h=tile_h, tile_w=tile_w, tile_c=tile_c,
        dtype="sample", itemsize=x.element_size(), **geom)
    th, tw = min(th, ho), min(tw, wo)
    xp = _plan.pad_zerocopy(x, tile_h=th, tile_w=tw, ho=ho, wo=wo, **geom)
    return deform_sample_zerocopy(xp, offsets.contiguous(), tile_h=th,
                                  tile_w=tw, tile_c=tc, **geom)


def deform_conv(x: Tensor, offsets: Tensor, w: Tensor, *,
                kernel_size: int = 3, stride: int = 1, dilation: int = 1,
                offset_bound: float | None = None,
                tile_h: int | None = None, tile_w: int | None = None,
                tile_c: int | None = None, tile_m: int | None = None,
                dataflow: str = "zero_copy", precision: str = "fp32",
                shard_batch: bool | None = None,
                shard_spatial: bool | None = None,
                x_scale=None, w_scale=None,
                device: str | torch.device | None = None) -> Tensor:
    """Fused DCL stage 1+2: y = g(x, o) * w_deform (Eq. 2).

    x: (N, H, W, C); offsets: (N, Ho, Wo, 2*K*K); w: (K*K, C, M).
    Returns (N, Ho, Wo, M).  Unspecified tiles come from the Hopper
    chooser (``core.tiling.choose_kernel_tiles``) of the datapath.

    ``dataflow`` picks the bounded forward: ``"zero_copy"`` (kernel 1a
    stages each band from the padded input) or ``"banded"`` (the legacy
    dataflow: ``tile_h``-row bands, default 8, are materialised in device
    memory and kernel 4 reads them).  Both have kernel 2 as their
    backward.  Each runs in x's dtype: fp32, or bf16 (w is cast to it;
    the offsets stay fp32 or bf16); other dtypes raise on the card.

    ``precision="int8"`` (bounded only) runs the quantized inference
    datapath: int8 band, fp32 bilinear coefficients, patches rounded to
    int8, exact integer contraction, per-output-channel dequant.
    ``x_scale`` (per-tensor) and ``w_scale`` (per-output-channel, (M,))
    override the absmax scales with calibrated ones.

    ``shard_batch`` (bounded fp32/bf16 only; None = auto, True = require,
    False = never) splits the batch over the active mesh's 'batch' axes
    (``resolve_batch_shard``).  ``shard_spatial=True`` (bounded,
    zero-copy; fp32, bf16 or int8) splits the height over the 'spatial'
    axis with one halo exchange of ``B + ceil(K/2)`` rows
    (``distributed.spatial``); it needs an active mesh and ``H %
    (stride*shards) == 0``, and folds an active batch shard into the same
    call (a data x model mesh).
    """
    dev = resolve_device(device)
    check_on(dev, x=x, offsets=offsets, w=w)
    n, _, _, c = x.shape
    m = w.shape[-1]
    ho, wo = offsets.shape[1], offsets.shape[2]
    k2 = kernel_size * kernel_size
    if precision not in ("fp32", "int8"):
        raise ValueError(
            f"unknown precision {precision!r}; expected 'fp32' or 'int8'")
    _plan.check_dataflow(dataflow)
    check_channel_tiles(c, m, tile_c, tile_m)
    if precision == "int8" and offset_bound is None:
        raise ValueError(
            "precision='int8' requires a trained offset_bound — the "
            "quantized datapath exists because Eq. 6 bounds the band; "
            "the unbounded gather baseline has no int8 kernel")
    if precision == "int8" and dataflow != "zero_copy":
        raise ValueError(
            f"precision='int8' supports only the zero-copy dataflow "
            f"(got {dataflow!r})")

    shard = spatial = None
    if shard_spatial:
        if offset_bound is None:
            raise ValueError(
                "shard_spatial=True requires a trained offset_bound — the "
                "halo exchange is bounded by Eq. 5/6 (B + ceil(K/2) rows); "
                "the unbounded gather baseline has no bounded halo")
        if dataflow != "zero_copy":
            raise ValueError(
                f"shard_spatial=True supports only the zero-copy dataflow "
                f"(got {dataflow!r}); the banded path materialises "
                f"full-width bands and has no per-shard slab to run on")
    inner = data_shard() is not None
    if offset_bound is not None and precision == "fp32":
        shard = resolve_batch_shard(n, shard_batch=shard_batch)
    elif shard_batch and not inner:
        raise ValueError(
            "shard_batch=True requires the bounded fp32 kernel path "
            "(offset_bound set, precision='fp32'); the unbounded gather "
            "baseline and the int8 inference datapath have no batch shard")
    if shard_spatial:
        # After the batch shard, so a data x model mesh folds the batch
        # axes into the one spatial call.
        spatial = _spatial.resolve_spatial_shard(
            x.shape[1], shard_spatial=True, stride=stride,
            kernel_size=kernel_size, dilation=dilation,
            offset_bound=offset_bound,
            batch_axes=shard.axes if shard is not None else ())
        shard = None

    if offset_bound is None:
        cfg = DCLConfig(in_channels=c, out_channels=m,
                        kernel_size=kernel_size, stride=stride,
                        dilation=dilation)
        patches = sample_patches(x, offsets.reshape(n, ho, wo, k2, 2), cfg)
        return torch.einsum("nhwkc,kcm->nhwm", patches.float(),
                            w.float()).to(x.dtype)

    if precision == "int8":
        _refuse_grad(dev, "deform_conv(precision='int8')", x, offsets, w)
    if spatial is not None:
        shards = (len(spatial.devices()), spatial.shards)
    else:
        shards = (1 if shard is None else len(shard.devices()), 1)
    if inner:
        shards += (batch_mesh_axes()[2],)
    context = {"op": "deform_conv", "precision": precision,
               "dataflow": dataflow, "shape": tuple(x.shape), "m": m,
               "offset_bound": offset_bound, "kernel_size": kernel_size,
               "stride": stride, "dilation": dilation, "device": dev.type,
               "itemsize": x.element_size(),
               "offset_itemsize": offsets.element_size(),
               "tiles": (tile_h, tile_w, tile_c, tile_m),
               "shards": shards, "spatial_shards": shards[1]}
    if x.device.type == "meta":
        return _priced(context, lambda: _MetaDeformConv.apply(
            x, offsets, w, (n, ho, wo, m), x.dtype))
    geom = dict(kernel_size=kernel_size, stride=stride, dilation=dilation,
                offset_bound=offset_bound, tile_h=tile_h, tile_w=tile_w,
                tile_c=tile_c, tile_m=tile_m, x_scale=x_scale,
                w_scale=w_scale)
    if precision == "int8" and spatial is not None:
        return _priced(context, lambda: _dispatch(
            context, lambda: _spatial.spatial_int8_forward(
                x, offsets, w, sspec=spatial, **geom)))
    if precision == "int8":
        return _priced(context, lambda: _dispatch(
            context, lambda: _plan.int8_forward(x, offsets, w, **geom)))
    spec = _plan.DCSpec(kernel_size=kernel_size, stride=stride,
                        dilation=dilation, offset_bound=offset_bound,
                        tile_h=tile_h, tile_w=tile_w, tile_c=tile_c,
                        tile_m=tile_m, dataflow=dataflow)
    if spatial is not None:
        run = lambda: _spatial.deform_conv_spatial(  # noqa: E731
            spec, spatial, x, offsets, w)
    elif shard is not None:
        run = lambda: BatchShardedDeformConv.apply(  # noqa: E731
            spec, shard, x, offsets, w)
    else:
        run = lambda: BoundedDeformConv.apply(  # noqa: E731
            spec, x, offsets, w)
    return _priced(context, lambda: _dispatch(context, run))


def deform_conv_chain(x: Tensor, w: Tensor, w_offset: Tensor, b_offset,
                      b_deform=None, *, kernel_size: int = 3,
                      stride: int = 1, dilation: int = 1,
                      offset_bound: float | None, x_scale, w_scale=None,
                      w_offset_scale=None, y_scale=None,
                      tile_h: int | None = None, tile_w: int | None = None,
                      tile_c: int | None = None, tile_m: int | None = None,
                      emit: str = "int8",
                      device: str | torch.device | None = None) -> Tensor:
    """One chained int8 DCL layer: fused offset conv + int8 emission.

    x: (N, H, W, C) — int8 on the ``x_scale`` grid (the previous chained
    layer's emission) or fp32 (the chain head, quantized here).  w:
    (K*K, C, M) deform weights; w_offset: (K*K, C, 2*K*K) offset-conv
    weights; b_offset/b_deform the biases (the deform bias is folded into
    the requant: int8 emission quantizes ``y + b``).

    Returns (N, Ho, Wo, M) int8 on the ``y_scale`` grid (``emit="int8"``;
    ``y_scale`` is the NEXT layer's activation scale, required) or fp32
    (``emit="fp32"``, the chain tail).  The offsets never reach device
    memory.  The kernel streams C in ``tile_c`` chunks, so ``tile_c`` may
    be any multiple of 4 that divides C (the TPU plan required C).
    """
    if offset_bound is None:
        raise ValueError(
            "deform_conv_chain requires a trained offset_bound — the "
            "fused offset stage exists because Eq. 6 bounds the band")
    if x_scale is None:
        raise ValueError(
            "deform_conv_chain requires x_scale: chained layers exchange "
            "int8 values whose grid must be pinned by calibration "
            "(repro_torch.quant.calibrate — the table's per-layer x_scale)")
    if emit not in ("int8", "fp32"):
        raise ValueError(
            f"unknown emit {emit!r}; expected 'int8' (chained) or 'fp32' "
            f"(chain tail)")
    if emit == "int8" and y_scale is None:
        raise ValueError(
            "emit='int8' requires y_scale (the NEXT layer's activation "
            "scale — the per-channel requant target grid); pass "
            "emit='fp32' for the chain tail instead")
    dev = resolve_device(device)
    check_on(dev, x=x, w=w, w_offset=w_offset)
    check_channel_tiles(x.shape[-1], w.shape[-1], tile_c, tile_m)
    _refuse_grad(dev, "deform_conv_chain", x, w, w_offset)
    context = {"op": "deform_conv_chain", "emit": emit,
               "shape": tuple(x.shape), "m": w.shape[-1],
               "offset_bound": offset_bound, "kernel_size": kernel_size,
               "stride": stride, "dilation": dilation, "device": dev.type,
               "tiles": (tile_h, tile_w, tile_c, tile_m)}
    if x.device.type == "meta":
        n, h, w_in, _ = x.shape
        ho, wo = out_hw(h, w_in, kernel_size=kernel_size, stride=stride,
                        dilation=dilation)
        return _priced(context, lambda: x.new_empty(
            (n, ho, wo, w.shape[-1]),
            dtype=torch.int8 if emit == "int8" else torch.float32))
    return _priced(context, lambda: _dispatch(
        context, lambda: _plan.chain_forward(
            x, w, w_offset, b_offset, b_deform, kernel_size=kernel_size,
            stride=stride, dilation=dilation, offset_bound=offset_bound,
            x_scale=x_scale, w_scale=w_scale,
            w_offset_scale=w_offset_scale, y_scale=y_scale, tile_h=tile_h,
            tile_w=tile_w, tile_c=tile_c, tile_m=tile_m, emit=emit)))


def dcnv3(v: Tensor, offsets: Tensor, mask_logits: Tensor, *, groups: int,
          kernel_size: int = 3, offset_bound: float,
          device: str | torch.device | None = None) -> Tensor:
    """The DCNv3 core with offsets clamped to ±``offset_bound``
    (``kernels.dcnv3``): v (N, H, W, C) in ``groups`` groups, offsets (N,
    H, W, groups*K*K*2) with (dx, dy) a tap, the taps x outer and y inner,
    mask logits (N, H, W, groups*K*K) whose softmax over each group's K*K
    taps weights its samples; stride 1, zero outside the image.  Returns
    y (N, H, W, C).  A dispatch like the DCL ops' (context ``op``
    "dcnv3", priced by ``core.h100.dcnv3_work``); no gradient on CUDA."""
    dev = resolve_device(device)
    check_on(dev, v=v, offsets=offsets, mask_logits=mask_logits)
    _dcnv3.check_shapes(v, offsets, mask_logits, groups=groups,
                        kernel_size=kernel_size)
    _refuse_grad(dev, "dcnv3", v, offsets, mask_logits,
                 why="has no backward kernel (inference only)")
    context = {"op": "dcnv3", "shape": tuple(v.shape), "m": v.shape[-1],
               "groups": groups, "offset_bound": offset_bound,
               "kernel_size": kernel_size, "stride": 1, "dilation": 1,
               "device": dev.type, "itemsize": v.element_size()}
    return _priced(context, lambda: _dispatch(context, lambda: _dcnv3.dcnv3(
        v, offsets, mask_logits, groups=groups, kernel_size=kernel_size,
        offset_bound=offset_bound)))
