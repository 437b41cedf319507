"""Spatial (height) sharding of the bounded DCL kernels: the bounded halo
exchange over a mesh axis (counterpart of ``repro.distributed.spatial``).

Batch data-parallelism cannot cut the latency of one large image; this
module shards the height axis instead.  The paper's Eq. 5 bound, which
keeps every gather inside the Eq. 6 band, also bounds what a shard needs
from its neighbours to

    halo = dilation*(K//2) + ceil(B) + 1        (4 rows at B = 2, K = 3)

rows (``core.tiling.spatial_halo_rows``), so a layer needs one up/down
exchange of that many rows.

Geometry.  The unsharded zero-copy path pads the input top/left by ``p0 =
dilation*(K//2) + ceil(B)`` zero rows (``plan.pad_zerocopy``); output row
``t`` reads original rows ``[t*s - p0, t*s + p0 + 1]``.  With ``H %
(stride*shards) == 0`` shard ``i`` owns output rows ``[i*ho_loc,
(i+1)*ho_loc)`` and reads at most ``halo = p0 + 1`` rows beyond its
block on either side.  After the exchange the shard trims its
halo-extended block to the local analogue of the global padded input
(``_shard_slab``) and runs the unmodified zero-copy kernel on it (1a for
fp32 and bf16, 1c for int8, 2 for the backward), so a shard's rows equal
the unsharded call's bit for bit when both run the same tiles: the
kernels round each tile's samples in its band's frame, and 1a is given
the unsharded call's C groups (``c_groups``), so each pixel's chunks add
in the same order.  The edge shards receive zero rows, exactly the zero
padding of the unsharded path.

The mesh is single-controller (``distributed.sharding``): a shard's
block moves to its device with ``.to``, the exchange is a slice of the
neighbour's block moved the same way, and the results meet on the
input's device.  On a mesh that repeats a device, ``.to`` returns the
neighbour's tensor itself, so nothing here writes into a received
tensor: the exchange concatenates into new tensors and the backward adds
into its own copy.

Backward: kernel 2 gives ``d_input`` over the halo-extended slab; the
``p0`` rows above the block belong to the previous shard and the ``p0 +
1`` rows below to the next, and are added into theirs; ``d_weights`` is
summed over every shard (spatial and batch) in a fixed order;
``d_offsets`` stays local.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from repro_torch.core.tiling import fwd_c_groups, spatial_halo_rows
from repro_torch.kernels import plan as _plan
from repro_torch.kernels.band_pipeline import band_geometry
from repro_torch.kernels.deform_conv_bwd import deform_conv_bwd_zerocopy
from repro_torch.kernels.deform_conv_fused import deform_conv_fused_zerocopy
from repro_torch.kernels.deform_conv_q import deform_conv_fused_zerocopy_q

from .sharding import Mesh, _position, current_rules, data_shard, move

Tensor = torch.Tensor


def halo_rows(*, kernel_size: int, dilation: int = 1,
              offset_bound: float) -> int:
    """Rows exchanged with each height-shard neighbour
    (``core.tiling.spatial_halo_rows``)."""
    return spatial_halo_rows(kernel_size=kernel_size, dilation=dilation,
                             offset_bound=offset_bound)


def check_height_split(h: int, *, shards: int, stride: int = 1,
                       min_rows: int | None = None) -> None:
    """Reject height splits the spatial path cannot serve, naming the
    sizes: a ragged split, and (``min_rows``, the halo) shards thinner
    than the halo they must lend."""
    if shards < 1:
        raise ValueError(f"spatial shards={shards} must be >= 1")
    if h % (stride * shards) != 0:
        raise ValueError(
            f"spatial shards={shards} does not evenly divide height "
            f"H={h} at stride={stride}; the spatial path needs equal "
            f"per-device row blocks (H % (stride*shards) == 0) — pad the "
            f"input height or pick a shard count dividing "
            f"{h // stride if h % stride == 0 else h}")
    if min_rows is not None and shards > 1 and h // shards < min_rows:
        raise ValueError(
            f"spatial shards={shards} leaves only {h // shards} rows per "
            f"shard, thinner than the {min_rows}-row halo the bounded "
            f"exchange needs — use fewer shards (or a smaller offset "
            f"bound)")


def spatial_mesh_axes() -> tuple[Mesh, str, int] | None:
    """``(mesh, axis_name, size)`` of the mesh axis the 'spatial' logical
    axis maps to under the active rules, or None when no mesh is active
    or the rules map 'spatial' to nothing.  A size-1 axis is kept: one
    shard still takes the exchange path (its halos are the zero
    padding).  Several mapped axes raise: the exchange needs one ordered
    axis."""
    ctx = current_rules()
    if ctx is None or ctx[1] is None:
        return None
    rules, mesh = ctx
    target = rules.get("spatial")
    if target is None:
        return None
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    axes = tuple(ax for ax in ((target,) if isinstance(target, str)
                               else tuple(target))
                 if ax in sizes)
    if not axes:
        return None
    if len(axes) > 1:
        raise ValueError(
            f"the 'spatial' logical axis maps to {axes} under the active "
            f"rules; the halo exchange needs exactly one mesh axis — map "
            f"'spatial' to a single axis")
    return mesh, axes[0], sizes[axes[0]]


@dataclasses.dataclass(frozen=True)
class SpatialSpec:
    """Mesh context of one height-sharded deform_conv call.

    ``batch_axes`` composes batch data-parallelism into the same call (a
    data x model mesh): dim 0 is split over them, dim 1 (height) over
    ``axis``.  ``at``: the coordinates of the data shard the call runs in
    (``sharding.data_shard``; its rows are the call's batch), which every
    height shard's device and position take."""
    mesh: Mesh
    axis: str
    shards: int
    batch_axes: tuple[str, ...] = ()
    at: tuple[tuple[str, int], ...] = ()

    @property
    def psum_axes(self) -> tuple[str, ...]:
        return (self.axis, *self.batch_axes)

    def devices(self) -> list[list[torch.device]]:
        """``[batch block][height shard]`` -> device."""
        axes = (*self.batch_axes, self.axis)
        sizes = [self.mesh.shape[a] for a in axes]
        flat = [self.mesh.device_at({**dict(self.at),
                                     **dict(zip(axes, idx))})
                for idx in np.ndindex(*sizes)]
        return [flat[i:i + self.shards]
                for i in range(0, len(flat), self.shards)]

    def positions(self) -> list[list[tuple[int, ...]]]:
        """``[batch block][height shard]`` -> mesh index (what
        ``sharding.count_crossings`` keys a crossing by)."""
        axes = (*self.batch_axes, self.axis)
        sizes = [self.mesh.shape[a] for a in axes]
        flat = [_position(self.mesh, {**dict(self.at),
                                      **dict(zip(axes, idx))})
                for idx in np.ndindex(*sizes)]
        return [flat[i:i + self.shards]
                for i in range(0, len(flat), self.shards)]


def resolve_spatial_shard(h: int, *, shard_spatial: bool | None = None,
                          stride: int = 1, kernel_size: int = 3,
                          dilation: int = 1, offset_bound: float = 0.0,
                          batch_axes: tuple[str, ...] = ()
                          ) -> SpatialSpec | None:
    """Whether to shard the height axis over the active mesh.  Strictly
    opt-in: ``None``/``False`` never shard; ``True`` requires an active
    mesh mapping 'spatial', an even split and shards no thinner than the
    halo, and raises a ``ValueError`` naming the sizes otherwise."""
    if not shard_spatial:
        return None
    got = spatial_mesh_axes()
    if got is None:
        raise ValueError(
            "shard_spatial=True but no mesh maps the 'spatial' logical "
            "axis — activate one with distributed.sharding.use_rules("
            "mesh=...) whose rules map 'spatial' to a mesh axis "
            "(DEFAULT_RULES maps it to 'model')")
    mesh, axis, size = got
    at = data_shard() or {}
    if axis in batch_axes or axis in at:
        raise ValueError(
            f"the 'spatial' mesh axis {axis!r} is already used by the "
            f"batch shard {tuple(batch_axes) or tuple(at)} — a mesh axis "
            f"may carry one logical axis per call; use a 2-D mesh (e.g. "
            f"('data', 'model')) so batch and height shard different axes")
    halo = halo_rows(kernel_size=kernel_size, dilation=dilation,
                     offset_bound=offset_bound)
    check_height_split(h, shards=size, stride=stride, min_rows=halo)
    return SpatialSpec(mesh=mesh, axis=axis, shards=size,
                       batch_axes=tuple(batch_axes),
                       at=tuple(sorted(at.items())))


# ---------------------------------------------------------------------------
# Shard bodies
# ---------------------------------------------------------------------------

def exchange_halo(blocks: list[Tensor], *, halo: int,
                  positions: list[tuple]) -> list[Tensor]:
    """The up/down exchange: each shard's block (``blocks[i]`` on its
    device, at mesh index ``positions[i]``) between ``halo`` edge rows of
    both neighbours, moved to it (a collective-permute); the edge shards
    get zero rows, the global zero padding."""
    pos = positions
    out = []
    for i, x in enumerate(blocks):
        zeros = x.new_zeros((x.shape[0], halo, *x.shape[2:]))
        top = _permute(blocks[i - 1][:, -halo:], x.device, pos[i - 1],
                       pos[i]) if i > 0 else zeros
        bot = _permute(blocks[i + 1][:, :halo], x.device, pos[i + 1],
                       pos[i]) if i + 1 < len(blocks) else zeros
        out.append(torch.cat([top, x, bot], 1))
    return out


def _permute(t: Tensor, device, src: tuple, dst: tuple) -> Tensor:
    return move(t, device, src, dst, "collective-permute")


def _shard_slab(x_ext: Tensor, *, kernel_size: int, stride: int,
                dilation: int, offset_bound: float, tile_h: int,
                tile_w: int, ho: int, wo: int) -> Tensor:
    """Trim one halo-extended block to the local analogue of the global
    ``plan.pad_zerocopy`` input.

    Global padded row ``u`` is original row ``u - p0``; local slab row
    ``j`` must be original row ``i*h_loc - p0 + j``, and ``x_ext`` row 0
    is original row ``i*h_loc - halo``, so the slab starts at ``x_ext``
    row ``halo - p0`` (= 1).  The width gets ``pad_zerocopy``'s left
    ``p0`` and right zero padding (it is not sharded), and the bottom is
    zero-padded to the band of the last of ``ceil(ho / tile_h)`` row
    tiles (rows only the ragged or padded outputs read)."""
    _, h_ext, w_, _ = x_ext.shape
    pad = dilation * (kernel_size // 2)
    geom = dict(kernel_size=kernel_size, stride=stride, dilation=dilation,
                offset_bound=offset_bound)
    hb, band_h = band_geometry(tile_h=tile_h, **geom)
    _, band_w = band_geometry(tile_h=tile_w, **geom)
    p0 = pad + hb
    top = 1                                   # halo - p0
    need_h = (-(-ho // tile_h) - 1) * tile_h * stride + band_h
    pb = max(0, need_h - (h_ext - top))
    pr = max(0, (-(-wo // tile_w) - 1) * tile_w * stride + band_w - p0 - w_)
    return F.pad(x_ext[:, top:], (0, 0, p0, pr, 0, pb)).contiguous()


def _blocks(t: Tensor, devs: list[list[torch.device]],
            rows: int) -> list[list[Tensor]]:
    """``t`` split into ``[batch block][height shard]`` blocks of ``rows``
    rows, each moved to its device."""
    return [[tb[:, i * rows:(i + 1) * rows].to(d) for i, d in enumerate(row)]
            for tb, row in zip(t.chunk(len(devs), 0), devs)]


def _gather(parts: list[list[Tensor]], device) -> Tensor:
    """Inverse of ``_blocks``: the blocks concatenated on ``device``."""
    return torch.cat([torch.cat([p.to(device) for p in row], 1)
                      for row in parts], 0)


def _geom(spec: _plan.DCSpec) -> dict:
    return dict(kernel_size=spec.kernel_size, stride=spec.stride,
                dilation=spec.dilation, offset_bound=spec.offset_bound)


def _halo(spec: _plan.DCSpec) -> int:
    return halo_rows(kernel_size=spec.kernel_size, dilation=spec.dilation,
                     offset_bound=spec.offset_bound)


def _run_shards(sspec: SpatialSpec, x: Tensor, offsets: Tensor, halo: int,
                body) -> Tensor:
    """``body(x_block, offset_block, x_ext)`` on every shard, its outputs
    gathered on x's device."""
    devs = sspec.devices()
    xs = _blocks(x, devs, x.shape[1] // sspec.shards)
    os_ = _blocks(offsets, devs, offsets.shape[1] // sspec.shards)
    return _gather([[body(xb, ob, ext) for xb, ob, ext in
                     zip(xrow, orow, exchange_halo(xrow, halo=halo,
                                                   positions=prow))]
                    for xrow, orow, prow in zip(xs, os_,
                                                sspec.positions())],
                   x.device)


def _spatial_forward(spec: _plan.DCSpec, sspec: SpatialSpec, x: Tensor,
                     offsets: Tensor, w: Tensor) -> Tensor:
    """Every shard: exchange, slab, then kernel 1a (its plain version on
    the CPU) at the tiles resolved for the shard's local block, with the
    unsharded call's C groups."""
    n, _, _, c = x.shape
    ho, wo = offsets.shape[1], offsets.shape[2]
    m = w.shape[-1]

    def body(xb, ob, ext):
        th, tw, tc, tm = _plan.spec_tiles(spec, xb, ob, w)
        slab = _shard_slab(ext, tile_h=th, tile_w=tw, ho=ob.shape[1], wo=wo,
                           **_geom(spec))
        return deform_conv_fused_zerocopy(
            slab, ob.contiguous(),
            _plan.tile_weights(w.to(xb.device, x.dtype), tc), tile_h=th,
            tile_w=tw, tile_c=tc, tile_m=tm,
            c_groups=fwd_c_groups(n, ho, wo, c, m, tile_h=th, tile_w=tw,
                                  tile_c=tc, tile_m=tm), **_geom(spec))

    return _run_shards(sspec, x, offsets, _halo(spec), body)


def _spatial_backward(spec: _plan.DCSpec, sspec: SpatialSpec, x: Tensor,
                      offsets: Tensor, w: Tensor, gy: Tensor
                      ) -> tuple[Tensor, Tensor, Tensor]:
    """Every shard: exchange, slab, kernel 2 at the shard's backward
    tiles; then each shard's halo-gradient rows are added into its
    neighbours' ``d_input`` (rows ``[0, p0)`` to the previous shard,
    ``[p0 + h_loc, 2*p0 + 1 + h_loc)`` to the next) and ``d_weights`` is
    summed over every shard in order."""
    _, h, w_in, _ = x.shape
    ho = offsets.shape[1]
    h_loc = h // sspec.shards
    devs = sspec.devices()
    halo = _halo(spec)
    p0 = halo - 1
    xs = _blocks(x, devs, h_loc)
    os_ = _blocks(offsets, devs, ho // sspec.shards)
    gs = _blocks(gy, devs, ho // sspec.shards)
    dxs, doffs, dw = [], [], None
    for xrow, orow, grow, prow in zip(xs, os_, gs, sspec.positions()):
        dxe, drow = [], []
        for xb, ob, gb, ext in zip(xrow, orow, grow,
                                   exchange_halo(xrow, halo=halo,
                                                 positions=prow)):
            th, tw, tc, _ = _plan.spec_tiles(spec, xb, ob, w,
                                             dtype="fp32_bwd")
            slab = _shard_slab(ext, tile_h=th, tile_w=tw, ho=ob.shape[1],
                               wo=ob.shape[2], **_geom(spec))
            dxp, doff, dwt = deform_conv_bwd_zerocopy(
                slab, ob.contiguous(), gb.contiguous(),
                _plan.tile_weights(w.to(xb.device, x.dtype), tc),
                tile_h=th, tile_w=tw, tile_c=tc, **_geom(spec))
            # Un-pad the width; keep the halo-extended rows.
            dxe.append(dxp[:, :, p0:p0 + w_in])
            drow.append(doff)
            part = _plan.untile_weights(dwt, spec.kernel_size).to(w.device)
            dw = part if dw is None else dw + part
        dx_row = []
        for i, d in enumerate(dxe):
            dx = d[:, p0:p0 + h_loc].clone()
            # Each halo's gradient rows go back to the shard they came
            # from: the exchange's collective-permute, reversed.
            if i + 1 < len(dxe) and p0 > 0:
                dx[:, h_loc - p0:] += _permute(dxe[i + 1][:, :p0],
                                               dx.device, prow[i + 1],
                                               prow[i])
            if i > 0:
                dx[:, :p0 + 1] += _permute(
                    dxe[i - 1][:, p0 + h_loc:p0 + h_loc + p0 + 1],
                    dx.device, prow[i - 1], prow[i])
            dx_row.append(dx)
        dxs.append(dx_row)
        doffs.append(drow)
    return (_gather(dxs, x.device).to(x.dtype),
            _gather(doffs, offsets.device).to(offsets.dtype),
            dw.to(w.dtype))


class DeformConvSpatial(torch.autograd.Function):
    """Height-sharded bounded deform conv (fp32 or bf16); saves only
    ``(x, offsets, w)``, as the unsharded ``ops.BoundedDeformConv``."""

    @staticmethod
    def forward(ctx, spec, sspec, x, offsets, w):
        ctx.spec, ctx.sspec = spec, sspec
        ctx.save_for_backward(x, offsets, w)
        return _spatial_forward(spec, sspec, x, offsets, w)

    @staticmethod
    @once_differentiable
    def backward(ctx, gy):
        x, offsets, w = ctx.saved_tensors
        dx, doff, dw = _spatial_backward(ctx.spec, ctx.sspec, x, offsets, w,
                                         gy.contiguous())
        need = ctx.needs_input_grad
        return (None, None, dx if need[2] else None,
                doff if need[3] else None, dw if need[4] else None)


def deform_conv_spatial(spec: _plan.DCSpec, sspec: SpatialSpec, x: Tensor,
                        offsets: Tensor, w: Tensor) -> Tensor:
    """Height-sharded bounded deform_conv (differentiable): one halo
    exchange and one kernel launch a shard."""
    return DeformConvSpatial.apply(spec, sspec, x, offsets, w)


def spatial_int8_forward(x: Tensor, offsets: Tensor, w: Tensor, *,
                         kernel_size: int, stride: int, dilation: int,
                         offset_bound: float, tile_h: int | None,
                         tile_w: int | None, tile_c: int | None,
                         tile_m: int | None, x_scale=None, w_scale=None,
                         sspec: SpatialSpec) -> Tensor:
    """Height-sharded int8 inference datapath (no gradient).

    The scales are taken on the global tensors before the split (the
    calibrated ones, else one absmax, ``plan.int8_operands``): a per-shard
    absmax would give each shard its own int8 grid.  The exchange then
    carries int8 rows, and the exact integer sums make every shard's rows
    equal the unsharded kernel's wherever both run the same spatial tiles
    (the int8 patches round in the band's frame)."""
    m, wo = w.shape[-1], offsets.shape[2]
    xq, wq, scale = _plan.int8_operands(x, w, x_scale, w_scale)
    geom = dict(kernel_size=kernel_size, stride=stride, dilation=dilation,
                offset_bound=offset_bound)

    def body(xb, ob, ext):
        ho_loc = ob.shape[1]
        th, tw, tc, tm = _plan.resolve_tiles(
            xb.shape[0], xb.shape[1], xb.shape[2], xb.shape[3], m,
            tile_h=tile_h, tile_w=tile_w, tile_c=tile_c, tile_m=tile_m,
            dtype="int8", device=xb.device, **geom)
        th, tw = min(th, ho_loc), min(tw, wo)
        slab = _shard_slab(ext, tile_h=th, tile_w=tw, ho=ho_loc, wo=wo,
                           **geom)
        return deform_conv_fused_zerocopy_q(
            slab, ob.float().contiguous(),
            _plan.tile_weights(wq.to(xb.device), tc), scale.to(xb.device),
            tile_h=th, tile_w=tw, tile_c=tc, tile_m=tm, **geom)

    return _run_shards(sspec, xq, offsets,
                       halo_rows(kernel_size=kernel_size, dilation=dilation,
                                 offset_bound=offset_bound),
                       body).to(x.dtype)
