"""Plan and input preparation of the bounded DCL kernels (counterpart of
``repro.kernels.plan``).

* ``DCSpec`` — the static configuration of one bounded call, with its
  dataflow: ``"zero_copy"`` (the kernels stage their bands from the
  padded input) or ``"banded"`` (the legacy dataflow: the bands are
  materialised in device memory first, ``pad_and_band``);
* tile resolution (``resolve_tiles``: explicit tiles win, then the
  installed tuned-tile cache of ``repro_torch.tune`` for the tunable
  datapaths, then the Hopper chooser of ``core.tiling``) and the weight
  blocking;
* ``pad_zerocopy`` / ``zerocopy_inputs`` — zero-pad the input once so
  every Eq. 6 band is a plain window of it; ``pad_and_band`` — zero-pad
  and cut the overlapping row bands (PyTorch glue, as XLA glue in JAX);
* ``bounded_forward`` (fp32 or bf16, x's dtype), ``int8_forward`` and
  ``chain_forward`` — prepare the inputs and call the kernel wrappers;
* ``bounded_backward`` — the backward (fp32 math, for fp32 or bf16
  inputs) at its own tiles (the ``"fp32_bwd"`` chooser at x's element
  size), un-padded and un-blocked; it serves both dataflows' forwards, as
  in JAX.

The int8 paths quantize outside the kernels, as the JAX package does:
the input per tensor, the weights per output channel, then pad the int8
plane (0 maps to 0, so padding and quantization commute).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.core.tiling import (BANDED_TILE_H, TUNABLE,
                                     choose_kernel_tiles, out_hw, tiles_fit)
from repro_torch.kernels.band_pipeline import band_geometry
from repro_torch.kernels.deform_conv_bwd import deform_conv_bwd_zerocopy
from repro_torch.kernels.deform_conv_fused import (
    deform_conv_fused_banded, deform_conv_fused_zerocopy)
from repro_torch.kernels.deform_conv_q import (
    deform_conv_fused_zerocopy_chain, deform_conv_fused_zerocopy_q)
from repro_torch.quant.qtypes import compute_scale, quantize_values

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class DCSpec:
    """Static configuration of one bounded deform_conv call."""
    kernel_size: int
    stride: int
    dilation: int
    offset_bound: float
    tile_h: int | None = None
    tile_w: int | None = None
    tile_c: int | None = None
    tile_m: int | None = None
    dataflow: str = "zero_copy"
    # Explicit tiles of the backward (kernel 2), else its own resolution.
    bwd_tiles: tuple[int, int, int] | None = None


DATAFLOWS = ("zero_copy", "banded")


def check_dataflow(dataflow: str) -> None:
    if dataflow not in DATAFLOWS:
        raise ValueError(
            f"unknown dataflow {dataflow!r}; expected 'zero_copy' or "
            f"'banded'")


def tile_weights(w: Tensor, tile_c: int) -> Tensor:
    """(K*K, C, M) -> (C//tile_c, K*K*tile_c, M): one contiguous block per
    channel chunk."""
    k2, c, m = w.shape
    if c % tile_c:
        raise ValueError(f"tile_c={tile_c} does not divide C={c}")
    n_c = c // tile_c
    wt = w.reshape(k2, n_c, tile_c, m).permute(1, 0, 2, 3)
    return wt.reshape(n_c, k2 * tile_c, m).contiguous()


def untile_weights(w_tiles: Tensor, kernel_size: int) -> Tensor:
    """Inverse of ``tile_weights``: (C//tile_c, K*K*tile_c, M) ->
    (K*K, C, M)."""
    n_c, kkt, m = w_tiles.shape
    k2 = kernel_size * kernel_size
    tc = kkt // k2
    w = w_tiles.reshape(n_c, k2, tc, m).permute(1, 0, 2, 3)
    return w.reshape(k2, n_c * tc, m)


# Resolutions since the last ``reset_tuned_stats``: served by the tuned
# cache, by the chooser, and entries refused (the chooser served them).
_TUNED_STATS = {"tuned_hits": 0, "analytic_resolves": 0,
                "tuned_incompatible": 0}


def reset_tuned_stats() -> None:
    """Zero the tuned-vs-analytic resolution counters (tests)."""
    for k in _TUNED_STATS:
        _TUNED_STATS[k] = 0


def _cache_key(dtype: str, itemsize: int) -> tuple[str, str]:
    """(objective, dtype) of a tunable datapath's cache entries: the
    backward's are the ``"training"`` objective's, bf16 has its own."""
    objective = "training" if dtype == "fp32_bwd" else "forward"
    if dtype in ("fp32", "fp32_bwd"):
        return objective, "bf16" if itemsize == 2 else "fp32"
    return objective, dtype


def _tuned_tiles(n: int, h: int, w: int, c: int, m: int, *,
                 kernel_size: int, stride: int, dilation: int,
                 offset_bound: float, dtype: str, itemsize: int,
                 device) -> tuple[tuple | None, bool]:
    """(tiles, found) of the installed cache's entry for one resolution
    on ``device``'s platform: ``(None, False)`` when no cache is
    installed, the datapath is not tunable or the key is cold;
    ``(None, True)`` for an entry the kernel would not take
    (``tiling.tiles_fit``), or an int8 entry whose spatial tiles are not
    the chooser's (they set the band frame the int8 patches round in, so
    they would change the rung's integers)."""
    from repro_torch.tune.cache import active_tile_cache, platform_of
    cache = active_tile_cache()
    if cache is None or device is None or dtype not in TUNABLE:
        return None, False
    objective, key_dtype = _cache_key(dtype, itemsize)
    geom = dict(kernel_size=kernel_size, stride=stride, dilation=dilation,
                offset_bound=offset_bound)
    entry = cache.lookup(n=n, h=h, w=w, c=c, m=m, objective=objective,
                         dtype=key_dtype, platform=platform_of(device),
                         **geom)
    if entry is None:
        return None, False
    tiles = entry.get("tiles") if isinstance(entry, dict) else None
    if not (isinstance(tiles, list) and len(tiles) == 4 and tiles_fit(
            *tiles, c=c, m=m, dtype=dtype, itemsize=itemsize, **geom)):
        return None, True
    if dtype in ("int8", "int8_chain"):
        kt = choose_kernel_tiles(n, h, w, c, m, dtype=dtype, **geom)
        if tiles[:2] != [kt.tile_h, kt.tile_w]:
            return None, True
    return tuple(tiles), True


def resolve_tiles_and_source(
        n: int, h: int, w: int, c: int, m: int, *, kernel_size: int,
        stride: int, dilation: int, offset_bound: float,
        tile_h: int | None = None, tile_w: int | None = None,
        tile_c: int | None = None, tile_m: int | None = None,
        dtype: str = "fp32", itemsize: int = 4, device=None,
        count: bool = True) -> tuple[tuple[int, int, int, int], str]:
    """``resolve_tiles`` and where its tiles came from: ``"explicit"``,
    ``"tuned"`` (the installed cache) or ``"analytic"`` (the chooser
    filled at least one).  ``count=False`` leaves the resolution counters
    of ``tile_cache_info`` (and the one-time warning) alone: pricing a
    dispatch is not a resolution."""
    from repro_torch.kernels.ops import check_channel_tiles
    if (tile_h, tile_w, tile_c, tile_m) == (None,) * 4:
        tuned, found = _tuned_tiles(n, h, w, c, m, kernel_size=kernel_size,
                                    stride=stride, dilation=dilation,
                                    offset_bound=offset_bound, dtype=dtype,
                                    itemsize=itemsize, device=device)
        if tuned is not None:
            if count:
                _TUNED_STATS["tuned_hits"] += 1
            return tuned, "tuned"
        if found and count:
            from repro_torch.tune.cache import warn_once
            _TUNED_STATS["tuned_incompatible"] += 1
            warn_once(("entry", n, h, w, c, m, dtype, itemsize),
                      "tuned-tile cache entry for %dx%dx%dx%d->%d (%s) is "
                      "malformed or incompatible with the layer; falling "
                      "back to the analytic chooser (warned once per key)",
                      n, h, w, c, m, dtype)
    source = "explicit"
    if None in (tile_h, tile_w, tile_c, tile_m):
        source = "analytic"
        if count:
            _TUNED_STATS["analytic_resolves"] += 1
        kt = choose_kernel_tiles(n, h, w, c, m, kernel_size=kernel_size,
                                 stride=stride, dilation=dilation,
                                 offset_bound=offset_bound, dtype=dtype,
                                 tile_h=tile_h, itemsize=itemsize)
        tile_h = tile_h or kt.tile_h
        tile_w = tile_w or kt.tile_w
        tile_c = tile_c or kt.tile_c
        tile_m = tile_m or kt.tile_m
    check_channel_tiles(c, m, tile_c, tile_m)
    return (tile_h, tile_w, tile_c, tile_m), source


def resolve_tiles(n: int, h: int, w: int, c: int, m: int, *,
                  kernel_size: int, stride: int, dilation: int,
                  offset_bound: float, tile_h: int | None = None,
                  tile_w: int | None = None, tile_c: int | None = None,
                  tile_m: int | None = None, dtype: str = "fp32",
                  itemsize: int = 4,
                  device=None) -> tuple[int, int, int, int]:
    """Explicit tiles win; when none is given, the installed tuned cache's
    entry for the call's datapath (``tiling.TUNABLE``: ``"fp32"``,
    ``"int8"``, ``"int8_chain"``, ``"fp32_bwd"``; bf16 at its own
    ``itemsize``) on ``device``'s platform serves, if the kernel takes
    it; the chooser for ``dtype`` (also ``"sample"``, ``"banded"``)
    fills the rest, around an explicit ``tile_h`` (``itemsize``: the
    element bytes the kernels stage, 4 fp32 or 2 bf16; the int8 choosers
    do not read it).  Without a ``device`` no cache is consulted.  Raises
    on channel tiles that do not divide the layer.  Not memoised."""
    return resolve_tiles_and_source(
        n, h, w, c, m, kernel_size=kernel_size, stride=stride,
        dilation=dilation, offset_bound=offset_bound, tile_h=tile_h,
        tile_w=tile_w, tile_c=tile_c, tile_m=tile_m, dtype=dtype,
        itemsize=itemsize, device=device)[0]


def _spatial_local_h(h: int, stride: int, spatial_shards: int, name: str,
                     *, kernel_size: int, dilation: int,
                     offset_bound: float) -> int:
    """The height a spatially sharded layer resolves its tiles at, after
    the whole split check (ragged and thinner than the halo), so a shard
    count that cannot serve fails when the plans are warmed (engine
    start), not on the first sharded request."""
    if spatial_shards <= 1:
        return h
    from repro_torch.core.tiling import spatial_halo_rows
    from repro_torch.distributed.spatial import check_height_split
    try:
        check_height_split(
            h, shards=spatial_shards, stride=stride,
            min_rows=spatial_halo_rows(kernel_size=kernel_size,
                                       dilation=dilation,
                                       offset_bound=offset_bound))
    except ValueError as e:
        raise ValueError(f"layer {name!r}: {e}") from None
    return h // spatial_shards


def tile_source(n: int, h: int, w: int, c: int, m: int, *,
                kernel_size: int = 3, stride: int = 1, dilation: int = 1,
                offset_bound: float, dtype: str = "fp32", itemsize: int = 4,
                device=None, spatial_shards: int = 1) -> str:
    """Where one layer's tiles come from: ``"tuned"`` when the installed
    cache serves them on ``device``'s platform, else ``"analytic"``
    (counts nothing).  ``spatial_shards`` asks for the shard-local plan
    the spatial path resolves."""
    h = _spatial_local_h(h, stride, spatial_shards, "tile_source",
                         kernel_size=kernel_size, dilation=dilation,
                         offset_bound=offset_bound)
    return resolve_tiles_and_source(
        n, h, w, c, m, kernel_size=kernel_size, stride=stride,
        dilation=dilation, offset_bound=offset_bound, dtype=dtype,
        itemsize=itemsize, device=device, count=False)[1]


def tile_cache_info() -> dict:
    """The resolution counters and the installed cache's status
    (``tuned_cache``), so a cold, corrupt or refused cache shows in the
    serving engine's telemetry."""
    from repro_torch.tune.cache import cache_info
    return dict(_TUNED_STATS, tuned_cache=cache_info())


def kernel_itemsize(x: Tensor) -> int:
    """The element bytes the fused DCL kernels stage for x: 2 for its bf16
    instance, else 4 (the fp32 instance; other dtypes run only the plain
    versions on the CPU, at the fp32 tiles, and raise on the card)."""
    return 2 if x.dtype == torch.bfloat16 else 4


def spec_tiles(spec: DCSpec, x: Tensor, offsets: Tensor, w: Tensor, *,
               dtype: str = "fp32") -> tuple[int, int, int, int]:
    """Tiles of one call at ``kernel_itemsize(x)`` on x's device, spatial
    tiles clamped to the output extent; the backward (``"fp32_bwd"``)
    takes ``spec.bwd_tiles`` when given."""
    ho, wo = offsets.shape[1], offsets.shape[2]
    if dtype == "fp32_bwd" and spec.bwd_tiles is not None:
        th, tw, tc = spec.bwd_tiles
        tm = w.shape[-1]
    else:
        th, tw, tc, tm = resolve_tiles(
            x.shape[0], x.shape[1], x.shape[2], x.shape[-1], w.shape[-1],
            kernel_size=spec.kernel_size, stride=spec.stride,
            dilation=spec.dilation, offset_bound=spec.offset_bound,
            tile_h=spec.tile_h, tile_w=spec.tile_w, tile_c=spec.tile_c,
            tile_m=spec.tile_m, dtype=dtype, itemsize=kernel_itemsize(x),
            device=x.device)
    return min(th, ho), min(tw, wo), tc, tm


def warm_tile_cache(layers, *, batch: int, offset_bound: float,
                    kernel_size: int = 3, dilation: int = 1,
                    dtype: str = "fp32", device=None,
                    spatial_shards: int = 1
                    ) -> tuple[dict[str, tuple[int, int, int, int]],
                               dict[str, str]]:
    """Resolve the tiles of every named layer ``{name: {"h", "w", "c",
    "m", "stride"?}}`` at ``batch`` for the ``dtype`` datapath on
    ``device`` — the serving engine's per-bucket plans, resolved at
    engine start.  Returns ``(tiles, sources)``: each layer's tiles and
    where they came from (``"tuned"`` or ``"analytic"``).

    ``spatial_shards > 1`` warms the plans the spatial path resolves: a
    shard sees the local height ``h // spatial_shards``; a height that
    does not split raises the split error naming the layer."""
    tiles, sources = {}, {}
    for name, d in layers.items():
        stride = d.get("stride", 1)
        h = _spatial_local_h(d["h"], stride, spatial_shards, name,
                             kernel_size=kernel_size, dilation=dilation,
                             offset_bound=offset_bound)
        tiles[name], sources[name] = resolve_tiles_and_source(
            batch, h, d["w"], d["c"], d["m"], kernel_size=kernel_size,
            stride=stride, dilation=dilation, offset_bound=offset_bound,
            dtype=dtype, device=device)
    return tiles, sources


def pad_zerocopy(x: Tensor, *, kernel_size: int, stride: int, dilation: int,
                 offset_bound: float, tile_h: int, tile_w: int,
                 ho: int, wo: int) -> Tensor:
    """Zero-pad x once: pad + ceil(B) on the top/left, and on the
    bottom/right as far as the last of ceil(Ho/tile_h) x ceil(Wo/tile_w)
    tiles' bands reaches."""
    _, h, w, _ = x.shape
    pad = dilation * (kernel_size // 2)
    hb, band_h = band_geometry(kernel_size=kernel_size, stride=stride,
                               dilation=dilation, offset_bound=offset_bound,
                               tile_h=tile_h)
    _, band_w = band_geometry(kernel_size=kernel_size, stride=stride,
                              dilation=dilation, offset_bound=offset_bound,
                              tile_h=tile_w)
    h_tiles, w_tiles = -(-ho // tile_h), -(-wo // tile_w)
    p0 = pad + hb
    pb = max(0, (h_tiles - 1) * tile_h * stride + band_h - p0 - h)
    pr = max(0, (w_tiles - 1) * tile_w * stride + band_w - p0 - w)
    return F.pad(x, (0, 0, p0, pr, p0, pb)).contiguous()


def pad_and_band(x: Tensor, *, kernel_size: int, stride: int, dilation: int,
                 offset_bound: float, tile_h: int,
                 ho: int) -> tuple[Tensor, int]:
    """Zero-pad x and cut it into overlapping row bands (the legacy banded
    dataflow), as ``repro.kernels.plan.pad_and_band``.

    Returns (bands, n_tiles): bands (N, n_tiles, band_h, w_pad, C), row
    tile j's Eq. 6 band starting at padded row ``j * tile_h * stride``.
    The top/left zero padding of ``pad + halo`` (+1 column on the right for
    the bilinear corner) puts every corner of every clamped tap inside its
    band.  The bands repeat the overlap rows: ``band_h / (tile_h *
    stride)`` times the input's bytes, written and read back through
    device memory, which is the cost the zero-copy dataflow removes."""
    _, h, _, _ = x.shape
    pad = dilation * (kernel_size // 2)
    hb, band_h = band_geometry(kernel_size=kernel_size, stride=stride,
                               dilation=dilation, offset_bound=offset_bound,
                               tile_h=tile_h)
    n_tiles = -(-ho // tile_h)
    p0 = pad + hb
    p1 = max(0, (n_tiles - 1) * tile_h * stride + band_h - p0 - h)
    xp = F.pad(x, (0, 0, p0, p0 + 1, p0, p1))
    rows = (torch.arange(n_tiles, device=x.device)[:, None] * tile_h * stride
            + torch.arange(band_h, device=x.device)[None, :])
    bands = xp.index_select(1, rows.reshape(-1))
    return bands.reshape(x.shape[0], n_tiles, band_h, xp.shape[2],
                         x.shape[3]), n_tiles


def zerocopy_inputs(spec: DCSpec, x: Tensor, offsets: Tensor, w: Tensor,
                    th: int, tw: int, tc: int):
    """(x_pad, offsets, w_tiled) for the kernel.  The offsets stay as they
    are: the kernel masks the ragged edge itself."""
    ho, wo = offsets.shape[1], offsets.shape[2]
    xp = pad_zerocopy(x, kernel_size=spec.kernel_size, stride=spec.stride,
                      dilation=spec.dilation,
                      offset_bound=spec.offset_bound, tile_h=th, tile_w=tw,
                      ho=ho, wo=wo)
    return xp, offsets.contiguous(), tile_weights(w.to(x.dtype), tc)


def banded_tiles(spec: DCSpec, x: Tensor, offsets: Tensor, m: int, *,
                 dtype: str) -> tuple[int, int, int, int]:
    """Tiles of one banded call: the bands' row tile (``spec.tile_h``,
    default ``BANDED_TILE_H``, not clamped to the output: the bands are
    cut at it) and the chooser's columns and channel tiles around it."""
    th = spec.tile_h or BANDED_TILE_H
    _, tw, tc, tm = resolve_tiles(
        x.shape[0], x.shape[1], x.shape[2], x.shape[3], m,
        kernel_size=spec.kernel_size, stride=spec.stride,
        dilation=spec.dilation, offset_bound=spec.offset_bound, tile_h=th,
        tile_w=spec.tile_w, tile_c=spec.tile_c, tile_m=spec.tile_m,
        dtype=dtype, itemsize=kernel_itemsize(x))
    return th, min(tw, offsets.shape[2]), tc, tm


def banded_inputs(spec: DCSpec, x: Tensor, offsets: Tensor,
                  th: int) -> tuple[Tensor, Tensor]:
    """(bands, offsets) of one banded call: the offsets zero-padded to
    whole row tiles (the kernels take ``n_tiles * tile_h`` rows, as the
    TPU kernels do), the bands of ``pad_and_band``."""
    ho = offsets.shape[1]
    pad_h = (-ho) % th
    if pad_h:
        offsets = F.pad(offsets, (0, 0, 0, 0, 0, pad_h))
    bands, _ = pad_and_band(x, kernel_size=spec.kernel_size,
                            stride=spec.stride, dilation=spec.dilation,
                            offset_bound=spec.offset_bound, tile_h=th,
                            ho=ho + pad_h)
    return bands, offsets.contiguous()


def bounded_forward(spec: DCSpec, x: Tensor, offsets: Tensor,
                    w: Tensor) -> Tensor:
    check_dataflow(spec.dataflow)
    if spec.dataflow == "banded":
        th, tw, tc, tm = banded_tiles(spec, x, offsets, w.shape[-1],
                                      dtype="banded")
        bands, offsets_p = banded_inputs(spec, x, offsets, th)
        y = deform_conv_fused_banded(
            bands, offsets_p, tile_weights(w.to(x.dtype), tc),
            kernel_size=spec.kernel_size, stride=spec.stride,
            dilation=spec.dilation, offset_bound=spec.offset_bound,
            tile_h=th, tile_w=tw, tile_c=tc, tile_m=tm)
        return y[:, :offsets.shape[1]]
    th, tw, tc, tm = spec_tiles(spec, x, offsets, w)
    xp, offsets, w_tiled = zerocopy_inputs(spec, x, offsets, w, th, tw, tc)
    return deform_conv_fused_zerocopy(
        xp, offsets, w_tiled, kernel_size=spec.kernel_size,
        stride=spec.stride, dilation=spec.dilation,
        offset_bound=spec.offset_bound, tile_h=th, tile_w=tw, tile_c=tc,
        tile_m=tm)


def bounded_backward(spec: DCSpec, x: Tensor, offsets: Tensor, w: Tensor,
                     gy: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """(d_input, d_offsets, d_weights) of one bounded call (fp32 or bf16)
    through the fused backward kernel, at the backward's own tiles
    (explicit tiles of ``spec`` win, as for the forward), each in its
    input's dtype (the kernel's d_weights is fp32).  ``gy`` must be
    contiguous; the kernel masks the ragged edge, so it is not padded."""
    _, h, w_in, _ = x.shape
    th, tw, tc, _ = spec_tiles(spec, x, offsets, w, dtype="fp32_bwd")
    xp, offsets_c, w_tiled = zerocopy_inputs(spec, x, offsets, w, th, tw,
                                             tc)
    dxp, doff, dwt = deform_conv_bwd_zerocopy(
        xp, offsets_c, gy, w_tiled, kernel_size=spec.kernel_size,
        stride=spec.stride, dilation=spec.dilation,
        offset_bound=spec.offset_bound, tile_h=th, tile_w=tw, tile_c=tc)
    # Un-pad: pad_zerocopy put pad + ceil(B) zero rows/cols top-left.
    p0 = spec.dilation * (spec.kernel_size // 2) \
        + int(math.ceil(spec.offset_bound))
    dx = dxp[:, p0:p0 + h, p0:p0 + w_in]
    dw = untile_weights(dwt, spec.kernel_size)
    return (dx.to(x.dtype), doff.to(offsets.dtype), dw.to(w.dtype))


def _f32(v, device) -> Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def int8_operands(x: Tensor, w: Tensor, x_scale=None,
                  w_scale=None) -> tuple[Tensor, Tensor, Tensor]:
    """(x int8, w int8, the (M,) dequant scale ``s_x * s_w[m]``): x per
    tensor, w per output channel, absmax unless calibrated scales are
    given."""
    m = w.shape[-1]
    sx = compute_scale(x) if x_scale is None else _f32(x_scale, x.device)
    sw = compute_scale(w, axis=-1) if w_scale is None \
        else _f32(w_scale, x.device).reshape(1, 1, m)
    return (quantize_values(x, sx), quantize_values(w, sw),
            (sx * sw).reshape(m).contiguous())


def int8_forward(x: Tensor, offsets: Tensor, w: Tensor, *,
                 kernel_size: int, stride: int, dilation: int,
                 offset_bound: float, tile_h: int | None = None,
                 tile_w: int | None = None, tile_c: int | None = None,
                 tile_m: int | None = None, x_scale=None,
                 w_scale=None) -> Tensor:
    """int8 inference datapath: quantize (per-tensor x, per-out-channel w;
    absmax unless calibrated scales are given), pad the int8 plane, block
    the int8 weights and run the int8 kernel with its per-M dequant
    epilogue ``s_x * s_w[m]``."""
    ho, wo = offsets.shape[1], offsets.shape[2]
    m = w.shape[-1]
    th, tw, tc, tm = resolve_tiles(
        x.shape[0], x.shape[1], x.shape[2], x.shape[-1], m,
        kernel_size=kernel_size, stride=stride, dilation=dilation,
        offset_bound=offset_bound, tile_h=tile_h, tile_w=tile_w,
        tile_c=tile_c, tile_m=tile_m, dtype="int8", device=x.device)
    th, tw = min(th, ho), min(tw, wo)
    xq, wq, scale = int8_operands(x, w, x_scale, w_scale)
    xp = pad_zerocopy(xq, kernel_size=kernel_size, stride=stride,
                      dilation=dilation, offset_bound=offset_bound,
                      tile_h=th, tile_w=tw, ho=ho, wo=wo)
    w_tiled = tile_weights(wq, tc)
    y = deform_conv_fused_zerocopy_q(
        xp, offsets.float().contiguous(), w_tiled, scale,
        kernel_size=kernel_size, stride=stride, dilation=dilation,
        offset_bound=offset_bound, tile_h=th, tile_w=tw, tile_c=tc,
        tile_m=tm)
    return y.to(x.dtype)


def chain_forward(x: Tensor, w: Tensor, w_offset: Tensor, b_offset,
                  b_deform, *, kernel_size: int, stride: int,
                  dilation: int, offset_bound: float, x_scale,
                  w_scale=None, w_offset_scale=None, y_scale=None,
                  tile_h: int | None = None, tile_w: int | None = None,
                  tile_c: int | None = None, tile_m: int | None = None,
                  emit: str = "int8") -> Tensor:
    """Chained int8 DCL layer (inference datapath).

    x is int8 on the ``x_scale`` grid (a chained producer's emission,
    taken verbatim) or fp32 (the chain head, quantized here).  The offset
    conv runs inside the kernel (int8 ``w_offset``, dequantized by
    ``s_x * s_woff`` plus ``b_offset``); the output is emitted int8 on the
    ``y_scale`` grid with the per-channel requant ``s_x * s_w[m] / s_y``
    and the deform bias folded as ``b[m] / s_y``, or in fp32
    (``emit="fp32"``: ``s_x * s_w[m]`` and ``b[m]``).  The kernel streams
    C in ``tile_c`` chunks, so ``tile_c`` need not be C (unlike the TPU
    plan, which stages all of C per band).
    """
    n, h, w_in, c = x.shape
    m = w.shape[-1]
    k2 = kernel_size * kernel_size
    dev = x.device
    ho, wo = out_hw(h, w_in, kernel_size=kernel_size, stride=stride,
                    dilation=dilation)
    th, tw, tc, tm = resolve_tiles(
        n, h, w_in, c, m, kernel_size=kernel_size, stride=stride,
        dilation=dilation, offset_bound=offset_bound, tile_h=tile_h,
        tile_w=tile_w, tile_c=tile_c, tile_m=tile_m, dtype="int8_chain",
        device=dev)
    th, tw = min(th, ho), min(tw, wo)
    sx = _f32(x_scale, dev)
    sw = compute_scale(w, axis=-1) if w_scale is None \
        else _f32(w_scale, dev).reshape(1, 1, m)
    swo = compute_scale(w_offset, axis=-1) if w_offset_scale is None \
        else _f32(w_offset_scale, dev).reshape(1, 1, 2 * k2)
    xq = x if x.dtype == torch.int8 else quantize_values(x, sx)
    xp = pad_zerocopy(xq, kernel_size=kernel_size, stride=stride,
                      dilation=dilation, offset_bound=offset_bound,
                      tile_h=th, tile_w=tw, ho=ho, wo=wo)
    w_tiled = tile_weights(quantize_values(w, sw), c)
    wo_tiled = tile_weights(quantize_values(w_offset, swo), c)
    off_scale = (sx * swo).reshape(2 * k2).contiguous()
    off_bias = _f32(b_offset, dev).reshape(2 * k2).contiguous()
    bias = torch.zeros(m, dtype=torch.float32, device=dev) \
        if b_deform is None else _f32(b_deform, dev).reshape(m)
    if emit == "int8":
        sy = _f32(y_scale, dev)
        out_scale = (sx * sw / sy).reshape(m)
        out_bias = bias / sy
    else:
        out_scale = (sx * sw).reshape(m)
        out_bias = bias
    return deform_conv_fused_zerocopy_chain(
        xp, w_tiled, wo_tiled, off_scale, off_bias,
        out_scale.contiguous(), out_bias.contiguous(),
        kernel_size=kernel_size, stride=stride, dilation=dilation,
        offset_bound=offset_bound, tile_h=th, tile_w=tw, tile_c=tc,
        tile_m=tm, emit=emit, ho=ho, wo=wo)
