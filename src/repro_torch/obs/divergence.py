"""Measured time against the H100's bound, per dispatch (counterpart of
``repro.obs.divergence``).

* ``price_dispatch`` prices one bounded dispatch from its ``ops`` hook
  context: its tiles (as the dispatcher resolves them, counting no
  resolution), the bytes and operations of the kernel it runs and the
  least time the card could take for them (``core.h100``, the bounds of
  ``PERF.md`` section 6), and the bytes its launches load and store at
  those tiles (``core.tiling``'s traffic model, which counts what
  neighbouring blocks re-read: JAX's ``modeled_dispatch_bytes`` at the
  resolved tiles).
* ``DivergenceTracker`` aggregates measured seconds per
  ``DispatchKey``; each report row carries ``traffic_bytes`` beside the
  bound's ``modeled_bytes`` and ``share = bound_s / best_s``,
  the share of the bound the best dispatch reached (at most 1 on the
  card: no dispatch beats it), and the named ratio pairs of
  ``record_pair``.
* ``DispatchRecorder`` is an ``ops`` dispatch hook that times every
  dispatch into a metrics registry, a ``kernel/dispatch`` span and the
  tracker.  It chains to the hook installed before it and runs that one
  first, so an injected fault aborts before any timing starts.

Timing: on the CPU the host clock around the call.  On CUDA the
recorder records a pair of CUDA events around each dispatch and reads
them in ``flush``, after the caller's own synchronisation (the serving
engine's copy of a step's outputs to the host), so no dispatch waits for
the device.  A row's seconds are then the stream's time between the two
events: the dispatch's input preparation and kernel launches, and any
gap in which the stream idles while the host enqueues them — on a
host-bound step mostly host gaps, not the kernel's device time alone.
``block=True`` (the tuner) synchronises after each call instead and
reads the host clock: the wall time of a call.
"""
from __future__ import annotations

import dataclasses
import logging
import time

from . import metrics as _metrics
from . import trace as _trace

__all__ = ["DispatchKey", "DispatchRecorder", "DivergenceTracker",
           "key_from_context", "modeled_bound_ms", "modeled_dispatch_bytes",
           "price_dispatch"]

_log = logging.getLogger("repro_torch.obs")


@dataclasses.dataclass(frozen=True)
class DispatchKey:
    """Aggregation key of one population of bounded dispatches."""
    op: str
    shape: tuple            # (N, H, W, C) of the dispatched input
    m: int
    stride: int
    dtype: str              # element type of the band: fp32 | bf16 | int8
    quant: str              # none | int8 | int8_chain
    # (batch blocks, height shards) of a mesh call, and inside a model's
    # data shard the number of data shards (``ops``' dispatch context)
    shards: tuple = (1, 1)

    def label(self) -> str:
        n, h, w, c = self.shape
        split = "" if self.shards[:2] == (1, 1) else \
            f"@{self.shards[0]}x{self.shards[1]}shard"
        if len(self.shards) > 2:
            split += f"/data{self.shards[2]}"
        return (f"{self.op}[{n}x{h}x{w}x{c}->{self.m} s{self.stride}]"
                f"/{self.dtype}/{self.quant}{split}")


def key_from_context(context: dict) -> DispatchKey | None:
    """The key of an ``ops`` hook context; None without its geometry."""
    op, shape, m = context.get("op"), context.get("shape"), context.get("m")
    if op is None or shape is None or len(shape) != 4 or m is None:
        return None
    if op == "deform_conv_chain":
        dtype, quant = "int8", "int8_chain"
    elif context.get("precision", "fp32") == "int8":
        dtype, quant = "int8", "int8"
    else:
        dtype = "bf16" if context.get("itemsize", 4) == 2 else "fp32"
        quant = "none"
    return DispatchKey(op=op, shape=tuple(int(s) for s in shape), m=int(m),
                       stride=int(context.get("stride", 1)), dtype=dtype,
                       quant=quant,
                       shards=tuple(context.get("shards", (1, 1))))


def price_dispatch(context: dict) -> dict | None:
    """``{"tiles", "bytes", "ops", "bound_s", "bound_by",
    "traffic_bytes"}`` of the dispatch an ``ops`` hook context describes
    (``context["objective"] == "training"``: its forward and backward
    kernels, 1a then 2): the bound's work, and the bytes its launches
    load and store at its tiles (``_traffic_bytes``; at least the work's
    ``bytes``).  None when the context cannot be priced: observability
    never raises into the dispatch path."""
    try:
        import torch

        from repro_torch.core import h100
        from repro_torch.kernels.plan import resolve_tiles_and_source

        key = key_from_context(context)
        if key.op == "dcnv3":
            return _price_dcnv3(context, key)
        # A mesh call runs every shard's kernels at its block's shape (on
        # a mesh that repeats a device, all of them on that device), so it
        # is priced as the sum of the shards' work.
        nb, ns = key.shards[:2]
        n, h, w, c = key.shape
        n, h = n // nb, h // ns
        geom = dict(kernel_size=context.get("kernel_size", 3),
                    stride=key.stride, dilation=context.get("dilation", 1))
        bound = context["offset_bound"]
        itemsize = context.get("itemsize", 4)
        explicit = dict(zip(("tile_h", "tile_w", "tile_c", "tile_m"),
                            context.get("tiles") or (None,) * 4))
        training = context.get("objective") == "training"
        if key.quant != "none":
            datapath = key.quant
        elif context.get("dataflow") == "banded":
            datapath = "banded"
        else:
            datapath = "fp32_bwd" if training else "fp32"
        device = torch.device(context.get("device", "cpu"))
        if datapath == "banded" and explicit["tile_h"] is None:
            from repro_torch.core.tiling import BANDED_TILE_H
            explicit["tile_h"] = BANDED_TILE_H
        # The dispatcher's tiles, without counting a resolution.
        tiles, _ = resolve_tiles_and_source(
            n, h, w, c, key.m, offset_bound=bound, dtype=datapath,
            itemsize=itemsize, device=device, count=False, **geom,
            **explicit)
        if key.quant != "none":
            work = h100.int8_work(n, h, w, c, key.m,
                                  chain=key.quant == "int8_chain",
                                  emit=context.get("emit", "fp32"), **geom)
        else:
            sizes = dict(itemsize=itemsize,
                         offset_itemsize=context.get("offset_itemsize"))
            if datapath == "banded":
                work = h100.banded_work(n, h, w, c, key.m,
                                        offset_bound=bound, tile_h=tiles[0],
                                        **geom, **sizes)
            elif training:
                work = h100.training_work(n, h, w, c, key.m, **geom, **sizes)
            else:
                work = h100.forward_work(n, h, w, c, key.m, **geom, **sizes)
        traffic = _traffic_bytes(context, key, datapath, tiles,
                                 n=n, h=h, w=w, c=c, training=training)
        if nb * ns > 1:
            work = h100.total([(work, nb * ns)])
        return dict(work, tiles=list(tiles), traffic_bytes=traffic)
    except Exception:  # noqa: BLE001 — a pricing failure is not a fault
        _log.debug("cannot price dispatch %r", context, exc_info=True)
        return None


def _price_dcnv3(context: dict, key: DispatchKey) -> dict:
    """``price_dispatch`` of an ``ops.dcnv3`` call: ``core.h100``'s
    ``dcnv3_work``, the kernel's tiles and its blocks' bytes
    (``kernels.dcnv3.traffic_bytes``)."""
    from repro_torch.core import h100
    from repro_torch.kernels import dcnv3
    n, h, w, c = key.shape
    g, k = context["groups"], context.get("kernel_size", 3)
    work = h100.dcnv3_work(n, h, w, c, g, k)
    return dict(work, tiles=list(dcnv3.tiles(h, w, g)),
                traffic_bytes=dcnv3.traffic_bytes(
                    n, h, w, c, g, kernel_size=k,
                    offset_bound=context["offset_bound"]))


def _traffic_bytes(context: dict, key: DispatchKey, datapath: str,
                   tiles, *, n: int, h: int, w: int, c: int,
                   training: bool) -> int:
    """The bytes the dispatch's kernel launches load and store at its
    tiles (``core.tiling``'s traffic model): every shard's call, and on a
    height split each shard's received halo rows."""
    from repro_torch.core import tiling as T
    nb, ns = key.shards[:2]
    geom = dict(kernel_size=context.get("kernel_size", 3), stride=key.stride,
                offset_bound=context["offset_bound"])
    shape = T.LayerShape(h=h, w=w, c_in=c, c_out=key.m, **geom)
    kt = T.KernelTiles(*tiles)
    itemsize = 1 if key.quant != "none" else context.get("itemsize", 4)
    kw = dict(batch=n, dilation=context.get("dilation", 1),
              bytes_per_elem=itemsize)
    if key.quant == "int8_chain":
        one = T.dcl_total_hbm_bytes(
            shape, kt, fused_offsets=True,
            out_bytes_per_elem=1 if context.get("emit") == "int8" else 4,
            **kw)
    elif training:
        # The forward runs at its own tiles, the backward at ``tiles``.
        from repro_torch.kernels.plan import resolve_tiles_and_source
        fwd, _ = resolve_tiles_and_source(
            n, h, w, c, key.m, dilation=kw["dilation"], dtype="fp32",
            itemsize=itemsize, device=context.get("device", "cpu"),
            count=False, **geom)
        one = T.dcl_train_hbm_bytes(shape, T.KernelTiles(*fwd),
                                    bwd_tiles=kt, **kw)
    else:
        one = T.dcl_total_hbm_bytes(
            shape, kt, offset_bytes_per_elem=None if key.quant != "none"
            else context.get("offset_itemsize"),
            dataflow="materialized_band" if datapath == "banded"
            else "zero_copy", **kw)
    halo = T.spatial_halo_bytes(
        dataclasses.replace(shape, h=h * ns), shards=ns,
        dilation=kw["dilation"], bytes_per_elem=itemsize)
    return nb * ns * (one + halo)


def modeled_dispatch_bytes(context: dict) -> int | None:
    """The bytes one dispatch must move (each input read once, each
    output written once), or None."""
    price = price_dispatch(context)
    return None if price is None else int(price["bytes"])


def modeled_bound_ms(context: dict) -> float | None:
    """The least time (ms) the H100 could take for one dispatch, or
    None."""
    price = price_dispatch(context)
    return None if price is None else price["bound_s"] * 1e3


class DivergenceTracker:
    """Measured seconds against the model, per ``DispatchKey``
    (``observe``), and named ratio pairs (``record_pair``, flagged
    ``anomalous`` where the model predicts a gain the measurement
    inverts)."""

    def __init__(self):
        self._agg: dict[DispatchKey, dict] = {}
        self.pairs: list[dict] = []

    def observe(self, key: DispatchKey, price: dict | None,
                measured_s: float, *, clock: str = "host") -> None:
        """One dispatch of ``key``: its ``price_dispatch`` (or None) and
        its measured seconds, on the ``"device"`` or ``"host"`` clock."""
        a = self._agg.get(key)
        if a is None:
            a = self._agg[key] = {"n": 0, "sum_s": 0.0,
                                  "min_s": float("inf"), "price": price,
                                  "clock": clock}
        a["n"] += 1
        a["sum_s"] += measured_s
        a["min_s"] = min(a["min_s"], measured_s)
        if a["price"] is None:
            a["price"] = price

    def price(self, key: DispatchKey) -> dict | None:
        """The price observed with ``key`` so far (None if none)."""
        a = self._agg.get(key)
        return None if a is None else a["price"]

    def record_pair(self, name: str, *, modeled_ratio: float,
                    measured_ratio: float, note: str = "") -> dict:
        rec = {
            "name": name,
            "modeled_ratio": modeled_ratio,
            "measured_ratio": measured_ratio,
            "divergence": (modeled_ratio / measured_ratio
                           if measured_ratio else float("inf")),
            "anomalous": bool(modeled_ratio > 1.0 > measured_ratio),
        }
        if note:
            rec["note"] = note
        self.pairs.append(rec)
        return rec

    def annotate_pair(self, name: str, **fields) -> dict | None:
        """Add fields to the last pair named ``name``; None if none."""
        for rec in reversed(self.pairs):
            if rec.get("name") == name:
                rec.update(fields)
                return rec
        return None

    def report(self) -> dict:
        rows = []
        for key, a in self._agg.items():
            price = a["price"] or {}
            best = a["min_s"]
            bound = price.get("bound_s")
            nbytes = price.get("bytes")
            rows.append({
                "key": key.label(), "op": key.op, "shape": list(key.shape),
                "m": key.m, "stride": key.stride, "dtype": key.dtype,
                "quant": key.quant, "n": a["n"],
                "clock": a["clock"], "tiles": price.get("tiles"),
                "modeled_bytes": nbytes, "modeled_ops": price.get("ops"),
                "traffic_bytes": price.get("traffic_bytes"),
                "bound_s": bound, "bound_by": price.get("bound_by"),
                "best_s": best, "mean_s": a["sum_s"] / a["n"],
                "share": bound / best if bound and best > 0 else None,
                "implied_gbps": (nbytes / best / 1e9
                                 if nbytes and best > 0 else None),
            })
        rows.sort(key=lambda r: r["key"])
        return {"dispatches": rows, "pairs": list(self.pairs)}


class DispatchRecorder:
    """``ops`` dispatch hook: time every bounded dispatch into the
    registry (``kernel_dispatch_seconds``, ``kernel_dispatch_total``), a
    ``kernel/dispatch`` span and the tracker.  See the module docstring
    for the clocks; on CUDA without ``block`` call ``flush`` once the
    dispatches' outputs have been synchronised, and the events go on the
    stream current at the first dispatch (one recorder a forward, as the
    serving engine makes them).  ``tracer=None`` resolves the
    process-wide tracer at each call."""

    def __init__(self, *, registry: _metrics.MetricsRegistry | None = None,
                 tracer: _trace.Tracer | None = None,
                 tracker: DivergenceTracker | None = None,
                 next_hook=None, clock=time.monotonic, block: bool = False):
        self.registry = registry if registry is not None \
            else _metrics.get_registry()
        self._tracer = tracer
        self.tracker = tracker
        self.next_hook = next_hook
        self.clock = clock
        self.block = block
        self._hist = self.registry.histogram(
            "kernel_dispatch_seconds",
            "time of one bounded-kernel dispatch (on CUDA the stream's "
            "time between two events, host gaps included; else host)")
        self._total = self.registry.counter(
            "kernel_dispatch_total", "bounded-kernel dispatches by outcome")
        self._pending: list[tuple] = []
        self._stream = None

    def __call__(self, context: dict):
        if self.next_hook is not None:
            self.next_hook(context)     # chaos first: a raise aborts here
        key = key_from_context(context)
        labels = dict(op=str(context.get("op", "?")),
                      quant=key.quant if key is not None else "?")
        tracer = self._tracer if self._tracer is not None \
            else _trace.get_tracer()
        span = tracer.span("kernel/dispatch", shape=context.get("shape"),
                           **labels).start()
        cuda = context.get("device") == "cuda"
        events = None
        if cuda and not self.block:
            import torch
            if self._stream is None:
                # Looked up once: ``Event.record()`` without a stream
                # resolves the current device and stream on every call.
                self._stream = torch.cuda.current_stream()
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            events[0].record(self._stream)
        t0 = self.clock()

        def finish(out=None, error=None) -> None:
            if events is not None and error is None:
                events[1].record(self._stream)
                span.end()
                self._pending.append((key, context, labels, span, events))
                return
            if cuda and self.block and error is None:
                import torch
                torch.cuda.synchronize()
            self._close(key, context, labels, span, self.clock() - t0,
                        error, "host")

        return finish

    def _close(self, key, context, labels, span, seconds, error, clock):
        outcome = "ok" if error is None else "error"
        span.set_attr(outcome=outcome, seconds=seconds, clock=clock)
        if error is not None:
            span.set_attr(error=f"{type(error).__name__}: {error}")
        span.end()
        self._hist.observe(seconds, **labels)
        self._total.inc(outcome=outcome, **labels)
        if self.tracker is not None and key is not None and error is None:
            price = self.tracker.price(key) or price_dispatch(context)
            self.tracker.observe(key, price, seconds, clock=clock)

    def flush(self) -> int:
        """Read the CUDA events of the dispatches since the last flush
        (waiting for the last of them, which the caller's own
        synchronisation has normally passed); returns how many."""
        pending, self._pending = self._pending, []
        if not pending:
            return 0
        try:
            pending[-1][-1][1].synchronize()
            times = [ev[0].elapsed_time(ev[1]) / 1e3
                     for *_, ev in pending]
        except RuntimeError as e:     # a failed device: nothing to read
            _log.warning("dropping %d dispatch timings: %s", len(pending),
                         e)
            return 0
        for (key, context, labels, span, _), seconds in zip(pending, times):
            self._close(key, context, labels, span, seconds, None, "device")
        return len(pending)
