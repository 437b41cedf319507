"""Measured-time autotuner of the DCL kernels' tiles (counterpart of
``repro.tune.autotune``).

The chooser of ``core.tiling`` picks tiles from a model of shared memory
and wave fill; this module measures.  For one layer shape and datapath
it times the chooser's pick and its neighbours
(``tiling.neighbor_kernel_tiles``) and writes the winner to a
``TileCache`` that ``kernels.plan.resolve_tiles`` consults.

* ``objective="forward"`` times ``ops.deform_conv`` (``"fp32"`` kernel
  1a, ``"int8"`` kernel 1c) and ``ops.deform_conv_chain`` (``"int8_chain"``,
  kernel 1d), the serving datapaths; by default it sweeps all three.
* ``objective="training"`` times a forward and backward through
  ``ops.BoundedDeformConv``: kernel 1a at its own tiles, kernel 2 at the
  candidate's (``DCSpec.bwd_tiles``).  The entry sets the backward's
  tiles (``resolve_tiles(dtype="fp32_bwd")``).

Each candidate (all of them pass ``tiling.tiles_fit``) runs at explicit
tiles under ``tile_cache_scope(None)``, so an installed cache never
stands in for its own baseline; one untimed
call first (the first of a shape also builds the kernel), then the best
of ``reps`` through a private ``obs.DispatchRecorder(block=True)``: the
wall time of a call.  JAX also sweeps ``cores`` and
``dw_flush_every_step``; neither has a counterpart here, so each entry
records them at their fixed values.  A candidate that raises is a fault,
not an infeasible tile: the result counts the candidates given
(``n_given``) and measured (``n_candidates``) and lists each failure
(``failed``), and the tuner logs it as a warning.  On the CPU the tuner
runs the plain versions and keys its entries ``cpu``.
"""
from __future__ import annotations

import time

import torch

from .cache import TileCache, _log, platform_of, tile_cache_scope

_QUANT_MODES = (None, "int8", "int8_chain")


def measure_best_of(fn, args, *, context: dict, reps: int = 3) -> float:
    """Best-of-``reps`` wall seconds of ``fn(*args)`` through a private
    ``DispatchRecorder(block=True)`` (nothing reaches a shared registry),
    after one untimed call.  ``context`` is an ``ops``-style hook context:
    it keys the recorder's row as a dispatch's would."""
    from repro_torch.obs import (DispatchRecorder, DivergenceTracker,
                                 MetricsRegistry)
    tracker = DivergenceTracker()
    rec = DispatchRecorder(registry=MetricsRegistry(), tracker=tracker,
                           clock=time.perf_counter, block=True)
    fn(*args)
    if context.get("device") == "cuda":
        torch.cuda.synchronize()
    for _ in range(max(1, int(reps))):
        finish = rec(context)
        finish(out=fn(*args))
    return min(r["best_s"] for r in tracker.report()["dispatches"])


def _traffic_key(shape, kt, *, batch: int, dilation: int, objective: str,
                 dtype: str | None, fwd_tiles=None) -> int:
    """The bytes one candidate's launches move (``core.tiling``'s traffic
    model; JAX's ``_traffic_key``): ``"training"`` the forward at
    ``fwd_tiles`` and kernel 2 at the candidate, else the forward datapath
    the tuner times (1a; 1c; 1d emitting fp32)."""
    from repro_torch.core.tiling import (dcl_total_hbm_bytes,
                                         dcl_train_hbm_bytes)
    kw = dict(batch=batch, dilation=dilation)
    if objective == "training":
        return dcl_train_hbm_bytes(shape, fwd_tiles, bwd_tiles=kt, **kw)
    if dtype in ("int8", "int8_chain"):
        return dcl_total_hbm_bytes(shape, kt, bytes_per_elem=1,
                                   fused_offsets=dtype == "int8_chain",
                                   out_bytes_per_elem=4, **kw)
    return dcl_total_hbm_bytes(shape, kt, **kw)


def _cap_candidates(cands: list, max_candidates: int | None,
                    traffic) -> list:
    """The seed and an even-stride sample of the rest ordered by
    ``traffic`` (a candidate's modeled bytes; JAX's ``_cap_candidates``):
    the sample spans the model's range, and measurement decides."""
    if max_candidates is None or len(cands) <= max_candidates:
        return cands
    k = max(0, int(max_candidates) - 1)
    if k == 0:
        return cands[:1]
    rest = sorted(cands[1:], key=traffic)
    idxs = sorted({round(i * (len(rest) - 1) / max(k - 1, 1))
                   for i in range(k)})
    return [cands[0]] + [rest[i] for i in idxs]


def _tune_single(*, h: int, w: int, c: int, m: int, batch: int = 1,
                 kernel_size: int = 3, stride: int = 1, dilation: int = 1,
                 offset_bound: float = 2.0, objective: str = "training",
                 dtype: str | None = None, reps: int = 3,
                 max_candidates: int | None = 12,
                 cache: TileCache | None = None, rng_seed: int = 0,
                 device: str | torch.device | None = None) -> dict:
    """Tune one (shape, objective, datapath): the body of
    ``tune_deform_conv``."""
    from repro_torch.core.tiling import (LayerShape, choose_kernel_tiles,
                                         neighbor_kernel_tiles, out_hw)
    from repro_torch.device import resolve_device
    from repro_torch.kernels import ops
    from repro_torch.kernels.plan import DCSpec
    from repro_torch.quant.qtypes import compute_scale

    if objective not in ("forward", "training"):
        raise ValueError(f"unknown objective {objective!r}")
    if dtype in ("int8", "int8_chain") and objective == "training":
        raise ValueError(f"dtype={dtype!r} tunes the inference datapath "
                         f"— use objective='forward'")
    dev = resolve_device(device)
    plat = platform_of(dev)
    chooser = "fp32_bwd" if objective == "training" else (dtype or "fp32")
    geom = dict(kernel_size=kernel_size, stride=stride, dilation=dilation,
                offset_bound=offset_bound)
    k2 = kernel_size * kernel_size
    ho, wo = out_hw(h, w, kernel_size=kernel_size, stride=stride,
                    dilation=dilation)
    gen = torch.Generator().manual_seed(rng_seed)
    x = torch.randn(batch, h, w, c, generator=gen).to(dev)
    offs = (offset_bound * (2 * torch.rand(batch, ho, wo, 2 * k2,
                                           generator=gen) - 1)).to(dev)
    wgt = (torch.randn(k2, c, m, generator=gen) * 0.1).to(dev)
    op = "deform_conv_chain" if dtype == "int8_chain" else "deform_conv"

    if dtype == "int8_chain":
        w_off = (torch.randn(k2, c, 2 * k2, generator=gen) * 0.05).to(dev)
        b_off = torch.zeros(2 * k2, device=dev)
        x_scale = compute_scale(x)

        def run(kt):
            with torch.no_grad():
                return ops.deform_conv_chain(
                    x, wgt, w_off, b_off, x_scale=x_scale, emit="fp32",
                    tile_h=kt.tile_h, tile_w=kt.tile_w, tile_c=kt.tile_c,
                    tile_m=kt.tile_m, device=dev, **geom)
    elif objective == "forward":
        def run(kt):
            with torch.no_grad():
                return ops.deform_conv(
                    x, offs, wgt, precision=dtype or "fp32",
                    tile_h=kt.tile_h, tile_w=kt.tile_w, tile_c=kt.tile_c,
                    tile_m=kt.tile_m, device=dev, **geom)
    else:
        leaves = [t.clone().requires_grad_(True) for t in (x, offs, wgt)]

        def run(kt):
            spec = DCSpec(**geom, bwd_tiles=(kt.tile_h, kt.tile_w,
                                             kt.tile_c))
            y = ops.BoundedDeformConv.apply(spec, *leaves)
            return torch.autograd.grad(y.sum(), leaves)

    def context(kt):
        return dict(op=op, precision=dtype if dtype == "int8" else "fp32",
                    dataflow="zero_copy", shape=tuple(x.shape), m=m,
                    device=dev.type, itemsize=4, objective=objective,
                    emit="fp32",
                    tiles=(kt.tile_h, kt.tile_w, kt.tile_c, kt.tile_m),
                    **geom)

    seed = choose_kernel_tiles(batch, h, w, c, m, dtype=chooser, **geom)
    shape = LayerShape(h=h, w=w, c_in=c, c_out=m, kernel_size=kernel_size,
                       stride=stride, offset_bound=offset_bound)
    fwd = choose_kernel_tiles(batch, h, w, c, m, dtype="fp32", **geom) \
        if objective == "training" else None
    cands = _cap_candidates(
        neighbor_kernel_tiles(batch, h, w, c, m, seed, dtype=chooser,
                              **geom), max_candidates,
        lambda kt: _traffic_key(shape, kt, batch=batch, dilation=dilation,
                                objective=objective, dtype=dtype,
                                fwd_tiles=fwd))
    best, analytic_us, measured, failed = None, None, 0, []
    with tile_cache_scope(None):        # the baseline stays analytic
        for kt in cands:
            try:
                s = measure_best_of(lambda kt=kt: run(kt), (),
                                    context=context(kt), reps=reps)
            except (RuntimeError, ValueError) as e:
                # Every candidate passed tiling.tiles_fit, so a failure is
                # a kernel or mirror fault: kept in the result (the seed's
                # is fatal below) and logged as a warning.
                failed.append({"tiles": [kt.tile_h, kt.tile_w, kt.tile_c,
                                         kt.tile_m],
                               "error": f"{type(e).__name__}: {e}"})
                _log.warning("tune: candidate %s failed (%s: %s)", kt,
                             type(e).__name__, e)
                continue
            measured += 1
            if kt == cands[0]:
                analytic_us = s * 1e6
            if best is None or s < best[1]:
                best = (kt, s)
    if best is None or analytic_us is None:
        raise RuntimeError(
            f"autotuner could not measure the chooser's tiles for "
            f"{batch}x{h}x{w}x{c}->{m} ({objective}, {dtype or 'fp32'})")
    kt, s = best
    tiles = [kt.tile_h, kt.tile_w, kt.tile_c, kt.tile_m]
    analytic = [seed.tile_h, seed.tile_w, seed.tile_c, seed.tile_m]
    result = {
        "op": op, "h": h, "w": w, "c": c, "m": m, "batch": batch,
        "kernel_size": kernel_size, "stride": stride, "dilation": dilation,
        "offset_bound": offset_bound, "objective": objective,
        "dtype": dtype, "platform": plat, "reps": reps,
        "n_candidates": measured, "n_given": len(cands),
        "failed": failed,
        "analytic": {"tiles": analytic, "cores": 1, "us": analytic_us},
        "best": {"tiles": tiles, "cores": 1, "dw_flush_every_step": None,
                 "us": s * 1e6},
        "tuned_vs_analytic_ratio": analytic_us / (s * 1e6),
    }
    if cache is not None:
        cache.put({"tiles": tiles, "dw_flush_every_step": None, "cores": 1,
                   "recommended_cores": 1, "measured_us": s * 1e6,
                   "analytic_us": analytic_us, "analytic_tiles": analytic,
                   "batch": batch, "reps": reps, "op": op},
                  n=batch, h=h, w=w, c=c, m=m, objective=objective,
                  dtype=dtype, platform=plat, **geom)
    return result


def tune_deform_conv(*, h: int, w: int, c: int, m: int, batch: int = 1,
                     kernel_size: int = 3, stride: int = 1,
                     dilation: int = 1, offset_bound: float = 2.0,
                     objective: str = "training", dtype: str | None = None,
                     sweep_quant: tuple | None = None, reps: int = 3,
                     max_candidates: int | None = 12,
                     cache: TileCache | None = None, rng_seed: int = 0,
                     device: str | torch.device | None = None) -> dict:
    """Tune one deform_conv shape on ``device`` (default ``cuda``); returns
    the record of ``dtype`` and, given a ``cache``, writes one entry per
    swept datapath, keyed by the batch and ``device``'s platform.

    ``objective="forward"`` sweeps ``dtype`` plus ``"int8"`` and
    ``"int8_chain"`` by default (``sweep_quant`` narrows it, a subset of
    ``(None, "int8", "int8_chain")``), their records under
    ``result["quant_sweep"]``; ``"training"`` tunes the fp32 backward
    only."""
    if objective not in ("forward", "training"):
        raise ValueError(f"unknown objective {objective!r}")
    if sweep_quant is None:
        sweep_quant = (dtype, "int8", "int8_chain") \
            if objective == "forward" else (dtype,)
    modes: list = []
    for dt in (dtype, *sweep_quant):
        if dt not in _QUANT_MODES:
            raise ValueError(
                f"unknown quant mode {dt!r} in sweep_quant; expected a "
                f"subset of {_QUANT_MODES}")
        if dt not in modes:
            modes.append(dt)
    kw = dict(h=h, w=w, c=c, m=m, batch=batch, kernel_size=kernel_size,
              stride=stride, dilation=dilation, offset_bound=offset_bound,
              objective=objective, reps=reps, max_candidates=max_candidates,
              cache=cache, rng_seed=rng_seed, device=device)
    results = {dt or "fp32": _tune_single(dtype=dt, **kw) for dt in modes}
    primary = results[dtype or "fp32"]
    extras = {k: v for k, v in results.items() if v is not primary}
    if extras:
        primary["quant_sweep"] = extras
    return primary
