"""Post-training calibration: observers and a ResNet-DCN sweep
(counterpart of ``repro.quant.calibrate``).

A sweep runs a few batches through the fp32 model
(``models.resnet_dcn.forward`` with its ``tap`` hook) and feeds every DCL
input and output activation into observers.  It emits a scale table in
the JAX package's format, so a table written by either package loads in
the other:

    {block_name: {"x_scale": float,            # per-tensor activation
                  "w_scale": [float, ...],     # per-out-channel weights
                  "w_offset_scale": [...],     # per-channel offset-conv w
                  "y_scale": float},           # per-tensor DCL output
     "_meta": {"observer": ..., "percentile": ..., "batches": ...}}

``x_scale``/``w_scale`` feed the ``int8`` rung, ``w_offset_scale`` the
fused offset conv of the ``int8_chain`` rung, and ``y_scale`` pins its
int8 emission grid.  Weight scales are exact per-channel absmax.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Callable, Iterable, Mapping

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.quant.qtypes import EPS, QMAX, compute_scale

_RESERVOIR = 1 << 15     # per-update subsample cap of the percentile observer


class AbsMaxObserver:
    """Running absolute maximum -> symmetric scale."""

    def __init__(self) -> None:
        self.amax = 0.0
        self.updates = 0

    def update(self, x) -> None:
        self.amax = max(self.amax, float(torch.as_tensor(x).abs().max()))
        self.updates += 1

    def scale(self) -> float:
        return max(self.amax, EPS) / QMAX


class PercentileObserver:
    """p-th percentile of |x| over the sweep -> symmetric scale, from a
    deterministic strided subsample of each update (at most
    ``_RESERVOIR`` values), so memory stays bounded."""

    def __init__(self, percentile: float = 99.9) -> None:
        if not 0.0 < percentile <= 100.0:
            raise ValueError(f"percentile must lie in (0, 100] "
                             f"(got {percentile})")
        self.percentile = percentile
        self.samples: list[np.ndarray] = []
        self.updates = 0

    def update(self, x) -> None:
        a = torch.as_tensor(x).detach().float().abs().reshape(-1)
        stride = max(1, a.numel() // _RESERVOIR)
        self.samples.append(a[::stride].cpu().numpy())
        self.updates += 1

    def scale(self) -> float:
        if not self.samples:
            return EPS / QMAX
        v = float(np.percentile(np.concatenate(self.samples),
                                self.percentile))
        return max(v, EPS) / QMAX


def make_observer(kind: str, *, percentile: float = 99.9):
    if kind == "absmax":
        return AbsMaxObserver()
    if kind == "percentile":
        return PercentileObserver(percentile)
    raise ValueError(f"unknown observer {kind!r}; expected 'absmax' or "
                     f"'percentile'")


def weight_channel_scales(w) -> np.ndarray:
    """Exact per-output-channel absmax scales of (..., M) weights."""
    return compute_scale(torch.as_tensor(w), axis=-1).reshape(-1) \
        .cpu().numpy()


def calibrate_resnet_dcn(params: Mapping[str, Any], cfg, batches: Iterable,
                         *, observer: str = "absmax",
                         percentile: float = 99.9,
                         forward: Callable | None = None,
                         device: str | torch.device | None = None) -> dict:
    """Sweep calibration batches through the fp32 model on ``device``
    (default ``cuda``) and emit the scale table of every DCL block.

    ``batches`` yields image arrays (N, H, W, 3) or dicts with an
    ``"images"`` key.  The sweep runs the fp32 semantics whatever
    ``cfg.quant`` says (with ``cfg.use_kernel``, through the fp32 kernel).
    """
    from repro_torch.models import resnet_dcn as R

    dev = resolve_device(device)
    fwd = forward or R.forward
    cfg_fp = dataclasses.replace(cfg, quant="none")
    obs: dict[str, Any] = {}

    def tap(name: str, x) -> None:
        if name not in obs:
            obs[name] = make_observer(observer, percentile=percentile)
        obs[name].update(x)

    n_batches = 0
    with torch.no_grad():
        for batch in batches:
            images = batch["images"] if isinstance(batch, Mapping) else batch
            images = torch.as_tensor(np.asarray(images, np.float32)).to(dev)
            fwd(params, cfg_fp, images, tap=tap, device=dev)
            n_batches += 1
    if not obs:
        raise ValueError(
            "calibration sweep saw no DCL activations — does the config "
            f"have num_dcn > 0 (got cfg={cfg})?")

    table: dict[str, dict] = {}
    for name, o in sorted(obs.items()):
        if name.endswith("/out"):
            continue                    # folded into y_scale below
        dcl = params[name]["dcl"]
        table[name] = {
            "x_scale": float(o.scale()),
            "w_scale": [float(s) for s in
                        weight_channel_scales(dcl["w_deform"])],
            "w_offset_scale": [float(s) for s in
                               weight_channel_scales(dcl["w_offset"])],
        }
        if f"{name}/out" in obs:
            table[name]["y_scale"] = float(obs[f"{name}/out"].scale())
    table["_meta"] = {"observer": observer, "percentile": percentile,
                      "batches": n_batches}
    return table


def scale_table_on(table: Mapping[str, Any], device) -> dict:
    """The table's scales as fp32 tensors on ``device`` (``_meta``
    dropped).  A forward handed this reads its scales without a
    host-to-device copy per layer: a copy from pageable host memory
    waits for the stream to drain, several times per DCL."""
    return {name: {key: torch.as_tensor(v, dtype=torch.float32,
                                        device=device)
                   for key, v in entry.items()}
            for name, entry in table.items() if name != "_meta"}


def save_scale_table(table: Mapping[str, Any], path: str) -> None:
    with open(path, "w") as f:
        json.dump(table, f, indent=2, sort_keys=True)


def load_scale_table(path: str) -> dict:
    with open(path) as f:
        return json.load(f)
