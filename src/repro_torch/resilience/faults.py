"""Chaos harness: seeded, composable fault injectors (counterpart of
``repro.resilience.faults``; the same kinds, plans and seams).

Trainer kinds, through the Trainer's ``fault_hook`` / ``batch_hook``:

* ``nonfinite_grads`` — the batch's float leaves become NaN (integer
  labels stay); the Trainer's sentinel must skip the step;
* ``step_crash`` — the step raises ``DeviceLost``; the Trainer restores
  the last checkpoint and replays;
* ``ckpt_corrupt`` — the latest complete checkpoint is corrupted
  (``corrupt_checkpoint``) and the device is lost in the same event;
  the restore must verify and fall back to the previous complete step;
* ``data_hiccup`` — the input pipeline raises ``DataPipelineHiccup``
  once;
* ``dispatch_fault`` — the ``ops`` dispatch hook raises
  ``KernelDispatchFault``.  JAX degrades such a call to its reference
  path.  The port's ``ops`` has no fallback: the fault reaches the
  serving engine, which replays the batch on its rung and, past
  ``max_retries``, drops a rung on the CPU only; on CUDA the batch
  retires ``failed``.  So on the card a one-shot fault ends ``ok`` after
  a same-rung retry, and never on the plain path.

Serving kinds, through the DCL engine's ``step_hook`` / ``admit_hook``:
``slow_step`` (one engine step stalls ``mode`` seconds, default 0.05),
``malformed_request`` (the image becomes a rank-1 plane) and
``bucket_miss_storm`` (``mode`` requests, default 3, go to a resolution
no bucket matches).

Every injector fires once, so a replay cannot loop on its own fault, and
``FaultPlan.random`` draws a whole schedule from one seed with numpy's
``default_rng``, as JAX does: the same seed gives the same schedule in
both packages.
"""
from __future__ import annotations

import dataclasses
import pathlib
import time
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.obs.metrics import dump_telemetry

__all__ = [
    "FAULT_KINDS", "FaultInjected", "DeviceLost", "DataPipelineHiccup",
    "KernelDispatchFault", "FaultEvent", "FaultPlan", "ChaosHooks",
    "corrupt_checkpoint", "dump_telemetry",
]

FAULT_KINDS = ("nonfinite_grads", "step_crash", "ckpt_corrupt",
               "data_hiccup", "dispatch_fault",
               # serve-time kinds (DCL serving engine seams)
               "slow_step", "malformed_request", "bucket_miss_storm")


class FaultInjected(RuntimeError):
    """Marker base: this failure came from the chaos harness."""


class DeviceLost(FaultInjected):
    """Injected device loss: the step raises mid-flight."""


class DataPipelineHiccup(FaultInjected):
    """Injected transient input-pipeline failure."""


class KernelDispatchFault(FaultInjected):
    """Injected kernel-dispatch failure (the dispatch-hook seam)."""


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault: fire ``kind`` when the run reaches ``step``."""
    step: int
    kind: str
    mode: str = ""          # injector detail (e.g. corruption mode)

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; expected one of "
                f"{FAULT_KINDS}")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A reproducible fault schedule: (seed, events)."""
    events: tuple[FaultEvent, ...] = ()
    seed: int | None = None

    @classmethod
    def random(cls, seed: int, *, total_steps: int,
               kinds: Sequence[str] = ("nonfinite_grads", "ckpt_corrupt",
                                       "step_crash", "data_hiccup"),
               min_step: int = 1) -> "FaultPlan":
        """One event per kind, each at a random step inside its own window
        of ``[min_step, total_steps)``, the kinds in their listed order
        (so a corruption comes before the crash that needs it)."""
        if total_steps - min_step < len(kinds):
            raise ValueError(
                f"total_steps={total_steps} leaves fewer than "
                f"{len(kinds)} steps after min_step={min_step} — one "
                f"window per fault kind is needed")
        rng = np.random.default_rng(seed)
        span = total_steps - min_step
        events = []
        for i, kind in enumerate(kinds):
            lo = min_step + (i * span) // len(kinds)
            hi = min_step + ((i + 1) * span) // len(kinds)
            step = int(rng.integers(lo, max(hi, lo + 1)))
            mode = ""
            if kind == "ckpt_corrupt":
                mode = str(rng.choice(["truncate_leaf", "bad_manifest"]))
            events.append(FaultEvent(step=step, kind=kind, mode=mode))
        return cls(events=tuple(events), seed=seed)

    def at(self, step: int) -> list[tuple[int, FaultEvent]]:
        """(index, event) pairs scheduled for ``step``."""
        return [(i, e) for i, e in enumerate(self.events) if e.step == step]

    def kinds(self) -> set[str]:
        return {e.kind for e in self.events}

    def summary(self) -> dict:
        return {"seed": self.seed,
                "events": [dataclasses.asdict(e) for e in self.events]}


def corrupt_checkpoint(directory, *, step: int | None = None,
                       mode: str = "truncate_leaf") -> pathlib.Path:
    """Corrupt one complete checkpoint in ``directory`` (the latest when
    ``step`` is None) as a crash mid-write or bit-rot would:
    ``truncate_leaf`` halves the first leaf file, ``bad_manifest``
    overwrites ``manifest.json`` with junk.  The layout is JAX's, so this
    corrupts a checkpoint of either package the same way.  Returns the
    corrupted checkpoint's path."""
    from repro_torch.checkpoint.checkpoint import complete_steps

    directory = pathlib.Path(directory)
    if step is None:
        steps = complete_steps(directory)
        if not steps:
            raise FileNotFoundError(f"no complete checkpoint in {directory}")
        step = steps[0]
    path = directory / f"step_{step:08d}"
    if mode == "bad_manifest":
        (path / "manifest.json").write_text("{not json")
    elif mode == "truncate_leaf":
        leaf = path / "000.npy"
        data = leaf.read_bytes()
        leaf.write_bytes(data[: max(1, len(data) // 2)])
    else:
        raise ValueError(
            f"unknown corruption mode {mode!r}; expected 'truncate_leaf' "
            f"or 'bad_manifest'")
    return path


def _poison(x):
    """A float leaf as NaN (``torch.full_like``); other leaves as they
    are."""
    t = torch.as_tensor(x)
    return torch.full_like(t, float("nan")) if t.is_floating_point() else x


class ChaosHooks:
    """Bind a ``FaultPlan`` to the runtime seams:

    * ``fault_hook(step)`` -> ``Trainer(fault_hook=...)``: raises for
      ``step_crash`` / ``data_hiccup``; for ``ckpt_corrupt`` corrupts the
      latest complete checkpoint and raises ``DeviceLost``;
    * ``batch_hook(step, batch)`` -> ``Trainer(batch_hook=...)``: NaN in
      the float leaves for ``nonfinite_grads``;
    * ``dispatch_hook(context)`` -> ``ops.dispatch_hook_scope``: raises
      ``KernelDispatchFault`` once per ``dispatch_fault`` event (consumed
      per call: the dispatcher has no step counter);
    * ``serve_step_hook(step, ctx)`` -> ``DCLServingEngine(step_hook=...)``:
      stalls ``slow_step`` events through ``sleep`` (point it at a fake
      clock's ``advance`` for a deterministic stall);
    * ``admit_hook(request)`` -> ``DCLServingEngine(admit_hook=...)``:
      corrupts submitted requests, the admission events in plan order.

    ``fired`` records every injection; each is also a ``fault/<kind>``
    event on the process-wide tracer.  ``bind(trainer)`` lets the
    corruption wait for the trainer's checkpoint write in flight."""

    def __init__(self, plan: FaultPlan, *, ckpt_dir=None, sleep=time.sleep):
        self.plan = plan
        self.ckpt_dir = ckpt_dir
        self.trainer = None
        self.sleep = sleep
        self.fired: list[dict] = []
        self._consumed: set[int] = set()
        self._armed_dispatch = [
            i for i, e in enumerate(plan.events)
            if e.kind == "dispatch_fault"]
        self._armed_admission = [
            i for i, e in enumerate(plan.events)
            if e.kind in ("malformed_request", "bucket_miss_storm")]
        self._storm_left = 0

    def bind(self, trainer) -> "ChaosHooks":
        self.trainer = trainer
        if self.ckpt_dir is None:
            self.ckpt_dir = trainer.cfg.ckpt_dir
        return self

    def _fire(self, i: int, event: FaultEvent, **detail) -> None:
        from repro_torch.obs.trace import get_tracer
        self._consumed.add(i)
        self.fired.append({"step": event.step, "kind": event.kind,
                           "mode": event.mode, **detail})
        get_tracer().event(f"fault/{event.kind}", step=event.step,
                           mode=event.mode)

    # -- Trainer seams -------------------------------------------------
    def fault_hook(self, step: int) -> None:
        for i, ev in self.plan.at(step):
            if i in self._consumed:
                continue
            if ev.kind == "step_crash":
                self._fire(i, ev)
                raise DeviceLost(f"injected device loss at step {step}")
            if ev.kind == "data_hiccup":
                self._fire(i, ev)
                raise DataPipelineHiccup(
                    f"injected data-pipeline hiccup at step {step}")
            if ev.kind == "ckpt_corrupt":
                if self.trainer is not None:
                    self.trainer.ckpt.wait()
                try:
                    path = corrupt_checkpoint(
                        self.ckpt_dir, mode=ev.mode or "truncate_leaf")
                except FileNotFoundError:
                    path = None     # nothing on disk: only the loss fires
                self._fire(i, ev, path=str(path))
                raise DeviceLost(
                    f"injected device loss at step {step} (latest "
                    f"checkpoint corrupted: {path})")

    def batch_hook(self, step: int, batch: Any) -> Any:
        for i, ev in self.plan.at(step):
            if i in self._consumed or ev.kind != "nonfinite_grads":
                continue
            self._fire(i, ev)
            batch = T.tree_map(_poison, batch)
        return batch

    # -- dispatcher seam -----------------------------------------------
    def dispatch_hook(self, context: dict) -> None:
        if self._armed_dispatch:
            i = self._armed_dispatch.pop(0)
            self._fire(i, self.plan.events[i], context=dict(context))
            raise KernelDispatchFault(
                f"injected kernel-dispatch failure ({context.get('op')})")

    # -- serving seams -------------------------------------------------
    def serve_step_hook(self, step: int, context: dict | None = None
                        ) -> None:
        for i, ev in self.plan.at(step):
            if i in self._consumed or ev.kind != "slow_step":
                continue
            dur = float(ev.mode) if ev.mode else 0.05
            self._fire(i, ev, sleep_s=dur, **(context or {}))
            self.sleep(dur)

    def admit_hook(self, request):
        if self._storm_left > 0:
            self._storm_left -= 1
            request.image = self._off_bucket(request.image)
            return request
        if not self._armed_admission:
            return request
        i = self._armed_admission[0]
        ev = self.plan.events[i]
        if ev.kind == "bucket_miss_storm":
            self._armed_admission.pop(0)
            burst = int(ev.mode) if ev.mode else 3
            self._fire(i, ev, burst=burst)
            self._storm_left = burst - 1
            request.image = self._off_bucket(request.image)
        elif ev.kind == "malformed_request":
            self._armed_admission.pop(0)
            self._fire(i, ev)
            request.image = np.full((5,), np.nan, np.float32)
        return request

    @staticmethod
    def _off_bucket(image) -> np.ndarray:
        """A zero image at odd extents larger than the original, which no
        power-aligned bucket matches."""
        arr = np.asarray(image)
        h = (arr.shape[0] if arr.ndim >= 2 else 8) + 1
        w = (arr.shape[1] if arr.ndim >= 2 else 8) + 3
        return np.zeros((h | 1, w | 1, 3), np.float32)

    # -- telemetry -----------------------------------------------------
    def telemetry(self) -> dict:
        return {"plan": self.plan.summary(), "fired": list(self.fired)}

    def dump_telemetry(self, path, extra: dict | None = None) -> None:
        dump_telemetry(path, self.telemetry(), extra)
