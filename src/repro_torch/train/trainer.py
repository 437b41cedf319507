"""Fault-tolerant training loop (counterpart of ``repro.train.trainer``).

* params and optimizer state laid out on a ``mesh`` by their specs:
  ``param_specs`` (the params' partition specs, ``layers.spec_tree`` of
  the model's defs under the mesh's rules) places each param
  (``distributed.sharding.place``: one block per distinct mesh index of
  the axes its spec names, each owning its storage), and the optimizer's
  and the error-feedback state follow their params
  (``optim.opt_state_specs``); the gradients come back to the blocks.
  Without ``param_specs`` the params stay whole on the mesh's first
  device (the data-parallel DCN Trainer);
* each step runs under ``use_rules(rules, mesh)`` (``rules``: those the
  specs were made under, default the defaults): the batch, whole on the
  first device, splits over the mesh's 'batch' axes per microbatch
  (``batch_specs``; a batch that does not divide stays whole, as JAX's
  rules leave it replicated), and the model runs one data shard a block
  of each microbatch's rows (``sharding.data_shards``): the LM's layers
  (``models.transformer``) and every layer of the detector
  (``models.resnet_dcn``, whose DCL calls inside a shard split its rows
  no further, or, with a config's ``shard_spatial``, split the height
  over the 'spatial' axis at the shard's coordinates); each data shard's
  gradient comes back to the one copy of a param the Trainer holds;
* optional int8 error-feedback gradient compression (``grad_compression=
  "int8_ef"``, ``distributed.compression``), applied after the sentinel
  read the uncompressed gradient norm;
* gradient accumulation over ``microbatches`` slices of the batch;
* checkpoint every ``ckpt_every`` steps (async, atomic, keep-k, CRC; the
  bundle gathered whole, free of any mesh), resume from the latest
  complete one onto this Trainer's own mesh, whatever mesh wrote it
  (``try_resume``, JAX's ``_bundle_shardings``: the elastic restore);
* numerics sentinel: the loss and the gradient norm are checked BEFORE
  the optimizer update, and a non-finite step leaves every state leaf
  (the error-feedback state too) as it was; ``max_skips`` consecutive non-finite steps raise
  ``NonFiniteDivergence`` (a replay from a checkpoint would replay it);
* a step that raises is retried from the last checkpoint with
  exponential backoff (restore and replay: the data pipeline is
  stateless, so the replay is exact);
* SIGTERM flips a flag; the loop saves and exits at the next step.

The optimizer updates params and state in place under
``torch.no_grad()``; params are leaf tensors with ``requires_grad`` set.
Nothing here switches a DCL to another datapath: a retried step runs the
same kernels as the failed one.

``fault_hook(step)`` may raise before a step; ``batch_hook(step, batch)``
may transform the host batch.  Health telemetry (``skipped``,
``recovered``, ``retries``, ``preempted``) lives in a metrics registry.
Spans go to the tracer (``obs.trace``; on the profiler's clock while
one records): ``train/step`` holds ``train/data``, a ``train/sync`` (the
batch on the device) and ``train/compute``, which holds per microbatch
``train/forward`` (``loss_fn``) and ``train/backward`` (the gradients
and their sum), then ``train/sentinel`` (the gradient norm and the wait
for its verdict), ``train/optimizer`` (the error-feedback compression
and the update) and ``train/sync`` (the step's end on the device);
``train/checkpoint`` is each save.
"""
from __future__ import annotations

import dataclasses
import signal
import statistics
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.checkpoint import CheckpointManager
from repro_torch.device import resolve_device
from repro_torch.distributed.compression import (ef_compress_grads,
                                                 init_ef_state)
from repro_torch.distributed.sharding import (logical_spec, place_tree,
                                              shardings_of, use_rules)
from repro_torch.obs import trace as _trace
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import Tracer
from repro_torch.optim import Optimizer, global_norm, opt_state_specs

Tensor = torch.Tensor


GRAD_COMPRESSIONS = (None, "int8_ef")


def checkpoint_bundle(params: Any, opt_state: Any, step: int,
                      ef: Any = None) -> dict:
    """The tree a Trainer checkpoints (JAX's bundle: params, optimizer
    state, the error-feedback state or None, step); also the template a
    launcher restores a Trainer checkpoint into."""
    return {"params": params, "opt": opt_state, "ef": ef,
            "step": torch.tensor(step, dtype=torch.int32)}


class NonFiniteDivergence(RuntimeError):
    """Training diverged: ``max_skips`` consecutive non-finite steps.
    Never retried: the replay would reproduce the same batch."""


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = "build/train_ckpt"
    keep: int = 3
    microbatches: int = 1          # gradient accumulation factor
    grad_compression: str | None = None   # None | 'int8_ef'
    log_every: int = 10
    max_retries: int = 3
    max_skips: int = 3             # consecutive non-finite steps -> raise
    retry_backoff: float = 0.0     # seconds; doubles per consecutive retry


class Trainer:
    def __init__(self, *, loss_fn: Callable[[Any, Any], tuple[Tensor, dict]],
                 params: Any, optimizer: Optimizer,
                 batch_fn: Callable[[int], Any], config: TrainerConfig,
                 fault_hook: Callable[[int], None] | None = None,
                 batch_hook: Callable[[int, Any], Any] | None = None,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] | None = None,
                 registry: MetricsRegistry | None = None,
                 tracer: Tracer | None = None,
                 device: str | torch.device | None = None,
                 mesh=None, param_specs: Any = None, rules=None):
        if config.grad_compression not in GRAD_COMPRESSIONS:
            raise ValueError(
                f"unknown grad_compression {config.grad_compression!r}; "
                f"expected one of {GRAD_COMPRESSIONS}")
        if config.microbatches < 1:
            raise ValueError(f"microbatches={config.microbatches} must be "
                             f">= 1")
        self.cfg = config
        self.rules = rules
        self.device = resolve_device(device) if mesh is None or device \
            is not None else mesh.first_device
        if mesh is not None and mesh.first_device != self.device:
            raise ValueError(
                f"the Trainer runs on {self.device} but the mesh's first "
                f"device is {mesh.first_device}: the unsharded layers run "
                f"there")
        self.mesh = mesh
        self.loss_fn = loss_fn
        self.opt = optimizer
        self.batch_fn = batch_fn
        self.fault_hook = fault_hook
        self.batch_hook = batch_hook
        self.clock = clock
        self._sleep = sleep
        self.ckpt = CheckpointManager(config.ckpt_dir, keep=config.keep)
        self.history: list[dict] = []
        self.metrics = registry if registry is not None else MetricsRegistry()
        self._tracer = tracer
        m = self.metrics
        self._c_skipped = m.counter(
            "train_steps_skipped_total", "non-finite steps skipped")
        self._c_recovered = m.counter(
            "train_recovered_total", "restore-and-replay recoveries")
        self._c_retries = m.counter(
            "train_retries_total", "step failures retried")
        self._g_preempted = m.gauge(
            "train_preempted", "1 after a SIGTERM save-and-exit")
        self._h_step = m.histogram(
            "train_step_seconds", "wall time per completed training step")
        self._preempted = False
        # Wall time of every completed step.
        self.step_seconds: list[float] = []
        if param_specs is not None:
            T.tree_map(self._check_spec, params, param_specs)
            if mesh is not None:
                params = place_tree(params, param_specs, mesh)
        self.params = T.tree_map(
            lambda p: p.detach().requires_grad_(True), params)
        self.param_specs = param_specs
        self.opt_state = optimizer.init(self.params)
        self.ef_state = init_ef_state(self.params) \
            if config.grad_compression == "int8_ef" else None
        # Each batch leaf's partition on the mesh ({key: spec}), as the
        # last ``_shard_batch`` laid it out.
        self.batch_specs: dict[str, tuple] = {}
        self.step = 0

    @staticmethod
    def _check_spec(p: Tensor, spec) -> None:
        if len(tuple(spec)) != p.ndim:
            raise ValueError(f"param spec {spec} does not fit a param of "
                             f"shape {tuple(p.shape)}")

    @property
    def _tr(self) -> Tracer:
        return self._tracer if self._tracer is not None \
            else _trace.get_tracer()

    @property
    def telemetry(self) -> dict:
        """Health telemetry, read from the metrics registry."""
        return {"skipped": int(self._c_skipped.value()),
                "recovered": int(self._c_recovered.value()),
                "retries": int(self._c_retries.value()),
                "preempted": bool(self._g_preempted.value())}

    # -- one step -------------------------------------------------------
    def _grads(self, batch) -> tuple[Tensor, Any]:
        """Loss (mean over microbatches) and gradients (their mean, laid
        out as the params are), under the mesh's rules."""
        tensors = T.leaves(self.params)
        mb = self.cfg.microbatches
        tr = self._tr
        gsum = None
        losses = []
        for i in range(mb):
            part = batch if mb == 1 else T.tree_map(
                lambda x: x.reshape(mb, x.shape[0] // mb,
                                    *x.shape[1:])[i], batch)
            with use_rules(self.rules, mesh=self.mesh):
                with tr.span("train/forward", step=self.step):
                    loss, _ = self.loss_fn(self.params, part)
                with tr.span("train/backward", step=self.step):
                    gs = torch.autograd.grad(loss, tensors,
                                             allow_unused=True)
                    gs = [torch.zeros_like(p, dtype=torch.float32)
                          if g is None else g.float()
                          for g, p in zip(gs, tensors)]
                    if gsum is None:
                        gsum = gs
                    else:   # in place: one sum of the gradients, not two
                        for a, b in zip(gsum, gs):
                            a.add_(b)
                    del gs
            losses.append(loss.detach().to(self.device))
        if mb > 1:
            with tr.span("train/backward", step=self.step):
                for g in gsum:
                    g.div_(mb)
        by_block = {id(p): g for p, g in zip(tensors, gsum)}
        grads = T.tree_map(lambda p: by_block[id(p)], self.params)
        return torch.stack(losses).mean(), grads

    def _device_batch(self, step: int):
        batch = self.batch_fn(step)
        if self.batch_hook is not None:
            batch = self.batch_hook(step, batch)
        mb = self.cfg.microbatches
        for k, x in batch.items():
            if mb > 1 and np.shape(x)[0] % mb:
                raise ValueError(f"batch {k!r} of {np.shape(x)[0]} does not "
                                 f"split into {mb} microbatches")
        return self._shard_batch(batch)

    def _shard_batch(self, batch):
        """Lay the host batch out for the step: every leaf on the mesh's
        first device (the Trainer's), and ``batch_specs`` records how the
        mesh's rules split each one's sample axis per microbatch (JAX's
        ``_shard_batch`` splits axis 1 after the microbatch axis): the
        models' data shards take that split of each microbatch, one block
        a device of the 'batch' axes; a leaf whose batch does not divide
        stays whole (``None``)."""
        out = {k: torch.as_tensor(np.asarray(x)).to(self.device)
               for k, x in batch.items()}
        if self.mesh is not None:
            mb = self.cfg.microbatches
            self.batch_specs = {
                k: logical_spec((x.shape[0] // mb, *x.shape[1:]),
                                ("batch",) + (None,) * (x.ndim - 1),
                                mesh=self.mesh)
                for k, x in out.items() if x.ndim >= 1}
        return out

    def _one_step(self, batch) -> tuple[float, float, bool]:
        tr = self._tr
        loss, grads = self._grads(batch)
        with tr.span("train/sentinel", step=self.step):
            grad_norm = global_norm(grads)
            finite = bool(torch.isfinite(loss) & torch.isfinite(grad_norm))
        if finite:
            # The sentinel decided first, on the uncompressed norm: a
            # non-finite step touches no state leaf, the error-feedback
            # state included.
            with tr.span("train/optimizer", step=self.step):
                if self.ef_state is not None:
                    grads, self.ef_state = ef_compress_grads(grads,
                                                             self.ef_state)
                with torch.no_grad():
                    self.opt.update(grads, self.opt_state, self.params,
                                    self.step)
        return float(loss), float(grad_norm), finite

    # -- checkpoint bundle ----------------------------------------------
    def _bundle(self):
        return checkpoint_bundle(self.params, self.opt_state, self.step,
                                 self.ef_state)

    def _bundle_shardings(self):
        """The bundle's layout on this Trainer's mesh (JAX's
        ``_bundle_shardings``): params by their specs, optimizer state by
        ``opt_state_specs``, the error-feedback state like the params, the
        step whole; None without a mesh or specs."""
        if self.mesh is None or self.param_specs is None:
            return None
        specs = {"params": self.param_specs,
                 "opt": opt_state_specs(self.opt, self.param_specs),
                 "ef": (self.param_specs if self.ef_state is not None
                        else None),
                 "step": ()}
        return shardings_of(specs, self.mesh)

    def save(self):
        with self._tr.span("train/checkpoint", step=self.step):
            self.ckpt.save(self.step, self._bundle())

    def try_resume(self) -> bool:
        """Restore the latest complete checkpoint into params and
        optimizer state (in place, block by block), laid out on this
        Trainer's mesh whatever mesh wrote it.  False when there is none.
        A write still in flight is joined first, so the step it saves
        counts."""
        self.ckpt.wait()
        if self.ckpt.latest_step() is None:
            return False
        restored, _ = self.ckpt.restore(
            self._bundle(), shardings=self._bundle_shardings())
        with torch.no_grad():
            T.tree_map(lambda dst, src: dst.copy_(src),
                       {"params": self.params, "opt": self.opt_state,
                        "ef": self.ef_state},
                       {"params": restored["params"],
                        "opt": restored["opt"], "ef": restored["ef"]})
        self.step = int(restored["step"])
        return True

    @property
    def last_loss(self) -> float:
        """Most recent logged loss (event records interleave with the
        logged steps in ``history``)."""
        for h in reversed(self.history):
            if "loss" in h:
                return h["loss"]
        return float("nan")

    def median_step_sec(self, *, skip_first: int = 1) -> float:
        """Median wall time per completed step, excluding the first
        ``skip_first`` steps (kernel builds, cuDNN planning).  nan if
        nothing completed."""
        ts = self.step_seconds[skip_first:]
        return statistics.median(ts) if ts else float("nan")

    # -- main loop ------------------------------------------------------
    def _on_sigterm(self, signum, frame):
        self._preempted = True

    def _preempt_exit(self):
        self.save()
        self.ckpt.wait()
        self._g_preempted.set(1)
        self._tr.event("train/preempt", step=self.step)
        self.history.append(
            {"step": self.step,
             "event": f"preempted: checkpoint saved at step {self.step}, "
                      f"exiting"})
        self.history.append({"step": self.step, "event": "health",
                             **self.telemetry})
        return self.history

    def _sync(self):
        with self._tr.span("train/sync", step=self.step):
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

    def run(self) -> list[dict]:
        cfg = self.cfg
        retries = 0
        skips = 0
        prev_handler = None
        try:
            prev_handler = signal.signal(signal.SIGTERM, self._on_sigterm)
        except ValueError:
            pass          # not the main thread
        try:
            while self.step < cfg.total_steps:
                if self._preempted:
                    return self._preempt_exit()
                try:
                    if self.fault_hook is not None:
                        self.fault_hook(self.step)
                    with self._tr.span("train/step",
                                       step=self.step) as step_span:
                        with self._tr.span("train/data", step=self.step):
                            batch = self._device_batch(self.step)
                        self._sync()
                        t0 = self.clock()
                        with self._tr.span("train/compute", step=self.step):
                            # float() waits for the device, so dt covers
                            # the computation, not its dispatch.
                            loss, grad_norm, finite = self._one_step(batch)
                            self._sync()
                        dt = self.clock() - t0
                        step_span.set_attr(finite=finite)
                    if finite:
                        skips = 0
                        self.step_seconds.append(dt)
                        self._h_step.observe(dt)
                        if self.step % cfg.log_every == 0:
                            self.history.append(
                                {"step": self.step, "loss": loss,
                                 "grad_norm": round(grad_norm, 6),
                                 "sec": round(dt, 4)})
                    else:
                        skips += 1
                        self._c_skipped.inc()
                        self._tr.event("train/skip", step=self.step,
                                       loss=loss, grad_norm=grad_norm)
                        self.history.append(
                            {"step": self.step,
                             "event": f"skipped: non-finite step "
                                      f"(loss={loss}, "
                                      f"grad_norm={grad_norm})"})
                        if skips >= cfg.max_skips:
                            raise NonFiniteDivergence(
                                f"{skips} consecutive non-finite steps "
                                f"(max_skips={cfg.max_skips}) at step "
                                f"{self.step}; last loss={loss}, "
                                f"grad_norm={grad_norm} — the replay is "
                                f"deterministic, so this is a divergence, "
                                f"not a transient")
                    # A skipped step still advances: re-running it would
                    # re-poison deterministically.
                    self.step += 1
                    retries = 0
                    if self.step % cfg.ckpt_every == 0:
                        self.save()
                except (KeyboardInterrupt, NonFiniteDivergence):
                    raise
                except Exception as e:  # noqa: BLE001 — any step failure
                    retries += 1
                    self._c_retries.inc()
                    self._tr.event("train/retry", step=self.step,
                                   attempt=retries,
                                   error=f"{type(e).__name__}: {e}")
                    if retries > cfg.max_retries:
                        raise
                    if cfg.retry_backoff > 0:
                        (self._sleep or time.sleep)(
                            cfg.retry_backoff * (2 ** (retries - 1)))
                    if not self.try_resume():
                        raise     # no checkpoint to restart from
                    self._c_recovered.inc()
                    self._tr.event("train/restore", step=self.step)
                    self.history.append(
                        {"step": self.step, "event": f"recovered: {e}"})
            if self._preempted:
                return self._preempt_exit()
            self.save()
            self.ckpt.wait()
            self.history.append({"step": self.step, "event": "health",
                                 **self.telemetry})
        finally:
            if prev_handler is not None:
                signal.signal(signal.SIGTERM, prev_handler)
        return self.history

