"""Slot-based detection serving engine for the bounded DCL models and
InternImage (counterpart of ``repro.serve.dcl_engine``).

Detection requests are single-shot: admit -> one batched forward ->
retire.  A small fixed set of square shape buckets keeps the shapes
closed; each bucket's DCL tile plans are resolved at engine start
(``kernels.plan.warm_tile_cache``).  Every step serves one bucket — up to
``slots`` queued requests padded into one batch.

The rungs, top first, are the JAX engine's: ``int8_chain`` (the default:
every DCL through the chained int8 kernel, offset conv fused in, output
emitted int8), ``int8`` (every DCL through the int8 dequant kernel),
``fp32_kernel`` (the fused fp32 kernel, over the model config's
dataflow) and ``fp32_ref`` (the plain reference).  The int8 rungs need a
calibration scale table at engine start (``scale_table``: a dict or a
JSON path, see ``quant.calibrate``).  The model config's type names its
family (``model_family``: ``models.resnet_dcn`` or
``models.internimage``), which says what the engine serves: its
``RUNGS`` (an entry rung outside them raises at construction: InternImage
has no int8 rung), each rung's config (``rung_configs``), the kernel
plans warmed per bucket (``warm_plans``) and the ``forward`` the rungs
run.  ``spatial_shards`` runs the listed
buckets' kernel rungs height-sharded over that many of the engine's
devices, one halo exchange a DCL (``distributed.spatial``); such a bucket
enters the ladder at ``int8`` where the entry rung is ``int8_chain``,
whose fused offset stage cannot be split at shard seams.  The shard
counts are checked at construction: more shards than devices, a layer
thinner than its halo or a ragged split raise there, not on the first
request.  On CUDA the ladder is the entry rung alone (``ladder``):
a batch whose kernel keeps failing retires ``failed`` with the kernel's
error and is never served by another rung.  ``fp32_ref`` runs there only
when the caller chooses it as the entry rung.

Robustness, as in the JAX engine:

* per-request deadlines — checked at admission, swept between steps and
  re-checked after the step; expiry is the typed ``deadline_exceeded``;
* bounded admission queue (``serve.admission``): overload is shed or
  bounced, never an exception;
* a failed batch is replayed with exponential backoff up to
  ``max_retries``, then drops one rung where the device's ladder has one
  (CPU tensors only), else retires ``failed``; the rung and the
  ``degraded`` flag are recorded per request.  Kernel failures raise out
  of ``ops`` (there is no silent fallback below the engine).

Spans (``obs.trace``; on the profiler's clock while one records):
``serve/step`` (with its requests' ``uids`` when the tracer is enabled,
the ids of their ``serve/admit`` and ``serve/retire`` events) holds
``serve/batch`` (``batch_array``: the batch staged row by row in the
bucket's pinned buffer and its copies enqueued), ``serve/forward`` (the
forward's launches),
``serve/readback`` (the copies of ``cls`` and ``box`` to the host, the
step's synchronisation) and ``serve/retire``.

While the engine's tracer is enabled, every forward runs under an
``obs.DispatchRecorder`` chained to the dispatch hook already installed
(a chaos hook fires first): each DCL dispatch is timed against its H100
bound in ``divergence`` (on CUDA the stream's time between two events,
host enqueue gaps included, read after the step's own copy of its
outputs to the host).  Otherwise the forward runs under the installed
hook alone and ``divergence`` stays empty.
``telemetry()`` carries that report, ``plan_cache``
(``plan.tile_cache_info``) and ``plan_sources`` (each layer's
``"tuned"`` or ``"analytic"`` tiles, per bucket).  The engine's metrics
(``metrics``) count requests, retries, degraded batches, rungs and steps,
and ``serve_staged_batches_total`` the batches staged through a pinned
buffer (``path="pinned"``, on CUDA) or built in a host tensor
(``path="host"``), per bucket.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import time
from typing import Any, Callable, Mapping

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import Mesh, use_rules
from repro_torch.kernels import ops, plan
from repro_torch.models import internimage as I
from repro_torch.models import resnet_dcn as R
from repro_torch.obs import trace as _trace
from repro_torch.obs.divergence import DispatchRecorder, DivergenceTracker
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import Tracer
from repro_torch.quant.calibrate import load_scale_table, scale_table_on

from .admission import (AdmissionConfig, AdmissionQueue, DetRequest,
                        MalformedRequest, resolve_bucket)

__all__ = ["LADDER", "DCLServeConfig", "DCLServingEngine",
           "bucket_layer_dims", "ladder", "model_family"]

# Degradation ladder, top rung first.  The bottom rung never touches the
# kernel path.
LADDER = ("int8_chain", "int8", "fp32_kernel", "fp32_ref")
INT8_RUNGS = ("int8_chain", "int8")


def ladder(entry: str, device: torch.device) -> tuple[str, ...]:
    """Rungs a batch may take, from ``entry`` down.  On CUDA only the
    entry rung: the plain path never stands in for the kernel there."""
    rungs = LADDER[LADDER.index(entry):]
    return rungs if device.type == "cpu" else rungs[:1]


@dataclasses.dataclass(frozen=True)
class DCLServeConfig:
    buckets: tuple[int, ...] = (64, 128)
    slots: int = 4                   # batch rows per step
    quant: str = "int8_chain"        # entry rung of LADDER
    strict_buckets: bool = True      # False: pad up to the next bucket
    queue_capacity: int = 64
    shed_policy: str = "reject_new"  # reject_new | shed_oldest
    max_retries: int = 2             # same-rung replays before degrading
    retry_backoff: float = 0.0       # seconds; doubles per retry
    default_deadline: float | None = None
    batch_window: float = 0.0        # hold partial batches this long
    # ((bucket, shards), ...): the bucket's kernel rungs run height-
    # sharded over ``shards`` devices with the bounded halo exchange.
    spatial_shards: tuple[tuple[int, int], ...] = ()

    def __post_init__(self):
        if self.quant not in LADDER:
            raise ValueError(
                f"unknown serve datapath {self.quant!r}; expected one of "
                f"{LADDER} (the ladder runs from the chosen rung down)")
        for entry in self.spatial_shards:
            if len(entry) != 2:
                raise ValueError(
                    f"spatial_shards entries are (bucket, shards) pairs "
                    f"(got {entry!r})")
            b, n = entry
            if b not in self.buckets:
                raise ValueError(
                    f"spatial_shards names bucket {b} which is not in "
                    f"buckets {self.buckets}")
            if n < 1:
                raise ValueError(
                    f"spatial_shards for bucket {b} must be >= 1 (got {n})")
        if not self.buckets:
            raise ValueError("at least one shape bucket is required")
        if self.slots < 1:
            raise ValueError(f"slots must be >= 1 (got {self.slots})")
        if self.batch_window < 0:
            raise ValueError(
                f"batch_window must be >= 0 (got {self.batch_window})")

    def spatial_shards_for(self, bucket: int | None) -> int:
        for b, n in self.spatial_shards:
            if b == bucket:
                return n
        return 1


def model_family(cfg):
    """The module of a model config's family, by the config's type: its
    ``RUNGS``, ``rung_configs``, ``warm_plans``, ``forward`` and
    ``bucket_layer_dims``."""
    for kind, family in ((R.ResNetDCNConfig, R),
                         (I.InternImageConfig, I)):
        if isinstance(cfg, kind):
            return family
    raise TypeError(f"the detection engine serves ResNet-DCN and "
                    f"InternImage configs (got {type(cfg).__name__})")


def bucket_layer_dims(cfg, res: int) -> dict[str, dict]:
    """Dims of every DCL (ResNet-DCN) or DCNv3 layer (InternImage)
    invocation at input resolution ``res``."""
    return model_family(cfg).bucket_layer_dims(cfg, res)


@dataclasses.dataclass
class _Staging:
    """A bucket's reused input buffers: ``host`` (pinned on CUDA), and on
    CUDA the device input ``dev`` and the event ``copied`` recorded after
    the last row's copy."""
    host: torch.Tensor
    dev: torch.Tensor | None = None
    copied: torch.cuda.Event | None = None

    @classmethod
    def make(cls, shape: tuple[int, ...], device: torch.device) -> "_Staging":
        if device.type != "cuda":
            return cls(torch.empty(shape, dtype=torch.float32,
                                   device=device))
        return cls(torch.empty(shape, dtype=torch.float32, pin_memory=True),
                   torch.empty(shape, dtype=torch.float32, device=device),
                   torch.cuda.Event())


class DCLServingEngine:
    """See module docstring.  ``clock``/``sleep`` are injectable for
    deterministic deadline and backoff tests; ``step_hook(step, ctx)`` and
    ``admit_hook(request)`` are fault-injection seams.  ``device``
    defaults to ``cuda``; params must already lie there.  ``devices`` are
    the ones a spatial bucket's shards may take, in order (default
    ``launch.mesh.make_host_mesh``'s, or ``device`` alone on the CPU); a
    caller may repeat one to run every shard on it."""

    def __init__(self, params,
                 model_cfg: R.ResNetDCNConfig | I.InternImageConfig,
                 serve_cfg: DCLServeConfig, *,
                 scale_table: Mapping[str, Any] | str | None = None,
                 device: str | torch.device | None = None,
                 devices=None,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep,
                 step_hook: Callable[[int, dict], None] | None = None,
                 admit_hook: Callable[[DetRequest], DetRequest] | None = None,
                 registry: MetricsRegistry | None = None,
                 tracer: Tracer | None = None):
        self.device = resolve_device(device)
        self.params = params
        self.scfg = serve_cfg
        self.rungs = ladder(serve_cfg.quant, self.device)
        self.clock = clock
        self._sleep = sleep
        self.step_hook = step_hook
        self.admit_hook = admit_hook

        self.metrics = registry if registry is not None else MetricsRegistry()
        self._tracer = tracer
        self.divergence = DivergenceTracker()
        m = self.metrics
        self._c_requests = m.counter(
            "serve_requests_total", "retired requests by outcome and bucket")
        self._c_retries = m.counter(
            "serve_retries_total", "same-rung batch replays")
        self._c_degraded = m.counter(
            "serve_degraded_batches_total", "batches dropped one ladder rung")
        self._c_ladder = m.counter(
            "serve_ladder_total", "requests served per datapath rung")
        self._c_steps = m.counter("serve_steps_total",
                                  "engine serving steps per bucket")
        self._c_staged = m.counter(
            "serve_staged_batches_total",
            "batches staged per path (pinned, host) and bucket")
        self._g_queue = m.gauge(
            "serve_queue_depth", "queued requests after the last step")
        self._h_queue_wait = m.histogram(
            "serve_queue_wait_seconds",
            "submit-to-batch-start wait per bucket")
        self._h_latency = m.histogram(
            "serve_latency_seconds",
            "submit-to-retire latency per bucket and outcome")

        self.family = model_family(model_cfg)
        if serve_cfg.quant not in self.family.RUNGS:
            raise ValueError(
                f"serve datapath {serve_cfg.quant!r} has no path for "
                f"{model_cfg.name}, which serves {self.family.RUNGS}")

        if isinstance(scale_table, str):
            scale_table = load_scale_table(scale_table)
        self.scale_table = scale_table
        # The scales the forwards read, on the device once.
        self._scales = None if scale_table is None \
            else scale_table_on(scale_table, self.device)
        if serve_cfg.quant in INT8_RUNGS:
            if model_cfg.offset_bound is None:
                raise ValueError(
                    f"serve datapath {serve_cfg.quant!r} needs a trained "
                    f"offset_bound on the model config — the int8 kernels "
                    f"exist because Eq. 6 bounds the band")
            if scale_table is None:
                raise ValueError(
                    f"serve datapath {serve_cfg.quant!r} needs a "
                    f"calibration scale table at engine start "
                    f"(repro_torch.quant.calibrate_resnet_dcn + "
                    f"save_scale_table); chained layers exchange int8 on "
                    f"pinned activation grids")

        self._cfgs = self.family.rung_configs(model_cfg)

        # Per-bucket meshes of the spatial buckets, checked now: a shard
        # count the devices or a layer's height cannot take fails at
        # construction.
        if devices is None:
            from repro_torch.launch.mesh import make_host_mesh
            devices = [self.device] if self.device.type == "cpu" \
                else list(make_host_mesh().devices.reshape(-1))
        self.devices = [torch.device(d) for d in devices]
        self._spatial_meshes: dict[int, Mesh] = {}
        for b, n in serve_cfg.spatial_shards:
            if n > len(self.devices):
                raise ValueError(
                    f"spatial_shards={n} for bucket {b} exceeds the "
                    f"{len(self.devices)} available device(s) — the height "
                    f"split needs one device per shard")
            if n > 1:
                if model_cfg.offset_bound is None:
                    raise ValueError(
                        f"spatial_shards={n} for bucket {b} needs a trained "
                        f"offset_bound on the model config — the bounded "
                        f"halo exchange is derived from it")
                self._spatial_meshes[b] = Mesh(self.devices[:n], ("model",))

        # Per-bucket kernel plans of each bucket's entry rung and its kernel
        # build, done now rather than on the first request
        # (``family.warm_plans``); a spatial bucket's at the shard-local
        # height ("analytic@2shard"), which raises here for a layer its
        # shards cannot split.
        self.plans: dict[int, dict[str, tuple]] = {}
        self.plan_sources: dict[int, dict[str, str]] = {}
        for b in serve_cfg.buckets:
            warmed = self.family.warm_plans(
                model_cfg, b, rung=self.rungs_for(b)[0],
                slots=serve_cfg.slots, device=self.device,
                spatial_shards=serve_cfg.spatial_shards_for(b))
            if warmed is not None:
                self.plans[b], self.plan_sources[b] = warmed

        self.queue = AdmissionQueue(AdmissionConfig(
            capacity=serve_cfg.queue_capacity,
            policy=serve_cfg.shed_policy))
        self.completed: list[DetRequest] = []
        self.steps = 0
        self._uid = itertools.count()
        self._staging: dict[int, _Staging] = {}

    def rungs_for(self, bucket: int) -> tuple[str, ...]:
        """The ladder of ``bucket``: a spatial bucket whose entry rung is
        ``int8_chain`` enters at ``int8``."""
        if self.scfg.spatial_shards_for(bucket) > 1 \
                and self.rungs[0] == "int8_chain":
            return ladder("int8", self.device)
        return self.rungs

    @property
    def _tr(self) -> Tracer:
        return self._tracer if self._tracer is not None \
            else _trace.get_tracer()

    @property
    def counters(self) -> dict[str, int]:
        """``{outcome: count}`` summed over buckets, plus ``retries`` /
        ``degraded_batches`` when nonzero."""
        out: dict[str, int] = {}
        for key, v in self._c_requests.items():
            outcome = dict(key)["outcome"]
            out[outcome] = out.get(outcome, 0) + int(v)
        retries = int(self._c_retries.value())
        if retries:
            out["retries"] = retries
        degraded = int(self._c_degraded.value())
        if degraded:
            out["degraded_batches"] = degraded
        return out

    # -- admission -----------------------------------------------------
    def submit(self, image, *, deadline: float | None = None,
               uid: int | None = None) -> DetRequest:
        """Admit a detection request (``deadline`` in seconds from now on
        the engine clock).  The request comes back queued or already
        retired with a typed outcome; admission never raises on bad
        traffic."""
        now = self.clock()
        if deadline is None and self.scfg.default_deadline is not None:
            deadline = self.scfg.default_deadline
        req = DetRequest(
            uid=next(self._uid) if uid is None else uid, image=image,
            deadline=None if deadline is None else now + deadline,
            submitted_at=now)
        self._tr.event("serve/admit", uid=req.uid)
        if self.admit_hook is not None:
            req = self.admit_hook(req) or req
        try:
            arr = np.asarray(req.image)
            if arr.ndim != 3 or arr.shape[-1] != 3 \
                    or not np.issubdtype(arr.dtype, np.number):
                raise MalformedRequest(
                    f"detection request needs a numeric (H, W, 3) "
                    f"image; got shape {arr.shape} dtype {arr.dtype}")
        except (ValueError, TypeError) as e:
            return self._retire(req, "malformed",
                                f"{type(e).__name__}: {e}")
        try:
            req.bucket = resolve_bucket(arr.shape[0], arr.shape[1],
                                        self.scfg.buckets,
                                        strict=self.scfg.strict_buckets)
        except ValueError as e:
            return self._retire(req, "unbucketable", str(e))
        if req.deadline is not None and now > req.deadline:
            return self._retire(req, "deadline_exceeded",
                                "expired at admission")
        displaced = self.queue.offer(req)
        if displaced is not None:
            self._retire(displaced)
        return req

    def _retire(self, req: DetRequest, outcome: str | None = None,
                error: str = "") -> DetRequest:
        if outcome is not None:
            req.outcome = outcome
            if error:
                req.error = error
        req.done = True
        req.completed_at = self.clock()
        self.completed.append(req)
        bucket = str(req.bucket)
        self._c_requests.inc(outcome=req.outcome, bucket=bucket)
        lat = req.latency_s()
        if lat is not None:
            self._h_latency.observe(lat, bucket=bucket, outcome=req.outcome)
        self._tr.event("serve/retire", uid=req.uid, outcome=req.outcome)
        return req

    # -- serving -------------------------------------------------------
    def step(self) -> int:
        """Expire, pick the most urgent bucket, serve it.  Returns the
        number of requests retired this step."""
        before = len(self.completed)
        for req in self.queue.expire(self.clock()):
            self._retire(req)
        bucket = self.queue.pick_bucket(
            slots=self.scfg.slots, now=self.clock(),
            batch_window=self.scfg.batch_window)
        if bucket is None:
            self._g_queue.set(len(self.queue))
            return len(self.completed) - before
        batch = self.queue.take(bucket, self.scfg.slots)
        tr = self._tr
        uids = {"uids": [r.uid for r in batch]} if tr.enabled else {}
        with tr.span("serve/step", step=self.steps, bucket=bucket,
                     size=len(batch), **uids):
            now = self.clock()
            for r in batch:
                self._h_queue_wait.observe(now - r.submitted_at,
                                           bucket=str(bucket))
            if self.step_hook is not None:
                self.step_hook(self.steps,
                               {"bucket": bucket, "size": len(batch)})
            self._run_batch(bucket, batch)
        self.steps += 1
        self._c_steps.inc(bucket=str(bucket))
        self._g_queue.set(len(self.queue))
        return len(self.completed) - before

    def batch_array(self, bucket: int, reqs: list[DetRequest]) -> torch.Tensor:
        """The step's input: ``slots`` rows, requests zero-padded into
        the bucket, unused rows zero.

        The bucket's buffers are made on its first step and reused on
        every later one, so the tensor returned holds this batch until
        the next call for the same bucket.  On CUDA each request is
        written into its row of a pinned host buffer and that row's copy
        to the device is enqueued at once on the current stream, the
        stream the forward runs on; only what the step does not write is
        zeroed (a smaller image's margin, the unused rows on the
        device).  On the CPU the host buffer is the input."""
        st = self._staging.get(bucket)
        if st is None:
            st = self._staging[bucket] = _Staging.make(
                (self.scfg.slots, bucket, bucket, 3), self.device)
        host, dev = st.host, st.dev
        if st.copied is not None:
            # A forward that raised before its readback may leave the
            # last batch's copies out of ``host`` in flight.
            st.copied.synchronize()
        # numpy writes the rows on this thread alone (and converts as
        # ``np.asarray(image, float32)`` does); torch's ``copy_`` spreads
        # over the intra-op thread pool, whose stalls lengthened the
        # serving tail on an H100.
        rows = host.numpy()
        for i, r in enumerate(reqs):
            arr = np.asarray(r.image)
            h, w = arr.shape[:2]
            if h < bucket or w < bucket:
                rows[i, h:] = 0
                rows[i, :h, w:] = 0
            rows[i, :h, :w] = arr
            if dev is not None:
                dev[i].copy_(host[i], non_blocking=True)
        out = host if dev is None else dev
        out[len(reqs):].zero_()
        if st.copied is not None:
            st.copied.record(torch.cuda.current_stream(dev.device))
        self._c_staged.inc(path="host" if dev is None else "pinned",
                           bucket=str(bucket))
        return out

    def _forward(self, rung: str, x: torch.Tensor, bucket: int | None = None
                 ) -> tuple[np.ndarray, np.ndarray]:
        """One batch on ``rung``, every DCL dispatch recorded while the
        tracer is enabled; returns ``cls`` and ``box`` on the host.  A
        spatial bucket's kernel rungs run height-sharded under its
        mesh."""
        scales = self._scales if rung in INT8_RUNGS else None
        cfg = self._cfgs[rung]
        mesh = self._spatial_meshes.get(bucket)
        spatial = mesh is not None and rung in ("int8", "fp32_kernel")
        if spatial:
            cfg = dataclasses.replace(cfg, shard_spatial=True)
        tr = self._tr
        rec = DispatchRecorder(registry=self.metrics, tracer=self._tracer,
                               tracker=self.divergence,
                               next_hook=ops.get_dispatch_hook(),
                               clock=self.clock) if tr.enabled else None
        try:
            with torch.no_grad(), \
                    (ops.dispatch_hook_scope(rec) if rec is not None
                     else contextlib.nullcontext()), \
                    (use_rules(mesh=mesh) if spatial
                     else contextlib.nullcontext()), \
                    tr.span("serve/forward", step=self.steps, bucket=bucket):
                kw = {} if scales is None else {"quant_scales": scales}
                out, _ = self.family.forward(self.params, cfg, x,
                                             device=self.device, **kw)
            # The copies to the host are the step's synchronisation.
            with tr.span("serve/readback", step=self.steps, bucket=bucket):
                return out["cls"].cpu().numpy(), out["box"].cpu().numpy()
        finally:
            if rec is not None:
                rec.flush()

    def _run_batch(self, bucket: int, reqs: list[DetRequest]) -> None:
        with self._tr.span("serve/batch", step=self.steps, bucket=bucket):
            x = self.batch_array(bucket, reqs)
        rungs = self.rungs_for(bucket)
        rung_idx = 0
        attempt = 0
        while True:
            try:
                cls, box = self._forward(rungs[rung_idx], x, bucket)
                break
            except Exception as e:   # noqa: BLE001 — recorded per request
                self._c_retries.inc()
                self._tr.event("serve/retry", bucket=bucket,
                               rung=rungs[rung_idx],
                               attempt=attempt + 1,
                               error=f"{type(e).__name__}: {e}")
                for r in reqs:
                    r.retries += 1
                attempt += 1
                if attempt <= self.scfg.max_retries:
                    if self.scfg.retry_backoff:
                        self._sleep(self.scfg.retry_backoff
                                    * 2 ** (attempt - 1))
                    continue
                if rung_idx + 1 < len(rungs):
                    rung_idx += 1
                    attempt = 0
                    for r in reqs:
                        r.degraded = True
                    self._c_degraded.inc()
                    self._tr.event("serve/degrade", bucket=bucket,
                                   rung=rungs[rung_idx])
                    continue
                for r in reqs:
                    self._retire(r, "failed", f"{type(e).__name__}: {e}")
                return
        with self._tr.span("serve/retire", step=self.steps, bucket=bucket):
            now = self.clock()
            for i, r in enumerate(reqs):
                r.ladder = rungs[rung_idx]
                self._c_ladder.inc(rung=r.ladder)
                if r.deadline is not None and now > r.deadline:
                    self._retire(r, "deadline_exceeded",
                                 f"completed {now - r.deadline:.3f}s past "
                                 f"deadline (result dropped)")
                    continue
                r.result = {"cls": cls[i], "box": box[i]}
                self._retire(r, "ok")

    def run_until_drained(self, max_steps: int = 10_000
                          ) -> list[DetRequest]:
        steps = 0
        while len(self.queue) and steps < max_steps:
            self.step()
            steps += 1
        return self.completed

    # -- telemetry -----------------------------------------------------
    def telemetry(self) -> dict:
        """Per-request records, engine counters, the dispatches against
        their bounds (``divergence``) and where the plans' tiles came
        from (``plan_cache``, ``plan_sources``)."""
        per_bucket: dict[str, int] = {}
        for r in self.completed:
            if r.outcome == "ok":
                key = str(r.bucket)
                per_bucket[key] = per_bucket.get(key, 0) + 1
        return {
            "engine": {
                "device": str(self.device),
                "buckets": list(self.scfg.buckets),
                "slots": self.scfg.slots,
                "quant": self.scfg.quant,
                "strict_buckets": self.scfg.strict_buckets,
                "queue_capacity": self.scfg.queue_capacity,
                "shed_policy": self.scfg.shed_policy,
                "batch_window": self.scfg.batch_window,
                "spatial_shards": [list(e) for e in self.scfg.spatial_shards],
            },
            "steps": self.steps,
            "steps_per_bucket": {dict(k)["bucket"]: int(v)
                                 for k, v in self._c_steps.items()},
            "counters": dict(self.counters),
            "served_per_bucket": per_bucket,
            "plan_cache": plan.tile_cache_info(),
            "plans": {str(b): {k: list(v) for k, v in p.items()}
                      for b, p in self.plans.items()},
            "plan_sources": {str(b): dict(s)
                             for b, s in self.plan_sources.items()},
            "requests": [{
                "uid": r.uid, "outcome": r.outcome, "bucket": r.bucket,
                "ladder": r.ladder, "degraded": r.degraded,
                "retries": r.retries, "latency_s": r.latency_s(),
                "error": r.error,
            } for r in self.completed],
            "metrics": self.metrics.snapshot(),
            "divergence": self.divergence.report(),
        }
