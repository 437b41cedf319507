"""Admission control for the DCL detection serving engine (a copy of
``repro.serve.admission``; the port imports nothing of the JAX package).

Everything that can refuse a request lives here, typed:

* :func:`resolve_bucket` — map a request resolution onto the engine's
  fixed shape buckets (static compilation demands a closed shape set);
  a miss raises a friendly ``ValueError`` naming the resolution and the
  nearest configured buckets, or pads up with ``strict=False``.
* :class:`AdmissionQueue` — a bounded FIFO with a configurable
  load-shedding policy: ``reject_new`` (backpressure — the submitter's
  request bounces) or ``shed_oldest`` (the head of the queue is
  sacrificed for the newcomer).
* deadline bookkeeping — requests carry an absolute engine-clock
  deadline; :meth:`AdmissionQueue.expire` sweeps the queue between
  steps and a :class:`DeadlineExceeded` is recorded (never raised
  across the engine boundary) as the typed ``deadline_exceeded``
  outcome.

A refused request is never an exception at the ``submit()`` call site:
it comes back retired with one of the :data:`OUTCOMES` and a
human-readable ``error`` — overload and malformed traffic are expected
inputs for a serving system, not crashes.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any

__all__ = [
    "OUTCOMES", "DeadlineExceeded", "MalformedRequest", "DetRequest",
    "AdmissionConfig", "AdmissionQueue", "resolve_bucket",
]

# Every terminal state a request can reach.  "ok" is the only one with
# a result; the rest carry the reason in ``error``.
OUTCOMES = ("ok", "rejected", "shed", "deadline_exceeded", "malformed",
            "unbucketable", "failed")

SHED_POLICIES = ("reject_new", "shed_oldest")


class DeadlineExceeded(RuntimeError):
    """Typed expiry: the request's deadline passed before (or while)
    it was served.  Checked at admission and between engine steps."""


class MalformedRequest(ValueError):
    """The request payload is not a detection image."""


@dataclasses.dataclass
class DetRequest:
    """One detection request and its full lifecycle record."""
    uid: int
    image: Any                       # (H, W, 3) array-like
    deadline: float | None = None    # absolute, on the engine clock
    # filled by the engine:
    bucket: int | None = None
    outcome: str = "pending"
    error: str = ""
    ladder: str | None = None        # datapath rung that actually served it
    degraded: bool = False
    retries: int = 0
    submitted_at: float | None = None
    completed_at: float | None = None
    result: dict | None = None       # {"cls", "box"} for outcome == "ok"
    done: bool = False

    def latency_s(self) -> float | None:
        if self.submitted_at is None or self.completed_at is None:
            return None
        return self.completed_at - self.submitted_at


def resolve_bucket(h: int, w: int, buckets, *, strict: bool = True) -> int:
    """Map an ``h x w`` request onto one of the configured square shape
    ``buckets`` (each bucket is one static compilation of the model).

    ``strict=True`` requires an exact square match (``h == w == b``);
    ``strict=False`` pads up to the smallest bucket covering both
    extents (the engine zero-pads the image, which the bounded kernels'
    own zero-padding semantics absorb).  A resolution no bucket can
    serve raises a ``ValueError`` naming the request and the nearest
    buckets.
    """
    buckets = tuple(sorted(buckets))
    if not buckets:
        raise ValueError("no shape buckets configured")
    side = max(int(h), int(w))
    if strict:
        if h == w and h in buckets:
            return int(h)
        below = max((b for b in buckets if b <= side), default=None)
        above = min((b for b in buckets if b >= side), default=None)
        near = " and ".join(f"{b}x{b}" for b in (below, above)
                            if b is not None)
        raise ValueError(
            f"request resolution {h}x{w} matches no configured shape "
            f"bucket {buckets} — nearest: {near}; resize the request, "
            f"add a bucket, or serve with strict_buckets=False to pad "
            f"up to the next bucket")
    above = min((b for b in buckets if b >= side), default=None)
    if above is None:
        raise ValueError(
            f"request resolution {h}x{w} exceeds the largest configured "
            f"shape bucket {buckets[-1]}x{buckets[-1]} (buckets "
            f"{buckets}); padding only goes UP — add a larger bucket or "
            f"downscale the request")
    return int(above)


@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    capacity: int = 64
    policy: str = "reject_new"       # reject_new | shed_oldest

    def __post_init__(self):
        if self.capacity < 1:
            raise ValueError(
                f"admission capacity must be >= 1 (got {self.capacity})")
        if self.policy not in SHED_POLICIES:
            raise ValueError(
                f"unknown shed policy {self.policy!r}; expected one of "
                f"{SHED_POLICIES}")


class AdmissionQueue:
    """Bounded FIFO of admitted-but-unserved requests."""

    def __init__(self, cfg: AdmissionConfig):
        self.cfg = cfg
        self.queue: deque[DetRequest] = deque()

    def __len__(self) -> int:
        return len(self.queue)

    def offer(self, req: DetRequest) -> DetRequest | None:
        """Enqueue ``req``.  Returns the displaced request — marked
        ``rejected`` (the newcomer, under backpressure) or ``shed``
        (the oldest queued request, under shed-oldest) — or None when
        there was room."""
        if len(self.queue) < self.cfg.capacity:
            self.queue.append(req)
            return None
        if self.cfg.policy == "shed_oldest":
            victim = self.queue.popleft()
            victim.outcome = "shed"
            victim.error = (
                f"shed by request {req.uid}: queue at capacity "
                f"{self.cfg.capacity} (policy=shed_oldest)")
            self.queue.append(req)
            return victim
        req.outcome = "rejected"
        req.error = (f"queue at capacity {self.cfg.capacity} "
                     f"(policy=reject_new)")
        return req

    def expire(self, now: float) -> list[DetRequest]:
        """Sweep deadline-expired requests out of the queue, marking
        each with the typed ``deadline_exceeded`` outcome."""
        expired = []
        keep = deque()
        for req in self.queue:
            if req.deadline is not None and now > req.deadline:
                req.outcome = "deadline_exceeded"
                req.error = str(DeadlineExceeded(
                    f"request {req.uid} expired in queue "
                    f"({now - req.deadline:.3f}s past deadline)"))
                expired.append(req)
            else:
                keep.append(req)
        self.queue = keep
        return expired

    def head_bucket(self) -> int | None:
        """Bucket of the oldest queued request (the next step's batch)."""
        return self.queue[0].bucket if self.queue else None

    def pick_bucket(self, *, slots: int, now: float,
                    batch_window: float = 0.0) -> int | None:
        """Deadline-aware bucket pick: the bucket whose most
        urgent request has the earliest deadline, instead of blind
        head-of-line order — a full queue of lax-deadline 64px requests
        no longer starves a tight-deadline 128px request behind them.

        Buckets that can fill all ``slots`` are preferred (a full static
        batch wastes no padded rows); among them — and among the partial
        ones — order is (earliest deadline, oldest submit), with
        deadline-less requests sorting last (+inf).  A *partial* bucket
        is only eligible once its oldest request has waited at least
        ``batch_window`` seconds, so a small window trades a bounded
        extra wait for fuller batches (``batch_window=0`` serves
        partials immediately).  Returns
        None when the queue is empty or every partial batch is still
        inside its window.
        """
        stats: dict[int, tuple[int, float, float]] = {}
        for req in self.queue:
            dl = req.deadline if req.deadline is not None else float("inf")
            sub = req.submitted_at if req.submitted_at is not None \
                else float("inf")
            count, best_dl, oldest = stats.get(
                req.bucket, (0, float("inf"), float("inf")))
            stats[req.bucket] = (count + 1, min(best_dl, dl),
                                 min(oldest, sub))
        if not stats:
            return None
        order = sorted(stats, key=lambda b: (stats[b][1], stats[b][2]))
        for b in order:
            if stats[b][0] >= slots:
                return b
        for b in order:
            oldest = stats[b][2]
            if batch_window <= 0.0 or now - oldest >= batch_window:
                return b
        return None

    def take(self, bucket: int, limit: int) -> list[DetRequest]:
        """Pop up to ``limit`` requests for ``bucket``, preserving FIFO
        order; requests for other buckets stay queued in place."""
        taken: list[DetRequest] = []
        keep = deque()
        for req in self.queue:
            if req.bucket == bucket and len(taken) < limit:
                taken.append(req)
            else:
                keep.append(req)
        self.queue = keep
        return taken
