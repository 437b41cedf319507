"""Cells of the ResNet-DCN configurations: the program's detection
serving engine under a closed and an open loop, and its Trainer.

``run(cfg, traffic, ...)`` builds what the cell runs from the seed,
warms up exactly the shapes the window uses (counted as set-up), runs
the window, reads the device's peak memory, frees the program's state
and compares what the window produced with ``pb_ref_dcn``.  It returns
the end-to-end values, the record the per-layer readers read (``Run``),
the comparison's numbers beside their limits, and the counts.

Traffic kinds (``traffic["kind"]``):

* ``serve_closed`` — the queue always holds ``depth`` seeded images, so
  every step serves a full batch; ``images_per_s`` is the images
  retired ``ok`` in the window over its length;
* ``serve_open`` — ``rate_per_s * seconds`` requests at Poisson
  arrivals over the window (``arrivals``: every seed the same gaps in
  the same order, rotated), each submitted by the loop that steps the
  engine as soon as it falls due;
  latency runs from the due time to retirement, a request that is not
  ``ok`` counts as infinitely late, and the loop drains the queue after
  the window for at most ``drain_s``;
* ``train`` — the Trainer's own loop over a pool of seeded batches: its
  first ``ref_steps`` steps are set-up and the comparison's, the window
  counts the images of the finite steps that complete in it.

``control`` replaces what the program produced by the reference one
precision below the configuration's (int4 for the int8 chain, TF32 for
fp32) before the comparison, which must then fail; the benchmark's own
runs never set it.
"""
from __future__ import annotations

import dataclasses
import gc
import math
import statistics
import tempfile
import time

import numpy as np
import torch

import pb_data
import pb_ref_dcn as ref
import pb_trace
import pb_yard

clock = time.monotonic


@dataclasses.dataclass
class Run:
    """What the per-layer readers read (``perfbench/metrics``)."""
    kind: str
    window_s: float
    images: int = 0           # images served ok, or trained
    steps: int = 0            # engine or training steps in the window
    rows: int = 0             # requests the window's engine steps served
    slots: int = 0
    flops_per_image: float = 0.0
    dcl_bound_s: float = 0.0  # the DCL kernels' bound, whole window
    queue_waits: list = dataclasses.field(default_factory=list)
    trace: dict | None = None


@dataclasses.dataclass
class Outcome:
    values: dict              # end-to-end values by metric name
    run: Run
    checks: dict              # {name: (value, limit)}
    attempted: int
    failed: int
    memory_peak_bytes: int
    notes: dict = dataclasses.field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return self.failed == 0 and all(
            math.isfinite(v) and v <= lim for v, lim in self.checks.values())


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _peak(dev: torch.device) -> int:
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def _free(dev: torch.device) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def program_config(cfg: dict):
    """The program's model config of the configuration file's sizes."""
    from repro_torch.models import resnet_dcn as R
    return R.ResNetDCNConfig(
        name=cfg["arch"], stage_sizes=tuple(cfg["stage_sizes"]),
        widths=tuple(cfg["widths"]), stem_width=cfg["stem_width"],
        num_dcn=cfg["num_dcn"], offset_bound=cfg["offset_bound"],
        num_classes=cfg["num_classes"], img_size=cfg["img_size"],
        use_kernel=True)


def apply_settings(cfg: dict) -> None:
    """The process settings the configuration states."""
    s = cfg["torch_settings"]
    torch.backends.cuda.matmul.allow_tf32 = s["matmul_allow_tf32"]
    torch.backends.cudnn.allow_tf32 = s["cudnn_allow_tf32"]


def run(cfg: dict, traffic: dict, *, seed: int, seconds: float,
        trace: bool, device: str, t0: float,
        control: bool = False) -> Outcome:
    apply_settings(cfg)
    dev = torch.device(device)
    kinds = {"serve_closed": _serve, "serve_open": _serve, "train": _train}
    return kinds[traffic["kind"]](cfg, traffic, seed=seed, seconds=seconds,
                                  spans=pb_trace.Spans(trace), dev=dev,
                                  t0=t0, control=control)


# -- serving ------------------------------------------------------------------

def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).norm()
                 / b.double().norm().clamp_min(1e-30))


def _serve(cfg, traffic, *, seed, seconds, spans, dev, t0, control):
    from repro_torch.quant.calibrate import calibrate_resnet_dcn
    from repro_torch.serve import DCLServeConfig, DCLServingEngine

    img, classes = cfg["img_size"], cfg["num_classes"]
    slots, rung = traffic["slots"], cfg["serve_rung"]
    params = pb_data.make_params(ref.param_specs(cfg), seed, dev)
    pool = pb_data.detection_batch(img, traffic["pool"], classes, seed,
                                   step=0)["images"]
    calib = pb_data.detection_batch(img, cfg["calibration_images"], classes,
                                    seed, step=1)["images"]
    pcfg = program_config(cfg)
    table = None
    if rung in ("int8", "int8_chain"):
        table = calibrate_resnet_dcn(params, pcfg, [calib], device=dev)
    engine = DCLServingEngine(
        params, pcfg,
        DCLServeConfig(buckets=(img,), slots=slots, quant=rung,
                       queue_capacity=traffic["queue_capacity"]),
        scale_table=table, device=dev)
    image_of: dict[int, int] = {}
    due_of: dict[int, float] = {}
    count = [0]

    def submit(due=None):
        j = count[0] % len(pool)
        r = engine.submit(pool[j])
        image_of[r.uid] = j
        due_of[r.uid] = clock() if due is None else due
        count[0] += 1

    for _ in range(2):                      # the window's one shape, warm
        while len(engine.queue) < slots:
            submit()
        engine.step()
    _sync(dev)
    n_warm = len(engine.completed)
    waits: list[float] = []
    rows = steps = 0
    lateness: list[float] = []

    def step():
        nonlocal rows, steps
        before = len(engine.completed)
        t_step = clock()
        with spans.span("bench/step"):
            engine.step()
        done = engine.completed[before:]
        rows += len(done)
        steps += 1
        waits.extend(t_step - due_of[r.uid] for r in done if r.outcome == "ok")

    spans.start()
    t_start = clock()
    setup_s = t_start - t0
    if traffic["kind"] == "serve_closed":
        while True:
            with spans.span("bench/fill"):
                while len(engine.queue) < traffic["depth"]:
                    submit()
            step()
            t_end = clock()
            if t_end - t_start >= seconds:
                break
        window = engine.completed[n_warm:]
        attempted = len(window)
    else:
        n = int(round(traffic["rate_per_s"] * seconds))
        dues = t_start + arrivals(n, seconds, seed,
                                  traffic["arrival_order"])
        i, backlog = 0, None
        while True:
            now = clock()
            with spans.span("bench/fill"):
                while i < n and dues[i] <= now:
                    submit(float(dues[i]))
                    lateness.append(clock() - dues[i])
                    i += 1
            if i == n and backlog is None:
                backlog = len(engine.queue)
            if len(engine.queue):
                step()
            elif i < n:
                with spans.span("bench/idle"):
                    time.sleep(max(0.0, dues[i] - clock()))
            else:
                break
            if clock() - t_start > seconds + traffic["drain_s"]:
                break
        t_end = clock()
        window = engine.completed[n_warm:]
        attempted = n
    trace_summary = spans.stop(lambda: _sync(dev))
    peak = _peak(dev)
    ok = [r for r in window if r.outcome == "ok"]
    window_s = t_end - t_start
    values = {"setup_s": setup_s}
    failed = attempted - len(ok)
    if traffic["kind"] == "serve_closed":
        values["images_per_s"] = len(ok) / window_s
    else:
        lats = [r.completed_at - due_of[r.uid] for r in ok]
        lats += [math.inf] * failed
        values["latency_p95_ms"] = 1e3 * _percentile(lats, 95)
    path = "int8_chain" if rung == "int8_chain" else "fp32"
    run_rec = Run(kind=traffic["kind"], window_s=window_s, images=len(ok),
                  steps=steps, rows=rows, slots=slots,
                  flops_per_image=pb_yard.forward_flops(cfg, img),
                  dcl_bound_s=steps * pb_yard.dcl_bound_s(
                      cfg, img, slots, path),
                  queue_waits=waits, trace=trace_summary)
    notes = {}
    if traffic["kind"] == "serve_open":
        notes["backlog_at_close"] = backlog
    if lateness:
        notes["generator_late_ms"] = {
            "median": 1e3 * statistics.median(lateness),
            "max": 1e3 * max(lateness)}
    # The comparison: a sample of the ok requests, drawn from the seed.
    pick = np.random.default_rng([seed, 3])
    k = min(traffic["sample"], len(ok))
    sample = [ok[i] for i in sorted(pick.choice(len(ok), k, replace=False))]
    served = {r.uid: (torch.as_tensor(r.result["cls"]),
                      torch.as_tensor(r.result["box"])) for r in sample}
    del engine, window, ok, table
    _free(dev)
    images = {j: torch.as_tensor(pool[j]) for j in
              sorted({image_of[r.uid] for r in sample})}
    calib_t = torch.as_tensor(calib, device=dev)
    expect = _reference_outputs(cfg, params, images, calib_t, rung, dev,
                                lower=False)
    if control:
        lower = _reference_outputs(cfg, params, images, calib_t, rung, dev,
                                   lower=True)
        served = {r.uid: lower[image_of[r.uid]] for r in sample}
    # The gap of the whole sample, cls and box apart: one relative norm
    # over every compared answer.  An int8 rounding flips wherever two
    # implementations' fp32 sums differ, and the flips spread through
    # the chained layers, so single answers swing more than the sample.
    gap = max(_rel(torch.stack([served[r.uid][i] for r in sample]),
                   torch.stack([expect[image_of[r.uid]][i] for r in sample]))
              for i in (0, 1)) if sample else math.inf
    notes["worst_answer_gap"] = max(
        (max(_rel(served[r.uid][i], expect[image_of[r.uid]][i])
             for i in (0, 1)) for r in sample), default=math.inf)
    limit = cfg["limits"]["serve_out_gap"]
    notes["compared"] = len(sample)
    return Outcome(values=values, run=run_rec,
                   checks={"out_gap": (gap, limit)},
                   attempted=attempted, failed=failed,
                   memory_peak_bytes=peak, notes=notes)


def arrivals(n: int, seconds: float, seed: int, order: int) -> np.ndarray:
    """Due times of ``n`` requests over ``seconds``, a Poisson process's:
    the gaps are the exponential distribution's n quantiles in an order
    fixed by the traffic file (``order``), so every seed meets the same
    bursts; the seed rotates the sequence, scaled to span the window."""
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q)
    np.random.default_rng(order).shuffle(gaps)
    gaps = np.roll(gaps, int(np.random.default_rng([seed, 2]).integers(n)))
    return np.cumsum(gaps) * (seconds / gaps.sum())


def _percentile(values: list[float], q: float) -> float:
    """The q-th percentile of all values by nearest rank: the smallest
    value that at least q% of them do not exceed (inf where that is a
    failed request)."""
    xs = sorted(values)
    if not xs:
        return math.inf
    return xs[max(0, math.ceil(q / 100.0 * len(xs)) - 1)]


@torch.no_grad()
def _reference_outputs(cfg, params, images: dict, calib, rung, dev, *,
                       lower: bool, block: int = 8) -> dict:
    """{pool index: (cls, box)} of the reference on the CPU-held images,
    in blocks of rows; ``lower`` computes it one precision down."""
    if rung in ("int8", "int8_chain"):
        qmax = 7.0 if lower else 127.0
        scales = ref.calibrate(params, cfg, calib, qmax=qmax)
        fwd = dict(dcl="int", scales=scales, qmax=qmax)
        mode = ref.tf32(False)
    else:
        fwd = {}
        mode = ref.tf32(lower)
    keys = list(images)
    out = {}
    with mode:
        for lo in range(0, len(keys), block):
            ks = keys[lo:lo + block]
            x = torch.stack([images[j] for j in ks]).to(dev)
            cls, box, _ = ref.forward(params, cfg, x, **fwd)
            for i, j in enumerate(ks):
                out[j] = (cls[i].cpu(), box[i].cpu())
    return out


# -- training -----------------------------------------------------------------

class WindowClosed(KeyboardInterrupt):
    """Raised from the Trainer's fault hook once the window has closed:
    the Trainer re-raises an interrupt without retrying or saving."""


def _leaf_norms(flat: dict) -> dict:
    """{path: norm} of a flat {path: tensor} mapping."""
    return {path: float(t.double().norm()) for path, t in flat.items()}


def _worst_leaf_gap(prog: dict, refs: dict, counted) -> float:
    """The largest ``|prog - ref|`` of a leaf's norm over the larger of
    the reference's norm of that leaf and of the median leaf."""
    med = statistics.median(refs[p] for p in counted)
    return max(abs(prog[p] - refs[p]) / max(refs[p], med) for p in counted)


def _median_leaf_gap(prog: dict, refs: dict, counted) -> float:
    """``_worst_leaf_gap``'s ratio of the median leaf instead of the
    worst."""
    med = statistics.median(refs[p] for p in counted)
    return statistics.median(abs(prog[p] - refs[p]) / max(refs[p], med)
                             for p in counted)


def _train(cfg, traffic, *, seed, seconds, spans, dev, t0, control):
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import train_optimizer
    from repro_torch.models import resnet_dcn as R
    from repro_torch.train import Trainer, TrainerConfig

    img, classes, batch = cfg["img_size"], cfg["num_classes"], \
        traffic["batch"]
    tc = cfg["train"]
    n_ref = traffic["ref_steps"]
    params = pb_data.make_params(ref.param_specs(cfg), seed, dev)
    p0 = {path: t.clone() for path, t in pb_data.tree_leaves(params)}
    batches = [pb_data.detection_batch(img, batch, classes, seed, step=s)
               for s in range(traffic["pool"])]
    pcfg = program_config(cfg)
    lam = tc["lam"]
    mesh = make_host_mesh(None if dev.type == "cuda" else [dev])

    def batch_fn(step):
        with spans.span("train/data"):
            return batches[step % len(batches)]

    def loss_fn(p, b):
        with spans.span("train/forward"):
            return R.train_loss(p, pcfg, b, lam=lam, device=dev)

    state: dict = {}

    def hook(step):
        tr = state["trainer"]
        if step > n_ref:
            spans.end("train/step")
            if clock() - state["t_start"] >= seconds:
                state["t_end"] = clock()
                raise WindowClosed
        if step == 1:
            state["mu1"] = {path: t.clone() for path, t in
                            pb_data.tree_leaves(tr.opt_state["mu"])}
        if step == n_ref:
            state["p_ref"] = {path: t.detach().clone() for path, t in
                              pb_data.tree_leaves(tr.params)}
            _sync(dev)
            spans.start()
            state["t_start"] = clock()
            state["done0"] = len(tr.step_seconds)
            state["skipped0"] = tr.telemetry["skipped"]
        if step >= n_ref:
            spans.begin("train/step")

    trainer = Trainer(
        loss_fn=loss_fn, params=params,
        optimizer=train_optimizer(cfg["arch"], params, 10**9),
        batch_fn=batch_fn,
        config=TrainerConfig(total_steps=10**9, ckpt_every=10**9,
                             ckpt_dir=tempfile.gettempdir()
                             + "/pb-train-ckpt-unused", log_every=1),
        fault_hook=hook, device=mesh.first_device, mesh=mesh)
    state["trainer"] = trainer
    try:
        trainer.run()
    except WindowClosed:
        pass
    trace_summary = spans.stop(lambda: _sync(dev))
    peak = _peak(dev)
    t_start, t_end = state["t_start"], state["t_end"]
    setup_s = t_start - t0
    window_s = t_end - t_start
    done = len(trainer.step_seconds) - state["done0"]
    attempted = trainer.step - n_ref
    failed = trainer.telemetry["skipped"] - state["skipped0"]
    losses = [h["loss"] for h in trainer.history
              if "loss" in h and h["step"] < n_ref]
    if len(losses) < n_ref:
        losses += [math.nan] * (n_ref - len(losses))
    p_after = state["p_ref"]
    mu1 = state["mu1"]
    del trainer, state, params
    _free(dev)
    wd = tc["weight_decay"]
    g_prog = {p: mu1[p] - wd * p0[p] for p in mu1}
    prog = {"losses": losses, "g": _leaf_norms(g_prog),
            "d": _leaf_norms({p: p_after[p] - p0[p] for p in p0})}
    del g_prog, mu1, p_after
    ref_batches = [{k: torch.as_tensor(v).to(dev) for k, v in b.items()}
                   for b in batches[:n_ref]]
    params0 = _nest(p0)
    expect = _reference_train(cfg, params0, ref_batches, tf32=False)
    if control:
        prog = _reference_train(cfg, params0, ref_batches, tf32=True)
    g_ref = expect["g"]
    med = statistics.median(g_ref.values())
    counted = [p for p in g_ref if g_ref[p] >= 1e-3 * med]
    loss_gaps = [abs(a - b) / abs(b)
                 for a, b in zip(prog["losses"], expect["losses"])]
    # The first step's loss and the median leaf's change: the later
    # steps of this random model amplify a rounding (PERF.md, section 2).
    checks = {
        "loss_gap": (loss_gaps[0], cfg["limits"]["train_loss_gap"]),
        "grad_gap": (_worst_leaf_gap(prog["g"], g_ref, counted),
                     cfg["limits"]["train_grad_gap"]),
        "step_gap": (_median_leaf_gap(prog["d"], expect["d"], counted),
                     cfg["limits"]["train_step_gap"]),
    }
    values = {"setup_s": setup_s,
              "train_images_per_s": done * batch / window_s}
    run_rec = Run(kind="train", window_s=window_s, images=done * batch,
                  steps=attempted,
                  flops_per_image=3 * pb_yard.forward_flops(cfg, img),
                  dcl_bound_s=attempted * pb_yard.dcl_bound_s(
                      cfg, img, batch, "train"),
                  trace=trace_summary)
    med = statistics.median(g_ref[p] for p in counted)
    worst = max(counted, key=lambda p: abs(prog["g"][p] - g_ref[p])
                / max(g_ref[p], med))
    notes = {"leaves_counted": len(counted), "leaves": len(g_ref),
             "grad_worst_leaf": "/".join(worst),
             "loss_gaps": loss_gaps,
             "grad_gap_median": _median_leaf_gap(prog["g"], g_ref, counted),
             "step_gap_worst": _worst_leaf_gap(prog["d"], expect["d"],
                                               counted)}
    return Outcome(values=values, run=run_rec, checks=checks,
                   attempted=attempted, failed=failed,
                   memory_peak_bytes=peak, notes=notes)


def _nest(flat: dict) -> dict:
    out: dict = {}
    for path, t in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return out


def _reference_train(cfg, params0, batches, *, tf32: bool) -> dict:
    tc = cfg["train"]
    with ref.tf32(tf32):
        losses, g, p_end = ref.train_steps(
            params0, cfg, batches, lam=tc["lam"], lr=tc["lr"],
            momentum=tc["momentum"], weight_decay=tc["weight_decay"],
            block=tc["reference_block"])
    p0 = dict(pb_data.tree_leaves(params0))
    return {"losses": losses, "g": _leaf_norms(g),
            "d": _leaf_norms({p: p_end[p] - p0[p] for p in p0})}


# -- the CPU tests' cut ---------------------------------------------------------

# Limits of the reduced configurations on the CPU: the plain versions
# agree with the reference to ~1e-5 on the forward and the first
# gradient; a random reduced model's third step moves by a few % where
# an Eq. 5 maximum or a tap's floor changes, so the training limits
# here are loose and the faults the CPU tests plant read 1 or more.
# At this size one int8 rounding that flips where the CPU sums in another
# order moves the outputs by ~1% (int4 reads 0.77), so the int8 limit
# is wider than the fp32 one.
CPU_LIMITS = {"serve_out_gap": 1e-3, "train_loss_gap": 0.05,
              "train_grad_gap": 1e-3, "train_step_gap": 0.3}
CPU_INT8_GAP = 0.05


def cpu_config(cfg: dict) -> dict:
    """The configuration cut for the CPU tests (``pb_spec``'s driver
    contract): one block a stage, narrow widths, 64^2 images, and the
    CPU's limits."""
    limits = dict(CPU_LIMITS)
    if cfg["serve_rung"] == "int8_chain":
        limits["serve_out_gap"] = CPU_INT8_GAP
    return dict(cfg, stage_sizes=[1, 1, 1, 1], widths=[32, 64, 128, 256],
                stem_width=16, num_dcn=2, num_classes=8, img_size=64,
                limits=limits)


def cpu_traffic(traffic: dict) -> dict:
    """The traffic shrunk for the CPU tests: two rows a step, a pool of
    four images and three compared, or a batch of two."""
    if traffic["kind"] == "train":
        return dict(traffic, batch=2)
    t = dict(traffic, slots=2, pool=4, sample=3)
    if t["kind"] == "serve_open":
        return dict(t, rate_per_s=6)
    return dict(t, depth=2)
