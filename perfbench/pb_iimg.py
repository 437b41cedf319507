"""Cells of the InternImage configurations: the program's detection
serving engine, on the ``fp32_kernel`` rung, under a closed loop
(``serve_closed``: the queue always holds ``depth`` seeded images, every
step serves a full batch; ``images_per_s`` is the images retired ``ok``
in the window over its length).

``run(cfg, traffic, ...)`` follows ``pb_dcn``'s serving cells: weights
and images from the seed, the window's one shape warmed as set-up, the
window, the device's peak memory, the program's state freed, and a
sample of the window's answers compared with ``pb_ref_iimg`` on the
card.  It returns ``pb_dcn``'s ``Outcome`` with an ``IimgRun``: the
``Run`` the readers read, with the DCNv3 kernels' bound of the window
(``dcnv3_bound_s``) and, in a traced run, their device seconds and
launches in the trace (``dv3_s``, ``dv3_launches``: the kernels whose
bare name starts with ``dv3_``).

The yardstick (``forward_macs``, ``dcnv3_bound_s``) counts from layer
shapes alone and imports nothing of the program.  The program's modules
are imported inside ``run``, so a checkout without them fails there at
once.  ``control`` puts the reference computed with TF32 in the
program's place before the comparison, which must then fail.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import tempfile

import numpy as np
import torch

import pb_data
import pb_dcn
import pb_ref_iimg as ref
import pb_trace
import pb_yard

clock = pb_dcn.clock

DV3_PREFIX = "dv3_"


@dataclasses.dataclass
class IimgRun(pb_dcn.Run):
    dcnv3_bound_s: float = 0.0   # the DCNv3 kernels' bound, whole window


# -- the yardstick ------------------------------------------------------------

def stages(cfg: dict, img: int) -> list[dict]:
    """Each stage's extent, width, groups and depth at input ``img``: the
    stem takes the image to img/4, each later stage halves it."""
    e, out = img // 4, []
    for s, (depth, g) in enumerate(zip(cfg["depths"], cfg["groups"])):
        out.append(dict(e=e, c=cfg["channels"] * 2 ** s, groups=g,
                        depth=depth))
        e = -(-e // 2)
    return out


def forward_macs(cfg: dict, img: int) -> int:
    """Multiply-accumulates of one image's forward: the stem's two
    convolutions; in each layer the input and output projections, the
    depthwise convolution, the offset and mask projections and the MLP;
    the downsampling convolutions; the head.  The DCNv3 core's sampling
    is no product of weights and is left out."""
    k2 = cfg["kernel_size"] ** 2
    c0 = cfg["channels"]
    e1, e2 = -(-img // 2), -(-img // 4)
    macs = e1 * e1 * 9 * 3 * (c0 // 2) + e2 * e2 * 9 * (c0 // 2) * c0
    st = stages(cfg, img)
    for i, s in enumerate(st):
        c, p = s["c"], s["e"] * s["e"]
        hidden = int(c * cfg["mlp_ratio"])
        layer = 2 * c * c + k2 * c + c * s["groups"] * 3 * k2 \
            + 2 * c * hidden
        macs += s["depth"] * p * layer
        if i + 1 < len(st):
            eo = st[i + 1]["e"]
            macs += eo * eo * 9 * c * 2 * c
    e, cin, head = st[-1]["e"], st[-1]["c"], cfg["head_width"]
    macs += e * e * 9 * cin * head + e * e * head * (cfg["num_classes"] + 5)
    return macs


def forward_flops(cfg: dict, img: int) -> float:
    return 2.0 * forward_macs(cfg, img)


def _dcnv3_calls(cfg: dict, img: int, batch: int):
    """``(calls, bytes, operations)`` of each stage's DCNv3 core at
    ``batch`` images: v, the offsets, the mask logits and y, each once,
    fp32; 9 operations a channel and tap (the bilinear sample, its
    softmax weight, the sum)."""
    k2 = cfg["kernel_size"] ** 2
    for s in stages(cfg, img):
        p = batch * s["e"] * s["e"]
        yield (s["depth"], 4 * (2 * p * s["c"] + p * s["groups"] * 3 * k2),
               9 * p * s["c"] * k2)


PEAK_FP32_FLOPS = 67e12           # fp32 on the CUDA cores


def dcnv3_bytes(cfg: dict, img: int, batch: int) -> int:
    """The DCNv3 core's bytes of one forward at ``batch`` images."""
    return sum(d * b for d, b, _ in _dcnv3_calls(cfg, img, batch))


def dcnv3_bound_s(cfg: dict, img: int, batch: int) -> float:
    """The least time the card could take for the DCNv3 kernels of one
    forward at ``batch`` images: each call's bytes at the HBM rate or its
    operations at the fp32 rate of the CUDA cores (it has no tensor-core
    product), the larger, summed over calls."""
    return sum(d * max(b / pb_yard.PEAK_HBM_BYTES_PER_S,
                       ops / PEAK_FP32_FLOPS)
               for d, b, ops in _dcnv3_calls(cfg, img, batch))


# -- the traced window --------------------------------------------------------

def dv3_time(events: list[dict]) -> tuple[float, int]:
    """Seconds and launches of the ``dv3_`` kernels inside the window
    span of a trace's events."""
    window = [(e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("cat") == "user_annotation" and "dur" in e
              and e["name"] == pb_trace.WINDOW]
    if not window:
        return 0.0, 0
    w0, w1 = window[0]
    seconds, launches = 0.0, 0
    for e in events:
        if e.get("cat") != "kernel" or "dur" not in e or not \
                pb_yard.kernel_function(e["name"]).startswith(DV3_PREFIX):
            continue
        a, b = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
        if b > a:
            seconds += (b - a) * 1e-6
            launches += 1
    return seconds, launches


class Spans(pb_trace.Spans):
    """``pb_trace.Spans`` whose summary also holds the ``dv3_`` kernels'
    seconds and launches in the window (``dv3_time``)."""

    def stop(self, sync) -> dict | None:
        if not self.enabled:
            return None
        self.end(pb_trace.WINDOW)
        for name in list(self._open):
            self.end(name)
        sync()
        self._prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json", prefix="pb-trace-")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        self._prof = None
        out = pb_trace.reduce(events)
        out["dv3_s"], out["dv3_launches"] = dv3_time(events)
        return out


# -- the cell -----------------------------------------------------------------

def program_config(cfg: dict):
    """The program's model config of the configuration file's sizes."""
    from repro_torch.models import internimage as I
    return I.InternImageConfig(
        name=cfg["arch"], channels=cfg["channels"],
        depths=tuple(cfg["depths"]), groups=tuple(cfg["groups"]),
        kernel_size=cfg["kernel_size"], mlp_ratio=cfg["mlp_ratio"],
        offset_bound=cfg["offset_bound"], ln_eps=cfg["ln_eps"], num_classes=cfg["num_classes"],
        img_size=cfg["img_size"], use_kernel=True)


def run(cfg: dict, traffic: dict, *, seed: int, seconds: float,
        trace: bool, device: str, t0: float,
        control: bool = False) -> pb_dcn.Outcome:
    from repro_torch.models import internimage  # noqa: F401  (fails early)
    from repro_torch.serve import DCLServeConfig, DCLServingEngine
    if traffic["kind"] != "serve_closed":
        raise ValueError(f"pb_iimg runs serve_closed traffic only (got "
                         f"{traffic['kind']!r})")
    pb_dcn.apply_settings(cfg)
    dev = torch.device(device)
    spans = Spans(trace)
    img, classes = cfg["img_size"], cfg["num_classes"]
    slots = traffic["slots"]
    params = pb_data.make_params(ref.param_specs(cfg), seed, dev)
    pool = pb_data.detection_batch(img, traffic["pool"], classes, seed,
                                   step=0)["images"]
    engine = DCLServingEngine(
        params, program_config(cfg),
        DCLServeConfig(buckets=(img,), slots=slots, quant=cfg["serve_rung"],
                       queue_capacity=traffic["queue_capacity"]),
        device=dev)
    image_of: dict[int, int] = {}
    count = [0]

    def submit():
        j = count[0] % len(pool)
        image_of[engine.submit(pool[j]).uid] = j
        count[0] += 1

    for _ in range(2):                      # the window's one shape, warm
        while len(engine.queue) < slots:
            submit()
        engine.step()
    pb_dcn._sync(dev)
    n_warm = len(engine.completed)
    steps = 0
    spans.start()
    t_start = clock()
    setup_s = t_start - t0
    while True:
        with spans.span("bench/fill"):
            while len(engine.queue) < traffic["depth"]:
                submit()
        with spans.span("bench/step"):
            engine.step()
        steps += 1
        t_end = clock()
        if t_end - t_start >= seconds:
            break
    window = engine.completed[n_warm:]
    trace_summary = spans.stop(lambda: pb_dcn._sync(dev))
    peak = pb_dcn._peak(dev)
    ok = [r for r in window if r.outcome == "ok"]
    window_s = t_end - t_start
    run_rec = IimgRun(kind=traffic["kind"], window_s=window_s,
                      images=len(ok), steps=steps, rows=len(window),
                      slots=slots, flops_per_image=forward_flops(cfg, img),
                      dcnv3_bound_s=steps * dcnv3_bound_s(cfg, img, slots),
                      trace=trace_summary)
    values = {"setup_s": setup_s, "images_per_s": len(ok) / window_s}
    # The comparison: a sample of the ok requests, drawn from the seed.
    pick = np.random.default_rng([seed, 3])
    k = min(traffic["sample"], len(ok))
    sample = [ok[i] for i in sorted(pick.choice(len(ok), k, replace=False))]
    served = {r.uid: (torch.as_tensor(r.result["cls"]),
                      torch.as_tensor(r.result["box"])) for r in sample}
    attempted, failed = len(window), len(window) - len(ok)
    del engine, window, ok
    pb_dcn._free(dev)
    images = {j: torch.as_tensor(pool[j]) for j in
              sorted({image_of[r.uid] for r in sample})}
    expect = reference_outputs(cfg, params, images, dev, tf32=False)
    if control:
        lower = reference_outputs(cfg, params, images, dev, tf32=True)
        served = {r.uid: lower[image_of[r.uid]] for r in sample}
    # The larger relative L2 gap of cls and box over the whole sample.
    gap = max(pb_dcn._rel(torch.stack([served[r.uid][i] for r in sample]),
                          torch.stack([expect[image_of[r.uid]][i]
                                       for r in sample]))
              for i in (0, 1)) if sample else math.inf
    notes = {"compared": len(sample), "worst_answer_gap": max(
        (max(pb_dcn._rel(served[r.uid][i], expect[image_of[r.uid]][i])
             for i in (0, 1)) for r in sample), default=math.inf)}
    return pb_dcn.Outcome(
        values=values, run=run_rec,
        checks={"out_gap": (gap, cfg["limits"]["serve_out_gap"])},
        attempted=attempted, failed=failed, memory_peak_bytes=peak,
        notes=notes)


@torch.no_grad()
def reference_outputs(cfg, params, images: dict, dev, *, tf32: bool,
                      block: int = 8) -> dict:
    """{pool index: (cls, box)} of the reference on the CPU-held images,
    in blocks of rows; ``tf32`` computes it with TF32 products."""
    keys = list(images)
    out = {}
    with ref.tf32(tf32):
        for lo in range(0, len(keys), block):
            ks = keys[lo:lo + block]
            x = torch.stack([images[j] for j in ks]).to(dev)
            cls, box = ref.forward(params, cfg, x)
            for i, j in enumerate(ks):
                out[j] = (cls[i].cpu(), box[i].cpu())
    return out


# -- the CPU tests' cut -------------------------------------------------------

# The plain path and the reference agree to ~1e-6 at this size (the same
# fp32 arithmetic in other orders); a changed answer moves the gap by
# its own size.
CPU_LIMITS = {"serve_out_gap": 1e-4}


def cpu_config(cfg: dict) -> dict:
    """The configuration cut for the CPU tests (``pb_spec``'s driver
    contract): width 32 in groups of 16 channels, depths 1/1/2/1, 64^2
    images, 8 classes, and the CPU's limit."""
    return dict(cfg, channels=32, groups=[2, 4, 8, 16], depths=[1, 1, 2, 1],
                num_classes=8, img_size=64, limits=dict(CPU_LIMITS))


def cpu_traffic(traffic: dict) -> dict:
    """The traffic shrunk for the CPU tests: two rows a step, a pool of
    four images and three compared."""
    return dict(traffic, slots=2, depth=2, pool=4, sample=3)
