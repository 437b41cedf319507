"""Serve a model of the registry through the port's engines, at full
width unless ``--reduced``.

LM archs run the token slot engine (continuous batching):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
        [--requests 8] [--slots 4] [--cache-len 128] [--max-new-tokens 16] \
        [--ckpt DIR] [--reduced]

with seeded prompts of 4-12 tokens; a multi-codebook arch
(musicgen-medium) is refused, as the JAX launcher refuses it.  DCL
detection archs run the shape-bucketed engine:

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch resnet50_dcn_bounded --buckets 256,512 --requests 8 \
        [--slots 4] [--quant int8_chain] [--deadline 30] [--device cuda] \
        [--ckpt DIR] [--reduced] [--telemetry OUT.json]

and so does InternImage-B with bounded DCNv3 offsets
(``--arch internimage_b_bounded``), whose entry rung is ``fp32_kernel``:
it has no int8 datapath, so ``--quant`` defaults to the arch's top rung
(``int8_chain`` for the DCL archs) and the int8 rungs are refused there.

Params are random, from ``--seed``, unless ``--ckpt DIR`` restores them
from the newest complete checkpoint there: a params-only checkpoint (the
JAX launcher's layout) or the bundle a Trainer saves
(``repro_torch.launch.train``: params, optimizer state, the
error-feedback state of ``--grad-compression int8_ef`` if any, step), of
which the params are served.  ``--reduced`` serves the registry's
reduced config of the family (for the DCL archs what ``launch.train``
trains without ``--full``).  A checkpoint that does not fit the chosen config raises the
checkpoint's own error.  The int8 rungs (``int8_chain``, the default,
and ``int8``) are calibrated first, as the JAX launcher does: two seeded
images per bucket through the fp32 model give the scale table.  The
device defaults to ``cuda``; with no GPU the launcher raises unless
``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import time

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.checkpoint import restore_checkpoint
from repro_torch.checkpoint.checkpoint import stored_structure
from repro_torch.distributed.compression import init_ef_state
from repro_torch.launch.train import train_optimizer
from repro_torch.models import registry as reg
from repro_torch.models import resnet_dcn as R
from repro_torch.models import transformer as TF
from repro_torch.obs.trace import Tracer, tracer_scope
from repro_torch.quant.calibrate import calibrate_resnet_dcn
from repro_torch.serve import (LADDER, DCLServeConfig, DCLServingEngine,
                               Request, ServeConfig, ServingEngine)
from repro_torch.serve.dcl_engine import INT8_RUNGS, model_family
from repro_torch.train.trainer import checkpoint_bundle


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True,
                    choices=reg.det_names() + reg.names())
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--buckets", default="256,512",
                    help="comma-separated square shape buckets")
    ap.add_argument("--quant", default=None, choices=LADDER,
                    help="entry rung (default: int8_chain, fp32_kernel "
                         "for InternImage)")
    ap.add_argument("--deadline", type=float, default=None,
                    help="per-request deadline in seconds")
    ap.add_argument("--queue-capacity", type=int, default=64)
    ap.add_argument("--shed-policy", default="reject_new",
                    choices=("reject_new", "shed_oldest"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    ap.add_argument("--ckpt", default=None,
                    help="restore the served params from this checkpoint "
                         "directory")
    ap.add_argument("--reduced", action="store_true",
                    help="serve the reduced config of the family")
    ap.add_argument("--telemetry", default=None,
                    help="write engine telemetry JSON here")
    return ap


def restore_params(directory, params, arch: str):
    """Restore served params from the newest complete checkpoint in
    ``directory``: params-only (``params`` itself or ``{"params": ...}``)
    or a Trainer bundle (``checkpoint_bundle`` with ``arch``'s launcher
    optimizer, with or without the error-feedback state of
    ``grad_compression="int8_ef"``), picked by the stored leaf count and
    key paths.  Returns
    ``(params, step)``; a checkpoint that fits none of them raises the
    restore's own error, from the bundle template."""
    count, paths = stored_structure(directory)
    opt_state = train_optimizer(arch, params, 1).init(params)
    bundle = checkpoint_bundle(params, opt_state, 0)
    ef_bundle = checkpoint_bundle(params, opt_state, 0,
                                  init_ef_state(params))
    for like in (params, {"params": params}, bundle, ef_bundle):
        flat = T.leaves_with_paths(like)
        if len(flat) == count and (paths is None
                                   or paths == [q for q, _ in flat]):
            break
    restored, step = restore_checkpoint(directory, like)
    return (restored if like is params else restored["params"]), step


def load_params(init, args):
    """``init()`` (seeded params), or, with ``args.ckpt``, the params
    restored into them (``restore_params``)."""
    params = init()
    if args.ckpt:
        params, step = restore_params(args.ckpt, params, args.arch)
        print(f"restored params from step {step}")
    return params


def detection_config(args):
    """The detection config ``args`` serves: the arch's, or its reduced
    config under ``--reduced``."""
    cfg = reg.get(args.arch).config
    return reg.reduced_config(cfg) if args.reduced else cfg


def entry_rung(cfg, args) -> str:
    """``--quant``, or the top rung of the config's family."""
    return args.quant or model_family(cfg).RUNGS[0]


def _served_cfg(cfg):
    if cfg.offset_bound is None:
        cfg = dataclasses.replace(cfg, offset_bound=2.0)
    return dataclasses.replace(cfg, use_kernel=True)


def _buckets(args) -> tuple[int, ...]:
    return tuple(int(b) for b in args.buckets.split(","))


def calibrate(cfg: R.ResNetDCNConfig, params, args) -> dict:
    """Scale table of the int8 rungs: two images per bucket, seeded from
    ``args.seed + 1``, through the fp32 model on ``args.device``."""
    rng = np.random.RandomState(args.seed + 1)
    return calibrate_resnet_dcn(
        params, _served_cfg(cfg),
        [rng.randn(2, b, b, 3).astype(np.float32) for b in _buckets(args)],
        device=args.device)


def serve_detection(cfg, args, *, params=None, scale_table=None):
    """Build the engine, submit ``args.requests`` seeded images spread
    over the buckets, drain it.  Returns ``(engine, images, seconds)``;
    ``params``, when given, replaces the seeded init and ``--ckpt``
    (``load_params``).  The int8 rungs calibrate first (``calibrate``)
    unless ``scale_table`` is given."""
    cfg = _served_cfg(cfg)
    buckets = _buckets(args)
    quant = entry_rung(cfg, args)
    if params is None:
        params = load_params(lambda: model_family(cfg).init_params(
            cfg, seed=args.seed, device=args.device), args)
    # A family without the rung is refused by the engine, uncalibrated.
    if scale_table is None and quant in INT8_RUNGS \
            and quant in model_family(cfg).RUNGS:
        scale_table = calibrate(cfg, params, args)
    engine = DCLServingEngine(
        params, cfg,
        DCLServeConfig(buckets=buckets, slots=args.slots, quant=quant,
                       queue_capacity=args.queue_capacity,
                       shed_policy=args.shed_policy,
                       default_deadline=args.deadline),
        scale_table=scale_table, device=args.device)
    rng = np.random.RandomState(args.seed)
    images = [rng.randn(b, b, 3).astype(np.float32)
              for b in (buckets[i % len(buckets)]
                        for i in range(args.requests))]
    for img in images:
        engine.submit(img)
    t0 = time.monotonic()
    engine.run_until_drained()
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    return engine, images, time.monotonic() - t0


def report(engine: DCLServingEngine, seconds: float) -> str:
    ok = [r for r in engine.completed if r.outcome == "ok"]
    lats = sorted(r.latency_s() for r in ok)
    dev = engine.device
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    lines = [f"served {len(ok)}/{len(engine.completed)} requests on "
             f"{engine.scfg.quant} in {engine.steps} batched steps "
             f"({seconds:.3f}s, {len(ok) / max(seconds, 1e-9):.2f} images/s "
             f"on {where})"]
    if lats:
        lines.append(f"  p50 latency {lats[len(lats) // 2] * 1e3:.1f} ms, "
                     f"max {lats[-1] * 1e3:.1f} ms")
    lines.append(f"  counters: {engine.counters}")
    return "\n".join(lines)


def serve_lm(cfg: TF.ModelConfig, args, *, params=None):
    """Build the slot engine, submit ``args.requests`` prompts of 4-12
    tokens drawn from ``np.random.RandomState(0)`` (as the JAX launcher
    does), run until drained.  Returns ``(engine, steps, seconds)``;
    ``params``, when given, replaces the init from ``args.seed`` and
    ``--ckpt``.  A multi-codebook config is refused, as the JAX launcher
    refuses it: the engine keeps one token a slot."""
    if cfg.codebooks > 1:
        raise SystemExit("the slot engine tracks one token per slot; "
                         "multi-codebook decoding (musicgen) needs a "
                         "(slots, codebooks) token state — not wired yet")
    if params is None:
        params = load_params(lambda: TF.init_params(
            cfg, seed=args.seed, device=args.device), args)
    engine = ServingEngine(params, cfg,
                           ServeConfig(slots=args.slots,
                                       cache_len=args.cache_len),
                           device=args.device)
    rng = np.random.RandomState(0)
    for uid in range(args.requests):
        prompt = rng.randint(0, cfg.vocab,
                             rng.randint(4, 12)).astype(np.int32)
        engine.submit(Request(uid=uid, prompt=prompt,
                              max_new_tokens=args.max_new_tokens))
    t0 = time.monotonic()
    engine.run_until_drained()
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    return engine, engine.steps, time.monotonic() - t0


def report_lm(engine: ServingEngine, steps: int, seconds: float) -> str:
    dev = engine.device
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    toks = sum(len(r.output) for r in engine.completed)
    lines = [f"served {len(engine.completed)} requests / {toks} tokens in "
             f"{steps} batched steps ({seconds:.3f}s, "
             f"{toks / max(seconds, 1e-9):.1f} tok/s on {where})"]
    lines += [f"  req {r.uid}: {r.output[:8]}..."
              for r in engine.completed[:3]]
    return "\n".join(lines)


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if args.arch not in reg.det_names():
        arch = reg.get(args.arch)
        cfg = reg.reduced_config(arch) if args.reduced else arch.config
        engine, steps, seconds = serve_lm(cfg, args)
        print(report_lm(engine, steps, seconds))
        return
    # The telemetry's divergence rows are timed only under an enabled
    # tracer.
    with (tracer_scope(Tracer()) if args.telemetry
          else contextlib.nullcontext()):
        engine, _, seconds = serve_detection(detection_config(args), args)
    print(report(engine, seconds))
    if args.telemetry:
        from repro_torch.obs.metrics import dump_telemetry
        dump_telemetry(args.telemetry, engine.telemetry())
        print(f"  telemetry -> {args.telemetry}")


if __name__ == "__main__":
    main()
