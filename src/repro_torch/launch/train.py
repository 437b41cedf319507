"""Train a DCL detection model or a registry LM through the port's
Trainer.

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch resnet50_dcn_bounded [--full] --steps 6 [--ckpt DIR] \
        [--ckpt-every 20] [--microbatches 1] [--lam 0.005] \
        [--global-batch 8] [--seed 0] [--device cuda] \
        [--grad-compression int8_ef]
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch tinyllama-1.1b [--full] --steps 50 [--seq-len 64] ...

The default is the JAX launcher's REDUCED config of the same family
(stages 1/1/1/1, widths 32...256, 2 DCLs, 64x64 images); ``--full`` trains
the published widths (512x512 images, 12 DCLs).  A bounded arch trains
with the Eq. 5 regularizer at lambda = 0.005 unless ``--lam`` says
otherwise, and every DCL runs the fused kernels: the forward kernel and
the fused backward kernel.  The unbounded arch (``resnet50_dcn``, the
lambda = 0 baseline) trains through the plain gather.  Params and data
come from ``--seed``; the run resumes from the latest checkpoint in
``--ckpt``.  The device defaults to ``cuda``.  The Trainer runs on the
host's mesh (``launch.mesh.make_host_mesh``: the visible CUDA devices as
the 'data' axis, or the CPU), so the DCLs split the batch over several
cards where there are several; ``--grad-compression int8_ef`` compresses
the gradients with error feedback (``distributed.compression``).

An LM arch (``repro_torch.models.registry``) trains the registry's
reduced config unless ``--full``, on ``lm_batch`` data of ``--seq-len``
tokens, with the JAX launcher's optimizer (``default_optimizer_for``
with a warm-up cosine from 3e-3 over 10 steps: AdamW below 90B params)
and the config's ``remat``.  Its params are laid out on the host mesh by
their specs (``param_defs`` under the mesh's rules), as JAX's launcher
does; a host mesh of several devices splits the batch over 'data' and
gathers the 'embed' blocks (FSDP) where a layer runs.
"""
from __future__ import annotations

import argparse
import dataclasses

from repro_torch.configs import resnet50_dcn as configs
from repro_torch.data import (DetectionDataConfig, LMDataConfig,
                              detection_batch, lm_batch)
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import DEFAULT_RULES, use_rules
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import layers as L
from repro_torch.models import registry as reg
from repro_torch.models import resnet_dcn as R
from repro_torch.models import transformer as TF
from repro_torch.optim import default_optimizer_for, warmup_cosine
from repro_torch.train import Trainer, TrainerConfig
from repro_torch.tree import leaves


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True,
                    choices=sorted(configs.ARCHS) + reg.names())
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--ckpt", default="build/train_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lam", type=float, default=0.0,
                    help="Eq. 5 lambda (default: 0.005 for a bounded arch)")
    ap.add_argument("--full", action="store_true",
                    help="train the published widths (default: reduced)")
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64,
                    help="tokens a sequence (LM archs)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    ap.add_argument("--grad-compression", choices=["int8_ef"], default=None)
    return ap


def host_mesh(args):
    """The run's mesh: every visible card for a CUDA run, the CPU for a
    CPU run."""
    dev = resolve_device(args.device)
    return make_host_mesh(None if dev.type == "cuda" else [dev])


def reduced_config(cfg: R.ResNetDCNConfig) -> R.ResNetDCNConfig:
    """The JAX registry's reduced config of the same family."""
    return dataclasses.replace(
        cfg, stage_sizes=(1, 1, 1, 1), widths=(32, 64, 128, 256),
        stem_width=16, num_dcn=2, num_classes=8, img_size=64)


def train_config(cfg: R.ResNetDCNConfig, args) -> R.ResNetDCNConfig:
    """The config a run trains: reduced unless ``--full``; a bounded arch
    on the kernels (the plain gather is no training path on the card)."""
    if not args.full:
        cfg = reduced_config(cfg)
    if cfg.offset_bound is not None:
        cfg = dataclasses.replace(cfg, use_kernel=True)
    return cfg


def train_optimizer(arch: str, params, steps: int):
    """The launcher's optimizer for ``arch`` (``default_optimizer_for``
    with a warm-up cosine schedule over ``steps``)."""
    n_params = sum(p.numel() for p in leaves(params))
    return default_optimizer_for(arch, n_params,
                                 warmup_cosine(3e-3, 10, steps))


def train_detection(cfg: R.ResNetDCNConfig, args, *, params=None,
                    chaos=None) -> Trainer:
    """Build the Trainer for ``cfg`` (see ``train_config``), resume from
    ``args.ckpt`` if it holds a checkpoint, and run to ``args.steps``.
    ``params`` replaces the seeded init when given; ``chaos`` (a
    ``resilience.ChaosHooks``) is bound to the Trainer's fault and batch
    hooks.  Returns the Trainer (its ``history``, ``telemetry`` and
    ``step_seconds``)."""
    cfg = train_config(cfg, args)
    lam = args.lam or (0.005 if cfg.offset_bound else 0.0)
    if params is None:
        params = R.init_params(cfg, seed=args.seed, device=args.device)
    data = DetectionDataConfig(img_size=cfg.img_size,
                               global_batch=args.global_batch,
                               num_classes=cfg.num_classes, seed=args.seed)
    opt = train_optimizer(args.arch, params, args.steps)
    mesh = host_mesh(args)
    trainer = Trainer(
        loss_fn=lambda p, b: R.train_loss(p, cfg, b, lam=lam,
                                          device=args.device),
        params=params, optimizer=opt,
        batch_fn=lambda step: detection_batch(data, step),
        config=TrainerConfig(total_steps=args.steps,
                             ckpt_every=args.ckpt_every,
                             ckpt_dir=args.ckpt, log_every=args.log_every,
                             microbatches=args.microbatches,
                             grad_compression=args.grad_compression),
        fault_hook=None if chaos is None else chaos.fault_hook,
        batch_hook=None if chaos is None else chaos.batch_hook,
        device=mesh.first_device, mesh=mesh)
    if chaos is not None:
        chaos.bind(trainer)
    if trainer.try_resume():
        print(f"resumed from step {trainer.step}")
    trainer.run()
    return trainer


def train_lm(cfg: TF.ModelConfig, args, *, params=None) -> Trainer:
    """Build the Trainer for the LM ``cfg`` (the registry's reduced
    config of it unless ``args.full``), resume from ``args.ckpt`` if it
    holds a checkpoint, and run to ``args.steps``.  ``params`` replaces
    the seeded init when given.  Returns the Trainer."""
    if not args.full:
        cfg = reg.reduced_config(cfg)
    if params is None:
        params = TF.init_params(cfg, seed=args.seed, device=args.device)
    data = LMDataConfig(vocab=cfg.vocab, seq_len=args.seq_len,
                        global_batch=args.global_batch,
                        codebooks=cfg.codebooks, seed=args.seed)
    opt = default_optimizer_for(args.arch, cfg.param_count(),
                                warmup_cosine(3e-3, 10, args.steps))
    mesh = host_mesh(args)
    overrides = reg.get(args.arch).rules_overrides
    rules = {**DEFAULT_RULES, **overrides} if overrides else None
    with use_rules(rules, mesh=mesh):
        specs = L.spec_tree(TF.param_defs(cfg))
    trainer = Trainer(
        loss_fn=lambda p, b: TF.loss_fn(p, cfg, b), params=params,
        optimizer=opt, batch_fn=lambda step: lm_batch(data, step),
        config=TrainerConfig(total_steps=args.steps,
                             ckpt_every=args.ckpt_every,
                             ckpt_dir=args.ckpt, log_every=args.log_every,
                             microbatches=args.microbatches,
                             grad_compression=args.grad_compression),
        device=mesh.first_device, mesh=mesh, param_specs=specs,
        rules=rules)
    if trainer.try_resume():
        print(f"resumed from step {trainer.step}")
    trainer.run()
    return trainer


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    print(f"arch={args.arch} ({'full' if args.full else 'reduced'}), "
          f"device={args.device or 'cuda'}, mesh={host_mesh(args).shape}")
    if args.arch in configs.ARCHS:
        trainer = train_detection(configs.get(args.arch), args)
    else:
        trainer = train_lm(reg.get(args.arch).config, args)
    for h in trainer.history:
        print(h)
    print(f"median step {trainer.median_step_sec() * 1e3:.1f} ms")


if __name__ == "__main__":
    main()
