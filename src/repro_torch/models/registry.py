"""Architecture registry: ``--arch <id>`` -> config and shape set
(counterpart of ``repro.models.registry`` for the LMs the port runs: the
dense ones and the RG-LRU hybrid).

Each ported config module registers an ``ArchSpec`` with its published
configuration.  The DCL detection configs are in
``repro_torch.configs.resnet50_dcn``; the other architectures of the JAX
registry wait in ROADMAP Queue A: RWKV-6 (item 7), MoE (item 8),
multi-codebook and VLM (item 9), command-r (item 10).
"""
from __future__ import annotations

import dataclasses
import importlib

import torch

from repro_torch.models.rglru import RGLRUConfig
from repro_torch.models.transformer import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    kind: str               # train | prefill | decode
    seq_len: int = 0
    global_batch: int = 1
    note: str = ""


# The LM-family shape set of the JAX registry.
LM_SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode", 32768, 128),
    "long_500k": ShapeSpec("decode", 524288, 1,
                           note="sub-quadratic archs only"),
}


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    name: str
    family: str                       # dense | hybrid
    config: ModelConfig
    shapes: dict[str, ShapeSpec]
    long_context_ok: bool = False     # may run long_500k
    source: str = ""
    notes: str = ""


_REGISTRY: dict[str, ArchSpec] = {}

ARCH_MODULES = ["tinyllama_1_1b", "glm4_9b", "deepseek_7b",
                "recurrentgemma_9b"]


def register(spec: ArchSpec) -> ArchSpec:
    _REGISTRY[spec.name] = spec
    return spec


def _ensure_loaded() -> None:
    if _REGISTRY:
        return
    for mod in ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{mod}")


def get(name: str) -> ArchSpec:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(
            f"arch {name!r} is not in the port's registry, which has "
            f"{sorted(_REGISTRY)}; the DCL configs are in "
            f"repro_torch.configs.resnet50_dcn, the other architectures "
            f"wait in ROADMAP Queue A items 7-10")
    return _REGISTRY[name]


def names() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


def reduced_config(arch: ArchSpec | ModelConfig) -> ModelConfig:
    """Small same-family config for CPU tests: the same mixer pattern, GQA
    ratio, rotary fraction and biases at tiny widths, in fp32 (as the JAX
    package's).  Takes an ``ArchSpec`` or its config."""
    cfg = arch.config if isinstance(arch, ArchSpec) else arch
    plen = len(cfg.pattern)
    kw = dict(
        n_layers=plen * 2 + (cfg.n_layers % plen), d_model=64, n_heads=4,
        kv_heads=max(1, (4 * cfg.kv_heads) // cfg.n_heads), head_dim=16,
        d_ff=128, vocab=128, dtype=torch.float32, remat="none",
        name=cfg.name + "-reduced")
    if cfg.window is not None:
        kw["window"] = 16
    if cfg.rglru is not None:
        kw["rglru"] = RGLRUConfig(d_model=64, d_rnn=64)
    return dataclasses.replace(cfg, **kw)
