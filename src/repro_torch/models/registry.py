"""Architecture registry: ``--arch <id>`` -> config and shape set
(counterpart of ``repro.models.registry``): the LMs (dense, MoE, RWKV-6,
the RG-LRU hybrid, multi-codebook audio and the VLM backbone), the
paper's two ResNet-50-DCN detectors and InternImage-B with bounded
DCNv3 offsets.

Each LM config module registers an ``ArchSpec`` with its published
configuration; ``names()`` lists them.  The detection configs are in
``repro_torch.configs.resnet50_dcn`` and ``repro_torch.configs.internimage``
(``det_names()``), which also hold their ``ArchSpec`` s; ``get`` finds
either kind.  ``runnable_cells`` and ``skipped_cells`` walk the LMs and
the ResNet-DCN detectors, as the JAX registry's do: the dry run
(``launch.steps``) builds no InternImage step, and the JAX package has
no InternImage.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any

import torch

from repro_torch.models.moe import MoEConfig
from repro_torch.models.rglru import RGLRUConfig
from repro_torch.models.rwkv6 import RWKVConfig
from repro_torch.models.transformer import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    kind: str               # train | prefill | decode | train_det | infer_det
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
    family: str             # dense | moe | ssm | hybrid | audio | vlm | cnn
    config: Any                       # ModelConfig or ResNetDCNConfig
    shapes: dict[str, ShapeSpec]
    long_context_ok: bool = False     # may run long_500k
    source: str = ""
    notes: str = ""
    # per-arch logical -> mesh rule overrides (dbrx: expert parallelism)
    rules_overrides: dict | None = None


_REGISTRY: dict[str, ArchSpec] = {}

ARCH_MODULES = ["tinyllama_1_1b", "glm4_9b", "deepseek_7b",
                "recurrentgemma_9b", "musicgen_medium", "pixtral_12b",
                "rwkv6_3b", "dbrx_132b", "grok_1_314b", "command_r_35b"]


def register(spec: ArchSpec) -> ArchSpec:
    _REGISTRY[spec.name] = spec
    return spec


def _ensure_loaded() -> None:
    if _REGISTRY:
        return
    for mod in ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{mod}")


def _det_specs() -> dict[str, ArchSpec]:
    from repro_torch.configs import internimage, resnet50_dcn
    return {**resnet50_dcn.SPECS, **internimage.SPECS}


def get(name: str) -> ArchSpec:
    """The LM or detection ``ArchSpec`` named ``name``."""
    _ensure_loaded()
    if name in _REGISTRY:
        return _REGISTRY[name]
    if name in _det_specs():
        return _det_specs()[name]
    raise KeyError(
        f"arch {name!r} is not in the port's registry, which has "
        f"{sorted(_REGISTRY)}; the DCL configs are "
        f"{sorted(_det_specs())} (repro_torch.configs.resnet50_dcn, "
        f"repro_torch.configs.internimage)")


def names() -> list[str]:
    """The LM archs."""
    _ensure_loaded()
    return sorted(_REGISTRY)


def det_names() -> list[str]:
    """The detection archs: the DCL detectors and InternImage."""
    return sorted(_det_specs())


def _dryrun_names() -> list[str]:
    """The archs of the dry run's cells: the LMs and the ResNet-DCN
    detectors (module docstring)."""
    from repro_torch.models.resnet_dcn import ResNetDCNConfig
    return sorted(names() + [n for n in det_names()
                             if isinstance(get(n).config, ResNetDCNConfig)])


LONG_CONTEXT_SKIP = ("full-attention arch: 0.5M-token dense KV/attn per "
                     "step is out of scope by design (DESIGN.md)")


def runnable_cells() -> list[tuple[str, str]]:
    """All (arch, shape) dry-run cells, honouring the long-context skip."""
    return [(name, shape_name)
            for name in _dryrun_names()
            for shape_name in get(name).shapes
            if shape_name != "long_500k" or get(name).long_context_ok]


def skipped_cells() -> list[tuple[str, str, str]]:
    """(arch, shape, reason) of each cell ``runnable_cells`` leaves out."""
    return [(name, shape_name, LONG_CONTEXT_SKIP)
            for name in _dryrun_names()
            for shape_name in get(name).shapes
            if shape_name == "long_500k" and not get(name).long_context_ok]


def reduced_config(arch: ArchSpec | ModelConfig):
    """Small same-family config for CPU tests: the same mixer pattern, GQA
    ratio, rotary fraction, biases and MoE routing at tiny widths, in
    fp32 (as the JAX package's); a detector keeps its DCL bound at four
    one-block stages, InternImage its offset bound and 16 channels a
    DCNv3 group at width 32 and depths 1/1/2/1.  Takes an ``ArchSpec`` or
    its config."""
    from repro_torch.models.internimage import InternImageConfig
    from repro_torch.models.resnet_dcn import ResNetDCNConfig
    cfg = arch.config if isinstance(arch, ArchSpec) else arch
    if isinstance(cfg, InternImageConfig):
        return dataclasses.replace(
            cfg, channels=32, depths=(1, 1, 2, 1), groups=(2, 4, 8, 16),
            num_classes=8, img_size=64)
    if isinstance(cfg, ResNetDCNConfig):
        return dataclasses.replace(
            cfg, stage_sizes=(1, 1, 1, 1), widths=(32, 64, 128, 256),
            stem_width=16, num_dcn=2, num_classes=8, img_size=64)
    plen = len(cfg.pattern)
    kw = dict(
        n_layers=plen * 2 + (cfg.n_layers % plen), d_model=64, n_heads=4,
        kv_heads=max(1, (4 * cfg.kv_heads) // cfg.n_heads), head_dim=16,
        d_ff=128, vocab=128, dtype=torch.float32, remat="none",
        name=cfg.name + "-reduced")
    if cfg.window is not None:
        kw["window"] = 16
    if cfg.moe is not None:
        kw["moe"] = MoEConfig(d_model=64, d_ff=128, num_experts=4,
                              top_k=min(2, cfg.moe.top_k),
                              kind=cfg.moe.kind)
    if cfg.rwkv is not None:
        kw["rwkv"] = RWKVConfig(d_model=64, d_ff=128, head_dim=16,
                                decay_lora_rank=8)
    if cfg.rglru is not None:
        kw["rglru"] = RGLRUConfig(d_model=64, d_rnn=64)
    return dataclasses.replace(cfg, **kw)
