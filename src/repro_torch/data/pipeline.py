"""Deterministic, stateless synthetic data (counterpart of
``repro.data.pipeline``): ``lm_batch``, a token LM with learnable
structure, and ``detection_batch``, scenes for the DCN detector.

Every batch is a pure function of (seed, step, host shard), so a restart
regenerates any step exactly.  The generator is numpy, as in the JAX
package, so the same config and step give identical arrays in both.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class LMDataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    codebooks: int = 1
    seed: int = 0
    noise: float = 0.05          # fraction of uniformly-resampled tokens


def lm_batch(cfg: LMDataConfig, step: int, *, host_id: int = 0,
             num_hosts: int = 1) -> dict[str, np.ndarray]:
    """A noisy affine-mod sequence (token_{t+1} = 31 token_t + 17 mod V,
    a share ``noise`` resampled uniformly): tokens and next-token targets,
    int32 (B, S) or (B, S, codebooks)."""
    if cfg.global_batch % num_hosts:
        raise ValueError(f"global_batch={cfg.global_batch} does not split "
                         f"over {num_hosts} hosts")
    b = cfg.global_batch // num_hosts
    rng = np.random.RandomState(
        (cfg.seed * 1_000_003 + step * 7919 + host_id * 104729) % (2**31))
    a = 31 % cfg.vocab or 1
    c = 17 % cfg.vocab
    shape = (b, cfg.seq_len + 1)
    if cfg.codebooks > 1:
        shape = (b, cfg.seq_len + 1, cfg.codebooks)
    start = rng.randint(0, cfg.vocab, shape[:1] + shape[2:])
    seq = np.empty(shape, np.int64)
    seq[:, 0] = start
    for t in range(1, cfg.seq_len + 1):
        seq[:, t] = (seq[:, t - 1] * a + c) % cfg.vocab
    flip = rng.rand(*shape) < cfg.noise
    seq = np.where(flip, rng.randint(0, cfg.vocab, shape), seq)
    return {"tokens": seq[:, :-1].astype(np.int32),
            "targets": seq[:, 1:].astype(np.int32)}


@dataclasses.dataclass(frozen=True)
class DetectionDataConfig:
    img_size: int = 256
    global_batch: int = 8
    num_classes: int = 16
    max_objects: int = 4
    stride: int = 32             # head cell stride
    seed: int = 0


def detection_batch(cfg: DetectionDataConfig, step: int, *,
                    host_id: int = 0,
                    num_hosts: int = 1) -> dict[str, np.ndarray]:
    """Synthetic scenes (coloured rectangles on a textured background) and
    dense grid targets for the detection head: images (B, S, S, 3) f32,
    obj (B, Hc, Wc) f32, cls (B, Hc, Wc) int32, box (B, Hc, Wc, 4) f32."""
    if cfg.global_batch % num_hosts:
        raise ValueError(f"global_batch={cfg.global_batch} does not split "
                         f"over {num_hosts} hosts")
    b = cfg.global_batch // num_hosts
    hw, hc = cfg.img_size, cfg.img_size // cfg.stride
    rng = np.random.RandomState(
        (cfg.seed * 999_983 + step * 6007 + host_id * 31337) % (2**31))

    images = rng.rand(b, hw, hw, 3).astype(np.float32) * 0.25
    obj = np.zeros((b, hc, hc), np.float32)
    cls = np.zeros((b, hc, hc), np.int32)
    box = np.zeros((b, hc, hc, 4), np.float32)

    for i in range(b):
        for _ in range(rng.randint(1, cfg.max_objects + 1)):
            c = rng.randint(0, cfg.num_classes)
            w = rng.randint(hw // 8, hw // 2)
            h = rng.randint(hw // 8, hw // 2)
            x0 = rng.randint(0, hw - w)
            y0 = rng.randint(0, hw - h)
            color = (np.arange(3) == c % 3).astype(np.float32) * 0.5 + 0.25 \
                + rng.rand(3) * 0.25
            images[i, y0:y0 + h, x0:x0 + w] = color
            # centre cell target
            cy, cx = (y0 + h // 2) // cfg.stride, (x0 + w // 2) // cfg.stride
            cy, cx = min(cy, hc - 1), min(cx, hc - 1)
            obj[i, cy, cx] = 1.0
            cls[i, cy, cx] = c
            box[i, cy, cx] = [(y0 + h / 2) / hw, (x0 + w / 2) / hw,
                              h / hw, w / hw]
    return {"images": images, "obj": obj, "cls": cls, "box": box}
