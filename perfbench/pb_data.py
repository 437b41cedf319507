"""Inputs and weights made from ``--seed``: the same seed gives the same
images, batches and weights, on both sides of the comparison.

``detection_batch`` is a frozen copy of ``repro_torch/data/pipeline.py``'s
generator (coloured rectangles on a textured background, dense grid
targets for the head); ``make_params`` draws a model's weights on the
device in one call to the generator, from a tree of parameter specs.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def detection_batch(img_size: int, batch: int, num_classes: int,
                    seed: int, step: int, *, max_objects: int = 4,
                    stride: int = 32) -> dict[str, np.ndarray]:
    """Synthetic scenes and their targets: images (B, S, S, 3) f32, obj
    (B, Hc, Wc) f32, cls (B, Hc, Wc) int32, box (B, Hc, Wc, 4) f32."""
    hw, hc = img_size, img_size // stride
    rng = np.random.RandomState((seed * 999_983 + step * 6007) % (2**31))
    images = rng.rand(batch, hw, hw, 3).astype(np.float32) * 0.25
    obj = np.zeros((batch, hc, hc), np.float32)
    cls = np.zeros((batch, hc, hc), np.int32)
    box = np.zeros((batch, hc, hc, 4), np.float32)
    for i in range(batch):
        for _ in range(rng.randint(1, max_objects + 1)):
            c = rng.randint(0, num_classes)
            w = rng.randint(hw // 8, hw // 2)
            h = rng.randint(hw // 8, hw // 2)
            x0 = rng.randint(0, hw - w)
            y0 = rng.randint(0, hw - h)
            color = (np.arange(3) == c % 3).astype(np.float32) * 0.5 + 0.25 \
                + rng.rand(3) * 0.25
            images[i, y0:y0 + h, x0:x0 + w] = color
            cy, cx = (y0 + h // 2) // stride, (x0 + w // 2) // stride
            cy, cx = min(cy, hc - 1), min(cx, hc - 1)
            obj[i, cy, cx] = 1.0
            cls[i, cy, cx] = c
            box[i, cy, cx] = [(y0 + h / 2) / hw, (x0 + w / 2) / hw,
                              h / hw, w / hw]
    return {"images": images, "obj": obj, "cls": cls, "box": box}


def tree_leaves(tree, prefix=()):
    """``(path, leaf)`` of every leaf of a nested dict, keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def make_params(specs, seed: int, device) -> dict:
    """Weights of a spec tree (leaves ``(shape, init, std)``, init
    ``"normal"``, ``"zeros"`` or ``"ones"``) drawn on ``device``: one
    normal draw for every random leaf, split and scaled leaf by leaf."""
    leaves = list(tree_leaves(specs))
    sizes = [math.prod(s[0]) if s[1] == "normal" else 0 for _, s in leaves]
    gen = torch.Generator(device=device).manual_seed(seed)
    draw = torch.randn(sum(sizes), generator=gen, device=device)
    out: dict = {}
    start = 0
    for (path, (shape, init, std)), size in zip(leaves, sizes):
        if init == "normal":
            t = draw[start:start + size].view(shape).mul(std)
            start += size
        elif init == "zeros":
            t = torch.zeros(shape, device=device)
        elif init == "ones":
            t = torch.ones(shape, device=device)
        else:
            raise ValueError(f"unknown init {init!r} at {'/'.join(path)}")
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return out
