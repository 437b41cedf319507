"""Parameter conversion from the JAX package's trees.

The JAX params (nested dicts of arrays) come in as nested dicts of numpy
arrays — the caller applies ``np.asarray`` — so this module never needs
JAX.  Tree names and layouts are the same in both packages.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device


def params_from_jax(tree: Any, *, device: str | torch.device | None = None):
    """Nested dict of numpy arrays -> the same tree of tensors on
    ``device``.  Each leaf is copied (JAX's host buffers are read-only)."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return torch.from_numpy(np.array(node, copy=True)).to(dev)

    return conv(tree)
