"""Parameter conversion from the JAX package's trees.

The JAX params and caches (nested dicts of arrays) come in as nested
dicts of numpy arrays — the caller applies ``np.asarray`` — so this module
never needs JAX.  Tree names and layouts are the same in both packages.
A bf16 leaf arrives with ``ml_dtypes``' bfloat16 dtype, which
``torch.from_numpy`` does not take; it crosses as its 16-bit patterns.
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
        arr = np.array(node, copy=True)
        if arr.dtype.name == "bfloat16":
            return torch.from_numpy(arr.view(np.uint16)) \
                .view(torch.bfloat16).to(dev)
        return torch.from_numpy(arr).to(dev)

    return conv(tree)
