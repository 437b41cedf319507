"""Mesh construction (counterpart of ``repro.launch.mesh``).

Functions, not module constants: importing this module touches no device.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.distributed.sharding import Mesh


def visible_devices() -> list[torch.device]:
    """Every CUDA device of this process, else the CPU."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return [torch.device("cuda", i) for i in range(n)] \
        or [torch.device("cpu")]


def make_production_mesh(devices: Sequence | None = None, *,
                         multi_pod: bool = False) -> Mesh:
    """Single pod: (data=16, model=16) over 256 devices; multi-pod: (pod=2,
    data=16, model=16) over 512.  Raises unless exactly that many devices
    are given (default: the visible ones), as ``jax.make_mesh`` does."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    devs = list(visible_devices() if devices is None else devices)
    want = 1
    for s in shape:
        want *= s
    if len(devs) != want:
        raise ValueError(
            f"the production mesh {dict(zip(axes, shape))} needs {want} "
            f"devices, got {len(devs)}")
    import numpy as np
    return Mesh(np.asarray(devs, dtype=object).reshape(shape), axes)


def make_host_mesh(devices: Sequence | None = None) -> Mesh:
    """(n, 1) over ('data', 'model'): the given devices, default the
    visible ones.  A caller may repeat a device (tests, ``chip_smoke.py``)
    to run n shards on one."""
    devs = list(visible_devices() if devices is None else devices)
    return Mesh([[d] for d in devs], ("data", "model"))
