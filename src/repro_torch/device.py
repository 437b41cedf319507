"""The device rule of the port.

An entry point runs on ``cuda`` unless its caller names another device.
Without a GPU and without an explicit ``device="cpu"`` it raises: nothing
drops quietly to the CPU.  Below the entry points, the device of the
tensors decides the path (plain PyTorch on the CPU, the kernel on CUDA).
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means ``cuda``.  A CUDA device without a usable GPU raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev


def check_on(device: torch.device, **tensors: torch.Tensor) -> None:
    """Raise unless every named tensor lies on ``device`` (by type)."""
    for name, t in tensors.items():
        if t.device.type != device.type:
            raise ValueError(
                f"{name} lies on {t.device}, but the call runs on {device}; "
                f"move it there or pass device={t.device.type!r}")
