"""Public entry point of the bounded DCL kernel (counterpart of
``repro.kernels.ops``, fp32 zero-copy forward only).

* ``offset_bound`` given (the Eq. 5-trained model): the fused kernel of
  ``deform_conv_fused`` through ``plan.bounded_forward``.
* ``offset_bound`` None (the lambda=0 baseline): the plain gather of
  ``core.deform_conv`` — there is no kernel for unbounded offsets.

The device of the call is explicit (``device=None`` means ``cuda``) and
the tensors must lie on it; the tensors' device then picks the kernel
(CUDA) or its plain version (CPU).  A kernel failure raises: unlike the
JAX package there is no silent fallback to the reference path.  The
backward kernel is not ported yet, so on CUDA an input that needs a
gradient raises.

``dispatch_hook_scope`` installs a callable that sees a context dict
before each bounded dispatch; raising from it aborts the call.  It is
the fault-injection seam the serving engine's ladder is tested through.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.core.deform_conv import DCLConfig, sample_patches
from repro_torch.device import check_on, resolve_device
from repro_torch.kernels import plan as _plan

Tensor = torch.Tensor

_dispatch_hook = None


@contextlib.contextmanager
def dispatch_hook_scope(hook):
    """Install ``hook(context)`` around a block, restoring the previous
    hook afterwards."""
    global _dispatch_hook
    prev, _dispatch_hook = _dispatch_hook, hook
    try:
        yield
    finally:
        _dispatch_hook = prev


def check_channel_tiles(c: int, m: int, tile_c: int | None,
                        tile_m: int | None = None) -> None:
    """Reject channel tiles that do not divide the layer."""
    if tile_c is not None and c % tile_c != 0:
        raise ValueError(
            f"tile_c={tile_c} does not divide C={c}; the fused kernel steps "
            f"the channel axis in contiguous tile_c chunks — pass a divisor "
            f"of C (or tile_c=None for the chooser)")
    if tile_m is not None and m % tile_m != 0:
        raise ValueError(
            f"tile_m={tile_m} does not divide M={m}; pass a divisor of M "
            f"(or tile_m=None for the chooser)")


def deform_conv(x: Tensor, offsets: Tensor, w: Tensor, *,
                kernel_size: int = 3, stride: int = 1, dilation: int = 1,
                offset_bound: float | None = None,
                tile_h: int | None = None, tile_w: int | None = None,
                tile_c: int | None = None, tile_m: int | None = None,
                device: str | torch.device | None = None) -> Tensor:
    """Fused DCL stage 1+2: y = g(x, o) * w_deform (Eq. 2).

    x: (N, H, W, C); offsets: (N, Ho, Wo, 2*K*K); w: (K*K, C, M).
    Returns (N, Ho, Wo, M).  Unspecified tiles come from the Hopper
    chooser (``core.tiling.choose_kernel_tiles``).
    """
    dev = resolve_device(device)
    check_on(dev, x=x, offsets=offsets, w=w)
    n, _, _, c = x.shape
    m = w.shape[-1]
    ho, wo = offsets.shape[1], offsets.shape[2]
    k2 = kernel_size * kernel_size
    check_channel_tiles(c, m, tile_c, tile_m)

    if offset_bound is None:
        cfg = DCLConfig(in_channels=c, out_channels=m,
                        kernel_size=kernel_size, stride=stride,
                        dilation=dilation)
        patches = sample_patches(x, offsets.reshape(n, ho, wo, k2, 2), cfg)
        return torch.einsum("nhwkc,kcm->nhwm", patches.float(),
                            w.float()).to(x.dtype)

    if dev.type == "cuda" and torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, offsets, w)):
        raise NotImplementedError(
            "deform_conv on CUDA is forward-only: the fused backward kernel "
            "arrives with the training slice of the port; run under "
            "torch.no_grad() or on the CPU")
    if _dispatch_hook is not None:
        _dispatch_hook({"op": "deform_conv", "precision": "fp32",
                        "shape": tuple(x.shape), "m": m,
                        "offset_bound": offset_bound,
                        "kernel_size": kernel_size, "stride": stride,
                        "dilation": dilation, "device": dev.type})
    spec = _plan.DCSpec(kernel_size=kernel_size, stride=stride,
                        dilation=dilation, offset_bound=offset_bound,
                        tile_h=tile_h, tile_w=tile_w, tile_c=tile_c,
                        tile_m=tile_m)
    return _plan.bounded_forward(spec, x, offsets, w)
