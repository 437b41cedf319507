"""GPipe pipeline parallelism over a 'stage' mesh axis (counterpart of
``repro.distributed.pipeline``).

Stage ``s`` holds its params on the stage axis's ``s``-th device; the
microbatches stream through with the GPipe schedule, ``n_micro + n_stages
- 1`` ticks, in which stage ``s`` runs microbatch ``t - s`` at tick ``t``
and hands its activation to stage ``s + 1`` (``.to`` its device).  The
mesh is single-controller (``distributed.sharding``): the ticks run in
order on the host, and the (stage, tick) pairs JAX computes on a bubble
and discards are skipped.  The bubble fraction is ``(S-1) / (M+S-1)``.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch import tree as T

Tensor = torch.Tensor


def gpipe_forward(stage_fn: Callable[[Any, Tensor], Tensor],
                  stage_params: Any, xs: Tensor, *, mesh,
                  axis_name: str = "stage") -> Tensor:
    """Run microbatches through the pipeline stages.

    stage_fn:     (params_of_one_stage, activation) -> activation
    stage_params: tree with a leading axis of n_stages (stage ``s``'s slice
                  goes to the stage axis's ``s``-th device)
    xs:           (n_micro, ...) microbatch activations fed to stage 0
    returns:      (n_micro, ...) outputs of the last stage, on xs's device.
    """
    n_stages = mesh.shape[axis_name]
    n_micro = xs.shape[0]
    assert n_micro >= 1
    devs = [mesh.device_at({axis_name: s}) for s in range(n_stages)]
    params = [T.tree_map(lambda a, d=d, s=s: a[s].to(d), stage_params)
              for s, d in enumerate(devs)]
    carry: list[Tensor | None] = [None] * n_stages
    ys: list[Tensor | None] = [None] * n_micro
    for t in range(n_micro + n_stages - 1):
        nxt: list[Tensor | None] = [None] * n_stages
        for s in range(n_stages):
            mb = t - s
            if not 0 <= mb < n_micro:
                continue                   # a bubble: JAX discards it
            inp = xs[mb].to(devs[s]) if s == 0 else carry[s]
            out = stage_fn(params[s], inp)
            if s == n_stages - 1:
                ys[mb] = out.to(xs.device)
            else:
                nxt[s + 1] = out.to(devs[s + 1])
        carry = nxt
    return torch.stack(ys)


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    """GPipe bubble overhead: (S-1) / (M+S-1)."""
    return (n_stages - 1) / (n_micro + n_stages - 1)
