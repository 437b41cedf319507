"""Receptive-field regularization — the paper's Eq. 5 (counterpart of
``repro.core.rf_regularizer``).

    Loss = (1 - lambda) * L + lambda * max_{l in D} o_max^l ,  0 <= lambda < 1

where ``D`` is the set of deformable layers and ``o_max^l`` is Eq. 3 on
layer ``l``'s raw offsets.  The hard max is the paper's: its subgradient
flows only into the single largest offset.  ``smoothness = t > 0`` takes
``t * logsumexp(o / t)`` instead, which spreads the gradient over the
near-maximal offsets.
"""
from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from repro_torch.core.deform_conv import receptive_field

Tensor = torch.Tensor


def network_offset_max(o_maxes: Sequence[Tensor] | Tensor, *,
                       smoothness: float = 0.0) -> Tensor:
    """max_{l in D} o_max^l over the per-layer Eq. 3 statistics; with
    ``smoothness = t > 0``, the smooth upper bound ``t * logsumexp(o / t)``.
    """
    o = o_maxes if isinstance(o_maxes, Tensor) else torch.stack(
        list(o_maxes))
    if smoothness and smoothness > 0.0:
        return smoothness * torch.logsumexp(o / smoothness, dim=0)
    return o.amax()


def regularized_loss(task_loss: Tensor, o_maxes: Sequence[Tensor] | Tensor,
                     lam: float, *, smoothness: float = 0.0) -> Tensor:
    """Eq. 5.  ``lam`` must satisfy 0 <= lam < 1."""
    if not 0.0 <= lam < 1.0:
        raise ValueError(f"lambda must be in [0, 1), got {lam}")
    if lam == 0.0:
        return task_loss
    penalty = network_offset_max(o_maxes, smoothness=smoothness)
    return (1.0 - lam) * task_loss + lam * penalty


class OffsetStats:
    """Running collector of per-layer o_max statistics during eval, for
    the paper's Fig. 7 histogram: the Eq. 3 value of every DCL over a
    validation set, histogrammed by per-image network maximum."""

    def __init__(self) -> None:
        self.per_image_max: list[float] = []
        self.per_layer_max: dict[str, float] = {}

    def update(self, layer_maxes: Mapping[str, Tensor]) -> None:
        vals = {k: float(v) for k, v in layer_maxes.items()}
        for k, v in vals.items():
            self.per_layer_max[k] = max(self.per_layer_max.get(k, 0.0), v)
        if vals:
            self.per_image_max.append(max(vals.values()))

    def network_max(self) -> float:
        return max(self.per_layer_max.values()) if self.per_layer_max \
            else 0.0

    def histogram(self, bins: int = 32) -> tuple[list[float], list[int]]:
        if not self.per_image_max:
            return [], []
        counts, edges = np.histogram(self.per_image_max, bins=bins)
        return list(map(float, edges)), list(map(int, counts))

    def compression_vs(self, other: "OffsetStats",
                       kernel_size: int = 3) -> float:
        """RF compression ratio (paper: 12.6x between lambda=0 and
        0.005)."""
        rf_self = receptive_field(kernel_size, self.network_max())
        rf_other = receptive_field(kernel_size, other.network_max())
        return rf_other / rf_self
