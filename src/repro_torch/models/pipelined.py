"""Pipeline-parallel transformer forward, GPipe over the layer stack
(counterpart of ``repro.models.pipelined``).

The stacked periods are split into ``n_stages`` contiguous chunks, one a
device of the mesh's 'stage' axis (``distributed.pipeline.gpipe_forward``);
microbatches stream through them.  The embedding, the final norm and the
unembedding run outside the pipeline, on the tokens' device.

Scope, as in JAX: the train/eval forward (no KV caches), configs with no
prefix layers, ``n_periods % n_stages == 0``; the MoE aux loss is not
threaded through the single-activation stages.
"""
from __future__ import annotations

import torch

from repro_torch import tree as T
from repro_torch.distributed.pipeline import gpipe_forward

from . import layers as L
from .transformer import _LAYER_APPLY, ModelConfig, _embed, _logits

Tensor = torch.Tensor


def split_stage_params(params, cfg: ModelConfig, n_stages: int):
    """(n_periods, ...) stacked layers -> (n_stages, periods/stage, ...)."""
    assert not cfg.prefix, "pipelined path requires no prefix layers"
    assert cfg.n_periods % n_stages == 0, (cfg.n_periods, n_stages)
    pp = cfg.n_periods // n_stages
    return T.tree_map(lambda a: a.reshape((n_stages, pp) + a.shape[1:]),
                      params["layers"])


def pipelined_forward(params, cfg: ModelConfig, tokens: Tensor, *, mesh,
                      n_stages: int, microbatches: int,
                      axis_name: str = "stage") -> Tensor:
    """Returns logits (B, S, V); B must divide into ``microbatches``."""
    b, s = tokens.shape[0], tokens.shape[1]
    assert b % microbatches == 0
    stage_params = split_stage_params(params, cfg, n_stages)

    x = _embed(params, cfg, tokens, None)
    positions = torch.arange(s, device=x.device).expand(b, s)
    xs = x.reshape((microbatches, b // microbatches) + x.shape[1:])
    pos_mb = positions[: b // microbatches]

    def stage_fn(stage_p, act):
        pos = pos_mb.to(act.device)
        for i in range(next(iter(T.leaves(stage_p))).shape[0]):
            per = T.tree_map(lambda a: a[i], stage_p)
            for j, kind in enumerate(cfg.pattern):
                act, _, _ = _LAYER_APPLY[kind](
                    per[f"m{j}"], act, cfg, mode="train", cache=None,
                    positions=pos, cache_len=None)
        return act

    y = gpipe_forward(stage_fn, stage_params, xs, mesh=mesh,
                      axis_name=axis_name)
    y = y.reshape((b,) + y.shape[2:])
    y = L.apply_norm(params["final_norm"], y, cfg.norm)
    return _logits(params, cfg, y)
