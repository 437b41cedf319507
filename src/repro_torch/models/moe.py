"""Mixture-of-Experts block: top-k routing with capacity (GShard-style),
the counterpart of ``repro.models.moe``.

Grouped scatter/gather dispatch, as in JAX: each batch row routes its
(token, k) choices into its own (E, cap) buffer, the experts run as one
batched product over E, and each choice gathers its expert's output back
and weighs it by its gate.  Capacity is per batch row: ``_capacity`` in
train and prefill (so a full expert drops the later choices), ``s * k``
slots with ``full_capacity`` (decode; drop-free).

Top-k keeps ``jax.lax.top_k``'s order: among equal probabilities the
lower expert index comes first (a stable descending sort).  The choices
are token-major, each token's k in a row (``repeat_interleave``, JAX's
``jnp.repeat``); a choice's place in its expert is the count of earlier
choices for that expert.  A dropped choice goes to a spare row past the
buffer that is thrown away; every kept row is written once, so the
scatter is deterministic on the card.

The load-balancing loss is a product of two batch means, so data shards
cannot add theirs: ``moe_apply(..., stats=True)`` returns each shard's
sums (``moe_stats``: choices and router probability per expert, and the
token count), the shards' sums meet, and ``aux_from_stats`` takes the
product once.

Under an active mesh (``sharding.use_rules(mesh=...)``) the experts run
per model shard.  Expert-parallel, where 'experts' maps to mesh axes that
divide E (dbrx-132b's ``experts -> model``): model shard j holds experts
``[j E/n, (j+1) E/n)``, takes their rows of the dispatch buffer, runs
only its experts and sends their outputs back (the expert exchange, an
all-to-all); each choice then reads its expert's row and the k choices
are weighed and summed in the flat order.  Tensor-parallel otherwise
(``experts -> None``, ``ff -> model``): each model shard runs every
expert on its ``ff`` block and the down projection is row-parallel
(fp32 partials meeting in ``layers._sum_partials``).  The router is
replicated: every shard routes alike.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (mesh_axes, move, position,
                                              shard_coords, shard_device,
                                              within)
from repro_torch.models.layers import (ParamDef, _gelu, _part,
                                       _row_parallel, _sum_partials, _w)

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int
    num_experts: int
    top_k: int
    capacity_factor: float = 1.25
    kind: str = "swiglu"          # expert MLP activation: swiglu | geglu | gelu
    router_softcap: float | None = None


def moe_def(cfg: MoEConfig) -> dict[str, ParamDef]:
    e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    defs = {"w_router": ParamDef((d, e), (None, None), scale=0.02),
            "w_out": ParamDef((e, f, d), ("experts", "ff", "embed"))}
    if cfg.kind in ("swiglu", "geglu"):
        defs["w_gate"] = ParamDef((e, d, f), ("experts", "embed", "ff"))
        defs["w_up"] = ParamDef((e, d, f), ("experts", "embed", "ff"))
    else:
        defs["w_in"] = ParamDef((e, d, f), ("experts", "embed", "ff"))
    return defs


def _capacity(tokens: int, cfg: MoEConfig) -> int:
    cap = int(tokens * cfg.top_k * cfg.capacity_factor / cfg.num_experts)
    return max(cap, cfg.top_k)


def route(params, x: Tensor, cfg: MoEConfig):
    """Router probabilities (B, S, E) fp32 and the top-k choices: gates
    normalised over k (fp32) and expert indices (B, S, K), ties to the
    lower index."""
    logits = torch.einsum("bsd,de->bse", x,
                          _w(params["w_router"], x)).float()
    if cfg.router_softcap is not None:
        logits = torch.tanh(logits / cfg.router_softcap) \
            * cfg.router_softcap
    probs = torch.softmax(logits, -1)
    vals, idx = torch.sort(probs, dim=-1, descending=True,
                           stable=True)
    gates, experts = vals[..., :cfg.top_k], idx[..., :cfg.top_k]
    return probs, gates / gates.sum(-1, keepdim=True), experts


def dispatch_slots(experts: Tensor, e: int, cap: int):
    """(slot, keep) of each choice, flattened token-major to (B, S*K):
    slot ``expert * cap + position`` for a kept choice, ``e * cap`` (the
    spare row) for a dropped one."""
    flat = experts.reshape(experts.shape[0], -1)
    onehot = F.one_hot(flat, e)
    pos = ((onehot.cumsum(1) - onehot) * onehot).sum(-1)
    keep = pos < cap
    return torch.where(keep, flat * cap + pos, e * cap), keep


def expert_split(cfg: MoEConfig) -> tuple[str, tuple[str, ...], int]:
    """How the experts run under the active mesh: ``("experts", axes,
    n)`` (expert-parallel), ``("ff", axes, n)`` (tensor-parallel) or
    ``("whole", (), 1)``, as the specs split the expert weights."""
    _, axes, n = mesh_axes("experts")
    if n > 1 and cfg.num_experts % n == 0:
        return "experts", axes, n
    _, axes, n = mesh_axes("ff")
    if n > 1 and cfg.d_ff % n == 0:
        return "ff", axes, n
    return "whole", (), 1


def _expert_mlp(w: dict, ein: Tensor, cfg: MoEConfig, *,
                partial: bool = False) -> Tensor:
    """The experts of ``w`` on their rows of the buffer: (B, E', cap, D)
    -> (B, E', cap, D), or a shard's fp32 partial of the down projection
    (``partial``)."""
    if cfg.kind in ("swiglu", "geglu"):
        act = F.silu if cfg.kind == "swiglu" else _gelu
        g = torch.einsum("becd,edf->becf", ein, w["w_gate"])
        u = torch.einsum("becd,edf->becf", ein, w["w_up"])
        h = act(g) * u
    else:
        h = _gelu(torch.einsum("becd,edf->becf", ein, w["w_in"]))
    if partial:
        return _row_parallel("becf,efd->becd", h, w["w_out"])
    return torch.einsum("becf,efd->becd", h, w["w_out"])


_IN = ("w_gate", "w_up", "w_in")


def _experts(params, ein: Tensor, cfg: MoEConfig) -> Tensor:
    """Every expert on its rows of the dispatch buffer, per model shard
    under the active mesh (module docstring)."""
    how, axes, n = expert_split(cfg)
    names = [k for k in _IN if k in params] + ["w_out"]
    if how == "whole":
        return _expert_mlp({k: _w(params[k], ein) for k in names}, ein, cfg)
    home, dt = ein.device, ein.dtype
    here = position()
    outs, parts = [], []
    for j in range(n):
        coords = shard_coords(axes, j)
        with within(coords):
            dev, at = shard_device(), position()
            if how == "experts":
                el = cfg.num_experts // n
                w = {k: _part(params[k], 0, j * el, el, dev, dt)
                     for k in names}
                rows = move(ein[:, j * el:(j + 1) * el], dev, here, at,
                            "all-to-all")
                out = _expert_mlp(w, rows, cfg)
            else:
                f = cfg.d_ff // n
                w = {k: _part(params[k], 1 if k == "w_out" else 2, j * f, f,
                              dev, dt) for k in names}
                parts.append((coords, _expert_mlp(w, ein.to(dev), cfg,
                                                  partial=True)))
        if how == "experts":
            outs.append(move(out, home, at, here, "all-to-all"))
    if how == "experts":
        return torch.cat(outs, 1)
    return _sum_partials(parts, dt, home)


def moe_stats(probs: Tensor, experts: Tensor, e: int) -> Tensor:
    """(2E + 1,) fp32 sums of a block of rows: the top-k choices of each
    expert (before any drop), the router probability of each expert, and
    the token count."""
    counts = F.one_hot(experts, e).float().sum((0, 1, 2))
    n = probs.new_tensor([float(probs.shape[0] * probs.shape[1])])
    return torch.cat([counts, probs.sum((0, 1)), n])


def aux_from_stats(stats: Tensor, e: int, k: int) -> Tensor:
    """The load-balancing loss of ``moe_stats`` sums (..., 2E + 1):
    sum over experts of the share of choices times the mean router
    probability, times E / k."""
    n = stats[..., -1:]
    frac, mean_prob = stats[..., :e] / n, stats[..., e:2 * e] / n
    return torch.sum(frac * mean_prob, -1) * e / k


def moe_apply(params, x: Tensor, cfg: MoEConfig, *,
              full_capacity: bool = False, stats: bool = False
              ) -> tuple[Tensor, Tensor]:
    """x: (B, S, D) -> (y in x's dtype, aux_loss fp32), or (y, the
    ``moe_stats`` sums) with ``stats``.

    aux_loss is the load-balancing loss: sum over experts of the share of
    top-k choices (before any drop) times the mean router probability,
    times E / k."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    cap = s * k if full_capacity else _capacity(s, cfg)
    probs, gates, experts = route(params, x, cfg)
    slot, keep = dispatch_slots(experts, e, cap)

    src = x.repeat_interleave(k, 1) * keep[..., None].to(x.dtype)
    idx = slot[..., None].expand(b, s * k, d)
    buf = x.new_zeros((b, e * cap + 1, d)).scatter_add(1, idx, src)
    ein = buf[:, :-1].reshape(b, e, cap, d)
    eout = _experts(params, ein, cfg)

    eflat = torch.cat([eout.reshape(b, e * cap, d),
                       eout.new_zeros((b, 1, d))], 1)
    back = torch.gather(eflat, 1, idx)                       # (B, SK, D)
    gk = (gates.reshape(b, s * k) * keep).to(x.dtype)
    y = (back * gk[..., None]).reshape(b, s, k, d).sum(2)

    sums = moe_stats(probs, experts, e)
    return y, (sums if stats else aux_from_stats(sums, e, k))
