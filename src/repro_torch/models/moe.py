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
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models.layers import ParamDef, _gelu

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
                          params["w_router"].to(x.dtype)).float()
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


def moe_apply(params, x: Tensor, cfg: MoEConfig, *,
              full_capacity: bool = False) -> tuple[Tensor, Tensor]:
    """x: (B, S, D) -> (y in x's dtype, aux_loss fp32).

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

    if cfg.kind in ("swiglu", "geglu"):
        act = F.silu if cfg.kind == "swiglu" else _gelu
        g = torch.einsum("becd,edf->becf", ein,
                         params["w_gate"].to(x.dtype))
        u = torch.einsum("becd,edf->becf", ein, params["w_up"].to(x.dtype))
        h = act(g) * u
    else:
        h = _gelu(torch.einsum("becd,edf->becf", ein,
                               params["w_in"].to(x.dtype)))
    eout = torch.einsum("becf,efd->becd", h, params["w_out"].to(x.dtype))

    eflat = torch.cat([eout.reshape(b, e * cap, d),
                       eout.new_zeros((b, 1, d))], 1)
    back = torch.gather(eflat, 1, idx)                       # (B, SK, D)
    gk = (gates.reshape(b, s * k) * keep).to(x.dtype)
    y = (back * gk[..., None]).reshape(b, s, k, d).sum(2)

    frac = F.one_hot(experts, e).float().sum(2).mean((0, 1))
    aux = torch.sum(frac * probs.mean((0, 1))) * e / k
    return y, aux
