"""Optimizers: SGD with momentum (the paper's), AdamW, Adafactor
(counterpart of ``repro.optim.optimizers``).

``Optimizer(init, update)`` over nested dicts of tensors, with
``update(grads, state, params, step) -> (params, state)``.  The update
formulas are the JAX package's, weight decay and epsilon included (not
``torch.optim``'s, which place both elsewhere).  Unlike JAX, ``update``
writes the new values into ``params`` and ``state`` in place and returns
the same trees; the caller runs it under ``torch.no_grad()`` and decides
beforehand whether the step is taken (see ``train.trainer``).

Params placed on a mesh (``distributed.sharding.Placed``) carry state
placed the same way (``opt_state_specs``): SGD and AdamW update each
block in place on its device, ``global_norm`` and the clip count each
distinct block once (a replicated leaf is one block).  Adafactor's
factored moments and its update-RMS clip reduce over a whole leaf, so it
refuses a placed leaf (plain leaves, whole on one device, it takes).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch import tree as T
from repro_torch.distributed.sharding import is_placed

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, int], tuple[Any, Any]]


def global_norm(grads) -> Tensor:
    """sqrt of the sum of squares of every leaf, in fp32: every distinct
    block of a placed leaf once, the sums meeting in leaf order on the
    first leaf's device."""
    blocks = T.leaves(grads)
    dev = blocks[0].device
    return torch.sqrt(sum(torch.sum(torch.square(g.float())).to(dev)
                          for g in blocks))


def _clipped(grads, max_norm: float | None):
    if max_norm is None:
        return grads
    scale = torch.clamp_max(max_norm / (global_norm(grads) + 1e-9), 1.0)
    return T.tree_map(
        lambda g: (g.float() * scale.to(g.device)).to(g.dtype), grads)


def _zeros_like(p: Tensor, shape=None) -> Tensor:
    return torch.zeros(p.shape if shape is None else shape,
                       dtype=torch.float32, device=p.device)


def _assign(p: Tensor, value: Tensor) -> None:
    p.copy_(value.to(p.dtype))


# -- SGD + momentum (the paper trains with SGD, lr 0.005, momentum 0.9) ------

def sgd(lr_fn, *, momentum: float = 0.9, weight_decay: float = 0.0,
        max_norm: float | None = None) -> Optimizer:
    def init(params):
        return {"mu": T.tree_map(_zeros_like, params)}

    def update(grads, state, params, step):
        grads = _clipped(grads, max_norm)
        lr = lr_fn(step)

        def upd(g, mu, p):
            g = g.float()
            if weight_decay:
                g = g + weight_decay * p.float()
            mu.mul_(momentum).add_(g)
            _assign(p, p.float() - lr * mu)

        T.tree_map(upd, grads, state["mu"], params)
        return params, state

    return Optimizer("sgd", init, update)


# -- AdamW -------------------------------------------------------------------

def adamw(lr_fn, *, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1,
          max_norm: float | None = 1.0) -> Optimizer:
    def init(params):
        return {"m": T.tree_map(_zeros_like, params),
                "v": T.tree_map(_zeros_like, params)}

    def update(grads, state, params, step):
        grads = _clipped(grads, max_norm)
        lr = lr_fn(step)
        t = float(step) + 1.0
        c1 = 1.0 - b1 ** t
        c2 = 1.0 - b2 ** t

        def upd(g, m, v, p):
            g = g.float()
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * torch.square(g))
            step_ = (m / c1) / (torch.sqrt(v / c2) + eps)
            if weight_decay:
                step_ = step_ + weight_decay * p.float()
            _assign(p, p.float() - lr * step_)

        T.tree_map(upd, grads, state["m"], state["v"], params)
        return params, state

    return Optimizer("adamw", init, update)


# -- Adafactor (factored second moments) -------------------------------------

def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def adafactor(lr_fn, *, decay_pow: float = 0.8, eps: float = 1e-30,
              clip_rms: float = 1.0, weight_decay: float = 0.0,
              max_norm: float | None = 1.0) -> Optimizer:
    def state_for(p):
        if is_placed(p):
            raise ValueError(
                f"adafactor reduces its factored moments and its update "
                f"RMS over a whole leaf, so it takes no placed leaf "
                f"({p!r}); place the params with specs that split "
                f"nothing, or train with sgd or adamw")
        if _factored(p.shape):
            return {"vr": _zeros_like(p, p.shape[:-1]),
                    "vc": _zeros_like(p, p.shape[:-2] + (p.shape[-1],))}
        return {"v": _zeros_like(p)}

    def init(params):
        return {"f": T.tree_map(state_for, params, is_leaf=is_placed)}

    def update(grads, state, params, step):
        grads = _clipped(grads, max_norm)
        lr = lr_fn(step)
        beta2 = 1.0 - (float(step) + 1.0) ** (-decay_pow)

        def upd(g, s, p):
            g = g.float()
            g2 = torch.square(g) + eps
            if "vr" in s:
                vr, vc = s["vr"], s["vc"]
                vr.mul_(beta2).add_((1 - beta2) * g2.mean(-1))
                vc.mul_(beta2).add_((1 - beta2) * g2.mean(-2))
                r = vr / torch.clamp_min(vr.mean(-1, keepdim=True), eps)
                u = g / (torch.sqrt(r)[..., None]
                         * torch.sqrt(vc)[..., None, :] + eps)
            else:
                v = s["v"]
                v.mul_(beta2).add_((1 - beta2) * g2)
                u = g / (torch.sqrt(v) + eps)
            rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-12)
            u = u / torch.clamp_min(rms / clip_rms, 1.0)
            if weight_decay:
                u = u + weight_decay * p.float()
            _assign(p, p.float() - lr * u)

        # The state tree holds one dict per param leaf: walk the params.
        for path, g in T.leaves_with_paths(grads):
            s, p = state["f"], params
            for k in path:
                s, p = s[k], p[k]
            upd(g, s, p)
        return params, state

    return Optimizer("adafactor", init, update)


def opt_state_specs(opt: Optimizer, params_specs):
    """Optimizer-state specs from the param specs (JAX's
    ``opt_state_specs``): SGD's and AdamW's slots are laid out like their
    params; Adafactor's factored moments drop the last or the
    second-to-last dimension."""
    if opt.name == "sgd":
        return {"mu": params_specs}
    if opt.name == "adamw":
        return {"m": params_specs, "v": params_specs}

    def spec_for(s):
        s = tuple(s)
        if len(s) >= 2:
            return {"vr": s[:-1], "vc": s[:-2] + s[-1:]}
        return {"v": s}
    return {"f": T.tree_map(spec_for, params_specs,
                            is_leaf=lambda x: isinstance(x, tuple))}


def default_optimizer_for(arch_name: str, param_count: int, lr_fn=None):
    """>= 90B params -> Adafactor; the paper's CNN -> SGD(0.005, momentum
    0.9, weight decay 1e-4); else AdamW."""
    from repro_torch.optim.schedules import constant
    lr_fn = lr_fn or constant(1e-4)
    if arch_name.startswith("resnet50_dcn"):
        return sgd(constant(0.005), momentum=0.9, weight_decay=1e-4)
    if param_count >= 90e9:
        return adafactor(lr_fn)
    return adamw(lr_fn)
