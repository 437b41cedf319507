"""Optimizers: SGD with momentum (the paper's), AdamW, Adafactor
(counterpart of ``repro.optim.optimizers``).

``Optimizer(init, update)`` over nested dicts of tensors, with
``update(grads, state, params, step) -> (params, state)``.  The update
formulas are the JAX package's, weight decay and epsilon included (not
``torch.optim``'s, which place both elsewhere).  Unlike JAX, ``update``
writes the new values into ``params`` and ``state`` in place and returns
the same trees; the caller runs it under ``torch.no_grad()`` and decides
beforehand whether the step is taken (see ``train.trainer``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch import tree as T

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, int], tuple[Any, Any]]


def global_norm(grads) -> Tensor:
    """sqrt of the sum of squares of every leaf, in fp32."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in T.leaves(grads)))


def _clipped(grads, max_norm: float | None):
    if max_norm is None:
        return grads
    scale = torch.clamp_max(max_norm / (global_norm(grads) + 1e-9), 1.0)
    return T.tree_map(lambda g: (g.float() * scale).to(g.dtype), grads)


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
        if _factored(p.shape):
            return {"vr": _zeros_like(p, p.shape[:-1]),
                    "vc": _zeros_like(p, p.shape[:-2] + (p.shape[-1],))}
        return {"v": _zeros_like(p)}

    def init(params):
        return {"f": T.tree_map(state_for, params)}

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
