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
factored moments (``vr`` placed by the param's spec without its last
dimension, ``vc`` without its second-to-last) and its update-RMS clip
reduce over the whole leaf: each statistic is a sum of the blocks' sums
along the split dimension, meeting on the statistic's block, divided
once by the whole leaf's extent (``_placed_adafactor``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import torch

from repro_torch import tree as T
from repro_torch.distributed.sharding import Placed, is_placed, place

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


def _clip_scale(grads, max_norm: float | None) -> Tensor | None:
    """The clip's factor ``min(1, max_norm / global_norm)``, or None."""
    if max_norm is None:
        return None
    return torch.clamp_max(max_norm / (global_norm(grads) + 1e-9), 1.0)


def _scaled(g, scale: Tensor | None):
    """``g`` (a tensor or a placed leaf) times the clip's ``scale``, in
    its own dtype.  The updates clip one leaf at a time, so that a step
    never holds a second copy of every gradient."""
    if scale is None:
        return g
    return T.tree_map(
        lambda b: (b.float() * scale.to(b.device)).to(b.dtype), g)


def _clipped(grads, max_norm: float | None):
    if max_norm is None:
        return grads
    scale = _clip_scale(grads, max_norm)
    return T.tree_map(lambda g: _scaled(g, scale), grads)


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
        scale = _clip_scale(grads, max_norm)
        lr = lr_fn(step)

        def upd(g, mu, p):
            g = _scaled(g, scale).float()
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
        scale = _clip_scale(grads, max_norm)
        lr = lr_fn(step)
        t = float(step) + 1.0
        c1 = 1.0 - b1 ** t
        c2 = 1.0 - b2 ** t

        def upd(g, m, v, p):
            g = _scaled(g, scale).float()
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


def _zeros_placed(p: Placed, keep: Sequence[int]):
    """fp32 zeros of ``p``'s dimensions ``keep``, placed by those entries
    of its spec on its mesh (a plain tensor where they split nothing)."""
    shape = tuple(p.shape[d] for d in keep)
    dev = next(iter(p.blocks.values())).device
    return place(torch.zeros(shape, device=dev),
                 tuple(p.spec[d] for d in keep), p.mesh)


def _blocks(x) -> dict:
    """{block index: block} of a placed tensor; a plain one is block 0."""
    return x.blocks if is_placed(x) else {(0,) * x.ndim: x}


def _add_at(acc: dict, key, t: Tensor, device) -> None:
    t = t.to(device)
    acc[key] = t if key not in acc else acc[key] + t


def _placed_adafactor(g: Placed, s: dict, p: Placed, *, beta2: float,
                      eps: float, clip_rms: float, weight_decay: float,
                      lr: float) -> None:
    """One Adafactor step of a placed leaf, block by block: JAX's update
    with each mean over a split dimension taken as the blocks' sums
    meeting on the statistic's block (in block order), divided once by
    the dimension's extent, and the update RMS a sum over every block
    (a block held once counts once)."""
    gb = {i: b.float() for i, b in g.blocks.items()}
    g2 = {i: torch.square(b) + eps for i, b in gb.items()}
    if "vr" in s:
        vr, vc = _blocks(s["vr"]), _blocks(s["vc"])
        rows, cols = {}, {}
        for i in sorted(g2):
            _add_at(rows, i[:-1], g2[i].sum(-1), vr[i[:-1]].device)
            kc = i[:-2] + i[-1:]
            _add_at(cols, kc, g2[i].sum(-2), vc[kc].device)
        for k, t in rows.items():
            vr[k].mul_(beta2).add_((1 - beta2) * (t / p.shape[-1]))
        for k, t in cols.items():
            vc[k].mul_(beta2).add_((1 - beta2) * (t / p.shape[-2]))
        means: dict = {}
        for k in sorted(vr):
            _add_at(means, k[:-1], vr[k].sum(-1, keepdim=True),
                    vr[k].device)
        u = {}
        for i, gi in gb.items():
            dev = gi.device
            r = vr[i[:-1]] / torch.clamp_min(
                means[i[:-2]].to(dev) / p.shape[-2], eps)
            u[i] = gi / (torch.sqrt(r)[..., None]
                         * torch.sqrt(vc[i[:-2] + i[-1:]].to(dev))
                         [..., None, :] + eps)
    else:
        v = _blocks(s["v"])
        for i, b in v.items():
            b.mul_(beta2).add_((1 - beta2) * g2[i])
        u = {i: gi / (torch.sqrt(v[i]) + eps) for i, gi in gb.items()}
    home = next(iter(u.values())).device
    sq = sum(torch.sum(torch.square(t)).to(home) for t in u.values())
    rms = torch.sqrt(sq / p.shape.numel() + 1e-12)
    scale = torch.clamp_min(rms / clip_rms, 1.0)
    for i, ui in u.items():
        ui = ui / scale.to(ui.device)
        pi = p.blocks[i]
        if weight_decay:
            ui = ui + weight_decay * pi.float()
        _assign(pi, pi.float() - lr * ui)


def adafactor(lr_fn, *, decay_pow: float = 0.8, eps: float = 1e-30,
              clip_rms: float = 1.0, weight_decay: float = 0.0,
              max_norm: float | None = 1.0) -> Optimizer:
    def state_for(p):
        if is_placed(p):
            if _factored(p.shape):
                n = p.ndim
                return {"vr": _zeros_placed(p, range(n - 1)),
                        "vc": _zeros_placed(p, [*range(n - 2), n - 1])}
            return {"v": T.tree_map(_zeros_like, p)}
        if _factored(p.shape):
            return {"vr": _zeros_like(p, p.shape[:-1]),
                    "vc": _zeros_like(p, p.shape[:-2] + (p.shape[-1],))}
        return {"v": _zeros_like(p)}

    def init(params):
        return {"f": T.tree_map(state_for, params, is_leaf=is_placed)}

    def update(grads, state, params, step):
        scale = _clip_scale(grads, max_norm)
        lr = lr_fn(step)
        beta2 = 1.0 - (float(step) + 1.0) ** (-decay_pow)

        def upd(g, s, p):
            # In place where the result is the same, and each leaf-sized
            # temporary freed once used: a large leaf's step holds few
            # copies of it.
            g2 = torch.square(g).add_(eps)
            if "vr" in s:
                vr, vc = s["vr"], s["vc"]
                vr.mul_(beta2).add_((1 - beta2) * g2.mean(-1))
                vc.mul_(beta2).add_((1 - beta2) * g2.mean(-2))
                del g2
                r = vr / torch.clamp_min(vr.mean(-1, keepdim=True), eps)
                den = torch.sqrt(r)[..., None] * torch.sqrt(vc)[..., None, :]
            else:
                v = s["v"]
                v.mul_(beta2).add_((1 - beta2) * g2)
                del g2
                den = torch.sqrt(v)
            u = g / den.add_(eps)
            del den
            rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-12)
            u.div_(torch.clamp_min(rms / clip_rms, 1.0))
            if weight_decay:
                u.add_(weight_decay * p.float())
            _assign(p, p.float() - u.mul_(lr))

        # The state tree holds one dict per param leaf: walk the params.
        for path, g in T.leaves_with_paths(grads, is_leaf=is_placed):
            s, p = state["f"], params
            for k in path:
                s, p = s[k], p[k]
            g = _scaled(g, scale)
            if is_placed(g):
                _placed_adafactor(g, s, p, beta2=beta2, eps=eps,
                                  clip_rms=clip_rms,
                                  weight_decay=weight_decay, lr=lr)
            else:
                upd(g.float(), s, p)
            del g
        return params, state

    return Optimizer("adafactor", init, update)


def chain_clip(opt: Optimizer) -> Optimizer:
    """The optimizer itself: each optimizer clips by ``max_norm`` already
    (JAX's name, kept for API symmetry)."""
    return opt


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
