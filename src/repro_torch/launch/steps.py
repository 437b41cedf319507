"""Step builders of the (arch, shape) cells (counterpart of
``repro.launch.steps``).

``make_cell_step(arch, shape_name, mesh)`` returns what a dry run needs
to run one cell without allocating anything:

* the step function — ``train`` (microbatched, with the arch's default
  optimizer state, updated in place), ``prefill``, ``decode``, and the
  detector's ``infer_det`` and ``train_det``;
* its inputs as ``meta`` tensors (a tuple of trees: params, optimizer
  state, step and batch for training; params and tokens for prefill;
  params, caches, tokens and positions for decode; params and images for
  inference);
* each input leaf's partition spec, ``sharding.logical_spec`` of its
  logical axes under ``use_rules`` and the arch's ``rules_overrides``
  (training), the serving rules (prefill and decode) or the defaults
  (inference), against ``mesh`` (None: one card, every leaf whole);
* ``arch_param_count(arch)``.

Each input is declared once as a ``layers.ParamDef`` tree (shape, logical
axes, dtype), so its meta tensors and its specs cannot disagree.
``real_inputs`` draws the same trees as real tensors from a seed (the
card check runs the same step on them).  The bounded detector runs its
DCLs through the fused kernels (``use_kernel=True``), the port's main
path; on ``meta`` inputs ``ops.deform_conv`` takes its shape-only path.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch import tree as T
from repro_torch.distributed.sharding import (DEFAULT_RULES, serve_rules_for,
                                              use_rules)
from repro_torch.models import layers as L
from repro_torch.models import resnet_dcn as R
from repro_torch.models import transformer as TF
from repro_torch.models.registry import ArchSpec, ShapeSpec
from repro_torch.optim.optimizers import (default_optimizer_for,
                                          opt_state_specs)

Tensor = torch.Tensor


def _pd(shape, axes, dtype=torch.float32) -> L.ParamDef:
    return L.ParamDef(tuple(shape), tuple(axes), dtype=dtype)


def arch_param_defs(arch: ArchSpec) -> dict:
    """The ParamDef tree of the arch's params (``init_params``' layout)."""
    cfg = arch.config
    if isinstance(cfg, R.ResNetDCNConfig):
        return R.model_def(cfg)
    return TF.param_defs(cfg)


def arch_param_count(arch: ArchSpec) -> int:
    cfg = arch.config
    if isinstance(cfg, R.ResNetDCNConfig):
        return sum(math.prod(d.shape) for d in T.leaves(R.model_def(cfg)))
    return cfg.param_count()


def _merged_rules(arch: ArchSpec, rules=None):
    """Explicit rules > per-arch overrides > defaults (None)."""
    if rules is not None:
        return rules
    if arch.rules_overrides:
        return {**DEFAULT_RULES, **arch.rules_overrides}
    return None


def _serve_rules(arch: ArchSpec):
    rules = serve_rules_for(arch_param_count(arch))
    if arch.rules_overrides:
        rules = {**rules, **arch.rules_overrides}
    return rules


def _train_shape_name(arch: ArchSpec) -> str:
    for name, s in arch.shapes.items():
        if s.kind in ("train", "train_det"):
            return name
    raise ValueError(f"{arch.name} has no train shape")


def microbatches(arch: ArchSpec) -> int:
    """Gradient accumulation of the train step, as JAX's: 8 microbatches
    from 90B params, 4 from 20B, else 1."""
    n = arch_param_count(arch)
    return 8 if n >= 90e9 else (4 if n >= 20e9 else 1)


# ---------------------------------------------------------------------------
# Input declarations (shape, logical axes, dtype)
# ---------------------------------------------------------------------------

def _tokens(cfg, b: int, s: int | None) -> L.ParamDef:
    cb = cfg.codebooks > 1
    shape = (b,) if s is None else (b, s)
    axes = ("batch",) if s is None else ("batch", "seq")
    return _pd(shape + ((cfg.codebooks,) if cb else ()),
               axes + ((None,) if cb else ()), torch.int32)


def _frontend(cfg, b: int) -> L.ParamDef:
    return _pd((b, 256, cfg.d_model), ("batch", None, None), cfg.dtype)


def _det_batch(cfg: R.ResNetDCNConfig, b: int) -> dict:
    hw, hc = cfg.img_size, cfg.img_size // 32
    return {"images": _pd((b, hw, hw, 3), ("batch", "spatial", None, None)),
            "obj": _pd((b, hc, hc), ("batch", "spatial", None)),
            "cls": _pd((b, hc, hc), ("batch", "spatial", None), torch.int32),
            "box": _pd((b, hc, hc, 4), ("batch", "spatial", None, None))}


def input_defs(arch: ArchSpec, shape_name: str) -> dict:
    """The ParamDef trees of a cell's non-param inputs, by name."""
    shape = arch.shapes[shape_name]
    cfg = arch.config
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train_det":
        return {"batch": _det_batch(cfg, b)}
    if shape.kind == "infer_det":
        hw = cfg.img_size
        return {"images": _pd((b, hw, hw, 3), ("batch", None, None, None))}
    if shape.kind == "train":
        batch = {"tokens": _tokens(cfg, b, s), "targets": _tokens(cfg, b, s)}
        if cfg.frontend_embeds:
            batch["frontend"] = _frontend(cfg, b)
        return {"batch": batch}
    if shape.kind == "prefill":
        out = {"tokens": _tokens(cfg, b, s)}
        if cfg.frontend_embeds:
            out["frontend"] = _frontend(cfg, b)
        return out
    if shape.kind == "decode":
        return {"caches": TF.cache_defs(cfg, b, s),
                "tokens": _tokens(cfg, b, None),
                "pos": _pd((b,), ("batch",), torch.int32)}
    raise ValueError(shape.kind)


# ---------------------------------------------------------------------------
# Step functions
# ---------------------------------------------------------------------------

def _step_index(step: Tensor) -> int:
    return 0 if step.device.type == "meta" else int(step)


def _grads(lf, params, batch) -> tuple[Tensor, list[Tensor]]:
    """(loss, gradient of each param leaf, JAX's flatten order)."""
    paths = [p for p, _ in T.leaves_with_paths(params)]
    leaves = [x.detach().requires_grad_() for x in T.leaves(params)]
    loss = lf(T.from_paths(zip(paths, leaves)), batch)
    gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), [torch.zeros_like(x) if g is None else g
                           for g, x in zip(gs, leaves)]


def make_train_step(arch: ArchSpec, mesh, *, shape_name: str | None = None,
                    optimizer=None, rules=None):
    """The production train step: forward, backward and the optimizer's
    in-place update, over ``microbatches(arch)`` microbatches whose
    gradients accumulate in fp32 (JAX's ``make_train_step``), on the
    batch of ``shape_name`` (default: the arch's train shape)."""
    cfg = arch.config
    rules = _merged_rules(arch, rules)
    n_params = arch_param_count(arch)
    opt = optimizer or default_optimizer_for(arch.name, n_params)
    name = shape_name or _train_shape_name(arch)
    p_defs = arch_param_defs(arch)
    b_defs = input_defs(arch, name)["batch"]
    with use_rules(rules=rules, mesh=mesh):
        p_specs = L.spec_tree(p_defs)
        b_specs = L.spec_tree(b_defs)
    params = L.meta_tree(p_defs)
    opt_state = opt.init(params)
    step0 = torch.zeros((), dtype=torch.int32, device="meta")

    if isinstance(cfg, R.ResNetDCNConfig):
        kcfg = dataclasses.replace(cfg, use_kernel=cfg.offset_bound
                                   is not None)
        lam = 0.005 if cfg.offset_bound is not None else 0.0

        def lf(p, batch):
            return R.train_loss(p, kcfg, batch, lam=lam,
                                device=batch["images"].device)[0]
    else:
        def lf(p, batch):
            return TF.loss_fn(p, cfg, batch)[0]
    micro = microbatches(arch)

    def train_step(params, opt_state, step, batch):
        if micro > 1:
            mbs = [dict(zip(batch, vals)) for vals in
                   zip(*(v.chunk(micro) for v in batch.values()))]
            acc, loss = None, 0.0
            for mb in mbs:
                l_, gs = _grads(lf, params, mb)
                gs = [g.float() for g in gs]
                acc = gs if acc is None else [a + g for a, g in zip(acc, gs)]
                loss = loss + l_
            grads = [a / micro for a in acc]
            loss = loss / micro
        else:
            loss, grads = _grads(lf, params, batch)
        paths = [p for p, _ in T.leaves_with_paths(params)]
        with torch.no_grad():
            params, new_opt = opt.update(T.from_paths(zip(paths, grads)),
                                         opt_state, params,
                                         _step_index(step))
        return params, new_opt, step + 1, loss

    specs = (p_specs, opt_state_specs(opt, p_specs), (), b_specs)
    inputs = (params, opt_state, step0, L.meta_tree(b_defs))
    return train_step, inputs, specs


def make_prefill_step(arch: ArchSpec, shape_name: str, mesh):
    cfg = arch.config
    shape = arch.shapes[shape_name]
    p_defs = arch_param_defs(arch)
    i_defs = input_defs(arch, shape_name)
    with use_rules(rules=_serve_rules(arch), mesh=mesh):
        p_specs = L.spec_tree(p_defs)
        i_specs = L.spec_tree(i_defs)

    def prefill_step(params, tokens, frontend=None):
        with torch.no_grad():
            logits, caches = TF.prefill(params, cfg, tokens,
                                        cache_len=shape.seq_len,
                                        frontend=frontend)
            return logits.argmax(-1).to(torch.int32), caches

    names = ["tokens"] + (["frontend"] if cfg.frontend_embeds else [])
    inputs = (L.meta_tree(p_defs),) + tuple(L.meta_tree(i_defs[k])
                                           for k in names)
    specs = (p_specs,) + tuple(i_specs[k] for k in names)
    return prefill_step, inputs, specs


def make_decode_step(arch: ArchSpec, shape_name: str, mesh):
    """The decode step; its caches are declared under the serving rules
    on ``mesh``, so their KV heads are ``effective_kv_heads`` there (KV
    replicated per query group where the model axis cannot split it), as
    JAX's ``cache_specs`` are."""
    cfg = arch.config
    p_defs = arch_param_defs(arch)
    with use_rules(rules=_serve_rules(arch), mesh=mesh):
        i_defs = input_defs(arch, shape_name)
        p_specs = L.spec_tree(p_defs)
        i_specs = L.spec_tree(i_defs)

    def serve_step(params, caches, tokens, pos):
        with torch.no_grad():
            logits, new_caches = TF.decode_step(params, cfg, tokens, caches,
                                                pos)
            return logits.argmax(-1).to(torch.int32), new_caches

    names = ("caches", "tokens", "pos")
    inputs = (L.meta_tree(p_defs),) + tuple(L.meta_tree(i_defs[k])
                                           for k in names)
    specs = (p_specs,) + tuple(i_specs[k] for k in names)
    return serve_step, inputs, specs


def make_infer_step(arch: ArchSpec, shape_name: str, mesh):
    """Detector batch inference (``infer_det``): the classes and boxes."""
    cfg = arch.config
    if not isinstance(cfg, R.ResNetDCNConfig):
        raise ValueError(f"{arch.name} is not a detector")
    kcfg = dataclasses.replace(cfg, use_kernel=cfg.offset_bound is not None)
    p_defs = arch_param_defs(arch)
    i_defs = input_defs(arch, shape_name)
    with use_rules(mesh=mesh):
        p_specs = L.spec_tree(p_defs)
        i_specs = L.spec_tree(i_defs)

    def infer_step(params, images):
        with torch.no_grad():
            out, _ = R.forward(params, kcfg, images, device=images.device)
            return out["cls"], out["box"]

    return infer_step, (L.meta_tree(p_defs), L.meta_tree(i_defs["images"])), \
        (p_specs, i_specs["images"])


def make_cell_step(arch: ArchSpec, shape_name: str, mesh, rules=None
                   ) -> tuple[Callable, tuple, tuple, int]:
    """(step, meta inputs, their specs, ``arch_param_count``) of one
    cell."""
    kind = arch.shapes[shape_name].kind
    if kind in ("train", "train_det"):
        step, inputs, specs = make_train_step(arch, mesh,
                                              shape_name=shape_name,
                                              rules=rules)
    elif kind == "prefill":
        step, inputs, specs = make_prefill_step(arch, shape_name, mesh)
    elif kind == "decode":
        step, inputs, specs = make_decode_step(arch, shape_name, mesh)
    elif kind == "infer_det":
        step, inputs, specs = make_infer_step(arch, shape_name, mesh)
    else:
        raise ValueError(kind)
    return step, inputs, specs, arch_param_count(arch)


def output_specs(arch: ArchSpec, shape_name: str, mesh, in_specs: tuple,
                 outputs: tuple) -> tuple:
    """The specs of a step's outputs, as JAX's ``out_shardings``: a train
    step's params, optimizer state and step keep their inputs' specs and
    its loss is replicated; a decode step's caches keep theirs; prefill
    caches take the cache specs at the prompt's length; the rest is
    replicated."""
    kind = arch.shapes[shape_name].kind

    def rep(t):
        return T.tree_map(lambda x: (None,) * x.dim(), t)
    if kind in ("train", "train_det"):
        return in_specs[:3] + ((),)
    if kind == "decode":
        return (rep(outputs[0]), in_specs[1])
    if kind == "prefill":
        shape = arch.shapes[shape_name]
        with use_rules(rules=_serve_rules(arch), mesh=mesh):
            c_specs = L.spec_tree(TF.cache_defs(
                arch.config, shape.global_batch, shape.seq_len))
        return (rep(outputs[0]), c_specs)
    return tuple(rep(o) for o in outputs)


def output_trees(arch: ArchSpec, shape_name: str, mesh,
                 outputs: tuple) -> tuple:
    """A step's traced ``outputs`` with their caches in ``mesh``'s layout:
    a prefill or decode step on a tensor-parallel mesh emits the caches
    of ``cache_defs`` under the serving rules there (its KV heads
    ``effective_kv_heads``), which a trace on one card does not show."""
    kind = arch.shapes[shape_name].kind
    if kind not in ("prefill", "decode"):
        return outputs
    shape = arch.shapes[shape_name]
    with use_rules(rules=_serve_rules(arch), mesh=mesh):
        caches = L.meta_tree(TF.cache_defs(arch.config, shape.global_batch,
                                           shape.seq_len))
    return (outputs[0], caches)


def with_shape(arch: ArchSpec, shape_name: str, shape: ShapeSpec, *,
               img_size: int | None = None) -> ArchSpec:
    """``arch`` with one more shape (and a detector's ``img_size``): the
    card check's shapes, which the registry does not list."""
    cfg = arch.config if img_size is None else dataclasses.replace(
        arch.config, img_size=img_size)
    return dataclasses.replace(arch, config=cfg,
                               shapes={**arch.shapes, shape_name: shape})


def real_inputs(arch: ArchSpec, shape_name: str, inputs: tuple, device,
                *, seed: int = 0, params=None) -> tuple:
    """A cell's meta ``inputs`` drawn as real tensors on ``device`` (the
    same shapes and dtypes): params (unless ``params`` gives them) and
    float data N(0, 0.02), tokens below the vocab, decode positions below
    the cache length, class labels below ``num_classes - 1``, objectness
    in {0, 1}; optimizer state, the step and caches zero."""
    gen = torch.Generator().manual_seed(seed)
    cfg = arch.config
    shape = arch.shapes[shape_name]
    vocab = getattr(cfg, "vocab", 1)
    hi = {"tokens": vocab, "targets": vocab, "obj": 2,
          "pos": max(shape.seq_len, 1),
          "cls": max(getattr(cfg, "num_classes", 2) - 1, 1)}

    def draw(name: str, x: Tensor) -> Tensor:
        if name in hi:
            v = torch.randint(0, hi[name], x.shape, generator=gen)
        else:
            v = torch.randn(x.shape, generator=gen) * 0.02
        return v.to(x.dtype).to(device)

    def zeros(tree):
        return T.tree_map(lambda x: torch.zeros(
            x.shape, dtype=x.dtype, device=device), tree)

    def drawn(tree, name: str = ""):
        if isinstance(tree, Tensor):
            return draw(name, tree)
        return T.from_paths((p, draw(p[-1], x))
                            for p, x in T.leaves_with_paths(tree))

    if params is None:
        params = drawn(inputs[0])
    elif [(p, x.shape, x.dtype) for p, x in T.leaves_with_paths(params)] \
            != [(p, x.shape, x.dtype)
                for p, x in T.leaves_with_paths(inputs[0])]:
        raise ValueError(f"the params given are not {arch.name}'s")
    if shape.kind in ("train", "train_det"):
        _, opt_state, step, batch = inputs
        return params, zeros(opt_state), zeros(step), drawn(batch)
    if shape.kind == "decode":
        _, caches, tokens, pos = inputs
        return (params, zeros(caches), drawn(tokens, "tokens"),
                drawn(pos, "pos"))
    if shape.kind == "prefill":
        return (params, drawn(inputs[1], "tokens")) \
            + tuple(drawn(x) for x in inputs[2:])
    return params, drawn(inputs[1])
