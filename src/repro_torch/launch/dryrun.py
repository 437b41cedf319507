"""Dry run of every (arch x shape x mesh) cell on the ``meta`` device
(counterpart of ``repro.launch.dryrun``).

For each cell this module builds the cell's step and its inputs as
``meta`` tensors (``launch.steps.make_cell_step``), runs the step once,
and records to ``build/dryrun/<arch>__<shape>__<mesh>.json``:

* ``mesh_shape`` and ``axes``: ``card`` is one H100 (every leaf whole);
  ``single`` (data=16, model=16) and ``multi`` (pod=2, data=16,
  model=16) are JAX's production meshes, built by the port's
  ``launch.mesh.make_production_mesh`` over repeated ``meta`` devices;
* ``argument_bytes`` (and by group: params, optimizer state, batch,
  caches): per device, each leaf's shard shape under its partition spec
  on the mesh; ``output_bytes`` the same for the outputs.  A spec that
  does not match its leaf puts the error in the record, as JAX's does;
* ``peak_live_bytes``: the step's peak on one card — the arguments plus
  the most bytes of new storage alive at once (``LiveBytes``, a
  ``TorchDispatchMode`` that adds each new storage's bytes and subtracts
  them when the storage is freed), an op's own temporaries included:
  what its CUDA implementation allocates inside the call, where no
  dispatch mode sees it (``op_temp_bytes``; ``peak_op_temp_bytes`` is
  their share of the peak);
* ``flops``: ``torch.utils.flop_counter.FlopCounterMode`` over the step,
  plus each bounded DCL call priced by ``core.h100``'s works (the
  kernels are not aten ops): the forward's operations, and the
  backward's dP and dw products;
* ``bytes_accessed``: the operand and result bytes of every aten op that
  is not a view or an allocation (XLA's pre-fusion ``bytes accessed``),
  plus each DCL call's work bytes;
* ``collectives`` (JAX's ``parse_collectives`` keys: ``{count, bytes}``
  per kind, ``total_bytes``, ``total_count``) and ``collective_bytes``
  (``total_bytes`` over the mesh's devices), counted from the specs and
  shapes (``launch.collectives``): an LM step's FSDP gathers (again in a
  rematerialised backward) and their gradients' reduce-scatters and
  all-reduces, the row-parallel partial sums, the vocab combine and
  MoE's expert exchange, and a detector's every-param gradient sum over
  its data shards (every layer runs per shard), as
  ``sharding.count_crossings`` counts the same step run on a mesh; one
  card moves nothing.

The trace is taken once a cell, on one card's layout (its FLOPs are the
function's, which no layout changes); the arguments' and outputs' bytes
take each mesh's layout, a decode cell's caches with the KV heads
``effective_kv_heads`` gives on it.  A mesh's record gives the step's
totals (``flops``, ``bytes_accessed``) and their even split over its
devices (``*_per_device``), the layout its specs describe.  The port
walks every layer in Python, so unlike JAX (whose cost analysis counts a
scan body once) it needs no loop extrapolation.  Nothing leaves the
``meta`` device: ``LiveBytes(meta_only=True)`` raises on any tensor with
elements that an op makes elsewhere.

Usage:
  python -m repro_torch.launch.dryrun --arch grok-1-314b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--mesh card|single|multi|all]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import tree as T
from repro_torch.core import h100
from repro_torch.core.tiling import BANDED_TILE_H
from repro_torch.kernels import ops
from repro_torch.launch import collectives, steps
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import registry as reg
from repro_torch.models.resnet_dcn import ResNetDCNConfig

RESULTS_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" \
    / "dryrun"
MESHES = ("card", "single", "multi")

_ALLOCS = {"empty", "empty_like", "new_empty", "empty_strided",
           "new_empty_strided"}


def meta_mesh(kind: str):
    """None for one card; else the production mesh over meta devices."""
    if kind == "card":
        return None
    n = 512 if kind == "multi" else 256
    return make_production_mesh([torch.device("meta")] * n,
                                multi_pod=kind == "multi")


def dcl_work(phase: str, ctx: dict) -> tuple[float, float]:
    """(flops, bytes) of one bounded DCL call's ``phase`` from its
    ``ops`` context (``core.h100``'s works)."""
    n, h, w, c = ctx["shape"]
    m = ctx["m"]
    g = dict(kernel_size=ctx["kernel_size"], stride=ctx["stride"],
             dilation=ctx["dilation"])
    if ctx["op"] == "deform_conv_chain":
        wk = h100.int8_work(n, h, w, c, m, chain=True, emit=ctx["emit"], **g)
        return wk["ops"], wk["bytes"]
    if ctx["precision"] == "int8":
        wk = h100.int8_work(n, h, w, c, m, **g)
        return wk["ops"], wk["bytes"]
    item = dict(itemsize=ctx["itemsize"],
                offset_itemsize=ctx["offset_itemsize"])
    if phase == "backward":
        flops = h100.backward_work(n, h, w, c, m, **g)["ops"]
        return flops, h100.backward_work(n, h, w, c, m, **g, **item)["bytes"]
    if ctx["dataflow"] == "banded":
        wk = h100.banded_work(n, h, w, c, m, **g, **item,
                              offset_bound=ctx["offset_bound"],
                              tile_h=ctx["tiles"][0] or BANDED_TILE_H)
    else:
        wk = h100.forward_work(n, h, w, c, m, **g, **item)
    return wk["ops"], wk["bytes"]


def _caller() -> str:
    """The innermost frame of the port on the stack, as file:line."""
    for f in reversed(traceback.extract_stack()):
        if "repro_torch" in f.filename and "dryrun" not in f.filename:
            return f"{pathlib.Path(f.filename).name}:{f.lineno}"
    return "?"


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def op_temp_bytes(func, args, outs) -> int:
    """Bytes of the temporaries that ``func``'s CUDA implementation
    allocates inside the call, alive together at its peak, from its
    operands' shapes, dtypes and strides (read off the H100's allocator,
    torch 2.11); 0 for an op that makes none.  A dispatch mode sees only
    the op's outputs, on every device, so ``LiveBytes`` adds these.

    * ``_softmax_backward_data(grad, output, ..)``: ``grad * output`` at
      grad's size, and a contiguous copy of each of grad and output that
      is not contiguous (an einsum's backward hands attention's softmax a
      permuted grad: two scores-sized blocks in all);
    * ``logsumexp(x, dims)``: ``x - max`` at x's size, beside the max."""
    name = func.overloadpacket.__name__
    if name == "_softmax_backward_data":
        grad, out = args[0], args[1]
        return _nbytes(grad) * (1 + (not grad.is_contiguous())
                                + (not out.is_contiguous()))
    if name == "logsumexp":
        x = args[0]
        return (x.numel() + outs[0].numel()) * x.element_size()
    return 0


class LiveBytes(TorchDispatchMode):
    """Operand and result bytes of every aten op (``bytes_accessed``) and
    the bytes of new storage alive at once (``live``, ``peak``), with
    each op's own temporaries (``op_temp_bytes``) counted while it runs
    (``peak_temp``: theirs at the peak; ``temps``: the most an op of
    each name made); the storages of ``known``
    tensors (the step's arguments, which in-place updates write) are not
    new.  With ``meta_only`` it raises on any tensor an op makes off
    ``meta``."""

    def __init__(self, meta_only: bool = False, known=()):
        super().__init__()
        self.meta_only = meta_only
        self.bytes_accessed = 0
        self.live = 0
        self.peak = 0
        self.peak_temp = 0
        self.temps: dict[str, int] = {}
        self.ops = 0
        self._sizes: dict[int, int] = {
            t.untyped_storage()._cdata: 0 for t in tree_leaves(known)
            if isinstance(t, torch.Tensor)}

    def _free(self, key: int) -> None:
        self.live -= self._sizes.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops += 1
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if self.meta_only:
            for t in outs:
                # A tensor of no elements holds no bytes: the bookkeeping
                # of torch.utils.checkpoint makes one on the CPU on some
                # versions of torch.
                if t.device.type != "meta" and t.numel():
                    raise RuntimeError(
                        f"{func} made a tensor on {t.device} in a dry run "
                        f"(at {_caller()})")
        if func.is_view:
            return out
        name = func.overloadpacket.__name__
        if name not in _ALLOCS:
            self.bytes_accessed += sum(
                _nbytes(t) for t in tree_leaves((args, kwargs))
                if isinstance(t, torch.Tensor)) + sum(map(_nbytes, outs))
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in self._sizes:
                continue
            self._sizes[key] = st.nbytes()
            self.live += st.nbytes()
            weakref.finalize(st, self._free, key)
        temp = op_temp_bytes(func, args, outs)
        if temp:
            self.temps[name] = max(self.temps.get(name, 0), temp)
        if self.live + temp > self.peak:
            self.peak, self.peak_temp = self.live + temp, temp
        return out


class StepCounter:
    """FLOPs, bytes accessed, peak live bytes and DCL calls of one step
    run inside it, on ``meta`` (a dry run), the CPU or the card (the same
    step on real tensors).  A bounded DCL call is opaque on every device:
    what runs inside it (the plain version's aten ops on the CPU, the
    input preparation on the card) is left out of ``flops`` and
    ``bytes_accessed``, and the call is priced by ``dcl_work`` instead.
    ``known``: the step's arguments (their storages are not new)."""

    def __init__(self, *, meta_only: bool = False, known=()):
        self.meta_only = meta_only
        self.known = known
        self.dcl = {"forward": 0, "backward": 0}
        self.dcl_flops = 0.0
        self.dcl_bytes = 0.0
        self._inner_flops = 0
        self._inner_bytes = 0
        self._open: list[tuple[int, int]] = []

    # the ops.work_scope sink
    def begin(self, phase: str, ctx: dict) -> None:
        self._open.append((self._flop.get_total_flops(),
                           self._live.bytes_accessed))

    def end(self, phase: str, ctx: dict) -> None:
        f0, b0 = self._open.pop()
        if self._open:          # a call inside a call is the outer one's
            return
        self._inner_flops += self._flop.get_total_flops() - f0
        self._inner_bytes += self._live.bytes_accessed - b0
        flops, nbytes = dcl_work(phase, ctx)
        self.dcl[phase] += 1
        self.dcl_flops += flops
        self.dcl_bytes += nbytes

    def __enter__(self):
        self._flop = FlopCounterMode(display=False)
        self._live = LiveBytes(self.meta_only, self.known)
        self._work = ops.work_scope(self)
        self._flop.__enter__()
        self._live.__enter__()
        self._work.__enter__()
        return self

    def __exit__(self, *exc):
        self._work.__exit__(*exc)
        self._live.__exit__(*exc)
        self._flop.__exit__(*exc)
        return False

    @property
    def flops(self) -> float:
        return self._flop.get_total_flops() - self._inner_flops \
            + self.dcl_flops

    @property
    def bytes_accessed(self) -> float:
        return self._live.bytes_accessed - self._inner_bytes \
            + self.dcl_bytes

    @property
    def peak_new_bytes(self) -> int:
        return self._live.peak

    @property
    def peak_temp_bytes(self) -> int:
        """Of ``peak_new_bytes``, an op's own temporaries."""
        return self._live.peak_temp

    @property
    def op_temps(self) -> dict[str, int]:
        """The most bytes of its own temporaries an op of each name made."""
        return dict(self._live.temps)

    @property
    def aten_ops(self) -> int:
        return self._live.ops


def shard_bytes(t: torch.Tensor, spec, mesh) -> int:
    """Bytes of one device's shard of ``t`` under ``spec`` on ``mesh``."""
    if len(spec) != t.dim():
        raise ValueError(f"spec {spec} does not match a leaf of shape "
                         f"{tuple(t.shape)}")
    sizes = {} if mesh is None else mesh.shape
    n = t.element_size()
    for d, ent in zip(t.shape, spec):
        axes = () if ent is None else ((ent,) if isinstance(ent, str)
                                       else tuple(ent))
        k = math.prod(sizes.get(a, 1) for a in axes)
        if d % k:
            raise ValueError(f"dimension {d} does not divide over {axes}")
        n *= d // k
    return n


def tree_shard_bytes(tree, specs, mesh) -> int:
    if isinstance(tree, torch.Tensor):
        return shard_bytes(tree, specs, mesh)
    leaves = T.leaves_with_paths(tree)
    total = 0
    for path, t in leaves:
        s = specs
        for k in path:
            s = s[k]
        total += shard_bytes(t, s, mesh)
    return total


_GROUPS = {"train": ("params", "opt_state", "step", "batch"),
           "train_det": ("params", "opt_state", "step", "batch"),
           "prefill": ("params", "tokens", "frontend"),
           "decode": ("params", "caches", "tokens", "pos"),
           "infer_det": ("params", "images")}


def trace_cell(arch, shape_name: str) -> dict:
    """Run one cell's step on ``meta`` once: its FLOPs, bytes accessed,
    peak new bytes (an op's own temporaries among them), DCL calls,
    output bytes on one card and the seconds it took."""
    step, inputs, _, _ = steps.make_cell_step(arch, shape_name, None)
    t0 = time.monotonic()
    with StepCounter(meta_only=True, known=inputs) as sc:
        out = step(*inputs)
    return {"flops": sc.flops, "bytes_accessed": sc.bytes_accessed,
            "peak_new_bytes": sc.peak_new_bytes,
            "peak_temp_bytes": sc.peak_temp_bytes, "dcl_calls": dict(sc.dcl),
            "dcl_flops": sc.dcl_flops, "dcl_bytes": sc.dcl_bytes,
            "aten_ops": sc.aten_ops,
            "trace_s": round(time.monotonic() - t0, 2), "outputs": out}


def run_cell(arch_name: str, shape_name: str, mesh_kind: str, *,
             arch=None, trace: dict | None = None,
             rules: dict | None = None) -> dict:
    """The record of one (arch, shape, mesh) cell; ``trace`` reuses a
    ``trace_cell`` of the same cell (the trace depends on neither the
    mesh nor the rules).  ``rules`` (a rule experiment, JAX's
    ``--set-rule``) replace the arch's own for a training cell's specs
    and crossings; prefill and decode keep the serving rules and
    inference the defaults, as JAX's step builders do."""
    arch = arch or reg.get(arch_name)
    mesh = meta_mesh(mesh_kind)
    shape_spec = [1] if mesh is None else list(mesh.devices.shape)
    chips = math.prod(shape_spec)
    rec: dict = {"arch": arch_name, "shape": shape_name, "mesh": mesh_kind,
                 "mesh_shape": shape_spec,
                 "axes": [] if mesh is None else list(mesh.axis_names),
                 "dtype": str(arch.config.dtype).removeprefix("torch.")}
    rules = steps._merged_rules(arch, rules)
    if rules is not None:
        from repro_torch.distributed.sharding import DEFAULT_RULES
        rec["rule_overrides"] = {k: v for k, v in rules.items()
                                 if DEFAULT_RULES.get(k) != v}
    kind = arch.shapes[shape_name].kind
    _, inputs, specs, n_params = steps.make_cell_step(arch, shape_name, mesh,
                                                      rules=rules)
    rec["params"] = n_params
    rec["micro"] = steps.microbatches(arch) if kind.startswith("train") \
        else 1
    trace = trace or trace_cell(arch, shape_name)
    groups = {}
    for name, tree, spec in zip(_GROUPS[kind], inputs, specs):
        groups[name] = tree_shard_bytes(tree, spec, mesh)
    rec["argument_bytes_by_group"] = groups
    rec["argument_bytes"] = sum(groups.values())
    outs = steps.output_trees(arch, shape_name, mesh, trace["outputs"])
    o_specs = steps.output_specs(arch, shape_name, mesh, specs, outs)
    rec["output_bytes"] = sum(tree_shard_bytes(o, s, mesh)
                              for o, s in zip(outs, o_specs))
    if mesh_kind == "card":
        rec["peak_live_bytes"] = rec["argument_bytes"] \
            + trace["peak_new_bytes"]
        rec["peak_op_temp_bytes"] = trace["peak_temp_bytes"]
    for k in ("flops", "bytes_accessed", "dcl_calls", "dcl_flops",
              "dcl_bytes", "aten_ops", "trace_s"):
        rec[k] = trace[k]
    rec["flops_per_device"] = trace["flops"] / chips
    rec["bytes_accessed_per_device"] = trace["bytes_accessed"] / chips
    if mesh is None:
        rec["collective_bytes"] = None
        rec["collective_reason"] = "one card: nothing crosses between " \
            "devices"
        return rec
    rec["collectives"] = cell_collectives(arch, shape_name, mesh,
                                          rules=rules)
    rec["collective_bytes"] = rec["collectives"]["total_bytes"] / chips
    return rec


def cell_collectives(arch, shape_name: str, mesh, rules=None) -> dict:
    """The crossings of one cell's step on ``mesh`` (``launch.
    collectives``) as JAX's ``parse_collectives`` keys; ``rules`` as
    ``run_cell``'s (a training cell's only)."""
    shape = arch.shapes[shape_name]
    if isinstance(arch.config, ResNetDCNConfig):
        kcfg = dataclasses.replace(
            arch.config, use_kernel=arch.config.offset_bound is not None)
        return collectives.dcn_collectives(
            kcfg, mesh, batch=shape.global_batch,
            train=shape.kind == "train_det").summary()
    cfg = arch.config
    train = shape.kind == "train"
    rules = steps._merged_rules(arch, rules) if train \
        else steps._serve_rules(arch)
    return collectives.lm_collectives(
        cfg, mesh, mode=shape.kind, batch=shape.global_batch,
        seq=shape.seq_len, rules=rules,
        micro=steps.microbatches(arch) if train else 1,
        frontend=256 if cfg.frontend_embeds and shape.kind != "decode"
        else 0).summary()


def record_path(arch_name: str, shape_name: str, mesh_kind: str,
                tag: str = "", results_dir=None) -> pathlib.Path:
    """Where a cell's record is written: ``<arch>__<shape>[@tag]__<mesh>
    .json`` (a tagged rule experiment beside the untagged record)."""
    shape = f"{shape_name}@{tag}" if tag else shape_name
    return pathlib.Path(results_dir or RESULTS_DIR) \
        / f"{arch_name}__{shape}__{mesh_kind}.json"


def save(rec: dict, results_dir: pathlib.Path | None = None
         ) -> pathlib.Path:
    p = record_path(rec["arch"], rec["shape"], rec["mesh"],
                    results_dir=results_dir)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(rec, indent=1))
    return p


def run_cells(cells, meshes, *, results_dir=None, rules=None, tag="",
              skip_existing=False, log=print) -> list:
    """Dry-run ``cells`` on ``meshes`` under ``rules`` (``run_cell``'s),
    tracing each cell once; writes a record per (cell, mesh), its shape
    ``<shape>@<tag>`` under a ``tag`` (with ``error`` and its traceback
    on failure).  ``skip_existing`` skips a (cell, mesh) whose record,
    at the name it would write, exists without an error.  Returns the
    failures as (tag, message)."""
    failures = []
    shape_of = (lambda s: f"{s}@{tag}") if tag else (lambda s: s)
    for arch_name, shape_name in cells:
        todo = []
        for mesh_kind in meshes:
            p = record_path(arch_name, shape_name, mesh_kind, tag,
                            results_dir)
            if skip_existing and p.exists() \
                    and "error" not in json.loads(p.read_text()):
                log(f"[skip] {arch_name} {shape_of(shape_name)} "
                    f"{mesh_kind}")
            else:
                todo.append(mesh_kind)
        if not todo:
            continue
        try:
            arch = reg.get(arch_name)
            trace = trace_cell(arch, shape_name)
        except Exception as e:  # noqa: BLE001 — recorded, counted
            trace, err = None, (e, traceback.format_exc())
        for mesh_kind in todo:
            name = f"{arch_name} x {shape_of(shape_name)} x {mesh_kind}"
            try:
                if trace is None:
                    raise err[0]
                rec = run_cell(arch_name, shape_name, mesh_kind, arch=arch,
                               trace=trace, rules=rules)
                rec["shape"] = shape_of(shape_name)
                p = save(rec, results_dir)
                log(f"  OK {name}: args "
                    f"{rec['argument_bytes'] / 1e9:.3f} GB/device, flops "
                    f"{rec['flops']:.4e}, trace {rec['trace_s']} s "
                    f"-> {p.name}")
            except Exception as e:  # noqa: BLE001
                tb = err[1] if trace is None else traceback.format_exc()
                failures.append((name, str(e)))
                save({"arch": arch_name, "shape": shape_of(shape_name),
                      "mesh": mesh_kind, "error": str(e), "traceback": tb},
                     results_dir)
                log(f"  FAIL {name}: {e}")
    return failures


def _one_cell(cell, meshes, kw) -> tuple[list, list]:
    """A worker of ``run_cells_parallel``: (failures, log lines)."""
    lines: list[str] = []
    return run_cells([cell], meshes, log=lines.append, **kw), lines


def run_cells_parallel(cells, meshes, *, jobs: int, log=print, **kw
                       ) -> list:
    """``run_cells`` (``kw``: its ``results_dir``, ``rules``, ``tag``,
    ``skip_existing``) over ``jobs`` worker processes (each imports torch
    once), the training cells first since they take longest."""
    if jobs <= 1:
        return run_cells(cells, meshes, log=log, **kw)
    import concurrent.futures
    import multiprocessing
    order = sorted(cells, key=lambda c: not reg.get(c[0]).shapes[c[1]]
                   .kind.startswith("train"))
    failures = []
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(jobs, mp_context=ctx) as ex:
        futs = [ex.submit(_one_cell, c, list(meshes), kw) for c in order]
        for f in futs:
            fails, lines = f.result()
            failures += fails
            for line in lines:
                log(line)
    return failures


def parse_rules(pairs) -> dict | None:
    """``--set-rule k=v`` pairs over ``DEFAULT_RULES`` (``none``/``None``
    maps an axis to no mesh axis); None without any."""
    if not pairs:
        return None
    from repro_torch.distributed.sharding import DEFAULT_RULES
    rules = dict(DEFAULT_RULES)
    for kv in pairs:
        k, v = kv.split("=", 1)
        rules[k] = None if v in ("none", "None") else v
    return rules


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="all",
                    choices=[*MESHES, "all"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--dir", default=None,
                    help=f"results directory (default {RESULTS_DIR})")
    ap.add_argument("--jobs", type=int, default=1,
                    help="worker processes (each traces whole cells)")
    ap.add_argument("--skip-existing", action="store_true",
                    help="skip a cell whose record (at the name it would "
                    "write, tag included) exists without an error")
    ap.add_argument("--set-rule", action="append", default=[],
                    help="override a logical->mesh rule, e.g. "
                    "experts=model (repeatable; none: no mesh axis)")
    ap.add_argument("--tag", default="",
                    help="suffix of the records' shape (rule experiments)")
    args = ap.parse_args(argv)
    meshes = list(MESHES) if args.mesh == "all" else [args.mesh]
    if args.all:
        cells = reg.runnable_cells()
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("give --arch and --shape, or --all")
    failures = run_cells_parallel(
        cells, meshes, jobs=args.jobs, results_dir=args.dir,
        rules=parse_rules(args.set_rule), tag=args.tag,
        skip_existing=args.skip_existing)
    print(f"\n{len(cells) * len(meshes) - len(failures)} ok, "
          f"{len(failures)} failed, {len(reg.skipped_cells())} recorded "
          f"skips (long_500k on full-attention archs)")
    if failures:
        for name, err in failures:
            print(f"  FAIL {name}: {err.splitlines()[0] if err else ''}")
        raise SystemExit(1)


if __name__ == "__main__":
    main()
