"""Port parity: the planning layer of ``repro_torch`` (``models.registry``'s
cells, ``launch.steps``, ``launch.dryrun`` on the ``meta`` device and
``launch.roofline``) against the JAX package, and the windowed serving
repair of ``models.transformer._attn_prefill_cache``.

* Cells, parameter counts, every input leaf's partition spec and
  MODEL_FLOPS equal JAX's.  JAX's step builders wrap their specs in
  ``NamedSharding`` s, which need a JAX mesh of 256 devices; the specs
  are taken from the functions the builders call, under a stand-in mesh
  that carries only the axis sizes.
* ``analyze_cell`` given JAX's TPU peaks equals JAX's on the same
  synthetic records.
* A dry run's FLOPs and argument bytes equal those of the same step on
  CPU tensors (exactly: the same aten ops, and the same DCL calls priced
  by ``core.h100``'s works); a full-width cell stays on ``meta``.
* A windowed model serves at any ``cache_len``: its tokens equal the
  engine's at ``cache_len`` = window and JAX's ``prefill(cache_len=
  window)`` + ``decode_step`` on a prompt longer than the window.
"""
import dataclasses
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch.utils._pytree import tree_leaves

from repro.core import tiling as JTiling
from repro.distributed import sharding as JS
from repro.launch import roofline as JRoof
from repro.launch import steps as JSteps
from repro.models import registry as JReg
from repro.models import transformer as JT
from repro.optim import default_optimizer_for as j_default_optimizer
from repro.optim import opt_state_specs as j_opt_state_specs
from repro_torch.convert import params_from_jax
from repro_torch.distributed import sharding as TS
from repro_torch.kernels import _build, ops
from repro_torch.kernels.deform_conv_fused import deform_conv_fused_zerocopy
from repro_torch.launch import dryrun, roofline, steps
from repro_torch.launch import serve as serve_launch
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import registry as reg
from repro_torch.models import transformer as TT
from repro_torch.models.registry import ShapeSpec
from repro_torch.serve import Request, ServeConfig, ServingEngine

torch.set_num_threads(2)

MESHES = {"card": None, "single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def _standin(kind):
    """JAX's side: an object with a mesh's axis names and device shape."""
    if MESHES[kind] is None:
        return None
    shape, names = MESHES[kind]
    return types.SimpleNamespace(axis_names=names,
                                 devices=np.empty(shape, dtype=object))


def _port_mesh(kind):
    if MESHES[kind] is None:
        return None
    return make_production_mesh(["meta"] * (512 if kind == "multi" else 256),
                                multi_pod=kind == "multi")


def _tuples(tree):
    return jax.tree_util.tree_map(lambda s: tuple(s), tree,
                                  is_leaf=lambda x: isinstance(x, P))


# ---------------------------------------------------------------------------
# Cells, counts and specs against JAX's
# ---------------------------------------------------------------------------

def test_cells_equal_jax():
    assert reg.runnable_cells() == JReg.runnable_cells()
    assert reg.skipped_cells() == JReg.skipped_cells()
    assert len(reg.runnable_cells()) == 36
    # InternImage has no JAX counterpart and no dry-run cells.
    assert reg.det_names() == ["internimage_b_bounded", "resnet50_dcn",
                               "resnet50_dcn_bounded"]
    assert reg.get("resnet50_dcn_bounded").config.offset_bound == 2.0
    assert reg.get("dbrx-132b").rules_overrides \
        == JReg.get("dbrx-132b").rules_overrides
    # names() stays the LM registry; the detectors are beside it.
    assert "resnet50_dcn" not in reg.names()


@pytest.mark.parametrize("name", sorted(
    n for n in reg.names() + reg.det_names() if n != "internimage_b_bounded"))
def test_arch_param_count_equals_jax(name):
    assert steps.arch_param_count(reg.get(name)) \
        == JSteps.arch_param_count(JReg.get(name))


def _jax_specs(arch, shape_name: str, mesh):
    """The spec trees JAX's builders hand to ``jax.jit``, in the order of
    the step's arguments."""
    shape = arch.shapes[shape_name]
    kind = shape.kind
    if kind in ("train", "train_det"):
        with JS.use_rules(rules=JSteps._merged_rules(arch), mesh=mesh):
            p = JSteps.arch_param_specs(arch)
            opt = j_default_optimizer(arch.name, JSteps.arch_param_count(arch))
            o = j_opt_state_specs(opt, p)
            b = JReg.input_shardings(arch, shape_name, mesh)["batch"]
        return (p, o, P(), b)
    if kind == "infer_det":
        with JS.use_rules(mesh=mesh):
            p = JSteps.arch_param_specs(arch)
            hw, b = arch.config.img_size, shape.global_batch
            img = JS.logical_spec((b, hw, hw, 3),
                                  ("batch", None, None, None), mesh=mesh)
        return (p, img)
    with JS.use_rules(rules=JSteps._serve_rules(arch), mesh=mesh):
        p = JSteps.arch_param_specs(arch)
        ins = JReg.input_shardings(arch, shape_name, mesh)
    if kind == "prefill":
        extra = (ins["frontend"],) if arch.config.frontend_embeds else ()
        return (p, ins["tokens"]) + extra
    return (p, ins["caches"], ins["tokens"], ins["pos"])


def _rules_of(arch, kind):
    if kind in ("train", "train_det"):
        return steps._merged_rules(arch)
    if kind == "infer_det":
        return None
    return steps._serve_rules(arch)


@pytest.mark.parametrize("cell", reg.runnable_cells(),
                         ids=lambda c: f"{c[0]}-{c[1]}")
def test_every_leaf_spec_equals_jax(cell):
    """Every input leaf's partition spec, on one card and on both
    production meshes: (1) equals what JAX's ``logical_spec`` resolves for
    the same leaf (shape, logical axes) under the same rules and axis
    sizes; (2) the spec trees equal those JAX's builders hand to
    ``jax.jit``, leaf for leaf, the KV caches included (both replicate
    KV heads per query group where the model axis cannot split them)."""
    name, shape_name = cell
    arch = reg.get(name)
    kind = arch.shapes[shape_name].kind
    defs = [steps.arch_param_defs(arch), steps.input_defs(arch, shape_name)]
    rules = _rules_of(arch, kind)
    for mesh_kind in MESHES:
        mesh, standin = _port_mesh(mesh_kind), _standin(mesh_kind)
        jrules = dict(JS.DEFAULT_RULES if rules is None else rules)
        for tree in defs:
            for _, d in steps.T.leaves_with_paths(tree):
                with TS.use_rules(rules=rules, mesh=mesh):
                    got = TS.logical_spec(d.shape, d.axes)
                want = tuple(JS.logical_spec(d.shape, d.axes, rules=jrules,
                                             mesh=standin))
                assert got == want, (mesh_kind, d, got, want)
        _, inputs, specs, _ = steps.make_cell_step(arch, shape_name, mesh)
        want = _tuples(_jax_specs(JReg.get(name), shape_name, standin))
        assert len(specs) == len(want) == len(inputs)
        for got_tree, exp_tree in zip(specs, want):
            if isinstance(got_tree, tuple):
                assert got_tree == exp_tree
                continue
            got_l = steps.T.leaves_with_paths(got_tree)
            exp_l = jax.tree_util.tree_flatten_with_path(
                exp_tree, is_leaf=lambda x: isinstance(x, tuple))[0]
            assert [p for p, _ in got_l] == [
                tuple(k.key for k in p) for p, _ in exp_l]
            for (path, g), (_, e) in zip(got_l, exp_l):
                assert g == e, (mesh_kind, path, g, e)
        # every spec covers its leaf: the per-device bytes resolve
        for tree, spec in zip(inputs, specs):
            dryrun.tree_shard_bytes(tree, spec, mesh)


@pytest.mark.parametrize("cell", reg.runnable_cells(),
                         ids=lambda c: f"{c[0]}-{c[1]}")
def test_model_flops_equal_jax(cell):
    name, shape_name = cell
    for chips in (1, 256, 512):
        assert roofline._model_flops_per_device(reg.get(name), shape_name,
                                                chips) \
            == JRoof._model_flops_per_device(JReg.get(name), shape_name,
                                             chips)


@pytest.mark.parametrize("flops,nbytes,coll", [
    (3.1e15, 2.0e12, 4.0e10),        # compute-bound
    (1.0e12, 9.0e12, 0.0),           # memory-bound
    (1.0e12, 1.0e11, 5.0e11),        # collective-bound
])
def test_analyze_cell_equals_jax_at_jax_peaks(flops, nbytes, coll):
    peaks = dict(peak_flops=JTiling.V5E_PEAK_FLOPS_BF16,
                 hbm_bw=JTiling.V5E_HBM_BW, link_bw=JTiling.V5E_ICI_BW)
    for (name, shape_name), mesh_shape in zip(
            reg.runnable_cells(), [[1], [16, 16], [2, 16, 16]] * 12):
        base = {"arch": name, "shape": shape_name, "mesh": "x",
                "mesh_shape": mesh_shape}
        want = JRoof.analyze_cell(dict(
            base, cost_total={"flops": flops, "bytes accessed": nbytes},
            collective_bytes_total=coll))
        got = roofline.analyze_cell(dict(
            base, flops_per_device=flops, bytes_accessed_per_device=nbytes,
            collective_bytes=coll), **peaks)
        for k in ("chips", "flops_per_device", "hbm_bytes_per_device",
                  "collective_bytes_per_device", "compute_s", "memory_s",
                  "collective_s", "dominant", "model_flops_per_device",
                  "roofline_fraction"):
            assert got[k] == want[k], k
        assert got["model_over_counted"] == want["model_over_hlo"]
    # The defaults are the H100's.
    got = roofline.analyze_cell(dict(
        base, flops_per_device=989e12, bytes_accessed_per_device=3.35e12,
        collective_bytes=None))
    assert got["compute_s"] == pytest.approx(1.0)
    assert got["memory_s"] == pytest.approx(1.0)
    assert got["collective_s"] == 0 and not got["collective_traced"]


# ---------------------------------------------------------------------------
# The dry run against the same step on CPU tensors
# ---------------------------------------------------------------------------

REDUCED = [("tinyllama-1.1b", ShapeSpec("train", 16, 2)),
           ("tinyllama-1.1b", ShapeSpec("prefill", 16, 2)),
           ("tinyllama-1.1b", ShapeSpec("decode", 16, 2)),
           ("musicgen-medium", ShapeSpec("decode", 16, 2)),
           ("pixtral-12b", ShapeSpec("prefill", 16, 2)),
           ("dbrx-132b", ShapeSpec("train", 16, 2)),
           ("recurrentgemma-9b", ShapeSpec("train", 24, 2)),
           ("rwkv6-3b", ShapeSpec("prefill", 40, 2)),
           ("resnet50_dcn_bounded", ShapeSpec("train_det", 0, 2)),
           ("resnet50_dcn_bounded", ShapeSpec("infer_det", 0, 2)),
           ("resnet50_dcn", ShapeSpec("train_det", 0, 2))]


def _reduced_cell(name, shape):
    arch = reg.get(name)
    arch = dataclasses.replace(arch, config=reg.reduced_config(arch))
    return steps.with_shape(arch, "t", shape)


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


@pytest.mark.parametrize("name,shape", REDUCED,
                         ids=[f"{n}-{s.kind}" for n, s in REDUCED])
def test_dry_run_counts_equal_the_step_on_cpu_tensors(name, shape):
    arch = _reduced_cell(name, shape)
    trace = dryrun.trace_cell(arch, "t")
    rec = dryrun.run_cell(arch.name, "t", "card", arch=arch, trace=trace)
    step, inputs, _, _ = steps.make_cell_step(arch, "t", None)
    real = steps.real_inputs(arch, "t", inputs, "cpu", seed=1)
    assert rec["argument_bytes"] == _nbytes(real)
    with dryrun.StepCounter(known=real) as sc:
        out = step(*real)
    assert rec["flops"] == sc.flops > 0
    assert rec["dcl_calls"] == sc.dcl
    assert rec["output_bytes"] == _nbytes(out)
    if name == "resnet50_dcn_bounded":
        n_dcl = 2    # the reduced config's DCLs
        assert rec["dcl_calls"] == {
            "forward": n_dcl,
            "backward": n_dcl if shape.kind == "train_det" else 0}
        assert rec["dcl_flops"] > 0
    else:
        assert rec["dcl_calls"] == {"forward": 0, "backward": 0}
    assert all(np.isfinite(float(t.float().sum()))
               for t in tree_leaves(out) if isinstance(t, torch.Tensor))


def test_microbatched_train_step_counts_equal_on_cpu(monkeypatch):
    """JAX's gradient accumulation (8 microbatches from 90B params) on a
    reduced config: the same counts on meta and on the CPU, and one
    microbatch's forward FLOPs a quarter of the whole batch's."""
    monkeypatch.setattr(steps, "microbatches", lambda arch: 4)
    arch = _reduced_cell("grok-1-314b", ShapeSpec("train", 16, 8))
    trace = dryrun.trace_cell(arch, "t")
    step, inputs, _, _ = steps.make_cell_step(arch, "t", None)
    real = steps.real_inputs(arch, "t", inputs, "cpu")
    with dryrun.StepCounter(known=real) as sc:
        params, _, nxt, loss = step(*real)
    assert trace["flops"] == sc.flops
    assert int(nxt) == 1 and bool(torch.isfinite(loss))
    assert params is real[0]        # updated in place


def test_full_width_cell_stays_on_meta():
    """tinyllama-1.1b decode_32k at full width: the record's sizes are
    the ParamDefs' and the caches', and every tensor is ``meta``."""
    arch = reg.get("tinyllama-1.1b")
    trace = dryrun.trace_cell(arch, "decode_32k")
    assert all(t.device.type == "meta" for t in tree_leaves(trace["outputs"])
               if isinstance(t, torch.Tensor))
    rec = dryrun.run_cell(arch.name, "decode_32k", "card", arch=arch,
                          trace=trace)
    cfg = arch.config
    caches = 2 * cfg.n_layers * 128 * 32768 * cfg.kv_heads * cfg.hd * 2
    assert rec["argument_bytes_by_group"] == {
        "params": 4 * cfg.param_count(), "caches": caches, "tokens": 512,
        "pos": 512}
    assert rec["peak_live_bytes"] > rec["argument_bytes"]
    assert rec["flops"] > 2 * cfg.param_count() * 128
    single = dryrun.run_cell(arch.name, "decode_32k", "single", arch=arch,
                             trace=trace)
    assert single["mesh_shape"] == [16, 16]
    # KV 4 does not split 16 ways: it is replicated per query group (32
    # heads, 2 a device), the batch split over 'data'.
    ekv = cfg.n_heads
    assert single["argument_bytes_by_group"]["caches"] \
        == caches // cfg.kv_heads * ekv // 256
    assert single["flops_per_device"] == rec["flops"] / 256
    # The mesh's crossings are counted from the specs (launch.collectives):
    # every kind of JAX's parse_collectives, none left out.
    coll = single["collectives"]
    assert set(coll) == {"all-reduce", "all-gather", "reduce-scatter",
                         "all-to-all", "collective-permute", "total_bytes",
                         "total_count"}
    assert coll["total_bytes"] > 0 and coll["all-reduce"]["count"] > 0
    assert single["collective_bytes"] == coll["total_bytes"] / 256
    assert "collective_reason" not in single
    assert rec["collective_bytes"] is None and "one card" in \
        rec["collective_reason"]


@pytest.mark.parametrize("name", ["resnet50_dcn_bounded", "resnet50_dcn"])
@pytest.mark.parametrize("kind", ["train_det", "infer_det"])
def test_detector_mesh_record_counts_every_params_gradient(name, kind):
    """A detector's record on the (data=16, model=16) mesh: every layer
    runs per data shard, so its count is whole (no "partial" reason) and
    equals ``dcn_collectives``: in training each leaf's fp32 gradient
    from 15 data shards to the first, in inference nothing."""
    import math

    from repro_torch import tree as RT
    from repro_torch.launch import collectives
    from repro_torch.models import resnet_dcn
    arch = _reduced_cell(name, ShapeSpec(kind, 0, 32))
    trace = dryrun.trace_cell(arch, "t")
    rec = dryrun.run_cell(arch.name, "t", "single", arch=arch, trace=trace)
    assert "collective_reason" not in rec
    kcfg = dataclasses.replace(arch.config,
                               use_kernel=arch.config.offset_bound is not None)
    want = collectives.dcn_collectives(
        kcfg, dryrun.meta_mesh("single"), batch=32,
        train=kind == "train_det").summary()
    assert rec["collectives"] == want
    assert rec["collective_bytes"] == want["total_bytes"] / 256
    defs = RT.leaves(resnet_dcn.model_def(arch.config))
    if kind == "train_det":
        assert want["all-reduce"]["count"] == 15 * len(defs)
        assert want["total_bytes"] == want["all-reduce"]["bytes"] == 15 * 4 \
            * sum(math.prod(d.shape) for d in defs)
    else:
        assert want["total_count"] == 0


def test_a_tensor_off_meta_fails_the_dry_run():
    with pytest.raises(RuntimeError, match="made a tensor on cpu"):
        with dryrun.StepCounter(meta_only=True):
            torch.ones(2) + 1
    with dryrun.StepCounter(meta_only=True):    # no elements, no bytes
        torch.empty(0)


def test_live_bytes_frees_and_ignores_the_arguments():
    x = torch.empty(1000, device="meta")
    with dryrun.StepCounter(meta_only=True, known=[x]) as sc:
        x.mul_(2)                       # in place: nothing new
        y = x * 2
        z = y.view(10, 100) + 1
        del y
        w = z.sum()
    assert sc.peak_new_bytes == 8000    # y and z, before y is freed
    assert sc._live.live == 4000 + 4    # z and w
    assert w.device.type == "meta"


def test_cli_writes_records_and_the_roofline(tmp_path, capsys):
    dryrun.main(["--arch", "tinyllama-1.1b", "--shape", "decode_32k",
                 "--mesh", "all", "--dir", str(tmp_path)])
    files = sorted(p.name for p in tmp_path.glob("*.json"))
    assert files == [f"tinyllama-1.1b__decode_32k__{m}.json"
                     for m in ("card", "multi", "single")]
    roofline.main(["--mesh", "all", "--dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert out.count("| tinyllama-1.1b | decode_32k |") == 3
    rows = json.loads((tmp_path / "roofline.json").read_text())
    assert {r["mesh"] for r in rows} == {"card", "single", "multi"}
    card = next(r for r in rows if r["mesh"] == "card")
    assert card["dtype"] == "bfloat16" and card["fits_card"] is False
    assert card["dominant"] == "memory"


def test_a_failed_cell_carries_its_error(tmp_path):
    fails = dryrun.run_cells([("tinyllama-1.1b", "no_such_shape")],
                             ["card"], results_dir=tmp_path,
                             log=lambda s: None)
    assert len(fails) == 1
    rec = json.loads(
        (tmp_path / "tinyllama-1.1b__no_such_shape__card.json").read_text())
    assert "no_such_shape" in rec["error"] and rec["traceback"]
    assert roofline.load_all(None, tmp_path)[0]["error"] == rec["error"]


# ---------------------------------------------------------------------------
# The shape-only path of the DCL ops on meta
# ---------------------------------------------------------------------------

class _Sink:
    def __init__(self):
        self.events = []

    def begin(self, phase, ctx):
        self.events.append(("begin", phase, ctx["op"]))

    def end(self, phase, ctx):
        self.events.append(("end", phase, ctx["op"]))


def test_meta_deform_conv_is_shape_only_with_gradients():
    launches = deform_conv_fused_zerocopy.launches
    x = torch.empty(2, 17, 23, 8, device="meta", requires_grad=True)
    off = torch.empty(2, 9, 12, 18, device="meta", requires_grad=True)
    w = torch.empty(9, 8, 16, device="meta", requires_grad=True)
    sink = _Sink()
    with ops.work_scope(sink):
        y = ops.deform_conv(x, off, w, stride=2, offset_bound=2.0,
                            device="meta")
        assert y.shape == (2, 9, 12, 16) and y.device.type == "meta"
        gx, goff, gw = torch.autograd.grad(y.sum(), (x, off, w))
    assert (gx.shape, goff.shape, gw.shape) == (x.shape, off.shape, w.shape)
    assert sink.events == [("begin", "forward", "deform_conv"),
                           ("end", "forward", "deform_conv"),
                           ("begin", "backward", "deform_conv"),
                           ("end", "backward", "deform_conv")]
    off1 = torch.empty(2, 17, 23, 18, device="meta")
    yq = ops.deform_conv(x.detach(), off1, w.detach(), offset_bound=2.0,
                         precision="int8", device="meta")
    assert yq.shape == (2, 17, 23, 16) and yq.dtype == torch.float32
    for emit, dtype in (("int8", torch.int8), ("fp32", torch.float32)):
        yc = ops.deform_conv_chain(
            x.detach(), w.detach(), torch.empty(9, 8, 18, device="meta"),
            None, offset_bound=2.0, x_scale=0.1, y_scale=0.2, emit=emit,
            device="meta")
        assert yc.shape == (2, 17, 23, 16) and yc.dtype == dtype
    assert deform_conv_fused_zerocopy.launches == launches
    assert not _build._loaded


def test_cpu_calls_do_not_take_the_meta_path():
    """On the CPU the op runs its plain version (values, not empties),
    and the sink brackets it the same way."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(1, 8, 8, 4, generator=g)
    off = torch.randn(1, 8, 8, 18, generator=g)
    w = torch.randn(9, 4, 4, generator=g)
    sink = _Sink()
    with ops.work_scope(sink):
        y = ops.deform_conv(x, off, w, offset_bound=2.0, device="cpu")
    assert y.abs().sum() > 0
    assert [e[:2] for e in sink.events] == [("begin", "forward"),
                                            ("end", "forward")]


# ---------------------------------------------------------------------------
# A windowed model served at any cache_len
# ---------------------------------------------------------------------------

RG = "recurrentgemma-9b"


def _perturbed(tree, seed):
    rng = np.random.RandomState(seed)

    def go(node):
        if isinstance(node, dict):
            return {k: go(node[k]) for k in sorted(node)}
        a = np.array(node)
        if not a.any():
            a = (rng.randn(*a.shape) * 0.1).astype(a.dtype)
        return a
    return go(tree)


def _rg_params(seed=2):
    jcfg = JReg.reduced_config(JReg.get(RG))
    tcfg = reg.reduced_config(reg.get(RG))
    tree = _perturbed(JT.init_params(jax.random.PRNGKey(seed), jcfg), seed)
    return jcfg, tcfg, jax.tree_util.tree_map(jnp.asarray, tree), \
        params_from_jax(tree, device="cpu")


def _served(tp, tcfg, cache_len, prompts, max_new):
    eng = ServingEngine(tp, tcfg, ServeConfig(slots=2, cache_len=cache_len),
                        device="cpu")
    for i, p in enumerate(prompts):
        eng.submit(Request(uid=i, prompt=p, max_new_tokens=max_new))
    return {r.uid: r.output for r in eng.run_until_drained()}, eng


def test_prefill_cache_is_the_ring_of_the_window():
    _, tcfg, _, tp = _rg_params()
    toks = torch.as_tensor(np.random.RandomState(3).randint(0, 128, (1, 21)))
    _, c16 = TT.prefill(tp, tcfg, toks, cache_len=16)
    for cache_len in (24, 128):
        _, c = TT.prefill(tp, tcfg, toks, cache_len=cache_len)
        k = c["layers"]["m2"]["k"]
        assert k.shape[2] == 16                      # min(cache_len, 16)
        assert torch.equal(k, c16["layers"]["m2"]["k"])
    short = toks[:, :5]
    _, c = TT.prefill(tp, tcfg, short, cache_len=128)
    assert c["layers"]["m2"]["k"].shape[2] == 16
    assert not c["layers"]["m2"]["k"][:, :, 5:].any()  # unwritten slots


@pytest.mark.parametrize("cache_len", [24, 128])
def test_engine_tokens_equal_the_engine_at_the_window(cache_len):
    _, tcfg, _, tp = _rg_params()
    rng = np.random.RandomState(4)
    prompts = [rng.randint(0, tcfg.vocab, n).astype(np.int32)
               for n in (5, 9, 3, 7)]
    want, _ = _served(tp, tcfg, 16, prompts, 6)
    got, eng = _served(tp, tcfg, cache_len, prompts, 6)
    assert got == want
    assert eng.caches["layers"]["m2"]["k"].shape[2] == 16


@pytest.mark.parametrize("cache_len", [24, 128])
def test_engine_past_the_window_equals_jax_prefill_and_decode(cache_len):
    """A prompt longer than the window (every ring slot written, so JAX's
    unwritten-slot fault stays out): the engine's greedy tokens equal
    JAX's ``prefill(cache_len=window)`` followed by ``decode_step``."""
    jcfg, tcfg, jp, tp = _rg_params()
    prompt = np.random.RandomState(5).randint(0, jcfg.vocab, 17) \
        .astype(np.int32)
    n_new = 6
    logits, cache = JT.prefill(jp, jcfg, jnp.asarray(prompt[None]),
                               cache_len=16)
    want = [int(np.asarray(logits[0]).argmax())]
    for i in range(n_new - 1):
        logits, cache = JT.decode_step(
            jp, jcfg, jnp.asarray([want[-1]], jnp.int32), cache,
            jnp.asarray([len(prompt) + i], jnp.int32))
        want.append(int(np.asarray(logits[0]).argmax()))
    got, _ = _served(tp, tcfg, cache_len, [prompt], n_new)
    assert got[0] == want


def test_serve_launcher_defaults_with_reduced_windowed_model(capsys):
    """``python -m repro_torch.launch.serve --arch recurrentgemma-9b
    --reduced --device cpu``: the default ``--cache-len`` 128 exceeds the
    reduced window of 16, and it serves."""
    args = serve_launch.build_parser().parse_args(
        ["--arch", RG, "--reduced", "--device", "cpu"])
    assert args.cache_len == 128 and args.requests == 8
    serve_launch.main(["--arch", RG, "--reduced", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "served 8 requests / 128 tokens" in out
