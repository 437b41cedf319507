"""Every public name of the JAX package has a counterpart in the port.

Both trees are parsed with ``ast`` (neither is imported): each public
top-level function and class of ``src/repro/<module>.py``, and each public
method and dataclass field of such a class, must be defined (or imported)
under the same name in ``src/repro_torch/<module>.py``, or stand in
``EXCEPTIONS`` with where the port's counterpart lives or why there is
none.  A name the port has since gained must leave the dict.
(``DCLConfig.use_bias`` and ``init_dcl_params``, which this check found
missing, are held against JAX's in ``test_torch_deform_conv.py``.)"""
import ast
import pathlib

import pytest

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"

_MEGACORE = "the TPU megacore split (cores); a CUDA grid has no counterpart"
_PALLAS = ("a Pallas internal of the TPU kernels (DMA staging, the kernel "
           "plan, the pallas_call emitter); on the card csrc/*.cu and the "
           "kernels/*.py wrappers")
_FALLBACK = ("the JAX kernel-to-XLA fallback; the port has none: a failed "
             "launch raises (kernels/ops.py)")
_TREE = "JAX tree idiom (ShapeDtypeStruct leaves); the port uses meta tensors"

# (module, name) -> the port's counterpart, or why there is none; name "*"
# for a module the port has no file for.
EXCEPTIONS = {
    ("core/deform_conv.py", "dcl_forward_jit"):
        "jax.jit of dcl_forward; the port calls dcl_forward (no tracing)",
    ("core/tiling.py", "TileConfig.vmem_bytes"):
        "TileConfig.onchip_bytes (smem_bytes names the 1a kernel's mirror)",
    ("core/tiling.py", "TileChoice.vmem_bytes"): "TileChoice.onchip_bytes",
    ("core/tiling.py", "zerocopy_vmem_bytes"):
        "the kernels' own working sets: smem_bytes (1a, 4), q_smem_bytes "
        "(1c, 1d), sample_smem_bytes (1b, 3)",
    ("core/tiling.py", "zerocopy_bwd_vmem_bytes"):
        "bwd_smem_bytes and bwd_dw_smem_bytes (kernel 2's two kernels)",
    ("distributed/sharding.py", "named_sharding"):
        "sharding.place / place_tree: a block per mesh position",
    ("distributed/spatial.py", "SpatialSpec.pspec"):
        "a PartitionSpec for shard_map; SpatialSpec.devices / positions "
        "place the height blocks",
    ("kernels/_compat.py", "*"): "a Pallas shim; the port has no Pallas",
    **{("kernels/band_pipeline.py", n): _PALLAS for n in (
        "BandStager", "BandStager.dma", "BandStager.prefetch",
        "BandStager.stage", "BandStager.wait", "BandStager.warmup",
        "DCLPlan", "DCLPlan.band_scratch", "DCLPlan.contract",
        "DCLPlan.dma_sem", "DCLPlan.jnp_acc_dtype", "DCLPlan.jnp_band_dtype",
        "DCLPlan.sample", "DCLPlan.stager", "DCLPlan.acc_dtype",
        "DCLPlan.band", "DCLPlan.band_dtype", "DCLPlan.cores",
        "DCLPlan.epilogue", "DCLPlan.fuse_offsets", "DCLPlan.tile_c",
        "DCLPlan.tile_m", "forward_call", "make_band_dma")},
    ("kernels/ops.py", "default_interpret"):
        "Pallas interpret mode; a wrapper runs its plain version on CPU "
        "tensors",
    ("kernels/ops.py", "set_degradation"): _FALLBACK,
    ("kernels/ops.py", "degradation_scope"): _FALLBACK,
    ("kernels/ops.py", "reset_fallback_warnings"): _FALLBACK,
    ("kernels/ops.py", "set_dispatch_hook"):
        "ops.dispatch_hook_scope and ops.get_dispatch_hook",
    ("kernels/plan.py", "reference_forward"):
        _FALLBACK + "; the plain versions are kernels/ref.py and "
        "core.deform_conv.dcl_forward",
    ("kernels/plan.py", "DCSpec.cores"): _MEGACORE,
    ("kernels/plan.py", "DCSpec.dw_flush_every_step"):
        "a TPU scheduling knob of the backward's d_weights flush; kernel 2 "
        "reduces its pixel splits once (dcb_reduce_kernel)",
    ("kernels/plan.py", "DCSpec.interpret"):
        "Pallas interpret mode; the tensors' device picks the path",
    ("launch/dryrun.py", "parse_collectives"):
        "parses XLA HLO text; the port counts collectives from the specs "
        "(launch/collectives.py) and as they run (sharding.count_crossings)",
    ("launch/platform.py", "*"):
        "the Pallas lowering switch (tpu, interpret, xla_ref); the tensors' "
        "device picks the kernel or its plain version",
    ("launch/steps.py", "arch_abstract_params"):
        _TREE + ": launch.steps.arch_param_defs with layers.meta_tree",
    ("launch/steps.py", "arch_param_specs"):
        "launch.steps.arch_param_defs with layers.spec_tree",
    ("models/layers.py", "abstract_tree"): _TREE + ": layers.meta_tree",
    ("models/registry.py", "input_specs"):
        "launch.steps.input_defs with layers.spec_tree",
    ("models/registry.py", "input_shardings"):
        "launch.steps.input_defs; sharding.place_tree places them",
    ("models/resnet_dcn.py", "ResNetDCNConfig.bwd_cores"): _MEGACORE,
    ("models/transformer.py", "abstract_params"):
        _TREE + ": transformer.param_defs with layers.meta_tree",
    ("models/transformer.py", "abstract_cache"):
        _TREE + ": transformer.cache_defs with layers.meta_tree",
    ("models/transformer.py", "param_specs"):
        "transformer.param_defs with layers.spec_tree",
    ("models/transformer.py", "cache_specs"):
        "transformer.cache_defs with layers.spec_tree",
    ("obs/divergence.py", "DispatchKey.cores"): _MEGACORE,
    ("optim/optimizers.py", "abstract_opt_state"):
        _TREE + ": Optimizer.init on meta params (launch/dryrun.py)",
    ("optim/optimizers.py", "Optimizer.abstract_init"):
        _TREE + ": Optimizer.init on meta params (launch/dryrun.py)",
    ("quant/qtypes.py", "QTensor.tree_flatten"):
        "JAX pytree registration; the port's QTensor is a plain object",
    ("quant/qtypes.py", "QTensor.tree_unflatten"):
        "JAX pytree registration; the port's QTensor is a plain object",
}


def _public(name: str) -> bool:
    return not name.startswith("_")


def _names(root: pathlib.Path, *, imports: bool) -> dict[str, set[str]]:
    """{module path: its public top-level functions and classes, and each
    class's public methods and annotated fields as "Class.name"; with
    ``imports`` also the names it imports (a re-export)}."""
    out = {}
    for path in sorted(root.rglob("*.py")):
        names = set()
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)) and _public(node.name):
                names.add(node.name)
                members = node.body if isinstance(node, ast.ClassDef) else ()
                for sub in members:
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                        sub_name = sub.name
                    elif isinstance(sub, ast.AnnAssign) and \
                            isinstance(sub.target, ast.Name):
                        sub_name = sub.target.id
                    else:
                        continue
                    if _public(sub_name):
                        names.add(f"{node.name}.{sub_name}")
            elif imports and isinstance(node, ast.ImportFrom):
                names.update(a.asname or a.name for a in node.names)
        out[path.relative_to(root).as_posix()] = names
    return out


JAX = _names(SRC / "repro", imports=False)
PORT = _names(SRC / "repro_torch", imports=True)


def _missing(module: str) -> set[str]:
    if module not in PORT:
        return {"*"}
    return JAX[module] - PORT[module]


@pytest.mark.parametrize("module", sorted(JAX))
def test_every_public_name_has_a_counterpart(module):
    unexplained = sorted(n for n in _missing(module)
                         if (module, n) not in EXCEPTIONS)
    assert not unexplained, (
        f"{module}: {unexplained} have no counterpart in src/repro_torch/"
        f"{module}; port them or say in EXCEPTIONS where they live")


def test_every_exception_is_needed_and_says_why():
    for (module, name), why in EXCEPTIONS.items():
        assert module in JAX, module
        assert name in _missing(module), \
            f"{module}:{name} has a counterpart now; drop its exception"
        assert len(why) > 20, (module, name)

