"""Import hygiene of the port: ``repro_torch`` and ``chip_smoke.py`` use
neither JAX nor the JAX package, importing builds nothing, and a kernel
whose build fails raises on CUDA instead of running its plain version."""
import ast
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _forbidden(name: str) -> bool:
    return name in ("jax", "repro") or name.startswith(("jax.", "repro."))


def _modules():
    return sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
        .removesuffix(".__init__")
        for p in PKG.rglob("*.py"))


def test_importing_every_module_loads_no_jax_and_no_reference_package():
    code = (
        "import importlib, sys\n"
        f"mods = {_modules()!r}\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'repro') or "
        "m.startswith(('jax.', 'repro.')))\n"
        "from repro_torch.kernels import _build\n"
        "print(len(mods), bad, len(_build._loaded))\n"
        "sys.exit(1 if bad or _build._loaded else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, cwd=ROOT)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.split()[0] == str(len(_modules()))


def test_the_mesh_modules_are_among_those_checked():
    """The device mesh's modules take part in both checks above."""
    assert {"repro_torch.distributed", "repro_torch.distributed.sharding",
            "repro_torch.distributed.spatial",
            "repro_torch.distributed.compression",
            "repro_torch.distributed.pipeline", "repro_torch.launch.mesh",
            "repro_torch.models.pipelined",
            "repro_torch.configs.command_r_35b"} <= set(_modules())


def test_the_planning_modules_are_among_those_checked():
    """The planning layer's modules take part in both checks: the FPGA
    model and traffic reports, the step builders, the meta dry run and
    the roofline."""
    assert {"repro_torch.core.perf_model", "repro_torch.launch.steps",
            "repro_torch.launch.dryrun",
            "repro_torch.launch.roofline"} <= set(_modules())


def test_the_param_sharding_modules_are_among_those_checked():
    """The modules that lay an LM's params out on the mesh and run its
    layers per shard take part in both checks: placement, the layers,
    the model, the optimizers, the compression, the Trainer, the
    checkpoint, the launchers and the dry run."""
    assert {"repro_torch.tree", "repro_torch.distributed.sharding",
            "repro_torch.models.layers", "repro_torch.models.transformer",
            "repro_torch.optim.optimizers",
            "repro_torch.distributed.compression",
            "repro_torch.train.trainer", "repro_torch.checkpoint.checkpoint",
            "repro_torch.launch.train", "repro_torch.launch.steps",
            "repro_torch.launch.dryrun",
            "repro_torch.core.deform_conv"} <= set(_modules())


@pytest.mark.parametrize("path", [ROOT / "chip_smoke.py"]
                         + sorted(PKG.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax_or_the_reference_package(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        assert not any(_forbidden(n) for n in names), (path, names)


def test_the_last_mesh_paths_are_among_those_checked():
    """The modules of the MoE, RG-LRU and RWKV-6 mesh paths, Adafactor on
    placed leaves, the collective count and the metrics and trace exports
    take part in both checks, and each new name is there."""
    assert {"repro_torch.models.moe", "repro_torch.models.rglru",
            "repro_torch.models.rwkv6", "repro_torch.optim.optimizers",
            "repro_torch.launch.collectives", "repro_torch.obs.metrics",
            "repro_torch.obs.trace", "repro_torch.serve.admission",
            "repro_torch.distributed.spatial"} <= set(_modules())
    from repro_torch import obs, optim
    from repro_torch.distributed import sharding
    from repro_torch.launch import collectives
    from repro_torch.models import moe, rglru, rwkv6
    from repro_torch.serve.admission import AdmissionQueue
    for mod, names in (
            (obs, ("get_registry", "set_registry", "registry_scope",
                   "parse_prometheus_text")),
            (obs.MetricsRegistry, ("metrics", "prometheus_text")),
            (obs.Histogram, ("count", "sum", "bucket_width")),
            (obs.Gauge, ("inc",)),
            (obs.Tracer, ("clear", "to_chrome", "export_chrome")),
            (optim, ("chain_clip",)), (AdmissionQueue, ("head_bucket",)),
            (sharding, ("count_crossings", "move", "fetch_crossings",
                        "within", "position")),
            (collectives, ("lm_collectives", "spatial_collectives")),
            (moe, ("moe_stats", "aux_from_stats", "expert_split")),
            (rglru, ("rnn_split",)), (rwkv6, ("head_split", "ff_split"))):
        for name in names:
            assert hasattr(mod, name), (mod, name)


def test_library_is_named_by_its_source_and_built_outside_git():
    import hashlib
    from repro_torch.kernels import _build
    names = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    assert names == sorted(_build.SIGNATURES) == ["dcnv3",
                                                  "deform_conv_bwd",
                                                  "deform_conv_fused",
                                                  "deform_conv_q",
                                                  "deform_sample",
                                                  "flash_attention",
                                                  "matmul"]
    for name in names:
        src = _build.CSRC / f"{name}.cu"
        lib = _build.library_path(name)
        # The source's bytes, then those of each csrc header it includes.
        headers = re.findall(r'^#include "([^"]+)"', src.read_text(),
                             re.MULTILINE)
        data = src.read_bytes() + b"".join(
            (_build.CSRC / h).read_bytes() for h in headers)
        assert hashlib.sha1(data).hexdigest()[:12] in lib.name
        assert lib.parent.relative_to(ROOT).parts[0] == "build"
        # Every exported C function has a ctypes signature.
        for fn in _build.SIGNATURES[name]:
            assert f" {fn}(" in src.read_text(), (name, fn)
    assert "build/" in (ROOT / ".gitignore").read_text().split()


def test_edited_header_renames_the_library(tmp_path, monkeypatch):
    """A library is named by its source and every header it includes, so
    an edited shared header is never served by a stale build."""
    import shutil
    from repro_torch.kernels import _build
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    assert [p.name for p in _build.sources("matmul")] == ["matmul.cu",
                                                         "warp_mma.cuh"]
    assert [p.name for p in _build.sources("deform_sample")] \
        == ["deform_sample.cu"]
    before = {n: _build.library_path(n) for n in ("flash_attention",
                                                   "matmul", "deform_sample")}
    with open(csrc / "warp_mma.cuh", "a") as f:
        f.write("// edited\n")
    after = {n: _build.library_path(n) for n in before}
    assert after["flash_attention"] != before["flash_attention"]
    assert after["matmul"] != before["matmul"]
    assert after["deform_sample"] == before["deform_sample"]


def test_chip_smoke_alone_fails_without_result(tmp_path):
    (tmp_path / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text())
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_every_kernel_module_is_checked():
    """The modules of the kernels and of the operations layer are among
    those the two tests above import and parse."""
    mods = _modules()
    for name in ("deform_sample", "matmul", "deform_conv_fused",
                 "deform_conv_bwd", "deform_conv_q", "flash_attention"):
        assert f"repro_torch.kernels.{name}" in mods
    for name in ("models.transformer", "models.registry", "serve.engine",
                 "configs.tinyllama_1_1b", "configs.deepseek_7b",
                 "configs.glm4_9b", "core.h100", "obs", "obs.divergence",
                 "tune", "tune.cache", "tune.autotune", "resilience",
                 "resilience.faults", "launch.obs_report", "models.rglru",
                 "configs.recurrentgemma_9b", "data.pipeline",
                 "launch.train", "models.rwkv6", "models.moe",
                 "configs.rwkv6_3b", "configs.dbrx_132b",
                 "configs.grok_1_314b", "configs.musicgen_medium",
                 "configs.pixtral_12b"):
        assert f"repro_torch.{name}" in mods


def _cuda_calls():
    """One CUDA call of each kernel wrapper, on fake CUDA tensors (no
    memory, no device): every check passes, so only the build stands
    between the call and its launch."""
    from repro_torch.kernels import deform_conv_bwd as B
    from repro_torch.kernels import deform_conv_fused as F
    from repro_torch.kernels import deform_conv_q as Q
    from repro_torch.kernels import deform_sample as S
    from repro_torch.kernels import flash_attention as A
    from repro_torch.kernels import matmul as M
    geom = dict(kernel_size=3, stride=1, dilation=1, offset_bound=2.0)
    band_h = 8 - 1 + 2 + 4 + 2            # Eq. 6 rows of an 8-row tile

    def f32(*shape):
        return torch.empty(*shape, device="cuda")
    return {
        "deform_sample_zerocopy": (S, lambda: S.deform_sample_zerocopy(
            f32(1, 16, 16, 4), f32(1, 4, 4, 18), tile_h=4, tile_w=4,
            **geom)),
        "deform_sample_banded": (S, lambda: S.deform_sample_banded(
            f32(1, 1, band_h, 16, 4), f32(1, 8, 8, 18), tile_h=8, **geom)),
        "deform_conv_fused_banded": (F, lambda: F.deform_conv_fused_banded(
            f32(1, 1, band_h, 16, 4), f32(1, 8, 8, 18), f32(1, 36, 8),
            tile_h=8, **geom)),
        "deform_conv_fused_zerocopy": (F, lambda: F.deform_conv_fused_zerocopy(
            f32(1, 16, 16, 4), f32(1, 4, 4, 18), f32(1, 36, 8), tile_h=4,
            tile_w=4, **geom)),
        "deform_conv_bwd_zerocopy": (B, lambda: B.deform_conv_bwd_zerocopy(
            f32(1, 16, 16, 4), f32(1, 4, 4, 18), f32(1, 4, 4, 8),
            f32(1, 36, 8), tile_h=4, tile_w=4, tile_c=4, **geom)),
        "deform_conv_fused_zerocopy_q": (
            Q, lambda: Q.deform_conv_fused_zerocopy_q(
                torch.empty(1, 16, 16, 4, dtype=torch.int8, device="cuda"),
                f32(1, 4, 4, 18),
                torch.empty(1, 36, 8, dtype=torch.int8, device="cuda"),
                f32(8), tile_h=4, tile_w=4, tile_c=4, **geom)),
        "matmul": (M, lambda: M.matmul(f32(8, 4), f32(4, 8))),
        "flash_attention": (A, lambda: A.flash_attention(
            f32(1, 8, 2, 2, 16), f32(1, 8, 2, 16), f32(1, 8, 2, 16))),
        "flash_attention_bh": (A, lambda: A.flash_attention_bh(
            f32(4, 8, 16), f32(4, 8, 16), f32(4, 8, 16))),
    }


WRAPPERS = ["deform_sample_zerocopy", "deform_sample_banded",
            "deform_conv_fused_banded", "deform_conv_fused_zerocopy",
            "deform_conv_bwd_zerocopy", "deform_conv_fused_zerocopy_q",
            "matmul", "flash_attention", "flash_attention_bh"]


@pytest.mark.parametrize("wrapper", WRAPPERS)
def test_cuda_call_raises_when_the_kernel_does_not_build(wrapper, tmp_path,
                                                         monkeypatch):
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import _build
    monkeypatch.setattr(_build, "_nvcc", lambda: "false")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_loaded", {})
    with FakeTensorMode():
        module, call = _cuda_calls()[wrapper]
        plain = [n for n in vars(module) if n.endswith("_plain")]
        for name in plain:
            monkeypatch.setattr(module, name, _no_plain)
        before = getattr(module, wrapper).launches
        with pytest.raises(RuntimeError, match="kernel build failed"):
            call()
    assert getattr(module, wrapper).launches == before
    assert plain and not list(tmp_path.glob("*.so"))


def _no_plain(*args, **kwargs):
    raise AssertionError("a CUDA call ran the plain version")
