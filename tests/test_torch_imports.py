"""Import hygiene of the port: ``repro_torch`` and ``chip_smoke.py`` use
neither JAX nor the JAX package, and importing builds nothing."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

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


def test_library_is_named_by_its_source_and_built_outside_git():
    import hashlib
    from repro_torch.kernels import _build
    names = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    assert names == sorted(_build.SIGNATURES) == ["deform_conv_bwd",
                                                  "deform_conv_fused",
                                                  "deform_conv_q"]
    for name in names:
        src = _build.CSRC / f"{name}.cu"
        lib = _build.library_path(name)
        assert hashlib.sha1(src.read_bytes()).hexdigest()[:12] in lib.name
        assert lib.parent.relative_to(ROOT).parts[0] == "build"
        # Every exported C function has a ctypes signature.
        for fn in _build.SIGNATURES[name]:
            assert f" {fn}(" in src.read_text(), (name, fn)
    assert "build/" in (ROOT / ".gitignore").read_text().split()


def test_chip_smoke_alone_fails_without_result(tmp_path):
    (tmp_path / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text())
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
