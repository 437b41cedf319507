"""Build and load the port's CUDA kernels (nvcc into a shared library with
a plain C interface, loaded with ctypes).

Every ``*.cu`` under ``kernels/csrc/`` becomes ``build/repro_torch/
lib<name>-<hash>.so`` at the root of the checkout (listed in
``.gitignore``); the hash of the source and of every ``csrc/*.cuh`` it
includes names the library, so an edited source or header is never served
by a stale build.  Nothing is built when a module is imported: the first
call that launches a kernel builds it, and ``build_all`` builds every
source at once, one ``nvcc`` each, started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures of every exported function, per library.
SIGNATURES = {
    "deform_conv_fused": {
        "dcf_forward": (_I, [_P, _P, _P, _P] + [_I] * 10
                        + [ctypes.c_float] + [_I] * 5 + [_P]),
        "dcf_forward_banded": (_I, [_P, _P, _P, _P] + [_I] * 10
                               + [ctypes.c_float] + [_I] * 5 + [_P]),
        "dcf_smem_bytes": (ctypes.c_longlong, [_I] * 7),
        "dcf_error_string": (ctypes.c_char_p, [_I]),
    },
    "deform_sample": {
        "ds_zerocopy": (_I, [_P] * 3 + [_I] * 9 + [ctypes.c_float]
                        + [_I] * 4 + [_P]),
        "ds_banded": (_I, [_P] * 3 + [_I] * 9 + [ctypes.c_float]
                      + [_I] * 4 + [_P]),
        "ds_smem_bytes": (ctypes.c_longlong, [_I] * 7),
        "ds_error_string": (ctypes.c_char_p, [_I]),
    },
    "flash_attention": {
        "fa_forward": (_I, [_P] * 5 + [_I] * 8
                       + [ctypes.c_float, _I, _P]),
        "fa_smem_bytes": (ctypes.c_longlong, [_I, _I]),
        "fa_error_string": (ctypes.c_char_p, [_I]),
    },
    "matmul": {
        "mm_f32": (_I, [_P] * 3 + [_I] * 5 + [_P]),
        "mm_bf16": (_I, [_P] * 3 + [_I] * 4 + [_P]),
        "mm_error_string": (ctypes.c_char_p, [_I]),
    },
    "deform_conv_bwd": {
        "dcb_backward": (_I, [_P] * 10 + [_I] * 10 + [ctypes.c_float]
                         + [_I] * 7 + [_P]),
        "dcb_smem_bytes": (ctypes.c_longlong, [_I] * 7),
        "dcb_dw_smem_bytes": (ctypes.c_longlong, [_I] * 7),
        "dcb_error_string": (ctypes.c_char_p, [_I]),
    },
    "deform_conv_q": {
        "dcq_forward": (_I, [_P] * 5 + [_I] * 10 + [ctypes.c_float]
                        + [_I] * 5 + [_P]),
        "dcc_forward": (_I, [_P] * 8 + [_I] * 11 + [ctypes.c_float]
                        + [_I] * 5 + [_P]),
        "dcq_smem_bytes": (ctypes.c_longlong, [_I] * 7),
        "dcc_smem_bytes": (ctypes.c_longlong, [_I] * 7),
        "dcq_error_string": (ctypes.c_char_p, [_I]),
    },
}

_loaded: dict[str, ctypes.CDLL] = {}
build_log: dict[str, str] = {}      # name -> nvcc's output (ptxas -v)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: building the CUDA kernels needs "
                           "the CUDA toolkit")
    return path


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def sources(name: str) -> list[pathlib.Path]:
    """``csrc/{name}.cu`` and every ``csrc`` header it includes, directly
    or through another header (``#include "x.cuh"``)."""
    found = [CSRC / f"{name}.cu"]
    for path in found:
        for inc in _INCLUDE.findall(path.read_bytes()):
            dep = CSRC / inc.decode()
            if dep.exists() and dep not in found:
                found.append(dep)
    return found


def library_path(name: str) -> pathlib.Path:
    """The library's path, named by the SHA-1 of the source followed by
    its headers (of the source alone when it includes none)."""
    digest = hashlib.sha1()
    for path in sources(name):
        digest.update(path.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build_all(names=None) -> dict[str, float]:
    """Build the named sources (default: all of ``csrc/``) in parallel.
    Returns seconds per built library; up-to-date libraries are skipped.
    Raises with nvcc's output if a build fails."""
    names = sorted(p.stem for p in CSRC.glob("*.cu")) if names is None \
        else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out, time.monotonic())
    seconds = {}
    failed = []
    for name, (proc, tmp, out, t0) in jobs.items():
        log, _ = proc.communicate()
        seconds[name] = time.monotonic() - t0
        build_log[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, (restype, argtypes) in SIGNATURES[name].items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        _loaded[name] = lib
    return lib
