"""Build and load the hand-written CUDA kernels.

Each kernel package keeps its source under ``csrc/<name>.cu`` with a plain
C interface. ``library(name)`` compiles it with ``nvcc`` for Hopper
(``sm_90a``) into ``build/kernels/`` at the repository root on first use
and loads it with ``ctypes``. The library's file name carries a hash of
the source and the flags, so an edited source is never served a stale
build. Nothing here runs on import: the CPU tests import every module on
a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Sequence

KERNELS = ("batched_topk", "tier_assign", "logmem_update", "topk_filter")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG.parents[2] / "build" / "kernels"

_loaded: Dict[str, ctypes.CDLL] = {}


def source(name: str) -> Path:
    return _PKG / name / "csrc" / f"{name}.cu"


def _target(name: str) -> Path:
    h = hashlib.sha256(source(name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return str(path)


def build(names: Sequence[str] = KERNELS) -> Dict[str, str]:
    """Compile every named kernel that has no up-to-date library, one
    ``nvcc`` process per source, all started together. Returns
    {name: ptxas report} for the kernels compiled now (empty for those
    already built). Raises if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        target = _target(name)
        if target.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, str(source(name))]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
    reports, failed = {}, []
    for name, (proc, tmp, target) in procs.items():
        out = proc.communicate()[0]
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{name}:\n{out}")
            continue
        os.replace(tmp, target)  # atomic: a reader never sees a partial .so
        reports[name] = out
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel ``name``, built if needed."""
    lib = _loaded.get(name)
    if lib is None:
        target = _target(name)
        if not target.exists():
            build([name])
        lib = ctypes.CDLL(str(target))
        _loaded[name] = lib
    return lib
