"""Build and load the hand-written CUDA kernels.

Each kernel package keeps its sources under ``csrc/``, ``<name>.cu`` and
any further ``*.cu`` (with shared ``*.cuh`` headers), behind a plain C
interface. ``library(name)`` compiles each source with ``nvcc`` for
Hopper (``sm_90a``), all at once, links them into one library in
``build/kernels/`` at the repository root on first use and loads it with
``ctypes``. The library's file name carries a hash of the sources and
the flags, so an edited source is never served a stale build. Nothing
here runs on import: the CPU tests import every module on a machine
without ``nvcc``.

The build reports to the compile-cache probe ``"kernels.build"``
(``obs.jits``), keyed by kernel name: a kernel compiled by ``nvcc`` is a
miss (``compile_s``: the seconds until its library is linked), a library
found up to date by ``build`` or loaded from ``build/kernels/`` by
``library`` is a hit.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Sequence

from repro_torch.obs import jits

KERNELS = ("batched_topk", "tier_assign", "logmem_update", "topk_filter",
           "plan_solve", "entropy_scores", "flash_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG.parents[2] / "build" / "kernels"

_loaded: Dict[str, ctypes.CDLL] = {}


def sources(name: str) -> List[Path]:
    """The kernel's translation units: every ``csrc/*.cu`` of its
    package."""
    return sorted((_PKG / name / "csrc").glob("*.cu"))


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for path in sorted((_PKG / name / "csrc").glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _cached() -> int:
    """Libraries in the build cache."""
    return sum(1 for _ in BUILD_DIR.glob("lib*.so"))


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
    ``nvcc -c`` process per source file, all started together, then link
    each kernel's objects into its library. Returns {name: ptxas report}
    for the kernels compiled now (empty for those already built). Raises
    if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    probe = jits.probe("kernels.build")
    jobs = {}
    t0 = time.perf_counter()
    for name in names:
        target = _target(name)
        if target.exists():
            probe.record(False, 0.0, key=name, cache_size=_cached())
            continue
        work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
        procs = []
        for i, src in enumerate(sources(name)):
            obj = work / f"{i}-{src.stem}.o"
            procs.append((subprocess.Popen(
                [nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), obj))
        jobs[name] = (procs, work, target)
    reports, failed = {}, []
    for name, (procs, work, target) in jobs.items():
        outs = [(proc.communicate()[0], proc.returncode) for proc, _ in procs]
        report = "".join(out for out, _ in outs)
        if any(rc != 0 for _, rc in outs):
            failed.append(f"{name}:\n{report}")
            shutil.rmtree(work, ignore_errors=True)
            continue
        lib = work / "lib.so"
        link = subprocess.run([nvcc(), "-shared", "-o", str(lib),
                               *(str(obj) for _, obj in procs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            failed.append(f"{name} (link):\n{link.stdout}{link.stderr}")
        else:
            # atomic: a reader never sees a partial .so
            os.replace(lib, target)
            probe.record(True, time.perf_counter() - t0, key=name,
                         cache_size=_cached())
            reports[name] = report
        shutil.rmtree(work, ignore_errors=True)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel ``name``, built if needed."""
    lib = _loaded.get(name)
    if lib is None:
        target = _target(name)
        if target.exists():
            jits.probe("kernels.build").record(False, 0.0, key=name,
                                               cache_size=_cached())
        else:
            build([name])
        lib = ctypes.CDLL(str(target))
        _loaded[name] = lib
    return lib
