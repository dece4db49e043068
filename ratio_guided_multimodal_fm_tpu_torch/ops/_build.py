"""Build the CUDA C++ kernels of `csrc/` and load them with ctypes.

Each `csrc/<name>.cu` exposes a plain C interface (no PyTorch headers), so
one `nvcc` run takes seconds. Sources are compiled on first use into
`build/kernels/` at the repository root (listed in .gitignore), one shared
library per source, named by a hash of the source, of every header
`csrc/*.cuh` and of the flags, so an edit of any of them rebuilds.
`build_all()` starts one nvcc process per source, all at once. The
compiles are the span `ops.build`, each library's first load (and any
build it triggers) the span `ops.load` (core/observability.py).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List

from ratio_guided_multimodal_fm_tpu_torch.core.observability import span

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (looked on PATH and in "
                           "$CUDA_HOME/bin): cannot build the CUDA kernels")
    return nvcc


def _lib_path(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(src.parent.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def _build(srcs: List[Path]) -> Dict[str, dict]:
    """Compile `srcs` in parallel; raise with nvcc's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = []
    t0 = time.perf_counter()
    for src in srcs:
        out = _lib_path(src)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((src, out, tmp, proc))
    report = {}
    for src, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name} "
                               f"(exit {proc.returncode}):\n{log}")
        os.replace(tmp, out)
        report[src.stem] = {"seconds": time.perf_counter() - t0, "log": log}
    return report


def build_all() -> Dict[str, dict]:
    """Compile every csrc/*.cu that is not built yet (all nvcc runs in
    parallel). Returns {name: {"seconds", "log"}} for what was built."""
    with _lock:
        srcs = [s for s in sorted(CSRC.glob("*.cu"))
                if not _lib_path(s).exists()]
        if not srcs:
            return {}
        with span("ops.build"):
            return _build(srcs)


def load(name: str) -> ctypes.CDLL:
    """The shared library of csrc/<name>.cu, built on first use."""
    with _lock:
        if name not in _libs:
            with span("ops.load"):
                src = CSRC / f"{name}.cu"
                out = _lib_path(src)
                if not out.exists():
                    _build([src])
                _libs[name] = ctypes.CDLL(str(out))
        return _libs[name]
