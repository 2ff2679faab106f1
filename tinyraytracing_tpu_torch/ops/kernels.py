"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, at first use, into ``_build/`` next to
the package (git-ignored), under a name keyed on the source's content, the
shared headers (``csrc/*.cuh``) and the flags — so an edited source or
header rebuilds and an unchanged one loads. The
libraries are loaded with ``ctypes``; nothing here runs at import time.

``--fmad=false`` is required: every kernel reproduces the JAX package's
float arithmetic operation for operation, and FMA contraction would move
hit distances in the last ulp.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
SOURCES = ("trace.cu", "bvh_intersect.cu", "slot_intersect.cu", "scatter_add.cu",
           "rng.cu")

_libs: dict[tuple[str, tuple[str, ...]], ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (needed to build the CUDA kernels)")


def _lib_path(source: str, defines: tuple[str, ...] = ()) -> Path:
    h = hashlib.sha256((CSRC / source).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):     # the shared headers
        h.update(header.read_bytes())
    h.update(" ".join((*NVCC_FLAGS, *defines)).encode())
    return BUILD_DIR / f"{Path(source).stem}_{h.hexdigest()[:16]}.so"


def _build_one(source: str, defines: tuple[str, ...] = ()) -> tuple[Path, str]:
    out = _lib_path(source, defines)
    if out.exists():
        return out, "cached"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-I",
           str(CSRC), "-o", str(tmp), str(CSRC / source)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{res.stdout}{res.stderr}")
    os.replace(tmp, out)              # atomic: a reader never sees half a file
    return out, res.stdout + res.stderr


def build() -> tuple[float, dict[str, str]]:
    """Compile every source not yet built (one nvcc per source, all in
    parallel). Returns (seconds, {source: compiler log or "cached"})."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(SOURCES)) as ex:
        results = list(ex.map(_build_one, SOURCES))
    logs = {s: log for s, (_, log) in zip(SOURCES, results)}
    return time.perf_counter() - t0, logs


def library(source: str, defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """The loaded library of ``source`` (built first if needed), compiled
    with the macros ``defines`` (e.g. ``("TRT_PROFILE",)`` for trace.cu's
    measurement build) beside the plain build."""
    lib = _libs.get((source, defines))
    if lib is None:
        path, _ = _build_one(source, defines)
        lib = ctypes.CDLL(str(path))
        _libs[source, defines] = lib
    return lib
