"""Native (C++) host code, loaded with ctypes: the counterpart of
``tinyraytracing_tpu/native/``, with copies of its sources and the same
``extern "C"`` symbols.

- ``bvh_builder.cc``: the O(N log N) SAH builder, the same splits as the
  numpy ``ops.bvh.build_bvh`` in float64, without its Python loop over
  nodes;
- ``objparser.cc``: the OBJ triangle-soup parser with the reference's
  vt/vn layout rule, the contract of ``io.objmesh.parse_obj``.

Each source is compiled by g++ at first use into ``_build/`` next to the
package (git-ignored), under a name keyed on the source's content and the
flags, so an edited source rebuilds and an unchanged one loads. Nothing
runs at import time. Where g++ is missing or fails, ``BuildError`` is
raised; the callers (``ops.bvh.build_bvh_host``, ``models.scene.load_scene``)
then take the numpy code and say so once (``log_fallback``).
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR.parent / "_build"
# -ffp-contract=off: no FMA contraction. The SAH cost arithmetic must round
# exactly like the float64 numpy builder, or a near-tie between two split
# costs can go the other way and the two trees differ.
GXX_FLAGS = ("-O3", "-march=native", "-ffp-contract=off", "-std=c++17",
             "-shared", "-fPIC")

_libs: dict[str, ctypes.CDLL] = {}
_fallback_logged = False


class BuildError(RuntimeError):
    """The native code could not be built here (no g++, or it failed)."""


def log_fallback(err: BuildError) -> None:
    """Log, once per process, that the numpy code stands in for the native
    code (a tree so built can differ from the JAX package's by an ulp)."""
    global _fallback_logged
    if not _fallback_logged:
        logging.getLogger(__name__).warning(
            "native code unavailable, parsing and building with numpy "
            "(BVH boxes may differ by a float32 ulp): %s", err)
        _fallback_logged = True


def _lib_path(source: str) -> Path:
    h = hashlib.sha256((_DIR / source).read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}_{h.hexdigest()[:16]}.so"


def _library(source: str) -> ctypes.CDLL:
    lib = _libs.get(source)
    if lib is not None:
        return lib
    out = _lib_path(source)
    if not out.exists():
        gxx = shutil.which("g++")
        if gxx is None:
            raise BuildError("g++ not found (needed to build the native code)")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [gxx, *GXX_FLAGS, "-o", str(tmp), str(_DIR / source)]
        try:
            res = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise BuildError(f"g++ failed on {source}: {e}") from e
        if res.returncode != 0:
            raise BuildError(f"g++ failed on {source}:\n{res.stderr}")
        os.replace(tmp, out)          # atomic: a reader never sees half a file
    lib = ctypes.CDLL(str(out))
    _libs[source] = lib
    return lib


# ---------------------------------------------------------------- BVH build

def _bvh_lib() -> ctypes.CDLL:
    lib = _library("bvh_builder.cc")
    if not getattr(lib, "_typed", False):
        F, I = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32)
        lib.tinypt_build_bvh.restype = ctypes.c_int64
        lib.tinypt_build_bvh.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int32,
            ctypes.c_float, F, F, I, I, I, ctypes.POINTER(ctypes.c_int64),
        ]
        lib._typed = True
    return lib


def build_bvh_native(tri_v: np.ndarray, leaf_size: int = 8,
                     aabb_pad: float = 1e-3):
    """C++ SAH build of (T, 3, 3) vertices. Returns (nodes dict of numpy
    arrays {nmin, nmax, start, count, skip}, permutation (T,) int64), as
    ``ops.bvh.build_bvh``."""
    lib = _bvh_lib()
    tri = np.ascontiguousarray(tri_v, dtype=np.float64).reshape(-1, 9)
    T = tri.shape[0]
    cap = max(2 * T, 1)
    nmin = np.empty((cap, 3), np.float32)
    nmax = np.empty((cap, 3), np.float32)
    start = np.empty(cap, np.int32)
    count = np.empty(cap, np.int32)
    skip = np.empty(cap, np.int32)
    perm = np.empty(T, np.int64)
    ptr = lambda a, t: a.ctypes.data_as(ctypes.POINTER(t))
    f, i = ctypes.c_float, ctypes.c_int32
    n_nodes = lib.tinypt_build_bvh(
        ptr(tri, ctypes.c_double), T, leaf_size, aabb_pad,
        ptr(nmin, f), ptr(nmax, f), ptr(start, i), ptr(count, i),
        ptr(skip, i), ptr(perm, ctypes.c_int64),
    )
    if n_nodes <= 0:
        raise RuntimeError(f"native BVH build failed on {T} triangles")
    nodes = dict(nmin=nmin[:n_nodes].copy(), nmax=nmax[:n_nodes].copy(),
                 start=start[:n_nodes].copy(), count=count[:n_nodes].copy(),
                 skip=skip[:n_nodes].copy())
    return nodes, perm


# ---------------------------------------------------------------- OBJ parse

def _obj_lib() -> ctypes.CDLL:
    lib = _library("objparser.cc")
    if not getattr(lib, "_typed", False):
        D = ctypes.POINTER(ctypes.c_double)
        lib.tinypt_obj_scan.restype = ctypes.c_int
        I64 = ctypes.POINTER(ctypes.c_int64)
        lib.tinypt_obj_scan.argtypes = [ctypes.c_char_p, I64, I64, I64]
        lib.tinypt_obj_parse.restype = ctypes.c_int64
        lib.tinypt_obj_parse.argtypes = [
            ctypes.c_char_p, D, D, D, ctypes.POINTER(ctypes.c_int32),
            ctypes.c_char_p, ctypes.c_int64, I64, D,
        ]
        lib._typed = True
    return lib


def parse_obj_native(path: str):
    """C++ OBJ parse -> ``io.objmesh.MeshArrays`` (the contract of
    ``io.objmesh.parse_obj``)."""
    from tinyraytracing_tpu_torch.io.objmesh import MeshArrays

    lib = _obj_lib()
    bpath = os.fsencode(path)
    n_tris, names_bytes, n_verts = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int64()
    if lib.tinypt_obj_scan(bpath, ctypes.byref(n_tris), ctypes.byref(names_bytes),
                           ctypes.byref(n_verts)) != 0:
        raise FileNotFoundError(path)
    T = n_tris.value
    v = np.empty((T, 3, 3), np.float64)
    vn = np.empty((T, 3, 3), np.float64)
    vt = np.empty((T, 3, 2), np.float64)
    mtl = np.empty(T, np.int32)
    fv = np.empty((T, 3), np.int64)
    verts = np.empty((n_verts.value, 3), np.float64)
    names_buf = ctypes.create_string_buffer(int(names_bytes.value) + 1)
    dptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    got = lib.tinypt_obj_parse(
        bpath, dptr(v), dptr(vn), dptr(vt),
        mtl.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        names_buf, names_bytes.value + 1,
        fv.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), dptr(verts),
    )
    if got != T:
        raise RuntimeError(f"obj parse of {path}: {got} triangles, scan said {T}")
    raw = names_buf.value.decode("utf-8", errors="replace")
    mtl_names = [n for n in raw.split("\n") if n != ""] or [""]
    # faces before any usemtl get the empty material name, as parse_obj
    if (mtl < 0).any():
        if "" not in mtl_names:
            mtl_names.append("")
        mtl = np.where(mtl < 0, mtl_names.index(""), mtl).astype(np.int32)

    gn = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    gn /= np.maximum(np.linalg.norm(gn, axis=1, keepdims=True), 1e-30)
    return MeshArrays(v=v, vn=vn, vt=vt, normal=gn, center=v.mean(axis=1),
                      mtl=mtl, mtl_names=mtl_names, vertices=verts, vertex_index=fv)
