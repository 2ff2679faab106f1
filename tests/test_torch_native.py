"""The port's native host code (``tinyraytracing_tpu_torch/native/``: the
C++ SAH builder and OBJ parser, built with g++ at first use) against the
JAX package's copy of the same sources and against the port's numpy
code, on the CPU.

- The native builder gives nodes and permutation bitwise equal to the JAX
  package's native builder, on the triangles of quad_grid(6000) and on
  seeded random soups of 300 and 20,000 triangles.
- The numpy builder gives the same topology and permutation, with node
  boxes within one float32 ulp: the native builder takes the pad as a
  float32, numpy as a float64, and ``min - pad`` can round to
  neighbouring float32 values. So only the native tree is the JAX
  package's tree, and that is why the port builds natively.
- ``parse_obj_native`` equals ``parse_obj`` on OBJs with ``v``, ``vt``,
  ``vn`` in both orders, faces ``a``, ``a/b``, ``a//c``, ``a/b/c`` and
  ``a/b/``, faces before any ``usemtl``.
- ``load_scene`` builds the JAX ``load_scene``'s tree bitwise, natively,
  and falls back to numpy, saying so once, where g++ is missing.
"""

import logging

import numpy as np
import pytest

from tinyraytracing_tpu.models import procedural as jproc
from tinyraytracing_tpu.native import build_bvh_native as jax_native
from tinyraytracing_tpu_torch import native
from tinyraytracing_tpu_torch.io.objmesh import parse_obj
from tinyraytracing_tpu_torch.ops import bvh as tbvh
from tests.test_torch_scene import _assert_scene_equal
from tests.test_torch_textures import _OBJ as TEXTURED_OBJ

NODE_KEYS = ("nmin", "nmax", "start", "count", "skip")


def _soup(n, seed):
    """n random triangles (float64, coordinates not exact in float32)."""
    rng = np.random.default_rng(seed)
    centre = rng.uniform(0.0, 100.0, (n, 1, 3))
    return centre + rng.normal(scale=2.0, size=(n, 3, 3))


def _grid():
    js, _ = jproc.quad_grid(6000, width=16, height=16)
    return np.stack([np.asarray(js.v0), np.asarray(js.v1), np.asarray(js.v2)],
                    axis=1).astype(np.float64)


def _tris(case):
    return _grid() if case == "grid6000" else _soup(int(case[4:]), len(case))


def _ulps(a, b):
    """Largest distance in float32 ulps between two float32 arrays."""
    def ordered(x):
        i = np.ascontiguousarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int(np.abs(ordered(a) - ordered(b)).max())


CASES = ["grid6000", "soup300", "soup20000"]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("leaf", [8, 32])
def test_native_build_equals_jax_native(case, leaf):
    v = _tris(case)
    nodes_t, perm_t = native.build_bvh_native(v, leaf, 1e-3)
    nodes_j, perm_j = jax_native(v, leaf, 1e-3)
    np.testing.assert_array_equal(perm_t, perm_j)
    for k in NODE_KEYS:
        assert nodes_t[k].dtype == nodes_j[k].dtype, k
        np.testing.assert_array_equal(nodes_t[k], nodes_j[k], err_msg=k)


@pytest.mark.parametrize("case", CASES)
def test_numpy_build_topology_equals_native(case):
    v = _tris(case)
    nodes_n, perm_n = native.build_bvh_native(v, 8, 1e-3)
    nodes_p, perm_p = tbvh.build_bvh(v, 8, 1e-3)
    np.testing.assert_array_equal(perm_p, perm_n)
    for k in ("start", "count", "skip"):
        np.testing.assert_array_equal(nodes_p[k], nodes_n[k], err_msg=k)
    for k in ("nmin", "nmax"):
        assert _ulps(nodes_p[k], nodes_n[k]) <= 1, k
    if case == "soup20000":     # where the two trees' boxes differ
        assert not np.array_equal(nodes_p["nmin"], nodes_n["nmin"])


def test_build_bvh_host_takes_native_and_records_it():
    v = _soup(300, 5)
    nodes, perm = tbvh.build_bvh_host(v, 8, 1e-3)
    nodes_n, perm_n = native.build_bvh_native(v, 8, 1e-3)
    assert nodes["builder"] == "native"
    np.testing.assert_array_equal(perm, perm_n)
    for k in NODE_KEYS:
        np.testing.assert_array_equal(nodes[k], nodes_n[k])


_OBJ_VN_FIRST = """# vn before vt: faces read v/vn/vt
v 0 0 0
v 1.1 0 0.3
v 1 1.7 0
v 0 1 -0.25
v 0.5 0.5 2.125
vn 0 0 1
vn 0.6 0.8 0
vt 0.1 0.2
vt 0.9 0.3
f 1 2 3
f 1//2 3//1 4//2
usemtl Red
f 2/1/2 3/2/1 5/1/1
f 1/2 4/1 5/2
usemtl Blue
f 3/1/ 4/2/ 5/1/
usemtl Red
f 5 4 1
"""


@pytest.mark.parametrize("text", [TEXTURED_OBJ, _OBJ_VN_FIRST],
                         ids=["vt_first", "vn_first"])
def test_parse_obj_native_equals_parse_obj(tmp_path, text):
    path = tmp_path / "m.obj"
    path.write_text(text)
    a, b = native.parse_obj_native(str(path)), parse_obj(str(path))
    assert a.mtl_names == b.mtl_names
    for k in ("v", "vn", "vt", "normal", "center", "mtl", "vertices", "vertex_index"):
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


def _write_scene(d, n=400):
    """A random soup of ``n`` triangles ("Wall", the last two "Lamp")
    as XML, OBJ and MTL files under ``d``."""
    v = _soup(n, 9)
    lines = [f"v {x!r} {y!r} {z!r}" for x, y, z in v.reshape(-1, 3).tolist()]
    lines.append("usemtl Wall")
    lines += [f"f {3 * t + 1} {3 * t + 2} {3 * t + 3}" for t in range(n - 2)]
    lines.append("usemtl Lamp")
    lines += [f"f {3 * t + 1} {3 * t + 2} {3 * t + 3}" for t in range(n - 2, n)]
    (d / "s.obj").write_text("\n".join(lines) + "\n")
    (d / "s.mtl").write_text("newmtl Wall\nKd 0.5 0.6 0.7\nnewmtl Lamp\nKd 0 0 0\n")
    (d / "s.xml").write_text(
        '<?xml version="1.0" encoding="utf-8"?>\n'
        '<camera type="perspective" width="8" height="8" fovy="45.0">\n'
        '  <eye x="50" y="50" z="-150"/><lookat x="50" y="50" z="50"/>\n'
        '  <up x="0" y="1" z="0"/>\n</camera>\n'
        '<light mtlname="Lamp" radiance="10, 8, 6"/>\n')
    return [str(d / n) for n in ("s.xml", "s.obj", "s.mtl")]


def test_load_scene_tree_equals_jax(tmp_path):
    from tinyraytracing_tpu.models.scene import load_scene as jload
    from tinyraytracing_tpu_torch.models.scene import load_scene as tload

    paths = _write_scene(tmp_path)
    js, _ = jload(*paths, with_bvh=True, leaf_size=8)
    ts, _ = tload(*paths, with_bvh=True, leaf_size=8, device="cpu")
    assert ts.bvh.builder == "native"
    td = _assert_scene_equal(js, ts)
    for k in NODE_KEYS:
        assert f"bvh.{k}" in td
    assert ts.bvh.n_nodes == js.bvh.n_nodes > 1


def test_without_gxx_load_scene_falls_back_and_says_so(tmp_path, monkeypatch,
                                                       caplog):
    """No g++: the numpy parser and builder stand in, the tree records it,
    and the log says so once."""
    from tinyraytracing_tpu_torch.models.scene import load_scene as tload

    paths = _write_scene(tmp_path, n=60)
    want, _ = tload(*paths, with_bvh=True, device="cpu")

    def no_gxx(source):
        raise native.BuildError("g++ not found")

    monkeypatch.setattr(native, "_library", no_gxx)
    monkeypatch.setattr(native, "_fallback_logged", False)
    with caplog.at_level(logging.WARNING, logger=native.__name__):
        ts, _ = tload(*paths, with_bvh=True, device="cpu")
        tload(*paths, with_bvh=True, device="cpu")
    assert ts.bvh.builder == "numpy"
    said = [r for r in caplog.records if "native code unavailable" in r.message]
    assert len(said) == 1
    np.testing.assert_array_equal(ts.v0.numpy(), want.v0.numpy())
    for k in ("start", "count", "skip"):
        np.testing.assert_array_equal(getattr(ts.bvh, k).numpy(),
                                      getattr(want.bvh, k).numpy())
