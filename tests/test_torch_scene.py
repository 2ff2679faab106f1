"""Scene assembly and BVH packing of tinyraytracing_tpu_torch against the
JAX package: both sides are host numpy, so every array must be EXACTLY
equal (geometry, Woop rows, light tables, P, PS, tid, node boxes/meta,
wide rows) and so must n_wide and wide_depth."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tinyraytracing_tpu.config import RenderConfig as JConfig
from tinyraytracing_tpu.models import procedural as jproc
from tinyraytracing_tpu.ops import bvh as jbvh
from tinyraytracing_tpu_torch.config import RenderConfig
from tinyraytracing_tpu_torch.models import procedural as tproc
from tinyraytracing_tpu_torch.models.scene import scene_from_arrays, scene_to_arrays
from tinyraytracing_tpu_torch.ops import bvh as tbvh
from tests.torch_port_util import flatten_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _assert_scene_equal(jscene, tscene):
    jd, js = flatten_scene(jscene)
    td, ts = scene_to_arrays(tscene)
    assert td.keys() <= jd.keys()
    for k, v in td.items():
        assert v.dtype == jd[k].dtype, k
        assert v.shape == jd[k].shape, k
        np.testing.assert_array_equal(v, jd[k], err_msg=k)
    for k, v in ts.items():
        assert js[k] == v, k
    return td


def _scenes(case):
    if case == "cornell":
        return jproc.cornell_box(32, 32)[0], tproc.cornell_box(32, 32, device="cpu")[0]
    if case == "cornell+bvh8":
        js, ts = _scenes("cornell")
        return (jbvh.attach_bvh(js, JConfig(leaf_size=8)),
                tbvh.attach_bvh(ts, RenderConfig(leaf_size=8)))
    if case == "grid6000+bvh8":
        return jproc.quad_grid(6000)[0], tproc.quad_grid(6000, device="cpu")[0]
    if case == "grid6000+bvh32":
        js, ts = _scenes("grid6000+bvh8")
        return (jbvh.attach_bvh(js, JConfig(leaf_size=32)),
                tbvh.attach_bvh(ts, RenderConfig(leaf_size=32)))
    raise ValueError(case)


@pytest.mark.parametrize(
    "case", ["cornell", "cornell+bvh8", "grid6000+bvh8", "grid6000+bvh32"])
def test_scene_arrays_equal_jax(case):
    js, ts = _scenes(case)
    td = _assert_scene_equal(js, ts)
    if "bvh" in case:
        for k in ("P", "PS", "tid", "node_box", "node_meta", "WN"):
            assert f"bvh.packed.{k}" in td
        pk = ts.bvh.packed
        assert pk.n_wide == js.bvh.packed.n_wide == pk.WN.shape[0]
        assert pk.wide_depth == js.bvh.packed.wide_depth
        assert pk.leaf_size == int(case.split("bvh")[1])


def test_scene_from_arrays_round_trip():
    js, _ = _scenes("grid6000+bvh8")
    ts = scene_from_arrays(*flatten_scene(js), device="cpu")
    d, statics = scene_to_arrays(ts)
    again = scene_from_arrays(d, statics, device="cpu")
    _assert_scene_equal(js, again)
    assert again.bvh.packed.n_wide == js.bvh.packed.n_wide
    assert again.to("cpu").num_triangles == js.num_triangles
    # a scene without a BVH round-trips too
    jc, _ = _scenes("cornell")
    tc = scene_from_arrays(*flatten_scene(jc), device="cpu")
    assert tc.bvh is None
    _assert_scene_equal(jc, tc)


def test_root_leaf_tree_widens_to_one_node():
    """A scene of at most leaf_size triangles: the root is a leaf, and the
    wide tree is one node whose only child is that leaf."""
    v = np.random.default_rng(3).uniform(0, 1, (5, 3, 3))
    nodes_j, perm_j = jbvh.build_bvh(v, leaf_size=8)
    nodes_t, perm_t = tbvh.build_bvh(v, leaf_size=8)
    np.testing.assert_array_equal(perm_t, perm_j)
    wide_j, depth_j, bmap_j = jbvh.widen_bvh(nodes_j)
    wide_t, depth_t, bmap_t = tbvh.widen_bvh(nodes_t)
    np.testing.assert_array_equal(wide_t, wide_j)
    np.testing.assert_array_equal(bmap_t, bmap_j)
    assert depth_t == depth_j == 1
    assert wide_t.shape == (1, 128)
    assert wide_t[0, 6] == -(0 * 64 + 5 + 2)
    assert (wide_t[0, 14:64:8] == -1.0).all()


_XML = """<?xml version="1.0" encoding="utf-8"?>
<camera type="perspective" width="24" height="16" fovy="45.0">
    <eye x="0.5" y="1.0" z="4.0"/>
    <lookat x="0.5" y="0.5" z="0.0"/>
    <up x="0.0" y="1.0" z="0.0"/>
</camera>
<light mtlname="Lamp" radiance="10, 8,
  6"/>
"""
_OBJ = """v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
v 0.2 2 0.2
v 0.8 2 0.2
v 0.8 2 0.8
vn 0 0 1
vn 0 -1 0
vt 0 0
vt 1 0
vt 1 1
usemtl Wall
f 1/1/1 2/1/2 3/1/3
f 1/1/1 3/1/3 4/1/2
usemtl Lamp
f 5/2/ 6/2/ 7/2/
"""
_MTL = """newmtl Wall
Kd 0.5 0.6 0.7
Ks 0.1 0.1 0.1
Ns 10
newmtl Lamp
Kd 0 0 0
Ni 1.2
"""


def test_load_scene_from_files_equals_jax(tmp_path):
    from tinyraytracing_tpu.models.scene import load_scene as jload
    from tinyraytracing_tpu_torch.models.scene import load_scene as tload

    for name, text in (("s.xml", _XML), ("s.obj", _OBJ), ("s.mtl", _MTL)):
        (tmp_path / name).write_text(text)
    paths = [str(tmp_path / n) for n in ("s.xml", "s.obj", "s.mtl")]
    js, jcam = jload(*paths, with_bvh=True)
    ts, tcam = tload(*paths, with_bvh=True, device="cpu")
    _assert_scene_equal(js, ts)
    assert ts.light_names == ("Lamp",) and ts.num_triangles == 3
    for f in ("eye", "lookat", "up", "fovy"):
        np.testing.assert_array_equal(getattr(tcam, f).numpy(),
                                      np.asarray(getattr(jcam, f)))
    assert (tcam.width, tcam.height) == (jcam.width, jcam.height) == (24, 16)


def test_port_never_imports_jax():
    """Importing every module of the port leaves jax out of sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import tinyraytracing_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "assert len(mods) > 15, mods\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m.startswith('tinyraytracing_tpu.')]\n"
        "assert not bad, bad\n"
        "print(len(mods))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) > 15


def test_scene_to_device_keeps_arrays():
    _, ts = _scenes("cornell+bvh8")
    moved = ts.to(torch.device("cpu"))
    assert moved.bvh.packed.PS.data_ptr() == ts.bvh.packed.PS.data_ptr()
    assert moved.device.type == "cpu"


@pytest.mark.parametrize("make", ["cornell_box", "cornell_box_specular",
                                  "quad_grid", "load_scene",
                                  "scene_from_arrays", "assemble_scene"])
def test_constructors_default_to_the_card(make):
    """The user-facing constructors put the scene on the CUDA device unless
    the caller asks for the CPU: without a card the default raises."""
    import inspect

    from tinyraytracing_tpu_torch.models import scene as tscene

    fn = getattr(tproc, make, None) or getattr(tscene, make)
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    if make in ("cornell_box", "cornell_box_specular", "quad_grid"):
        args = (40,) if make == "quad_grid" else ()
        assert fn(*args, 8, 8, device="cpu")[0].device.type == "cpu"
        if not torch.cuda.is_available():
            with pytest.raises((AssertionError, RuntimeError)):
                fn(*args, 8, 8)


def test_cli_builds_the_jax_cli_tree():
    """``--scene grid:N`` renders on the tree the JAX CLI builds at the same
    leaf size (``attach_bvh`` of the scene's float32 vertices), not on the
    one ``quad_grid`` built from its float64 mesh, whose node boxes differ
    in the last bits: every packed array equal."""
    from tinyraytracing_tpu_torch import cli

    args = cli.build_parser().parse_args(
        ["--scene", "grid:6000", "--leaf-size", "8", "--device", "cpu"])
    scene, _, config = cli.build_scene(args)
    assert config.leaf_size == 8
    want = jbvh.attach_bvh(jproc.quad_grid(6000)[0], JConfig(leaf_size=8))
    jp, tp = want.bvh.packed, scene.bvh.packed
    for k in ("P", "tid", "node_box", "node_meta", "PS", "WN"):
        np.testing.assert_array_equal(getattr(tp, k).numpy(),
                                      np.asarray(getattr(jp, k)), err_msg=k)
    # the tree quad_grid builds for itself is another one
    own = tproc.quad_grid(6000, device="cpu")[0].bvh.packed
    assert not torch.equal(own.WN, tp.WN)
