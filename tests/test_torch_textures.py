"""A textured scene, loaded from files and rendered by the port and by the
JAX package on the CPU.

The scene is written under ``tmp_path``: a 5x7 PNG (rows != columns, so
a swapped row and column shows) drawn from a numpy seed; an OBJ with
``vt`` coordinates on the floor and the back wall, the floor's running
outside [0, 1] so the texture wraps; an MTL whose "Checker" material has
``map_Kd`` and whose "Plain" material has none, beside the light's; and
an XML camera and light in the form of tests/test_torch_scene.py's.

Both packages' ``load_scene`` (with a BVH) must build the same arrays,
the texture atlas (``tex``, ``tex_hw``, ``tex_id``) among them. Two
renders are then held as tests/test_torch_render.py holds the procedural
scenes, with the arithmetic aligned in a process of its own
(tests/torch_aligned_render.py ``textured:<dir>``): the scan renderer
with ``intersector="pallas"`` (the slot kernel's plain version here, the
JAX package's Pallas kernel in interpret mode; its texture branch is
``integrator/wavefront.py``'s) and ``render_image``'s default renderer
(the persistent one below 512 triangles, whose texture lookup is
``integrator/fused.py::_tex_kd``): >= 99% of pixels within rtol 1e-4 /
atol 1e-5, image means within 1e-4 relative.
"""

import numpy as np
import pytest
from PIL import Image

from tests.test_torch_scene import _assert_scene_equal
from tests.torch_aligned_render import (
    SIZE, TEXTURED_CASES, TEXTURED_FILES, run_processes, textured_scenes,
)

_TEXELS = (5, 7)      # rows, columns

_XML = f"""<?xml version="1.0" encoding="utf-8"?>
<camera type="perspective" width="{SIZE}" height="{SIZE}" fovy="55.0">
    <eye x="0.5" y="1.4" z="3.2"/>
    <lookat x="0.5" y="0.7" z="-0.5"/>
    <up x="0.0" y="1.0" z="0.0"/>
</camera>
<light mtlname="Lamp" radiance="12, 11, 9"/>
"""
# vt before any vn: faces read v/vt/vn (the reference's layout guess)
_OBJ = """v -1 0 1.5
v 2 0 1.5
v 2 0 -2
v -1 0 -2
v -1 2.5 -2
v 2 2.5 -2
v -1 2.5 1.5
v 0.1 2.45 -0.6
v 0.9 2.45 -0.6
v 0.9 2.45 0.2
v 0.1 2.45 0.2
vt -0.3 -0.2
vt 1.7 -0.2
vt 1.7 1.6
vt -0.3 1.6
vt 0 0
vt 1 0
vt 1 1
vt 0 1
vn 0 1 0
vn 0 0 1
vn 1 0 0
vn 0 -1 0
usemtl Checker
f 1/1/1 2/2/1 3/3/1
f 1/1/1 3/3/1 4/4/1
f 4/5/2 3/6/2 6/7/2
f 4/5/2 6/7/2 5/8/2
usemtl Plain
f 1/5/3 4/6/3 5/7/3
f 1/5/3 5/7/3 7/8/3
usemtl Lamp
f 8/5/4 10/7/4 9/6/4
f 8/5/4 11/8/4 10/7/4
"""
_MTL = """newmtl Checker
Kd 0.5 0.5 0.5
map_Kd checker.png
newmtl Plain
Kd 0.2 0.6 0.3
Ks 0.1 0.1 0.1
Ns 20
newmtl Lamp
Kd 0 0 0
"""


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("textured")
    texels = np.random.default_rng(11).integers(0, 256, (*_TEXELS, 3),
                                                dtype=np.uint8)
    Image.fromarray(texels).save(d / "checker.png")
    for name, text in zip(TEXTURED_FILES, (_XML, _OBJ, _MTL)):
        (d / name).write_text(text)
    return str(d)


@pytest.fixture(scope="module")
def aligned(scene_dir, tmp_path_factory):
    """Both packages' images of the textured cases (one process)."""
    return run_processes(str(tmp_path_factory.mktemp("aligned_textured")),
                         [f"textured:{scene_dir}"])


def test_texture_atlas_equals_jax(scene_dir):
    js, jcam, ts, tcam = textured_scenes(scene_dir)
    _assert_scene_equal(js, ts)
    tex = ts.tex.numpy()
    np.testing.assert_array_equal(tex, np.asarray(js.tex))
    np.testing.assert_array_equal(ts.tex_hw.numpy(), np.asarray(js.tex_hw))
    np.testing.assert_array_equal(ts.tex_id.numpy(), np.asarray(js.tex_id))
    # one texture, rows by columns as drawn; only "Checker" maps it
    assert tex.shape == (1, *_TEXELS, 3)
    assert ts.tex_hw.tolist() == [list(_TEXELS)]
    with Image.open(f"{scene_dir}/checker.png") as im:
        np.testing.assert_array_equal(
            tex[0], np.asarray(im, dtype=np.float32) / 255.0)
    names = ts.mtl_names
    assert {n: int(ts.tex_id[i]) for i, n in enumerate(names)} == {
        "Lamp": -1, "Checker": 0, "Plain": -1}
    # the floor's texture coordinates run outside [0, 1]: the lookup wraps
    t = np.concatenate([ts.t0.numpy(), ts.t1.numpy(), ts.t2.numpy()])
    assert t.min() < 0.0 and t.max() > 1.0
    assert (tcam.width, tcam.height) == (jcam.width, jcam.height) == (SIZE, SIZE)


@pytest.mark.parametrize("case", TEXTURED_CASES)
def test_textured_render_matches_jax(case, aligned):
    want = aligned[f"textured-{case}-jax"]
    got = aligned[f"textured-{case}-port"]
    assert got.shape == want.shape == (SIZE, SIZE, 3)
    assert np.isfinite(got).all() and (got >= 0).all() and got.mean() > 0
    close = np.isclose(got, want, rtol=1e-4, atol=1e-5).all(axis=-1)
    assert close.mean() >= 0.99, f"{(~close).sum()} of {close.size} pixels differ"
    assert abs(got.mean() - want.mean()) <= 1e-4 * want.mean()


def test_texture_shows_in_the_render(aligned):
    """The texture decides the colour of many pixels: without it (every
    material untextured) the port's default render differs in most of
    them."""
    got = aligned["textured-default-port"]
    plain = aligned["textured-default-untextured"]
    moved = ~np.isclose(got, plain, rtol=1e-2, atol=1e-3).all(axis=-1)
    assert moved.mean() >= 0.25, f"{moved.sum()} of {moved.size} pixels moved"
