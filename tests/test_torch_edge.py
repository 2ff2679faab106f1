"""The edge-sampled boundary terms (``tinyraytracing_tpu_torch/diff/edge.py``)
and ``render_loss_fast``'s edge arguments, against the JAX package's
``diff/edge.py`` and against finite differences, on the CPU.

- ``ops.rng.randint`` bitwise ``jax.random.randint`` (spans 1 to 262,144).
- The edge topology (``mesh_edges``, ``boundary_edges``,
  ``build_edge_aux``) equal as arrays on cornell, the closed-cube scene
  and quad_grid(6000); ``silhouette_mask`` equal; ``_project`` within
  1e-6 relative.
- The surrogates' gradients against ``jax.grad`` of the JAX surrogates on
  the same inputs and keys (so the same edges and points are sampled):
  ``silhouette_edge_surrogate`` with one analytic G written in each
  framework, in the endpoints and the eye, within 1e-5 of the largest
  entry; ``primary_edge_surrogate`` and ``shadow_edge_surrogate`` in the
  vertex offsets on the FD scenes of tests/test_diff_edge.py, with the
  "brute" intersector in both, within 1e-4 of the largest entry.
- The FD checks of tests/test_diff_edge.py through the port's
  ``render_loss_fast`` (tests/torch_edge_scenes.py): the interior
  gradient below a tenth of the central difference, interior plus edge
  within the JAX tests' tolerances (0.15, 0.2, 0.25 relative).
- ``render_loss_fast`` takes the JAX signature, and the edge terms leave
  its value unchanged.
"""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyraytracing_tpu.config import RenderConfig as JConfig
from tinyraytracing_tpu.diff import edge as jedge
from tinyraytracing_tpu.diff import fast as jfast
from tinyraytracing_tpu.diff.inverse import SceneParams as JParams
from tinyraytracing_tpu.diff.inverse import apply_params as japply
from tinyraytracing_tpu.models import procedural as jproc
from tinyraytracing_tpu.render import render as jrender
from tinyraytracing_tpu_torch.config import RenderConfig
from tinyraytracing_tpu_torch.diff import SceneParams, apply_params, edge, render_loss_fast
from tinyraytracing_tpu_torch.models.camera import Camera
from tinyraytracing_tpu_torch.ops.rng import master_key_data, randint
from tests.test_diff_edge import _make, _make_cube, _make_shadow
from tests.torch_edge_scenes import CASES, fd_check, make_scene
from tests.torch_port_util import port_scene

JAX_SCENES = {"quad": _make, "cube": _make_cube, "shadow": _make_shadow}
BRUTE = dict(intersector="brute", max_depth=1, ray_chunk=8192, tri_chunk=64)


def _port_cam(jcam):
    return Camera.create(np.array(jcam.eye), np.array(jcam.lookat),
                         np.array(jcam.up), float(jcam.fovy), jcam.width,
                         jcam.height)


def _close_to_largest(got, want, frac, name=""):
    want = np.asarray(want)
    assert np.isfinite(got).all() and np.abs(want).max() > 0, name
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=frac * np.abs(want).max(), err_msg=name)


@pytest.mark.parametrize("span", [1, 4, 48, 2304, 100_012, 262_144])
def test_randint_equals_jax(span):
    words = np.random.default_rng(span).integers(0, 2**32, 2)
    jkey = jnp.asarray(words, jnp.uint32)
    for shape in ((1,), (257,), (8192,)):
        want = np.asarray(jax.random.randint(jkey, shape, 0, span))
        got = randint(tuple(int(w) for w in words), shape, 0, span)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(shape))
        assert got.min() >= 0 and got.max() < span


def _jax_scene(name):
    if name == "cornell":
        return jproc.cornell_box(16, 16)
    if name == "grid6000":
        return jproc.quad_grid(6000, 16, 16)
    return JAX_SCENES[name](0.0)


@pytest.mark.parametrize("name", ["cornell", "cube", "grid6000"])
def test_edge_topology_equals_jax(name):
    js, _ = _jax_scene(name)
    ts = port_scene(js)
    jv, tv = (js.v0, js.v1, js.v2), (ts.v0, ts.v1, ts.v2)
    for want, got in zip(jedge.mesh_edges(*jv), edge.mesh_edges(*tv)):
        np.testing.assert_array_equal(got, want)
    ids = np.random.default_rng(3).permutation(js.num_triangles)[:js.num_triangles // 2]
    np.testing.assert_array_equal(edge.boundary_edges(*tv, ids),
                                  jedge.boundary_edges(*jv, ids))
    want, got = jedge.build_edge_aux(js), edge.build_edge_aux(ts)
    for k in ("ends", "adj"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    # the mask from the camera and from seeded viewpoints
    views = [np.asarray(_jax_scene(name)[1].eye)] + list(
        np.random.default_rng(4).uniform(-600, 800, (3, 3)).astype(np.float32))
    for vp in views:
        m_j = jedge.silhouette_mask(*jv, js.gn, want["adj"], jnp.asarray(vp))
        m_t = edge.silhouette_mask(*tv, ts.gn, got["adj"], torch.tensor(vp))
        np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))


@pytest.mark.parametrize("name", ["quad", "cube", "shadow"])
def test_fd_scenes_equal_jax(name):
    """tests/torch_edge_scenes.py builds tests/test_diff_edge.py's scenes."""
    js, jcam = JAX_SCENES[name](0.0)
    ts, tcam = make_scene(name, bvh=False)
    for f in ("v0", "v1", "v2", "gn", "kd", "tri_mtl", "tri_emissive",
              "lt_v0", "light_area", "light_radiance"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)), err_msg=f)
    for f in ("eye", "lookat", "up", "fovy"):
        np.testing.assert_array_equal(getattr(tcam, f).numpy(),
                                      np.asarray(getattr(jcam, f)), err_msg=f)


def test_project_matches_jax():
    js, jcam = jproc.cornell_box(24, 16)
    p = np.random.default_rng(5).uniform([0, 0, 0], [550, 550, 560],
                                         (512, 3)).astype(np.float32)
    want = jedge._project(jcam, jnp.asarray(p))
    got = edge._project(_port_cam(jcam), torch.from_numpy(p))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6 * np.abs(np.asarray(w)).max())


def test_silhouette_surrogate_grad_matches_jax():
    """The surrogate with one analytic G in each framework: the gradient in
    the endpoints and the eye."""
    _, jcam = jproc.cornell_box(32, 24)
    rng = np.random.default_rng(6)
    pa = rng.uniform([100, 100, 100], [450, 450, 500], (24, 3)).astype(np.float32)
    pb = (pa + rng.normal(scale=60.0, size=pa.shape)).astype(np.float32)
    eye = np.asarray(jcam.eye)

    def jf(a, b, e):
        G = lambda x, y: jnp.sin(7.0 * x) * jnp.cos(5.0 * y) + x * y
        return jedge.silhouette_edge_surrogate(
            a, b, dataclasses.replace(jcam, eye=e), G,
            jax.random.PRNGKey(8), n_samples=1024)

    want = jax.grad(jf, argnums=(0, 1, 2))(*map(jnp.asarray, (pa, pb, eye)))
    x = [torch.from_numpy(v.copy()).requires_grad_() for v in (pa, pb, eye)]
    G = lambda x, y: torch.sin(7.0 * x) * torch.cos(5.0 * y) + x * y
    cam = dataclasses.replace(_port_cam(jcam), eye=x[2])
    edge.silhouette_edge_surrogate(x[0], x[1], cam, G, master_key_data(8),
                                   n_samples=1024).backward()
    for name, t, w in zip(("pa", "pb", "eye"), x, want):
        _close_to_largest(t.grad.numpy(), w, 1e-5, name)


def _surrogate_grads(name, kind, n_samples=2048):
    """d surrogate / d vertex_offset from both packages on FD scene
    ``name`` (the same arrays, target and key)."""
    js, jcam = JAX_SCENES[name](0.0)
    case = CASES[name]
    jcfg = JConfig(**BRUTE, **dict(case.cfg))
    tcfg = RenderConfig(**BRUTE, **dict(case.cfg))
    tjs, _ = JAX_SCENES[name](case.shift)
    target = np.asarray(jrender(tjs, jcam, jax.random.PRNGKey(0), jcfg, spp=2))
    img = np.asarray(jrender(js, jcam, jax.random.PRNGKey(1), jcfg, spp=2))
    jaux = jedge.build_edge_aux(js)

    def jf(off):
        s2, c2 = japply(js, jcam, JParams(vertex_offset=off))
        key = jax.random.PRNGKey(9)
        if kind == "primary":
            return jedge.primary_edge_surrogate(s2, c2, jcfg, jnp.asarray(target),
                                                key, jaux, n_samples)
        return jedge.shadow_edge_surrogate(s2, c2, jcfg, jnp.asarray(target),
                                           jnp.asarray(img), key, jaux, n_samples)

    want = jax.jit(jax.grad(jf))(jnp.zeros_like(js.v0))
    ts, tcam = port_scene(js), _port_cam(jcam)
    off = torch.zeros_like(ts.v0, requires_grad=True)
    s2, c2 = apply_params(ts, tcam, SceneParams(vertex_offset=off))
    taux, key = edge.build_edge_aux(ts), master_key_data(9)
    if kind == "primary":
        sur = edge.primary_edge_surrogate(s2, c2, tcfg, torch.from_numpy(target),
                                          key, taux, n_samples)
    else:
        sur = edge.shadow_edge_surrogate(s2, c2, tcfg, torch.from_numpy(target),
                                         torch.from_numpy(img), key, taux, n_samples)
    sur.backward()
    return off.grad.numpy(), np.asarray(want)


@pytest.mark.parametrize("name,kind", [("quad", "primary"), ("cube", "primary"),
                                       ("shadow", "shadow")])
def test_surrogate_grads_match_jax(name, kind):
    got, want = _surrogate_grads(name, kind)
    _close_to_largest(got, want, 1e-4)


@pytest.mark.parametrize("name", list(CASES))
def test_edge_terms_match_finite_differences(name):
    """tests/test_diff_edge.py's checks, on the port's fast path: the
    interior term misses the derivative, interior plus edge recovers it."""
    r = fd_check(name)
    case = CASES[name]
    assert abs(r["fd"]) > case.fd_min, "degenerate setup: FD vanished"
    assert abs(r["g_int"]) < 0.1 * abs(r["fd"])
    assert r["g_full"] == pytest.approx(r["fd"], rel=case.rel), r
    assert r["ok"]


def test_render_loss_fast_takes_the_jax_signature():
    jsig = inspect.signature(jfast.render_loss_fast).parameters
    tsig = inspect.signature(render_loss_fast).parameters
    assert list(tsig) == list(jsig)
    assert all(tsig[k].default == jsig[k].default for k in jsig)


def _cornell_bvh():
    from tinyraytracing_tpu_torch.models.procedural import cornell_box
    from tinyraytracing_tpu_torch.ops.bvh import attach_bvh

    scene, cam = cornell_box(32, 32, device="cpu")
    return attach_bvh(scene, RenderConfig()), cam


LOSS_VALUE_CASES = {
    # both terms at once, through every edge argument
    "shadow-both": (lambda: make_scene("shadow"),
                    RenderConfig(max_depth=1, light_sampler="uniform"), 2,
                    lambda s: dict(edge_samples=512, shadow_edge_samples=512,
                                   edge_aux=edge.build_edge_aux(s),
                                   edge_delta=0.05, shadow_light=0)),
    # each term alone on a scene with a BVH, the default config
    "cornell-primary": (_cornell_bvh, RenderConfig(), 1,
                        lambda s: dict(edge_samples=64)),
    "cornell-shadow": (_cornell_bvh, RenderConfig(), 1,
                       lambda s: dict(shadow_edge_samples=4096)),
}


@pytest.mark.parametrize("case", list(LOSS_VALUE_CASES))
def test_edge_terms_keep_the_loss_value(case):
    """The loss value with the edge terms is bitwise the loss without
    them; the gradient is not."""
    make, cfg, spp, edge_kw = LOSS_VALUE_CASES[case]
    scene, cam = make()
    target = torch.zeros(cam.height, cam.width, 3)
    out = []
    for kw in ({}, edge_kw(scene)):
        off = torch.zeros_like(scene.v0, requires_grad=True)
        loss = render_loss_fast(SceneParams(vertex_offset=off), scene, cam,
                                master_key_data(4), target, cfg, spp, **kw)
        loss.backward()
        out.append((loss.detach(), off.grad))
    assert torch.equal(out[0][0], out[1][0])
    assert not torch.equal(out[0][1], out[1][1])
