"""The port's differentiable rendering (``tinyraytracing_tpu_torch/diff/``)
against the JAX package's and against finite differences, on the CPU.

- ``refit_bvh``: bitwise the JAX refit on the same moved scene (carried
  across with ``scene_from_arrays``), plus P, which the port refits too
  (its trace kernels read P's records); ``apply_params`` returns a new
  Scene, so the kernels' per-scene caches cannot go stale.
- ``fused_trace_diff``: outputs and VJP against ``jax.vjp`` of the JAX
  ``fused_trace_diff`` (its kernel in interpret mode), for fixed rays:
  t within rtol 1e-5 (``_check_fused``), normals / texcoords within 1e-4,
  discrete planes equal; the cotangents within 1e-4 of the largest (XLA
  contracts FMAs here and sums the scatter in another order).
- Finite differences as tests/test_diff.py (``render_loss`` with
  "brute": albedo, radiance, eye, lookat, vertex) and
  tests/test_diff_fast.py (the trace's VJP on vertices and rays;
  ``render_loss_fast`` in kd, vertex, eye), at their tolerances (median
  relative error 0.05), at 12x12-32x32.
- ``render_diff``'s image, and the gradients of ``render_loss_fast`` and
  of ``render_loss`` (scan, "brute") in kd, radiance, vertex_offset and
  eye, against the JAX package's, the arithmetic aligned in a process of
  its own (tests/torch_aligned_render.py ``diff:cornell``): the image as
  the aligned renders (every pixel within 1e-6), each loss within 1e-6
  relative, each gradient within 1e-5 (fast) or 1e-4 (scan) of its
  largest entry.
- The Adam loop recovers albedo; a fast-path train step lowers the loss.
- Geometry or camera gradients through the kernel backends ("pallas",
  "bvh_pallas") raise, as the JAX package's do; kd through them works.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyraytracing_tpu.config import RenderConfig as JConfig
from tinyraytracing_tpu.diff import fast as jfast
from tinyraytracing_tpu.diff.inverse import SceneParams as JParams
from tinyraytracing_tpu.diff.inverse import render_loss as jax_render_loss
from tinyraytracing_tpu.diff.inverse import woop_transform_jnp
from tinyraytracing_tpu.diff.refit import refit_bvh as jax_refit
from tinyraytracing_tpu.models import procedural as jproc
from tinyraytracing_tpu.ops.bvh import attach_bvh as jax_attach
from tinyraytracing_tpu.ops.pallas_trace import fused_trace_planes as jax_trace
from tinyraytracing_tpu_torch.config import RenderConfig
from tinyraytracing_tpu_torch.diff import (
    SceneParams, apply_params, fused_trace_diff, make_train_step,
    render_diff, render_loss, render_loss_fast,
)
from tinyraytracing_tpu_torch.diff.inverse import woop_transform
from tinyraytracing_tpu_torch.diff.refit import refit_bvh
from tinyraytracing_tpu_torch.io.xmlscene import LightSpec, SceneConfig
from tinyraytracing_tpu_torch.models import procedural as tproc
from tinyraytracing_tpu_torch.models.camera import Camera
from tinyraytracing_tpu_torch.models.scene import assemble_scene
from tinyraytracing_tpu_torch.ops.bvh import attach_bvh
from tinyraytracing_tpu_torch.ops.bvh_intersect import bvh_records
from tinyraytracing_tpu_torch.ops.rng import master_key_data
from tests.torch_aligned_render import DIFF_FIELDS, SIZE, run_processes
from tests.torch_port_util import port_scene, scene_pair

CFG = RenderConfig(intersector="brute", max_depth=3, ray_chunk=1024,
                   tri_chunk=64)
SPP = 2


# ---------------------------------------------------------------------------
# refit
# ---------------------------------------------------------------------------

def _moved_jax(js, seed, scale=3.0):
    """The JAX scene with a seeded per-triangle offset applied as the JAX
    apply_params applies it, before the refit."""
    off = np.random.default_rng(seed).normal(size=np.shape(js.v0)) * scale
    off = jnp.asarray(off, jnp.float32)
    v0, v1, v2 = js.v0 + off, js.v1 + off, js.v2 + off
    wa, wb, gn = woop_transform_jnp(v0, v1, v2)
    return dataclasses.replace(js, v0=v0, v1=v1, v2=v2, woop_a=wa, woop_b=wb,
                               gn=gn)


@pytest.mark.parametrize("name", ["cornell", "grid2000_32"])
def test_refit_equals_jax(name):
    js, _ = scene_pair(name)
    jm = _moved_jax(js, seed=len(name))
    jr = jax_refit(jm)
    tr = refit_bvh(port_scene(jm))
    for k in ("nmin", "nmax"):
        np.testing.assert_array_equal(getattr(tr.bvh, k).numpy(),
                                      np.asarray(getattr(jr.bvh, k)), err_msg=k)
    for k in ("node_box", "PS", "WN"):
        np.testing.assert_array_equal(getattr(tr.bvh.packed, k).numpy(),
                                      np.asarray(getattr(jr.bvh.packed, k)),
                                      err_msg=k)
    # the port refits P too: the trace kernels' slot records come from it
    assert torch.equal(tr.bvh.packed.P, tr.bvh.packed.PS[:4])
    # every moved triangle lies inside its leaf's refit box
    leaf = tr.bvh.tri_leaf.long()
    for v in (tr.v0, tr.v1, tr.v2):
        assert (v >= tr.bvh.nmin[leaf]).all() and (v <= tr.bvh.nmax[leaf]).all()


def test_apply_params_refits_into_a_new_scene():
    """The kernels read per-Scene caches (``trace_records`` from
    ``bvh_records``, built from P), so a refit must come back as a new
    Scene whose records hold the moved triangles."""
    _, ts = scene_pair("cornell")
    old = ts.trace_records.slot.clone()
    off = torch.full_like(ts.v0, 7.0)
    s2, _ = apply_params(ts, None, SceneParams(vertex_offset=off))
    assert s2 is not ts and s2.bvh is not ts.bvh
    assert torch.equal(ts.trace_records.slot, old)
    assert torch.equal(s2.trace_records.slot, bvh_records(s2.bvh.packed).slot)
    assert not torch.equal(s2.trace_records.slot, old)
    assert torch.equal(s2.bvh.count, ts.bvh.count)        # same topology
    # a tree without refit metadata is dropped under vertex offsets
    grid, _ = tproc.quad_grid(600, 8, 8, device="cpu")
    assert grid.bvh is not None and grid.bvh.tri_leaf is None
    g2, _ = apply_params(grid, None,
                         SceneParams(vertex_offset=torch.zeros_like(grid.v0)))
    assert g2.bvh is None
    g3, _ = apply_params(grid, None, SceneParams(kd=grid.kd))
    assert g3.bvh is grid.bvh


def test_woop_transform_matches_jax():
    rng = np.random.default_rng(2)
    v = (rng.uniform(0, 500, (256, 1, 3))
         + rng.normal(scale=20.0, size=(256, 3, 3))).astype(np.float32)
    want = woop_transform_jnp(*(jnp.asarray(v[:, k]) for k in range(3)))
    got = woop_transform(*(torch.from_numpy(v[:, k]) for k in range(3)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6 * np.abs(np.asarray(w)).max())
    # a degenerate triangle gets zero rows (no ray can hit it). XLA's
    # contracted cross product of two equal edges is not exactly zero, so
    # the JAX rows are not compared there.
    v[3, 2] = v[3, 1]
    a, b, gn = woop_transform(*(torch.from_numpy(v[:, k]) for k in range(3)))
    assert not a[3].any() and not b[3].any() and not gn[3].any()


# ---------------------------------------------------------------------------
# fused_trace_diff against the JAX custom VJP
# ---------------------------------------------------------------------------

def _rays(rng, n):
    org = rng.uniform(-0.3, 0.3, (n, 3)) * 100 + np.asarray([278.0, 273.0, -500.0])
    d = rng.normal(size=(n, 3)) * np.asarray([0.3, 0.3, 1.0])
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return org.astype(np.float32), d.astype(np.float32)


GEOM = ("v0", "v1", "v2", "n0", "n1", "n2", "t0", "t1", "t2")


def test_fused_trace_diff_matches_jax_vjp(monkeypatch):
    monkeypatch.setattr(jfast, "fused_trace_planes",
                        lambda *a, **k: jax_trace(*a, force_kernel=True, **k))
    js, ts = scene_pair("cornell")
    rng = np.random.default_rng(3)
    n = 512
    org, d = _rays(rng, n)
    planes = [org[:, k] for k in range(3)] + [d[:, k] for k in range(3)]
    tb = np.full(n, 3e38, np.float32)
    tg = np.full(n, -2.0, np.float32)
    cts = [rng.normal(size=n).astype(np.float32) for _ in range(6)]
    jcfg, tcfg = JConfig(), RenderConfig()

    def jf(*x):
        s = dataclasses.replace(js, **dict(zip(GEOM, x[6:])))
        return jfast.fused_trace_diff(s, *x[:6], jcfg, jnp.asarray(tb),
                                      jnp.asarray(tg))

    jprim = [jnp.asarray(p) for p in planes] + [getattr(js, k) for k in GEOM]
    jout, vjp = jax.vjp(jf, *jprim)
    hit = np.asarray(jout[8]) >= 0
    assert hit.sum() > n // 4
    jct = [jnp.asarray(np.where(hit, c, 0.0)) for c in cts]
    jgrads = vjp((*jct, *(jnp.zeros(n) for _ in range(3))))

    tprim = [torch.from_numpy(p).requires_grad_() for p in planes]
    tgeom = {k: getattr(ts, k).clone().requires_grad_() for k in GEOM}
    s = dataclasses.replace(ts, **tgeom)
    tout = fused_trace_diff(s, *tprim, tcfg, torch.from_numpy(tb),
                            torch.from_numpy(tg))
    for k in (6, 7, 8):                      # mtl, em, tri: discrete
        np.testing.assert_array_equal(tout[k].numpy(), np.asarray(jout[k]))
        assert not tout[k].requires_grad
    np.testing.assert_allclose(tout[0].detach().numpy()[hit],
                               np.asarray(jout[0])[hit], rtol=1e-5)
    for k in range(1, 6):
        np.testing.assert_allclose(tout[k].detach().numpy(),
                                   np.asarray(jout[k]), rtol=1e-4, atol=1e-4)
    torch.autograd.backward(tout[:6], [torch.from_numpy(np.array(c)) for c in jct])
    tgrads = [p.grad for p in tprim] + [tgeom[k].grad for k in GEOM]
    for name, g, w in zip(["ox", "oy", "oz", "dx", "dy", "dz", *GEOM],
                          tgrads, jgrads):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)


# ---------------------------------------------------------------------------
# finite differences (tests/test_diff_fast.py, tests/test_diff.py)
# ---------------------------------------------------------------------------

def _directional(f, x0, v, eps):
    with torch.no_grad():
        return float((f(x0 + eps * v) - f(x0 - eps * v)) / (2 * eps))


def _grad(f, x0):
    x = x0.clone().requires_grad_(True)
    f(x).backward()
    return x.grad


@pytest.fixture(scope="module")
def cornell_fast():
    scene, cam = tproc.cornell_box(32, 32, device="cpu")
    return attach_bvh(scene, RenderConfig()), cam


def test_trace_vjp_matches_fd_on_vertices(cornell_fast):
    """d mean(w * (t - t0)) / d vertex_offset through apply_params' refit
    and the replay == the central difference of the trace (the loss is
    centred on the unmoved t, as in tests/test_diff_fast.py)."""
    scene, cam = cornell_fast
    rng = np.random.default_rng(3)
    n = 512
    org, d = (torch.from_numpy(a) for a in _rays(rng, n))
    w = torch.from_numpy(rng.normal(size=n).astype(np.float32))
    tb, tg = torch.full((n,), 3e38), torch.full((n,), -2.0)

    def t_of(off):
        s2, _ = apply_params(scene, cam, SceneParams(vertex_offset=off))
        return fused_trace_diff(s2, *org.T, *d.T, RenderConfig(), tb, tg)[0]

    off0 = torch.zeros_like(scene.v0)
    with torch.no_grad():
        tbase = t_of(off0)

    def loss(off):
        t = t_of(off)
        ok = (t < 1e30) & (tbase < 1e30)
        return torch.mean(torch.where(ok, w * (t - tbase), 0.0))

    g = _grad(loss, off0)
    assert torch.isfinite(g).all() and g.abs().sum() > 0
    v = torch.from_numpy(rng.normal(size=off0.shape).astype(np.float32))
    fd = _directional(loss, off0, v, 1e-3)
    assert float((g * v).sum()) == pytest.approx(fd, rel=0.05, abs=1e-5)


def test_trace_vjp_matches_fd_on_rays(cornell_fast):
    scene, _ = cornell_fast
    rng = np.random.default_rng(5)
    org, d = (torch.from_numpy(a) for a in _rays(rng, 256))
    w = torch.from_numpy(rng.normal(size=256).astype(np.float32))
    tb, tg = torch.full((256,), 3e38), torch.full((256,), -2.0)

    def out_of(o):
        t, pnx, pny, pnz = fused_trace_diff(scene, *o.T, *d.T, RenderConfig(),
                                            tb, tg)[:4]
        return t, pnx + pny + pnz

    with torch.no_grad():
        t0, s0 = out_of(org)

    def loss(o):
        t, sm = out_of(o)
        ok = (t < 1e30) & (t0 < 1e30)
        return torch.mean(torch.where(ok, w * ((t - t0) + (sm - s0)), 0.0))

    g = _grad(loss, org)
    assert torch.isfinite(g).all()
    v = torch.from_numpy(rng.normal(size=org.shape).astype(np.float32))
    fd = _directional(loss, org, v, 1e-3)
    assert float((g * v).sum()) == pytest.approx(fd, rel=0.05, abs=1e-5)


def _fd_scene(size):
    """tests/test_diff.py's flip-free configuration (a huge floor, an
    out-of-view overhead light, depth 1), with a BVH, with two changes.
    There the floor's normal points down, so no light reaches the camera:
    its image and every gradient are zero, and its finite-difference
    checks compare 0 with 0; here the floor faces up. And there the top
    rows look past the floor's far edge (a silhouette, which the
    interior-term gradient cannot see); here the camera looks down at
    45 degrees, so the floor fills the frustum and the light, level with
    the eye, stays out of view."""
    quads = [
        ([(-4000, 0, -4000), (-4000, 0, 4000), (4000, 0, 4000),
          (4000, 0, -4000)], "DiffuseWhite"),
        ([(200, 800, 100), (330, 800, 100), (330, 800, 230),
          (200, 800, 230)], "Light"),
    ]
    cfg = SceneConfig(width=size, height=size, fovy=40.0,
                      eye=(0.0, 800.0, -800.0), lookat=(0.0, 0.0, 0.0),
                      up=(0.0, 1.0, 0.0),
                      lights=[LightSpec("Light", (30.0, 25.0, 20.0))])
    scene = assemble_scene(cfg, tproc._quads_to_mesh(quads),
                           dict(tproc.CORNELL_MATERIALS), device="cpu")
    cam = Camera.create(cfg.eye, cfg.lookat, cfg.up, cfg.fovy, size, size)
    return attach_bvh(scene, RenderConfig()), cam


def _fd_check(f, x0, seed, eps, rel=0.05, n_dirs=3, mask=None):
    """tests/test_diff.py::_fd_check: median relative error of the
    directional derivative over ``n_dirs`` seeded directions; the gradient
    must not be zero."""
    g = _grad(f, x0)
    assert torch.isfinite(g).all() and g.abs().sum() > 0
    rng = np.random.default_rng(seed)
    errs = []
    for _ in range(n_dirs):
        v = rng.normal(size=tuple(x0.shape))
        if mask is not None:
            v = v * mask
        v = torch.from_numpy(v.astype(np.float32))
        fd = _directional(f, x0, v, eps)
        errs.append(abs(float((g * v).sum()) - fd) / max(abs(fd), 1e-7))
    assert np.median(errs) < rel, f"median rel err {np.median(errs)} ({errs})"


def _fast_loss(scene, cam, field, cfg, seed=7):
    target = torch.zeros(cam.height, cam.width, 3)
    key = master_key_data(seed)
    f = lambda x: render_loss_fast(SceneParams(**{field: x}), scene, cam, key,
                                   target, cfg, 2)
    return f, getattr(SceneParams.init_from(scene, cam, field), field)


def test_fast_loss_fd_albedo(cornell_fast):
    scene, cam = cornell_fast
    f, x0 = _fast_loss(scene, cam, "kd", RenderConfig(max_depth=3))
    _fd_check(f, x0, seed=1, eps=1e-2, n_dirs=1)


# the eye steps by 1.0, not 0.1: on this scene the loss's slope in the
# eye's x and y is ~1% of its slope in z, and a 0.1 step reads an extra
# ~5e-7 of slope in x and y (as does a 0.01 step) that steps of 1.0 and
# 3.0 do not; no visibility flip shows in the pixels, and the cause is
# not traced
EYE_EPS = 1.0


@pytest.mark.parametrize("field,seed,eps", [("vertex_offset", 4, 0.1),
                                            ("eye", 2, EYE_EPS)])
def test_fast_loss_fd_geometry(field, seed, eps):
    scene, cam = _fd_scene(24)
    f, x0 = _fast_loss(scene, cam, field, RenderConfig(max_depth=1))
    _fd_check(f, x0, seed=seed, eps=eps, n_dirs=1)


@pytest.fixture(scope="module")
def cornell12():
    scene, cam = tproc.cornell_box(12, 12, device="cpu")
    return scene, cam, master_key_data(11), torch.zeros(12, 12, 3)


def _scan_loss(setup, field, cfg=CFG):
    scene, cam, key, target = setup
    f = lambda x: render_loss(SceneParams(**{field: x}), scene, cam, key,
                              target, cfg, SPP)
    return f, getattr(SceneParams.init_from(scene, cam, field), field)


@pytest.mark.parametrize("field,seed", [("kd", 0), ("radiance", 1)])
def test_scan_loss_fd_materials(cornell12, field, seed):
    f, x0 = _scan_loss(cornell12, field)
    _fd_check(f, x0, seed=seed, eps=1e-2, n_dirs=1)


FD_CFG = RenderConfig(intersector="brute", max_depth=1, ray_chunk=1024,
                      tri_chunk=64)


@pytest.mark.parametrize("field,seed,eps,light_only", [
    ("eye", 2, EYE_EPS, False), ("lookat", 3, 0.1, False),
    ("vertex_offset", 4, 0.1, False), ("vertex_offset", 5, 0.1, True)])
def test_scan_loss_fd_geometry(field, seed, eps, light_only):
    """tests/test_diff.py's camera and vertex checks; ``light_only`` moves
    the light quad's two triangles alone (the NEE light tables follow).
    lookat steps by 0.1, not 1e-3: at 1e-3 the float32 loss's rounding is
    20-40% of the difference it takes."""
    scene, cam = _fd_scene(12)
    setup = (dataclasses.replace(scene, bvh=None), cam, master_key_data(7),
             torch.zeros(12, 12, 3))
    f, x0 = _scan_loss(setup, field, FD_CFG)
    mask = None
    if light_only:
        mask = np.zeros(tuple(x0.shape))
        lt = scene.lt_tri[0, :2].long().numpy()
        mask[lt] = 1.0
    _fd_check(f, x0, seed=seed, eps=eps, mask=mask)


def test_scan_camera_vertex_grads_finite_on_cornell(cornell12):
    for field in ("eye", "vertex_offset"):
        f, x0 = _scan_loss(cornell12, field)
        g = _grad(f, x0)
        assert torch.isfinite(g).all() and g.abs().sum() > 0, field


# ---------------------------------------------------------------------------
# against the JAX package, aligned
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def aligned(tmp_path_factory):
    return run_processes(str(tmp_path_factory.mktemp("aligned_diff")),
                         ["diff:cornell"])


def test_render_diff_image_matches_jax(aligned):
    want, got = aligned["diff-cornell-image-jax"], aligned["diff-cornell-image-port"]
    assert got.shape == want.shape == (SIZE, SIZE, 3)
    assert np.isfinite(got).all() and (got >= 0).all() and got.mean() > 0
    close = np.isclose(got, want, rtol=1e-4, atol=1e-5).all(axis=-1)
    assert close.mean() >= 0.99
    assert np.abs(got - want).max() <= 1e-6 * max(1.0, np.abs(want).max())


# each gradient's distance from the JAX package's, over its largest entry:
# the scan path's camera rays are (R, 3) tensors whose derivatives sum in
# other orders than XLA's (its eye gradient read 1.2e-5 on the first run)
GRAD_ATOL = {"fast": 1e-5, "scan": 1e-4}


@pytest.mark.parametrize("kind", ["fast", "scan"])
@pytest.mark.parametrize("field", DIFF_FIELDS)
def test_loss_grads_match_jax(aligned, kind, field):
    """render_loss_fast ("fast") and render_loss over the scan renderer
    with "brute" ("scan"), against the JAX package's: the loss within
    1e-6 relative, the gradient within ``GRAD_ATOL`` of its largest
    entry."""
    lw = aligned[f"diff-cornell-{kind}-loss-jax"]
    lg = aligned[f"diff-cornell-{kind}-loss-port"]
    assert abs(lg - lw) <= 1e-6 * abs(lw)
    want = aligned[f"diff-cornell-{kind}-grad-{field}-jax"]
    got = aligned[f"diff-cornell-{kind}-grad-{field}-port"]
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=GRAD_ATOL[kind] * np.abs(want).max())


# ---------------------------------------------------------------------------
# training, slicing, and the raises
# ---------------------------------------------------------------------------

def test_adam_recovers_albedo(cornell12):
    """BASELINE config 4 in miniature (tests/test_diff.py's albedo test,
    with make_train_step's Adam): from a perturbed albedo the loss against
    the unperturbed render falls below 5% of where it started."""
    from tinyraytracing_tpu_torch.render import render

    scene, cam, key, _ = cornell12
    target = render(scene, cam, key, CFG, SPP)
    step, init = make_train_step(scene, cam, target, CFG, SPP,
                                 learning_rate=0.02)
    state = init(SceneParams(kd=scene.kd * 0.5 + 0.1))
    losses = []
    for _ in range(60):
        state, loss = step(state, key)
        losses.append(float(loss))
    assert losses[-1] < 0.05 * losses[0], losses[::10]


def test_fast_train_step_lowers_the_loss():
    """make_train_step over render_loss_fast, in albedo and vertex offsets
    at once (a refit on every step), on the flip-free scene: on the
    cornell box any vertex step beyond the tie band (~3e-3 here) flips the
    emissive tie-break of its light, coplanar with the ceiling
    (tests/test_diff.py::fd_scene)."""
    scene, cam = _fd_scene(24)
    cfg, key = RenderConfig(max_depth=1), master_key_data(2)
    with torch.no_grad():
        target = render_diff(scene, cam, key, cfg, SPP)
    step, init = make_train_step(scene, cam, target, cfg, SPP,
                                 learning_rate=0.02, loss_fn=render_loss_fast)
    state = init(SceneParams(kd=scene.kd * 0.5 + 0.1,
                             vertex_offset=torch.zeros_like(scene.v0)))
    losses = [float(step(state, key)[1]) for _ in range(8)]
    assert losses[-1] < 0.5 * losses[0], losses
    assert state[0].vertex_offset.abs().sum() > 0


def test_render_diff_slices_are_the_image(cornell_fast):
    scene, cam = cornell_fast
    cam = dataclasses.replace(cam, width=8, height=8)
    cfg, key = RenderConfig(max_depth=2), master_key_data(4)
    with torch.no_grad():
        full, rays = render_diff(scene, cam, key, cfg, 2, return_rays=True)
        parts = [render_diff(scene, cam, key, cfg, 2, pix_lo=lo,
                             n_pix_local=24) for lo in (0, 24, 48)]
    assert float(rays) >= 64 * 2
    got = torch.cat(parts)[:64].reshape(8, 8, 3)
    assert torch.equal(got, full)


def test_render_diff_matches_scan_statistically(cornell_fast):
    from tinyraytracing_tpu_torch.render import render

    """tests/test_diff_fast.py's check at its size: the same estimator as
    the scan renderer, other samples."""
    scene, cam = cornell_fast
    cam = dataclasses.replace(cam, width=24, height=24)
    cfg = RenderConfig(intersector="bvh", max_depth=3)
    with torch.no_grad():
        a = render_diff(scene, cam, master_key_data(0), cfg, 16).numpy()
    b = render(scene, cam, master_key_data(1), cfg, 16).numpy()
    assert np.isfinite(a).all() and (a >= 0).all()
    assert abs(a.mean() - b.mean()) < 0.12 * max(b.mean(), 1e-6)
    assert np.corrcoef(a.ravel(), b.ravel())[0, 1] > 0.9


@pytest.mark.parametrize("backend", ["pallas", "bvh_pallas"])
def test_geometry_grads_through_kernel_backends_raise(backend):
    """Both packages refuse geometry and camera gradients through the
    intersect kernels (neither kernel has a backward pass); albedo, which
    does not enter the intersection, works through both."""
    js, jcam = jproc.cornell_box(8, 8)
    js = jax_attach(js, JConfig())
    ts, tcam = tproc.cornell_box(8, 8, device="cpu")
    ts = attach_bvh(ts, RenderConfig())
    jcfg = JConfig(intersector=backend, max_depth=2)
    tcfg = RenderConfig(intersector=backend, max_depth=2)
    jtarget, ttarget = jnp.zeros((8, 8, 3)), torch.zeros(8, 8, 3)
    for field in ("kd", "vertex_offset", "eye"):
        jp0 = getattr(JParams.init_from(js, jcam, field), field)
        jf = lambda x: jax_render_loss(JParams(**{field: x}), js, jcam,
                                       jax.random.PRNGKey(3), jtarget, jcfg, 1)
        tf, tx0 = _scan_loss((ts, tcam, master_key_data(3), ttarget), field,
                             tcfg)
        if field == "kd":
            jg = np.asarray(jax.grad(jf)(jp0))
            tg = _grad(tf, tx0)
            assert np.isfinite(jg).all() and np.abs(jg).sum() > 0
            assert torch.isfinite(tg).all() and tg.abs().sum() > 0
            continue
        with pytest.raises((ValueError, AssertionError)):
            jax.grad(jf)(jp0)
        with pytest.raises(ValueError, match="no backward pass"):
            _grad(tf, tx0)
        with torch.no_grad():                  # the forward alone is fine
            assert torch.isfinite(tf(tx0))


def test_edge_terms_raise_until_ported(cornell_fast):
    scene, cam = cornell_fast
    p = SceneParams(kd=scene.kd)
    for kw in (dict(edge_samples=4), dict(shadow_edge_samples=4)):
        with pytest.raises(NotImplementedError, match="edge"):
            render_loss_fast(p, scene, cam, master_key_data(0),
                             torch.zeros(32, 32, 3), RenderConfig(), 1, **kw)


def test_fast_path_under_the_near_first_walk(cornell_fast):
    """Under walk_order="near" the forward traces with the near-first walk
    (kernel 3 on the card): the same hits, so the same loss and
    gradients as the preorder walk's."""
    scene, cam = cornell_fast
    cam = dataclasses.replace(cam, width=16, height=16)
    target = torch.zeros(16, 16, 3)
    out = {}
    for order in ("preorder", "near"):
        cfg = RenderConfig(max_depth=3, walk_order=order, bvh_walk="wide",
                           ray_tile=256)
        p = SceneParams.init_from(scene, cam, "kd", "vertex_offset")
        for t in p.tensors():
            t.requires_grad_(True)
        loss = render_loss_fast(p, scene, cam, master_key_data(5), target,
                                cfg, SPP)
        loss.backward()
        out[order] = [loss.detach()] + [t.grad for t in p.tensors()]
    for a, b in zip(out["near"], out["preorder"]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9)
