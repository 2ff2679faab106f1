"""The three finite-difference scenes of tests/test_diff_edge.py, built with
tinyraytracing_tpu_torch alone (``chip_smoke.py`` loads this file by its
path on the card), and the finite-difference check of the edge terms
through ``diff.fast.render_loss_fast``.

- "quad": an emissive floor under a floating dark quad (an open mesh);
- "cube": the same floor under a closed dark cube (view-dependent
  silhouettes);
- "shadow": a diffuse floor lit by a small overhead light, with a dark
  occluder between them outside the camera's frustum (the loss moves only
  through the cast shadow).

The occluder moves in x; the target is the scene with it shifted by
``shift``. Each check holds the interior plus edge gradient to the
central difference of the loss at the tolerance of the JAX test, and the
interior gradient alone below a tenth of it.
"""

from __future__ import annotations

import dataclasses

import torch

from tinyraytracing_tpu_torch.config import RenderConfig
from tinyraytracing_tpu_torch.io.mtl import MaterialSpec
from tinyraytracing_tpu_torch.io.xmlscene import LightSpec, SceneConfig
from tinyraytracing_tpu_torch.models.camera import Camera
from tinyraytracing_tpu_torch.models.procedural import _quads_to_mesh
from tinyraytracing_tpu_torch.models.scene import assemble_scene
from tinyraytracing_tpu_torch.ops.bvh import attach_bvh

RES = 48
FLOOR = [(-600, 0, -600), (600, 0, -600), (600, 0, 600), (-600, 0, 600)]


def _cube_quads(cx, cy, cz, h, mtl):
    """6 outward-wound quads of an axis-aligned cube (center, half-size)."""
    x0, y0, z0 = cx - h, cy - h, cz - h
    x1, y1, z1 = cx + h, cy + h, cz + h
    return [
        ([(x0, y1, z0), (x1, y1, z0), (x1, y1, z1), (x0, y1, z1)], mtl),  # +y
        ([(x0, y0, z1), (x1, y0, z1), (x1, y0, z0), (x0, y0, z0)], mtl),  # -y
        ([(x1, y0, z0), (x1, y0, z1), (x1, y1, z1), (x1, y1, z0)], mtl),  # +x
        ([(x0, y0, z1), (x0, y0, z0), (x0, y1, z0), (x0, y1, z1)], mtl),  # -x
        ([(x0, y0, z1), (x0, y1, z1), (x1, y1, z1), (x1, y0, z1)], mtl),  # +z
        ([(x1, y0, z0), (x1, y1, z0), (x0, y1, z0), (x0, y0, z0)], mtl),  # -z
    ]


def _quads(name, dx):
    if name == "quad":
        occ = [(-100 + dx, 150, -100), (100 + dx, 150, -100),
               (100 + dx, 150, 100), (-100 + dx, 150, 100)]
        return [(FLOOR, "Light"), (occ, "Black")]
    if name == "cube":
        return [(FLOOR, "Light")] + _cube_quads(dx, 150.0, 0.0, 60.0, "Black")
    # the floor wound to face up (+y); the light high up off to +x
    return [
        ([(-600, 0, -600), (-600, 0, 600), (600, 0, 600), (600, 0, -600)],
         "White"),
        ([(220, 400, -80), (380, 400, -80), (380, 400, 80), (220, 400, 80)],
         "Light"),
        ([(100 + dx, 200, -50), (200 + dx, 200, -50), (200 + dx, 200, 50),
          (100 + dx, 200, 50)], "Black"),
    ]


def make_scene(name, dx=0.0, device="cpu", bvh=True):
    """(scene, camera) of FD scene ``name`` with the occluder shifted by
    ``dx``; with ``bvh`` a BVH with refit metadata (the fast path needs
    one)."""
    shadow = name == "shadow"
    cfg = SceneConfig(
        width=RES, height=RES, fovy=30.0 if shadow else 45.0,
        eye=(0.0, 500.0, -1e-3), lookat=(0.0, 0.0, 0.0), up=(0.0, 0.0, 1.0),
        lights=[LightSpec("Light", (15.0,) * 3 if shadow else (5.0,) * 3)])
    mats = {"Light": MaterialSpec("Light", kd=(0, 0, 0)),
            "Black": MaterialSpec("Black", kd=(0, 0, 0))}
    if shadow:
        mats["White"] = MaterialSpec("White", kd=(0.7, 0.7, 0.7))
    scene = assemble_scene(cfg, _quads_to_mesh(_quads(name, dx)), mats,
                           device="cpu")
    if bvh:
        scene = attach_bvh(scene, RenderConfig())
    cam = Camera.create(cfg.eye, cfg.lookat, cfg.up, cfg.fovy, RES, RES)
    return scene.to(device), cam


@dataclasses.dataclass(frozen=True)
class FDCase:
    """One FD check: the target's shift, spp, edge sample counts, the
    central difference's step, the least difference that is not
    degenerate, the tolerance and the config's overrides (the JAX test's
    values)."""

    shift: float
    spp: int
    edge_samples: int
    shadow_edge_samples: int
    eps: float
    fd_min: float
    rel: float
    cfg: tuple = ()


CASES = {
    "quad": FDCase(30.0, 4, 4096, 0, 10.0, 1e-6, 0.15),
    "cube": FDCase(30.0, 4, 4096, 0, 10.0, 1e-6, 0.2),
    "shadow": FDCase(20.0, 8, 0, 8192, 8.0, 1e-7, 0.25,
                     (("light_sampler", "uniform"),)),
}


def config(name, intersector="pallas"):
    """The JAX tests' config (depth 1), with ``intersector``."""
    return RenderConfig(intersector=intersector, max_depth=1, ray_chunk=8192,
                        tri_chunk=64, **dict(CASES[name].cfg))


def occluder_mask(scene):
    """(T, 1) float32: 1 on the dark occluder's triangles (not emissive,
    zero Kd), whatever order the BVH put them in."""
    kd0 = scene.kd[scene.tri_mtl.long()].abs().sum(-1) == 0
    return (kd0 & ~scene.tri_emissive).to(torch.float32)[:, None]


def fd_check(name, device="cpu", intersector="pallas", wrap=None):
    """The FD check of scene ``name``: returns a dict with the loss at the
    unmoved scene, the interior gradient, the interior plus edge gradient
    (both along the occluder's x move), the central difference, the full
    vertex-offset gradient and whether the check passed. ``wrap(fn)``, if
    given, runs the forward + backward with the edge terms (``fn()``) and
    returns its result (e.g. counting the launches in it)."""
    from tinyraytracing_tpu_torch.diff import SceneParams, render_loss_fast
    from tinyraytracing_tpu_torch.diff.edge import build_edge_aux
    from tinyraytracing_tpu_torch.ops.rng import master_key_data
    from tinyraytracing_tpu_torch.render import render

    case = CASES[name]
    cfg = config(name, intersector)
    scene, cam = make_scene(name, device=device)
    tscene, _ = make_scene(name, case.shift, device=device, bvh=False)
    key = master_key_data(0)
    with torch.no_grad():
        target = render(tscene, cam, key, cfg, case.spp)
    aux = build_edge_aux(scene)
    move = torch.zeros_like(scene.v0)
    move[:, :1] = occluder_mask(scene)

    def loss(dx, n_edge, n_shadow):
        off = (dx * move).requires_grad_(True)
        value = render_loss_fast(
            SceneParams(vertex_offset=off), scene, cam, key, target, cfg,
            case.spp, edge_samples=n_edge, shadow_edge_samples=n_shadow,
            edge_aux=aux)
        return value, off

    def grad(n_edge, n_shadow):
        value, off = loss(0.0, n_edge, n_shadow)
        value.backward()
        return value.detach(), off.grad

    with torch.no_grad():
        fd = (loss(case.eps, 0, 0)[0] - loss(-case.eps, 0, 0)[0]) / (2 * case.eps)
    _, g0 = grad(0, 0)
    full = lambda: grad(case.edge_samples, case.shadow_edge_samples)
    value, g = full() if wrap is None else wrap(full)
    fd, g_int, g_full = float(fd), float((g0 * move).sum()), float((g * move).sum())
    ok = (abs(fd) > case.fd_min and abs(g_int) < 0.1 * abs(fd)
          and abs(g_full - fd) <= case.rel * abs(fd))
    return dict(loss=float(value), fd=fd, g_int=g_int, g_full=g_full, grad=g,
                ok=ok)
