"""Procedural scene generation, ported from
``tinyraytracing_tpu/models/procedural.py`` (identical geometry, so the
scenes equal the JAX package's array for array).

Two jobs (BASELINE.json configs 1/3/5):

1. ``cornell_box()`` — the reference repo's cornell-box scene ships
   cornell-box.{xml,mtl} but NOT the .obj (SURVEY.md §2 "Scene assets");
   we synthesize the geometry from the classic, publicly documented Cornell
   box coordinates (floor/ceiling/walls/light + short & tall blocks),
   using the material names of the checked-in cornell-box.mtl
   (DiffuseWhite/LeftWall/RightWall/Light). The light quad is coplanar with
   the ceiling — exactly the situation the reference's emissive tie-break
   exists for (bvh.cpp:219).

2. ``triangle_soup(n)`` / ``quad_grid(n)`` — parameterized large meshes
   (100K / 1M triangles) for BVH-scaling benchmarks; the reference assets
   top out at 31,407 triangles (staircase).

The scenes are assembled on the host (numpy) and moved to ``device`` at
the end: the card by default, the CPU only when the caller asks for it.
"""

from __future__ import annotations

import numpy as np

from tinyraytracing_tpu_torch.io.mtl import MaterialSpec
from tinyraytracing_tpu_torch.io.objmesh import MeshArrays
from tinyraytracing_tpu_torch.io.xmlscene import LightSpec, SceneConfig
from tinyraytracing_tpu_torch.models.camera import Camera
from tinyraytracing_tpu_torch.models.scene import Scene, assemble_scene

# classic Cornell box quads (public specification), one entry per surface:
# (4 corner vertices CCW as seen from inside, material name)
_CORNELL_QUADS = [
    # floor
    ([(552.8, 0, 0), (0, 0, 0), (0, 0, 559.2), (549.6, 0, 559.2)], "DiffuseWhite"),
    # light (coplanar with ceiling)
    ([(343, 548.8, 227), (343, 548.8, 332), (213, 548.8, 332), (213, 548.8, 227)], "Light"),
    # ceiling
    ([(556, 548.8, 0), (556, 548.8, 559.2), (0, 548.8, 559.2), (0, 548.8, 0)], "DiffuseWhite"),
    # back wall
    ([(549.6, 0, 559.2), (0, 0, 559.2), (0, 548.8, 559.2), (556, 548.8, 559.2)], "DiffuseWhite"),
    # right wall (x=0)
    ([(0, 0, 559.2), (0, 0, 0), (0, 548.8, 0), (0, 548.8, 559.2)], "RightWall"),
    # left wall (x~552)
    ([(552.8, 0, 0), (549.6, 0, 559.2), (556, 548.8, 559.2), (556, 548.8, 0)], "LeftWall"),
    # short block
    ([(130, 165, 65), (82, 165, 225), (240, 165, 272), (290, 165, 114)], "DiffuseWhite"),
    ([(290, 0, 114), (290, 165, 114), (240, 165, 272), (240, 0, 272)], "DiffuseWhite"),
    ([(130, 0, 65), (130, 165, 65), (290, 165, 114), (290, 0, 114)], "DiffuseWhite"),
    ([(82, 0, 225), (82, 165, 225), (130, 165, 65), (130, 0, 65)], "DiffuseWhite"),
    ([(240, 0, 272), (240, 165, 272), (82, 165, 225), (82, 0, 225)], "DiffuseWhite"),
    # tall block
    ([(423, 330, 247), (265, 330, 296), (314, 330, 456), (472, 330, 406)], "DiffuseWhite"),
    ([(423, 0, 247), (423, 330, 247), (472, 330, 406), (472, 0, 406)], "DiffuseWhite"),
    ([(472, 0, 406), (472, 330, 406), (314, 330, 456), (314, 0, 456)], "DiffuseWhite"),
    ([(314, 0, 456), (314, 330, 456), (265, 330, 296), (265, 0, 296)], "DiffuseWhite"),
    ([(265, 0, 296), (265, 330, 296), (423, 330, 247), (423, 0, 247)], "DiffuseWhite"),
]

CORNELL_MATERIALS = {
    "DiffuseWhite": MaterialSpec("DiffuseWhite", kd=(0.79, 0.76, 0.73), tr=(1, 1, 1)),
    "LeftWall": MaterialSpec("LeftWall", kd=(0.0, 0.24, 0.9), tr=(1, 1, 1)),
    "RightWall": MaterialSpec("RightWall", kd=(0.2, 0.76, 0.0), tr=(1, 1, 1)),
    "Light": MaterialSpec("Light", kd=(0, 0, 0), tr=(1, 1, 1)),
}


def _quads_to_mesh(quads) -> MeshArrays:
    mtl_names: list[str] = []
    tri_v, tri_m = [], []
    for corners, mtl in quads:
        if mtl not in mtl_names:
            mtl_names.append(mtl)
        mi = mtl_names.index(mtl)
        c = [np.asarray(p, np.float64) for p in corners]
        tri_v.append([c[0], c[1], c[2]])
        tri_v.append([c[0], c[2], c[3]])
        tri_m += [mi, mi]
    v = np.asarray(tri_v)
    e1 = v[:, 1] - v[:, 0]
    e2 = v[:, 2] - v[:, 0]
    gn = np.cross(e1, e2)
    gn /= np.maximum(np.linalg.norm(gn, axis=1, keepdims=True), 1e-30)
    vn = np.repeat(gn[:, None, :], 3, axis=1)  # flat shading normals
    return MeshArrays(
        v=v, vn=vn, vt=np.zeros((len(v), 3, 2)), normal=gn,
        center=v.mean(axis=1),
        mtl=np.asarray(tri_m, np.int32), mtl_names=mtl_names,
    )


def cornell_box(
    width: int = 1024,
    height: int = 1024,
    extra_materials: dict | None = None,
    device="cuda",
) -> tuple[Scene, Camera]:
    """The cornell-box scene with the reference's own camera/light config
    (cornell-box.xml: eye (278,273,-800), fovy 39.3077, light 'Light'
    radiance (34,24,8)) over synthesized classic geometry."""
    cfg = SceneConfig(
        width=width, height=height, fovy=39.3077,
        eye=(278.0, 273.0, -800.0), lookat=(278.0, 273.0, -799.0),
        up=(0.0, 1.0, 0.0),
        lights=[LightSpec("Light", (34.0, 24.0, 8.0))],
    )
    mesh = _quads_to_mesh(_CORNELL_QUADS)
    mats = dict(CORNELL_MATERIALS)
    if extra_materials:
        mats.update(extra_materials)
    scene = assemble_scene(cfg, mesh, mats, device=device)
    cam = Camera.create(cfg.eye, cfg.lookat, cfg.up, cfg.fovy, width, height)
    return scene, cam


def cornell_box_specular(width: int = 512, height: int = 512, device="cuda"):
    """BASELINE.json config 2: cornell box with a specular tall block and a
    glass short block (Fresnel/refraction path)."""
    quads = []
    for i, (corners, mtl) in enumerate(_CORNELL_QUADS):
        if 6 <= i <= 10:
            mtl = "Glass"
        elif i >= 11:
            mtl = "Mirror"
        quads.append((corners, mtl))
    cfg = SceneConfig(
        width=width, height=height, fovy=39.3077,
        eye=(278.0, 273.0, -800.0), lookat=(278.0, 273.0, -799.0),
        up=(0.0, 1.0, 0.0),
        lights=[LightSpec("Light", (34.0, 24.0, 8.0))],
    )
    mesh = _quads_to_mesh(quads)
    mats = dict(CORNELL_MATERIALS)
    mats["Mirror"] = MaterialSpec("Mirror", kd=(0.2, 0.2, 0.2), ks=(0.8, 0.8, 0.8), ns=500.0)
    mats["Glass"] = MaterialSpec("Glass", kd=(0.1, 0.1, 0.1), ks=(0.9, 0.9, 0.9), ns=200.0, ni=1.5, tr=(0.95, 0.95, 0.95))
    scene = assemble_scene(cfg, mesh, mats, device=device)
    cam = Camera.create(cfg.eye, cfg.lookat, cfg.up, cfg.fovy, width, height)
    return scene, cam


def quad_grid(n_triangles: int, width: int = 512, height: int = 512,
              seed: int = 0, device="cuda") -> tuple[Scene, Camera]:
    """A displaced checkerboard of small quads filling the cornell floor —
    n_triangles of real occluding geometry for BVH scaling runs
    (BASELINE.json configs 3 and 5: 100K / 1M tris)."""
    rng = np.random.default_rng(seed)
    n_quads = max(n_triangles // 2, 1)
    g = int(np.ceil(np.sqrt(n_quads)))
    xs = np.linspace(30.0, 520.0, g + 1)
    zs = np.linspace(30.0, 520.0, g + 1)
    quads = [_CORNELL_QUADS[i] for i in (0, 2, 3, 4, 5)]  # box minus blocks & light
    ii, jj = np.meshgrid(np.arange(g), np.arange(g), indexing="ij")
    ii, jj = ii.ravel()[:n_quads], jj.ravel()[:n_quads]
    y = 20.0 + 120.0 * rng.random(n_quads) ** 2
    x0, x1 = xs[ii], xs[ii + 1]
    z0, z1 = zs[jj], zs[jj + 1]

    v = np.empty((2 * n_quads, 3, 3))
    c0 = np.stack([x0, y, z0], 1)
    c1 = np.stack([x1, y, z0], 1)
    c2 = np.stack([x1, y, z1], 1)
    c3 = np.stack([x0, y, z1], 1)
    v[0::2, 0], v[0::2, 1], v[0::2, 2] = c0, c1, c2
    v[1::2, 0], v[1::2, 1], v[1::2, 2] = c0, c2, c3

    base = _quads_to_mesh(quads)
    mtl_names = list(base.mtl_names)
    if "DiffuseWhite" not in mtl_names:
        mtl_names.append("DiffuseWhite")
    mi = mtl_names.index("DiffuseWhite")

    gn = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    gn /= np.maximum(np.linalg.norm(gn, axis=1, keepdims=True), 1e-30)
    mesh = MeshArrays(
        v=np.concatenate([base.v, v]),
        vn=np.concatenate([base.vn, np.repeat(gn[:, None], 3, axis=1)]),
        vt=np.zeros((len(base.v) + len(v), 3, 2)),
        normal=np.concatenate([base.normal, gn]),
        center=np.concatenate([base.center, v.mean(1)]),
        mtl=np.concatenate([base.mtl, np.full(len(v), mi, np.int32)]),
        mtl_names=mtl_names,
    )
    cfg = SceneConfig(
        width=width, height=height, fovy=39.3077,
        eye=(278.0, 273.0, -800.0), lookat=(278.0, 273.0, -799.0),
        up=(0.0, 1.0, 0.0),
        lights=[LightSpec("Light", (34.0, 24.0, 8.0))],
    )
    # the light quad must exist as geometry: reuse the cornell light quad
    light_mesh = _quads_to_mesh([_CORNELL_QUADS[1]])
    mesh = MeshArrays(
        v=np.concatenate([mesh.v, light_mesh.v]),
        vn=np.concatenate([mesh.vn, light_mesh.vn]),
        vt=np.zeros((len(mesh.v) + 2, 3, 2)),
        normal=np.concatenate([mesh.normal, light_mesh.normal]),
        center=np.concatenate([mesh.center, light_mesh.center]),
        mtl=np.concatenate(
            [mesh.mtl, np.full(2, len(mtl_names), np.int32)]
        ),
        mtl_names=mtl_names + ["Light"],
    )
    from tinyraytracing_tpu_torch.ops.bvh import build_bvh_host

    bvh_host = build_bvh_host(mesh.v)
    scene = assemble_scene(cfg, mesh, dict(CORNELL_MATERIALS),
                           bvh_host=bvh_host, device=device)
    cam = Camera.create(cfg.eye, cfg.lookat, cfg.up, cfg.fovy, width, height)
    return scene, cam
