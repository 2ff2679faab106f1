"""Shared helpers of the tests that hold tinyraytracing_tpu_torch against
tinyraytracing_tpu: one scene for both packages, rays made with numpy."""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from tinyraytracing_tpu.config import RenderConfig as JConfig
from tinyraytracing_tpu.io.xmlscene import LightSpec, SceneConfig
from tinyraytracing_tpu.models import procedural as jproc
from tinyraytracing_tpu.models.scene import assemble_scene
from tinyraytracing_tpu.ops.bvh import attach_bvh, build_bvh_host
from tinyraytracing_tpu.ops.pallas_trace import fused_trace_planes as jtrace
from tinyraytracing_tpu_torch.config import RenderConfig
from tinyraytracing_tpu_torch.models.scene import scene_from_arrays
from tinyraytracing_tpu_torch.ops.trace import fused_trace_planes


def flatten_scene(scene, prefix=""):
    """A JAX Scene's fields as (numpy arrays, statics) with dotted keys —
    the input of tinyraytracing_tpu_torch.models.scene.scene_from_arrays."""
    arrays, statics = {}, {}
    for f in dataclasses.fields(scene):
        v = getattr(scene, f.name)
        key = prefix + f.name
        if v is None:
            continue
        if dataclasses.is_dataclass(v):
            a, s = flatten_scene(v, key + ".")
            arrays.update(a)
            statics.update(s)
        elif hasattr(v, "shape"):
            arrays[key] = np.asarray(v)
        else:
            statics[key] = v
    return arrays, statics


def port_scene(jscene, device="cpu"):
    """The port's Scene holding exactly the JAX scene's arrays."""
    return scene_from_arrays(*flatten_scene(jscene), device=device)


def random_rays(rng, n, center, spread, aim=None):
    """(org, dir) float32 numpy arrays: origins uniform in the cube
    center +- spread; directions uniform on the sphere, or, with ``aim`` =
    (center, spread), toward points uniform in that box."""
    org = rng.uniform(-1, 1, (n, 3)) * spread + np.asarray(center)
    if aim is None:
        d = rng.normal(size=(n, 3))
    else:
        d = rng.uniform(-1, 1, (n, 3)) * np.asarray(aim[1]) + aim[0] - org
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return org.astype(np.float32), d.astype(np.float32)


def shadow_queries(jscene, rng, n, center, spread):
    """Genuine shadow queries: origins in center +- spread, directions at a sampled
    point of light 0's first triangle, bound = that distance, target = the
    light's material. Returns float32 numpy (org, dir, t_bound, target)."""
    org, _ = random_rays(rng, n, center, spread)
    lv = [np.asarray(getattr(jscene, f"lt_v{k}"))[0, 0] for k in range(3)]
    b = rng.uniform(0, 1, (n, 3))
    b /= b.sum(1, keepdims=True)
    lp = b[:, :1] * lv[0] + b[:, 1:2] * lv[1] + b[:, 2:] * lv[2]
    to_l = lp - org
    tb = np.linalg.norm(to_l, axis=1)
    d = (to_l / tb[:, None]).astype(np.float32)
    tg = np.full(n, float(np.asarray(jscene.light_mtl)[0]), np.float32)
    return org, d, tb.astype(np.float32), tg


def planes(a):
    """(n, 3) numpy -> tuple of 3 contiguous (n,) planes."""
    return tuple(np.ascontiguousarray(a[:, k]) for k in range(3))


# ---------------------------------------------------------------------------
# one scene, traced by both packages
# ---------------------------------------------------------------------------

_SCENES = {}


def scene_pair(name):
    """(JAX scene, port scene with the same arrays), cached per worker."""
    if name not in _SCENES:
        if name == "cornell":
            js, _ = jproc.cornell_box(32, 32)
            js = attach_bvh(js, JConfig(leaf_size=8))
        elif name in ("grid600", "grid2000", "grid2000_32"):
            n = 600 if name == "grid600" else 2000
            js, _ = jproc.quad_grid(n, width=16, height=16)       # leaf 8
            if name == "grid2000_32":
                js = attach_bvh(js, JConfig(leaf_size=32))
        elif name in ("grid", "grid32"):
            js, _ = jproc.quad_grid(6000, width=16, height=16)   # leaf 8
            if name == "grid32":   # the JAX CLI's leaf width for big scenes
                js = attach_bvh(js, JConfig(leaf_size=32))
        elif name == "root_leaf":
            # 4 triangles (floor + light quads): the BVH root is a leaf
            quads = [jproc._CORNELL_QUADS[0], jproc._CORNELL_QUADS[1]]
            mesh = jproc._quads_to_mesh(quads)
            cfg = SceneConfig(8, 8, 40.0, (278.0, 273.0, -800.0),
                              (278.0, 273.0, -799.0), (0.0, 1.0, 0.0),
                              [LightSpec("Light", (34.0, 24.0, 8.0))])
            js = assemble_scene(cfg, mesh, dict(jproc.CORNELL_MATERIALS),
                                bvh_host=build_bvh_host(mesh.v, 8))
        _SCENES[name] = (js, port_scene(js))
    return _SCENES[name]


def scan_rays(tscene, n_side=32, seed=0):
    """The scan renderer's three kinds of rays on the port scene, as float32
    numpy (org, dir) of 3 * n_side^2 rows: jittered camera rays of the
    procedural scenes' camera; one cosine-diffuse bounce ray from each
    camera hit (a miss parks at 1e30 with direction (0, 0, 1), as the scan
    renderer parks dead rays); one shadow ray from each camera hit toward a
    random point of light 0 (a miss parks at 1e30 with the direction the
    renderer's NEE then computes). Hits come from the port's plain "bvh"
    walk; the random numbers from numpy."""
    from tinyraytracing_tpu_torch.models.camera import Camera, generate_rays
    from tinyraytracing_tpu_torch.ops.intersect import intersect
    from tinyraytracing_tpu_torch.ops.linalg import dot, normalize
    from tinyraytracing_tpu_torch.ops.sampling import sample_lobe

    rng = np.random.default_rng(seed)
    cam = Camera.create((278.0, 273.0, -800.0), (278.0, 273.0, -799.0),
                        (0.0, 1.0, 0.0), 39.3077, n_side, n_side)
    o, d = generate_rays(cam, (0, seed), "cpu")
    n = o.shape[0]
    hit = intersect(tscene, o, d, RenderConfig(intersector="bvh"))
    ok = hit.hit[:, None]
    point = torch.where(ok, o + hit.t[:, None] * d, torch.tensor(1.0e30))
    gn = tscene.gn[hit.idx]
    nrm = torch.where((dot(gn, d) > 0.0)[:, None], -gn, gn)
    u = torch.from_numpy(rng.uniform(size=(2, n)).astype(np.float32))
    bd = sample_lobe(nrm, u[0], u[1], torch.ones(n, dtype=torch.bool),
                     torch.ones(n))
    bd = torch.where(ok, bd, torch.tensor([0.0, 0.0, 1.0]))
    b = rng.uniform(size=(n, 3)).astype(np.float32)
    b = torch.from_numpy(b / b.sum(1, keepdims=True))
    lp = (b[:, :1] * tscene.lt_v0[0, 0] + b[:, 1:2] * tscene.lt_v1[0, 0]
          + b[:, 2:] * tscene.lt_v2[0, 0])
    sd = normalize(lp - point)
    org = torch.cat([o, point, point])
    dirs = torch.cat([d, bd, sd])
    return org.numpy().astype(np.float32), dirs.numpy().astype(np.float32)


def max_leaf_slots(tscene):
    """The most triangles any leaf of the port scene's wide tree holds."""
    meta = tscene.bvh.packed.WN[:, 6::8].flatten().to(torch.int64)
    leaf = meta[meta <= -2]
    return int(((-leaf - 2) & 63).max())


# ray origins (center, spread) per scene: the JAX package's own test rays
# (tests/test_pallas_trace.py), which keep hit distances well above the
# scene scale's float32 cancellation error (an origin a few units from a
# surface loses ~1e-5 relative t to cancellation, with or without FMA)
RAYS = {"cornell": ((278.0, 273.0, -500.0), 100.0,
                    ((278.0, 274.0, 280.0), 300.0)),
        "grid": ((275.0, 275.0, 275.0), 175.0)}
RAYS["grid32"] = RAYS["grid"]
# shadow-ray origins: inside the box, below the light
SHADOW_RAYS = {"cornell": ((278.0, 150.0, 280.0), 120.0),
               "grid": ((275.0, 110.0, 275.0), 90.0)}
SHADOW_RAYS["grid32"] = SHADOW_RAYS["grid"]


def trace_both(name, org, d, cfg=None, **kw):
    """Trace the same rays with the JAX interpret-mode kernel and the port,
    both under the config fields ``cfg`` (default: the wide walk); extra
    numpy keyword planes (t_bound, target_mtl) go to both."""
    js, ts = scene_pair(name)
    cfg = dict(bvh_walk="wide") if cfg is None else cfg
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    j = jtrace(js, *map(jnp.asarray, planes(org)), *map(jnp.asarray, planes(d)),
               JConfig(**cfg), force_kernel=True, **jkw)
    t = fused_trace_planes(
        ts, *map(torch.from_numpy, planes(org)),
        *map(torch.from_numpy, planes(d)), RenderConfig(**cfg), **tkw)
    return [np.asarray(x) for x in j], [x.numpy() for x in t]
