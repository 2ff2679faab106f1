"""Inverse rendering: optimisable scene parameters and the gradient-descent
loop (BASELINE.json config 4: recover albedo and vertex offsets on the
Cornell box), the counterpart of ``tinyraytracing_tpu/diff/inverse.py``;
``torch.optim.Adam`` takes the place of ``optax.adam``.

``render_loss`` differentiates the scan renderer (``render.render``).
Its CUDA intersect kernels ("bvh_pallas", "pallas") return tensors with
no ``grad_fn``, so a geometry or camera parameter reaching them would get
a zero gradient and no error; ``render_loss`` raises there instead, on
either device, as the JAX package raises (its Pallas kernels define no
VJP). Albedo and radiance do not enter the intersection and stay allowed.
The fast path (``diff/fast.py``) differentiates geometry through the
trace kernels.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from tinyraytracing_tpu_torch.config import RenderConfig
from tinyraytracing_tpu_torch.models.camera import Camera
from tinyraytracing_tpu_torch.models.scene import Scene
from tinyraytracing_tpu_torch.ops.linalg import cross, dot
from tinyraytracing_tpu_torch.ops.lookup import gather_rows
from tinyraytracing_tpu_torch.render import render
from tinyraytracing_tpu_torch.utils import spans
from tinyraytracing_tpu_torch.utils.spans import span

PARAM_FIELDS = ("kd", "radiance", "vertex_offset", "eye", "lookat",
                "shared_vertex_offset")


@dataclasses.dataclass
class SceneParams:
    """Differentiable leaves layered onto a Scene/Camera.

    Any field can be None (not optimised). ``vertex_offset`` is a
    per-triangle rigid offset added to all three vertices;
    ``shared_vertex_offset`` moves the mesh's shared vertices
    (``Scene.vertices``): each mesh triangle's corner k takes the offset
    of its vertex id k, so the surface stays connected, and triangles
    outside the mesh stay. Silhouette gradients are interior-term only
    (the JAX package's diff/__init__).
    """

    kd: torch.Tensor | None = None             # (M, 3) material albedo
    radiance: torch.Tensor | None = None       # (M, 3) emitter radiance
    vertex_offset: torch.Tensor | None = None  # (T, 3)
    eye: torch.Tensor | None = None            # (3,) camera position
    lookat: torch.Tensor | None = None         # (3,)
    shared_vertex_offset: torch.Tensor | None = None  # (V, 3)

    @staticmethod
    def init_from(scene: Scene, cam: Camera, *fields: str) -> "SceneParams":
        """The current values of ``fields`` (copies, on the scene's device
        for scene fields and the camera's for camera fields)."""
        src = dict(
            kd=lambda: scene.kd,
            radiance=lambda: scene.radiance,
            vertex_offset=lambda: torch.zeros_like(scene.v0),
            eye=lambda: cam.eye,
            lookat=lambda: cam.lookat,
            shared_vertex_offset=lambda: torch.zeros_like(scene.vertices),
        )
        return SceneParams(**{f: src[f]().detach().clone() for f in fields})

    def tensors(self) -> list[torch.Tensor]:
        """The fields that are set, in ``PARAM_FIELDS`` order."""
        return [getattr(self, f) for f in PARAM_FIELDS
                if getattr(self, f) is not None]


def woop_transform(v0, v1, v2):
    """Differentiable version of ``models.scene.woop_transform`` in the
    corners' precision: per-triangle affine map to unit-barycentric space.
    Returns (A (T, 3, 3), b (T, 3), unit geometric normal (T, 3))."""
    e1 = v1 - v0
    e2 = v2 - v0
    n = cross(e1, e2)
    det = dot(n, n)
    safe = det > 1e-24
    one = torch.ones_like(det)
    inv = torch.where(safe, one / torch.where(safe, det, one),
                      torch.zeros_like(det))
    a = torch.stack([cross(e2, n), cross(n, e1), n], dim=1)
    a = a * inv[:, None, None]
    # sums written out in x, y, z order, and 1/sqrt (rsqrt is an
    # approximation on the card): CPU and card rows agree
    b = -(a[:, :, 0] * v0[:, None, 0] + a[:, :, 1] * v0[:, None, 1]
          + a[:, :, 2] * v0[:, None, 2])
    gn = n * torch.reciprocal(torch.sqrt(torch.clamp_min(det, 1e-30)))[:, None]
    return a, b, gn


def refittable(scene: Scene) -> bool:
    """Whether ``scene.bvh`` carries the refit metadata (``attach_bvh``)."""
    bvh = scene.bvh
    return (bvh is not None and bvh.tri_leaf is not None
            and bvh.packed is not None and bvh.packed.wn_bnode is not None)


def apply_params(scene: Scene, cam: Camera, p: SceneParams):
    """Overlay the optimisable parameters onto scene and camera; returns a
    new (Scene, Camera).

    ``vertex_offset`` moves all three vertices of each triangle rigidly
    and ``shared_vertex_offset`` the mesh's shared vertices (the span
    ``diff.mesh``), and either recomputes every derived geometric quantity
    differentiably (the Woop rows the mxu and slot intersectors read, the
    geometric normal of the grazing cull, the NEE light tables through
    ``lt_tri``), so no backend traces the unmoved mesh. Under
    ``shared_vertex_offset`` the mesh's faces turn, so a flat-shaded
    mesh's shading normals become the moved faces' unit normals, with
    their gradient; a mesh with smooth vertex normals raises. The moved
    mesh's Woop rows and normals come from its corners in float64 (the
    loaded table plus the offsets), as the loader computes them;
    triangles outside the mesh keep theirs bitwise. A BVH with refit
    metadata is refit (``diff/refit.py``, detached, the packed shading
    normals with it); one without it is dropped.
    """
    up_s = {}
    if p.kd is not None:
        up_s["kd"] = p.kd
    if p.radiance is not None:
        up_s["radiance"] = p.radiance
        # keep the light table's cached radiance consistent
        up_s["light_radiance"] = p.radiance[scene.light_mtl.long()]
    shared = p.shared_vertex_offset is not None
    if p.vertex_offset is not None or shared:
        with span("diff.mesh") if shared else contextlib.nullcontext():
            up_s.update(_moved_geometry(scene, p))
        if not refittable(scene):
            up_s["bvh"] = None
    if up_s:
        scene = dataclasses.replace(scene, **up_s)
        if "v0" in up_s and scene.bvh is not None:
            scene = _refit_sg(scene)
    up_c = {}
    if p.eye is not None:
        up_c["eye"] = p.eye
    if p.lookat is not None:
        up_c["lookat"] = p.lookat
    if up_c:
        cam = dataclasses.replace(cam, **up_c)
    return scene, cam


def _moved_geometry(scene: Scene, p: SceneParams) -> dict:
    """The Scene fields that the vertex leaves of ``p`` move: corners,
    Woop rows, geometric normals, the light tables' corners and, under
    ``shared_vertex_offset``, the mesh's flat shading normals."""
    v0, v1, v2 = scene.v0, scene.v1, scene.v2
    if p.vertex_offset is not None:
        v0, v1, v2 = v0 + p.vertex_offset, v1 + p.vertex_offset, v2 + p.vertex_offset
    shared = p.shared_vertex_offset
    if shared is None:
        woop_a, woop_b, gn = woop_transform(v0, v1, v2)
    else:
        if scene.vertex_index is None:
            raise ValueError("shared_vertex_offset needs a scene with a shared vertex "
                             "table (a mesh loaded with its vertex index)")
        if not scene.mesh_flat:
            raise ValueError("shared_vertex_offset moves flat-shaded meshes only: this "
                             "mesh's shading normals are not its face normals")
        # each corner's offset row; triangles outside the mesh read a zero
        # row past the table and keep everything as it is
        V, idx = shared.shape[0], scene.vertex_index
        inside = (idx[:, 0] >= 0)[:, None]
        rows = torch.where(idx >= 0, idx, V).to(torch.int64)
        table = torch.cat([shared, torch.zeros_like(shared[:1])])
        corner = gather_rows(table, rows, span_name="diff.mesh.scatter")      # (T, 3, 3)
        v0, v1, v2 = (torch.where(inside, v + corner[:, k], v)
                      for k, v in enumerate((v0, v1, v2)))
        c64 = scene.vertices[torch.clamp_max(rows, V - 1)] + corner.double()
        if p.vertex_offset is not None:
            c64 = c64 + p.vertex_offset.double()[:, None, :]
        a64, b64, g64 = woop_transform(c64[:, 0], c64[:, 1], c64[:, 2])
        woop_a = torch.where(inside[:, :, None], a64.float(), scene.woop_a)
        woop_b, gn = (torch.where(inside, x.float(), getattr(scene, k))
                      for x, k in ((b64, "woop_b"), (g64, "gn")))
        spans.count("mesh.vertices", V)
    # neither move changes a light's area (lt_prefix, light_area): per-triangle
    # moves are rigid, and emitters are never in the mesh
    lt = scene.lt_tri.long()
    out = dict(v0=v0, v1=v1, v2=v2, woop_a=woop_a, woop_b=woop_b, gn=gn,
               lt_v0=v0[lt], lt_v1=v1[lt], lt_v2=v2[lt])
    if shared is not None:
        out.update({k: torch.where(inside, gn, getattr(scene, k))
                    for k in ("n0", "n1", "n2")})
    return out


def _refit_sg(scene: Scene) -> Scene:
    """Refit the BVH to the moved vertices with only the refit outputs
    (boxes, packed payload) detached; the scene's own arrays keep their
    gradient paths."""
    from tinyraytracing_tpu_torch.diff.refit import refit_bvh

    with torch.no_grad():
        refit = refit_bvh(scene)
    return dataclasses.replace(scene, bvh=refit.bvh)


_KERNEL_BACKENDS = ("bvh_pallas", "pallas")


def check_differentiable(scene: Scene, cam: Camera, config: RenderConfig):
    """Raise where a gradient would be silently zero: a geometry or camera
    tensor that requires grad, and an intersect backend that is a CUDA
    kernel (its outputs have no ``grad_fn``). The backend is resolved on
    the scene's device, as ``ops.intersect.intersect`` resolves it."""
    from tinyraytracing_tpu_torch.ops.intersect import resolve_backend

    backend = resolve_backend(scene, scene.v0, config)
    if backend not in _KERNEL_BACKENDS or not torch.is_grad_enabled():
        return
    geometry = dict(v0=scene.v0, v1=scene.v1, v2=scene.v2,
                    woop_a=scene.woop_a, woop_b=scene.woop_b, gn=scene.gn,
                    eye=cam.eye, lookat=cam.lookat, up=cam.up, fovy=cam.fovy)
    needs = [k for k, t in geometry.items() if t.requires_grad]
    if needs:
        raise ValueError(
            f"intersector {backend!r} runs a kernel with no backward pass, so "
            f"the gradients of {needs} would be zero; use the fast path "
            "(diff.fast.render_loss_fast) or intersector 'brute' / 'mxu'")


def render_loss(params: SceneParams, scene: Scene, cam: Camera, key, target,
                config: RenderConfig, spp: int):
    """Mean-squared pixel loss of the scan render against ``target``,
    differentiable in ``params`` (path-replay interior-term gradients).
    ``key``: (k0, k1) key words (``ops.rng.master_key_data``). Raises for
    geometry or camera gradients through a CUDA intersect kernel
    (``check_differentiable``)."""
    with span("diff.refit"):
        s2, c2 = apply_params(scene, cam, params)
    check_differentiable(s2, c2, config)
    img = render(s2, c2, key, config, spp)
    return torch.mean((img - target) ** 2)


def make_train_step(scene, cam, target, config: RenderConfig, spp: int,
                    learning_rate: float = 0.05, loss_fn=render_loss):
    """Returns (step_fn, init_state) for Adam-based inverse rendering.

    ``init_state(params)`` -> state = (params, optimizer): the set fields
    of ``params`` become leaves that require grad, optimised by
    ``torch.optim.Adam`` (optax.adam's update). ``step_fn(state, key)`` ->
    (state, loss) takes one step of ``loss_fn`` (``render_loss``, or
    ``diff.fast.render_loss_fast`` for the fast path) and updates the
    parameters in place."""

    def step(state, key):
        params, opt = state
        with span("diff.step"):
            opt.zero_grad(set_to_none=True)
            with span("diff.loss"):
                loss = loss_fn(params, scene, cam, key, target, config, spp)
            with span("diff.backward"):
                loss.backward()
            with span("diff.update"):
                opt.step()
        return (params, opt), loss.detach()

    def init(params: SceneParams):
        leaves = {f: getattr(params, f).detach().clone().requires_grad_(True)
                  for f in PARAM_FIELDS if getattr(params, f) is not None}
        params = SceneParams(**leaves)
        return (params, torch.optim.Adam(params.tensors(), lr=learning_rate))

    return step, init
