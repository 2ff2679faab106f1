"""Scene: the tensor representation of geometry, materials, lights, textures
and the packed BVH — the counterpart of ``tinyraytracing_tpu/models/scene.py``
with the same fields and the same array layouts (float32 / int32 / bool).

Host-side assembly is numpy, exactly as in the JAX package, so every array
equals that package's bit for bit; ``scene_from_arrays`` builds a Scene
from such numpy arrays (e.g. the fields of a JAX Scene), which is how the
tests make both implementations trace the same scene.
"""

from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np
import torch

from tinyraytracing_tpu_torch.io.mtl import MaterialSpec, parse_mtl
from tinyraytracing_tpu_torch.io.objmesh import MeshArrays, parse_obj, triangle_areas
from tinyraytracing_tpu_torch.io.textures import load_texture_atlas
from tinyraytracing_tpu_torch.io.xmlscene import SceneConfig, parse_scene_xml
from tinyraytracing_tpu_torch.models.camera import Camera
from tinyraytracing_tpu_torch.utils.spans import spanned


def _to(obj, device):
    """Copy of a dataclass with every tensor field moved to ``device``."""
    kw = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            kw[f.name] = v.to(device)
        elif dataclasses.is_dataclass(v):
            kw[f.name] = _to(v, device)
    return dataclasses.replace(obj, **kw)


@dataclasses.dataclass
class PackedLeaves:
    """Leaf-slot-padded BVH payload read by the trace kernels. Every leaf
    occupies one 128-lane block of 32 triangle slots; padding slots have
    all-zero Woop rows (they can never register a hit).

    P block (rows 0-3 of PS): attr a of slot s at (row a//4, lane
    (a%4)*32 + s) of the leaf's block:
      [ax ay az bx | by bz cx cy | cz ou ov ow | gx gy gz em]
    (a,b,c) = Woop u/v/w transform rows, o* = Woop offsets, g* = geometric
    normal (grazing cull), em = emissive flag (tie-break).
    S block (rows 4-7 of PS), same addressing:
      [n0x n0y n0z n1x | n1y n1z n2x n2y | n2z t0u t0v t1u | t1v t2u t2v mtl]
    """

    P: torch.Tensor          # (4, n_leaves*128) f32
    tid: torch.Tensor        # (n_leaves*32,) i32 slot -> triangle (0 for pads)
    node_box: torch.Tensor   # (N, 8) f32 [min xyz, max xyz, skip, leaf enc]
    node_meta: torch.Tensor  # (N, 2) i32 [skip, leaf_id*64+count or -1]
    PS: torch.Tensor         # (8, n_leaves*128) f32
    WN: torch.Tensor         # (n_wide, 128) f32; lane c*8+k = child c's
    #   [x0 y0 z0 x1 y1 z1 meta pad]; meta >= 0 wide child index,
    #   <= -2 -(leaf_id*64+count+2), == -1 empty
    n_nodes: int
    n_leaves: int
    leaf_size: int
    n_wide: int
    wide_depth: int
    # refit metadata (diff/refit.py): the binary node behind each wide
    # child (-1 empty), and which slots hold a triangle (pads keep zero
    # Woop rows); None for a tree packed without them
    wn_bnode: torch.Tensor | None = None    # (n_wide, 8) int32
    slot_valid: torch.Tensor | None = None  # (n_leaves*32,) bool


@dataclasses.dataclass
class BVHArrays:
    """Flattened binary BVH in depth-first preorder plus its packed form.
    The refit metadata (``ops.bvh.refit_metadata``) is recorded by
    ``attach_bvh``; a tree built elsewhere (``assemble_scene``'s
    ``bvh_host``) keeps it None, as in the JAX package, and then
    ``diff.inverse.apply_params`` drops the tree under vertex offsets.
    ``builder`` says which builder made the tree ("native", "numpy"; None
    where it was not recorded, e.g. a tree carried across from JAX)."""

    nmin: torch.Tensor       # (N, 3) AABB min (includes the build's pad)
    nmax: torch.Tensor       # (N, 3) AABB max
    start: torch.Tensor      # (N,) first triangle of leaf range
    count: torch.Tensor      # (N,) leaf triangle count (0 => internal)
    skip: torch.Tensor       # (N,) next preorder node past this subtree
    packed: PackedLeaves
    n_nodes: int
    leaf_size: int
    aabb_pad: float = 1e-3
    tri_leaf: torch.Tensor | None = None   # (T,) leaf node of each triangle
    level: torch.Tensor | None = None      # (N,) depth of each node (root 0)
    child_l: torch.Tensor | None = None    # (N,) left child (i+1) or -1
    child_r: torch.Tensor | None = None    # (N,) right child (skip[i+1]) or -1
    n_levels: int = 0
    builder: str | None = None

    @staticmethod
    def from_nodes(nodes, packed, leaf_size, aabb_pad) -> "BVHArrays":
        t = lambda k: torch.from_numpy(np.asarray(nodes[k]))
        return BVHArrays(
            nmin=t("nmin"), nmax=t("nmax"), start=t("start"),
            count=t("count"), skip=t("skip"), packed=packed,
            n_nodes=int(nodes["nmin"].shape[0]), leaf_size=int(leaf_size),
            aabb_pad=float(aabb_pad), builder=nodes.get("builder"),
        )

    def to(self, device) -> "BVHArrays":
        return _to(self, device)


@dataclasses.dataclass
class Scene:
    # --- geometry (T triangles) ---
    v0: torch.Tensor         # (T, 3)
    v1: torch.Tensor
    v2: torch.Tensor
    n0: torch.Tensor         # (T, 3) shading normals
    n1: torch.Tensor
    n2: torch.Tensor
    t0: torch.Tensor         # (T, 2) texcoords
    t1: torch.Tensor
    t2: torch.Tensor
    gn: torch.Tensor         # (T, 3) geometric normal
    woop_a: torch.Tensor     # (T, 3, 3) Woop transform rows (u, v, w)
    woop_b: torch.Tensor     # (T, 3) Woop offset
    tri_mtl: torch.Tensor    # (T,) int32
    tri_emissive: torch.Tensor  # (T,) bool
    # --- materials (M) ---
    kd: torch.Tensor         # (M, 3)
    ks: torch.Tensor
    tr: torch.Tensor
    ns: torch.Tensor         # (M,)
    ni: torch.Tensor
    radiance: torch.Tensor   # (M, 3)
    mtl_emissive: torch.Tensor  # (M,) bool
    tex_id: torch.Tensor     # (M,) int32, -1 = no texture
    # --- lights (L, padded to K triangles each) ---
    light_mtl: torch.Tensor  # (L,) int32
    light_radiance: torch.Tensor  # (L, 3)
    lt_v0: torch.Tensor      # (L, K, 3)
    lt_v1: torch.Tensor
    lt_v2: torch.Tensor
    lt_n0: torch.Tensor
    lt_n1: torch.Tensor
    lt_n2: torch.Tensor
    lt_prefix: torch.Tensor  # (L, K) prefix areas, +inf padding
    lt_tri: torch.Tensor     # (L, K) int32 scene triangle of each entry
    light_area: torch.Tensor  # (L,)
    nee_range: torch.Tensor  # () area of lights[0] (reference quirk)
    # --- textures ---
    tex: torch.Tensor        # (NT, Hmax, Wmax, 3) float32
    tex_hw: torch.Tensor     # (NT, 2) int32
    # --- acceleration structure (optional) ---
    bvh: BVHArrays | None
    # --- static metadata ---
    mtl_names: tuple = ()
    light_names: tuple = ()
    lt_counts: tuple = ()    # per-light REAL triangle counts
    # --- the optimisable mesh's shared vertices (None: no mesh) ---
    vertices: torch.Tensor | None = None      # (V, 3) f64 shared vertex table, as loaded
    vertex_index: torch.Tensor | None = None  # (T, 3) int32 ids, -1 outside the mesh
    mesh_flat: bool = True   # every mesh triangle shades with its face normal

    @property
    def num_triangles(self) -> int:
        return self.v0.shape[0]

    @property
    def num_lights(self) -> int:
        return self.light_mtl.shape[0]

    @property
    def num_materials(self) -> int:
        return self.kd.shape[0]

    @property
    def device(self) -> torch.device:
        return self.v0.device

    @functools.cached_property
    def slot_payload(self) -> tuple[torch.Tensor, int]:
        """(P, n_chunks): the triangles packed into 32-slot blocks for the
        slot kernel (``ops.slot_intersect.pack_triangle_slots``), on the
        scene's device; packed at first use and kept with the scene."""
        from tinyraytracing_tpu_torch.ops.slot_intersect import pack_triangle_slots

        return pack_triangle_slots(self.woop_a, self.woop_b, self.gn,
                                   self.tri_emissive)

    @functools.cached_property
    def bvh_records(self):
        """The packet-BVH kernel's layout of the scene's BVH
        (``ops.bvh_intersect.bvh_records``: node records and the occupied
        slots' records), on the scene's device; built at first use and
        kept with the scene."""
        from tinyraytracing_tpu_torch.ops.bvh_intersect import bvh_records

        return bvh_records(self.bvh.packed)

    @functools.cached_property
    @spanned("scene.records")
    def trace_records(self):
        """The trace kernels' layout of the scene's BVH
        (``ops.trace.trace_records``: child records of the wide nodes, the
        occupied slots' test records, which are ``bvh_records.slot``, and
        their shading records), on the scene's device; built at first use
        and kept with the scene."""
        from tinyraytracing_tpu_torch.ops.trace import trace_records

        return trace_records(self.bvh.packed, self.bvh_records)

    def to(self, device) -> "Scene":
        return _to(self, device)


_STATIC = {"mtl_names", "light_names", "lt_counts", "mesh_flat"}
# the shared vertex table, the port's own (never carried across)
MESH_ARRAYS = ("vertices", "vertex_index")
SCENE_ARRAYS = tuple(f.name for f in dataclasses.fields(Scene)
                     if f.name not in _STATIC and f.name != "bvh"
                     and f.name not in MESH_ARRAYS)
BVH_ARRAYS = ("nmin", "nmax", "start", "count", "skip")
BVH_STATICS = ("n_nodes", "leaf_size", "aabb_pad")
PACKED_ARRAYS = ("P", "tid", "node_box", "node_meta", "PS", "WN")
PACKED_STATICS = ("n_nodes", "n_leaves", "leaf_size", "n_wide", "wide_depth")
# the refit metadata: carried across where present, else None
BVH_REFIT = ("tri_leaf", "level", "child_l", "child_r")
PACKED_REFIT = ("wn_bnode", "slot_valid")


def scene_from_arrays(d: dict, statics: dict, device="cuda") -> Scene:
    """Build a Scene on ``device`` (the card unless the caller asks for the
    CPU) from numpy arrays.

    ``d`` maps every Scene array field name to its array; BVH arrays are
    keyed ``"bvh.<field>"`` and packed-leaf arrays ``"bvh.packed.<field>"``
    (omit them all for a scene without a BVH). ``statics`` holds
    ``mtl_names``, ``light_names``, ``lt_counts`` and, with a BVH, the
    integer fields under the same dotted keys (``"bvh.n_nodes"``,
    ``"bvh.packed.n_wide"``, ...). The refit metadata (``BVH_REFIT``,
    ``PACKED_REFIT``, ``"bvh.n_levels"``) comes across where present and
    is None where absent; ``BVHArrays.builder`` and the shared vertex
    table (``MESH_ARRAYS``, which the JAX package has not) are not carried
    (None).
    Extra keys are ignored, so the fields of a JAX Scene can be passed as
    they are."""
    t = lambda a: torch.from_numpy(np.array(a)).to(device)
    opt = lambda key: t(d[key]) if key in d else None
    bvh = None
    if "bvh.nmin" in d:
        packed = PackedLeaves(
            **{k: t(d[f"bvh.packed.{k}"]) for k in PACKED_ARRAYS},
            **{k: int(statics[f"bvh.packed.{k}"]) for k in PACKED_STATICS},
            **{k: opt(f"bvh.packed.{k}") for k in PACKED_REFIT},
        )
        bvh = BVHArrays(
            **{k: t(d[f"bvh.{k}"]) for k in BVH_ARRAYS}, packed=packed,
            n_nodes=int(statics["bvh.n_nodes"]),
            leaf_size=int(statics["bvh.leaf_size"]),
            aabb_pad=float(statics.get("bvh.aabb_pad", 1e-3)),
            **{k: opt(f"bvh.{k}") for k in BVH_REFIT},
            n_levels=int(statics.get("bvh.n_levels", 0)),
        )
    return Scene(
        **{k: t(d[k]) for k in SCENE_ARRAYS}, bvh=bvh,
        mtl_names=tuple(statics["mtl_names"]),
        light_names=tuple(statics["light_names"]),
        lt_counts=tuple(int(c) for c in statics["lt_counts"]),
    )


def scene_to_arrays(scene: Scene) -> tuple[dict, dict]:
    """Inverse of ``scene_from_arrays``: (numpy arrays, statics)."""
    host = lambda x: x.detach().cpu().numpy()
    d = {k: host(getattr(scene, k)) for k in SCENE_ARRAYS}
    statics = dict(mtl_names=scene.mtl_names, light_names=scene.light_names,
                   lt_counts=scene.lt_counts)
    if scene.bvh is not None:
        b, pk = scene.bvh, scene.bvh.packed
        d.update({f"bvh.{k}": host(getattr(b, k)) for k in BVH_ARRAYS})
        d.update({f"bvh.packed.{k}": host(getattr(pk, k))
                  for k in PACKED_ARRAYS})
        d.update({f"bvh.{k}": host(getattr(b, k)) for k in BVH_REFIT
                  if getattr(b, k) is not None})
        d.update({f"bvh.packed.{k}": host(getattr(pk, k))
                  for k in PACKED_REFIT if getattr(pk, k) is not None})
        statics.update({f"bvh.{k}": getattr(b, k)
                        for k in (*BVH_STATICS, "n_levels")})
        statics.update({f"bvh.packed.{k}": getattr(pk, k)
                        for k in PACKED_STATICS})
    return d, statics


def woop_transform(tri_v: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-triangle affine transform to unit-barycentric space: local =
    A @ p + b maps v0 to the origin, v1 to (1,0,0)-ish, v2 to (0,1,0)-ish,
    with the third coordinate the (unnormalized) plane offset.

    Rows (computed in float64):
      A = [cross(e2, n); cross(n, e1); n] / (n . n),  b = -A @ v0
    with e1 = v1-v0, e2 = v2-v0, n = e1 x e2. Degenerate triangles get
    zero rows (every ray misses).
    """
    v = np.asarray(tri_v, dtype=np.float64)
    e1 = v[:, 1] - v[:, 0]
    e2 = v[:, 2] - v[:, 0]
    n = np.cross(e1, e2)
    det = np.einsum("ij,ij->i", n, n)
    safe = det > 1e-24
    inv_det = np.where(safe, 1.0 / np.where(safe, det, 1.0), 0.0)
    rows = np.stack(
        [np.cross(e2, n), np.cross(n, e1), n], axis=1
    ) * inv_det[:, None, None]                       # (T, 3, 3)
    b = -np.einsum("tij,tj->ti", rows, v[:, 0])      # (T, 3)
    return rows, b


@spanned("scene.assemble")
def assemble_scene(
    config: SceneConfig,
    mesh: MeshArrays,
    materials: dict[str, MaterialSpec],
    basedir: str = "",
    bvh_host: tuple | None = None,
    device="cuda",
) -> Scene:
    """Build a Scene from parsed host data (the JAX package's
    ``assemble_scene``, step for step).

    ``bvh_host``: optional (nodes_dict, permutation) from ops.bvh.build_bvh;
    per-triangle arrays are permuted to leaf order on the host. Light
    tables are built from the ORIGINAL obj order, as the reference does
    (main.cpp:66-76).

    A mesh with a shared vertex table (``MeshArrays.vertex_index``) keeps
    it: ``Scene.vertices`` (float64, for Woop rows of the moved mesh as
    exact as the loaded ones) and each triangle's vertex ids, permuted with
    the triangles. Emitters are left out of the mesh (their ids become
    -1): the light tables' areas stay as loaded. ``Scene.mesh_flat`` says
    whether every mesh triangle's three shading normals are its geometric
    normal (within 1e-6).
    """
    # --- material table: encounter order = xml lights, obj usemtl, mtl file
    names: list[str] = []
    index: dict[str, int] = {}

    def intern(n: str) -> int:
        if n not in index:
            index[n] = len(names)
            names.append(n)
        return index[n]

    for l in config.lights:
        intern(l.mtl_name)
    for n in mesh.mtl_names:
        intern(n)
    for n in materials:
        intern(n)

    M = len(names)
    kd = np.zeros((M, 3), np.float32)
    ks = np.zeros((M, 3), np.float32)
    tr = np.zeros((M, 3), np.float32)
    ns = np.ones((M,), np.float32)
    ni = np.ones((M,), np.float32)
    radiance = np.zeros((M, 3), np.float32)
    emissive = np.zeros((M,), bool)
    tex_id = np.full((M,), -1, np.int32)

    tex_paths: list[str] = []
    for n, i in index.items():
        spec = materials.get(n)
        if spec is not None:
            kd[i], ks[i], tr[i] = spec.kd, spec.ks, spec.tr
            ns[i], ni[i] = spec.ns, spec.ni
            if spec.map_kd:
                path = os.path.join(basedir, spec.map_kd) if basedir else spec.map_kd
                if path not in tex_paths:
                    tex_paths.append(path)
                tex_id[i] = tex_paths.index(path)
    for l in config.lights:
        emissive[index[l.mtl_name]] = True
        radiance[index[l.mtl_name]] = l.radiance

    atlas, tex_hw = load_texture_atlas(tex_paths)

    # --- geometry, remapped to global material ids
    obj_to_global = np.asarray([intern(n) for n in mesh.mtl_names], np.int32)
    tri_mtl = obj_to_global[mesh.mtl]
    tri_emissive = emissive[tri_mtl]

    # --- light triangle tables with prefix-area CDFs (obj order)
    L = max(len(config.lights), 1)
    areas = triangle_areas(mesh.v)
    counts = []
    per_light: list[np.ndarray] = []
    for l in config.lights:
        sel = np.nonzero(tri_mtl == index[l.mtl_name])[0]
        per_light.append(sel)
        counts.append(len(sel))
    K = max(max(counts, default=0), 1)

    lt_v = np.zeros((L, K, 3, 3), np.float32)
    lt_n = np.zeros((L, K, 3, 3), np.float32)
    lt_prefix = np.full((L, K), np.inf, np.float32)
    lt_tri = np.zeros((L, K), np.int32)
    light_area = np.zeros((L,), np.float32)
    light_mtl = np.zeros((L,), np.int32)
    light_radiance = np.zeros((L, 3), np.float32)
    T = mesh.v.shape[0]
    inv_perm = np.arange(T, dtype=np.int64)
    if bvh_host is not None:
        inv_perm[np.asarray(bvh_host[1])] = np.arange(T)
    for li, l in enumerate(config.lights):
        sel = per_light[li]
        light_mtl[li] = index[l.mtl_name]
        light_radiance[li] = l.radiance
        if len(sel):
            lt_v[li, : len(sel)] = mesh.v[sel]
            lt_n[li, : len(sel)] = mesh.vn[sel]
            lt_tri[li, : len(sel)] = inv_perm[sel]
            pref = np.cumsum(areas[sel])
            lt_prefix[li, : len(sel)] = pref
            light_area[li] = pref[-1]
    nee_range = light_area[0] if len(config.lights) else np.float32(0)

    # the mesh's vertex ids, emitters left out
    vidx = None
    if mesh.vertex_index is not None:
        vidx = np.where(tri_emissive[:, None], -1, mesh.vertex_index)

    # optional host-side BVH permutation of the per-triangle arrays
    tv, tvn, tvt, tgn = mesh.v, mesh.vn, mesh.vt, mesh.normal
    bvh = None
    if bvh_host is not None:
        from tinyraytracing_tpu_torch.ops.bvh import pack_bvh_leaves

        nodes, perm = bvh_host
        tv, tvn, tvt, tgn = tv[perm], tvn[perm], tvt[perm], tgn[perm]
        if vidx is not None:
            vidx = vidx[perm]
        tri_mtl = tri_mtl[perm]
        tri_emissive = tri_emissive[perm]
        woop_a, woop_b = woop_transform(tv)
        packed = pack_bvh_leaves(
            nodes, woop_a, woop_b, tgn, tri_emissive, int(nodes["leaf_size"]),
            n0=tvn[:, 0], n1=tvn[:, 1], n2=tvn[:, 2],
            t0=tvt[:, 0], t1=tvt[:, 1], t2=tvt[:, 2],
            mtl=tri_mtl,
        )
        bvh = BVHArrays.from_nodes(nodes, packed, int(nodes["leaf_size"]),
                                   float(nodes.get("aabb_pad", 1e-3)))
    else:
        woop_a, woop_b = woop_transform(tv)

    f32 = lambda x: np.asarray(x, dtype=np.float32)
    d = dict(
        v0=f32(tv[:, 0]), v1=f32(tv[:, 1]), v2=f32(tv[:, 2]),
        n0=f32(tvn[:, 0]), n1=f32(tvn[:, 1]), n2=f32(tvn[:, 2]),
        t0=f32(tvt[:, 0]), t1=f32(tvt[:, 1]), t2=f32(tvt[:, 2]),
        gn=f32(tgn), woop_a=f32(woop_a), woop_b=f32(woop_b),
        tri_mtl=tri_mtl, tri_emissive=tri_emissive,
        kd=kd, ks=ks, tr=tr, ns=ns, ni=ni, radiance=radiance,
        mtl_emissive=emissive, tex_id=tex_id,
        light_mtl=light_mtl, light_radiance=light_radiance,
        lt_v0=lt_v[:, :, 0], lt_v1=lt_v[:, :, 1], lt_v2=lt_v[:, :, 2],
        lt_n0=lt_n[:, :, 0], lt_n1=lt_n[:, :, 1], lt_n2=lt_n[:, :, 2],
        lt_prefix=lt_prefix, lt_tri=lt_tri, light_area=light_area,
        nee_range=f32(nee_range), tex=atlas, tex_hw=tex_hw,
    )
    t = lambda a: torch.from_numpy(np.array(a)).to(device)
    mesh_kw = {}
    if vidx is not None:
        inside = vidx[:, 0] >= 0
        flat = bool(np.all(np.abs(tvn[inside] - tgn[inside][:, None]) <= 1e-6))
        mesh_kw = dict(vertices=t(np.asarray(mesh.vertices, np.float64)),
                       vertex_index=t(vidx.astype(np.int32)), mesh_flat=flat)
    return Scene(
        **{k: t(d[k]) for k in SCENE_ARRAYS},
        bvh=bvh.to(device) if bvh is not None else None,
        mtl_names=tuple(names),
        light_names=tuple(l.mtl_name for l in config.lights),
        lt_counts=tuple(int(c) for c in counts),
        **mesh_kw,
    )


def load_scene(
    xml_path: str,
    obj_path: str,
    mtl_path: str,
    basedir: str | None = None,
    with_bvh: bool = False,
    leaf_size: int = 8,
    aabb_pad: float = 1e-3,
    device="cuda",
) -> tuple[Scene, Camera]:
    """Load a scene the way the reference program does (main.cpp:66-69),
    returning the Scene (on ``device``, the card unless the caller asks
    for the CPU) and the Camera from the XML. With ``with_bvh`` the SAH BVH
    is built on the host and attached. The OBJ parse and the build take
    the native code first, as the JAX package does, and numpy where g++
    is missing (logged once)."""
    from tinyraytracing_tpu_torch.native import (
        BuildError, log_fallback, parse_obj_native,
    )

    if basedir is None:
        basedir = os.path.dirname(os.path.abspath(xml_path))
    config = parse_scene_xml(xml_path)
    try:
        mesh = parse_obj_native(obj_path)
    except BuildError as e:
        log_fallback(e)
        mesh = parse_obj(obj_path)
    materials = parse_mtl(mtl_path)
    bvh_host = None
    if with_bvh:
        from tinyraytracing_tpu_torch.ops.bvh import build_bvh_host

        bvh_host = build_bvh_host(mesh.v, leaf_size, aabb_pad)
    scene = assemble_scene(config, mesh, materials, basedir,
                           bvh_host=bvh_host, device=device)
    camera = Camera.create(
        config.eye, config.lookat, config.up, config.fovy,
        config.width, config.height,
    )
    return scene, camera
