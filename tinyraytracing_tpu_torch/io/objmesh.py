"""OBJ mesh parser → SoA numpy arrays.

Replicates the semantics of Scene::readobj (reference:
RayTracingOnCPU/scene.cpp:115-213), in particular its quirky face-index
layout heuristic: the reference sets ``isvnvt=false`` if any ``vt`` line
appears while zero ``vn`` lines have been seen (scene.cpp:150-152). Then for
a face token ``a/b/c`` (scene.cpp:166-190):

    isvnvt == True   ->  a = vertex, b = NORMAL index, c = TEXCOORD index
    isvnvt == False  ->  a = vertex, b = TEXCOORD index, c = NORMAL index

(i.e. the course assets' exporters disagree about v/vt/vn vs v/vn/vt order
and the reference guesses from declaration order; we must follow to match
its shading normals). Two-component ``a/b`` faces assign b to vt (isvnvt)
else vn, like the reference's last-character branch.

Per-face data computed exactly as the reference does: geometric normal
``normalize(cross(v1-v0, v2-v0))`` and centroid (scene.cpp:196-197).
Triangles only (the assets contain only 3-vertex faces).

The shared vertex table and each face's three vertex ids are kept beside
the triangle soup (``vertices``, ``vertex_index``): a connected mesh is
what per-vertex geometry gradients (``diff.inverse.SceneParams.
shared_vertex_offset``) move.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class MeshArrays:
    """Structure-of-arrays triangle soup (float64 host precision)."""

    v: np.ndarray        # (T, 3, 3) vertex positions
    vn: np.ndarray       # (T, 3, 3) shading normals (zeros if absent)
    vt: np.ndarray       # (T, 3, 2) texcoords (zeros if absent)
    normal: np.ndarray   # (T, 3) geometric normal
    center: np.ndarray   # (T, 3) centroid
    mtl: np.ndarray      # (T,) int32 index into mtl_names
    mtl_names: list[str]  # encounter-ordered usemtl names ("" if none)
    # the shared vertex table and each triangle's vertex ids into it, -1
    # for a triangle outside the mesh; None where the source has no table
    vertices: np.ndarray | None = None      # (V, 3) float64
    vertex_index: np.ndarray | None = None  # (T, 3) int64

    @property
    def num_triangles(self) -> int:
        return self.v.shape[0]


def parse_obj(path: str) -> MeshArrays:
    vertices: list[tuple] = []
    normals: list[tuple] = []
    texcoords: list[tuple] = []
    isvnvt = True
    mtl_names: list[str] = []
    mtl_index: dict[str, int] = {}
    cur_mtl = -1

    fv: list = []   # (3,) of vertex indices per face
    fn: list = []
    ft: list = []
    fm: list = []

    with open(path, "r", encoding="utf-8", errors="replace") as f:
        for line in f:
            tok = line.split()
            if not tok:
                continue
            key = tok[0]
            if key == "v":
                vertices.append((float(tok[1]), float(tok[2]), float(tok[3])))
            elif key == "vn":
                normals.append((float(tok[1]), float(tok[2]), float(tok[3])))
            elif key == "vt":
                if not normals:
                    isvnvt = False
                texcoords.append((float(tok[1]), float(tok[2])))
            elif key == "usemtl":
                name = tok[1]
                if name not in mtl_index:
                    mtl_index[name] = len(mtl_names)
                    mtl_names.append(name)
                cur_mtl = mtl_index[name]
            elif key == "f":
                vi = [0, 0, 0]
                ni = [-1, -1, -1]
                ti = [-1, -1, -1]
                for k in range(3):
                    parts = tok[1 + k].split("/")
                    vi[k] = int(parts[0]) - 1
                    if len(parts) == 3:
                        # second slot: vn if isvnvt else vt (reference
                        # scene.cpp:178-183); third slot the other one.
                        if isvnvt:
                            if parts[1]:
                                ni[k] = int(parts[1]) - 1
                            if parts[2]:
                                ti[k] = int(parts[2]) - 1
                        else:
                            if parts[1]:
                                ti[k] = int(parts[1]) - 1
                            if parts[2]:
                                ni[k] = int(parts[2]) - 1
                    elif len(parts) == 2:
                        if isvnvt:
                            ti[k] = int(parts[1]) - 1
                        else:
                            ni[k] = int(parts[1]) - 1
                fv.append(vi)
                fn.append(ni)
                ft.append(ti)
                fm.append(cur_mtl)

    T = len(fv)
    V = np.asarray(vertices, dtype=np.float64).reshape(-1, 3)
    VN = (
        np.asarray(normals, dtype=np.float64).reshape(-1, 3)
        if normals
        else np.zeros((0, 3))
    )
    VT = (
        np.asarray(texcoords, dtype=np.float64).reshape(-1, 2)
        if texcoords
        else np.zeros((0, 2))
    )

    fvi = np.asarray(fv, dtype=np.int64).reshape(T, 3)
    fni = np.asarray(fn, dtype=np.int64).reshape(T, 3)
    fti = np.asarray(ft, dtype=np.int64).reshape(T, 3)

    v = V[fvi]                                          # (T, 3, 3)
    vn = np.zeros((T, 3, 3))
    if len(VN):
        has = fni >= 0
        vn[has] = VN[fni[has]]
    vt = np.zeros((T, 3, 2))
    if len(VT):
        has = fti >= 0
        vt[has] = VT[fti[has]]

    e1 = v[:, 1] - v[:, 0]
    e2 = v[:, 2] - v[:, 0]
    gn = np.cross(e1, e2)
    norm = np.linalg.norm(gn, axis=1, keepdims=True)
    gn = gn / np.maximum(norm, 1e-30)
    center = v.mean(axis=1)

    # faces before any usemtl get a synthetic empty material name, matching
    # the reference's default-constructed materials[""] entry.
    mtl = np.asarray(fm, dtype=np.int32)
    if (mtl < 0).any():
        if "" not in mtl_index:
            mtl_index[""] = len(mtl_names)
            mtl_names.append("")
        mtl = np.where(mtl < 0, mtl_index[""], mtl).astype(np.int32)

    return MeshArrays(
        v=v, vn=vn, vt=vt, normal=gn, center=center, mtl=mtl, mtl_names=mtl_names,
        vertices=V, vertex_index=fvi,
    )


def triangle_areas(v: np.ndarray) -> np.ndarray:
    """Areas of (T,3,3) triangles: 0.5 * |e1 x e2|.

    (The reference computes this via the law of cosines, triangle.cpp:3-10 —
    mathematically identical, the cross form is better conditioned.)
    """
    cr = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    return 0.5 * np.linalg.norm(cr, axis=1)
