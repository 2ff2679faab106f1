"""BVH refit under vertex moves, the counterpart of
``tinyraytracing_tpu/diff/refit.py``.

Vertex moves keep the tree's topology valid; only boxes and the leaf
payload go stale. ``refit_bvh`` rewrites them from the scene's
current v0/v1/v2/woop_a/woop_b/gn:

- leaf boxes: segment min/max of the moved per-triangle boxes over
  ``BVHArrays.tri_leaf`` (``scatter_reduce`` "amin"/"amax", exact), with
  the builder's pad;
- interior boxes: a bottom-up union over ``n_levels`` sweeps;
- the wide nodes' child boxes through ``PackedLeaves.wn_bnode``;
- PS rows 0-3 (Woop rows and offsets, geometric normal, emissive flag) at
  the static slot layout, and P, which holds the same rows: the trace
  kernels read P's records (``Scene.trace_records`` takes its slot records
  from ``Scene.bvh_records``, built from P);
- the shading normals of PS rows 4-7 from the scene's n0/n1/n2, which turn
  with the faces of a flat-shaded mesh under per-vertex offsets (the
  trace kernels shade with the normals the shading records hold); rigid
  per-triangle moves leave them, and so these rows, as they were. The
  texcoords and material of rows 4-7 move with the triangle and stay.
  The JAX refit leaves its P stale, which only its packet-BVH kernel
  reads; here a stale P would make the trace kernels test the unmoved
  triangles.

The result is a new PackedLeaves, BVHArrays and Scene: the kernels read
``Scene.trace_records`` / ``bvh_records`` / ``slot_payload``, caches kept
with each Scene object, so a refit that kept the old Scene would have the
kernels trace the unmoved geometry without any error. Hit-finding is
discrete, so the caller detaches the refit (``inverse._refit_sg``);
geometry gradients come from the path replay of ``diff/fast.py``.
"""

from __future__ import annotations

import dataclasses

import torch

_BIG = 3e38


def refit_bvh(scene, aabb_pad: float | None = None):
    """Return a new Scene whose BVH boxes and leaf payload are refit to its
    current geometry. Needs the refit metadata ``ops.bvh.attach_bvh``
    records. ``aabb_pad`` defaults to the pad the builder applied
    (``BVHArrays.aabb_pad``)."""
    bvh = scene.bvh
    pk = bvh.packed if bvh is not None else None
    if bvh is None or bvh.tri_leaf is None or pk is None or pk.wn_bnode is None:
        raise ValueError("scene.bvh lacks refit metadata (re-attach_bvh)")
    if aabb_pad is None:
        aabb_pad = bvh.aabb_pad
    N = bvh.n_nodes
    f32 = torch.float32
    dev = scene.v0.device
    c = lambda x: torch.tensor(x, dtype=f32, device=dev)

    tmin = torch.minimum(torch.minimum(scene.v0, scene.v1), scene.v2)
    tmax = torch.maximum(torch.maximum(scene.v0, scene.v1), scene.v2)
    idx = bvh.tri_leaf.to(torch.int64)[:, None].expand(-1, 3)
    leaf_min = torch.full((N, 3), _BIG, dtype=f32, device=dev).scatter_reduce(
        0, idx, tmin, "amin", include_self=False)
    leaf_max = torch.full((N, 3), -_BIG, dtype=f32, device=dev).scatter_reduce(
        0, idx, tmax, "amax", include_self=False)
    is_leaf = (bvh.count > 0)[:, None]
    nmin = torch.where(is_leaf, leaf_min - c(aabb_pad), c(_BIG))
    nmax = torch.where(is_leaf, leaf_max + c(aabb_pad), c(-_BIG))

    cl = torch.clamp_min(bvh.child_l, 0).to(torch.int64)
    cr = torch.clamp_min(bvh.child_r, 0).to(torch.int64)
    internal = (bvh.count == 0)[:, None]
    for lvl in range(bvh.n_levels - 2, -1, -1):
        m = internal & (bvh.level == lvl)[:, None]
        nmin = torch.where(m, torch.minimum(nmin[cl], nmin[cr]), nmin)
        nmax = torch.where(m, torch.maximum(nmax[cl], nmax[cr]), nmax)

    # binary node records: cols 0-5 the boxes, 6-7 (skip, leaf) unchanged
    node_box = torch.cat([nmin, nmax, pk.node_box[:, 6:8]], dim=1)

    # wide-node rows: child boxes through the binary map, meta unchanged
    bmap = torch.clamp_min(pk.wn_bnode, 0).to(torch.int64)   # (n_wide, 8)
    empty = (pk.wn_bnode < 0)[:, :, None]
    zero = c(0.0)
    gmin = torch.where(empty, zero, nmin[bmap])              # (n_wide, 8, 3)
    gmax = torch.where(empty, zero, nmax[bmap])
    meta = pk.WN[:, 6:64:8][:, :, None]                      # (n_wide, 8, 1)
    child = torch.cat([gmin, gmax, meta, torch.zeros_like(meta)], dim=2)
    WN = torch.cat([child.reshape(pk.n_wide, 64),
                    torch.zeros((pk.n_wide, 64), dtype=f32, device=dev)], dim=1)

    # PS rows 0-3 at the static slot layout (pack_bvh_leaves' block layout)
    tid = pk.tid.to(torch.int64)
    valid = pk.slot_valid
    n_blk = pk.n_leaves
    wa = torch.where(valid[:, None, None], scene.woop_a[tid], zero)
    wb = torch.where(valid[:, None], scene.woop_b[tid], zero)
    g = torch.where(valid[:, None], scene.gn[tid], zero)
    em = (valid & scene.tri_emissive[tid]).to(f32)
    attrs = [
        wa[:, 0, 0], wa[:, 0, 1], wa[:, 0, 2], wa[:, 1, 0],
        wa[:, 1, 1], wa[:, 1, 2], wa[:, 2, 0], wa[:, 2, 1],
        wa[:, 2, 2], wb[:, 0], wb[:, 1], wb[:, 2],
        g[:, 0], g[:, 1], g[:, 2], em,
    ]
    rows = [torch.cat([a.reshape(n_blk, 32) for a in attrs[4 * r:4 * r + 4]],
                      dim=1).reshape(1, -1) for r in range(4)]
    P = torch.cat(rows, dim=0)
    # S attrs 0-8 are n0 n1 n2 (xyz each) at (row a // 4, lane a % 4)
    S = pk.PS[4:].reshape(4, n_blk, 4, 32).clone()
    normals = torch.cat([scene.n0[tid], scene.n1[tid], scene.n2[tid]], dim=1)
    for a, x in enumerate(normals.unbind(1)):
        r, c = divmod(a, 4)
        S[r, :, c] = torch.where(valid, x, S[r, :, c].reshape(-1)).reshape(n_blk, 32)
    PS = torch.cat([P, S.reshape(4, -1)], dim=0)

    pk2 = dataclasses.replace(pk, P=P, node_box=node_box, PS=PS, WN=WN)
    bvh2 = dataclasses.replace(bvh, nmin=nmin, nmax=nmax, packed=pk2)
    return dataclasses.replace(scene, bvh=bvh2)
