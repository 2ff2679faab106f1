"""Stackless per-ray BVH traversal over the preorder skip-link layout, the
counterpart of ``tinyraytracing_tpu/ops/traverse.py`` (a vmapped
``lax.while_loop`` there; here one cursor per ray, vectorised over the
rays that are still walking, looping until every cursor is past the last
node).

AABB hit on an internal node -> cursor + 1 (descend into the left child);
a miss or a finished leaf -> cursor = skip[cursor]. With
``config.bvh_early_out`` a box whose entry distance lies beyond the ray's
best hit (times 1 + tie_eps) is skipped. A leaf's ``leaf_size`` triangle
lanes are tested with Moller-Trumbore (ops/intersect.py), masked to its
count. Slab test per the reference interactAABB (bvh.cpp:231-245).
"""

from __future__ import annotations

import torch

from tinyraytracing_tpu_torch.config import RenderConfig
from tinyraytracing_tpu_torch.ops.intersect import INF, Hit, _moller_trumbore


def bvh_intersect(scene, org, d, config: RenderConfig) -> Hit:
    bvh = scene.bvh
    LS = bvh.leaf_size
    N = bvh.n_nodes
    T = scene.v0.shape[0]
    dev = org.device
    R = org.shape[0]
    eps1 = 1.0 + config.tie_eps
    lane = torch.arange(LS, device=dev)
    inv = torch.reciprocal(torch.where(d == 0.0, torch.full_like(d, 1e-30), d))

    node = torch.zeros(R, dtype=torch.int64, device=dev)
    bt = torch.full((R,), INF, dtype=torch.float32, device=dev)
    bi = torch.zeros(R, dtype=torch.int64, device=dev)
    bu = torch.zeros(R, dtype=torch.float32, device=dev)
    bv = torch.zeros(R, dtype=torch.float32, device=dev)
    be = torch.zeros(R, dtype=torch.bool, device=dev)
    while True:
        act = torch.nonzero(node < N).squeeze(1)
        if act.numel() == 0:
            break
        nd = node[act]
        o = org[act]
        t_a = (bvh.nmin[nd] - o) * inv[act]
        t_b = (bvh.nmax[nd] - o) * inv[act]
        t0 = torch.minimum(t_a, t_b).amax(dim=1)
        t1 = torch.maximum(t_a, t_b).amin(dim=1)
        dist = torch.where(t0 > 0.0, t0, t1)
        aabb_hit = (t1 >= t0) & (dist > 0.0)
        if config.bvh_early_out:
            aabb_hit = aabb_hit & (torch.clamp_min(t0, 0.0) <= bt[act] * eps1)
        count = bvh.count[nd]
        is_leaf = count > 0

        # masked vector test of the leaf's <= LS triangles
        at = torch.nonzero(aabb_hit & is_leaf).squeeze(1)
        if at.numel():
            r = act[at]
            ids = torch.clamp(bvh.start[nd[at]].to(torch.int64)[:, None] + lane,
                              0, T - 1)                          # (n, LS)
            mask = lane[None, :] < count[at][:, None]
            t, u, v, ok = _moller_trumbore(
                org[r][:, None, :], d[r][:, None, :], scene.v0[ids],
                scene.v1[ids], scene.v2[ids], scene.gn[ids], config)
            ok = ok & mask
            t = torch.where(ok, t, torch.full_like(t, INF))
            emis = scene.tri_emissive[ids] & ok
            lt = t.amin(dim=1)
            tie = (t <= lt[:, None] * eps1) & (t < INF) & emis
            lhas = tie.any(dim=1)
            li = torch.where(lhas, tie.to(torch.int32).argmax(dim=1),
                             t.argmin(dim=1))[:, None]
            lt = torch.gather(t, 1, li)[:, 0]
            cbt, cbe = bt[r], be[r]
            near = (lt <= cbt * eps1) & (cbt <= lt * eps1) & (lt < INF)
            repl = (~near & (lt < cbt)) | (near & lhas & ~cbe)
            bt[r] = torch.where(repl, lt, cbt)
            bi[r] = torch.where(repl, torch.gather(ids, 1, li)[:, 0], bi[r])
            bu[r] = torch.where(repl, torch.gather(u, 1, li)[:, 0], bu[r])
            bv[r] = torch.where(repl, torch.gather(v, 1, li)[:, 0], bv[r])
            be[r] = torch.where(repl, lhas, cbe)

        node[act] = torch.where(aabb_hit & ~is_leaf, nd + 1,
                                bvh.skip[nd].to(torch.int64))
    return Hit(t=bt, idx=bi, u=bu, v=bv, hit=bt < INF)
