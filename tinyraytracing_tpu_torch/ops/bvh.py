"""SAH BVH construction (host side, numpy) and the packed device layout,
ported from ``tinyraytracing_tpu/ops/bvh.py`` with identical arrays.

Split semantics replicate the reference construction (RayTracingOnCPU/
bvh.cpp:16-144): top-down over centroid-sorted ranges, full-sweep SAH on all
3 axes, leaf when <= leaf_size, node AABBs padded by the build's aabb_pad.
The tree is flattened to depth-first preorder with skip links, collapsed to
8-wide nodes (``widen_bvh``) and packed into per-leaf 128-lane blocks
(``pack_bvh_leaves``) — the layouts the trace kernels read.

``build_bvh_host`` builds with the native C++ builder
(``native/bvh_builder.cc``, a copy of the JAX package's) as the JAX
package does, and with the numpy ``build_bvh`` only where g++ is missing
(logged once). The two give the same topology and permutation, but a
node box can differ by one float32 ulp between them: the native builder
takes the pad as a float32 (its C ``float pad``) and numpy as the float64
``aabb_pad``, so ``min - pad`` can round to neighbouring float32 values.
So only the native tree is the JAX package's tree bitwise, and the tree
records which builder made it (``BVHArrays.builder``).

``attach_bvh`` also records the refit metadata (``tri_leaf``, ``level``,
``child_l``/``child_r``, ``n_levels``; ``PackedLeaves.wn_bnode`` and
``slot_valid``) that ``diff/refit.py`` needs to move boxes and leaf
payload with the vertices.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tinyraytracing_tpu_torch.config import RenderConfig
from tinyraytracing_tpu_torch.utils.spans import span, spanned


def build_bvh(
    tri_v: np.ndarray, leaf_size: int = 8, aabb_pad: float = 1e-3
) -> tuple[dict, np.ndarray]:
    """Build from (T, 3, 3) float vertices.

    Returns (nodes dict of numpy arrays {nmin,nmax,start,count,skip},
    permutation (T,) such that leaf ranges index permuted triangles).
    """
    tri_v = np.asarray(tri_v, dtype=np.float64)
    T = tri_v.shape[0]
    tmin = tri_v.min(axis=1)                      # (T, 3) per-tri AABB
    tmax = tri_v.max(axis=1)
    centers = tri_v.mean(axis=1)                  # reference centroid (scene.cpp:197)

    # three axis orderings of the full set, maintained by stable partition
    lists = [np.argsort(centers[:, a], kind="stable") for a in range(3)]

    nmin_l: list = []
    nmax_l: list = []
    start_l: list = []
    count_l: list = []
    skip_l: list = []
    perm_chunks: list = []
    perm_offset = 0

    # explicit stack of (ids_by_axis, phase); phase "post" entries patch skip
    stack: list = [(lists, False, None)]
    while stack:
        item = stack.pop()
        if item[1]:  # post-visit: set skip to the next emitted node index
            skip_l[item[2]] = len(nmin_l)
            continue
        ids3, _, _ = item
        ids0 = ids3[0]
        n = len(ids0)
        node = len(nmin_l)
        nmin_l.append(tmin[ids0].min(axis=0) - aabb_pad)
        nmax_l.append(tmax[ids0].max(axis=0) + aabb_pad)
        skip_l.append(-1)
        stack.append((None, True, node))

        if n <= leaf_size:
            nonlocal_start = perm_offset
            perm_chunks.append(ids0)
            perm_offset += n
            start_l.append(nonlocal_start)
            count_l.append(n)
            continue
        start_l.append(0)
        count_l.append(0)

        # full-sweep SAH over all 3 axes (reference bvh.cpp:52-131)
        best_cost = np.inf
        best_axis = 0
        best_split = n // 2
        for a in range(3):
            ids = ids3[a]
            lo = tmin[ids]                         # (n, 3) in axis order
            hi = tmax[ids]
            pre_min = np.minimum.accumulate(lo, axis=0)
            pre_max = np.maximum.accumulate(hi, axis=0)
            suf_min = np.minimum.accumulate(lo[::-1], axis=0)[::-1]
            suf_max = np.maximum.accumulate(hi[::-1], axis=0)[::-1]

            def sa(mn, mx):
                d = mx - mn
                return 2.0 * (d[:, 0] * d[:, 1] + d[:, 0] * d[:, 2] + d[:, 1] * d[:, 2])

            left_sa = sa(pre_min[:-1], pre_max[:-1])        # split after i
            right_sa = sa(suf_min[1:], suf_max[1:])
            counts = np.arange(1, n)
            cost = left_sa * counts + right_sa * (n - counts)
            i = int(np.argmin(cost))
            if cost[i] < best_cost:
                best_cost = cost[i]
                best_axis = a
                best_split = i                     # left = [0..i] of this axis order

        left_ids = ids3[best_axis][: best_split + 1]
        member = np.zeros(T, dtype=bool)
        member[left_ids] = True
        left3 = []
        right3 = []
        for a in range(3):
            ids = ids3[a]
            m = member[ids]
            left3.append(ids[m])
            right3.append(ids[~m])
        # preorder: left subtree first -> push right, then left
        stack.append((right3, False, None))
        stack.append((left3, False, None))

    perm = np.concatenate(perm_chunks) if perm_chunks else np.arange(0)
    nodes = dict(
        nmin=np.asarray(nmin_l, dtype=np.float32),
        nmax=np.asarray(nmax_l, dtype=np.float32),
        start=np.asarray(start_l, dtype=np.int32),
        count=np.asarray(count_l, dtype=np.int32),
        skip=np.asarray(skip_l, dtype=np.int32),
    )
    return nodes, perm.astype(np.int64)


@spanned("scene.sah")
def build_bvh_host(
    tri_v: np.ndarray, leaf_size: int = 8, aabb_pad: float = 1e-3
) -> tuple[dict, np.ndarray]:
    """Builder dispatch: the native C++ builder, else (no g++ here, logged
    once) the numpy one. Returns (nodes dict incl. 'leaf_size', 'aabb_pad'
    and 'builder' ("native" or "numpy"), permutation)."""
    from tinyraytracing_tpu_torch.native import (
        BuildError, build_bvh_native, log_fallback,
    )

    try:
        nodes, perm = build_bvh_native(np.asarray(tri_v), leaf_size, aabb_pad)
        nodes["builder"] = "native"
    except BuildError as e:
        log_fallback(e)
        nodes, perm = build_bvh(np.asarray(tri_v), leaf_size, aabb_pad)
        nodes["builder"] = "numpy"
    nodes["leaf_size"] = leaf_size
    nodes["aabb_pad"] = aabb_pad
    return nodes, perm


def refit_metadata(nodes, T: int) -> dict:
    """The static topology ``diff/refit.py`` sweeps (numpy): ``tri_leaf``
    (T,) the leaf node of each permuted triangle, ``level`` (N,) each
    node's depth, ``child_l``/``child_r`` (N,) an internal node's children
    (i + 1 and skip[i + 1]; -1 at leaves), ``n_levels``."""
    count = np.asarray(nodes["count"])
    start = np.asarray(nodes["start"])
    skip = np.asarray(nodes["skip"])
    N = len(count)
    tri_leaf = np.zeros(T, np.int32)
    for i in np.nonzero(count > 0)[0]:
        tri_leaf[start[i]:start[i] + count[i]] = i
    level = np.zeros(N, np.int32)
    child_l = np.full(N, -1, np.int32)
    child_r = np.full(N, -1, np.int32)
    for i in np.nonzero(count == 0)[0]:      # preorder: parents come first
        l, r = i + 1, int(skip[i + 1])
        child_l[i], child_r[i] = l, r
        level[l] = level[r] = level[i] + 1
    return dict(tri_leaf=tri_leaf, level=level, child_l=child_l,
                child_r=child_r, n_levels=int(level.max()) + 1 if N else 1)


def attach_bvh(scene, config: RenderConfig):
    """Build a BVH for ``scene`` and return a new Scene (on the same device)
    with (a) triangles permuted to leaf order and (b) scene.bvh set, with
    its refit metadata (``refit_metadata``). Geometry is read back to the
    host for the build."""
    from tinyraytracing_tpu_torch.models.scene import BVHArrays

    host = lambda t: t.detach().cpu().numpy()
    v = np.stack([host(scene.v0), host(scene.v1), host(scene.v2)], axis=1)
    nodes, perm = build_bvh_host(v, config.leaf_size, config.aabb_pad)

    def p(t):
        return host(t)[perm]

    with span("scene.pack"):
        packed = pack_bvh_leaves(
            nodes, p(scene.woop_a), p(scene.woop_b), p(scene.gn),
            p(scene.tri_emissive), config.leaf_size,
            n0=p(scene.n0), n1=p(scene.n1), n2=p(scene.n2),
            t0=p(scene.t0), t1=p(scene.t1), t2=p(scene.t2),
            mtl=p(scene.tri_mtl),
        )
        bvh = BVHArrays.from_nodes(nodes, packed, config.leaf_size,
                                   config.aabb_pad)
        meta = refit_metadata(nodes, len(perm))
        bvh = dataclasses.replace(
            bvh, n_levels=meta.pop("n_levels"),
            **{k: torch.from_numpy(a) for k, a in meta.items()})
        inv_perm = np.empty(len(perm), np.int64)
        inv_perm[np.asarray(perm)] = np.arange(len(perm))
    dev = scene.v0.device
    fields = ("v0", "v1", "v2", "n0", "n1", "n2", "t0", "t1", "t2", "gn",
              "woop_a", "woop_b", "tri_mtl", "tri_emissive")
    if scene.vertex_index is not None:
        fields += ("vertex_index",)
    with span("scene.upload"):
        moved = {f: torch.from_numpy(p(getattr(scene, f))).to(dev) for f in fields}
        lt_tri = inv_perm[host(scene.lt_tri)].astype(np.int32)
        return dataclasses.replace(
            scene, **moved, lt_tri=torch.from_numpy(lt_tri).to(dev),
            bvh=bvh.to(dev),
        )


def widen_bvh(nodes, arity: int = 8):
    """Collapse the binary skip-link tree into ``arity``-wide nodes.

    Collapse rule: starting from a binary internal node's two children,
    repeatedly expand the child with the LARGEST subtree until ``arity``
    children are reached. Children keep their binary node's padded AABB,
    ordered by binary preorder, so a stack walk that pushes children in
    reverse order pops them in the skip-link walk's order.

    Returns (wide (n_wide, 128) float32, depth, bnode_map):
      lane c*8+k of a row = child c's [x0 y0 z0 x1 y1 z1 meta pad]
      meta >= 0: wide-node index of an internal child;
      meta <= -2: -(leaf_id*64 + count + 2) — leaf block id into
        PackedLeaves plus the leaf's occupied slot count;
      meta == -1: empty slot (box is zeroed, never acted on).
    bnode_map (n_wide, 8) int32: the binary node behind each child slot
    (-1 empty), through which ``diff/refit.py`` rewrites child boxes.
    A tree whose root is a leaf becomes one wide node with that leaf as
    its only child.
    """
    count = np.asarray(nodes["count"])
    skip = np.asarray(nodes["skip"])
    nmin = np.asarray(nodes["nmin"], np.float32)
    nmax = np.asarray(nodes["nmax"], np.float32)
    N = len(count)
    leaf_mask = count > 0
    leaf_id = np.full(N, -1, np.int64)
    leaf_id[np.nonzero(leaf_mask)[0]] = np.arange(int(leaf_mask.sum()))
    sub_size = skip - np.arange(N)           # subtree node count

    rows: list = []          # list of per-wide-node child lists
    meta_patch: list = []    # (wide_idx, child_slot, binary_node) to patch
    wide_of: dict = {}       # binary internal node -> wide index

    def leaf_meta(c):
        return -(int(leaf_id[c]) * 64 + int(count[c]) + 2)

    if N == 1 or leaf_mask[0]:
        # degenerate: root is a leaf — one wide node with one leaf child
        rows.append([(0, leaf_meta(0))])
        depth = 1
    else:
        stack = [(0, 1)]     # (binary internal node, depth)
        depth = 1
        while stack:
            b, d = stack.pop()
            depth = max(depth, d)
            kids = [b + 1, int(skip[b + 1])]
            while len(kids) < arity:
                # expand the internal child with the largest subtree
                best = -1
                best_sz = 0
                for i, c in enumerate(kids):
                    if not leaf_mask[c] and sub_size[c] > best_sz:
                        best, best_sz = i, int(sub_size[c])
                if best < 0:
                    break
                c = kids.pop(best)
                kids.extend([c + 1, int(skip[c + 1])])
            kids.sort()      # binary preorder == front-to-back walk order
            wi = len(rows)
            wide_of[b] = wi
            row = []
            for c in kids:
                if leaf_mask[c]:
                    row.append((c, leaf_meta(c)))
                else:
                    meta_patch.append((wi, len(row), c))
                    row.append((c, None))
                    stack.append((c, d + 1))
            rows.append(row)
        for wi, slot, c in meta_patch:
            b_node, _ = rows[wi][slot]
            rows[wi][slot] = (b_node, wide_of[c])

    n_wide = len(rows)
    wide = np.zeros((n_wide, 128), np.float32)
    wide[:, 6:64:8] = -1.0  # empty slots (kernel gates pushes on meta != -1,
    #                         so the zero box contents are never acted on)
    bnode_map = np.full((n_wide, arity), -1, np.int32)
    for wi, row in enumerate(rows):
        for c_slot, (b_node, meta) in enumerate(row):
            o = c_slot * 8
            wide[wi, o:o + 3] = nmin[b_node]
            wide[wi, o + 3:o + 6] = nmax[b_node]
            wide[wi, o + 6] = np.float32(meta)
            bnode_map[wi, c_slot] = b_node
    return wide, int(depth), bnode_map


def pack_bvh_leaves(nodes, woop_a, woop_b, gn, emissive, leaf_size,
                    n0=None, n1=None, n2=None, t0=None, t1=None, t2=None,
                    mtl=None):
    """Leaf-block payload for the trace kernels (layouts documented on
    models.scene.PackedLeaves); returns a PackedLeaves of host tensors.

    Every leaf gets one 128-lane block with 32 triangle slots (leaf_size
    must be <= 32); slots beyond the leaf's count hold all-zero Woop rows
    that can never hit. Inputs are the PERMUTED per-triangle arrays
    (numpy, host side).

    The optional shading arrays (per-vertex normals (T, 3), texcoords
    (T, 2), material id (T,)) fill the S rows of the fused-trace payload
    ``PS``; when omitted they are zeros.
    """
    from tinyraytracing_tpu_torch.models.scene import PackedLeaves

    if leaf_size > 32:
        raise ValueError(f"packed leaves hold leaf_size <= 32, got {leaf_size}")
    SLOT = 32
    count = nodes["count"]
    start = nodes["start"]
    skip = nodes["skip"]
    N = len(count)
    leaf_nodes = np.nonzero(count > 0)[0]
    n_leaves = len(leaf_nodes)
    n_blk = max(n_leaves, 1)
    S = n_blk * SLOT

    slot_tri = np.full(S, -1, np.int64)
    leaf_id = np.full(N, -1, np.int32)
    for k, ln in enumerate(leaf_nodes):
        leaf_id[ln] = k
        c = count[ln]
        slot_tri[k * SLOT : k * SLOT + c] = np.arange(start[ln], start[ln] + c)

    valid = slot_tri >= 0
    idx = np.where(valid, slot_tri, 0)
    wa = np.where(valid[:, None, None], np.asarray(woop_a, np.float64)[idx], 0.0)
    wb = np.where(valid[:, None], np.asarray(woop_b, np.float64)[idx], 0.0)
    g = np.where(valid[:, None], np.asarray(gn, np.float64)[idx], 0.0)
    em = np.where(valid, np.asarray(emissive)[idx], False)

    # 16 per-slot attributes, 4 per row x 4 rows; attr a of slot s sits at
    # (row a//4, lane (a%4)*32 + s) in the leaf's (4, 128) block:
    #   [ax ay az bx | by bz cx cy | cz ou ov ow | gx gy gz em]
    # where (a,b,c) are the Woop u/v/w rows, o* the offsets, g* the
    # geometric normal (grazing cull), em the emissive flag (tie-break).
    wa_l = wa.reshape(n_blk, SLOT, 3, 3)
    wb_l = wb.reshape(n_blk, SLOT, 3)
    g_l = g.reshape(n_blk, SLOT, 3)
    attrs = [
        wa_l[:, :, 0, 0], wa_l[:, :, 0, 1], wa_l[:, :, 0, 2], wa_l[:, :, 1, 0],
        wa_l[:, :, 1, 1], wa_l[:, :, 1, 2], wa_l[:, :, 2, 0], wa_l[:, :, 2, 1],
        wa_l[:, :, 2, 2], wb_l[:, :, 0], wb_l[:, :, 1], wb_l[:, :, 2],
        g_l[:, :, 0], g_l[:, :, 1], g_l[:, :, 2],
        em.reshape(n_blk, SLOT).astype(np.float64),
    ]
    P = np.zeros((n_blk, 4, 128), np.float32)
    for a, col in enumerate(attrs):
        P[:, a // 4, (a % 4) * SLOT : (a % 4 + 1) * SLOT] = col
    P_t = P.transpose(1, 0, 2).reshape(4, n_blk * 128)

    # S rows of the fused-trace payload: shading normals, texcoords, mtl id
    def lane(tab, comp=None):
        a = np.asarray(tab, np.float64)
        a = a[idx] if comp is None else a[idx, comp]
        return np.where(valid, a, 0.0).reshape(n_blk, SLOT)

    zeros = np.zeros((n_blk, SLOT))
    s_attrs = [
        lane(n0, 0) if n0 is not None else zeros,
        lane(n0, 1) if n0 is not None else zeros,
        lane(n0, 2) if n0 is not None else zeros,
        lane(n1, 0) if n1 is not None else zeros,
        lane(n1, 1) if n1 is not None else zeros,
        lane(n1, 2) if n1 is not None else zeros,
        lane(n2, 0) if n2 is not None else zeros,
        lane(n2, 1) if n2 is not None else zeros,
        lane(n2, 2) if n2 is not None else zeros,
        lane(t0, 0) if t0 is not None else zeros,
        lane(t0, 1) if t0 is not None else zeros,
        lane(t1, 0) if t1 is not None else zeros,
        lane(t1, 1) if t1 is not None else zeros,
        lane(t2, 0) if t2 is not None else zeros,
        lane(t2, 1) if t2 is not None else zeros,
        lane(mtl) if mtl is not None else zeros,
    ]
    Sb = np.zeros((n_blk, 4, 128), np.float32)
    for a, col in enumerate(s_attrs):
        Sb[:, a // 4, (a % 4) * SLOT : (a % 4 + 1) * SLOT] = col
    S_t = Sb.transpose(1, 0, 2).reshape(4, n_blk * 128)
    PS = np.concatenate([P_t, S_t], axis=0)          # (8, n_blk*128)

    node_box = np.zeros((N, 8), np.float32)
    node_box[:, 0:3] = nodes["nmin"]
    node_box[:, 3:6] = nodes["nmax"]
    # cols 6/7: skip & the leaf encoding as exact f32 so the HBM-node
    # fused-kernel variant fetches a whole node in one (8,) DMA. Leaves
    # encode leaf_id*64 + occupied-slot count (same scheme as the wide
    # meta) so the binary walk can skip empty slot groups too; internal
    # nodes stay -1.
    leaf_enc = np.where(
        count > 0, leaf_id.astype(np.int64) * 64 + count, -1
    ).astype(np.int32)
    node_box[:, 6] = skip.astype(np.float32)
    node_box[:, 7] = leaf_enc.astype(np.float32)
    node_meta = np.stack([skip.astype(np.int32), leaf_enc], axis=1)

    wide, wide_depth, wn_bnode = widen_bvh(nodes)

    t = torch.from_numpy
    return PackedLeaves(
        P=t(P_t),
        tid=t(np.where(valid, slot_tri, 0).astype(np.int32)),
        node_box=t(node_box),
        node_meta=t(node_meta),
        PS=t(PS),
        WN=t(wide),
        n_nodes=int(N), n_leaves=int(n_blk), leaf_size=int(leaf_size),
        n_wide=int(wide.shape[0]), wide_depth=int(wide_depth),
        wn_bnode=t(wn_bnode), slot_valid=t(valid),
    )
