"""An emulation of the slot kernel's fold (csrc/slot_intersect.cu) for the
CPU tests, and a scene built for ties.

``emulate`` computes what the kernel computes, vectorised over rays: each
ray tests the 32 slots of a chunk in slot order (the same float32
operations as ``slot_intersect_plain``, ``ops/slot_test.py``) and keeps
the least t of its accepted slots (with its u, v, em and slot) and the
next; at the chunk's end, with the carry in front, the least m and the
next s2, and it takes m where s2 > fl(m * eps1) (m >= 0, eps1 >= 1), else
replays the chunk's accepted slots in slot order from the carry. A slot
whose ldw lies outside the range of the kernel's fast reciprocal
(``slow``) sends its chunk to the replay too, and is tested there.
``merge_split`` takes the shortcut the kernel must not take: the slots
split into interleaved groups, each folded into a partial best, and the
partial bests merged in group order.

``tie_scene`` is a scene of horizontal triangles in nine regions, coplanar
or nearly so within each region, some emissive, at slots chosen so that
the tied ones fall next to each other, apart in one chunk, or in
different chunks (``TIE_WINNERS``: the slot each region's rays must hit).
Region 4 holds the tie band's counterexample to transitivity: a (t, not
emissive), b (t(1 + 1.5e), emissive) and c (t(1 + 0.8e), emissive),
e = tie_eps, in that order, with b and c in one group of 2, 4 or 8
interleaved groups. ``tie_rays`` aim at every region from below,
``tie_shadow_rays`` at the scene's light triangles. It imports only torch
and the port, so ``chip_smoke.py`` uses it too.
"""

from __future__ import annotations

import numpy as np
import torch

from tinyraytracing_tpu_torch.config import RenderConfig
from tinyraytracing_tpu_torch.io.mtl import MaterialSpec
from tinyraytracing_tpu_torch.io.objmesh import MeshArrays
from tinyraytracing_tpu_torch.io.xmlscene import LightSpec, SceneConfig
from tinyraytracing_tpu_torch.models.camera import Camera
from tinyraytracing_tpu_torch.models.scene import assemble_scene
from tinyraytracing_tpu_torch.ops.slot_test import (
    SLOT, init_best, slot_replaces, tie_band, woop_slot_test,
)

_INF = 3.0e38


def emulate(P, n_tri, rays, config: RenderConfig, *, stats: dict | None = None):
    """The kernel's (t, idx, u, v) for the (6, R) ``rays`` and payload
    ``P``. ``stats`` (if given) gains, over the (ray, chunk) pairs with an
    accepted slot, how many took the least t ("fast") and how many were
    replayed ("replayed")."""
    R = rays.shape[1]
    n_chunks = P.shape[1] // 128
    eps1 = tie_band(config, rays.device)
    col = lambda x: x[:, None]
    o, d = tuple(map(col, rays[:3])), tuple(map(col, rays[3:6]))
    lane = torch.arange(SLOT)
    best = list(init_best(R, rays.device))              # bt, bi, bu, bv, be
    for ch in range(n_chunks):
        blk = P[:, ch * 128:(ch + 1) * 128]
        g = lambda a: blk[a // 4, (a % 4) * SLOT:(a % 4 + 1) * SLOT][None, :]
        tm, u, v = woop_slot_test(g, o, d, config)     # (R, 32)
        em = g(15).expand_as(tm)
        ldw = d[0] * g(6) + d[1] * g(7) + d[2] * g(8)
        slow = ((ldw != 0) & ~fast_reciprocal(ldw)).any(dim=1)
        acc = tm < _INF
        # the least accepted t (the first slot of it) and the next
        m1, s1 = tm.min(dim=1)
        m2 = tm.sort(dim=1).values[:, 1]
        m1 = torch.where(slow, -_INF, m1)
        bt = best[0]
        m = torch.minimum(bt, m1)
        s2 = torch.minimum(torch.maximum(bt, m1), m2)
        any_ = m1 < _INF
        fast = (s2 > m * eps1) & (m >= 0) & bool(eps1 >= 1)
        take = any_ & fast & (m1 < bt)
        at = lambda x: x.gather(1, s1[:, None])[:, 0]
        slot_id = (ch * SLOT + s1).to(torch.float32)
        for i, x in enumerate((m1, slot_id, at(u), at(v), at(em))):
            best[i] = torch.where(take, x, best[i])
        # the rest: the chunk's accepted slots in slot order, from the carry
        replay = any_ & ~fast
        if stats is not None:
            stats["fast"] = stats.get("fast", 0) + int((any_ & fast).sum())
            stats["replayed"] = stats.get("replayed", 0) + int(replay.sum())
        for s in range(SLOT):
            _apply(best, replay & acc[:, s], tm[:, s], em[:, s], u[:, s],
                   v[:, s], torch.full((R,), float(ch * SLOT + s)), eps1)
    bt, bi, bu, bv, _ = best
    return bt, torch.clamp_max(bi.to(torch.int32), n_tri - 1), bu, bv


def merge_split(P, n_tri, rays, config: RenderConfig, parts: int):
    """The shortcut: slot s of every chunk in group s % ``parts``, each
    group folded in slot order into its own best, and the groups' bests
    merged in group order. Returns (t, idx, u, v) as ``emulate``."""
    R = rays.shape[1]
    eps1 = tie_band(config, rays.device)
    col = lambda x: x[:, None]
    o, d = tuple(map(col, rays[:3])), tuple(map(col, rays[3:6]))
    part = [list(init_best(R, rays.device)) for _ in range(parts)]
    for ch in range(P.shape[1] // 128):
        blk = P[:, ch * 128:(ch + 1) * 128]
        g = lambda a: blk[a // 4, (a % 4) * SLOT:(a % 4 + 1) * SLOT][None, :]
        tm, u, v = woop_slot_test(g, o, d, config)
        em = g(15).expand_as(tm)
        for s in range(SLOT):
            _apply(part[s % parts], tm[:, s] < _INF, tm[:, s], em[:, s],
                   u[:, s], v[:, s], torch.full((R,), float(ch * SLOT + s)),
                   eps1)
    best = part[0]
    for bt, bi, bu, bv, be in part[1:]:
        _apply(best, bt < _INF, bt, be, bu, bv, bi, eps1)
    bt, bi, bu, bv, _ = best
    return bt, torch.clamp_max(bi.to(torch.int32), n_tri - 1), bu, bv


def fast_reciprocal(x):
    """Where the kernel's rcp_fast is exact: the biased exponent of x is
    not 0 (zero, denormal), 253, 254 (|x| >= 2^126) or 255 (inf, NaN)."""
    e = (x.contiguous().view(torch.int32) >> 23) & 0xFF
    return (e != 0) & (e < 253)


def extreme_payload(P):
    """A copy of the payload ``P`` in which three of every four slots have
    their w row and offset (cx, cy, cz, ow) scaled by 2^-140, 2^-127 or
    2^140: ldw falls outside the fast reciprocal's range (or the row
    overflows), and the kernel takes its slow path there."""
    P = P.clone()
    n = P.shape[1] // 128
    for k, scale in ((1, 2.0 ** -140), (2, 2.0 ** -127), (3, 2.0 ** 140)):
        for a in (6, 7, 8, 11):                       # cx cy cz ow
            row = P[a // 4].view(n, 4, 32)[:, a % 4]
            row[:, k::4] = (row[:, k::4].double() * scale).float()
    return P


def _apply(best, mask, tm, em, u, v, slot_id, eps1):
    """Fold one slot per ray into the running best where ``mask``."""
    bt, bi, bu, bv, be = best
    repl = mask & slot_replaces(tm, em, bt, be, eps1)
    for i, x in enumerate((tm, slot_id, u, v, em)):
        best[i] = torch.where(repl, x, best[i])


# ---------------------------------------------------------------------------
# a scene built for ties
# ---------------------------------------------------------------------------

_H, _E = 100.0, RenderConfig().tie_eps      # layer height, the tie band
_FILL = 40                                   # triangles: chunk 1 is partial
# region: [(slot, height, emissive)], the slot the region's rays must hit
TIE_LAYERS = {
    0: [(1, _H, False), (2, _H, True)],        # adjacent, emissive second
    1: [(3, _H, True), (6, _H, True)],         # two emissive: the first
    2: [(8, _H, True), (13, _H, False)],       # emissive first, apart
    3: [(9, _H, False), (10, _H, False)],      # adjacent, neither emissive
    4: [(16, _H, False), (17, _H * (1 + 1.5 * _E), True),
        (25, _H * (1 + 0.8 * _E), True)],      # a, b, c: b and c one group
    5: [(30, _H, False), (33, _H, True)],      # across chunks
    6: [(31, _H, True), (35, _H, False)],      # across chunks, emissive first
    7: [(5, _H, False), (39, 0.8 * _H, False)],  # closer, in the last slot
    8: [(38, _H, False)],                      # alone
}
TIE_WINNERS = {0: 2, 1: 3, 2: 8, 3: 9, 4: 25, 5: 33, 6: 31, 7: 39, 8: 38}
_SPAN = 10.0     # the rays aim inside +-_SPAN of a region's centre


def _center(region):
    return 100.0 * region, 0.0


def tie_scene(device="cuda"):
    """(scene, camera): ``_FILL`` triangles in slot order (no BVH, so the
    slots are the triangles' own order), the layers of ``TIE_LAYERS``
    and, at the other slots, small far triangles that no ray here hits.
    The camera looks up at the layers from below."""
    tris, mtl = [], []
    layer = {s: (reg, h, em) for reg, ls in TIE_LAYERS.items()
             for s, h, em in ls}
    for s in range(_FILL):
        if s in layer:
            reg, h, em = layer[s]
            x, z = _center(reg)
            tris.append([(x - 30, h, z - 30), (x + 60, h, z - 30),
                         (x - 30, h, z + 60)])
            mtl.append(1 if em else 0)
        else:
            x = -5000.0 + 10.0 * s
            tris.append([(x, 50.0, 5000.0), (x + 5, 50.0, 5000.0),
                         (x, 55.0, 5000.0)])
            mtl.append(0)
    v = np.asarray(tris, np.float64)
    n = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    mesh = MeshArrays(v=v, vn=np.repeat(n[:, None], 3, axis=1),
                      vt=np.zeros((len(v), 3, 2)), normal=n,
                      center=v.mean(axis=1), mtl=np.asarray(mtl, np.int32),
                      mtl_names=["Wall", "Lamp"])
    cfg = SceneConfig(width=256, height=24, fovy=12.0,
                      eye=(400.0, -300.0, 0.0), lookat=(400.0, 100.0, 0.0),
                      up=(0.0, 0.0, 1.0),
                      lights=[LightSpec("Lamp", (10.0, 10.0, 10.0))])
    mats = {"Wall": MaterialSpec("Wall", kd=(0.5, 0.5, 0.5)),
            "Lamp": MaterialSpec("Lamp")}
    scene = assemble_scene(cfg, mesh, mats, device=device)
    cam = Camera.create(cfg.eye, cfg.lookat, cfg.up, cfg.fovy, cfg.width,
                        cfg.height)
    return scene, cam


def tie_rays(per_region=64, seed=0, device="cuda"):
    """(6, 9 * per_region) float32 rays, ``per_region`` for each region in
    order: origins on y = 0 below the region, aimed up at points inside
    it, from numpy's generator ``seed``."""
    rng = np.random.default_rng(seed)
    rays = []
    for reg in sorted(TIE_LAYERS):
        x, z = _center(reg)
        o = np.stack([x + rng.uniform(-_SPAN, _SPAN, per_region),
                      np.zeros(per_region),
                      z + rng.uniform(-_SPAN, _SPAN, per_region)], 1)
        aim = np.stack([x + rng.uniform(-_SPAN, _SPAN, per_region),
                        np.full(per_region, _H),
                        z + rng.uniform(-_SPAN, _SPAN, per_region)], 1)
        d = aim - o
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        rays.append(np.concatenate([o, d], 1))
    r = np.concatenate(rays).astype(np.float32).T
    return torch.from_numpy(np.ascontiguousarray(r)).to(device)


def tie_shadow_rays(scene, n, seed=0, device="cuda"):
    """(6, n) float32 shadow rays of the tie scene ``scene``: each toward a
    uniform point of one of its light's triangles (the emissive layers of
    ``TIE_LAYERS``, each tied with another), from below it on y = 0, off
    by up to +-_SPAN in x and z; from numpy's generator ``seed``."""
    rng = np.random.default_rng(seed)
    K = scene.lt_counts[0]
    k = rng.integers(0, K, n)
    v = [x[0, :K].cpu().numpy().astype(np.float64)[k]
         for x in (scene.lt_v0, scene.lt_v1, scene.lt_v2)]
    b = rng.uniform(size=(n, 3))
    b /= b.sum(1, keepdims=True)
    aim = b[:, :1] * v[0] + b[:, 1:2] * v[1] + b[:, 2:] * v[2]
    o = aim + rng.uniform(-_SPAN, _SPAN, (n, 3)) * [1.0, 0.0, 1.0]
    o[:, 1] = 0.0
    d = aim - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    r = np.concatenate([o, d], 1).astype(np.float32).T
    return torch.from_numpy(np.ascontiguousarray(r)).to(device)
