"""The plain reference for gradients in a mesh's shared vertex positions,
in plain PyTorch beside ``core/reference.py``, whose helpers it uses; it
imports nothing of the program.

The method is the mesh refinement of Nicolet, Jacobson and Jakob, "Large
Steps in Inverse Rendering of Geometry" (ACM TOG 40(6), 2021): Adam on the
shared vertex positions of a triangle mesh against rendered target
images. A raw scene of ``scenes/height_grid.py`` names its mesh
(``vertex_positions``, ``vertex_index``, ``mesh_range``); the offsets
(V, 3) move it:

- corner k of mesh triangle i is ``v[index[i, k]] + offset[index[i, k]]``,
  with gradient, in float32 (``v`` rounded) and in float64 (``v`` as
  given); triangles outside the mesh do not move;
- every mesh triangle shades with the unit normal of its moved float64
  face, rounded to float32 (flat shading), with gradient;
- the hit tables (each triangle's affine rows) are rebuilt from the moved
  float64 corners, without gradient, and rounded to float32; hits are
  found by brute force, each (ray, triangle) test summed term by term in
  x, y, z order; a hit's distance and barycentrics are the Moller-Trumbore
  functions of the ray and the moved float32 corners, with gradient, as
  ``core/reference.py`` defines them for per-triangle offsets.

Departures from the published method: no Laplacian reparameterisation
(the preconditioner's sparse solve is left out: plain Adam); flat normals
only; the interior term of the gradient only (no silhouette edges).

The search skips, for each block of triangles, the rays that do not meet
the block's box: the box of the block's moved float64 corners, padded by
``PAD``, met by the ray's float64 slab test over the ray's whole range.
A triangle the search could accept lies inside the box, so no hit is
lost: the cull is exact. Blocks are runs of the triangles in Morton order
of their centroids; triangles far larger than the median (the box's walls,
the light) form a block of their own, so that they do not swell the
others' boxes. No matrix product: each test is summed term by term.
"""

from __future__ import annotations

import math

import torch

from core import reference, rng
from core.reference import (
    CAMERA, INVALID, TRANSMISSION, _const, _dot, _f64fn, _hit_terms, _moller_trumbore,
    _next_direction, _normalize, camera_rays,
)

BLOCK = 1024          # triangles a block of the culled search
PAD = 1e-2            # box padding, in scene units (a grid cell is ~2.2)
BIG = 16.0            # a triangle whose box is BIG times the median one's is "large"


class MeshRefScene(reference.RefScene):
    """A raw scene with a mesh as the reference's tables, in ``dtype``,
    and the mesh's corners moved by ``move``."""

    def __init__(self, raw: dict, device, dtype=torch.float32):
        super().__init__(raw, device, dtype)
        dev = self.device
        self.tri = torch.arange(*raw["mesh_range"], device=dev)
        self.index = torch.as_tensor(raw["vertex_index"], dtype=torch.int64, device=dev)
        self.pos64 = reference._f64(raw["vertex_positions"], dev)
        self.pos = self.pos64.to(torch.float32)
        self.vn0 = self.vn
        self.gn0 = self.gn
        self.verts = self.v

    def move(self, offset: torch.Tensor | None):
        """Move the mesh by ``offset`` (V, 3) float32 (None: unmoved):
        ``verts`` and ``vn`` with gradient, the hit tables and the
        search's normals without."""
        if offset is None:
            self.verts, self.vn, self.gn = self.v, self.vn0, self.gn0
            self.set_geometry(self.v64)
            return
        idx = self.index
        verts = self.v.index_put((self.tri,), self.pos[idx] + offset[idx])
        c64 = self.pos64[idx] + offset.double()[idx]                 # (Tm, 3, 3)
        gn = _normalize(reference._cross(c64[:, 1] - c64[:, 0], c64[:, 2] - c64[:, 0])).float()
        vn = self.vn0.index_put((self.tri,), gn.to(self.dtype)[:, None, :].expand(-1, 3, -1))
        self.verts, self.vn = verts, vn
        self.gn = self.gn0.index_put((self.tri,), gn.detach().to(self.dtype))
        self.set_geometry(self.v64.index_put((self.tri,), c64.detach()))

    def set_geometry(self, v: torch.Tensor):
        """The hit tables for float64 corners ``v`` (each triangle's affine
        rows [a; b; c | offsets], worked out term by term in float64 and
        rounded), and the culled search's blocks and padded boxes."""
        with torch.no_grad():
            e1, e2 = v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]
            n = reference._cross(e1, e2)
            det = _dot(n, n)
            safe = det > 1e-24
            one = torch.ones_like(det)
            inv = torch.where(safe, one / torch.where(safe, det, one), torch.zeros_like(det))
            rows = torch.stack([reference._cross(e2, n), reference._cross(n, e1), n], 1)
            rows = rows * inv[:, None, None]
            off = -(rows[:, :, 0] * v[:, None, 0, 0] + rows[:, :, 1] * v[:, None, 0, 1]
                    + rows[:, :, 2] * v[:, None, 0, 2])
            self.rows_o = torch.cat([rows, off[:, :, None]], 2).to(self.dtype)  # (T, 3, 4)
            self.rows_d = rows.to(self.dtype)
            lo, hi = v.amin(1), v.amax(1)                            # (T, 3)
            if not hasattr(self, "blocks"):
                self.blocks = _blocks(lo, hi)
            self.box_lo = torch.stack([lo[b].amin(0) for b in self.blocks]) - PAD
            self.box_hi = torch.stack([hi[b].amax(0) for b in self.blocks]) + PAD


def _blocks(lo, hi) -> list[torch.Tensor]:
    """Triangle ids in blocks: the large ones alone, then runs of ``BLOCK``
    in Morton order of the box centres."""
    size = (hi - lo).norm(dim=1)
    big = size > BIG * size.median()
    c = 0.5 * (lo + hi)
    q = ((c - c.amin(0)) / (c.amax(0) - c.amin(0)).clamp_min(1e-30) * 1023).long()
    code = torch.zeros_like(q[:, 0])
    for bit in range(10):
        for axis in range(3):
            code |= ((q[:, axis] >> bit) & 1) << (3 * bit + axis)
    small = torch.nonzero(~big).squeeze(1)
    order = small[torch.argsort(code[small], stable=True)]
    out = [torch.nonzero(big).squeeze(1)] if bool(big.any()) else []
    return out + list(order.split(BLOCK))


def _meets(scn, o, d, t_max):
    """(B, N) whether each ray (o, d over [0, t_max]) meets each block's
    padded box, by a float64 slab test."""
    o, d = o.double(), d.double()
    lo, hi = scn.box_lo, scn.box_hi                                  # (B, 3)
    near = torch.zeros((lo.shape[0], o.shape[0]), dtype=torch.float64, device=o.device)
    far = t_max.double()[None, :].expand_as(near).clone()
    for a in range(3):
        oa, da = o[None, :, a], d[None, :, a]
        flat = da == 0
        inv = 1.0 / torch.where(flat, torch.ones_like(da), da)
        t1, t2 = (lo[:, a:a + 1] - oa) * inv, (hi[:, a:a + 1] - oa) * inv
        inside = (lo[:, a:a + 1] <= oa) & (oa <= hi[:, a:a + 1])
        big = torch.tensor(math.inf, dtype=torch.float64, device=o.device)
        near = torch.maximum(near, torch.where(flat, torch.where(inside, -big, big),
                                               torch.minimum(t1, t2)))
        far = torch.minimum(far, torch.where(flat, torch.where(inside, big, -big),
                                             torch.maximum(t1, t2)))
    return near <= far


@torch.no_grad()
def search(scn: MeshRefScene, o, d, opts, bound=None, target=None):
    """``core.reference``'s closest hit (``target`` None: (t, triangle))
    or shadow visibility (``bound``, ``target``), over the blocks each ray
    meets; the same acceptance rule, tie band and tests."""
    dt, dev = scn.dtype, scn.device
    N = o.shape[0]
    big = torch.tensor(torch.finfo(dt).max, dtype=dt, device=dev)
    eps1 = torch.tensor(1.0 + opts["tie_eps"], dtype=dt, device=dev)
    o3, d3 = o.to(dt), d.to(dt)
    best_t = torch.full((N,), float(big), dtype=dt, device=dev)
    best_i = torch.full((N,), -1, dtype=torch.int64, device=dev)
    em_t, em_i = best_t.clone(), best_i.clone()
    budget = reference._pair_budget(dev)
    t_max = (bound.double() * (1.0 + opts["tie_eps"]) if bound is not None
             else torch.full((N,), math.inf, dtype=torch.float64, device=dev))
    step = max(1, budget // max(1, len(scn.blocks)))
    for r0 in range(0, N, step):
        rs = slice(r0, min(N, r0 + step))
        meets = _meets(scn, o[rs], d[rs], t_max[rs])
        for b, tris in enumerate(scn.blocks):
            ids = torch.nonzero(meets[b]).squeeze(1) + r0
            rb = max(1, budget // tris.numel())
            for c0 in range(0, ids.numel(), rb):
                r = ids[c0:c0 + rb]
                _pairs(scn, o3[r], d3[r], tris, opts, big, r, best_t, best_i, em_t, em_i,
                       None if target is None else target[r])
    if target is None:
        use_em = (em_t < big) & (em_t <= best_t * eps1)
        t = torch.where(use_em, em_t, best_t)
        tri = torch.where(use_em, em_i, best_i)
        return t, torch.where(t < big, tri, torch.full_like(tri, -1))
    t_g, t_w = best_t, em_t          # target material, any other material
    bound = bound.to(dt)
    return (t_g < big) & (t_g <= bound * eps1) & ~(t_w * eps1 < bound)


def _pairs(scn, o, d, tris, opts, big, r, best_t, best_i, em_t, em_i, target):
    """One block of rays ``r`` against the triangles ``tris``: the pair
    tests of ``core.reference._search`` with each sum taken term by term
    in x, y, z order (as ``core.reference._hit_terms`` takes them), folded
    into the running minima."""
    ro, gn = scn.rows_o[tris], scn.gn[tris]
    lin = lambda p, k, c: (p[:, None, 0] * ro[None, :, k, 0] + p[:, None, 1] * ro[None, :, k, 1]
                           + p[:, None, 2] * ro[None, :, k, 2] + c)
    ldw = lin(d, 2, 0.0)
    z = ldw == 0
    inv = torch.where(z, 0.0, 1.0).to(ldw.dtype) / torch.where(z, torch.ones_like(ldw), ldw)
    t = -lin(o, 2, ro[None, :, 2, 3]) * inv
    u = lin(o, 0, ro[None, :, 0, 3]) + t * lin(d, 0, 0.0)
    v = lin(o, 1, ro[None, :, 1, 3]) + t * lin(d, 1, 0.0)
    ndd = d[:, None, 0] * gn[None, :, 0] + d[:, None, 1] * gn[None, :, 1] + d[:, None, 2] * gn[None, :, 2]
    ok = ((ldw != 0) & (ndd.abs() >= opts["n_dot_d_min"])
          & (t >= opts["t_min"]) & (u >= 0) & (v >= 0) & (u + v <= 1))
    t = torch.where(ok, t, big)
    if target is None:
        for tt, bt, bi in ((t, best_t, best_i),
                           (torch.where(scn.em[tris][None, :], t, big), em_t, em_i)):
            m, i = tt.min(1)
            take = m < bt[r]
            bt[r] = torch.where(take, m, bt[r])
            bi[r] = torch.where(take, tris[i], bi[r])
    else:
        is_tgt = scn.mat[tris][None, :] == target[:, None]
        best_t[r] = torch.minimum(best_t[r], torch.where(is_tgt, t, big).min(1).values)
        em_t[r] = torch.minimum(em_t[r], torch.where(is_tgt, big, t).min(1).values)


def trace_paths(scn: MeshRefScene, cam: dict, key, path_ids, pix, opts: dict,
                kd=None):
    """Radiance (N, 3) and traced rays (N,) of the paths ``path_ids`` of
    pixels ``pix`` under master ``key``, on the mesh as ``scn.move`` left
    it: ``core.reference.trace_paths``'s estimator, with the moved corners
    and flat normals and the culled search. Differentiable in ``kd`` (the
    albedos; the loaded ones where None) and in the offsets given to
    ``move``."""
    dt, dev = scn.dtype, scn.device
    N = path_ids.shape[0]
    pk0, pk1 = rng.path_keys(key, path_ids.to(dev))
    o, d = camera_rays(cam, pk0, pk1, pix.to(dev), dt)
    thr = torch.ones((N, 3), dtype=dt, device=dev)
    rad = torch.zeros((N, 3), dtype=dt, device=dev)
    rays = torch.zeros(N, dtype=torch.int64, device=dev)
    rtype = torch.full((N,), CAMERA, dtype=torch.int64, device=dev)
    idx = torch.arange(N, device=dev)
    kd_tab = (kd if kd is not None else scn.kd0).to(dt)
    verts = scn.verts
    L = len(scn.lights)
    c = lambda x: _const(x, thr)
    inv_prr, pi, two_pi = c(1.0 / opts["p_rr"]), c(math.pi), c(2.0 * math.pi)
    for b in range(opts["max_depth"]):
        if idx.numel() == 0:
            break
        _, tri = search(scn, o.detach(), d.detach(), opts)
        rays[idx] += 1
        hit = tri >= 0
        ti = torch.clamp_min(tri, 0)
        t, u, v = _hit_terms(scn, o.detach(), d.detach(), ti)
        # forward values of the affine rows, gradients of Moller-Trumbore
        tv = verts[ti].to(dt)
        mt = _moller_trumbore(tv[:, 0], tv[:, 1], tv[:, 2], o, d)
        t, u, v = (x + (y - y.detach()) for x, y in zip((t, u, v), mt))
        t = torch.where(hit, t, torch.zeros_like(t))
        w = 1.0 - u - v
        vn = scn.vn[ti]
        pn = _normalize(vn[:, 0] * w[:, None] + vn[:, 1] * u[:, None] + vn[:, 2] * v[:, None])
        point = o + d * t[:, None]
        m = scn.mat[ti]
        hit_em = hit & scn.em[ti]
        emit = hit_em & ((rtype == CAMERA) | (rtype == TRANSMISSION))
        zero3 = torch.zeros_like(thr)
        gain = torch.where(emit[:, None], thr * scn.radiance[m], zero3)
        shade = hit & ~hit_em
        kdm, ks, ns, ni = kd_tab[m], scn.ks[m], scn.ns[m], scn.ni[m]
        draws = [x.to(dt) for x in rng.bounce_uniforms(pk0[idx], pk1[idx], b, 4 * L + 5)]
        wi = -d
        for l, light in enumerate(scn.lights):
            u_pick, u1, u2, u3 = draws[4 * l:4 * l + 4]
            rnd = u_pick * c(scn.nee_range)
            valid = rnd < c(light["area"])
            K = light["prefix"].shape[0]
            sel = torch.clamp_max((light["prefix"][None, :] <= rnd[:, None]).sum(1), K - 1)
            lt = light["tri"][sel]
            s = u1 + u2 + u3
            s = torch.where(s == 0, torch.ones_like(s), s)
            p1, p2, p3 = (u1 / s)[:, None], (u2 / s)[:, None], (u3 / s)[:, None]
            lv, ln = verts[lt].to(dt), scn.vn[lt]
            light_p = lv[:, 0] * p1 + lv[:, 1] * p2 + lv[:, 2] * p3
            light_n = _normalize(ln[:, 0] * p1 + ln[:, 1] * p2 + ln[:, 2] * p3)
            to_l = light_p - point
            r2 = torch.clamp_min(_dot(to_l, to_l), 1e-20)
            dist = torch.sqrt(r2)
            wo = to_l * torch.reciprocal(torch.clamp_min(dist, 1e-20))[:, None]
            cos_o = _dot(wo, pn)
            ok = shade & valid & (cos_o > 0)
            geom = _dot(wo, light_n).abs() * cos_o.abs() / r2 * c(light["area"])
            h = _normalize(wi + wo)
            cos_a = torch.clamp_min(_dot(pn, h), 0.0)
            phong = (ns + 2.0) * _f64fn(torch.pow, cos_a, ns) / two_pi
            contrib = light["radiance"][None] * geom[:, None] * (kdm / pi + ks * phong[:, None])
            vis = torch.zeros_like(ok)
            q = torch.nonzero(ok).squeeze(1)
            if q.numel():
                vis[q] = search(scn, point[q].detach(), wo[q].detach(), opts,
                                bound=dist[q].detach(),
                                target=torch.full((q.numel(),), light["mat"], device=dev))
            rays[idx] += ok.to(torch.int64)
            gain = gain + torch.where((ok & vis)[:, None], thr * contrib, zero3)
        rad = rad.index_add(0, idx, gain)
        u_rr, u_fr, u_lobe, u_phi, u_th = draws[4 * L:4 * L + 5]
        survive = shade & (u_rr < c(opts["p_rr"])) & (b + 1 < opts["max_depth"])
        new_dir, new_type = _next_direction(d.detach(), pn.detach(), kdm.detach(), ks, ns, ni,
                                            u_fr, u_lobe, u_phi, u_th)
        alive = survive & (new_type != INVALID)
        weight = torch.where((new_type == TRANSMISSION)[:, None], scn.tr[m], kdm)
        keep = torch.nonzero(alive).squeeze(1)
        idx = idx[keep]
        o, d = point[keep], new_dir[keep]
        thr = (thr * weight * inv_prr)[keep]
        rtype = new_type[keep]
    return rad, rays
