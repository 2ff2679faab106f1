"""Edge-sampled boundary terms of the visibility gradient, the counterpart
of ``tinyraytracing_tpu/diff/edge.py``.

Path replay (``diff/fast.py``, ``diff/inverse.py``) differentiates with
the hit set held fixed, so a loss whose derivative lives on silhouettes
gets ~zero gradient. The missing term of Reynolds' transport theorem over
the image integral,

    d/dtheta int G(x) dx = int dG/dtheta dx + int_C (G- - G+)(x) (n . v) dl,

is estimated by edge sampling (Li et al. 2018, "Differentiable Monte
Carlo Ray Tracing through Edge Sampling"): sample a point on a
silhouette edge, evaluate the integrand a small step to either side of
its projection, and return a surrogate scalar whose gradient is
len * (G- - G+) * (n . dC/dtheta). ``diff.fast.render_loss_fast`` adds
the surrogates value-neutrally (``x - x.detach()``).

- Primary visibility (``primary_edge_surrogate``): every mesh edge
  (``mesh_edges``), masked per view (``silhouette_mask``: boundary edges,
  and interior edges whose two faces lie on opposite sides of the eye).
- Shadow visibility (``shadow_edge_surrogate``): the NEE direct term's
  boundary for camera-visible shading points, in the plane of a planar
  light.

Everything the JAX package detaches with ``stop_gradient`` is evaluated
here under ``torch.no_grad()``: the integrands (``mse_G_fn``'s trace,
the shadow term's three ``intersect`` calls, its Kd gather and ``f_at``)
build no graph, so no gradient ever reaches the scan stack's intersect
kernels. The integrands trace through ``ops.intersect.intersect`` with
``config.intersector``: on a CUDA tensor the packet-BVH kernel (a scene
with a BVH) or the slot kernel. The gathers that carry gradients
(endpoints and sampled edges) use ``ops.lookup.gather_rows``, whose
backward sums the cotangent rows in a fixed order. The sample streams
are ``jax.random``'s (``ops.rng.uniform`` / ``randint``), so the same key
samples the same edges and points as the JAX package.

The edge topology (``boundary_edges``, ``mesh_edges``, ``build_edge_aux``)
is host numpy, the JAX package's dictionary walk over vertex positions
rounded to 5 decimals, so the edges come out in the same order.

Limits, as in the JAX package: single-scattering boundary terms only
(camera or first-hit NEE); the shadow integrand uses the material's
constant Kd diffuse lobe on planar lights; uniform edge sampling.
"""

from __future__ import annotations

import numpy as np
import torch

from tinyraytracing_tpu_torch.models.camera import camera_basis
from tinyraytracing_tpu_torch.ops.linalg import cross, dot
from tinyraytracing_tpu_torch.ops.lookup import gather_rows
from tinyraytracing_tpu_torch.ops.rng import fold_in, randint, uniform


def _tri_vertices(tri_v0, tri_v1, tri_v2) -> np.ndarray:
    """(T, 3, 3) float32 numpy vertices from tensors or arrays."""
    host = lambda a: (a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
                      else np.asarray(a))
    return np.stack([host(tri_v0), host(tri_v1), host(tri_v2)], axis=1)


def _edge_key(v, t, a, b):
    ka = tuple(np.round(v[t, a], 5))
    kb = tuple(np.round(v[t, b], 5))
    return (min(ka, kb), max(ka, kb))


def boundary_edges(tri_v0, tri_v1, tri_v2, tri_ids) -> np.ndarray:
    """Boundary (used-once) edges of the triangles ``tri_ids``: (E, 2, 2)
    int32 [edge, endpoint, (triangle, vertex slot 0/1/2)]. Vertices are
    matched by rounded position (the meshes are triangle soups)."""
    v = _tri_vertices(tri_v0, tri_v1, tri_v2)
    seen: dict = {}
    for t in tri_ids:
        for a, b in ((0, 1), (1, 2), (2, 0)):
            key = _edge_key(v, t, a, b)
            seen[key] = None if key in seen else (t, a, b)
    edges = [e for e in seen.values() if e is not None]
    return np.asarray([[[t, a], [t, b]] for (t, a, b) in edges], np.int32)


def mesh_edges(tri_v0, tri_v1, tri_v2, tri_ids=None) -> tuple:
    """Every unique edge with its faces: (ends (E, 2, 2) int32
    [(tri, slot), (tri, slot)], adj (E, 2) int32 [left tri, right tri or
    -1]); boundary edges have adj[:, 1] == -1."""
    v = _tri_vertices(tri_v0, tri_v1, tri_v2)
    if tri_ids is None:
        tri_ids = range(v.shape[0])
    seen: dict = {}
    for t in tri_ids:
        for a, b in ((0, 1), (1, 2), (2, 0)):
            key = _edge_key(v, t, a, b)
            if key in seen:
                ends, adj = seen[key]
                seen[key] = (ends, (adj[0], t))
            else:
                seen[key] = (((t, a), (t, b)), (t, -1))
    ends = np.asarray([[list(e[0][0]), list(e[0][1])] for e in seen.values()],
                      np.int32)
    adj = np.asarray([list(e[1]) for e in seen.values()], np.int32)
    return ends, adj


def build_edge_aux(scene) -> dict:
    """The scene's edge topology for ``render_loss_fast(edge_aux=...)``:
    {"ends", "adj"} as int64 tensors on the scene's device. Build it once
    per scene; the (triangle, slot) maps stay valid under vertex offsets."""
    ends, adj = mesh_edges(scene.v0, scene.v1, scene.v2)
    t = lambda a: torch.as_tensor(a, dtype=torch.int64, device=scene.device)
    return dict(ends=t(ends), adj=t(adj))


def edge_endpoints(v0, v1, v2, ends):
    """Differentiable (E, 3) endpoint positions of the edges ``ends``
    (int64 (E, 2, 2)) from the (possibly offset) vertex tables."""
    tabs = (v0, v1, v2)

    def pick(k):
        out = 0
        for s in range(3):
            out = out + torch.where((ends[:, k, 1] == s)[:, None],
                                    gather_rows(tabs[s], ends[:, k, 0]), 0.0)
        return out

    return pick(0), pick(1)


def silhouette_mask(v0, v1, v2, gn, adj, viewpoint):
    """(E,) float32 0/1, detached: the edges that are silhouettes seen from
    ``viewpoint`` (boundary edges, and edges whose two faces lie on
    opposite sides of it)."""
    with torch.no_grad():
        three = torch.tensor(3.0, dtype=torch.float32, device=v0.device)
        cen = (v0 + v1 + v2) / three
        vp = viewpoint.to(v0.device)
        tl = adj[:, 0]
        tr = torch.clamp_min(adj[:, 1], 0)
        side = lambda t: dot(gn[t], vp[None, :] - cen[t])
        sil = (adj[:, 1] < 0) | ((side(tl) > 0.0) != (side(tr) > 0.0))
        return sil.to(torch.float32)


def _basis(cam, device):
    return tuple(v.to(device) for v in camera_basis(cam))


def _project(cam, p):
    """World points (..., 3) -> continuous image coordinates (x, y) in the
    ray-generation parameterisation (x = j/(W-1) + ..., y = (H-i)/(H-1));
    differentiable in ``p`` and the camera."""
    eye, horizontal, vertical, llc = _basis(cam, p.device)
    basis = torch.stack([horizontal, vertical, llc - eye], dim=1)   # (3, 3)
    coef = torch.linalg.solve(basis[None], (p - eye)[..., None])[..., 0]
    g = coef[..., 2]
    return coef[..., 0] / g, coef[..., 1] / g


def _ray_through(cam, x, y):
    """Unit rays from the eye through image points (x, y)."""
    eye, horizontal, vertical, llc = _basis(cam, x.device)
    d = ((llc - eye)[None] + x[:, None] * horizontal[None]
         + y[:, None] * vertical[None])
    d = d / torch.sqrt(dot(d, d))[:, None]
    return eye.expand(d.shape), d


def silhouette_edge_surrogate(pa, pb, cam, G_fn, key, n_samples: int = 256,
                              delta: float = 0.1, weights=None):
    """Surrogate scalar whose gradient is the image-boundary term.

    ``pa``, ``pb``: (E, 3) differentiable edge endpoints. ``G_fn(x, y)``:
    the per-sample integrand (per unit pixel area) at image points, called
    under ``torch.no_grad()`` at ``delta`` pixels either side of the
    projected edge. ``weights``: optional (E,) 0/1 edge weights (e.g.
    ``silhouette_mask``); masked edges stay in the uniform draw. Only the
    gradient of the return value is meaningful."""
    E = pa.shape[0]
    dev = pa.device
    W1 = torch.tensor(cam.width - 1.0, dtype=torch.float32, device=dev)
    H1 = torch.tensor(cam.height - 1.0, dtype=torch.float32, device=dev)
    s = uniform(key, (n_samples,), dev)
    e_idx = randint(fold_in(key, 1), (n_samples,), 0, E, dev)
    a = gather_rows(pa, e_idx)
    b = gather_rows(pb, e_idx)
    p = a + s[:, None] * (b - a)                   # (S, 3) points on edges

    # pixel units: G is per unit pixel area, so lengths and velocities are
    def proj_px(q):
        x, y = _project(cam, q)
        return x * W1, y * H1

    ax, ay = proj_px(a)
    bx, by = proj_px(b)
    px, py = proj_px(p)

    # image-space tangent, unit normal and length: detached geometry
    tx, ty = (bx - ax).detach(), (by - ay).detach()
    ln = torch.sqrt(tx * tx + ty * ty)
    inv = 1.0 / torch.clamp_min(ln, 1e-12)
    nx, ny = -ty * inv, tx * inv

    with torch.no_grad():
        gm = G_fn((px - delta * nx) / W1, (py - delta * ny) / H1)
        gp = G_fn((px + delta * nx) / W1, (py + delta * ny) / H1)

    contrib = ln * (gm - gp) * (nx * px + ny * py)
    if weights is not None:
        contrib = contrib * gather_rows(weights.detach(), e_idx)
    return torch.sum(contrib) * (E / n_samples)


def mse_G_fn(scene, cam, config, target, key, spp: int = 1):
    """G for the loss mean((img - target)^2) over pixels and channels:
    G(x) = sum_c (L_c(x) - t_c(x))^2 / (3 n_pix), L the radiance through
    the image point (``integrator.wavefront.trace``, one path per point)
    and t the target's nearest pixel. Call it under ``torch.no_grad()``."""
    from tinyraytracing_tpu_torch.integrator.wavefront import trace

    W, H = cam.width, cam.height
    dev = scene.device
    target = torch.as_tensor(target, device=dev).reshape(H, W, 3)
    denom = torch.tensor(3.0 * W * H, dtype=torch.float32, device=dev)

    def G(x, y):
        o, d = _ray_through(cam, x, y)
        rad = trace(scene, o, d, key, config)
        j = torch.clamp(torch.round(x * (W - 1)).to(torch.int64), 0, W - 1)
        i = torch.clamp(torch.round(H - y * (H - 1)).to(torch.int64), 0, H - 1)
        e = rad - target[i, j]
        return dot(e, e) / denom
    return G


def primary_edge_surrogate(scene, cam, config, target, key, aux,
                           n_samples: int = 256, delta: float = 0.1,
                           spp: int = 1):
    """Primary-visibility boundary term over the whole mesh with the
    view-dependent silhouette mask (closed meshes included); a surrogate
    scalar (see ``silhouette_edge_surrogate``)."""
    pa, pb = edge_endpoints(scene.v0, scene.v1, scene.v2, aux["ends"])
    w = silhouette_mask(scene.v0, scene.v1, scene.v2, scene.gn, aux["adj"],
                        cam.eye)
    G = mse_G_fn(scene, cam, config, target, key, spp)
    return silhouette_edge_surrogate(pa, pb, cam, G, fold_in(key, 17),
                                     n_samples, delta, weights=w)


def shadow_edge_surrogate(scene, cam, config, target, img, key, aux,
                          n_samples: int = 256, delta_frac: float = 2e-2,
                          light: int = 0):
    """Shadow-silhouette boundary term: the NEE direct term's visibility
    discontinuity for camera-visible shading points, under planar light
    ``light``.

    Samples (pixel, edge, point on the edge), projects the edge through
    the detached shading point p onto the light's plane (its basis from
    the light's first triangle), and accumulates
    dLoss/dD_pix * (f- - f+) * len2 * (n . y2(theta)) in plane
    coordinates. ``img``: the rendered image (detached here). Gradients
    reach the occluder's vertices and the light's, not the receiver; f is
    the material's constant-Kd diffuse term (as in the JAX package)."""
    from tinyraytracing_tpu_torch.ops.intersect import intersect

    dev = scene.device
    f32 = torch.float32
    c = lambda x: torch.tensor(x, dtype=f32, device=dev)
    W, H = cam.width, cam.height
    n_pix = W * H
    E = aux["ends"].shape[0]
    k1, k2, k3 = (fold_in(key, i) for i in (31, 32, 33))

    # --- sample pixels; camera rays -> detached primary hits
    with torch.no_grad():
        delta = torch.sqrt(torch.clamp_min(scene.light_area[light], 1e-12)) * delta_frac
        pix = randint(k1, (n_samples,), 0, n_pix, dev)
        i = (pix // W).to(f32)
        j = (pix % W).to(f32)
        o, d = _ray_through(cam, j / c(W - 1.0), (H - i) / c(H - 1.0))
        hit = intersect(scene, o, d, config)
        p = o + hit.t[:, None] * d
        tri = torch.clamp_min(hit.idx, 0)
        valid = hit.hit & ~scene.tri_emissive[tri]
        n_p = scene.gn[tri]
        kd = scene.kd[scene.tri_mtl[tri].to(torch.int64)]      # (S, 3)

    # --- light plane (planar light): origin, normal, in-plane basis
    lv0 = scene.lt_v0[light, 0]
    lv1 = scene.lt_v1[light, 0]
    lv2 = scene.lt_v2[light, 0]
    norm = lambda v: torch.sqrt(dot(v, v))
    nl = cross(lv1 - lv0, lv2 - lv0)
    nl = nl / torch.clamp_min(norm(nl), 1e-12)
    ul = (lv1 - lv0) / torch.clamp_min(norm(lv1 - lv0), 1e-12)
    wl = cross(nl, ul)

    # --- sample edges; silhouette with respect to each p
    e_idx = randint(k2, (n_samples,), 0, E, dev)
    pa, pb = edge_endpoints(scene.v0, scene.v1, scene.v2, aux["ends"])
    a3, b3 = gather_rows(pa, e_idx), gather_rows(pb, e_idx)
    with torch.no_grad():
        adj = aux["adj"][e_idx]
        cen = (scene.v0 + scene.v1 + scene.v2) / c(3.0)
        side = lambda t: dot(scene.gn[t], p - cen[t])
        tl, tr = adj[:, 0], torch.clamp_min(adj[:, 1], 0)
        sil = (adj[:, 1] < 0) | ((side(tl) > 0.0) != (side(tr) > 0.0))

    def to_plane(q):
        dq = q - p
        denom = dot(dq, nl[None])
        safe = denom.abs() > 1e-9
        tau = dot(lv0[None] - p, nl[None]) / torch.where(safe, denom, 1.0)
        yw = p + tau[:, None] * dq
        return (dot(yw - lv0[None], ul[None]), dot(yw - lv0[None], wl[None]),
                tau, safe)

    ax2, ay2, ta, sa_ok = to_plane(a3)
    bx2, by2, tb_, sb_ok = to_plane(b3)
    s = uniform(k3, (n_samples,), dev)
    qx = ax2 + s * (bx2 - ax2)                     # y2(theta), differentiable
    qy = ay2 + s * (by2 - ay2)

    tx, ty = (bx2 - ax2).detach(), (by2 - ay2).detach()
    ln2 = torch.sqrt(tx * tx + ty * ty)
    inv = 1.0 / torch.clamp_min(ln2, 1e-12)
    nx, ny = -ty * inv, tx * inv

    with torch.no_grad():
        # the edge must lie between p and the light's plane: tau > 1
        tau_q = ta + s * (tb_ - ta)
        between = (tau_q > 1.0) & sa_ok & sb_ok
        le = scene.light_radiance[light]

        # the integrand on both sides (includes visibility)
        def f_at(y2x, y2y):
            yw = lv0[None] + y2x[:, None] * ul[None] + y2y[:, None] * wl[None]
            to_l = yw - p
            r2 = torch.clamp_min(dot(to_l, to_l), 1e-12)
            wo = to_l / torch.sqrt(r2)[:, None]
            cos_p = dot(wo, n_p)
            cos_y = dot(wo, nl[None]).abs()
            inside = _point_in_light(scene, light, y2x, y2y, lv0, ul, wl)
            h2 = intersect(scene, p, wo, config)
            vis = h2.hit & (scene.tri_mtl[torch.clamp_min(h2.idx, 0)]
                            == scene.light_mtl[light])
            geom = torch.clamp_min(cos_p, 0.0) * cos_y / r2
            return (kd / c(np.pi)) * (geom * inside * vis)[:, None] * le[None]

        gm = f_at(qx - delta * nx, qy - delta * ny)
        gp = f_at(qx + delta * nx, qy + delta * ny)

        # loss weighting: dLoss/dD_pix = 2 (img - target) / (3 n_pix)
        img = img.detach().reshape(n_pix, 3)
        tgt = torch.as_tensor(target, device=dev).reshape(n_pix, 3)
        gw = 2.0 * (img[pix] - tgt[pix]) / c(3.0 * n_pix)
        df = gw * (gm - gp)
        wsum = df[:, 0] + df[:, 1] + df[:, 2]
        ok = (valid & sil & between).to(f32)

    contrib = wsum * ln2 * (nx * qx + ny * qy) * ok
    return torch.sum(contrib) * (float(n_pix) * E / n_samples)


def _point_in_light(scene, light, y2x, y2y, lv0, ul, wl):
    """Whether each plane point lies inside a triangle of the light (0/1
    float32; call under ``torch.no_grad()``)."""
    K = scene.lt_v0.shape[1]
    inside = torch.zeros(y2x.shape, dtype=torch.bool, device=y2x.device)
    for k in range(K):
        p2 = lambda v: (dot(v - lv0, ul), dot(v - lv0, wl))
        axk, ayk = p2(scene.lt_v0[light, k])
        bxk, byk = p2(scene.lt_v1[light, k])
        cxk, cyk = p2(scene.lt_v2[light, k])
        d00x, d00y = bxk - axk, byk - ayk
        d01x, d01y = cxk - axk, cyk - ayk
        den = d00x * d01y - d01x * d00y
        degen = den.abs() < 1e-12
        den = torch.where(degen, 1.0, den)
        ex, ey = y2x - axk, y2y - ayk
        u = (ex * d01y - d01x * ey) / den
        v = (d00x * ey - ex * d00y) / den
        inside = inside | (~degen & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0))
    return inside.to(torch.float32)
