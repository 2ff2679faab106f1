"""The plain reference: a path tracer in plain PyTorch, written from the
estimator's description and imports nothing of the program.

It traces any set of paths of a render independently of the others: a
path is its id (which picks its key, ``core.rng.path_keys``) and its
pixel, and its camera ray, bounces, next-event estimation and Russian
roulette follow the estimator the port implements (the reference
renderer's ``pathTracing.cpp``: a jittered pinhole camera ray; at each
bounce the closest hit, emission on camera and transmission rays only,
one light sample per light chosen by area among the light's triangles
with the reference's barycentrics, a shadow ray that must reach the
light's own material, Russian roulette at ``p_rr`` and a cosine or Phong
lobe, or Fresnel refraction, for the next direction). Hits are found by
brute force over every triangle: each triangle's affine map to
barycentric space (worked out in float64 from the raw corners) applied
to a block of rays by matrix products, with the renderers' acceptance
rule (t >= t_min, |n.d| >= n_dot_d_min) and their tie-break (inside a
relative band of 1 + tie_eps an emissive hit wins). Matrix products run
without TF32.

``dtype`` sets the precision of every float the tracer computes; the
control runs it in bfloat16 in the program's place. With ``params``
(``kd``, ``vertex_offset``) the render is differentiable as the port's
gradient path defines it: the hit triangle is fixed (found without
gradient), and its distance and barycentrics are the Moller-Trumbore
functions of the ray and the moved corners; the light's corners move
with their triangles; shadow visibility and sampled directions carry no
gradient.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from core import rng

CAMERA, DIFFUSE, SPECULAR, TRANSMISSION, INVALID = 4, 0, 1, 2, 3
PI = math.pi


def _f64(x, dev):
    return torch.as_tensor(np.asarray(x, np.float64), device=dev)


class RefScene:
    """A raw scene (``core.scenes``) as the reference's tables on
    ``device`` in ``dtype``."""

    def __init__(self, raw: dict, device, dtype=torch.float32):
        self.raw, self.device, self.dtype = raw, torch.device(device), dtype
        dev = self.device
        names = list(raw["mtl_names"])
        for n in raw["materials"]:
            if n not in names:
                names.append(n)
        self.names = names
        mats = [raw["materials"].get(n) for n in names]
        tab = lambda key, default: torch.tensor(
            [m[key] if m is not None else default for m in mats],
            dtype=torch.float32, device=dev)
        self.kd0 = tab("kd", (0.0, 0.0, 0.0))
        self.ks = tab("ks", (0.0, 0.0, 0.0)).to(dtype)
        self.tr = tab("tr", (0.0, 0.0, 0.0)).to(dtype)
        self.ns = tab("ns", 1.0).to(dtype)
        self.ni = tab("ni", 1.0).to(dtype)
        rad = torch.zeros((len(names), 3), dtype=torch.float32, device=dev)
        emis = torch.zeros(len(names), dtype=torch.bool, device=dev)
        for name, radiance in raw["lights"]:
            rad[names.index(name)] = torch.tensor(radiance, dtype=torch.float32)
            emis[names.index(name)] = True
        self.radiance = rad.to(dtype)
        self.mat = torch.as_tensor(raw["mtl"], dtype=torch.int64, device=dev)
        self.em = emis[self.mat]
        self.v64 = _f64(raw["v"], dev)                              # (T, 3, 3)
        self.v = self.v64.to(torch.float32)
        self.vn = _f64(raw["vn"], dev).to(torch.float32).to(dtype)
        self.gn = _f64(raw["normal"], dev).to(torch.float32).to(dtype)
        self.T = self.v.shape[0]
        # lights: triangles of the light's material in file order, their
        # prefix areas (float64 sums rounded to float32)
        v64 = np.asarray(raw["v"], np.float64)
        areas = 0.5 * np.linalg.norm(
            np.cross(v64[:, 1] - v64[:, 0], v64[:, 2] - v64[:, 0]), axis=1)
        self.lights = []
        for name, radiance in raw["lights"]:
            sel = np.nonzero(np.asarray(raw["mtl"]) == raw["mtl_names"].index(name))[0]
            pref = np.cumsum(areas[sel]).astype(np.float32)
            self.lights.append(dict(
                tri=torch.as_tensor(sel, dtype=torch.int64, device=dev),
                prefix=torch.as_tensor(pref, device=dev).to(dtype),
                area=float(pref[-1]), mat=names.index(name),
                radiance=torch.tensor(radiance, dtype=torch.float32,
                                      device=dev).to(dtype)))
        self.nee_range = self.lights[0]["area"] if self.lights else 0.0
        self.set_geometry(self.v64)

    def set_geometry(self, v: torch.Tensor):
        """The hit search's tables for float64 corners ``v`` (T, 3, 3):
        each triangle's affine rows [a; b; c | offsets], rounded."""
        with torch.no_grad():
            e1, e2 = v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]
            n = torch.linalg.cross(e1, e2)
            det = (n * n).sum(1)
            inv = torch.where(det > 1e-24, 1.0 / torch.where(det > 1e-24, det, 1.0),
                              torch.zeros_like(det))
            rows = torch.stack([torch.linalg.cross(e2, n), torch.linalg.cross(n, e1),
                                n], 1) * inv[:, None, None]          # (T, 3, 3)
            off = -(rows * v[:, None, 0, :]).sum(-1)                 # (T, 3)
            self.rows_o = torch.cat([rows, off[:, :, None]], 2).to(self.dtype)  # (T, 3, 4)
            self.rows_d = rows.to(self.dtype)


@contextlib.contextmanager
def _no_tf32():
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _pair_budget(dev) -> int:
    return 1 << 25 if dev.type == "cuda" else 1 << 18


@torch.no_grad()
def closest_hit(scn: RefScene, o, d, opts):
    """(t, triangle) of rays o, d (N, 3): the closest accepted hit, an
    emissive one inside the tie band winning; triangle -1 on a miss."""
    return _search(scn, o, d, opts, None, None)


@torch.no_grad()
def visible(scn: RefScene, o, d, bound, target, opts):
    """Whether each shadow ray reaches a triangle of material ``target``
    within its bound's tie band with no hit of another material closer
    than the bound by more than the band (a surface coplanar with the
    light, as the Cornell ceiling is, blocks a ray whose sampled point
    lies past its hit by more than the band)."""
    return _search(scn, o, d, opts, bound, target)


def _search(scn, o, d, opts, bound, target):
    dt, dev = scn.dtype, scn.device
    N, T = o.shape[0], scn.T
    big = torch.tensor(torch.finfo(dt).max, dtype=dt, device=dev)
    eps1 = torch.tensor(1.0 + opts["tie_eps"], dtype=dt, device=dev)
    budget = _pair_budget(dev)
    tb = max(1, min(T, budget))
    rb = max(1, budget // tb)
    o4 = torch.cat([o.to(dt), torch.ones((N, 1), dtype=dt, device=dev)], 1)
    d3 = d.to(dt)
    best_t = torch.full((N,), float(big), dtype=dt, device=dev)
    best_i = torch.full((N,), -1, dtype=torch.int64, device=dev)
    em_t, em_i = best_t.clone(), best_i.clone()
    with _no_tf32():
        for t0 in range(0, T, tb):
            sl = slice(t0, min(T, t0 + tb))
            ro, rd, gn = scn.rows_o[sl], scn.rows_d[sl], scn.gn[sl]
            em, mat = scn.em[sl], scn.mat[sl]
            for r0 in range(0, N, rb):
                rs = slice(r0, min(N, r0 + rb))
                oo, dd = o4[rs], d3[rs]
                ldw = dd @ rd[:, 2].T
                t = -(oo @ ro[:, 2].T) / torch.where(ldw == 0, torch.ones_like(ldw), ldw)
                u = oo @ ro[:, 0].T + t * (dd @ rd[:, 0].T)
                v = oo @ ro[:, 1].T + t * (dd @ rd[:, 1].T)
                ok = ((ldw != 0) & ((dd @ gn.T).abs() >= opts["n_dot_d_min"])
                      & (t >= opts["t_min"]) & (u >= 0) & (v >= 0) & (u + v <= 1))
                t = torch.where(ok, t, big)
                if target is None:
                    m, i = t.min(1)
                    take = m < best_t[rs]
                    best_t[rs] = torch.where(take, m, best_t[rs])
                    best_i[rs] = torch.where(take, i + t0, best_i[rs])
                    m, i = torch.where(em[None, :], t, big).min(1)
                    take = m < em_t[rs]
                    em_t[rs] = torch.where(take, m, em_t[rs])
                    em_i[rs] = torch.where(take, i + t0, em_i[rs])
                else:
                    is_tgt = mat[None, :] == target[rs, None]
                    best_t[rs] = torch.minimum(
                        best_t[rs], torch.where(is_tgt, t, big).min(1).values)
                    em_t[rs] = torch.minimum(
                        em_t[rs], torch.where(is_tgt, big, t).min(1).values)
    if target is None:
        use_em = (em_t < big) & (em_t <= best_t * eps1)
        t = torch.where(use_em, em_t, best_t)
        tri = torch.where(use_em, em_i, best_i)
        return t, torch.where(t < big, tri, torch.full_like(tri, -1))
    t_g, t_w = best_t, em_t          # target material, any other material
    bound = bound.to(dt)
    return (t_g < big) & (t_g <= bound * eps1) & ~(t_w * eps1 < bound)


def _hit_terms(scn, o, d, tri):
    """(t, u, v) of rays on the triangles ``tri`` by their affine rows,
    summed term by term in x, y, z order: the distance a shading point
    takes, recomputed for the one triangle the search chose."""
    r = scn.rows_o[tri]                                          # (N, 3, 4)
    lin = lambda k, p: p[:, 0] * r[:, k, 0] + p[:, 1] * r[:, k, 1] + p[:, 2] * r[:, k, 2]
    ldw = lin(2, d)
    z = ldw == 0
    inv = torch.where(z, 0.0, 1.0).to(d.dtype) / torch.where(z, torch.ones_like(ldw), ldw)
    t = -(lin(2, o) + r[:, 2, 3]) * inv
    return (t, (lin(0, o) + r[:, 0, 3]) + t * lin(0, d),
            (lin(1, o) + r[:, 1, 3]) + t * lin(1, d))


def _moller_trumbore(a, b, c, o, d):
    """(t, u, v) of rays o, d on triangles (a, b, c), differentiable."""
    e1, e2 = b - a, c - a
    p = _cross(d, e2)
    det = _dot(e1, p)
    safe = det.abs() > 1e-24
    one = torch.ones_like(det)
    inv = torch.where(safe, one, torch.zeros_like(det)) / torch.where(safe, det, one)
    s = o - a
    q = _cross(s, e1)
    return _dot(e2, q) * inv, _dot(s, p) * inv, _dot(d, q) * inv


def _dot(a, b):
    """Row dot products summed x, then y, then z."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _normalize(x):
    """x times the reciprocal of its length (a correctly rounded square
    root and reciprocal, so the card and the CPU agree)."""
    inv = torch.reciprocal(torch.sqrt(torch.clamp_min(_dot(x, x), 1e-30)))
    return x * inv[..., None]


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _const(x, like):
    """A constant as a 0-d tensor of ``like``'s type and device: the card
    turns a division by a Python number into a product by its inverse."""
    return torch.tensor(x, dtype=like.dtype, device=like.device)


def _f64fn(fn, *xs):
    """A transcendental evaluated in float64 and rounded to the inputs' type."""
    return fn(*(x.double() for x in xs)).to(xs[0].dtype)


def _sample_lobe(axis, u_phi, u_theta, diffuse, ns):
    phi = (2.0 * PI) * u_phi
    th_d = _f64fn(torch.arcsin, torch.sqrt(torch.clamp(u_theta, 0.0, 1.0)))
    th_s = _f64fn(torch.arccos, torch.clamp(_f64fn(
        torch.pow, torch.clamp_min(u_theta, 1e-30), 1.0 / (ns + 1.0)), -1.0, 1.0))
    theta = torch.where(diffuse, th_d, th_s)
    st = _f64fn(torch.sin, theta)
    local = (st * _f64fn(torch.cos, phi), _f64fn(torch.cos, theta),
             st * _f64fn(torch.sin, phi))
    ax, ay, az = axis.unbind(1)
    zero = torch.zeros_like(ax)
    front = _normalize(torch.where((ax.abs() > ay.abs())[:, None],
                                   torch.stack([az, zero, -ax], 1),
                                   torch.stack([zero, -az, ay], 1)))
    right = _cross(axis, front)
    return _normalize(right * local[0][:, None] + axis * local[1][:, None]
                      + front * local[2][:, None])


def _reflect(d, n):
    return d - (2.0 * _dot(d, n))[:, None] * n


def _next_direction(d, pn, kd, ks, ns, ni, u_fr, u_lobe, u_phi, u_theta):
    """The continuation direction and its ray type."""
    cos_in = _dot(d, pn)
    exiting = cos_in > 0
    normal = torch.where(exiting[:, None], -pn, pn)
    one = torch.ones_like(ni)
    n1, n2 = torch.where(exiting, ni, one), torch.where(exiting, one, ni)
    rf0 = torch.square((n1 - n2) / (n1 + n2))
    fresnel = rf0 + (1.0 - rf0) * _f64fn(torch.pow, 1.0 - cos_in.abs(),
                                         torch.full_like(cos_in, 5.0))
    refract = (ni > 1.0) & (fresnel < u_fr)
    eta = (n1 / n2)[:, None]
    cosi = _dot(normal, d)[:, None]
    k = 1.0 - eta * eta * (1.0 - cosi * cosi)
    tir = (k < 0)[:, 0]
    refr = eta * d - (eta * cosi + torch.sqrt(torch.clamp_min(k, 0.0))) * normal
    kd_len = torch.sqrt(torch.clamp_min(_dot(kd, kd), 0.0))
    ks_len = torch.sqrt(torch.clamp_min(_dot(ks, ks), 0.0))
    den = kd_len + ks_len
    safe = den > 0
    inv_den = torch.reciprocal(torch.where(safe, den, one))
    kd_frac = torch.where(safe, kd_len * inv_den, torch.zeros_like(den))
    ks_frac = torch.where(safe, ks_len * inv_den, torch.zeros_like(den))
    diffuse = safe & (u_lobe < kd_frac)
    specular = safe & ~diffuse & (ns > 1.0) & (u_lobe < kd_frac + ks_frac)
    axis = torch.where(diffuse[:, None], pn, _reflect(d, pn))
    lobe = _sample_lobe(axis, u_phi, u_theta, diffuse, ns)
    full = lambda v: torch.full_like(cos_in, v, dtype=torch.int64)
    lobe_type = torch.where(diffuse, full(DIFFUSE),
                            torch.where(specular, full(SPECULAR), full(INVALID)))
    new_dir = torch.where(refract[:, None],
                          torch.where(tir[:, None], _reflect(d, normal), refr), lobe)
    new_type = torch.where(refract, torch.where(tir, full(SPECULAR), full(TRANSMISSION)),
                           lobe_type)
    return new_dir, new_type


def camera_basis(cam: dict):
    """(eye, horizontal, vertical, lower-left corner) in float32."""
    f = lambda x: torch.tensor(x, dtype=torch.float32)
    eye, lookat, up = f(cam["eye"]), f(cam["lookat"]), f(cam["up"])
    h = torch.tan(torch.deg2rad(f(cam["fovy"])) / 2.0)
    vh = 2.0 * h
    vw = (cam["width"] / cam["height"]) * vh
    nrm = lambda a: a * torch.reciprocal(torch.clamp_min(torch.sqrt(
        torch.clamp_min(torch.sum(a * a), 0.0)), 1e-20))
    w = nrm(eye - lookat)
    u = nrm(torch.linalg.cross(up, w))
    v = torch.linalg.cross(w, u)
    hor, ver = vw * u, vh * v
    return eye, hor, ver, eye - hor / 2.0 - ver / 2.0 - w


def camera_rays(cam: dict, pk0, pk1, pix, dtype):
    """Jittered pinhole rays of pixels ``pix`` from the path keys' bits."""
    W, H = cam["width"], cam["height"]
    eye, hor, ver, llc = (x.to(pix.device) for x in camera_basis(cam))
    i = torch.div(pix, W, rounding_mode="floor").to(torch.float32)
    j = (pix % W).to(torch.float32)
    x = j / (W - 1.0) + (rng.bits_to_uniform(pk0) - 0.5) / float(W)
    y = (H - i) / (H - 1.0) + (rng.bits_to_uniform(pk1) - 0.5) / float(H)
    d = _normalize(llc[None] + x[:, None] * hor[None] + y[:, None] * ver[None] - eye[None])
    return eye[None].expand_as(d).to(dtype), d.to(dtype)


def trace_paths(scn: RefScene, cam: dict, key, path_ids, pix, opts: dict,
                params: dict | None = None):
    """Radiance (N, 3) and traced rays (N,) of the paths ``path_ids`` of
    pixels ``pix`` under master ``key``. ``opts``: max_depth, p_rr, t_min,
    n_dot_d_min, tie_eps. With ``params`` the radiance is differentiable
    in them (see the module note)."""
    dt, dev = scn.dtype, scn.device
    N = path_ids.shape[0]
    pk0, pk1 = rng.path_keys(key, path_ids.to(dev))
    o, d = camera_rays(cam, pk0, pk1, pix.to(dev), dt)
    thr = torch.ones((N, 3), dtype=dt, device=dev)
    rad = torch.zeros((N, 3), dtype=dt, device=dev)
    rays = torch.zeros(N, dtype=torch.int64, device=dev)
    rtype = torch.full((N,), CAMERA, dtype=torch.int64, device=dev)
    idx = torch.arange(N, device=dev)
    kd_tab = (params["kd"] if params is not None else scn.kd0).to(dt)
    verts = scn.v
    if params is not None and params.get("vertex_offset") is not None:
        verts = scn.v + params["vertex_offset"][:, None, :]
        scn.set_geometry(scn.v64 + params["vertex_offset"].detach().double()[:, None, :])
    L = len(scn.lights)
    c = lambda x: _const(x, thr)
    inv_prr, pi, two_pi = c(1.0 / opts["p_rr"]), c(PI), c(2.0 * PI)
    for b in range(opts["max_depth"]):
        if idx.numel() == 0:
            break
        _, tri = closest_hit(scn, o.detach(), d.detach(), opts)
        rays[idx] += 1
        hit = tri >= 0
        ti = torch.clamp_min(tri, 0)
        t, u, v = _hit_terms(scn, o.detach(), d.detach(), ti)
        if params is not None:
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
        kd, ks, ns, ni = kd_tab[m], scn.ks[m], scn.ns[m], scn.ni[m]
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
            contrib = (light["radiance"][None] * geom[:, None]
                       * (kd / pi + ks * phong[:, None]))
            vis = torch.zeros_like(ok)
            q = torch.nonzero(ok).squeeze(1)
            if q.numel():
                vis[q] = visible(scn, point[q].detach(), wo[q].detach(), dist[q].detach(),
                                 torch.full((q.numel(),), light["mat"], device=dev), opts)
            rays[idx] += ok.to(torch.int64)
            gain = gain + torch.where((ok & vis)[:, None], thr * contrib, zero3)
        rad = rad.index_add(0, idx, gain)
        u_rr, u_fr, u_lobe, u_phi, u_th = draws[4 * L:4 * L + 5]
        survive = shade & (u_rr < c(opts["p_rr"])) & (b + 1 < opts["max_depth"])
        new_dir, new_type = _next_direction(d.detach(), pn.detach(), kd.detach(), ks, ns, ni,
                                            u_fr, u_lobe, u_phi, u_th)
        alive = survive & (new_type != INVALID)
        weight = torch.where((new_type == TRANSMISSION)[:, None], scn.tr[m], kd)
        keep = torch.nonzero(alive).squeeze(1)
        idx = idx[keep]
        o, d = point[keep], new_dir[keep]
        thr = (thr * weight * inv_prr)[keep]
        rtype = new_type[keep]
    return rad, rays
