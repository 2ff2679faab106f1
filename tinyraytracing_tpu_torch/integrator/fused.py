"""The fused pixel-persistent wavefront (``render_fused``) and the
per-bounce shading helpers it shares with the queue renderer (BSDF
sampling, material and light-table lookups, next-event geometry, the
tile-order pixel queue), ported from ``tinyraytracing_tpu/integrator/fused.py``.

Everything is planar: vectors are (x, y, z) triples of (R,) float32
tensors, computed in the JAX package's operation order. Divisions by a
constant divide by a float32 tensor on the data's device (not a Python
scalar, which CUDA turns into a multiply by the reciprocal),
normalisation is a correctly rounded 1/sqrt (ops/vec.py), and sin, cos,
asin, acos and pow are evaluated in float64 and rounded
(``ops/sampling.py::f32_transcendental``) — so CPU and CUDA results
agree but for float-add order in sums.

The persistent renderer binds lane to pixel: in epoch e, lane l serves
pixel order[slot_base + e*R + l] and runs that pixel's ``spp`` paths one
after another. Each iteration is ONE closest-hit trace over
[bounce rays | the L shadow-ray groups queued by the last iteration]
(shadow legs bounded at their light distance, dead lanes at 0), so next
event estimation is deferred by one iteration. A lane accumulates its own
pixel and an epoch's image is a dense write — no scatter, no atomics: the
render is deterministic on the card too. Every draw is path-indexed
(``ops/rng.py``), so the image is bitwise independent of ``lanes``,
``slot_base`` and ``n_slots`` under the preorder walk.
"""

from __future__ import annotations

import numpy as np
import torch

from tinyraytracing_tpu_torch.config import (
    CAMERA, DIFFUSE, INVALID, SPECULAR, TRANSMISSION, RenderConfig,
)
from tinyraytracing_tpu_torch.models.camera import Camera, camera_basis
from tinyraytracing_tpu_torch.ops import vec
from tinyraytracing_tpu_torch.ops.lookup import (
    CHAIN_LIMIT, chain_lookup, chain_lookup_planes, gather_rows,
)
from tinyraytracing_tpu_torch.ops.rng import bits_to_uniform, bounce_uniforms, path_keys
from tinyraytracing_tpu_torch.ops.sampling import PI, f32_transcendental
from tinyraytracing_tpu_torch.ops.trace import fused_trace_planes
from tinyraytracing_tpu_torch.utils.spans import count, span

# parked rays: origin far outside any scene AABB, so every slab test fails
_FAR = 1.0e30
_INF = 3.0e38


def _c(x, like: torch.Tensor) -> torch.Tensor:
    """A float32 0-d constant on ``like``'s device."""
    return torch.tensor(x, dtype=torch.float32, device=like.device)


# ---------------------------------------------------------------------------
# planar BSDF sampling (reference nextRay(), pathTracing.cpp:147-209)
# ---------------------------------------------------------------------------

def sample_lobe_planar(axis, u_phi, u_theta, is_diffuse, ns):
    """Cosine (diffuse) or Phong lobe about ``axis`` (reference Sample(),
    pathTracing.cpp:111-145)."""
    ax, ay, az = axis
    t = f32_transcendental
    phi = (2.0 * PI) * u_phi
    theta_d = t(torch.arcsin, torch.sqrt(torch.clamp(u_theta, 0.0, 1.0)))
    theta_s = t(torch.arccos, torch.clamp(
        t(torch.pow, torch.clamp_min(u_theta, 1e-30), 1.0 / (ns + 1.0)),
        -1.0, 1.0))
    theta = torch.where(is_diffuse, theta_d, theta_s)
    st = t(torch.sin, theta)
    sx = st * t(torch.cos, phi)
    sy = t(torch.cos, theta)
    sz = st * t(torch.sin, phi)
    # reference ONB (pathTracing.cpp:131-144)
    zeros = torch.zeros_like(ax)
    pickx = ax.abs() > ay.abs()
    front = vec.normalize(vec.where(pickx, (az, zeros, -ax), (zeros, -az, ay)))
    right = vec.cross(axis, front)
    return vec.normalize((
        right[0] * sx + ax * sy + front[0] * sz,
        right[1] * sx + ay * sy + front[1] * sz,
        right[2] * sx + az * sy + front[2] * sz,
    ))


def sample_bsdf_planar(d, pn, kd, ks, ns, ni, u_fresnel, u_lobe, u_phi, u_theta):
    """Next direction and ray type (reference nextRay(),
    pathTracing.cpp:147-209): Fresnel-chosen refraction for ni > 1, else a
    diffuse or Phong lobe picked by |kd| : |ks|, else INVALID."""
    one = _c(1.0, d[0])
    cos_in = vec.dot(d, pn)
    exiting = cos_in > 0.0
    normal = vec.where(exiting, vec.neg(pn), pn)
    n1 = torch.where(exiting, ni, one)
    n2 = torch.where(exiting, one, ni)
    rf0 = torch.square((n1 - n2) / (n1 + n2))
    fresnel = rf0 + (1.0 - rf0) * f32_transcendental(
        torch.pow, 1.0 - cos_in.abs(), _c(5.0, d[0]))
    take_refract = (ni > 1.0) & (fresnel < u_fresnel)

    refr_dir, tir = vec.refract(d, normal, n1 / n2)
    mirror_normal = vec.reflect(d, normal)

    kd_len = vec.length(kd)
    ks_len = vec.length(ks)
    denom = kd_len + ks_len
    safe = denom > 0.0
    inv_denom = torch.reciprocal(torch.where(safe, denom, one))
    zero = _c(0.0, d[0])
    kd_frac = torch.where(safe, kd_len * inv_denom, zero)
    ks_frac = torch.where(safe, ks_len * inv_denom, zero)

    is_diffuse = safe & (u_lobe < kd_frac)
    is_specular = safe & ~is_diffuse & (ns > 1.0) & (u_lobe < kd_frac + ks_frac)
    lobe_axis = vec.where(is_diffuse, pn, vec.reflect(d, pn))
    lobe_dir = sample_lobe_planar(lobe_axis, u_phi, u_theta, is_diffuse, ns)
    i64 = lambda k: torch.tensor(k, dtype=torch.int64, device=d[0].device)
    lobe_type = torch.where(
        is_diffuse, i64(DIFFUSE),
        torch.where(is_specular, i64(SPECULAR), i64(INVALID)))

    new_dir = vec.where(
        take_refract, vec.where(tir, mirror_normal, refr_dir), lobe_dir
    )
    ray_type = torch.where(
        take_refract,
        torch.where(tir, i64(SPECULAR), i64(TRANSMISSION)),
        lobe_type,
    )
    return new_dir, ray_type


# ---------------------------------------------------------------------------
# scene lookups
# ---------------------------------------------------------------------------

def _material_planes(scene, m):
    """All material attributes at material-id plane ``m`` (float ids; a
    miss's -1 reads the last row, as the JAX select chain does)."""
    return dict(
        kd=chain_lookup_planes(scene.kd, m),
        ks=chain_lookup_planes(scene.ks, m),
        tr=chain_lookup_planes(scene.tr, m),
        rad=chain_lookup_planes(scene.radiance, m),
        ns=chain_lookup(scene.ns, m),
        ni=chain_lookup(scene.ni, m),
        tex_id=chain_lookup(scene.tex_id, m),
    )


def _tex_kd(scene, mat, tcu, tcv, kd_plain):
    """Kd from texture (interpolated UV, wrap, nearest — reference
    pathTracing.cpp:15-30) when the material has one, else material Kd.
    Skipped for scenes without textures (1x1 atlas)."""
    if scene.tex.shape[1] == 1 and scene.tex.shape[2] == 1:
        return kd_plain
    tid = mat["tex_id"]
    has_tex = tid >= 0
    tid_safe = torch.clamp_min(tid, 0)
    icol = tcu - torch.floor(tcu)
    irow = tcv - torch.floor(tcv)
    th = chain_lookup(scene.tex_hw[:, 0], tid_safe)
    tw = chain_lookup(scene.tex_hw[:, 1], tid_safe)
    r_ix = torch.minimum(torch.clamp_min((irow * th).to(torch.int32), 0), th - 1)
    c_ix = torch.minimum(torch.clamp_min((icol * tw).to(torch.int32), 0), tw - 1)
    texel = scene.tex[tid_safe.long(), r_ix.long(), c_ix.long()]
    return vec.where(has_tex, (texel[..., 0], texel[..., 1], texel[..., 2]),
                     kd_plain)


def _nee_geometry(scene, config, l, point, pn, wi, kd_val, ks, ns,
                  u_pick, u1, u2, u3, shade_mask):
    """Light l's NEE term EXCEPT visibility (reference pathTracing.cpp:34-74
    split at the shadow trace): returns the shadow direction, the
    pre-visibility contribution planes, the light distance and the
    validity mask."""
    K_pad = scene.lt_prefix.shape[1]
    K = K_pad
    if l < len(scene.lt_counts):
        K = max(min(int(scene.lt_counts[l]), K_pad), 1)
    prefix = scene.lt_prefix[l, :K]                   # (K,)
    area = scene.light_area[l]
    if config.light_sampler == "ref":
        rnd = u_pick * scene.nee_range
    else:
        rnd = u_pick * area
    valid = rnd < area
    # the CDF pick: first triangle with prefix > rnd == count(prefix <= rnd)
    sel = torch.sum(prefix[None, :] <= rnd[:, None], dim=1)
    tabs = (scene.lt_v0, scene.lt_v1, scene.lt_v2,
            scene.lt_n0, scene.lt_n1, scene.lt_n2)
    if K <= CHAIN_LIMIT:
        sel = torch.clamp_max(sel, K - 1)
        lv0, lv1, lv2, ln0, ln1, ln2 = (
            chain_lookup_planes(tab[l, :K], sel) for tab in tabs)
    else:
        # the JAX package's one-hot matmul: rnd past the last prefix
        # selects no row (a zero row, masked by ``valid`` below)
        tab = torch.cat([t[l, :K] for t in tabs], dim=1)     # (K, 18)
        tab = torch.cat([tab, tab.new_zeros((1, 18))])
        rows = gather_rows(tab, sel)                  # (R, 18) exact rows
        p = lambda col: rows[:, col]
        lv0, lv1, lv2 = (p(0), p(1), p(2)), (p(3), p(4), p(5)), (p(6), p(7), p(8))
        ln0, ln1, ln2 = (p(9), p(10), p(11)), (p(12), p(13), p(14)), (p(15), p(16), p(17))

    if config.light_sampler == "ref":
        s = u1 + u2 + u3
        s = torch.where(s == 0.0, _c(1.0, s), s)
        p1, p2, p3 = u1 / s, u2 / s, u3 / s
    else:
        su = torch.sqrt(torch.clamp(u1, 0.0, 1.0))
        p1, p2, p3 = 1.0 - su, su * (1.0 - u2), su * u2
    bc = lambda a, b, c: (
        a[0] * p1 + b[0] * p2 + c[0] * p3,
        a[1] * p1 + b[1] * p2 + c[1] * p3,
        a[2] * p1 + b[2] * p2 + c[2] * p3,
    )
    light_p = bc(lv0, lv1, lv2)
    light_n = vec.normalize(bc(ln0, ln1, ln2))

    to_light = vec.sub(light_p, point)
    r2 = torch.clamp_min(vec.length2(to_light), 1e-20)
    dist = torch.sqrt(r2)
    wo = vec.scale(to_light, torch.reciprocal(torch.clamp_min(dist, 1e-20)))

    cos_o = vec.dot(wo, pn)
    ok = shade_mask & valid & (cos_o > 0.0)

    cos_p = vec.dot(wo, light_n).abs()
    geom = cos_p * cos_o.abs() / r2 * area            # pdf = 1/area
    lr = scene.light_radiance[l]

    h = vec.normalize(vec.add(wi, wo))
    cos_alpha = torch.clamp_min(vec.dot(pn, h), 0.0)
    phong_s = ((ns + 2.0) * f32_transcendental(torch.pow, cos_alpha, ns)
               / _c(2.0 * PI, ns))
    pi = _c(PI, ns)
    contrib = (
        lr[0] * geom * (kd_val[0] / pi + ks[0] * phong_s),
        lr[1] * geom * (kd_val[1] / pi + ks[1] * phong_s),
        lr[2] * geom * (kd_val[2] / pi + ks[2] * phong_s),
    )
    zero = torch.zeros_like(geom)
    contrib = vec.where(ok, contrib, (zero, zero, zero))
    return wo, contrib, dist, ok


def camera_rays(cam: Camera, key, dev):
    """The camera ray both fused renderers start a path with: a function
    (pixel ids, path ids) -> (org, dir, path key planes), jittered from
    the path key's bits, the key kept for the bounce draws."""
    f32 = torch.float32
    c = lambda x: torch.tensor(x, dtype=f32, device=dev)
    W, H = cam.width, cam.height
    eye, horizontal, vertical, llc = (
        tuple(float(x) for x in v.tolist()) for v in camera_basis(cam))
    c_w1, c_w, c_h1, c_h = c(W - 1.0), c(float(W)), c(H - 1.0), c(float(H))

    def ray(pix, path_id):
        i = (pix // W).to(f32)
        j = (pix % W).to(f32)
        pk0, pk1 = path_keys(key, path_id)
        h1 = bits_to_uniform(pk0)
        h2 = bits_to_uniform(pk1)
        x = j / c_w1 + (h1 - 0.5) / c_w
        y = (H - i) / c_h1 + (h2 - 0.5) / c_h
        d = tuple(llc[k] + x * horizontal[k] + y * vertical[k] - eye[k]
                  for k in range(3))
        d = vec.normalize(d)
        return vec.splat(eye, d[0]), d, (pk0, pk1)

    return ray


def pixel_tile_order(W: int, H: int, tile: int = 32):
    """Static pixel visitation order: 32x32 image tiles in row-major tile
    order, row-major within each tile. Returns numpy (order, inv):
    order[slot] = pixel, inv[pixel] = slot."""
    ys, xs = np.mgrid[0:H, 0:W]
    key = (
        ((ys // tile) * ((W + tile - 1) // tile) + (xs // tile)).ravel()
        * (tile * tile)
        + (ys % tile).ravel() * tile
        + (xs % tile).ravel()
    )
    order = np.argsort(key, kind="stable").astype(np.int32)
    inv = np.empty_like(order)
    inv[order] = np.arange(order.size, dtype=np.int32)
    return order, inv


# ---------------------------------------------------------------------------
# the pixel-persistent renderer (reference main.cpp:79-113 sample loop)
# ---------------------------------------------------------------------------

def render_fused(scene, cam: Camera, key, config: RenderConfig, spp: int,
                 lanes: int = 262144, max_iters: int | None = None,
                 slot_base: int = 0, n_slots: int | None = None):
    """Render with the fused pixel-persistent wavefront on ``scene``'s
    device (the JAX package's ``render_fused``).

    ``key`` is the (2,) master key words (``ops.rng.master_key_data``).
    Lanes serve pixels in 32x32-tile order (``pixel_tile_order``): lane l
    of epoch e serves slot ``slot_base + e*R + l``; ``n_slots`` (default
    all pixels) bounds the slot range. Returns the (n_epochs*R, 3) float32
    linear image in SLOT order and the traced-ray count (float32 0-d).
    Requires scene.bvh with packed leaves.
    """
    dev = scene.device
    f32, i64 = torch.float32, torch.int64
    c = lambda x: torch.tensor(x, dtype=f32, device=dev)
    W, H = cam.width, cam.height
    n_pix_total = W * H
    if n_slots is None:
        n_slots = n_pix_total
    R = min(lanes, n_slots)
    R = -(-R // 128) * 128                           # full lane tiles
    n_epochs = -(-n_slots // R)
    if max_iters is None:
        max_iters = (int(spp * (1.0 / (1.0 - config.p_rr)) * 3)
                     + config.max_depth + 9)

    # padded by R so every epoch's window of R slots stays in bounds
    order = torch.as_tensor(np.concatenate(
        [pixel_tile_order(W, H)[0], np.zeros(R, np.int32)]),
        dtype=i64, device=dev)
    camera_ray = camera_rays(cam, key, dev)
    inv_spp = c(1.0 / spp)
    L = scene.light_mtl.shape[0]
    light_mtl_f = [scene.light_mtl[l].to(f32) for l in range(L)]

    zero = torch.zeros(R, dtype=f32, device=dev)
    one = torch.ones(R, dtype=f32, device=dev)
    z3 = (zero, zero, zero)
    up = vec.splat((0.0, 0.0, 1.0), zero)
    far3 = vec.splat((_FAR, _FAR, _FAR), zero)
    lane = torch.arange(R, dtype=i64, device=dev)
    img = torch.zeros((n_epochs * R, 3), dtype=f32, device=dev)
    rays_traced = torch.zeros((), dtype=f32, device=dev)

    for e in range(n_epochs):
        count("fused.epochs")
        slot = slot_base + e * R + lane
        in_range = (lane + e * R < n_slots) & (slot < n_pix_total)
        # dynamic_slice clamps its start so the window stays in bounds
        start = min(max(slot_base + e * R, 0), order.shape[0] - R)
        pixel = order[start:start + R]

        it = 0
        active = torch.zeros(R, dtype=torch.bool, device=dev)
        samples_done = torch.zeros(R, dtype=i64, device=dev)
        bounce = torch.zeros(R, dtype=i64, device=dev)
        o, d = z3, up
        ray_type = torch.full((R,), CAMERA, dtype=i64, device=dev)
        thr, rad, accum = (one, one, one), z3, z3
        sh_o, sh_d = [far3] * L, [up] * L              # parked shadow legs
        pend_ok = [torch.zeros(R, dtype=torch.bool, device=dev)] * L
        pend_c, pend_dist = [z3] * L, [zero] * L
        pkd = (torch.zeros(R, dtype=i64, device=dev),) * 2
        ray_count = zero

        def more():
            m = active.any() | (in_range & (samples_done < spp)).any()
            for p in pend_ok:
                m = m | p.any()
            with span("fused.more.sync"):
                return bool(m)

        while it < max_iters and more():
            count("fused.iterations")
            with span("fused.iter"):
                # --- regenerate: start the pixel's next sample on dead lanes
                can = ~active & in_range & (samples_done < spp)
                path_id = torch.where(can, pixel * spp + samples_done, 0)
                norg, nd, npk = camera_ray(path_id // spp, path_id)
                pkd = (torch.where(can, npk[0], pkd[0]),
                       torch.where(can, npk[1], pkd[1]))
                o = vec.where(can, norg, o)
                d = vec.where(can, nd, d)
                ray_type = torch.where(can, CAMERA, ray_type)
                thr = vec.where(can, (one, one, one), thr)
                rad = vec.where(can, z3, rad)
                bounce = torch.where(can, 0, bounce)
                samples_done = samples_done + can.to(i64)
                active = active | can
                o = vec.where(active, o, far3)

                # --- ONE trace: [bounce rays | L shadow-ray groups], shadow
                # legs bounded at their light distance, dead lanes at 0
                cat = lambda main, sh: torch.cat([main] + sh)
                tb = cat(torch.where(active, c(_INF), c(0.0)),
                         [torch.where(pend_ok[l], pend_dist[l], c(0.0))
                          for l in range(L)])
                tg = cat(torch.full((R,), -2.0, dtype=f32, device=dev),
                         [torch.where(pend_ok[l], light_mtl_f[l], c(-2.0))
                          for l in range(L)])
                t_all, pnx_a, pny_a, pnz_a, tcu_a, tcv_a, mtl_a, em_a = (
                    fused_trace_planes(
                        scene, *(cat(o[k], [s[k] for s in sh_o]) for k in range(3)),
                        *(cat(d[k], [s[k] for s in sh_d]) for k in range(3)),
                        config, t_bound=tb, target_mtl=tg))
                ray_count = ray_count + active.to(f32)
                for l in range(L):
                    ray_count = ray_count + pend_ok[l].to(f32)

                # --- resolve LAST iteration's NEE with this trace's shadow legs
                for l in range(L):
                    sl = slice((1 + l) * R, (2 + l) * R)
                    if config.shadow_test == "mtl":
                        vis = mtl_a[sl] == light_mtl_f[l]      # miss -1, killed -3
                    else:
                        vis = ~((mtl_a[sl] == -3.0) | (
                            (mtl_a[sl] >= 0.0)
                            & (t_all[sl] < pend_dist[l] - c(1e-3))))
                    add = pend_ok[l] & vis
                    accum = tuple(accum[k] + torch.where(
                        add, pend_c[l][k] * inv_spp, zero) for k in range(3))

                # --- shade the bounce leg
                t, m = t_all[:R], mtl_a[:R]
                hit = m >= 0.0
                point = vec.add(o, vec.scale(d, t))
                pn = vec.normalize((pnx_a[:R], pny_a[:R], pnz_a[:R]))
                hit_emissive = hit & (em_a[:R] > 0.5)
                include = (ray_type == CAMERA) | (ray_type == TRANSMISSION)
                emit = active & hit_emissive & include
                mat = _material_planes(scene, m)
                mrad = mat["rad"]
                rad = tuple(rad[k] + torch.where(emit, thr[k] * mrad[k], zero)
                            for k in range(3))
                shade_mask = active & hit & ~hit_emissive
                kd_val = _tex_kd(scene, mat, tcu_a[:R], tcv_a[:R], mat["kd"])
                ks, ns = mat["ks"], mat["ns"]
                wi = vec.neg(d)

                # --- per-(path, bounce) uniforms: 4 per light, 5 for RR/BSDF
                draws = bounce_uniforms(pkd[0], pkd[1], bounce, 4 * L + 5)

                # --- queue THIS bounce's NEE (resolved next iteration),
                # pre-scaled by the throughput
                pend_ok, pend_c, pend_dist, sh_o, sh_d = [], [], [], [], []
                for l in range(L):
                    wo, contrib, distl, okl = _nee_geometry(
                        scene, config, l, point, pn, wi, kd_val, ks, ns,
                        draws[4 * l + 0], draws[4 * l + 1],
                        draws[4 * l + 2], draws[4 * l + 3], shade_mask)
                    pend_ok.append(okl)
                    pend_c.append(vec.mul(thr, contrib))
                    pend_dist.append(distl)
                    sh_o.append(vec.where(okl, point, far3))
                    sh_d.append(vec.where(okl, wo, up))

                # --- Russian roulette + BSDF continuation
                u = [draws[4 * L + i] for i in range(5)]
                survive = (shade_mask & (u[0] < c(config.p_rr))
                           & (bounce + 1 < config.max_depth))
                new_dir, new_type = sample_bsdf_planar(
                    d, pn, mat["kd"], ks, ns, mat["ni"], u[1], u[2], u[3], u[4])
                alive_next = survive & (new_type != INVALID)
                if config.specular_weight == "ref":
                    ds_weight = kd_val
                else:
                    ds_weight = vec.where(new_type == SPECULAR, ks, kd_val)
                weight = vec.where(new_type == TRANSMISSION, mat["tr"], ds_weight)
                inv_prr = c(1.0 / config.p_rr)
                thr = vec.where(
                    alive_next,
                    tuple(thr[k] * weight[k] * inv_prr for k in range(3)), thr)
                o = vec.where(alive_next, point, o)
                d = vec.where(alive_next, new_dir, up)
                ray_type = torch.where(alive_next, new_type, ray_type)
                bounce = bounce + 1

                # --- finished paths: emissive radiance into the lane's pixel
                finished = active & ~alive_next
                accum = tuple(accum[k] + torch.where(finished, rad[k] * inv_spp,
                                                     zero) for k in range(3))
                active = alive_next
                it += 1

        img[e * R:(e + 1) * R] = torch.stack(accum, dim=-1)
        rays_traced = rays_traced + torch.sum(ray_count)
    return img, rays_traced


def render_fused_stats(scene, cam: Camera, key, config: RenderConfig,
                       spp: int, lanes: int = 262144):
    """The whole image in pixel order, (H, W, 3), and the traced-ray count
    (the JAX package's ``render_fused_stats_jit``)."""
    img, rays = render_fused(scene, cam, key, config, spp, lanes)
    inv = torch.as_tensor(pixel_tile_order(cam.width, cam.height)[1],
                          dtype=torch.int64, device=img.device)
    return img[inv].reshape(cam.height, cam.width, 3), rays


def render_fused_image(scene, cam: Camera, key, config: RenderConfig,
                       spp: int, lanes: int = 262144) -> torch.Tensor:
    """The (H, W, 3) image alone (the JAX package's ``render_fused_jit``)."""
    return render_fused_stats(scene, cam, key, config, spp, lanes)[0]
