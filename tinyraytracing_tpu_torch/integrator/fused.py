"""Per-bounce shading helpers of the fused wavefront, ported from
``tinyraytracing_tpu/integrator/fused.py`` (BSDF sampling, material and
light-table lookups, next-event geometry, the tile-order pixel queue).

Everything is planar: vectors are (x, y, z) triples of (R,) float32
tensors, computed in the JAX package's operation order. Divisions by a
constant divide by a float32 tensor on the data's device (not a Python
scalar, which CUDA turns into a multiply by the reciprocal), and
normalisation is a correctly rounded 1/sqrt (ops/vec.py) — so CPU and
CUDA results differ only in the transcendental functions' last ulps.

The persistent renderer (``render_fused``) is not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import numpy as np
import torch

from tinyraytracing_tpu_torch.config import DIFFUSE, INVALID, SPECULAR, TRANSMISSION
from tinyraytracing_tpu_torch.ops import vec
from tinyraytracing_tpu_torch.ops.lookup import CHAIN_LIMIT, chain_lookup, chain_lookup_planes
from tinyraytracing_tpu_torch.ops.sampling import PI

# parked rays: origin far outside any scene AABB, so every slab test fails
_FAR = 1.0e30


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
    phi = (2.0 * PI) * u_phi
    theta_d = torch.arcsin(torch.sqrt(torch.clamp(u_theta, 0.0, 1.0)))
    theta_s = torch.arccos(torch.clamp(
        torch.pow(torch.clamp_min(u_theta, 1e-30), 1.0 / (ns + 1.0)),
        -1.0, 1.0))
    theta = torch.where(is_diffuse, theta_d, theta_s)
    st = torch.sin(theta)
    sx = st * torch.cos(phi)
    sy = torch.cos(theta)
    sz = st * torch.sin(phi)
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
    fresnel = rf0 + (1.0 - rf0) * torch.pow(1.0 - cos_in.abs(), 5.0)
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
        rows = tab[sel]                               # (R, 18) exact rows
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
    phong_s = (ns + 2.0) * torch.pow(cos_alpha, ns) / _c(2.0 * PI, ns)
    pi = _c(PI, ns)
    contrib = (
        lr[0] * geom * (kd_val[0] / pi + ks[0] * phong_s),
        lr[1] * geom * (kd_val[1] / pi + ks[1] * phong_s),
        lr[2] * geom * (kd_val[2] / pi + ks[2] * phong_s),
    )
    zero = torch.zeros_like(geom)
    contrib = vec.where(ok, contrib, (zero, zero, zero))
    return wo, contrib, dist, ok


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
