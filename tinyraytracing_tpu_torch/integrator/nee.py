"""Next-event estimation (direct light) in the (R, 3) layout — the
counterpart of ``tinyraytracing_tpu/integrator/nee.py::direct_light``
(reference per-light loop in shade(), RayTracingOnCPU/pathTracing.cpp:34-74).

Per shading point and light: pick a light triangle by the first prefix
area > rnd (rnd scaled by the FIRST light's area under light_sampler
"ref", the reference's quirk); sample a point on it; trace one shadow
ray (all R*L of them as one flattened batch); visibility is the light's
material being hit ("mtl") or nothing closer than the light ("tmin");
the contribution is radiance * cos * cos / r^2 * area times the Phong
half-vector BRDF Kd/pi + Ks (Ns+2)/(2 pi) cos^Ns.
"""

from __future__ import annotations

import torch

from tinyraytracing_tpu_torch.config import RenderConfig
from tinyraytracing_tpu_torch.ops.linalg import dot, length2, normalize
from tinyraytracing_tpu_torch.ops.sampling import (
    PI, barycentric_ref, barycentric_uniform, f32_transcendental,
)


def direct_light(scene, config: RenderConfig, intersect_fn,
                 point, pn, wi, kd_val, ks, ns, uniforms):
    """Direct-light radiance for R shading points. Returns (R, 3).

    uniforms: (R, L, 4) — pick, and 3 barycentric draws per light.
    intersect_fn(org, dir) -> Hit over flattened ray batches.
    """
    R = point.shape[0]
    L, K = scene.lt_prefix.shape
    # constant divisors as float32 tensors: CUDA turns a division by a
    # Python scalar into a multiplication by its reciprocal
    c = lambda x: torch.tensor(x, dtype=torch.float32, device=point.device)

    u_pick = uniforms[:, :, 0]                               # (R, L)
    if config.light_sampler == "ref":
        rnd = u_pick * scene.nee_range
    else:
        rnd = u_pick * scene.light_area[None, :]
    valid = rnd < scene.light_area[None, :]                  # (R, L)

    # first triangle with prefix > rnd (padding prefix = +inf); argmax
    # returns the first maximum, as jnp.argmax does
    sel = (scene.lt_prefix[None, :, :] > rnd[:, :, None]).to(torch.int8).argmax(dim=-1)

    def take(table):  # (L, K, 3) -> (R, L, 3)
        return torch.gather(table[None].expand(R, L, K, 3), 2,
                            sel[:, :, None, None].expand(R, L, 1, 3))[:, :, 0, :]

    lv0, lv1, lv2 = take(scene.lt_v0), take(scene.lt_v1), take(scene.lt_v2)
    ln0, ln1, ln2 = take(scene.lt_n0), take(scene.lt_n1), take(scene.lt_n2)

    if config.light_sampler == "ref":
        p1, p2, p3 = barycentric_ref(
            uniforms[:, :, 1], uniforms[:, :, 2], uniforms[:, :, 3])
    else:
        p1, p2, p3 = barycentric_uniform(uniforms[:, :, 1], uniforms[:, :, 2])
    bc = lambda a, b, cc: a * p1[..., None] + b * p2[..., None] + cc * p3[..., None]
    light_p = bc(lv0, lv1, lv2)                              # (R, L, 3)
    light_n = normalize(bc(ln0, ln1, ln2))

    to_light = light_p - point[:, None, :]
    wo = normalize(to_light)                                 # (R, L, 3)

    # shadow rays: closest hit, flattened (R*L,)
    sh = intersect_fn(point[:, None, :].expand(R, L, 3).reshape(R * L, 3),
                      wo.reshape(R * L, 3))
    hit_mtl = torch.where(sh.hit, scene.tri_mtl[sh.idx].to(torch.int32),
                          torch.full_like(sh.idx, -1, dtype=torch.int32)
                          ).reshape(R, L)
    if config.shadow_test == "mtl":
        visible = hit_mtl == scene.light_mtl[None, :]
    else:
        dist = torch.sqrt(length2(to_light))
        visible = ~(sh.hit.reshape(R, L) & (sh.t.reshape(R, L) < dist - 1e-3))

    cos_o = dot(wo, pn[:, None, :])                          # (R, L)
    visible = visible & (cos_o > 0.0) & valid

    area = scene.light_area[None, :]
    inv_pdf = area                                           # pdf = 1/area
    cos_p = dot(wo, light_n).abs()
    cos_t = cos_o.abs()
    r2 = torch.clamp_min(length2(to_light), 1e-20)
    intensity = (scene.light_radiance[None, :, :]
                 * (cos_p * cos_t / r2 * inv_pdf)[..., None])   # (R, L, 3)

    h = normalize(wi[:, None, :] + wo)
    cos_alpha = torch.clamp_min(dot(pn[:, None, :], h), 0.0)
    phong = (ks[:, None, :]
             * ((ns[:, None] + 2.0)
                * f32_transcendental(torch.pow, cos_alpha, ns[:, None])
                / c(2.0 * PI))[..., None])
    brdf = kd_val[:, None, :] / c(PI) + phong

    contrib = torch.where(visible[..., None], intensity * brdf,
                          torch.zeros((), dtype=torch.float32, device=point.device))
    # the sum over lights, in light order
    out = contrib[:, 0]
    for l in range(1, L):
        out = out + contrib[:, l]
    return out
