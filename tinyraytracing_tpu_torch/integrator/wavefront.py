"""Fixed-depth wavefront path tracing — the counterpart of
``tinyraytracing_tpu/integrator/wavefront.py::trace``, the loop of the
scan renderer (``render.py::render``).

The reference's recursive shade() (pathTracing.cpp:3-102) as a loop of
``config.max_depth`` bounce waves over the whole ray batch. Per bounce:
closest hit (``ops/intersect.py``, the configured backend); emissive hits
add throughput * radiance when the previous bounce was the camera or a
TRANSMISSION ray (pathTracing.cpp:87-96); other hits shade: interpolated
normal, Kd from texture or material, next-event estimation
(``integrator/nee.py``; dead lanes park at 1e30), Russian roulette with
p_rr and BSDF sampling (``integrator/bsdf.py``); the throughput takes
Kd (or Ks for SPECULAR under specular_weight "ks") or Tr, over p_rr.
Dead rays keep the direction (0, 0, 1) so the next intersect stays
NaN-free. One bounce wave is ``bounce``, which the regeneration oracles
(``integrator/regen.py``) run too.

The sample streams are ``jax.random``'s: bounce ``depth`` draws from
``kb = fold_in(key, depth)``, with ``uniform(fold_in(kb, 0), (R, L, 4))``
for NEE and ``uniform(fold_in(kb, 1), (5, R))`` for roulette and BSDF.
Under ``config.detach_sampling`` the sampled bounce direction is
detached, as in the JAX package: ``diff.inverse.render_loss``
differentiates this loop with the sampling decisions held fixed.
"""

from __future__ import annotations

import torch

from tinyraytracing_tpu_torch.config import CAMERA, INVALID, SPECULAR, TRANSMISSION, RenderConfig
from tinyraytracing_tpu_torch.integrator.bsdf import sample_bsdf
from tinyraytracing_tpu_torch.integrator.nee import direct_light
from tinyraytracing_tpu_torch.ops.intersect import intersect
from tinyraytracing_tpu_torch.ops.linalg import normalize
from tinyraytracing_tpu_torch.ops.lookup import gather_rows
from tinyraytracing_tpu_torch.ops.rng import fold_in, uniform


def bounce(scene, config: RenderConfig, org, d, ray_type, throughput, radiance,
           alive, kb, last=None):
    """One bounce wave over R rays: the loop body of ``trace``, and of the
    regeneration oracles (``integrator/regen.py``). ``kb``: the bounce's
    key words; ``last``: optional (R,) bool, the lanes whose path may not
    continue past this bounce. Returns (radiance, throughput, org, d,
    ray_type, alive, shade_mask) after the bounce; dead lanes keep their
    throughput and origin and take the direction (0, 0, 1).

    Tables that can carry a gradient (materials, radiance, shading
    normals) are gathered with ``ops.lookup.gather_rows``, whose backward
    sums the cotangent rows in a fixed order."""
    R = org.shape[0]
    L = scene.light_mtl.shape[0]
    dev = org.device
    f32 = torch.float32
    zero = torch.zeros((), dtype=f32, device=dev)
    p_rr = torch.tensor(config.p_rr, dtype=f32, device=dev)
    up = torch.tensor([0.0, 0.0, 1.0], dtype=f32, device=dev)

    def intersect_fn(o, dd):
        return intersect(scene, o, dd, config)

    hit = intersect_fn(org, d)
    idx = hit.idx
    m = scene.tri_mtl[idx].to(torch.int64)
    point = org + hit.t[:, None] * d
    kd, ks, ns, ni, tr, mrad = (gather_rows(t, m) for t in (
        scene.kd, scene.ks, scene.ns, scene.ni, scene.tr, scene.radiance))

    hit_emissive = hit.hit & scene.tri_emissive[idx]
    include_emis = (ray_type == CAMERA) | (ray_type == TRANSMISSION)
    radiance = radiance + torch.where(
        (alive & hit_emissive & include_emis)[:, None], throughput * mrad, zero)

    shade_mask = alive & hit.hit & ~hit_emissive

    # interpolated shading normal (free Moller-Trumbore barycentrics)
    w = hit.w
    pn = normalize(gather_rows(scene.n0, idx) * w[:, None]
                   + gather_rows(scene.n1, idx) * hit.u[:, None]
                   + gather_rows(scene.n2, idx) * hit.v[:, None])

    # diffuse albedo: texture or constant (pathTracing.cpp:15-30)
    tid = scene.tex_id[m]
    has_tex = tid >= 0
    tid_safe = torch.clamp_min(tid, 0).to(torch.int64)
    col = scene.t0[idx, 0] * w + scene.t1[idx, 0] * hit.u + scene.t2[idx, 0] * hit.v
    row = scene.t0[idx, 1] * w + scene.t1[idx, 1] * hit.u + scene.t2[idx, 1] * hit.v
    icol = col - torch.floor(col)
    irow = row - torch.floor(row)
    th = scene.tex_hw[tid_safe, 0]
    tw = scene.tex_hw[tid_safe, 1]
    r_ix = torch.minimum(torch.clamp_min((irow * th).to(torch.int32), 0), th - 1)
    c_ix = torch.minimum(torch.clamp_min((icol * tw).to(torch.int32), 0), tw - 1)
    tex_val = scene.tex[tid_safe, r_ix.to(torch.int64), c_ix.to(torch.int64)]
    kd_val = torch.where(has_tex[:, None], tex_val, kd)

    # NEE; dead lanes are parked far outside the scene, so their shadow
    # rays fail the root box (their contribution is masked below)
    wi = -d
    nee_uniforms = uniform(fold_in(kb, 0), (R, L, 4), dev)
    point_sh = torch.where(shade_mask[:, None], point,
                           torch.full((), 1.0e30, dtype=f32, device=dev))
    l_dir = direct_light(scene, config, intersect_fn, point_sh, pn, wi,
                         kd_val, ks, ns, nee_uniforms)
    radiance = radiance + torch.where(shade_mask[:, None], throughput * l_dir, zero)

    # Russian roulette (pathTracing.cpp:78) + BSDF sampling
    u = uniform(fold_in(kb, 1), (5, R), dev)
    survive = shade_mask & (u[0] < config.p_rr)
    if last is not None:
        survive = survive & ~last
    new_dir, new_type = sample_bsdf(d, pn, kd, ks, ns, ni, u[1], u[2], u[3], u[4])
    if config.detach_sampling:
        new_dir = new_dir.detach()
    alive = survive & (new_type != INVALID)

    # bounce weight (pathTracing.cpp:85-97): Kd for DIFFUSE/SPECULAR
    # ("ref") or Ks for SPECULAR ("ks"), Tr for TRANSMISSION
    if config.specular_weight == "ref":
        ds_weight = kd_val
    else:
        ds_weight = torch.where((new_type == SPECULAR)[:, None], ks, kd_val)
    weight = torch.where((new_type == TRANSMISSION)[:, None], tr, ds_weight)
    throughput = torch.where(alive[:, None], throughput * weight / p_rr, throughput)

    d = torch.where(alive[:, None], new_dir, up)
    org = torch.where(alive[:, None], point, org)
    return radiance, throughput, org, d, new_type, alive, shade_mask


def trace(scene, org, d, key, config: RenderConfig, return_stats: bool = False):
    """Estimate radiance for a batch of camera rays (R, 3) on their device.
    ``key``: (k0, k1) key words. Returns (R, 3); with ``return_stats`` also
    {"primary": (max_depth,), "shadow": (max_depth,)} int64 ray counts per
    bounce (rays alive at the closest-hit trace, shadow rays cast)."""
    R = org.shape[0]
    L = scene.light_mtl.shape[0]
    dev = org.device
    ray_type = torch.full((R,), CAMERA, dtype=torch.int32, device=dev)
    throughput = torch.ones((R, 3), dtype=torch.float32, device=dev)
    radiance = torch.zeros((R, 3), dtype=torch.float32, device=dev)
    alive = torch.ones((R,), dtype=torch.bool, device=dev)
    stats = {"primary": [], "shadow": []}
    for depth in range(config.max_depth):
        if return_stats:     # launches of their own: only when asked for
            stats["primary"].append(alive.sum())
        radiance, throughput, org, d, ray_type, alive, shade_mask = bounce(
            scene, config, org, d, ray_type, throughput, radiance, alive,
            fold_in(key, depth))
        if return_stats:
            stats["shadow"].append(shade_mask.sum() * L)
    if return_stats:
        return radiance, {k: torch.stack(v) for k, v in stats.items()}
    return radiance
