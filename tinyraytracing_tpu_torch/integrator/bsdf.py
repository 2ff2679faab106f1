"""BSDF sampling in the (R, 3) layout — the counterpart of
``tinyraytracing_tpu/integrator/bsdf.py::sample_bsdf`` (reference
nextRay(), RayTracingOnCPU/pathTracing.cpp:147-209). The queue renderer's
planar version is ``integrator/fused.py::sample_bsdf_planar``.

Per ray, all branches evaluated and masked: refractive materials
(Ni > 1) refract with probability 1 - F (Schlick), mirror-reflecting on
total internal reflection; otherwise (and with probability F) the lobe is
chosen by |Kd| : |Ks| — cosine lobe about the shading normal (DIFFUSE),
Phong lobe about the mirror direction when Ns > 1 (SPECULAR), else
INVALID (the path dies). Zero Kd and Ks give INVALID.
"""

from __future__ import annotations

import torch

from tinyraytracing_tpu_torch.config import DIFFUSE, INVALID, SPECULAR, TRANSMISSION
from tinyraytracing_tpu_torch.ops.linalg import dot, length, reflect, refract
from tinyraytracing_tpu_torch.ops.sampling import f32_transcendental, sample_lobe


def sample_bsdf(d, pn, kd, ks, ns, ni, u_fresnel, u_lobe, u_phi, u_theta):
    """Sample the next ray direction and type for a batch of hits.

    d: (R,3) incoming ray direction; pn: (R,3) shading normal;
    kd/ks: (R,3); ns/ni: (R,); u_*: (R,) uniforms.
    Returns (new_dir (R,3), ray_type (R,) int32).
    """
    one = torch.ones_like(ni)
    # --- Fresnel / refraction branch (Ni > 1) ---
    cos_in = dot(d, pn)
    exiting = cos_in > 0.0
    normal = torch.where(exiting[:, None], -pn, pn)
    n1 = torch.where(exiting, ni, one)
    n2 = torch.where(exiting, one, ni)
    rf0 = torch.square((n1 - n2) / (n1 + n2))
    fresnel = rf0 + (1.0 - rf0) * f32_transcendental(
        lambda x: torch.pow(x, 5.0), 1.0 - cos_in.abs())
    take_refract = (ni > 1.0) & (fresnel < u_fresnel)

    refr_dir, tir = refract(d, normal, n1 / n2)
    mirror_normal = reflect(d, normal)

    # --- lobe branch ---
    kd_len = length(kd)
    ks_len = length(ks)
    denom = kd_len + ks_len
    safe = denom > 0.0
    zero = torch.zeros_like(denom)
    safe_denom = torch.where(safe, denom, torch.ones_like(denom))
    kd_frac = torch.where(safe, kd_len / safe_denom, zero)
    ks_frac = torch.where(safe, ks_len / safe_denom, zero)

    is_diffuse = safe & (u_lobe < kd_frac)
    is_specular = safe & ~is_diffuse & (ns > 1.0) & (u_lobe < kd_frac + ks_frac)
    lobe_axis = torch.where(is_diffuse[:, None], pn, reflect(d, pn))
    lobe_dir = sample_lobe(lobe_axis, u_phi, u_theta, is_diffuse, ns)
    i32 = lambda k: torch.tensor(k, dtype=torch.int32, device=d.device)
    lobe_type = torch.where(is_diffuse, i32(DIFFUSE),
                            torch.where(is_specular, i32(SPECULAR), i32(INVALID)))

    # --- combine ---
    new_dir = torch.where(
        take_refract[:, None],
        torch.where(tir[:, None], mirror_normal, refr_dir),
        lobe_dir,
    )
    ray_type = torch.where(
        take_refract,
        torch.where(tir, i32(SPECULAR), i32(TRANSMISSION)),
        lobe_type,
    )
    return new_dir, ray_type
