"""Monte-Carlo direction and light-point sampling, the counterpart of
``tinyraytracing_tpu/ops/sampling.py`` (reference Sample(),
RayTracingOnCPU/pathTracing.cpp:111-145, and the light-point barycentrics
of pathTracing.cpp:44-47), on (..., 3) tensors.

The transcendentals go through ``f32_transcendental``: evaluated in float64
and rounded to float32, which is the correctly rounded float32 result on
the card and on the CPU alike (their float32 sin, cos, asin, acos and pow
differ in the last ulp, and one ulp flips a grazing bounce).
"""

from __future__ import annotations

import math

import torch

from tinyraytracing_tpu_torch.ops.linalg import cross, normalize

PI = math.pi


def f32_transcendental(fn, *xs):
    """``fn`` of float32 tensors, evaluated in float64, rounded to float32."""
    return fn(*(x.double() for x in xs)).float()


def reference_onb(axis):
    """(right, front) completing ``axis`` to the reference's local frame:
    front = |a.x| > |a.y| ? normalize(a.z, 0, -a.x) : normalize(0, -a.z, a.y)."""
    ax, ay, az = axis[..., 0], axis[..., 1], axis[..., 2]
    zeros = torch.zeros_like(ax)
    f1 = torch.stack([az, zeros, -ax], dim=-1)
    f2 = torch.stack([zeros, -az, ay], dim=-1)
    front = normalize(torch.where((ax.abs() > ay.abs())[..., None], f1, f2))
    right = cross(axis, front)
    return right, front


def sample_lobe(axis, u_phi, u_theta, is_diffuse, ns):
    """Sample a direction about ``axis``: cosine lobe when is_diffuse else
    Phong lobe with exponent ns. All args broadcast over leading dims."""
    t = f32_transcendental
    phi = 2.0 * PI * u_phi
    theta_d = t(torch.arcsin, torch.sqrt(torch.clamp(u_theta, 0.0, 1.0)))
    theta_s = t(torch.arccos, torch.clamp(
        t(torch.pow, torch.clamp_min(u_theta, 1e-30), 1.0 / (ns + 1.0)), -1.0, 1.0))
    theta = torch.where(is_diffuse, theta_d, theta_s)
    sx = t(torch.sin, theta) * t(torch.cos, phi)
    sy = t(torch.cos, theta)
    sz = t(torch.sin, theta) * t(torch.sin, phi)
    right, front = reference_onb(axis)
    out = right * sx[..., None] + axis * sy[..., None] + front * sz[..., None]
    return normalize(out)


def barycentric_ref(u1, u2, u3):
    """The reference's light-point barycentrics: three uniforms normalized
    by their sum (not uniform over the triangle; config.light_sampler "ref")."""
    s = u1 + u2 + u3
    s = torch.where(s == 0.0, torch.ones_like(s), s)
    return u1 / s, u2 / s, u3 / s


def barycentric_uniform(u1, u2):
    """Uniform-over-area barycentrics (sqrt warp; light_sampler "uniform")."""
    su = torch.sqrt(torch.clamp(u1, 0.0, 1.0))
    p1 = 1.0 - su
    p2 = su * (1.0 - u2)
    p3 = su * u2
    return p1, p2, p3
