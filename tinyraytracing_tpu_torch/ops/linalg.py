"""Batched vector math on (..., 3) tensors (last axis = xyz), the
counterpart of ``tinyraytracing_tpu/ops/linalg.py``.

Sums over the 3 components are written out in x, y, z order, so a result
does not depend on how a backend reduces a length-3 axis; ``normalize``
multiplies by the reciprocal of the clamped length, as the JAX package does.
"""

from __future__ import annotations

import torch

EPS_NORM = 1e-20


def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a, b):
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def length(a):
    return torch.sqrt(torch.clamp_min(dot(a, a), 0.0))


def length2(a):
    return dot(a, a)


def normalize(a):
    return a * torch.reciprocal(torch.clamp_min(length(a), EPS_NORM))[..., None]


def reflect(d, n):
    """glm::reflect: d - 2*dot(d,n)*n."""
    return d - 2.0 * dot(d, n)[..., None] * n


def refract(d, n, eta):
    """glm::refract semantics: returns (refracted_dir, total_internal_reflection)
    (k = 1 - eta^2 (1 - dot(n,d)^2); TIR iff k < 0)."""
    cosi = dot(n, d)
    k = 1.0 - eta * eta * (1.0 - cosi * cosi)
    tir = k < 0.0
    ksafe = torch.clamp_min(k, 0.0)
    out = eta[..., None] * d - (eta * cosi + torch.sqrt(ksafe))[..., None] * n
    return out, tir
