"""Component-plane vector math: each vector is an (x, y, z) triple of
equal-shape tensors, the planar layout of ``tinyraytracing_tpu/ops/vec.py``
(same helpers, same operation order, so float results match op for op)."""

from __future__ import annotations

import torch

V3 = tuple  # (x, y, z) component triple


def splat(v, like: torch.Tensor):
    """Broadcast a 3-vector constant to float32 planes shaped like ``like``."""
    return tuple(
        torch.full(like.shape, float(v[k]), dtype=torch.float32,
                   device=like.device)
        for k in range(3)
    )


def add(a, b):
    return a[0] + b[0], a[1] + b[1], a[2] + b[2]


def sub(a, b):
    return a[0] - b[0], a[1] - b[1], a[2] - b[2]


def mul(a, b):
    return a[0] * b[0], a[1] * b[1], a[2] * b[2]


def scale(a, s):
    return a[0] * s, a[1] * s, a[2] * s


def neg(a):
    return -a[0], -a[1], -a[2]


def dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def cross(a, b):
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def length2(a):
    return dot(a, a)


def length(a):
    return torch.sqrt(torch.clamp_min(length2(a), 0.0))


def normalize(a):
    # 1/sqrt rather than torch.rsqrt: both are correctly rounded on CPU and
    # CUDA, where rsqrtf is an approximation — so the two devices agree
    inv = torch.reciprocal(torch.sqrt(torch.clamp_min(length2(a), 1e-30)))
    return scale(a, inv)


def where(m, a, b):
    return (
        torch.where(m, a[0], b[0]),
        torch.where(m, a[1], b[1]),
        torch.where(m, a[2], b[2]),
    )


def reflect(d, n):
    """glm::reflect: d - 2 dot(d,n) n."""
    k = 2.0 * dot(d, n)
    return d[0] - k * n[0], d[1] - k * n[1], d[2] - k * n[2]


def refract(d, n, eta):
    """glm::refract; returns (dir, tir_mask)."""
    cosi = dot(n, d)
    k = 1.0 - eta * eta * (1.0 - cosi * cosi)
    tir = k < 0.0
    s = eta * cosi + torch.sqrt(torch.clamp_min(k, 0.0))
    out = (eta * d[0] - s * n[0], eta * d[1] - s * n[1], eta * d[2] - s * n[2])
    return out, tir
