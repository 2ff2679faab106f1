"""Ray-scene closest hit: batched Moller-Trumbore with the reference's
acceptance rules, the emissive tie-break, and the intersector dispatch —
the counterpart of ``tinyraytracing_tpu/ops/intersect.py``.

Acceptance (reference RayTracingOnCPU/bvh.cpp:168-219): |dot(gn, d)| >=
n_dot_d_min, t >= t_min, inside the triangle; the closest hit wins, and
inside the relative tie band ``tie_eps`` an emissive triangle displaces a
non-emissive one.

The brute-force and "mxu" paths are XLA code in the JAX package, so plain
PyTorch is their port; the "bvh_pallas" and "pallas" backends are the
hand-written CUDA kernels of ``ops/bvh_intersect.py`` and
``ops/slot_intersect.py``. Sums over the 3 components are written out in
x, y, z order (``_dot3``) rather than left to a backend's reduction.
"""

from __future__ import annotations

import dataclasses

import torch

from tinyraytracing_tpu_torch.config import RenderConfig
from tinyraytracing_tpu_torch.ops.linalg import cross

INF = 3.0e38

BACKENDS = ("auto", "mxu", "brute", "bvh", "pallas", "bvh_pallas")


@dataclasses.dataclass
class Hit:
    """Per-ray closest-hit record (the reference's HitRecord, bvh.h:7-15)."""

    t: torch.Tensor      # (R,) distance, INF on miss
    idx: torch.Tensor    # (R,) int triangle index, 0 on miss (mask with .hit)
    u: torch.Tensor      # (R,) barycentric weight of v1
    v: torch.Tensor      # (R,) barycentric weight of v2
    hit: torch.Tensor    # (R,) bool

    @property
    def w(self):
        return 1.0 - self.u - self.v


def _dot3(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _matmul3(x, w):
    """(R, 3) x (C, 3)^T -> (R, C), summed over the depth 3 in x, y, z order."""
    return (x[:, 0:1] * w[None, :, 0] + x[:, 1:2] * w[None, :, 1]
            + x[:, 2:3] * w[None, :, 2])


def _pad_to(x, multiple, value=0):
    """Pad axis 0 of ``x`` up to a multiple of ``multiple`` with ``value``."""
    rem = (-x.shape[0]) % multiple
    if rem == 0:
        return x
    pad = torch.full((rem, *x.shape[1:]), value, dtype=x.dtype, device=x.device)
    return torch.cat([x, pad])


def _moller_trumbore(o, d, v0, v1, v2, gn, config: RenderConfig):
    """Moller-Trumbore on broadcastable (..., 3) operands -> (t, u, v, ok)."""
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = cross(d, e2)
    det = _dot3(e1, pvec)
    inv_det = torch.reciprocal(torch.where(det == 0.0, torch.ones_like(det), det))
    tvec = o - v0
    u = _dot3(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = _dot3(d, qvec) * inv_det
    t = _dot3(e2, qvec) * inv_det
    ndd = _dot3(d, gn)
    ok = ((ndd.abs() >= config.n_dot_d_min) & (det != 0.0)
          & (t >= config.t_min) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0))
    return t, u, v, ok


def moller_trumbore(org, d, v0, v1, v2, gn, config: RenderConfig):
    """Intersect R rays against C triangles -> (t, u, v, ok) each (R, C).
    org/d: (R, 3); v0/v1/v2/gn: (C, 3)."""
    return _moller_trumbore(org[:, None, :], d[:, None, :], v0[None], v1[None],
                            v2[None], gn[None], config)


def _chunk_best(t, u, v, ok, emissive, tie_eps):
    """Per-ray best over the chunk axis with the emissive tie preference.
    t/u/v/ok: (R, C); emissive: (C,) -> (bt, bi, bu, bv, bemis) each (R,)."""
    tm = torch.where(ok, t, torch.full_like(t, INF))
    bt = tm.amin(dim=1)
    tie_emis = ((tm <= bt[:, None] * (1.0 + tie_eps)) & (tm < INF)
                & emissive[None, :])
    has_emis = tie_emis.any(dim=1)
    # argmax/argmin return the first extremum, as jnp's do
    bi = torch.where(has_emis, tie_emis.to(torch.int32).argmax(dim=1),
                     tm.argmin(dim=1))
    take = lambda a: torch.gather(a, 1, bi[:, None])[:, 0]
    return take(tm), bi, take(u), take(v), has_emis


def _merge_best(carry, cand, tie_eps):
    """Merge a chunk's best into the running best: strictly closer wins
    outside the tie band; inside it an emissive candidate displaces a
    non-emissive incumbent (reference bvh.cpp:168-174,219)."""
    bt0, bi0, bu0, bv0, be0 = carry
    bt, bi, bu, bv, be = cand
    eps1 = 1.0 + tie_eps
    near = (bt <= bt0 * eps1) & (bt0 <= bt * eps1) & (bt < INF)
    repl = (~near & (bt < bt0)) | (near & be & ~be0)
    sel = lambda a, b: torch.where(repl, a, b)
    return (sel(bt, bt0), sel(bi, bi0), sel(bu, bu0), sel(bv, bv0), sel(be, be0))


def _init_best(R, device):
    z = torch.zeros(R, dtype=torch.float32, device=device)
    return (torch.full((R,), INF, dtype=torch.float32, device=device),
            torch.zeros(R, dtype=torch.int64, device=device), z, z.clone(),
            torch.zeros(R, dtype=torch.bool, device=device))


def brute_force_intersect(scene, org, d, config: RenderConfig) -> Hit:
    """Closest hit over all triangles, scanned in chunks of config.tri_chunk
    (padding triangles are degenerate: gn = 0 fails the grazing cull)."""
    C = config.tri_chunk
    T = scene.v0.shape[0]
    n_chunks = -(-T // C)
    stack = lambda a, value=0.0: _pad_to(a, C, value).reshape(n_chunks, C, *a.shape[1:])
    v0, v1, v2, gn = (stack(a) for a in (scene.v0, scene.v1, scene.v2, scene.gn))
    emis = stack(scene.tri_emissive, False)
    tid = stack(torch.arange(T, dtype=torch.int64, device=org.device), 0)
    best = _init_best(org.shape[0], org.device)
    for k in range(n_chunks):
        t, u, v, ok = moller_trumbore(org, d, v0[k], v1[k], v2[k], gn[k], config)
        bt, bi, bu, bv, be = _chunk_best(t, u, v, ok, emis[k], config.tie_eps)
        best = _merge_best(best, (bt, tid[k][bi], bu, bv, be), config.tie_eps)
    bt, bi, bu, bv, _ = best
    return Hit(t=bt, idx=bi, u=bu, v=bv, hit=bt < INF)


def mxu_intersect(scene, org, d, config: RenderConfig) -> Hit:
    """Closest hit over all triangles with the Woop test phrased as matrix
    products per chunk of C triangles (the JAX package's MXU form):
    ld = d @ A^T, lo = org @ A^T + b over BLOCK-ordered rows
    [C u-rows | C v-rows | C w-rows], t = -lo_w / ld_w, u = lo_u + t ld_u,
    v = lo_v + t ld_v, and the grazing cull from d @ gn^T. The depth-3
    products are written out (``_matmul3``) in full float32: XLA's CPU dot
    sums them in that order, and a BLAS call (or TF32 on the card) would
    round differently and flip grazing hits."""
    C = config.tri_chunk
    T = scene.v0.shape[0]
    n_chunks = -(-T // C)
    pad3 = lambda x: _pad_to(x, C).reshape(n_chunks, C, 3)
    A = torch.cat([pad3(scene.woop_a[:, 0]), pad3(scene.woop_a[:, 1]),
                   pad3(scene.woop_a[:, 2])], dim=1)             # (n, 3C, 3)
    pad1 = lambda x: _pad_to(x, C).reshape(n_chunks, C)
    B = torch.cat([pad1(scene.woop_b[:, 0]), pad1(scene.woop_b[:, 1]),
                   pad1(scene.woop_b[:, 2])], dim=1)             # (n, 3C)
    G = pad3(scene.gn)
    emis = _pad_to(scene.tri_emissive, C, False).reshape(n_chunks, C)
    tid = _pad_to(torch.arange(T, dtype=torch.int64, device=org.device),
                  C).reshape(n_chunks, C)
    best = _init_best(org.shape[0], org.device)
    for k in range(n_chunks):
        a = A[k]
        ld = _matmul3(d, a)                                      # (R, 3C)
        lo = _matmul3(org, a) + B[k][None, :]
        ndd = _matmul3(d, G[k])                                  # (R, C)
        ldz = ld[:, 2 * C:]
        inv = torch.reciprocal(torch.where(ldz == 0.0, torch.ones_like(ldz), ldz))
        t = -lo[:, 2 * C:] * inv
        u = lo[:, :C] + t * ld[:, :C]
        v = lo[:, C:2 * C] + t * ld[:, C:2 * C]
        ok = ((ndd.abs() >= config.n_dot_d_min) & (ldz != 0.0)
              & (t >= config.t_min) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0))
        t = torch.where(ok, t, torch.full_like(t, INF))
        bt, bi, bu, bv, be = _chunk_best(t, u, v, ok, emis[k], config.tie_eps)
        best = _merge_best(best, (bt, tid[k][bi], bu, bv, be), config.tie_eps)
    bt, bi, bu, bv, _ = best
    return Hit(t=bt, idx=bi, u=bu, v=bv, hit=bt < INF)


def resolve_backend(scene, org, config: RenderConfig) -> str:
    """The backend ``intersect`` runs: "auto" is the CUDA kernels on a CUDA
    tensor (the packet-BVH kernel with a BVH, the slot kernel without),
    and the plain "bvh" or "mxu" path on the CPU — the JAX package's rule,
    with "on an accelerator" read as "on a CUDA tensor"."""
    backend = config.intersector
    if backend == "auto":
        if scene.bvh is not None:
            backend = "bvh_pallas" if org.is_cuda else "bvh"
        else:
            backend = "pallas" if org.is_cuda else "mxu"
    if backend not in BACKENDS:
        raise ValueError(f"unknown intersector {backend!r}")
    return backend


def intersect(scene, org, d, config: RenderConfig) -> Hit:
    """Dispatch to the configured intersector backend (names as in the JAX
    package: "bvh_pallas" and "pallas" are the CUDA kernels here)."""
    backend = resolve_backend(scene, org, config)
    if backend == "mxu":
        return mxu_intersect(scene, org, d, config)
    if backend == "brute":
        return brute_force_intersect(scene, org, d, config)
    if backend == "bvh":
        from tinyraytracing_tpu_torch.ops.traverse import bvh_intersect

        if scene.bvh is None:
            raise ValueError("scene has no BVH; call ops.bvh.attach_bvh first")
        return bvh_intersect(scene, org, d, config)
    rays = torch.cat([org, d], 1).to(torch.float32).T.contiguous()  # (6, R)
    if backend == "pallas":
        from tinyraytracing_tpu_torch.ops.slot_intersect import slot_intersect_planes

        t, idx, u, v = slot_intersect_planes(scene, rays, config)
    else:
        from tinyraytracing_tpu_torch.ops.bvh_intersect import bvh_intersect_planes

        if scene.bvh is None or scene.bvh.packed is None:
            raise ValueError("scene has no packed BVH (load_scene with_bvh=True)")
        t, idx, u, v = bvh_intersect_planes(scene, rays, config)
    return Hit(t=t, idx=idx.to(torch.int64), u=u, v=v, hit=t < INF)
