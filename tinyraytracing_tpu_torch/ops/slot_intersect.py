"""Brute-force closest hit in 32-triangle slot chunks — the counterpart of
``tinyraytracing_tpu/ops/pallas_intersect.py`` (``pack_triangle_slots``,
``pallas_intersect_planes``): the ``intersector="pallas"`` backend.

A hand-written CUDA kernel (``csrc/slot_intersect.cu``: one thread per
ray; per chunk the least accepted t wins unless another slot or the carry
lies in its tie band, and then the chunk's accepted slots are replayed in
slot order; the payload staged through shared memory) replaces the Pallas
kernel; its source note says why that fold is exact and what bounds it on
an H100. Beside it lives
its plain PyTorch version, ``slot_intersect_plain``, with the kernel's
exact arithmetic (the slot test and running best of ``ops/slot_test.py``).
``slot_intersect_planes`` takes the plain version only for CPU tensors; on
a CUDA tensor it launches the kernel or raises. A scene's packed payload
is ``Scene.slot_payload``.
"""

from __future__ import annotations

import ctypes

import torch

from tinyraytracing_tpu_torch.config import RenderConfig
from tinyraytracing_tpu_torch.ops.slot_test import (
    SLOT, init_best, merge_slots, tie_band, woop_slot_test,
)
from tinyraytracing_tpu_torch.utils import spans


def pack_triangle_slots(woop_a, woop_b, gn, emissive):
    """(4, n_chunks*128) slot blocks: 16 attrs x 32 slots per chunk, attr a
    of slot s at (row a//4, lane (a%4)*32 + s), chunk c holding triangles
    [c*32, c*32+32); padding slots are all-zero rows (they never hit).
    Returns (P, n_chunks), P on the inputs' device."""
    T = woop_a.shape[0]
    n_chunks = max(-(-T // SLOT), 1)
    Tp = n_chunks * SLOT

    def pad(x):
        x = x.to(torch.float32)
        z = torch.zeros((Tp - T, *x.shape[1:]), dtype=x.dtype, device=x.device)
        return torch.cat([x, z])

    wa = pad(woop_a).reshape(n_chunks, SLOT, 3, 3)
    wb = pad(woop_b).reshape(n_chunks, SLOT, 3)
    g = pad(gn).reshape(n_chunks, SLOT, 3)
    em = pad(emissive).reshape(n_chunks, SLOT)
    attrs = [
        wa[:, :, 0, 0], wa[:, :, 0, 1], wa[:, :, 0, 2], wa[:, :, 1, 0],
        wa[:, :, 1, 1], wa[:, :, 1, 2], wa[:, :, 2, 0], wa[:, :, 2, 1],
        wa[:, :, 2, 2], wb[:, :, 0], wb[:, :, 1], wb[:, :, 2],
        g[:, :, 0], g[:, :, 1], g[:, :, 2], em,
    ]
    rows = [torch.cat(attrs[r * 4:r * 4 + 4], dim=1) for r in range(4)]
    P = torch.stack(rows, dim=0).reshape(4, n_chunks * 128).contiguous()
    return P, n_chunks


def slot_intersect_plain(P, n_tri: int, rays: torch.Tensor,
                         config: RenderConfig, stats: dict | None = None):
    """Reference of the kernel on any device. ``rays`` (6, R) float32
    planes, ``P`` the packed slots; returns (t f32, idx int32, u, v).
    ``stats`` (if given) gains the work the function needs, for the
    kernel's bound: "slot_tests", the (ray, triangle) tests (the kernel
    also tests the last chunk's pad slots), and "scene_bytes", the
    triangles' 16 float32 attributes read once."""
    dev = rays.device
    R = rays.shape[1]
    n_chunks = P.shape[1] // 128
    o, d = tuple(rays[:3]), tuple(rays[3:])
    best = init_best(R, dev)
    rows = torch.arange(R, device=dev)
    eps1 = tie_band(config, dev)
    lane = torch.arange(SLOT, device=dev)
    col = lambda x: x[:, None]
    oc, dc = tuple(map(col, o)), tuple(map(col, d))
    for k in range(n_chunks):
        blk = P[:, k * 128:(k + 1) * 128]                      # (4, 128)
        g = lambda a: blk[a // 4, (a % 4) * SLOT:(a % 4 + 1) * SLOT][None, :]
        tm, u, v = woop_slot_test(g, oc, dc, config)           # (R, 32)
        slot_id = (lane + k * SLOT).to(torch.float32)[None, :].expand_as(tm)
        merge_slots(best, rows, tm, u, v, g(15).expand_as(tm), slot_id, eps1)
    if stats is not None:
        stats["slot_tests"] = stats.get("slot_tests", 0) + R * n_tri
        stats["scene_bytes"] = stats.get("scene_bytes", 0) + 16 * 4 * n_tri
    bt, bi, bu, bv, _ = best
    idx = torch.clamp_max(bi.to(torch.int32), n_tri - 1)
    return bt, idx, bu, bv


# ---------------------------------------------------------------------------
# the CUDA kernel's wrapper
# ---------------------------------------------------------------------------

def _lib():
    from tinyraytracing_tpu_torch.ops.kernels import library

    lib = library("slot_intersect.cu")
    if not getattr(lib, "_trt_typed", False):
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.trt_slot_intersect.argtypes = [P, P, P, P, P, P, I, I, I, F, F, F, P]
        lib.trt_slot_intersect.restype = ctypes.c_int
        lib._trt_typed = True
    return lib


def slot_intersect_kernel(P, n_tri: int, rays: torch.Tensor,
                          config: RenderConfig):
    """Launch the CUDA kernel on PyTorch's current stream; same contract as
    ``slot_intersect_plain``. Raises on a CPU tensor or a failed launch."""
    if not rays.is_cuda:
        raise ValueError("slot_intersect_kernel needs CUDA tensors")
    for name, x in (("rays", rays), ("P", P)):
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32")
        if x.device != rays.device:
            raise ValueError(f"{name} is on {x.device}, rays on {rays.device}")
    if rays.dim() != 2 or rays.shape[0] != 6:
        raise ValueError(f"rays must be (6, R), got {tuple(rays.shape)}")
    if P.dim() != 2 or P.shape[0] != 4 or P.shape[1] % 128:
        raise ValueError(f"P must be (4, n_chunks*128), got {tuple(P.shape)}")
    if n_tri < 1:
        raise ValueError("the scene has no triangles")
    R = rays.shape[1]
    f = lambda dt: torch.empty(R, dtype=dt, device=rays.device)
    t, idx, u, v = f(torch.float32), f(torch.int32), f(torch.float32), f(torch.float32)
    with torch.cuda.device(rays.device):
        err = _lib().trt_slot_intersect(
            rays.data_ptr(), P.data_ptr(), t.data_ptr(), idx.data_ptr(),
            u.data_ptr(), v.data_ptr(), R, P.shape[1] // 128, n_tri,
            config.t_min, config.n_dot_d_min, 1.0 + config.tie_eps,
            torch.cuda.current_stream(rays.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"slot_intersect kernel launch failed: cudaError {err}")
    spans.count("launches.slot_intersect")
    return t, idx, u, v


def slot_intersect_planes(scene, rays: torch.Tensor, config: RenderConfig):
    """``rays``, the JAX function's six ray planes (o xyz, d xyz) stacked
    into one contiguous (6, R) float32 block, in;
    (t, idx, u, v) (R,) planes out, as ``pallas_intersect_planes`` returns
    them (idx = min(slot, T-1), 0 on a miss)."""
    P, _ = scene.slot_payload
    n_tri = scene.num_triangles
    if rays.is_cuda:
        return slot_intersect_kernel(P, n_tri, rays, config)
    if rays.device.type == "cpu":
        return slot_intersect_plain(P, n_tri, rays, config)
    raise ValueError(f"no slot_intersect implementation for device {rays.device}")

