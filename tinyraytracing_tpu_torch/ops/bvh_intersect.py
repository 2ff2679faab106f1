"""Binary skip-link BVH closest hit — the counterpart of
``tinyraytracing_tpu/ops/pallas_bvh.py::pallas_bvh_intersect_planes``:
the ``intersector="bvh_pallas"`` backend, and the scan renderer's "auto"
backend on a CUDA scene with a BVH.

A hand-written CUDA kernel (``csrc/bvh_intersect.cu``) replaces the
Pallas packet walk with a per-ray stackless cursor walk; its source note
says why that is exact lane for lane and what bounds it on an H100.
Beside it lives its plain PyTorch version, ``bvh_intersect_plain``: the
same per-ray walk vectorised over the rays still walking, with the
kernel's exact arithmetic (the slot test and running best of
``ops/slot_test.py``). ``bvh_intersect_planes`` takes the plain version
only for CPU tensors; on a CUDA tensor it launches the kernel or raises.

Semantics (``pallas_bvh.py:59-244``): inverse direction
where(d == 0, 3e38, 1) / where(d == 0, 1, d); slab test with the tie-band
early-out always on (not gated by ``config.bvh_early_out``); leaf
encoding leaf_id*64 + count (-1 interior); slots 0..leaf_size-1 of the
leaf's block tested with the Woop-plane test; the slot id carried as a
float and mapped to a triangle through ``tid`` (a miss keeps slot 0, so
its triangle is tid[0]).
"""

from __future__ import annotations

import ctypes

import torch

from tinyraytracing_tpu_torch.config import RenderConfig
from tinyraytracing_tpu_torch.ops.slot_test import (
    SLOT, init_best, merge_slots, tie_band, woop_slot_test,
)

_INF = 3.0e38
# float operations of one node's slab test: 6 sub, 6 mul, 10 min/max,
# the entry/exit select, 3 compares, the clamp at 0 and bt * (1 + tie_eps)
SLAB_FLOPS = 28

LAUNCHES = {"bvh_intersect": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def bvh_intersect_plain(pk, rays: torch.Tensor, config: RenderConfig,
                        stats: dict | None = None):
    """Reference walk on any device. ``rays`` (6, R) float32 planes, ``pk``
    the scene's PackedLeaves; returns (t f32, tri int32, u, v), exactly
    what the kernel writes. ``stats`` (if given) gains the work the walk
    needs, for the kernel's bound: "node_visits" (slab tests),
    "slot_tests" (the occupied slots of each leaf entered; the kernel also
    tests its pad slots up to leaf_size) and "scene_bytes" (each node
    visited, occupied slot tested and ``tid`` entry read, counted once:
    40, 64 and 4 bytes)."""
    f32 = torch.float32
    dev = rays.device
    R = rays.shape[1]
    N, L = pk.n_nodes, pk.leaf_size
    INF = torch.tensor(_INF, dtype=f32, device=dev)
    one = torch.ones((), dtype=f32, device=dev)
    eps1 = tie_band(config, dev)
    ox, oy, oz, dx, dy, dz = rays.unbind(0)
    inv_of = lambda d: (torch.where(d == 0.0, INF, one)
                        / torch.where(d == 0.0, one, d))
    invx, invy, invz = inv_of(dx), inv_of(dy), inv_of(dz)
    box = pk.node_box
    meta = pk.node_meta.to(torch.int64)
    Pf = pk.P.reshape(-1)
    cols = pk.P.shape[1]
    # flat P offset of attribute a, slot s, in leaf block 0
    off = ((torch.arange(16, device=dev) // 4) * cols
           + (torch.arange(16, device=dev) % 4) * SLOT)[None, :, None] \
        + torch.arange(L, device=dev)[None, None, :]          # (1, 16, L)
    lane = torch.arange(L, device=dev)

    best = init_best(R, dev)
    bt = best[0]
    node = torch.zeros(R, dtype=torch.int64, device=dev)
    visits = slots = 0
    if stats is not None:     # what the walk reads, for the bound
        node_seen = torch.zeros(N, dtype=torch.bool, device=dev)
        slot_seen = torch.zeros(pk.tid.shape[0], dtype=torch.bool, device=dev)
    while True:
        act = torch.nonzero(node < N).squeeze(1)
        if act.numel() == 0:
            break
        visits += act.numel()
        nd = node[act]
        if stats is not None:
            node_seen[nd] = True
        b = box[nd]
        o = (ox[act], oy[act], oz[act])
        t_ax = (b[:, 0] - o[0]) * invx[act]
        t_bx = (b[:, 3] - o[0]) * invx[act]
        t_ay = (b[:, 1] - o[1]) * invy[act]
        t_by = (b[:, 4] - o[1]) * invy[act]
        t_az = (b[:, 2] - o[2]) * invz[act]
        t_bz = (b[:, 5] - o[2]) * invz[act]
        t0 = torch.maximum(torch.maximum(torch.minimum(t_ax, t_bx),
                                         torch.minimum(t_ay, t_by)),
                           torch.minimum(t_az, t_bz))
        t1 = torch.minimum(torch.minimum(torch.maximum(t_ax, t_bx),
                                         torch.maximum(t_ay, t_by)),
                           torch.maximum(t_az, t_bz))
        dist = torch.where(t0 > 0.0, t0, t1)
        hit = ((t1 >= t0) & (dist > 0.0)
               & (torch.clamp_min(t0, 0.0) <= bt[act] * eps1))
        enc = meta[nd, 1]
        at = torch.nonzero(hit & (enc >= 0)).squeeze(1)
        if at.numel():
            r = act[at]
            leaf = enc[at] >> 6
            slot_id = leaf[:, None] * SLOT + lane[None, :]
            if stats is not None:
                occupied = lane[None, :] < (enc[at] & 63)[:, None]  # (n, L)
                slots += occupied.sum()
                slot_seen[slot_id[occupied]] = True
            attrs = Pf[leaf[:, None, None] * 128 + off]        # (n, 16, L)
            col = lambda x: x[r][:, None]
            tm, u, v = woop_slot_test(
                lambda a: attrs[:, a], (col(ox), col(oy), col(oz)),
                (col(dx), col(dy), col(dz)), config)
            merge_slots(best, r, tm, u, v, attrs[:, 15], slot_id.to(f32), eps1)
        node[act] = torch.where(hit & (enc < 0), nd + 1, meta[nd, 0])
    bt, bi, bu, bv, _ = best
    slot = torch.clamp(bi.to(torch.int64), 0, pk.tid.shape[0] - 1)
    if stats is not None:
        stats["node_visits"] = stats.get("node_visits", 0) + visits
        stats["slot_tests"] = stats.get("slot_tests", 0) + int(slots)
        nbytes = (40 * int(node_seen.sum()) + 64 * int(slot_seen.sum())
                  + 4 * torch.unique(slot).numel())
        stats["scene_bytes"] = stats.get("scene_bytes", 0) + nbytes
    return bt, pk.tid[slot].to(torch.int32), bu, bv


# ---------------------------------------------------------------------------
# the CUDA kernel's wrapper
# ---------------------------------------------------------------------------

def _lib():
    from tinyraytracing_tpu_torch.ops.kernels import library

    lib = library("bvh_intersect.cu")
    if not getattr(lib, "_trt_typed", False):
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.trt_bvh_intersect.argtypes = [P, P, P, P, P, ctypes.c_longlong,
                                          P, P, P, P, I, I, I, I, F, F, F, P]
        lib.trt_bvh_intersect.restype = ctypes.c_int
        lib._trt_typed = True
    return lib


def bvh_intersect_kernel(pk, rays: torch.Tensor, config: RenderConfig):
    """Launch the CUDA kernel on PyTorch's current stream; same contract as
    ``bvh_intersect_plain``. Raises on a CPU tensor or a failed launch."""
    if not rays.is_cuda:
        raise ValueError("bvh_intersect_kernel needs CUDA tensors")
    for name, x, dt in (("rays", rays, torch.float32),
                        ("node_box", pk.node_box, torch.float32),
                        ("node_meta", pk.node_meta, torch.int32),
                        ("P", pk.P, torch.float32), ("tid", pk.tid, torch.int32)):
        if x.dtype != dt or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dt}")
        if x.device != rays.device:
            raise ValueError(f"{name} is on {x.device}, rays on {rays.device}")
    if rays.dim() != 2 or rays.shape[0] != 6:
        raise ValueError(f"rays must be (6, R), got {tuple(rays.shape)}")
    if (tuple(pk.node_box.shape) != (pk.n_nodes, 8)
            or tuple(pk.node_meta.shape) != (pk.n_nodes, 2)):
        raise ValueError("node_box must be (N, 8) and node_meta (N, 2)")
    if pk.P.dim() != 2 or pk.P.shape[0] != 4 or not 1 <= pk.leaf_size <= SLOT:
        raise ValueError("P must be (4, cols) with leaf_size in [1, 32]")
    R = rays.shape[1]
    f = lambda dt: torch.empty(R, dtype=dt, device=rays.device)
    t, tri, u, v = f(torch.float32), f(torch.int32), f(torch.float32), f(torch.float32)
    with torch.cuda.device(rays.device):
        err = _lib().trt_bvh_intersect(
            rays.data_ptr(), pk.node_box.data_ptr(), pk.node_meta.data_ptr(),
            pk.P.data_ptr(), pk.tid.data_ptr(), pk.P.shape[1],
            t.data_ptr(), tri.data_ptr(), u.data_ptr(), v.data_ptr(),
            R, pk.n_nodes, pk.leaf_size, pk.tid.shape[0],
            config.t_min, config.n_dot_d_min, 1.0 + config.tie_eps,
            torch.cuda.current_stream(rays.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"bvh_intersect kernel launch failed: cudaError {err}")
    LAUNCHES["bvh_intersect"] += 1
    return t, tri, u, v


def bvh_intersect_planes(scene, rays: torch.Tensor, config: RenderConfig):
    """``rays``, the JAX function's six ray planes (o xyz, d xyz) stacked
    into one contiguous (6, R) float32 block, in;
    (t, tri, u, v) (R,) planes out, as ``pallas_bvh_intersect_planes``
    returns them."""
    pk = scene.bvh.packed
    if rays.is_cuda:
        return bvh_intersect_kernel(pk, rays, config)
    if rays.device.type == "cpu":
        return bvh_intersect_plain(pk, rays, config)
    raise ValueError(f"no bvh_intersect implementation for device {rays.device}")

