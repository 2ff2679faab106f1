"""Binary skip-link BVH closest hit — the counterpart of
``tinyraytracing_tpu/ops/pallas_bvh.py::pallas_bvh_intersect_planes``:
the ``intersector="bvh_pallas"`` backend, and the scan renderer's "auto"
backend on a CUDA scene with a BVH.

A hand-written CUDA kernel (``csrc/bvh_intersect.cu``) replaces the
Pallas packet walk with a per-ray stackless cursor walk over a layout of
the same tree made for the card (``BvhRecords``: 32-byte node records and
64-byte records of the occupied slots only, built once per scene from the
PackedLeaves as ``Scene.bvh_records``); its source note says why that is
exact lane for lane and what bounds it on an H100. Beside it lives its
plain PyTorch version, ``bvh_intersect_plain``: the same per-ray walk over
the JAX layout, vectorised over the rays still walking, with the kernel's
exact arithmetic (the slot test and running best of
``ops/slot_test.py``). ``bvh_intersect_planes`` takes the plain version
only for CPU tensors; on a CUDA tensor it launches the kernel or raises.

Semantics (``pallas_bvh.py:59-244``): inverse direction
where(d == 0, 3e38, 1) / where(d == 0, 1, d); slab test with the tie-band
early-out always on (not gated by ``config.bvh_early_out``); leaf
encoding leaf_id*64 + count (-1 interior); slots 0..leaf_size-1 of the
leaf's block tested with the Woop-plane test (the pad slots beyond the
leaf's count never hit, so the kernel tests only the occupied ones); the
slot id carried as a float and mapped to a triangle through ``tid`` (a
miss keeps slot 0, so its triangle is tid[0]).
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from tinyraytracing_tpu_torch.config import RenderConfig
from tinyraytracing_tpu_torch.ops.slot_test import (
    SLOT, init_best, merge_slots, tie_band, woop_slot_test,
)
from tinyraytracing_tpu_torch.utils import spans

_INF = 3.0e38
# float operations of one node's slab test: 6 sub, 6 mul, 10 min/max,
# the entry/exit select, 3 compares, the clamp at 0 and bt * (1 + tie_eps)
SLAB_FLOPS = 28


def bvh_intersect_plain(pk, rays: torch.Tensor, config: RenderConfig,
                        stats: dict | None = None):
    """Reference walk on any device. ``rays`` (6, R) float32 planes, ``pk``
    the scene's PackedLeaves; returns (t f32, tri int32, u, v), exactly
    what the kernel writes. ``stats`` (if given) gains the work the walk
    needs, for the kernel's bound: "node_visits" (slab tests),
    "slot_tests" (the occupied slots of each leaf entered) and
    "scene_bytes" (each node
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
# the kernel's layout of the same tree, and the CUDA kernel's wrapper
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BvhRecords:
    """The kernel's layout of a PackedLeaves tree (``bvh_records``).

    ``node`` (N, 8) int32, one 32-byte record per node: the bits of
    node_box's x0 y0 z0 x1 y1 z1, then ``link`` and ``enc``. ``enc`` is
    node_meta's leaf word (leaf_id*64 + count, -1 for an interior node);
    ``link`` is node_meta's skip link for an interior node and the index
    of the leaf's first slot record for a leaf (a leaf's skip link is the
    next node). ``slot`` (n_records, 16) float32, one 64-byte record per
    occupied slot, its 16 attributes in P's order, each leaf's records
    contiguous and in slot order; ``slot_id`` (n_records,) int32, the slot
    id 32*leaf + s of each record (ascending). ``tid`` is the packed tree's
    slot -> triangle map."""

    node: torch.Tensor
    slot: torch.Tensor
    slot_id: torch.Tensor
    tid: torch.Tensor
    n_nodes: int


def bvh_records(pk) -> BvhRecords:
    """The kernel's layout of ``pk`` on its device (``Scene.bvh_records``
    builds it once per scene)."""
    dev = pk.node_meta.device
    skip, enc = pk.node_meta[:, 0].long(), pk.node_meta[:, 1].long()
    leaf_node = torch.nonzero(enc >= 0).squeeze(1)
    if not torch.equal(skip[leaf_node], leaf_node + 1):
        raise ValueError("a leaf's skip link must be the next node")
    leaf, count = enc[leaf_node] >> 6, enc[leaf_node] & 63
    order = torch.argsort(leaf)                 # records in leaf-id order
    first = torch.zeros_like(count)
    first[order] = torch.cumsum(count[order], 0) - count[order]
    link = skip.clone()
    link[leaf_node] = first
    node = torch.cat([pk.node_box[:, :6].contiguous().view(torch.int32),
                      link.to(torch.int32)[:, None],
                      pk.node_meta[:, 1:]], dim=1).contiguous()
    # slot id 32*leaf + s of each record, then its 16 attributes from P
    rec_leaf = torch.repeat_interleave(leaf[order], count[order])
    s = torch.arange(rec_leaf.numel(), device=dev) - torch.repeat_interleave(
        first[order], count[order])
    a = torch.arange(16, device=dev)
    col = rec_leaf[:, None] * 128 + (a % 4) * SLOT + s[:, None]
    slot = pk.P[a // 4, col].contiguous()
    return BvhRecords(node=node, slot=slot,
                      slot_id=(rec_leaf * SLOT + s).to(torch.int32),
                      tid=pk.tid, n_nodes=pk.n_nodes)


def _lib():
    from tinyraytracing_tpu_torch.ops.kernels import library

    lib = library("bvh_intersect.cu")
    if not getattr(lib, "_trt_typed", False):
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.trt_bvh_intersect.argtypes = [P, P, P, P, P, P, P, P, I, I, I,
                                          F, F, F, P]
        lib.trt_bvh_intersect.restype = ctypes.c_int
        lib._trt_typed = True
    return lib


def bvh_intersect_kernel(rec: BvhRecords, rays: torch.Tensor,
                         config: RenderConfig):
    """Launch the CUDA kernel on PyTorch's current stream over the scene's
    ``bvh_records``; same result as ``bvh_intersect_plain`` on the scene's
    PackedLeaves. Raises on a CPU tensor or a failed launch."""
    if not rays.is_cuda:
        raise ValueError("bvh_intersect_kernel needs CUDA tensors")
    for name, x, dt in (("rays", rays, torch.float32),
                        ("node", rec.node, torch.int32),
                        ("slot", rec.slot, torch.float32),
                        ("tid", rec.tid, torch.int32)):
        if x.dtype != dt or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dt}")
        if x.device != rays.device:
            raise ValueError(f"{name} is on {x.device}, rays on {rays.device}")
    if rays.dim() != 2 or rays.shape[0] != 6:
        raise ValueError(f"rays must be (6, R), got {tuple(rays.shape)}")
    if (tuple(rec.node.shape) != (rec.n_nodes, 8) or rec.slot.dim() != 2
            or rec.slot.shape[1] != 16):
        raise ValueError("node records must be (N, 8) and slot records (n, 16)")
    R = rays.shape[1]
    f = lambda dt: torch.empty(R, dtype=dt, device=rays.device)
    t, tri, u, v = f(torch.float32), f(torch.int32), f(torch.float32), f(torch.float32)
    with torch.cuda.device(rays.device):
        err = _lib().trt_bvh_intersect(
            rays.data_ptr(), rec.node.data_ptr(), rec.slot.data_ptr(),
            rec.tid.data_ptr(), t.data_ptr(), tri.data_ptr(), u.data_ptr(),
            v.data_ptr(), R, rec.n_nodes, rec.tid.shape[0],
            config.t_min, config.n_dot_d_min, 1.0 + config.tie_eps,
            torch.cuda.current_stream(rays.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"bvh_intersect kernel launch failed: cudaError {err}")
    spans.count("launches.bvh_intersect")
    return t, tri, u, v


def bvh_intersect_planes(scene, rays: torch.Tensor, config: RenderConfig):
    """``rays``, the JAX function's six ray planes (o xyz, d xyz) stacked
    into one contiguous (6, R) float32 block, in;
    (t, tri, u, v) (R,) planes out, as ``pallas_bvh_intersect_planes``
    returns them."""
    if rays.is_cuda:
        return bvh_intersect_kernel(scene.bvh_records, rays, config)
    if rays.device.type == "cpu":
        return bvh_intersect_plain(scene.bvh.packed, rays, config)
    raise ValueError(f"no bvh_intersect implementation for device {rays.device}")

