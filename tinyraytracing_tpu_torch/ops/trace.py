"""Fused closest-hit / occlusion trace over the packed 8-wide BVH — the
counterpart of ``tinyraytracing_tpu/ops/pallas_trace.py``.

Hand-written CUDA kernels (``csrc/trace.cu``, one thread per ray) replace
the Pallas kernels reached from ``pallas_trace.fused_trace_planes``
(closest hit: ``_kernel_wide_*``/``_kernel_smem*``/``_kernel_hbm`` with the
slot loop ``_leaf_slots.run_slots``; occlusion: the same with
``run_slots_occl``; and both under ``walk_order="near"``, the near-first
child order of ``_interior_push`` with pop-time culling). They read a
layout of the same tree made for the card (``TraceRecords``, built once
per scene as ``Scene.trace_records``), walk in two loops (holding leaves
under preorder; under near-first on leaves of up to 8 slots the last few
walkers pause, ``near_pause``), and on trees of more than one wide node
refill the lanes whose walks end from a ray counter; the source note in
``trace.cu`` says why that is exact, what bounds them on an H100 and
what the design does about it.

Beside the kernels lives their plain PyTorch version, ``trace_plain``: the
same per-ray wide walk over the JAX layout (WN / PS), vectorised over rays
with an (R, S) stack tensor, one leaf at a time, looping until every stack
is empty. The wrappers take it only for tensors on the CPU; on a CUDA
tensor they launch the kernel or raise.

Semantics (identical to the JAX package's kernel, see its docstrings):
per-ray t-bound start (``t_bound``), Woop-plane slot test with
t >= t_min and |n.d| >= graze, the tie-banded emissive tie-break, the
target-material early kill (t = -1, mtl = -3), barycentric shading
normal / texcoord interpolated at the hit, and the 2-plane any-hit
occlusion query (bt, seen).

The near-first walk. The JAX kernel walks one PACKET of ``tile``
consecutive rays with one stack, and under ``walk_order="near"`` pushes
the children the packet keeps in descending order of a key along the
packet's summed direction (``_mean_dir``), so pops visit near children
first. The port keeps one walk per ray and gives each ray its packet's
key: ``walk_packets`` groups the dispatched rays as the JAX kernel does
and sums their directions once, in XLA's order (``packet_dirs``), and
the kernel and the plain version sort each ray's kept children by that
key with the same 19-exchange network. A ray then meets its leaves in
the packet walk's order, except where two of its children's keys tie:
the network is not stable and the packet keeps more children than the
ray, so equal keys can come out in another order (and XLA's CPU backend
may contract a key's products into FMAs, moving it by an ulp). Such a
swap can move a result only inside the tie band. Where the JAX kernel
walks the binary tree (``bvh_walk``, tree size and query decide), it
ignores ``walk_order``, and so does the port.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from tinyraytracing_tpu_torch.config import RenderConfig
from tinyraytracing_tpu_torch.ops.slot_test import SLOT, slot_replaces, woop_slot_test
from tinyraytracing_tpu_torch.utils import spans

_INF = 3.0e38
N_OUT = 9          # t, pn xyz, tc uv, mtl, em, slot
# the JAX kernel's walk and packet choices
# (tinyraytracing_tpu/ops/pallas_trace.py:76-90 and :1036-1051)
RAY_TILE = 4096
RAY_TILE_BIG = 1024
WIDE_TILE_LIMIT = 1024
SMEM_NODE_LIMIT = 1024
# _SORT8 (pallas_trace.py:371): Batcher's odd-even merge network, 19
# compare-exchanges; csrc/trace.cu runs the same list
SORT8 = ((0, 1), (2, 3), (4, 5), (6, 7), (0, 2), (1, 3), (4, 6), (5, 7),
         (1, 2), (5, 6), (0, 4), (1, 5), (2, 6), (3, 7), (2, 4), (3, 5),
         (1, 2), (3, 4), (5, 6))
# float operations of one near-first key (3 adds of box bounds, 3 products,
# 2 adds), computed for each child a ray keeps
KEY_FLOPS = 8


def stack_size(pk) -> int:
    """Per-ray stack bound: every interior pop pushes <= 8 children, so the
    high-water mark is wide_depth*7 + 1 (+ slack, as in the JAX kernel)."""
    return max(64, pk.wide_depth * 7 + 16)


def near_tile(pk, config: RenderConfig, occl: bool) -> int:
    """The packet size of the near-first walk for one dispatch, or 0 where
    the JAX kernel would walk preorder: ``walk_order`` other than "near",
    or the binary walk (``bvh_walk`` "binary", or "auto" on a tree of at
    most SMEM_NODE_LIMIT binary nodes for a closest-hit query), which
    ignores the order. The size is the JAX kernel's: ``ray_tile`` if set,
    else 2048 (leaves <= 8) or RAY_TILE_BIG on wide trees of more than
    WIDE_TILE_LIMIT rows, else RAY_TILE."""
    if config.walk_order != "near" or pk.n_wide == 0:
        return 0
    if not (config.bvh_walk == "wide" or (
            config.bvh_walk == "auto"
            and (pk.n_nodes > SMEM_NODE_LIMIT or occl))):
        return 0
    if config.ray_tile:
        return config.ray_tile
    if pk.n_wide > WIDE_TILE_LIMIT:
        return 2048 if pk.leaf_size <= 8 else RAY_TILE_BIG
    return RAY_TILE


def packet_dirs_plain(rays: torch.Tensor, tile: int) -> torch.Tensor:
    """(n_packets, 3) float32: the summed direction (dx, dy, dz) of each
    packet of ``tile`` consecutive rays of the (8, R) ``rays``, the last
    packet zero-padded — ``_mean_dir`` over the JAX kernel's packets,
    parked lanes included, added in XLA's CPU order: a packet is a
    (tile/128, 128) block, cut into bands of min(rows, 32) rows and each
    band into four windows of 32 lanes; each window is summed row-major
    from 0, each band's four window sums in order from 0, and the band
    sums pairwise, ``b[i] + b[i + n/2]`` halving to one (the band count
    padded with zero bands to a power of two). Bitwise ``jnp.sum`` on the
    CPU for every tile up to 4096 (one band) and for 8192, 16384 and
    32768 (2, 4 and 8 full bands). XLA adds the other tall tiles (5120
    or 65536 rays, say) in other orders, so there the sums may differ
    from ``_mean_dir`` in the last bits."""
    if tile <= 0 or tile % 128:
        raise ValueError(f"packets hold a multiple of 128 rays, got {tile}")
    R = rays.shape[1]
    n = -(-R // tile)
    rows = tile // 128
    wr = min(rows, 32)
    rb = -(-rows // wr)
    d = torch.nn.functional.pad(rays[3:6], (0, n * tile - R)).reshape(
        3, n, rows, 128)
    d = torch.nn.functional.pad(d, (0, 0, 0, rb * wr - rows))
    win = d.reshape(3, n, rb, wr, 4, 32).permute(0, 1, 2, 4, 3, 5).reshape(
        3, n, rb, 4, wr * 32)
    acc = torch.zeros(win.shape[:4], dtype=torch.float32, device=rays.device)
    for k in range(wr * 32):
        acc = acc + win[..., k]
    band = torch.zeros(win.shape[:3], dtype=torch.float32, device=rays.device)
    for j in range(4):
        band = band + acc[..., j]
    band = torch.nn.functional.pad(band, (0, (1 << (rb - 1).bit_length()) - rb))
    while band.shape[-1] > 1:
        h = band.shape[-1] // 2
        band = band[..., :h] + band[..., h:]
    return band[..., 0].T.contiguous()


def packet_dirs_kernel(rays: torch.Tensor, tile: int) -> torch.Tensor:
    """Launch the CUDA kernel of ``packet_dirs_plain`` (one block per
    packet and axis, one warp per window; the same additions in the same
    order)."""
    if not rays.is_cuda:
        raise ValueError("packet_dirs_kernel needs CUDA tensors")
    if (rays.dtype != torch.float32 or not rays.is_contiguous()
            or rays.dim() != 2 or rays.shape[0] != 8):
        raise ValueError("rays must be contiguous float32 (8, R)")
    if tile <= 0 or tile % 128:
        raise ValueError(f"packets hold a multiple of 128 rays, got {tile}")
    R = rays.shape[1]
    md = torch.empty((-(-R // tile), 3), dtype=torch.float32,
                     device=rays.device)
    with torch.cuda.device(rays.device):
        err = _lib().trt_packet_dirs(
            rays.data_ptr(), R, tile, md.data_ptr(),
            torch.cuda.current_stream(rays.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"packet_dirs kernel launch failed: cudaError {err}")
    spans.count("launches.packet_dirs")
    return md


def packet_dirs(rays: torch.Tensor, tile: int) -> torch.Tensor:
    """``packet_dirs_plain``'s result: the kernel on a CUDA tensor, the
    plain version on a CPU one."""
    if rays.is_cuda:
        return packet_dirs_kernel(rays, tile)
    if rays.device.type == "cpu":
        return packet_dirs_plain(rays, tile)
    raise ValueError(f"no packet_dirs implementation for device {rays.device}")


def walk_packets(pk, rays: torch.Tensor, config: RenderConfig, occl: bool):
    """(tile, packet directions) selecting the near-first walk for this
    dispatch, or (0, None) for the preorder walk. Computed once per
    dispatch and handed to the kernel or the plain version alike."""
    tile = near_tile(pk, config, occl)
    return (tile, packet_dirs(rays, tile)) if tile else (0, None)


# ---------------------------------------------------------------------------
# plain PyTorch version of the per-ray wide walk
# ---------------------------------------------------------------------------

def trace_plain(pk, rays: torch.Tensor, config: RenderConfig, *,
                attrs: bool = True, occl: bool = False, tile: int = 0,
                md: torch.Tensor | None = None,
                stats: dict | None = None) -> torch.Tensor:
    """Reference walk on any device. ``rays`` is (8, R) float32 (o xyz,
    d xyz, t_bound, target_mtl); returns (9, R) closest-hit planes or
    (2, R) occlusion planes (bt, seen), exactly what the kernel writes.
    With ``md`` (``walk_packets``) the walk is near-first: ray i sorts the
    children it keeps by their box centres' projection on md[i // tile]
    and skips a popped node whose entry distance exceeds its bound.
    ``stats`` (if given) gains "node_visits" (child slab tests),
    "slot_tests" (occupied slots of the leaves popped), as the kernel runs
    them up to its early exit after a kill, "near_keys" and "near_sorts"
    (the near-first walk's keys and 19-exchange sorts), and "scene_bytes"
    (what the kernel reads of ``TraceRecords``, each record counted once:
    32 bytes per occupied child of each wide node it expands, the 64-byte
    test record of each slot it tests, a slot's 64-byte shading record
    where it replaces with attributes, else its 4-byte material where it
    may replace or kill, and the 4-byte slot id of each ray's best record
    with attributes)."""
    f32 = torch.float32
    dev = rays.device
    R = rays.shape[1]
    c = lambda x: torch.tensor(x, dtype=f32, device=dev)
    INF, eps1 = c(_INF), c(1.0 + config.tie_eps)
    zero, one = c(0.0), c(1.0)

    ox, oy, oz, dx, dy, dz, tb, tg = rays.unbind(0)

    def inv_of(d):
        small = d.abs() < c(1e-18)
        return torch.where(small, c(1e18), one) / torch.where(small, one, d)

    invx, invy, invz = inv_of(dx), inv_of(dy), inv_of(dz)
    oix, oiy, oiz = ox * invx, oy * invy, oz * invz
    tga = tg > -1.5

    if occl:
        state = torch.stack([tb, torch.zeros_like(tb), torch.zeros_like(tb)])
    else:
        init = torch.tensor([0.0, 0.0, 1.0, 0.0, 0.0, -1.0, 0.0, -1.0],
                            dtype=f32, device=dev)
        state = torch.cat([tb[None], init[:, None].expand(8, R)])
    # closest rows: bt pnx pny pnz tcu tcv mtl em slot; occlusion: bt bs bem
    EM = 2 if occl else 7

    S = stack_size(pk)
    stack = torch.zeros((R, S), dtype=torch.int32, device=dev)
    sp = torch.ones(R, dtype=torch.int64, device=dev)
    ordered = md is not None
    if ordered:
        # entry distance of each pushed node (the root's is 0)
        tstack = torch.zeros((R, S), dtype=f32, device=dev)
        pmd = md[torch.arange(R, device=dev) // tile]        # (R, 3)
    WN, PS = pk.WN, pk.PS
    lane_off = torch.arange(4, device=dev) * SLOT
    visits = torch.zeros((), dtype=torch.int64, device=dev)
    slots = torch.zeros((), dtype=torch.int64, device=dev)
    keys = torch.zeros((), dtype=torch.int64, device=dev)
    sorts = torch.zeros((), dtype=torch.int64, device=dev)
    # what the kernel reads, for the bound: wide rows popped, and per slot
    # its P attributes, its material and its shading attributes
    if stats is not None:
        flags = lambda n: torch.zeros(n, dtype=torch.bool, device=dev)
        n_slots = PS.shape[1] // 4
        seen = {"rows": flags(WN.shape[0]), "P": flags(n_slots),
                "mtl": flags(n_slots), "shading": flags(n_slots)}

    while True:
        act = torch.nonzero(sp > 0).squeeze(1)
        if act.numel() == 0:
            break
        sp[act] -= 1
        m = stack[act, sp[act]].to(torch.int64)
        if ordered:
            # pop-time cull: every hit in the node lies at t >= its entry,
            # so past bt*(1+tie_eps) it can neither replace nor kill
            fresh = tstack[act, sp[act]] <= state[0, act] * eps1
            act, m = act[fresh], m[fresh]
        is_leaf = m < 0

        # --- interior pops: slab-test the 8 children, push in reverse order
        ia = act[~is_leaf]
        if ia.numel():
            if stats is not None:
                seen["rows"][m[~is_leaf][state[0, ia] >= 0.0]] = True
            row = WN[m[~is_leaf]]                      # (n, 128)
            bte = state[0, ia] * eps1
            ix, iy, iz = invx[ia], invy[ia], invz[ia]
            ax_, ay_, az_ = oix[ia], oiy[ia], oiz[ia]
            spi = sp[ia]
            kids = []                    # (key, meta, keep, entry) per child
            for ch in (range(8) if ordered else range(7, -1, -1)):
                b = row[:, ch * 8: ch * 8 + 8]
                meta = b[:, 6]
                visits += ((meta != -1.0) & (state[0, ia] >= 0.0)).sum()
                t_ax = b[:, 0] * ix - ax_
                t_bx = b[:, 3] * ix - ax_
                t_ay = b[:, 1] * iy - ay_
                t_by = b[:, 4] * iy - ay_
                t_az = b[:, 2] * iz - az_
                t_bz = b[:, 5] * iz - az_
                t0 = torch.maximum(
                    torch.maximum(torch.minimum(t_ax, t_bx),
                                  torch.minimum(t_ay, t_by)),
                    torch.minimum(t_az, t_bz))
                t1 = torch.minimum(
                    torch.minimum(torch.maximum(t_ax, t_bx),
                                  torch.maximum(t_ay, t_by)),
                    torch.maximum(t_az, t_bz))
                dist = torch.where(t0 > 0.0, t0, t1)
                keep = ((t1 >= t0) & (dist > 0.0)
                        & (torch.clamp_min(t0, 0.0) <= bte) & (meta != -1.0))
                if ordered:
                    m3 = pmd[ia]
                    key = ((b[:, 0] + b[:, 3]) * m3[:, 0]
                           + (b[:, 1] + b[:, 4]) * m3[:, 1]
                           + (b[:, 2] + b[:, 5]) * m3[:, 2])
                    kids.append([torch.where(keep, key, INF), meta, keep,
                                 torch.clamp_min(t0, 0.0)])
                    continue
                k = torch.nonzero(keep).squeeze(1)
                stack[ia[k], spi[k]] = meta[k].to(torch.int32)
                spi = spi + keep
            # near-first: descending keys (strict <, as _interior_push), so
            # the nearest child is pushed last and popped first
            if ordered:
                live_ia = state[0, ia] >= 0.0
                sorts += live_ia.sum()
                keys += sum((kid[2] & live_ia).sum() for kid in kids)
            for p, q in (SORT8 if ordered else ()):
                sw = kids[p][0] < kids[q][0]
                kids[p], kids[q] = (
                    [torch.where(sw, y, x) for x, y in zip(kids[p], kids[q])],
                    [torch.where(sw, x, y) for x, y in zip(kids[p], kids[q])])
            for _, meta, keep, ent in kids:
                k = torch.nonzero(keep).squeeze(1)
                stack[ia[k], spi[k]] = meta[k].to(torch.int32)
                tstack[ia[k], spi[k]] = ent[k]
                spi = spi + keep
            sp[ia] = spi

        # --- leaf pops: the slot loop over the leaf's occupied slots
        la = act[is_leaf]
        if la.numel():
            dec = -m[is_leaf] - 2
            leaf = dec >> 6
            cnt = dec & 63
            st = state[:, la]
            lx, ly, lz = ox[la], oy[la], oz[la]
            ex, ey, ez = dx[la], dy[la], dz[la]
            ltg, ltga = tg[la], tga[la]
            for s in range(int(cnt.max())):
                # a lane killed earlier (bt = -1) has left the kernel's walk
                live = (cnt > s) & (st[0] >= 0.0)
                slots += live.sum()
                cols = (leaf * 128 + s)[:, None] + lane_off     # (n, 4)
                blk = PS[:, cols]                               # (8, n, 4)
                g = lambda a: blk[a // 4, :, a % 4]
                h = lambda a: blk[4 + a // 4, :, a % 4]
                tm, u, v = woop_slot_test(g, (lx, ly, lz), (ex, ey, ez), config)
                tm = torch.where(cnt > s, tm, INF)
                em = g(15)
                bt, bem = st[0], st[EM]
                repl = slot_replaces(tm, em, bt, bem, eps1)
                may_kill = ltga & (tm * eps1 < bt)
                mt_slot = h(15)
                wrong = (mt_slot - ltg).abs() > 0.5
                kill = may_kill & wrong
                if stats is not None:
                    slot_id = leaf * SLOT + s
                    seen["P"][slot_id[live]] = True
                    seen["mtl"][slot_id[live & (repl | may_kill)]] = True
                    if attrs and not occl:
                        seen["shading"][slot_id[live & repl]] = True
                sel = lambda kv, rv, old: torch.where(
                    kill, kv, torch.where(repl, rv, old))
                new_bt = sel(-one, tm, bt)
                new_em = sel(zero, em, bem)
                if occl:
                    bs = sel(zero, torch.where(wrong, zero, one), st[1])
                    st = torch.stack([new_bt, bs, new_em])
                    continue
                rows = [new_bt, *st[1:6], sel(c(-3.0), mt_slot, st[6]),
                        new_em, st[8]]
                if attrs:
                    w = 1.0 - u - v
                    for k, (a0, a1, a2) in enumerate(
                            ((0, 3, 6), (1, 4, 7), (2, 5, 8),
                             (9, 11, 13), (10, 12, 14))):
                        val = h(a0) * w + h(a1) * u + h(a2) * v
                        rows[1 + k] = torch.where(repl, val, st[1 + k])
                    slot = (leaf * SLOT + s).to(f32)
                    rows[8] = sel(-one, slot, st[8])
                st = torch.stack(rows)
            state[:, la] = st

    if stats is not None:
        stats["node_visits"] = stats.get("node_visits", 0) + int(visits)
        stats["slot_tests"] = stats.get("slot_tests", 0) + int(slots)
        stats["near_keys"] = stats.get("near_keys", 0) + int(keys)
        stats["near_sorts"] = stats.get("near_sorts", 0) + int(sorts)
        # a 32-byte record per occupied child of a row; a slot's 64-byte
        # test record, its shading record or else its material; the slot
        # id of each ray's best record
        occupied = int((WN[seen["rows"]][:, 6:64:8] != -1.0).sum())
        mtl_only = seen["mtl"] & ~seen["shading"]
        best = state[8] if attrs and not occl else state[0][:0]
        nbytes = (32 * occupied + 64 * int(seen["P"].sum())
                  + 64 * int(seen["shading"].sum()) + 4 * int(mtl_only.sum())
                  + 4 * torch.unique(best[best >= 0.0]).numel())
        stats["scene_bytes"] = stats.get("scene_bytes", 0) + nbytes
    return state[:2] if occl else state


# ---------------------------------------------------------------------------
# the CUDA kernels' wrappers
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TraceRecords:
    """The trace kernels' layout of a PackedLeaves tree (``trace_records``).

    ``node`` (n_wide * 8, 8) int32, one 32-byte record per child of each
    wide node, ``[x0 y0 z0 x1 | y1 z1 meta link]``: the bits of WN's eight
    lanes for that child, the last (a pad in WN) holding ``link``: for a
    leaf child the index of its first slot record, for an interior child
    the number of children of that wide node, 0 for an empty child. Empty
    children trail every row. ``slot`` (n_records, 16) float32: the
    occupied slots' test records, ``BvhRecords.slot`` itself (P's 16
    attributes, in leaf-id and slot order). ``shade`` (n_records, 16)
    float32: the same slots' PS rows 4-7 in the S order ``[n0x n0y n0z n1x
    | n1y n1z n2x n2y | n2z t0u t0v t1u | t1v t2u t2v mtl]``. ``slot_id``
    (n_records,) int32: 32 * leaf + s of each record. ``root_kids``: the
    root wide node's children; ``wide_depth``: for the stack bound;
    ``leaf_size``: the most slots a leaf holds."""

    node: torch.Tensor
    slot: torch.Tensor
    shade: torch.Tensor
    slot_id: torch.Tensor
    root_kids: int
    wide_depth: int
    leaf_size: int


def trace_records(pk, brec) -> TraceRecords:
    """The trace kernels' layout of ``pk`` on its device, reusing the
    packet-BVH kernel's slot records ``brec`` (``Scene.trace_records``
    builds it once per scene)."""
    dev = pk.WN.device
    if pk.n_leaves * 64 + 66 > 2 ** 24:
        raise ValueError("WN's float leaf words are exact below 262,143 leaves")
    child = pk.WN[:, :64].reshape(-1, 8)      # lanes 64-127 of a row are unused
    meta = child[:, 6].to(torch.int64)
    kids = (meta != -1).reshape(-1, 8).sum(dim=1)
    # widen_bvh fills each row from the front: the walks stop at `kids`
    if not torch.equal(meta.reshape(-1, 8) != -1,
                       torch.arange(8, device=dev) < kids[:, None]):
        raise ValueError("empty children must trail every wide node")
    leaf, inner = meta <= -2, meta >= 0
    dec = -meta[leaf] - 2
    slot_id = brec.slot_id
    first = torch.searchsorted(slot_id, ((dec >> 6) * SLOT).to(torch.int32))
    last = torch.searchsorted(slot_id, ((dec >> 6) * SLOT + SLOT).to(torch.int32))
    if not torch.equal(last - first, dec & 63):
        raise ValueError("a leaf child's count must match its slot records")
    link = torch.zeros_like(meta)
    link[leaf] = first
    link[inner] = kids[meta[inner]]
    node = child.contiguous().view(torch.int32).clone()
    node[:, 7] = link.to(torch.int32)
    a = torch.arange(16, device=dev)
    sid = slot_id.to(torch.int64)[:, None]
    col = (sid >> 5) * 128 + (a % 4) * SLOT + (sid & (SLOT - 1))
    shade = pk.PS[4 + a // 4, col].contiguous()
    return TraceRecords(node=node, slot=brec.slot, shade=shade,
                        slot_id=slot_id, root_kids=int(kids[0]),
                        wide_depth=pk.wide_depth, leaf_size=pk.leaf_size)


def near_pause(rec: TraceRecords, md) -> int:
    """How few of a warp's lanes may still be walking before they pause
    and the warp tests the leaves the others hold (0: never): 8 for the
    near-first walk on leaves of at most 8 slots. On leaves of up to 32
    slots, whose tests cost more, the warp waits for its last walkers,
    and a preorder lane walks on past its held leaves instead (both
    measured faster on the card)."""
    return 8 if md is not None and rec.leaf_size <= 8 else 0


def _lib():
    from tinyraytracing_tpu_torch.ops.kernels import library

    lib = library("trace.cu")
    if not getattr(lib, "_trt_typed", False):
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.trt_trace.argtypes = [P, P, P, P, P, P, P, I, I, P, I, I, I, F, F,
                                  F, P]
        lib.trt_trace.restype = ctypes.c_int
        lib.trt_packet_dirs.argtypes = [P, I, I, P, P]
        lib.trt_packet_dirs.restype = ctypes.c_int
        lib.trt_max_stack.argtypes = []
        lib.trt_max_stack.restype = ctypes.c_int
        lib._trt_typed = True
    return lib


def trace_kernel(rec: TraceRecords, rays: torch.Tensor, config: RenderConfig,
                 *, attrs: bool = True, occl: bool = False, tile: int = 0,
                 md: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream over the scene's
    ``trace_records``; same result as ``trace_plain`` on the scene's
    PackedLeaves. Raises on a CPU tensor or a failed launch."""
    if not rays.is_cuda:
        raise ValueError("trace_kernel needs CUDA tensors")
    checked = [("rays", rays, torch.float32), ("node", rec.node, torch.int32),
               ("slot", rec.slot, torch.float32),
               ("shade", rec.shade, torch.float32),
               ("slot_id", rec.slot_id, torch.int32)]
    if md is not None:
        checked.append(("md", md, torch.float32))
    for name, x, dt in checked:
        if x.dtype != dt or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dt}")
        if x.device != rays.device:
            raise ValueError(f"{name} is on {x.device}, rays on {rays.device}")
    if rays.dim() != 2 or rays.shape[0] != 8:
        raise ValueError(f"rays must be (8, R), got {tuple(rays.shape)}")
    n_rec = rec.slot.shape[0]
    if (rec.node.dim() != 2 or rec.node.shape[1] != 8
            or tuple(rec.shade.shape) != (n_rec, 16)
            or tuple(rec.slot_id.shape) != (n_rec,)):
        raise ValueError("node records must be (n, 8), slot and shading "
                         "records (n_records, 16), slot ids (n_records,)")
    if rec.node.shape[0] >= 2 ** 28 or n_rec >= 2 ** 25:
        raise ValueError("the kernel's stack words hold < 2^25 slot records "
                         "and < 2^25 wide nodes")
    R = rays.shape[1]
    if md is not None and (tile <= 0 or tuple(md.shape) != (-(-R // tile), 3)):
        raise ValueError(f"md must be (ceil(R / tile), 3) with tile > 0, got "
                         f"{tuple(md.shape)} for R={R}, tile={tile}")
    lib = _lib()
    need = rec.wide_depth * 7 + 1
    if need > lib.trt_max_stack():
        raise ValueError(f"BVH needs a {need}-entry stack; the kernel holds "
                         f"{lib.trt_max_stack()} (TRT_MAX_STACK in trace.cu)")
    out = torch.empty((2 if occl else N_OUT, R), dtype=torch.float32,
                      device=rays.device)
    # on a tree of more than one wide node, resident blocks take the rays
    # from a counter, refilling the lanes whose walks end early; a one-node
    # tree's walks are short and alike, and there a plain grid is faster
    counter = (torch.empty(1, dtype=torch.int32, device=rays.device)
               if rec.node.shape[0] > 8 else None)
    pause = near_pause(rec, md)
    query = 2 if occl else (0 if attrs else 1)
    with torch.cuda.device(rays.device):
        err = lib.trt_trace(
            rays.data_ptr(), rec.node.data_ptr(), rec.slot.data_ptr(),
            rec.shade.data_ptr(), rec.slot_id.data_ptr(), out.data_ptr(),
            None if counter is None else counter.data_ptr(), R, query,
            None if md is None else md.data_ptr(), tile, rec.root_kids, pause,
            config.t_min, config.n_dot_d_min, 1.0 + config.tie_eps,
            torch.cuda.current_stream(rays.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"trace kernel launch failed: cudaError {err}")
    if md is not None:
        spans.count("launches.trace_near")
    else:
        spans.count("launches.trace_occlusion" if occl
                    else "launches.trace_closest")
    return out


def _trace(scene, rays, config, attrs, occl):
    pk = scene.bvh.packed
    tile, md = walk_packets(pk, rays, config, occl)
    if rays.is_cuda:
        return trace_kernel(scene.trace_records, rays, config, attrs=attrs,
                            occl=occl, tile=tile, md=md)
    if rays.device.type == "cpu":
        return trace_plain(pk, rays, config, attrs=attrs, occl=occl,
                           tile=tile, md=md)
    raise ValueError(f"no trace implementation for device {rays.device}")


def fused_trace_planes(scene, ox, oy, oz, dx, dy, dz, config: RenderConfig,
                       t_bound=None, target_mtl=None, return_tri: bool = False,
                       attrs: bool = True, query: str = "closest"):
    """Fused closest-hit + shading-attribute trace (the JAX function's
    signature and outputs, less its ``force_kernel`` switch).

    Planar in, planar out: six (R,) ray planes -> (t, pn_x, pn_y, pn_z,
    tc_u, tc_v, mtl, em) (R,) planes; ``pn`` is the unnormalized
    interpolated shading normal, ``mtl`` the material id as f32 (-1 miss,
    -3 killed), misses keep t at the bound (3e38 by default).
    ``t_bound``/``target_mtl``: per-ray initial best t and shadow target
    material (> -1.5 enables the early kill). ``attrs=False`` skips the
    attribute interpolation (pn/tc/slot keep their initial values).
    ``return_tri`` appends the hit triangle index as f32 (-1 miss/killed).
    ``query="occlusion"`` returns the two planes (bt, seen); visibility is
    ``(seen > 0.5) & (bt >= 0)``. ``config.walk_order``, ``bvh_walk`` and
    ``ray_tile`` pick the walk and its packets (``walk_packets``).
    """
    if query not in ("closest", "occlusion"):
        raise ValueError(f"unknown query {query!r}")
    occl = query == "occlusion"
    if t_bound is None:
        t_bound = torch.full_like(ox, _INF)
    if target_mtl is None:
        target_mtl = torch.full_like(ox, -2.0)
    pk = scene.bvh.packed
    rays = torch.stack([ox, oy, oz, dx, dy, dz, t_bound, target_mtl]).to(
        torch.float32).contiguous()
    outs = _trace(scene, rays, config, attrs, occl).unbind(0)
    if occl:
        return outs
    if not return_tri:
        return outs[:8]
    slot = outs[8]
    tri = torch.where(
        slot >= 0.0,
        pk.tid[torch.clamp_min(slot, 0).to(torch.int64)].to(torch.float32),
        -1.0,
    )
    return outs[:8] + (tri,)


def occlusion_trace_segmented(scene, ox, oy, oz, dx, dy, dz, t_bound,
                              target_mtl, config: RenderConfig, n_seg: int):
    """Occlusion query over ``n_seg`` concatenated equal segments of shadow
    lanes (one per light), with optional per-segment live-lane compaction.
    Returns ONE (n_seg * R,) f32 visibility plane: 1.0 where some
    target-material hit lies within the tie band of the bound and no
    wrong-material hit strictly inside occluded the lane; parked lanes
    (t_bound == 0) give 0.

    ``config.shadow_compact``: "on" compacts; "auto" follows the JAX
    package's rule (n_wide > 512) under ``walk_order="near"``, where the
    packets are part of the result, and is off under preorder (the
    one-thread-per-ray kernel has no packet for parked lanes to dilute,
    and on an H100 the compaction's two sorts cost more than the
    occlusion time they saved on grid:100000 — PERF.md, Findings).

    Compaction is a stable sort of each segment by "parked", the trace of
    the sorted lanes, and the inverse sort. Under preorder per-lane
    results do not depend on lane order, so the visibility is bitwise the
    uncompacted one; under near the sort regroups the packets and so
    their keys, which can move a lane only inside the tie band. The
    segment's target material is re-broadcast from its live lanes (all
    live lanes of a segment target the same light)."""
    n_wide = scene.bvh.packed.n_wide
    compact = config.shadow_compact == "on" or (
        config.shadow_compact == "auto" and config.walk_order == "near"
        and n_wide > 512)
    vis = lambda bt, seen: ((seen > 0.5) & (bt >= 0.0)).to(torch.float32)
    if not compact or n_seg * 128 > ox.shape[0]:
        bt, seen = fused_trace_planes(
            scene, ox, oy, oz, dx, dy, dz, config,
            t_bound=t_bound, target_mtl=target_mtl, query="occlusion",
        )
        return vis(bt, seen)

    R = ox.shape[0] // n_seg
    seg = lambda x: x.reshape(n_seg, R)
    dead = (seg(t_bound) <= 0.0).to(torch.int32)
    _, perm = torch.sort(dead, dim=1, stable=True)
    take = lambda x: torch.gather(seg(x), 1, perm)
    stb = take(t_bound)
    seg_tg = torch.amax(
        torch.where(seg(t_bound) > 0.0, seg(target_mtl),
                    torch.full_like(stb, float("-inf"))),
        dim=1, keepdim=True,
    )
    ctg = torch.where(stb > 0.0, seg_tg, torch.full_like(stb, -2.0))
    flat = lambda a: a.reshape(n_seg * R)
    cbt, cseen = fused_trace_planes(
        scene, flat(take(ox)), flat(take(oy)), flat(take(oz)),
        flat(take(dx)), flat(take(dy)), flat(take(dz)),
        config, t_bound=flat(stb), target_mtl=flat(ctg), query="occlusion",
    )
    out = torch.empty_like(stb)
    out.scatter_(1, perm, seg(vis(cbt, cseen)))       # inverse permutation
    return flat(out)
