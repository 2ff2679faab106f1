"""The Woop-plane slot test and the repl rule of the JAX walk kernels, for
the plain versions of the three walk kernels (``ops/trace.py``,
``ops/bvh_intersect.py``, ``ops/slot_intersect.py``). Their CUDA twin is
``csrc/slot_test.cuh``, included by all three ``.cu`` sources: the kernels'
bitwise equality with their plain versions rests on these expressions, in
the JAX association order.

Also here: the per-ray running best over slots in order (``merge_slots``),
which the brute-force and packet-BVH plain versions share.
"""

from __future__ import annotations

import torch

from tinyraytracing_tpu_torch.config import RenderConfig

_INF = 3.0e38
SLOT = 32          # triangle slots per 128-lane block
# float operations of one (ray, slot) test, as the kernels run it: ldw 5,
# low 6, inverse 3, t 2, u 13, v 13, n.d 5, accept 8, tm 1, tie band 5,
# repl 3, carry selects 5
SLOT_FLOPS = 69


def woop_slot_test(g, o, d, config: RenderConfig):
    """Slot test of the rays ``o``/``d`` (xyz triples of planes) against the
    slots whose attribute a (0..15, the P layout) is ``g(a)``, broadcastable
    against the ray planes. Returns (tm, u, v): tm = t where the slot is
    accepted, else 3e38."""
    ox, oy, oz = o
    dx, dy, dz = d
    ax, ay, az, bx = g(0), g(1), g(2), g(3)
    by, bz, cx, cy = g(4), g(5), g(6), g(7)
    cz, ou, ov, ow = g(8), g(9), g(10), g(11)
    gx, gy, gz = g(12), g(13), g(14)
    ldw = dx * cx + dy * cy + dz * cz
    low = ox * cx + oy * cy + oz * cz + ow
    z = ldw == 0.0
    inv = (torch.where(z, 0.0, 1.0).to(torch.float32)
           / torch.where(z, torch.ones_like(ldw), ldw))
    t = -low * inv
    u = (ox * ax + oy * ay + oz * az + ou) + t * (dx * ax + dy * ay + dz * az)
    v = (ox * bx + oy * by + oz * bz + ov) + t * (dx * bx + dy * by + dz * bz)
    ndd = dx * gx + dy * gy + dz * gz
    ok = ((ndd.abs() >= config.n_dot_d_min) & (ldw != 0.0)
          & (t >= config.t_min) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0))
    return torch.where(ok, t, torch.full_like(t, _INF)), u, v


def slot_replaces(tm, em, bt, be, eps1):
    """Whether a slot at ``tm`` with emissive flag ``em`` replaces the best
    (``bt``, ``be``): closer outside the relative tie band; inside it,
    emissive over non-emissive. ``eps1`` = float32(1 + tie_eps)."""
    near = (tm <= bt * eps1) & (bt <= tm * eps1) & (tm < _INF)
    return (~near & (tm < bt)) | (near & (em > 0.5) & (be < 0.5))


def merge_slots(best, rows, tm, u, v, em, slot_id, eps1):
    """Apply the (n, S) slot results of rays ``rows`` to the running best
    (bt, bi, bu, bv, be) planes, slot after slot per ray, in place.
    ``slot_id``: (n, S) float slot ids. A slot with tm >= 3e38 never
    replaces, so only accepted slots are visited, in rank order."""
    bt, bi, bu, bv, be = best
    cand = tm < _INF
    rank = torch.cumsum(cand.to(torch.int32), dim=1)
    n_ok = rank[:, -1]
    for k in range(1, int(n_ok.max()) + 1 if n_ok.numel() else 1):
        sel = torch.nonzero(n_ok >= k).squeeze(1)
        s = (cand[sel] & (rank[sel] == k)).to(torch.int8).argmax(dim=1)[:, None]
        r = rows[sel]
        at = lambda x: torch.gather(x[sel], 1, s)[:, 0]
        ctm, cem = at(tm), at(em)
        cbt, cbe = bt[r], be[r]
        repl = slot_replaces(ctm, cem, cbt, cbe, eps1)
        bt[r] = torch.where(repl, ctm, cbt)
        bi[r] = torch.where(repl, at(slot_id), bi[r])
        bu[r] = torch.where(repl, at(u), bu[r])
        bv[r] = torch.where(repl, at(v), bv[r])
        be[r] = torch.where(repl, cem, cbe)


def init_best(R, device):
    f = lambda v: torch.full((R,), v, dtype=torch.float32, device=device)
    return f(_INF), f(0.0), f(0.0), f(0.0), f(0.0)


def tie_band(config, device):
    """float32(1 + tie_eps) on ``device``: the relative tie band's factor."""
    return torch.tensor(1.0 + config.tie_eps, dtype=torch.float32, device=device)
