"""A per-ray emulation of the trace kernels' walk (csrc/trace.cu) over
``Scene.trace_records``, for the CPU tests: the same float32 operations in
the same order, vectorised over rays, so its results are bitwise the
kernel's. It reads the records as the kernel does and can count what it
reads (``reads``), so the tests also check the plain version's byte count
behind the kernels' bounds."""

from __future__ import annotations

import torch

from tinyraytracing_tpu_torch.ops import trace as ttrace
from tinyraytracing_tpu_torch.ops.slot_test import slot_replaces, woop_slot_test

HOLD = 2          # TRT_HOLD in csrc/trace.cu

def _word(meta, link):
    """child_word: w*8 + kids-1 for an interior child, -(first*64 +
    count) - 1 for a leaf child."""
    m = meta.to(torch.int64)
    link = link.to(torch.int64)
    return torch.where(m >= 0, m * 8 + link - 1,
                       -(link * 64 + ((-m - 2) & 63)) - 1)


def emulate(rec, rays, config, *, attrs=True, occl=False, tile=0, md=None,
            warp=32, hold=HOLD, reads=None):
    """The kernel's result for (8, R) ``rays``, computed as trace.cu walks:
    the node loop (pop, hold a leaf, or expand an interior node from its
    child records; leave when `hold` leaves are held, the walk is over, or
    every lane of the warp still walking holds one), then the leaf loop
    over the held leaves from the slot test and shading records. The
    kernel's lanes may take their rays in any order (its resident blocks
    refill lanes whose walks end); a lane's result depends on its ray
    alone, so here warps are groups of consecutive rays. With
    ``warp=1`` every lane tests each leaf as it meets it (the plain walk's
    order of events); with ``warp=None`` there is no vote, and every lane
    walks on until it holds `hold` leaves or its walk ends. ``reads`` (if given) gains "bytes" (each record the
    walk reads counted once: child records, slot test records, a shading
    record or else a material, the slot id of each best record),
    "slot_tests" and "held" (leaves tested after the first of a set)."""
    f32 = torch.float32
    R = rays.shape[1]
    c = lambda x: torch.tensor(x, dtype=f32)
    eps1 = c(1.0 + config.tie_eps)
    ordered = md is not None
    hold = 1 if ordered or not config.t_min > 0 else hold
    ox, oy, oz, dx, dy, dz, tb, tg = rays.unbind(0)

    def inv_of(d):
        small = d.abs() < c(1e-18)
        return torch.where(small, c(1e18), c(1.0)) / torch.where(small, c(1.0), d)

    inv = (inv_of(dx), inv_of(dy), inv_of(dz))
    oi = (ox * inv[0], oy * inv[1], oz * inv[2])
    tga = tg > -1.5
    node = rec.node
    nodef = node.view(f32)
    bt, bem, bs = tb.clone(), torch.zeros(R), torch.zeros(R)
    bpn = [torch.zeros(R), torch.zeros(R), torch.ones(R)]
    btc = [torch.zeros(R), torch.zeros(R)]
    bmtl = torch.full((R,), -1.0)
    brec = torch.full((R,), -1, dtype=torch.int64)
    pmd = md[torch.arange(R) // tile] if ordered else None
    S = rec.wide_depth * 7 + 16
    stack = torch.zeros((R, S), dtype=torch.int64)
    sent = torch.zeros((R, S), dtype=f32)
    sp = torch.zeros(R, dtype=torch.int64)
    cur = torch.full((R,), rec.root_kids - 1, dtype=torch.int64)
    have = torch.ones(R, dtype=torch.bool)
    walking = torch.ones(R, dtype=torch.bool)          # the outer loop
    wid = torch.arange(R) // (warp or R)

    n_rec = rec.slot.shape[0]
    seen = {k: torch.zeros(n, dtype=torch.bool) for k, n in (
        ("child", node.shape[0]), ("slot", n_rec), ("shade", n_rec),
        ("mtl", n_rec))}
    n_tests = n_held = 0

    def push(lanes, word, ent):
        stack[lanes, sp[lanes]] = word
        sent[lanes, sp[lanes]] = ent
        sp[lanes] += 1

    while walking.any():
        held = torch.zeros((R, hold), dtype=torch.int64)
        nh = torch.zeros(R, dtype=torch.int64)
        inner = walking.clone()
        while inner.any():
            # pop where nothing is held in cur (ORDERED: skip stale nodes)
            bte = bt * eps1
            while True:
                need = inner & ~have & (sp > 0)
                if not need.any():
                    break
                i = torch.nonzero(need).squeeze(1)
                top = sp[i] - 1
                stale = (sent[i, top] > bte[i]) if ordered else torch.zeros_like(i, dtype=torch.bool)
                sp[i] = top
                fresh = i[~stale]
                cur[fresh] = stack[fresh, top[~stale]]
                have[fresh] = True
            over = inner & ~have
            inner &= ~over
            # a leaf: hold it
            lf = torch.nonzero(inner & (cur < 0)).squeeze(1)
            held[lf, nh[lf]] = cur[lf]
            nh[lf] += 1
            have[lf] = False
            full = torch.zeros(R, dtype=torch.bool)
            full[lf] = nh[lf] == hold
            # an interior node: test its children against this bt
            ex = torch.nonzero(inner & (cur >= 0)).squeeze(1)
            if ex.numel():
                w, nk = cur[ex] >> 3, (cur[ex] & 7) + 1
                rows = (w * 8)[:, None] + torch.arange(8)           # (n, 8)
                a = nodef[rows]                                     # (n, 8, 8)
                seen["child"][rows[torch.arange(8) < nk[:, None]]] = True
                bte = bt[ex] * eps1
                kids = []
                for k in range(8):
                    x0, y0, z0, x1, y1, z1 = (a[:, k, j] for j in range(6))
                    t_ax = x0 * inv[0][ex] - oi[0][ex]
                    t_bx = x1 * inv[0][ex] - oi[0][ex]
                    t_ay = y0 * inv[1][ex] - oi[1][ex]
                    t_by = y1 * inv[1][ex] - oi[1][ex]
                    t_az = z0 * inv[2][ex] - oi[2][ex]
                    t_bz = z1 * inv[2][ex] - oi[2][ex]
                    t0 = torch.maximum(torch.maximum(torch.minimum(t_ax, t_bx),
                                                     torch.minimum(t_ay, t_by)),
                                       torch.minimum(t_az, t_bz))
                    t1 = torch.minimum(torch.minimum(torch.maximum(t_ax, t_bx),
                                                     torch.maximum(t_ay, t_by)),
                                       torch.maximum(t_az, t_bz))
                    dist = torch.where(t0 > 0.0, t0, t1)
                    keep = ((t1 >= t0) & (dist > 0.0)
                            & (torch.clamp_min(t0, 0.0) <= bte) & (k < nk))
                    word = torch.where(k < nk, _word(a[:, k, 6], node[rows[:, k], 7]),
                                       torch.full_like(w, -1))
                    key = c(3.0e38).expand_as(t0)
                    if ordered:
                        m3 = pmd[ex]
                        key = torch.where(keep, (x0 + x1) * m3[:, 0]
                                          + (y0 + y1) * m3[:, 1]
                                          + (z0 + z1) * m3[:, 2], key)
                    ent = torch.where(k < nk, torch.clamp_min(t0, 0.0), c(0.0))
                    kids.append([key, word, keep, ent])
                if ordered:
                    for p, q in ttrace.SORT8:
                        sw = kids[p][0] < kids[q][0]
                        kids[p], kids[q] = (
                            [torch.where(sw, y, x) for x, y in zip(kids[p], kids[q])],
                            [torch.where(sw, x, y) for x, y in zip(kids[p], kids[q])])
                    order = range(8)
                else:
                    order = range(7, -1, -1)
                nxt = torch.full_like(w, -1)
                nent = torch.zeros(ex.numel())
                for k in order:
                    _, word, keep, ent = kids[k]
                    pu = keep & (nxt != -1)
                    push(ex[pu], nxt[pu], nent[pu])
                    nxt = torch.where(keep, word, nxt)
                    nent = torch.where(keep, ent, nent)
                cur[ex] = nxt
                have[ex] = nxt != -1
            inner &= ~full
            # the vote: leave when every lane of the warp still walking
            # holds a leaf
            waiting = torch.zeros(R, dtype=torch.int64).index_add_(
                0, wid, (inner & (nh == 0)).long())
            if warp:
                inner &= waiting[wid] > 0
        # leaf loop: the held leaves in order
        walking &= nh > 0
        for j in range(hold):
            lanes = torch.nonzero(walking & (nh > j)).squeeze(1)
            if not lanes.numel():
                continue
            x = -held[lanes, j] - 1
            first, cnt = x >> 6, x & 63
            if j:
                n_held += lanes.numel()
            for s in range(int(cnt.max())):
                live = (cnt > s) & walking[lanes]
                i, k = lanes[live], (first + s)[live]
                n_tests += k.numel()
                seen["slot"][k] = True
                f = rec.slot[k]
                h = rec.shade[k]
                o, d = (ox[i], oy[i], oz[i]), (dx[i], dy[i], dz[i])
                tm, u, v = woop_slot_test(lambda a: f[:, a], o, d, config)
                em = f[:, 15]
                repl = slot_replaces(tm, em, bt[i], bem[i], eps1)
                may_kill = tga[i] & (tm * eps1 < bt[i])
                mt = h[:, 15]
                wrong = (mt - tg[i]).abs() > 0.5
                kill = may_kill & wrong
                upd = repl | may_kill
                whole = repl if attrs and not occl else torch.zeros_like(repl)
                seen["shade"][k[whole]] = True
                seen["mtl"][k[upd & ~whole]] = True
                sel = lambda kv, rv, old: torch.where(
                    kill, kv, torch.where(upd, rv, old))
                bt[i] = sel(c(-1.0), tm, bt[i])
                bem[i] = sel(c(0.0), em, bem[i])
                if occl:
                    bs[i] = sel(c(0.0), torch.where(wrong, c(0.0), c(1.0)), bs[i])
                else:
                    bmtl[i] = sel(c(-3.0), mt, bmtl[i])
                    if attrs:
                        brec[i] = torch.where(kill, -1, torch.where(upd, k, brec[i]))
                        ww = 1.0 - u - v
                        for p, (a0, a1, a2) in enumerate(
                                ((0, 3, 6), (1, 4, 7), (2, 5, 8))):
                            bpn[p][i] = torch.where(
                                repl, h[:, a0] * ww + h[:, a1] * u + h[:, a2] * v,
                                bpn[p][i])
                        for p, (a0, a1, a2) in enumerate(((9, 11, 13), (10, 12, 14))):
                            btc[p][i] = torch.where(
                                repl, h[:, a0] * ww + h[:, a1] * u + h[:, a2] * v,
                                btc[p][i])
                if config.t_min > 0:                 # a kill ends the walk
                    done = i[kill]
                    walking[done] = False
                    sp[done] = 0
                    have[done] = False
    if reads is not None:
        best = torch.unique(brec[brec >= 0])
        reads["bytes"] = int(32 * seen["child"].sum() + 64 * seen["slot"].sum()
                             + 64 * seen["shade"].sum()
                             + 4 * (seen["mtl"] & ~seen["shade"]).sum()
                             + 4 * best.numel())
        reads["slot_tests"] = n_tests
        reads["held"] = n_held
    if occl:
        return torch.stack([bt, bs])
    slot = torch.where(brec >= 0, rec.slot_id[brec.clamp_min(0)].to(f32), c(-1.0))
    return torch.stack([bt, *bpn, *btc, bmtl, bem, slot])


