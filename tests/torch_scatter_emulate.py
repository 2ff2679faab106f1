"""Python emulations of ``tinyraytracing_tpu_torch/csrc/scatter_add.cu``'s
thread programs, for the CPU tests (the kernels run only on the card).

An image call (``rows_add``) first claims its rows' slots, and sorts only
where a row takes more than ``SLOTS`` values. A cotangent call
(``fixed_sum``) sorts, gathers the values in sorted order (and the run
ends after several passes), then ``sums`` runs the second launch: a lane
per level-0 chunk, the levels above summed by the warp of the child that
counts last. The sort (``sort_rows``) is emulated phase by phase, block
by block, a warp's turn of 32 lanes at a time: per pass ``count`` (each
block's histogram of the pass's digit over the items it owns, one add per
group of equal digits of a turn) and ``place`` (the table read by every
block, the scan of the digit totals, the warp ranks from the peers of a
lane's digit and the popcount of the lower lanes, the per-warp offsets,
the placement). The launch constants are parameters (``Shape``), so a
test can force several blocks, sub-tiles and passes at a small size;
``KERNEL`` holds the kernel's own.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Shape:
    threads: int = 512          # csrc/scatter_add.cu THREADS
    items: int = 4              # ITEMS
    max_blocks: int = 128       # MAX_BLOCKS (the card may hold fewer)
    digit_bits: int = 8         # DIGIT_BITS

    @property
    def warps(self):
        return self.threads // 32

    @property
    def tile(self):
        return self.threads * self.items


KERNEL = Shape()
SLOTS = 4                   # csrc/scatter_add.cu: positions a row's claim holds


@dataclass
class Plan:
    G: int
    BS: int
    passes: list                # (shift, bits) per pass, least significant first


def make_plan(n, nkeys, shape=KERNEL):
    """``make_plan`` of the source: blocks, items a block owns, digits."""
    tiles = max(1, -(-n // shape.tile))
    per = -(-tiles // shape.max_blocks)           # sub-tiles a block
    G = -(-tiles // per)
    BS = per * shape.tile
    B = 1
    while B < 31 and (1 << B) < nkeys:
        B += 1
    P = -(-B // shape.digit_bits)
    passes, done = [], 0
    for i in range(P):
        w = -(-(B - done) // (P - i))
        passes.append((done, w))
        done += w
    return Plan(G, BS, passes)


def _block_range(plan, p, n_items, b):
    """block_range: the first pass's blocks own BS positions each, a later
    pass's spread its kept items evenly."""
    per = plan.BS if p == 0 else -(-n_items // plan.G)
    return b * per, min(b * per + per, n_items)


def _peers(v):
    """The kernel's multisplit over one turn's 32 values (one ballot a
    bit): (rank among the lower lanes of equal value, group size, is the
    group's lowest lane)."""
    eq = v[None, :] == v[:, None]
    lower = np.tril(np.ones((32, 32), bool), -1)          # [lane, other < lane]
    rank = (eq & lower).sum(1)
    return rank, eq.sum(1), rank == 0


def _keys(rows, nkeys):
    r = np.asarray(rows, np.int64).reshape(-1)
    return np.where((r >= 0) & (r < nkeys), r, -1).astype(np.int64)


def count(keys, n_items, p, plan, shape=KERNEL):
    """count_phase of pass ``p`` over every block: its row of the table,
    the histogram of the pass's digit over the items it owns (``keys``:
    the pass's input, -1 where dropped), one add per group of equal
    digits of a warp's turn."""
    shift, bits = plan.passes[p]
    R = 1 << bits
    table = np.zeros((plan.G, R), np.int64)
    for b in range(plan.G):
        lo, hi = _block_range(plan, p, n_items, b)
        for sub in range(lo, hi, shape.tile):
            for t in range(shape.items):
                for w in range(shape.warps):
                    i = sub + t * shape.threads + 32 * w + np.arange(32)
                    k = np.where(i < hi, keys[np.minimum(i, n_items - 1)], -1)
                    d = np.where(k >= 0, (k >> shift) & (R - 1), -1)
                    _, size, lead = _peers(d)
                    for lane in np.nonzero(lead & (d >= 0))[0]:
                        table[b, d[lane]] += size[lane]
    return table


def place(p, plan, table, src_keys, src_pos, n_items, shape=KERNEL):
    """place_phase of pass ``p`` over every block: (keys, positions) in
    the pass's order, the total, and the digits' (start, count): the rows'
    ranges after a single pass."""
    shift, bits = plan.passes[p]
    R = 1 << bits
    tot = table.sum(0)
    digit_start = np.concatenate([[0], np.cumsum(tot)[:-1]])
    total = int(tot.sum())
    out_keys = np.full(total, -7, np.int64)
    out_pos = np.full(total, -7, np.int64)
    for b in range(plan.G):
        base = digit_start + table[:b].sum(0)
        lo, hi = _block_range(plan, p, n_items, b)
        for sub in range(lo, hi, shape.tile):
            wcnt = np.zeros((shape.warps, R), np.int64)
            turns = []
            for w in range(shape.warps):
                wlo = sub + w * 32 * shape.items
                for t in range(shape.items):
                    i = wlo + 32 * t + np.arange(32)
                    ok = i < hi
                    ic = np.minimum(i, n_items - 1)
                    k = np.where(ok, src_keys[ic], -1)
                    pos = np.where(ok, src_pos[ic], 0)
                    d = np.where(k >= 0, (k >> shift) & (R - 1), -1)
                    rank, size, lead = _peers(d)
                    r = np.where(d >= 0, wcnt[w, np.maximum(d, 0)] + rank, 0)
                    for lane in np.nonzero(lead & (d >= 0))[0]:
                        wcnt[w, d[lane]] += size[lane]
                    turns.append((w, k, pos, d, r))
            sub_count = wcnt.sum(0)
            wpre = np.cumsum(wcnt, 0) - wcnt                # exclusive over warps
            for w, k, pos, d, r in turns:
                v = d >= 0
                out = base[d[v]] + wpre[w, d[v]] + r[v]
                out_keys[out] = k[v]
                out_pos[out] = pos[v]
            base = base + sub_count
    return out_keys, out_pos, total, (digit_start, tot)


def sort_rows(rows, nkeys, shape=KERNEL):
    """Every pass's count and place: (sorted keys, positions, total,
    (run_start, run_end) per key for the fixed sums)."""
    keys = _keys(rows, nkeys)
    n = keys.size
    plan = make_plan(n, nkeys, shape)
    k, pos, n_items = keys, np.arange(n), n
    for p in range(len(plan.passes)):
        table = count(k, n_items, p, plan, shape)
        k, pos, n_items, (start, tot) = place(p, plan, table, k, pos, n_items, shape)
    if len(plan.passes) == 1:                   # the digit is the row
        runs = (start[:nkeys], (start + tot)[:nkeys])
    else:
        runs = _run_ends(k, nkeys)
    return k, pos, n_items, runs


def _run_ends(keys, nkeys):
    """runs_phase: each position that heads or ends a run of equal keys
    writes its key's start or end."""
    start, end = np.zeros(nkeys, np.int64), np.zeros(nkeys, np.int64)
    total = keys.size
    for p in range(total):
        if p == 0 or keys[p - 1] != keys[p]:
            start[keys[p]] = p
        if p + 1 == total or keys[p + 1] != keys[p]:
            end[keys[p]] = p + 1
    return start, end


def rows_add(dst, dim, rows, src, keep, shape=KERNEL, order=None):
    """trt_scatter_rows (``dst``: numpy float32, updated in place): every
    kept position claims a slot of its row, in ``order`` (a permutation of
    the positions; ascending if None), as the atomics let them. If no row
    took more than SLOTS, the position in a row's first slot sorts the
    row's claimed positions and adds their values in that order; else the
    sort, then one thread per run of equal rows adds it in sorted order."""
    keys_in = _keys(rows, keep)
    if keys_in.size == 0:
        return dst
    C = dst.shape[1 - dim]
    at = (lambda r, c: (r, c)) if dim == 0 else (lambda r, c: (c, r))
    val = (lambda p, c: src[p, c]) if dim == 0 else (lambda p, c: src[c, p])
    claims = {}
    for i in (range(keys_in.size) if order is None else order):
        if keys_in[i] >= 0:
            claims.setdefault(int(keys_in[i]), []).append(int(i))
    if all(len(v) <= SLOTS for v in claims.values()):
        for i in range(keys_in.size):
            k = int(keys_in[i])
            if k < 0 or claims[k][0] != i:      # not the row's first slot
                continue
            for c in range(C):
                acc = dst[at(k, c)]
                for p in sorted(claims[k]):
                    acc = np.float32(acc + val(p, c))
                dst[at(k, c)] = acc
        return dst
    keys, pos, total, _ = sort_rows(rows, keep, shape)
    for i in range(total):
        r = keys[i]
        if i > 0 and keys[i - 1] == r:
            continue
        e = i + 1
        while e < total and keys[e] == r:
            e += 1
        for c in range(C):
            acc = dst[at(r, c)]
            for j in range(i, e):
                acc = np.float32(acc + val(pos[j], c))
            dst[at(r, c)] = acc
    return dst


def fixed_sum(n_rows, rows, src, k, shape=KERNEL, order=None):
    """trt_scatter_fixed: the sort, the values gathered in sorted order,
    then ``sums`` (its lanes in ``order``)."""
    x = np.asarray(src, np.float32)
    x = x.reshape(x.shape[0], int(np.prod(x.shape[1:])))
    n, C = x.shape
    out = np.zeros((n_rows, C), np.float32)
    if n == 0 or C == 0:
        return out
    keys, pos, total, runs = sort_rows(rows, n_rows, shape)
    vals = x[pos]                               # gather_phase
    return sums(out, keys, vals, runs, total, k, order)


def sums(out, keys, vals, runs, total, k, order=None):
    """sums_kernel: its lanes one after another in ``order`` (a
    permutation of the sorted positions; ascending if None), each to its
    end: a lane whose position starts a level-0 chunk sums it, and while
    it is the last child of a node (the node's counter), its warp sums the
    node from its children, left to right, and it climbs."""
    run_start, run_end = runs
    n = vals.shape[0]
    part = np.full((n, out.shape[1]), np.nan, np.float32)
    cnt = np.zeros(n, np.int64)
    for p in (range(total) if order is None else [q for q in order if q < total]):
        row = keys[p]
        s, nr = int(run_start[row]), int(run_end[row] - run_start[row])
        q = p - s
        if q % k:
            continue
        ln = min(nr - q, k)
        m, idx, off = -(-nr // k), q // k, 0
        acc = vals[p].copy()
        for t in range(1, ln):
            acc = (acc + vals[p + t]).astype(np.float32)
        if m == 1:
            out[row] = acc
            continue
        part[s + idx] = acc
        while m > 1:
            parent = idx // k
            first = off + parent * k
            kids = min(m - parent * k, k)
            up = off + m + parent
            cnt[s + up] += 1
            if cnt[s + up] != kids:
                break
            m_up = -(-m // k)
            acc = part[s + first].copy()
            for t in range(1, kids):
                acc = (acc + part[s + first + t]).astype(np.float32)
            if m_up == 1:
                out[row] = acc
            else:
                part[s + up] = acc
            off, idx, m = off + m, parent, m_up
    return out


# ---------------------------------------------------------------------------
# edge cases, for the CPU tests and the card (chip_smoke.py phase 6b)
# ---------------------------------------------------------------------------

THRESHOLD = 1 << KERNEL.digit_bits     # rows a one-pass sort takes

ROWS_CASES = ("past keep and negative", "one row takes all",
              "every row unique", "n below 32", "n not a block multiple",
              "n zero", f"{THRESHOLD} rows", f"{THRESHOLD + 1} rows",
              f"{SLOTS} values a row", f"{SLOTS + 1} values in one row")
FIXED_CASES = ("one row takes all", "every row unique", "n below 32",
               "n not a block multiple", "n zero", "runs at the level edges",
               f"{THRESHOLD} rows", f"{THRESHOLD + 1} rows")


def values(rng, n, c):
    """float32 (n, c) spread over 12 decades, both signs."""
    mag = 10.0 ** rng.uniform(-6, 6, (n, 1))
    return (rng.standard_normal((n, c)) * mag).astype(np.float32)


def rows_case(name):
    """(rows, dst, src, dim, keep) of an edge case of the image scatter,
    from a seed: int64 rows, float32 dst of keep + 7 rows, along dim 0
    or 1 (dst and src C-contiguous in the layout of that dim)."""
    rng = np.random.default_rng(ROWS_CASES.index(name))
    if name == "past keep and negative":
        rows, keep = rng.integers(-20, 80, 900), 50
    elif name == "one row takes all":            # a 1x1 image and its drop row
        rows, keep = (rng.random(700) < 0.2).astype(np.int64), 1
    elif name == "every row unique":             # render_regen's drop rows
        rows = np.where(rng.random(1000) < 0.4, rng.permutation(3000)[:1000],
                        3000 + np.arange(1000))
        keep = 3000
    elif name == "n below 32":
        rows, keep = rng.integers(0, 12, 19), 10
    elif name == "n not a block multiple":       # two blocks, the second short
        rows, keep = rng.integers(0, 407, 4133), 400
    elif name == "n zero":
        rows, keep = np.zeros(0, np.int64), 5
    elif name.endswith("rows"):                  # just below / above one pass
        keep = int(name.split()[0])
        rows = rng.integers(0, keep + 3, 3000)
    else:                                        # the claims' limit, and one past it
        keep = 200
        rows = np.repeat(np.arange(keep), SLOTS)
        if name.endswith("one row"):
            rows = np.append(rows, 17)
        rows = rng.permutation(np.concatenate([rows, keep + rng.integers(0, 7, 300)]))
    dim = ROWS_CASES.index(name) % 2
    src, dst = values(rng, rows.size, 3), values(rng, keep + 7, 3)
    if dim == 1:
        src, dst = np.ascontiguousarray(src.T), np.ascontiguousarray(dst.T)
    return rows.astype(np.int64), dst, src, dim, keep


def fixed_case(name):
    """(rows, src, n_rows) of an edge case of the cotangent scatter."""
    rng = np.random.default_rng(100 + FIXED_CASES.index(name))
    if name == "one row takes all":
        rows, n_rows = np.zeros(5000, np.int64), 1
    elif name == "every row unique":
        rows, n_rows = rng.permutation(3000), 3000
    elif name == "n below 32":
        rows, n_rows = rng.integers(0, 4, 19), 4
    elif name == "n not a block multiple":
        rows, n_rows = rng.integers(0, 3, 4133), 3
    elif name == "n zero":
        rows, n_rows = np.zeros(0, np.int64), 5
    elif name == "runs at the level edges":      # one and two levels, chunk edges
        lengths = [1, 2, 31, 32, 33, 64, 65, 1024, 1025]
        rows = rng.permutation(np.repeat(np.arange(len(lengths)), lengths))
        n_rows = len(lengths) + 1
    else:
        n_rows = int(name.split()[0])
        rows = rng.integers(0, n_rows, 3000)
    return rows.astype(np.int64), values(rng, rows.size, 3), n_rows


# ---------------------------------------------------------------------------
# the main paths' calls at full width, from a seed
# ---------------------------------------------------------------------------

N_PIX = 1 << 20                        # grid:100000 at 1024x1024


# distinct pixels of the queue's image call at 80,385 finished lanes: at 4
# spp phase 6b's call (grid:100000 1024x1024); at 256 spp (the CLI's
# default) 80,385 / 18.65, the finished lanes a pixel that
# ``python -m tests.torch_scatter_emulate 256 32 16384`` reads (4 spp at
# 128x128, 4,096 lanes reads 1.33 against the 1.35 of phase 6b's call)
QUEUE_PIXELS = {4: 59_571, 256: 4_310}


def queue_call(seed=0, lanes=262_144, spp=4, finished=80_385, pixels=None):
    """(rows, dst, src, dim, keep) shaped as the queue renderer's image
    scatter (integrator/fused_queue.py): ``lanes`` lanes into the (3,
    N_PIX + 1) image along dim 1, ~``finished`` of them into ~``pixels``
    (default ``QUEUE_PIXELS[spp]``) distinct pixels (at most ``spp``
    each), the rest into the drop row N_PIX."""
    pixels = QUEUE_PIXELS[spp] if pixels is None else pixels
    rng = np.random.default_rng(seed)
    pix = rng.choice(N_PIX, pixels, replace=False)
    mult = 1 + rng.binomial(spp - 1, (finished / pixels - 1) / (spp - 1), pixels)
    take = rng.permutation(np.repeat(pix, mult))[:lanes]
    rows = np.full(lanes, N_PIX, np.int64)
    rows[rng.permutation(lanes)[:take.size]] = take
    return (rows, values(rng, N_PIX + 1, 3).T.copy(),
            values(rng, lanes, 3).T.copy(), 1, N_PIX)


def regen_call(seed=1, lanes=131_072, kept=35_004):
    """(rows, dst, src, dim, keep) shaped as render_regen's image scatter
    (integrator/regen.py): ``lanes`` lanes into the (N_PIX + lanes, 3)
    image along dim 0, ``kept`` of them into distinct pixels, each other
    lane into its own drop row N_PIX + lane."""
    rng = np.random.default_rng(seed)
    rows = N_PIX + np.arange(lanes, dtype=np.int64)
    rows[rng.permutation(lanes)[:kept]] = rng.choice(N_PIX, kept, replace=False)
    return rows, values(rng, N_PIX + lanes, 3), values(rng, lanes, 3), 0, N_PIX


# ---------------------------------------------------------------------------
# on the card: a call captured in a CUDA graph, and its device ops
# ---------------------------------------------------------------------------

def captured(fn, keep_graph=False):
    """``fn`` (after a warm-up call on a side stream) captured in a CUDA
    graph: (graph, what the captured call returned)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=keep_graph)
    with torch.cuda.graph(graph):
        out = fn()
    return graph, out


def device_ops(fn):
    """Device ops (kernels, fills, copies) of one call of ``fn``: the nodes
    of a CUDA graph that captures it, from libcuda's cuGraphGetNodes. A
    graph holds every op of the call; torch.profiler drops whole record
    sets on the card's machine."""
    import ctypes

    graph, _ = captured(fn, keep_graph=True)
    nodes = ctypes.c_size_t(0)
    err = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(nodes))
    if err:
        raise RuntimeError(f"cuGraphGetNodes failed: CUresult {err}")
    return nodes.value


def queue_stats(spp, size, lanes):
    """(finished lanes, distinct pixels, finished lanes a pixel) of the
    queue renderer's image scatters, means over the middle half of its
    iterations, on grid:6000 at size x size on the CPU. A pixel's spp
    paths take neighbouring lanes and finish over the bounces, so the
    finished lanes a pixel follow spp and not the image's size."""
    import torch

    from tinyraytracing_tpu_torch.config import RenderConfig
    from tinyraytracing_tpu_torch.integrator import fused_queue as fq
    from tinyraytracing_tpu_torch.models.procedural import quad_grid
    from tinyraytracing_tpu_torch.ops.bvh import attach_bvh
    from tinyraytracing_tpu_torch.ops.rng import master_key_data

    seen, scatter = [], fq.scatter_add_rows

    def spy(dst, dim, rows, src, keep):
        kept = rows[(rows >= 0) & (rows < keep)]
        seen.append((kept.numel(), torch.unique(kept).numel()))
        return scatter(dst, dim, rows, src, keep=keep)

    cfg = RenderConfig()
    scene, cam = quad_grid(6000, size, size, device="cpu")
    fq.scatter_add_rows = spy
    try:
        fq.render_fused_queue(attach_bvh(scene, cfg), cam, master_key_data(0),
                              cfg, spp, lanes=lanes)
    finally:
        fq.scatter_add_rows = scatter
    mid = np.array(seen[len(seen) // 4:3 * len(seen) // 4], np.float64)
    return mid[:, 0].mean(), mid[:, 1].mean(), mid[:, 0].sum() / mid[:, 1].sum()


if __name__ == "__main__":
    import sys

    spp, size, lanes = (int(a) for a in sys.argv[1:4])
    print("finished %.1f, pixels %.1f, finished a pixel %.2f"
          % queue_stats(spp, size, lanes))
