// Fixed-order scatter-adds for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (tinyraytracing_tpu_torch/ops/kernels.py builds
// this file with nvcc).
//
// No TPU kernel is replaced: the JAX package leaves its scatter-adds to
// XLA, whose TPU scatter runs in one fixed order, so a render and a
// gradient repeat bitwise there. index_add_ on a CUDA tensor adds with
// atomics in whatever order the warps arrive. These kernels add in an
// order that depends on the data alone; ops/scatter.py's plain versions
// define that order and make the same float adds (__fadd_rn, never
// contracted).
//
// The images' call is one cooperative launch (a grid of at most 128
// blocks, all resident, its phases apart by grid-wide barriers); the
// cotangents' call is one cooperative launch and one plain one. Neither
// calls a library sort or scan, and neither reads anything back to the
// host. Where a call needs each row's positions in ascending order, it
// sorts them with a stable LSD radix sort of its own (no scan launch),
// an 8-bit digit at most a pass, over the bits of the row count only (one
// pass up to 256 rows: every cornell cotangent table; three at the 2^20
// pixels of an image):
//
//   count   each block counts the digit of the items it owns (the first
//           pass: the caller's row ids, int64 or int32, rows outside
//           [0, keep) or [0, n_rows) left out and never sorted; later
//           passes: an even share of the previous pass's order) with a
//           warp multisplit (one ballot a digit bit) and one shared
//           atomic per group of equal digits; it writes its row of the
//           (blocks x radix) table. No global atomics.
//   place   each block reads the whole table (every thread at once), so
//           it knows where each digit starts and where its own items of
//           a digit go; ranks its items stably (warp ranks from the
//           multisplit's peers and the popcount of the lower lanes,
//           per-warp digit counts in shared memory) and writes each
//           (row, position) pair to its place. A thread issues all its
//           loads of a sub-tile before its warp's first turn.
//
// 1. trt_scatter_rows (the images: the queue's and render_regen's): each
//    row's values added into dst one at a time, in ascending source
//    position: bitwise what index_add_ computes on the CPU. First every
//    kept position claims one of its row's SLOTS = 4 slots (an atomic on
//    its row's own counter: a pixel takes at most spp values an
//    iteration). If no row took more, the position in a row's first slot
//    orders the row's positions and adds them: two phases, no sort. Else
//    the call sorts as above, and one thread per run of equal rows adds
//    the run in sorted order, so a row that takes every value stays
//    linear in its length.
//
// 2. trt_scatter_fixed (the cotangents behind ops/lookup.gather_rows). A
//    row's values, in ascending position, are cut into chunks of K = 32
//    counted from the row's first value; each chunk is summed left to
//    right; the chunk sums are cut and summed the same way, level after
//    level, until one value is left, which becomes the row of out. The
//    cooperative launch zeroes out, sorts, and gathers the values in
//    sorted order (coalesced writes: scattering them from the last pass
//    cost ~13 us at 32 rows). The second launch (sums_kernel, a thread a
//    sorted position) sums every level: a warp stages its 32 positions'
//    values and the next 32 in shared memory, and a lane whose position
//    starts a chunk sums it from there; a node above counts its finished
//    children (at most K) with an atomic after __threadfence, and the
//    warp of the child that counts last sums the node (its children
//    staged, one a lane; lane c sums channel c left to right) and climbs
//    on. Which warp sums a node varies from run to run; the node's value
//    does not. A row's partial sums of every level sit in its own range
//    of sorted positions (level 0's at [s, s + m0), level 1's after them,
//    ...), and each node's counter at its output's slot, so rows never
//    meet. Each row's range comes from the single pass's digit table, or
//    after several passes from the heads and tails of the sorted runs.
//
// What bounds them on this card: bytes, at the sizes of the main paths a
// few MB: each row id read once, each kept value read once (a dropped
// lane's values are never read), each touched row read and written once.
// Counted in 4-byte words at 3.35 TB/s that is 1.34 us for the queue's
// image call, 0.69 us for render_regen's and 1.57 us for 262,144
// cotangent rows; the queue's planar image touches three 32-byte sectors a
// pixel, and its call moves ~5 us of whole sectors. The first design of these kernels spent its time
// elsewhere: a general 32-bit torch.sort of every position with int64
// positions (0.0667 ms of the queue call's 0.0734 on an H100 SXM at
// 700 W), a cast, a fill, a binary search per position and one launch per
// level over all n positions. This one claims instead of sorting where
// it can, sorts only the kept rows over only their bits, and keeps a
// call's phases in one launch; what is left is the latency of a few
// dependent memory round trips and barriers (~1 us each), not bytes.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 512;             // a block of the cooperative grid
constexpr int WARPS = THREADS / 32;
constexpr int SUM_THREADS = 256;         // a block of the fixed sums
constexpr int SUM_WARPS = SUM_THREADS / 32;
constexpr int ITEMS = 4;                 // items a thread ranks per sub-tile
constexpr int TILE = THREADS * ITEMS;    // items a block ranks at a time
constexpr int MAX_BLOCKS = 128;          // blocks of the grid, at most
constexpr int DIGIT_BITS = 8;            // bits a pass sorts, at most
constexpr int RADIX = 1 << DIGIT_BITS;   // digits a pass counts, at most
constexpr int MAX_PASSES = 4;            // 31-bit keys
constexpr int MAX_K = 32;                // the fixed sums' chunk, at most a warp
constexpr int STAGE = 4;                 // channels loaded at once
constexpr int SLOTS = 4;                 // positions a row's claim holds (rows)
constexpr unsigned FULL = 0xffffffffu;

static_assert(RADIX <= THREADS && THREADS % RADIX == 0,
              "the digit loops give one digit a thread");
static_assert(2 * THREADS <= WARPS * RADIX, "the table's fold fits wcnt");

// The launch plan and the scratch layout, a function of (n, nkeys, C)
// and the card alone: the wrapper allocates trt_scatter_scratch_words()
// int32 words.
struct Plan {
  int G, BS;                       // blocks; items a block owns (k * TILE)
  int passes, shift[MAX_PASSES], bits[MAX_PASSES];
  long long table[MAX_PASSES];     // (G x 2^bits) counts of each pass
  long long pairs[2];              // ping-pong (row, position) pairs, int2
  long long total;                 // kept items, written by the first pass
  long long run_start, run_end;    // fixed: each row's range of sorted positions
  long long cnt, part, vals;       // fixed: node counters, partial sums, sorted values
  long long claims, slots, flag;   // rows: a row's claims, its positions, more than SLOTS
  long long words;
};

Plan make_plan(int n, int nkeys, int C, bool fixed, int max_blocks) {
  Plan p{};
  int tiles = (n + TILE - 1) / TILE;
  if (tiles < 1) tiles = 1;
  const int per = (tiles + max_blocks - 1) / max_blocks;   // sub-tiles a block
  p.G = (tiles + per - 1) / per;
  p.BS = per * TILE;
  int B = 1;                                   // bits of nkeys - 1, at least 1
  while (B < 31 && (1LL << B) < nkeys) ++B;
  p.passes = (B + DIGIT_BITS - 1) / DIGIT_BITS;
  for (int i = 0, done = 0; i < p.passes; ++i) {
    const int left = p.passes - i;
    p.bits[i] = (B - done + left - 1) / left;  // near-equal digits
    p.shift[i] = done;
    done += p.bits[i];
  }
  long long w = 0;
  auto take = [&w](long long words) {          // 16-byte aligned regions
    const long long at = w;
    w += (words + 3) & ~3LL;
    return at;
  };
  for (int i = 0; i < p.passes; ++i) p.table[i] = take((long long)p.G << p.bits[i]);
  p.pairs[0] = take(2LL * n);
  p.pairs[1] = p.passes > 1 ? take(2LL * n) : p.pairs[0];
  p.total = take(1);
  if (fixed) {
    p.run_start = take(nkeys);
    p.run_end = take(nkeys);
    p.cnt = take(n);
    p.part = take((long long)n * C);
    p.vals = take((long long)n * C);
  } else {
    p.claims = take(nkeys);
    p.slots = take((long long)nkeys * SLOTS);
    p.flag = take(1);
  }
  p.words = w;
  return p;
}

// Everything a call's phases read and write.
struct Job {
  const void* rows;                // the caller's row ids
  int rows64, n, nkeys, fixed;
  int G, BS, passes, shift[MAX_PASSES], bits[MAX_PASSES];
  int* table[MAX_PASSES];
  int2* pairs[2];
  int* total;
  const float* src;                // values: rows (n x C, strided), fixed (n x C)
  int C;
  float* dst;                      // rows: the image, updated in place
  long long d_row, d_col, s_row, s_col;
  float* out;                      // fixed: (nkeys x C), zeroed here
  float* vals;
  float* part;
  int* cnt;
  int* run_start;
  int* run_end;
  int K;
  int* claims;                     // rows
  int* slots;
  int* flag;
};

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// The lanes whose value v (its low `bits` bits) equals this lane's, among
// the lanes where ok: one ballot a bit (a warp multisplit); 0 where !ok.
__device__ __forceinline__ unsigned peers_of(int v, int bits, bool ok) {
  unsigned m = __ballot_sync(FULL, ok);
#pragma unroll
  for (int b = 0; b < DIGIT_BITS; ++b) {
    if (b < bits) {                            // uniform: bits is the warp's
      const bool set = (v >> b) & 1;
      const unsigned on = __ballot_sync(FULL, set);
      m &= set ? on : ~on;
    }
  }
  return ok ? m : 0u;
}

// the caller's row id at i as a key, or -1 where it is dropped
__device__ __forceinline__ int load_key(const Job& j, long long i) {
  const long long r = j.rows64 ? ((const long long*)j.rows)[i]
                               : (long long)((const int*)j.rows)[i];
  return (r >= 0 && r < j.nkeys) ? (int)r : -1;
}

// The items block b owns in pass ip: [lo, hi) of the caller's positions
// (the first pass: BS a block) or of the previous pass's order (the kept
// items, spread evenly over the G blocks).
__device__ __forceinline__ void block_range(const Job& j, int ip, long long& lo,
                                            long long& hi) {
  const long long n_items = ip == 0 ? j.n : *j.total;
  const long long per = ip == 0 ? j.BS : (n_items + j.G - 1) / j.G;
  lo = (long long)blockIdx.x * per;
  hi = lo + per < n_items ? lo + per : n_items;
}

// item i of pass ip's input: (key or -1, position)
__device__ __forceinline__ int2 load_item(const Job& j, int ip, long long i) {
  if (ip == 0) return make_int2(load_key(j, i), (int)i);
  return j.pairs[(ip - 1) & 1][i];
}

__device__ void count_phase(const Job& j, int ip, int* hist) {
  const int R = 1 << j.bits[ip];
  const int tid = threadIdx.x, lane = tid & 31;
  if (tid < R) hist[tid] = 0;
  __syncthreads();
  long long lo, hi;
  block_range(j, ip, lo, hi);
  // the bound is the block's, so every lane of a warp takes every turn
  for (long long sub = lo; sub < hi; sub += TILE) {
    int key[ITEMS];
#pragma unroll
    for (int t = 0; t < ITEMS; ++t) {
      const long long i = sub + t * THREADS + tid;
      key[t] = i < hi ? load_item(j, ip, i).x : -1;
    }
#pragma unroll
    for (int t = 0; t < ITEMS; ++t) {
      const int d = (key[t] >> j.shift[ip]) & (R - 1);
      const unsigned peers = peers_of(d, j.bits[ip], key[t] >= 0);
      if (peers != 0 && lane == __ffs(peers) - 1) atomicAdd(&hist[d], __popc(peers));
    }
  }
  __syncthreads();
  if (tid < R) j.table[ip][blockIdx.x * R + tid] = hist[tid];
}

struct PlaceSmem {
  int wcnt[WARPS][RADIX];          // per warp: digit counts, then offsets
  int base[RADIX];                 // where the block's next item of a digit goes
  int warp_sum[WARPS];
  int total;
};

__device__ void place_phase(const Job& j, int ip, PlaceSmem& sm) {
  const int R = 1 << j.bits[ip];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x;
  int2* out_pairs = j.pairs[ip & 1];

  // 1. the table: a digit's items over all blocks (tot), and in the blocks
  //    before this one (col). Every thread reads it at once: entry e is
  //    digit e % R of block e / R, and THREADS is a multiple of R, so a
  //    thread's entries share one digit; then the threads of a digit fold.
  int tot = 0, col = 0;
  {
    int t_tot = 0, t_col = 0;
    const int entries = j.G * R;
    const int* table = j.table[ip];
#pragma unroll 16
    for (int e = tid; e < entries; e += THREADS) {
      const int c = table[e];
      t_tot += c;
      t_col += (e >> j.bits[ip]) < b ? c : 0;
    }
    for (int o = R; o < 32; o <<= 1) {         // lanes of one digit in a warp
      t_tot += __shfl_xor_sync(FULL, t_tot, o);
      t_col += __shfl_xor_sync(FULL, t_col, o);
    }
    int* fold = &sm.wcnt[0][0];
    fold[tid] = t_tot;
    fold[THREADS + tid] = t_col;
    __syncthreads();
    if (tid < R) {
      for (int t = tid; t < THREADS; t += (R > 32 ? R : 32)) {
        tot += fold[t];
        col += fold[THREADS + t];
      }
    }
  }
  int incl = tot;                              // scan of tot over the digits
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) sm.warp_sum[warp] = incl;
  __syncthreads();
  if (tid == 0) {
    int run = 0;
    for (int w = 0; w < WARPS; ++w) {
      const int v = sm.warp_sum[w];
      sm.warp_sum[w] = run;
      run += v;
    }
    sm.total = run;
  }
  __syncthreads();
  const int digit_start = sm.warp_sum[warp] + incl - tot;
  if (tid < R) sm.base[tid] = digit_start + col;
  if (b == 0) {
    if (tid == 0 && ip == 0) *j.total = sm.total;
    if (j.fixed && j.passes == 1 && tid < R && tid < j.nkeys) {
      j.run_start[tid] = digit_start;          // one pass: the digit is the row
      j.run_end[tid] = digit_start + tot;
    }
  }
  __syncthreads();

  // 2. the block's items, TILE at a time: warp w ranks the sub-tile's
  //    items [w * 32 * ITEMS, (w + 1) * 32 * ITEMS), 32 a turn, in order
  long long lo, hi;
  block_range(j, ip, lo, hi);
  const unsigned lower = lanemask_lt();
  for (long long sub = lo; sub < hi; sub += TILE) {
    for (int d = lane; d < R; d += 32) sm.wcnt[warp][d] = 0;
    __syncwarp();
    int key[ITEMS], pos[ITEMS], rank[ITEMS];
    const long long wlo = sub + (long long)warp * 32 * ITEMS;
#pragma unroll
    for (int t = 0; t < ITEMS; ++t) {          // every load first
      const long long i = wlo + t * 32 + lane;
      const int2 kp = i < hi ? load_item(j, ip, i) : make_int2(-1, 0);
      key[t] = kp.x;
      pos[t] = kp.y;
    }
#pragma unroll
    for (int t = 0; t < ITEMS; ++t) {          // then the warp's turns, in order
      const int k = key[t];
      const int d = (k >> j.shift[ip]) & (R - 1);
      const unsigned peers = peers_of(d, j.bits[ip], k >= 0);
      const int r = k >= 0 ? sm.wcnt[warp][d] + __popc(peers & lower) : 0;
      __syncwarp();
      if (peers != 0 && lane == __ffs(peers) - 1) sm.wcnt[warp][d] += __popc(peers);
      __syncwarp();
      rank[t] = r;
    }
    __syncthreads();
    int sub_count = 0;                         // digit tid: offsets of the warps, in order
    if (tid < R) {
      for (int w = 0; w < WARPS; ++w) {
        const int c = sm.wcnt[w][tid];
        sm.wcnt[w][tid] = sub_count;
        sub_count += c;
      }
    }
    __syncthreads();
#pragma unroll
    for (int t = 0; t < ITEMS; ++t) {
      const int k = key[t];
      if (k < 0) continue;
      const int d = (k >> j.shift[ip]) & (R - 1);
      out_pairs[sm.base[d] + sm.wcnt[warp][d] + rank[t]] = make_int2(k, pos[t]);
    }
    __syncthreads();
    if (tid < R) sm.base[tid] += sub_count;
    __syncthreads();
  }
}

// rows, after the sort (a row took more than SLOTS values): one thread
// per run of equal rows adds the run's values into dst in sorted order,
// STAGE channels at a time
__device__ void adds_phase(const Job& j) {
  const int2* sorted = j.pairs[(j.passes - 1) & 1];
  const long long total = *j.total;
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < total;
       i += stride) {
    const int2 me = sorted[i];
    if (i > 0 && sorted[i - 1].x == me.x) continue;   // not the run's first
    const long long r = me.x;
    for (int c0 = 0; c0 < j.C; c0 += STAGE) {
      float acc[STAGE], v[STAGE];
#pragma unroll
      for (int u = 0; u < STAGE; ++u)
        acc[u] = c0 + u < j.C ? j.dst[r * j.d_row + (long long)(c0 + u) * j.d_col] : 0.0f;
      for (long long e = i; e < total; ++e) {
        const int2 kp = e == i ? me : sorted[e];
        if (kp.x != me.x) break;
#pragma unroll
        for (int u = 0; u < STAGE; ++u)
          v[u] = c0 + u < j.C ? j.src[(long long)kp.y * j.s_row + (long long)(c0 + u) * j.s_col] : 0.0f;
#pragma unroll
        for (int u = 0; u < STAGE; ++u) acc[u] = __fadd_rn(acc[u], v[u]);
      }
#pragma unroll
      for (int u = 0; u < STAGE; ++u)
        if (c0 + u < j.C) j.dst[r * j.d_row + (long long)(c0 + u) * j.d_col] = acc[u];
    }
  }
}

// fixed: the values in sorted order (each loop turn's loads issued before
// its stores), and after several passes each row's range from its run's
// ends
__device__ void gather_phase(const Job& j) {
  constexpr int U = 4;                         // positions a thread has in flight
  const int2* sorted = j.pairs[(j.passes - 1) & 1];
  const long long total = *j.total;
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long p0 = (long long)blockIdx.x * THREADS + threadIdx.x; p0 < total;
       p0 += U * stride) {
    int2 kp[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long p = p0 + u * stride;
      kp[u] = p < total ? sorted[p] : make_int2(-1, 0);
    }
    for (int c0 = 0; c0 < j.C; c0 += STAGE) {
      float v[U][STAGE];
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int c = 0; c < STAGE; ++c)
          v[u][c] = kp[u].x >= 0 && c0 + c < j.C
                        ? j.src[(long long)kp[u].y * j.C + c0 + c] : 0.0f;
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int c = 0; c < STAGE; ++c)
          if (kp[u].x >= 0 && c0 + c < j.C)
            j.vals[(p0 + u * stride) * j.C + c0 + c] = v[u][c];
    }
    if (j.passes > 1) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long long p = p0 + u * stride;
        if (p >= total) continue;
        const int k = kp[u].x;
        if (p == 0 || sorted[p - 1].x != k) j.run_start[k] = (int)p;
        if (p + 1 == total || sorted[p + 1].x != k) j.run_end[k] = (int)(p + 1);
      }
    }
  }
}

// fixed, its own launch (a thread per sorted position: every load of a
// level in flight at once): every level's sums. Warp w stages the values
// of sorted positions [32w, 32w + 64); a lane whose position starts a
// level-0 chunk of its row sums it from there, into out (a row of at most
// K values) or part. A node above counts its finished children
// (__threadfence, then an atomic: K children at most); the warp of the
// child that counts last stages the node's children, one a lane, lane c
// sums channel c left to right, and the child climbs on.
__global__ void __launch_bounds__(SUM_THREADS) sums_kernel(Job j) {
  __shared__ float stage[SUM_WARPS][2 * 32 * STAGE];
  const int2* sorted = j.pairs[(j.passes - 1) & 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int K = j.K, C = j.C;
  const long long total = *j.total;
  const long long p = (long long)blockIdx.x * SUM_THREADS + threadIdx.x;
  if (p - lane >= total) return;               // the whole warp
  int row = 0;
  long long s = 0, nr = 0, q = 1;
  if (p < total) {
    row = sorted[p].x;
    s = j.run_start[row];
    nr = j.run_end[row] - s;
    q = p - s;
  }
  const bool starts = p < total && q % K == 0;
  const int len = starts ? (int)(nr - q < K ? nr - q : K) : 0;
  long long m = (nr + K - 1) / K;              // outputs of the node's level
  long long idx = q / K;                       // the node's index in it
  long long off = 0;                           // the level's first slot, from s
  for (int c0 = 0; c0 < C; c0 += STAGE) {
    const int nc = C - c0 < STAGE ? C - c0 : STAGE;
    float v0[STAGE], v1[STAGE];                // every load, then the stage
#pragma unroll
    for (int u = 0; u < STAGE; ++u) {
      v0[u] = p < total && u < nc ? j.vals[p * C + c0 + u] : 0.0f;
      v1[u] = p + 32 < total && u < nc ? j.vals[(p + 32) * C + c0 + u] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < STAGE; ++u) {
      stage[warp][lane * STAGE + u] = v0[u];
      stage[warp][(lane + 32) * STAGE + u] = v1[u];
    }
    __syncwarp();
    if (starts) {
      for (int u = 0; u < nc; ++u) {
        float acc = stage[warp][lane * STAGE + u];
#pragma unroll
        for (int t = 1; t < MAX_K; ++t)
          if (t < len) acc = __fadd_rn(acc, stage[warp][(lane + t) * STAGE + u]);
        if (m == 1) j.out[(long long)row * C + c0 + u] = acc;
        else j.part[(s + idx) * C + c0 + u] = acc;
      }
    }
    __syncwarp();
  }
  bool pending = starts && m > 1;              // a written node to count at its parent
  for (;;) {
    bool mine = false;
    long long first = 0, up = 0;
    int kids = 0;
    if (pending) {
      const long long parent = idx / K;
      first = off + parent * K;                // the parent's children, from s
      kids = (int)(m - parent * K < K ? m - parent * K : K);
      up = off + m + parent;                   // the parent's slot
      __threadfence();                         // this child's sums, then its count
      mine = atomicAdd(&j.cnt[s + up], 1) == kids - 1;
      if (mine) {                              // the last child: every child is written
        __threadfence();
        off += m;
        idx = parent;
        m = (m + K - 1) / K;
      }
    }
    unsigned owners = __ballot_sync(FULL, mine);
    if (owners == 0) break;
    __threadfence();                           // every lane reads the children
    while (owners != 0) {                      // the warp sums each owned node
      const int o = __ffs(owners) - 1;
      owners &= owners - 1;
      const long long os = __shfl_sync(FULL, s, o);
      const long long ofirst = __shfl_sync(FULL, first, o);
      const long long oup = __shfl_sync(FULL, up, o);
      const long long om = __shfl_sync(FULL, m, o);
      const int okids = __shfl_sync(FULL, kids, o);
      const int orow = __shfl_sync(FULL, row, o);
      for (int c0 = 0; c0 < C; c0 += STAGE) {
        const int nc = C - c0 < STAGE ? C - c0 : STAGE;
        if (lane < okids) {
          const float* child = j.part + (os + ofirst + lane) * C + c0;
          float v[STAGE];
#pragma unroll
          for (int u = 0; u < STAGE; ++u) v[u] = u < nc ? __ldcg(child + u) : 0.0f;
#pragma unroll
          for (int u = 0; u < STAGE; ++u) stage[warp][lane * STAGE + u] = v[u];
        }
        __syncwarp();
        if (lane < nc) {
          float acc = stage[warp][lane];
#pragma unroll
          for (int t = 1; t < MAX_K; ++t)
            if (t < okids) acc = __fadd_rn(acc, stage[warp][t * STAGE + lane]);
          if (om == 1) j.out[(long long)orow * C + c0 + lane] = acc;
          else j.part[(os + oup) * C + c0 + lane] = acc;
        }
        __threadfence();                       // the node's sums, before its count
        __syncwarp();
      }
    }
    pending = mine && m > 1;
  }
}

// rows, first: every kept position claims a slot of its row (one atomic,
// its row's own); a row of more than SLOTS values raises the flag
__device__ void claim_phase(const Job& j) {
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < j.n;
       i += stride) {
    const int k = load_key(j, i);
    if (k < 0) continue;
    const int at = atomicAdd(&j.claims[k], 1);
    if (at < SLOTS) j.slots[(long long)k * SLOTS + at] = (int)i;
    else *j.flag = 1;
  }
}

// rows, no row above SLOTS values: the position in a row's first slot
// orders the row's positions (claimed in any order) ascending and adds
// their values into dst one at a time
__device__ void chain_phase(const Job& j) {
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < j.n;
       i += stride) {
    const int k = load_key(j, i);
    if (k < 0) continue;
    const int4 sl = *(const int4*)(j.slots + (long long)k * SLOTS);
    const int c = j.claims[k];
    if (sl.x != (int)i) continue;              // not the row's first slot
    int at[SLOTS] = {sl.x, sl.y, sl.z, sl.w};
#pragma unroll
    for (int a = 1; a < SLOTS; ++a)            // insertion sort of c <= SLOTS
#pragma unroll
      for (int b = a; b > 0; --b)
        if (b < c && at[b] < at[b - 1]) {
          const int t = at[b];
          at[b] = at[b - 1];
          at[b - 1] = t;
        }
    const long long r = k;
    for (int c0 = 0; c0 < j.C; c0 += STAGE) {
      float acc[STAGE], v[SLOTS][STAGE];       // every load, then the adds
#pragma unroll
      for (int u = 0; u < STAGE; ++u) {
        const bool on = c0 + u < j.C;
        acc[u] = on ? j.dst[r * j.d_row + (long long)(c0 + u) * j.d_col] : 0.0f;
#pragma unroll
        for (int a = 0; a < SLOTS; ++a)
          v[a][u] = on && a < c
                        ? j.src[(long long)at[a] * j.s_row + (long long)(c0 + u) * j.s_col]
                        : 0.0f;
      }
#pragma unroll
      for (int a = 0; a < SLOTS; ++a)
#pragma unroll
        for (int u = 0; u < STAGE; ++u)
          if (a < c) acc[u] = __fadd_rn(acc[u], v[a][u]);
#pragma unroll
      for (int u = 0; u < STAGE; ++u)
        if (c0 + u < j.C) j.dst[r * j.d_row + (long long)(c0 + u) * j.d_col] = acc[u];
    }
  }
}

__global__ void __launch_bounds__(THREADS, 2) scatter_kernel(Job j) {
  __shared__ int hist[RADIX];
  __shared__ PlaceSmem place;
  cg::grid_group grid = cg::this_grid();
  if (!j.fixed) {                              // rows: the claims first
    const long long stride = (long long)gridDim.x * THREADS;
    for (long long e = (long long)blockIdx.x * THREADS + threadIdx.x; e < j.nkeys;
         e += stride)
      j.claims[e] = 0;
    if (blockIdx.x == 0 && threadIdx.x == 0) *j.flag = 0;
    grid.sync();
    claim_phase(j);
    grid.sync();
    if (*j.flag == 0) {                        // the same for every block
      chain_phase(j);
      return;
    }
  }
  if (j.fixed) {                               // the output and the node counters
    const long long stride = (long long)gridDim.x * THREADS;
    const long long first = (long long)blockIdx.x * THREADS + threadIdx.x;
    for (long long e = first; e < (long long)j.nkeys * j.C; e += stride) j.out[e] = 0.0f;
    for (long long e = first; e < j.n; e += stride) j.cnt[e] = 0;
  }
  for (int ip = 0; ip < j.passes; ++ip) {
    count_phase(j, ip, hist);
    grid.sync();
    place_phase(j, ip, place);
    grid.sync();
  }
  if (!j.fixed) {
    adds_phase(j);
    return;
  }
  gather_phase(j);                             // then sums_kernel's launch
}

// blocks of scatter_kernel the card holds at once, at most MAX_BLOCKS
// (a cooperative grid must be resident); -1 - cudaError on failure
int max_blocks() {
  static int cached[64];
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err != 0) return -1 - err;
  if (dev < 64 && cached[dev] > 0) return cached[dev];
  int sms = 0, per = 0;
  err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == 0)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, scatter_kernel,
                                                             THREADS, 0);
  if (err != 0) return -1 - err;
  const int cap = sms * per < MAX_BLOCKS ? sms * per : MAX_BLOCKS;
  if (dev < 64) cached[dev] = cap;
  return cap;
}

Job make_job(const Plan& p, int* s, const void* rows, int rows64, int n,
             int nkeys, const float* src, int C) {
  Job j{};
  j.rows = rows;
  j.rows64 = rows64;
  j.n = n;
  j.nkeys = nkeys;
  j.G = p.G;
  j.BS = p.BS;
  j.passes = p.passes;
  for (int i = 0; i < p.passes; ++i) {
    j.shift[i] = p.shift[i];
    j.bits[i] = p.bits[i];
    j.table[i] = s + p.table[i];
  }
  j.pairs[0] = (int2*)(s + p.pairs[0]);
  j.pairs[1] = (int2*)(s + p.pairs[1]);
  j.total = s + p.total;
  j.src = src;
  j.C = C;
  return j;
}

int launch(Job& j, cudaStream_t st) {
  void* args[] = {&j};
  const int err = (int)cudaLaunchCooperativeKernel(
      (const void*)scatter_kernel, dim3(j.G), dim3(THREADS), args, 0, st);
  return err != 0 ? err : (int)cudaGetLastError();
}

}  // namespace

// int32 words of scratch a call with these sizes needs on the current
// card, or -1 - cudaError
extern "C" long long trt_scatter_scratch_words(int n, int nkeys, int C,
                                               int fixed) {
  const int cap = max_blocks();
  if (cap < 0) return cap;
  return make_plan(n, nkeys, C, fixed != 0, cap).words;
}

// dst updated in place: each row in [0, keep) gets its values added in
// ascending position of rows (n int64 ids if rows64, else int32).
// Returns the launch's cudaError (0: launched).
extern "C" int trt_scatter_rows(float* dst, const void* rows, int rows64,
                                const float* src, int* scratch, int n, int C,
                                int keep, long long d_row, long long d_col,
                                long long s_row, long long s_col,
                                void* stream) {
  if (n <= 0) return 0;
  const int cap = max_blocks();
  if (cap < 0) return -1 - cap;
  const Plan p = make_plan(n, keep, C, false, cap);
  Job j = make_job(p, scratch, rows, rows64, n, keep, src, C);
  j.dst = dst;
  j.claims = scratch + p.claims;
  j.slots = scratch + p.slots;
  j.flag = scratch + p.flag;
  j.d_row = d_row;
  j.d_col = d_col;
  j.s_row = s_row;
  j.s_col = s_col;
  return launch(j, (cudaStream_t)stream);
}

// out (n_rows x C floats, any contents; zeroed here) gets the fixed-order
// sums of src's rows (n x C, contiguous) by rows; rows outside
// [0, n_rows) are left out. 3 <= K <= 32 (a row's levels must fit its
// range; a node's children a warp). Returns the launch's cudaError.
extern "C" int trt_scatter_fixed(float* out, const void* rows, int rows64,
                                 const float* src, int* scratch, int n, int C,
                                 int n_rows, int K, void* stream) {
  if (n <= 0 || C <= 0) return 0;
  if (K < 3 || K > MAX_K) return (int)cudaErrorInvalidValue;
  const int cap = max_blocks();
  if (cap < 0) return -1 - cap;
  const Plan p = make_plan(n, n_rows, C, true, cap);
  Job j = make_job(p, scratch, rows, rows64, n, n_rows, src, C);
  j.fixed = 1;
  j.out = out;
  j.vals = (float*)(scratch + p.vals);
  j.part = (float*)(scratch + p.part);
  j.cnt = scratch + p.cnt;
  j.run_start = scratch + p.run_start;
  j.run_end = scratch + p.run_end;
  j.K = K;
  const cudaStream_t st = (cudaStream_t)stream;
  const int err = launch(j, st);
  if (err != 0) return err;
  sums_kernel<<<(n + SUM_THREADS - 1) / SUM_THREADS, SUM_THREADS, 0, st>>>(j);
  return (int)cudaGetLastError();
}
