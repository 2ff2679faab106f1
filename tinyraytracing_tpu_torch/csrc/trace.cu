// Closest-hit and occlusion BVH traces for Hopper (sm_90a), one thread per
// ray, with a plain C interface loaded through ctypes
// (tinyraytracing_tpu_torch/ops/kernels.py builds this file with nvcc).
//
// Replaces the Pallas kernels reached from
// tinyraytracing_tpu/ops/pallas_trace.py::fused_trace_planes:
//   query "closest"   : _kernel_wide_smem / _kernel_wide_hbm walking
//                       _walk_wide(_pf), and the binary _kernel_smem /
//                       _kernel_smem_all / _kernel_hbm walking _walk; slot
//                       update _leaf_slots.run_slots.
//   query "occlusion" : the same kernels with occl=True; slot update
//                       _leaf_slots.run_slots_occl, carry _init_carry(occl).
//   walk_order "near" : the same wide kernels with ordered=True: the
//                       near-first push of _interior_push (keys along
//                       _mean_dir, the _SORT8 network) and the pop-time
//                       stale cull (ORDERED below).
// The TPU kernels walk one 8-wide tree per PACKET of rays with a scalar
// stack, because the TPU's scalar unit drives the walk; their SMEM/HBM
// variants and DMA prefetch are memory placements that are bitwise equal to
// each other, and the wide walk is bitwise the binary walk. A per-lane
// result does not depend on which packet the lane travels in
// (pallas_trace.py:1212-1217), so here every thread walks the wide tree for
// its own ray, with its own stack, testing children against its own best t
// and pushing hits in reverse child order so pops follow the binary
// preorder — the packet walk's results, lane for lane.
//
// Near-first (ORDERED): the packet walk pushes the children the packet
// keeps in descending order of key = centre . md, md being the packet's
// summed direction. Here the wrapper (ops/trace.py::walk_packets) groups
// the rays into the JAX kernel's packets and passes md per packet; each
// thread keys the children IT keeps with its packet's md, gives the others
// 3e38, and runs the same 19-exchange network, so among its own children
// it pops in the packet's order (exactly, unless two keys tie). Each stack
// entry also holds the thread's entry distance max(t0, 0), and a popped
// node whose entry exceeds bt*(1+tie_eps) is skipped: no hit inside can
// replace or kill any more, so the cull changes no result (the per-lane
// form of the packet's max(bt) cull).
//
// The slot tests copy the JAX arithmetic operation for operation (the slot
// test and repl rule shared with the other walks live in slot_test.cuh);
// this file must be compiled with --fmad=false, since FMA contraction moves
// t in the last ulp and flips decisions inside the tie_eps band and the
// kill.
//
// The layout (ops/trace.py::trace_records, built once per scene from the
// JAX-identical PackedLeaves as Scene.trace_records; the plain version
// still reads WN / PS):
//  - one 32-byte record per child of a wide node, [x0 y0 z0 x1 | y1 z1 meta
//    link]: WN's eight lanes for that child, its pad lane holding the link
//    as int bits (a leaf child: its first slot record; an interior child:
//    how many children that wide node holds). Empty children trail every
//    row, so a walk reads only the occupied ones: two 16-byte loads each,
//    where the WN row took seven scalar loads per child and one for every
//    empty child;
//  - one 64-byte slot test record per OCCUPIED slot, in P's order (the
//    packet-BVH kernel's records, Scene.bvh_records.slot): four 16-byte
//    loads instead of 16 scalar ones from 16 lines 32 floats apart. Pad
//    slots are never tested: their all-zero rows give 3e38, which neither
//    replaces nor kills;
//  - one 64-byte shading record per occupied slot (PS rows 4-7 in the S
//    order), read only where a slot replaces the best hit with attributes
//    (four 16-byte loads), or its material alone where a slot may kill or
//    replaces without attributes;
//  - the slot id 32*leaf + s of each record, read once per ray at the end
//    for its best record.
// A stack entry is one int, the child's WORD (child_word below), plus the
// entry distance under ORDERED: one 8-byte local store and load per push
// and pop instead of two of each. The child taken next (the last one
// pushed) stays in a register and is not pushed at all.
//
// The walk, in two loops, as csrc/bvh_intersect.cu walks: the node loop
// carries a lane to its next leaf and HOLDS it, untested, walking on past
// it with the older, larger bt while other active lanes of the warp hold
// none, up to TRT_HOLD leaves; then the leaf loop tests the held leaves in
// order, the warp's lanes together. That is exact: the lane still meets its
// leaves in preorder, and the larger bt only adds nodes; a leaf the
// one-at-a-time walk would have culled lies, with every triangle in it,
// beyond bt*(1+tie_eps) for the bt of that moment, and bt only shrinks, so
// its slots can neither replace (outside the band and farther) nor kill
// (which needs tm*(1+tie_eps) < bt). After a kill with t_min > 0 the walk
// is over and the held leaves left are dropped. With t_min <= 0 a killed
// lane (bt = -1) could still be replaced by a hit behind its origin in such
// an extra leaf, so there every lane holds one leaf at a time. Under
// ORDERED too: a larger bt keeps more children, which then get finite keys,
// and the network is not stable among tied keys (regular grids tie often),
// so the kept children could pop in another order than the plain walk's.
// One leaf at a time keeps the near walk exact; it still walks in the two
// loops.
//
// Pause (near-first, leaves of at most 8 slots): a near-first lane cannot
// walk past its leaf, so lanes holding one wait for the warp's last
// walkers; once at most 8 lanes still walk, those pause, keeping their
// stack, and the warp tests the held leaves. At leaf 32, where a leaf
// costs up to 32 slot tests, pausing was slower, and under preorder (whose
// lanes walk on past held leaves) it gained nothing.
//
// Refill (PERSIST, on trees of more than one wide node): as many blocks as
// stay resident, whose lanes take ray after ray from a counter at the top
// of each round of the two loops. A lane's result depends on its ray alone,
// so which lanes walk together changes no result. On a one-node tree every
// walk is short and alike, and there a plain grid of one ray per thread is
// faster.
//
// What bounds it on an H100 (chip_smoke.py --profile-walk: per-ray clock64
// counts of a -DTRT_PROFILE build, grid100k at leaf 8, 262,144 camera +
// bounce rays, NVIDIA H100 80GB HBM3 at 700 W): divergence. One ray per
// thread (the earlier kernel's schedule), a warp runs 42.9 interior steps
// while its mean lane needs 7.7, the node loop's iterations find 19% of a
// warp's lanes active and its slot tests 13%, and a warp step costs ~6,100
// cycles (preorder) or 8,800-9,200 (near-first without its pause: the keys
// and the 19-exchange network); bytes and operations do not bound it (its
// bound, chip_smoke.py phase 2, is ~2% of its time). The records cut the
// loads and instructions of a step; one slot record at a time and a cap of
// 80 registers keep 24 warps resident (four records in flight, as
// bvh_intersect.cu loads them, took 186 registers, two blocks per SM, and
// ran at 1.28 ms against the earlier kernel's 0.68); holding two leaves
// and refilling lanes raise the node loop's active share to 30% (near-
// first, with its pause: 13% to 37%). Left over: the lanes of a warp still
// walk paths of different lengths, and the slot tests find 13-21% of the
// lanes active. The near-first instantiations with attributes spill a few
// bytes at the cap; a looser cap (fewer resident blocks) was slower.

#include <cuda_runtime.h>

#include "slot_test.cuh"

#define TRT_MAX_STACK 192
#define TRT_HOLD 2        // leaves a preorder lane holds
#define TRT_MIN_BLOCKS 6  // resident 128-thread blocks per SM (<= 80 registers)

struct TraceParams {
  const float* rays;     // (8, R): ox oy oz dx dy dz t_bound target_mtl
  const float4* nodes;   // (n_wide * 8, 8) child records, 2 float4 each
  const float4* slots;   // (n_records, 16) slot test records, 4 float4 each
  const float4* shade;   // (n_records, 16) shading records, 4 float4 each
  const int* slot_id;    // (n_records,) 32 * leaf + s
  float* out;            // (9, R) closest / (2, R) occlusion
  const float* md;       // (ceil(R / tile), 3) packet direction sums (ORDERED)
  unsigned* next;        // rays taken so far (PERSIST)
  int R, tile, root_kids;
  int pause;             // near-first: walkers pause when at most this many
  float t_min, graze, eps1;  // eps1 = float(1 + tie_eps)
};

struct Ray {
  float ox, oy, oz, dx, dy, dz, invx, invy, invz, oix, oiy, oiz;
};

#ifdef TRT_PROFILE
// measurement builds (chip_smoke.py --profile-walk): per ray i, at 8 * i,
// [cycles, node-loop cycles, leaf-loop cycles, interior expansions, leaves
// tested, slots in them, node-loop entries, 0] (plain grid only); per
// thread t, at 8 * R + 4 * t, [active lanes summed over the node-loop
// iterations it took part in, 2^20 / active lanes summed likewise, the same
// two over its slot tests]: summed over a warp's threads, the first is the
// lanes' work and the second the warp's iterations (both grid and refill)
__device__ long long* trt_prof;
__device__ __forceinline__ void prof_simt(long long& lanes, long long& iters) {
  lanes += 1;
  iters += (1 << 20) / __popc(__activemask());
}
extern "C" int trt_set_prof(void* ptr) {
  return (int)cudaMemcpyToSymbol(trt_prof, &ptr, sizeof(ptr));
}
#define PROF(...) __VA_ARGS__
#else
#define PROF(...)
#endif

// The best hit so far (_init_carry): closest hit with its shading
// attributes and best slot record, or the occlusion pair (bt, bs).
struct Carry {
  float bt, bem, bs, bpnx, bpny, bpnz, btcu, btcv, bmtl;
  int brec;
};

// A child's stack word: an interior child w * 8 + (kids - 1), w its wide
// node and kids that node's children (the record's link); a leaf child
// -(first * 64 + count) - 1, first its first slot record (the link). -1 is
// no word.
__device__ __forceinline__ int child_word(float meta, int link) {
  const int m = (int)meta;
  return m >= 0 ? m * 8 + (link - 1) : -(link * 64 + ((-m - 2) & 63)) - 1;
}

// The slab test of a child record (a, b) with the tie-band early-out, as
// the JAX kernel computes it ((box * inv) - o * inv); t0 is the entry.
__device__ __forceinline__ bool slab(const float4 a, const float4 b,
                                     const Ray& r, float bte, float& t0) {
  const float t_ax = a.x * r.invx - r.oix, t_bx = a.w * r.invx - r.oix;
  const float t_ay = a.y * r.invy - r.oiy, t_by = b.x * r.invy - r.oiy;
  const float t_az = a.z * r.invz - r.oiz, t_bz = b.y * r.invz - r.oiz;
  t0 = fmaxf(fmaxf(fminf(t_ax, t_bx), fminf(t_ay, t_by)), fminf(t_az, t_bz));
  const float t1 = fminf(fminf(fmaxf(t_ax, t_bx), fmaxf(t_ay, t_by)),
                         fmaxf(t_az, t_bz));
  const float dist = t0 > 0.f ? t0 : t1;
  return (t1 >= t0) && (dist > 0.f) && (fmaxf(t0, 0.f) <= bte);
}

// The walk's stack in thread-local memory: child words, with the entry
// distance under ORDERED (one 8-byte entry), whose pop skips stale nodes.
template <bool ORDERED>
struct WalkStack {
  int e[TRT_MAX_STACK];
  int sp = 0;
  __device__ __forceinline__ void push(int w, float) { e[sp++] = w; }
  __device__ __forceinline__ bool pop(int& w, float) {
    if (sp == 0) return false;
    w = e[--sp];
    return true;
  }
};
template <>
struct WalkStack<true> {
  int2 e[TRT_MAX_STACK];
  int sp = 0;
  __device__ __forceinline__ void push(int w, float ent) {
    e[sp++] = make_int2(w, __float_as_int(ent));
  }
  // pop-time cull: nothing in the node lies nearer than its entry
  __device__ __forceinline__ bool pop(int& w, float bte) {
    while (sp > 0) {
      const int2 x = e[--sp];
      if (__int_as_float(x.y) > bte) continue;
      w = x.x;
      return true;
    }
    return false;
  }
};

// one compare-exchange of _SORT8 (pallas_trace.py:414-421): descending by
// key, strict <, the child's word (-1 where the ray does not keep it: the
// keep flag) and entry riding along
__device__ __forceinline__ void cex(float& ka, float& kb, int& ma, int& mb,
                                    float& ea, float& eb) {
  const bool sw = ka < kb;
  const float k = sw ? kb : ka, e = sw ? eb : ea;
  const int m = sw ? mb : ma;
  kb = sw ? ka : kb; mb = sw ? ma : mb; eb = sw ? ea : eb;
  ka = k; ma = m; ea = e;
}

// The slot tests of one held leaf (its word), one 64-byte record after the
// other, the carry updated in slot order (run_slots / run_slots_occl).
// Returns true where a kill with t_min > 0 ended the walk.
template <bool OCCL, bool ATTRS>
__device__ __forceinline__ bool leaf_slots(const TraceParams& p, int word,
                                           const Ray& r, float tg, bool tga,
                                           Carry& c) {
  const int x = -word - 1;
  const int first = x >> 6, cnt = x & 63;
  for (int s = 0; s < cnt; ++s) {
    const int k = first + s;
    const float4* q = p.slots + 4 * (long long)k;
    const float4 q0 = __ldg(q), q1 = __ldg(q + 1), q2 = __ldg(q + 2),
                 q3 = __ldg(q + 3);
    const float f[16] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w,
                         q2.x, q2.y, q2.z, q2.w, q3.x, q3.y, q3.z, q3.w};
    float u, v;
    const float tm =
        woop_slot_test([&f](int a) { return f[a]; }, r.ox, r.oy, r.oz, r.dx,
                       r.dy, r.dz, p.t_min, p.graze, u, v);
    const float em = f[15];
    const bool repl = slot_replaces(tm, em, c.bt, c.bem, p.eps1);
    const bool may_kill = tga && (tm * p.eps1 < c.bt);
    if (!repl && !may_kill) continue;                  // no carry change
    const float4* sh = p.shade + 4 * (long long)k;
    float4 h0, h1, h2, h3;
    float mt_slot;
    if (ATTRS && repl) {
      h0 = __ldg(sh); h1 = __ldg(sh + 1); h2 = __ldg(sh + 2);
      h3 = __ldg(sh + 3);
      mt_slot = h3.w;
    } else {
      mt_slot = __ldg((const float*)sh + 15);
    }
    const bool wrong = fabsf(mt_slot - tg) > 0.5f;
    const bool kill = may_kill && wrong;
    // the jnp.where chains: a kill takes precedence over repl, except for
    // the shading attributes, which follow repl alone (a kill implies
    // repl: tm*(1+eps) < bt rules out the band, and tm < bt)
    if (kill) {
      c.bt = -1.f;
      c.bem = 0.f;
      if (OCCL) {
        c.bs = 0.f;
      } else {
        c.bmtl = -3.f;
        if (ATTRS) c.brec = -1;
      }
    } else {
      c.bt = tm;
      c.bem = em;
      if (OCCL) {
        c.bs = wrong ? 0.f : 1.f;
      } else {
        c.bmtl = mt_slot;
        if (ATTRS) c.brec = k;
      }
    }
    if (ATTRS && repl) {
      // H(0..15) = h0.xyzw h1.xyzw h2.xyzw h3.xyzw
      const float w = 1.0f - u - v;
      c.bpnx = h0.x * w + h0.w * u + h1.z * v;
      c.bpny = h0.y * w + h1.x * u + h1.w * v;
      c.bpnz = h0.z * w + h1.y * u + h2.x * v;
      c.btcu = h2.y * w + h2.w * u + h3.y * v;
      c.btcv = h2.z * w + h3.x * u + h3.z * v;
    }
    // after a kill (bt = -1) no slot with t >= t_min > 0 can replace or
    // kill again and no box passes the slab test: the walk is over
    if (kill && p.t_min > 0.f) return true;
  }
  return false;
}

// A lane's ray: its planes, _ray_consts (1e18 axis-parallel sentinel,
// hoisted o*inv), its target, _init_carry, and its packet's direction sum
// under ORDERED.
template <bool ORDERED>
__device__ __forceinline__ void load_ray(const TraceParams& p, long long i,
                                         Ray& r, float& tg, Carry& c,
                                         float& md0, float& md1, float& md2) {
  const long long R = p.R;   // plane k of ray i at k*R + i
  r.ox = p.rays[i]; r.oy = p.rays[R + i]; r.oz = p.rays[2 * R + i];
  r.dx = p.rays[3 * R + i]; r.dy = p.rays[4 * R + i]; r.dz = p.rays[5 * R + i];
  tg = p.rays[7 * R + i];
  const bool sx = fabsf(r.dx) < 1e-18f, sy = fabsf(r.dy) < 1e-18f,
             sz = fabsf(r.dz) < 1e-18f;
  r.invx = (sx ? 1e18f : 1.0f) / (sx ? 1.0f : r.dx);
  r.invy = (sy ? 1e18f : 1.0f) / (sy ? 1.0f : r.dy);
  r.invz = (sz ? 1e18f : 1.0f) / (sz ? 1.0f : r.dz);
  r.oix = r.ox * r.invx; r.oiy = r.oy * r.invy; r.oiz = r.oz * r.invz;
  c = Carry{p.rays[6 * R + i], 0.f, 0.f, 0.f, 0.f, 1.f, 0.f, 0.f, -1.f, -1};
  if (ORDERED) {
    const float* md = p.md + 3 * (i / p.tile);
    md0 = md[0]; md1 = md[1]; md2 = md[2];
  }
}

template <bool OCCL, bool ATTRS>
__device__ __forceinline__ void store_ray(const TraceParams& p, long long i,
                                          const Carry& c) {
  const long long R = p.R;
  float* out = p.out;
  out[i] = c.bt;
  if (OCCL) {
    out[R + i] = c.bs;
  } else {
    out[R + i] = c.bpnx;
    out[2 * R + i] = c.bpny;
    out[3 * R + i] = c.bpnz;
    out[4 * R + i] = c.btcu;
    out[5 * R + i] = c.btcv;
    out[6 * R + i] = c.bmtl;
    out[7 * R + i] = c.bem;
    out[8 * R + i] = c.brec >= 0 ? (float)__ldg(p.slot_id + c.brec) : -1.f;
  }
}

// PERSIST: resident blocks whose lanes take ray after ray from a counter
// (the warp's lanes that need one take consecutive rays), so a lane whose
// walk ends early does not idle while its warp's slowest lane walks on.
template <bool OCCL, bool ATTRS, bool ORDERED, bool PERSIST>
__global__ void __launch_bounds__(128, TRT_MIN_BLOCKS)
    trace_kernel(TraceParams p) {
  long long i = PERSIST ? -1 : (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (!PERSIST && i >= p.R) return;
  Ray r;
  Carry c;
  float tg = 0.f, md0 = 0.f, md1 = 0.f, md2 = 0.f;
  if (!PERSIST) load_ray<ORDERED>(p, i, r, tg, c, md0, md1, md2);
  bool tga = tg > -1.5f;
  const int hold = (ORDERED || !(p.t_min > 0.f)) ? 1 : TRT_HOLD;

  WalkStack<ORDERED> st;
  int cur = p.root_kids - 1;   // the root: wide node 0
  bool have = !PERSIST;        // cur holds the next node; else pop
  bool fin = PERSIST;          // this lane's walk is over (or not begun)
  PROF(long long pf_start = clock64(), pf_node = 0, pf_leaf = 0, pf_exp = 0,
       pf_leaves = 0, pf_slots = 0, pf_entries = 0, pf_t = 0;
       long long pf_na = 0, pf_ni = 0, pf_sa = 0, pf_si = 0;)
  for (;;) {
    if (PERSIST) {
      // lanes whose walk is over store their result and take the next ray
      const unsigned act = __activemask();
      const unsigned need = __ballot_sync(act, fin);
      if (need) {
        const int lead = __ffs(need) - 1;
        unsigned base = 0;
        if ((int)(threadIdx.x % 32) == lead)
          base = atomicAdd(p.next, (unsigned)__popc(need));
        base = __shfl_sync(act, base, lead);
        if (fin) {
          if (i >= 0) store_ray<OCCL, ATTRS>(p, i, c);
          i = (long long)base +
              __popc(need & ((1u << (threadIdx.x % 32)) - 1));
          if (i >= p.R) break;
          load_ray<ORDERED>(p, i, r, tg, c, md0, md1, md2);
          tga = tg > -1.5f;
          st.sp = 0;
          cur = p.root_kids - 1;
          have = true;
          fin = false;
        }
      }
    }
    PROF(++pf_entries; pf_t = clock64();)
    // node loop: walk to the next leaf and hold it; walk on past it while
    // other active lanes hold none, up to `hold` leaves
    int h0 = 0, h1 = 0, nh = 0;
    for (;;) {
      PROF(prof_simt(pf_na, pf_ni);)
      if (!have) {
        have = st.pop(cur, c.bt * p.eps1);
        if (!have) break;                                // walk over
      }
      if (cur < 0) {                                     // a leaf: hold it
        if (nh == 0) h0 = cur;
        else h1 = cur;
        have = false;
        if (++nh == hold) break;
      } else {
        // interior: slab-test its children against this ray's current bt
        PROF(++pf_exp;)
        const float4* row = p.nodes + 16 * (long long)(cur >> 3);
        const int nk = (cur & 7) + 1;
        const float bte = c.bt * p.eps1;
        int next = -1;
        float next_ent = 0.f;
        if (ORDERED) {
          // near-first: key the children this ray keeps, sort them
          // descending, push far first; the nearest is taken next
          float key[8], ent[8];
          int word[8];                   // -1: a child this ray does not keep
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            key[k] = 3.0e38f; ent[k] = 0.f; word[k] = -1;
            if (k < nk) {
              const float4 a = __ldg(row + 2 * k), b = __ldg(row + 2 * k + 1);
              float t0;
              if (slab(a, b, r, bte, t0)) {
                key[k] = (a.x + a.w) * md0 + (a.y + b.x) * md1 +
                         (a.z + b.y) * md2;
                word[k] = child_word(b.z, __float_as_int(b.w));
              }
              ent[k] = fmaxf(t0, 0.f);
            }
          }
          // one kept child has one order: the warp sorts only where some
          // lane keeps two
          int kept = 0;
#pragma unroll
          for (int k = 0; k < 8; ++k) kept += word[k] != -1;
          if (__any_sync(__activemask(), kept > 1)) {
#define CEX(a, b) cex(key[a], key[b], word[a], word[b], ent[a], ent[b])
          CEX(0, 1); CEX(2, 3); CEX(4, 5); CEX(6, 7); CEX(0, 2); CEX(1, 3);
          CEX(4, 6); CEX(5, 7); CEX(1, 2); CEX(5, 6); CEX(0, 4); CEX(1, 5);
          CEX(2, 6); CEX(3, 7); CEX(2, 4); CEX(3, 5); CEX(1, 2); CEX(3, 4);
          CEX(5, 6);
#undef CEX
          }
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            if (word[k] != -1) {
              if (next != -1) st.push(next, next_ent);
              next = word[k];
              next_ent = ent[k];
            }
          }
        } else {
          // preorder: children in reverse, so the first hit is taken next
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int k = 7 - j;
            if (k >= nk) continue;
            const float4 a = __ldg(row + 2 * k), b = __ldg(row + 2 * k + 1);
            float t0;
            if (slab(a, b, r, bte, t0)) {
              if (next != -1) st.push(next, 0.f);
              next = child_word(b.z, __float_as_int(b.w));
            }
          }
        }
        cur = next;
        have = next != -1;
      }
      // (a near-first lane holds one leaf and leaves at once: no vote; the
      // few lanes still walking pause instead, keeping their state)
      if (!ORDERED && __all_sync(__activemask(), nh > 0)) break;
      if (ORDERED && __popc(__activemask()) <= p.pause) break;
    }
    PROF(pf_node += clock64() - pf_t;)
    if (ORDERED && nh == 0 && (have || st.sp > 0)) continue;  // paused
    if (nh == 0) {                                       // walk over
      fin = true;
      if (PERSIST) continue;
      break;
    }
    // leaf loop: the held leaves in the order met
    PROF(pf_t = clock64(); pf_leaves += nh;
         pf_slots += ((-h0 - 1) & 63) + (nh > 1 ? (-h1 - 1) & 63 : 0);)
    bool over = false;
    for (; nh > 0 && !over; --nh) {      // one call site: one inlined copy
      PROF(for (int k = 0; k < ((-h0 - 1) & 63); ++k) prof_simt(pf_sa, pf_si);)
      over = leaf_slots<OCCL, ATTRS>(p, h0, r, tg, tga, c);
      h0 = h1;
    }
    PROF(pf_leaf += clock64() - pf_t;)
    if (over) {                            // a kill with t_min > 0: done
      st.sp = 0;
      have = false;
    }
  }
  PROF(long long* w = trt_prof + 8LL * p.R +
                      4 * ((long long)blockIdx.x * blockDim.x + threadIdx.x);
       w[0] = pf_na; w[1] = pf_ni; w[2] = pf_sa; w[3] = pf_si;)
  if (PERSIST) return;
  PROF(long long* q = trt_prof + 8 * i; q[0] = clock64() - pf_start;
       q[1] = pf_node; q[2] = pf_leaf; q[3] = pf_exp; q[4] = pf_leaves;
       q[5] = pf_slots; q[6] = pf_entries; q[7] = 0;)
  store_ray<OCCL, ATTRS>(p, i, c);
}

// _mean_dir (pallas_trace.py:376) as XLA's CPU backend adds it: a packet's
// (rows, 128) block in bands of min(rows, 32) rows, each band in four
// windows of 32 lanes; each window summed row-major from 0, each band's
// four window sums in order from 0, then the band sums pairwise
// (b[i] + b[i + n/2], halving; the band count padded with zero bands to a
// power of two). Rays past R are zero padding.
// ops/trace.py::packet_dirs_plain is the same sum.
//
// The order of the adds is fixed, so each window's chain of wr * 32
// dependent adds (512 at tile 2048) is the critical path; the bound by
// bytes is about as long. One block per (packet, axis), one warp per
// window (up to 32 warps; a warp takes windows w, w + 32, ... of taller
// packets): the warp's 32 lanes load the window's rows, one 128-byte row
// per load, all in flight before any is used, into the warp's own slice of
// shared memory; then lane 0 runs the chain from 16-byte shared loads,
// which do not depend on the chain and run ahead of it. Thread 0 then
// combines the window sums in the order above.
#define TRT_DIRS_BAND 32
#define TRT_DIRS_WARPS 32
__global__ void __launch_bounds__(32 * TRT_DIRS_WARPS) packet_dirs_kernel(
    const float* __restrict__ rays, int R, int tile, float* __restrict__ md) {
  extern __shared__ float4 dirs_smem[];
  const int pkt = blockIdx.x, axis = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nwarps = blockDim.x / 32;
  const float* d = rays + (long long)(3 + axis) * R;
  const int rows = tile / 128;
  const int wr = rows < TRT_DIRS_BAND ? rows : TRT_DIRS_BAND;
  const int rb = (rows + wr - 1) / wr, nwin = 4 * rb;
  const long long base = (long long)pkt * tile;
  float* win = (float*)dirs_smem + warp * (TRT_DIRS_BAND * 32);
  float* part = (float*)dirs_smem + nwarps * (TRT_DIRS_BAND * 32);
  for (int w = warp; w < nwin; w += nwarps) {
    const int b = w / 4, j = w % 4;
    float v[TRT_DIRS_BAND];
#pragma unroll
    for (int r = 0; r < TRT_DIRS_BAND; ++r) {
      const int row = b * wr + r;
      const long long k = base + (long long)row * 128 + j * 32 + lane;
      v[r] = (r < wr && row < rows && k < R) ? __ldg(d + k) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < TRT_DIRS_BAND; ++r)
      if (r < wr) win[r * 32 + lane] = v[r];
    __syncwarp();
    if (lane == 0) {
      const float4* q = (const float4*)win;
      float acc = 0.f;
#pragma unroll 2
      for (int r = 0; r < wr; ++r) {
        float4 x[8];
#pragma unroll
        for (int c = 0; c < 8; ++c) x[c] = q[r * 8 + c];
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          acc += x[c].x;
          acc += x[c].y;
          acc += x[c].z;
          acc += x[c].w;
        }
      }
      part[w] = acc;
    }
    __syncwarp();  // the warp's next window overwrites its slice
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int b = 0; b < rb; ++b)
      part[b] = (((0.f + part[4 * b]) + part[4 * b + 1]) + part[4 * b + 2]) +
                part[4 * b + 3];
    int n = 1;
    while (n < rb) n *= 2;
    for (int b = rb; b < n; ++b) part[b] = 0.f;
    for (int h = n / 2; h >= 1; h /= 2)
      for (int i = 0; i < h; ++i) part[i] = part[i] + part[i + h];
    md[3 * pkt + axis] = part[0];
  }
}

extern "C" int trt_packet_dirs(const float* rays, int R, int tile, float* md,
                               void* stream) {
  if (R <= 0) return 0;
  if (tile <= 0 || tile % 128) return (int)cudaErrorInvalidValue;
  const int rows = tile / 128;
  const int wr = rows < TRT_DIRS_BAND ? rows : TRT_DIRS_BAND;
  const int nwin = 4 * ((rows + wr - 1) / wr);
  const int nwarps = nwin < TRT_DIRS_WARPS ? nwin : TRT_DIRS_WARPS;
  // the warps' window slices, then one sum per window (the band sums, padded
  // to a power of two, reuse the first half)
  const size_t smem =
      sizeof(float) * ((size_t)nwarps * TRT_DIRS_BAND * 32 + nwin);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        packet_dirs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)((R + tile - 1) / tile), 3), block(32 * nwarps);
  packet_dirs_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(rays, R,
                                                                  tile, md);
  return (int)cudaGetLastError();
}

extern "C" int trt_max_stack() { return TRT_MAX_STACK; }

template <bool OCCL, bool ATTRS, bool ORDERED>
static int launch_trace(const TraceParams& p, cudaStream_t st) {
  const unsigned blocks = (unsigned)((p.R + 127) / 128);
  if (p.next == nullptr) {
    trace_kernel<OCCL, ATTRS, ORDERED, false><<<blocks, 128, 0, st>>>(p);
    return (int)cudaGetLastError();
  }
  // as many blocks as stay resident (counted once per instantiation)
  static unsigned resident = 0;
  if (resident == 0) {
    int per_sm = 0, dev = 0, n_sm = 0;
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, trace_kernel<OCCL, ATTRS, ORDERED, true>, 128, 0);
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    resident = (unsigned)(per_sm * n_sm);
  }
  const cudaError_t e = cudaMemsetAsync(p.next, 0, sizeof(unsigned), st);
  if (e != cudaSuccess) return (int)e;
  trace_kernel<OCCL, ATTRS, ORDERED, true>
      <<<blocks < resident ? blocks : resident, 128, 0, st>>>(p);
  return (int)cudaGetLastError();
}

// query: 0 closest hit with attributes, 1 closest hit without, 2 occlusion.
// nodes / slots / shade / slot_id: Scene.trace_records; root_kids: the root
// wide node's children. next: NULL, or one int of scratch with which
// resident blocks take rays until all are walked. md: NULL for the
// preorder walk, else the (ceil(R / tile), 3) packet direction sums of the
// near-first walk. pause: under md, the near-first walkers pause (and the
// warp tests its held leaves) once at most this many lanes still walk.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int trt_trace(const float* rays, const void* nodes,
                         const void* slots, const void* shade,
                         const int* slot_id, float* out, void* next, int R,
                         int query, const float* md, int tile, int root_kids,
                         int pause, float t_min, float graze, float eps1,
                         void* stream) {
  if (R <= 0) return 0;
  if (query < 0 || query > 2 || (md != nullptr && tile <= 0) ||
      root_kids < 1 || root_kids > 8)
    return (int)cudaErrorInvalidValue;
  TraceParams p{rays, (const float4*)nodes, (const float4*)slots,
                (const float4*)shade, slot_id, out, md, (unsigned*)next, R,
                tile, root_kids, pause, t_min, graze, eps1};
  cudaStream_t st = (cudaStream_t)stream;
  switch (query + (md != nullptr ? 3 : 0)) {
    case 0: return launch_trace<false, true, false>(p, st);
    case 1: return launch_trace<false, false, false>(p, st);
    case 2: return launch_trace<true, false, false>(p, st);
    case 3: return launch_trace<false, true, true>(p, st);
    case 4: return launch_trace<false, false, true>(p, st);
    case 5: return launch_trace<true, false, true>(p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
