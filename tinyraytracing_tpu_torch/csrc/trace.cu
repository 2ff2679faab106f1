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
// it pops in the packet's order (exactly, unless two keys tie). Each push
// also records the thread's entry distance max(t0, 0) on a parallel float
// stack, and a popped node whose entry exceeds bt*(1+tie_eps) is skipped:
// no hit inside can replace or kill any more, so the cull changes no
// result (the per-lane form of the packet's max(bt) cull). The float stack
// doubles the thread's local stack memory, from 768 to 1,536 bytes at
// TRT_MAX_STACK 192 (local memory, L1-cached; 196 KB per 128-thread block
// at most, reached only by the deepest trees).
//
// The slot tests copy the JAX arithmetic operation for operation (the slot
// test and repl rule shared with the other walks live in slot_test.cuh); this
// file
// must be compiled with --fmad=false, since FMA contraction moves t in the
// last ulp and flips decisions inside the tie_eps band and the kill.
//
// What bounds it on an H100: neither FLOPs nor bandwidth. Each step of the
// walk is a dependent global load (a 512-byte wide-node row, or 16-32
// strided per-slot floats of a leaf block) followed by ~60 float ops, and
// rays of one warp take different paths (divergence). The PS and WN arrays
// are read in their JAX (TPU-shaped) layouts: a slot's attributes sit 32
// floats apart, so one slot test touches 16 different 128-byte lines.
// This design does what is cheap: reads through the read-only cache
// (__ldg), loads a slot's shading attributes only when the slot replaces
// the best hit, and keeps the stack in thread-local memory (L1-resident).
// A Hopper-shaped layout (slot-major leaf records, 16-byte vector loads)
// and warp-coherent ray ordering are later work.

#include <cuda_runtime.h>

#include "slot_test.cuh"

#define TRT_MAX_STACK 192
#define TRT_SLOT 32

struct TraceParams {
  const float* rays;  // (8, R): ox oy oz dx dy dz t_bound target_mtl
  const float* wn;    // (n_wide, 128) wide node rows
  const float* ps;    // (8, ps_cols) packed leaf payload
  long long ps_cols;
  float* out;         // (9, R) closest / (2, R) occlusion
  const float* md;    // (ceil(R / tile), 3) packet direction sums (ORDERED)
  int R, tile;
  float t_min, graze, eps1;  // eps1 = float(1 + tie_eps)
};

// one compare-exchange of _SORT8 (pallas_trace.py:414-421): descending by
// key, strict <, the keep flag and entry riding along
__device__ __forceinline__ void cex(float& ka, float& kb, int& ma, int& mb,
                                    bool& pa, bool& pb, float& ea,
                                    float& eb) {
  const bool sw = ka < kb;
  const float k = sw ? kb : ka, e = sw ? eb : ea;
  const int m = sw ? mb : ma;
  const bool q = sw ? pb : pa;
  kb = sw ? ka : kb; mb = sw ? ma : mb; pb = sw ? pa : pb; eb = sw ? ea : eb;
  ka = k; ma = m; pa = q; ea = e;
}

template <bool OCCL, bool ATTRS, bool ORDERED>
__global__ void __launch_bounds__(128) trace_kernel(TraceParams p) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.R) return;
  const long long R = p.R;   // plane k of ray i at k*R + i
  const float INF = 3.0e38f;

  const float ox = p.rays[i], oy = p.rays[R + i], oz = p.rays[2 * R + i];
  const float dx = p.rays[3 * R + i], dy = p.rays[4 * R + i],
              dz = p.rays[5 * R + i];
  const float tb = p.rays[6 * R + i], tg = p.rays[7 * R + i];

  // _ray_consts: 1e18 axis-parallel sentinel, hoisted o*inv
  const bool sx = fabsf(dx) < 1e-18f, sy = fabsf(dy) < 1e-18f,
             sz = fabsf(dz) < 1e-18f;
  const float invx = (sx ? 1e18f : 1.0f) / (sx ? 1.0f : dx);
  const float invy = (sy ? 1e18f : 1.0f) / (sy ? 1.0f : dy);
  const float invz = (sz ? 1e18f : 1.0f) / (sz ? 1.0f : dz);
  const float oix = ox * invx, oiy = oy * invy, oiz = oz * invz;
  const bool tga = tg > -1.5f;

  // _init_carry
  float bt = tb, bem = 0.f;
  float bs = 0.f;                                        // occlusion
  float bpnx = 0.f, bpny = 0.f, bpnz = 1.f, btcu = 0.f, btcv = 0.f,
        bmtl = -1.f, bslot = -1.f;                       // closest hit

  const float* __restrict__ ps = p.ps;
  const long long cols = p.ps_cols;

  float md0 = 0.f, md1 = 0.f, md2 = 0.f;
  if (ORDERED) {
    const float* md = p.md + 3 * (i / p.tile);
    md0 = md[0]; md1 = md[1]; md2 = md[2];
  }

  int stack[TRT_MAX_STACK];
  float tstack[ORDERED ? TRT_MAX_STACK : 1];  // entry distance per push
  int sp = 1;
  stack[0] = 0;  // root wide node
  tstack[0] = 0.f;
  while (sp > 0) {
    const int m = stack[--sp];
    // pop-time cull: nothing in the node lies nearer than its entry
    if (ORDERED && tstack[sp] > bt * p.eps1) continue;
    if (ORDERED && m >= 0) {
      // interior, near-first: key the children this ray keeps, sort them
      // descending, push far first so the nearest pops next
      const float* __restrict__ row = p.wn + (long long)m * 128;
      const float bte = bt * p.eps1;
      float key[8], ent[8];
      int meta[8];
      bool keep[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float* ch = row + c * 8;
        const float mf = __ldg(ch + 6);
        meta[c] = (int)mf;
        key[c] = 3.0e38f;
        ent[c] = 0.f;
        keep[c] = false;
        if (mf == -1.0f) continue;                       // empty slot
        const float x0 = __ldg(ch + 0), y0 = __ldg(ch + 1), z0 = __ldg(ch + 2);
        const float x1 = __ldg(ch + 3), y1 = __ldg(ch + 4), z1 = __ldg(ch + 5);
        const float t_ax = x0 * invx - oix, t_bx = x1 * invx - oix;
        const float t_ay = y0 * invy - oiy, t_by = y1 * invy - oiy;
        const float t_az = z0 * invz - oiz, t_bz = z1 * invz - oiz;
        const float t0 = fmaxf(fmaxf(fminf(t_ax, t_bx), fminf(t_ay, t_by)),
                               fminf(t_az, t_bz));
        const float t1 = fminf(fminf(fmaxf(t_ax, t_bx), fmaxf(t_ay, t_by)),
                               fmaxf(t_az, t_bz));
        const float dist = t0 > 0.f ? t0 : t1;
        keep[c] = (t1 >= t0) && (dist > 0.f) && (fmaxf(t0, 0.f) <= bte);
        if (keep[c])
          key[c] = (x0 + x1) * md0 + (y0 + y1) * md1 + (z0 + z1) * md2;
        ent[c] = fmaxf(t0, 0.f);
      }
#define CEX(a, b) \
  cex(key[a], key[b], meta[a], meta[b], keep[a], keep[b], ent[a], ent[b])
      CEX(0, 1); CEX(2, 3); CEX(4, 5); CEX(6, 7); CEX(0, 2); CEX(1, 3);
      CEX(4, 6); CEX(5, 7); CEX(1, 2); CEX(5, 6); CEX(0, 4); CEX(1, 5);
      CEX(2, 6); CEX(3, 7); CEX(2, 4); CEX(3, 5); CEX(1, 2); CEX(3, 4);
      CEX(5, 6);
#undef CEX
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        if (keep[c]) {
          stack[sp] = meta[c];
          tstack[sp] = ent[c];
          ++sp;
        }
      }
      continue;
    }
    if (m >= 0) {
      // interior: slab-test the 8 children against this ray's current bt
      const float* __restrict__ row = p.wn + (long long)m * 128;
      const float bte = bt * p.eps1;
      for (int c = 7; c >= 0; --c) {                     // reverse preorder
        const float* ch = row + c * 8;
        const float meta = __ldg(ch + 6);
        if (meta == -1.0f) continue;                     // empty slot
        const float t_ax = __ldg(ch + 0) * invx - oix;
        const float t_bx = __ldg(ch + 3) * invx - oix;
        const float t_ay = __ldg(ch + 1) * invy - oiy;
        const float t_by = __ldg(ch + 4) * invy - oiy;
        const float t_az = __ldg(ch + 2) * invz - oiz;
        const float t_bz = __ldg(ch + 5) * invz - oiz;
        const float t0 = fmaxf(fmaxf(fminf(t_ax, t_bx), fminf(t_ay, t_by)),
                               fminf(t_az, t_bz));
        const float t1 = fminf(fminf(fmaxf(t_ax, t_bx), fmaxf(t_ay, t_by)),
                               fmaxf(t_az, t_bz));
        const float dist = t0 > 0.f ? t0 : t1;
        if ((t1 >= t0) && (dist > 0.f) && (fmaxf(t0, 0.f) <= bte))
          stack[sp++] = (int)meta;
      }
      continue;
    }
    // leaf: meta = -(leaf_id*64 + count + 2)
    const int dec = -m - 2;
    const int leaf = dec >> 6;
    const int cnt = dec & 63;
    const float* __restrict__ blk = ps + (long long)leaf * 128;
#define H(a) __ldg(blk + (4 + (a) / 4) * cols + ((a) % 4) * TRT_SLOT + s)
    for (int s = 0; s < cnt; ++s) {
      const auto g = [blk, cols, s](int a) {
        return __ldg(blk + (a / 4) * cols + (a % 4) * TRT_SLOT + s);
      };
      float u, v;
      const float tm = woop_slot_test(g, ox, oy, oz, dx, dy, dz, p.t_min,
                                      p.graze, u, v);
      const float em = g(15);
      const bool repl = slot_replaces(tm, em, bt, bem, p.eps1);
      const bool may_kill = tga && (tm * p.eps1 < bt);
      if (!repl && !may_kill) continue;                  // no carry change
      const float mt_slot = H(15);
      const bool wrong = fabsf(mt_slot - tg) > 0.5f;
      const bool kill = may_kill && wrong;
      // the jnp.where chains: a kill takes precedence over repl, except for
      // the shading attributes, which follow repl alone (a kill implies
      // repl: tm*(1+eps) < bt rules out the band, and tm < bt)
      if (kill) {
        bt = -1.f;
        bem = 0.f;
        if (OCCL) {
          bs = 0.f;
        } else {
          bmtl = -3.f;
          if (ATTRS) bslot = -1.f;
        }
      } else {
        bt = tm;
        bem = em;
        if (OCCL) {
          bs = wrong ? 0.f : 1.f;
        } else {
          bmtl = mt_slot;
          if (ATTRS) bslot = (float)(leaf * TRT_SLOT) + (float)s;
        }
      }
      if (ATTRS && repl) {
        const float w = 1.0f - u - v;
        bpnx = H(0) * w + H(3) * u + H(6) * v;
        bpny = H(1) * w + H(4) * u + H(7) * v;
        bpnz = H(2) * w + H(5) * u + H(8) * v;
        btcu = H(9) * w + H(11) * u + H(13) * v;
        btcv = H(10) * w + H(12) * u + H(14) * v;
      }
      // after a kill (bt = -1) no slot with t >= t_min > 0 can replace or
      // kill again and no box passes the slab test: the walk is over
      if (kill && p.t_min > 0.f) {
        sp = 0;
        break;
      }
    }
#undef H
  }

  float* out = p.out;
  out[i] = bt;
  if (OCCL) {
    out[R + i] = bs;
  } else {
    out[R + i] = bpnx;
    out[2 * R + i] = bpny;
    out[3 * R + i] = bpnz;
    out[4 * R + i] = btcu;
    out[5 * R + i] = btcv;
    out[6 * R + i] = bmtl;
    out[7 * R + i] = bem;
    out[8 * R + i] = bslot;
  }
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

// query: 0 closest hit with attributes, 1 closest hit without, 2 occlusion.
// md: NULL for the preorder walk, else the (ceil(R / tile), 3) packet
// direction sums of the near-first walk.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int trt_trace(const float* rays, const float* wn, const float* ps,
                         long long ps_cols, float* out, int R, int query,
                         const float* md, int tile, float t_min, float graze,
                         float eps1, void* stream) {
  if (R <= 0) return 0;
  if (query < 0 || query > 2 || (md != nullptr && tile <= 0))
    return (int)cudaErrorInvalidValue;
  TraceParams p{rays, wn, ps, ps_cols, out, md, R, tile, t_min, graze, eps1};
  const dim3 block(128), grid((unsigned)((R + 127) / 128));
  cudaStream_t st = (cudaStream_t)stream;
  const int q = query + (md != nullptr ? 3 : 0);
  switch (q) {
    case 0: trace_kernel<false, true, false><<<grid, block, 0, st>>>(p); break;
    case 1: trace_kernel<false, false, false><<<grid, block, 0, st>>>(p); break;
    case 2: trace_kernel<true, false, false><<<grid, block, 0, st>>>(p); break;
    case 3: trace_kernel<false, true, true><<<grid, block, 0, st>>>(p); break;
    case 4: trace_kernel<false, false, true><<<grid, block, 0, st>>>(p); break;
    case 5: trace_kernel<true, false, true><<<grid, block, 0, st>>>(p); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
