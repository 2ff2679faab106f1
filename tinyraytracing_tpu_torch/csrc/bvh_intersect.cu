// Binary skip-link BVH closest hit for Hopper (sm_90a), one thread per ray,
// with a plain C interface loaded through ctypes
// (tinyraytracing_tpu_torch/ops/kernels.py builds this file with nvcc).
//
// Replaces tinyraytracing_tpu/ops/pallas_bvh.py::pallas_bvh_intersect_planes
// (its _kernel): the intersector="bvh_pallas" backend of the scan renderer.
// Outputs (t, tri, u, v) per ray, as that function returns them; a miss
// gives t = 3e38 and slot 0, hence tri = tid[0].
//
// The TPU kernel walks the tree once per PACKET of 1024 rays: it descends
// when ANY lane's box test passes, and at a leaf it runs the slot test for
// every lane of the packet. Here every thread walks the tree for its own
// ray with a stackless cursor (descend to i+1 on its own interior hit,
// otherwise jump to the skip link). That is exact, lane for lane:
//  - a lane whose own box test fails at a node cannot be replaced by any
//    triangle below it. A triangle lies inside every ancestor's box,
//    padded by aabb_pad, so a ray that hits it at t >= t_min > 0 passes
//    the geometric slab test; if the lane failed the early-out instead,
//    max(t0, 0) > bt * (1 + tie_eps) and the hit lies at t >= t0, outside
//    the tie band and beyond bt, and bt only shrinks along the walk. So the
//    packet's extra leaf tests never change the lane's carry;
//  - the leaves a lane does reach, it reaches in preorder in both walks,
//    so its sequence of carry updates is the same.
// tests/test_torch_intersect.py holds the plain version of this walk
// against the JAX kernel in interpret mode, on coherent (camera, shadow)
// and incoherent (diffuse bounce) rays.
//
// The arithmetic copies the JAX kernel operation for operation: inverse
// direction where(d == 0, 3e38, 1) / where(d == 0, 1, d) (-0.0 == 0 takes
// the 3e38 branch), the slab test (box - o) * inv with the tie-band
// early-out always on, slots 0..leaf_size-1 of the leaf's block (the pad
// slots are all-zero rows that never hit), the Woop-plane slot test and
// the repl rule (slot_test.cuh), the slot id carried as a float. Build with
// --fmad=false:
// FMA contraction would move t in the last ulp and flip decisions inside
// the tie band.
//
// What bounds it on an H100: neither FLOPs nor bandwidth. A node costs two
// dependent 16-byte box loads and an 8-byte link load, then ~28 float ops;
// a leaf costs 16 scalar loads per slot from the TPU-shaped P layout
// (a slot's attributes sit 32 floats apart) and ~69 float ops; rays of a
// warp take different paths (divergence) and wait on those loads. The
// design keeps it simple: node records are read with two float4 and one
// int2 loads through the read-only cache, the walk needs no stack, and the
// carry lives in registers. A slot-major leaf layout and warp-coherent ray
// order are later work.

#include <cuda_runtime.h>

#include "slot_test.cuh"

#define BVH_SLOT 32

// NaN-propagating min / max, as jnp.minimum / jnp.maximum and torch's
// (fminf / fmaxf would drop a NaN operand)
__device__ __forceinline__ float jmin(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float jmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

struct BvhParams {
  const float* rays;       // (6, R): ox oy oz dx dy dz
  const float4* node_box;  // (N, 8) f32 as 2 float4 per node
  const int2* node_meta;   // (N, 2) i32: skip, leaf_id*64 + count or -1
  const float* p;          // (4, p_cols) packed leaf payload
  const int* tid;          // (n_tid,) slot -> triangle
  long long p_cols;
  float* t_out;
  int* tri_out;
  float* u_out;
  float* v_out;
  int R, n_nodes, leaf_size, n_tid;
  float t_min, graze, eps1;  // eps1 = float(1 + tie_eps)
};

__global__ void __launch_bounds__(128) bvh_intersect_kernel(BvhParams p) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.R) return;
  const long long R = p.R;
  const float INF = 3.0e38f;

  const float ox = p.rays[i], oy = p.rays[R + i], oz = p.rays[2 * R + i];
  const float dx = p.rays[3 * R + i], dy = p.rays[4 * R + i],
              dz = p.rays[5 * R + i];
  const float invx = (dx == 0.f ? INF : 1.f) / (dx == 0.f ? 1.f : dx);
  const float invy = (dy == 0.f ? INF : 1.f) / (dy == 0.f ? 1.f : dy);
  const float invz = (dz == 0.f ? INF : 1.f) / (dz == 0.f ? 1.f : dz);

  float bt = INF, bi = 0.f, bu = 0.f, bv = 0.f, be = 0.f;
  const float* __restrict__ P = p.p;
  const long long cols = p.p_cols;

  int node = 0;
  while (node < p.n_nodes) {
    // node row: [x0 y0 z0 x1 | y1 z1 skip enc] (the last two as floats)
    const float4 a = __ldg(p.node_box + 2 * (long long)node);
    const float4 b = __ldg(p.node_box + 2 * (long long)node + 1);
    const int2 meta = __ldg(p.node_meta + node);
    const float t_ax = (a.x - ox) * invx;
    const float t_bx = (a.w - ox) * invx;
    const float t_ay = (a.y - oy) * invy;
    const float t_by = (b.x - oy) * invy;
    const float t_az = (a.z - oz) * invz;
    const float t_bz = (b.y - oz) * invz;
    const float t0 = jmax(jmax(jmin(t_ax, t_bx), jmin(t_ay, t_by)),
                          jmin(t_az, t_bz));
    const float t1 = jmin(jmin(jmax(t_ax, t_bx), jmax(t_ay, t_by)),
                          jmax(t_az, t_bz));
    const float dist = t0 > 0.f ? t0 : t1;
    const bool hit =
        (t1 >= t0) && (dist > 0.f) && (jmax(t0, 0.f) <= bt * p.eps1);
    const int enc = meta.y;
    if (hit && enc >= 0) {
      const int leaf = enc >> 6;
      const float* __restrict__ blk = P + (long long)leaf * 128;
      const float slotbase = (float)BVH_SLOT * (float)leaf;
      for (int s = 0; s < p.leaf_size; ++s) {
        const auto g = [blk, cols, s](int a) {
          return __ldg(blk + (a / 4) * cols + (a % 4) * BVH_SLOT + s);
        };
        float u, v;
        const float tm = woop_slot_test(g, ox, oy, oz, dx, dy, dz, p.t_min,
                                        p.graze, u, v);
        const float em = g(15);
        if (slot_replaces(tm, em, bt, be, p.eps1)) {
          bt = tm;
          bi = slotbase + (float)s;
          bu = u;
          bv = v;
          be = em;
        }
      }
    }
    node = (hit && enc < 0) ? node + 1 : meta.x;
  }

  int slot = (int)bi;
  slot = slot < 0 ? 0 : (slot >= p.n_tid ? p.n_tid - 1 : slot);
  p.t_out[i] = bt;
  p.tri_out[i] = __ldg(p.tid + slot);
  p.u_out[i] = bu;
  p.v_out[i] = bv;
}

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int trt_bvh_intersect(const float* rays, const float* node_box,
                                 const int* node_meta, const float* p,
                                 const int* tid, long long p_cols,
                                 float* t_out, int* tri_out, float* u_out,
                                 float* v_out, int R, int n_nodes,
                                 int leaf_size, int n_tid, float t_min,
                                 float graze, float eps1, void* stream) {
  if (R <= 0) return 0;
  BvhParams prm{rays, (const float4*)node_box, (const int2*)node_meta, p, tid,
                p_cols, t_out, tri_out, u_out, v_out, R, n_nodes, leaf_size,
                n_tid, t_min, graze, eps1};
  const dim3 block(128), grid((unsigned)((R + 127) / 128));
  bvh_intersect_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(prm);
  return (int)cudaGetLastError();
}
