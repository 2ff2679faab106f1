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
// early-out always on, the Woop-plane slot test and the repl rule
// (slot_test.cuh) in slot order, the slot id carried as the float
// 32 * leaf + s. Build with --fmad=false: FMA contraction would move t in
// the last ulp and flip decisions inside the tie band.
//
// The layout (ops/bvh_intersect.py::bvh_records, built once per scene from
// the JAX-identical PackedLeaves):
//  - one 32-byte node record per node, [x0 y0 z0 x1 | y1 z1 link enc] with
//    the last two as int bits: enc = leaf_id * 64 + count for a leaf, -1
//    for an interior node; link = the skip link of an interior node, the
//    first slot record of a leaf (a leaf's skip link is always the next
//    node in preorder). Two 16-byte loads from one 32-byte sector;
//  - one 64-byte slot record per OCCUPIED slot, its 16 attributes in the P
//    order [ax ay az bx | by bz cx cy | cz ou ov ow | gx gy gz em], a
//    leaf's records contiguous. Four 16-byte loads per slot.
// The TPU layout tested every slot up to leaf_size with 16 scalar loads
// from 16 lines 32 floats apart. Pad slots are all-zero rows whose test
// gives 3e38, which never replaces (slot_replaces needs tm < bt <= 3e38 or
// tm < 3e38), so testing only the occupied slots is bitwise the same; and
// woop_slot_test never reads the carry, so the loads and tests of a group
// of slots can all run before the carry updates, which stay in slot order.
//
// The walk. Rays of a warp take different paths, and a lane that tests a
// leaf makes the lanes still at interior nodes wait (and the other way
// round). So the walk runs in two loops: the node loop carries every lane
// to its next hit leaf and HOLDS it, untested, walking on past it while
// other active lanes of the warp hold none, up to four held leaves; then
// the leaf loop tests the held leaves in preorder, the warp's lanes
// together. That is exact: leaves are still tested in preorder, and a
// lane walking past a held leaf uses an older, larger bt, so it visits a
// superset of the nodes the one-leaf-at-a-time walk visits. A node that
// walk would have culled lies (with every triangle below it) beyond
// bt * (1 + tie_eps) for the bt of that moment, and bt only shrinks, so
// the extra leaves' slot tests never replace the carry, by the packet
// argument above.
//
// What bounds it on an H100: latency. A dispatch of 65,536 rays is 512
// blocks of 128 threads, ~15 warps per SM, too few to hide a walk's chain
// of dependent L2 loads and the lanes' divergence. The layout cuts the
// loads per step (node: 2 instead of 3; slot: 4 instead of 16; no pad
// slots), a group of slots' records is loaded before any is tested, and
// the two loops keep a warp's lanes testing leaves together. Tried on the
// card and left out: prefetching both successor nodes and
// NaN-propagating hardware min/max (no gain); groups of 1, 2 or 8 slots,
// blocks of 64 or 256 threads, holding up to 2, 3 or 6 leaves at leaf 8,
// and persistent lanes that fetch the next ray from a global counter
// (fewer resident warps: slower).

#include <cuda_runtime.h>

#include "slot_test.cuh"

#define BVH_SLOT 32
#define BVH_BLOCK 128
#define BVH_GROUP 4  // slot records loaded together

// NaN-propagating min / max, as jnp.minimum / jnp.maximum and torch's
// (fminf / fmaxf would drop a NaN operand)
__device__ __forceinline__ float jmin(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float jmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

struct BvhParams {
  const float* rays;     // (6, R): ox oy oz dx dy dz
  const float4* nodes;   // (N, 8) node records as 2 float4 each
  const float4* slots;   // (n_records, 16) slot records as 4 float4 each
  const int* tid;        // (n_tid,) slot -> triangle
  float* t_out;
  int* tri_out;
  float* u_out;
  float* v_out;
  int R, n_nodes, n_tid;
  float t_min, graze, eps1;  // eps1 = float(1 + tie_eps)
};

struct Ray {
  float ox, oy, oz, dx, dy, dz, invx, invy, invz;
};

struct Best {
  float t, slot, u, v, em;
};

// Whether the ray enters the node's box (the slab test with the tie-band
// early-out) and the node's link and leaf word.
__device__ __forceinline__ bool node_test(const BvhParams& p, int node,
                                          const Ray& r, float bt, int& link,
                                          int& enc) {
  const float4 a = __ldg(p.nodes + 2 * (long long)node);
  const float4 b = __ldg(p.nodes + 2 * (long long)node + 1);
  const float t_ax = (a.x - r.ox) * r.invx;
  const float t_bx = (a.w - r.ox) * r.invx;
  const float t_ay = (a.y - r.oy) * r.invy;
  const float t_by = (b.x - r.oy) * r.invy;
  const float t_az = (a.z - r.oz) * r.invz;
  const float t_bz = (b.y - r.oz) * r.invz;
  const float t0 = jmax(jmax(jmin(t_ax, t_bx), jmin(t_ay, t_by)),
                        jmin(t_az, t_bz));
  const float t1 = jmin(jmin(jmax(t_ax, t_bx), jmax(t_ay, t_by)),
                        jmax(t_az, t_bz));
  const float dist = t0 > 0.f ? t0 : t1;
  link = __float_as_int(b.z);
  enc = __float_as_int(b.w);
  return (t1 >= t0) && (dist > 0.f) && (jmax(t0, 0.f) <= bt * p.eps1);
}

// The slot tests of one leaf (leaf word enc, first record first), its
// records loaded BVH_GROUP at a time before any is tested; the carry
// updated in slot order.
__device__ __forceinline__ void leaf_test(const BvhParams& p, int enc,
                                          int first, const Ray& r, Best& best) {
  const int cnt = enc & 63;
  const float slotbase = (float)BVH_SLOT * (float)(enc >> 6);
  const float4* rec = p.slots + 4 * (long long)first;
  for (int s0 = 0; s0 < cnt; s0 += BVH_GROUP) {
    float4 q[BVH_GROUP][4];
#pragma unroll
    for (int g = 0; g < BVH_GROUP; ++g)
      if (s0 + g < cnt) {
#pragma unroll
        for (int k = 0; k < 4; ++k) q[g][k] = __ldg(rec + 4 * (s0 + g) + k);
      }
#pragma unroll
    for (int g = 0; g < BVH_GROUP; ++g) {
      if (s0 + g >= cnt) break;
      const float f[16] = {q[g][0].x, q[g][0].y, q[g][0].z, q[g][0].w,
                           q[g][1].x, q[g][1].y, q[g][1].z, q[g][1].w,
                           q[g][2].x, q[g][2].y, q[g][2].z, q[g][2].w,
                           q[g][3].x, q[g][3].y, q[g][3].z, q[g][3].w};
      float u, v;
      const float tm =
          woop_slot_test([&f](int k) { return f[k]; }, r.ox, r.oy, r.oz, r.dx,
                         r.dy, r.dz, p.t_min, p.graze, u, v);
      if (slot_replaces(tm, f[15], best.t, best.em, p.eps1)) {
        best = Best{tm, slotbase + (float)(s0 + g), u, v, f[15]};
      }
    }
  }
}

__global__ void __launch_bounds__(BVH_BLOCK) bvh_intersect_kernel(BvhParams p) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.R) return;
  const long long R = p.R;
  const float INF = 3.0e38f;

  Ray r;
  r.ox = p.rays[i];
  r.oy = p.rays[R + i];
  r.oz = p.rays[2 * R + i];
  r.dx = p.rays[3 * R + i];
  r.dy = p.rays[4 * R + i];
  r.dz = p.rays[5 * R + i];
  r.invx = (r.dx == 0.f ? INF : 1.f) / (r.dx == 0.f ? 1.f : r.dx);
  r.invy = (r.dy == 0.f ? INF : 1.f) / (r.dy == 0.f ? 1.f : r.dy);
  r.invz = (r.dz == 0.f ? INF : 1.f) / (r.dz == 0.f ? 1.f : r.dz);

  // The walk, in two loops (see the note at the top): the node loop runs
  // until every active lane of the warp holds a hit leaf, or this lane
  // holds four; then the held leaves are tested, in preorder.
  Best best{INF, 0.f, 0.f, 0.f, 0.f};
  int e0 = -1, f0 = 0, e1 = -1, f1 = 0, e2 = -1, f2 = 0, e3 = -1, f3 = 0;
  int node = 0;
  while (node < p.n_nodes) {
    while (node < p.n_nodes) {
      int link, enc;
      const bool hit = node_test(p, node, r, best.t, link, enc);
      if (enc < 0) {
        node = hit ? node + 1 : link;
      } else {
        ++node;  // a leaf's skip link
        if (hit) {
          if (e0 < 0) {
            e0 = enc, f0 = link;
          } else if (e1 < 0) {
            e1 = enc, f1 = link;
          } else if (e2 < 0) {
            e2 = enc, f2 = link;
          } else {
            e3 = enc, f3 = link;
            break;
          }
        }
      }
      if (__all_sync(__activemask(), e0 >= 0)) break;
    }
    if (e0 >= 0) leaf_test(p, e0, f0, r, best);
    if (e1 >= 0) leaf_test(p, e1, f1, r, best);
    if (e2 >= 0) leaf_test(p, e2, f2, r, best);
    if (e3 >= 0) leaf_test(p, e3, f3, r, best);
    e0 = e1 = e2 = e3 = -1;
  }

  int slot = (int)best.slot;
  slot = slot < 0 ? 0 : (slot >= p.n_tid ? p.n_tid - 1 : slot);
  p.t_out[i] = best.t;
  p.tri_out[i] = __ldg(p.tid + slot);
  p.u_out[i] = best.u;
  p.v_out[i] = best.v;
}

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int trt_bvh_intersect(const float* rays, const void* nodes,
                                 const float* slots, const int* tid,
                                 float* t_out, int* tri_out, float* u_out,
                                 float* v_out, int R, int n_nodes, int n_tid,
                                 float t_min, float graze, float eps1,
                                 void* stream) {
  if (R <= 0) return 0;
  BvhParams prm{rays, (const float4*)nodes, (const float4*)slots, tid,
                t_out, tri_out, u_out, v_out, R, n_nodes, n_tid,
                t_min, graze, eps1};
  const dim3 block(BVH_BLOCK), grid((unsigned)((R + BVH_BLOCK - 1) / BVH_BLOCK));
  bvh_intersect_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(prm);
  return (int)cudaGetLastError();
}
