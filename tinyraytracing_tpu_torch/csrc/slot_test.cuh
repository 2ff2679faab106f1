// The Woop-plane slot test and the repl rule of the JAX walk kernels, in one
// place for trace.cu, bvh_intersect.cu and slot_intersect.cu (their plain
// twin is tinyraytracing_tpu_torch/ops/slot_test.py). Bitwise equality with
// the plain versions rests on this arithmetic: every kernel is built with
// --fmad=false and the expressions keep the JAX association order.
#pragma once

// n.d along w for the ray direction d and the slot whose attribute a (0..15,
// the P layout [ax ay az bx | by bz cx cy | cz ou ov ow | gx gy gz em]) is
// g(a).
template <class G>
__device__ __forceinline__ float woop_ldw(const G& g, float dx, float dy,
                                          float dz) {
  return dx * g(6) + dy * g(7) + dz * g(8);
}

// The JAX kernel's inverse where(ldw == 0, 0, 1) / where(ldw == 0, 1, ldw).
// (0 / 1 is 0, and 1 / ldw correctly rounded is rcp.rn: slot_intersect.cu
// computes the same bits with rcp.rn's fast path. In the walk kernels
// __frcp_rn here made them 2-10% slower than the division on an H100.)
__device__ __forceinline__ float woop_inv(float ldw) {
  return (ldw == 0.f ? 0.f : 1.f) / (ldw == 0.f ? 1.f : ldw);
}

// The plane half of the slot test of the ray (o, d), given its ldw and
// inv: returns the plane's t, and in ok whether the plane accepts it
// (|n.d| >= graze, ldw != 0, t >= t_min).
template <class G>
__device__ __forceinline__ float woop_plane_t(const G& g, float ox, float oy,
                                              float oz, float dx, float dy,
                                              float dz, float ldw, float inv,
                                              float t_min, float graze,
                                              bool& ok) {
  const float cx = g(6), cy = g(7), cz = g(8), ow = g(11);
  const float gx = g(12), gy = g(13), gz = g(14);
  const float low = ox * cx + oy * cy + oz * cz + ow;
  const float t = -low * inv;
  const float ndd = dx * gx + dy * gy + dz * gz;
  ok = (fabsf(ndd) >= graze) && (ldw != 0.f) && (t >= t_min);
  return t;
}

// The barycentric half: u, v of the plane hit at t, and whether it lies
// inside the triangle.
template <class G>
__device__ __forceinline__ bool woop_inside(const G& g, float ox, float oy,
                                            float oz, float dx, float dy,
                                            float dz, float t, float& u,
                                            float& v) {
  const float ax = g(0), ay = g(1), az = g(2), bx = g(3);
  const float by = g(4), bz = g(5), ou = g(9), ov = g(10);
  u = (ox * ax + oy * ay + oz * az + ou) + t * (dx * ax + dy * ay + dz * az);
  v = (ox * bx + oy * by + oz * bz + ov) + t * (dx * bx + dy * by + dz * bz);
  return (u >= 0.f) && (v >= 0.f) && (u + v <= 1.f);
}

// The whole slot test: t where the slot is accepted, else 3e38; writes the
// barycentrics u, v either way.
template <class G>
__device__ __forceinline__ float woop_slot_test(const G& g, float ox, float oy,
                                                float oz, float dx, float dy,
                                                float dz, float t_min,
                                                float graze, float& u,
                                                float& v) {
  bool ok;
  const float ldw = woop_ldw(g, dx, dy, dz);
  const float t = woop_plane_t(g, ox, oy, oz, dx, dy, dz, ldw, woop_inv(ldw),
                               t_min, graze, ok);
  const bool in = woop_inside(g, ox, oy, oz, dx, dy, dz, t, u, v);
  return ok && in ? t : 3.0e38f;
}

// Whether a slot at tm with emissive flag em replaces the best (bt, be):
// closer outside the relative tie band; inside it, emissive over
// non-emissive. eps1 = float(1 + tie_eps).
__device__ __forceinline__ bool slot_replaces(float tm, float em, float bt,
                                              float be, float eps1) {
  const bool near = (tm <= bt * eps1) && (bt <= tm * eps1) && (tm < 3.0e38f);
  return (!near && (tm < bt)) || (near && (em > 0.5f) && (be < 0.5f));
}
