// The Woop-plane slot test and the repl rule of the JAX walk kernels, in one
// place for trace.cu, bvh_intersect.cu and slot_intersect.cu (their plain
// twin is tinyraytracing_tpu_torch/ops/slot_test.py). Bitwise equality with
// the plain versions rests on this arithmetic: every kernel is built with
// --fmad=false and the expressions keep the JAX association order.
#pragma once

// Slot test of the ray (o, d) against the slot whose attribute a (0..15, the
// P layout [ax ay az bx | by bz cx cy | cz ou ov ow | gx gy gz em]) is g(a).
// Returns t where the slot is accepted (|n.d| >= graze, t >= t_min, inside
// the triangle), else 3e38; writes the barycentrics u, v either way.
template <class G>
__device__ __forceinline__ float woop_slot_test(const G& g, float ox, float oy,
                                                float oz, float dx, float dy,
                                                float dz, float t_min,
                                                float graze, float& u,
                                                float& v) {
  const float ax = g(0), ay = g(1), az = g(2), bx = g(3);
  const float by = g(4), bz = g(5), cx = g(6), cy = g(7);
  const float cz = g(8), ou = g(9), ov = g(10), ow = g(11);
  const float gx = g(12), gy = g(13), gz = g(14);
  const float ldw = dx * cx + dy * cy + dz * cz;
  const float low = ox * cx + oy * cy + oz * cz + ow;
  const float inv = (ldw == 0.f ? 0.f : 1.f) / (ldw == 0.f ? 1.f : ldw);
  const float t = -low * inv;
  u = (ox * ax + oy * ay + oz * az + ou) + t * (dx * ax + dy * ay + dz * az);
  v = (ox * bx + oy * by + oz * bz + ov) + t * (dx * bx + dy * by + dz * bz);
  const float ndd = dx * gx + dy * gy + dz * gz;
  const bool ok = (fabsf(ndd) >= graze) && (ldw != 0.f) && (t >= t_min) &&
                  (u >= 0.f) && (v >= 0.f) && (u + v <= 1.f);
  return ok ? t : 3.0e38f;
}

// Whether a slot at tm with emissive flag em replaces the best (bt, be):
// closer outside the relative tie band; inside it, emissive over
// non-emissive. eps1 = float(1 + tie_eps).
__device__ __forceinline__ bool slot_replaces(float tm, float em, float bt,
                                              float be, float eps1) {
  const bool near = (tm <= bt * eps1) && (bt <= tm * eps1) && (tm < 3.0e38f);
  return (!near && (tm < bt)) || (near && (em > 0.5f) && (be < 0.5f));
}
