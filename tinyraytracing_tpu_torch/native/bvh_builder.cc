// tinypt native SAH BVH builder.
//
// Split semantics match the Python builder (ops/bvh.py) and therefore the
// reference algorithm (RayTracingOnCPU/bvh.cpp:16-144: centroid-sorted
// ranges, full-sweep surface-area cost over all three axes, leaf when
// <= leaf_size, +/-pad on stored AABBs), but runs the classic
// O(N log N) formulation: one stable sort per axis up front, stable
// in-place partition of the three orderings at every node.
//
// Output is the flattened preorder skip-link layout consumed by
// ops/traverse.py. C API only (loaded via ctypes; no pybind11 in the
// image).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Vec3 {
  double x, y, z;
};

inline Vec3 vmin(const Vec3& a, const Vec3& b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline Vec3 vmax(const Vec3& a, const Vec3& b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}
inline double surface(const Vec3& lo, const Vec3& hi) {
  double dx = hi.x - lo.x, dy = hi.y - lo.y, dz = hi.z - lo.z;
  return 2.0f * (dx * dy + dx * dz + dy * dz);
}

struct Builder {
  int64_t n;
  int leaf_size;
  float pad;
  std::vector<Vec3> lo, hi;      // per-triangle bounds
  std::vector<double> cx, cy, cz; // centroids (double: tie order must
  // match the float64 numpy builder exactly)
  // three orderings, partitioned in place as we descend
  std::vector<int64_t> order[3];
  std::vector<int64_t> scratch;
  std::vector<uint8_t> in_left;
  // sweep scratch
  std::vector<Vec3> pre_lo, pre_hi, suf_lo, suf_hi;

  // outputs
  float* nmin;
  float* nmax;
  int32_t* start;
  int32_t* count;
  int32_t* skip;
  int64_t* perm;
  int64_t n_nodes = 0;
  int64_t perm_off = 0;

  void node_bounds(int64_t l, int64_t r, Vec3* out_lo, Vec3* out_hi) const {
    Vec3 a = lo[order[0][l]], b = hi[order[0][l]];
    for (int64_t i = l + 1; i <= r; ++i) {
      a = vmin(a, lo[order[0][i]]);
      b = vmax(b, hi[order[0][i]]);
    }
    *out_lo = a;
    *out_hi = b;
  }

  // returns (axis, nl) of the best SAH split of [l, r]
  void best_split(int64_t l, int64_t r, int* best_axis, int64_t* best_nl) {
    const int64_t m = r - l + 1;
    double best_cost = 1.0e300;
    *best_axis = 0;
    *best_nl = m / 2;
    for (int axis = 0; axis < 3; ++axis) {
      const auto& ord = order[axis];
      pre_lo[0] = lo[ord[l]];
      pre_hi[0] = hi[ord[l]];
      for (int64_t i = 1; i < m; ++i) {
        pre_lo[i] = vmin(pre_lo[i - 1], lo[ord[l + i]]);
        pre_hi[i] = vmax(pre_hi[i - 1], hi[ord[l + i]]);
      }
      suf_lo[m - 1] = lo[ord[r]];
      suf_hi[m - 1] = hi[ord[r]];
      for (int64_t i = m - 2; i >= 0; --i) {
        suf_lo[i] = vmin(suf_lo[i + 1], lo[ord[l + i]]);
        suf_hi[i] = vmax(suf_hi[i + 1], hi[ord[l + i]]);
      }
      for (int64_t i = 0; i < m - 1; ++i) {
        double cost = surface(pre_lo[i], pre_hi[i]) * double(i + 1) +
                      surface(suf_lo[i + 1], suf_hi[i + 1]) * double(m - 1 - i);
        if (cost < best_cost) {
          best_cost = cost;
          *best_axis = axis;
          *best_nl = i + 1;
        }
      }
    }
  }

  // stable-partition the two other orderings by left-membership
  void partition(int64_t l, int64_t r, int axis, int64_t nl) {
    const auto& win = order[axis];
    for (int64_t i = l; i <= r; ++i) in_left[win[i]] = (i < l + nl);
    for (int o = 0; o < 3; ++o) {
      if (o == axis) continue;
      auto& ord = order[o];
      int64_t a = 0, b = 0;
      const int64_t m = r - l + 1;
      for (int64_t i = l; i <= r; ++i) {
        if (in_left[ord[i]])
          scratch[a++] = ord[i];
        else
          scratch[nl + (b++)] = ord[i];
      }
      std::memcpy(&ord[l], scratch.data(), sizeof(int64_t) * m);
    }
  }

  void build(int64_t l, int64_t r) {
    // explicit stack: (l, r, post_node) — post entries patch skip links
    struct Frame {
      int64_t l, r, node;
      bool post;
    };
    std::vector<Frame> stack;
    stack.push_back({l, r, -1, false});
    while (!stack.empty()) {
      Frame f = stack.back();
      stack.pop_back();
      if (f.post) {
        skip[f.node] = int32_t(n_nodes);
        continue;
      }
      const int64_t node = n_nodes++;
      Vec3 blo, bhi;
      node_bounds(f.l, f.r, &blo, &bhi);
      nmin[node * 3 + 0] = float(blo.x - pad);
      nmin[node * 3 + 1] = float(blo.y - pad);
      nmin[node * 3 + 2] = float(blo.z - pad);
      nmax[node * 3 + 0] = float(bhi.x + pad);
      nmax[node * 3 + 1] = float(bhi.y + pad);
      nmax[node * 3 + 2] = float(bhi.z + pad);
      stack.push_back({0, 0, node, true});

      const int64_t m = f.r - f.l + 1;
      if (m <= leaf_size) {
        start[node] = int32_t(perm_off);
        count[node] = int32_t(m);
        for (int64_t i = f.l; i <= f.r; ++i) perm[perm_off++] = order[0][i];
        continue;
      }
      start[node] = 0;
      count[node] = 0;
      int axis;
      int64_t nl;
      best_split(f.l, f.r, &axis, &nl);
      partition(f.l, f.r, axis, nl);
      // preorder: left first
      stack.push_back({f.l + nl, f.r, -1, false});
      stack.push_back({f.l, f.l + nl - 1, -1, false});
    }
  }
};

}  // namespace

extern "C" int64_t tinypt_build_bvh(const double* tri, int64_t n,
                                    int32_t leaf_size, float pad, float* nmin,
                                    float* nmax, int32_t* start, int32_t* count,
                                    int32_t* skip, int64_t* perm) {
  if (n <= 0) return 0;
  Builder b;
  b.n = n;
  b.leaf_size = leaf_size;
  b.pad = pad;
  b.nmin = nmin;
  b.nmax = nmax;
  b.start = start;
  b.count = count;
  b.skip = skip;
  b.perm = perm;

  b.lo.resize(n);
  b.hi.resize(n);
  b.cx.resize(n);
  b.cy.resize(n);
  b.cz.resize(n);
  for (int64_t i = 0; i < n; ++i) {
    const double* t = tri + i * 9;
    Vec3 a{t[0], t[1], t[2]}, c{t[3], t[4], t[5]}, d{t[6], t[7], t[8]};
    b.lo[i] = vmin(a, vmin(c, d));
    b.hi[i] = vmax(a, vmax(c, d));
    b.cx[i] = (t[0] + t[3] + t[6]) / 3.0;
    b.cy[i] = (t[1] + t[4] + t[7]) / 3.0;
    b.cz[i] = (t[2] + t[5] + t[8]) / 3.0;
  }
  for (int axis = 0; axis < 3; ++axis) {
    b.order[axis].resize(n);
    for (int64_t i = 0; i < n; ++i) b.order[axis][i] = i;
    const double* key = axis == 0 ? b.cx.data() : axis == 1 ? b.cy.data() : b.cz.data();
    std::stable_sort(b.order[axis].begin(), b.order[axis].end(),
                     [key](int64_t x, int64_t y) { return key[x] < key[y]; });
  }
  b.scratch.resize(n);
  b.in_left.resize(n);
  b.pre_lo.resize(n);
  b.pre_hi.resize(n);
  b.suf_lo.resize(n);
  b.suf_hi.resize(n);

  b.build(0, n - 1);
  return b.n_nodes;
}
