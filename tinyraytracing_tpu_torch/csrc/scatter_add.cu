// Fixed-order scatter-adds for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (tinyraytracing_tpu_torch/ops/kernels.py builds
// this file with nvcc).
//
// No TPU kernel is replaced: the JAX package leaves its scatter-adds to
// XLA, whose TPU scatter runs in one fixed order, so a render and a
// gradient repeat bitwise there. index_add_ on a CUDA tensor adds with
// atomics in whatever order the warps arrive, so the port's images and
// cotangents varied in their last bits from run to run. These two kernels
// add in an order that depends on the data alone. The wrapper
// (ops/scatter.py) sorts the destination rows stably first
// (torch.sort(stable=True), deterministic), and passes the sorted rows
// `srow` with the permutation `perm` back to the source positions, so the
// positions of one row form a run [s, e) of srow in ascending source
// position.
//
// 1. trt_scatter_rows (the images: the queue's and render_regen's). One
//    thread per run adds the run's values into dst one at a time, in
//    ascending source position: bitwise what index_add_ computes on the
//    CPU, which adds in index order. A run is at most spp long there (a
//    pixel has spp paths), so the chains are short. Rows outside
//    [0, keep) are skipped (the renderers' drop rows, which nobody reads).
//
// 2. trt_scatter_fixed_level (the cotangents behind ops/lookup.gather_rows).
//    A run can hold every lane of a bounce (262,144 values into one
//    material row), far too long for one thread's chain. The order: a
//    run's values, in ascending source position, are cut into chunks of K
//    counted from the run's start; each chunk is summed left to right; the
//    chunk sums are cut and summed the same way, level after level, until
//    one value is left, which is written to the run's row of the zeroed
//    output. It depends on the run's values alone. Level l keeps the run's
//    partial sums at positions [s, s + ceil(n_r / K^l)) of a buffer of n
//    rows, inside the run's own range, so no prefix sum is needed: one
//    launch per level, a thread per position, ceil(log_K(n)) levels at
//    most (4 at 262,144 values, K = 32). Level 0 also finds each
//    position's run by binary search in srow and keeps [s, e) for the
//    later levels.
//
// Both are bound by memory: each source value is read once, each output
// row written once, plus the sorted rows and the permutation (and, for the
// levels, n/K partial sums a level). The float adds are __fadd_rn: exact
// IEEE single adds, never contracted. ops/scatter.py's plain versions
// repeat these adds in the same order.

#include <cuda_runtime.h>

#define SCATTER_BLOCK 256

// rows: dst element (r, c) at dst[r * d_row + c * d_col]; source element
// (p, c) at src[p * s_row + c * s_col].
__global__ void scatter_rows_kernel(float* __restrict__ dst,
                                    const int* __restrict__ srow,
                                    const long long* __restrict__ perm,
                                    const float* __restrict__ src, int n,
                                    int C, int keep, long long d_row,
                                    long long d_col, long long s_row,
                                    long long s_col) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int r = srow[i];
  if (r < 0 || r >= keep) return;
  if (i > 0 && srow[i - 1] == r) return;       // not the run's first
  int e = i + 1;
  while (e < n && srow[e] == r) ++e;
  for (int c = 0; c < C; ++c) {
    float* out = dst + (long long)r * d_row + (long long)c * d_col;
    float acc = *out;
    for (int j = i; j < e; ++j)
      acc = __fadd_rn(acc, src[perm[j] * s_row + (long long)c * s_col]);
    *out = acc;
  }
}

// first position of srow (sorted, n entries) holding a value >= v
__device__ __forceinline__ int lower_bound(const int* srow, int n, int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (srow[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// One level of the fixed-order reduction. Level 0 reads src through perm
// (C contiguous floats a row) and records each position's run [s, e);
// level l > 0 reads the partial sums `in` of level l-1. kpow = K^l.
__global__ void scatter_fixed_level_kernel(
    const int* __restrict__ srow, const long long* __restrict__ perm,
    const float* __restrict__ src, const float* __restrict__ in,
    float* __restrict__ out, float* __restrict__ dst, int* __restrict__ run_s,
    int* __restrict__ run_e, int n, int C, int K, int level, long long kpow,
    int n_rows) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  int s, e;
  if (level == 0) {
    const int v = srow[p];
    s = lower_bound(srow, n, v);
    e = lower_bound(srow, n, v + 1);
    if (v == 0x7fffffff) e = n;
    run_s[p] = s;
    run_e[p] = e;
  } else {
    s = run_s[p];
    e = run_e[p];
  }
  const long long nr = e - s;
  const long long m_in = (nr + kpow - 1) / kpow;   // partial sums on entry
  if (level > 0 && m_in == 1) return;              // finished earlier
  const long long m_out = (m_in + K - 1) / K;
  const long long q = p - s;
  if (q >= m_out) return;
  const long long first = q * K;
  const int len = (int)(m_in - first < K ? m_in - first : K);
  const int row = srow[s];
  const bool last = m_out == 1;
  if (last && (row < 0 || row >= n_rows)) return;
  for (int c = 0; c < C; ++c) {
    float acc;
    if (level == 0) {
      acc = src[perm[s + first] * C + c];
      for (int t = 1; t < len; ++t)
        acc = __fadd_rn(acc, src[perm[s + first + t] * C + c]);
    } else {
      acc = in[(s + first) * C + c];
      for (int t = 1; t < len; ++t)
        acc = __fadd_rn(acc, in[(s + first + t) * C + c]);
    }
    if (last)
      dst[(long long)row * C + c] = acc;
    else
      out[(s + q) * C + c] = acc;
  }
}

static unsigned blocks(int n) {
  return (unsigned)((n + SCATTER_BLOCK - 1) / SCATTER_BLOCK);
}

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int trt_scatter_rows(float* dst, const int* srow,
                                const long long* perm, const float* src,
                                int n, int C, int keep, long long d_row,
                                long long d_col, long long s_row,
                                long long s_col, void* stream) {
  if (n <= 0) return 0;
  scatter_rows_kernel<<<blocks(n), SCATTER_BLOCK, 0, (cudaStream_t)stream>>>(
      dst, srow, perm, src, n, C, keep, d_row, d_col, s_row, s_col);
  return (int)cudaGetLastError();
}

// Runs every level; buf0 and buf1 hold n * C floats each, run_s and run_e
// n ints. dst (n_rows * C floats) must be zeroed. Returns
// cudaGetLastError() after the last launch, or the first launch's error.
extern "C" int trt_scatter_fixed(float* dst, const int* srow,
                                 const long long* perm, const float* src,
                                 float* buf0, float* buf1, int* run_s,
                                 int* run_e, int n, int C, int K, int n_rows,
                                 void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  long long kpow = 1;
  for (int level = 0;; ++level) {
    float* out = (level & 1) ? buf1 : buf0;
    const float* in = (level & 1) ? buf0 : buf1;
    scatter_fixed_level_kernel<<<blocks(n), SCATTER_BLOCK, 0, st>>>(
        srow, perm, src, in, out, dst, run_s, run_e, n, C, K, level, kpow,
        n_rows);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
    kpow *= K;
    if (kpow >= n) break;          // every run fits in one chunk of level+1's input
  }
  return 0;
}
