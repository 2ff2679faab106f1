// Threefry-2x32-20 on lane planes for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (tinyraytracing_tpu_torch/ops/kernels.py
// builds this file with nvcc).
//
// No TPU kernel is replaced: the JAX package draws its per-path words with
// tinyraytracing_tpu/ops/rng.py's threefry2x32, which XLA fuses into one
// elementwise loop over the lanes. ops/rng.py's plain versions run the same
// chain as stock PyTorch ops on int64 planes (32-bit words, masked after
// every add and shift): eager PyTorch launches each of its ~1,050 ops of a
// loop iteration alone, and each one moves a whole int64 plane through
// device memory for one 32-bit operation. These kernels are XLA's fusion
// written out: one thread a lane, the words in uint32 registers, one
// launch a call, bitwise the plain versions (uint32 arithmetic wraps as the
// masked int64 chain does; a 24-bit integer converts to float exactly).
//
// 1. threefry_draws: ops/rng.py::bounce_uniforms(k0, k1, bounce, n). A
//    lane reads its two key words and its bounce (int64, taken modulo
//    2^32; one bounce word for every lane where the caller passes a 0-d
//    tensor: stride 0), runs ceil(n/2) blocks TF(key, (bounce, j)) and
//    writes uniform j to plane j: block j / 2's first word for even j, its
//    second for odd j, as (bits >> 8) * 2^-24. The n output planes are
//    separate allocations (the diff path's autograd keeps some of them
//    alive), passed by value in the launch's parameters, MAX_DRAWS at most:
//    a device array of pointers would cost a host-to-device copy a call.
// 2. threefry_path_keys: ops/rng.py::path_keys(key, path_id). A lane
//    reads its path id (int64, modulo 2^32), runs TF(master key,
//    (path_id, PATH_TAG)) with the master key words as launch arguments,
//    and writes the two words as int64, the lane state's dtype.
//
// What bounds them on this card (chip_smoke.py phase 2c counts the same):
// bytes. threefry_draws at n = 9 reads three int64 words and writes nine
// floats a lane, 60 B: 252 MB, 0.075 ms at 3.35 TB/s at 4,194,304 lanes.
// Its operations are 5 blocks of 77 32-bit integer operations (20 rounds
// of an add, a rotate by funnel shift and an xor; the counter plus the
// key; five key injections of 3), the key's parity word and 9 draws of 3
// (a shift, a conversion, a product): 414 a lane, 0.052 ms at the card's
// issue rate (132 SMs x 4 schedulers x 32 lanes at 1.98 GHz).
// threefry_path_keys moves 24 B a lane (0.030 ms) for one block (79
// operations, 0.010 ms). The design keeps every word in registers between
// the one read and the one write of each plane, so the bytes are the
// least a call can move, and issues nothing but the chain's own integer
// operations and the plane loads and stores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_DRAWS = 256;           // output planes a launch carries
constexpr uint32_t PARITY = 0x1BD11BDAu;
constexpr uint32_t PATH_TAG = 0x9E3779B9u;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// four rounds of threefry2x32 with the rotations R0..R3
template <int R0, int R1, int R2, int R3>
__device__ __forceinline__ void group(uint32_t& x0, uint32_t& x1) {
  x0 += x1; x1 = rotl(x1, R0) ^ x0;
  x0 += x1; x1 = rotl(x1, R1) ^ x0;
  x0 += x1; x1 = rotl(x1, R2) ^ x0;
  x0 += x1; x1 = rotl(x1, R3) ^ x0;
}

// Threefry-2x32-20 of the counter (x0, x1) under the key (k0, k1), in
// place: five groups of four rounds, a key injection after each group.
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1,
                                         uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ PARITY;
  x0 += k0; x1 += k1;
  group<13, 15, 26, 6>(x0, x1); x0 += k1; x1 += k2 + 1u;
  group<17, 29, 16, 24>(x0, x1); x0 += k2; x1 += k0 + 2u;
  group<13, 15, 26, 6>(x0, x1); x0 += k0; x1 += k1 + 3u;
  group<17, 29, 16, 24>(x0, x1); x0 += k1; x1 += k2 + 4u;
  group<13, 15, 26, 6>(x0, x1); x0 += k2; x1 += k0 + 5u;
}

// a 32-bit word -> a float32 uniform in [0, 1) with 24-bit resolution
__device__ __forceinline__ float uniform(uint32_t bits) {
  return __uint2float_rn(bits >> 8) * 0x1p-24f;
}

struct DrawParams {
  const long long* k0;
  const long long* k1;
  const long long* bounce;
  long long bounce_stride;         // 1: a word a lane; 0: one for all lanes
  int R, n;
  float* out[MAX_DRAWS];
};

// __grid_constant__: the planes are read from the parameter bank by index,
// with no copy of the struct into each thread's local memory
__global__ void __launch_bounds__(THREADS)
threefry_draws(const __grid_constant__ DrawParams p) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= p.R) return;
  const uint32_t k0 = (uint32_t)p.k0[i], k1 = (uint32_t)p.k1[i];
  const uint32_t b = (uint32_t)p.bounce[i * p.bounce_stride];
  for (int j = 0; j < p.n; j += 2) {
    uint32_t x0 = b, x1 = (uint32_t)(j / 2);
    threefry(k0, k1, x0, x1);
    p.out[j][i] = uniform(x0);
    if (j + 1 < p.n) p.out[j + 1][i] = uniform(x1);
  }
}

__global__ void __launch_bounds__(THREADS)
threefry_path_keys(const long long* __restrict__ path_id,
                   long long* __restrict__ k0_out,
                   long long* __restrict__ k1_out, uint32_t key0,
                   uint32_t key1, int R) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= R) return;
  uint32_t x0 = (uint32_t)path_id[i], x1 = PATH_TAG;
  threefry(key0, key1, x0, x1);
  k0_out[i] = (long long)x0;
  k1_out[i] = (long long)x1;
}

int blocks(int R) { return (R + THREADS - 1) / THREADS; }

}  // namespace

// n float32 planes of R uniforms (out: n device pointers, held by the
// caller's host array and copied into the launch's parameters) from the
// key planes k0, k1 and bounce (R int64 words, or one where
// bounce_stride is 0). Returns the launch's cudaError (0: launched).
extern "C" int trt_threefry_draws(const long long* k0, const long long* k1,
                                  const long long* bounce,
                                  long long bounce_stride,
                                  float* const* out, int n, int R,
                                  void* stream) {
  if (n < 1 || n > MAX_DRAWS || R < 0 || (bounce_stride != 0 && bounce_stride != 1))
    return (int)cudaErrorInvalidValue;
  if (R == 0) return 0;
  DrawParams p{};
  p.k0 = k0;
  p.k1 = k1;
  p.bounce = bounce;
  p.bounce_stride = bounce_stride;
  p.R = R;
  p.n = n;
  for (int j = 0; j < n; ++j) p.out[j] = out[j];
  threefry_draws<<<blocks(R), THREADS, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// The two int64 key planes of R path ids (int64) under the master key
// words (key0, key1). Returns the launch's cudaError (0: launched).
extern "C" int trt_threefry_path_keys(const long long* path_id, long long* k0,
                                      long long* k1, unsigned key0,
                                      unsigned key1, int R, void* stream) {
  if (R < 0) return (int)cudaErrorInvalidValue;
  if (R == 0) return 0;
  threefry_path_keys<<<blocks(R), THREADS, 0, (cudaStream_t)stream>>>(
      path_id, k0, k1, key0, key1, R);
  return (int)cudaGetLastError();
}
