// Fused Eq. 8 sensitivity + hashed Rademacher sketch on Hopper:
//
//   out[r] = (1/sqrt(k)) * sum_i sign_r(i) * |g_i*theta_i - 0.5*F_i*theta_i^2|
//   sign_r(i) = +1 iff top bit of pcg(seed ^ pcg((offset + i) * k + r)) is 0
//
// Replaces the Pallas TPU kernel repro/kernels/sens_sketch.py
// (sens_sketch_pallas -> _sens_sketch_kernel, hash _pcg). The (k x d)
// projection is never materialised and the d-sized sensitivity never
// leaves registers.
//
// Bound: the INT32 pipe, not HBM. Each element is read once (12 bytes:
// theta, g, F) but costs 2k PCG hashes. Per (element, row) the function
// needs 9 operations that only the INT32 pipe executes (shifts, LOP3s,
// LEA.HI; the outer hash's last shift and XOR are dead since only bit 31
// is read) plus 3 IMADs on the FMA pipe: 144 INT32 operations per element
// at the paper's k = 16. An H100 SXM SM issues 64 INT32 operations per
// clock against about 12.8 bytes of HBM per clock (3.35 TB/s over 132 SMs
// at 1.98 GHz), so one element costs ~2.3 clocks of INT32 pipe and under 1
// clock of memory. chip_smoke.py prints what the built loop issues.
//
// Design: two passes and no atomics, so repeated runs give identical bits
// (golden trajectories are replayed and compared across runs).
//   Pass 1: a grid that depends only on d. Each thread grid-strides over
//   elements, computes s, hashes the k signs and keeps k register
//   accumulators (k is a template parameter: 1, 4, 16 or 32, so the row
//   loop unrolls). A fixed-order block reduction (warp shuffle tree, then
//   the warps in order) writes one (k,) partial per block.
//   Pass 2: one block of k warps; warp r sums row r of the partials in a
//   fixed lane-strided order, reduces by shuffle and scales by 1/sqrt(k).
// `offset` shifts the hash to global indices so per-shard sketches of a
// split vector sum to the full sketch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ uint32_t pcg(uint32_t x) {
  uint32_t state = x * 747796405u + 2891336453u;
  uint32_t word = ((state >> ((state >> 28u) + 4u)) ^ state) * 277803737u;
  return (word >> 22u) ^ word;
}

template <int K>
__global__ void __launch_bounds__(kThreads)
sens_sketch_partial(const float* __restrict__ theta,
                    const float* __restrict__ g, const float* __restrict__ f,
                    float* __restrict__ partials, long long d, uint32_t seed,
                    uint32_t offset) {
  float acc[K];
#pragma unroll
  for (int r = 0; r < K; ++r) acc[r] = 0.f;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < d;
       i += stride) {
    const float t = theta[i];
    const float s = fabsf(g[i] * t - 0.5f * f[i] * (t * t));
    const uint32_t base = (offset + (uint32_t)i) * (uint32_t)K;
#pragma unroll
    for (int r = 0; r < K; ++r) {
      const uint32_t h = pcg(seed ^ pcg(base + (uint32_t)r));
      acc[r] += (h >> 31) ? -s : s;
    }
  }
  __shared__ float red[kWarps][K];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < K; ++r) {
    float v = acc[r];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) red[warp][r] = v;
  }
  __syncthreads();
  if (threadIdx.x < K) {
    float v = 0.f;
    for (int w = 0; w < kWarps; ++w) v += red[w][threadIdx.x];
    partials[(long long)blockIdx.x * K + threadIdx.x] = v;
  }
}

template <int K>
__global__ void sens_sketch_finish(const float* __restrict__ partials,
                                   float* __restrict__ out, int nblocks) {
  const int r = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float v = 0.f;
  for (int b = lane; b < nblocks; b += 32) v += partials[(long long)b * K + r];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if (lane == 0) out[r] = v / sqrtf((float)K);
}

template <int K>
int launch(const float* theta, const float* g, const float* f,
           float* partials, float* out, long long d, uint32_t seed,
           uint32_t offset, int nblocks, cudaStream_t stream) {
  sens_sketch_partial<K><<<nblocks, kThreads, 0, stream>>>(
      theta, g, f, partials, d, seed, offset);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sens_sketch_finish<K><<<1, 32 * K, 0, stream>>>(partials, out, nblocks);
  return (int)cudaGetLastError();
}

}  // namespace

// theta, g, f: (d,) contiguous f32 device data; partials: (nblocks, k) f32
// scratch; out: (k,) f32. Launches both passes on `stream` and returns the
// first non-zero cudaGetLastError(). k must be 1, 4, 16 or 32.
extern "C" int sens_sketch_f32(const void* theta, const void* g,
                               const void* f, void* partials, void* out,
                               long long d, uint32_t seed, uint32_t offset,
                               int k, int nblocks, void* stream) {
  if (d < 1 || nblocks < 1) return (int)cudaErrorInvalidValue;
  const float* t = (const float*)theta;
  const float* gg = (const float*)g;
  const float* ff = (const float*)f;
  float* p = (float*)partials;
  float* o = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (k) {
    case 1: return launch<1>(t, gg, ff, p, o, d, seed, offset, nblocks, s);
    case 4: return launch<4>(t, gg, ff, p, o, d, seed, offset, nblocks, s);
    case 16: return launch<16>(t, gg, ff, p, o, d, seed, offset, nblocks, s);
    case 32: return launch<32>(t, gg, ff, p, o, d, seed, offset, nblocks, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
