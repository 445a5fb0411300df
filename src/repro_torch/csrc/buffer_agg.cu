// FedPSA Eq. 20 apply on Hopper: out[i] = g[i] + sum_{l<L} w[l] * U[l, i].
//
// Replaces the Pallas TPU kernel repro/kernels/buffer_agg.py
// (buffer_agg_pallas -> _buffer_agg_kernel).
//
// Bound: HBM. The function reads the (L, d) update slab and g once and
// writes out once, (L + 2) * d * 4 bytes, with 2 flops per slab element;
// at L = 5 that is 0.29 flop/byte, far below the card's ridge point.
//
// Design: a grid-stride elementwise loop over d. The L <= 256 weights are
// staged once per block in shared memory; each thread keeps one f32
// accumulator per element and folds the L slab rows in the fixed order
// l = 0 .. L-1 with fmaf, so the result does not depend on the launch
// shape. Consecutive threads read consecutive addresses of each slab row
// (coalesced). The output is a fresh buffer: in-flight clients hold the
// previous global vector as their dispatch snapshot, so it must not change.
// Simple and correct first: no vectorised loads, no TMA.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxL = 256;
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;  // 8 resident blocks on each of 132 SMs

__global__ void buffer_agg_kernel(const float* __restrict__ w,
                                  const float* __restrict__ g,
                                  const float* __restrict__ u,
                                  float* __restrict__ out, int L,
                                  long long d) {
  __shared__ float ws[kMaxL];
  for (int l = threadIdx.x; l < L; l += blockDim.x) ws[l] = w[l];
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < d;
       i += stride) {
    float acc = g[i];
    for (int l = 0; l < L; ++l) acc = fmaf(ws[l], u[(long long)l * d + i], acc);
    out[i] = acc;
  }
}

}  // namespace

// All pointers are device pointers to contiguous f32 data: w (L,), g (d,),
// u (L, d), out (d,). Launches on `stream` and returns cudaGetLastError().
extern "C" int buffer_agg_f32(const void* w, const void* g, const void* u,
                              void* out, int L, long long d, void* stream) {
  if (L < 1 || L > kMaxL || d < 1) return (int)cudaErrorInvalidValue;
  long long want = (d + kThreads - 1) / kThreads;
  int blocks = (int)(want < kMaxBlocks ? want : kMaxBlocks);
  buffer_agg_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)w, (const float*)g, (const float*)u, (float*)out, L, d);
  return (int)cudaGetLastError();
}
