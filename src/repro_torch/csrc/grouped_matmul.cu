// Grouped member GEMM on Hopper: out[g] = valid[g] * (lhs[g] @ rhs[g]),
// lhs (G, M, K), rhs (G, K, N) -> out (G, M, N), f32 accumulation.
//
// Replaces the Pallas TPU kernel repro/kernels/grouped_matmul.py
// (grouped_matmul_pallas -> _grouped_matmul_kernel). The cohort engine's
// dense layers call it once per layer and direction (forward, dW, dx) for a
// whole wave of members: group g is member g.
//
// Bound: at the main path's fc0 shape (G = 4, M = 64, K = 4096, N = 384) the
// product is 2 G M K N = 805 MFLOP against 29.75 MB moved, about 27
// flop/byte, above the FP32 ridge point of the card (67 TFLOP/s over 3.35
// TB/s = 20 flop/byte): FP32-operation-bound on the CUDA cores. Parity runs
// in IEEE fp32 (no TF32), so the tensor cores are not used.
//
// Design: one CUDA block per (group, 64 x 64 output tile); grid (N tiles,
// M tiles, G). 256 threads, each owning a 4 x 4 register tile of outputs
// (rows ty + 16 i, columns tx + 16 j). The K loop walks 16-deep slabs in
// order: each slab of lhs and rhs is staged in shared memory (converted to
// f32 on load, zero outside the ragged M/K/N edges, so the padding adds
// exact zeros) and folded into the accumulators with fmaf in the fixed
// order k = 0 .. K-1. There is no split-K and no atomic, so repeated runs
// give identical bits. The operands are read through their strides, so the
// backward's transposed views (w.transpose(1, 2), x.transpose(1, 2)) need
// no copy; the loader lets neighbouring threads walk whichever of the two
// tile axes has unit stride, so global loads coalesce in either layout.
// `valid` is applied at the store: a group with valid == 0 skips the K loop
// and writes exact zeros. The output is contiguous (G, M, N), f32, or bf16
// when both inputs are bf16 (the promoted dtype).
//
// Simple and correct first: no wgmma, no TMA, no cp.async pipelining. At
// G = 4 the fc0 forward has only 4 * 1 * 6 = 24 blocks for 132 SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 16;
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename LT, typename RT, typename OT>
__global__ void __launch_bounds__(kThreads)
grouped_matmul_kernel(const LT* __restrict__ lhs, const RT* __restrict__ rhs,
                      const float* __restrict__ valid, OT* __restrict__ out,
                      int M, int K, int N, long long lsg, long long lsm,
                      long long lsk, long long rsg, long long rsk,
                      long long rsn) {
  // +1 column of padding keeps the transposed-layout stores off one bank
  __shared__ float As[kBK][kBM + 1];  // As[k][m]
  __shared__ float Bs[kBK][kBN + 1];  // Bs[k][n]
  const int g = blockIdx.z;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  OT* o = out + (long long)g * M * N;
  const float v = valid == nullptr ? 1.0f : valid[g];
  if (v == 0.0f) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int m = m0 + ty + 16 * i;
        const int n = n0 + tx + 16 * j;
        if (m < M && n < N) store(o + (long long)m * N + n, 0.0f);
      }
    }
    return;
  }
  const LT* A = lhs + (long long)g * lsg;
  const RT* B = rhs + (long long)g * rsg;
  const bool a_k_fast = lsk == 1;   // lhs rows contiguous: threads walk k
  const bool b_n_fast = rsn == 1 || rsk != 1;  // rhs rows contiguous: walk n

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // lhs slab: kBM x kBK = 1024 elements, 4 per thread
#pragma unroll
    for (int r = 0; r < (kBM * kBK) / kThreads; ++r) {
      const int e = tid + r * kThreads;
      const int kk = a_k_fast ? e % kBK : e / kBM;
      const int mm = a_k_fast ? e / kBK : e % kBM;
      const int gm = m0 + mm, gk = k0 + kk;
      As[kk][mm] = (gm < M && gk < K)
                       ? to_f32(A[(long long)gm * lsm + (long long)gk * lsk])
                       : 0.0f;
    }
    // rhs slab: kBK x kBN = 1024 elements, 4 per thread
#pragma unroll
    for (int r = 0; r < (kBK * kBN) / kThreads; ++r) {
      const int e = tid + r * kThreads;
      const int kk = b_n_fast ? e / kBN : e % kBK;
      const int nn = b_n_fast ? e % kBN : e / kBK;
      const int gk = k0 + kk, gn = n0 + nn;
      Bs[kk][nn] = (gk < K && gn < N)
                       ? to_f32(B[(long long)gk * rsk + (long long)gn * rsn])
                       : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + ty + 16 * i;
      const int n = n0 + tx + 16 * j;
      if (m < M && n < N) store(o + (long long)m * N + n, acc[i][j] * v);
    }
  }
}

template <typename LT, typename RT, typename OT>
int launch(const void* lhs, const void* rhs, const void* valid, void* out,
           int G, int M, int K, int N, const long long* ls,
           const long long* rs, cudaStream_t stream) {
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, G);
  grouped_matmul_kernel<LT, RT, OT><<<grid, kThreads, 0, stream>>>(
      (const LT*)lhs, (const RT*)rhs, (const float*)valid, (OT*)out, M, K, N,
      ls[0], ls[1], ls[2], rs[0], rs[1], rs[2]);
  return (int)cudaGetLastError();
}

}  // namespace

// lhs (G, M, K) and rhs (G, K, N) are device pointers read through the
// element strides ls = (g, m, k) and rs = (g, k, n); dtype codes: 0 = f32,
// 1 = bf16. valid is a device pointer to G f32 values or null. out is a
// contiguous (G, M, N) buffer, bf16 when both inputs are bf16, else f32.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int grouped_matmul(const void* lhs, const void* rhs,
                              const void* valid, void* out, int G, int M,
                              int K, int N, long long lsg, long long lsm,
                              long long lsk, long long rsg, long long rsk,
                              long long rsn, int lhs_bf16, int rhs_bf16,
                              void* stream) {
  if (G < 1 || M < 1 || N < 1 || K < 0 || G > 65535 ||
      (M + kBM - 1) / kBM > 65535)
    return (int)cudaErrorInvalidValue;
  const long long ls[3] = {lsg, lsm, lsk};
  const long long rs[3] = {rsg, rsk, rsn};
  cudaStream_t s = (cudaStream_t)stream;
  typedef __nv_bfloat16 bf;
  if (!lhs_bf16 && !rhs_bf16)
    return launch<float, float, float>(lhs, rhs, valid, out, G, M, K, N, ls, rs, s);
  if (lhs_bf16 && !rhs_bf16)
    return launch<bf, float, float>(lhs, rhs, valid, out, G, M, K, N, ls, rs, s);
  if (!lhs_bf16 && rhs_bf16)
    return launch<float, bf, float>(lhs, rhs, valid, out, G, M, K, N, ls, rs, s);
  return launch<bf, bf, bf>(lhs, rhs, valid, out, G, M, K, N, ls, rs, s);
}
