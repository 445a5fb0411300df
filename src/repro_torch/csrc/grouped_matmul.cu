// Grouped member GEMM on Hopper: out[g] = valid[g] * (lhs[g] @ rhs[g]),
// lhs (G, M, K), rhs (G, K, N) -> out (G, M, N), IEEE fp32 accumulation.
//
// Replaces the Pallas TPU kernel repro/kernels/grouped_matmul.py
// (grouped_matmul_pallas -> _grouped_matmul_kernel). The cohort engine's
// dense layers call it once per layer and direction (forward, dW, dx) for a
// whole wave of members: group g is member g.
//
// Bound: at the main path's fc0 shape (G = 4, M = 64, K = 4096, N = 384) the
// product is 2 G M K N = 805 MFLOP against 29.75 MB moved, about 27
// flop/byte, above the FP32 ridge point of the card (67 TFLOP/s over 3.35
// TB/s = 20 flop/byte): FP32-operation-bound on the CUDA cores, 12.0 us.
// Parity runs in IEEE fp32 (no TF32), so the tensor cores are not used.
//
// Design. The first design (one block per 64 x 64 output tile, loads then
// compute with nothing in flight) gave the fc0 forward 24 blocks for 132
// SMs and ~3 us per 16-deep K slab. Two changes:
// - Deterministic split-K. The caller picks S slices of `slice` K values
//   each (kernels/grouped_matmul.py split_k, from one group's M, N and K
//   alone, so a member's sums do not depend on G: enough blocks for two
//   per SM at 4 groups, each slice at least 256 deep, S = 1 when the tiles
//   fill the card). Pass
//   1 runs one block per (group, 64 x 64 tile, slice); with S > 1 it writes
//   the slice's f32 partial tile to a workspace (S, G, M, N), and pass 2
//   (splitk_reduce) sums the S partials in the fixed order s = 0 .. S-1,
//   applies `valid` and casts to the output dtype. With S = 1 pass 1 writes
//   the output itself. No atomics: repeated runs give identical bits.
// - cp.async double buffering. Each 32-deep K slab of both operands is
//   copied into shared memory with 16-byte cp.async.cg along whichever axis
//   of the operand has unit stride (zero-fill past the ragged M, N and
//   slice edges) while the previous slab is computed. The shared layout
//   follows that axis ([m][k] or [k][m] for lhs, [n][k] or [k][n] for
//   rhs; a template choice), so the backward's transposed views
//   (w.transpose(1, 2), x.transpose(1, 2)) are read with no copy. Operands
//   whose rows are not 16-byte aligned, or that have no unit-stride axis,
//   are staged by element-wise loads into the same layout.
// 256 threads, each owning 4 x 4 outputs (rows 4 ty + i; columns 4 tx + j,
// or tx + 16 j when rhs is k-contiguous), fmaf in the fixed order k =
// k_lo .. k_hi - 1 within a slice. A group with valid == 0 skips its blocks
// and is written as exact zeros (by pass 1 when S = 1, else by pass 2),
// whatever its operands hold. Inputs are f32 (the wrapper casts bf16); the
// output is f32, or bf16 when both inputs were bf16 (the promoted dtype).
// ptxas -v (sm_90a, f32 out): 92-122 registers and 34,816-36,864 bytes of
// static shared memory by layout, no spills, so two blocks share an SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 32;        // K slab depth
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int kPad = 4;        // floats of row padding; rows stay 16-byte aligned

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Shared slab of one operand, kBK deep and X wide (X = m for lhs, n for
// rhs). KC (the operand is k-contiguous in global memory): [x][k] rows of
// kBK + kPad floats; else [k][x] rows of X + kPad.
template <bool KC, int X>
struct Slab {
  static constexpr int kLd = (KC ? kBK : X) + kPad;
  static constexpr int kFloats = (KC ? X : kBK) * kLd;
  __device__ static __forceinline__ int at(int k, int x) {
    return KC ? x * kLd + k : k * kLd + x;
  }
};

// Stage K values [k0, k0 + kBK) x columns [x0, x0 + X) of an operand whose
// element (x, k) is p[x * sx + k * sk]; zero where k >= k_hi or x >= xn.
// vec: 16-byte cp.async of 4 floats along the unit-stride axis.
template <bool KC, int X>
__device__ __forceinline__ void load_slab(float* dst, const float* p,
                                          long long sx, long long sk, int x0,
                                          int xn, int k0, int k_hi, bool vec,
                                          int tid) {
  typedef Slab<KC, X> L;
  if (vec) {
    for (int e = tid; e < kBK * X / 4; e += kThreads) {
      const int x = KC ? e / (kBK / 4) : (e % (X / 4)) * 4;
      const int k = KC ? (e % (kBK / 4)) * 4 : e / (X / 4);
      const int gx = x0 + x, gk = k0 + k;
      const int n = KC ? (gx < xn ? k_hi - gk : 0) : (gk < k_hi ? xn - gx : 0);
      const int bytes = 4 * max(0, min(4, n));
      const float* src = bytes ? p + (long long)gx * sx + (long long)gk * sk : p;
      const uint32_t d =
          static_cast<uint32_t>(__cvta_generic_to_shared(dst + L::at(k, x)));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                   "l"(src), "r"(bytes)
                   : "memory");
    }
  } else {
    for (int e = tid; e < kBK * X; e += kThreads) {
      const int x = KC ? e / kBK : e % X;
      const int k = KC ? e % kBK : e / X;
      const int gx = x0 + x, gk = k0 + k;
      dst[L::at(k, x)] = (gx < xn && gk < k_hi)
                             ? p[(long long)gx * sx + (long long)gk * sk]
                             : 0.0f;
    }
  }
}

template <bool A_KC, bool B_KC, typename OT>
__global__ void __launch_bounds__(kThreads, 2)
grouped_matmul_kernel(const float* __restrict__ lhs,
                      const float* __restrict__ rhs,
                      const float* __restrict__ valid, OT* __restrict__ out,
                      float* __restrict__ ws, int G, int M, int K, int N,
                      long long lsg, long long lsm, long long lsk,
                      long long rsg, long long rsk, long long rsn, int slice,
                      int vec_a, int vec_b) {
  typedef Slab<A_KC, kBM> LA;
  typedef Slab<B_KC, kBN> LB;
  __shared__ __align__(16) float As[2][LA::kFloats];
  __shared__ __align__(16) float Bs[2][LB::kFloats];
  const int g = blockIdx.z % G;
  const int s = blockIdx.z / G;
  const int S = gridDim.z / G;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const float v = valid == nullptr ? 1.0f : valid[g];
  if (v == 0.0f) {
    if (S == 1) {
      OT* o = out + (long long)g * M * N;
      for (int e = tid; e < kBM * kBN; e += kThreads) {
        const int m = m0 + e / kBN, n = n0 + e % kBN;
        if (m < M && n < N) store(o + (long long)m * N + n, 0.0f);
      }
    }
    return;  // with S > 1, pass 2 writes the zeros
  }
  const float* A = lhs + (long long)g * lsg;
  const float* B = rhs + (long long)g * rsg;
  const int k_lo = s * slice;
  const int k_hi = min(K, k_lo + slice);
  const int nslab = k_hi > k_lo ? (k_hi - k_lo + kBK - 1) / kBK : 0;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  if (nslab > 0) {
    load_slab<A_KC, kBM>(As[0], A, lsm, lsk, m0, M, k_lo, k_hi, vec_a, tid);
    load_slab<B_KC, kBN>(Bs[0], B, rsn, rsk, n0, N, k_lo, k_hi, vec_b, tid);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int t = 0; t < nslab; ++t) {
    if (t + 1 < nslab) {
      const int k0 = k_lo + (t + 1) * kBK;
      load_slab<A_KC, kBM>(As[(t + 1) & 1], A, lsm, lsk, m0, M, k0, k_hi,
                           vec_a, tid);
      load_slab<B_KC, kBN>(Bs[(t + 1) & 1], B, rsn, rsk, n0, N, k0, k_hi,
                           vec_b, tid);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // slab t landed
    __syncthreads();
    const float* as = As[t & 1];
    const float* bs = Bs[t & 1];
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4], b[4];
      if (A_KC) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = as[LA::at(kk, 4 * ty + i)];
      } else {
        const float4 x = *reinterpret_cast<const float4*>(as + LA::at(kk, 4 * ty));
        a[0] = x.x; a[1] = x.y; a[2] = x.z; a[3] = x.w;
      }
      if (B_KC) {
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = bs[LB::at(kk, tx + 16 * j)];
      } else {
        const float4 x = *reinterpret_cast<const float4*>(bs + LB::at(kk, 4 * tx));
        b[0] = x.x; b[1] = x.y; b[2] = x.z; b[3] = x.w;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();  // slab t's stage is free for slab t + 2
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + 4 * ty + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + (B_KC ? tx + 16 * j : 4 * tx + j);
      if (n >= N) continue;
      const long long e = ((long long)g * M + m) * N + n;
      if (S == 1)
        store(out + e, acc[i][j] * v);
      else
        ws[(long long)s * G * M * N + e] = acc[i][j];
    }
  }
}

// Pass 2 of a split: out[e] = valid[g] * sum_{s = 0 .. S-1} ws[s][e], in
// that order; exact zeros where valid[g] == 0 (the workspace is not read).
template <typename OT>
__global__ void __launch_bounds__(256)
splitk_reduce(const float* __restrict__ ws, const float* __restrict__ valid,
              OT* __restrict__ out, int S, long long per_group,
              long long total) {
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    const float v = valid == nullptr ? 1.0f : valid[e / per_group];
    float acc = 0.0f;
    if (v != 0.0f) {
      for (int s = 0; s < S; ++s) acc += ws[(long long)s * total + e];
      acc *= v;
    }
    store(out + e, acc);
  }
}

// pass 1's grid: one block per (64 x 64 output tile, group, slice)
dim3 grid_of(int G, int M, int N, int S) {
  return dim3((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, G * S);
}

template <bool A_KC, bool B_KC, typename OT>
int launch(const float* lhs, const float* rhs, const float* valid, void* out,
           float* ws, int G, int M, int K, int N, const long long* ls,
           const long long* rs, int S, int slice, bool vec_a, bool vec_b,
           cudaStream_t stream) {
  grouped_matmul_kernel<A_KC, B_KC, OT>
      <<<grid_of(G, M, N, S), kThreads, 0, stream>>>(
      lhs, rhs, valid, (OT*)out, ws, G, M, K, N, ls[0], ls[1], ls[2], rs[0],
      rs[1], rs[2], slice, (int)vec_a, (int)vec_b);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return (int)err;
  const long long total = (long long)G * M * N;
  const long long blocks = (total + 255) / 256;
  splitk_reduce<OT><<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0,
                      stream>>>(ws, valid, (OT*)out, S, (long long)M * N,
                                total);
  return (int)cudaGetLastError();
}

template <typename OT>
int dispatch(bool a_kc, bool b_kc, const float* lhs, const float* rhs,
             const float* valid, void* out, float* ws, int G, int M, int K,
             int N, const long long* ls, const long long* rs, int S,
             int slice, bool vec_a, bool vec_b, cudaStream_t st) {
  if (a_kc && b_kc)
    return launch<true, true, OT>(lhs, rhs, valid, out, ws, G, M, K, N, ls, rs, S, slice, vec_a, vec_b, st);
  if (a_kc)
    return launch<true, false, OT>(lhs, rhs, valid, out, ws, G, M, K, N, ls, rs, S, slice, vec_a, vec_b, st);
  if (b_kc)
    return launch<false, true, OT>(lhs, rhs, valid, out, ws, G, M, K, N, ls, rs, S, slice, vec_a, vec_b, st);
  return launch<false, false, OT>(lhs, rhs, valid, out, ws, G, M, K, N, ls, rs, S, slice, vec_a, vec_b, st);
}

}  // namespace

// lhs (G, M, K) and rhs (G, K, N) are f32 device pointers read through the
// element strides ls = (g, m, k) and rs = (g, k, n). valid is a device
// pointer to G f32 values or null. out is a contiguous (G, M, N) buffer,
// bf16 if out_bf16 else f32. S slices of `slice` K values each (S * slice
// >= K); with S > 1, ws is an f32 workspace of S * G * M * N values.
// Launches pass 1 (and, for S > 1, pass 2) on `stream` and returns
// cudaGetLastError().
extern "C" int grouped_matmul(const float* lhs, const float* rhs,
                              const float* valid, void* out, float* ws, int G,
                              int M, int K, int N, long long lsg,
                              long long lsm, long long lsk, long long rsg,
                              long long rsk, long long rsn, int S, int slice,
                              int out_bf16, void* stream) {
  if (G < 1 || M < 1 || N < 1 || K < 0 || S < 1 || (long long)G * S > 65535 ||
      (M + kBM - 1) / kBM > 65535 || (long long)S * slice < K ||
      (S > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  const long long ls[3] = {lsg, lsm, lsk};
  const long long rs[3] = {rsg, rsk, rsn};
  // the shared layout follows each operand's unit-stride axis
  const bool a_kc = lsk == 1;
  const bool b_kc = rsk == 1 && rsn != 1;
  // cp.async: that axis has unit stride, the other strides keep 16-byte
  // alignment (slab and tile origins are multiples of 4)
  const bool vec_a = (uintptr_t)lhs % 16 == 0 && lsg % 4 == 0 &&
                     (a_kc ? lsm % 4 == 0 : lsm == 1 && lsk % 4 == 0);
  const bool vec_b = (uintptr_t)rhs % 16 == 0 && rsg % 4 == 0 &&
                     (b_kc ? rsn % 4 == 0 : rsn == 1 && rsk % 4 == 0);
  cudaStream_t st = (cudaStream_t)stream;
  if (out_bf16)
    return dispatch<__nv_bfloat16>(a_kc, b_kc, lhs, rhs, valid, out, ws, G, M,
                                   K, N, ls, rs, S, slice, vec_a, vec_b, st);
  return dispatch<float>(a_kc, b_kc, lhs, rhs, valid, out, ws, G, M, K, N, ls,
                         rs, S, slice, vec_a, vec_b, st);
}

// The number of blocks pass 1 launches for a (G, M, N) output in S slices,
// into *blocks. Returns a cudaError_t.
extern "C" int grouped_matmul_blocks(int G, int M, int N, int S,
                                     long long* blocks) {
  if (G < 1 || M < 1 || N < 1 || S < 1) return (int)cudaErrorInvalidValue;
  const dim3 g = grid_of(G, M, N, S);
  *blocks = (long long)g.x * g.y * g.z;
  return 0;
}
