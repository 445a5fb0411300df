// Flash attention backward on Hopper: dQ, dK, dV of online-softmax GQA
// attention, causal (top-left: key j is seen by query i iff j <= i) or
// bidirectional, from the forward's saved row log-sum-exp.
// q (B, Sq, H, hd), k and v (B, Sk, Hkv, hd), o and dout (B, Sq, H, hd), all
// f32 or all bf16, read through their element strides; lse f32 (B, H, Sq).
// Out: dq (B, Sq, H, hd), dk and dv (B, Sk, Hkv, hd), contiguous, in the
// inputs' dtype; all arithmetic in f32 on the CUDA cores.
//
// Replaces: the TPU side has no backward kernel. The reference trains
// through JAX's autodiff of models/layers.py chunked_attention (its forward
// is the function of repro/kernels/flash_attention.py); this kernel is the
// gradient of the port's forward kernel (csrc/flash_attention.cu), bound to
// it by kernels/flash_attention.py's FlashAttention autograd function.
//
// Math (FA-2): P = exp(s * scale - lse) with s = q.k (masked pairs 0),
// D_i = sum_d dO_id O_id, dS = P o (dO V^T - D), dV = P^T dO,
// dK = scale dS^T Q, dQ = scale dS K; for GQA the group's G = H / Hkv query
// heads add into their kv head's dK and dV.
//
// Bound: five products of 2 hd FLOP per unmasked (query, key) pair and head
// (QK^T, dO V^T, P^T dO, dS^T Q, dS K). At the full-width training shape
// (B = 2, S = 2048, H = 24, Hkv = 8, hd = 128, causal) that is 1.29e11 FLOP:
// 0.13 ms at the bf16 tensor-core peak (989 TFLOP/s) and 1.9 ms at the fp32
// CUDA-core peak (67 TFLOP/s) that this design runs on; the bytes (q, k, v,
// o, dO read once, dq, dk, dv written once: 88 MB in bf16) take 26 us.
//
// Design (simple first; a wgmma/TMA redesign is later work):
//   two kernels, launched in order on the caller's stream, no float atomics
//   anywhere, every sum in a fixed order, so repeated runs give the same
//   bits.
//   dq_kernel: one block per (b, h, 64-query tile) (32 at hd 256). Its
//     prologue computes D_i for its rows from O and dO and stores it for
//     the second kernel. It loops over the key tiles its queries can see,
//     recomputes S and dP for the (query, key) tile pair, forms dS, and
//     adds dS K into its dQ accumulators.
//   dkdv_kernel: one block per (b, kv head, 64-key tile). It holds its K and
//     V tiles, loops over the G query heads of its group and, for each, over
//     the query tiles that can see its keys (causal: from the tile holding
//     query k0), recomputes P and dS and adds P^T dO and dS^T Q. So the GQA
//     sum stays inside one block.
//   Tiles live in shared memory as f32, rows padded by one float so that the
//   lanes of a warp read distinct banks; hd is a template bucket (32, 64,
//   128, 256) zero-filled past hd (exact). 256 threads as a 16 x 16 grid:
//   for the score tile a thread holds a (tile / 16) x (tile / 16) register
//   micro-tile (4 x 4 at 64), rows ty + 16 a and columns tx + 16 b; for the
//   outputs (tile / 16) rows x (HD / 16) columns. The dQ pass recomputes S
//   and dP (seven products in all where the bound counts five), the price
//   of keeping dQ free of atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <int HD>
struct Cfg {
  static constexpr int BT = HD <= 128 ? 64 : 32;  // rows of a query/key tile
  static constexpr int LD = HD + 1;               // padded row of a q/k tile
  static constexpr int LP = BT + 1;               // padded row of P and dS
  static constexpr int TS = BT / 16;              // score micro-tile edge
  static constexpr int TC = HD / 16;              // output columns a thread
  // dkdv: K, V, Q, dO tiles, P, dS, lse, D; dq: the same less P
  static constexpr int kDkdvBytes =
      (4 * BT * LD + 2 * BT * LP + 2 * BT) * 4;
  static constexpr int kDqBytes = (4 * BT * LD + BT * LP + 2 * BT) * 4;
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

struct Strides {
  long long b, s, h, d;
};

template <typename T>
struct Args {
  const T *q, *k, *v, *o, *dout;
  const float* lse;
  float* D;
  T *dq, *dk, *dv;
  int Sq, Sk, H, Hkv, hd, causal;
  float scale;
  Strides sq, sk, sv, so, sdo;
};

// rows [r0, r0 + BT) of head h of a (B, S, heads, hd) tensor into a padded
// f32 tile; zero past S and hd
template <int HD, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          const Strides& st_, int b, int h,
                                          int r0, int S, int hd) {
  using C = Cfg<HD>;
  const T* base = src + (long long)b * st_.b + (long long)h * st_.h;
  for (int e = threadIdx.x; e < C::BT * HD; e += kThreads) {
    const int r = e / HD, c = e % HD;
    float x = 0.0f;
    if (r0 + r < S && c < hd)
      x = ld(base + (long long)(r0 + r) * st_.s + (long long)c * st_.d);
    dst[r * C::LD + c] = x;
  }
}

// The (query tile q0, key tile k0) pair: P (if sP) and dS into shared
// memory, from the Q, dO, K, V tiles and the rows' lse and D
template <int HD>
__device__ __forceinline__ void scores(const float* sQ, const float* sdO,
                                       const float* sK, const float* sV,
                                       const float* sL, const float* sD,
                                       float* sP, float* sdS, int q0, int k0,
                                       int Sq, int Sk, int causal,
                                       float scale) {
  using C = Cfg<HD>;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float s[C::TS][C::TS], dp[C::TS][C::TS];
#pragma unroll
  for (int a = 0; a < C::TS; ++a)
#pragma unroll
    for (int c = 0; c < C::TS; ++c) s[a][c] = dp[a][c] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float qa[C::TS], oa[C::TS], kb[C::TS], vb[C::TS];
#pragma unroll
    for (int a = 0; a < C::TS; ++a) {
      qa[a] = sQ[(ty + 16 * a) * C::LD + d];
      oa[a] = sdO[(ty + 16 * a) * C::LD + d];
      kb[a] = sK[(tx + 16 * a) * C::LD + d];
      vb[a] = sV[(tx + 16 * a) * C::LD + d];
    }
#pragma unroll
    for (int a = 0; a < C::TS; ++a)
#pragma unroll
      for (int c = 0; c < C::TS; ++c) {
        s[a][c] = fmaf(qa[a], kb[c], s[a][c]);
        dp[a][c] = fmaf(oa[a], vb[c], dp[a][c]);
      }
  }
#pragma unroll
  for (int a = 0; a < C::TS; ++a) {
    const int i = ty + 16 * a, qi = q0 + i;
#pragma unroll
    for (int c = 0; c < C::TS; ++c) {
      const int j = tx + 16 * c, kj = k0 + j;
      const bool ok = qi < Sq && kj < Sk && (!causal || kj <= qi);
      const float p = ok ? expf(s[a][c] * scale - sL[i]) : 0.0f;
      if (sP != nullptr) sP[i * C::LP + j] = p;
      sdS[i * C::LP + j] = p * (dp[a][c] - sD[i]);
    }
  }
}

template <int HD, typename T>
__global__ void __launch_bounds__(kThreads)
dq_kernel(Args<T> A) {
  using C = Cfg<HD>;
  extern __shared__ float sm[];
  float* sQ = sm;
  float* sdO = sQ + C::BT * C::LD;
  float* sK = sdO + C::BT * C::LD;
  float* sV = sK + C::BT * C::LD;
  float* sdS = sV + C::BT * C::LD;
  float* sL = sdS + C::BT * C::LP;
  float* sD = sL + C::BT;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * C::BT;  // long tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (A.H / A.Hkv);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  // prologue: D_i = sum_d dO_id O_id (O staged in the K buffer), and lse
  load_tile<HD>(sQ, A.q, A.sq, b, h, q0, A.Sq, A.hd);
  load_tile<HD>(sdO, A.dout, A.sdo, b, h, q0, A.Sq, A.hd);
  load_tile<HD>(sK, A.o, A.so, b, h, q0, A.Sq, A.hd);
  __syncthreads();
  const long long row0 = ((long long)b * A.H + h) * A.Sq + q0;
  if (tid < C::BT) {
    float acc = 0.0f;
    for (int d = 0; d < HD; ++d)
      acc = fmaf(sdO[tid * C::LD + d], sK[tid * C::LD + d], acc);
    const bool live = q0 + tid < A.Sq;
    sD[tid] = acc;
    sL[tid] = live ? A.lse[row0 + tid] : 0.0f;
    if (live) A.D[row0 + tid] = acc;
  }

  float dq[C::TS][C::TC];
#pragma unroll
  for (int a = 0; a < C::TS; ++a)
#pragma unroll
    for (int c = 0; c < C::TC; ++c) dq[a][c] = 0.0f;

  int nt = (A.Sk + C::BT - 1) / C::BT;
  if (A.causal) nt = min(nt, min(q0 + C::BT - 1, A.Sq - 1) / C::BT + 1);
  for (int t = 0; t < nt; ++t) {
    const int k0 = t * C::BT;
    __syncthreads();  // the previous tile's readers (and D's) are done
    load_tile<HD>(sK, A.k, A.sk, b, hk, k0, A.Sk, A.hd);
    load_tile<HD>(sV, A.v, A.sv, b, hk, k0, A.Sk, A.hd);
    __syncthreads();
    scores<HD>(sQ, sdO, sK, sV, sL, sD, nullptr, sdS, q0, k0, A.Sq, A.Sk,
               A.causal, A.scale);
    __syncthreads();
    for (int j = 0; j < C::BT; ++j) {
      float ds[C::TS], kc[C::TC];
#pragma unroll
      for (int a = 0; a < C::TS; ++a) ds[a] = sdS[(ty + 16 * a) * C::LP + j];
#pragma unroll
      for (int c = 0; c < C::TC; ++c) kc[c] = sK[j * C::LD + tx + 16 * c];
#pragma unroll
      for (int a = 0; a < C::TS; ++a)
#pragma unroll
        for (int c = 0; c < C::TC; ++c) dq[a][c] = fmaf(ds[a], kc[c], dq[a][c]);
    }
  }

#pragma unroll
  for (int a = 0; a < C::TS; ++a) {
    const int qi = q0 + ty + 16 * a;
    if (qi >= A.Sq) continue;
    T* out = A.dq + (((long long)b * A.Sq + qi) * A.H + h) * A.hd;
#pragma unroll
    for (int c = 0; c < C::TC; ++c) {
      const int col = tx + 16 * c;
      if (col < A.hd) st(out + col, dq[a][c] * A.scale);
    }
  }
}

template <int HD, typename T>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(Args<T> A) {
  using C = Cfg<HD>;
  extern __shared__ float sm[];
  float* sK = sm;
  float* sV = sK + C::BT * C::LD;
  float* sQ = sV + C::BT * C::LD;
  float* sdO = sQ + C::BT * C::LD;
  float* sP = sdO + C::BT * C::LD;
  float* sdS = sP + C::BT * C::LP;
  float* sL = sdS + C::BT * C::LP;
  float* sD = sL + C::BT;

  const int k0 = blockIdx.x * C::BT;  // early key tiles see the most queries
  const int hk = blockIdx.y, b = blockIdx.z;
  const int G = A.H / A.Hkv;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  load_tile<HD>(sK, A.k, A.sk, b, hk, k0, A.Sk, A.hd);
  load_tile<HD>(sV, A.v, A.sv, b, hk, k0, A.Sk, A.hd);

  float dk[C::TS][C::TC], dv[C::TS][C::TC];
#pragma unroll
  for (int a = 0; a < C::TS; ++a)
#pragma unroll
    for (int c = 0; c < C::TC; ++c) dk[a][c] = dv[a][c] = 0.0f;

  const int nq = (A.Sq + C::BT - 1) / C::BT;
  const int first = A.causal ? k0 / C::BT : 0;  // the tile holding query k0
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const long long row_h = ((long long)b * A.H + h) * A.Sq;
    for (int qt = first; qt < nq; ++qt) {
      const int q0 = qt * C::BT;
      __syncthreads();  // the previous pair's readers are done
      load_tile<HD>(sQ, A.q, A.sq, b, h, q0, A.Sq, A.hd);
      load_tile<HD>(sdO, A.dout, A.sdo, b, h, q0, A.Sq, A.hd);
      if (tid < C::BT) {
        const bool live = q0 + tid < A.Sq;
        sL[tid] = live ? A.lse[row_h + q0 + tid] : 0.0f;
        sD[tid] = live ? A.D[row_h + q0 + tid] : 0.0f;
      }
      __syncthreads();
      scores<HD>(sQ, sdO, sK, sV, sL, sD, sP, sdS, q0, k0, A.Sq, A.Sk,
                 A.causal, A.scale);
      __syncthreads();
      for (int i = 0; i < C::BT; ++i) {
        float p[C::TS], ds[C::TS], oc[C::TC], qc[C::TC];
#pragma unroll
        for (int a = 0; a < C::TS; ++a) {
          p[a] = sP[i * C::LP + ty + 16 * a];
          ds[a] = sdS[i * C::LP + ty + 16 * a];
        }
#pragma unroll
        for (int c = 0; c < C::TC; ++c) {
          oc[c] = sdO[i * C::LD + tx + 16 * c];
          qc[c] = sQ[i * C::LD + tx + 16 * c];
        }
#pragma unroll
        for (int a = 0; a < C::TS; ++a)
#pragma unroll
          for (int c = 0; c < C::TC; ++c) {
            dv[a][c] = fmaf(p[a], oc[c], dv[a][c]);
            dk[a][c] = fmaf(ds[a], qc[c], dk[a][c]);
          }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < C::TS; ++a) {
    const int kj = k0 + ty + 16 * a;
    if (kj >= A.Sk) continue;
    const long long off = (((long long)b * A.Sk + kj) * A.Hkv + hk) * A.hd;
#pragma unroll
    for (int c = 0; c < C::TC; ++c) {
      const int col = tx + 16 * c;
      if (col < A.hd) {
        st(A.dk + off + col, dk[a][c] * A.scale);
        st(A.dv + off + col, dv[a][c]);
      }
    }
  }
}

template <int HD, typename T>
int launch(const Args<T>& a, int B, cudaStream_t stream) {
  using C = Cfg<HD>;
  static bool ready = false;  // the attributes are set once per instantiation
  if (!ready) {
    cudaError_t e = cudaFuncSetAttribute(
        dq_kernel<HD, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        C::kDqBytes);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(dkdv_kernel<HD, T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::kDkdvBytes);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  dim3 gq((a.Sq + C::BT - 1) / C::BT, a.H, B);
  dq_kernel<HD, T><<<gq, kThreads, C::kDqBytes, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dim3 gk((a.Sk + C::BT - 1) / C::BT, a.Hkv, B);
  dkdv_kernel<HD, T><<<gk, kThreads, C::kDkdvBytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int run(const void* q, const void* k, const void* v, const void* o,
        const void* dout, const float* lse, float* D, void* dq, void* dk,
        void* dv, int B, int Sq, int Sk, int H, int Hkv, int hd,
        const long long* s, int causal, float scale, cudaStream_t stream) {
  Args<T> a;
  a.q = (const T*)q;
  a.k = (const T*)k;
  a.v = (const T*)v;
  a.o = (const T*)o;
  a.dout = (const T*)dout;
  a.lse = lse;
  a.D = D;
  a.dq = (T*)dq;
  a.dk = (T*)dk;
  a.dv = (T*)dv;
  a.Sq = Sq;
  a.Sk = Sk;
  a.H = H;
  a.Hkv = Hkv;
  a.hd = hd;
  a.causal = causal;
  a.scale = scale;
  Strides* st_[5] = {&a.sq, &a.sk, &a.sv, &a.so, &a.sdo};
  for (int i = 0; i < 5; ++i)
    *st_[i] = Strides{s[4 * i], s[4 * i + 1], s[4 * i + 2], s[4 * i + 3]};
  if (hd <= 32) return launch<32, T>(a, B, stream);
  if (hd <= 64) return launch<64, T>(a, B, stream);
  if (hd <= 128) return launch<128, T>(a, B, stream);
  return launch<256, T>(a, B, stream);
}

}  // namespace

// q, k, v, o, dout: device pointers read through their element strides,
// (b, s, h, d) for each in that order (20 values in `strides`); lse: f32
// (B, H, Sq) contiguous; D: f32 (B, H, Sq) scratch the first kernel writes
// and the second reads; dq (B, Sq, H, hd), dk and dv (B, Sk, Hkv, hd):
// contiguous outputs in the inputs' dtype (0 = f32, 1 = bf16). Launches two
// kernels on `stream`; returns the first non-zero cudaGetLastError().
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const float* lse,
                                   float* D, void* dq, void* dk, void* dv,
                                   int B, int Sq, int Sk, int H, int Hkv,
                                   int hd, const long long* strides,
                                   int causal, float scale, int bf16,
                                   void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || Hkv < 1 || H % Hkv != 0 || hd < 1 ||
      hd > 256 || H > 65535 || Hkv > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return run<__nv_bfloat16>(q, k, v, o, dout, lse, D, dq, dk, dv, B, Sq, Sk,
                              H, Hkv, hd, strides, causal, scale, st);
  return run<float>(q, k, v, o, dout, lse, D, dq, dk, dv, B, Sq, Sk, H, Hkv,
                    hd, strides, causal, scale, st);
}
