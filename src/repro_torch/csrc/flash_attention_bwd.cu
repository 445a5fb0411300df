// Flash attention backward on Hopper: dQ, dK, dV of online-softmax GQA
// attention, causal (top-left: key j is seen by query i iff j <= i) or
// bidirectional, with an optional sliding window W (key j is seen by query
// i only if j > i - W; W = 0 means none), from the forward's saved row
// log-sum-exp.
// q (B, Sq, H, hd), k and v (B, Sk, Hkv, hd), o and dout (B, Sq, H, hd), all
// f32 or all bf16, read through their element strides; lse f32 (B, H, Sq).
// Out: dq (B, Sq, H, hd), dk and dv (B, Sk, Hkv, hd), contiguous, in the
// inputs' dtype.
//
// Replaces: the TPU side has no backward kernel. The reference trains
// through JAX's autodiff of models/layers.py chunked_attention (its forward
// is the function of repro/kernels/flash_attention.py); these kernels are
// the gradient of the port's forward kernels (csrc/flash_attention.cu),
// bound to them by kernels/flash_attention.py's FlashAttention autograd
// function.
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
// CUDA-core peak (67 TFLOP/s); the bytes (q, k, v, o, dO and the lse read
// once, dq, dk, dv written once: 134.6 MB in bf16) take 40 us.
//
// Two designs, chosen by dtype and hd (a documented dispatch, not a
// fallback: the wrapper picks one entry point and neither catches the
// other's failure). Both launch two kernels in order on the caller's
// stream, use no float atomics and sum everything in a fixed order, so
// repeated runs give the same bits; both recompute S and dP in the dQ pass
// (seven products where the bound counts five), the price of a dQ free of
// atomics. A two-pass dQ over key-tile partials would write and read a
// 64 x hd f32 partial per (query tile, key tile) pair, about 830 MB at the
// full-width shape (0.5 ms of HBM), against two more tensor-core products.
//
// bf16, hd <= 128 (entry flash_attention_bwd_tc; the full-width training
//   path): bwd_dq_tc and bwd_dkdv_tc on the tensor cores, built from the
//   forward's wgmma blocks (wgmma_bf16.cuh): tiles in shared memory in the
//   128-byte swizzle, hd zero-filled to its bucket (64, 128; exact), 16-byte
//   cp.async loads, 256 threads as two warpgroups of 64 rows each, one block
//   an SM (__launch_bounds__(256, 1): up to 255 registers a thread).
//   Arithmetic, the reference's own rounding (its forward rounds p to bf16
//   before PV, so its gradient of v reads a bf16 p): S = Q K^T and
//   dP = dO V^T are bf16 x bf16 products with f32 accumulation (mma_ss, both
//   operands K-major); P = 2^(s scale log2 e - lse log2 e) (ex2.approx) and
//   dS = P (dP - D) in f32 registers; P and dS are each rounded once to
//   bf16 as the register-A fragment of dV = P^T dO, dK = scale dS^T Q and
//   dQ = scale dS K (mma_rs, B MN-major); each output is rounded once to
//   bf16. Limit (kernels/flash_attention.py bwd_bf16_tc_limit): elementwise
//   against the float64 backward, 2^-8 |ref| + (2^-8 + (n + 2 hd + 16) u)
//   sum|terms| with u = 2^-24.
//   bwd_dq_tc: one block per (b, h, 128-query tile), grid (H, B, q tiles)
//     with the tile index reversed so the long causal tiles start first. Q
//     and dO stay resident (2 x 32 KB at hd 128); 64-key K and V tiles come
//     through a 2-stage ring, tile t + 1 in flight while tile t is computed.
//     The prologue computes D_i from O and dO in global memory (two threads
//     a row, one xor-shuffle) while the first copies fly, and stores it for
//     the second kernel. Per key tile: S and dP (16 m64n64k16), P, dS, then
//     dQ += dS K (8 more); causal tiles wholly above a warpgroup's rows are
//     skipped and the diagonal tile is masked.
//   bwd_dkdv_tc: one block per (b, kv head, 128-key tile), grid (Hkv, B,
//     key tiles) with key tile 0 first (under causal masking it sees every
//     query). K and V stay resident; the block loops over the group's G
//     query heads and, for each, over the 64-query tiles that see its keys
//     (causal: from the tile holding query k0), streaming Q, dO, lse and D
//     through a 2-stage ring. It computes the transposed tiles S^T = K Q^T
//     and dP^T = V dO^T, so P^T and dS^T sit in registers as the A operand
//     of dV += P^T dO and dK += dS^T Q; lse and D index the columns. The GQA
//     sum stays in the block, head then query tile: no atomics.
//   Registers at hd 128: dK and dV accumulators 64 each, S^T and dP^T 32
//   each (dq: dQ 64, S and dP 32 each). Shared memory: 132,608 bytes (dq)
//   and 133,120 (dkdv), set above 48 KB through cudaFuncSetAttribute once a
//   bucket; flash_attention_bwd_tc_attributes reports both kernels'
//   registers, spill bytes and shared memory. Not yet: TMA loads with a
//   producer warp, setmaxnreg, warpgroups ping-ponging so one's softmax
//   overlaps the other's products, 128-row tiles, hd 256.
//
// f32, and bf16 with hd > 128 (entry flash_attention_bwd; the parity mode
//   of the fed-lm golden): dq_kernel and dkdv_kernel, all arithmetic in f32
//   on the CUDA cores (capped by the fp32 peak), each output rounded once.
//   Limits: f32 within 2e-5 max(1, max|plain|) of the plain backward; bf16
//   (bwd_bf16_limit) 2^-8 |ref| + (n + 2 hd + 16) u sum|terms| against
//   float64. At hd 256 a 64 x 256 f32 dK and dV pair does not fit in the
//   registers beside the score tiles, so hd 256 stays here.
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
//   outputs (tile / 16) rows x (HD / 16) columns.
//
// The window (all four kernels). Masked pairs have P = 0, so a tile pair
// outside the band adds nothing and is skipped: the dQ kernels start at the
// first key tile holding a key > q0 - W (q0 the block's first query), and
// the dK/dV kernels stop at the query tile holding query k_last + W - 1
// (k_last the block's last key); the tensor-core kernels' warpgroups also
// skip the loaded tiles wholly outside their rows' band. A tile pair that
// straddles the band's lower edge is masked, as the diagonal is. The GQA
// sum keeps its order: head, then query tile.
//
// Rows that see no key (a window W > 0 and Sq >= Sk + W: queries i >=
// Sk + W - 1 have no key in their band). The reference masks a score to the
// constant -1e30, so such a row's output is the mean of v over the Sk keys
// and its gradient is p = 1/Sk on every key with dS = 0: nothing to dQ or
// dK, and do_i / Sk to every key's dV. Its lse cannot say so (in f32
// -1e30 + log Sk rounds to -1e30, which would give p = 1), so every kernel
// above masks these rows' pairs to P = 0, and a third kernel,
// empty_rows_dv, runs between the two passes when the wrapper passes the
// f32 scratch E (B, Hkv, hd): E[b, hk] = (sum over the group's heads, then
// over the empty rows in order, of dO) / Sk, one thread a column, a fixed
// order. The dK/dV kernels add E to each key's f32 dV before its one
// rounding.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_bf16.cuh"

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
  float* E;  // the empty rows' dV share (B, Hkv, hd), or null: none
  T *dq, *dk, *dv;
  int Sq, Sk, H, Hkv, hd, causal, window;
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
                                       int Sq, int Sk, int causal, int window,
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
      const bool ok = qi < Sq && kj < Sk && (!causal || kj <= qi) &&
                      (window <= 0 || kj > qi - window);
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
  const int t0 = A.window > 0 ? max(0, q0 - A.window + 1) / C::BT : 0;
  for (int t = t0; t < nt; ++t) {
    const int k0 = t * C::BT;
    __syncthreads();  // the previous tile's readers (and D's) are done
    load_tile<HD>(sK, A.k, A.sk, b, hk, k0, A.Sk, A.hd);
    load_tile<HD>(sV, A.v, A.sv, b, hk, k0, A.Sk, A.hd);
    __syncthreads();
    scores<HD>(sQ, sdO, sK, sV, sL, sD, nullptr, sdS, q0, k0, A.Sq, A.Sk,
               A.causal, A.window, A.scale);
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

  // query tiles: (causal) from the tile holding query k0, (window) to the
  // one holding query k_last + W - 1
  int nq = (A.Sq + C::BT - 1) / C::BT;
  if (A.window > 0)
    nq = min(nq, (min(k0 + C::BT - 1, A.Sk - 1) + A.window - 1) / C::BT + 1);
  const int first = A.causal ? k0 / C::BT : 0;
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
                 A.causal, A.window, A.scale);
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
        const float e =
            A.E != nullptr
                ? A.E[((long long)b * A.Hkv + hk) * A.hd + col]
                : 0.0f;
        st(A.dk + off + col, dk[a][c] * A.scale);
        st(A.dv + off + col, dv[a][c] + e);
      }
    }
  }
}

// E[b, hk, c] = (sum_g sum_{i >= i0} dO[b, i, hk G + g, c]) / Sk: the dV
// every key gets from the rows i >= i0 = Sk + W - 1, which see no key. One
// block per (kv head, b), one thread per column, the heads then the rows
// in order (no atomics, the same bits on every run).
template <typename T>
__global__ void __launch_bounds__(kThreads)
empty_rows_dv(Args<T> A, int i0) {
  const int hk = blockIdx.x, b = blockIdx.y, c = threadIdx.x;
  if (c >= A.hd) return;
  const int G = A.H / A.Hkv;
  float acc = 0.0f;
  for (int g = 0; g < G; ++g) {
    const T* p = A.dout + (long long)b * A.sdo.b +
                 (long long)(hk * G + g) * A.sdo.h + (long long)c * A.sdo.d;
    for (int i = i0; i < A.Sq; ++i) acc += ld(p + (long long)i * A.sdo.s);
  }
  A.E[((long long)b * A.Hkv + hk) * A.hd + c] = acc / (float)A.Sk;
}

// empty_rows_dv on `stream` when the wrapper passed E (hd <= kThreads)
template <typename T>
cudaError_t launch_empty_rows(const Args<T>& a, int B, cudaStream_t stream) {
  if (a.E == nullptr) return cudaSuccess;
  empty_rows_dv<T><<<dim3(a.Hkv, B), kThreads, 0, stream>>>(
      a, a.Sk + a.window - 1);
  return cudaGetLastError();
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
  if (e == cudaSuccess) e = launch_empty_rows(a, B, stream);
  if (e != cudaSuccess) return (int)e;
  dim3 gk((a.Sk + C::BT - 1) / C::BT, a.Hkv, B);
  dkdv_kernel<HD, T><<<gk, kThreads, C::kDkdvBytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int run(const void* q, const void* k, const void* v, const void* o,
        const void* dout, const float* lse, float* D, float* E, void* dq,
        void* dk, void* dv, int B, int Sq, int Sk, int H, int Hkv, int hd,
        const long long* s, int causal, int window, float scale,
        cudaStream_t stream) {
  Args<T> a;
  a.q = (const T*)q;
  a.k = (const T*)k;
  a.v = (const T*)v;
  a.o = (const T*)o;
  a.dout = (const T*)dout;
  a.lse = lse;
  a.D = D;
  a.E = E;
  a.dq = (T*)dq;
  a.dk = (T*)dk;
  a.dv = (T*)dv;
  a.Sq = Sq;
  a.Sk = Sk;
  a.H = H;
  a.Hkv = Hkv;
  a.hd = hd;
  a.causal = causal;
  a.window = window;
  a.scale = scale;
  Strides* st_[5] = {&a.sq, &a.sk, &a.sv, &a.so, &a.sdo};
  for (int i = 0; i < 5; ++i)
    *st_[i] = Strides{s[4 * i], s[4 * i + 1], s[4 * i + 2], s[4 * i + 3]};
  if (hd <= 32) return launch<32, T>(a, B, stream);
  if (hd <= 64) return launch<64, T>(a, B, stream);
  if (hd <= 128) return launch<128, T>(a, B, stream);
  return launch<256, T>(a, B, stream);
}


// ---- bf16, hd <= 128: the tensor-core kernels ------------------------------

namespace tc {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kVec = 1;    // flags: q, k, v, dout take the cp.async loaders
constexpr int kOVec = 2;   // o and dout rows read as 16-byte vectors

// 4-byte copy to shared memory, zero if bytes is 0
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

// bf16 pairs of two 16-byte vectors, multiplied and added into acc in order
__device__ __forceinline__ float dot8(const uint4& a, const uint4& b,
                                      float acc) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(x[i]), w = __bfloat1622float2(y[i]);
    acc = fmaf(u.x, w.x, acc);
    acc = fmaf(u.y, w.y, acc);
  }
  return acc;
}

// one row's dq/dk/dv fragment (f32, times mul, plus add[column] if add is
// not null) as bf16: register 4 j + 2 half + e holds column
// 64 n + 8 j + 2 (lane % 4) + e
template <int kNB>
__device__ __forceinline__ void store_row(bf16* op, const float (&acc)[kNB][32],
                                          int half, int lane, int hd,
                                          float mul,
                                          const float* add = nullptr) {
#pragma unroll
  for (int n = 0; n < kNB; ++n)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 64 * n + 8 * j + 2 * (lane % 4);
      float x0 = acc[n][4 * j + 2 * half] * mul;
      float x1 = acc[n][4 * j + 2 * half + 1] * mul;
      if (add != nullptr) {
        if (c < hd) x0 += add[c];
        if (c + 1 < hd) x1 += add[c + 1];
      }
      if (c + 1 < hd) {
        if (hd % 2 == 0) {
          *reinterpret_cast<__nv_bfloat162*>(op + c) =
              __floats2bfloat162_rn(x0, x1);
        } else {
          op[c] = __float2bfloat16(x0);
          op[c + 1] = __float2bfloat16(x1);
        }
      } else if (c < hd) {
        op[c] = __float2bfloat16(x0);
      }
    }
}

template <int HDB>
constexpr int dq_smem_bytes() {  // Q, dO, 2 x (K, V), D, alignment
  return 2 * kBQ * HDB * 2 + 4 * kBK * HDB * 2 + kBQ * 4 + 1024;
}

template <int HDB>
constexpr int dkdv_smem_bytes() {  // K, V, 2 x (Q, dO), 2 x (lse, D), align
  return 2 * kBQ * HDB * 2 + 4 * kBK * HDB * 2 + 4 * kBK * 4 + 1024;
}

// dQ of a (b, h, 128-query tile): two warpgroups of 64 query rows; K and V
// tiles of 64 keys through a 2-stage cp.async ring.
template <int HDB>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dq_tc(Args<bf16> A, float scale_log2, int flags) {
  constexpr int kNB = HDB / 64;               // 64-wide hd blocks
  constexpr int kQBytes = kBQ * HDB * 2;      // a 128-row tile
  constexpr int kTBytes = kBK * HDB * 2;      // a 64-row tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sQ = sm;
  unsigned char* sdO = sm + kQBytes;
  unsigned char* ring = sm + 2 * kQBytes;     // stage s: K, V at 2 s tiles
  float* sD = reinterpret_cast<float*>(ring + 4 * kTBytes);

  const int qt = gridDim.z - 1 - blockIdx.z;  // long causal tiles first
  const int h = blockIdx.x, b = blockIdx.y;
  const int hk = h / (A.H / A.Hkv);
  const int tid = threadIdx.x;
  const int wg = tid / 128;                   // warpgroup: rows 64 wg ..
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const bool vec = flags & kVec;
  const int q0 = qt * kBQ;
  const int w0 = q0 + 64 * wg;
  const int r_lo = 64 * wg + 16 * warp + lane / 4;  // fragment rows r_lo,
  const int qi_lo = q0 + r_lo, qi_hi = qi_lo + 8;   // r_lo + 8 of the tile
  const bf16* qb = A.q + (long long)b * A.sq.b + (long long)q0 * A.sq.s +
                   (long long)h * A.sq.h;
  const bf16* dob = A.dout + (long long)b * A.sdo.b +
                    (long long)q0 * A.sdo.s + (long long)h * A.sdo.h;
  const bf16* kb = A.k + (long long)b * A.sk.b + (long long)hk * A.sk.h;
  const bf16* vb = A.v + (long long)b * A.sv.b + (long long)hk * A.sv.h;

  int nt = (A.Sk + kBK - 1) / kBK;
  if (A.causal) nt = min(nt, min(q0 + kBQ - 1, A.Sq - 1) / kBK + 1);
  // window: from the first key tile holding a key > q0 - W
  const int t0 = A.window > 0 ? max(0, q0 - A.window + 1) / kBK : 0;
  const int lo_lo = A.window > 0 ? qi_lo - A.window : -1;  // keys <= lo
  const int lo_hi = A.window > 0 ? qi_hi - A.window : -1;  // are masked

  load_tile<kBQ, HDB>(sQ, qb, A.Sq - q0, A.hd, A.sq.s, A.sq.d, vec, tid);
  load_tile<kBQ, HDB>(sdO, dob, A.Sq - q0, A.hd, A.sdo.s, A.sdo.d, vec, tid);
  if (t0 < nt)
    load_kv<HDB>(ring + (t0 & 1) * 2 * kTBytes, kb, vb, t0 * kBK, A.Sk, A.hd,
                 A.sk.s, A.sk.d, A.sv.s, A.sv.d, vec, tid);
  cp_async_commit();

  // prologue, while the copies fly: D_i = sum_d dO_id O_id in f32 from
  // global memory, two threads a row (16-byte chunks 2 i + half, then one
  // xor-shuffle: a fixed order); stored for the dkdv kernel
  const long long row0 = ((long long)b * A.H + h) * A.Sq;
  {
    const int r = tid / 2, half = tid % 2, qi = q0 + r;
    float acc = 0.0f;
    if (qi < A.Sq) {
      const bf16* po = A.o + (long long)b * A.so.b + (long long)qi * A.so.s +
                       (long long)h * A.so.h;
      const bf16* pd = A.dout + (long long)b * A.sdo.b +
                       (long long)qi * A.sdo.s + (long long)h * A.sdo.h;
      if (flags & kOVec) {
#pragma unroll
        for (int i = 0; i < HDB / 16; ++i) {
          const int c = 16 * i + 8 * half;
          if (c < A.hd)
            acc = dot8(*reinterpret_cast<const uint4*>(pd + c),
                       *reinterpret_cast<const uint4*>(po + c), acc);
        }
      } else {
        for (int c = half; c < A.hd; c += 2)
          acc = fmaf(__bfloat162float(pd[(long long)c * A.sdo.d]),
                     __bfloat162float(po[(long long)c * A.so.d]), acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      sD[r] = acc;
      if (qi < A.Sq) A.D[row0 + qi] = acc;
    }
  }
  // the rows' lse in base-2 units of the scaled score
  const float l_lo = qi_lo < A.Sq ? A.lse[row0 + qi_lo] * kLog2e : 0.0f;
  const float l_hi = qi_hi < A.Sq ? A.lse[row0 + qi_hi] * kLog2e : 0.0f;
  __syncthreads();
  const float D_lo = sD[r_lo], D_hi = sD[r_lo + 8];

  float dq[kNB][32];
#pragma unroll
  for (int n = 0; n < kNB; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[n][i] = 0.0f;
  const bool rows_live = w0 < A.Sq;

  for (int t = t0; t < nt; ++t) {
    unsigned char* sK = ring + (t & 1) * 2 * kTBytes;
    unsigned char* sV = sK + kTBytes;
    if (t + 1 < nt)
      load_kv<HDB>(ring + ((t + 1) & 1) * 2 * kTBytes, kb, vb, (t + 1) * kBK,
                   A.Sk, A.hd, A.sk.s, A.sk.d, A.sv.s, A.sv.d, vec, tid);
    cp_async_commit();
    cp_async_wait<1>();  // tile t (and Q, dO) have landed; t + 1 may fly
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    const int k0 = t * kBK;
    if (rows_live && (!A.causal || k0 <= w0 + 63) &&
        (A.window <= 0 || k0 + kBK - 1 > w0 - A.window)) {
      // S = Q K^T and dP = dO V^T for this warpgroup's 64 rows
      float s[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.0f;
      const uint32_t qa = smem_u32(sQ) + wg * 64 * 128;
      const uint32_t oa = smem_u32(sdO) + wg * 64 * 128;
      const uint32_t ka = smem_u32(sK), va = smem_u32(sV);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < HDB / 16; ++ks)
        mma_ss(s, desc(qa + (ks / 4) * kBQ * 128 + (ks % 4) * 32, 16, 1024),
               desc(ka + (ks / 4) * kBK * 128 + (ks % 4) * 32, 16, 1024));
#pragma unroll
      for (int ks = 0; ks < HDB / 16; ++ks)
        mma_ss(dp, desc(oa + (ks / 4) * kBQ * 128 + (ks % 4) * 32, 16, 1024),
               desc(va + (ks / 4) * kBK * 128 + (ks % 4) * 32, 16, 1024));
      wgmma_commit();
      wgmma_wait0();
      keep(s);
      keep(dp);

      // P = 2^(s scale log2 e - lse log2 e) and dS = P (dP - D) in f32:
      // register 4 j + e (+2) holds row qi_lo (qi_hi), key
      // k0 + 8 j + 2 (lane % 4) + e; dS overwrites s
      const bool masked = k0 + kBK > A.Sk ||
                          (A.causal && k0 + kBK - 1 > w0) ||
                          (A.window > 0 && k0 <= w0 + 63 - A.window);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kj = k0 + 8 * j + 2 * (lane % 4) + e;
          float p_lo = ex2(fmaf(s[4 * j + e], scale_log2, -l_lo));
          float p_hi = ex2(fmaf(s[4 * j + 2 + e], scale_log2, -l_hi));
          if (masked) {
            if (!(kj < A.Sk && (!A.causal || kj <= qi_lo) && kj > lo_lo))
              p_lo = 0.0f;
            if (!(kj < A.Sk && (!A.causal || kj <= qi_hi) && kj > lo_hi))
              p_hi = 0.0f;
          }
          s[4 * j + e] = p_lo * (dp[4 * j + e] - D_lo);
          s[4 * j + 2 + e] = p_hi * (dp[4 * j + 2 + e] - D_hi);
        }
      }
      // dS rounded to bf16 once, as the register-A fragment of each
      // 16-key slice kk
      uint32_t da[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          da[kk][i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);

      // dQ += dS K: the K tile as B, MN-major (transpose bit)
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int n = 0; n < kNB; ++n)
          mma_rs(dq[n], da[kk],
                 desc(ka + n * kBK * 128 + kk * 2048, kBK * 128, 1024));
      wgmma_commit();
      wgmma_wait0();
#pragma unroll
      for (int n = 0; n < kNB; ++n) keep(dq[n]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) keep(da[kk]);
    }
    __syncthreads();  // every reader of stage t & 1 is done before reuse
  }
  cp_async_wait<0>();  // no copy outlives the block (t0 = nt: Q and dO)

  if (!rows_live) return;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qi = half ? qi_hi : qi_lo;
    if (qi < A.Sq)
      store_row<kNB>(A.dq + (((long long)b * A.Sq + qi) * A.H + h) * A.hd,
                     dq, half, lane, A.hd, A.scale);
  }
}

// dK and dV of a (b, kv head, 128-key tile): two warpgroups of 64 key rows
// hold K and V; the group's query heads, then their 64-query tiles, stream
// Q, dO, lse and D through a 2-stage cp.async ring.
template <int HDB>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dkdv_tc(Args<bf16> A, float scale_log2, int flags) {
  constexpr int kNB = HDB / 64;
  constexpr int kKBytes = kBQ * HDB * 2;      // a 128-row K or V tile
  constexpr int kTBytes = kBK * HDB * 2;      // a 64-row Q or dO tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sK = sm;
  unsigned char* sV = sm + kKBytes;
  unsigned char* ring = sm + 2 * kKBytes;     // stage s: Q, dO at 2 s tiles
  float* sLD = reinterpret_cast<float*>(ring + 4 * kTBytes);  // [s][lse, D]

  const int kt = blockIdx.z;  // key tile 0 first: causal, it sees every query
  const int hk = blockIdx.x, b = blockIdx.y;
  const int G = A.H / A.Hkv;
  const int tid = threadIdx.x;
  const int wg = tid / 128;                   // warpgroup: keys 64 wg ..
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const bool vec = flags & kVec;
  const int k0 = kt * kBQ;
  const int w0 = k0 + 64 * wg;
  const int kj_lo = w0 + 16 * warp + lane / 4, kj_hi = kj_lo + 8;
  const bf16* kb = A.k + (long long)b * A.sk.b + (long long)k0 * A.sk.s +
                   (long long)hk * A.sk.h;
  const bf16* vb = A.v + (long long)b * A.sv.b + (long long)k0 * A.sv.s +
                   (long long)hk * A.sv.h;

  load_tile<kBQ, HDB>(sK, kb, A.Sk - k0, A.hd, A.sk.s, A.sk.d, vec, tid);
  load_tile<kBQ, HDB>(sV, vb, A.Sk - k0, A.hd, A.sv.s, A.sv.d, vec, tid);

  // iterations it = g per + (qt - first): head g of the group, query tile
  // qt; causal: from the tile holding query k0; window: to the tile holding
  // query k_last + W - 1
  int nq = (A.Sq + kBK - 1) / kBK;
  if (A.window > 0)
    nq = min(nq, (min(k0 + kBQ - 1, A.Sk - 1) + A.window - 1) / kBK + 1);
  const int first = A.causal ? min(k0 / kBK, nq) : 0;
  const int per = nq - first;
  const int n_it = G * per;
  auto load_q = [&](int it, int st) {
    const int h = hk * G + it / per, q0 = (first + it % per) * kBK;
    load_kv<HDB>(ring + st * 2 * kTBytes,
                 A.q + (long long)b * A.sq.b + (long long)h * A.sq.h,
                 A.dout + (long long)b * A.sdo.b + (long long)h * A.sdo.h, q0,
                 A.Sq, A.hd, A.sq.s, A.sq.d, A.sdo.s, A.sdo.d, vec, tid);
    if (tid < 2 * kBK) {
      const int i = tid % kBK;
      const float* src = (tid < kBK ? A.lse : A.D) +
                         ((long long)b * A.H + h) * A.Sq + q0 + i;
      const bool in = q0 + i < A.Sq;
      cp_async4(smem_u32(sLD + st * 2 * kBK + tid), in ? src : A.lse,
                in ? 4 : 0);
    }
  };

  float dk[kNB][32], dv[kNB][32];
#pragma unroll
  for (int n = 0; n < kNB; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[n][i] = dv[n][i] = 0.0f;

  if (n_it > 0) load_q(0, 0);
  cp_async_commit();
  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1;
    if (it + 1 < n_it) load_q(it + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // stage st (and K, V) have landed
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    const int q0 = (first + it % per) * kBK;
    if (w0 < A.Sk && (!A.causal || w0 <= q0 + kBK - 1) &&
        (A.window <= 0 || q0 <= w0 + 63 + A.window - 1)) {
      // S^T = K Q^T and dP^T = V dO^T for this warpgroup's 64 keys
      float s[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.0f;
      const uint32_t ka = smem_u32(sK) + wg * 64 * 128;
      const uint32_t va = smem_u32(sV) + wg * 64 * 128;
      const uint32_t qa = smem_u32(ring + st * 2 * kTBytes);
      const uint32_t oa = qa + kTBytes;
      const float* sL = sLD + st * 2 * kBK;
      const float* sDD = sL + kBK;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < HDB / 16; ++ks)
        mma_ss(s, desc(ka + (ks / 4) * kBQ * 128 + (ks % 4) * 32, 16, 1024),
               desc(qa + (ks / 4) * kBK * 128 + (ks % 4) * 32, 16, 1024));
#pragma unroll
      for (int ks = 0; ks < HDB / 16; ++ks)
        mma_ss(dp, desc(va + (ks / 4) * kBQ * 128 + (ks % 4) * 32, 16, 1024),
               desc(oa + (ks / 4) * kBK * 128 + (ks % 4) * 32, 16, 1024));
      wgmma_commit();
      wgmma_wait0();
      keep(s);
      keep(dp);

      // P^T and dS^T = P^T (dP^T - D) in f32: register 4 j + e (+2) holds
      // key kj_lo (kj_hi), query q0 + 8 j + 2 (lane % 4) + e, whose lse and
      // D index the column; P^T stays in s, dS^T overwrites dp
      const bool masked = q0 + kBK > A.Sq || w0 + 64 > A.Sk ||
                          (A.causal && w0 + 63 > q0) ||
                          (A.window > 0 && q0 + kBK - 1 >= w0 + A.window);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 8 * j + 2 * (lane % 4);
        const float2 l2 = *reinterpret_cast<const float2*>(sL + c);
        const float2 d2 = *reinterpret_cast<const float2*>(sDD + c);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qi = q0 + c + e;
          const float l = (e ? l2.y : l2.x) * kLog2e;
          const float d = e ? d2.y : d2.x;
          float p_lo = ex2(fmaf(s[4 * j + e], scale_log2, -l));
          float p_hi = ex2(fmaf(s[4 * j + 2 + e], scale_log2, -l));
          if (masked) {
            const bool q_in = qi < A.Sq;
            const int lo = A.window > 0 ? qi - A.window : -1;  // keys <= lo
            if (!(q_in && kj_lo < A.Sk && (!A.causal || kj_lo <= qi) &&
                  kj_lo > lo))
              p_lo = 0.0f;
            if (!(q_in && kj_hi < A.Sk && (!A.causal || kj_hi <= qi) &&
                  kj_hi > lo))
              p_hi = 0.0f;
          }
          s[4 * j + e] = p_lo;
          s[4 * j + 2 + e] = p_hi;
          dp[4 * j + e] = p_lo * (dp[4 * j + e] - d);
          dp[4 * j + 2 + e] = p_hi * (dp[4 * j + 2 + e] - d);
        }
      }
      // P^T and dS^T rounded to bf16 once, as register-A fragments of each
      // 16-query slice kk
      uint32_t pa[4][4], da[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pa[kk][i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
          da[kk][i] = pack_bf16(dp[8 * kk + 2 * i], dp[8 * kk + 2 * i + 1]);
        }

      // dV += P^T dO and dK += dS^T Q: the dO and Q tiles as B, MN-major
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int n = 0; n < kNB; ++n) {
          mma_rs(dv[n], pa[kk],
                 desc(oa + n * kBK * 128 + kk * 2048, kBK * 128, 1024));
          mma_rs(dk[n], da[kk],
                 desc(qa + n * kBK * 128 + kk * 2048, kBK * 128, 1024));
        }
      wgmma_commit();
      wgmma_wait0();
#pragma unroll
      for (int n = 0; n < kNB; ++n) {
        keep(dv[n]);
        keep(dk[n]);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        keep(pa[kk]);
        keep(da[kk]);
      }
    }
    __syncthreads();  // every reader of stage st is done before reuse
  }
  cp_async_wait<0>();  // no copy outlives the block (n_it = 0: K and V)

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int kj = half ? kj_hi : kj_lo;
    if (kj >= A.Sk) continue;
    const long long off = (((long long)b * A.Sk + kj) * A.Hkv + hk) * A.hd;
    store_row<kNB>(A.dk + off, dk, half, lane, A.hd, A.scale);
    store_row<kNB>(A.dv + off, dv, half, lane, A.hd, 1.0f,
                   A.E != nullptr
                       ? A.E + ((long long)b * A.Hkv + hk) * A.hd
                       : nullptr);
  }
}

template <int HDB>
int launch(const Args<bf16>& a, int B, int flags, cudaStream_t stream) {
  constexpr int dq_smem = dq_smem_bytes<HDB>();
  constexpr int kv_smem = dkdv_smem_bytes<HDB>();
  static bool ready = false;  // the attributes are set once per bucket
  if (!ready) {
    cudaError_t e = cudaFuncSetAttribute(
        bwd_dq_tc<HDB>, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(bwd_dkdv_tc<HDB>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kv_smem);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  const float scale_log2 = a.scale * kLog2e;
  dim3 gq(a.H, B, (a.Sq + kBQ - 1) / kBQ);
  bwd_dq_tc<HDB><<<gq, kThreads, dq_smem, stream>>>(a, scale_log2, flags);
  cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess) e = launch_empty_rows(a, B, stream);
  if (e != cudaSuccess) return (int)e;
  dim3 gk(a.Hkv, B, (a.Sk + kBQ - 1) / kBQ);
  bwd_dkdv_tc<HDB><<<gk, kThreads, kv_smem, stream>>>(a, scale_log2, flags);
  return (int)cudaGetLastError();
}

// hd is padded with zeros to its bucket, 64 or 128
int bucket(int hd) { return hd <= 64 ? 64 : 128; }

int run(const void* q, const void* k, const void* v, const void* o,
        const void* dout, const float* lse, float* D, float* E, void* dq,
        void* dk, void* dv, int B, int Sq, int Sk, int H, int Hkv, int hd,
        const long long* s, int causal, int window, float scale,
        cudaStream_t stream) {
  Args<bf16> a;
  a.q = (const bf16*)q;
  a.k = (const bf16*)k;
  a.v = (const bf16*)v;
  a.o = (const bf16*)o;
  a.dout = (const bf16*)dout;
  a.lse = lse;
  a.D = D;
  a.E = E;
  a.dq = (bf16*)dq;
  a.dk = (bf16*)dk;
  a.dv = (bf16*)dv;
  a.Sq = Sq;
  a.Sk = Sk;
  a.H = H;
  a.Hkv = Hkv;
  a.hd = hd;
  a.causal = causal;
  a.window = window;
  a.scale = scale;
  Strides* st_[5] = {&a.sq, &a.sk, &a.sv, &a.so, &a.sdo};
  for (int i = 0; i < 5; ++i)
    *st_[i] = Strides{s[4 * i], s[4 * i + 1], s[4 * i + 2], s[4 * i + 3]};
  // 16-byte copies need a unit hd stride, 16-byte-aligned rows and bases
  const void* ptrs[5] = {q, k, v, o, dout};
  bool ok[5];
  for (int i = 0; i < 5; ++i) {
    ok[i] = s[4 * i + 3] == 1 && (uintptr_t)ptrs[i] % 16 == 0;
    for (int j = 0; j < 3; ++j)
      if (s[4 * i + j] % 8 != 0) ok[i] = false;
  }
  int flags = 0;
  if (ok[0] && ok[1] && ok[2] && ok[4]) flags |= kVec;
  if (ok[3] && ok[4] && hd % 8 == 0) flags |= kOVec;
  if (bucket(hd) == 64) return launch<64>(a, B, flags, stream);
  return launch<128>(a, B, flags, stream);
}

// The runtime's attributes of the two kernels that hd launches, into
// out[0..3] (dq) and out[4..7] (dkdv): registers a thread, local (spill)
// bytes a thread, static and maximum dynamic shared memory a block (the
// latter as the first launch of that bucket set it)
int attributes(int hd, int* out) {
  const bool b64 = bucket(hd) == 64;
  const void* fs[2] = {
      b64 ? (const void*)bwd_dq_tc<64> : (const void*)bwd_dq_tc<128>,
      b64 ? (const void*)bwd_dkdv_tc<64> : (const void*)bwd_dkdv_tc<128>};
  for (int i = 0; i < 2; ++i) {
    cudaFuncAttributes a;
    const cudaError_t e = cudaFuncGetAttributes(&a, fs[i]);
    if (e != cudaSuccess) return (int)e;
    out[4 * i] = a.numRegs;
    out[4 * i + 1] = (int)a.localSizeBytes;
    out[4 * i + 2] = (int)a.sharedSizeBytes;
    out[4 * i + 3] = a.maxDynamicSharedSizeBytes;
  }
  return 0;
}

}  // namespace tc

}  // namespace

// q, k, v, o, dout: device pointers read through their element strides,
// (b, s, h, d) for each in that order (20 values in `strides`); lse: f32
// (B, H, Sq) contiguous; D: f32 (B, H, Sq) scratch the first kernel writes
// and the second reads; E: null, or (when window >= 1 and Sq >= Sk +
// window, so that rows see no key) f32 (B, Hkv, hd) scratch for their dV;
// dq (B, Sq, H, hd), dk and dv (B, Sk, Hkv, hd): contiguous outputs in the
// inputs' dtype (0 = f32, 1 = bf16); window >= 1 masks key j for query i
// unless j > i - window, 0 is none. Launches two kernels (three with E) on
// `stream`; returns the first non-zero cudaGetLastError().
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const float* lse,
                                   float* D, float* E, void* dq, void* dk,
                                   void* dv,
                                   int B, int Sq, int Sk, int H, int Hkv,
                                   int hd, const long long* strides,
                                   int causal, int window, float scale,
                                   int bf16, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || Hkv < 1 || H % Hkv != 0 || hd < 1 ||
      hd > 256 || H > 65535 || Hkv > 65535 || B > 65535 || window < 0 ||
      (E != nullptr && window < 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return run<__nv_bfloat16>(q, k, v, o, dout, lse, D, E, dq, dk, dv, B, Sq,
                              Sk, H, Hkv, hd, strides, causal, window, scale,
                              st);
  return run<float>(q, k, v, o, dout, lse, D, E, dq, dk, dv, B, Sq, Sk, H,
                    Hkv, hd, strides, causal, window, scale, st);
}

// The bf16 tensor-core kernels, hd <= 128: arguments as flash_attention_bwd
// less the dtype flag (all bf16). Launches bwd_dq_tc, then (with E)
// empty_rows_dv, then bwd_dkdv_tc, on `stream`; returns the first non-zero
// cudaGetLastError().
extern "C" int flash_attention_bwd_tc(const void* q, const void* k,
                                      const void* v, const void* o,
                                      const void* dout, const float* lse,
                                      float* D, float* E, void* dq, void* dk,
                                      void* dv,
                                      int B, int Sq, int Sk, int H, int Hkv,
                                      int hd, const long long* strides,
                                      int causal, int window, float scale,
                                      void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || Hkv < 1 || H % Hkv != 0 || hd < 1 ||
      hd > 128 || B > 65535 || (Sq + 127) / 128 > 65535 ||
      (Sk + 127) / 128 > 65535 || window < 0 ||
      (E != nullptr && window < 1))
    return (int)cudaErrorInvalidValue;
  return tc::run(q, k, v, o, dout, lse, D, E, dq, dk, dv, B, Sq, Sk, H, Hkv,
                 hd, strides, causal, window, scale, (cudaStream_t)stream);
}

// The tensor-core kernels' runtime attributes for head dim hd, into
// out[8]: dq's registers, local bytes (a thread), static shared bytes,
// maximum dynamic shared bytes (a block), then dkdv's. Returns a
// cudaError_t.
extern "C" int flash_attention_bwd_tc_attributes(int hd, int* out) {
  if (hd < 1 || hd > 128) return (int)cudaErrorInvalidValue;
  return tc::attributes(hd, out);
}
