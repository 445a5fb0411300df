// Flash attention forward on Hopper: online-softmax GQA attention, causal
// (top-left: key j is seen by query i iff j <= i) or bidirectional, with an
// optional sliding window W (key j is seen by query i only if j > i - W;
// W = 0 means no window).
// q (B, Sq, H, hd), k and v (B, Sk, Hkv, hd) with H % Hkv == 0 -> out
// (B, Sq, H, hd) in q's dtype (f32 or bf16); softmax math in f32. Given a
// buffer (training), each kernel also writes the row log-sum-exp of the
// scaled scores, lse = m + log l, as f32 (B, H, Sq): the backward kernel
// (flash_attention_bwd.cu) recomputes P = exp(s * scale - lse) from it. The
// serve path passes none, and then the kernels store nothing more.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention -> _flash_kernel). The port's models/layers.py
// attention_forward calls it once per attention layer of a prefill.
// Two kernels, chosen by the inputs' dtype (a dispatch, not a fallback):
//
// bf16 (the serve path): flash_attention_tc, on the tensor cores.
//   Bound: at the serve shape (B = 8, S = 2048, H = 24, Hkv = 8, hd = 128,
//   causal) the unmasked (query, key) pairs need 4 hd FLOP each (QK^T and
//   PV), 2.06e11 FLOP at the bf16 tensor-core peak (989 TFLOP/s): 0.2086
//   ms, against 80 us for the 268 MB of q, k, v and o. The old design (the
//   f32 kernel below, run on bf16) issued about 100 instructions per key per
//   lane for 64 FMAs and sat at 1.4% of that bound; here both products are
//   wgmma instructions (one m64n64k16 does 64 x 64 x 16 multiply-adds for a
//   warpgroup), so the CUDA cores only run the softmax on the accumulator.
//   Design: one block per (b, h, 128-query tile), grid (q tiles, H, B) with
//   the q-tile index reversed so long causal tiles start first; 256 threads,
//   two consumer warpgroups of 64 query rows. The Q tile is loaded once and
//   64-key K and V tiles stream through a 2-stage shared-memory ring, all
//   with 16-byte cp.async.cg (zero-fill past the ragged Sk and hd edges;
//   hd is padded with zeros to its bucket, 64/128/256, which is exact),
//   tile t+1 in flight while tile t is computed. Shared tiles use the
//   128-byte swizzle that wgmma's descriptors read: hd in blocks of 64
//   elements, each block rows x 128 bytes, 16-byte chunk c of row r at c ^ (r
//   % 8). S = Q K^T: wgmma m64n64k16 bf16 x bf16 -> f32, both operands from
//   shared memory (K-major). Online softmax on the accumulator fragment, in
//   f32 and base 2 (scores scaled by log2(e) / sqrt(hd), 2^x by ex2.approx
//   on the special-function unit, subnormal p flushed to 0): a thread owns rows
//   r and r + 8 of its warp's 16, and 16 columns of each; masked scores are
//   -1e30 (only the diagonal and ragged tiles test the mask); row max by two
//   xor-shuffles over the four lanes of a row; corr = exp2(m - m_new); l is
//   the f32 sum of p (each lane's share, summed over the four lanes at the
//   end); the output is acc / max(l, 1e-30). O += P V: wgmma with A = p
//   rounded to bf16 from registers (the f32 S fragment is the register-A
//   fragment) and B = the V tile (MN-major, transpose bit set), one n64
//   instruction per 64-wide hd block. Causal K tiles wholly above a
//   warpgroup's rows are skipped (tile 0 holds key 0, which every query sees,
//   so m is finite after it and a skipped tile would add p = 0 with corr =
//   1). Inputs are read through their strides: the cp.async path needs unit
//   hd stride and 16-byte-aligned rows, and any other layout takes an
//   element-wise loader into the same tiles. No atomics and a fixed key
//   order: repeated runs give identical bits.
//   The issue-rate limit: the softmax is ~10 instructions per score on the
//   CUDA cores while the tensor cores do the products, and the K/V copies
//   cost a few adds per 16-byte chunk (load_kv fixes each thread's chunk
//   column once). Two blocks (four warpgroups) share an SM at hd <= 128, so
//   one warpgroup's softmax overlaps another's wgmma.
//   ptxas -v (sm_90a, bucket 128, the serve shape): 128 registers (the cap
//   of __launch_bounds__(256, 2)), 12 bytes spilled; 99,328 bytes of
//   dynamic shared memory (32 KB Q, 2 x 2 x 16 KB K/V, 1 KB alignment).
//   Bucket 256: 1 block an SM, 197,632 bytes. Not yet: TMA loads and a
//   producer warp (warp specialisation), overlap of one tile's softmax with
//   the next tile's QK^T.
//
// The window (both kernels). A block starts at the first K tile holding a
//   key > q_first - W (q_first its first query), so the tiles below the
//   band are never loaded; the bf16 kernel's warpgroups also skip the
//   loaded tiles wholly below their own rows' band, and a tile that
//   straddles the lower edge is masked, as the diagonal tile is. A row
//   whose first tiles are all masked carries m = -1e30 and p = 1 from them
//   until its first key arrives; then corr = exp(-1e30 - m) = 0 clears
//   l and the accumulator, so the result is the same as if those tiles
//   were skipped. A row with no key in its band (i >= Sk + W - 1, only when
//   Sq > Sk + W - 1) gets the softmax of Sk scores of -1e30, the mean of v
//   over the Sk keys, as the reference computes it: a block (warpgroup)
//   holding such a row walks every tile from the first, and the padding
//   past Sk scores -inf (p = 0) so that only the Sk keys count. Padding
//   scores -inf in every case; a row with a key in its band gets the same
//   bits as with -1e30 there (p = 0 either way). Such a row's lse is
//   -1e30 (-1e30 + log Sk rounds to it in f32); its gradient, the
//   reference's (do_i / Sk to every key's dV, nothing to dQ or dK), is
//   flash_attention_bwd.cu's empty_rows_dv.
//
// f32 (the parity mode): flash_attention_kernel, IEEE fp32 on the CUDA
//   cores, as the reference's kernel computes; capped at about 3.1 ms at
//   the serve shape by the FP32 peak (67 TFLOP/s).
//   Design: one block per (b, h, 64-query tile); grid (q tiles, H, B), the
//   q-tile index reversed so the long causal tiles start first. 256 threads,
//   two blocks per SM at hd <= 128 (launch bound):
//   each query row is owned by 4 neighbouring lanes of one warp, and each
//   lane holds 1/4 of the row's q and of its f32 accumulator in registers,
//   as 4-float chunks c = sub + 4 i (so the four lanes' 16-byte shared loads
//   fall on distinct banks). The K loop walks kBK-key tiles in order: each K
//   and V tile is staged in shared memory as f32, zero outside the ragged
//   Sk / hd edges. A lane computes its partial q.k for every key of the
//   tile; two xor-shuffles sum the four partials inside the warp, so every
//   lane of the row holds the full score. Masked scores are -1e30 (the
//   reference's NEG_INF), the running max m, sum l and accumulator follow
//   the reference's update (corr = exp(m - m_new)), and the output is acc /
//   max(l, 1e-30). Causal K tiles wholly above the diagonal are skipped as
//   above. The inputs are read through their element strides, and query
//   head h reads kv head h / (H / Hkv). No atomics and a fixed key order.
//   hd is a template bucket (32, 64, 128, 256) with zero-filled tails.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_bf16.cuh"

namespace {

constexpr int kBQ = 64;         // query rows per block
constexpr int kLanes = 4;       // lanes per query row
constexpr int kThreads = kBQ * kLanes;
constexpr float kNegInf = -1e30f;

template <int HD>
struct Tile {
  static constexpr int kBK = HD <= 128 ? 32 : 16;  // keys per K/V tile
  static constexpr int kChunks = HD / (4 * kLanes);  // float4 chunks per lane
  // blocks per SM the register budget must allow: at hd 128 the compiler
  // takes 172 registers a thread unbounded (one block per SM); capped at
  // 128 (a few spilled bytes) two blocks fit, 15% faster on the H100
  static constexpr int kMinBlocks = HD <= 128 ? 2 : 1;
};

template <int HD>
__global__ void __launch_bounds__(kThreads, Tile<HD>::kMinBlocks)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
                       int Sq, int Sk, int H, int group, int hd, long long qsb,
                       long long qss, long long qsh, long long qsd,
                       long long ksb, long long kss, long long ksh,
                       long long ksd, long long vsb, long long vss,
                       long long vsh, long long vsd, int causal, int window,
                       float scale, float* __restrict__ lse) {
  constexpr int kBK = Tile<HD>::kBK;
  constexpr int kC = Tile<HD>::kChunks;
  __shared__ __align__(16) float Ks[kBK * HD];
  __shared__ __align__(16) float Vs[kBK * HD];

  const int qt = gridDim.x - 1 - blockIdx.x;  // long causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / group;
  const int tid = threadIdx.x;
  const int row = tid / kLanes;
  const int sub = tid % kLanes;
  const int qi = qt * kBQ + row;
  const bool live = qi < Sq;

  // this lane's q chunks (dims 4c .. 4c+3, c = sub + kLanes * i), f32
  float4 qr[kC];
  const float* qp = q + (long long)b * qsb + (long long)qi * qss + (long long)h * qsh;
#pragma unroll
  for (int i = 0; i < kC; ++i) {
    const int d0 = 4 * (sub + kLanes * i);
    float e[4];
#pragma unroll
    for (int t = 0; t < 4; ++t)
      e[t] = (live && d0 + t < hd) ? qp[(long long)(d0 + t) * qsd] : 0.0f;
    qr[i] = make_float4(e[0], e[1], e[2], e[3]);
  }
  float4 acc[kC];
#pragma unroll
  for (int i = 0; i < kC; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  float m = kNegInf, l = 0.0f;

  // K tiles this block needs: all of them, or (causal) those holding a key
  // <= the block's last live query, and (window) from the first holding a
  // key > its first query - W, unless one of its rows sees no key
  const int nk = (Sk + kBK - 1) / kBK;
  const int q_last = min(qt * kBQ + kBQ - 1, Sq - 1);
  int nt = nk;
  if (causal) nt = min(nk, q_last / kBK + 1);
  int t0 = 0;
  if (window > 0 && q_last < Sk + window - 1)
    t0 = max(0, qt * kBQ - window + 1) / kBK;
  const int lo = window > 0 ? qi - window : -1;  // keys <= lo are masked
  const float* kb = k + (long long)b * ksb + (long long)hk * ksh;
  const float* vb = v + (long long)b * vsb + (long long)hk * vsh;

  for (int t = t0; t < nt; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < kBK * HD; e += kThreads) {
      const int r = e / HD, d = e % HD;
      const bool in = k0 + r < Sk && d < hd;
      const long long kr = (long long)(k0 + r);
      Ks[e] = in ? kb[kr * kss + (long long)d * ksd] : 0.0f;
      Vs[e] = in ? vb[kr * vss + (long long)d * vsd] : 0.0f;
    }
    __syncthreads();

    float s[kBK];
    float mt = kNegInf;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(Ks + j * HD);
      float part = 0.0f;
#pragma unroll
      for (int i = 0; i < kC; ++i) {
        const float4 kk = kr[sub + kLanes * i];
        part = fmaf(qr[i].x, kk.x, part);
        part = fmaf(qr[i].y, kk.y, part);
        part = fmaf(qr[i].z, kk.z, part);
        part = fmaf(qr[i].w, kk.w, part);
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int kj = k0 + j;
      const bool ok = (!causal || kj <= qi) && kj > lo;
      s[j] = kj >= Sk ? -INFINITY : ok ? part * scale : kNegInf;
      mt = fmaxf(mt, s[j]);
    }
    const float m_new = fmaxf(m, mt);
    const float corr = expf(m - m_new);
    float psum = 0.0f;
#pragma unroll
    for (int i = 0; i < kC; ++i) {
      acc[i].x *= corr; acc[i].y *= corr; acc[i].z *= corr; acc[i].w *= corr;
    }
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      const float p = expf(s[j] - m_new);
      psum += p;
      const float4* vr = reinterpret_cast<const float4*>(Vs + j * HD);
#pragma unroll
      for (int i = 0; i < kC; ++i) {
        const float4 vv = vr[sub + kLanes * i];
        acc[i].x = fmaf(p, vv.x, acc[i].x);
        acc[i].y = fmaf(p, vv.y, acc[i].y);
        acc[i].z = fmaf(p, vv.z, acc[i].z);
        acc[i].w = fmaf(p, vv.w, acc[i].w);
      }
    }
    l = l * corr + psum;
    m = m_new;
  }

  if (!live) return;
  if (lse != nullptr && sub == 0)
    lse[((long long)b * H + h) * Sq + qi] = m + logf(l);
  const float inv = 1.0f / fmaxf(l, 1e-30f);
  float* op = out + (((long long)b * Sq + qi) * H + h) * hd;
#pragma unroll
  for (int i = 0; i < kC; ++i) {
    const int d0 = 4 * (sub + kLanes * i);
    const float e[4] = {acc[i].x, acc[i].y, acc[i].z, acc[i].w};
#pragma unroll
    for (int t = 0; t < 4; ++t)
      if (d0 + t < hd) op[d0 + t] = e[t] * inv;
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int H, int Hkv, int hd, const long long* s,
           int causal, int window, float scale, float* lse,
           cudaStream_t stream) {
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel<HD><<<grid, kThreads, 0, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, Sq, Sk,
      H, H / Hkv, hd, s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10], s[11],
      causal, window, scale, lse);
  return (int)cudaGetLastError();
}

int dispatch(const void* q, const void* k, const void* v, void* out, int B,
             int Sq, int Sk, int H, int Hkv, int hd, const long long* s,
             int causal, int window, float scale, float* lse,
             cudaStream_t stream) {
  if (hd <= 32)
    return launch<32>(q, k, v, out, B, Sq, Sk, H, Hkv, hd, s, causal, window, scale, lse, stream);
  if (hd <= 64)
    return launch<64>(q, k, v, out, B, Sq, Sk, H, Hkv, hd, s, causal, window, scale, lse, stream);
  if (hd <= 128)
    return launch<128>(q, k, v, out, B, Sq, Sk, H, Hkv, hd, s, causal, window, scale, lse, stream);
  return launch<256>(q, k, v, out, B, Sq, Sk, H, Hkv, hd, s, causal, window, scale, lse, stream);
}


// ---- bf16: the tensor-core kernel -----------------------------------------
// (its swizzle, descriptors, cp.async loaders and wgmma wrappers are in
// wgmma_bf16.cuh, shared with the backward's tensor-core kernels)

namespace tc {

template <int HDB>
constexpr int smem_bytes() {
  return kBQ * HDB * 2 + 4 * kBK * HDB * 2 + 1024;  // Q, 2 x (K, V), align
}

template <int HDB>
__global__ void __launch_bounds__(kThreads, HDB <= 128 ? 2 : 1)
flash_attention_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, bf16* __restrict__ out, int Sq,
                   int Sk, int H, int group, int hd, long long qsb,
                   long long qss, long long qsh, long long qsd, long long ksb,
                   long long kss, long long ksh, long long ksd, long long vsb,
                   long long vss, long long vsh, long long vsd, int causal,
                   int window, float scale_log2, int vec,
                   float* __restrict__ lse) {
  constexpr int kNB = HDB / 64;               // 64-wide hd blocks
  constexpr int kQBytes = kBQ * HDB * 2;
  constexpr int kTBytes = kBK * HDB * 2;      // one K or V tile
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte alignment of the swizzle atoms, in the shared address space
  unsigned char* sm =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sQ = sm;

  const int qt = gridDim.x - 1 - blockIdx.x;  // long causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / group;
  const int tid = threadIdx.x;
  const int wg = tid / 128;                   // warpgroup: query rows 64 wg..
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int q0 = qt * kBQ;
  const int w0 = q0 + 64 * wg;                // this warpgroup's first row
  const int qi_lo = w0 + 16 * warp + lane / 4;  // rows of fragment halves
  const int qi_hi = qi_lo + 8;
  const bf16* qb = q + (long long)b * qsb + (long long)q0 * qss +
                   (long long)h * qsh;
  const bf16* kb = k + (long long)b * ksb + (long long)hk * ksh;
  const bf16* vb = v + (long long)b * vsb + (long long)hk * vsh;

  // the block's K tiles: as the f32 kernel's, from t0
  const int q_last = min(q0 + kBQ - 1, Sq - 1);
  int nt = (Sk + kBK - 1) / kBK;
  if (causal) nt = min(nt, q_last / kBK + 1);
  int t0 = 0;
  if (window > 0 && q_last < Sk + window - 1)
    t0 = max(0, q0 - window + 1) / kBK;
  // this warpgroup: keys <= lo_* are masked; a row without keys walks all
  const int lo_lo = window > 0 ? qi_lo - window : -1;
  const int lo_hi = window > 0 ? qi_hi - window : -1;
  const bool wg_all =
      window > 0 && min(w0 + 63, Sq - 1) >= Sk + window - 1;

  load_tile<kBQ, HDB>(sQ, qb, Sq - q0, hd, qss, qsd, vec, tid);
  load_kv<HDB>(sm + kQBytes + (t0 & 1) * 2 * kTBytes, kb, vb, t0 * kBK, Sk,
               hd, kss, ksd, vss, vsd, vec, tid);
  cp_async_commit();

  float o[kNB][32];
#pragma unroll
  for (int n = 0; n < kNB; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[n][i] = 0.0f;
  float m_lo = kNegInf, m_hi = kNegInf, l_lo = 0.0f, l_hi = 0.0f;
  const bool rows_live = w0 < Sq;

  for (int t = t0; t < nt; ++t) {
    unsigned char* sK = sm + kQBytes + (t & 1) * 2 * kTBytes;
    unsigned char* sV = sK + kTBytes;
    if (t + 1 < nt)
      load_kv<HDB>(sm + kQBytes + ((t + 1) & 1) * 2 * kTBytes, kb, vb,
                   (t + 1) * kBK, Sk, hd, kss, ksd, vss, vsd, vec, tid);
    cp_async_commit();
    cp_async_wait<1>();  // tile t (and Q) have landed; t + 1 may be in flight
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    const int k0 = t * kBK;
    if (rows_live && (!causal || k0 <= w0 + 63) &&
        (window <= 0 || wg_all || k0 + kBK - 1 > w0 - window)) {
      // S = Q K^T for this warpgroup's 64 rows
      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.0f;
      const uint32_t qa = smem_u32(sQ) + wg * 64 * 128;
      const uint32_t ka = smem_u32(sK);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < HDB / 16; ++ks)
        mma_ss(s, desc(qa + (ks / 4) * kBQ * 128 + (ks % 4) * 32, 16, 1024),
               desc(ka + (ks / 4) * kBK * 128 + (ks % 4) * 32, 16, 1024));
      wgmma_commit();
      wgmma_wait0();
      keep(s);

      // online softmax, base 2: register 4 j + e (+2) holds row qi_lo
      // (qi_hi), key k0 + 8 j + 2 (lane % 4) + e
      const bool masked = k0 + kBK > Sk || (causal && k0 + kBK - 1 > w0) ||
                          (window > 0 && k0 <= w0 + 63 - window);
      float mx_lo = kNegInf, mx_hi = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kj = k0 + 8 * j + 2 * (lane % 4) + e;
          float a = s[4 * j + e] * scale_log2;
          float c = s[4 * j + 2 + e] * scale_log2;
          if (masked) {
            if ((causal && kj > qi_lo) || kj <= lo_lo) a = kNegInf;
            if ((causal && kj > qi_hi) || kj <= lo_hi) c = kNegInf;
            if (kj >= Sk) a = c = -INFINITY;
          }
          s[4 * j + e] = a;
          s[4 * j + 2 + e] = c;
          mx_lo = fmaxf(mx_lo, a);
          mx_hi = fmaxf(mx_hi, c);
        }
      }
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
      const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
      const float corr_lo = ex2(m_lo - mn_lo), corr_hi = ex2(m_hi - mn_hi);
      m_lo = mn_lo;
      m_hi = mn_hi;
      float ps_lo = 0.0f, ps_hi = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[4 * j + e] = ex2(s[4 * j + e] - mn_lo);
          s[4 * j + 2 + e] = ex2(s[4 * j + 2 + e] - mn_hi);
          ps_lo += s[4 * j + e];
          ps_hi += s[4 * j + 2 + e];
        }
      }
      l_lo = l_lo * corr_lo + ps_lo;
      l_hi = l_hi * corr_hi + ps_hi;
#pragma unroll
      for (int n = 0; n < kNB; ++n)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          o[n][4 * j] *= corr_lo;
          o[n][4 * j + 1] *= corr_lo;
          o[n][4 * j + 2] *= corr_hi;
          o[n][4 * j + 3] *= corr_hi;
        }
      // p as the register-A fragment of each 16-key slice kk: registers
      // (row lo, keys 0-7), (row hi, keys 0-7), (row lo, 8-15), (row hi, 8-15)
      uint32_t pa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          pa[kk][i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);

      // O += P V: 16 keys (two 8-row swizzle atoms, 2048 bytes) per slice
      const uint32_t va = smem_u32(sV);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int n = 0; n < kNB; ++n)
          mma_rs(o[n], pa[kk],
                 desc(va + n * kBK * 128 + kk * 2048, kBK * 128, 1024));
      wgmma_commit();
      wgmma_wait0();
#pragma unroll
      for (int n = 0; n < kNB; ++n) keep(o[n]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) keep(pa[kk]);
    }
    __syncthreads();  // every reader of stage t & 1 is done before reuse
  }

  if (!rows_live) return;
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
  if (lse != nullptr && lane % 4 == 0) {
    // m is in base-2 units of the scaled score: lse = (m + log2 l) ln 2
    const float ln2 = 0.6931471805599453f;
    float* lp = lse + ((long long)b * H + h) * Sq;
    if (qi_lo < Sq) lp[qi_lo] = (m_lo + log2f(l_lo)) * ln2;
    if (qi_hi < Sq) lp[qi_hi] = (m_hi + log2f(l_hi)) * ln2;
  }
  const float inv_lo = 1.0f / fmaxf(l_lo, 1e-30f);
  const float inv_hi = 1.0f / fmaxf(l_hi, 1e-30f);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qi = half ? qi_hi : qi_lo;
    if (qi >= Sq) continue;
    const float inv = half ? inv_hi : inv_lo;
    bf16* op = out + (((long long)b * Sq + qi) * H + h) * hd;
#pragma unroll
    for (int n = 0; n < kNB; ++n)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 64 * n + 8 * j + 2 * (lane % 4);
        const float x0 = o[n][4 * j + 2 * half] * inv;
        const float x1 = o[n][4 * j + 2 * half + 1] * inv;
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
}

template <int HDB>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int H, int Hkv, int hd, const long long* s,
           int causal, int window, float scale, float* lse,
           cudaStream_t stream) {
  constexpr int smem = smem_bytes<HDB>();
  static bool ready = false;  // the attribute is set once per instantiation
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_tc<HDB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  // cp.async needs unit hd stride and 16-byte-aligned rows
  bool vec = s[3] == 1 && s[7] == 1 && s[11] == 1;
  for (int i = 0; i < 12; ++i)
    if (i % 4 != 3 && s[i] % 8 != 0) vec = false;
  const void* ptrs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i)
    if ((uintptr_t)ptrs[i] % 16 != 0) vec = false;
  const float log2e = 1.4426950408889634f;
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_attention_tc<HDB><<<grid, kThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, Sq, Sk, H,
      H / Hkv, hd, s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9],
      s[10], s[11], causal, window, scale * log2e, (int)vec, lse);
  return (int)cudaGetLastError();
}

// hd is padded with zeros to its bucket
int bucket(int hd) { return hd <= 64 ? 64 : hd <= 128 ? 128 : 256; }

int dispatch(const void* q, const void* k, const void* v, void* out, int B,
             int Sq, int Sk, int H, int Hkv, int hd, const long long* s,
             int causal, int window, float scale, float* lse,
             cudaStream_t stream) {
  switch (bucket(hd)) {
    case 64:
      return launch<64>(q, k, v, out, B, Sq, Sk, H, Hkv, hd, s, causal, window, scale, lse, stream);
    case 128:
      return launch<128>(q, k, v, out, B, Sq, Sk, H, Hkv, hd, s, causal, window, scale, lse, stream);
    default:
      return launch<256>(q, k, v, out, B, Sq, Sk, H, Hkv, hd, s, causal, window, scale, lse, stream);
  }
}

// The runtime's attributes of the instantiation that hd launches: registers
// a thread, local (spill) bytes a thread, static and maximum dynamic shared
// memory a block (the latter as set by the first launch of that bucket)
int attributes(int hd, int* out) {
  cudaFuncAttributes a;
  const int hb = bucket(hd);
  const void* f = hb == 64    ? (const void*)flash_attention_tc<64>
                  : hb == 128 ? (const void*)flash_attention_tc<128>
                              : (const void*)flash_attention_tc<256>;
  const cudaError_t e = cudaFuncGetAttributes(&a, f);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = a.maxDynamicSharedSizeBytes;
  return 0;
}

}  // namespace tc

}  // namespace

// q, k, v are device pointers read through their element strides
// (b, s, h, d) for q, then k, then v (12 values); out is a contiguous
// (B, Sq, H, hd) buffer of the inputs' dtype (0 = f32, 1 = bf16); lse, if
// not null, a contiguous f32 (B, H, Sq) buffer for the row log-sum-exp;
// window >= 1 masks key j for query i unless j > i - window, 0 is none.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int B, int Sq, int Sk, int H,
                               int Hkv, int hd, long long qsb, long long qss,
                               long long qsh, long long qsd, long long ksb,
                               long long kss, long long ksh, long long ksd,
                               long long vsb, long long vss, long long vsh,
                               long long vsd, int causal, int window,
                               float scale, int bf16, float* lse,
                               void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || Hkv < 1 || H % Hkv != 0 || hd < 1 ||
      hd > 256 || H > 65535 || B > 65535 || window < 0)
    return (int)cudaErrorInvalidValue;
  const long long s[12] = {qsb, qss, qsh, qsd, ksb, kss,
                           ksh, ksd, vsb, vss, vsh, vsd};
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return tc::dispatch(q, k, v, out, B, Sq, Sk, H, Hkv, hd, s, causal, window,
                        scale, lse, st);
  return dispatch(q, k, v, out, B, Sq, Sk, H, Hkv, hd, s, causal, window,
                  scale, lse, st);
}

// The tensor-core kernel's runtime attributes for head dim hd, into out[4]:
// registers, local bytes (a thread), static shared bytes, maximum dynamic
// shared bytes (a block). Returns a cudaError_t.
extern "C" int flash_attention_tc_attributes(int hd, int* out) {
  if (hd < 1 || hd > 256) return (int)cudaErrorInvalidValue;
  return tc::attributes(hd, out);
}
