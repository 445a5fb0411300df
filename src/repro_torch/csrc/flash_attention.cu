// Flash attention forward on Hopper: online-softmax GQA attention, causal
// (top-left: key j is seen by query i iff j <= i) or bidirectional.
// q (B, Sq, H, hd), k and v (B, Sk, Hkv, hd) with H % Hkv == 0 -> out
// (B, Sq, H, hd) in q's dtype (f32 or bf16); all softmax and PV math in f32.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention -> _flash_kernel). The port's models/layers.py
// attention_forward calls it once per attention layer of a prefill.
//
// Bound: at the serve shape (B = 8, S = 2048, H = 24, Hkv = 8, hd = 128,
// causal) the unmasked (query, key) pairs need 4 hd FLOP each (QK^T and PV),
// 2.06e11 FLOP, against 268 MB of q, k, v and o. The serve path's operands
// are bf16, whose card rate is the tensor cores' (989 TFLOP/s; a bf16 x bf16
// product is exact in f32): a 0.21 ms operation bound, against 80 us for
// HBM. This kernel runs both products in IEEE fp32 on the CUDA cores, as the
// reference's kernel does, so its own pipe caps it at about 3.1 ms
// (67 TFLOP/s): a tensor-core path is the next step (ROADMAP.md).
//
// Design: one block per (b, h, 64-query tile); grid (q tiles, H, B), the
// q-tile index reversed so the long causal tiles start first. 256 threads,
// two blocks per SM at hd <= 128 (launch bound):
// each query row is owned by 4 neighbouring lanes of one warp, and each lane
// holds 1/4 of the row's q and of its f32 accumulator in registers, as
// 4-float chunks c = sub + 4 i (so the four lanes' 16-byte shared loads fall
// on distinct banks). The K loop walks kBK-key tiles in order: each K and V
// tile is staged in shared memory, converted to f32 on load (bf16 read
// natively), zero outside the ragged Sk / hd edges. A lane computes its
// partial q.k for every key of the tile; two xor-shuffles sum the four
// partials inside the warp, so every lane of the row holds the full score.
// Masked scores are -1e30 (the reference's NEG_INF), the running max m, sum
// l and accumulator follow the reference's update (corr = exp(m - m_new)),
// and the output is acc / max(l, 1e-30). Causal K tiles wholly above the
// diagonal are skipped: tile 0 always holds key 0, which every query sees,
// so m is finite after it and a skipped tile would add p = 0 with corr = 1.
// The inputs are read through their element strides (no transposes or
// copies), and query head h reads kv head h / (H / Hkv). No atomics and a
// fixed key order: repeated runs give identical bits. hd is a template bucket
// (32, 64, 128, 256) with zero-filled tails.
//
// Simple and correct first: no tensor cores, no cp.async / TMA pipelining.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;         // query rows per block
constexpr int kLanes = 4;       // lanes per query row
constexpr int kThreads = kBQ * kLanes;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <int HD>
struct Tile {
  static constexpr int kBK = HD <= 128 ? 32 : 16;  // keys per K/V tile
  static constexpr int kChunks = HD / (4 * kLanes);  // float4 chunks per lane
  // blocks per SM the register budget must allow: at hd 128 the compiler
  // takes 172 registers a thread unbounded (one block per SM); capped at
  // 128 (a few spilled bytes) two blocks fit, 15% faster on the H100
  static constexpr int kMinBlocks = HD <= 128 ? 2 : 1;
};

template <int HD, typename T>
__global__ void __launch_bounds__(kThreads, Tile<HD>::kMinBlocks)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int Sq,
                       int Sk, int H, int group, int hd, long long qsb,
                       long long qss, long long qsh, long long qsd,
                       long long ksb, long long kss, long long ksh,
                       long long ksd, long long vsb, long long vss,
                       long long vsh, long long vsd, int causal, float scale) {
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
  const T* qp = q + (long long)b * qsb + (long long)qi * qss + (long long)h * qsh;
#pragma unroll
  for (int i = 0; i < kC; ++i) {
    const int d0 = 4 * (sub + kLanes * i);
    float e[4];
#pragma unroll
    for (int t = 0; t < 4; ++t)
      e[t] = (live && d0 + t < hd) ? to_f32(qp[(long long)(d0 + t) * qsd]) : 0.0f;
    qr[i] = make_float4(e[0], e[1], e[2], e[3]);
  }
  float4 acc[kC];
#pragma unroll
  for (int i = 0; i < kC; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  float m = kNegInf, l = 0.0f;

  // K tiles this block needs: all of them, or (causal) those holding a key
  // <= the block's last live query
  const int nk = (Sk + kBK - 1) / kBK;
  int nt = nk;
  if (causal) {
    const int q_last = min(qt * kBQ + kBQ - 1, Sq - 1);
    nt = min(nk, q_last / kBK + 1);
  }
  const T* kb = k + (long long)b * ksb + (long long)hk * ksh;
  const T* vb = v + (long long)b * vsb + (long long)hk * vsh;

  for (int t = 0; t < nt; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < kBK * HD; e += kThreads) {
      const int r = e / HD, d = e % HD;
      const bool in = k0 + r < Sk && d < hd;
      const long long kr = (long long)(k0 + r);
      Ks[e] = in ? to_f32(kb[kr * kss + (long long)d * ksd]) : 0.0f;
      Vs[e] = in ? to_f32(vb[kr * vss + (long long)d * vsd]) : 0.0f;
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
      const bool ok = kj < Sk && (!causal || kj <= qi);
      s[j] = ok ? part * scale : kNegInf;
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
  const float inv = 1.0f / fmaxf(l, 1e-30f);
  T* op = out + (((long long)b * Sq + qi) * H + h) * hd;
#pragma unroll
  for (int i = 0; i < kC; ++i) {
    const int d0 = 4 * (sub + kLanes * i);
    const float e[4] = {acc[i].x, acc[i].y, acc[i].z, acc[i].w};
#pragma unroll
    for (int t = 0; t < 4; ++t)
      if (d0 + t < hd) store(op + d0 + t, e[t] * inv);
  }
}

template <int HD, typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int H, int Hkv, int hd, const long long* s,
           int causal, float scale, cudaStream_t stream) {
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel<HD, T><<<grid, kThreads, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, Sq, Sk, H, H / Hkv, hd,
      s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10], s[11],
      causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int B,
             int Sq, int Sk, int H, int Hkv, int hd, const long long* s,
             int causal, float scale, cudaStream_t stream) {
  if (hd <= 32)
    return launch<32, T>(q, k, v, out, B, Sq, Sk, H, Hkv, hd, s, causal, scale, stream);
  if (hd <= 64)
    return launch<64, T>(q, k, v, out, B, Sq, Sk, H, Hkv, hd, s, causal, scale, stream);
  if (hd <= 128)
    return launch<128, T>(q, k, v, out, B, Sq, Sk, H, Hkv, hd, s, causal, scale, stream);
  return launch<256, T>(q, k, v, out, B, Sq, Sk, H, Hkv, hd, s, causal, scale, stream);
}

}  // namespace

// q, k, v are device pointers read through their element strides
// (b, s, h, d) for q, then k, then v (12 values); out is a contiguous
// (B, Sq, H, hd) buffer of the inputs' dtype (0 = f32, 1 = bf16).
// Launches on `stream` and returns cudaGetLastError().
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int B, int Sq, int Sk, int H,
                               int Hkv, int hd, long long qsb, long long qss,
                               long long qsh, long long qsd, long long ksb,
                               long long kss, long long ksh, long long ksd,
                               long long vsb, long long vss, long long vsh,
                               long long vsd, int causal, float scale,
                               int bf16, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || Hkv < 1 || H % Hkv != 0 || hd < 1 ||
      hd > 256 || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const long long s[12] = {qsb, qss, qsh, qsd, ksb, kss,
                           ksh, ksd, vsb, vss, vsh, vsd};
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return dispatch<__nv_bfloat16>(q, k, v, out, B, Sq, Sk, H, Hkv, hd, s,
                                   causal, scale, st);
  return dispatch<float>(q, k, v, out, B, Sq, Sk, H, Hkv, hd, s, causal,
                         scale, st);
}
