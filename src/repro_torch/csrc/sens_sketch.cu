// Fused Eq. 8 sensitivity + hashed Rademacher sketch on Hopper, for B
// members x L leaves of a flat layout in one call:
//
//   out[b, r] = (1/sqrt(k)) * sum_l sum_j sign_lr(j) * s[b, off_l + j]
//   s = |g*theta - 0.5*F*theta^2|
//   sign_lr(j) = +1 iff top bit of pcg(seed_l ^ pcg((base_l + j) * k + r)) is 0
//
// Replaces the Pallas TPU kernel repro/kernels/sens_sketch.py
// (sens_sketch_pallas -> _sens_sketch_kernel, hash _pcg), and the
// per-leaf launches of repro/kernels/ops.py sketch_tree_fused: one call
// covers every leaf of a tree and every member of a wave. The (k x d)
// projection is never materialised and s never leaves registers.
//
// Bound: the INT32 pipe, not HBM. Each element is read once (12 bytes:
// theta, g, F) but costs 2k PCG hashes. Per (element, row) the function
// needs 9 operations that only the INT32 pipe executes (chip_smoke.py
// derives them) beside 3 multiplies and an add on the FMA pipe: 144 INT32
// operations per element at the paper's k = 16, against 12 bytes of HBM.
//
// Design (what it does about that):
//   Hash. Element j's inner states for rows r are one per-thread base plus
//   a compile-time constant (x * A + C with x = (base + j) * k + r is
//   base_state + (v*k + r) * A), the seed XOR rides in the inner hash's
//   last three-input LOP3, the outer hash stops at its multiply (only bit
//   31 is read, and word >> 22 has a zero top bit), and the sign lands on
//   s with one LOP3 on its sign bit.
//   Tiles. The wrapper cuts every leaf into tiles of 2,048 elements (the
//   last one shorter) and keeps one record per tile on the device, per
//   layout, seed and k: the tile's first element in a row, its length, its
//   leaf's seed and the inner hash state of its first element. A tile never
//   crosses a leaf, so a block finds its hash index with no search.
//   One launch. A grid sized from the SM count and the kernel's occupancy
//   (at most 8 rounds of the blocks the card holds at once) walks the
//   (member, tile) items. Per item a thread takes 4 consecutive elements a
//   step (one 16-byte load a stream where the row is aligned, scalar loads
//   otherwise), keeps k sums in registers (k is a template parameter: 1,
//   4, 16 or 32), and the block reduces them in a fixed order (a
//   transposing warp reduction, then the warps in order) into one (k,)
//   partial per item. An integer ticket per member counts its finished
//   items; the block that takes the last ticket sums the member's
//   partials in tile order and scales by 1/sqrt(k). The ticket only picks
//   which block adds; the order of the additions is a function of the
//   shapes alone, so repeated runs give identical bits. No floating-point
//   atomics.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 4;                   // consecutive elements a thread takes a step
constexpr int kStep = kThreads * kVec;    // elements a block takes a step
// resident blocks an SM the registers must allow: <= 64 a thread, 85 at k = 32
template <int K>
constexpr int min_blocks() { return K == 32 ? 3 : 4; }
constexpr int kWaves = 8;                 // blocks: at most 8 rounds of residents
constexpr uint32_t kMulA = 747796405u, kAddC = 2891336453u, kMulB = 277803737u;

// kMode 0 is the kernel. The probe instantiations (k = 16) also write each
// block's SM clock and global timer at its start and end; kMode 2 replaces
// the loads by values made from the index, to time the hashing alone.
constexpr int kClocked = 1, kNoLoads = 2;

// pcg up to its final xor-shift: ((state >> ((state >> 28) + 4)) ^ state) * B
__device__ __forceinline__ uint32_t pcg_word(uint32_t state) {
  return ((state >> ((state >> 28u) + 4u)) ^ state) * kMulB;
}

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Sum each of v[0..K) over the warp's 32 lanes. Each halving step trades
// half of a lane's values with its partner lane (lane ^ K / 2H), so K sums
// take K - 1 shuffles instead of 5K; lane l ends with row
// bitreverse(l mod K). A template recursion, so that every index is a
// constant and v stays in registers.
template <int K, int H>
struct Halve {
  __device__ static __forceinline__ void run(float (&v)[K], int lane) {
    constexpr int kPartner = K / (2 * H);
    const bool up = lane & kPartner;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const float send = up ? v[i] : v[i + H];
      const float keep = up ? v[i + H] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, kPartner);
    }
    Halve<K, H / 2>::run(v, lane);
  }
};
template <int K>
struct Halve<K, 0> {
  __device__ static __forceinline__ void run(float (&)[K], int) {}
};

template <int K>
__device__ __forceinline__ float warp_reduce_rows(float (&v)[K], int lane) {
  Halve<K, K / 2>::run(v, lane);
  float x = v[0];
#pragma unroll
  for (int o = K; o < 32; o *= 2) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int K>
__device__ __forceinline__ int reduced_row(int lane) {
  constexpr int kLog = K == 1 ? 0 : K == 4 ? 2 : K == 16 ? 4 : 5;
  return kLog == 0 ? 0 : (int)(__brev((unsigned)lane) >> (32 - kLog));
}

// The last block to finish one of member b's items sums the member's
// partials in tile order: thread (j, r) adds tiles j, j + kThreads/K, ...
// of row r, then thread r adds the j sums in order; it scales by
// 1/sqrt(k), writes out[b] and sets the member's ticket back to 0.
template <int K>
__device__ __forceinline__ void finish_member(const float* __restrict__ partials,
                                              float* __restrict__ out,
                                              int ntiles, int b, float* sums) {
  constexpr int kLanes = kThreads / K;     // threads a row
  const int r = threadIdx.x % K, j = threadIdx.x / K;
  const float* p = partials + (long long)b * ntiles * K + r;
  float v = 0.f;
  for (int t0 = j; t0 < ntiles; t0 += kLanes * 8) {
    float x[8];                            // 8 loads in flight a thread
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int t = t0 + kLanes * u;
      x[u] = t < ntiles ? __ldcg(p + (long long)t * K) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) v += x[u];
  }
  sums[threadIdx.x] = v;
  __syncthreads();
  if (threadIdx.x < K) {
    float y = 0.f;
    for (int i = 0; i < kLanes; ++i) y += sums[i * K + threadIdx.x];
    out[(long long)b * K + threadIdx.x] = y / sqrtf((float)K);
  }
}

// tiles: (ntiles, 4) int64 records [first element in a row, length, seed,
// inner state of the first element]; items = members * ntiles, member-major;
// tickets: (members,) zeros, the count of each member's finished items.
template <int K, int kMode>
__global__ void __launch_bounds__(kThreads, min_blocks<K>())
sens_sketch_tiles(const float* __restrict__ theta, const float* __restrict__ g,
                  const float* __restrict__ f, long long ld,
                  const long long* __restrict__ tiles, int ntiles,
                  int items, int aligned,
                  float* __restrict__ partials, unsigned* __restrict__ tickets,
                  float* __restrict__ out, long long* __restrict__ clocks) {
  __shared__ float red[2][kWarps][K];
  __shared__ float sums[kThreads];
  __shared__ bool last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long clk0 = 0, ns0 = 0;
  if (kMode != 0 && threadIdx.x == 0) {
    ns0 = global_ns();
    clk0 = clock64();
  }
  int buf = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int b = item / ntiles, t = item - b * ntiles;
    const longlong2* rec = reinterpret_cast<const longlong2*>(tiles) + 2 * t;
    const longlong2 where = rec[0], hash = rec[1];
    const long long row0 = (long long)b * ld + where.x;
    const int n = (int)where.y;
    const uint32_t seed = (uint32_t)hash.x, state0 = (uint32_t)hash.y;
    const bool vec = aligned && (row0 & 3) == 0;
    const float* tp = theta + row0;
    const float* gp = g + row0;
    const float* fp = f + row0;
    float acc[K];
#pragma unroll
    for (int r = 0; r < K; ++r) acc[r] = 0.f;
#pragma unroll 1
    for (int e = threadIdx.x * kVec; e < n; e += kStep) {
      float s[kVec];
      if (kMode == kNoLoads) {
#pragma unroll
        for (int v = 0; v < kVec; ++v)
          s[v] = __int_as_float(0x3f800000u | (uint32_t)((e + v) & 0xffff));
      } else {
        float tv[kVec], gv[kVec], fv[kVec];
        if (vec && e + kVec <= n) {
          const float4 a = *reinterpret_cast<const float4*>(tp + e);
          const float4 c = *reinterpret_cast<const float4*>(gp + e);
          const float4 d = *reinterpret_cast<const float4*>(fp + e);
          tv[0] = a.x; tv[1] = a.y; tv[2] = a.z; tv[3] = a.w;
          gv[0] = c.x; gv[1] = c.y; gv[2] = c.z; gv[3] = c.w;
          fv[0] = d.x; fv[1] = d.y; fv[2] = d.z; fv[3] = d.w;
        } else {
#pragma unroll
          for (int v = 0; v < kVec; ++v) {
            const bool in = e + v < n;
            tv[v] = in ? tp[e + v] : 0.f;
            gv[v] = in ? gp[e + v] : 0.f;
            fv[v] = in ? fp[e + v] : 0.f;
          }
        }
        // torch's order, unfused: g*theta - (0.5*F)*theta^2
#pragma unroll
        for (int v = 0; v < kVec; ++v)
          s[v] = fabsf(__fsub_rn(__fmul_rn(gv[v], tv[v]),
                                 __fmul_rn(__fmul_rn(0.5f, fv[v]),
                                           __fmul_rn(tv[v], tv[v]))));
      }
      const uint32_t st = state0 + (uint32_t)e * ((uint32_t)K * kMulA);
#pragma unroll
      for (int v = 0; v < kVec; ++v) {
        const uint32_t sb = __float_as_uint(s[v]);
#pragma unroll
        for (int r = 0; r < K; ++r) {
          const uint32_t w1 = pcg_word(st + (uint32_t)(v * K + r) * kMulA);
          const uint32_t w2 = pcg_word(((w1 >> 22u) ^ w1 ^ seed) * kMulA + kAddC);
          acc[r] += __uint_as_float(sb ^ (w2 & 0x80000000u));
        }
      }
    }
    const float x = warp_reduce_rows<K>(acc, lane);
    if (lane < K) red[buf][warp][reduced_row<K>(lane)] = x;
    __syncthreads();
    if (warp == 0) {
      if (lane < K) {
        float v = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) v += red[buf][w][lane];
        partials[(long long)item * K + lane] = v;
        __threadfence();                   // the partial before the ticket
      }
      __syncwarp();
      if (lane == 0) last = atomicAdd(&tickets[b], 1u) == (unsigned)ntiles - 1;
    }
    __syncthreads();
    if (last) {                            // block-uniform
      __threadfence();
      finish_member<K>(partials, out, ntiles, b, sums);
      if (threadIdx.x == 0) tickets[b] = 0;
      __syncthreads();                     // sums and last are reused
    }
    buf ^= 1;   // the next item writes the other red buffer
  }
  if (kMode != 0 && threadIdx.x == 0) {
    const long long clk1 = clock64(), ns1 = global_ns();
    clocks[4 * blockIdx.x + 0] = clk0;
    clocks[4 * blockIdx.x + 1] = clk1;
    clocks[4 * blockIdx.x + 2] = ns0;
    clocks[4 * blockIdx.x + 3] = ns1;
  }
}

// Blocks for `items` at this k: one an item, at most kWaves
// rounds of the blocks the card holds at once (SMs x the kernel's resident
// blocks an SM, read once per device); the same blocks walk further items.
template <int K>
int pass1_grid(int items, int* sms_out, int* per_out) {
  constexpr int kDevices = 16;
  static int sms_of[kDevices], per_of[kDevices];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= kDevices) return 0;
  if (sms_of[dev] == 0) {
    cudaDeviceGetAttribute(&sms_of[dev], cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_of[dev], sens_sketch_tiles<K, 0>, kThreads, 0);
  }
  const int sms = sms_of[dev], per = per_of[dev];
  if (sms_out) *sms_out = sms;
  if (per_out) *per_out = per;
  if (sms < 1 || per < 1) return 0;
  return (int)std::min<long long>(items, (long long)sms * per * kWaves);
}

template <int K, int kMode>
int launch(const float* theta, const float* g, const float* f, long long ld,
           int members, const long long* tiles, int ntiles, int aligned,
           float* partials, unsigned* tickets, float* out, int grid,
           long long* clocks, cudaStream_t stream) {
  const int items = members * ntiles;
  if (grid <= 0) grid = pass1_grid<K>(items, nullptr, nullptr);
  if (grid <= 0) return (int)cudaErrorInvalidConfiguration;
  sens_sketch_tiles<K, kMode><<<grid, kThreads, 0, stream>>>(
      theta, g, f, ld, tiles, ntiles, items, aligned, partials, tickets, out,
      clocks);
  return (int)cudaGetLastError();
}

bool valid_call(long long ld, int members, int ntiles, int grid) {
  return ld >= 1 && members >= 1 && ntiles >= 1 && grid >= 0 &&
         (long long)members * ntiles <= 0x7fffffffLL;
}

}  // namespace

// theta, g, f: (members, ld) contiguous f32 device rows in one flat layout;
// tiles: (ntiles, 4) int64 device records (see sens_sketch_tiles); aligned:
// the three base pointers are 16-byte aligned; partials: (members * ntiles, k)
// f32 scratch; tickets: (members,) uint32 device zeros, left zero again;
// out: (members, k) f32. grid 0 sizes the grid from the SM count
// (sens_sketch_grid). Launches the kernel on `stream` (calls that share
// `tickets` must not overlap) and returns cudaGetLastError(). k must be
// 1, 4, 16 or 32.
extern "C" int sens_sketch_rows_f32(const void* theta, const void* g,
                                    const void* f, long long ld, int members,
                                    const void* tiles, int ntiles, int aligned,
                                    void* partials, void* tickets, void* out,
                                    int k, int grid, void* stream) {
  if (!valid_call(ld, members, ntiles, grid))
    return (int)cudaErrorInvalidValue;
#define SKETCH_CASE(KK)                                                       \
  case KK:                                                                    \
    return launch<KK, 0>((const float*)theta, (const float*)g,                \
                         (const float*)f, ld, members,                        \
                         (const long long*)tiles, ntiles, aligned,            \
                         (float*)partials, (unsigned*)tickets, (float*)out,   \
                         grid, nullptr, (cudaStream_t)stream);
  switch (k) {
    SKETCH_CASE(1)
    SKETCH_CASE(4)
    SKETCH_CASE(16)
    SKETCH_CASE(32)
    default: return (int)cudaErrorInvalidValue;
  }
#undef SKETCH_CASE
}

// The grid sens_sketch_rows_f32 launches for `items` = members * ntiles
// at this k on the current device, with the SM count and the kernel's
// resident blocks an SM it was sized from; 0 for a bad k.
extern "C" int sens_sketch_grid(int k, int items, int* sms, int* per_sm) {
  switch (k) {
    case 1: return pass1_grid<1>(items, sms, per_sm);
    case 4: return pass1_grid<4>(items, sms, per_sm);
    case 16: return pass1_grid<16>(items, sms, per_sm);
    case 32: return pass1_grid<32>(items, sms, per_sm);
    default: return 0;
  }
}

// The k = 16 kernel for chip_smoke.py's timing phase, on a given grid:
// mode 1 as launched, mode 2 with the loads replaced by values made from
// the index; both also write clocks[4 * block + 0..3] = the block's SM
// clock at its start and end and its global timer (ns) at its start and
// end. clocks: (grid, 4) int64 device memory, grid > 0; the other
// arguments as for sens_sketch_rows_f32.
extern "C" int sens_sketch_probe_f32(const void* theta, const void* g,
                                     const void* f, long long ld, int members,
                                     const void* tiles, int ntiles,
                                     int aligned, void* partials,
                                     void* tickets, void* out, int grid,
                                     int mode, void* clocks, void* stream) {
  if (!valid_call(ld, members, ntiles, grid) || grid < 1 ||
      (mode != kClocked && mode != kNoLoads))
    return (int)cudaErrorInvalidValue;
  auto run = mode == kClocked ? launch<16, kClocked> : launch<16, kNoLoads>;
  return run((const float*)theta, (const float*)g, (const float*)f, ld,
             members, (const long long*)tiles, ntiles, aligned,
             (float*)partials, (unsigned*)tickets, (float*)out, grid,
             (long long*)clocks, (cudaStream_t)stream);
}
