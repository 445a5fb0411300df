// The bf16 wgmma building blocks shared by the tensor-core attention
// kernels: the forward (flash_attention.cu, flash_attention_tc) and the
// backward (flash_attention_bwd.cu, bwd_dq_tc and bwd_dkdv_tc). Moved here
// unchanged from the forward's source, so both compile the same helpers.
//
// Tiles live in shared memory in the 128-byte swizzle that wgmma's
// descriptors read (swz, desc); 16-byte cp.async copies fill them with
// zeros past the ragged row and hd edges (cp_async16, load_tile, load_kv);
// mma_ss runs a 64 x 64 x 16 bf16 product with both operands K-major in
// shared memory, mma_rs one with A from registers (the f32 accumulator
// fragment, rounded to bf16 by pack_bf16) and B MN-major in shared memory.
// Each block has kThreads = 256 threads: two warpgroups of 128.
//
// kernels/_build.py hashes every header under csrc/ into each library's
// name, so an edit here rebuilds both sources.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace tc {

typedef __nv_bfloat16 bf16;
constexpr int kBQ = 128;      // query rows per block: two warpgroups of 64
constexpr int kBK = 64;       // keys per K/V tile
constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of element (r, c) in a tile of `rows` rows held in the
// 128-byte swizzle: hd blocks of 64 elements, each rows x 128 bytes, the
// 16-byte chunk (c % 64) / 8 of row r stored at chunk ((c % 64) / 8) ^ (r % 8).
__device__ __forceinline__ uint32_t swz(int rows, int r, int c) {
  return (uint32_t)((c >> 6) * rows * 128 + r * 128 +
                    ((((c >> 3) & 7) ^ (r & 7)) << 4) + (c & 7) * 2);
}

// wgmma shared-memory descriptor, 128-byte swizzle; offsets in bytes
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// 2^x on the special-function unit (subnormal results flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep registers that an in-flight wgmma reads or writes live, and in
// place, up to this point
__device__ __forceinline__ void keep(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void keep(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// d (64 x 64, f32) += A (64 x 16) B (16 x 64), both bf16 from shared
// memory, K-major
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t da,
                                       uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 64, f32) += A (64 x 16, bf16 in registers) B (16 x 64, bf16 in
// shared memory, MN-major: the transpose bit)
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4],
                                       uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// 16-byte copy to shared memory, zero past the first `bytes` bytes
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

// Rows [0, R) x hd columns [0, HDB) of a tile whose row 0 is `src`: rows
// >= nvalid and columns >= hd are zero. vec: 16-byte cp.async (unit hd
// stride, 16-byte-aligned rows); else element-wise loads and stores.
template <int R, int HDB>
__device__ __forceinline__ void load_tile(unsigned char* dst,
                                          const bf16* src, int nvalid,
                                          int hd, long long rs, long long ds,
                                          bool vec, int tid) {
  if (vec) {
    const uint32_t base = smem_u32(dst);
    for (int e = tid; e < R * HDB / 8; e += kThreads) {
      const int r = e / (HDB / 8), c = (e % (HDB / 8)) * 8;
      int bytes = 0;
      const bf16* p = src;
      if (r < nvalid && c < hd) {
        bytes = min(16, (hd - c) * 2);
        p = src + (long long)r * rs + c;
      }
      cp_async16(base + swz(R, r, c), p, bytes);
    }
  } else {
    for (int e = tid; e < R * HDB; e += kThreads) {
      const int r = e / HDB, c = e % HDB;
      bf16 x = __float2bfloat16(0.0f);
      if (r < nvalid && c < hd) x = src[(long long)r * rs + (long long)c * ds];
      *reinterpret_cast<bf16*>(dst + swz(R, r, c)) = x;
    }
  }
}

// The K and V tiles of keys [k0, k0 + kBK) into dst and dst + one tile.
// On the cp.async path with 256 % (HDB / 8) == 0 every thread copies the
// same 16-byte column chunk c of rows r0, r0 + kStep, ... of each tile, so
// its addressing costs a few adds a chunk; otherwise load_tile.
template <int HDB>
__device__ __forceinline__ void load_kv(unsigned char* dst, const bf16* kb,
                                        const bf16* vb, int k0, int Sk,
                                        int hd, long long kss, long long ksd,
                                        long long vss, long long vsd,
                                        bool vec, int tid) {
  constexpr int kPerRow = HDB / 8;  // 16-byte chunks per row
  if (vec && kThreads % kPerRow == 0) {
    constexpr int kStep = kThreads / kPerRow;  // rows apart: a multiple of 8
    const int r0 = tid / kPerRow, c = (tid % kPerRow) * 8;
    const int bytes = c < hd ? min(16, (hd - c) * 2) : 0;
    const uint32_t sk = smem_u32(dst) + swz(kBK, r0, c);  // same swizzle
    const uint32_t sv = sk + kBK * HDB * 2;                 // for every i
    const bf16* pk = kb + (long long)(k0 + r0) * kss + c;
    const bf16* pv = vb + (long long)(k0 + r0) * vss + c;
#pragma unroll
    for (int i = 0; i < kBK / kStep; ++i) {
      const int n = k0 + r0 + i * kStep < Sk ? bytes : 0;
      cp_async16(sk + i * kStep * 128, n ? pk + (long long)i * kStep * kss : kb, n);
      cp_async16(sv + i * kStep * 128, n ? pv + (long long)i * kStep * vss : vb, n);
    }
  } else {
    load_tile<kBK, HDB>(dst, kb + (long long)k0 * kss, Sk - k0, hd, kss, ksd,
                        vec, tid);
    load_tile<kBK, HDB>(dst + kBK * HDB * 2, vb + (long long)k0 * vss, Sk - k0,
                        hd, vss, vsd, vec, tid);
  }
}

}  // namespace tc
}  // namespace
