// Tensor-core building blocks of the bf16 flash-attention kernels
// (flash_attn_fwd.cu, flash_attn_bwd.cu) for Hopper (sm_90a).
//
// A CTA is one warpgroup (128 threads); it issues wgmma.mma_async of
// shape m64nNk16 (bf16 in, fp32 accumulate), so every tile it owns has
// 64 rows. Operand tiles live in shared memory as bf16 only, staged by
// 16-byte cp.async (zero-filled past T and past the head dim) in rings
// of two stages: the next tile's copy is in flight while the tensor
// cores work on this one.
//
// Shared-memory tile layout (the one wgmma's 128-byte swizzle reads):
// a ROWS x D bf16 tile is stored as padded(D) / 64 column blocks of
// ROWS x 64 elements (128-byte rows); in each block the 16-byte chunk c
// of row r sits at chunk c ^ (r % 8). Every tile starts on a 1024-byte
// boundary, so the swizzle the hardware applies to address bits [4, 7)
// from bits [7, 10) is exactly this one. The same tile serves as a
// K-major operand (K = the tile's columns: q, k as in q . k^T) and as
// an MN-major one (K = the tile's rows: v in p . v, with the transposed
// B flag). Head dims 32 and 96 are padded to 64 and 128 with zeros, so
// products over the head dim as N run on whole 64-wide blocks; products
// over the head dim as K stop at D.
//
// Register fragments: in an m64nN fp32 accumulator, thread t (warp
// w = t / 32, lane l) holds element 4 j + 2 h + b at row 16 w + l / 4 +
// 8 h, column 8 j + 2 (l % 4) + b. The A operand of a register-sourced
// wgmma has the same layout per 16 columns, so a score tile becomes the
// next product's A operand in registers (FlashAttention-3's structure);
// p and ds are split into hi = bf16(x) and lo = bf16(x - hi) there, and
// both halves go through the tensor cores into one fp32 accumulator.
#pragma once

#include "common.cuh"

namespace pk {
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;          // one warpgroup
constexpr int kRows = 64;              // wgmma M: rows of every tile a CTA owns
constexpr float kNegInf = -1e30f;      // the TPU kernel's mask value
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// head dim rounded up to whole 64-element (128-byte) column blocks
__host__ __device__ constexpr int padded(int d) { return (d + 63) / 64 * 64; }

// bytes of one ROWS x D tile in the layout above
__host__ __device__ constexpr int tile_bytes(int rows, int d) {
  return rows * padded(d) * 2;
}

// ---------------------------------------------------------------------------
// shared memory and asynchronous copies
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the first 1024-byte boundary at or after the dynamic shared memory's
// start (launches ask for 1024 bytes more than their tiles need)
__device__ __forceinline__ uint32_t smem_base(const void* smem) {
  return (smem_u32(smem) + 1023u) & ~1023u;
}

__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait for every copy this thread issued, make them visible to the
// async proxy (wgmma reads shared memory through it), then to the CTA
__device__ __forceinline__ void cp_async_land() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
}

// byte offset of 16-byte chunk c of row r in a ROWS-row tile
template <int ROWS>
__device__ __forceinline__ uint32_t chunk_offset(int r, int c) {
  return (c >> 3) * (ROWS * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// Rows [row0, row0 + ROWS) of a [T, D] row-major bf16 matrix into the
// tile at ``dst``; rows past T and columns D..padded(D) are zero-filled
// (the source address is then the matrix's start, never read).
template <int ROWS, int D>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src,
                                          int row0, int T) {
  constexpr int kChunks = padded(D) / 8;          // per tile row
  static_assert(ROWS * kChunks % kThreads == 0, "whole passes only");
#pragma unroll
  for (int it = 0; it < ROWS * kChunks / kThreads; ++it) {
    const int i = it * kThreads + threadIdx.x;
    const int r = i / kChunks, c = i % kChunks;
    const bool full = row0 + r < T && c * 8 < D;
    const bf16* g = full ? src + (size_t)(row0 + r) * D + c * 8 : src;
    cp_async_16(dst + chunk_offset<ROWS>(r, c), g, full);
  }
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// matrix descriptor: start address, leading and stride byte offsets,
// 128-byte swizzle (layout type 1 in bits 62-63), base offset 0
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// K-major operand, K = the tile's columns: k-step kk reads columns
// [16 kk, 16 kk + 16), 32 bytes into column block kk / 4; 8-row groups
// lie 1024 bytes apart
template <int ROWS>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  return make_desc(tile + (kk >> 2) * (ROWS * 128) + (kk & 3) * 32, 16,
                   1024);
}

// MN-major operand, K = the tile's rows: k-step kk reads rows
// [16 kk, 16 kk + 16); 64-wide column blocks (the N direction) lie
// ROWS * 128 bytes apart, 8-row groups (the K direction) 1024
template <int ROWS>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return make_desc(tile + kk * 16 * 128, ROWS * 128, 1024);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving reads or writes of wgmma's registers
// across the fence / wait that order them against the tensor cores
template <int R>
__device__ __forceinline__ void pin(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int K>
__device__ __forceinline__ void pin(uint32_t (&r)[K][4]) {
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[k][i])::"memory");
}

// m64nNk16 products, bf16 in, fp32 accumulate (each N only with the
// forms the kernels use: score tiles of 64 or 32 columns, outputs of 64
// or 128):
//   ss(d, a, b, accumulate): d = a . b (+ d when accumulate != 0), a and
//     b from shared memory, both K-major;
//   rs(d, a, b): d += a . b, a from registers, b MN-major (tnspB = 1).
template <int N>
struct Wgmma;

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t a,
                                            uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "l"(a), "l"(b), "r"(accumulate));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a,
                                            uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(accumulate));
  }
  static __device__ __forceinline__ void rs(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void rs(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

// ---------------------------------------------------------------------------
// fragments
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// hi = bf16(x), lo = bf16(x - hi) of a pair (x, y); x in the low half
__device__ __forceinline__ void split_pair(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

// the A operands (hi and lo halves) of every 16-column k-step of an
// m64nN fp32 accumulator
template <int N>
__device__ __forceinline__ void split_frags(const float (&acc)[N / 2],
                                            uint32_t (&hi)[N / 16][4],
                                            uint32_t (&lo)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      split_pair(acc[8 * kk + 2 * i], acc[8 * kk + 2 * i + 1], hi[kk][i],
                 lo[kk][i]);
}

// reductions over the four threads (a quad) that share a row
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(kFull, v, 1));
  return fmaxf(v, __shfl_xor_sync(kFull, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  return v + __shfl_xor_sync(kFull, v, 2);
}

// the tile row of this thread's accumulator rows (+ 8 for h = 1) and
// the first of its columns (+ 8 j + {0, 1})
__device__ __forceinline__ int frag_row() {
  return 16 * (threadIdx.x >> 5) + ((threadIdx.x & 31) >> 2);
}
__device__ __forceinline__ int frag_col() { return 2 * (threadIdx.x & 3); }

// rows row0 + frag_row() + 8 h of an m64n(padded D) accumulator, each
// divided by div[h], into a [T, D] bf16 matrix; rows past T and the
// padding columns are not written
template <int D>
__device__ __forceinline__ void store_acc(bf16* dst,
                                          const float (&acc)[padded(D) / 2],
                                          int row0, int T,
                                          const float (&div)[2]) {
  const int c0 = frag_col();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + frag_row() + 8 * h;
    if (row >= T) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)row * D + 8 * j + c0) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h] / div[h],
                                acc[4 * j + 2 * h + 1] / div[h]);
  }
}

}  // namespace tc
}  // namespace pk
