// Tile helpers of the fp32 flash-attention kernels, forward and
// backward (flash_attn_fwd_f32.cu, flash_attn_bwd_f32.cu): the CUDA-core
// branch that serves fp32 inputs only. The bf16 kernels run on the
// tensor cores and use flash_tc.cuh.
//
// A CTA of 256 threads works on 64 x 64 tiles: thread (ty, tx) =
// (tid / 16, tid % 16) owns score rows ty + 16 i and key columns
// tx + 16 j (i, j < 4), and output columns 32 jj + 2 tx + {0, 1}
// (jj < D / 32) of its four rows. The 16 threads of one row sit in one
// half-warp, so a row reduction is four xor-shuffles. Operand tiles are
// fp32 in shared memory with a row stride of D + 4 floats: rows stay
// 16-byte aligned for float4 loads, and the eight rows a quarter-warp
// reads land in eight different 16-byte bank groups.
#pragma once

#include "common.cuh"

namespace pk {
namespace flash {

constexpr int kThreads = 256;
constexpr int kBlock = 64;           // query rows and key rows per tile
constexpr int kPLd = kBlock + 16;    // score-tile stride: rows ty, ty + 1
                                     // fall 16 banks apart
constexpr float kNegInf = -1e30f;    // the TPU kernel's mask value

// Rows [row0, row0 + kBlock) of a [T, D] matrix into dst[kBlock][D + 4]
// as fp32 times ``scale``; rows past T are zero.
template <int D, typename Elt>
__device__ __forceinline__ void load_rows(float* dst, const Elt* src,
                                          int row0, int T, float scale) {
  constexpr int LD = D + 4;
  for (int i = threadIdx.x; i < kBlock * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int row = row0 + r;
    dst[r * LD + d] =
        row < T ? to_f32(src[(size_t)row * D + d]) * scale : 0.f;
  }
}

// s[i][j] = a[ty + 16 i, :] . b[tx + 16 j, :] over D, both tiles in the
// padded layout above.
template <int D>
__device__ __forceinline__ void dot_tile(const float* a, const float* b,
                                         int ty, int tx, float s[4][4]) {
  constexpr int LD = D + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + (ty + 16 * i) * LD + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bv[j] = *reinterpret_cast<const float4*>(b + (tx + 16 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float t = s[i][j];
        t = fmaf(av[i].x, bv[j].x, t);
        t = fmaf(av[i].y, bv[j].y, t);
        t = fmaf(av[i].z, bv[j].z, t);
        t = fmaf(av[i].w, bv[j].w, t);
        s[i][j] = t;
      }
  }
}

// Reductions over the 16 threads of one score row (one half-warp).
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Rows ty + 16 i of an fp32 accumulator [4][D / 32][2] into a [T, D]
// output at row0, in the output's dtype; rows past T are not written.
template <int D, typename Elt>
__device__ __forceinline__ void store_rows(Elt* dst, float (*acc)[D / 32][2],
                                           int row0, int T, int ty, int tx,
                                           const float* row_scale) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= T) continue;
#pragma unroll
    for (int jj = 0; jj < D / 32; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        dst[(size_t)row * D + 32 * jj + 2 * tx + e] =
            from_f32<Elt>(acc[i][jj][e] * row_scale[i]);
  }
}

}  // namespace flash
}  // namespace pk
