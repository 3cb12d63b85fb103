// Shared helpers of the Hopper kernels: dtype codes, widening loads and
// warp reductions. Plain C interface on every entry point (no PyTorch
// headers), so each source compiles in seconds.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pk {

// must match paddle_tpu_torch/ops/kernels/_build.py: DTYPE_CODES
enum DType { kF32 = 0, kBF16 = 1 };

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename Elt>
__device__ __forceinline__ Elt from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// KV pool storage, must match paddle_tpu_torch/ops/kernels/_build.py:
// KV_CODES. kModel rows hold Dh elements of the model dtype; kInt8 rows
// Dh int8 codes; kInt4 rows Dh/2 bytes, element 2j in the low nibble of
// byte j and element 2j+1 in the high one. Quantized rows carry one
// fp32 scale each.
enum KvStore { kModel = 0, kInt8 = 1, kInt4 = 2 };

// the stored element type of a pool row
template <typename Elt, int KV>
struct Stored {
  using T = int8_t;
};
template <typename Elt>
struct Stored<Elt, kModel> {
  using T = Elt;
};

// stored elements per row of Dh logical ones
template <int KV>
__host__ __device__ __forceinline__ int row_len(int Dh) {
  return KV == kInt4 ? Dh / 2 : Dh;
}

// element d of a stored row widened to fp32 exactly as
// paddle_tpu_torch/ops/q8.py::dequantize_kv does: the exact integer code
// (nibbles sign-extended), converted to fp32, times the row's scale in
// one fp32 rounding (__fmul_rn: never contracted into a later add)
template <int KV, typename S>
__device__ __forceinline__ float widen(const S* row, int d, float scale) {
  if constexpr (KV == kModel) {
    return to_f32(row[d]);
  } else if constexpr (KV == kInt8) {
    return __fmul_rn(static_cast<float>(row[d]), scale);
  } else {
    const int p = row[d >> 1];  // the byte, sign-extended
    const int code = (d & 1) ? (p >> 4) : (((p & 0xF) ^ 8) - 8);
    return __fmul_rn(static_cast<float>(code), scale);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Opt a kernel into more than 48 KB of dynamic shared memory.
template <typename K>
inline cudaError_t allow_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace pk
