// Chunk prefill's C entry and its bf16 instantiations (the kernel and
// its design: chunk_prefill.cuh; the fp32 instantiations:
// chunk_prefill_fp32_d32_128.cu, chunk_prefill_fp32_d64_96.cu).
#include "chunk_prefill.cuh"

extern "C" int pk_chunk_prefill(const void* q, const void* k_chunk,
                                const void* v_chunk, const void* k,
                                const void* v, const void* k_scale,
                                const void* v_scale, const void* pages,
                                void* out, void* part, void* counters, int C,
                                int Hkv, int G, int Dh, int M, int P_ctx,
                                int bs, int rows, float scale, int dtype,
                                int kv, int smem, void* stream) {
  using namespace pk::prefill;
  if (C * Hkv * G == 0) return cudaSuccess;
  if (rows != kRows || (C * G + kRows - 1) / kRows > 65535)
    return cudaErrorInvalidValue;
  const Args a{q,   k_chunk, v_chunk, k, v,  k_scale, v_scale,
               pages, out,   part,    counters, C, Hkv, G, Dh, M,
               P_ctx, bs,    kv,      smem,     scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == pk::kF32) return launch_dtype<float>(a, s);
  if (dtype == pk::kBF16) return launch_dtype<bf16>(a, s);
  return cudaErrorInvalidValue;
}
