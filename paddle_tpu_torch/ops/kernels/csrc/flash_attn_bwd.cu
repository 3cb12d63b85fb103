// The flash attention backward's C entry and its bf16 instantiations
// (the kernels and their design: flash_attn_bwd.cuh; the fp32
// instantiations: flash_attn_bwd_fp32_inst.cu).
#include "flash_attn_bwd.cuh"

extern "C" int pk_flash_attn_bwd(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq, void* dk,
                                 void* dv, int BH, int T, int D, float scale,
                                 int causal, int dtype, void* stream) {
  using namespace pk::bwd;
  if (BH == 0 || T == 0) return cudaSuccess;
  if (BH > 65535) return cudaErrorInvalidValue;
  const Args a{q, k, v, dout, lse, delta, dq, dk, dv, BH, T, D, causal,
               scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == pk::kF32) return launch_dtype<float>(a, s);
  if (dtype == pk::kBF16) return launch_dtype<bf16>(a, s);
  return cudaErrorInvalidValue;
}
