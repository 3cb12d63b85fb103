// The flash attention forward's C entry and its bf16 instantiations
// (the kernel and its design: flash_attn_fwd.cuh; the fp32
// instantiations: flash_attn_fwd_fp32_inst.cu).
#include "flash_attn_fwd.cuh"

extern "C" int pk_flash_attn_fwd(const void* q, const void* k, const void* v,
                                 void* out, void* lse, int BH, int T, int D,
                                 float scale, int causal, int dtype,
                                 void* stream) {
  using namespace pk::fwd;
  if (BH == 0 || T == 0) return cudaSuccess;
  if (BH > 65535) return cudaErrorInvalidValue;
  const Args a{q, k, v, out, lse, BH, T, D, causal, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == pk::kF32) return launch_dtype<float>(a, s);
  if (dtype == pk::kBF16) return launch_dtype<bf16>(a, s);
  return cudaErrorInvalidValue;
}
