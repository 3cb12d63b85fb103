// The flash attention backward's fp32 instantiations (three-term
// operands; the kernels: flash_attn_bwd.cuh), compiled beside
// flash_attn_bwd.cu's bf16 ones.
#include "flash_attn_bwd.cuh"

namespace pk {
namespace bwd {
template cudaError_t launch_dtype<float>(const Args&, cudaStream_t);
}  // namespace bwd
}  // namespace pk
