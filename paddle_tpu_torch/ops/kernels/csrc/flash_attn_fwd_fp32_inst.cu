// The flash attention forward's fp32 instantiations (three-term
// operands; the kernel: flash_attn_fwd.cuh), compiled beside
// flash_attn_fwd.cu's bf16 ones.
#include "flash_attn_fwd.cuh"

namespace pk {
namespace fwd {
template cudaError_t launch_dtype<float>(const Args&, cudaStream_t);
}  // namespace fwd
}  // namespace pk
