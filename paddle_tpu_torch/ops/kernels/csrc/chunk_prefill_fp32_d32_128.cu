// Chunk prefill's fp32 instantiations (three-term operands; the kernel:
// chunk_prefill.cuh) at head dims 32 and 128, compiled beside
// chunk_prefill_fp32_d64_96.cu and chunk_prefill.cu's bf16 ones.
#include "chunk_prefill.cuh"

namespace pk {
namespace prefill {
template cudaError_t launch_kv<float, 32>(const Args&, cudaStream_t);
template cudaError_t launch_kv<float, 128>(const Args&, cudaStream_t);
}  // namespace prefill
}  // namespace pk
