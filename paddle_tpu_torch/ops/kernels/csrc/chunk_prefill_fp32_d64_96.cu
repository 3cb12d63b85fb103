// Chunk prefill's fp32 instantiations (three-term operands; the kernel:
// chunk_prefill.cuh) at head dims 64 and 96, compiled beside
// chunk_prefill_fp32_d32_128.cu and chunk_prefill.cu's bf16 ones.
#include "chunk_prefill.cuh"

namespace pk {
namespace prefill {
template cudaError_t launch_kv<float, 64>(const Args&, cudaStream_t);
template cudaError_t launch_kv<float, 96>(const Args&, cudaStream_t);
}  // namespace prefill
}  // namespace pk
