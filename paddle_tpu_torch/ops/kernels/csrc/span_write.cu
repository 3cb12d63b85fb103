// Masked in-place write of one prefill chunk's K/V spans into its pages.
//
// Replaces paddle_tpu/ops/pallas/prefill.py::paged_span_write (the
// Pallas kernel _span_write_kernel). For layer-head lh and chunk page j,
// row i of the span [L*Hkv, pc*bs, Dh] lands at pool row
// pages[j]*bs + i of [L*Hkv, M, Dh] when valid[j*bs + i] is set; a row
// with valid = 0 is never written and keeps the pool's old bytes.
// Padded chunk rows map to page-table entries that are 0, so writing
// them would corrupt page 0, which may belong to another request.
//
// What bounds it on the H100: bytes — a pure copy, each valid row read
// once and written once, no arithmetic.
//
// What the design does about it: the pool is updated in place (the TPU
// kernel aliases its output to the pool for the same reason: no
// pool-sized copy); one CTA per (layer-head, chunk page) copies its
// bs-row span with 16-byte vector accesses where the row width allows
// (4-byte otherwise), neighbouring threads on neighbouring addresses;
// K and V ride the same launch.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;

template <typename Vec>
__global__ void __launch_bounds__(kThreads)
span_write_kernel(Vec* __restrict__ pool_k, Vec* __restrict__ pool_v,
                  const Vec* __restrict__ span_k,
                  const Vec* __restrict__ span_v,
                  const int* __restrict__ pages,
                  const uint8_t* __restrict__ valid, int span_len, int M,
                  int bs, int row_vecs) {
  const int lh = blockIdx.x, j = blockIdx.y;
  const size_t dst0 = ((size_t)lh * M + (size_t)pages[j] * bs) * row_vecs;
  const size_t src0 = ((size_t)lh * span_len + (size_t)j * bs) * row_vecs;
  for (int i = threadIdx.x; i < bs * row_vecs; i += kThreads) {
    if (!valid[j * bs + i / row_vecs]) continue;
    pool_k[dst0 + i] = span_k[src0 + i];
    pool_v[dst0 + i] = span_v[src0 + i];
  }
}

template <typename Vec>
cudaError_t launch(void* pk_, void* pv, const void* sk, const void* sv,
                   const void* pages, const void* valid, int LH, int pc,
                   int M, int bs, int row_bytes, cudaStream_t stream) {
  span_write_kernel<Vec><<<dim3(LH, pc), kThreads, 0, stream>>>(
      static_cast<Vec*>(pk_), static_cast<Vec*>(pv),
      static_cast<const Vec*>(sk), static_cast<const Vec*>(sv),
      static_cast<const int*>(pages), static_cast<const uint8_t*>(valid),
      pc * bs, M, bs, row_bytes / static_cast<int>(sizeof(Vec)));
  return cudaGetLastError();
}

}  // namespace

extern "C" int pk_span_write(void* pool_k, void* pool_v, const void* span_k,
                             const void* span_v, const void* pages,
                             const void* valid, int LH, int pc, int M,
                             int bs, int row_bytes, void* stream) {
  if (LH * pc == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the wrapper guarantees 16-byte aligned base pointers
  if (row_bytes % 16 == 0)
    return launch<uint4>(pool_k, pool_v, span_k, span_v, pages, valid, LH,
                         pc, M, bs, row_bytes, s);
  if (row_bytes % 4 == 0)
    return launch<uint32_t>(pool_k, pool_v, span_k, span_v, pages, valid,
                            LH, pc, M, bs, row_bytes, s);
  return cudaErrorInvalidValue;
}
