// Masked in-place write of one prefill chunk's spans into its pages.
//
// Replaces paddle_tpu/ops/pallas/prefill.py::paged_span_write (the
// Pallas kernel _span_write_kernel), which writes any set of named pool
// arrays in one pallas_call. Here one launch writes up to four arrays
// (k and v; for a quantized pool also the fp32 scale tables k_scale and
// v_scale), each with its own row width: a pool array is
// [L*Hkv, M, row] and its span [L*Hkv, pc*bs, row], where a row is Dh
// model-dtype elements, Dh int8 codes, Dh/2 packed int4 bytes or one
// fp32 scale (the 3-D scale tables are arrays of 4-byte rows). For
// layer-head lh and chunk page j, span row i lands at pool row
// pages[j]*bs + i when valid[j*bs + i] is set; a row with valid = 0 is
// never written and keeps the pool's old bytes. Padded chunk rows map to
// page-table entries that are 0, so writing them would corrupt page 0,
// which may belong to another request. The copy is byte-exact.
//
// What bounds it on the H100: bytes — a pure copy, each valid row read
// once and written once, no arithmetic.
//
// What the design does about it: the pool is updated in place (the TPU
// kernel aliases its output to the pool for the same reason: no
// pool-sized copy); one CTA per (layer-head, chunk page) copies its
// bs-row span of every array, neighbouring threads on neighbouring
// addresses, with 16-byte accesses where an array's row width allows,
// 4-byte ones otherwise (the scale rows) and single bytes for rows that
// are no multiple of 4.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxArrays = 4;

struct Arrays {
  uint8_t* pool[kMaxArrays];
  const uint8_t* span[kMaxArrays];
  int row_bytes[kMaxArrays];
  int n;
};

template <typename Vec>
__device__ __forceinline__ void copy_rows(uint8_t* dst, const uint8_t* src,
                                          const uint8_t* valid, int bs,
                                          int row_bytes) {
  const int row_vecs = row_bytes / static_cast<int>(sizeof(Vec));
  Vec* d = reinterpret_cast<Vec*>(dst);
  const Vec* s = reinterpret_cast<const Vec*>(src);
  for (int i = threadIdx.x; i < bs * row_vecs; i += kThreads)
    if (valid[i / row_vecs]) d[i] = s[i];
}

__global__ void __launch_bounds__(kThreads)
span_write_kernel(Arrays a, const int* __restrict__ pages,
                  const uint8_t* __restrict__ valid, int span_len, int M,
                  int bs) {
  const int lh = blockIdx.x, j = blockIdx.y;
  const uint8_t* vj = valid + (size_t)j * bs;
  // unrolled: constant indices keep the array table in parameter space
#pragma unroll
  for (int n = 0; n < kMaxArrays; ++n) {
    if (n >= a.n) break;
    const int rb = a.row_bytes[n];
    uint8_t* dst = a.pool[n] + ((size_t)lh * M + (size_t)pages[j] * bs) * rb;
    const uint8_t* src =
        a.span[n] + ((size_t)lh * span_len + (size_t)j * bs) * rb;
    if (rb % 16 == 0)
      copy_rows<uint4>(dst, src, vj, bs, rb);
    else if (rb % 4 == 0)
      copy_rows<uint32_t>(dst, src, vj, bs, rb);
    else
      copy_rows<uint8_t>(dst, src, vj, bs, rb);
  }
}

}  // namespace

// pools/spans: n pointers each (16-byte aligned: the wrapper checks);
// row_bytes: n row widths
extern "C" int pk_span_write(void* pool0, void* pool1, void* pool2,
                             void* pool3, const void* span0,
                             const void* span1, const void* span2,
                             const void* span3, int rb0, int rb1, int rb2,
                             int rb3, int n, const void* pages,
                             const void* valid, int LH, int pc, int M,
                             int bs, void* stream) {
  if (n < 1 || n > kMaxArrays) return cudaErrorInvalidValue;
  if (LH * pc == 0) return cudaSuccess;
  Arrays a;
  void* pools[kMaxArrays] = {pool0, pool1, pool2, pool3};
  const void* spans[kMaxArrays] = {span0, span1, span2, span3};
  const int rbs[kMaxArrays] = {rb0, rb1, rb2, rb3};
  for (int i = 0; i < kMaxArrays; ++i) {
    a.pool[i] = static_cast<uint8_t*>(pools[i]);
    a.span[i] = static_cast<const uint8_t*>(spans[i]);
    a.row_bytes[i] = rbs[i];
    if (i < n && rbs[i] < 1) return cudaErrorInvalidValue;
  }
  a.n = n;
  span_write_kernel<<<dim3(LH, pc), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<const int*>(pages), static_cast<const uint8_t*>(valid),
      pc * bs, M, bs);
  return cudaGetLastError();
}
