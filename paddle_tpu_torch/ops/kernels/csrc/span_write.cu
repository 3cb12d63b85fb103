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
// pool-sized copy). One CTA takes one layer-head and kPages chunk pages.
// It reduces valid to one flag per page first (every page of a chunk
// but the last is full; the padding pages are empty), so a full page is
// one contiguous run of bs rows in both the span and the pool, copied
// with no per-row test, an empty page is neither read nor written, and
// only the partial page reads the row mask. Each thread issues kUnroll
// loads (16-byte vectors where an array's row width allows, 4-byte ones
// for the scale rows, single bytes for rows that are no multiple of 4)
// before their stores. At the serving shapes (2-15 MB a launch) the
// time is a fixed cost of launch and dependent round trips more than
// bytes: loading before the mask is known, or batching all arrays'
// loads (125 registers), gave no shorter device time on the H100.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxArrays = 4;
constexpr int kPages = 4;        // chunk pages per CTA
constexpr int kUnroll = 4;       // vectors in flight per thread
static_assert(kPages <= kWarps, "one warp reduces one page's mask");

enum PageState { kEmpty = 0, kFull = 1, kPartial = 2 };

struct Arrays {
  uint8_t* pool[kMaxArrays];
  const uint8_t* span[kMaxArrays];
  int row_bytes[kMaxArrays];
  int n;
};

// one array's rows of this CTA's pages: page g of npg starts at span row
// (j0 + g) * bs and pool row phys[g] * bs
template <typename Vec>
__device__ __forceinline__ void copy_pages(
    uint8_t* pool, const uint8_t* span, int row_bytes, int npg, int bs,
    const int* state, const int* phys, const uint8_t* valid) {
  const int row_vecs = row_bytes / static_cast<int>(sizeof(Vec));
  const int page_vecs = bs * row_vecs;
  const int total = npg * page_vecs;
  Vec* d = reinterpret_cast<Vec*>(pool);
  const Vec* s = reinterpret_cast<const Vec*>(span);
  for (int base = threadIdx.x; base < total; base += kThreads * kUnroll) {
    Vec r[kUnroll];
    int to[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int idx = base + u * kThreads;
      to[u] = -1;
      if (idx < total) {
        const int g = idx / page_vecs, w = idx - g * page_vecs;
        if (state[g] == kFull ||
            (state[g] == kPartial && valid[g * bs + w / row_vecs])) {
          r[u] = s[idx];
          to[u] = phys[g] * page_vecs + w;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (to[u] >= 0) d[to[u]] = r[u];
  }
}

__global__ void __launch_bounds__(kThreads)
span_write_kernel(Arrays a, const int* __restrict__ pages,
                  const uint8_t* __restrict__ valid, int pc, int M,
                  int bs) {
  __shared__ int state[kPages], phys[kPages];
  const int lh = blockIdx.x, j0 = blockIdx.y * kPages;
  const int npg = min(kPages, pc - j0);
  const uint8_t* v = valid + (size_t)j0 * bs;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < npg) {
    unsigned count = 0;
    for (int i = lane; i < bs; i += 32) count += v[warp * bs + i] != 0;
    count = __reduce_add_sync(pk::kFull, count);
    if (lane == 0) {
      state[warp] = count == static_cast<unsigned>(bs) ? kFull
                    : count == 0                       ? kEmpty
                                                       : kPartial;
      phys[warp] = pages[j0 + warp];
    }
  }
  __syncthreads();
  const size_t span_rows = (size_t)pc * bs;
  // unrolled: constant indices keep the array table in parameter space
#pragma unroll
  for (int n = 0; n < kMaxArrays; ++n) {
    if (n >= a.n) break;
    const int rb = a.row_bytes[n];
    uint8_t* dst = a.pool[n] + (size_t)lh * M * rb;
    const uint8_t* src =
        a.span[n] + ((size_t)lh * span_rows + (size_t)j0 * bs) * rb;
    if (rb % 16 == 0)
      copy_pages<uint4>(dst, src, rb, npg, bs, state, phys, v);
    else if (rb % 4 == 0)
      copy_pages<uint32_t>(dst, src, rb, npg, bs, state, phys, v);
    else
      copy_pages<uint8_t>(dst, src, rb, npg, bs, state, phys, v);
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
  const dim3 grid(LH, (pc + kPages - 1) / kPages);
  span_write_kernel<<<grid, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<const int*>(pages), static_cast<const uint8_t*>(valid),
      pc, M, bs);
  return cudaGetLastError();
}
