// Fused sampling epilogue: one token id per logits row, no sort.
//
// Replaces paddle_tpu/ops/pallas/decode.py::fused_sample (the Pallas
// kernel _sample_kernel and its helpers _sortable_key, _kth_key,
// _hash_uniform, _first_argmax). Per row:
// - greedy: first-index argmax;
// - top-k: the k-th largest order-preserving uint32 key by a 32-step
//   binary search on the threshold (count(key >= mid) is monotone), ties
//   at the threshold kept;
// - temperature divide, then Gumbel-max over splitmix-hashed uniforms of
//   (seed, row, lane) — the same constants and uint32 wraparound as the
//   TPU kernel, so the uniforms are bitwise the same;
// - temperature <= 0 picks the greedy id.
// A uniform that rounds to 1.0 gives a +inf Gumbel term, and NaN on a
// filtered lane (-inf + inf); NaN never wins here (every comparison with
// it is false), where the TPU kernel's max propagates it and returns
// the out-of-range id V.
//
// What bounds it on the H100: bytes. The work per logit is a handful of
// integer and float operations; the row (V*4 bytes, 201 KB at V=50257)
// must cross from memory at least once.
//
// What the design does about it: one CTA of 1024 threads per row, block
// reductions for argmax and counts. The binary search re-reads the row
// (up to 32 counting passes) from L2, where a 201 KB row stays resident;
// it stops as soon as the interval collapses, and it is skipped for rows
// whose result cannot depend on it (greedy rows, k <= 0, k >= V).
// Left for later: keeping the row in shared memory across the passes,
// and several rows per CTA when B is large.
#include <limits.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

struct ArgMax {
  float v;
  int i;
};

// larger value wins; equal values keep the smaller index (jnp.argmax's
// first-index convention). A total order, so any reduction tree gives
// the same answer.
__device__ __forceinline__ ArgMax better(ArgMax a, ArgMax b) {
  return (b.v > a.v || (b.v == a.v && b.i < a.i)) ? b : a;
}

__device__ ArgMax block_argmax(ArgMax a, ArgMax* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    ArgMax b{__shfl_xor_sync(pk::kFull, a.v, o),
             __shfl_xor_sync(pk::kFull, a.i, o)};
    a = better(a, b);
  }
  if (lane == 0) red[warp] = a;
  __syncthreads();
  a = red[lane];                    // every warp reduces the 32 partials
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    ArgMax b{__shfl_xor_sync(pk::kFull, a.v, o),
             __shfl_xor_sync(pk::kFull, a.i, o)};
    a = better(a, b);
  }
  __syncthreads();                  // red is reused by the next call
  return a;
}

__device__ int block_count(int c, int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) c += __shfl_xor_sync(pk::kFull, c, o);
  if (lane == 0) red[warp] = c;
  __syncthreads();
  c = red[lane];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) c += __shfl_xor_sync(pk::kFull, c, o);
  __syncthreads();
  return c;
}

// fp32 -> uint32 order-preserving image (decode.py::_sortable_key)
__device__ __forceinline__ uint32_t sortable_key(float x) {
  const uint32_t u = __float_as_uint(x);
  return u ^ (((u >> 31) * 0x7FFFFFFFu) | 0x80000000u);
}

// counter-based uniform in (0, 1) (decode.py::_hash_uniform)
__device__ __forceinline__ float hash_uniform(uint32_t seed, uint32_t row,
                                              uint32_t lane) {
  uint32_t h = seed + row * 0x9E3779B9u + (lane + 1u) * 0x85EBCA6Bu;
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  h *= 0x846CA68Bu;
  h ^= h >> 16;
  return (static_cast<float>(h >> 8) + 0.5f) * (1.0f / 16777216.0f);
}

__global__ void __launch_bounds__(kThreads)
fused_sample_kernel(const float* __restrict__ logits,
                    const float* __restrict__ temperature,
                    const int* __restrict__ top_k, int* __restrict__ out,
                    int V, uint32_t seed) {
  static_assert(kWarps == 32, "block reductions assume 32 warps");
  __shared__ ArgMax red_am[kWarps];
  __shared__ int red_cnt[kWarps];
  const int row = blockIdx.x, tid = threadIdx.x;
  const float* x = logits + (size_t)row * V;

  ArgMax a{-INFINITY, INT_MAX};
  for (int i = tid; i < V; i += kThreads) a = better(a, ArgMax{x[i], i});
  const int greedy = block_argmax(a, red_am).i;

  const float temp = temperature[row];
  if (!(temp > 0.f)) {
    if (tid == 0) out[row] = greedy;
    return;
  }
  const int k = min(max(top_k[row], 0), V);
  // k <= 0 keeps every lane; so does k == V (the k-th key is the min)
  const bool filter = k > 0 && k < V;
  uint32_t kstar = 0;
  if (filter) {
    uint32_t lo = 0u, hi = 0xFFFFFFFFu;
    for (int step = 0; step < 32 && lo != hi; ++step) {
      const uint32_t d = hi - lo;
      const uint32_t mid = lo + (d >> 1) + (d & 1u);   // ceil, no overflow
      int cnt = 0;
      for (int i = tid; i < V; i += kThreads) cnt += sortable_key(x[i]) >= mid;
      cnt = block_count(cnt, red_cnt);
      if (cnt >= k) lo = mid; else hi = mid - 1u;
    }
    kstar = lo;
  }

  ArgMax s{-INFINITY, INT_MAX};
  for (int i = tid; i < V; i += kThreads) {
    const float xi = x[i];
    float z = (!filter || sortable_key(xi) >= kstar) ? xi : -INFINITY;
    z = z / temp;
    const float g = -logf(-logf(hash_uniform(seed, row, i)));
    s = better(s, ArgMax{z + g, i});
  }
  s = block_argmax(s, red_am);
  if (tid == 0) out[row] = s.i;
}

}  // namespace

extern "C" int pk_fused_sample(const void* logits, const void* temperature,
                               const void* top_k, void* out, int B, int V,
                               int seed, void* stream) {
  if (B == 0) return cudaSuccess;
  fused_sample_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits),
      static_cast<const float*>(temperature),
      static_cast<const int*>(top_k), static_cast<int*>(out), V,
      static_cast<uint32_t>(seed));
  return cudaGetLastError();
}
