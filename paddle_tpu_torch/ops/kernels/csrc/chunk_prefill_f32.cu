// One prefill chunk's attention against its pool-resident context, fp32
// queries, on the CUDA cores.
//
// Replaces paddle_tpu/ops/pallas/prefill.py::flash_chunk_prefill (the
// Pallas kernels _chunk_kernel and, for a cold chunk with no context,
// _cold_chunk_kernel) for fp32 inputs; bf16 queries go to the tensor-core
// kernel of chunk_prefill.cu, whose C entry dispatches here. Query row
// (c, g) of kv-head h attends over the S = P_ctx*bs context positions,
// read through pages[] from the pool [Hkv, M, Dh] and fully visible, then
// over the chunk's own fresh K/V [C, Hkv, Dh] causally (column S + j is
// visible iff j <= c). Scores are divided by sqrt(Dh), -1e30 masks the
// rest, one exact softmax, p @ V. Output fp32 [C, Hkv, G, Dh].
//
// A quantized pool (the TPU kernel's kv_dtype "int8"/"int4") holds int8
// codes [Hkv, M, Dh] or nibble-packed [Hkv, M, Dh/2] with fp32 scales
// k_scale/v_scale [Hkv, M]: each context element is widened as
// dequantize_kv does (float(code) * scale, one fp32 rounding) when its
// tile is staged. The chunk's own K/V stay in the model dtype, exact.
//
// fp32 products have no tensor-core path that matches the plain version
// to 1e-4 (TF32 keeps ten mantissa bits), so this kernel stays on the
// CUDA cores: a grid of (kv-head, tile of query rows), the TPU kernel's
// sequential page-step grid a loop inside the CTA. Each CTA stages its
// query rows once, then streams 32-row tiles of keys (context pages
// through the page table, then the chunk's own rows) into shared memory
// and scores every (row, key) pair from there; the score rows stay in
// shared memory for the exact softmax, and the value tiles stream the
// same way for p @ V. A CTA stops at the last column its rows can see.
// P_ctx = 0 (a cold chunk) is the same kernel with no context loop; it
// reads no pool, so it always runs the model-dtype instantiation.
// Left for later: an online softmax that drops the O(rows * (S + C))
// score buffer (and with it the shared-memory limit on S + C).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;          // key/value rows staged per step
constexpr int kMaxOut = 16;        // (row, d) outputs per thread

// logical column t of K or V widened to fp32: context positions t < S
// come from the pool through the page table, the rest from the chunk
template <typename Elt, int KV>
__device__ __forceinline__ float kv_elem(
    const typename pk::Stored<Elt, KV>::T* pool_h, const float* scale_h,
    const Elt* chunk, const int* pages, int t, int d, int S, int bs, int h,
    int Hkv, int Dh) {
  if (t < S) {
    const size_t row = (size_t)pages[t / bs] * bs + t % bs;
    return pk::widen<KV>(pool_h + row * pk::row_len<KV>(Dh), d,
                         KV == pk::kModel ? 1.f : scale_h[row]);
  }
  return pk::to_f32(chunk[((size_t)(t - S) * Hkv + h) * Dh + d]);
}

template <typename Elt, int KV>
__global__ void __launch_bounds__(kThreads)
chunk_prefill_kernel(const Elt* __restrict__ q,
                     const Elt* __restrict__ k_chunk,
                     const Elt* __restrict__ v_chunk,
                     const typename pk::Stored<Elt, KV>::T* __restrict__ k,
                     const typename pk::Stored<Elt, KV>::T* __restrict__ v,
                     const float* __restrict__ k_scale,
                     const float* __restrict__ v_scale,
                     const int* __restrict__ pages, float* __restrict__ out,
                     int C, int Hkv, int G, int Dh, int M, int S, int bs,
                     int rows, float scale) {
  using St = typename pk::Stored<Elt, KV>::T;
  extern __shared__ float smem[];
  const int h = blockIdx.x;
  const int r0 = blockIdx.y * rows;              // first (c*G + g) row
  const int nrows = min(rows, C * G - r0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ld = Dh + 1;                         // padded: no bank clash
  const int stride = S + C;                      // score row stride
  float* q_s = smem;                             // [rows, Dh]
  float* kv_s = q_s + rows * Dh;                 // [kTile, Dh + 1]
  float* s_s = kv_s + kTile * ld;                // [rows, S + C]
  // columns this CTA's rows can see: up to S + (last chunk row)
  const int ncols = S + (r0 + nrows - 1) / G + 1;

  for (int i = tid; i < nrows * Dh; i += kThreads) {
    const int r = r0 + i / Dh;                   // global row = c*G + g
    const int c = r / G, g = r % G;
    q_s[i] = pk::to_f32(q[(((size_t)c * Hkv + h) * G + g) * Dh + i % Dh]);
  }
  const St* kh = k + (size_t)h * M * pk::row_len<KV>(Dh);
  const St* vh = v + (size_t)h * M * pk::row_len<KV>(Dh);
  const float* ksh = KV == pk::kModel ? nullptr : k_scale + (size_t)h * M;
  const float* vsh = KV == pk::kModel ? nullptr : v_scale + (size_t)h * M;

  // scores, one staged key tile at a time
  for (int t0 = 0; t0 < ncols; t0 += kTile) {
    const int nt = min(kTile, ncols - t0);
    __syncthreads();                             // kv_s free to refill
    for (int i = tid; i < nt * Dh; i += kThreads) {
      const int j = i / Dh, d = i % Dh;
      kv_s[j * ld + d] = kv_elem<Elt, KV>(kh, ksh, k_chunk, pages, t0 + j,
                                          d, S, bs, h, Hkv, Dh);
    }
    __syncthreads();
    for (int p = tid; p < nrows * kTile; p += kThreads) {
      const int r = p / kTile, j = p % kTile, t = t0 + j;
      if (j >= nt) continue;
      float acc = 0.f;
      for (int d = 0; d < Dh; ++d) acc += q_s[r * Dh + d] * kv_s[j * ld + d];
      const int c = (r0 + r) / G;
      s_s[r * stride + t] = t <= S + c ? acc / scale : -1e30f;
    }
  }
  __syncthreads();

  // one exact softmax per row (warp per row) over the CTA's columns;
  // masked columns hold -1e30 and come out exactly 0
  for (int r = warp; r < nrows; r += kWarps) {
    float* sr = s_s + r * stride;
    float m = -INFINITY;
    for (int t = lane; t < ncols; t += 32) m = fmaxf(m, sr[t]);
    m = pk::warp_max(m);
    float sum = 0.f;
    for (int t = lane; t < ncols; t += 32) {
      const float e = expf(sr[t] - m);
      sr[t] = e;
      sum += e;
    }
    sum = pk::warp_sum(sum);
    for (int t = lane; t < ncols; t += 32) sr[t] = sr[t] / sum;
  }

  // p @ V: each thread owns the (row, d) outputs tid, tid + kThreads, ...
  float acc[kMaxOut];
#pragma unroll
  for (int o = 0; o < kMaxOut; ++o) acc[o] = 0.f;
  for (int t0 = 0; t0 < ncols; t0 += kTile) {
    const int nt = min(kTile, ncols - t0);
    __syncthreads();
    for (int i = tid; i < nt * Dh; i += kThreads) {
      const int j = i / Dh, d = i % Dh;
      kv_s[j * ld + d] = kv_elem<Elt, KV>(vh, vsh, v_chunk, pages, t0 + j,
                                          d, S, bs, h, Hkv, Dh);
    }
    __syncthreads();
#pragma unroll
    for (int o = 0; o < kMaxOut; ++o) {
      const int p = tid + o * kThreads;
      if (p >= nrows * Dh) break;
      const int r = p / Dh, d = p % Dh;
      const float* pr = s_s + r * stride + t0;
      float a = acc[o];
      for (int j = 0; j < nt; ++j) a += pr[j] * kv_s[j * ld + d];
      acc[o] = a;
    }
  }
#pragma unroll
  for (int o = 0; o < kMaxOut; ++o) {
    const int p = tid + o * kThreads;
    if (p >= nrows * Dh) break;
    const int r = r0 + p / Dh;
    const int c = r / G, g = r % G;
    out[(((size_t)c * Hkv + h) * G + g) * Dh + p % Dh] = acc[o];
  }
}

template <typename Elt, int KV>
cudaError_t launch(const void* q, const void* kc, const void* vc,
                   const void* k, const void* v, const void* k_scale,
                   const void* v_scale, const void* pages, void* out, int C,
                   int Hkv, int G, int Dh, int M, int P_ctx, int bs,
                   int rows, float scale, int smem, cudaStream_t stream) {
  using St = typename pk::Stored<Elt, KV>::T;
  auto kernel = chunk_prefill_kernel<Elt, KV>;
  cudaError_t err = pk::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(Hkv, (C * G + rows - 1) / rows);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const Elt*>(q), static_cast<const Elt*>(kc),
      static_cast<const Elt*>(vc), static_cast<const St*>(k),
      static_cast<const St*>(v), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(pages),
      static_cast<float*>(out), C, Hkv, G, Dh, M, P_ctx * bs, bs, rows,
      scale);
  return cudaGetLastError();
}

template <typename Elt>
cudaError_t launch_kv(int kv, const void* q, const void* kc, const void* vc,
                      const void* k, const void* v, const void* k_scale,
                      const void* v_scale, const void* pages, void* out,
                      int C, int Hkv, int G, int Dh, int M, int P_ctx,
                      int bs, int rows, float scale, int smem,
                      cudaStream_t s) {
  // a cold chunk reads no pool: the model-dtype instantiation serves it
  if (kv == pk::kModel || P_ctx == 0)
    return launch<Elt, pk::kModel>(q, kc, vc, k, v, k_scale, v_scale,
                                   pages, out, C, Hkv, G, Dh, M, P_ctx, bs,
                                   rows, scale, smem, s);
  if (kv == pk::kInt8)
    return launch<Elt, pk::kInt8>(q, kc, vc, k, v, k_scale, v_scale, pages,
                                  out, C, Hkv, G, Dh, M, P_ctx, bs, rows,
                                  scale, smem, s);
  if (kv == pk::kInt4)
    return launch<Elt, pk::kInt4>(q, kc, vc, k, v, k_scale, v_scale, pages,
                                  out, C, Hkv, G, Dh, M, P_ctx, bs, rows,
                                  scale, smem, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int pk_chunk_prefill_f32(const void* q, const void* k_chunk,
                                    const void* v_chunk, const void* k,
                                    const void* v, const void* k_scale,
                                    const void* v_scale, const void* pages,
                                    void* out, int C, int Hkv, int G, int Dh,
                                    int M, int P_ctx, int bs, int rows,
                                    float scale, int kv, int smem,
                                    cudaStream_t s) {
  if (rows < 1 || rows * Dh > kMaxOut * kThreads)
    return cudaErrorInvalidValue;
  return launch_kv<float>(kv, q, k_chunk, v_chunk, k, v, k_scale, v_scale,
                          pages, out, C, Hkv, G, Dh, M, P_ctx, bs, rows,
                          scale, smem, s);
}
