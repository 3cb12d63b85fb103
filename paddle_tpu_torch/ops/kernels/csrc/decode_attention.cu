// Flash-decode attention over the head-major paged KV pool.
//
// Replaces paddle_tpu/ops/pallas/decode.py::flash_decode_attention (the
// Pallas kernel _decode_kernel): one decode step of grouped-query
// attention. For slot b and kv-head h, the G query rows attend over the
// logical positions 0..pos[b], read through pages[b, :] from the pool
// [Hkv, M, Dh]; scores are divided by sqrt(Dh), one exact softmax
// (max / exp / sum / divide), then p @ V. Output fp32 [B, Hkv, G, Dh].
//
// What bounds it on the H100: bytes. Each (slot, head) reads its
// (pos+1) K and V rows once and does 4*G*Dh flops per row — about one
// flop per byte for G=1 bf16, far below the ~295 flop/byte ridge. A
// quantized pool moves (Dh + 4) bytes per row (int8) or (Dh/2 + 4)
// (int4) instead of 2*Dh.
//
// What the design does about it:
// - one CTA per (slot, kv-head); the G query rows share every K/V row
//   the CTA streams, so the pool is read once per step, not G times;
// - the walk stops at pos[b] (the TPU kernel streams all P pages and
//   masks; positions past pos[b] carry exactly zero weight after the
//   -1e30 mask, so stopping early computes the same function and moves
//   only the bytes the slot needs);
// - the [G, T] score row lives in shared memory (G*T*4 bytes: 4 KB at
//   G=1, T=1024), as the TPU kernel kept it in VMEM, so the exact
//   softmax needs no second pass over K;
// - the page vector is staged in shared memory once per CTA;
// - a quantized pool streams at its stored width and widens in
//   registers; the warp that scores a position also stages its V scale
//   in shared memory, so each scale is read from memory once. For int4
//   a lane owns whole bytes (elements 2b and 2b+1 of byte b), so no byte
//   is split across lanes.
// Left for later: splitting one slot's positions across CTAs (B*Hkv is
// 96 CTAs on 132 SMs at the slice's shape) and 16-byte vector loads.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 8;        // query rows per kv-head (GQA group)
constexpr int kMaxDPL = 8;      // head-dim elements per lane (Dh <= 256)

// the head-dim element that lane holds in its register slot i (-1 when
// none): lanes split the row as lane + 32*i; for int4, lane owns bytes
// b = lane + 32*(i/2) and holds their elements 2b and 2b+1
template <int KV>
__device__ __forceinline__ int lane_elem(int lane, int i, int Dh) {
  const int d = KV == pk::kInt4 ? 2 * (lane + 32 * (i >> 1)) + (i & 1)
                                : lane + 32 * i;
  return d < Dh ? d : -1;
}

template <typename Elt, int KV>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const Elt* __restrict__ q,
                        const typename pk::Stored<Elt, KV>::T* __restrict__ k,
                        const typename pk::Stored<Elt, KV>::T* __restrict__ v,
                        const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale,
                        const int* __restrict__ pages,
                        const int* __restrict__ pos,
                        float* __restrict__ out, int Hkv, int G, int Dh,
                        int M, int P, int bs, float scale) {
  using S = typename pk::Stored<Elt, KV>::T;
  constexpr bool kQuant = KV != pk::kModel;
  extern __shared__ float smem[];
  const int b = blockIdx.x / Hkv;
  const int h = blockIdx.x % Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ngroups = max(1, kThreads / Dh);  // PV: position groups
  const int TP = P * bs;
  float* q_s = smem;                          // [G, Dh]
  float* s_s = q_s + G * Dh;                  // [G, T] scores -> probs
  float* red_s = s_s + G * TP;                // [ngroups, G, Dh]
  int* pg_s = reinterpret_cast<int*>(red_s + ngroups * G * Dh);  // [P]
  float* vs_s = reinterpret_cast<float*>(pg_s + P);  // [T] V scales

  // positions past pos[b] get exactly zero weight: never read them
  const int T = min(pos[b] + 1, TP);
  const Elt* qb = q + (size_t)blockIdx.x * G * Dh;
  for (int i = tid; i < G * Dh; i += kThreads) q_s[i] = pk::to_f32(qb[i]);
  for (int i = tid; i < P; i += kThreads) pg_s[i] = pages[(size_t)b * P + i];
  __syncthreads();

  const int rl = pk::row_len<KV>(Dh);
  const S* kh = k + (size_t)h * M * rl;
  const S* vh = v + (size_t)h * M * rl;
  const float* ksh = kQuant ? k_scale + (size_t)h * M : nullptr;
  const float* vsh = kQuant ? v_scale + (size_t)h * M : nullptr;

  // scores: one warp per position, the lanes split the head dim
  for (int t = warp; t < T; t += kWarps) {
    const size_t row = (size_t)pg_s[t / bs] * bs + t % bs;
    const S* kr = kh + row * rl;
    const float ks = kQuant ? ksh[row] : 1.f;
    if (kQuant && lane == 0) vs_s[t] = vsh[row];
    float kreg[kMaxDPL];
#pragma unroll
    for (int i = 0; i < kMaxDPL; ++i) {
      const int d = lane_elem<KV>(lane, i, Dh);
      kreg[i] = d >= 0 ? pk::widen<KV>(kr, d, ks) : 0.f;
    }
    for (int g = 0; g < G; ++g) {
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxDPL; ++i) {
        const int d = lane_elem<KV>(lane, i, Dh);
        if (d >= 0) acc += q_s[g * Dh + d] * kreg[i];
      }
      acc = pk::warp_sum(acc);
      if (lane == 0) s_s[g * T + t] = acc / scale;
    }
  }
  __syncthreads();

  // one exact softmax per query row (warp per row)
  for (int g = warp; g < G; g += kWarps) {
    float* sr = s_s + g * T;
    float m = -INFINITY;
    for (int t = lane; t < T; t += 32) m = fmaxf(m, sr[t]);
    m = pk::warp_max(m);
    float sum = 0.f;
    for (int t = lane; t < T; t += 32) {
      const float e = expf(sr[t] - m);
      sr[t] = e;
      sum += e;
    }
    sum = pk::warp_sum(sum);
    for (int t = lane; t < T; t += 32) sr[t] = sr[t] / sum;
  }
  __syncthreads();

  // p @ V: thread (group, d) sums positions t = group (mod ngroups),
  // then the groups' partial sums are added in a fixed order
  for (int w = tid; w < ngroups * Dh; w += kThreads) {
    const int grp = w / Dh, d = w % Dh;
    float acc[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) acc[g] = 0.f;
    for (int t = grp; t < T; t += ngroups) {
      const size_t row = (size_t)pg_s[t / bs] * bs + t % bs;
      const float vv = pk::widen<KV>(vh + row * rl, d, kQuant ? vs_s[t] : 1.f);
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < G) acc[g] += s_s[g * T + t] * vv;
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
      if (g < G) red_s[(grp * G + g) * Dh + d] = acc[g];
  }
  __syncthreads();
  float* ob = out + (size_t)blockIdx.x * G * Dh;
  for (int i = tid; i < G * Dh; i += kThreads) {
    const int g = i / Dh, d = i % Dh;
    float s = 0.f;
    for (int grp = 0; grp < ngroups; ++grp) s += red_s[(grp * G + g) * Dh + d];
    ob[i] = s;
  }
}

template <typename Elt, int KV>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* k_scale, const void* v_scale,
                   const void* pages, const void* pos, void* out, int B,
                   int Hkv, int G, int Dh, int M, int P, int bs,
                   float scale, int smem, cudaStream_t stream) {
  using S = typename pk::Stored<Elt, KV>::T;
  auto kernel = decode_attention_kernel<Elt, KV>;
  cudaError_t err = pk::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<B * Hkv, kThreads, smem, stream>>>(
      static_cast<const Elt*>(q), static_cast<const S*>(k),
      static_cast<const S*>(v), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(pages),
      static_cast<const int*>(pos), static_cast<float*>(out), Hkv, G, Dh,
      M, P, bs, scale);
  return cudaGetLastError();
}

template <typename Elt>
cudaError_t launch_kv(int kv, const void* q, const void* k, const void* v,
                      const void* k_scale, const void* v_scale,
                      const void* pages, const void* pos, void* out, int B,
                      int Hkv, int G, int Dh, int M, int P, int bs,
                      float scale, int smem, cudaStream_t s) {
  if (kv == pk::kModel)
    return launch<Elt, pk::kModel>(q, k, v, k_scale, v_scale, pages, pos,
                                   out, B, Hkv, G, Dh, M, P, bs, scale,
                                   smem, s);
  if (kv == pk::kInt8)
    return launch<Elt, pk::kInt8>(q, k, v, k_scale, v_scale, pages, pos,
                                  out, B, Hkv, G, Dh, M, P, bs, scale,
                                  smem, s);
  if (kv == pk::kInt4)
    return launch<Elt, pk::kInt4>(q, k, v, k_scale, v_scale, pages, pos,
                                  out, B, Hkv, G, Dh, M, P, bs, scale,
                                  smem, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int pk_decode_attention(const void* q, const void* k,
                                   const void* v, const void* k_scale,
                                   const void* v_scale, const void* pages,
                                   const void* pos, void* out, int B,
                                   int Hkv, int G, int Dh, int M, int P,
                                   int bs, float scale, int dtype, int kv,
                                   int smem, void* stream) {
  if (B * Hkv == 0) return cudaSuccess;
  if (G < 1 || G > kMaxG || Dh % 32 || Dh > 32 * kMaxDPL)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == pk::kBF16)
    return launch_kv<__nv_bfloat16>(kv, q, k, v, k_scale, v_scale, pages,
                                    pos, out, B, Hkv, G, Dh, M, P, bs,
                                    scale, smem, s);
  if (dtype == pk::kF32)
    return launch_kv<float>(kv, q, k, v, k_scale, v_scale, pages, pos, out,
                            B, Hkv, G, Dh, M, P, bs, scale, smem, s);
  return cudaErrorInvalidValue;
}
