// Flash-decode attention over the head-major paged KV pool, positions
// split across CTAs.
//
// Replaces paddle_tpu/ops/pallas/decode.py::flash_decode_attention (the
// Pallas kernel _decode_kernel): one decode step of grouped-query
// attention. For slot b and kv-head h, the G query rows attend over the
// logical positions 0..pos[b], read through pages[b, :] from the pool
// [Hkv, M, Dh]; scores are divided by sqrt(Dh), one exact softmax, then
// p @ V. Output fp32 [B, Hkv, G, Dh].
//
// What bounds it on the H100: bytes. Each (slot, head) reads its
// (pos+1) K and V rows once and does 4*G*Dh flops per row -- about one
// flop per byte for G=1 bf16, far below the ~295 flop/byte ridge. At the
// serving slice (B=8, Hkv=12, Dh=64, positions up to ~765) that is ~10 MB,
// ~3 us at 3.35 TB/s. A quantized pool moves (Dh + 4) bytes per row
// (int8) or (Dh/2 + 4) (int4) instead of 2*Dh.
//
// What held the previous design back was latency, not bytes: one CTA
// per (slot, head) walked its positions one dependent 2-byte load after
// another. This design puts every load of a CTA in flight at once:
//   - grid (slot x kv-head, split): a split is kSplit = 64 consecutive
//     logical positions, a constant of the kernel (never derived from B
//     or the card), so a slot's arithmetic depends on its own inputs
//     only; a split that starts past pos[b] exits at once;
//   - a CTA stages its split's physical rows from the page table once
//     (the page entries loaded while pos[b] is), then issues every K row
//     and every V row of the split as 16-byte cp.async copies into
//     shared memory (a bf16 Dh=64 row is 8 copies, int8 4, int4 2), K
//     (with the row scales) and V in two commit groups, so the scores
//     start while V is still in flight;
//   - scores: LPR lanes share a row (its 16-byte chunks, LPR the chunk
//     count rounded up to a power of two, at most 32), so a warp scores
//     32/LPR rows per pass and the lanes' partial dots meet in a
//     shuffle tree; the G <= 8 query rows of the kv-head share every K/V
//     row loaded;
//   - each split computes its own max, exp, sum and p @ V (positions past
//     pos[b] are never read: they carry exactly zero weight, as after the
//     TPU kernel's -1e30 mask);
//   - combine: a slot with one split writes its output directly. With
//     more, each split writes fp32 (m, l, o) partials, and the last CTA of
//     the (slot, head) to arrive -- an atomic counter, __threadfence before
//     it, used for ordering only -- combines them in ascending split
//     order, o = sum e^(m_i - m) o_i / sum e^(m_i - m) l_i, and resets the
//     counter to 0. Values never go through atomics, so two launches are
//     bitwise equal, and a slot's output is the same at any batch size.
//     One launch per layer per step: the engine is launch-bound.
// Quantized pools: the codes stay codes; K's row scale multiplies the
// product after it (ks[t] * (q . code_t)) and V's is folded into p
// (p_t * vs[t]) before p @ V. Both differ from dequantize_kv's order by
// one fp32 rounding, far inside the 1e-4 gate.
// Query dtypes: bf16 and fp32 queries are two instantiations of this
// source. With G <= 8 query rows a kv-head there is no 64-row tile for
// wgmma to fill, so the products stay on the CUDA cores.
// Left for later: TMA page loads, a persistent grid over (slot, head,
// split), and fusing the step's pool write into the kernel.
#include "flash_tc.cuh"

namespace {

using pk::tc::cp_async_16;
using pk::tc::cp_async_4;
using pk::tc::cp_async_commit;
using pk::tc::smem_u32;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kSplit = 64;      // logical positions per CTA
constexpr int kMaxG = 8;        // query rows per kv-head (GQA group)

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// stored bytes of one pool row
template <typename Elt, int KV>
__host__ __device__ __forceinline__ int row_bytes(int Dh) {
  return KV == pk::kModel ? Dh * (int)sizeof(Elt)
                          : (KV == pk::kInt8 ? Dh : Dh / 2);
}

// logical elements in one 16-byte chunk of a stored row
template <typename Elt, int KV>
__host__ __device__ constexpr int chunk_elems() {
  return KV == pk::kModel ? 16 / (int)sizeof(Elt)
                          : (KV == pk::kInt8 ? 16 : 32);
}

// the elements of one 16-byte chunk as fp32: model-dtype values, or the
// exact integer codes (nibbles sign-extended, element 2j in the low
// nibble of byte j)
template <typename Elt, int KV>
__device__ __forceinline__ void widen_chunk(const uint4& raw,
                                            float (&x)[chunk_elems<Elt, KV>()]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
  if constexpr (KV == pk::kModel && sizeof(Elt) == 2) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  } else if constexpr (KV == pk::kModel) {
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = __uint_as_float(w[i]);
  } else if constexpr (KV == pk::kInt8) {
#pragma unroll
    for (int i = 0; i < 16; ++i)
      x[i] = static_cast<float>(
          static_cast<int>(w[i >> 2] << (24 - 8 * (i & 3))) >> 24);
  } else {
#pragma unroll
    for (int i = 0; i < 32; ++i)
      x[i] = static_cast<float>(
          static_cast<int>(w[i >> 3] << (28 - 4 * (i & 7))) >> 28);
  }
}

// element d of a stored row as fp32 (a quantized row: its integer code)
template <typename Elt, int KV>
__device__ __forceinline__ float elem(const uint8_t* row, int d) {
  if constexpr (KV == pk::kModel) {
    return pk::to_f32(reinterpret_cast<const Elt*>(row)[d]);
  } else if constexpr (KV == pk::kInt8) {
    return static_cast<float>(reinterpret_cast<const int8_t*>(row)[d]);
  } else {
    const int p = reinterpret_cast<const int8_t*>(row)[d >> 1];
    return static_cast<float>((d & 1) ? (p >> 4) : (((p & 0xF) ^ 8) - 8));
  }
}

template <typename Elt, int KV>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const Elt* __restrict__ q, const uint8_t* __restrict__ k,
                    const uint8_t* __restrict__ v,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ pages,
                    const int* __restrict__ pos, float* __restrict__ out,
                    float* __restrict__ part, int* __restrict__ counters,
                    int Hkv, int G, int Dh, int M, int P, int bs,
                    float scale) {
  constexpr bool kQuant = KV != pk::kModel;
  constexpr int kEpc = chunk_elems<Elt, KV>();
  extern __shared__ __align__(16) uint8_t smem[];
  const int bh = blockIdx.x, split = blockIdx.y, nsplit = gridDim.y;
  const int BH = gridDim.x;
  const int b = bh / Hkv, h = bh % Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int GD = G * Dh;
  const int t0 = split * kSplit;
  // the split's page entry is loaded before pos[b] is known: the two
  // loads overlap
  const int tp = t0 + tid;
  const int page = tid < kSplit && tp < P * bs
                       ? pages[(size_t)b * P + tp / bs] : 0;
  const int T = min(pos[b] + 1, P * bs);
  const int nact = T > 0 ? (T + kSplit - 1) / kSplit : 0;
  float* ob = out + (size_t)bh * GD;
  if (nact == 0) {                 // no position visible: zeros
    if (split == 0)
      for (int i = tid; i < GD; i += kThreads) ob[i] = 0.f;
    return;
  }
  if (split >= nact) return;

  // shared memory, in the order decode_split_layout sizes it
  const int RB = row_bytes<Elt, KV>(Dh);
  const int ngroups = max(1, kThreads / Dh);  // p @ V: position groups
  uint8_t* kv_s = smem;                        // [2][kSplit][RB]: K, V
  float* q_s = reinterpret_cast<float*>(smem + 2 * kSplit * RB);  // [G, Dh]
  float* s_s = q_s + GD;                       // [G, kSplit] scores -> p
  float* red_s = s_s + G * kSplit;             // [ngroups, G, Dh]
  int* rows_s = reinterpret_cast<int*>(red_s + ngroups * GD);  // [kSplit]
  float* ks_s = reinterpret_cast<float*>(rows_s + kSplit);     // [kSplit]
  float* vs_s = ks_s + kSplit;                 // [kSplit]
  float* ml_s = vs_s + kSplit;                 // [2, G]: max, sum
  int* last_s = reinterpret_cast<int*>(ml_s + 2 * G);

  const int n = min(kSplit, T - t0);
  if (tid < n) {
    const int row = page * bs + tp % bs;
    rows_s[tid] = row;
    if constexpr (kQuant) {        // the row scales land with K
      cp_async_4(smem_u32(ks_s + tid), k_scale + (size_t)h * M + row, true);
      cp_async_4(smem_u32(vs_s + tid), v_scale + (size_t)h * M + row, true);
    }
  }
  const Elt* qb = q + (size_t)bh * GD;
  for (int i = tid; i < GD; i += kThreads) q_s[i] = pk::to_f32(qb[i]);
  __syncthreads();

  // every K row of the split, then every V row: all copies in flight
  const int RC = RB / 16;                      // 16-byte chunks per row
  const uint8_t* kh = k + (size_t)h * M * RB;
  const uint8_t* vh = v + (size_t)h * M * RB;
  const uint32_t kv_u = smem_u32(kv_s);
  for (int i = tid; i < n * RC; i += kThreads) {
    const int t = i / RC, c = i % RC;
    cp_async_16(kv_u + t * RB + 16 * c, kh + (size_t)rows_s[t] * RB + 16 * c,
                true);
  }
  cp_async_commit();
  for (int i = tid; i < n * RC; i += kThreads) {
    const int t = i / RC, c = i % RC;
    cp_async_16(kv_u + (kSplit + t) * RB + 16 * c,
                vh + (size_t)rows_s[t] * RB + 16 * c, true);
  }
  cp_async_commit();
  cp_async_wait<1>();                          // this thread's K copies
  __syncthreads();                             // everyone's

  // scores: LPR lanes a row, lane `sub` holding chunks sub, sub + LPR
  int LPR = 1;
  while (LPR < RC && LPR < 32) LPR <<= 1;
  const int RPW = 32 / LPR;                    // rows a warp pass
  const int sub = lane & (LPR - 1), rw = lane / LPR;
  for (int base = warp * RPW; base < n; base += kWarps * RPW) {
    const int t = base + rw;
    float acc[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) acc[g] = 0.f;
    if (t < n) {
      for (int c = sub; c < RC; c += LPR) {
        float x[kEpc];
        widen_chunk<Elt, KV>(
            *reinterpret_cast<const uint4*>(kv_s + t * RB + 16 * c), x);
        const float* qc = q_s + c * kEpc;
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) {
          if (g < G) {
            float a = acc[g];
#pragma unroll
            for (int e = 0; e < kEpc; e += 4) {
              const float4 qq =
                  *reinterpret_cast<const float4*>(qc + g * Dh + e);
              a = fmaf(qq.x, x[e], a);
              a = fmaf(qq.y, x[e + 1], a);
              a = fmaf(qq.z, x[e + 2], a);
              a = fmaf(qq.w, x[e + 3], a);
            }
            acc[g] = a;
          }
        }
      }
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < G) {
        float a = acc[g];
        for (int o = LPR >> 1; o > 0; o >>= 1)
          a += __shfl_xor_sync(pk::kFull, a, o);
        if (t < n && sub == 0)
          s_s[g * kSplit + t] = (kQuant ? a * ks_s[t] : a) / scale;
      }
    }
  }
  __syncthreads();

  // the split's softmax, one warp per query row: max, exp, sum; V's
  // row scale folded into p
  for (int g = warp; g < G; g += kWarps) {
    float* sr = s_s + g * kSplit;
    float m = -INFINITY;
    for (int t = lane; t < n; t += 32) m = fmaxf(m, sr[t]);
    m = pk::warp_max(m);
    float l = 0.f;
    for (int t = lane; t < n; t += 32) {
      const float e = expf(sr[t] - m);
      l += e;
      sr[t] = kQuant ? e * vs_s[t] : e;
    }
    l = pk::warp_sum(l);
    if (lane == 0) {
      ml_s[g] = m;
      ml_s[G + g] = l;
    }
  }
  cp_async_wait<0>();                          // V
  __syncthreads();

  // p @ V: thread (group, d) sums positions t = group (mod ngroups),
  // then the groups' partial sums are added in a fixed order
  const uint8_t* v_s = kv_s + kSplit * RB;
  for (int w = tid; w < ngroups * Dh; w += kThreads) {
    const int grp = w / Dh, d = w % Dh;
    float acc[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) acc[g] = 0.f;
    for (int t = grp; t < n; t += ngroups) {
      const float x = elem<Elt, KV>(v_s + t * RB, d);
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < G) acc[g] = fmaf(s_s[g * kSplit + t], x, acc[g]);
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
      if (g < G) red_s[(grp * G + g) * Dh + d] = acc[g];
  }
  __syncthreads();

  if (nact == 1) {                             // the split is the slot
    for (int i = tid; i < GD; i += kThreads) {
      const int g = i / Dh, d = i % Dh;
      float o = 0.f;
      for (int grp = 0; grp < ngroups; ++grp)
        o += red_s[(grp * G + g) * Dh + d];
      ob[i] = o / ml_s[G + g];
    }
    return;
  }

  // partials: o [BH, nsplit, G, Dh], then (m, l) [BH, nsplit, 2, G]
  float* po = part + ((size_t)bh * nsplit + split) * GD;
  float* pml = part + (size_t)BH * nsplit * GD +
               ((size_t)bh * nsplit + split) * 2 * G;
  for (int i = tid; i < GD; i += kThreads) {
    const int g = i / Dh, d = i % Dh;
    float o = 0.f;
    for (int grp = 0; grp < ngroups; ++grp) o += red_s[(grp * G + g) * Dh + d];
    po[i] = o;
  }
  if (tid < 2 * G) pml[tid] = ml_s[tid];
  __threadfence();                             // partials before arrival
  __syncthreads();
  if (tid == 0) *last_s = atomicAdd(counters + bh, 1) == nact - 1;
  __syncthreads();
  if (!*last_s) return;
  if (tid == 0) counters[bh] = 0;              // ready for the next launch
  __threadfence();

  // the last split to arrive combines all of them, in ascending order:
  // the global max of each query row (a warp a row, its lanes over the
  // splits), then, 64 splits at a time, each split's weight e^(m_i - m)
  // and weighted sum into shared memory, every load of a pass in flight
  // at once; the (now free) score, partial-sum and q buffers hold them
  // and the running output sums
  const float* base_o = part + (size_t)bh * nsplit * GD;
  const float* base_ml = part + (size_t)BH * nsplit * GD +
                         (size_t)bh * nsplit * 2 * G;
  for (int g = warp; g < G; g += kWarps) {
    float m = -INFINITY;
    for (int j = lane; j < nact; j += 32)
      m = fmaxf(m, __ldcg(base_ml + (size_t)j * 2 * G + g));
    m = pk::warp_max(m);
    if (lane == 0) {
      ml_s[g] = m;
      ml_s[G + g] = 0.f;
    }
  }
  __syncthreads();
  float* w_s = s_s;                            // [kSplit, G]
  float* wl_s = red_s;                         // [kSplit, G]
  float* acc_s = q_s;                          // [G, Dh] running sums
  for (int i = tid; i < GD; i += kThreads) acc_s[i] = 0.f;
  for (int j0 = 0; j0 < nact; j0 += kSplit) {
    const int nj = min(kSplit, nact - j0);
    for (int x = tid; x < nj * G; x += kThreads) {
      const int g = x % G;
      const float* ml = base_ml + (size_t)(j0 + x / G) * 2 * G;
      const float w = expf(__ldcg(ml + g) - ml_s[g]);
      w_s[x] = w;
      wl_s[x] = w * __ldcg(ml + G + g);
    }
    __syncthreads();
    if (tid < G) {
      float l = ml_s[G + tid];
      for (int j = 0; j < nj; ++j) l += wl_s[j * G + tid];
      ml_s[G + tid] = l;
    }
    for (int i = tid; i < GD; i += kThreads) {
      const int g = i / Dh;
      const float* po_i = base_o + (size_t)j0 * GD + i;
      float o = acc_s[i];
#pragma unroll 8
      for (int j = 0; j < nj; ++j)
        o = fmaf(w_s[j * G + g], __ldcg(po_i + (size_t)j * GD), o);
      acc_s[i] = o;
    }
    __syncthreads();
  }
  for (int i = tid; i < GD; i += kThreads)
    ob[i] = acc_s[i] / ml_s[G + i / Dh];
}

// shared memory of one CTA: paddle_tpu_torch/ops/kernels/decode.py::
// decode_split_layout computes the same bytes
template <typename Elt, int KV>
int smem_bytes(int G, int Dh) {
  const int ngroups = kThreads / Dh > 1 ? kThreads / Dh : 1;
  return 2 * kSplit * row_bytes<Elt, KV>(Dh) +
         4 * (G * Dh + G * kSplit + ngroups * G * Dh + 3 * kSplit + 2 * G +
              1);
}

template <typename Elt, int KV>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* k_scale, const void* v_scale,
                   const void* pages, const void* pos, void* out, void* part,
                   void* counters, int B, int Hkv, int G, int Dh, int M,
                   int P, int bs, float scale, int smem,
                   cudaStream_t stream) {
  if (smem != smem_bytes<Elt, KV>(G, Dh)) return cudaErrorInvalidValue;
  auto kernel = decode_split_kernel<Elt, KV>;
  cudaError_t err = pk::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(B * Hkv, (P * bs + kSplit - 1) / kSplit);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const Elt*>(q), static_cast<const uint8_t*>(k),
      static_cast<const uint8_t*>(v), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(pages),
      static_cast<const int*>(pos), static_cast<float*>(out),
      static_cast<float*>(part), static_cast<int*>(counters), Hkv, G, Dh, M,
      P, bs, scale);
  return cudaGetLastError();
}

template <typename Elt>
cudaError_t launch_kv(int kv, const void* q, const void* k, const void* v,
                      const void* k_scale, const void* v_scale,
                      const void* pages, const void* pos, void* out,
                      void* part, void* counters, int B, int Hkv, int G,
                      int Dh, int M, int P, int bs, float scale, int smem,
                      cudaStream_t s) {
  if (kv == pk::kModel)
    return launch<Elt, pk::kModel>(q, k, v, k_scale, v_scale, pages, pos,
                                   out, part, counters, B, Hkv, G, Dh, M, P,
                                   bs, scale, smem, s);
  if (kv == pk::kInt8)
    return launch<Elt, pk::kInt8>(q, k, v, k_scale, v_scale, pages, pos,
                                  out, part, counters, B, Hkv, G, Dh, M, P,
                                  bs, scale, smem, s);
  if (kv == pk::kInt4)
    return launch<Elt, pk::kInt4>(q, k, v, k_scale, v_scale, pages, pos,
                                  out, part, counters, B, Hkv, G, Dh, M, P,
                                  bs, scale, smem, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int pk_decode_attention(const void* q, const void* k,
                                   const void* v, const void* k_scale,
                                   const void* v_scale, const void* pages,
                                   const void* pos, void* out, void* part,
                                   void* counters, int B, int Hkv, int G,
                                   int Dh, int M, int P, int bs, float scale,
                                   int dtype, int kv, int smem,
                                   void* stream) {
  if (B * Hkv == 0) return cudaSuccess;
  if (G < 1 || G > kMaxG || Dh % 32 || Dh > 256 || P * bs < 1 ||
      (P * bs + kSplit - 1) / kSplit > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == pk::kBF16)
    return launch_kv<__nv_bfloat16>(kv, q, k, v, k_scale, v_scale, pages,
                                    pos, out, part, counters, B, Hkv, G, Dh,
                                    M, P, bs, scale, smem, s);
  if (dtype == pk::kF32)
    return launch_kv<float>(kv, q, k, v, k_scale, v_scale, pages, pos, out,
                            part, counters, B, Hkv, G, Dh, M, P, bs, scale,
                            smem, s);
  return cudaErrorInvalidValue;
}
