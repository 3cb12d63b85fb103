// Fused sampling epilogue: one token id per logits row, no sort.
//
// Replaces paddle_tpu/ops/pallas/decode.py::fused_sample (the Pallas
// kernel _sample_kernel and its helpers _sortable_key, _kth_key,
// _hash_uniform, _first_argmax). Per row:
// - greedy: first-index argmax;
// - top-k: the exact k-th largest order-preserving uint32 key, ties at
//   the threshold kept;
// - temperature divide, then Gumbel-max over one of two uniform streams:
//   - hashed (the decode tail): splitmix-hashed uniforms of (seed, row,
//     lane) with the TPU kernel's constants and uint32 wraparound, so
//     bitwise the same uniforms; kept lanes compare keys;
//   - threefry (the prefill tail): jax.random.categorical under
//     PRNGKey(seed), the uniforms and Gumbel noise of
//     paddle_tpu_torch/ops/prng.py (threefry2x32 over the row-major flat
//     index, XLA:CPU's log), kept lanes compare floats against the k-th
//     value, as serving/sampling.py::sample_tokens does;
// - temperature <= 0 picks the greedy id.
// A hashed uniform that rounds to 1.0 gives a +inf Gumbel term, and NaN
// on a filtered lane (-inf + inf); NaN never wins here (every comparison
// with it is false), where the TPU kernel's max propagates it and
// returns the out-of-range id V.
//
// What bounds it on the H100: bytes. The work per logit is a few
// compares, a hash and two logs; the row (V*4 bytes, 201 KB at
// V=50257) must cross from memory once.
//
// What the design does about it: each row is split over a cluster of
// kCluster CTAs (16, a non-portable cluster size), so B = 8 rows fill
// about one wave of the 132 SMs. Every CTA reads its slice of the row
// once, with 16-byte loads on an aligned body (rows of odd V are not
// 16-byte aligned: a scalar head and tail), into shared memory, and
// works from there:
// - argmax: a local reduction, then the CTAs' partials through
//   distributed shared memory;
// - top-k: radix select over the keys, 4 rounds of 8-bit digits from
//   the top. Each CTA builds a histogram of its slice under the current
//   prefix (warp-aggregated shared atomics), every CTA sums bin t over
//   the cluster through DSMEM and picks the same digit from the same
//   integers. Such a round costs a cluster barrier and 16 remote reads
//   a bin, ~4 us on the H100, so as soon as the chosen digit holds at
//   most kCap keys (at V=50257 and k=50, after the first round) every
//   CTA gathers those keys and runs the rounds left on them alone;
// - the Gumbel-max: as the argmax.
// better() is a total order and the counts are integer sums, so any
// reduction tree gives the same id, and a row's answer does not depend
// on the batch. logf is the IEEE-accurate libdevice one (no fast math):
// the hashed stream's plain version on the card is torch.log.
#include <cooperative_groups.h>
#include <limits.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 16;     // CTAs per row
constexpr int kBins = 256;       // 8-bit radix digits
static_assert(kBins <= kThreads, "one thread per bin");
// keys the direct selection takes (two lists of them in dynamic shared
// memory beside the slice)
constexpr int kCap = 8192;
constexpr float kTiny = 1.17549435e-38f;     // float32's smallest normal
constexpr int kMaxDevices = 64;

struct ArgMax {
  float v;
  int i;
};

// larger value wins; equal values keep the smaller index (jnp.argmax's
// first-index convention). A total order on non-NaN values, so any
// reduction tree gives the same answer.
__device__ __forceinline__ ArgMax better(ArgMax a, ArgMax b) {
  return (b.v > a.v || (b.v == a.v && b.i < a.i)) ? b : a;
}

struct Shared {
  ArgMax part[2];            // this CTA's greedy and sampled partials
  ArgMax red[kWarps];
  unsigned hist[2][kBins];   // one per radix round, alternating
  unsigned scan[kWarps];
  unsigned digit, need, count;
  unsigned ncand;
  unsigned offs[kCluster + 1];
};

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
  a = lane < kWarps ? red[lane] : ArgMax{-INFINITY, INT_MAX};
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    ArgMax b{__shfl_xor_sync(pk::kFull, a.v, o),
             __shfl_xor_sync(pk::kFull, a.i, o)};
    a = better(a, b);
  }
  __syncthreads();                  // red is reused by the next call
  return a;
}

// the cluster's best of the CTAs' partials part[slot], by warp 0 of
// rank 0 (lane q reads rank q)
__device__ int cluster_argmax(cg::cluster_group& cluster, Shared& sh,
                              int slot) {
  ArgMax a{-INFINITY, INT_MAX};
  if (threadIdx.x < kCluster)
    a = cluster.map_shared_rank(&sh, threadIdx.x)->part[slot];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    ArgMax b{__shfl_xor_sync(pk::kFull, a.v, o),
             __shfl_xor_sync(pk::kFull, a.i, o)};
    a = better(a, b);
  }
  return a.i;
}

// fp32 -> uint32 order-preserving image (decode.py::_sortable_key)
__device__ __forceinline__ uint32_t sortable_key(float x) {
  const uint32_t u = __float_as_uint(x);
  return u ^ (((u >> 31) * 0x7FFFFFFFu) | 0x80000000u);
}

// its inverse: the float whose key is k
__device__ __forceinline__ float key_float(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k ^ 0x80000000u) : ~k);
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

// prng.py::threefry2x32 on the counter words (hi, lo) of a flat index,
// then prng.py::random_bits's draw and prng.py::uniform over
// [tiny, 1): the float32 steps as single IEEE operations
__device__ __forceinline__ float threefry_uniform(uint32_t k0, uint32_t k1,
                                                  uint64_t i) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  constexpr int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  uint32_t x0 = static_cast<uint32_t>(i >> 32) + ks[0];
  uint32_t x1 = static_cast<uint32_t>(i) + ks[1];
#pragma unroll
  for (int g = 0; g < 5; ++g) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      x0 += x1;
      x1 = __funnelshift_l(x1, x1, rot[g & 1][r]) ^ x0;
    }
    x0 += ks[(g + 1) % 3];
    x1 += ks[(g + 2) % 3] + static_cast<uint32_t>(g + 1);
  }
  const float f =
      __fsub_rn(__uint_as_float(((x0 ^ x1) >> 9) | 0x3F800000u), 1.0f);
  // f * (1 - tiny) + tiny with 1 - tiny == 1.0f in float32
  return fmaxf(kTiny, __fadd_rn(f, kTiny));
}

// prng.py::xla_log, XLA:CPU's float32 log for positive normal x: the
// Cephes polynomial with its fused multiply-adds, every other step one
// rounding (no contraction). The constants are the double literals
// rounded to float, as XLA and the plain version round them.
__device__ __forceinline__ float xla_log(float x) {
  const uint32_t b = __float_as_uint(x);
  float e = __fsub_rn(static_cast<float>((b >> 23) & 0xFFu), 126.0f);
  const float m = __uint_as_float((b & 0x007FFFFFu) | 0x3F000000u);
  const bool small = m < static_cast<float>(0.707106781186547524);
  if (small) e = __fsub_rn(e, 1.0f);
  float t = __fadd_rn(__fsub_rn(m, 1.0f), small ? m : 0.0f);
  const float t2 = __fmul_rn(t, t), t3 = __fmul_rn(t2, t);
  float y = __fmaf_rn(t, static_cast<float>(7.0376836292e-2),
                      static_cast<float>(-1.1514610310e-1));
  float y1 = __fmaf_rn(t, static_cast<float>(-1.2420140846e-1),
                       static_cast<float>(1.4249322787e-1));
  float y2 = __fmaf_rn(t, static_cast<float>(2.0000714765e-1),
                       static_cast<float>(-2.4999993993e-1));
  y = __fmaf_rn(y, t, static_cast<float>(1.1676998740e-1));
  y1 = __fmaf_rn(y1, t, static_cast<float>(-1.6668057665e-1));
  y2 = __fmaf_rn(y2, t, static_cast<float>(3.3333331174e-1));
  y = __fmaf_rn(y, t3, y1);
  y = __fmaf_rn(y, t3, y2);
  y = __fmaf_rn(y, t3, __fmul_rn(e, static_cast<float>(-2.12194440e-4)));
  t = __fsub_rn(t, __fmul_rn(t2, 0.5f));
  t = __fadd_rn(t, y);
  return __fadd_rn(t, __fmul_rn(e, 0.693359375f));
}

// the digit of this round: thread t < kBins holds the count c of digit
// kBins-1-t; the digit where the count from the top first reaches
// ``need`` wins (one thread writes it, the rank left and the digit's
// count)
__device__ void pick_digit(Shared& sh, unsigned c, unsigned need) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  unsigned incl = c;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned v = __shfl_up_sync(pk::kFull, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) sh.scan[warp] = incl;
  __syncthreads();
  if (tid < kBins) {
    for (int w = 0; w < warp; ++w) incl += sh.scan[w];
    const unsigned above = incl - c;
    if (above < need && incl >= need) {
      sh.digit = kBins - 1 - tid;
      sh.need = need - above;
      sh.count = c;
    }
  }
  __syncthreads();
}

// the need-th largest of the keys whose bits from ``shift`` up equal
// those of ``prefix``, once the cluster holds at most kCap of them: each
// CTA lists its own in ``cand`` (warp-aggregated appends), every CTA
// gathers the lists through DSMEM into ``all`` and runs the radix rounds
// left on those keys alone, with no cluster barrier. The list order
// does not matter: every round counts.
__device__ uint32_t select_under_prefix(cg::cluster_group& cluster,
                                        Shared& sh, const float* s, int n,
                                        uint32_t* cand, uint32_t* all,
                                        uint32_t prefix, int shift,
                                        unsigned need) {
  const int tid = threadIdx.x, lane = tid & 31;
  if (tid == 0) sh.ncand = 0;
  __syncthreads();
  for (int i0 = 0; i0 < n; i0 += kThreads) {
    const int i = i0 + tid;
    const uint32_t key = i < n ? sortable_key(s[i]) : 0u;
    const bool hit = i < n && (key >> shift) == (prefix >> shift);
    const unsigned mask = __ballot_sync(pk::kFull, hit);
    if (!mask) continue;
    const int first = __ffs(mask) - 1;
    unsigned base = 0;
    if (lane == first) base = atomicAdd(&sh.ncand, __popc(mask));
    base = __shfl_sync(pk::kFull, base, first);
    if (hit) cand[base + __popc(mask & ((1u << lane) - 1u))] = key;
  }
  cluster.sync();                   // every CTA's list is complete
  if (tid < kCluster)
    sh.offs[tid + 1] = cluster.map_shared_rank(&sh, tid)->ncand;
  __syncthreads();
  if (tid == 0) {
    sh.offs[0] = 0;
    for (int q = 0; q < kCluster; ++q) sh.offs[q + 1] += sh.offs[q];
  }
  __syncthreads();
  const unsigned total = sh.offs[kCluster];
  for (unsigned t = tid; t < total; t += kThreads) {
    int q = 0;
    while (sh.offs[q + 1] <= t) ++q;
    all[t] = cluster.map_shared_rank(cand, q)[t - sh.offs[q]];
  }
  // every CTA is past reading the histograms: hist[0] is free
  unsigned* h = sh.hist[0];
  uint32_t kstar = prefix;
  for (int low = shift - 8; low >= 0; low -= 8) {
    if (tid < kBins) h[tid] = 0;
    __syncthreads();
    for (unsigned t = tid; t < total; t += kThreads) {
      const uint32_t x = all[t];
      if ((x >> (low + 8)) == (kstar >> (low + 8)))
        atomicAdd(&h[(x >> low) & (kBins - 1)], 1u);
    }
    __syncthreads();
    pick_digit(sh, tid < kBins ? h[kBins - 1 - tid] : 0u, need);
    kstar |= sh.digit << low;
    need = sh.need;
  }
  return kstar;
}

template <bool kThreefry>
__global__ void __launch_bounds__(kThreads)
fused_sample_kernel(const float* __restrict__ logits,
                    const float* __restrict__ temperature,
                    const int* __restrict__ top_k, int* __restrict__ out,
                    int V, int chunk, const int* __restrict__ seed_ptr) {
  __shared__ Shared sh;
  // the seed's uint32 image, read from device memory: a captured launch
  // takes each replay's seed from the same address
  const auto seed = static_cast<uint32_t>(__ldg(seed_ptr));
  extern __shared__ float4 slice_mem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int row = blockIdx.x / kCluster, tid = threadIdx.x;
  const int lo = min(rank * chunk, V), n = min(lo + chunk, V) - lo;
  const float* g = logits + (size_t)row * V + lo;

  // this CTA's slice into shared memory, at the same offset mod 16
  // bytes as in the row, so the aligned body moves in 16-byte vectors
  const int mis = static_cast<int>((reinterpret_cast<uintptr_t>(g) >> 2) & 3);
  const int head = min((4 - mis) & 3, n);
  const int nv = (n - head) >> 2;
  float* s = reinterpret_cast<float*>(slice_mem) + mis;
  uint32_t* cand = reinterpret_cast<uint32_t*>(slice_mem) + chunk + 4;
  ArgMax a{-INFINITY, INT_MAX};
  for (int i = tid; i < head; i += kThreads) {
    s[i] = g[i];
    a = better(a, ArgMax{s[i], lo + i});
  }
  const float4* gv = reinterpret_cast<const float4*>(g + head);
  float4* sv = reinterpret_cast<float4*>(s + head);
#pragma unroll 4
  for (int j = tid; j < nv; j += kThreads) {
    const float4 v = __ldcs(gv + j);
    sv[j] = v;
    const int at = lo + head + 4 * j;
    a = better(a, ArgMax{v.x, at});
    a = better(a, ArgMax{v.y, at + 1});
    a = better(a, ArgMax{v.z, at + 2});
    a = better(a, ArgMax{v.w, at + 3});
  }
  for (int i = head + 4 * nv + tid; i < n; i += kThreads) {
    s[i] = g[i];
    a = better(a, ArgMax{s[i], lo + i});
  }
  a = block_argmax(a, sh.red);
  if (tid == 0) sh.part[0] = a;
  cluster.sync();

  const float temp = temperature[row];
  if (!(temp > 0.f)) {
    if (rank == 0 && tid < 32) {
      const int id = cluster_argmax(cluster, sh, 0);
      if (tid == 0) out[row] = id;
    }
    cluster.sync();                 // shared memory outlives the reads
    return;
  }
  const int k = min(max(top_k[row], 0), V);
  // k <= 0 keeps every lane; so does k == V (the k-th key is the min)
  const bool filter = k > 0 && k < V;
  uint32_t kstar = 0;
  if (filter) {
    unsigned need = static_cast<unsigned>(k);
#pragma unroll 1
    for (int round = 0; round < 4; ++round) {
      const int shift = 24 - 8 * round, top = shift + 8;
      unsigned* h = sh.hist[round & 1];
      // this buffer was last read remotely two rounds ago, before every
      // CTA passed the previous round's cluster barrier
      if (tid < kBins) h[tid] = 0;
      __syncthreads();
      for (int i0 = 0; i0 < n; i0 += kThreads) {
        const int i = i0 + tid;
        unsigned d = 0xFFFFFFFFu;
        if (i < n) {
          const uint32_t key = sortable_key(s[i]);
          if (round == 0 || (key >> top) == (kstar >> top))
            d = (key >> shift) & (kBins - 1);
        }
        // past the first round most warps hold no key under the prefix
        if (!__any_sync(pk::kFull, d != 0xFFFFFFFFu)) continue;
        const unsigned peers = __match_any_sync(pk::kFull, d);
        if (d != 0xFFFFFFFFu && (tid & 31) == __ffs(peers) - 1)
          atomicAdd(&h[d], __popc(peers));
      }
      cluster.sync();               // every CTA's histogram is complete
      unsigned c = 0;
      if (tid < kBins) {
        unsigned part[kCluster];
#pragma unroll
        for (int q = 0; q < kCluster; ++q)
          part[q] = cluster.map_shared_rank(h, q)[kBins - 1 - tid];
#pragma unroll
        for (int q = 0; q < kCluster; ++q) c += part[q];
      }
      pick_digit(sh, c, need);
      kstar |= sh.digit << shift;
      need = sh.need;
      if (round < 3 && sh.count <= kCap) {
        kstar = select_under_prefix(cluster, sh, s, n, cand, cand + kCap,
                                    kstar, shift, need);
        break;
      }
    }
  }

  const float kth = key_float(kstar);
  ArgMax best{-INFINITY, INT_MAX};
#pragma unroll 2
  for (int i = tid; i < n; i += kThreads) {
    const float xi = s[i];
    const int lane = lo + i;
    bool keep;
    float gum;
    if constexpr (kThreefry) {
      keep = !filter || xi >= kth;
      const float u = threefry_uniform(
          0u, seed, (uint64_t)row * (uint64_t)V + (uint64_t)lane);
      gum = -xla_log(-xla_log(u));
    } else {
      keep = !filter || sortable_key(xi) >= kstar;
      gum = -logf(-logf(hash_uniform(seed, row, lane)));
    }
    const float z = __fdiv_rn(keep ? xi : -INFINITY, temp);
    best = better(best, ArgMax{__fadd_rn(z, gum), lane});
  }
  best = block_argmax(best, sh.red);
  if (tid == 0) sh.part[1] = best;
  cluster.sync();
  if (rank == 0 && tid < 32) {
    const int id = cluster_argmax(cluster, sh, 1);
    if (tid == 0) out[row] = id;
  }
  cluster.sync();                   // shared memory outlives the reads
}

template <bool kThreefry>
cudaError_t launch(const float* logits, const float* temperature,
                   const int* top_k, int* out, int B, int V, const int* seed,
                   cudaStream_t stream) {
  auto* kernel = fused_sample_kernel<kThreefry>;
  // each CTA's slice: a multiple of 4 floats, plus 3 of alignment slack;
  // then the two key lists of the direct selection
  const int chunk = (((V + kCluster - 1) / kCluster) + 3) & ~3;
  const size_t smem =
      (static_cast<size_t>(chunk) + 4 + 2 * kCap) * sizeof(float);
  // once per device: the non-portable cluster size, and room for the
  // largest slice beside the kernel's static shared memory
  static size_t smem_max[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem_max[dev] == 0) {
    cudaFuncAttributes fa = {};
    err = cudaFuncGetAttributes(&fa, kernel);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    const int room = 232448 - static_cast<int>(fa.sharedSizeBytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, room);
    if (err != cudaSuccess) return err;
    smem_max[dev] = room;
  }
  if (smem > smem_max[dev]) return cudaErrorInvalidValue;
  // one cluster of kCluster CTAs per row
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, logits, temperature, top_k, out,
                            V, chunk, seed);
}

}  // namespace

// seed: the address of one int32 in device memory, read by every CTA
// (the TPU kernel's seed is a device scalar too). threefry = 0: the
// hashed stream (seed's uint32 image); 1: the threefry stream under the
// key (0, seed's uint32 image), JAX's PRNGKey(seed)
extern "C" int pk_fused_sample(const void* logits, const void* temperature,
                               const void* top_k, void* out, int B, int V,
                               const void* seed, int threefry, void* stream) {
  if (B == 0) return cudaSuccess;
  if (V < 1) return cudaErrorInvalidValue;
  const auto* x = static_cast<const float*>(logits);
  const auto* t = static_cast<const float*>(temperature);
  const auto* k = static_cast<const int*>(top_k);
  auto* o = static_cast<int*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* u = static_cast<const int*>(seed);
  if (u == nullptr) return cudaErrorInvalidValue;
  return threefry ? launch<true>(x, t, k, o, B, V, u, s)
                  : launch<false>(x, t, k, o, B, V, u, s);
}
