// Flash attention forward: causal or full attention with an online
// softmax, returning the output and the logsumexp of every query row,
// every product on the Hopper tensor cores (wgmma), for bf16 and for
// fp32 inputs (two instantiations of the same kernel).
//
// Replaces paddle_tpu/ops/pallas/attention.py::_flash_fwd (the Pallas
// kernel _fwd_kernel, reached from flash_attention and flash_block_fwd).
// q, k, v, out are [BH, T, D] row-major in one dtype (bf16 or fp32); lse
// is [BH, T] fp32. As there: scores are q . k scaled, masked scores hold
// -1e30 (keys past T; keys after the query when causal), out = acc /
// max(l, 1e-30) and lse = m + log(max(l, 1e-30)).
//
// What bounds it on the H100: at the training slice (BH = 96, T = 1024,
// D = 64, causal) the algorithm's two products are ~1.3e10 FLOPs. bf16
// moves ~51 MB: ~15 us of bytes, ~13 us at the 989 TFLOP/s bf16 peak;
// the split of p below makes p . v two products, ~1.9e10 FLOPs on the
// tensor cores (~20 us). fp32 moves ~101 MB (~30 us) and takes each
// product as six bf16 passes (below): its bound is the same FLOPs at
// 989 / 6 ~ 165 TFLOP/s, ~79 us. The softmax between the products
// (exp2, masks, the splits' conversions) runs on the CUDA cores beside
// them.
//
// The design:
//   - one CTA = one warpgroup per (64-row query tile, bh), the heaviest
//     causal tiles launched first (blockIdx.y = 0 is the last tile); the
//     TPU kernel's sequential loop over key blocks is a loop over
//     64-key tiles inside the CTA, stopping at the diagonal when causal;
//     only the diagonal tile and the tile holding T are masked;
//   - tiles (flash_tc.cuh layout, 128-byte swizzle): q kept for the
//     whole loop, k and v streamed; tile kt + 1 is copied by 16-byte
//     cp.async while the tensor cores work on kt;
//   - S = q . k^T: m64n64k16 wgmma, both operands from shared memory
//     (K-major), D / 16 k-steps, fp32 accumulators in registers;
//   - the online softmax runs on the accumulator fragments in the exp2
//     domain (scores times scale * log2 e), row max and sum over the
//     four threads of a row; l sums the unrounded fp32 p;
//   - O += P . V: p stays in registers as the A operand (FA3's
//     structure), v is the B operand MN-major (transposed flag), N = D
//     padded to 64 or 128.
// Precision (flash_tc.cuh, split operands): the reference takes both
// products in fp32.
//   - bf16: q, k and v are one bf16 term each. One bf16 rounding of p
//     puts out 5–17 bf16 ulps off at T = 512 (tests/test_torch_attention
//     .py::TestTensorCoreArithmetic), over the 2-ulp gate. So p is split
//     into hi = bf16(p) and lo = bf16(p - hi), both go through the
//     tensor cores into the same fp32 accumulator (3 products instead
//     of 2), hi then lo at each k-step, and out lands within 1 ulp. K
//     and V stream through a two-stage ring.
//   - fp32: q, k, v and p are three bf16 terms each, and each product
//     the six cross terms of order 2^-16 and up, smallest first (one
//     TF32 or bf16 rounding misses the plain version's 1e-4 by an order
//     of magnitude: TestFp32TensorCoreArithmetic). cp.async cannot
//     convert, so the K and V rows of a tile land as fp32 in one raw
//     buffer and are split into their three term tiles right after,
//     before the next tile's copy goes into the same buffer (K and V
//     term tiles in one stage); the q tile is split once, straight from
//     global memory. The tensor cores' fp32 accumulation does not round
//     to nearest: o summed in the wgmma accumulators across every tile
//     (rescaled by alpha each tile, as in bf16) read 4.3e-6 / 3.3e-6
//     from a float64 reference at T = 1024 / 4096, ~4x the plain
//     version's 1.2e-6 / 8.2e-7 (tools/attention_f64_error.py, on an
//     H100 80GB HBM3 at 700 W). So each tile's share of p . v goes into
//     a fresh accumulator, 64 columns at a time, and is added to o on
//     the CUDA cores (rs_split_add): 7.5e-7 / 7.4e-7, under plain's.
// Every product is a wgmma; none uses mma.sync or the CUDA cores.
// Registers per thread: 32 of scores, 32 (bf16) or 48 (fp32) of packed
// p terms, D/2 or 64 of output accumulator, and in fp32 32 of the fresh
// one (253 registers at D = 128, no spill). Shared memory at D = 128:
// bf16 80 KB, fp32 209 KB (Plan).
//
// The kernel and its launch templates live here; flash_attn_fwd.cu
// holds the C entry and the bf16 instantiations,
// flash_attn_fwd_fp32_inst.cu the fp32 ones, so that the two halves
// compile in parallel.
#pragma once

#include "flash_tc.cuh"

namespace pk {
namespace fwd {

using namespace pk::tc;

// bytes one block may use (227 KB); _build.py: SMEM_LIMIT
constexpr int kSmemLimit = 232448;

// The shared-memory plan of one instantiation. bf16: one term per tile,
// K and V in a two-stage ring. fp32: three term tiles each of q, K and
// V, K and V in one stage, and one raw buffer of the fp32 K and V rows
// of the tile in flight.
template <typename Elt, int D>
struct Plan {
  static constexpr bool kF32 = std::is_same<Elt, float>::value;
  static constexpr int kTerms = kF32 ? 3 : 1;   // of q, K, V
  static constexpr int kPTerms = kF32 ? 3 : 2;  // of p
  static constexpr int kStages = kF32 ? 1 : 2;  // of the K / V term tiles
  static constexpr int kTile = tile_bytes(kRows, D);
  static constexpr int kRaw = kF32 ? kRows * 4 * D : 0;  // K's or V's rows
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kTerms * kTile;
  static constexpr int kV = kK + kStages * kTerms * kTile;
  static constexpr int kRawAt = kV + kStages * kTerms * kTile;
  static constexpr int kBytes = kRawAt + 2 * kRaw + 1024;
  static_assert(kBytes <= kSmemLimit, "over Hopper's shared memory");
};

template <typename Elt, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_tc_kernel(const Elt* __restrict__ q, const Elt* __restrict__ k,
                    const Elt* __restrict__ v, Elt* __restrict__ out,
                    float* __restrict__ lse, int T, float scale, int causal) {
  using P = Plan<Elt, D>;
  constexpr bool kF32 = P::kF32;
  constexpr int NT = P::kTerms, PT = P::kPTerms;
  constexpr int DP = padded(D);
  constexpr int kTile = P::kTile;
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t base = smem_base(smem);
  const uint32_t qs = base + P::kQ;
  const uint32_t raw0 = base + P::kRawAt;      // fp32 K rows; V's follow
  auto gen = [&](uint32_t a) { return smem + (a - smem_u32(smem)); };
  // term 0 of the K / V tile of key tile kt (term t: + t * kTile)
  auto ktile = [&](int kt) {
    return base + P::kK + kt % P::kStages * NT * kTile;
  };
  auto vtile = [&](int kt) {
    return base + P::kV + kt % P::kStages * NT * kTile;
  };

  const int nq = (T + kRows - 1) / kRows;
  const int qt = nq - 1 - blockIdx.y;
  const int q0 = qt * kRows;
  const size_t off = (size_t)blockIdx.x * T * D;
  const Elt* kg = k + off;
  const Elt* vg = v + off;
  const int nk = causal ? qt + 1 : nq;

  // key tile kt's copies: bf16 into its ring stage, fp32 into the raw
  // buffer
  auto issue = [&](int kt) {
    const int k0 = kt * kRows;
    if constexpr (kF32) {
      load_raw<kRows, 4 * D>(
          raw0, [=](int r) { return kg + (size_t)(k0 + r) * D; }, T - k0,
          kg);
      load_raw<kRows, 4 * D>(
          raw0 + P::kRaw, [=](int r) { return vg + (size_t)(k0 + r) * D; },
          T - k0, vg);
    } else {
      load_tile<kRows, D>(ktile(kt), kg, k0, T);
      load_tile<kRows, D>(vtile(kt), vg, k0, T);
    }
  };

  if constexpr (kF32)      // split once from global memory (fenced with
    split_rows<kRows, D, NT>(          // the first tile's split)
        qs, [=](int r) { return q + off + (size_t)(q0 + r) * D; }, T - q0);
  else
    load_tile<kRows, D>(qs, q + off, q0, T);
  issue(0);
  cp_async_commit();

  const int r0 = frag_row(), c0 = frag_col();
  const float c = scale * kLog2e;
  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_land();               // tile kt in; everyone is past kt - 1
    if constexpr (kF32) {          // one raw buffer: split before the
      const float* rk = reinterpret_cast<const float*>(gen(raw0));
      const float* rv = rk + kRows * D;         // next tile's copy
      split_rows<kRows, D, NT>(ktile(kt), [=](int r) { return rk + r * D; },
                               kRows);
      split_rows<kRows, D, NT>(vtile(kt), [=](int r) { return rv + r * D; },
                               kRows);
      fence_async_writes();
    }
    if (kt + 1 < nk) {
      issue(kt + 1);
      cp_async_commit();
    }
    const uint32_t ks = ktile(kt), vs = vtile(kt);

    float s[32];
    wg_fence();
    ss_split<64, kRows, kRows, D / 16, NT, NT>(s, qs, kTile, ks, kTile);
    wg_commit();
    wg_wait();
    pin(s);

    const int k0 = kt * kRows;
    const bool edge = k0 + kRows > T || (causal && kt == qt);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const int e = 4 * j + 2 * h + b;
          float x = s[e] * c;
          if (edge) {
            const int col = k0 + 8 * j + c0 + b, row = q0 + r0 + 8 * h;
            if (col >= T || (causal && col > row)) x = kNegInf;
          }
          s[e] = x;
          mx[h] = fmaxf(mx[h], x);
        }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = fmaxf(m[h], quad_max(mx[h]));
      alpha[h] = exp2f(m[h] - m_new);
      m[h] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const int e = 4 * j + 2 * h + b;
          s[e] = exp2f(s[e] - m[h]);
          sum[h] += s[e];
        }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + quad_sum(sum[h]);
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        o[4 * j + 2 * h] *= alpha[h];
        o[4 * j + 2 * h + 1] *= alpha[h];
      }

    uint32_t pf[PT][4][4];                // bf16: hi, lo
    split_frags<64>(s, pf);
    pin(o);
    pin(pf);
    if constexpr (kF32) {          // each tile's share rounded into o
      rs_split_add<DP, kRows, 4, PT, NT>(o, pf, vs, kTile);
    } else {
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        Wgmma<DP>::rs(o, pf[0][kk], desc_mn<kRows>(vs, kk));
        Wgmma<DP>::rs(o, pf[1][kk], desc_mn<kRows>(vs, kk));
      }
      wg_commit();
      wg_wait();
    }
    pin(o);
  }

  float l_safe[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_safe[h] = fmaxf(l[h], 1e-30f);
    const int row = q0 + r0 + 8 * h;
    if (c0 == 0 && row < T)
      lse[(size_t)blockIdx.x * T + row] = (m[h] + log2f(l_safe[h])) * kLn2;
  }
  store_acc<D>(out + off, o, q0, T, l_safe);
}

// one launch's operands and sizes, as pk_flash_attn_fwd takes them
struct Args {
  const void *q, *k, *v;
  void *out, *lse;
  int BH, T, D, causal;
  float scale;
};

template <typename Elt, int D>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr int smem = Plan<Elt, D>::kBytes;
  auto kernel = flash_fwd_tc_kernel<Elt, D>;
  cudaError_t err = pk::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.BH, (a.T + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const Elt*>(a.q), static_cast<const Elt*>(a.k),
      static_cast<const Elt*>(a.v), static_cast<Elt*>(a.out),
      static_cast<float*>(a.lse), a.T, a.scale, a.causal);
  return cudaGetLastError();
}

// every instantiation of one dtype, by head dim
template <typename Elt>
cudaError_t launch_dtype(const Args& a, cudaStream_t s) {
  switch (a.D) {
    case 32: return launch<Elt, 32>(a, s);
    case 64: return launch<Elt, 64>(a, s);
    case 96: return launch<Elt, 96>(a, s);
    case 128: return launch<Elt, 128>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

// the fp32 instantiations compile in a unit of their own
// (flash_attn_fwd_fp32_inst.cu), beside the bf16 ones (flash_attn_fwd.cu)
extern template cudaError_t launch_dtype<float>(const Args&, cudaStream_t);

}  // namespace fwd
}  // namespace pk
