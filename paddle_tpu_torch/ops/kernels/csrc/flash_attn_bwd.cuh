// Flash attention backward: dq, dk, dv from the saved (q, k, v, lse),
// the output gradient do, and delta = sum_d do * out (computed by the
// wrapper, as the JAX package computes it outside its kernel), every
// product on the Hopper tensor cores (wgmma), for bf16 and for fp32
// inputs (two instantiations of the same kernels).
//
// Replaces paddle_tpu/ops/pallas/attention.py::_flash_bwd_pallas (the
// Pallas kernel _bwd_kernel, reached from flash_attention's VJP and
// flash_block_bwd). q, k, v, do, dq, dk, dv are [BH, T, D] in one dtype
// (bf16 or fp32); lse and delta are [BH, T] fp32. As there: s = (q . k)
// * scale, p = exp(s - lse) zeroed where invalid (keys or queries past
// T; keys after the query when causal), dv += p^T do, ds = p * (do . v -
// delta) * scale, dq += ds k, dk += ds^T q, accumulated in fp32 and
// written once in the inputs' dtype. lse may be the logsumexp over more
// keys than k holds (a block of a composed attention); a block fed lse =
// +1e30 (the flash ring's masked block) has p = 0 exactly, so its
// gradients are exactly 0.
//
// What bounds it on the H100: operations. At the training slice
// (BH = 96, T = 1024, D = 64, causal) the algorithm's five products are
// ~3.2e10 FLOPs: ~33 us at the 989 TFLOP/s bf16 peak, against ~30 us of
// bytes in bf16 (~101 MB) and ~60 us in fp32 (~201 MB). fp32 takes each
// product as six bf16 passes (below), so its bound is the same FLOPs at
// 989 / 6 ~ 165 TFLOP/s, ~195 us; the design below does seven products,
// ~270 us at that rate.
//
// The design. The TPU grid is sequential, so _bwd_kernel adds each key
// block's share into a revisited dq block; CTAs run in no order, so the
// backward is two kernels with no atomics, each output summed by one
// thread in a fixed order (a step is bitwise repeatable):
//   - dkdv: one CTA = one warpgroup per (64-key tile, bh), heaviest
//     causal tiles first (blockIdx.y = 0 sees every query tile). k and v
//     tiles stay in shared memory; BQ-row tiles of q and do, with their
//     lse and delta, stream through cp.async. Per query tile: S^T = k .
//     q^T and dP^T = v . do^T (wgmma from shared memory, K-major), p^T
//     and ds^T on the fragments, then dv += p^T . do and dk += ds^T . q
//     with p^T and ds^T as register A operands and do, q as MN-major B
//     operands (transposed flag).
//   - dq: one CTA per (64-query tile, bh), heaviest causal tiles first.
//     q and do stay; BK-row tiles of k and v stream. Per key tile: S =
//     q . k^T, dP = do . v^T, p and ds, dq += ds . k (ds in registers, k
//     MN-major).
// Causal loops skip the tiles on the wrong side of the diagonal and
// mask only those that straddle it or hold T. The price of no atomics
// is that both kernels compute the scores and do . v: seven products of
// the algorithm instead of five.
//
// Precision (flash_tc.cuh, split operands): the reference takes every
// backward product in fp32.
//   - bf16: q, k, v and do are one bf16 term each. One bf16 rounding of
//     p and ds before their products puts the gradients 5–27 bf16 ulps
//     off at T = 512 (tests/test_torch_attention.py::
//     TestTensorCoreArithmetic), over the 2-ulp gate; so p and ds are
//     split into hi and lo, both halves go through the tensor cores into
//     one fp32 accumulator, and the gradients land within 1 ulp.
//   - fp32: every operand, p and ds included, is three bf16 terms, and
//     each product the six cross terms of order 2^-16 and up (smallest
//     first): fp32-accurate products at the tensor cores' rate over six,
//     where one TF32 or bf16 rounding misses the plain version's 1e-4 by
//     an order of magnitude. The tiles a CTA keeps are split once from
//     global memory; the streamed ones land as fp32 rows in a raw buffer
//     and are split into their three term tiles right after, before the
//     next tile's copy goes into the same buffer. The tensor cores' fp32
//     accumulation does not round to nearest: dk, dv and dq summed in
//     the wgmma accumulators across every tile drifted 6x further from a
//     float64 reference than the plain version (dv 4.9e-5 against 7.8e-6
//     at the slice, 7.9e-5 at T = 2048, on an H100), so each tile's share
//     goes into a fresh accumulator, 64 columns at a time, and is added
//     to the running sums on the CUDA cores (rs_split_add).
//
// Tiles: 64 keys x BQ queries in dkdv: bf16 BQ = 64 at D <= 64 and 32 at
// D = 96, 128; fp32 BQ = 32 at D <= 64 and 16 at D = 96, 128 (three
// terms of p^T and ds^T and the fresh accumulator in registers beside
// the dk and dv sums). dq: 64 queries x BK keys, BK = 64 but for fp32 at
// D = 96, 128, where BK = 32 keeps the q, do, k, v term tiles and the raw
// buffer within 227 KB. Every product is a wgmma; none uses mma.sync or
// the CUDA cores.
//
// The kernels and their launch templates live here; flash_attn_bwd.cu
// holds the C entry and the bf16 instantiations,
// flash_attn_bwd_fp32_inst.cu the fp32 ones, so that the two halves
// compile in parallel.
#pragma once

#include "flash_tc.cuh"

namespace pk {
namespace bwd {

using namespace pk::tc;

template <typename Elt>
constexpr bool kIsF32 = std::is_same<Elt, float>::value;

// bf16 terms of q, k, v, do; of p and ds
template <typename Elt>
constexpr int kTerms = kIsF32<Elt> ? 3 : 1;
template <typename Elt>
constexpr int kPTerms = kIsF32<Elt> ? 3 : 2;

// query rows per dkdv tile at head dim D
template <typename Elt>
__host__ __device__ constexpr int dkdv_rows(int d) {
  if (kIsF32<Elt>) return padded(d) > 64 ? 16 : 32;
  return padded(d) > 64 ? 32 : 64;
}

// key rows per dq tile at head dim D
template <typename Elt>
__host__ __device__ constexpr int dq_cols(int d) {
  return kIsF32<Elt> && padded(d) > 64 ? 32 : 64;
}

// Shared memory of the two kernels. bf16: the kept tiles, two-stage
// rings of the streamed ones. fp32: three term tiles per operand, the
// streamed ones in one stage beside a raw buffer of their fp32 rows.
template <typename Elt, int D>
struct Plan {
  static constexpr int NT = kTerms<Elt>;
  static constexpr int kStages = kIsF32<Elt> ? 1 : 2;
  static constexpr int BQ = dkdv_rows<Elt>(D), BK = dq_cols<Elt>(D);
  // dkdv: k, v kept; q, do streamed; [lse | delta] in two stages
  static constexpr int kKeep = NT * tile_bytes(kRows, D);   // one operand
  static constexpr int kQStream = NT * tile_bytes(BQ, D);
  static constexpr int kQRaw = kIsF32<Elt> ? BQ * D * 4 : 0;
  static constexpr int kv_bytes = 2 * kKeep + 2 * kStages * kQStream +
                                  2 * kQRaw + 2 * 2 * BQ * 4 + 1024;
  // dq: q, do kept; k, v streamed
  static constexpr int kKStream = NT * tile_bytes(BK, D);
  static constexpr int kKRaw = kIsF32<Elt> ? BK * D * 4 : 0;
  static constexpr int q_bytes =
      2 * kKeep + 2 * kStages * kKStream + 2 * kKRaw + 1024;
};

template <typename Elt, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_tc_kernel(const Elt* __restrict__ q,
                         const Elt* __restrict__ k,
                         const Elt* __restrict__ v,
                         const Elt* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         Elt* __restrict__ dk, Elt* __restrict__ dv, int T,
                         float scale, int causal) {
  using P = Plan<Elt, D>;
  constexpr bool kF32 = kIsF32<Elt>;
  constexpr int NT = P::NT, PT = kPTerms<Elt>;
  constexpr int DP = padded(D);
  constexpr int BQ = P::BQ;
  constexpr int kKTile = tile_bytes(kRows, D), kQTile = tile_bytes(BQ, D);
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t base = smem_base(smem);
  const uint32_t ks = base, vs = base + P::kKeep;
  const uint32_t qs0 = base + 2 * P::kKeep;                // q stages
  const uint32_t dos0 = qs0 + P::kStages * P::kQStream;   // do stages
  const uint32_t raw0 = dos0 + P::kStages * P::kQStream;  // fp32 q, do rows
  const uint32_t st0 = raw0 + 2 * P::kQRaw;   // [lse | delta] ring, fp32
  auto gen = [&](uint32_t a) { return smem + (a - smem_u32(smem)); };
  const float* stats = reinterpret_cast<const float*>(gen(st0));

  const int k0 = blockIdx.y * kRows;
  const size_t off = (size_t)blockIdx.x * T * D;
  const Elt* qg = q + off;
  const Elt* dog = dout + off;
  const float* lseg = lse + (size_t)blockIdx.x * T;
  const float* deltag = delta + (size_t)blockIdx.x * T;
  const int nqt = (T + BQ - 1) / BQ;
  const int qi0 = causal ? k0 / BQ : 0;

  // q, do (bf16: into their tiles of ring stage ``st``; fp32: into the
  // raw buffer), lse and delta (into ring stage ``st``) of query tile qi
  auto load_q = [&](int qi, int st) {
    const int q0 = qi * BQ;
    if constexpr (kF32) {
      load_raw<BQ, 4 * D>(raw0,
                          [=](int r) { return qg + (size_t)(q0 + r) * D; },
                          T - q0, qg);
      load_raw<BQ, 4 * D>(raw0 + P::kQRaw,
                          [=](int r) { return dog + (size_t)(q0 + r) * D; },
                          T - q0, dog);
    } else {
      load_tile<BQ, D>(qs0 + st * kQTile, qg, q0, T);
      load_tile<BQ, D>(dos0 + st * kQTile, dog, q0, T);
    }
    const int t = threadIdx.x;
    if (t < 2 * BQ) {
      const int row = q0 + (t % BQ);
      const float* src = t < BQ ? lseg : deltag;
      cp_async_4(st0 + (st * 2 * BQ + t) * 4, row < T ? src + row : src,
                 row < T);
    }
  };

  if constexpr (kF32) {      // split once (fenced with the first q tile's)
    auto krow = [=](int r) { return k + off + (size_t)(k0 + r) * D; };
    auto vrow = [=](int r) { return v + off + (size_t)(k0 + r) * D; };
    split_rows<kRows, D, NT>(ks, krow, T - k0);
    split_rows<kRows, D, NT>(vs, vrow, T - k0);
  } else {
    load_tile<kRows, D>(ks, k + off, k0, T);
    load_tile<kRows, D>(vs, v + off, k0, T);
  }
  load_q(qi0, 0);
  cp_async_commit();

  const int r0 = frag_row(), c0 = frag_col();
  const float c = scale * kLog2e;
  float dk_acc[DP / 2], dv_acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  for (int qi = qi0; qi < nqt; ++qi) {
    const int st = (qi - qi0) & 1;
    cp_async_land();
    if constexpr (kF32) {   // one raw buffer: split before the next copy
      const float* rq = reinterpret_cast<const float*>(gen(raw0));
      const float* rdo = rq + BQ * D;
      split_rows<BQ, D, NT>(qs0, [=](int r) { return rq + r * D; }, BQ);
      split_rows<BQ, D, NT>(dos0, [=](int r) { return rdo + r * D; }, BQ);
      fence_async_writes();
    }
    if (qi + 1 < nqt) {
      load_q(qi + 1, st ^ 1);
      cp_async_commit();
    }
    const int ts = kF32 ? 0 : st;              // the tiles' stage
    const uint32_t qs = qs0 + ts * P::kQStream, dos = dos0 + ts * P::kQStream;

    float sT[BQ / 2], dpT[BQ / 2];
    wg_fence();
    ss_split<BQ, kRows, BQ, D / 16, NT, NT>(sT, ks, kKTile, qs, kQTile);
    ss_split<BQ, kRows, BQ, D / 16, NT, NT>(dpT, vs, kKTile, dos, kQTile);
    wg_commit();
    wg_wait();
    pin(sT);
    pin(dpT);

    // rows are keys, columns are queries
    const int q0 = qi * BQ;
    const bool edge =
        q0 + BQ > T || k0 + kRows > T || (causal && q0 < k0 + kRows);
    const float* lse_s = stats + st * 2 * BQ;
    const float* delta_s = lse_s + BQ;
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int cq = 8 * j + c0 + b;
        const float l2 = lse_s[cq] * kLog2e, dl = delta_s[cq];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = 4 * j + 2 * h + b;
          float p = exp2f(sT[e] * c - l2);
          if (edge) {
            const int query = q0 + cq, key = k0 + r0 + 8 * h;
            if (query >= T || key >= T || (causal && query < key)) p = 0.f;
          }
          sT[e] = p;
          dpT[e] = p * (dpT[e] - dl) * scale;
        }
      }

    uint32_t pf[PT][BQ / 16][4], dsf[PT][BQ / 16][4];
    split_frags<BQ>(sT, pf);
    split_frags<BQ>(dpT, dsf);
    pin(dk_acc);
    pin(dv_acc);
    pin(pf);
    pin(dsf);
    if constexpr (kF32) {    // each tile's share rounded into the sums
      rs_split_add<DP, BQ, BQ / 16, PT, NT>(dv_acc, pf, dos, kQTile);
      rs_split_add<DP, BQ, BQ / 16, PT, NT>(dk_acc, dsf, qs, kQTile);
    } else {
      wg_fence();
      rs_split<DP, BQ, BQ / 16, PT, NT>(dv_acc, pf, dos, kQTile);
      rs_split<DP, BQ, BQ / 16, PT, NT>(dk_acc, dsf, qs, kQTile);
      wg_commit();
      wg_wait();
    }
    pin(dk_acc);
    pin(dv_acc);
  }

  const float one[2] = {1.f, 1.f};
  store_acc<D>(dk + off, dk_acc, k0, T, one);
  store_acc<D>(dv + off, dv_acc, k0, T, one);
}

template <typename Elt, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_tc_kernel(const Elt* __restrict__ q, const Elt* __restrict__ k,
                       const Elt* __restrict__ v,
                       const Elt* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       Elt* __restrict__ dq, int T, float scale,
                       int causal) {
  using P = Plan<Elt, D>;
  constexpr bool kF32 = kIsF32<Elt>;
  constexpr int NT = P::NT, PT = kPTerms<Elt>;
  constexpr int DP = padded(D);
  constexpr int BK = P::BK;
  constexpr int kQTile = tile_bytes(kRows, D), kKTile = tile_bytes(BK, D);
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t qs = smem_base(smem);
  const uint32_t dos = qs + P::kKeep;
  const uint32_t ks0 = qs + 2 * P::kKeep;                // k stages
  const uint32_t vs0 = ks0 + P::kStages * P::kKStream;  // v stages
  const uint32_t raw0 = vs0 + P::kStages * P::kKStream;  // fp32 k, v rows
  auto gen = [&](uint32_t a) { return smem + (a - smem_u32(smem)); };

  const int nq = (T + kRows - 1) / kRows;
  const int qt = nq - 1 - blockIdx.y;
  const int q0 = qt * kRows;
  const size_t off = (size_t)blockIdx.x * T * D;
  const Elt* kg = k + off;
  const Elt* vg = v + off;
  const int nk = ((causal ? min(T, q0 + kRows) : T) + BK - 1) / BK;

  // k and v of key tile kt (bf16: into ring stage kt & 1; fp32: into the
  // raw buffer)
  auto load_k = [&](int kt) {
    const int k0 = kt * BK;
    if constexpr (kF32) {
      load_raw<BK, 4 * D>(raw0,
                          [=](int r) { return kg + (size_t)(k0 + r) * D; },
                          T - k0, kg);
      load_raw<BK, 4 * D>(raw0 + P::kKRaw,
                          [=](int r) { return vg + (size_t)(k0 + r) * D; },
                          T - k0, vg);
    } else {
      load_tile<BK, D>(ks0 + (kt & 1) * kKTile, kg, k0, T);
      load_tile<BK, D>(vs0 + (kt & 1) * kKTile, vg, k0, T);
    }
  };

  if constexpr (kF32) {      // split once (fenced with the first k tile's)
    auto qrow = [=](int r) { return q + off + (size_t)(q0 + r) * D; };
    auto dorow = [=](int r) { return dout + off + (size_t)(q0 + r) * D; };
    split_rows<kRows, D, NT>(qs, qrow, T - q0);
    split_rows<kRows, D, NT>(dos, dorow, T - q0);
  } else {
    load_tile<kRows, D>(qs, q + off, q0, T);
    load_tile<kRows, D>(dos, dout + off, q0, T);
  }
  load_k(0);
  cp_async_commit();

  const int r0 = frag_row(), c0 = frag_col();
  const float c = scale * kLog2e;
  float l2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + r0 + 8 * h;
    const size_t i = (size_t)blockIdx.x * T + row;
    l2[h] = row < T ? lse[i] * kLog2e : 0.f;
    dl[h] = row < T ? delta[i] : 0.f;
  }
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_land();
    if constexpr (kF32) {   // one raw buffer: split before the next copy
      const float* rk = reinterpret_cast<const float*>(gen(raw0));
      const float* rv = rk + BK * D;
      split_rows<BK, D, NT>(ks0, [=](int r) { return rk + r * D; }, BK);
      split_rows<BK, D, NT>(vs0, [=](int r) { return rv + r * D; }, BK);
      fence_async_writes();
    }
    if (kt + 1 < nk) {
      load_k(kt + 1);
      cp_async_commit();
    }
    const int ts = kF32 ? 0 : kt & 1;          // the tiles' stage
    const uint32_t ks = ks0 + ts * P::kKStream, vs = vs0 + ts * P::kKStream;

    float s[BK / 2], dp[BK / 2];
    wg_fence();
    ss_split<BK, kRows, BK, D / 16, NT, NT>(s, qs, kQTile, ks, kKTile);
    ss_split<BK, kRows, BK, D / 16, NT, NT>(dp, dos, kQTile, vs, kKTile);
    wg_commit();
    wg_wait();
    pin(s);
    pin(dp);

    const int k0 = kt * BK;
    const bool edge =
        k0 + BK > T || q0 + kRows > T || (causal && k0 + BK - 1 > q0);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const int e = 4 * j + 2 * h + b;
          float p = exp2f(s[e] * c - l2[h]);
          if (edge) {
            const int col = k0 + 8 * j + c0 + b, row = q0 + r0 + 8 * h;
            if (col >= T || row >= T || (causal && col > row)) p = 0.f;
          }
          s[e] = p * (dp[e] - dl[h]) * scale;     // ds
        }

    uint32_t dsf[PT][BK / 16][4];
    split_frags<BK>(s, dsf);
    pin(acc);
    pin(dsf);
    if constexpr (kF32) {    // each tile's share rounded into the sum
      rs_split_add<DP, BK, BK / 16, PT, NT>(acc, dsf, ks, kKTile);
    } else {
      wg_fence();
      rs_split<DP, BK, BK / 16, PT, NT>(acc, dsf, ks, kKTile);
      wg_commit();
      wg_wait();
    }
    pin(acc);
  }

  const float one[2] = {1.f, 1.f};
  store_acc<D>(dq + off, acc, q0, T, one);
}

// one launch's operands and sizes, as pk_flash_attn_bwd takes them
struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *dq, *dk, *dv;
  int BH, T, D, causal;
  float scale;
};

template <typename Elt, int D>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using P = Plan<Elt, D>;
  auto kv_kernel = flash_bwd_dkdv_tc_kernel<Elt, D>;
  auto q_kernel = flash_bwd_dq_tc_kernel<Elt, D>;
  cudaError_t err = pk::allow_smem(kv_kernel, P::kv_bytes);
  if (err != cudaSuccess) return err;
  err = pk::allow_smem(q_kernel, P::q_bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(a.BH, (a.T + kRows - 1) / kRows);
  const Elt* q = static_cast<const Elt*>(a.q);
  const Elt* k = static_cast<const Elt*>(a.k);
  const Elt* v = static_cast<const Elt*>(a.v);
  const Elt* dout = static_cast<const Elt*>(a.dout);
  const float* lse = static_cast<const float*>(a.lse);
  const float* delta = static_cast<const float*>(a.delta);
  kv_kernel<<<grid, kThreads, P::kv_bytes, stream>>>(
      q, k, v, dout, lse, delta, static_cast<Elt*>(a.dk),
      static_cast<Elt*>(a.dv), a.T, a.scale, a.causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  q_kernel<<<grid, kThreads, P::q_bytes, stream>>>(
      q, k, v, dout, lse, delta, static_cast<Elt*>(a.dq), a.T, a.scale,
      a.causal);
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
// (flash_attn_bwd_fp32_inst.cu), beside the bf16 ones (flash_attn_bwd.cu)
extern template cudaError_t launch_dtype<float>(const Args&, cudaStream_t);

}  // namespace bwd
}  // namespace pk
