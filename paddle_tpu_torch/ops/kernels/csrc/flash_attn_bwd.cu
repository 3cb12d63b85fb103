// Flash attention backward, bf16 branch: dq, dk, dv from the saved
// (q, k, v, lse), the output gradient do, and delta = sum_d do * out
// (computed by the wrapper, as the JAX package computes it outside its
// kernel), every product on the Hopper tensor cores (wgmma).
//
// Replaces paddle_tpu/ops/pallas/attention.py::_flash_bwd_pallas (the
// Pallas kernel _bwd_kernel, reached from flash_attention's VJP and
// flash_block_bwd). q, k, v, do, dq, dk, dv are [BH, T, D] bf16; lse and
// delta are [BH, T] fp32. As there: s = (q . k) * scale, p = exp(s - lse)
// zeroed where invalid (keys or queries past T; keys after the query
// when causal), dv += p^T do, ds = p * (do . v - delta) * scale,
// dq += ds k, dk += ds^T q, accumulated in fp32 and written once in
// bf16. lse may be the logsumexp over more keys than k holds (a block
// of a composed attention). fp32 inputs go to the CUDA-core kernels of
// flash_attn_bwd_f32.cu from the same C entry.
//
// What bounds it on the H100: operations. At the training slice
// (BH = 96, T = 1024, D = 64, bf16, causal) it moves ~101 MB against
// ~3.2e10 FLOPs of the algorithm (five products): ~30 us of bytes, ~33
// us at the 989 TFLOP/s bf16 peak. The design below does ten products,
// ~6.4e10 FLOPs (~65 us at the peak), plus the elementwise p and ds.
//
// The design. The TPU grid is sequential, so _bwd_kernel adds each key
// block's share into a revisited dq block; CTAs run in no order, so the
// backward is two kernels with no atomics, each output summed by one
// thread in a fixed order (a step is bitwise repeatable):
//   - dkdv: one CTA = one warpgroup per (64-key tile, bh), heaviest
//     causal tiles first (blockIdx.y = 0 sees every query tile). k and v
//     tiles stay in shared memory; BQ-row tiles of q and do, with their
//     lse and delta, stream through a two-stage cp.async ring. Per query
//     tile: S^T = k . q^T and dP^T = v . do^T (wgmma from shared memory,
//     K-major), p^T and ds^T on the fragments, then dv += p^T . do and
//     dk += ds^T . q with p^T and ds^T as register A operands and do, q
//     as MN-major B operands (transposed flag).
//   - dq: one CTA per (64-query tile, bh), heaviest causal tiles first.
//     q and do stay; k and v tiles stream through the ring. Per key
//     tile: S = q . k^T, dP = do . v^T, p and ds, dq += ds . k (ds in
//     registers, k MN-major).
// Causal loops skip the tiles on the wrong side of the diagonal and
// mask only those that straddle it or hold T. The price of no atomics
// is that both kernels compute the scores and do . v: seven products of
// the algorithm instead of five.
//
// Precision: the reference takes every backward product in fp32. One
// bf16 rounding of p and ds before their products puts the gradients
// 5–27 bf16 ulps off at T = 512 (tests/test_torch_attention.py::
// TestTensorCoreArithmetic), over the 2-ulp gate; so p and ds are split
// into hi = bf16(x) and lo = bf16(x - hi), both halves go through the
// tensor cores into one fp32 accumulator (dv, dk and dq each two
// products: ten in all), and the gradients land within 1 ulp.
//
// Tiles: 64 keys x BQ queries in dkdv, BQ = 64 at D <= 64 and 32 at
// D = 96, 128, so that the dk and dv accumulators (2 x D/2 or 64 fp32),
// the S^T and dP^T fragments and the packed p and ds halves fit the 255
// registers of a thread without spilling. Every product is a wgmma;
// none uses mma.sync or the CUDA cores.
#include "flash_tc.cuh"

extern "C" int pk_flash_attn_bwd_f32(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* delta,
                                     void* dq, void* dk, void* dv, int BH,
                                     int T, int D, float scale, int causal,
                                     cudaStream_t s);

namespace {

using namespace pk::tc;

// query rows per dkdv tile at head dim D
__host__ __device__ constexpr int dkdv_rows(int d) {
  return padded(d) > 64 ? 32 : 64;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_tc_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int T,
                         float scale, int causal) {
  constexpr int DP = padded(D);
  constexpr int BQ = dkdv_rows(D);
  constexpr int kKTile = tile_bytes(kRows, D), kQTile = tile_bytes(BQ, D);
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t base = smem_base(smem);
  const uint32_t ks = base, vs = base + kKTile;
  const uint32_t qs0 = base + 2 * kKTile;     // q ring
  const uint32_t dos0 = qs0 + 2 * kQTile;     // do ring
  const uint32_t st0 = dos0 + 2 * kQTile;     // [lse | delta] ring, fp32
  const float* stats = reinterpret_cast<const float*>(
      smem + (st0 - smem_u32(smem)));

  const int k0 = blockIdx.y * kRows;
  const size_t off = (size_t)blockIdx.x * T * D;
  const bf16* qg = q + off;
  const bf16* dog = dout + off;
  const float* lseg = lse + (size_t)blockIdx.x * T;
  const float* deltag = delta + (size_t)blockIdx.x * T;
  const int nqt = (T + BQ - 1) / BQ;
  const int qi0 = causal ? k0 / BQ : 0;

  // q, do, lse and delta of query tile qi into ring stage ``st``
  auto load_q = [&](int qi, int st) {
    const int q0 = qi * BQ;
    load_tile<BQ, D>(qs0 + st * kQTile, qg, q0, T);
    load_tile<BQ, D>(dos0 + st * kQTile, dog, q0, T);
    const int t = threadIdx.x;
    if (t < 2 * BQ) {
      const int row = q0 + (t % BQ);
      const float* src = t < BQ ? lseg : deltag;
      cp_async_4(st0 + (st * 2 * BQ + t) * 4, row < T ? src + row : src,
                 row < T);
    }
  };

  load_tile<kRows, D>(ks, k + off, k0, T);
  load_tile<kRows, D>(vs, v + off, k0, T);
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
    if (qi + 1 < nqt) {
      load_q(qi + 1, st ^ 1);
      cp_async_commit();
    }
    const uint32_t qs = qs0 + st * kQTile, dos = dos0 + st * kQTile;

    float sT[BQ / 2], dpT[BQ / 2];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Wgmma<BQ>::ss(sT, desc_k<kRows>(ks, kk), desc_k<BQ>(qs, kk), kk);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Wgmma<BQ>::ss(dpT, desc_k<kRows>(vs, kk), desc_k<BQ>(dos, kk), kk);
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

    uint32_t ph[BQ / 16][4], pl[BQ / 16][4], dsh[BQ / 16][4],
        dsl[BQ / 16][4];
    split_frags<BQ>(sT, ph, pl);
    split_frags<BQ>(dpT, dsh, dsl);
    pin(dk_acc);
    pin(dv_acc);
    pin(ph);
    pin(pl);
    pin(dsh);
    pin(dsl);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      Wgmma<DP>::rs(dv_acc, ph[kk], desc_mn<BQ>(dos, kk));
      Wgmma<DP>::rs(dv_acc, pl[kk], desc_mn<BQ>(dos, kk));
      Wgmma<DP>::rs(dk_acc, dsh[kk], desc_mn<BQ>(qs, kk));
      Wgmma<DP>::rs(dk_acc, dsl[kk], desc_mn<BQ>(qs, kk));
    }
    wg_commit();
    wg_wait();
    pin(dk_acc);
    pin(dv_acc);
  }

  const float one[2] = {1.f, 1.f};
  store_acc<D>(dk + off, dk_acc, k0, T, one);
  store_acc<D>(dv + off, dv_acc, k0, T, one);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       const bf16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       bf16* __restrict__ dq, int T, float scale,
                       int causal) {
  constexpr int DP = padded(D);
  constexpr int kTile = tile_bytes(kRows, D);
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t qs = smem_base(smem);
  const uint32_t dos = qs + kTile;
  const uint32_t ks0 = qs + 2 * kTile;       // k ring
  const uint32_t vs0 = qs + 4 * kTile;       // v ring

  const int nq = (T + kRows - 1) / kRows;
  const int qt = nq - 1 - blockIdx.y;
  const int q0 = qt * kRows;
  const size_t off = (size_t)blockIdx.x * T * D;
  const bf16* kg = k + off;
  const bf16* vg = v + off;
  const int nk = causal ? qt + 1 : nq;

  load_tile<kRows, D>(qs, q + off, q0, T);
  load_tile<kRows, D>(dos, dout + off, q0, T);
  load_tile<kRows, D>(ks0, kg, 0, T);
  load_tile<kRows, D>(vs0, vg, 0, T);
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
    if (kt + 1 < nk) {
      const uint32_t nxt = ((kt + 1) & 1) * kTile;
      load_tile<kRows, D>(ks0 + nxt, kg, (kt + 1) * kRows, T);
      load_tile<kRows, D>(vs0 + nxt, vg, (kt + 1) * kRows, T);
      cp_async_commit();
    }
    const uint32_t ks = ks0 + (kt & 1) * kTile, vs = vs0 + (kt & 1) * kTile;

    float s[32], dp[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Wgmma<64>::ss(s, desc_k<kRows>(qs, kk), desc_k<kRows>(ks, kk), kk);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Wgmma<64>::ss(dp, desc_k<kRows>(dos, kk), desc_k<kRows>(vs, kk), kk);
    wg_commit();
    wg_wait();
    pin(s);
    pin(dp);

    const int k0 = kt * kRows;
    const bool edge =
        k0 + kRows > T || q0 + kRows > T || (causal && kt == qt);
#pragma unroll
    for (int j = 0; j < 8; ++j)
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

    uint32_t dsh[4][4], dsl[4][4];
    split_frags<64>(s, dsh, dsl);
    pin(acc);
    pin(dsh);
    pin(dsl);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      Wgmma<DP>::rs(acc, dsh[kk], desc_mn<kRows>(ks, kk));
      Wgmma<DP>::rs(acc, dsl[kk], desc_mn<kRows>(ks, kk));
    }
    wg_commit();
    wg_wait();
    pin(acc);
  }

  const float one[2] = {1.f, 1.f};
  store_acc<D>(dq + off, acc, q0, T, one);
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, void* dk, void* dv, int BH, int T, float scale,
                   int causal, cudaStream_t stream) {
  constexpr int BQ = dkdv_rows(D);
  const int smem_kv = 2 * tile_bytes(kRows, D) + 4 * tile_bytes(BQ, D) +
                      2 * 2 * BQ * 4 + 1024;
  const int smem_q = 6 * tile_bytes(kRows, D) + 1024;
  auto kv_kernel = flash_bwd_dkdv_tc_kernel<D>;
  auto q_kernel = flash_bwd_dq_tc_kernel<D>;
  cudaError_t err = pk::allow_smem(kv_kernel, smem_kv);
  if (err != cudaSuccess) return err;
  err = pk::allow_smem(q_kernel, smem_q);
  if (err != cudaSuccess) return err;
  dim3 grid(BH, (T + kRows - 1) / kRows);
  const bf16* q_ = static_cast<const bf16*>(q);
  const bf16* k_ = static_cast<const bf16*>(k);
  const bf16* v_ = static_cast<const bf16*>(v);
  const bf16* do_ = static_cast<const bf16*>(dout);
  const float* lse_ = static_cast<const float*>(lse);
  const float* delta_ = static_cast<const float*>(delta);
  kv_kernel<<<grid, kThreads, smem_kv, stream>>>(
      q_, k_, v_, do_, lse_, delta_, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), T, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  q_kernel<<<grid, kThreads, smem_q, stream>>>(
      q_, k_, v_, do_, lse_, delta_, static_cast<bf16*>(dq), T, scale,
      causal);
  return cudaGetLastError();
}

}  // namespace

extern "C" int pk_flash_attn_bwd(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq, void* dk,
                                 void* dv, int BH, int T, int D, float scale,
                                 int causal, int dtype, void* stream) {
  if (BH == 0 || T == 0) return cudaSuccess;
  if (BH > 65535) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == pk::kF32)
    return pk_flash_attn_bwd_f32(q, k, v, dout, lse, delta, dq, dk, dv, BH,
                                 T, D, scale, causal, s);
  if (dtype != pk::kBF16) return cudaErrorInvalidValue;
  switch (D) {
    case 32: return launch<32>(q, k, v, dout, lse, delta, dq, dk, dv, BH, T,
                               scale, causal, s);
    case 64: return launch<64>(q, k, v, dout, lse, delta, dq, dk, dv, BH, T,
                               scale, causal, s);
    case 96: return launch<96>(q, k, v, dout, lse, delta, dq, dk, dv, BH, T,
                               scale, causal, s);
    case 128: return launch<128>(q, k, v, dout, lse, delta, dq, dk, dv, BH,
                                 T, scale, causal, s);
    default: return cudaErrorInvalidValue;
  }
}
