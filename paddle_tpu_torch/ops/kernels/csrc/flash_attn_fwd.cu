// Flash attention forward, bf16 branch: causal or full attention with an
// online softmax, returning the output and the logsumexp of every query
// row, its products on the Hopper tensor cores (wgmma).
//
// Replaces paddle_tpu/ops/pallas/attention.py::_flash_fwd (the Pallas
// kernel _fwd_kernel, reached from flash_attention and flash_block_fwd).
// q, k, v, out are [BH, T, D] row-major bf16; lse is [BH, T] fp32. As
// there: scores are q . k scaled, masked scores hold -1e30 (keys past T;
// keys after the query when causal), out = acc / max(l, 1e-30) and
// lse = m + log(max(l, 1e-30)). fp32 inputs go to the CUDA-core kernel
// of flash_attn_fwd_f32.cu from the same C entry.
//
// What bounds it on the H100: at the training slice (BH = 96, T = 1024,
// D = 64, bf16, causal) it moves ~51 MB against ~1.3e10 FLOPs of the
// algorithm: ~15 us of bytes, ~13 us at the 989 TFLOP/s bf16 peak. The
// split below makes p . v two products, ~1.9e10 FLOPs on the tensor
// cores (~20 us), and the softmax between the products (exp2, masks,
// the split's conversions) runs on the CUDA cores beside them.
//
// The design:
//   - one CTA = one warpgroup per (64-row query tile, bh), the heaviest
//     causal tiles launched first (blockIdx.y = 0 is the last tile); the
//     TPU kernel's sequential loop over key blocks is a loop over
//     64-key tiles inside the CTA, stopping at the diagonal when causal;
//     only the diagonal tile and the tile holding T are masked;
//   - tiles (flash_tc.cuh layout, 128-byte swizzle): q (kept for the
//     whole loop), k and v in a two-stage ring, bf16, loaded by 16-byte
//     cp.async; tile kt + 1 is copied while the tensor cores work on kt;
//   - S = q . k^T: m64n64k16 wgmma, both operands from shared memory
//     (K-major), D / 16 k-steps, fp32 accumulators in registers;
//   - the online softmax runs on the accumulator fragments in the exp2
//     domain (scores times scale * log2 e), row max and sum over the
//     four threads of a row; l sums the unrounded fp32 p;
//   - O += P . V: p stays in registers as the A operand (FA3's
//     structure), v is the B operand MN-major (transposed flag), N = D
//     padded to 64 or 128. The reference multiplies fp32 p by v in fp32;
//     one bf16 rounding of p puts out 5–17 bf16 ulps off at T = 512
//     (tests/test_torch_attention.py::TestTensorCoreArithmetic), over the
//     2-ulp gate. So p is split into hi = bf16(p) and lo = bf16(p - hi),
//     both go through the tensor cores into the same fp32 accumulator
//     (3 products instead of 2), and out lands within 1 ulp.
// Every product is a wgmma; none uses mma.sync or the CUDA cores.
// Registers per thread: 32 of scores, 32 of packed p halves, D/2 or 64
// of output accumulator.
#include "flash_tc.cuh"

extern "C" int pk_flash_attn_fwd_f32(const void* q, const void* k,
                                     const void* v, void* out, void* lse,
                                     int BH, int T, int D, float scale,
                                     int causal, cudaStream_t s);

namespace {

using namespace pk::tc;

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ out,
                    float* __restrict__ lse, int T, float scale, int causal) {
  constexpr int DP = padded(D);
  constexpr int kTile = tile_bytes(kRows, D);
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t qs = smem_base(smem);
  const uint32_t ks0 = qs + kTile;           // k ring: ks0, ks0 + kTile
  const uint32_t vs0 = qs + 3 * kTile;       // v ring: vs0, vs0 + kTile

  const int nq = (T + kRows - 1) / kRows;
  const int qt = nq - 1 - blockIdx.y;
  const int q0 = qt * kRows;
  const size_t off = (size_t)blockIdx.x * T * D;
  const bf16* kg = k + off;
  const bf16* vg = v + off;
  const int nk = causal ? qt + 1 : nq;

  load_tile<kRows, D>(qs, q + off, q0, T);
  load_tile<kRows, D>(ks0, kg, 0, T);
  load_tile<kRows, D>(vs0, vg, 0, T);
  cp_async_commit();

  const int r0 = frag_row(), c0 = frag_col();
  const float c = scale * kLog2e;
  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_land();               // tile kt in; everyone is past kt - 1
    if (kt + 1 < nk) {
      const uint32_t nxt = ((kt + 1) & 1) * kTile;
      load_tile<kRows, D>(ks0 + nxt, kg, (kt + 1) * kRows, T);
      load_tile<kRows, D>(vs0 + nxt, vg, (kt + 1) * kRows, T);
      cp_async_commit();
    }
    const uint32_t ks = ks0 + (kt & 1) * kTile, vs = vs0 + (kt & 1) * kTile;

    float s[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Wgmma<64>::ss(s, desc_k<kRows>(qs, kk), desc_k<kRows>(ks, kk), kk);
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

    uint32_t pf[2][4][4];                 // hi, lo
    split_frags<64>(s, pf);
    pin(o);
    pin(pf);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      Wgmma<DP>::rs(o, pf[0][kk], desc_mn<kRows>(vs, kk));
      Wgmma<DP>::rs(o, pf[1][kk], desc_mn<kRows>(vs, kk));
    }
    wg_commit();
    wg_wait();
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

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* lse, int BH, int T, float scale, int causal,
                   cudaStream_t stream) {
  const int smem = 5 * tile_bytes(kRows, D) + 1024;
  auto kernel = flash_fwd_tc_kernel<D>;
  cudaError_t err = pk::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(BH, (T + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out),
      static_cast<float*>(lse), T, scale, causal);
  return cudaGetLastError();
}

}  // namespace

extern "C" int pk_flash_attn_fwd(const void* q, const void* k, const void* v,
                                 void* out, void* lse, int BH, int T, int D,
                                 float scale, int causal, int dtype,
                                 void* stream) {
  if (BH == 0 || T == 0) return cudaSuccess;
  if (BH > 65535) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == pk::kF32)
    return pk_flash_attn_fwd_f32(q, k, v, out, lse, BH, T, D, scale, causal,
                                 s);
  if (dtype != pk::kBF16) return cudaErrorInvalidValue;
  switch (D) {
    case 32: return launch<32>(q, k, v, out, lse, BH, T, scale, causal, s);
    case 64: return launch<64>(q, k, v, out, lse, BH, T, scale, causal, s);
    case 96: return launch<96>(q, k, v, out, lse, BH, T, scale, causal, s);
    case 128: return launch<128>(q, k, v, out, lse, BH, T, scale, causal, s);
    default: return cudaErrorInvalidValue;
  }
}
