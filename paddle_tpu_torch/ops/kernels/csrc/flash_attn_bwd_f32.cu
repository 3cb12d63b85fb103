// Flash attention backward, fp32 branch: dq, dk, dv from the saved
// (q, k, v, lse), the output gradient do, and delta = sum_d do * out
// (computed by the wrapper, as the JAX package computes it outside its
// kernel), all on the CUDA cores in fp32. The bf16 branch, on the
// tensor cores, is flash_attn_bwd.cu; its C entry pk_flash_attn_bwd
// dispatches fp32 inputs here.
//
// Replaces paddle_tpu/ops/pallas/attention.py::_flash_bwd_pallas (the
// Pallas kernel _bwd_kernel, reached from flash_attention's VJP and
// flash_block_bwd) for fp32 inputs. All of q, k, v, do, dq, dk, dv are
// [BH, T, D] fp32; lse and delta are [BH, T] fp32. As there:
// s = (q . k) * scale, p = exp(s - lse) zeroed where invalid (keys or
// queries past T; keys after the query when causal), dv += p^T do,
// ds = p * (do . v - delta) * scale, dq += ds k, dk += ds^T q, all
// accumulated in fp32 and written once in the tensors' dtype.
//
// What bounds it on the H100: operations. At BH = 96, T = 1024, D = 64,
// causal, fp32 it moves ~201 MB against ~3.2e10 FLOPs (five products):
// ~60 us of bytes, ~480 us at the ~67 TFLOP/s fp32 CUDA-core peak.
//
// What the design does about it, and about the TPU kernel's dq: the
// TPU grid is sequential, so _bwd_kernel adds each key block's share
// into a revisited dq block. CUDA CTAs run concurrently and in no
// order, so the backward is two kernels with no atomics:
//   - dkdv: one CTA per (64-key tile, bh) holds its K and V tiles and
//     loops over the query tiles that can see them, accumulating its
//     dk and dv rows in registers;
//   - dq: one CTA per (64-query tile, bh) holds its q, do, lse and
//     delta and loops over the key tiles its rows can see, rebuilding
//     p and ds, accumulating its dq rows in registers.
// Each output element is summed by one thread in a fixed order, so a
// step is bitwise repeatable run to run. The price is that both
// kernels compute the scores and do . v: seven products instead of
// five. Score tiles are 4 x 4 per thread as in the forward; causal
// loops skip the tiles on the wrong side of the diagonal.
#include "flash_tile.cuh"

namespace {

using namespace pk::flash;

// p and ds of one (query tile, key tile) pair from the staged q, k, do,
// v tiles: thread (ty, tx) gets rows ty + 16 i, columns tx + 16 j.
template <int D>
__device__ __forceinline__ void p_ds_tile(
    const float* qs, const float* ks, const float* dos, const float* vs,
    const float* lse_s, const float* delta_s, int q0, int k0, int T,
    float scale, int causal, int ty, int tx, float p[4][4],
    float ds[4][4]) {
  float dp[4][4];
  dot_tile<D>(qs, ks, ty, tx, p);
  dot_tile<D>(dos, vs, ty, tx, dp);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int qp = q0 + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kp = k0 + tx + 16 * j;
      const bool ok = kp < T && qp < T && (!causal || qp >= kp);
      const float pv = ok ? expf(p[i][j] * scale - lse_s[r]) : 0.f;
      p[i][j] = pv;
      ds[i][j] = pv * (dp[i][j] - delta_s[r]) * scale;
    }
  }
}

// lse and delta of rows [row0, row0 + kBlock); 0 past T.
__device__ __forceinline__ void load_stats(float* lse_s, float* delta_s,
                                           const float* lse,
                                           const float* delta, int row0,
                                           int T) {
  for (int r = threadIdx.x; r < kBlock; r += kThreads) {
    const bool in = row0 + r < T;
    lse_s[r] = in ? lse[row0 + r] : 0.f;
    delta_s[r] = in ? delta[row0 + r] : 0.f;
  }
}

template <typename Elt, int ND2>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const Elt* __restrict__ q, const Elt* __restrict__ k,
                      const Elt* __restrict__ v, const Elt* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, Elt* __restrict__ dk,
                      Elt* __restrict__ dv, int T, float scale, int causal) {
  constexpr int D = 32 * ND2;
  constexpr int LD = D + 4;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                       // [kBlock][LD]
  float* vs = ks + kBlock * LD;
  float* qs = vs + kBlock * LD;
  float* dos = qs + kBlock * LD;
  float* ps = dos + kBlock * LD;          // [kBlock][kPLd]
  float* dss = ps + kBlock * kPLd;        // [kBlock][kPLd]
  float* lse_s = dss + kBlock * kPLd;     // [kBlock]
  float* delta_s = lse_s + kBlock;        // [kBlock]
  const int k0 = blockIdx.x * kBlock;
  const size_t base = (size_t)blockIdx.y * T * D;
  const float* lse_h = lse + (size_t)blockIdx.y * T;
  const float* delta_h = delta + (size_t)blockIdx.y * T;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;

  load_rows<D>(ks, k + base, k0, T, 1.f);
  load_rows<D>(vs, v + base, k0, T, 1.f);

  // key rows ty + 16 i, columns 32 jj + 2 tx + e
  float acc_dk[4][ND2][2], acc_dv[4][ND2][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < ND2; ++jj)
      acc_dk[i][jj][0] = acc_dk[i][jj][1] = acc_dv[i][jj][0] =
          acc_dv[i][jj][1] = 0.f;

  const int nq = (T + kBlock - 1) / kBlock;
  for (int qt = causal ? blockIdx.x : 0; qt < nq; ++qt) {
    const int q0 = qt * kBlock;
    __syncthreads();                      // qs, dos, ps, dss free
    load_rows<D>(qs, q + base, q0, T, 1.f);
    load_rows<D>(dos, dout + base, q0, T, 1.f);
    load_stats(lse_s, delta_s, lse_h, delta_h, q0, T);
    __syncthreads();
    float p[4][4], ds[4][4];
    p_ds_tile<D>(qs, ks, dos, vs, lse_s, delta_s, q0, k0, T, scale, causal,
                 ty, tx, p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ps[(ty + 16 * i) * kPLd + tx + 16 * j] = p[i][j];
        dss[(ty + 16 * i) * kPLd + tx + 16 * j] = ds[i][j];
      }
    __syncthreads();
    const int nr = min(kBlock, T - q0);   // p and ds are 0 past T
    for (int r = 0; r < nr; ++r) {
      float pr[4], dr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pr[i] = ps[r * kPLd + ty + 16 * i];
        dr[i] = dss[r * kPLd + ty + 16 * i];
      }
#pragma unroll
      for (int jj = 0; jj < ND2; ++jj) {
        const float2 dov =
            *reinterpret_cast<const float2*>(dos + r * LD + 32 * jj + 2 * tx);
        const float2 qv =
            *reinterpret_cast<const float2*>(qs + r * LD + 32 * jj + 2 * tx);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc_dv[i][jj][0] = fmaf(pr[i], dov.x, acc_dv[i][jj][0]);
          acc_dv[i][jj][1] = fmaf(pr[i], dov.y, acc_dv[i][jj][1]);
          acc_dk[i][jj][0] = fmaf(dr[i], qv.x, acc_dk[i][jj][0]);
          acc_dk[i][jj][1] = fmaf(dr[i], qv.y, acc_dk[i][jj][1]);
        }
      }
    }
  }
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  store_rows<D>(dk + base, acc_dk, k0, T, ty, tx, one);
  store_rows<D>(dv + base, acc_dv, k0, T, ty, tx, one);
}

template <typename Elt, int ND2>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const Elt* __restrict__ q, const Elt* __restrict__ k,
                    const Elt* __restrict__ v, const Elt* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, Elt* __restrict__ dq,
                    int T, float scale, int causal) {
  constexpr int D = 32 * ND2;
  constexpr int LD = D + 4;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                       // [kBlock][LD]
  float* dos = qs + kBlock * LD;
  float* ks = dos + kBlock * LD;
  float* vs = ks + kBlock * LD;
  float* dss = vs + kBlock * LD;          // [kBlock][kPLd]
  float* lse_s = dss + kBlock * kPLd;     // [kBlock]
  float* delta_s = lse_s + kBlock;        // [kBlock]
  const int q0 = blockIdx.x * kBlock;
  const size_t base = (size_t)blockIdx.y * T * D;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;

  load_rows<D>(qs, q + base, q0, T, 1.f);
  load_rows<D>(dos, dout + base, q0, T, 1.f);
  load_stats(lse_s, delta_s, lse + (size_t)blockIdx.y * T,
             delta + (size_t)blockIdx.y * T, q0, T);

  // query rows ty + 16 i, columns 32 jj + 2 tx + e
  float acc[4][ND2][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < ND2; ++jj) acc[i][jj][0] = acc[i][jj][1] = 0.f;

  int nk = (T + kBlock - 1) / kBlock;
  if (causal) nk = min(nk, (int)blockIdx.x + 1);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kBlock;
    __syncthreads();                      // ks, vs, dss free
    load_rows<D>(ks, k + base, k0, T, 1.f);
    load_rows<D>(vs, v + base, k0, T, 1.f);
    __syncthreads();
    float p[4][4], ds[4][4];
    p_ds_tile<D>(qs, ks, dos, vs, lse_s, delta_s, q0, k0, T, scale, causal,
                 ty, tx, p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dss[(ty + 16 * i) * kPLd + tx + 16 * j] = ds[i][j];
    __syncthreads();
    const int nc = min(kBlock, T - k0);   // ds is 0 past T
    for (int c = 0; c < nc; ++c) {
      float dr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dr[i] = dss[(ty + 16 * i) * kPLd + c];
#pragma unroll
      for (int jj = 0; jj < ND2; ++jj) {
        const float2 kv =
            *reinterpret_cast<const float2*>(ks + c * LD + 32 * jj + 2 * tx);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][jj][0] = fmaf(dr[i], kv.x, acc[i][jj][0]);
          acc[i][jj][1] = fmaf(dr[i], kv.y, acc[i][jj][1]);
        }
      }
    }
  }
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  store_rows<D>(dq + base, acc, q0, T, ty, tx, one);
}

template <typename Elt, int ND2>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, void* dk, void* dv, int BH, int T, float scale,
                   int causal, cudaStream_t stream) {
  constexpr int LD = 32 * ND2 + 4;
  const int smem_kv =
      (4 * kBlock * LD + 2 * kBlock * kPLd + 2 * kBlock) * sizeof(float);
  const int smem_q =
      (4 * kBlock * LD + kBlock * kPLd + 2 * kBlock) * sizeof(float);
  auto kv_kernel = flash_bwd_dkdv_kernel<Elt, ND2>;
  auto q_kernel = flash_bwd_dq_kernel<Elt, ND2>;
  cudaError_t err = pk::allow_smem(kv_kernel, smem_kv);
  if (err != cudaSuccess) return err;
  err = pk::allow_smem(q_kernel, smem_q);
  if (err != cudaSuccess) return err;
  dim3 grid((T + kBlock - 1) / kBlock, BH);
  const Elt* q_ = static_cast<const Elt*>(q);
  const Elt* k_ = static_cast<const Elt*>(k);
  const Elt* v_ = static_cast<const Elt*>(v);
  const Elt* do_ = static_cast<const Elt*>(dout);
  const float* lse_ = static_cast<const float*>(lse);
  const float* delta_ = static_cast<const float*>(delta);
  kv_kernel<<<grid, kThreads, smem_kv, stream>>>(
      q_, k_, v_, do_, lse_, delta_, static_cast<Elt*>(dk),
      static_cast<Elt*>(dv), T, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  q_kernel<<<grid, kThreads, smem_q, stream>>>(
      q_, k_, v_, do_, lse_, delta_, static_cast<Elt*>(dq), T, scale,
      causal);
  return cudaGetLastError();
}

}  // namespace

// fp32 inputs of pk_flash_attn_bwd (flash_attn_bwd.cu), which has
// checked BH, T and the dtype
extern "C" int pk_flash_attn_bwd_f32(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* delta,
                                     void* dq, void* dk, void* dv, int BH,
                                     int T, int D, float scale, int causal,
                                     cudaStream_t s) {
  switch (D) {
    case 32: return launch<float, 1>(q, k, v, dout, lse, delta, dq, dk, dv,
                                     BH, T, scale, causal, s);
    case 64: return launch<float, 2>(q, k, v, dout, lse, delta, dq, dk, dv,
                                     BH, T, scale, causal, s);
    case 96: return launch<float, 3>(q, k, v, dout, lse, delta, dq, dk, dv,
                                     BH, T, scale, causal, s);
    case 128: return launch<float, 4>(q, k, v, dout, lse, delta, dq, dk, dv,
                                      BH, T, scale, causal, s);
    default: return cudaErrorInvalidValue;
  }
}
