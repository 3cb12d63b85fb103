// Flash attention forward, fp32 branch: causal or full attention with
// an online softmax, returning the output and the logsumexp of every
// query row, all on the CUDA cores in fp32. The bf16 branch, on the
// tensor cores, is flash_attn_fwd.cu; its C entry pk_flash_attn_fwd
// dispatches fp32 inputs here.
//
// Replaces paddle_tpu/ops/pallas/attention.py::_flash_fwd (the Pallas
// kernel _fwd_kernel, reached from flash_attention and flash_block_fwd)
// for fp32 inputs. q, k, v, out are [BH, T, D] row-major fp32; lse is
// [BH, T] fp32. q is scaled before the dot, masked scores hold
// -1e30 (keys past T; keys after the query when causal), and
// out = acc / max(l, 1e-30), lse = m + log(max(l, 1e-30)), as there.
//
// What bounds it on the H100: operations. At BH = 96, T = 1024, D = 64,
// causal, fp32 it moves ~101 MB against ~1.3e10 FLOPs: ~30 us of bytes,
// ~190 us at the ~67 TFLOP/s fp32 CUDA-core peak. One TF32 or bf16
// rounding of the operands misses the fp32 branch's 1e-4; operands
// split into three bf16 terms would not (flash_tc.cuh, as the fp32
// backward and chunk prefill do), which is this kernel's redesign.
//
// What the design does about it: one CTA per (64-row query tile, bh);
// the TPU kernel's sequential loop over key blocks stays a loop inside
// the CTA. The scaled query tile stays in shared memory for the whole
// loop; each 64-key tile of K and V is staged once and read by every
// query row. Every thread holds a 4 x 4 block of scores in registers
// (float4 shared loads, 16 FMAs per 8 loads), the row max and sum are
// half-warp shuffles, and the running (m, l, acc) of its four rows stay
// in registers. Under causal masking the loop stops at the diagonal
// tile. Rows past T are never stored; keys past T are masked, so no
// padding is ever copied.
#include "flash_tile.cuh"

namespace {

using namespace pk::flash;

template <typename Elt, int ND2>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const Elt* __restrict__ q, const Elt* __restrict__ k,
                 const Elt* __restrict__ v, Elt* __restrict__ out,
                 float* __restrict__ lse, int T, float scale, int causal) {
  constexpr int D = 32 * ND2;
  constexpr int LD = D + 4;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                       // [kBlock][LD], pre-scaled
  float* ks = qs + kBlock * LD;           // [kBlock][LD]
  float* vs = ks + kBlock * LD;           // [kBlock][LD]
  float* ps = vs + kBlock * LD;           // [kBlock][kPLd]
  const int q0 = blockIdx.x * kBlock;
  const size_t base = (size_t)blockIdx.y * T * D;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;

  load_rows<D>(qs, q + base, q0, T, scale);

  float m[4], l[4], acc[4][ND2][2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < ND2; ++jj) acc[i][jj][0] = acc[i][jj][1] = 0.f;
  }

  int nk = (T + kBlock - 1) / kBlock;
  if (causal) nk = min(nk, (int)blockIdx.x + 1);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kBlock;
    __syncthreads();                      // ks, vs, ps free to refill
    load_rows<D>(ks, k + base, k0, T, 1.f);
    load_rows<D>(vs, v + base, k0, T, 1.f);
    __syncthreads();
    float s[4][4];
    dot_tile<D>(qs, ks, ty, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        const bool ok = kp < T && (!causal || qp >= kp);
        s[i][j] = ok ? s[i][j] : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[(ty + 16 * i) * kPLd + tx + 16 * j] = p;
        sum += p;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < ND2; ++jj) {
        acc[i][jj][0] *= alpha;
        acc[i][jj][1] *= alpha;
      }
    }
    __syncthreads();                      // every p of the tile written
    const int nj = min(kBlock, T - k0);   // rows past T of vs are zero
    for (int j = 0; j < nj; ++j) {
      float pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = ps[(ty + 16 * i) * kPLd + j];
#pragma unroll
      for (int jj = 0; jj < ND2; ++jj) {
        const float2 vv =
            *reinterpret_cast<const float2*>(vs + j * LD + 32 * jj + 2 * tx);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][jj][0] = fmaf(pr[i], vv.x, acc[i][jj][0]);
          acc[i][jj][1] = fmaf(pr[i], vv.y, acc[i][jj][1]);
        }
      }
    }
  }

  float inv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float l_safe = fmaxf(l[i], 1e-30f);
    inv[i] = 1.f / l_safe;
    const int row = q0 + ty + 16 * i;
    if (tx == 0 && row < T)
      lse[(size_t)blockIdx.y * T + row] = m[i] + logf(l_safe);
  }
  store_rows<D>(out + base, acc, q0, T, ty, tx, inv);
}

template <typename Elt, int ND2>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* lse, int BH, int T, float scale, int causal,
                   cudaStream_t stream) {
  constexpr int LD = 32 * ND2 + 4;
  const int smem = (3 * kBlock * LD + kBlock * kPLd) * sizeof(float);
  auto kernel = flash_fwd_kernel<Elt, ND2>;
  cudaError_t err = pk::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((T + kBlock - 1) / kBlock, BH);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const Elt*>(q), static_cast<const Elt*>(k),
      static_cast<const Elt*>(v), static_cast<Elt*>(out),
      static_cast<float*>(lse), T, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// fp32 inputs of pk_flash_attn_fwd (flash_attn_fwd.cu), which has
// checked BH, T and the dtype
extern "C" int pk_flash_attn_fwd_f32(const void* q, const void* k,
                                     const void* v, void* out, void* lse,
                                     int BH, int T, int D, float scale,
                                     int causal, cudaStream_t s) {
  switch (D) {
    case 32: return launch<float, 1>(q, k, v, out, lse, BH, T, scale, causal, s);
    case 64: return launch<float, 2>(q, k, v, out, lse, BH, T, scale, causal, s);
    case 96: return launch<float, 3>(q, k, v, out, lse, BH, T, scale, causal, s);
    case 128: return launch<float, 4>(q, k, v, out, lse, BH, T, scale, causal, s);
    default: return cudaErrorInvalidValue;
  }
}
