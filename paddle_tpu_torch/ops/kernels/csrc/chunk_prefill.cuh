// One prefill chunk's attention against its pool-resident context, its
// products on the Hopper tensor cores (wgmma): bf16 queries over a bf16,
// int8 or int4 pool, and fp32 queries over an fp32, int8 or int4 pool,
// as instantiations of one kernel.
//
// Replaces paddle_tpu/ops/pallas/prefill.py::flash_chunk_prefill (the
// Pallas kernels _chunk_kernel and, for a cold chunk with no context,
// _cold_chunk_kernel). Query row (c, g) of kv-head h attends over the
// S = P_ctx*bs context positions, read through pages[] from the pool
// [Hkv, M, Dh] and fully visible, then over the chunk's own fresh K/V
// [C, Hkv, Dh] causally (column S + j is visible iff j <= c). Scores are
// q . k / sqrt(Dh), masked columns carry exactly zero weight, out =
// softmax . V in fp32 [C, Hkv, G, Dh].
//
// What bounds it on the H100: at the serving slice (C = 256, S = 512,
// Hkv = 12, G = 1, Dh = 64, bf16 pool) it reads ~2.4 MB (context K/V, the
// chunk's q/k/v) and writes 0.8 MB of fp32 output, ~1 us of bytes,
// against ~0.5 GFLOP, ~0.5 us at the 989 TFLOP/s bf16 peak: bytes, by a
// little. An int8 / int4 context moves 0.55x / 0.3x the context bytes.
// With fp32 queries and pool the bytes double (~2 us) and the same
// ~0.5 GFLOP takes six bf16 passes (below), ~3 us at 989 TFLOP/s, i.e.
// the fp32-accurate ~165 TFLOP/s: operations, by a little.
//
// The design (flash_attn_fwd.cu's, with the columns read through the
// page table):
//   - one CTA = one warpgroup per (kv-head, 64-row tile of the flattened
//     c*G + g query rows), the tiles with the most causal columns
//     launched first; the TPU kernel's sequential page-step grid is a
//     loop over 64-column tiles inside the CTA: the context tiles, then
//     the chunk's own, stopping at the last column the tile's rows see;
//     only the tile holding S and the tiles across the causal diagonal
//     are masked;
//   - K/V tiles (flash_tc.cuh layout, 128-byte swizzle) staged by 16-byte
//     cp.async, tile i + 1 in flight while the tensor cores work on tile
//     i. Context rows come through the page table (each 16-byte copy
//     reads from pool row pages[t / bs] * bs + t % bs), the chunk's rows
//     at a stride of Hkv * Dh, the query rows through the (c, h, g)
//     layout;
//   - S = q . k^T by m64n64k16 wgmma from shared memory, the online
//     softmax in registers in the exp2 domain, O += P . V with p in
//     registers as the A operand (FlashAttention-3's structure); no
//     score row is kept, so shared memory does not grow with S;
//   - precision: every operand reaches the tensor cores as bf16 terms
//     (flash_tc.cuh, split operands). bf16 queries: q, k and v are one
//     term each and p is split into hi and lo, so p . V keeps fp32
//     accuracy (one rounding of p alone would cost ~2^-9 relative).
//     fp32 queries: q, k, v and p are three terms each, 24 significand
//     bits, and each product is the six cross terms of order 2^-16 and
//     up, smallest first (TF32 or one bf16 rounding would miss the plain
//     version by ~1e-3; the split stays within ~1e-6). fp32 K/V rows
//     land in a raw buffer (64 rows x 4 Dh bytes each for K and V) and
//     are split into their three term tiles right after they arrive,
//     before the next tile's copy is issued into the same buffer; the q
//     tile is split once, straight from global memory;
//   - a quantized context (int8 codes, or int4 nibble pairs, with fp32
//     row scales) is staged as codes (load_paged_codes) and widened to
//     bf16 in shared memory right before its products (widen_tile; codes
//     are exact in bf16, so one term for either query type). K's row
//     scale multiplies the score after the product (ks[t] * (q .
//     code_t)); V's multiplies p before p is split (p_t * vs[t]); the
//     softmax sum takes p unscaled. The chunk's own K/V stay exact in the
//     model dtype;
//   - a cold chunk (P_ctx = 0) is the same kernel with no context loop;
//     it reads no pool, so it runs the model-dtype instantiation;
//   - a row tile's columns are split across CTAs, kSplitTiles = 2 tiles
//     (128 columns) each, a constant of the kernel: one CTA per (head, row
//     tile) left the slice's grid at 12 x 4 = 48 CTAs on 132 SMs, each
//     walking up to 12 tiles one after another (31 us at the slice on an
//     H100 80GB HBM3 at 700 W, 45 us over an int8 or int4 context).
//     Split, it is 12 x 4 x 6 (4 tiles a CTA were slower than 2 over
//     every pool storage). A row tile with one split writes its output
//     directly; with more, each split writes fp32 partials (o
//     unnormalized, row max and sum), and the last CTA of the row tile to
//     arrive (an atomic counter, used for ordering only) combines them in
//     ascending split order, as decode_attention.cu does, so the result
//     is bitwise repeatable.
// Head dims 32, 64, 96 and 128, padded to 64 / 128 columns as flash_tc
// does. Shared memory at Dh = 128: bf16 80 KB, fp32 209 KB (three term
// tiles each of q, K and V, and the raw K/V rows). Left for later: TMA
// tile loads and a persistent grid.
//
// The kernel and its launch templates live here; chunk_prefill.cu holds
// the C entry and the bf16 instantiations, chunk_prefill_fp32_d*.cu the
// fp32 ones, so that they compile in parallel.
#pragma once

#include "flash_tc.cuh"

namespace pk {
namespace prefill {

using namespace pk::tc;

constexpr int kSplitTiles = 2;   // 64-column tiles a CTA takes (128 columns)

// splits of the column tiles of the row tile that sees the most columns
// (the last: all nctx context tiles and every chunk tile);
// paddle_tpu_torch/ops/kernels/prefill.py::prefill_tc_splits mirrors it
inline int splits(int C, int G, int nctx) {
  const int nt = nctx + (C - 1) / kRows + 1;
  return (nt + kSplitTiles - 1) / kSplitTiles;
}

// code bytes of one quantized pool row
template <int D, int KV>
__host__ __device__ constexpr int code_bytes() {
  return KV == pk::kInt4 ? D / 2 : D;
}

// The shared-memory plan of one instantiation. bf16 queries: one term
// per operand tile; K and V in a two-stage ring; a quantized context's
// codes in a two-stage raw ring. fp32 queries: three term tiles per
// operand, K and V in one stage (their rows split before the next copy)
// and one raw buffer for the K and V rows of the tile in flight, fp32
// rows or codes. Either: two stages of K and V row scales for a
// quantized context.
template <typename Elt, int D, int KV>
struct Plan {
  static constexpr bool kF32 = std::is_same<Elt, float>::value;
  static constexpr bool kQuant = KV != pk::kModel;
  static constexpr int kTerms = kF32 ? 3 : 1;   // of q and model-dtype K/V
  static constexpr int kPTerms = kF32 ? 3 : 2;  // of p
  static constexpr int kStages = kF32 ? 1 : 2;  // of the K / V term tiles
  static constexpr int kTile = tile_bytes(kRows, D);
  // bytes of one raw row: fp32 values, or codes
  static constexpr int kRawRow = kF32 ? 4 * D : code_bytes<D, KV>();
  static constexpr int kRawStages = kF32 ? 1 : (kQuant ? 2 : 0);
  static constexpr int kRaw = kRows * kRawRow;  // one raw buffer (K or V)
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kTerms * kTile;
  static constexpr int kV = kK + kStages * kTerms * kTile;
  static constexpr int kRawAt = kV + kStages * kTerms * kTile;
  static constexpr int kScaleAt = kRawAt + kRawStages * 2 * kRaw;
  // paddle_tpu_torch/ops/kernels/prefill.py::prefill_layout computes the
  // same bytes
  static constexpr int kBytes =
      kScaleAt + (kQuant ? 2 * 2 * kRows * 4 : 0) + 1024;
};

template <typename Elt, int D, int KV>
__global__ void __launch_bounds__(kThreads)
chunk_prefill_tc_kernel(const Elt* __restrict__ q,
                        const Elt* __restrict__ k_chunk,
                        const Elt* __restrict__ v_chunk,
                        const void* __restrict__ k,
                        const void* __restrict__ v,
                        const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale,
                        const int* __restrict__ pages,
                        float* __restrict__ out, float* __restrict__ part,
                        int* __restrict__ counters, int C, int Hkv, int G,
                        int M, int S, int bs, float scale) {
  using P = Plan<Elt, D, KV>;
  constexpr bool kF32 = P::kF32, kQuant = P::kQuant;
  constexpr int NT = P::kTerms, PT = P::kPTerms;
  constexpr int DP = padded(D);
  constexpr int kTile = P::kTile;
  constexpr int RB = code_bytes<D, KV>();
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t base = smem_base(smem);
  const uint32_t qs = base + P::kQ;
  const uint32_t raw0 = base + P::kRawAt;
  const uint32_t sc0 = base + P::kScaleAt;      // scales: stage s, K / V
  // generic address of a shared one
  auto gen = [&](uint32_t a) { return smem + (a - smem_u32(smem)); };
  // term 0 of the K / V tile of ring stage st (term t: + t * kTile; the
  // fp32 instantiation has one stage)
  auto ktile = [&](int st) {
    return base + P::kK + st % P::kStages * NT * kTile;
  };
  auto vtile = [&](int st) {
    return base + P::kV + st % P::kStages * NT * kTile;
  };
  // the raw K buffer of ring stage st; V's follows it
  auto rawk = [&](int st) { return raw0 + (kF32 ? 0 : 2 * st * P::kRaw); };

  const int h = blockIdx.x;
  const int R = C * G;                          // query rows of the head
  const int rt = gridDim.y - 1 - blockIdx.y;    // row tile
  const int r0 = rt * kRows;
  const int last_c = (min(r0 + kRows, R) - 1) / G;  // last column it sees
  const int nctx = (S + kRows - 1) / kRows;
  const int nt = nctx + last_c / kRows + 1;     // column tiles it sees
  const int nact = (nt + kSplitTiles - 1) / kSplitTiles;  // splits
  const int split = blockIdx.z;
  if (split >= nact) return;
  const int i0 = split * kSplitTiles, i1 = min(nt, i0 + kSplitTiles);

  const size_t hoff = (size_t)h * M * (kQuant ? RB : D * sizeof(Elt));
  const uint8_t* kpool = static_cast<const uint8_t*>(k) + hoff;
  const uint8_t* vpool = static_cast<const uint8_t*>(v) + hoff;
  const float* ksh = kQuant ? k_scale + (size_t)h * M : nullptr;
  const float* vsh = kQuant ? v_scale + (size_t)h * M : nullptr;

  // tile i's copies into ring stage i & 1: a context tile (i < nctx)
  // through the page table, as codes and scales, or as model-dtype rows
  // (bf16 straight into the K / V tiles, fp32 into the raw buffer); then
  // the chunk's rows (bf16 into the tiles, fp32 into the raw buffer)
  auto issue = [&](int i) {
    const int st = i & 1;
    if (i < nctx) {
      if constexpr (kQuant) {
        const uint32_t sc = sc0 + 2 * st * kRows * 4;
        load_paged_codes<kRows, RB>(
            rawk(st), sc, reinterpret_cast<const int8_t*>(kpool), ksh, pages,
            bs, i * kRows, S);
        load_paged_codes<kRows, RB>(
            rawk(st) + P::kRaw, sc + kRows * 4,
            reinterpret_cast<const int8_t*>(vpool), vsh, pages, bs,
            i * kRows, S);
      } else if constexpr (kF32) {
        const int t0 = i * kRows;
        load_raw<kRows, 4 * D>(
            rawk(st),
            [=](int r) {
              return kpool + paged_row(pages, bs, t0 + r) * 4 * D;
            },
            S - t0, kpool);
        load_raw<kRows, 4 * D>(
            rawk(st) + P::kRaw,
            [=](int r) {
              return vpool + paged_row(pages, bs, t0 + r) * 4 * D;
            },
            S - t0, vpool);
      } else {
        load_paged_tile<kRows, D>(ktile(st),
                                  reinterpret_cast<const bf16*>(kpool), pages,
                                  bs, i * kRows, S);
        load_paged_tile<kRows, D>(vtile(st),
                                  reinterpret_cast<const bf16*>(vpool), pages,
                                  bs, i * kRows, S);
      }
    } else {
      const int j0 = (i - nctx) * kRows;
      auto krow = [=](int r) {
        return k_chunk + ((size_t)(j0 + r) * Hkv + h) * D;
      };
      auto vrow = [=](int r) {
        return v_chunk + ((size_t)(j0 + r) * Hkv + h) * D;
      };
      if constexpr (kF32) {
        load_raw<kRows, 4 * D>(rawk(st), krow, C - j0, k_chunk);
        load_raw<kRows, 4 * D>(rawk(st) + P::kRaw, vrow, C - j0, v_chunk);
      } else {
        load_rows<kRows, D>(ktile(st), krow, C - j0, k_chunk);
        load_rows<kRows, D>(vtile(st), vrow, C - j0, v_chunk);
      }
    }
  };

  // tile i's bf16 term tiles from what its copies left in the raw
  // buffer: codes widened (one term), fp32 rows split (three); a bf16
  // model-dtype tile is there already
  auto stage = [&](int i) {
    const int st = i & 1;
    if constexpr (kQuant) {
      if (i < nctx) {
        widen_tile<kRows, D, KV>(ktile(st), gen(rawk(st)));
        widen_tile<kRows, D, KV>(vtile(st), gen(rawk(st) + P::kRaw));
        fence_async_writes();
        return;
      }
    }
    if constexpr (kF32) {
      const float* rk = reinterpret_cast<const float*>(gen(rawk(st)));
      const float* rv = rk + kRows * D;
      split_rows<kRows, D, NT>(ktile(st), [=](int r) { return rk + r * D; },
                               kRows);
      split_rows<kRows, D, NT>(vtile(st), [=](int r) { return rv + r * D; },
                               kRows);
      fence_async_writes();
    }
  };

  // query row r0 + r = c * G + g lies at q[((c * Hkv + h) * G + g) * D]
  auto qrow = [=](int r) {
    const int rr = r0 + r;
    return q + (((size_t)(rr / G) * Hkv + h) * G + rr % G) * D;
  };
  if constexpr (kF32)      // split once from global memory (fenced with
    split_rows<kRows, D, NT>(qs, qrow, R - r0);  // the first tile's stage)
  else
    load_rows<kRows, D>(qs, qrow, R - r0, q);
  issue(i0);
  cp_async_commit();

  const int fr = frag_row(), fc = frag_col();
  // the chunk column each of this thread's two rows sees up to
  const int see[2] = {(r0 + fr) / G, (r0 + fr + 8) / G};
  const float c2 = kLog2e / scale;
  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int i = i0; i < i1; ++i) {
    cp_async_land();               // tile i in; everyone is past i - 1
    // fp32: one raw buffer, so split tile i before tile i + 1's copy
    if constexpr (kF32) stage(i);
    if (i + 1 < i1) {
      issue(i + 1);
      cp_async_commit();
    }
    if constexpr (!kF32) stage(i);
    const int st = i & 1;
    const uint32_t ks = ktile(st), vs = vtile(st);
    const bool ctx = i < nctx;
    const bool codes = kQuant && ctx;           // K / V one term
    const float* ksc = nullptr;
    const float* vsc = nullptr;
    if (codes) {
      ksc = reinterpret_cast<const float*>(gen(sc0 + 2 * st * kRows * 4));
      vsc = ksc + kRows;
    }

    float s[32];
    wg_fence();
    if (codes)
      ss_split<64, kRows, kRows, D / 16, NT, 1>(s, qs, kTile, ks, kTile);
    else
      ss_split<64, kRows, kRows, D / 16, NT, NT>(s, qs, kTile, ks, kTile);
    wg_commit();
    wg_wait();
    pin(s);

    // columns: context positions i * 64 + x, or chunk rows j0 + x
    const int col0 = ctx ? i * kRows : (i - nctx) * kRows;
    const bool edge = ctx ? col0 + kRows > S : col0 + kRows - 1 > r0 / G;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const int e = 4 * j + 2 * hh + b, x = 8 * j + fc + b;
          float y = s[e] * c2;
          if (ksc != nullptr) y *= ksc[x];
          if (edge && (ctx ? col0 + x >= S : col0 + x > see[hh]))
            y = kNegInf;
          s[e] = y;
          mx[hh] = fmaxf(mx[hh], y);
        }
    // every row sees the first column of each tile it takes (a context
    // column, or chunk column 64 t <= r0 / G, the row tile being
    // 64-aligned), so m is finite from a split's first tile on and every
    // masked p is exactly 0
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float m_new = fmaxf(m[hh], quad_max(mx[hh]));
      alpha[hh] = exp2f(m[hh] - m_new);
      m[hh] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const int e = 4 * j + 2 * hh + b;
          s[e] = exp2f(s[e] - m[hh]);
          sum[hh] += s[e];
          if (vsc != nullptr) s[e] *= vsc[8 * j + fc + b];
        }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) l[hh] = l[hh] * alpha[hh] + quad_sum(sum[hh]);
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        o[4 * j + 2 * hh] *= alpha[hh];
        o[4 * j + 2 * hh + 1] *= alpha[hh];
      }

    uint32_t pf[PT][4][4];
    split_frags<64>(s, pf);
    pin(o);
    pin(pf);
    wg_fence();
    if (codes)
      rs_split<DP, kRows, 4, PT, 1>(o, pf, vs, kTile);
    else
      rs_split<DP, kRows, 4, PT, NT>(o, pf, vs, kTile);
    wg_commit();
    wg_wait();
    pin(o);
  }

  // row r0 + fr + 8 hh = c * G + g to out[((c * Hkv + h) * G + g) * D]
  auto out_row = [&](int row) {
    return out + (((size_t)(row / G) * Hkv + h) * G + row % G) * D;
  };
  if (nact == 1) {                 // the split is the row tile
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = r0 + fr + 8 * hh;
      if (row >= R) continue;
      float* dst = out_row(row);
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(dst + 8 * j + fc) = make_float2(
            o[4 * j + 2 * hh] / l[hh], o[4 * j + 2 * hh + 1] / l[hh]);
    }
    return;
  }

  // partials of (head, row tile, split): o [64, D] unnormalized, then
  // (m, l) [2, 64] after all of o, m in the exp2 domain
  const int tile_id = h * gridDim.y + rt;
  const int nsplit = gridDim.z;
  const size_t ntiles = (size_t)gridDim.x * gridDim.y;
  float* po = part + ((size_t)tile_id * nsplit + split) * kRows * D;
  float* pml = part + ntiles * nsplit * kRows * D +
               ((size_t)tile_id * nsplit + split) * 2 * kRows;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = fr + 8 * hh;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(po + row * D + 8 * j + fc) =
          make_float2(o[4 * j + 2 * hh], o[4 * j + 2 * hh + 1]);
    if (fc == 0) {
      pml[row] = m[hh];
      pml[kRows + row] = l[hh];
    }
  }
  __threadfence();                 // partials before arrival
  __syncthreads();
  int* last = reinterpret_cast<int*>(gen(qs));  // the q tile is free
  if (threadIdx.x == 0)
    *last = atomicAdd(counters + tile_id, 1) == nact - 1;
  __syncthreads();
  if (!*last) return;
  if (threadIdx.x == 0) counters[tile_id] = 0;  // ready for the next launch
  __threadfence();

  // the last split to arrive combines them in ascending order: per row
  // the max m and sum l = sum 2^(m_i - m) l_i, then every output
  // o = sum 2^(m_i - m) o_i / l, a thread's 16-byte loads of one split
  // (kOut of them, a whole number of rows apart) in flight together
  const float* base_o = part + (size_t)tile_id * nsplit * kRows * D;
  const float* base_ml = part + ntiles * nsplit * kRows * D +
                         (size_t)tile_id * nsplit * 2 * kRows;
  float* row_m = reinterpret_cast<float*>(gen(qs)) + 4;  // [64]
  float* row_l = row_m + kRows;                           // [64]
  if (threadIdx.x < kRows) {
    const int r = threadIdx.x;
    float mm = kNegInf;
#pragma unroll 8
    for (int i = 0; i < nact; ++i)
      mm = fmaxf(mm, __ldcg(base_ml + (size_t)i * 2 * kRows + r));
    float ll = 0.f;
#pragma unroll 8
    for (int i = 0; i < nact; ++i) {
      const float* ml = base_ml + (size_t)i * 2 * kRows;
      ll += exp2f(__ldcg(ml + r) - mm) * __ldcg(ml + kRows + r);
    }
    row_m[r] = mm;
    row_l[r] = ll;
  }
  __syncthreads();
  constexpr int kOut = kRows * D / 4 / kThreads;  // float4s a thread owns
  float4 acc[kOut];
#pragma unroll
  for (int k = 0; k < kOut; ++k) acc[k] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = 0; i < nact; ++i) {
    const float4* po4 =
        reinterpret_cast<const float4*>(base_o + (size_t)i * kRows * D);
    const float* mi = base_ml + (size_t)i * 2 * kRows;
#pragma unroll
    for (int k = 0; k < kOut; ++k) {
      const int x4 = threadIdx.x + k * kThreads, r = 4 * x4 / D;
      const float w = exp2f(__ldcg(mi + r) - row_m[r]);
      const float4 v = __ldcg(po4 + x4);
      acc[k].x = fmaf(w, v.x, acc[k].x);
      acc[k].y = fmaf(w, v.y, acc[k].y);
      acc[k].z = fmaf(w, v.z, acc[k].z);
      acc[k].w = fmaf(w, v.w, acc[k].w);
    }
  }
#pragma unroll
  for (int k = 0; k < kOut; ++k) {
    const int x4 = threadIdx.x + k * kThreads, r = 4 * x4 / D;
    if (r0 + r >= R) continue;
    const float l_r = row_l[r];
    *reinterpret_cast<float4*>(out_row(r0 + r) + 4 * x4 % D) = make_float4(
        acc[k].x / l_r, acc[k].y / l_r, acc[k].z / l_r, acc[k].w / l_r);
  }
}

// one launch's operands and sizes, as pk_chunk_prefill takes them
struct Args {
  const void *q, *k_chunk, *v_chunk, *k, *v, *k_scale, *v_scale, *pages;
  void *out, *part, *counters;
  int C, Hkv, G, Dh, M, P_ctx, bs, kv, smem;
  float scale;
};

template <typename Elt, int D, int KV>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  if (a.smem != Plan<Elt, D, KV>::kBytes) return cudaErrorInvalidValue;
  auto kernel = chunk_prefill_tc_kernel<Elt, D, KV>;
  cudaError_t err = pk::allow_smem(kernel, a.smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.Hkv, (a.C * a.G + kRows - 1) / kRows,
            splits(a.C, a.G, (a.P_ctx * a.bs + kRows - 1) / kRows));
  kernel<<<grid, kThreads, a.smem, stream>>>(
      static_cast<const Elt*>(a.q), static_cast<const Elt*>(a.k_chunk),
      static_cast<const Elt*>(a.v_chunk), a.k, a.v,
      static_cast<const float*>(a.k_scale),
      static_cast<const float*>(a.v_scale), static_cast<const int*>(a.pages),
      static_cast<float*>(a.out), static_cast<float*>(a.part),
      static_cast<int*>(a.counters), a.C, a.Hkv, a.G, a.M, a.P_ctx * a.bs,
      a.bs, a.scale);
  return cudaGetLastError();
}

template <typename Elt, int D>
cudaError_t launch_kv(const Args& a, cudaStream_t s) {
  // a cold chunk reads no pool: the model-dtype instantiation serves it
  if (a.kv == pk::kModel || a.P_ctx == 0)
    return launch<Elt, D, pk::kModel>(a, s);
  if (a.kv == pk::kInt8) return launch<Elt, D, pk::kInt8>(a, s);
  if (a.kv == pk::kInt4) return launch<Elt, D, pk::kInt4>(a, s);
  return cudaErrorInvalidValue;
}

// every instantiation of one query dtype, by head dim and pool storage
template <typename Elt>
cudaError_t launch_dtype(const Args& a, cudaStream_t s) {
  switch (a.Dh) {
    case 32: return launch_kv<Elt, 32>(a, s);
    case 64: return launch_kv<Elt, 64>(a, s);
    case 96: return launch_kv<Elt, 96>(a, s);
    case 128: return launch_kv<Elt, 128>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

// the fp32 instantiations compile in units of their own, two head dims
// each (chunk_prefill_fp32_d32_128.cu, chunk_prefill_fp32_d64_96.cu),
// beside the bf16 ones (chunk_prefill.cu): in one unit they were the
// build's longest compile by far (tools/build_times.py)
extern template cudaError_t launch_kv<float, 32>(const Args&, cudaStream_t);
extern template cudaError_t launch_kv<float, 64>(const Args&, cudaStream_t);
extern template cudaError_t launch_kv<float, 96>(const Args&, cudaStream_t);
extern template cudaError_t launch_kv<float, 128>(const Args&,
                                                  cudaStream_t);

}  // namespace prefill
}  // namespace pk
