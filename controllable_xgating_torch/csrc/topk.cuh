// Shared by the two vocab top-K kernels (topk_tail.cu, topk_extract.cu):
// the (value desc, index asc) order that lax.top_k's ties follow, a warp
// and a quad arg-max on it (a quad of 4 lanes holds one accumulator row
// of a wgmma tile), the bf16 chunk stage both run (chunk_logits), and the
// merge of a row's per-chunk candidates and (max, sum-exp) partials into
// its top-K and logsumexp (merge_row).
#pragma once

#include <type_traits>

#include "common.cuh"
#include "hopper_gemm.cuh"

namespace cxg {

constexpr int kKMax = 8;
constexpr float kMaskNeg = -1e30f;
constexpr int kPad = 0, kBos = 1, kEos = 2, kUnk = 3;  // data/vocab.py

// (va, ia, la) ranks before (vb, ib, lb): value desc, index asc, then lane
__device__ __forceinline__ bool ranks_before(float va, int ia, int la, float vb, int ib,
                                             int lb) {
  return va > vb || (va == vb && (ia < ib || (ia == ib && la < lb)));
}

// warp-wide best (value, index, lane); every lane ends with the same answer
__device__ __forceinline__ void warp_best(float& v, int& i, int& l) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, off);
    const int oi = __shfl_xor_sync(kFull, i, off);
    const int ol = __shfl_xor_sync(kFull, l, off);
    if (ranks_before(ov, oi, ol, v, i, l)) {
      v = ov;
      i = oi;
      l = ol;
    }
  }
}

// (v, i, l) of the best of the 4 lanes of a quad, on (value desc, index asc)
__device__ __forceinline__ void quad_best(float& v, int& i, int& l) {
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    const float ov = __shfl_xor_sync(kFull, v, off);
    const int oi = __shfl_xor_sync(kFull, i, off);
    const int ol = __shfl_xor_sync(kFull, l, off);
    if (ranks_before(ov, oi, ol, v, i, l)) {
      v = ov;
      i = oi;
      l = ol;
    }
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}

// f(std::integral_constant<int, k>{}) for 1 <= k <= kKMax: one
// instantiation of a kernel per k; another k is cudaErrorInvalidValue.
template <typename F>
cudaError_t with_k(int k, F f) {
  using std::integral_constant;
  switch (k) {
    case 1: return f(integral_constant<int, 1>{});
    case 2: return f(integral_constant<int, 2>{});
    case 3: return f(integral_constant<int, 3>{});
    case 4: return f(integral_constant<int, 4>{});
    case 5: return f(integral_constant<int, 5>{});
    case 6: return f(integral_constant<int, 6>{});
    case 7: return f(integral_constant<int, 7>{});
    case 8: return f(integral_constant<int, 8>{});
  }
  return cudaErrorInvalidValue;
}

// Insert (v, i) into a list of K sorted by (value desc, index asc),
// dropping its last entry. A strict comparison: the incumbent keeps a tie.
template <int K>
__device__ __forceinline__ void insert_sorted(float (&tv)[K], int (&ti)[K], float v, int i) {
#pragma unroll
  for (int slot = 0; slot < K; ++slot) {
    const bool swap = ranks_before(v, i, 0, tv[slot], ti[slot], 0);
    const float ov = tv[slot];
    const int oi = ti[slot];
    tv[slot] = swap ? v : ov;
    ti[slot] = swap ? i : oi;
    v = swap ? ov : v;
    i = swap ? oi : i;
  }
}

// The bf16 policy's chunk stage: rows [m0, m0 + 128) x vocab columns
// [n0, n0 + 128) of h @ w_out^T on hop::streamed_tile (h [rows, hd] and
// w_out^T [v, hd] K-major through TMA descriptors, boxes of 128 and 128
// rows; a 3-stage ring; warpgroup wg multiplies rows m0 + 64 wg .. + 63
// with m64n128k16 and both share each w tile). On return acc holds the
// logits in place, bias added: -1e30 at the specials (PAD, BOS, and UNK
// with block_unk), -inf past the vocab (never a winner while a real
// column is left); m and s hold each owned row's max and sum of exp(x - m)
// over the chunk's other columns, the same in the row's 4 quad lanes
// (m = -inf and s = 0 where the chunk has none). Thread rows: acc_row(2 r)
// of warpgroup wg for r = 0, 1; acc[i] lies on row (i >> 1) & 1.
constexpr int kChunkStages = 3;  // 97 KB: two blocks an SM
constexpr int kChunkWgs = 2;
constexpr int kChunkRows = kChunkWgs * hop::kTileM;
constexpr int kChunkThreads = kChunkWgs * hop::kThreads;

__device__ __forceinline__ bool masked_col(int col, int block_unk) {
  return col == kPad || col == kBos || (block_unk && col == kUnk);
}

__device__ __forceinline__ void chunk_logits(float (&acc)[64], float (&m)[2], float (&s)[2],
                                             const CUtensorMap* map_h, const CUtensorMap* map_w,
                                             const float* __restrict__ b, int m0, int n0, int hd,
                                             int v, int block_unk) {
  hop::streamed_tile<kChunkStages, kChunkWgs>(acc, map_h, map_w, m0, n0, hd, false);
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int col = n0 + hop::acc_col(i);
    float x = -INFINITY;
    if (col < v) {
      const bool special = masked_col(col, block_unk);
      x = special ? kMaskNeg : acc[i] + b[col];
      if (!special) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
    }
    acc[i] = x;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m[r] = quad_max(mx[r]);
    s[r] = 0.0f;
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int r = (i >> 1) & 1, col = n0 + hop::acc_col(i);
    if (!masked_col(col, block_unk) && m[r] > -INFINITY) s[r] += expf(acc[i] - m[r]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    s[r] += __shfl_xor_sync(kFull, s[r], 1);
    s[r] += __shfl_xor_sync(kFull, s[r], 2);
  }
}

// One warp, one row: the top K (value desc, index asc) of the row's
// nchunks * K candidates cv, ci ([nchunks, K]) and its logsumexp from the
// partials pm, ps ([nchunks]; a partial sum of 0 is a chunk with nothing
// in the sum). Each lane keeps a sorted top-K of the candidates it reads,
// then K rounds of warp arg-max pop the lists' heads. Every lane ends
// with vals, idx and lse.
template <int K>
__device__ __forceinline__ void merge_row(const float* __restrict__ cv,
                                          const int* __restrict__ ci,
                                          const float* __restrict__ pm,
                                          const float* __restrict__ ps, int nchunks,
                                          float (&vals)[K], int (&idx)[K], float& lse) {
  const int lane = threadIdx.x & 31;
  float tv[K];
  int ti[K];
#pragma unroll
  for (int slot = 0; slot < K; ++slot) {
    tv[slot] = -INFINITY;
    ti[slot] = 0x7fffffff;
  }
  const int n = nchunks * K;
#pragma unroll 4
  for (int p = lane; p < n; p += 32) insert_sorted(tv, ti, cv[p], ci[p]);
#pragma unroll
  for (int j = 0; j < K; ++j) {
    float bv = tv[0];
    int bi = ti[0], bl = lane;
    warp_best(bv, bi, bl);
    if (lane == bl) {  // pop the winner's head
#pragma unroll
      for (int slot = 0; slot + 1 < K; ++slot) {
        tv[slot] = tv[slot + 1];
        ti[slot] = ti[slot + 1];
      }
      tv[K - 1] = -INFINITY;
      ti[K - 1] = 0x7fffffff;
    }
    vals[j] = bv;
    idx[j] = bi;
  }
  float mx = -INFINITY;
  for (int c = lane; c < nchunks; c += 32) mx = fmaxf(mx, pm[c]);
  mx = warp_max(mx);
  float z = 0.0f;
  for (int c = lane; c < nchunks; c += 32) {
    const float sc = ps[c];
    if (sc > 0.0f) z += sc * expf(pm[c] - mx);
  }
  z = warp_sum(z);
  lse = mx + logf(z);
}

// One warp per row: each row's top-k and logsumexp (merge_row) of the
// chunks' candidates [rows, nchunks, k] and partials [rows, nchunks].
// Defined in topk_tail.cu.
cudaError_t launch_topk_merge(const float* cand_v, const int* cand_i, const float* part_m,
                              const float* part_s, float* vals, int* idx, float* lse, int rows,
                              int nchunks, int k, cudaStream_t st);

}  // namespace cxg
