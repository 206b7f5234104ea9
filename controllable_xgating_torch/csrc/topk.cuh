// Shared by the two vocab top-K kernels (topk_tail.cu, topk_extract.cu):
// the (value desc, index asc) order that lax.top_k's ties follow, a warp
// and a quad arg-max on it (a quad of 4 lanes holds one accumulator row
// of a wgmma tile), and the merge of per-chunk candidates and (max,
// sum-exp) partials into each row's top-K and logsumexp.
#pragma once

#include "common.cuh"

namespace cxg {

constexpr int kKMax = 8;
constexpr float kMaskNeg = -1e30f;
constexpr int kPad = 0, kBos = 1, kUnk = 3;  // data/vocab.py

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

// One warp per row: K rounds of arg-max over the row's nchunks * k
// candidates [rows, nchunks, k], and the log-sum-exp combine of the
// partials [rows, nchunks] (a partial sum of 0 is a chunk with nothing in
// the sum). Defined in topk_tail.cu.
cudaError_t launch_topk_merge(const float* cand_v, const int* cand_i, const float* part_m,
                              const float* part_s, float* vals, int* idx, float* lse, int rows,
                              int nchunks, int k, cudaStream_t st);

}  // namespace cxg
