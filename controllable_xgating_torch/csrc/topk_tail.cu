// Beam tail: vocab projection, special-token mask, per-row top-K and
// logsumexp, without ever writing the [R, V] logits.
//
// Replaces the Pallas kernel controllable_xgating_tpu/ops/pallas/topk_tail.py
// (_make_kernel / _pallas_topk, wrappers _lane_topk and logits_topk_lanes):
//   logits = h @ w_out + b ; logits[PAD] = logits[BOS] = -1e30 (UNK too
//   when block_unk) ; vals, idx = top_k(logits, K) ; lse = logsumexp(logits)
// Ties go to the lower vocab index, as lax.top_k does.
//
// What bounds it on the card: per beam step (R = 1280, Hd = 512,
// V = 10000) the projection is 13 GFLOP over a 10 MB bf16 weight, so it is
// compute-bound (this version: by tile_gemm's staging loop, each 32-row
// tile re-reading the weight from L2); unfused, the f32 logits
// (51 MB) would be written, then read back by the mask, the log-softmax
// and the top-k.
//
// Design: two kernels on one stream.
//   1. topk_chunk_kernel, one block per (32-row tile, 1024-column vocab
//      chunk): logits in 128-column tiles through tile_gemm into shared
//      memory; each warp owns 4 rows and each lane keeps, per row, a sorted
//      top-K by insertion and an online (max, sum-exp) over the columns it
//      sees (col = lane mod 32, increasing, so the incumbent of an equal
//      value always has the lower index); then K rounds of warp arg-max on
//      (value desc, index asc) merge the 32 lane lists into the chunk's
//      top-K, and a warp reduction merges (max, sum-exp). Columns >= V
//      (V = 10000 is ragged) are skipped.
//   2. topk_merge_kernel, one warp per row: K rounds of arg-max over the
//      chunks' candidates on the same order, and the log-sum-exp combine.
// Masked specials enter the top-K lists at -1e30, as in the Pallas kernel,
// and are left out of the sum-exp, where they would add exp(-1e30 - m) = 0.
#include "topk.cuh"

namespace cxg {

constexpr int kTkRows = 32;     // TM = 4, 4 rows per warp
constexpr int kRowsPerWarp = kTkRows / 8;

inline size_t topk_chunk_smem_bytes() {
  return (size_t)(kTkRows * kBN + gemm_smem_floats<kTkRows / 8>()) * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    topk_chunk_kernel(const T* __restrict__ h, const T* __restrict__ w,
                      const float* __restrict__ b, float* __restrict__ cand_v,
                      int* __restrict__ cand_i, float* __restrict__ part_m,
                      float* __restrict__ part_s, int rows, int hd, int v, int k, int block_unk,
                      int chunk_cols) {
  constexpr int TM = kTkRows / 8;
  extern __shared__ __align__(128) float smem[];
  float* sL = smem;  // [32][128] logits tile
  float* sA = sL + kTkRows * kBN;
  float* sW = sA + kTkRows * kSA;
  const int chunk = blockIdx.x, nchunks = gridDim.x;
  const int r0 = blockIdx.y * kTkRows;
  const int nrows = min(kTkRows, rows - r0);
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int lane = tx, warp = ty;
  const int c_begin = chunk * chunk_cols;
  const int c_end = min(v, c_begin + chunk_cols);

  // per lane, per owned row: sorted top-K (slot kKMax stays -inf) and (m, s)
  float tv[kRowsPerWarp][kKMax + 1];
  int ti[kRowsPerWarp][kKMax + 1];
  float m[kRowsPerWarp], s[kRowsPerWarp];
#pragma unroll
  for (int q = 0; q < kRowsPerWarp; ++q) {
#pragma unroll
    for (int r = 0; r <= kKMax; ++r) {
      tv[q][r] = -INFINITY;
      ti[q][r] = 0x7fffffff;
    }
    m[q] = -INFINITY;
    s[q] = 0.0f;
  }

  float acc[TM][4];
  for (int col0 = c_begin; col0 < c_end; col0 += kBN) {
    const int nv = min(kBN, c_end - col0);
    zero_acc<TM>(acc);
    tile_gemm<T, T, TM>(acc, h + (size_t)r0 * hd, hd, nrows, hd, w, v, col0, kBN, 0, nv, sA, sW);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx * 4 + j;
        sL[(ty * TM + i) * kBN + c] = c < nv ? acc[i][j] + b[col0 + c] : 0.0f;
      }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kRowsPerWarp; ++q) {
      const int r = warp * kRowsPerWarp + q;
#pragma unroll
      for (int jj = 0; jj < kBN / 32; ++jj) {
        const int c = lane + 32 * jj;
        if (c >= nv) continue;
        const int col = col0 + c;
        float x = sL[r * kBN + c];
        const bool special = col == kPad || col == kBos || (block_unk && col == kUnk);
        if (special) {
          x = kMaskNeg;
        } else if (x > m[q]) {
          s[q] = s[q] * expf(m[q] - x) + 1.0f;
          m[q] = x;
        } else {
          s[q] += expf(x - m[q]);
        }
        float cv = x;
        int ci = col;
#pragma unroll
        for (int slot = 0; slot < kKMax; ++slot) {
          if (slot < k) {
            const bool swap = cv > tv[q][slot];  // strict: the incumbent keeps ties
            const float ov = tv[q][slot];
            const int oi = ti[q][slot];
            tv[q][slot] = swap ? cv : ov;
            ti[q][slot] = swap ? ci : oi;
            cv = swap ? ov : cv;
            ci = swap ? oi : ci;
          }
        }
      }
    }
    // the next tile_gemm starts with a barrier before sL is rewritten
  }

#pragma unroll
  for (int q = 0; q < kRowsPerWarp; ++q) {
    const int r = warp * kRowsPerWarp + q;
    const bool live = r < nrows;
    const size_t slot_base = ((size_t)(r0 + r) * nchunks + chunk) * k;
    for (int j = 0; j < k; ++j) {
      float bv = tv[q][0];
      int bi = ti[q][0];
      int bl = lane;
      warp_best(bv, bi, bl);
      if (lane == bl) {  // pop the winner's head
#pragma unroll
        for (int slot = 0; slot < kKMax; ++slot) {
          tv[q][slot] = tv[q][slot + 1];
          ti[q][slot] = ti[q][slot + 1];
        }
      }
      if (live && lane == 0) {
        cand_v[slot_base + j] = bv;
        cand_i[slot_base + j] = bi;
      }
    }
    const float mm = warp_max(m[q]);
    const float part = s[q] > 0.0f ? s[q] * expf(m[q] - mm) : 0.0f;
    const float ss = warp_sum(part);
    if (live && lane == 0) {
      part_m[(size_t)(r0 + r) * nchunks + chunk] = mm;
      part_s[(size_t)(r0 + r) * nchunks + chunk] = ss;
    }
  }
}

// one warp per row: merge nchunks * k candidates and the (m, s) partials
__global__ void __launch_bounds__(kThreads)
    topk_merge_kernel(const float* __restrict__ cand_v, const int* __restrict__ cand_i,
                      const float* __restrict__ part_m, const float* __restrict__ part_s,
                      float* __restrict__ vals, int* __restrict__ idx, float* __restrict__ lse,
                      int rows, int nchunks, int k) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;  // warp-uniform
  const int n = nchunks * k;
  const float* cv = cand_v + (size_t)row * n;
  const int* ci = cand_i + (size_t)row * n;
  // previous winner; a candidate is eligible iff the previous one ranks before it
  float pv = INFINITY;
  int pi = -1, pp = -1;
  for (int j = 0; j < k; ++j) {
    float bv = -INFINITY;
    int bi = 0x7fffffff, bp = 0x7fffffff;
    for (int p = lane; p < n; p += 32) {
      const float x = cv[p];
      const int xi = ci[p];
      if (ranks_before(pv, pi, pp, x, xi, p) && ranks_before(x, xi, p, bv, bi, bp)) {
        bv = x;
        bi = xi;
        bp = p;
      }
    }
    warp_best(bv, bi, bp);
    if (lane == 0) {
      vals[(size_t)row * k + j] = bv;
      idx[(size_t)row * k + j] = bi;
    }
    pv = bv;
    pi = bi;
    pp = bp;
  }
  float mx = -INFINITY;
  for (int c = lane; c < nchunks; c += 32) mx = fmaxf(mx, part_m[(size_t)row * nchunks + c]);
  mx = warp_max(mx);
  float z = 0.0f;
  for (int c = lane; c < nchunks; c += 32) {
    const float sc = part_s[(size_t)row * nchunks + c];
    if (sc > 0.0f) z += sc * expf(part_m[(size_t)row * nchunks + c] - mx);
  }
  z = warp_sum(z);
  if (lane == 0) lse[row] = mx + logf(z);
}

template <typename T>
cudaError_t launch_topk_tail(const void* h, const void* w, const float* b, float* cand_v,
                             int* cand_i, float* part_m, float* part_s, float* vals, int* idx,
                             float* lse, int rows, int hd, int v, int k, int block_unk,
                             int chunk_cols, cudaStream_t st) {
  const size_t smem = topk_chunk_smem_bytes();
  const int nchunks = (v + chunk_cols - 1) / chunk_cols;
  dim3 grid(nchunks, (rows + kTkRows - 1) / kTkRows);
  topk_chunk_kernel<T><<<grid, kThreads, smem, st>>>((const T*)h, (const T*)w, b, cand_v, cand_i,
                                                     part_m, part_s, rows, hd, v, k, block_unk,
                                                     chunk_cols);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_topk_merge(cand_v, cand_i, part_m, part_s, vals, idx, lse, rows, nchunks, k, st);
}

cudaError_t launch_topk_merge(const float* cand_v, const int* cand_i, const float* part_m,
                              const float* part_s, float* vals, int* idx, float* lse, int rows,
                              int nchunks, int k, cudaStream_t st) {
  const int rows_per_block = kThreads / 32;
  topk_merge_kernel<<<(rows + rows_per_block - 1) / rows_per_block, kThreads, 0, st>>>(
      cand_v, cand_i, part_m, part_s, vals, idx, lse, rows, nchunks, k);
  return cudaGetLastError();
}

}  // namespace cxg

// dtype: 0 = float32 operands, 1 = bfloat16 (h and w). b, cand_v, part_m,
// part_s, vals, lse f32; cand_i, idx int32. The scratch arrays hold
// rows x ceil(v / chunk_cols) (x k) entries; chunk_cols is a multiple of
// 128. k <= 8. Returns a cudaError_t (0 = launched).
extern "C" int cxg_topk_tail_fwd(int dtype, const void* h, const void* w, const void* b,
                                 void* cand_v, void* cand_i, void* part_m, void* part_s,
                                 void* vals, void* idx, void* lse, int rows, int hd, int v,
                                 int k, int block_unk, int chunk_cols, void* stream) {
  if (k < 1 || k > cxg::kKMax || chunk_cols % cxg::kBN) return (int)cudaErrorInvalidValue;
  auto run = [&](auto tag) -> cudaError_t {
    using T = decltype(tag);
    return cxg::launch_topk_tail<T>(h, w, (const float*)b, (float*)cand_v, (int*)cand_i,
                                    (float*)part_m, (float*)part_s, (float*)vals, (int*)idx,
                                    (float*)lse, rows, hd, v, k, block_unk, chunk_cols,
                                    (cudaStream_t)stream);
  };
  if (dtype == 0) return (int)run(float{});
  if (dtype == 1) return (int)run(__nv_bfloat16{});
  return (int)cudaErrorInvalidValue;
}
