// Vocab projection, PAD/BOS mask, per-row top-k by iterative arg-max
// extraction, and logsumexp, without writing the [R, V] logits.
//
// Replaces the Pallas kernel experiments/pallas_logits_topk.py
// (_make_kernel, line 50, called from _logits_topk and logits_topk_pallas):
//   logits = h @ w + b ; logits[PAD] = logits[BOS] = -1e30
//   vals, idx = top_k(logits, k) ; lse = logsumexp(logits)
// h and w in the compute dtype, sums in f32; ties go to the lower vocab
// index, as lax.top_k does. The masked specials stay candidates at -1e30
// and add exp(-1e30 - m) = 0 to the sum, so they are left out of it.
//
// What bounds it on the card: operations, as for the beam tail
// (topk_tail.cu): at R = 1280, Hd = 512, V = 10000 the projection is
// 13.1 GFLOP over a 10 MB bf16 weight (0.013 ms on the bf16 tensor cores).
//
// Design, the TPU kernel's algorithm recast for blocks that run in no
// order: the Pallas kernel walks the vocab in tiles on one core and carries
// its running top-k and (max, sum-exp) from tile to tile in scratch. Here
// one 256-thread block owns a (32-row, chunk_cols-column) tile: it
// computes the chunk's logits 128 columns at a time through tile_gemm and
// keeps all of them, f32, in shared memory (32 x 1024 x 4 B = 128 KB at
// the default width, with tile_gemm's 20 KB of stages). Each warp then
// takes 4 rows: an online (max, sum-exp) over each lane's columns, merged
// by warp shuffles, and k rounds of arg-max extraction on (value desc,
// index asc), where a column is eligible once the previous round's winner
// ranks before it (nothing is written back, so the logits stay intact).
// That is the Pallas kernel's own selection, k passes of arg-max, and
// what sets this kernel apart from topk_tail.cu, whose lanes keep sorted
// top-K lists by insertion. The chunks' k candidates and (max, sum-exp)
// partials then go through the beam tail's merge kernel.
#include "topk.cuh"

namespace cxg {

constexpr int kTxRows = 32;  // TM = 4
constexpr int kTxRowsPerWarp = kTxRows / 8;

inline size_t topk_extract_smem_bytes(int chunk_cols) {
  return (size_t)(kTxRows * chunk_cols + gemm_smem_floats<kTxRows / 8>()) * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    topk_extract_kernel(const T* __restrict__ h, const T* __restrict__ w,
                        const float* __restrict__ b, float* __restrict__ cand_v,
                        int* __restrict__ cand_i, float* __restrict__ part_m,
                        float* __restrict__ part_s, int rows, int hd, int v, int k,
                        int chunk_cols) {
  constexpr int TM = kTxRows / 8;
  extern __shared__ __align__(128) float smem[];
  float* sL = smem;  // [32][chunk_cols] the chunk's logits
  float* sA = sL + kTxRows * chunk_cols;
  float* sW = sA + kTxRows * kSA;
  const int chunk = blockIdx.x, nchunks = gridDim.x;
  const int r0 = blockIdx.y * kTxRows;
  const int nrows = min(kTxRows, rows - r0);
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int lane = tx, warp = ty;
  const int c_begin = chunk * chunk_cols;
  const int width = min(chunk_cols, v - c_begin);

  float acc[TM][4];
  for (int t0 = 0; t0 < width; t0 += kBN) {
    const int nv = min(kBN, width - t0);
    zero_acc<TM>(acc);
    tile_gemm<T, T, TM>(acc, h + (size_t)r0 * hd, hd, nrows, hd, w, v, c_begin + t0, kBN, 0,
                        nv, sA, sW);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx * 4 + j;
        if (c >= nv) continue;
        const int col = c_begin + t0 + c;
        const bool special = col == kPad || col == kBos;
        sL[(ty * TM + i) * chunk_cols + t0 + c] = special ? kMaskNeg : acc[i][j] + b[col];
      }
  }
  __syncthreads();

  for (int q = 0; q < kTxRowsPerWarp; ++q) {
    const int r = warp * kTxRowsPerWarp + q;
    const float* row = sL + r * chunk_cols;
    const bool live = r < nrows;
    const size_t slot = (size_t)(r0 + r) * nchunks + chunk;
    float m = -INFINITY, s = 0.0f;
    for (int c = lane; c < width; c += 32) {
      const int col = c_begin + c;
      if (col == kPad || col == kBos) continue;
      const float x = row[c];
      if (x > m) {
        s = s * expf(m - x) + 1.0f;
        m = x;
      } else {
        s += expf(x - m);
      }
    }
    const float mx = warp_max(m);
    const float ss = warp_sum(s > 0.0f ? s * expf(m - mx) : 0.0f);
    if (live && lane == 0) {
      part_m[slot] = mx;
      part_s[slot] = ss;
    }
    float pv = INFINITY;
    int pi = -1;
    for (int j = 0; j < k; ++j) {
      float bv = -INFINITY;
      int bi = 0x7fffffff, bl = 0;
      for (int c = lane; c < width; c += 32) {
        const float x = row[c];
        const int col = c_begin + c;
        if (ranks_before(pv, pi, 0, x, col, 0) && ranks_before(x, col, 0, bv, bi, 0)) {
          bv = x;
          bi = col;
        }
      }
      warp_best(bv, bi, bl);
      if (live && lane == 0) {
        cand_v[slot * k + j] = bv;
        cand_i[slot * k + j] = bi;
      }
      pv = bv;
      pi = bi;
    }
  }
}

template <typename T>
cudaError_t launch_topk_extract(const void* h, const void* w, const float* b, float* cand_v,
                                int* cand_i, float* part_m, float* part_s, float* vals,
                                int* idx, float* lse, int rows, int hd, int v, int k,
                                int chunk_cols, cudaStream_t st) {
  const size_t smem = topk_extract_smem_bytes(chunk_cols);
  cudaError_t err = cudaFuncSetAttribute(topk_extract_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int nchunks = (v + chunk_cols - 1) / chunk_cols;
  dim3 grid(nchunks, (rows + kTxRows - 1) / kTxRows);
  topk_extract_kernel<T><<<grid, kThreads, smem, st>>>((const T*)h, (const T*)w, b, cand_v,
                                                       cand_i, part_m, part_s, rows, hd, v, k,
                                                       chunk_cols);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_topk_merge(cand_v, cand_i, part_m, part_s, vals, idx, lse, rows, nchunks, k, st);
}

}  // namespace cxg

// dtype: 0 = float32 operands, 1 = bfloat16 (h and w). b, cand_v, part_m,
// part_s, vals, lse f32; cand_i, idx int32. The scratch arrays hold
// rows x ceil(v / chunk_cols) (x k) entries; chunk_cols is a multiple of
// 128. k <= 8. Returns a cudaError_t (0 = launched).
extern "C" int cxg_topk_extract_fwd(int dtype, const void* h, const void* w, const void* b,
                                    void* cand_v, void* cand_i, void* part_m, void* part_s,
                                    void* vals, void* idx, void* lse, int rows, int hd, int v,
                                    int k, int chunk_cols, void* stream) {
  if (k < 1 || k > cxg::kKMax || chunk_cols < cxg::kBN || chunk_cols % cxg::kBN)
    return (int)cudaErrorInvalidValue;
  auto run = [&](auto tag) -> cudaError_t {
    using T = decltype(tag);
    return cxg::launch_topk_extract<T>(h, w, (const float*)b, (float*)cand_v, (int*)cand_i,
                                       (float*)part_m, (float*)part_s, (float*)vals, (int*)idx,
                                       (float*)lse, rows, hd, v, k, chunk_cols,
                                       (cudaStream_t)stream);
  };
  if (dtype == 0) return (int)run(float{});
  if (dtype == 1) return (int)run(__nv_bfloat16{});
  return (int)cudaErrorInvalidValue;
}

extern "C" long cxg_topk_extract_smem_bytes(int chunk_cols) {
  return (long)cxg::topk_extract_smem_bytes(chunk_cols);
}
