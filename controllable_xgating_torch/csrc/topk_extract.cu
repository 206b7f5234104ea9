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
// The Pallas kernel walks the vocab in tiles on one core and carries its
// running top-k and (max, sum-exp) from tile to tile in scratch; it picks
// by k passes of arg-max, where topk_tail.cu's lanes insert into sorted
// lists. Here blocks run in no order, so each block owns one (row tile,
// vocab chunk), writes the chunk's k candidates and (max, sum-exp) partial
// per row, and the beam tail's merge kernel (topk_tail.cu) combines the
// chunks.
//
// bf16 policy, topk_extract_wgmma_kernel: a chunk is 128 vocab columns of
// a 128-row tile of hopper_gemm.cuh's streamed_tile (h [R, Hd] and
// w_out^T [V, Hd], both K-major, through a 3-stage TMA ring into wgmma
// m64n128; two warpgroups of 64 rows share each w tile). The chunk's
// logits are the accumulator itself: each row's 128 columns lie in one
// quad of 4 lanes, 32 registers each. The epilogue selects by k rounds of
// extraction on those registers: in each round a thread takes the best
// eligible value of its 32 with selects on predicates combined bitwise
// (short-circuit && / || compiled to a branch an element and made each
// round ~5x dearer on an H100), a value being eligible while the previous
// round's winner ranks before it, so nothing is rewritten; two quad
// shuffles then find the row's winner on (value desc, index asc). One pass
// before the rounds gives the (max, sum-exp) partial.
//
// f32 policy (full f32 on SIMT, no TF32), topk_extract_kernel: one
// 256-thread block per (32-row, 1024-column) chunk computes the chunk's
// logits 128 columns at a time through tile_gemm and keeps all of them in
// shared memory (128 KB); each warp then takes 4 rows: an online (max,
// sum-exp) over each lane's columns and k rounds of warp arg-max
// extraction, under the same eligibility rule.
#include "hopper_gemm.cuh"

#include <type_traits>
#include "topk.cuh"

namespace cxg {

constexpr int kTxRows = 32;  // TM = 4
constexpr int kTxRowsPerWarp = kTxRows / 8;

inline size_t topk_extract_smem_bytes(int chunk_cols) {
  return (size_t)(kTxRows * chunk_cols + gemm_smem_floats<kTxRows / 8>()) * sizeof(float);
}

__global__ void __launch_bounds__(kThreads)
    topk_extract_kernel(const float* __restrict__ h, const float* __restrict__ w,
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
    tile_gemm<float, float, TM>(acc, h + (size_t)r0 * hd, hd, nrows, hd, w, v, c_begin + t0, kBN,
                                0, nv, sA, sW);
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

constexpr int kTxWgs = 2;     // warpgroups a block: 128 rows x 128 columns
constexpr int kTxStages = 3;  // 97 KB: two blocks an SM
constexpr int kTxRowsPerBlock = kTxWgs * hop::kTileM;

// bf16 policy: h [rows, hd] and w_t = w_out^T [v, hd] through TMA
// descriptors (hd % 8 == 0); chunk = blockIdx.x covers vocab columns
// [128 chunk, 128 chunk + 128), warpgroup wg rows m0 + 64 wg .. + 63.
template <int K>
__global__ void __launch_bounds__(kTxWgs * hop::kThreads)
    topk_extract_wgmma_kernel(const __grid_constant__ CUtensorMap map_h,
                              const __grid_constant__ CUtensorMap map_w,
                              const float* __restrict__ b, float* __restrict__ cand_v,
                              int* __restrict__ cand_i, float* __restrict__ part_m,
                              float* __restrict__ part_s, int rows, int hd, int v) {
  const int chunk = blockIdx.x, nchunks = gridDim.x;
  const int m0 = blockIdx.y * kTxRowsPerBlock, n0 = chunk * hop::kTileN;
  const int mw = m0 + (threadIdx.x / hop::kThreads) * hop::kTileM;
  float acc[64];
  hop::streamed_tile<kTxStages, kTxWgs>(acc, &map_h, &map_w, m0, n0, hd, false);

  // the logits in place: -1e30 at the specials, -inf past the vocab (never
  // a winner while a real column is left); the row maxima without specials
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int col = n0 + hop::acc_col(i);
    float x = -INFINITY;
    if (col < v) {
      const bool special = col == kPad || col == kBos;
      x = special ? kMaskNeg : acc[i] + b[col];
      if (!special) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
    }
    acc[i] = x;
  }
  // (max, sum-exp) of each row over the chunk: quad max, then one pass
  float m[2], s[2] = {0.0f, 0.0f};
#pragma unroll
  for (int r = 0; r < 2; ++r) m[r] = quad_max(mx[r]);
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int r = (i >> 1) & 1, col = n0 + hop::acc_col(i);
    if (col != kPad && col != kBos && m[r] > -INFINITY) s[r] += expf(acc[i] - m[r]);
  }

  // K rounds of extraction: the best eligible (value desc, column asc) of
  // each row; a thread visits a row's columns in ascending order, so a
  // strict > keeps the lower column of two equal values
  float pv[2] = {INFINITY, INFINITY};
  int pi[2] = {-1, -1};
  const int lane = threadIdx.x & 31;
#pragma unroll 1
  for (int j = 0; j < K; ++j) {
    float bv[2] = {-INFINITY, -INFINITY};
    int bi[2] = {0x7fffffff, 0x7fffffff};
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int r = (i >> 1) & 1, col = n0 + hop::acc_col(i);
      const float x = acc[i];
      const bool take = ((x < pv[r]) | ((x == pv[r]) & (col > pi[r]))) & (x > bv[r]);
      bv[r] = take ? x : bv[r];
      bi[r] = take ? col : bi[r];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      int bl = lane;
      quad_best(bv[r], bi[r], bl);
      pv[r] = bv[r];
      pi[r] = bi[r];
      const int row = mw + hop::acc_row(2 * r);
      if ((lane & 3) == 0 && row < rows) {
        const size_t slot = ((size_t)row * nchunks + chunk) * K + j;
        cand_v[slot] = bv[r];
        cand_i[slot] = bi[r];
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    s[r] += __shfl_xor_sync(kFull, s[r], 1);
    s[r] += __shfl_xor_sync(kFull, s[r], 2);
    const int row = mw + hop::acc_row(2 * r);
    if ((lane & 3) == 0 && row < rows) {
      part_m[(size_t)row * nchunks + chunk] = m[r];
      part_s[(size_t)row * nchunks + chunk] = s[r];
    }
  }
}

cudaError_t launch_topk_extract_f32(const float* h, const float* w, const float* b, float* cand_v,
                                    int* cand_i, float* part_m, float* part_s, int rows, int hd,
                                    int v, int k, int chunk_cols, int nchunks, cudaStream_t st) {
  const size_t smem = topk_extract_smem_bytes(chunk_cols);
  const cudaError_t err = cudaFuncSetAttribute(
      topk_extract_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(nchunks, (rows + kTxRows - 1) / kTxRows);
  topk_extract_kernel<<<grid, kThreads, smem, st>>>(h, w, b, cand_v, cand_i, part_m, part_s, rows,
                                                    hd, v, k, chunk_cols);
  return cudaGetLastError();
}

cudaError_t launch_topk_extract_bf16(const void* h, const void* w_t, const float* b,
                                     float* cand_v, int* cand_i, float* part_m, float* part_s,
                                     int rows, int hd, int v, int k, int nchunks,
                                     cudaStream_t st) {
  CUtensorMap map_h, map_w;
  cudaError_t err = hop::make_tmap(&map_h, h, rows, hd, hd, kTxRowsPerBlock);
  if (err == cudaSuccess) err = hop::make_tmap(&map_w, w_t, v, hd, hd, hop::kTileN);
  if (err != cudaSuccess) return err;
  const int smem = (int)hop::streamed_smem_bytes(kTxStages, kTxWgs);
  const dim3 grid(nchunks, (rows + kTxRowsPerBlock - 1) / kTxRowsPerBlock);
  auto launch = [&](auto kc) -> cudaError_t {  // one instantiation per K
    constexpr int K = decltype(kc)::value;
    static hop::SmemLimits smem_set;
    const cudaError_t e = hop::allow_smem(topk_extract_wgmma_kernel<K>, smem, smem_set);
    if (e != cudaSuccess) return e;
    topk_extract_wgmma_kernel<K><<<grid, kTxWgs * hop::kThreads, smem, st>>>(
        map_h, map_w, b, cand_v, cand_i, part_m, part_s, rows, hd, v);
    return cudaGetLastError();
  };
  using std::integral_constant;
  switch (k) {
    case 1: return launch(integral_constant<int, 1>{});
    case 2: return launch(integral_constant<int, 2>{});
    case 3: return launch(integral_constant<int, 3>{});
    case 4: return launch(integral_constant<int, 4>{});
    case 5: return launch(integral_constant<int, 5>{});
    case 6: return launch(integral_constant<int, 6>{});
    case 7: return launch(integral_constant<int, 7>{});
    case 8: return launch(integral_constant<int, 8>{});
  }
  return cudaErrorInvalidValue;
}

}  // namespace cxg

// dtype 0: h [rows, hd] and w = w_out [hd, v], float32, chunk_cols a
// multiple of 128; dtype 1: h [rows, hd] and w = w_out^T [v, hd],
// bfloat16, hd % 8 == 0, chunk_cols == 128. b, cand_v, part_m, part_s,
// vals, lse f32; cand_i, idx int32. The scratch arrays hold
// rows x ceil(v / chunk_cols) (x k) entries. k <= 8. Returns a cudaError_t
// (0 = launched).
extern "C" int cxg_topk_extract_fwd(int dtype, const void* h, const void* w, const void* b,
                                    void* cand_v, void* cand_i, void* part_m, void* part_s,
                                    void* vals, void* idx, void* lse, int rows, int hd, int v,
                                    int k, int chunk_cols, void* stream) {
  if (k < 1 || k > cxg::kKMax || chunk_cols < cxg::kBN || chunk_cols % cxg::kBN ||
      (dtype == 1 && chunk_cols != cxg::hop::kTileN) || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  const int nchunks = (v + chunk_cols - 1) / chunk_cols;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err =
      dtype == 0
          ? cxg::launch_topk_extract_f32((const float*)h, (const float*)w, (const float*)b,
                                         (float*)cand_v, (int*)cand_i, (float*)part_m,
                                         (float*)part_s, rows, hd, v, k, chunk_cols, nchunks, st)
          : cxg::launch_topk_extract_bf16(h, w, (const float*)b, (float*)cand_v, (int*)cand_i,
                                          (float*)part_m, (float*)part_s, rows, hd, v, k,
                                          nchunks, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cxg::launch_topk_merge((const float*)cand_v, (const int*)cand_i,
                                     (const float*)part_m, (const float*)part_s, (float*)vals,
                                     (int*)idx, (float*)lse, rows, nchunks, k, st);
}

extern "C" long cxg_topk_extract_smem_bytes(int chunk_cols) {
  return (long)cxg::topk_extract_smem_bytes(chunk_cols);
}
