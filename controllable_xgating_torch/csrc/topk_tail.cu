// Beam tail: vocab projection, special-token mask, per-row top-K and
// logsumexp, without ever writing the [R, V] logits; and the lanes beam
// step's whole selection and reorder on those candidates.
//
// Replaces the Pallas kernel controllable_xgating_tpu/ops/pallas/topk_tail.py
// (_make_kernel / _pallas_topk, wrappers _lane_topk and logits_topk_lanes):
//   logits = h @ w_out + b ; logits[PAD] = logits[BOS] = -1e30 (UNK too
//   when block_unk) ; vals, idx = top_k(logits, K) ; lse = logsumexp(logits)
// Ties go to the lower vocab index, as lax.top_k does. The beam step's
// selection (beam_select_kernel) replaces the reference's jnp code around
// that call in infer/beam.py's lanes step; it has no Pallas counterpart.
//
// What bounds it on the card: per beam step (R = 1280, Hd = 512,
// V = 10000) the projection is 13 GFLOP over a 10 MB bf16 weight, so it is
// bound by the tensor cores (13 us at the bf16 peak); unfused, the f32
// logits (51 MB) would be written, then read back by the mask, the
// log-softmax and the top-k. The step's selection and reorder move a few
// hundred KB (h and c of 1280 rows); launched as ~40 small torch kernels
// a step they cost more than the projection, so one launch does them.
//
// Design: a chunk kernel, one block per (row tile, vocab chunk), then one
// merge launch, on one stream.
//   bf16 policy, topk_chunk_wgmma_kernel: the chunk stage it shares with
//     K6 (topk.cuh's chunk_logits: 128 rows x 128 vocab columns a block on
//     hop::streamed_tile, h and w_out^T K-major through a 3-stage TMA
//     ring, two warpgroups of m64n128, the logits left in the
//     accumulator with the row's (max, sum-exp) over the chunk). Its own
//     selection: each thread keeps, for each of its 2 rows, a sorted
//     top-K by insertion, visiting its 32 columns in increasing id with a
//     strict > (the incumbent keeps ties, so the lower id wins); the row's
//     quad then merges its 4 lists on (value desc, index asc).
//   f32 policy, topk_chunk_kernel: the same contract on tile_gemm's SIMT
//     products (full f32, no TF32), one block per (32-row tile, 512-column
//     chunk); each warp owns 4 rows and each lane a top-K per row over the
//     columns lane mod 32 of a shared-memory logits tile, merged by warp
//     arg-max.
//   topk_merge_kernel, one warp per row (topk.cuh's merge_row): each lane
//     a sorted top-K of the candidates it reads, then K rounds of warp
//     arg-max on the lists' heads, and the log-sum-exp combine.
//   beam_select_kernel, one block per video over its K rows: merge_row per
//     row, then the beam step of ops/kernels/topk_tail.py's
//     lanes_select_plain in the same f32 operations and order, written
//     into the carry in place (see the kernel).
// Columns >= V (V = 10000 is ragged) are skipped. Masked specials enter
// the top-K lists at -1e30, as in the Pallas kernel, and are left out of
// the sum-exp, where they would add exp(-1e30 - m) = 0.
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

// bf16 policy, top-K: rows m0 .. m0 + 127 (blockIdx.y) x vocab columns
// [128 chunk, 128 chunk + 128) (chunk = blockIdx.x) through chunk_logits,
// then each thread's 2 rows' top-K by insertion and the quad merge.
template <int K>
__global__ void __launch_bounds__(kChunkThreads, 2)
    topk_chunk_wgmma_kernel(const __grid_constant__ CUtensorMap map_h,
                            const __grid_constant__ CUtensorMap map_w, const float* __restrict__ b,
                            float* __restrict__ cand_v, int* __restrict__ cand_i,
                            float* __restrict__ part_m, float* __restrict__ part_s, int rows,
                            int hd, int v, int block_unk) {
  const int chunk = blockIdx.x, nchunks = gridDim.x;
  const int m0 = blockIdx.y * kChunkRows, n0 = chunk * hop::kTileN;
  const int mw = m0 + (threadIdx.x / hop::kThreads) * hop::kTileM;
  const int lane = threadIdx.x & 31;
  float acc[64], m[2], s[2];
  chunk_logits(acc, m, s, &map_h, &map_w, b, m0, n0, hd, v, block_unk);

  // per owned row: a top-K sorted by (value desc, index asc); a thread
  // visits a row's columns in increasing id, so a value that only ties
  // the K-th stays out
  float tv[2][K];
  int ti[2][K];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int slot = 0; slot < K; ++slot) {
      tv[r][slot] = -INFINITY;
      ti[r][slot] = 0x7fffffff;
    }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int r = (i >> 1) & 1;
    if (acc[i] > tv[r][K - 1]) insert_sorted(tv[r], ti[r], acc[i], n0 + hop::acc_col(i));
  }

  // the quad's 4 lists of a row -> the row's top-K of the chunk
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = mw + hop::acc_row(2 * r);
    const bool out = (lane & 3) == 0 && row < rows;
    const size_t base = ((size_t)row * nchunks + chunk) * K;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      float bv = tv[r][0];
      int bi = ti[r][0], bl = lane;
      quad_best(bv, bi, bl);
      if (lane == bl) {  // pop the winner's head
#pragma unroll
        for (int slot = 0; slot + 1 < K; ++slot) {
          tv[r][slot] = tv[r][slot + 1];
          ti[r][slot] = ti[r][slot + 1];
        }
        tv[r][K - 1] = -INFINITY;
        ti[r][K - 1] = 0x7fffffff;
      }
      if (out) {
        cand_v[base + j] = bv;
        cand_i[base + j] = bi;
      }
    }
    if (out) {
      part_m[(size_t)row * nchunks + chunk] = m[r];
      part_s[(size_t)row * nchunks + chunk] = s[r];
    }
  }
}

// one warp per row: merge nchunks * K candidates and the (m, s) partials
template <int K>
__global__ void __launch_bounds__(kThreads)
    topk_merge_kernel(const float* __restrict__ cand_v, const int* __restrict__ cand_i,
                      const float* __restrict__ part_m, const float* __restrict__ part_s,
                      float* __restrict__ vals, int* __restrict__ idx, float* __restrict__ lse,
                      int rows, int nchunks) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;  // warp-uniform
  const size_t n = (size_t)nchunks * K;
  float v[K], l;
  int i[K];
  merge_row(cand_v + row * n, cand_i + row * n, part_m + (size_t)row * nchunks,
            part_s + (size_t)row * nchunks, nchunks, v, i, l);
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      vals[(size_t)row * K + j] = v[j];
      idx[(size_t)row * K + j] = i[j];
    }
    lse[row] = l;
  }
}

// A finished hypothesis's score: cum / ((5 + length) / 6) ** lp for lp > 0,
// in torch's f32 operations on the card (a division by a scalar is a
// product with its reciprocal; exponents 0.5, 2 and 3 are sqrt and
// products; powf otherwise).
__device__ __forceinline__ float final_score(float cum, long long len, float lp) {
  if (!(lp > 0.0f)) return cum;
  const float base = (5.0f + (float)len) * (1.0f / 6.0f);
  float d;
  if (lp == 0.5f) {
    d = sqrtf(base);
  } else if (lp == 2.0f) {
    d = base * base;
  } else if (lp == 3.0f) {
    d = base * base * base;
  } else {
    d = powf(base, lp);
  }
  return cum / d;
}

// The lanes beam step after the chunk kernel, one block (kThreads) per
// video b over its rows r0 = b k .. r0 + k - 1, on the carry [B, K] (cum
// f32, finished bool, lengths and tok int64), hist [B, K, max_len] and
// reg_tokens [B, max_len] int64, reg_score [B] f32, all written in place:
//   warp j < k: row r0 + j's top-k (vals, ids) and lse (merge_row); the
//     last warp's first k lanes meanwhile read the video's carry;
//   warp 0: each row's k candidates, cum + (vals - lse), or for a
//     finished row the PAD continuation (id PAD = 0) at cum + 0 and ids
//     1 .. k-1 at cum - 1e30; the k best of the k * k by (score desc,
//     flat index asc): scores, beam rows (flat / k) and words; lane i < k:
//     the new beam i from row src = beam[i]: emit (PAD where src had
//     finished, else the word), finished (src's, or the word is EOS),
//     length (+1 unless src had finished), and the final score of a beam
//     that finishes now (-1e30 otherwise); lane 0: the best of those
//     (first of equals) replaces the register where it scores above it;
//   every thread: the history's columns (each thread owns whole columns,
//     so it reads a column's k rows before it writes them), column t set
//     to emit, the register's tokens from the best new beam; h and c of
//     the new beams gathered from h_new and c_new.
// Every value of the carry is read before the barrier that precedes its
// write.
template <int K>
__global__ void __launch_bounds__(kThreads)
    beam_select_kernel(const float* __restrict__ cand_v, const int* __restrict__ cand_i,
                       const float* __restrict__ part_m, const float* __restrict__ part_s,
                       int nchunks, const float* __restrict__ h_new,
                       const float* __restrict__ c_new, float* __restrict__ h_out,
                       float* __restrict__ c_out, int hidden, float* cum, bool* finished,
                       long long* lengths, long long* tok, long long* hist, float* reg_score,
                       long long* reg_tokens, int max_len, int t, float length_penalty) {
  constexpr int N = K * K;  // a video's candidates, at most 64: two a lane of warp 0
  __shared__ float row_v[N], row_lse[K], cum_old[K], top[K];
  __shared__ int row_i[N], src[K], word[K];
  __shared__ long long len_old[K], emit[K], len_new[K];
  __shared__ bool fin_old[K], fin_new[K];
  __shared__ int best, improve;
  const int vid = blockIdx.x, r0 = vid * K;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == kThreads / 32 - 1 && lane < K) {
    cum_old[lane] = cum[r0 + lane];
    fin_old[lane] = finished[r0 + lane];
    len_old[lane] = lengths[r0 + lane];
  }
  if (warp < K) {
    const int row = r0 + warp;
    const size_t n = (size_t)nchunks * K;
    float vals[K], lse;
    int idx[K];
    merge_row(cand_v + row * n, cand_i + row * n, part_m + (size_t)row * nchunks,
              part_s + (size_t)row * nchunks, nchunks, vals, idx, lse);
    if (lane == 0) {
#pragma unroll
      for (int s = 0; s < K; ++s) {
        row_v[warp * K + s] = vals[s];
        row_i[warp * K + s] = idx[s];
      }
      row_lse[warp] = lse;
    }
  }
  __syncthreads();
  if (warp == 0) {
    // lane p holds candidates p and p + 32: (row p / K, slot p % K)
    float x[2];
    int xi[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = lane + 32 * h, r = p / K, slot = p - r * K;
      x[h] = -INFINITY;
      xi[h] = 0;
      if (p < N) {
        x[h] = cum_old[r] +
               (fin_old[r] ? (slot == 0 ? 0.0f : kMaskNeg) : row_v[p] - row_lse[r]);
        xi[h] = fin_old[r] ? slot : row_i[p];
      }
    }
    float pv = INFINITY;
    int pp = -1;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      float bv = -INFINITY;
      int bp = 0x7fffffff;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = lane + 32 * h;
        if (p < N && ranks_before(pv, pp, 0, x[h], p, 0) &&
            ranks_before(x[h], p, 0, bv, bp, 0)) {
          bv = x[h];
          bp = p;
        }
      }
      int bl = lane;
      warp_best(bv, bp, bl);
      if (lane == bl) {
        top[j] = bv;
        src[j] = bp / K;
        word[j] = bp < 32 ? xi[0] : xi[1];
      }
      pv = bv;
      pp = bp;
    }
    __syncwarp();
    float score = -INFINITY;  // lanes >= K: never the best
    int bi = 0x7fffffff, bl = lane;
    if (lane < K) {
      const int from = src[lane];
      const bool fin_g = fin_old[from];
      const long long len_g = len_old[from], w = word[lane];
      const bool now = fin_g || w == kEos;
      const long long len = fin_g ? len_g : len_g + 1;
      emit[lane] = fin_g ? kPad : w;
      len_new[lane] = len;
      fin_new[lane] = now;
      score = now && !fin_g ? final_score(top[lane], len, length_penalty) : kMaskNeg;
      bi = lane;
    }
    warp_best(score, bi, bl);  // the best new beam's score, the first of equals
    if (lane == 0) {
      const bool up = score > reg_score[vid];
      if (up) reg_score[vid] = score;
      best = bi;
      improve = up;
    }
  }
  __syncthreads();
  if (threadIdx.x < K) {
    const int i = threadIdx.x;
    cum[r0 + i] = top[i];
    finished[r0 + i] = fin_new[i];
    lengths[r0 + i] = len_new[i];
    tok[r0 + i] = emit[i];
  }
  for (int col = threadIdx.x; col < max_len; col += blockDim.x) {
    long long old[K];
#pragma unroll
    for (int s = 0; s < K; ++s) old[s] = hist[(size_t)(r0 + s) * max_len + col];
    long long kept = 0;
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const int from = src[i];
      long long x = old[0];
#pragma unroll
      for (int s = 1; s < K; ++s) x = from == s ? old[s] : x;
      if (col == t) x = emit[i];
      hist[(size_t)(r0 + i) * max_len + col] = x;
      if (i == best) kept = x;
    }
    if (improve) reg_tokens[(size_t)vid * max_len + col] = kept;
  }
  if ((hidden & 3) == 0) {
    const int h4 = hidden / 4;
#pragma unroll 4
    for (int e = threadIdx.x; e < K * h4; e += blockDim.x) {
      const int i = e / h4, j = e - i * h4;
      const size_t from = (size_t)(r0 + src[i]) * h4 + j, to = (size_t)(r0 + i) * h4 + j;
      reinterpret_cast<float4*>(h_out)[to] = reinterpret_cast<const float4*>(h_new)[from];
      reinterpret_cast<float4*>(c_out)[to] = reinterpret_cast<const float4*>(c_new)[from];
    }
  } else {
    for (int e = threadIdx.x; e < K * hidden; e += blockDim.x) {
      const int i = e / hidden, j = e - i * hidden;
      const size_t from = (size_t)(r0 + src[i]) * hidden + j, to = (size_t)(r0 + i) * hidden + j;
      h_out[to] = h_new[from];
      c_out[to] = c_new[from];
    }
  }
}

cudaError_t launch_topk_tail_f32(const float* h, const float* w, const float* b, float* cand_v,
                                 int* cand_i, float* part_m, float* part_s, int rows, int hd,
                                 int v, int k, int block_unk, int chunk_cols, int nchunks,
                                 cudaStream_t st) {
  dim3 grid(nchunks, (rows + kTkRows - 1) / kTkRows);
  topk_chunk_kernel<float><<<grid, kThreads, topk_chunk_smem_bytes(), st>>>(
      h, w, b, cand_v, cand_i, part_m, part_s, rows, hd, v, k, block_unk, chunk_cols);
  return cudaGetLastError();
}

cudaError_t launch_topk_tail_bf16(const void* h, const void* w_t, const float* b, float* cand_v,
                                  int* cand_i, float* part_m, float* part_s, int rows, int hd,
                                  int v, int k, int block_unk, int nchunks, cudaStream_t st) {
  CUtensorMap map_h, map_w;
  cudaError_t err = hop::make_tmap(&map_h, h, rows, hd, hd, kChunkRows);
  if (err == cudaSuccess) err = hop::make_tmap(&map_w, w_t, v, hd, hd, hop::kTileN);
  if (err != cudaSuccess) return err;
  const int smem = (int)hop::streamed_smem_bytes(kChunkStages, kChunkWgs);
  const dim3 grid(nchunks, (rows + kChunkRows - 1) / kChunkRows);
  auto launch = [&](auto kc) -> cudaError_t {  // one instantiation per K
    constexpr int K = decltype(kc)::value;
    static hop::SmemLimits smem_set;
    const cudaError_t e = hop::allow_smem(topk_chunk_wgmma_kernel<K>, smem, smem_set);
    if (e != cudaSuccess) return e;
    topk_chunk_wgmma_kernel<K><<<grid, kChunkThreads, smem, st>>>(
        map_h, map_w, b, cand_v, cand_i, part_m, part_s, rows, hd, v, block_unk);
    return cudaGetLastError();
  };
  return with_k(k, launch);
}

cudaError_t launch_topk_merge(const float* cand_v, const int* cand_i, const float* part_m,
                              const float* part_s, float* vals, int* idx, float* lse, int rows,
                              int nchunks, int k, cudaStream_t st) {
  const int rows_per_block = kThreads / 32;
  return with_k(k, [&](auto kc) {
    topk_merge_kernel<decltype(kc)::value>
        <<<(rows + rows_per_block - 1) / rows_per_block, kThreads, 0, st>>>(
            cand_v, cand_i, part_m, part_s, vals, idx, lse, rows, nchunks);
    return cudaGetLastError();
  });
}

// The chunk kernel of the policy: dtype 0 f32 (chunk_cols a multiple of
// 128), dtype 1 bf16 (chunk_cols 128). Returns the chunks in *nchunks.
cudaError_t launch_topk_chunks(int dtype, const void* h, const void* w, const float* b,
                               float* cand_v, int* cand_i, float* part_m, float* part_s, int rows,
                               int hd, int v, int k, int block_unk, int chunk_cols, int* nchunks,
                               cudaStream_t st) {
  if (k < 1 || k > kKMax || dtype < 0 || dtype > 1 || chunk_cols < kBN || chunk_cols % kBN ||
      (dtype == 1 && chunk_cols != hop::kTileN))
    return cudaErrorInvalidValue;
  *nchunks = (v + chunk_cols - 1) / chunk_cols;
  return dtype == 0 ? launch_topk_tail_f32((const float*)h, (const float*)w, b, cand_v, cand_i,
                                           part_m, part_s, rows, hd, v, k, block_unk, chunk_cols,
                                           *nchunks, st)
                    : launch_topk_tail_bf16(h, w, b, cand_v, cand_i, part_m, part_s, rows, hd, v,
                                            k, block_unk, *nchunks, st);
}

}  // namespace cxg

// dtype 0: h [rows, hd] and w = w_out [hd, v], float32, chunk_cols a
// multiple of 128; dtype 1: h [rows, hd] and w = w_out^T [v, hd],
// bfloat16, hd % 8 == 0, chunk_cols == 128. b, cand_v, part_m, part_s,
// vals, lse f32; cand_i, idx int32. The scratch arrays hold
// rows x ceil(v / chunk_cols) (x k) entries. k <= 8. Returns a cudaError_t
// (0 = launched).
extern "C" int cxg_topk_tail_fwd(int dtype, const void* h, const void* w, const void* b,
                                 void* cand_v, void* cand_i, void* part_m, void* part_s,
                                 void* vals, void* idx, void* lse, int rows, int hd, int v,
                                 int k, int block_unk, int chunk_cols, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  int nchunks = 0;
  cudaError_t err = cxg::launch_topk_chunks(dtype, h, w, (const float*)b, (float*)cand_v,
                                            (int*)cand_i, (float*)part_m, (float*)part_s, rows,
                                            hd, v, k, block_unk, chunk_cols, &nchunks, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cxg::launch_topk_merge((const float*)cand_v, (const int*)cand_i,
                                     (const float*)part_m, (const float*)part_s, (float*)vals,
                                     (int*)idx, (float*)lse, rows, nchunks, k, st);
}

// The lanes beam step: the chunk kernel as cxg_topk_tail_fwd's (same
// operands; rows = videos x k), then beam_select_kernel on the beam's
// carry, written in place: h_new, c_new [rows, hidden] f32 (the step's
// new state, read) -> h_out, c_out [rows, hidden] f32; cum [videos, k]
// f32, finished [videos, k] bool, lengths and tok [videos, k] int64, hist
// [videos, k, max_len] int64, reg_score [videos] f32, reg_tokens [videos,
// max_len] int64; t < max_len the step. Returns a cudaError_t.
extern "C" int cxg_topk_tail_beam(int dtype, const void* h, const void* w, const void* b,
                                  void* cand_v, void* cand_i, void* part_m, void* part_s,
                                  int rows, int hd, int v, int k, int block_unk, int chunk_cols,
                                  const void* h_new, const void* c_new, void* h_out, void* c_out,
                                  int hidden, void* cum, void* finished, void* lengths, void* tok,
                                  void* hist, void* reg_score, void* reg_tokens, int max_len,
                                  int t, float length_penalty, void* stream) {
  if (k < 1 || rows % k || t < 0 || t >= max_len) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  int nchunks = 0;
  cudaError_t err = cxg::launch_topk_chunks(dtype, h, w, (const float*)b, (float*)cand_v,
                                            (int*)cand_i, (float*)part_m, (float*)part_s, rows,
                                            hd, v, k, block_unk, chunk_cols, &nchunks, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cxg::with_k(k, [&](auto kc) {
    cxg::beam_select_kernel<decltype(kc)::value><<<rows / k, cxg::kThreads, 0, st>>>(
        (const float*)cand_v, (const int*)cand_i, (const float*)part_m, (const float*)part_s,
        nchunks, (const float*)h_new, (const float*)c_new, (float*)h_out, (float*)c_out, hidden,
        (float*)cum, (bool*)finished, (long long*)lengths, (long long*)tok, (long long*)hist,
        (float*)reg_score, (long long*)reg_tokens, max_len, t, length_penalty);
    return cudaGetLastError();
  });
}

// the bf16 chunk kernel's dynamic shared memory (the ring; any hd)
extern "C" long cxg_topk_wgmma_smem_bytes(int hd) {
  (void)hd;
  return (long)cxg::hop::streamed_smem_bytes(cxg::kChunkStages, cxg::kChunkWgs);
}
