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
// bound by the tensor cores (13 us at the bf16 peak); unfused, the f32
// logits (51 MB) would be written, then read back by the mask, the
// log-softmax and the top-k.
//
// Design: a chunk kernel, one block per (64-row tile, CHUNK_COLS-column
// vocab chunk), then a merge kernel, on one stream.
//   bf16 policy, topk_chunk_wgmma_kernel (two warpgroups): the row tile
//     of h stays resident in shared memory (64 x Hd bf16, 64 KB at
//     Hd = 512); the chunk's columns of w_out, stored K-major ([V, Hd],
//     transposed once per caption call), stream through a 3-stage TMA
//     ring in [128, 64] tiles, and each warpgroup multiplies 64 of a
//     tile's columns with wgmma m64n64k16 (hopper_gemm.cuh); 113 KB of
//     shared memory, so two blocks share an SM. The epilogue works on the
//     accumulator registers, no logits tile: each thread owns 2 rows x 16
//     columns of every tile and keeps, per row, an online (max, sum-exp)
//     and a sorted top-K by insertion, visiting its columns in increasing
//     id with a strict > (the incumbent keeps ties, so the lower id wins);
//     a value below the largest K-th value of the 4 lists of its row's
//     quad is skipped, as it cannot win. At the chunk's end each quad
//     merges its 4 lists on (value desc, index asc), and one thread per
//     row merges the two warpgroups' lists through shared memory.
//   f32 policy, topk_chunk_kernel: the same contract on tile_gemm's SIMT
//     products (full f32, no TF32), one block per (32-row tile, chunk);
//     each warp owns 4 rows and each lane a top-K per row over the columns
//     lane mod 32 of a shared-memory logits tile, merged by warp arg-max.
//   topk_merge_kernel, one warp per row: K rounds of arg-max over the
//     chunks' candidates on the same order, and the log-sum-exp combine.
// Columns >= V (V = 10000 is ragged) are skipped. Masked specials enter
// the top-K lists at -1e30, as in the Pallas kernel, and are left out of
// the sum-exp, where they would add exp(-1e30 - m) = 0.
#include "hopper_gemm.cuh"

#include <type_traits>
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

constexpr int kTkStages = 3;  // ring of [128, 64] w tiles
constexpr int kTkWgs = 2;     // consumer warpgroups, each on 64 columns of a 128-column tile
constexpr int kTkThreads = kTkWgs * hop::kThreads;
constexpr int kTkCols = hop::kTileN / kTkWgs;

__host__ __device__ inline int topk_wgmma_tile_bytes(int hd) {
  const int nk = (hd + hop::kTileK - 1) / hop::kTileK;
  return nk * hop::kATileBytes + kTkStages * hop::kBTileBytes;
}

inline size_t topk_wgmma_smem_bytes(int hd) {
  return hop::smem_request(topk_wgmma_tile_bytes(hd));
}

// bf16 policy, top-K: h [rows, hd] and w_t = w_out^T [v, hd], both
// K-major, read through TMA descriptors (hd % 8 == 0); chunk_cols % 128
// == 0. Two warpgroups share h's resident row tile and every w tile of
// the ring, each multiplying 64 of its 128 columns (m64n64k16), so that
// an SM holds two blocks: 16 warps to hide the epilogue's latency.
template <int K>
__global__ void __launch_bounds__(kTkThreads, 2)
    topk_chunk_wgmma_kernel(const __grid_constant__ CUtensorMap map_h,
                            const __grid_constant__ CUtensorMap map_w, const float* __restrict__ b,
                            float* __restrict__ cand_v, int* __restrict__ cand_i,
                            float* __restrict__ part_m, float* __restrict__ part_s, int rows,
                            int hd, int v, int block_unk, int chunk_cols) {
  constexpr int S = kTkStages;
  extern __shared__ __align__(1024) uint8_t tk_smem_raw[];
  const int nk = (hd + hop::kTileK - 1) / hop::kTileK;
  uint64_t* full;
  uint8_t* sa = hop::smem_layout(tk_smem_raw, topk_wgmma_tile_bytes(hd), &full);
  uint8_t* ring = sa + nk * hop::kATileBytes;
  uint64_t* a_bar = full + S;
  const int chunk = blockIdx.x, nchunks = gridDim.x;
  const int m0 = blockIdx.y * hop::kTileM;
  const int c_begin = chunk * chunk_cols;
  const int c_end = min(v, c_begin + chunk_cols);
  const int ntiles = (c_end - c_begin + hop::kTileN - 1) / hop::kTileN;
  const int total = ntiles * nk;  // w tiles this block streams, N-tile major
  const int wg = threadIdx.x / hop::kThreads;
  const int lane = threadIdx.x & 31;
  const CUtensorMap* mw = &map_w;

  auto load = [=](int j) {
    uint64_t* bar = full + j % S;
    hop::mbar_expect_tx(bar, hop::kBTileBytes);
    hop::tma_load(ring + (j % S) * hop::kBTileBytes, mw, bar, (j % nk) * hop::kTileK,
                  c_begin + (j / nk) * hop::kTileN);
  };
  hop::ring_start<S>(full, 1, total, load);
  if (threadIdx.x == 0) {  // h's row tile, once
    hop::mbar_expect_tx(a_bar, nk * hop::kATileBytes);
    for (int kt = 0; kt < nk; ++kt)
      hop::tma_load(sa + kt * hop::kATileBytes, &map_h, a_bar, kt * hop::kTileK, m0);
  }

  // per owned row (acc_row(i) for (i >> 1) & 1 == r): a top-K sorted by
  // (value desc, index asc), its K-th value, and the online (max, sum-exp)
  float tv[2][K], thr[2], m[2], s[2];
  int ti[2][K];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int slot = 0; slot < K; ++slot) {
      tv[r][slot] = -INFINITY;
      ti[r][slot] = 0x7fffffff;
    }
    thr[r] = -INFINITY;
    m[r] = -INFINITY;
    s[r] = 0.0f;
  }
  hop::mbar_wait(a_bar, 0);

  float acc[kTkCols / 2];
  for (int nt = 0; nt < ntiles; ++nt) {
    hop::mma_tile<S>(
        acc, nt * nk, nk, total, ring, hop::kBTileBytes, wg * kTkCols * hop::kTileK * 2, full,
        false, [=](int kt, int) { return sa + kt * hop::kATileBytes; }, load);
    const int col0 = c_begin + nt * hop::kTileN + wg * kTkCols;
    // A value below the largest K-th value of the quad's 4 lists (all from
    // this row) has K values of the row above it: it cannot win.
    const float qthr[2] = {quad_max(thr[0]), quad_max(thr[1])};
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < kTkCols / 2; ++i) {
      const int r = (i >> 1) & 1;
      const int col = col0 + hop::acc_col(i);
      float x = -INFINITY;  // past the chunk: never enters a list
      if (col < c_end) {
        const bool special = col == kPad || col == kBos || (block_unk && col == kUnk);
        x = special ? kMaskNeg : acc[i] + b[col];
        if (!special) tmax[r] = fmaxf(tmax[r], x);
      }
      acc[i] = x;
      if (x > thr[r] && x >= qthr[r]) {  // strict: an equal value of a higher id stays out
        float cv = x;
        int ci = col;
#pragma unroll
        for (int slot = 0; slot < K; ++slot) {
          const bool swap = cv > tv[r][slot];
          const float ov = tv[r][slot];
          const int oi = ti[r][slot];
          tv[r][slot] = swap ? cv : ov;
          ti[r][slot] = swap ? ci : oi;
          cv = swap ? ov : cv;
          ci = swap ? oi : ci;
        }
        thr[r] = tv[r][K - 1];
      }
    }
    // sum-exp: rescale once per tile, then add this tile's terms (masked
    // specials at -1e30 and columns past the chunk at -inf add 0)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mn = fmaxf(m[r], tmax[r]);
      if (mn > m[r]) {
        s[r] *= expf(m[r] - mn);
        m[r] = mn;
      }
    }
#pragma unroll
    for (int i = 0; i < kTkCols / 2; ++i) {
      const int r = (i >> 1) & 1;
      if (m[r] > -INFINITY) s[r] += expf(acc[i] - m[r]);
    }
  }

  // Each warpgroup's quad merges its 4 lists of a row into the row's top-K
  // over its 64-column halves; the two warpgroups' lists and (m, s) then
  // meet in shared memory (the ring is idle now) and one thread per row
  // merges them.
  float* sv = reinterpret_cast<float*>(ring);  // [kTkWgs][64][K]
  int* si = reinterpret_cast<int*>(sv + kTkWgs * hop::kTileM * K);
  float* sm = reinterpret_cast<float*>(si + kTkWgs * hop::kTileM * K);  // [kTkWgs][64]
  float* ss = sm + kTkWgs * hop::kTileM;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wg * hop::kTileM + hop::acc_row(2 * r);
#pragma unroll
    for (int j = 0; j < K; ++j) {
      float bv = tv[r][0];
      int bi = ti[r][0];
      int bl = lane;
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
      if ((lane & 3) == 0) {
        sv[row * K + j] = bv;
        si[row * K + j] = bi;
      }
    }
    const float mm = quad_max(m[r]);
    float part = s[r] > 0.0f ? s[r] * expf(m[r] - mm) : 0.0f;
    part += __shfl_xor_sync(kFull, part, 1);
    part += __shfl_xor_sync(kFull, part, 2);
    if ((lane & 3) == 0) {
      sm[row] = mm;
      ss[row] = part;
    }
  }
  __syncthreads();
  const int row_l = threadIdx.x, row = m0 + row_l;
  if (row_l < hop::kTileM && row < rows) {
    const float* av = sv + row_l * K;
    const int* ai = si + row_l * K;
    const float* bv = sv + (hop::kTileM + row_l) * K;
    const int* bi = si + (hop::kTileM + row_l) * K;
    const size_t slot_base = ((size_t)row * nchunks + chunk) * K;
    int ia = 0, ib = 0;
    for (int j = 0; j < K; ++j) {
      const bool take_a = ranks_before(av[ia], ai[ia], 0, bv[ib], bi[ib], 1);
      cand_v[slot_base + j] = take_a ? av[ia] : bv[ib];
      cand_i[slot_base + j] = take_a ? ai[ia] : bi[ib];
      ia += take_a;
      ib += !take_a;
    }
    const float ma = sm[row_l], mb = sm[hop::kTileM + row_l], mm = fmaxf(ma, mb);
    const float sa_ = ss[row_l], sb = ss[hop::kTileM + row_l];
    part_m[(size_t)row * nchunks + chunk] = mm;
    part_s[(size_t)row * nchunks + chunk] =
        (sa_ > 0.0f ? sa_ * expf(ma - mm) : 0.0f) + (sb > 0.0f ? sb * expf(mb - mm) : 0.0f);
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
                                  int v, int k, int block_unk, int chunk_cols, int nchunks,
                                  cudaStream_t st) {
  CUtensorMap map_h, map_w;
  cudaError_t err = hop::make_tmap(&map_h, h, rows, hd, hd, hop::kTileM);
  if (err == cudaSuccess) err = hop::make_tmap(&map_w, w_t, v, hd, hd, hop::kTileN);
  if (err != cudaSuccess) return err;
  const int smem = (int)topk_wgmma_smem_bytes(hd);
  const dim3 grid(nchunks, (rows + hop::kTileM - 1) / hop::kTileM);
  auto launch = [&](auto kc) -> cudaError_t {  // one instantiation per K
    constexpr int K = decltype(kc)::value;
    static int smem_set = 0;
    const cudaError_t e = hop::allow_smem(topk_chunk_wgmma_kernel<K>, smem, smem_set);
    if (e != cudaSuccess) return e;
    topk_chunk_wgmma_kernel<K><<<grid, kTkThreads, smem, st>>>(
        map_h, map_w, b, cand_v, cand_i, part_m, part_s, rows, hd, v, block_unk, chunk_cols);
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

cudaError_t launch_topk_merge(const float* cand_v, const int* cand_i, const float* part_m,
                              const float* part_s, float* vals, int* idx, float* lse, int rows,
                              int nchunks, int k, cudaStream_t st) {
  const int rows_per_block = kThreads / 32;
  topk_merge_kernel<<<(rows + rows_per_block - 1) / rows_per_block, kThreads, 0, st>>>(
      cand_v, cand_i, part_m, part_s, vals, idx, lse, rows, nchunks, k);
  return cudaGetLastError();
}

}  // namespace cxg

// dtype 0: h [rows, hd] and w = w_out [hd, v], float32; dtype 1: h
// [rows, hd] and w = w_out^T [v, hd], bfloat16, hd % 8 == 0. b, cand_v,
// part_m, part_s, vals, lse f32; cand_i, idx int32. The scratch arrays
// hold rows x ceil(v / chunk_cols) (x k) entries; chunk_cols is a
// multiple of 128. k <= 8. Returns a cudaError_t (0 = launched).
extern "C" int cxg_topk_tail_fwd(int dtype, const void* h, const void* w, const void* b,
                                 void* cand_v, void* cand_i, void* part_m, void* part_s,
                                 void* vals, void* idx, void* lse, int rows, int hd, int v,
                                 int k, int block_unk, int chunk_cols, void* stream) {
  if (k < 1 || k > cxg::kKMax || chunk_cols % cxg::kBN || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  const int nchunks = (v + chunk_cols - 1) / chunk_cols;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err =
      dtype == 0
          ? cxg::launch_topk_tail_f32((const float*)h, (const float*)w, (const float*)b,
                                      (float*)cand_v, (int*)cand_i, (float*)part_m,
                                      (float*)part_s, rows, hd, v, k, block_unk, chunk_cols,
                                      nchunks, st)
          : cxg::launch_topk_tail_bf16(h, w, (const float*)b, (float*)cand_v, (int*)cand_i,
                                       (float*)part_m, (float*)part_s, rows, hd, v, k, block_unk,
                                       chunk_cols, nchunks, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cxg::launch_topk_merge((const float*)cand_v, (const int*)cand_i,
                                     (const float*)part_m, (const float*)part_s, (float*)vals,
                                     (int*)idx, (float*)lse, rows, nchunks, k, st);
}

extern "C" long cxg_topk_wgmma_smem_bytes(int hd) {
  return (long)cxg::topk_wgmma_smem_bytes(hd);
}
