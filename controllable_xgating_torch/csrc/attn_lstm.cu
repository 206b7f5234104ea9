// Decoder step: additive attention, gated visual/syntax fusion, LSTM cell.
//
// Replaces the Pallas kernel controllable_xgating_tpu/ops/pallas/attn_lstm.py
// (_kernel, wrapper attn_lstm_step_pallas):
//   q = h @ Wq ; score_t = sum_a tanh(q + keys_t + b)_a * v_a (f32)
//   alpha = softmax_T(score), masked frames at -1e9 ; vis_g = alpha . enc_proj
//   gate = sigmoid(h @ Wg_h + e @ Wg_e + bg)
//   guide = gate * vis_g + (1 - gate) * psi_g
//   gates = e @ Wih_e + round(guide) @ Wih_g + h @ Whh + bl ; LSTM tail
// Outputs h', c' and alpha in f32. The vocab projection stays outside.
//
// What bounds it on the card: per beam step (R = 1280 rows) it reads keys
// and enc_proj ([R, 26, 512] each, 27 MB apiece in bf16) and ~8 MB of
// weights, for ~10 GFLOP of products and 17 M tanh. The products are
// bound by the tensor cores; the attention's floor is device memory (~20
// us at 3.35 TB/s), but on the card it is bound by its instruction rate, the
// full-precision tanh above all (PERF.md).
//
// Design under the bf16 policy: three launches on one stream, each shaped
// by what bounds it.
//   1. pre_gemm_kernel: the three products that need only h and e, in one
//      wgmma GEMM (hopper_gemm.cuh) over all R rows: [h | e] @ W_pre, where
//      W_pre packs q = h @ Wq, gate_pre = h @ Wg_h + e @ Wg_e and
//      lstm_pre = e @ Wih_e + h @ Whh column-wise (K-major, packed once per
//      caption call, ops/kernels/attn_lstm.py), into an f32 scratch
//      [R, A + G + 4H']; 64 x 128 tiles (480 blocks at R = 1280).
//   2. attn_rows_kernel: one block per row (R blocks), the row's keys and
//      enc_proj staged into shared memory by two bulk copies started first
//      thing; scores with full-precision tanhf, masked softmax, vis_g, then
//      the gate and the guide, written in bf16 (the Pallas kernel casts it
//      there too).
//   3. cell_gemm_kernel: guide @ Wih_g on the same mainloop, its
//      accumulator preloaded with lstm_pre + b, the LSTM tail in its
//      epilogue: Wih_g's and lstm_pre's gate columns are interleaved so
//      that each thread's accumulator holds the i, f, g, o columns of its
//      hidden units (16-column blocks of 4 units; see gate_perm in
//      attn_lstm.py).
// Under the f32 policy (the reference, full f32 on SIMT, no TF32): two
// launches on tile_gemm, attn_guide_kernel per 16-row tile (q, scores,
// softmax, vis_g, the gate GEMM and the guide into an f32 scratch), then
// lstm_gates_kernel (common.cuh) on (e, Wih_e), (guide, Wih_g), (h, Whh).
#include "common.cuh"
#include "hopper_gemm.cuh"

#include <algorithm>

namespace cxg {

constexpr int kAttnRows = 16;  // TM = 2
constexpr float kNegInf = -1e9f;

inline size_t attn_smem_bytes(int t, int a, int g) {
  // sQ [16][a], sVis [16][g], sAl [16][t rounded up to 4], tile_gemm stages
  const int t4 = (t + 3) / 4 * 4;
  return (size_t)(kAttnRows * (a + g + t4) + gemm_smem_floats<kAttnRows / 8>()) * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    attn_guide_kernel(const T* __restrict__ h, const T* __restrict__ e,
                      const T* __restrict__ keys, const T* __restrict__ encp,
                      const T* __restrict__ psi, const float* __restrict__ mask,
                      const T* __restrict__ wq, const float* __restrict__ battn,
                      const T* __restrict__ v, const T* __restrict__ wg_h,
                      const T* __restrict__ wg_e, const float* __restrict__ bg,
                      T* __restrict__ guide, float* __restrict__ alpha_out, int rows, int hd,
                      int ed, int t, int a, int g) {
  constexpr int TM = kAttnRows / 8;
  extern __shared__ __align__(128) float smem[];
  const int t4 = (t + 3) / 4 * 4;
  float* sQ = smem;
  float* sVis = sQ + kAttnRows * a;
  float* sAl = sVis + kAttnRows * g;
  float* sA = sAl + kAttnRows * t4;
  float* sW = sA + kAttnRows * kSA;
  const int r0 = blockIdx.x * kAttnRows;
  const int nrows = min(kAttnRows, rows - r0);
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int lane = tx, warp = ty;
  float acc[TM][4];

  // q = h @ Wq
  for (int n0 = 0; n0 < a; n0 += kBN) {
    const int nv = min(kBN, a - n0);
    zero_acc<TM>(acc);
    tile_gemm<T, T, TM>(acc, h + (size_t)r0 * hd, hd, nrows, hd, wq, a, n0, kBN, 0, nv, sA, sW);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx * 4 + j;
        if (c < nv) sQ[(ty * TM + i) * a + n0 + c] = acc[i][j];
      }
  }
  __syncthreads();
  // scores: one warp per (row, frame), lanes stride over the A columns
  for (int pr = warp; pr < nrows * t; pr += kThreads / 32) {
    const int r = pr / t, tt = pr % t;
    const T* kr = keys + ((size_t)(r0 + r) * t + tt) * a;
    float s = 0.0f;
    for (int c = lane; c < a; c += 32)
      s += tanhf(sQ[r * a + c] + to_f32(kr[c]) + battn[c]) * to_f32(v[c]);
    s = warp_sum(s);
    if (lane == 0) sAl[r * t4 + tt] = mask[(size_t)(r0 + r) * t + tt] > 0.0f ? s : kNegInf;
  }
  __syncthreads();
  // masked softmax over frames: one warp per row
  for (int r = warp; r < nrows; r += kThreads / 32) {
    float m = -INFINITY;
    for (int tt = lane; tt < t; tt += 32) m = fmaxf(m, sAl[r * t4 + tt]);
    m = warp_max(m);
    float z = 0.0f;
    for (int tt = lane; tt < t; tt += 32) z += expf(sAl[r * t4 + tt] - m);
    z = warp_sum(z);
    __syncwarp();
    for (int tt = lane; tt < t; tt += 32) {
      const float al = expf(sAl[r * t4 + tt] - m) / z;
      sAl[r * t4 + tt] = al;
      alpha_out[(size_t)(r0 + r) * t + tt] = al;
    }
  }
  __syncthreads();
  // vis_g = alpha . enc_proj
  for (int idx = threadIdx.x; idx < nrows * g; idx += kThreads) {
    const int r = idx / g, c = idx % g;
    const T* er = encp + (size_t)(r0 + r) * t * g + c;
    float s = 0.0f;
    for (int tt = 0; tt < t; ++tt) s += sAl[r * t4 + tt] * to_f32(er[(size_t)tt * g]);
    sVis[r * g + c] = s;
  }
  // gate and guide (tile_gemm's entry barrier publishes sVis)
  for (int n0 = 0; n0 < g; n0 += kBN) {
    const int nv = min(kBN, g - n0);
    zero_acc<TM>(acc);
    tile_gemm<T, T, TM>(acc, h + (size_t)r0 * hd, hd, nrows, hd, wg_h, g, n0, kBN, 0, nv, sA,
                        sW);
    tile_gemm<T, T, TM>(acc, e + (size_t)r0 * ed, ed, nrows, ed, wg_e, g, n0, kBN, 0, nv, sA,
                        sW);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = ty * TM + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx * 4 + j;
        if (r < nrows && c < nv) {
          const int col = n0 + c;
          const float gate = sigmoid_f32(acc[i][j] + bg[col]);
          const size_t o = (size_t)(r0 + r) * g + col;
          const float gd = gate * sVis[r * g + col] + (1.0f - gate) * to_f32(psi[o]);
          guide[o] = from_f32<T>(gd);
        }
      }
    }
  }
}

template <typename T>
cudaError_t launch_attn_lstm_simt(const void* h, const float* c, const void* e, const void* keys,
                             const void* encp, const void* psi, const float* mask,
                             const void* wq, const float* battn, const void* v,
                             const void* wg_h, const void* wg_e, const float* bg,
                             const void* wih_e, const void* wih_g, const void* whh,
                             const float* bl, void* guide, float* h_out, float* c_out,
                             float* alpha, int rows, int hd, int ed, int t, int a, int g,
                             cudaStream_t st) {
  const size_t smem = attn_smem_bytes(t, a, g);
  cudaError_t err = cudaFuncSetAttribute(attn_guide_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int grid = (rows + kAttnRows - 1) / kAttnRows;
  attn_guide_kernel<T><<<grid, kThreads, smem, st>>>(
      (const T*)h, (const T*)e, (const T*)keys, (const T*)encp, (const T*)psi, mask,
      (const T*)wq, battn, (const T*)v, (const T*)wg_h, (const T*)wg_e, bg, (T*)guide, alpha,
      rows, hd, ed, t, a, g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  LstmArgs<T> p{};
  p.x[0] = (const T*)e;
  p.w[0] = (const T*)wih_e;
  p.kdim[0] = ed;
  p.x[1] = (const T*)guide;
  p.w[1] = (const T*)wih_g;
  p.kdim[1] = g;
  p.x[2] = (const T*)h;
  p.w[2] = (const T*)whh;
  p.kdim[2] = hd;
  p.n_in = 3;
  p.addend = nullptr;
  p.bias = bl;
  p.c = c;
  p.h_out = h_out;
  p.c_out = c_out;
  p.rows = rows;
  p.hidden = hd;
  return launch_lstm_gates<T>(p, st);
}

// ------------------------------------------------------------ bf16 policy

constexpr int kPreStages = 4;   // 97 KB: 2 blocks an SM
constexpr int kCellStages = 3;  // 73 KB: 3 blocks an SM, the cell's 320 tiles in one wave
constexpr int kAttnThreads = 256;  // attn_rows_kernel: one block of 8 warps per row
constexpr int kAttnFrames = 2;     // frames a warp scores at once (2 beat 1, 4 and 8 on the card)

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// q + b_attn and v as f32 (A rounded up to 8), the T scores (rounded up
// to 4), then, if staged, the row's keys [t, a] and enc_proj [t, g] in bf16
inline size_t attn_rows_smem_bytes(int t, int a, int g, bool staged) {
  return (size_t)(2 * round_up(a, 8) + round_up(t, 4)) * sizeof(float) +
         (staged ? (size_t)t * (a + g) * 2 : 0);
}

// Staging takes 16-byte rows and at most half an SM's shared memory.
inline bool attn_rows_staged(int t, int a, int g, const void* keys, const void* encp) {
  const uintptr_t ends = reinterpret_cast<uintptr_t>(keys) | reinterpret_cast<uintptr_t>(encp);
  return a % 8 == 0 && g % 8 == 0 && (ends & 15) == 0 &&
         attn_rows_smem_bytes(t, a, g, true) <= 113 * 1024;
}

// pre [rows, n] = x [rows, k] @ w_pre^T, w_pre [n, k] (K-major), f32 out
__global__ void __launch_bounds__(hop::kThreads)
    pre_gemm_kernel(const __grid_constant__ CUtensorMap map_x,
                    const __grid_constant__ CUtensorMap map_w, float* __restrict__ pre, int rows,
                    int n, int k) {
  const int m0 = blockIdx.y * hop::kTileM, n0 = blockIdx.x * hop::kTileN;
  float acc[64];
  hop::streamed_tile<kPreStages>(acc, &map_x, &map_w, m0, n0, k, false);
#pragma unroll
  for (int i = 0; i < 64; i += 2) {  // columns 2q, 2q + 1 of each 8-column group
    const int r = m0 + hop::acc_row(i), c = n0 + hop::acc_col(i);
    if (r >= rows || c >= n) continue;
    float* o = pre + (size_t)r * n + c;
    if (c + 1 < n && n % 2 == 0) {
      *reinterpret_cast<float2*>(o) = make_float2(acc[i], acc[i + 1]);
    } else {
      o[0] = acc[i];
      if (c + 1 < n) o[1] = acc[i + 1];
    }
  }
}

// 8 bf16 at p[c0 .. c0 + 7] as f32, zeros past n; one 16-byte load when vec
__device__ __forceinline__ void load8(float (&x)[8], const __nv_bfloat16* __restrict__ p, int c0,
                                      int n, bool vec) {
  if (vec && c0 + 8 <= n) {
    const uint4 u = *reinterpret_cast<const uint4*>(p + c0);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {  // a bf16 is the top half of its f32
      x[2 * e] = __uint_as_float(w[e] << 16);
      x[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) x[e] = c0 + e < n ? __bfloat162float(p[c0 + e]) : 0.0f;
  }
}

// 4 bf16 at p[c0 .. c0 + 3] as f32, zeros past n; one 8-byte load when vec
__device__ __forceinline__ void load4(float (&x)[4], const __nv_bfloat16* __restrict__ p, int c0,
                                      int n, bool vec) {
  if (vec && c0 + 4 <= n) {
    const uint2 u = *reinterpret_cast<const uint2*>(p + c0);
    x[0] = __uint_as_float(u.x << 16);
    x[1] = __uint_as_float(u.x & 0xffff0000u);
    x[2] = __uint_as_float(u.y << 16);
    x[3] = __uint_as_float(u.y & 0xffff0000u);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) x[e] = c0 + e < n ? __bfloat162float(p[c0 + e]) : 0.0f;
  }
}

__device__ __forceinline__ bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// One block per row: scores (warp w takes frames 2w and 2w + 1, then 16
// on), masked softmax (alpha out), vis_g, gate and guide (bf16, rows ldg
// apart; each thread 4 columns per 1024). q and gate_pre come from the pre
// scratch (columns [0, a) and [a, a + g) of rows ldp apart). If `staged`,
// the row's keys and enc_proj (26 KB each at MSR-VTT widths) come into
// shared memory by two bulk copies started first thing, so that all of the
// row's bytes are in flight at once and enc_proj's arrive during the
// scores; else the threads read them from device memory. The kernel is
// bound by its instruction rate (the 17 M full-precision tanhf of a beam step),
// not by memory: PERF.md.
__global__ void __launch_bounds__(kAttnThreads)
    attn_rows_kernel(const float* __restrict__ pre, int ldp,
                     const __nv_bfloat16* __restrict__ keys,
                     const __nv_bfloat16* __restrict__ encp,
                     const __nv_bfloat16* __restrict__ psi, const float* __restrict__ mask,
                     const float* __restrict__ battn, const __nv_bfloat16* __restrict__ v,
                     const float* __restrict__ bg, __nv_bfloat16* __restrict__ guide, int ldg,
                     float* __restrict__ alpha, int t, int a, int g, int staged) {
  extern __shared__ __align__(16) float attn_smem[];
  __shared__ uint64_t bars[2];  // keys, enc_proj
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r = blockIdx.x;
  const int a8 = round_up(a, 8);
  float* sq = attn_smem;  // q + b_attn
  float* sv = sq + a8;    // v
  float* sc = sv + a8;    // scores, then alpha
  const __nv_bfloat16* kr = keys + (size_t)r * t * a;
  const __nv_bfloat16* er = encp + (size_t)r * t * g;
  __nv_bfloat16* sk = reinterpret_cast<__nv_bfloat16*>(sc + round_up(t, 4));
  __nv_bfloat16* se = sk + (size_t)t * a;
  if (staged && tid == 0) {
    hop::mbar_init(&bars[0], 1);
    hop::mbar_init(&bars[1], 1);
    hop::mbar_init_fence();
    hop::mbar_expect_tx(&bars[0], t * a * 2);
    hop::bulk_load(sk, kr, t * a * 2, &bars[0]);
    hop::mbar_expect_tx(&bars[1], t * g * 2);
    hop::bulk_load(se, er, t * g * 2, &bars[1]);
  }
  const float* q = pre + (size_t)r * ldp;
  for (int c = tid; c < a8; c += kAttnThreads) {
    sq[c] = c < a ? q[c] + battn[c] : 0.0f;
    sv[c] = c < a ? __bfloat162float(v[c]) : 0.0f;
  }
  __syncthreads();
  if (staged) {
    hop::mbar_wait(&bars[0], 0);
    kr = sk;
  }

  // scores; lanes take 8 columns per 256
  const bool vk = a % 8 == 0 && aligned(kr, 16);
  for (int t0 = warp * kAttnFrames; t0 < t; t0 += kAttnThreads / 32 * kAttnFrames) {
    float sf[kAttnFrames];
#pragma unroll
    for (int f = 0; f < kAttnFrames; ++f) sf[f] = 0.0f;
#pragma unroll 2
    for (int c0 = lane * 8; c0 < a; c0 += 256) {
      float kx[kAttnFrames][8];
#pragma unroll
      for (int f = 0; f < kAttnFrames; ++f) {
        if (t0 + f < t) {
          load8(kx[f], kr + (size_t)(t0 + f) * a, c0, a, vk);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) kx[f][e] = 0.0f;
        }
      }
      const float4 q0 = *reinterpret_cast<const float4*>(sq + c0);
      const float4 q1 = *reinterpret_cast<const float4*>(sq + c0 + 4);
      const float4 v0 = *reinterpret_cast<const float4*>(sv + c0);
      const float4 v1 = *reinterpret_cast<const float4*>(sv + c0 + 4);
      const float qq[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
      const float vv[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
      for (int f = 0; f < kAttnFrames; ++f)
#pragma unroll
        for (int e = 0; e < 8; ++e) sf[f] += tanhf(qq[e] + kx[f][e]) * vv[e];
    }
#pragma unroll
    for (int f = 0; f < kAttnFrames; ++f) {
      const float sum = warp_sum(sf[f]);
      if (lane == 0 && t0 + f < t)
        sc[t0 + f] = mask[(size_t)r * t + t0 + f] > 0.0f ? sum : kNegInf;
    }
  }
  __syncthreads();

  // masked softmax over the frames
  if (warp == 0) {
    float mx = -INFINITY;
    for (int tt = lane; tt < t; tt += 32) mx = fmaxf(mx, sc[tt]);
    mx = warp_max(mx);
    float z = 0.0f;
    for (int tt = lane; tt < t; tt += 32) z += expf(sc[tt] - mx);
    z = warp_sum(z);
    __syncwarp();
    for (int tt = lane; tt < t; tt += 32) {
      const float al = expf(sc[tt] - mx) / z;
      sc[tt] = al;
      alpha[(size_t)r * t + tt] = al;
    }
  }
  __syncthreads();

  // vis_g = alpha . enc_proj, then the gate and the guide
  if (staged) {
    hop::mbar_wait(&bars[1], 0);
    er = se;
  }
  const bool ve = g % 4 == 0 && aligned(er, 8);
  const bool vp = g % 4 == 0 && aligned(psi, 8);
  const bool vo = g % 4 == 0 && ldg % 4 == 0 && aligned(guide, 8);
  const float* gp = pre + (size_t)r * ldp + a;
  for (int c0 = tid * 4; c0 < g; c0 += 4 * kAttnThreads) {
    float vis[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 8
    for (int tt = 0; tt < t; ++tt) {
      float ex[4];
      load4(ex, er + (size_t)tt * g, c0, g, ve);
      const float al = sc[tt];
#pragma unroll
      for (int e = 0; e < 4; ++e) vis[e] += al * ex[e];
    }
    float ps[4];
    load4(ps, psi + (size_t)r * g, c0, g, vp);
    uint32_t out[4];  // the guide in bf16, rounded to nearest even
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = c0 + e;
      float gd = 0.0f;
      if (c < g) {
        const float gate = sigmoid_f32(gp[c] + bg[c]);
        gd = gate * vis[e] + (1.0f - gate) * ps[e];
      }
      out[e] = __bfloat16_as_ushort(__float2bfloat16(gd));
    }
    __nv_bfloat16* go = guide + (size_t)r * ldg + c0;
    if (vo && c0 + 4 <= g) {
      *reinterpret_cast<uint2*>(go) = make_uint2(out[0] | out[1] << 16, out[2] | out[3] << 16);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (c0 + e < g) go[e] = __ushort_as_bfloat16((unsigned short)out[e]);
    }
  }
}

// h', c' from gates = lstm_pre + b_cell + guide @ W_cell, in the gate-
// interleaved column order: 16-column block j holds hidden units
// 4j .. 4j + 3, unit 4j + q's i, f at columns 2q, 2q + 1 and g, o at
// 8 + 2q, 9 + 2q, which are exactly the columns thread q of a quad holds
// in the accumulator. The accumulator starts as lstm_pre + b_cell (column
// `off` on of the pre scratch) and c is read before the products, so that
// their latency hides behind the mainloop; the epilogue is the LSTM tail.
__global__ void __launch_bounds__(hop::kThreads)
    cell_gemm_kernel(const __grid_constant__ CUtensorMap map_g,
                     const __grid_constant__ CUtensorMap map_w, const float* __restrict__ pre,
                     int ldp, int off, const float* __restrict__ b_cell,
                     const float* __restrict__ c, float* __restrict__ h_out,
                     float* __restrict__ c_out, int rows, int hidden, int n_cell, int g) {
  constexpr int kBlocks = hop::kTileN / 16;  // 16-column blocks of 4 units
  const int m0 = blockIdx.y * hop::kTileM, n0 = blockIdx.x * hop::kTileN;
  const int q = threadIdx.x & 3;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int r = m0 + hop::acc_row(i), p = n0 + hop::acc_col(i);
    acc[i] = r < rows && p < n_cell ? pre[(size_t)r * ldp + off + p] + b_cell[p] : 0.0f;
  }
  float c_old[2][kBlocks];
#pragma unroll
  for (int rs = 0; rs < 2; ++rs)
#pragma unroll
    for (int blk = 0; blk < kBlocks; ++blk) {
      const int r = m0 + hop::acc_row(2 * rs), u = (n0 + 16 * blk) / 4 + q;
      c_old[rs][blk] = r < rows && u < hidden ? c[(size_t)r * hidden + u] : 0.0f;
    }
  hop::streamed_tile<kCellStages>(acc, &map_g, &map_w, m0, n0, g, true);
#pragma unroll
  for (int rs = 0; rs < 2; ++rs) {
    const int r = m0 + hop::acc_row(2 * rs);
    if (r >= rows) continue;
#pragma unroll
    for (int blk = 0; blk < kBlocks; ++blk) {
      const int u = (n0 + 16 * blk) / 4 + q;
      if (u >= hidden) continue;
      const int i0 = 4 * (2 * blk) + 2 * rs;      // (row rs, column 16 blk + 2q)
      const int i1 = 4 * (2 * blk + 1) + 2 * rs;  // (row rs, column 16 blk + 8 + 2q)
      const float ig = sigmoid_f32(acc[i0]);
      const float fg = sigmoid_f32(acc[i0 + 1]);
      const float gg = tanhf(acc[i1]);
      const float og = sigmoid_f32(acc[i1 + 1]);
      const size_t o = (size_t)r * hidden + u;
      const float c_new = fg * c_old[rs][blk] + ig * gg;
      c_out[o] = c_new;
      h_out[o] = og * tanhf(c_new);
    }
  }
}

// Widths of the packed operands (attn_lstm.py builds them the same way):
// x = [h | e] rows kxp = round_up(hd + ed, 8) apart; pre rows of
// n_pre = a + g + 4 h4 (h4 = round_up(hd, 4)); guide rows gp = round_up(g, 8).
cudaError_t launch_attn_lstm_bf16(const void* x, const void* w_pre, float* pre, const void* keys,
                                  const void* encp, const void* psi, const float* mask,
                                  const float* battn, const void* v, const float* bg, void* guide,
                                  const void* w_cell, const float* b_cell, const float* c,
                                  float* h_out, float* c_out, float* alpha, int rows, int hd,
                                  int ed, int t, int a, int g, cudaStream_t st) {
  using bf16 = __nv_bfloat16;
  const int kx = hd + ed, kxp = round_up(kx, 8), gp = round_up(g, 8);
  const int n_cell = 4 * round_up(hd, 4), n_pre = a + g + n_cell;
  CUtensorMap map_x, map_wp, map_g, map_wc;
  cudaError_t err = hop::make_tmap(&map_x, x, rows, kx, kxp, hop::kTileM);
  if (err == cudaSuccess) err = hop::make_tmap(&map_wp, w_pre, n_pre, kx, kxp, hop::kTileN);
  if (err == cudaSuccess) err = hop::make_tmap(&map_g, guide, rows, g, gp, hop::kTileM);
  if (err == cudaSuccess) err = hop::make_tmap(&map_wc, w_cell, n_cell, g, gp, hop::kTileN);
  if (err != cudaSuccess) return err;
  const int smem = (int)hop::streamed_smem_bytes(kPreStages);
  const int cell_smem = (int)hop::streamed_smem_bytes(kCellStages);
  const bool staged = attn_rows_staged(t, a, g, keys, encp);
  const int attn_smem = (int)attn_rows_smem_bytes(t, a, g, staged);
  static hop::SmemLimits pre_set, cell_set, attn_set;
  err = hop::allow_smem(pre_gemm_kernel, smem, pre_set);
  if (err == cudaSuccess) err = hop::allow_smem(cell_gemm_kernel, cell_smem, cell_set);
  if (err == cudaSuccess) err = hop::allow_smem(attn_rows_kernel, attn_smem, attn_set);
  if (err != cudaSuccess) return err;
  const int mtiles = (rows + hop::kTileM - 1) / hop::kTileM;
  pre_gemm_kernel<<<dim3((n_pre + hop::kTileN - 1) / hop::kTileN, mtiles), hop::kThreads, smem,
                    st>>>(map_x, map_wp, pre, rows, n_pre, kx);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_rows_kernel<<<rows, kAttnThreads, attn_smem, st>>>(
      pre, n_pre, (const bf16*)keys, (const bf16*)encp, (const bf16*)psi, mask, battn,
      (const bf16*)v, bg, (bf16*)guide, gp, alpha, t, a, g, (int)staged);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cell_gemm_kernel<<<dim3(n_cell / hop::kTileN + (n_cell % hop::kTileN != 0), mtiles),
                     hop::kThreads, cell_smem, st>>>(map_g, map_wc, pre, n_pre, a + g, b_cell, c,
                                                h_out, c_out, rows, hd, n_cell, g);
  return cudaGetLastError();
}

}  // namespace cxg

// The f32 policy's path: h, e, keys, enc_proj, psi_g, the weights, c,
// mask, the biases and all outputs f32; guide is a [rows, g] f32 scratch.
// Returns a cudaError_t.
extern "C" int cxg_attn_lstm_fwd(const void* h, const void* c, const void* e, const void* keys,
                                 const void* encp, const void* psi, const void* mask,
                                 const void* wq, const void* battn, const void* v,
                                 const void* wg_h, const void* wg_e, const void* bg,
                                 const void* wih_e, const void* wih_g, const void* whh,
                                 const void* bl, void* guide, void* h_out, void* c_out,
                                 void* alpha, int rows, int hd, int ed, int t, int a, int g,
                                 void* stream) {
  auto f = [](const void* p) { return (const float*)p; };
  return (int)cxg::launch_attn_lstm_simt<float>(
      h, f(c), e, keys, encp, psi, f(mask), wq, f(battn), v, wg_h, wg_e, f(bg), wih_e, wih_g, whh,
      f(bl), guide, (float*)h_out, (float*)c_out, (float*)alpha, rows, hd, ed, t, a, g,
      (cudaStream_t)stream);
}

extern "C" long cxg_attn_smem_bytes(int t, int a, int g) {
  return (long)cxg::attn_smem_bytes(t, a, g);
}

// The bf16 policy's path. x [rows, kxp] = [h | e] and guide [rows, gp] in
// bf16 (the kernel writes guide; its padding is never read), pre [rows,
// n_pre] an f32 scratch, w_pre [n_pre, kxp] and w_cell [4 h4, gp] the
// packed K-major weights, b_cell [4 h4] f32 in w_cell's column order; keys,
// enc_proj, psi_g and v bf16; c, mask, b_attn, b_gate and all outputs f32.
// Returns a cudaError_t.
extern "C" int cxg_attn_lstm_bf16_fwd(const void* x, const void* w_pre, void* pre,
                                      const void* keys, const void* encp, const void* psi,
                                      const void* mask, const void* battn, const void* v,
                                      const void* bg, void* guide, const void* w_cell,
                                      const void* b_cell, const void* c, void* h_out,
                                      void* c_out, void* alpha, int rows, int hd, int ed, int t,
                                      int a, int g, void* stream) {
  auto f = [](const void* p) { return (const float*)p; };
  return (int)cxg::launch_attn_lstm_bf16(x, w_pre, (float*)pre, keys, encp, psi, f(mask),
                                         f(battn), v, f(bg), guide, w_cell, f(b_cell), f(c),
                                         (float*)h_out, (float*)c_out, (float*)alpha, rows, hd, ed,
                                         t, a, g, (cudaStream_t)stream);
}

// shared memory the bf16 path needs a block to have (the attention
// unstaged: it stages the rows only where they fit)
extern "C" long cxg_attn_bf16_smem_bytes(int t, int a, int g) {
  return (long)std::max(cxg::hop::streamed_smem_bytes(cxg::kPreStages),
                        cxg::attn_rows_smem_bytes(t, a, g, false));
}
