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
// What bounds it on the card: per beam step (R = 1280 rows) it reads
// ~7.9 MB of bf16 weights plus keys and enc_proj ([R, 26, 512] each, 27 MB
// apiece in bf16) for ~10 GFLOP: the attention half is bound by device
// memory, the LSTM half by the tensor cores; this version is bound by the
// latency of tile_gemm's staging loop, and the attention kernel has only
// R/16 = 80 blocks for 132 SMs.
//
// Design: two kernels, launched back to back on one stream. The guide for
// a row needs the whole attention (all T frames, all A columns) and the
// whole gate before any LSTM gate column can start, while the LSTM product
// is best split by hidden unit across many blocks. One kernel would have to
// either recompute the attention in each of the H/32 hidden-unit blocks of
// a row tile or synchronise across blocks. So:
//   1. attn_guide_kernel, per 16-row tile: q in shared memory, scores with
//      one warp per (row, frame), softmax with one warp per row, vis_g,
//      the gate GEMM and the guide, written to a [R, G] scratch in the
//      compute dtype (the Pallas kernel casts the guide there too);
//   2. lstm_gates_kernel (common.cuh) on (e, Wih_e), (guide, Wih_g),
//      (h, Whh), split by hidden unit.
#include "common.cuh"

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
cudaError_t launch_attn_lstm(const void* h, const float* c, const void* e, const void* keys,
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

}  // namespace cxg

// dtype: 0 = float32 operands, 1 = bfloat16. h, e, keys, enc_proj, psi_g and
// the weights in that dtype; c, mask, the biases and all outputs f32; guide
// is a [rows, g] scratch in the operand dtype. Returns a cudaError_t.
extern "C" int cxg_attn_lstm_fwd(int dtype, const void* h, const void* c, const void* e,
                                 const void* keys, const void* encp, const void* psi,
                                 const void* mask, const void* wq, const void* battn,
                                 const void* v, const void* wg_h, const void* wg_e,
                                 const void* bg, const void* wih_e, const void* wih_g,
                                 const void* whh, const void* bl, void* guide, void* h_out,
                                 void* c_out, void* alpha, int rows, int hd, int ed, int t,
                                 int a, int g, void* stream) {
  auto f = [](const void* p) { return (const float*)p; };
  auto run = [&](auto tag) -> cudaError_t {
    using T = decltype(tag);
    return cxg::launch_attn_lstm<T>(h, f(c), e, keys, encp, psi, f(mask), wq, f(battn), v, wg_h,
                                    wg_e, f(bg), wih_e, wih_g, whh, f(bl), guide,
                                    (float*)h_out, (float*)c_out, (float*)alpha, rows, hd, ed,
                                    t, a, g, (cudaStream_t)stream);
  };
  if (dtype == 0) return (int)run(float{});
  if (dtype == 1) return (int)run(__nv_bfloat16{});
  return (int)cudaErrorInvalidValue;
}

extern "C" long cxg_attn_smem_bytes(int t, int a, int g) {
  return (long)cxg::attn_smem_bytes(t, a, g);
}
