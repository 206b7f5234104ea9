// POS-generator LSTM step: gates and cell tail in one kernel.
//
// Replaces the Pallas kernel controllable_xgating_tpu/ops/pallas/pos_lstm.py
// (_kernel, wrapper pos_lstm_step_pallas):
//   gates = e @ Wih_e + s_gates + h @ Whh + b      (s_gates = summary @ Wih_s,
//   c' = f*c + i*g ; h' = o * tanh(c')              hoisted out of the rollout)
// The tag-logit projection ([H, 35]) stays outside, as it does in JAX.
//
// What bounds it on the card: at B = 256 rows it reads the two [512, 2048]
// weights (4 MB in bf16) for 2 x 256 x 1024 x 2048 = 1.1 GFLOP, about
// 250 FLOP per weight byte: near the bf16 ridge (2.5 us for the bytes).
// Unfused, the [B, 4H] gate pre-activations would make a round trip
// through device memory between the matmuls and the tail.
//
// Design under the bf16 policy: one launch on hopper_gemm.cuh's TMA +
// mbarrier + wgmma ring, shaped like attn_lstm.cu's cell_gemm_kernel. One
// warpgroup per [64-row, 64-column] tile of the gates (m64n64k16; 128
// blocks at B = 256 for the 132 SMs), a 4-stage ring of 64-deep K steps.
// The A stream is [e | h] without a concatenation: two TMA descriptors,
// e's tiles for the first ceil(Ep / 64) steps and h's for the rest. The B
// operand is [Wih_e; Whh] K-major in gate_perm order (ops/kernels/
// attn_lstm.py), packed once per rollout with e's part zero-padded to a
// multiple of 64 so that its K indices meet h's tiles (pos_lstm.py). The
// gates add s_gates + b, which the rollout adds and lays out in gate_perm
// order once (s_gates is the same at every step), so that a thread reads
// its columns in pairs and a warp whole 32-byte sectors (read in the
// natural order, they scatter: 1.7 us more a step at B = 256). They and c
// are read before the mainloop, whose latency hides theirs, and added
// after it (preloaded into the accumulator, they held back the first
// wgmma: 0.4 us more). The epilogue is the LSTM tail, which writes
// h' and c' in f32 and h' in bf16 (rounded to nearest even) into the other
// buffer of the rollout's ping-pong pair: the next step's A operand. The
// descriptors are encoded once per rollout (cxg_pos_lstm_bf16_plan).
//
// Under the f32 policy (full f32 on SIMT, no TF32): lstm_gates_kernel
// (common.cuh) splits the 4H gate columns by hidden unit: a block owns 32
// rows and 32 hidden units and computes their i, f, g and o columns.
#include <string.h>

#include "common.cuh"
#include "hopper_gemm.cuh"

namespace cxg {

constexpr int kPlStages = 4;
constexpr int kPlTileN = 64;                                    // gate columns a block
constexpr int kPlBTileBytes = kPlTileN * hop::kTileK * 2;       // 8 KB
constexpr int kPlStageBytes = hop::kATileBytes + kPlBTileBytes;  // 16 KB

inline size_t pos_lstm_smem_bytes() { return hop::smem_request(kPlStages * kPlStageBytes); }

// The rollout's descriptors: e [rows, ed], h's two buffers [rows, hd], the
// packed weight [n_cell, kw].
struct PosLstmMaps {
  CUtensorMap e, h[2], w;
};

__global__ void __launch_bounds__(hop::kThreads)
    pos_lstm_wgmma_kernel(const __grid_constant__ CUtensorMap map_e,
                          const __grid_constant__ CUtensorMap map_h,
                          const __grid_constant__ CUtensorMap map_w,
                          const float* __restrict__ sgb, const float* __restrict__ c, float* __restrict__ h_out,
                          float* __restrict__ c_out, __nv_bfloat16* __restrict__ h_next, int ldh,
                          int rows, int ed, int hd, int n_cell) {
  constexpr int S = kPlStages;
  constexpr int kBlocks = kPlTileN / 16;  // 16-column blocks of 4 units
  extern __shared__ __align__(1024) uint8_t pl_smem_raw[];
  uint64_t* full;
  uint8_t* ring = hop::smem_layout(pl_smem_raw, S * kPlStageBytes, &full);
  const int m0 = blockIdx.y * hop::kTileM, n0 = blockIdx.x * kPlTileN;
  const int q = threadIdx.x & 3;
  const int ne = (ed + hop::kTileK - 1) / hop::kTileK;
  const int total = ne + (hd + hop::kTileK - 1) / hop::kTileK;
  const CUtensorMap* me = &map_e;
  const CUtensorMap* mh = &map_h;
  const CUtensorMap* mw = &map_w;
  auto load = [=](int j) {
    uint8_t* stage = ring + (j % S) * kPlStageBytes;
    uint64_t* bar = &full[j % S];
    hop::mbar_expect_tx(bar, kPlStageBytes);
    if (j < ne)
      hop::tma_load(stage, me, bar, j * hop::kTileK, m0);
    else
      hop::tma_load(stage, mh, bar, (j - ne) * hop::kTileK, m0);
    hop::tma_load(stage + hop::kATileBytes, mw, bar, j * hop::kTileK, n0);
  };
  hop::ring_start<S>(full, 0, total, load);

  // s_gates + b are read before the mainloop and added after it: the
  // products start from zero, so that the first wgmma waits for no load
  float acc[32], pre[32];
#pragma unroll
  for (int i = 0; i < 32; i += 2) {  // columns p, p + 1 (n_cell is a multiple of 16)
    const int r = m0 + hop::acc_row(i), p = n0 + hop::acc_col(i);
    const float2 v = r < rows && p < n_cell
                         ? *reinterpret_cast<const float2*>(sgb + (size_t)r * n_cell + p)
                         : make_float2(0.0f, 0.0f);
    pre[i] = v.x;
    pre[i + 1] = v.y;
  }
  float c_old[2][kBlocks];
#pragma unroll
  for (int rs = 0; rs < 2; ++rs)
#pragma unroll
    for (int blk = 0; blk < kBlocks; ++blk) {
      const int r = m0 + hop::acc_row(2 * rs), u = (n0 + 16 * blk) / 4 + q;
      c_old[rs][blk] = r < rows && u < hd ? c[(size_t)r * hd + u] : 0.0f;
    }
  hop::mma_tile<S>(
      acc, 0, total, total, ring, kPlStageBytes, hop::kATileBytes, full, false,
      [=](int, int stage) { return ring + stage * kPlStageBytes; }, load);
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] += pre[i];
#pragma unroll
  for (int rs = 0; rs < 2; ++rs) {
    const int r = m0 + hop::acc_row(2 * rs);
    if (r >= rows) continue;
#pragma unroll
    for (int blk = 0; blk < kBlocks; ++blk) {
      const int u = (n0 + 16 * blk) / 4 + q;
      if (u >= hd) continue;
      const int i0 = 4 * (2 * blk) + 2 * rs;      // (row rs, column 16 blk + 2q)
      const int i1 = 4 * (2 * blk + 1) + 2 * rs;  // (row rs, column 16 blk + 8 + 2q)
      const float ig = sigmoid_f32(acc[i0]);
      const float fg = sigmoid_f32(acc[i0 + 1]);
      const float gg = tanhf(acc[i1]);
      const float og = sigmoid_f32(acc[i1 + 1]);
      const size_t o = (size_t)r * hd + u;
      const float c_new = fg * c_old[rs][blk] + ig * gg;
      const float h_new = og * tanhf(c_new);
      c_out[o] = c_new;
      h_out[o] = h_new;
      h_next[(size_t)r * ldh + u] = __float2bfloat16(h_new);
    }
  }
}

inline int round_up8(int x) { return (x + 7) / 8 * 8; }
inline int round_up4(int x) { return (x + 3) / 4 * 4; }

}  // namespace cxg

// f32 policy: e, h, wih_e [ed, 4 hd], whh [hd, 4 hd], s_gates, b, c,
// h_out, c_out all f32. Returns a cudaError_t (0 = launched).
extern "C" int cxg_pos_lstm_fwd(const void* e, const void* h, const void* s_gates, const void* c,
                                const void* wih_e, const void* whh, const void* b, void* h_out,
                                void* c_out, int rows, int ed, int hd, void* stream) {
  cxg::LstmArgs<float> p{};
  p.x[0] = (const float*)e;
  p.w[0] = (const float*)wih_e;
  p.kdim[0] = ed;
  p.x[1] = (const float*)h;
  p.w[1] = (const float*)whh;
  p.kdim[1] = hd;
  p.n_in = 2;
  p.addend = (const float*)s_gates;
  p.bias = (const float*)b;
  p.c = (const float*)c;
  p.h_out = (float*)h_out;
  p.c_out = (float*)c_out;
  p.rows = rows;
  p.hidden = hd;
  return (int)cxg::launch_lstm_gates<float>(p, (cudaStream_t)stream);
}

// bf16 policy, once per rollout: encode the descriptors of e [rows,
// round_up8(ed)], the two h buffers [rows, round_up8(hd)] (bf16) and the
// packed weight w [4 round_up(hd, 4), kw] (bf16, kw = 64 (ceil(ed / 64) +
// ceil(hd / 64))) into `maps` (host memory, cxg_pos_lstm_maps_bytes()).
extern "C" int cxg_pos_lstm_bf16_plan(void* maps, const void* e, const void* h0, const void* h1,
                                      const void* w, int rows, int ed, int hd) {
  namespace hop = cxg::hop;
  const int n_cell = 4 * cxg::round_up4(hd);
  const int kw = hop::kTileK * ((ed + hop::kTileK - 1) / hop::kTileK +
                                (hd + hop::kTileK - 1) / hop::kTileK);
  cxg::PosLstmMaps m;
  cudaError_t err = hop::make_tmap(&m.e, e, rows, ed, cxg::round_up8(ed), hop::kTileM);
  if (err == cudaSuccess) err = hop::make_tmap(&m.h[0], h0, rows, hd, cxg::round_up8(hd), hop::kTileM);
  if (err == cudaSuccess) err = hop::make_tmap(&m.h[1], h1, rows, hd, cxg::round_up8(hd), hop::kTileM);
  if (err == cudaSuccess) err = hop::make_tmap(&m.w, w, n_cell, kw, kw, cxg::kPlTileN);
  if (err != cudaSuccess) return (int)err;
  memcpy(maps, &m, sizeof(m));
  return 0;
}

extern "C" long cxg_pos_lstm_maps_bytes() { return (long)sizeof(cxg::PosLstmMaps); }

// bf16 policy, one step: A = [e | h_sel] through the plan's descriptors;
// sgb = s_gates + b [rows, 4 round_up(hd, 4)] f32 in gate_perm order; c,
// h_out, c_out [rows, hd] f32; h_next the other h buffer (bf16, rows
// round_up8(hd) apart), which receives bf16(h'). Returns a cudaError_t.
extern "C" int cxg_pos_lstm_bf16_fwd(const void* maps, int h_sel, const void* sgb, const void* c,
                                     void* h_out, void* c_out, void* h_next, int rows, int ed,
                                     int hd, void* stream) {
  namespace hop = cxg::hop;
  if (rows < 1 || (h_sel != 0 && h_sel != 1)) return (int)cudaErrorInvalidValue;
  cxg::PosLstmMaps m;
  memcpy(&m, maps, sizeof(m));
  const int smem = (int)cxg::pos_lstm_smem_bytes();
  static int smem_set = 0;
  cudaError_t err = hop::allow_smem(cxg::pos_lstm_wgmma_kernel, smem, smem_set);
  if (err != cudaSuccess) return (int)err;
  const int n_cell = 4 * cxg::round_up4(hd);
  dim3 grid((n_cell + cxg::kPlTileN - 1) / cxg::kPlTileN, (rows + hop::kTileM - 1) / hop::kTileM);
  cxg::pos_lstm_wgmma_kernel<<<grid, hop::kThreads, smem, (cudaStream_t)stream>>>(
      m.e, m.h[h_sel], m.w, (const float*)sgb, (const float*)c, (float*)h_out, (float*)c_out,
      (__nv_bfloat16*)h_next, cxg::round_up8(hd), rows, ed, hd, n_cell);
  return (int)cudaGetLastError();
}
