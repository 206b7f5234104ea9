// POS-generator LSTM step: gates and cell tail in one kernel.
//
// Replaces the Pallas kernel controllable_xgating_tpu/ops/pallas/pos_lstm.py
// (_kernel, wrapper pos_lstm_step_pallas):
//   gates = e @ Wih_e + s_gates + h @ Whh + b      (s_gates = summary @ Wih_s,
//   c' = f*c + i*g ; h' = o * tanh(c')              hoisted out of the rollout)
// The tag-logit projection ([H, 35]) stays outside, as it does in JAX.
//
// What bounds it on the card: at B = 256 rows it reads the two [512, 2048]
// weights (4 MB in bf16) for 2 x 256 x 512 x 2048 x 2 = 1.1 GFLOP, about
// 250 FLOP per weight byte: near the bf16 ridge, below it at f32 operands.
// Unfused, the [B, 4H] gate pre-activations would make a round trip
// through device memory between the matmuls and the tail.
//
// Design: lstm_gates_kernel (common.cuh) splits the 4H gate columns by
// hidden unit: a block owns 32 rows and 32 hidden units and computes their
// i, f, g and o columns, so the tail is local to the block. Grid
// (H/32) x (B/32) = 16 x 8 blocks at B = 256.
#include "common.cuh"

// dtype: 0 = float32 operands, 1 = bfloat16. e, h, wih_e, whh in that dtype;
// s_gates, b, c, h_out, c_out f32. Returns a cudaError_t (0 = launched).
extern "C" int cxg_pos_lstm_fwd(int dtype, const void* e, const void* h, const void* s_gates,
                                const void* c, const void* wih_e, const void* whh,
                                const void* b, void* h_out, void* c_out, int rows, int ed,
                                int hd, void* stream) {
  auto run = [&](auto tag) -> cudaError_t {
    using T = decltype(tag);
    cxg::LstmArgs<T> p{};
    p.x[0] = (const T*)e;
    p.w[0] = (const T*)wih_e;
    p.kdim[0] = ed;
    p.x[1] = (const T*)h;
    p.w[1] = (const T*)whh;
    p.kdim[1] = hd;
    p.n_in = 2;
    p.addend = (const float*)s_gates;
    p.bias = (const float*)b;
    p.c = (const float*)c;
    p.h_out = (float*)h_out;
    p.c_out = (float*)c_out;
    p.rows = rows;
    p.hidden = hd;
    return cxg::launch_lstm_gates<T>(p, (cudaStream_t)stream);
  };
  if (dtype == 0) return (int)run(float{});
  if (dtype == 1) return (int)run(__nv_bfloat16{});
  return (int)cudaErrorInvalidValue;
}
