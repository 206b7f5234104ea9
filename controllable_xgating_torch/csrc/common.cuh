// Shared device code for the port's Hopper kernels (sm_90a).
//
// Precision contract (ops/precision.py): matmul operands are in the compute
// dtype T (float or bf16), every sum is f32. Operands computed in f32
// inside a kernel are rounded to T where the JAX kernel casts them, so the
// arithmetic equals a T x T -> f32 matmul up to summation order.
//
// tile_gemm is the one matrix product all four kernels use: a 256-thread
// block computes a [BM, 128] f32 tile of A @ W, A rows from global or
// shared memory, W streamed from global memory (L2) through a [32, 128]
// shared-memory stage, and hands each thread TM rows x 4 adjacent columns
// of the result. bf16 operands go through the tensor cores (warp MMA,
// 16x16x16, f32 accumulators); f32 operands through SIMT FMA, so the f32
// policy stays full f32 (no TF32). No TMA, no wgmma, no double buffering
// yet: later work.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace cxg {

constexpr int kThreads = 256;  // 8 warps
constexpr int kBN = 128;       // tile columns (32 lanes x 4)
constexpr int kBK = 32;        // depth of one shared-memory stage
constexpr int kSA = kBK + 1;   // padded row stride of the A stage
constexpr unsigned kFull = 0xffffffffu;
constexpr int kTcA = kBK + 8;  // bf16 row stride of the tensor-core A stage
constexpr int kTcW = kBN + 8;  // bf16 row stride of the tensor-core W stage
constexpr int kTcC = kBN + 4;  // f32 row stride of the tensor-core result tile

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

// x rounded to T's precision, returned as f32
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32<T>(from_f32<T>(x));
}

__device__ __forceinline__ float sigmoid_f32(float x) { return 1.0f / (1.0f + expf(-x)); }

// Shared-memory floats tile_gemm needs for its stages.
template <int TM> __host__ __device__ constexpr int gemm_smem_floats() { return 8 * TM * kSA + kBK * kBN; }

// acc[i][j] += sum_k round_T(A[row][k]) * W[k][col(c)], for the thread's
// rows row = ty*TM + i and tile columns c = tx*4 + j (ty = warp, tx = lane).
//   A: rows of length >= K at stride lda, element type TA (T from global
//      memory, float for f32 intermediates kept in shared memory); rows
//      >= a_rows read as 0.
//   W: row-major [K, ldw] of T. Tile column c maps to W column
//      n0 + (c / gw) * gs + (c % gw), and reads as 0 unless c % gw < gvalid.
//      (gw = 128, gs = 0 is a plain column window; gw = 32, gs = H picks
//      the same 32 hidden units out of each of the four LSTM gate blocks.)
// Starts and ends with all threads past a barrier, so callers may reuse sA,
// sW and anything they wrote before the call. sA and sW must be the
// contiguous region of gemm_smem_floats<TM>() floats, 128-byte aligned.
template <typename T, typename TA, int TM>
__device__ __forceinline__ void tile_gemm(float (&acc)[TM][4], const TA* __restrict__ A,
                                          int lda, int a_rows, int K,
                                          const T* __restrict__ W, int ldw, int n0,
                                          int gw, int gs, int gvalid, float* sA,
                                          float* sW) {
  constexpr int BM = 8 * TM;
  const int tid = threadIdx.x;
  const int tx = tid & 31;
  const int ty = tid >> 5;
  __syncthreads();
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    // Tensor cores: warp w computes the 16-column strip w of the tile for
    // all BM rows; stages are bf16, the result goes through an f32 tile
    // that reuses the stage region once the products are done.
    namespace wmma = nvcuda::wmma;
    static_assert(BM % 16 == 0, "tensor-core tile_gemm needs BM % 16 == 0");
    static_assert(BM * kTcC <= gemm_smem_floats<TM>(), "result tile must fit the stages");
    constexpr int RB = BM / 16;
    __nv_bfloat16* tA = reinterpret_cast<__nv_bfloat16*>(sA);
    __nv_bfloat16* tW = tA + BM * kTcA;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[RB];
#pragma unroll
    for (int rb = 0; rb < RB; ++rb) wmma::fill_fragment(c[rb], 0.0f);
    // Staging: 16-byte loads of 8 bf16 where rows and column groups are
    // 8-aligned, with the next stage's loads issued before this stage's
    // products so that they overlap; element-wise loads otherwise.
    auto aligned16 = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
    const bool vec_w = ldw % 8 == 0 && n0 % 8 == 0 && gs % 8 == 0 && gw % 8 == 0 &&
                       gvalid % 8 == 0 && K % kBK == 0 && aligned16(W);
    bool vec_a = false;
    if constexpr (std::is_same<TA, __nv_bfloat16>::value)
      vec_a = lda % 8 == 0 && K % kBK == 0 && aligned16(A);
    constexpr int kWv = kBK * kBN / 8 / kThreads;  // 16-byte W pieces per thread
    constexpr int kAv = BM * kBK / 8;              // 16-byte A pieces per stage
    const uint4 zero = make_uint4(0, 0, 0, 0);
    uint4 wv[kWv], av = zero;
    auto fetch = [&](int k0) {
      if (vec_w) {
#pragma unroll
        for (int q = 0; q < kWv; ++q) {
          const int i = tid + q * kThreads;
          const int kk = i / (kBN / 8), cc = (i % (kBN / 8)) * 8;
          wv[q] = zero;
          if ((cc % gw) < gvalid)
            wv[q] = *reinterpret_cast<const uint4*>(
                W + (size_t)(k0 + kk) * ldw + n0 + (cc / gw) * gs + (cc % gw));
        }
      }
      if (vec_a && tid < kAv) {
        const int r = tid / (kBK / 8), kk = (tid % (kBK / 8)) * 8;
        av = r < a_rows ? *reinterpret_cast<const uint4*>(A + (size_t)r * lda + k0 + kk) : zero;
      }
    };
    fetch(0);
    for (int k0 = 0; k0 < K; k0 += kBK) {
      if (vec_a) {
        if (tid < kAv)
          *reinterpret_cast<uint4*>(tA + (tid / (kBK / 8)) * kTcA + (tid % (kBK / 8)) * 8) = av;
      } else {
        for (int i = tid; i < BM * kBK; i += kThreads) {
          const int r = i / kBK, kk = i % kBK;
          float v = 0.0f;
          if (r < a_rows && k0 + kk < K) v = to_f32(A[(size_t)r * lda + k0 + kk]);
          tA[r * kTcA + kk] = __float2bfloat16(v);
        }
      }
      if (vec_w) {
#pragma unroll
        for (int q = 0; q < kWv; ++q) {
          const int i = tid + q * kThreads;
          *reinterpret_cast<uint4*>(tW + (i / (kBN / 8)) * kTcW + (i % (kBN / 8)) * 8) = wv[q];
        }
      } else {
        for (int i = tid; i < kBK * kBN; i += kThreads) {
          const int kk = i / kBN, cc = i % kBN;
          __nv_bfloat16 v = __float2bfloat16(0.0f);
          if (k0 + kk < K && (cc % gw) < gvalid)
            v = W[(size_t)(k0 + kk) * ldw + n0 + (cc / gw) * gs + (cc % gw)];
          tW[kk * kTcW + cc] = v;
        }
      }
      __syncthreads();
      if (k0 + kBK < K) fetch(k0 + kBK);
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        wmma::load_matrix_sync(b, tW + kk * kTcW + ty * 16, kTcW);
#pragma unroll
        for (int rb = 0; rb < RB; ++rb) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
          wmma::load_matrix_sync(a, tA + rb * 16 * kTcA + kk, kTcA);
          wmma::mma_sync(c[rb], a, b, c[rb]);
        }
      }
      __syncthreads();
    }
    float* sC = sA;
#pragma unroll
    for (int rb = 0; rb < RB; ++rb)
      wmma::store_matrix_sync(sC + rb * 16 * kTcC + ty * 16, c[rb], kTcC, wmma::mem_row_major);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += sC[(ty * TM + i) * kTcC + tx * 4 + j];
    __syncthreads();
  } else {
    for (int k0 = 0; k0 < K; k0 += kBK) {
      for (int i = tid; i < BM * kBK; i += kThreads) {
        const int r = i / kBK, kk = i % kBK;
        float v = 0.0f;
        if (r < a_rows && k0 + kk < K) v = round_to<T>(to_f32(A[(size_t)r * lda + k0 + kk]));
        sA[r * kSA + kk] = v;
      }
      for (int i = tid; i < kBK * kBN; i += kThreads) {
        const int kk = i / kBN, c = i % kBN;
        float v = 0.0f;
        if (k0 + kk < K && (c % gw) < gvalid) {
          const int col = n0 + (c / gw) * gs + (c % gw);
          v = to_f32(W[(size_t)(k0 + kk) * ldw + col]);
        }
        sW[kk * kBN + c] = v;
      }
      __syncthreads();
      const int kend = min(kBK, K - k0);
      for (int kk = 0; kk < kend; ++kk) {
        const float4 b = *reinterpret_cast<const float4*>(&sW[kk * kBN + tx * 4]);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float a = sA[(ty * TM + i) * kSA + kk];
          acc[i][0] += a * b.x;
          acc[i][1] += a * b.y;
          acc[i][2] += a * b.z;
          acc[i][3] += a * b.w;
        }
      }
      __syncthreads();
    }
  }
}

template <int TM> __device__ __forceinline__ void zero_acc(float (&acc)[TM][4]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// ---------------------------------------------------------------------------
// LSTM gates + cell tail, split by hidden unit.
//
// gates = sum_p x_p @ W_p (+ addend) + bias, then
// c' = sigmoid(f) * c + sigmoid(i) * tanh(g), h' = sigmoid(o) * tanh(c').
// A block owns 32 rows and the 32 hidden units j0..j0+31: it computes gate
// columns j, H+j, 2H+j and 3H+j of each, so the i/f/g/o tail is local and
// needs no reduction across blocks. Weights [K_p, 4H] of every block's
// column slice stream from L2; grid = (ceil(H/32), ceil(R/32)).
// ---------------------------------------------------------------------------
constexpr int kLstmRows = 32;  // TM = 4
constexpr int kLstmUnits = 32;

template <typename T> struct LstmArgs {
  const T* x[3];          // [R, K_p] operands in the compute dtype
  const T* w[3];          // [K_p, 4H]
  int kdim[3];
  int n_in;
  const float* addend;    // [R, 4H] f32 or nullptr
  const float* bias;      // [4H] f32
  const float* c;         // [R, H] f32
  float* h_out;           // [R, H] f32
  float* c_out;           // [R, H] f32
  int rows;
  int hidden;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) lstm_gates_kernel(LstmArgs<T> p) {
  constexpr int TM = kLstmRows / 8;
  extern __shared__ __align__(128) float smem[];
  float* sG = smem;                         // [32][128] gate pre-activations
  float* sA = sG + kLstmRows * kBN;
  float* sW = sA + kLstmRows * kSA;
  const int H = p.hidden;
  const int j0 = blockIdx.x * kLstmUnits;
  const int r0 = blockIdx.y * kLstmRows;
  const int nrows = min(kLstmRows, p.rows - r0);
  const int nunits = min(kLstmUnits, H - j0);
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;

  float acc[TM][4];
  zero_acc<TM>(acc);
  for (int q = 0; q < p.n_in; ++q)
    tile_gemm<T, T, TM>(acc, p.x[q] + (size_t)r0 * p.kdim[q], p.kdim[q], nrows, p.kdim[q],
                        p.w[q], 4 * H, j0, kLstmUnits, H, nunits, sA, sW);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = ty * TM + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx * 4 + j;
      const int u = c % kLstmUnits;
      float v = 0.0f;
      if (r < nrows && u < nunits) {
        const int col = (c / kLstmUnits) * H + j0 + u;
        v = acc[i][j] + p.bias[col];
        if (p.addend) v += p.addend[(size_t)(r0 + r) * 4 * H + col];
      }
      sG[r * kBN + c] = v;
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < kLstmRows * kLstmUnits; idx += kThreads) {
    const int r = idx / kLstmUnits, u = idx % kLstmUnits;
    if (r >= nrows || u >= nunits) continue;
    const float* g = sG + r * kBN;
    const float ig = sigmoid_f32(g[u]);
    const float fg = sigmoid_f32(g[kLstmUnits + u]);
    const float gg = tanhf(g[2 * kLstmUnits + u]);
    const float og = sigmoid_f32(g[3 * kLstmUnits + u]);
    const size_t o = (size_t)(r0 + r) * H + j0 + u;
    const float c_new = fg * p.c[o] + ig * gg;
    p.c_out[o] = c_new;
    p.h_out[o] = og * tanhf(c_new);
  }
}

template <typename T> inline cudaError_t launch_lstm_gates(const LstmArgs<T>& p, cudaStream_t st) {
  const size_t smem = (size_t)(kLstmRows * kBN + gemm_smem_floats<kLstmRows / 8>()) * sizeof(float);
  dim3 grid((p.hidden + kLstmUnits - 1) / kLstmUnits, (p.rows + kLstmRows - 1) / kLstmRows);
  lstm_gates_kernel<T><<<grid, kThreads, smem, st>>>(p);
  return cudaGetLastError();
}

}  // namespace cxg
