// XGating fusion: five matmuls, two sigmoid gates and a tanh in one kernel.
//
// Replaces the Pallas kernel controllable_xgating_tpu/ops/pallas/xgate.py
// (_kernel, wrapper xgate_fuse_pallas):
//   ea = xa @ Wa + ba ; em = xm @ Wm + bm
//   ga = sigmoid(round(em) @ Uga + bga) ; gm = sigmoid(round(ea) @ Ugm + bgm)
//   out = tanh(round(ea * ga) @ Wf[:H] + round(em * gm) @ Wf[H:] + bf)
// with round() to the compute dtype at the same points as the Pallas kernel.
//
// What bounds it on the card: it is a chain of back-to-back GEMMs over the
// B*T rows (6656 x (1536 + 1024) -> 512 at MSR-VTT width, ~31 GFLOP), so it
// is compute-bound (this version: by tile_gemm's staging loop, with one
// 212 KB block per SM); without fusion, ea, em, ga, gm and both gated products
// would each make a round trip through device memory.
//
// Design: a block owns 32 rows. ea and em (f32) and a third [32, H] buffer
// stay in shared memory for the whole chain (3 x 64 KB at H = 512, inside
// the 227 KB a block may use), so no intermediate reaches device memory:
//   1. ea, em  <- two GEMMs over the input rows (A from global memory);
//   2. sG      <- ga, from em;
//   3. em *= gm column block by column block (gm reads ea, not em);
//   4. ea *= ga;
//   5. out     <- tanh of both gated products through the two halves of Wf.
// Weights stream from L2 through tile_gemm's shared-memory stage. One block
// per SM fits (the buffers take ~212 KB); H is limited to what fits.
#include "common.cuh"

namespace cxg {

constexpr int kXgRows = 32;  // TM = 4

inline size_t xgate_smem_bytes(int h) {
  return (size_t)(3 * kXgRows * h + gemm_smem_floats<kXgRows / 8>()) * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    xgate_kernel(const T* __restrict__ xa, const T* __restrict__ xm, const T* __restrict__ wa,
                 const T* __restrict__ wm, const T* __restrict__ uga,
                 const T* __restrict__ ugm, const T* __restrict__ wf,
                 const float* __restrict__ ba, const float* __restrict__ bm,
                 const float* __restrict__ bga, const float* __restrict__ bgm,
                 const float* __restrict__ bf, T* __restrict__ out, int rows, int da, int dm,
                 int h) {
  constexpr int TM = kXgRows / 8;
  extern __shared__ __align__(128) float smem[];
  float* sEA = smem;
  float* sEM = sEA + kXgRows * h;
  float* sG = sEM + kXgRows * h;
  float* sA = sG + kXgRows * h;
  float* sW = sA + kXgRows * kSA;
  const int r0 = blockIdx.x * kXgRows;
  const int nrows = min(kXgRows, rows - r0);
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  float acc[TM][4];

  // 1. embeddings
  for (int n0 = 0; n0 < h; n0 += kBN) {
    const int nv = min(kBN, h - n0);
    zero_acc<TM>(acc);
    tile_gemm<T, T, TM>(acc, xa + (size_t)r0 * da, da, nrows, da, wa, h, n0, kBN, 0, nv, sA, sW);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx * 4 + j;
        if (c < nv) sEA[(ty * TM + i) * h + n0 + c] = acc[i][j] + ba[n0 + c];
      }
    zero_acc<TM>(acc);
    tile_gemm<T, T, TM>(acc, xm + (size_t)r0 * dm, dm, nrows, dm, wm, h, n0, kBN, 0, nv, sA, sW);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx * 4 + j;
        if (c < nv) sEM[(ty * TM + i) * h + n0 + c] = acc[i][j] + bm[n0 + c];
      }
  }
  // 2. ga from em (tile_gemm's entry barrier publishes sEA / sEM)
  for (int n0 = 0; n0 < h; n0 += kBN) {
    const int nv = min(kBN, h - n0);
    zero_acc<TM>(acc);
    tile_gemm<T, float, TM>(acc, sEM, h, kXgRows, h, uga, h, n0, kBN, 0, nv, sA, sW);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx * 4 + j;
        if (c < nv) sG[(ty * TM + i) * h + n0 + c] = sigmoid_f32(acc[i][j] + bga[n0 + c]);
      }
  }
  // 3. em *= gm, gm from ea: each thread rewrites only the em entries it owns
  for (int n0 = 0; n0 < h; n0 += kBN) {
    const int nv = min(kBN, h - n0);
    zero_acc<TM>(acc);
    tile_gemm<T, float, TM>(acc, sEA, h, kXgRows, h, ugm, h, n0, kBN, 0, nv, sA, sW);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx * 4 + j;
        if (c < nv) {
          float* e = &sEM[(ty * TM + i) * h + n0 + c];
          *e = *e * sigmoid_f32(acc[i][j] + bgm[n0 + c]);
        }
      }
  }
  // 4. ea *= ga (after every gm block has read ea)
  __syncthreads();
  for (int i = threadIdx.x; i < kXgRows * h; i += kThreads) sEA[i] *= sG[i];
  // 5. fused output
  for (int n0 = 0; n0 < h; n0 += kBN) {
    const int nv = min(kBN, h - n0);
    zero_acc<TM>(acc);
    tile_gemm<T, float, TM>(acc, sEA, h, kXgRows, h, wf, h, n0, kBN, 0, nv, sA, sW);
    tile_gemm<T, float, TM>(acc, sEM, h, kXgRows, h, wf + (size_t)h * h, h, n0, kBN, 0, nv, sA,
                            sW);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = ty * TM + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx * 4 + j;
        if (r < nrows && c < nv)
          out[(size_t)(r0 + r) * h + n0 + c] = from_f32<T>(tanhf(acc[i][j] + bf[n0 + c]));
      }
    }
  }
}

template <typename T>
cudaError_t launch_xgate(const void* xa, const void* xm, const void* wa, const void* wm,
                         const void* uga, const void* ugm, const void* wf, const float* ba,
                         const float* bm, const float* bga, const float* bgm, const float* bf,
                         void* out, int rows, int da, int dm, int h, cudaStream_t st) {
  const size_t smem = xgate_smem_bytes(h);
  cudaError_t err = cudaFuncSetAttribute(xgate_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int grid = (rows + kXgRows - 1) / kXgRows;
  xgate_kernel<T><<<grid, kThreads, smem, st>>>(
      (const T*)xa, (const T*)xm, (const T*)wa, (const T*)wm, (const T*)uga, (const T*)ugm,
      (const T*)wf, ba, bm, bga, bgm, bf, (T*)out, rows, da, dm, h);
  return cudaGetLastError();
}

}  // namespace cxg

// dtype: 0 = float32 operands, 1 = bfloat16 operands. Biases are f32; the
// output has the operands' dtype. Returns a cudaError_t (0 = launched).
extern "C" int cxg_xgate_fwd(int dtype, const void* xa, const void* xm, const void* wa,
                             const void* wm, const void* uga, const void* ugm, const void* wf,
                             const void* ba, const void* bm, const void* bga, const void* bgm,
                             const void* bf, void* out, int rows, int da, int dm, int h,
                             void* stream) {
  auto st = (cudaStream_t)stream;
  auto f = [](const void* p) { return (const float*)p; };
  if (dtype == 0)
    return (int)cxg::launch_xgate<float>(xa, xm, wa, wm, uga, ugm, wf, f(ba), f(bm), f(bga),
                                         f(bgm), f(bf), out, rows, da, dm, h, st);
  if (dtype == 1)
    return (int)cxg::launch_xgate<__nv_bfloat16>(xa, xm, wa, wm, uga, ugm, wf, f(ba), f(bm),
                                                 f(bga), f(bgm), f(bf), out, rows, da, dm, h,
                                                 st);
  return (int)cudaErrorInvalidValue;
}

extern "C" long cxg_xgate_smem_bytes(int h) { return (long)cxg::xgate_smem_bytes(h); }
