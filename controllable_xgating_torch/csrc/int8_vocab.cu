// Weight-only int8 vocab projection for the quantized decode path.
//
// Replaces the Pallas kernel experiments/int8_vocab_matmul.py (_kernel,
// line 87, called from _int8_matmul_pallas):
//   out[m, j] = f32(bf16(x[m, :]) @ bf16(wq[:, j])) * scale[j] + bias[j]
// for the n true vocab columns j < n. x is bf16 [M, K]; wq is int8
// [K, ldw], its columns padded to a multiple of 1024 (zeros); scale and
// bias are f32 [ldw]; out is f32 [M, n], row-major. int8 -> bf16 is exact
// (|q| <= 127), the products are exact in f32 and the sums are f32, so the
// result equals the plain version up to summation order. The epilogue
// rounds the multiply and the add apart (no fused multiply-add), as the
// plain version does.
//
// What bounds it on the card: bytes. A beam step (M = 1280, K = 512,
// n = 10000) writes 51.2 MB of f32 logits and reads 5.2 MB of int8 weight:
// 0.017 ms at 3.35 TB/s, against 0.013 ms for its 13.1 GFLOP on the bf16
// tensor cores. A greedy step (M = 256) writes 10.2 MB.
//
// Design: one 256-thread block per (64-row, 128-column) output tile, the
// tile's columns inside the padded width; grid (ceil(n / 128),
// ceil(M / 64)). The depth is walked in stages of 32: each thread loads 16
// bytes of x (8 bf16) and 16 bytes of wq (16 int8) per stage, widens the
// int8 to bf16 on its way into shared memory, and starts the next stage's
// loads before this stage's products. The products run on the tensor
// cores (wmma 16x16x16 bf16, f32 accumulators): warp w owns the 16-column
// strip w of the tile for all 64 rows. The f32 tile goes through shared
// memory, which the stages reuse, to coalesced stores that apply the scale
// and the bias and leave out the columns >= n and rows >= M.
#include "common.cuh"

namespace cxg {

constexpr int kI8Rows = 64;            // rows per block
constexpr int kI8A = kBK + 8;          // bf16 row stride of the x stage
constexpr int kI8W = kBN + 8;          // bf16 row stride of the weight stage
constexpr int kI8C = kBN + 4;          // f32 row stride of the result tile
constexpr int kI8Smem = kI8Rows * kI8C * 4;  // the result tile; the stages fit in it
static_assert((kI8Rows * kI8A + kBK * kI8W) * 2 <= kI8Smem, "stages must fit the result tile");
static_assert(kI8Rows * kBK / 8 == kThreads, "one 16-byte x piece per thread and stage");
static_assert(kBK * kBN / 16 == kThreads, "one 16-byte wq piece per thread and stage");

// int8 bytes sh/8 and sh/8 + 1 of w -> two bf16 in one word (exact: |q| <= 127)
__device__ __forceinline__ uint32_t widen2(uint32_t w, int sh) {
  const int a = (int)(int8_t)(w >> sh), b = (int)(int8_t)(w >> (sh + 8));
  __nv_bfloat162 p = __halves2bfloat162(__int2bfloat16_rn(a), __int2bfloat16_rn(b));
  return *reinterpret_cast<uint32_t*>(&p);
}

// 16 int8 in a uint4 -> 16 bf16 in two uint4, in order
__device__ __forceinline__ void widen16(const uint4& q, uint4& lo, uint4& hi) {
  lo = make_uint4(widen2(q.x, 0), widen2(q.x, 16), widen2(q.y, 0), widen2(q.y, 16));
  hi = make_uint4(widen2(q.z, 0), widen2(q.z, 16), widen2(q.w, 0), widen2(q.w, 16));
}

__global__ void __launch_bounds__(kThreads)
    int8_vocab_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ wq,
                      const float* __restrict__ scale, const float* __restrict__ bias,
                      float* __restrict__ out, int m, int kdim, int n, int ldw) {
  namespace wmma = nvcuda::wmma;
  __shared__ __align__(128) unsigned char smem[kI8Smem];
  __nv_bfloat16* tA = reinterpret_cast<__nv_bfloat16*>(smem);  // [64][40]
  __nv_bfloat16* tW = tA + kI8Rows * kI8A;                      // [32][136]
  float* sC = reinterpret_cast<float*>(smem);                   // [64][132], after the products
  const int tid = threadIdx.x, warp = tid >> 5;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kI8Rows;

  // this thread's x piece: row ar, depth ak.. ak+7; its wq piece: depth
  // wk, columns wc.. wc+15
  const int ar = tid / (kBK / 8), ak = (tid % (kBK / 8)) * 8;
  const int wk = tid / (kBN / 16), wc = (tid % (kBN / 16)) * 16;
  const bool a_live = m0 + ar < m;
  const uint4 zero = make_uint4(0, 0, 0, 0);
  const __nv_bfloat16* xrow = x + (size_t)(m0 + ar) * kdim + ak;
  const int8_t* wcol = wq + (size_t)wk * ldw + n0 + wc;
  uint4 av = a_live ? *reinterpret_cast<const uint4*>(xrow) : zero;
  uint4 wv = *reinterpret_cast<const uint4*>(wcol);

  constexpr int RB = kI8Rows / 16;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[RB];
#pragma unroll
  for (int rb = 0; rb < RB; ++rb) wmma::fill_fragment(c[rb], 0.0f);

  for (int k0 = 0; k0 < kdim; k0 += kBK) {
    *reinterpret_cast<uint4*>(tA + ar * kI8A + ak) = av;
    uint4 lo, hi;
    widen16(wv, lo, hi);
    *reinterpret_cast<uint4*>(tW + wk * kI8W + wc) = lo;
    *reinterpret_cast<uint4*>(tW + wk * kI8W + wc + 8) = hi;
    __syncthreads();
    if (k0 + kBK < kdim) {  // the next stage's loads overlap this stage's products
      av = a_live ? *reinterpret_cast<const uint4*>(xrow + k0 + kBK) : zero;
      wv = *reinterpret_cast<const uint4*>(wcol + (size_t)(k0 + kBK) * ldw);
    }
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
      wmma::load_matrix_sync(b, tW + kk * kI8W + warp * 16, kI8W);
#pragma unroll
      for (int rb = 0; rb < RB; ++rb) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::load_matrix_sync(a, tA + rb * 16 * kI8A + kk, kI8A);
        wmma::mma_sync(c[rb], a, b, c[rb]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int rb = 0; rb < RB; ++rb)
    wmma::store_matrix_sync(sC + rb * 16 * kI8C + warp * 16, c[rb], kI8C, wmma::mem_row_major);
  __syncthreads();
  // coalesced epilogue: consecutive threads take consecutive columns
  const int col = n0 + (tid % kBN);
  if (col >= n) return;
  const float s = scale[col], bb = bias[col];
  for (int r = tid / kBN; r < kI8Rows; r += kThreads / kBN) {
    if (m0 + r >= m) break;
    out[(size_t)(m0 + r) * n + col] = __fadd_rn(__fmul_rn(sC[r * kI8C + (tid % kBN)], s), bb);
  }
}

}  // namespace cxg

// x bf16 [m, kdim]; wq int8 [kdim, ldw]; scale, bias f32 [ldw]; out f32
// [m, n]. kdim % 32 == 0, ldw % 128 == 0 and n <= ldw; x and wq 16-byte
// aligned. Returns a cudaError_t (0 = launched).
extern "C" int cxg_int8_vocab_fwd(const void* x, const void* wq, const void* scale,
                                  const void* bias, void* out, int m, int kdim, int n, int ldw,
                                  void* stream) {
  if (kdim % cxg::kBK || ldw % cxg::kBN || n > ldw || m < 1 || n < 1)
    return (int)cudaErrorInvalidValue;
  dim3 grid((n + cxg::kBN - 1) / cxg::kBN, (m + cxg::kI8Rows - 1) / cxg::kI8Rows);
  cxg::int8_vocab_kernel<<<grid, cxg::kThreads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const int8_t*)wq, (const float*)scale, (const float*)bias,
      (float*)out, m, kdim, n, ldw);
  return (int)cudaGetLastError();
}
