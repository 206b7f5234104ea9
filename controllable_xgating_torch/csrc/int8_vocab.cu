// Weight-only int8 vocab projection for the quantized decode path.
//
// Replaces the Pallas kernel experiments/int8_vocab_matmul.py (_kernel,
// line 87, called from _int8_matmul_pallas):
//   out[m, j] = f32(bf16(x[m, :]) @ bf16(wq[:, j])) * scale[j] + bias[j]
// for the n true vocab columns j < n. x is bf16 [M, K]; the weight comes
// K-major, wq_t = wq^T int8 [Vpad, Kp] (Kp = K rounded up to 64, zeros
// past K), with the 64 bytes of each K block in fragment order (below),
// made once per caption call (ops/kernels/int8_vocab.py); its rows are
// padded to a multiple of 1024 with zeros; scale and bias are f32 [Vpad];
// out is f32 [M, n], row-major. int8 -> bf16 is exact (|q| <= 127), the
// products are exact in f32 and the sums are f32, so the result equals the
// plain version up to summation order. The epilogue rounds the multiply
// and the add apart (no fused multiply-add), as the plain version does.
//
// What bounds it on the card: bytes. A beam step (M = 1280, K = 512,
// n = 10000) writes 51.2 MB of f32 logits and reads 5.2 MB of int8 weight:
// 0.017 ms at 3.35 TB/s, against 0.013 ms for its 13.1 GFLOP on the bf16
// tensor cores. A greedy step (M = 256) writes 10.2 MB.
//
// Design, on hopper_gemm.cuh's TMA + mbarrier ring and wgmma: the
// transposed product out^T = wq^T x^T, whose A operand, the weight, goes
// to wgmma from registers, so that int8 is widened to bf16 in registers on
// its way in and never goes back through shared memory. A block of two
// warpgroups owns [128 vocab, 128 x rows] output tiles; each 64-deep K step
// brings wq_t's [128, 64] int8 tile (8 KB, unswizzled) and x's [128, 64]
// bf16 tile (16 KB, 128-byte swizzle: wgmma's B) into a 4-stage ring by
// TMA. Each warpgroup takes 64 of the vocab rows (m64n128k16, B shared):
// a thread needs, of each of its two rows, the bytes at k = 16 kk + 2q +
// {0, 1, 8, 9} for the four 16-deep chunks kk (q = lane % 4), which the
// packing puts at bytes 16q .. 16q + 15 of the row's block, so they come
// in one 16-byte shared load (a warp reads 512 contiguous bytes). A step's
// products retire before the next step widens into the same registers
// (the registers must hold still while wgmma reads them); one barrier a
// step then frees the stage, and thread 0 refills it S steps ahead.
//
// The stores bound the kernel, so they must run under other tiles'
// products: the blocks are persistent (two an SM, 97 KB of shared memory
// each), each walking its tiles with the ring running on across them (the
// next tile's loads start during this one's last steps and epilogue), and
// the epilogue writes straight from the accumulator registers: scale and
// bias of a thread's two vocab rows sit in registers, and each warp store
// covers eight consecutive vocab columns of four x rows (four whole
// 32-byte sectors when n % 8 == 0; any n is taken, the stores are scalar
// and guarded).
#include "hopper_gemm.cuh"

namespace cxg {

constexpr int kI8Wgs = 2;
constexpr int kI8Threads = kI8Wgs * hop::kThreads;      // 256
constexpr int kI8Vocab = kI8Wgs * hop::kTileM;          // 128 vocab rows a tile
constexpr int kI8Rows = hop::kTileN;                    // 128 x rows a tile (wgmma n128)
constexpr int kI8Stages = 4;
constexpr int kI8XBytes = kI8Rows * hop::kTileK * 2;    // x tile: 16 KB
constexpr int kI8QBytes = kI8Vocab * hop::kTileK;       // int8 tile: 8 KB
constexpr int kI8StageBytes = kI8XBytes + kI8QBytes;    // 24 KB
constexpr int kI8TileBytes = kI8Stages * kI8StageBytes;  // 96 KB

inline size_t int8_vocab_smem_bytes() { return hop::smem_request(kI8TileBytes); }

// bytes 2h, 2h + 1 of w (int8) -> two bf16 in one word, the first in the
// low half; exact: a byte b ^ 0x80 under the exponent of 2^23 is 2^23 +
// 128 + b, and an integer of |b| <= 128 fills the top 16 bits of its f32
__device__ __forceinline__ uint32_t widen2(uint32_t w, int h) {
  const uint32_t u = w ^ 0x80808080u;
  const float a = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + 2 * h)) - 8388736.0f;
  const float b = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441 + 2 * h)) - 8388736.0f;
  return __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632);
}

// One K step: this thread's fragments of stage s's int8 tile (its rows
// `row`, row + 8 of the block's 128), widened into a, then four wgmma on
// the stage's x tile.
__device__ __forceinline__ void int8_vocab_step(float (&acc)[64], uint32_t (&a)[4][4],
                                                const uint8_t* stage, int row, int q, bool first) {
  const uint4 lo = *reinterpret_cast<const uint4*>(stage + kI8XBytes + row * 64 + 16 * q);
  const uint4 hi = *reinterpret_cast<const uint4*>(stage + kI8XBytes + (row + 8) * 64 + 16 * q);
  const uint32_t wl[4] = {lo.x, lo.y, lo.z, lo.w}, wh[4] = {hi.x, hi.y, hi.z, hi.w};
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {  // word kk: k = 16 kk + 2q + {0, 1, 8, 9}
    a[kk][0] = widen2(wl[kk], 0);
    a[kk][1] = widen2(wh[kk], 0);
    a[kk][2] = widen2(wl[kk], 1);
    a[kk][3] = widen2(wh[kk], 1);
  }
  const uint64_t db = hop::sw128_desc(stage);
  hop::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    hop::wgmma_m64n128k16_rs(acc, a[kk], db + 2 * kk, !first || kk != 0);
  hop::wgmma_commit();
}

__global__ void __launch_bounds__(kI8Threads, 2)
    int8_vocab_kernel(const __grid_constant__ CUtensorMap map_x,
                      const __grid_constant__ CUtensorMap map_q, const float* __restrict__ scale,
                      const float* __restrict__ bias, float* __restrict__ out, int m, int kdim,
                      int n) {
  constexpr int S = kI8Stages;
  extern __shared__ __align__(1024) uint8_t i8_smem_raw[];
  uint64_t* full;
  uint8_t* ring = hop::smem_layout(i8_smem_raw, kI8TileBytes, &full);
  const int wg = threadIdx.x / hop::kThreads, lane = threadIdx.x & 31;
  const int q = lane & 3;
  const int row = wg * hop::kTileM + 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);  // and row + 8
  const int nk = (kdim + hop::kTileK - 1) / hop::kTileK;
  const int vtiles = (n + kI8Vocab - 1) / kI8Vocab;
  const int ntiles = vtiles * ((m + kI8Rows - 1) / kI8Rows);
  const int mine = (ntiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int total = mine * nk;  // loads this block streams, tile-major
  const CUtensorMap* mx = &map_x;
  const CUtensorMap* mq = &map_q;
  auto load = [=](int j) {
    const int t = blockIdx.x + (j / nk) * gridDim.x, kt = j % nk;
    uint8_t* stage = ring + (j % S) * kI8StageBytes;
    uint64_t* bar = &full[j % S];
    hop::mbar_expect_tx(bar, kI8StageBytes);
    hop::tma_load(stage, mx, bar, kt * hop::kTileK, (t / vtiles) * kI8Rows);
    hop::tma_load(stage + kI8XBytes, mq, bar, kt * hop::kTileK, (t % vtiles) * kI8Vocab);
  };
  hop::ring_start<S>(full, 0, total, load);

  float acc[64];
  uint32_t a[4][4];
  int j = 0;
  for (int it = 0; it < mine; ++it) {
    const int t = blockIdx.x + it * gridDim.x;
    const int x0 = (t / vtiles) * kI8Rows, v0 = (t % vtiles) * kI8Vocab;
    float sc[2], bi[2];  // this thread's vocab rows' scale and bias (vpad % 128 == 0)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sc[h] = scale[v0 + row + 8 * h];
      bi[h] = bias[v0 + row + 8 * h];
    }
    hop::fence_acc(acc);
    for (int kt = 0; kt < nk; ++kt, ++j) {
      const int s = j % S;
      hop::mbar_wait(&full[s], (j / S) & 1);
      int8_vocab_step(acc, a, ring + s * kI8StageBytes, row, q, kt == 0);
      // retire the step before its fragment registers change again (the
      // SM's other three warpgroups keep the tensor cores busy meanwhile)
      hop::wgmma_wait<0>();
      __syncthreads();  // the step has retired in the other warpgroup too: its stage is free
      if (threadIdx.x == 0 && j + S < total) load(j + S);
    }
    hop::fence_acc(acc);
    // out[x0 + c][v0 + r] for accumulator row r (vocab), column c (x row)
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int h = (i >> 1) & 1;
      const int v = v0 + row + 8 * h, x = x0 + 8 * (i >> 2) + 2 * q + (i & 1);
      if (v < n && x < m) out[(size_t)x * n + v] = __fadd_rn(__fmul_rn(acc[i], sc[h]), bi[h]);
    }
  }
}

}  // namespace cxg

// x bf16 [m, kdim] (kdim % 8 == 0); wq_t int8 [vpad, kp] (kp = kdim
// rounded up to 64, in fragment order); scale, bias f32 [vpad] (vpad % 128
// == 0); out f32 [m, n] (n <= vpad); x and wq_t 16-byte
// aligned. Returns a cudaError_t (0 = launched).
extern "C" int cxg_int8_vocab_fwd(const void* x, const void* wq_t, const void* scale,
                                  const void* bias, void* out, int m, int kdim, int n, int vpad,
                                  int kp, void* stream) {
  namespace hop = cxg::hop;
  if (kdim % 8 || kp % hop::kTileK || kp < kdim || vpad % cxg::kI8Vocab || n > vpad || m < 1 ||
      n < 1)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map_x, map_q;
  cudaError_t err = hop::make_tmap(&map_x, x, m, kdim, kdim, cxg::kI8Rows);
  if (err == cudaSuccess)
    err = hop::make_tmap_2d(&map_q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, wq_t, vpad, kp, kp,
                            hop::kTileK, cxg::kI8Vocab, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != cudaSuccess) return (int)err;
  const int smem = (int)cxg::int8_vocab_smem_bytes();
  static hop::SmemLimits smem_set;
  static int sms = 0;
  err = hop::allow_smem(cxg::int8_vocab_kernel, smem, smem_set);
  if (err == cudaSuccess && sms == 0) {
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return (int)err;
  const int ntiles = ((n + cxg::kI8Vocab - 1) / cxg::kI8Vocab) * ((m + cxg::kI8Rows - 1) / cxg::kI8Rows);
  const int grid = ntiles < 2 * sms ? ntiles : 2 * sms;  // persistent: two blocks an SM
  cxg::int8_vocab_kernel<<<grid, cxg::kI8Threads, smem, (cudaStream_t)stream>>>(
      map_x, map_q, (const float*)scale, (const float*)bias, (float*)out, m, kdim, n);
  return (int)cudaGetLastError();
}
