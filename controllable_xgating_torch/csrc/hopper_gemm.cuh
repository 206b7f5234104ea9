// The Hopper GEMM mainloop shared by the redesigned kernels under the bf16
// policy: attn_lstm.cu's pre-activation and cell products, xgate.cu's
// GEMM chain and topk_extract.cu's projection on streamed_tile below,
// topk_tail.cu's vocab projection and pos_lstm.cu's gates on mma_tile;
// int8_vocab.cu on its own loop over the same ring, with its weight as
// wgmma's register operand (wgmma_m64n128k16_rs).
//
// A warpgroup (128 threads) computes a [64, N] f32 tile (N = 128 or 64)
// of A @ B^T with `wgmma.mma_async` m64nNk16 (bf16 x bf16 -> f32), both
// operands K-major in shared memory with the 128-byte swizzle; a block
// holds one or more such warpgroups, which share the ring. Tiles come
// from device memory by TMA (`cp.async.bulk.tensor`, one thread starts,
// an `mbarrier` per stage counts the bytes in) through a ring of S stages
// of 64-deep K steps; loads run S - 1 steps ahead of the products, and a
// stage is refilled as soon as the wgmma group that read it has retired.
// TMA fills rows and columns past the tensor's edge with zeros, so ragged
// M, N and K need no code here; the caller's epilogue masks its stores.
//
// The caller owns the shared-memory layout, the stream of loads (which
// tile goes into which stage, through `load`) and the epilogue, which
// reads the accumulator in registers: element i of a thread's N / 2 lies
// at tile row acc_row(i), column acc_col(i).
//
// The TMA descriptors come from libcuda's cuTensorMapEncodeTiled, reached
// through the runtime's entry-point lookup: no link against libcuda.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cxg {
namespace hop {

constexpr int kThreads = 128;  // one warpgroup
constexpr int kTileM = 64;     // wgmma m64
constexpr int kTileN = 128;    // wgmma n128
constexpr int kTileK = 64;     // one stage: 64 bf16 = the 128-byte swizzle span
constexpr int kATileBytes = kTileM * kTileK * 2;  // 8 KB
constexpr int kBTileBytes = kTileN * kTileK * 2;  // 16 KB
constexpr int kAlign = 1024;   // a 128-byte-swizzle atom: 8 rows x 128 bytes

// ---------------------------------------------------------------- host

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (EncodeTiledFn)p;
  }
  return fn;
}

// A TMA descriptor of a row-major matrix [rows, cols] of `elem_bytes`-byte
// elements whose rows lie `pitch` elements apart (pitch * elem_bytes % 16
// == 0, base 16-byte aligned), moved in boxes of [box_rows, box_cols].
inline cudaError_t make_tmap_2d(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes,
                                const void* base, int rows, int cols, int pitch, int box_cols,
                                int box_rows, CUtensorMapSwizzle swizzle) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  if ((reinterpret_cast<uintptr_t>(base) & 15) || (pitch * elem_bytes) % 16 || pitch < cols ||
      rows < 1 || cols < 1)
    return cudaErrorInvalidValue;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)pitch * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult r = encode(map, type, 2, const_cast<void*>(base), dims, strides, box,
                            elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A TMA descriptor of a row-major bf16 matrix [rows, cols] whose rows lie
// `pitch` elements apart (pitch % 8 == 0, base 16-byte aligned), read in
// boxes of [box_rows, 64] with the 128-byte swizzle.
inline cudaError_t make_tmap(CUtensorMap* map, const void* base, int rows, int cols, int pitch,
                             int box_rows) {
  return make_tmap_2d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, rows, cols, pitch, kTileK,
                      box_rows, CU_TENSOR_MAP_SWIZZLE_128B);
}

// Dynamic shared memory a kernel asks for: `bytes` of tiles and room to
// align them to kAlign, which also holds up to 64 mbarriers (smem_layout).
// Nothing more, so that two 113 KB blocks still share an SM's 228 KB.
inline size_t smem_request(size_t bytes) { return bytes + kAlign; }

// The dynamic shared memory limits this process has raised for one
// kernel, per device: the attribute is the current device's own, so a
// second card starts from the default.
struct SmemLimits {
  static constexpr int kDevices = 64;
  int bytes[kDevices] = {};
};

// Raise a kernel's dynamic shared memory limit on the current device to
// `bytes` where it is below; `current` remembers what this process has
// set on each device.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, int bytes, SmemLimits& current) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= SmemLimits::kDevices) return cudaErrorInvalidDevice;
  if (bytes <= current.bytes[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) current.bytes[dev] = bytes;
  return err;
}

// --------------------------------------------------------------- device

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The tiles start at the first kAlign-aligned byte of the dynamic shared
// memory (smem_request(tile_bytes) of it); the mbarriers go into the
// alignment gap before them if it has room for 64, else right after them.
__device__ __forceinline__ uint8_t* smem_layout(uint8_t* raw, int tile_bytes, uint64_t** bars) {
  const int gap = (kAlign - (smem_u32(raw) & (kAlign - 1))) & (kAlign - 1);
  *bars = reinterpret_cast<uint64_t*>(gap >= 8 * 64 ? raw : raw + gap + tile_bytes);
  return raw + gap;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// arrive once and expect `bytes` more of TMA traffic in this phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// wait for the completion of the barrier's phase of this parity
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// TMA: the box at (column c0, row c1) of `map` into shared memory at dst
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// bulk copy of `bytes` contiguous bytes (a multiple of 16, both ends
// 16-byte aligned) from device to shared memory, counted on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// wgmma descriptor of a K-major tile with the 128-byte swizzle: rows of
// 128 bytes, 8-row groups 1024 bytes apart (SBO), leading offset unused
// (1); the tile starts kAlign-aligned. Adding 2 steps 32 bytes = 16 bf16
// along K inside the swizzle span.
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  const uint64_t addr = smem_u32(tile);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads of the accumulator across a wait
template <int M> __device__ __forceinline__ void fence_acc(float (&d)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A[64 x 16] @ B[N x 16]^T, both K-major in shared memory
__device__ __forceinline__ void wgmma_m64nk16(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                              int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_m64nk16(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                              int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (+)= A[64 x 16] @ B[128 x 16]^T, A from registers (the m16n8k16 A
// fragment of warp w's rows 16w .. 16w + 15: a[0] = (row g, k 2q, 2q + 1),
// a[1] = (row g + 8, same k), a[2] = (row g, k 2q + 8, 2q + 9), a[3] =
// (row g + 8, same k), g = lane / 4, q = lane % 4, two bf16 a register, the
// lower k in the low half), B K-major in shared memory. The registers must
// hold still until the wgmma group that reads them has retired.
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4],
                                                    uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// Where element i of a thread's m64nN accumulator lies in the tile: warp
// w of the warpgroup owns rows 16w..16w+15; lane l holds rows 16w + l/4
// (+ 8) and, in each 8-column group, columns 2 (l % 4) and 2 (l % 4) + 1.
// For a fixed row, i ascending visits the thread's columns in ascending
// order.
__device__ __forceinline__ int acc_row(int i) {
  return 16 * ((threadIdx.x >> 5) & 3) + ((threadIdx.x & 31) >> 2) + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int i) {
  return 8 * (i >> 2) + 2 * (threadIdx.x & 3) + (i & 1);
}

// Start the ring: thread 0 initialises S stage barriers (+ `extra` more)
// and starts the first min(S, total) loads; every thread of the block
// then sees them.
template <int S, typename Load>
__device__ __forceinline__ void ring_start(uint64_t* full, int extra, int total, Load load) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < S + extra; ++s) mbar_init(&full[s], 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int j = 0; j < S && j < total; ++j) load(j);
}

// acc (+)= sum over nk K-steps of A_kt @ B_kt^T, for loads j0 .. j0 + nk
// - 1 of a stream of `total` loads (load j lands in stage j % S; this
// warpgroup's B tile at ring + (j % S) * stage_bytes + b_off, its A tile
// at a_tile(kt, stage)); acc starts from its own values if `accumulate`,
// else from zero. Each stage is refilled by thread 0 with load j + S
// (through load) once the wgmma group that read it has retired in every
// warp of the block.
template <int S, int M, typename ATile, typename Load>
__device__ __forceinline__ void mma_tile(float (&acc)[M], int j0, int nk, int total,
                                         uint8_t* ring, int stage_bytes, int b_off,
                                         uint64_t* full, bool accumulate, ATile a_tile,
                                         Load load) {
  fence_acc(acc);
  for (int kt = 0; kt < nk; ++kt) {
    const int j = j0 + kt, s = j % S;
    mbar_wait(&full[s], (j / S) & 1);
    const uint64_t da = sw128_desc(a_tile(kt, s));
    const uint64_t db = sw128_desc(ring + s * stage_bytes + b_off);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTileK / 16; ++kk)
      wgmma_m64nk16(acc, da + 2 * kk, db + 2 * kk, accumulate || (kt | kk) != 0);
    wgmma_commit();
    wgmma_wait<1>();  // the group of load j - 1 has retired
    __syncthreads();
    if (threadIdx.x == 0 && kt > 0 && j - 1 + S < total) load(j - 1 + S);
  }
  wgmma_wait<0>();
  fence_acc(acc);
  __syncthreads();
  const int last = j0 + nk - 1;
  if (threadIdx.x == 0 && last + S < total) load(last + S);
}

// Dynamic shared memory of streamed_tile's ring: S stages of W A tiles
// and one B tile (24 KB a stage for one warpgroup, 32 KB for two).
inline size_t streamed_smem_bytes(int stages, int wgs = 1) {
  return smem_request((size_t)stages * (wgs * kATileBytes + kBTileBytes));
}

// acc (+)= A[m0 + 64 wg : m0 + 64 wg + 64, :k] @ B[n0 : n0 + 128, :k]^T for
// warpgroup wg of the block's W, both operands streamed through a ring of
// S stages by TMA (descriptors ma, in boxes of 64 W rows, and mb); the W
// warpgroups share each B tile, which raises the products per byte a
// stage brings in from L2 (43 FLOP/B for one, 64 for two). acc starts
// from its own values if `accumulate`, else from zero.
template <int S, int W = 1>
__device__ __forceinline__ void streamed_tile(float (&acc)[64], const CUtensorMap* ma,
                                              const CUtensorMap* mb, int m0, int n0, int k,
                                              bool accumulate) {
  constexpr int kStage = W * kATileBytes + kBTileBytes;
  extern __shared__ __align__(1024) uint8_t gemm_smem_raw[];
  uint64_t* full;
  uint8_t* ring = smem_layout(gemm_smem_raw, S * kStage, &full);
  const int nk = (k + kTileK - 1) / kTileK;
  const int wg = threadIdx.x / kThreads;
  auto load = [=](int j) {
    uint8_t* stage = ring + (j % S) * kStage;
    uint64_t* bar = &full[j % S];
    mbar_expect_tx(bar, kStage);
    tma_load(stage, ma, bar, j * kTileK, m0);
    tma_load(stage + W * kATileBytes, mb, bar, j * kTileK, n0);
  };
  ring_start<S>(full, 0, nk, load);
  mma_tile<S>(
      acc, 0, nk, nk, ring, kStage, W * kATileBytes, full, accumulate,
      [=](int, int stage) { return ring + stage * kStage + wg * kATileBytes; }, load);
}

}  // namespace hop
}  // namespace cxg
