// XGating fusion: five matmuls, two sigmoid gates and a tanh.
//
// Replaces the Pallas kernel controllable_xgating_tpu/ops/pallas/xgate.py
// (_kernel, wrapper xgate_fuse_pallas):
//   ea = xa @ Wa + ba ; em = xm @ Wm + bm
//   ga = sigmoid(round(em) @ Uga + bga) ; gm = sigmoid(round(ea) @ Ugm + bgm)
//   out = tanh(round(ea * ga) @ Wf[:H] + round(em * gm) @ Wf[H:] + bf)
// with round() to the compute dtype at the same points as the Pallas kernel.
//
// What bounds it on the card: it is a chain of back-to-back GEMMs over the
// B*T rows (6656 x (1536 + 1024) -> 512 at MSR-VTT width, 31.4 GFLOP), so
// it is compute-bound: 32 us at the bf16 tensor-core peak.
//
// bf16 policy, the chain (xgate_chain_kernel, three launches on
// hopper_gemm.cuh's streamed_tile: a TMA ring of 3 stages into wgmma
// m64n128, 128 x 128 output tiles of two warpgroups that share each B
// tile, two blocks an SM). The Pallas kernel keeps every intermediate of
// a row tile in VMEM; a wgmma tile is 64 rows, and at 64 rows the f32 ea
// and em the chain must keep ([64, 512] each) already take 256 KB, more
// than a block's 227 KB. So the intermediates go to device memory, ~55 MB
// written and ~70 MB read at MSR-VTT width, mostly in L2. The operand
// tiles come from L2 at ~5 TB/s: a 128 x 128 tile does 64 FLOP for each
// byte its stages bring in, where a 64 x 128 tile did 43.
//   L1, embed: E = [ea | em] (f32) and Eb = [round(em) | round(ea)] (bf16),
//      both [R, 2H], from xa @ Wa^T' and xm @ Wm^T' (grid z = 0, 1);
//   L2, gates: P = [round(ea * ga) | round(em * gm)] [R, 2H] (bf16), from
//      Eb[:, :H] @ Uga and Eb[:, H:] @ Ugm, the epilogue reading ea or em
//      at the accumulator's own (row, column);
//   L3, out: tanh(P @ Wf + bf) as one product over K = 2H.
// Weights are K-major ([N, K], ops/kernels/xgate.py::xgate_weights, made
// once per call), biases f32 rounded through bf16. TMA rows need da, dm
// and H % 8 == 0 (xgate_fits); other widths take the SIMT kernel below.
//
// f32 policy (the reference, full f32 on SIMT, no TF32), and bf16 at
// widths the chain does not take: xgate_kernel, one block per 32 rows with
// ea and em (f32) and a third [32, H] buffer in shared memory for the
// whole chain (3 x 64 KB at H = 512), so no intermediate reaches device
// memory:
//   1. ea, em  <- two GEMMs over the input rows (A from global memory);
//   2. sG      <- ga, from em;
//   3. em *= gm column block by column block (gm reads ea, not em);
//   4. ea *= ga;
//   5. out     <- tanh of both gated products through the two halves of Wf.
// Weights stream from L2 through tile_gemm's shared-memory stage. One block
// per SM fits (the buffers take ~212 KB); H is limited to what fits.
#include "common.cuh"
#include "hopper_gemm.cuh"

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

// ------------------------------------------------------------ bf16 chain

constexpr int kXgWgs = 2;     // warpgroups a block: 128 x 128 output tiles
constexpr int kXgStages = 3;  // 97 KB: two blocks an SM (4 stages: one, and slower on an H100)
// __launch_bounds__(.., 2) keeps the gate step, which holds ea or em beside
// the accumulator, at two blocks an SM: 128 registers a thread and 52
// bytes of spills, and ~15% faster than one block an SM on an H100
constexpr int kXgRowsPerBlock = kXgWgs * hop::kTileM;
enum XgStep { kEmbed = 0, kGates = 1, kOut = 2 };

// One launch of the chain: problem z of the grid multiplies A_z [rows, k_z]
// by B_z [h, k_z]^T (descriptors a0 / b0, a1 / b1); the epilogue adds
// bias_z and writes as STEP says. e: f32 [rows, 2h]; eb, p: bf16 [rows, 2h];
// out: bf16 [rows, h].
struct XgArgs {
  const float* bias0;
  const float* bias1;
  float* e;
  __nv_bfloat16* eb;
  __nv_bfloat16* p;
  __nv_bfloat16* out;
  int rows, h, k0, k1;
};

// The gates' sigmoid on the fast intrinsics: their few-ulp f32 error is
// far below the bf16 rounding of ea * ga that follows (the IEEE division
// of sigmoid_f32 made the gate step ~1.3x slower on an H100).
__device__ __forceinline__ float fast_sigmoid(float x) {
  return __fdividef(1.0f, 1.0f + __expf(-x));
}

__device__ __forceinline__ void store_bf16x2(__nv_bfloat16* dst, float x0, float x1) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x0, x1);
}

template <int STEP>
__global__ void __launch_bounds__(kXgWgs * hop::kThreads, 2)
    xgate_chain_kernel(const __grid_constant__ CUtensorMap a0,
                       const __grid_constant__ CUtensorMap b0,
                       const __grid_constant__ CUtensorMap a1,
                       const __grid_constant__ CUtensorMap b1, XgArgs args) {
  const int z = blockIdx.z, h = args.h;
  const int m0 = blockIdx.y * kXgRowsPerBlock, n0 = blockIdx.x * hop::kTileN;
  const int mw = m0 + (threadIdx.x / hop::kThreads) * hop::kTileM;  // this warpgroup's rows
  float acc[64];
  hop::streamed_tile<kXgStages, kXgWgs>(acc, z ? &a1 : &a0, z ? &b1 : &b0, m0, n0,
                                        z ? args.k1 : args.k0, false);
  // the gate step's f32 ea or em at the accumulator's positions, all
  // loads in flight together
  float2 ev[32];
  if (STEP == kGates) {
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int r = mw + hop::acc_row(i), c = n0 + hop::acc_col(i);
      ev[i / 2] = r < args.rows && c < h
                      ? *reinterpret_cast<const float2*>(args.e + (size_t)r * 2 * h + z * h + c)
                      : make_float2(0.0f, 0.0f);
    }
  }
  const float* bias = z ? args.bias1 : args.bias0;
#pragma unroll
  for (int i = 0; i < 64; i += 2) {  // columns c, c + 1 (c even, h % 8 == 0)
    const int r = mw + hop::acc_row(i), c = n0 + hop::acc_col(i);
    if (r >= args.rows || c >= h) continue;
    const float x0 = acc[i] + bias[c], x1 = acc[i + 1] + bias[c + 1];
    const size_t row = (size_t)r * 2 * h;
    if (STEP == kEmbed) {  // z = 0: ea, z = 1: em; Eb holds them swapped
      *reinterpret_cast<float2*>(args.e + row + z * h + c) = make_float2(x0, x1);
      store_bf16x2(args.eb + row + (1 - z) * h + c, x0, x1);
    } else if (STEP == kGates) {  // z = 0: ga with ea, z = 1: gm with em
      store_bf16x2(args.p + row + z * h + c, ev[i / 2].x * fast_sigmoid(x0),
                   ev[i / 2].y * fast_sigmoid(x1));
    } else {
      store_bf16x2(args.out + (size_t)r * h + c, tanhf(x0), tanhf(x1));
    }
  }
}

template <int STEP>
cudaError_t launch_chain_step(const CUtensorMap& a0, const CUtensorMap& b0, const CUtensorMap& a1,
                              const CUtensorMap& b1, const XgArgs& args, int nz,
                              cudaStream_t st) {
  static int smem_set = 0;
  const int smem = (int)hop::streamed_smem_bytes(kXgStages, kXgWgs);
  const cudaError_t err = hop::allow_smem(xgate_chain_kernel<STEP>, smem, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((args.h + hop::kTileN - 1) / hop::kTileN,
                  (args.rows + kXgRowsPerBlock - 1) / kXgRowsPerBlock, nz);
  xgate_chain_kernel<STEP><<<grid, kXgWgs * hop::kThreads, smem, st>>>(a0, b0, a1, b1, args);
  return cudaGetLastError();
}

cudaError_t launch_xgate_chain(const void* xa, const void* xm, const void* wa_t, const void* wm_t,
                               const void* uga_t, const void* ugm_t, const void* wf_t,
                               const float* ba, const float* bm, const float* bga,
                               const float* bgm, const float* bf, float* e, void* eb, void* p,
                               void* out, int rows, int da, int dm, int h, cudaStream_t st) {
  typedef __nv_bfloat16 bf16;
  const bf16* ebh = (const bf16*)eb;
  CUtensorMap m_xa, m_xm, m_wa, m_wm, m_em, m_ea, m_uga, m_ugm, m_p, m_wf;
  const int tm = kXgRowsPerBlock, tn = hop::kTileN;
  cudaError_t err = hop::make_tmap(&m_xa, xa, rows, da, da, tm);
  if (err == cudaSuccess) err = hop::make_tmap(&m_xm, xm, rows, dm, dm, tm);
  if (err == cudaSuccess) err = hop::make_tmap(&m_wa, wa_t, h, da, da, tn);
  if (err == cudaSuccess) err = hop::make_tmap(&m_wm, wm_t, h, dm, dm, tn);
  if (err == cudaSuccess) err = hop::make_tmap(&m_em, ebh, rows, h, 2 * h, tm);      // round(em)
  if (err == cudaSuccess) err = hop::make_tmap(&m_ea, ebh + h, rows, h, 2 * h, tm);  // round(ea)
  if (err == cudaSuccess) err = hop::make_tmap(&m_uga, uga_t, h, h, h, tn);
  if (err == cudaSuccess) err = hop::make_tmap(&m_ugm, ugm_t, h, h, h, tn);
  if (err == cudaSuccess) err = hop::make_tmap(&m_p, p, rows, 2 * h, 2 * h, tm);
  if (err == cudaSuccess) err = hop::make_tmap(&m_wf, wf_t, h, 2 * h, 2 * h, tn);
  if (err != cudaSuccess) return err;
  XgArgs args{ba, bm, e, (bf16*)eb, (bf16*)p, (bf16*)out, rows, h, da, dm};
  err = launch_chain_step<kEmbed>(m_xa, m_wa, m_xm, m_wm, args, 2, st);
  if (err != cudaSuccess) return err;
  args.bias0 = bga;
  args.bias1 = bgm;
  args.k0 = args.k1 = h;
  err = launch_chain_step<kGates>(m_em, m_uga, m_ea, m_ugm, args, 2, st);
  if (err != cudaSuccess) return err;
  args.bias0 = args.bias1 = bf;
  args.k0 = args.k1 = 2 * h;
  return launch_chain_step<kOut>(m_p, m_wf, m_p, m_wf, args, 1, st);
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

// The bf16 chain: xa [rows, da], xm [rows, dm] and the K-major weights
// wa_t [h, da], wm_t [h, dm], uga_t, ugm_t [h, h], wf_t [h, 2h] in bf16,
// biases f32 [h]; scratch e f32, eb and p bf16, each [rows, 2h]; out bf16
// [rows, h]. da, dm, h % 8 == 0, every base 16-byte aligned. Three
// launches; returns a cudaError_t (0 = launched).
extern "C" int cxg_xgate_chain_fwd(const void* xa, const void* xm, const void* wa_t,
                                   const void* wm_t, const void* uga_t, const void* ugm_t,
                                   const void* wf_t, const void* ba, const void* bm,
                                   const void* bga, const void* bgm, const void* bf, void* e,
                                   void* eb, void* p, void* out, int rows, int da, int dm, int h,
                                   void* stream) {
  if (da % 8 || dm % 8 || h % 8 || rows < 1) return (int)cudaErrorInvalidValue;
  auto f = [](const void* q) { return (const float*)q; };
  return (int)cxg::launch_xgate_chain(xa, xm, wa_t, wm_t, uga_t, ugm_t, wf_t, f(ba), f(bm),
                                      f(bga), f(bgm), f(bf), (float*)e, eb, p, out, rows, da, dm,
                                      h, (cudaStream_t)stream);
}

extern "C" long cxg_xgate_smem_bytes(int h) { return (long)cxg::xgate_smem_bytes(h); }
