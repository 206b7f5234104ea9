// Cross-entropy row statistics over materialised logits, forward and
// backward, for the XE training step.
//
// Replaces the Pallas kernels of controllable_xgating_tpu/ops/pallas/xent.py
// (_fwd_kernel, line 49, and _bwd_kernel, line 60, behind the custom VJP
// xent_row_stats):
//   forward:  lse[r] = logsumexp(x[r, :]), tgt[r] = x[r, t[r]],
//             mean[r] = mean(x[r, :])
//   backward: dx[r, j] = g_lse[r] * exp(x[r, j] - lse[r]) + g_mean[r] / V
//                        + (j == t[r]) * g_tgt[r]
// x is f32 [N, V], row-major and contiguous; t is int64 [N]; the
// statistics and cotangents are f32 [N].
//
// What bounds it on the card: bytes. At the XE step's shape (N = 8640
// rows = 64 videos x 5 captions x 27 steps, V = 10000) the forward reads
// the 345.6 MB of logits once (0.103 ms at 3.35 TB/s) and the backward
// reads them once and writes dx once (0.206 ms). The arithmetic is about
// 1.25 exp per element in the forward and 1 in the backward, far below
// what the card's special-function units do in that time.
//
// Design: one warp per row, eight rows per 256-thread block, no shared
// memory and no padding rows (the Pallas kernel's 64-row blocks and jnp
// row tail were TPU tiling; any N works here). Each lane walks the row in
// 16-byte loads, four in flight, and keeps an online (max, sum-exp) over
// groups of four values (one rescale per group) and a plain sum; warp
// shuffles merge the (max, sum-exp) pairs and the sums. A row whose start
// is not 16-byte aligned (V % 4 != 0) takes scalar loads up to its first
// aligned element, and its ragged end takes scalar loads. Lane 0 reads
// x[t] directly; a target outside [0, V) gives NaN. The backward walks
// the row the same way and writes dx with 16-byte stores wherever x and
// dx rows share their alignment (else it goes element by element).
#include "common.cuh"

namespace cxg {

constexpr int kXentRowsPerBlock = kThreads / 32;

// online (max, sum-exp) update with a group of values; a row of -inf only
// stays (m, s) = (-inf, 0), so its lse is -inf as in logsumexp
__device__ __forceinline__ void lse_push4(float& m, float& s, float a, float b, float c,
                                          float d) {
  const float nm = fmaxf(m, fmaxf(fmaxf(a, b), fmaxf(c, d)));
  if (nm == -INFINITY) return;
  s = s * expf(m - nm) + ((expf(a - nm) + expf(b - nm)) + (expf(c - nm) + expf(d - nm)));
  m = nm;
}

__device__ __forceinline__ void lse_push1(float& m, float& s, float a) {
  const float nm = fmaxf(m, a);
  if (nm == -INFINITY) return;
  s = s * expf(m - nm) + expf(a - nm);
  m = nm;
}

__device__ __forceinline__ void stats_push4(float& m, float& s, float& sum, const float4 p) {
  lse_push4(m, s, p.x, p.y, p.z, p.w);
  sum += (p.x + p.y) + (p.z + p.w);
}

// elements before the first 16-byte boundary of a row (0..3, at most v)
__device__ __forceinline__ int head_elems(const float* p, int v) {
  return min(v, (int)((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15) / 4);
}

__global__ void __launch_bounds__(kThreads)
    xent_fwd_kernel(const float* __restrict__ x, const long long* __restrict__ t,
                    float* __restrict__ lse, float* __restrict__ tgt, float* __restrict__ mean,
                    int rows, int v) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kXentRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // warp-uniform
  const float* xr = x + (size_t)row * v;
  const int head = head_elems(xr, v);
  const int nvec = (v - head) / 4;
  const float4* xv = reinterpret_cast<const float4*>(xr + head);
  float m = -INFINITY, s = 0.0f, sum = 0.0f;
  if (lane < head) {
    const float a = xr[lane];
    lse_push1(m, s, a);
    sum += a;
  }
  int i = lane;
  for (; i + 96 < nvec; i += 128) {
    const float4 p0 = __ldg(xv + i), p1 = __ldg(xv + i + 32);
    const float4 p2 = __ldg(xv + i + 64), p3 = __ldg(xv + i + 96);
    stats_push4(m, s, sum, p0);
    stats_push4(m, s, sum, p1);
    stats_push4(m, s, sum, p2);
    stats_push4(m, s, sum, p3);
  }
  for (; i < nvec; i += 32) stats_push4(m, s, sum, __ldg(xv + i));
  const int tail = head + 4 * nvec;
  if (tail + lane < v) {
    const float a = xr[tail + lane];
    lse_push1(m, s, a);
    sum += a;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float om = __shfl_xor_sync(kFull, m, off);
    const float os = __shfl_xor_sync(kFull, s, off);
    const float nm = fmaxf(m, om);
    if (nm != -INFINITY) {
      s = s * expf(m - nm) + os * expf(om - nm);
      m = nm;
    }
    sum += __shfl_xor_sync(kFull, sum, off);
  }
  if (lane == 0) {
    lse[row] = m + logf(s);
    const long long ti = t[row];
    tgt[row] = (ti >= 0 && ti < v) ? xr[ti] : NAN;
    mean[row] = sum / (float)v;
  }
}

__device__ __forceinline__ float xent_dx(float xv, float l, float g_lse, float g_mean_v, int j,
                                         long long ti, float g_tgt) {
  const float d = g_lse * expf(xv - l) + g_mean_v;
  return j == ti ? d + g_tgt : d;
}

__global__ void __launch_bounds__(kThreads)
    xent_bwd_kernel(const float* __restrict__ x, const long long* __restrict__ t,
                    const float* __restrict__ lse, const float* __restrict__ g_lse,
                    const float* __restrict__ g_tgt, const float* __restrict__ g_mean,
                    float* __restrict__ dx, int rows, int v) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kXentRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // warp-uniform
  const float* xr = x + (size_t)row * v;
  float* dr = dx + (size_t)row * v;
  const float l = lse[row], gl = g_lse[row], gt = g_tgt[row], gm = g_mean[row] / (float)v;
  const long long ti = t[row];
  if (((reinterpret_cast<uintptr_t>(xr) ^ reinterpret_cast<uintptr_t>(dr)) & 15) != 0) {
    for (int j = lane; j < v; j += 32) dr[j] = xent_dx(xr[j], l, gl, gm, j, ti, gt);
    return;
  }
  const int head = head_elems(xr, v);
  const int nvec = (v - head) / 4;
  const float4* xv = reinterpret_cast<const float4*>(xr + head);
  float4* dv = reinterpret_cast<float4*>(dr + head);
  if (lane < head) dr[lane] = xent_dx(xr[lane], l, gl, gm, lane, ti, gt);
  auto one = [&](int k, const float4 p) {
    const int j = head + 4 * k;
    dv[k] = make_float4(xent_dx(p.x, l, gl, gm, j, ti, gt), xent_dx(p.y, l, gl, gm, j + 1, ti, gt),
                        xent_dx(p.z, l, gl, gm, j + 2, ti, gt),
                        xent_dx(p.w, l, gl, gm, j + 3, ti, gt));
  };
  int i = lane;
  for (; i + 96 < nvec; i += 128) {
    const float4 p0 = __ldg(xv + i), p1 = __ldg(xv + i + 32);
    const float4 p2 = __ldg(xv + i + 64), p3 = __ldg(xv + i + 96);
    one(i, p0);
    one(i + 32, p1);
    one(i + 64, p2);
    one(i + 96, p3);
  }
  for (; i < nvec; i += 32) one(i, __ldg(xv + i));
  const int tail = head + 4 * nvec;
  if (tail + lane < v) dr[tail + lane] = xent_dx(xr[tail + lane], l, gl, gm, tail + lane, ti, gt);
}

inline unsigned xent_blocks(int rows) {
  return (unsigned)((rows + kXentRowsPerBlock - 1) / kXentRowsPerBlock);
}

}  // namespace cxg

// x f32 [rows, v] contiguous; t int64 [rows]; lse, tgt, mean f32 [rows].
// Returns a cudaError_t (0 = launched).
extern "C" int cxg_xent_fwd(const void* x, const void* t, void* lse, void* tgt, void* mean,
                            int rows, int v, void* stream) {
  if (rows <= 0 || v <= 0) return (int)cudaErrorInvalidValue;
  cxg::xent_fwd_kernel<<<cxg::xent_blocks(rows), cxg::kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const long long*)t, (float*)lse, (float*)tgt, (float*)mean, rows, v);
  return (int)cudaGetLastError();
}

// x f32 [rows, v]; t int64 [rows]; lse and the cotangents g_lse, g_tgt,
// g_mean f32 [rows]; dx f32 [rows, v], written in full.
extern "C" int cxg_xent_bwd(const void* x, const void* t, const void* lse, const void* g_lse,
                            const void* g_tgt, const void* g_mean, void* dx, int rows, int v,
                            void* stream) {
  if (rows <= 0 || v <= 0) return (int)cudaErrorInvalidValue;
  cxg::xent_bwd_kernel<<<cxg::xent_blocks(rows), cxg::kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const long long*)t, (const float*)lse, (const float*)g_lse,
      (const float*)g_tgt, (const float*)g_mean, (float*)dx, rows, v);
  return (int)cudaGetLastError();
}
