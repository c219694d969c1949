// K4: the extended-Tofts quadrature sums of the PK fit.
//
// Replaces the TPU kernel stf_unet_tpu/ops/pallas/tofts_kernel.py:
// tofts_sums / _tofts_kernel. For rate [N] (= K/ve) and the quadrature
// tables lags, weights, wlags [T, Q] (wlags = weights * lags) it writes
//   s     [N, T]: S[n, t]   = sum_q weights[t, q] * exp(-rate[n] * lags[t, q])
//   s_lag [N, T]: S_D[n, t] = sum_q wlags[t, q]   * exp(-rate[n] * lags[t, q])
// without materialising the [N, T, Q] decay tensor.
//
// Active terms. The PK fit's tables are masked (tau_q < t_i): row t has
// weights and lags only on its first 100*t grid points at dt = 0.01, so
// half of the T*Q = 5,600 (t, q) terms are 0 * exp(-rate * 0) = 0. The
// kernel does no work on them, for any tables: a block finds, for each of
// its rows, the active length, one past the last q where lags, weights or
// wlags is non-zero, and sums only up to it. A dropped term is exactly
// weights * exp(-rate * 0) = 0 * 1 for a finite rate, so the sums are
// those of the whole row (the fit's rates are finite: K/ve with ve >=
// 0.001). For a rate that is not finite such a term is 0 * exp(NaN) =
// NaN, so a thread with such a rate sums its whole row, term by term past
// the last multiple of 4, and gives what the plain sums give.
//
// Bound on this card, counted over the active terms (a function of the
// tables): at N = 16384, T = 8, Q = 700 with the PK fit's tables, 45.9 M
// exponentials (of 91.75 M on the full grid), ~6 f32 operations each (a
// multiply, the exponential, two FMAs): 4.1 us at 67 TFLOP/s, against ~1.2
// MB of traffic (0.35 us at 3.35 TB/s), so operations. The exponentials go
// through the SFU (16 a clock per SM on cc 9.0): 11 us at 1.98 GHz, the
// practical floor of this formulation (22 us on the full grid).
//
// Design: the issue rate. The first version spent ~16 instructions per
// term (three scalar shared loads, an accurate expf of several FP32
// instructions around one MUFU op, a multiply, two FMAs) on every term of
// the full grid, 53 us. Here:
//  * One MUFU op per term: the thread scales its rate once by log2(e) and
//    takes ex2.approx.ftz of rate2 * lag. The argument is rounded twice
//    (|x| * 2^-23 relative to x) and ex2.approx is within 2 ulp; a term
//    that would be subnormal (< 2^-126) flushes to 0. Against expf this
//    moves a term of size e^-|x| by ~|x| * 2^-23 relative, <= 1.2e-6 on
//    the terms that carry the sum; the kernel stays within the plain
//    sums' 1e-5 relative (chip_smoke.py's TOFTS_RTOL).
//  * The tables are staged in shared memory zero-padded to a multiple of
//    4 and read as 16-byte vectors: three loads per four terms, each a
//    broadcast (every thread of the block reads the same q).
//  * Balance. A block of 256 voxels takes two rows, t and T-1-t, so every
//    thread's work is the sum of two active lengths: 100*t + 100*(7-t) =
//    700 terms for every pair of the fit's tables, where a (voxel tile, t)
//    grid would give blocks of 0..700 terms. The grid is (ceil(N/256),
//    ceil(T/2)): 256 blocks, 2048 warps at N = 16384, ~16 warps an SM.
//  * Two staged rows take 24 * Q bytes of shared memory, 16.8 KB at the
//    fit's Q = 700; above the 48 KB a block gets by default (Q > 2048)
//    the launch opts into more, up to Q = kMaxQ = 4096 (96 KB).
//  * Four independent partial sums per output (instruction-level
//    parallelism for the MUFU latency, a shorter f32 chain), added in a
//    fixed order.
// The last block masks its ragged tail of voxels.

#include <cuda_runtime.h>

namespace stf {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxQ = 4096;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Grid points of a row staged in shared memory: q rounded up to a
// multiple of 4, zeros past q.
__host__ __device__ inline int padded_q(int q) { return (q + 3) & ~3; }

__global__ void __launch_bounds__(kThreads)
    tofts_sums_kernel(const float* __restrict__ rate,
                      const float* __restrict__ lags,
                      const float* __restrict__ weights,
                      const float* __restrict__ wlags, float* __restrict__ s,
                      float* __restrict__ s_lag, int n, int t_steps, int q) {
  extern __shared__ __align__(16) float smem[];  // [2 rows][3][qp]
  __shared__ int warp_len[kWarps][2];
  const int qp = padded_q(q);
  const int rows[2] = {(int)blockIdx.y, t_steps - 1 - (int)blockIdx.y};
  const int nrows = rows[0] == rows[1] ? 1 : 2;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;

  // Stage the rows; each thread notes one past its last non-zero q.
  for (int r = 0; r < nrows; ++r) {
    const size_t row = (size_t)rows[r] * q;
    float* sl = smem + r * 3 * qp;
    int last = 0;
    for (int k = threadIdx.x; k < qp; k += kThreads) {
      const float l = k < q ? lags[row + k] : 0.0f;
      const float w = k < q ? weights[row + k] : 0.0f;
      const float wl = k < q ? wlags[row + k] : 0.0f;
      sl[k] = l;
      sl[qp + k] = w;
      sl[2 * qp + k] = wl;
      if (l != 0.0f || w != 0.0f || wl != 0.0f) last = k + 1;
    }
    last = (int)__reduce_max_sync(0xffffffffu, (unsigned)last);
    if (lane == 0) warp_len[warp][r] = last;
  }
  __syncthreads();
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;

  const bool finite = isfinite(rate[i]);
  const float rate2 = -rate[i] * kLog2e;
  for (int r = 0; r < nrows; ++r) {
    int len = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) len = max(len, warp_len[w][r]);
    // Past len (at most 3 padded points) every term is 0 * 1 for a finite
    // rate; any other rate takes the whole row, and no padded point.
    const int vec_end = finite ? padded_q(len) : (q & ~3);
    const int end = finite ? vec_end : q;
    const float* sl = smem + r * 3 * qp;
    const float* sw = sl + qp;
    const float* swl = sw + qp;
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
    float b0 = 0.0f, b1 = 0.0f, b2 = 0.0f, b3 = 0.0f;
    for (int k = 0; k < vec_end; k += 4) {
      const float4 l = *reinterpret_cast<const float4*>(sl + k);
      const float4 w = *reinterpret_cast<const float4*>(sw + k);
      const float4 wl = *reinterpret_cast<const float4*>(swl + k);
      const float e0 = ex2(rate2 * l.x);
      const float e1 = ex2(rate2 * l.y);
      const float e2 = ex2(rate2 * l.z);
      const float e3 = ex2(rate2 * l.w);
      a0 = fmaf(e0, w.x, a0);
      a1 = fmaf(e1, w.y, a1);
      a2 = fmaf(e2, w.z, a2);
      a3 = fmaf(e3, w.w, a3);
      b0 = fmaf(e0, wl.x, b0);
      b1 = fmaf(e1, wl.y, b1);
      b2 = fmaf(e2, wl.z, b2);
      b3 = fmaf(e3, wl.w, b3);
    }
    for (int k = vec_end; k < end; ++k) {
      const float e = ex2(rate2 * sl[k]);
      a0 = fmaf(e, sw[k], a0);
      b0 = fmaf(e, swl[k], b0);
    }
    const size_t out = (size_t)i * t_steps + rows[r];
    s[out] = (a0 + a1) + (a2 + a3);
    s_lag[out] = (b0 + b1) + (b2 + b3);
  }
}

}  // namespace stf

// rate [N]; lags, weights, wlags [T, Q]; s, s_lag [N, T]; all float32,
// contiguous, on the current device. Returns a cudaError_t (0 on
// success). Asynchronous on `stream`; allocates nothing.
extern "C" int stf_tofts_sums(const void* rate, const void* lags,
                              const void* weights, const void* wlags,
                              void* s, void* s_lag, int n, int t_steps, int q,
                              void* stream) {
  const size_t smem = 2 * 3 * (size_t)stf::padded_q(q) * sizeof(float);
  if (n < 1 || t_steps < 1 || t_steps > 2 * 65535 || q < 0 ||
      q > stf::kMaxQ)
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        stf::tofts_sums_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)((n + stf::kThreads - 1) / stf::kThreads),
                  (unsigned)((t_steps + 1) / 2));
  stf::tofts_sums_kernel<<<grid, stf::kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rate), static_cast<const float*>(lags),
      static_cast<const float*>(weights), static_cast<const float*>(wlags),
      static_cast<float*>(s), static_cast<float*>(s_lag), n, t_steps, q);
  return (int)cudaGetLastError();
}
