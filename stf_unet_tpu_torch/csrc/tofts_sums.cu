// K4: the extended-Tofts quadrature sums of the PK fit.
//
// Replaces the TPU kernel stf_unet_tpu/ops/pallas/tofts_kernel.py:
// tofts_sums / _tofts_kernel. For rate [N] (= K/ve) and the quadrature
// tables lags, weights, wlags [T, Q] (wlags = weights * lags) it writes
//   s     [N, T]: S[n, t]   = sum_q weights[t, q] * exp(-rate[n] * lags[t, q])
//   s_lag [N, T]: S_D[n, t] = sum_q wlags[t, q]   * exp(-rate[n] * lags[t, q])
// without materialising the [N, T, Q] decay tensor.
//
// Bound on this card: operations. At N = 16384, T = 8, Q = 700 the
// function is 91.75 M exponentials, ~6 f32 operations each (a multiply,
// the exponential, two FMAs): 0.55 GFLOP, 8.2 us at 67 TFLOP/s, against
// ~1.2 MB of traffic (0.35 us at 3.35 TB/s). The exponentials go through
// the SFU (16 a clock per SM on cc 9.0): ~22-25 us for them alone at
// 1.7-2.0 GHz, the practical floor of this formulation.
//
// Design. The TPU kernel walks voxel tiles in a sequential grid and keeps
// the [T, Q] tables in VMEM. Here the grid is (ceil(N / 256), T): one
// thread per (voxel, t), 512 blocks at N = 16384 (one thread per voxel
// over all T would give 64 blocks for 132 SMs). Each block stages its t's
// three rows (12 Q bytes, 8.4 KB at Q = 700) in shared memory, so the
// threads of a warp read the same q at each step: a broadcast. Each thread
// keeps four independent partial sums per output (instruction-level
// parallelism, and a shorter f32 summation chain), added in a fixed order.
// expf, not __expf: the rate reaches K/ve = 1/0.001 = 1000 and the lag 7,
// where __expf's error grows with |x|; the build uses no fast-math flag.
// The last block masks its ragged tail of voxels.

#include <cuda_runtime.h>

namespace stf {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    tofts_sums_kernel(const float* __restrict__ rate,
                      const float* __restrict__ lags,
                      const float* __restrict__ weights,
                      const float* __restrict__ wlags, float* __restrict__ s,
                      float* __restrict__ s_lag, int n, int t_steps, int q) {
  extern __shared__ float smem[];
  float* sl = smem;
  float* sw = smem + q;
  float* swl = smem + 2 * q;
  const int t = blockIdx.y;
  const size_t row = (size_t)t * q;
  for (int k = threadIdx.x; k < q; k += blockDim.x) {
    sl[k] = lags[row + k];
    sw[k] = weights[row + k];
    swl[k] = wlags[row + k];
  }
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  const float neg_rate = -rate[i];
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
  float b0 = 0.0f, b1 = 0.0f, b2 = 0.0f, b3 = 0.0f;
  int k = 0;
  for (; k + 4 <= q; k += 4) {
    const float e0 = expf(neg_rate * sl[k]);
    const float e1 = expf(neg_rate * sl[k + 1]);
    const float e2 = expf(neg_rate * sl[k + 2]);
    const float e3 = expf(neg_rate * sl[k + 3]);
    a0 = fmaf(e0, sw[k], a0);
    a1 = fmaf(e1, sw[k + 1], a1);
    a2 = fmaf(e2, sw[k + 2], a2);
    a3 = fmaf(e3, sw[k + 3], a3);
    b0 = fmaf(e0, swl[k], b0);
    b1 = fmaf(e1, swl[k + 1], b1);
    b2 = fmaf(e2, swl[k + 2], b2);
    b3 = fmaf(e3, swl[k + 3], b3);
  }
  for (; k < q; ++k) {
    const float e = expf(neg_rate * sl[k]);
    a0 = fmaf(e, sw[k], a0);
    b0 = fmaf(e, swl[k], b0);
  }
  const size_t out = (size_t)i * t_steps + t;
  s[out] = (a0 + a1) + (a2 + a3);
  s_lag[out] = (b0 + b1) + (b2 + b3);
}

}  // namespace stf

// rate [N]; lags, weights, wlags [T, Q]; s, s_lag [N, T]; all float32,
// contiguous, on the current device. Returns a cudaError_t (0 on
// success). Asynchronous on `stream`; allocates nothing.
extern "C" int stf_tofts_sums(const void* rate, const void* lags,
                              const void* weights, const void* wlags,
                              void* s, void* s_lag, int n, int t_steps, int q,
                              void* stream) {
  const size_t smem = 3 * (size_t)q * sizeof(float);
  if (n < 1 || t_steps < 1 || t_steps > 65535 || q < 0 ||
      smem > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((n + stf::kThreads - 1) / stf::kThreads),
                  (unsigned)t_steps);
  stf::tofts_sums_kernel<<<grid, stf::kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rate), static_cast<const float*>(lags),
      static_cast<const float*>(weights), static_cast<const float*>(wlags),
      static_cast<float*>(s), static_cast<float*>(s_lag), n, t_steps, q);
  return (int)cudaGetLastError();
}
