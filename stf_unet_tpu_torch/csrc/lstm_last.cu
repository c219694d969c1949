// K3: last-step pixel LSTM from a precomputed input projection.
//
// Replaces the TPU kernel stf_unet_tpu/ops/pallas/lstm_kernel.py:
// fused_lstm_last / _lstm_last_kernel. Computes, for x_proj [T, N, 4C]
// (= x @ W_ih, already rounded to its dtype by the caller), W_hh [C, 4C]
// (gate order i, f, g, o) and b [4C]:
//   gates_t = (x_proj_t + h_{t-1} @ W_hh) + b     (f32; h stays f32 in the
//                                                  product, lstm_kernel.py:52)
//   c_t = f*c_{t-1} + i*g,  h_t = o*tanh(c_t)
// and writes only h_T [N, C] in x_proj's dtype.
//
// Bound on this card: 8*T*N*C^2 operations against T*N*4C input elements,
// about 1,000 operations per byte at C=512 in bf16 (6.6 GFLOP at the
// serving shapes, ~6.7 us at the 989 TFLOP/s bf16 peak); bound by
// operations. This first version does the products on CUDA cores in f32
// FMA, at best ~1/15 of that bound.
//
// Design. As in lstm_last_x.cu: a block loops over T inside and owns a
// tile of rows with all C units; cell state in registers; h f32 and
// double-buffered in shared memory. W_hh (2 MB at C=512 in bf16) is read
// through L1/L2 as 4-gate vectors. Each thread reads its own four x_proj
// gate columns straight from global memory (every element is used once),
// issued before the recurrent product so the loads overlap it. The serving
// path routes only C=512 here, where N is 49-392 rows: 7-49 blocks of 512
// threads on 132 SMs, so the card is mostly idle at this kernel.

#include "lstm_cell.cuh"

namespace stf {

template <typename T>
__global__ void __launch_bounds__(kMaxC)
lstm_last_kernel(const T* __restrict__ xp, const T* __restrict__ w_hh,
                 const T* __restrict__ b, T* __restrict__ out, int t_steps,
                 int n, int c) {
  extern __shared__ float smem[];
  const int rows = blockDim.y * kRowsPerThread;
  float* hbuf0 = smem;  // [rows][c] h, two buffers
  float* hbuf1 = hbuf0 + rows * c;
  const int j = threadIdx.x;
  const int r0 = threadIdx.y * kRowsPerThread;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  const int row_base = blockIdx.x * rows;

  for (int idx = tid; idx < rows * c; idx += nthreads) hbuf0[idx] = 0.0f;
  float bias[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) bias[g] = to_f32(b[g * c + j]);
  float cst[kRowsPerThread], hlast[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) cst[i] = hlast[i] = 0.0f;
  __syncthreads();

  float* hcur = hbuf0;
  float* hnext = hbuf1;
  for (int t = 0; t < t_steps; ++t) {
    float xg[kRowsPerThread][4];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int row = row_base + r0 + i;
      const T* xr = xp + ((size_t)t * n + row) * 4 * c + j;
#pragma unroll
      for (int g = 0; g < 4; ++g)
        xg[i][g] = row < n ? to_f32(xr[g * c]) : 0.0f;
    }

    float acc[kRowsPerThread][4];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int g = 0; g < 4; ++g) acc[i][g] = 0.0f;
    for (int k = 0; k < c; k += 4)
      accumulate4<T>(acc, hcur + r0 * c, c, w_hh, k, j);
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      float gates[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) gates[g] = (xg[i][g] + acc[i][g]) + bias[g];
      hlast[i] = cell(gates, cst[i]);
      hnext[(r0 + i) * c + j] = hlast[i];
    }
    __syncthreads();  // h_t complete, every read of h_{t-1} done
    float* tmp = hcur;
    hcur = hnext;
    hnext = tmp;
  }
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int row = row_base + r0 + i;
    if (row < n) out[(size_t)row * c + j] = from_f32<T>(hlast[i]);
  }
}

template <typename T>
static cudaError_t launch(const void* xp, const void* w_hh, const void* b,
                          void* out, int t_steps, int n, int c,
                          cudaStream_t stream) {
  const Geometry g = geometry(n, c);
  const size_t smem = 2 * (size_t)g.rows * c * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        lstm_last_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  lstm_last_kernel<T><<<g.grid, g.block, smem, stream>>>(
      static_cast<const T*>(xp), static_cast<const T*>(w_hh),
      static_cast<const T*>(b), static_cast<T*>(out), t_steps, n, c);
  return cudaGetLastError();
}

}  // namespace stf

// x_proj [T,N,4C], w_hh packed [C,C,4], b [4C], out [N,C]; all of one dtype
// (0 = f32, 1 = bf16), contiguous, on the current device. Returns a
// cudaError_t (0 on success). Asynchronous on `stream`; allocates nothing.
extern "C" int stf_lstm_last(const void* xp, const void* w_hh, const void* b,
                             void* out, int t_steps, int n, int c, int dtype,
                             void* stream) {
  if (!stf::shape_ok(t_steps, n, c)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == stf::kF32)
    return (int)stf::launch<float>(xp, w_hh, b, out, t_steps, n, c, s);
  if (dtype == stf::kBF16)
    return (int)stf::launch<__nv_bfloat16>(xp, w_hh, b, out, t_steps, n, c,
                                           s);
  return (int)cudaErrorInvalidValue;
}
