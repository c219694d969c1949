// K1 forward: last-step pixel LSTM with the input projection in the kernel.
//
// Replaces the TPU kernel stf_unet_tpu/ops/pallas/lstm_train_kernel.py:
// _fwd_call / _make_fwd_kernel (public fused_lstm_last_x). Computes, for
// x [T, N, C], W_ih and W_hh [C, 4C] (gate order i, f, g, o) and b [4C]:
//   gates_t = x_t @ W_ih + round(h_{t-1}) @ W_hh + b      (f32 sums)
//   c_t = f*c_{t-1} + i*g,  h_t = o*tanh(c_t)              (f32 state)
// and writes only h_T [N, C] in x's dtype. round() casts h to x's dtype
// before the recurrent product, as the TPU kernel does (lstm_train_kernel
// .py:80); the cell state never leaves f32 registers.
//
// Bound on this card: 16*T*N*C^2 operations against T*N*C input elements,
// about 1,000 operations per byte at C=64 in bf16, so it is bound by
// operations (13.2 GFLOP at the serving shapes, ~13 us at the 989 TFLOP/s
// bf16 tensor-core peak). This first version does the products on CUDA
// cores in f32 FMA (67 TFLOP/s peak), so it can reach at best ~1/15 of
// that bound; tensor cores (mma.sync / wgmma) are a later step.
//
// Design. The TPU walks T as a sequential grid axis with (h, c) in VMEM
// scratch; here each block loops over T itself (blocks run in any order on
// 132 SMs) and owns a tile of rows with all C units (see lstm_cell.cuh).
// Per step the block stages x_t's tile in shared memory; W_ih and W_hh
// (up to 2 x 2 MB at C=512 in bf16, above the 227 KB of shared memory) are
// read through L1/L2 as 4-gate vectors, never staged whole. h is
// double-buffered in shared memory; one __syncthreads per half-step.
// Rows past N are computed on zeros and never stored.

#include "lstm_cell.cuh"

namespace stf {

template <typename T>
__global__ void __launch_bounds__(kMaxC)
lstm_last_x_kernel(const T* __restrict__ x, const T* __restrict__ w_ih,
                   const T* __restrict__ w_hh, const T* __restrict__ b,
                   T* __restrict__ out, int t_steps, int n, int c) {
  extern __shared__ float smem[];
  const int rows = blockDim.y * kRowsPerThread;
  float* xs = smem;             // [rows][c] x_t tile, f32
  float* hbuf0 = xs + rows * c; // [rows][c] h, two buffers
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

  float* hcur = hbuf0;
  float* hnext = hbuf1;
  for (int t = 0; t < t_steps; ++t) {
    const T* xt = x + ((size_t)t * n + row_base) * c;
    for (int idx = tid; idx < rows * c; idx += nthreads)
      xs[idx] = (row_base + idx / c < n) ? to_f32(xt[idx]) : 0.0f;
    __syncthreads();  // x_t staged; h_{t-1} complete

    float acc[kRowsPerThread][4];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int g = 0; g < 4; ++g) acc[i][g] = 0.0f;
    for (int k = 0; k < c; k += 4) {
      accumulate4<T>(acc, xs + r0 * c, c, w_ih, k, j);
      accumulate4<T>(acc, hcur + r0 * c, c, w_hh, k, j);
    }
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      float gates[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) gates[g] = acc[i][g] + bias[g];
      hlast[i] = cell(gates, cst[i]);
      hnext[(r0 + i) * c + j] = round_to<T>(hlast[i]);
    }
    __syncthreads();  // every read of x_t and h_{t-1} is done
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
static cudaError_t launch(const void* x, const void* w_ih, const void* w_hh,
                          const void* b, void* out, int t_steps, int n, int c,
                          cudaStream_t stream) {
  const Geometry g = geometry(n, c);
  const size_t smem = 3 * (size_t)g.rows * c * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        lstm_last_x_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  lstm_last_x_kernel<T><<<g.grid, g.block, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w_ih),
      static_cast<const T*>(w_hh), static_cast<const T*>(b),
      static_cast<T*>(out), t_steps, n, c);
  return cudaGetLastError();
}

}  // namespace stf

// x [T,N,C], w_ih/w_hh packed [C,C,4], b [4C], out [N,C]; all of one dtype
// (0 = f32, 1 = bf16), contiguous, on the current device. Returns a
// cudaError_t (0 on success). Asynchronous on `stream`; allocates nothing.
extern "C" int stf_lstm_last_x(const void* x, const void* w_ih,
                               const void* w_hh, const void* b, void* out,
                               int t_steps, int n, int c, int dtype,
                               void* stream) {
  if (!stf::shape_ok(t_steps, n, c)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == stf::kF32)
    return (int)stf::launch<float>(x, w_ih, w_hh, b, out, t_steps, n, c, s);
  if (dtype == stf::kBF16)
    return (int)stf::launch<__nv_bfloat16>(x, w_ih, w_hh, b, out, t_steps,
                                           n, c, s);
  return (int)cudaErrorInvalidValue;
}
