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
// operations: at every serving width (T=8, B=8: C=64/N=25088,
// C=128/N=6272, C=256/N=1568; N*C^2 is the same) 13.2 GFLOP per call,
// 13.3 us at the 989 TFLOP/s bf16 tensor-core peak.
//
// Two kernels, chosen by a rule on dtype and C (the wrapper's
// tensor_core_fwd, TC_FWD_C), never as a fallback:
//  * bf16 at C = 64, 128, 256 - the serving and training dtype - runs on
//    tensor cores: lstm_last_x_tc_kernel on the tile of lstm_tc.cuh (the
//    staging, the WMMA gate products and the cell that K1b's tensor-core
//    replay also runs). Both A operands are exactly bf16 (x_t, and
//    round(h_{t-1}), the TPU's rounding point), so there is no hi/lo split
//    and W is read as given, [C, 4C]. A block owns 16*RF rows and all C
//    units with C/16 warps; x and round(h) are double-buffered in shared
//    memory, so a step has one barrier, and x_{t+1}'s loads are issued
//    before step t's products and stored after them. Nothing but h_T
//    reaches device memory: h_T is bf16 of the f32 h of the last step,
//    the value the recurrence rounds. Rows past N are computed on zeros
//    and never stored. The row tile is fixed per C (tc_fwd_rf): 32 rows
//    (RF = 2) at C = 64 and 128, 16 rows (RF = 1) at C = 256, chosen by
//    device time at B=8 (torch.profiler) with both tiles built, on an
//    H100 80GB HBM3 at 700 W: C=64 0.239 ms with 32 rows against 0.295
//    with 16, C=128 0.261 against 0.391, C=256 0.364 with 16 against
//    0.411 with 32 (98 blocks instead of 49, and the 32-row tile spills at
//    the 128 registers 512 threads allow).
//  * f32, and bf16 at any other C, runs the first version on CUDA cores in
//    f32 FMA (67 TFLOP/s peak): each block loops over T and owns a tile of
//    rows with all C units (lstm_cell.cuh), thread j one unit; x_t's tile
//    is staged in shared memory as f32, W_ih and W_hh repacked [C, C, 4]
//    are read through L1/L2 as 4-gate vectors; h double-buffered in shared
//    memory, one __syncthreads per half-step. TF32 would miss f32's 2e-5.
//
// What holds the tensor-core kernel back (0.24 / 0.26 / 0.36 ms at B=8,
// 18-27x the bound): every block reads all of W_ih and W_hh as fragments
// from L1/L2 at every step (2 x C x 4C bf16: 64 KB at C=64, 1 MB at
// C=256), and each step's products wait on one barrier. At C=256 a call
// takes ~0.36 ms from N=196 to N=1568: 8 steps of ~45 us, each SM pulling
// its block's 1 MB of W from L2, so the time is set per block, not by N.
// Next: W split over the blocks of a cluster (C=256) or resident in
// shared memory (C=64), cp.async / TMA staging, `wgmma`.

#include "lstm_cell.cuh"
#include "lstm_tc.cuh"

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

// Row fragments per block of the tensor-core kernel (see the note above).
template <int C>
__host__ __device__ constexpr int tc_fwd_rf() { return C == 256 ? 1 : 2; }

// bf16, C in {64, 128, 256}: the recurrence on tensor cores (lstm_tc.cuh).
// Shared memory: x_t and x_{t+1}, round(h_{t-1}) and round(h_t) as
// [16*RF][C] bf16 tiles, and one [4][16][16] f32 scratch per warp.
template <int C>
__global__ void __launch_bounds__(2 * C)
lstm_last_x_tc_kernel(const bf16* __restrict__ x,
                      const bf16* __restrict__ w_ih,
                      const bf16* __restrict__ w_hh,
                      const bf16* __restrict__ b, bf16* __restrict__ out,
                      int t_steps, int n) {
  extern __shared__ __align__(32) unsigned char smem_raw[];
  constexpr int RF = tc_fwd_rf<C>();
  constexpr int rows = RF * kFrag;
  constexpr int tile = rows * tc_lda<C>();
  bf16* xcur = reinterpret_cast<bf16*>(smem_raw);
  bf16* xnext = xcur + tile;
  bf16* hcur = xnext + tile;
  bf16* hnext = hcur + tile;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  float* scr = reinterpret_cast<float*>(hnext + tile) + warp * kTcScratch;
  const int row_base = blockIdx.x * rows;
  const int u0 = warp * kFrag;      // the warp's units
  const int j = u0 + lane % kFrag;  // the lane's unit

  float bias[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) bias[g] = __bfloat162float(b[g * C + j]);
  float cst[RF][8];
#pragma unroll
  for (int rf = 0; rf < RF; ++rf)
#pragma unroll
    for (int q = 0; q < 8; ++q) cst[rf][q] = 0.0f;
  for (int idx = tid; idx < tile; idx += 2 * C)
    hcur[idx] = __float2bfloat16_rn(0.0f);
  stage_x_tile<C, RF>(x, xcur, 0, n, row_base, tid);
  __syncthreads();  // x_0 staged, h_{-1} = 0

  for (int t = 0; t < t_steps; ++t) {
    const bool last = t == t_steps - 1;
    uint4 xv[RF];
    if (!last) load_x_tile<C, RF>(x, t + 1, n, row_base, tid, xv);
    FragC acc[RF][4];
    gates_mma<C, RF>(xcur, hcur, w_ih, w_hh, u0, acc);
    // xnext and hnext were last read by step t-1's products, which every
    // warp finished before the barrier that ended step t-1.
    if (!last) store_x_tile<C, RF>(xnext, tid, xv);
    cell_step<C, RF>(acc, scr, bias, cst, hnext, lane, j,
                     [&](int r, float h, float) {
                       const int row = row_base + r;
                       if (last && row < n)
                         out[(size_t)row * C + j] = __float2bfloat16_rn(h);
                     });
    __syncthreads();  // x_{t+1} and round(h_t) complete; step t's reads done
    bf16* tmp = xcur;
    xcur = xnext;
    xnext = tmp;
    tmp = hcur;
    hcur = hnext;
    hnext = tmp;
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

template <int C>
static cudaError_t launch_tc(const void* x, const void* w_ih,
                             const void* w_hh, const void* b, void* out,
                             int t_steps, int n, cudaStream_t stream) {
  constexpr int rows = tc_fwd_rf<C>() * kFrag;
  const size_t smem = tc_smem_bytes<C, tc_fwd_rf<C>()>(4);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        lstm_last_x_tc_kernel<C>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const unsigned blocks = (unsigned)((n + rows - 1) / rows);
  lstm_last_x_tc_kernel<C><<<blocks, 2 * C, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w_ih),
      static_cast<const bf16*>(w_hh), static_cast<const bf16*>(b),
      static_cast<bf16*>(out), t_steps, n);
  return cudaGetLastError();
}

static cudaError_t launch_tc(const void* x, const void* w_ih,
                             const void* w_hh, const void* b, void* out,
                             int t_steps, int n, int c, cudaStream_t stream) {
  switch (c) {
    case 64:
      return launch_tc<64>(x, w_ih, w_hh, b, out, t_steps, n, stream);
    case 128:
      return launch_tc<128>(x, w_ih, w_hh, b, out, t_steps, n, stream);
    case 256:
      return launch_tc<256>(x, w_ih, w_hh, b, out, t_steps, n, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace stf

// x [T,N,C], b [4C], out [N,C]; all of one dtype (0 = f32, 1 = bf16),
// contiguous, on the current device. tensor_cores = 0: the CUDA-core
// kernel, w_ih / w_hh packed [C,C,4]. tensor_cores = 1 (bf16 only, C = 64,
// 128 or 256): the tensor-core kernel, w_ih / w_hh as given [C,4C], every
// pointer 32-byte aligned. Returns a cudaError_t (0 on success).
// Asynchronous on `stream`; allocates nothing.
extern "C" int stf_lstm_last_x(const void* x, const void* w_ih,
                               const void* w_hh, const void* b, void* out,
                               int t_steps, int n, int c, int dtype,
                               int tensor_cores, void* stream) {
  if (!stf::shape_ok(t_steps, n, c)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tensor_cores) {
    if (dtype != stf::kBF16) return (int)cudaErrorInvalidValue;
    return (int)stf::launch_tc(x, w_ih, w_hh, b, out, t_steps, n, c, s);
  }
  if (dtype == stf::kF32)
    return (int)stf::launch<float>(x, w_ih, w_hh, b, out, t_steps, n, c, s);
  if (dtype == stf::kBF16)
    return (int)stf::launch<__nv_bfloat16>(x, w_ih, w_hh, b, out, t_steps,
                                           n, c, s);
  return (int)cudaErrorInvalidValue;
}
