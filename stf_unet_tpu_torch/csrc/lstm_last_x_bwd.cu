// K1b: backward of the last-step pixel LSTM with the input projection in
// the kernel (the VJP of K1, lstm_last_x.cu).
//
// Replaces both TPU backward kernels of stf_unet_tpu/ops/pallas/
// lstm_train_kernel.py: _bwd_call_ti / _make_bwd_kernel_ti (T inside, one
// grid axis) and _bwd_call / _make_bwd_kernel (the (row tile, 2T) grid).
// They compute the same function and differ only in VMEM tiling. For x
// [T, N, C], W_ih and W_hh [C, 4C] (gate order i, f, g, o), b [4C] and the
// cotangent dh [N, C] of h_T it writes
//   dx [T, N, C] in x's dtype, dW_ih, dW_hh [C, 4C] f32, db [4C] f32,
// with the TPU kernel's rounding points (lstm_train_kernel.py:265-319):
//   * recompute: gates = x_t W_ih + round(h_{t-1}) W_hh + b in f32, where
//     round() casts to x's dtype; h_t and c_t stay f32, unrounded;
//   * from t = T-1 down: dgates in f32 (rows past N are zero),
//     dh_{t-1} = dgates W_hh^T, dx_t = round(dgates W_ih^T),
//     dW_ih += x_t^T dgates, dW_hh += h_{t-1}^T dgates with the UNROUNDED
//     f32 h_{t-1}, db += sum_rows dgates.
//
// Bound on this card: operations. The function needs 48*T*N*C^2 (one
// forward recurrence 16, dh and dx 16, dW_ih and dW_hh 16): 78.9 GFLOP per
// call at both training shapes (C=64, N=50176 and C=128, N=12544, T=8),
// 0.080 ms at the 989 TFLOP/s bf16 tensor-core peak. This first version
// runs every product on CUDA cores in f32 FMA (67 TFLOP/s peak, 1.18 ms)
// and recomputes the gates once more (+16*T*N*C^2), so it can reach at
// best ~1/20 of the bound; tensor cores are a later step.
//
// Design, three launches on one stream:
//  1. lstm_bwd_tile_kernel: a block owns a tile of rows and all C units
//     (the geometry of lstm_cell.cuh). Phase 1 replays the forward and
//     stores h_t and c_t (f32) in global scratch [T, N, C]; phase 2 walks
//     t down, recomputing the gates from the staged x_t and round(h_{t-1}).
//     Thread j owns unit j of its rows: the cell's backward needs no
//     exchange, and dh / dc stay in registers across t. dgates go to
//     shared memory [rows][C][4], from which thread k forms dh_{t-1}[k]
//     and dx_t[k] against transposed packed weights [C(j)][C(k)][4]
//     (coalesced over k), and to global scratch dg [T, N, 4C] f32.
//     The h/c scratch lives in global memory, not shared memory: held for
//     all T it would take T*rows*C*8 B = 128 KB per block, which leaves
//     one 256-thread block per SM; each thread reads back only what it
//     wrote itself, so the scratch needs no synchronisation and stays
//     coalesced.
//  2. lstm_bwd_dw_kernel: the weight gradients as A^T dg over the T*N
//     rows, A = x (dW_ih) or h shifted by one step (dW_hh), db as the
//     column sums of dg. The TPU accumulates across row tiles with += on
//     a sequential grid (:258-262, :317-319); CUDA blocks run concurrently,
//     so the T*N rows are cut into `splits` contiguous ranges and each
//     block writes its 64x64 f32 partial to a workspace.
//  3. lstm_bwd_reduce_kernel: sums the partials over the splits in a fixed
//     order. No atomics anywhere: the result is bitwise deterministic.

#include "lstm_cell.cuh"

namespace stf {

constexpr int kDwTile = 64;   // output tile of the dW kernel (k x col)
constexpr int kDwDepth = 16;  // rows of A / dg staged per step

template <typename T>
__global__ void __launch_bounds__(kMaxC)
lstm_bwd_tile_kernel(const T* __restrict__ x, const T* __restrict__ w_ih,
                     const T* __restrict__ w_hh,
                     const T* __restrict__ w_ih_t,
                     const T* __restrict__ w_hh_t, const T* __restrict__ b,
                     const T* __restrict__ dh_in, T* __restrict__ dx,
                     float* __restrict__ hs, float* __restrict__ cs,
                     float* __restrict__ dg, int t_steps, int n, int c) {
  extern __shared__ float smem[];
  const int rows = blockDim.y * kRowsPerThread;
  float* xs = smem;                // [rows][c] x_t tile, f32
  float* hbuf0 = xs + rows * c;    // [rows][c] h (phase 1: buffer 0;
                                   //            phase 2: round(h_{t-1}))
  float* region = hbuf0 + rows * c;  // phase 1: h buffer 1 [rows][c];
                                     // phase 2: dgates [rows][c][4]
  const int j = threadIdx.x;
  const int r0 = threadIdx.y * kRowsPerThread;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  const int row_base = blockIdx.x * rows;
  const int c4 = 4 * c;

  float bias[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) bias[g] = to_f32(b[g * c + j]);

  // ---- phase 1: forward replay, h_t / c_t to the scratch --------------
  for (int idx = tid; idx < rows * c; idx += nthreads) hbuf0[idx] = 0.0f;
  float cst[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) cst[i] = 0.0f;
  float* hcur = hbuf0;
  float* hnext = region;
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
      const float h = cell(gates, cst[i]);
      hnext[(r0 + i) * c + j] = round_to<T>(h);
      const int row = row_base + r0 + i;
      if (row < n) {
        const size_t o = ((size_t)t * n + row) * c + j;
        hs[o] = h;
        cs[o] = cst[i];
      }
    }
    __syncthreads();  // every read of x_t and h_{t-1} is done
    float* tmp = hcur;
    hcur = hnext;
    hnext = tmp;
  }

  // ---- phase 2: t = T-1 .. 0 -------------------------------------------
  float* hprev = hbuf0;  // round(h_{t-1}), [rows][c]
  float* dgs = region;   // dgates, [rows][c][4]
  float dh[kRowsPerThread], dcar[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int row = row_base + r0 + i;
    dh[i] = row < n ? to_f32(dh_in[(size_t)row * c + j]) : 0.0f;
    dcar[i] = 0.0f;
  }
  for (int t = t_steps - 1; t >= 0; --t) {
    for (int idx = tid; idx < rows * c; idx += nthreads) {
      const int row = row_base + idx / c;
      const int k = idx % c;
      const bool ok = row < n;
      xs[idx] = ok ? to_f32(x[((size_t)t * n + row) * c + k]) : 0.0f;
      hprev[idx] = (ok && t > 0)
                       ? round_to<T>(hs[((size_t)(t - 1) * n + row) * c + k])
                       : 0.0f;
    }
    __syncthreads();  // x_t, round(h_{t-1}) staged; last step's dgs read

    float acc[kRowsPerThread][4];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int g = 0; g < 4; ++g) acc[i][g] = 0.0f;
    for (int k = 0; k < c; k += 4) {
      accumulate4<T>(acc, xs + r0 * c, c, w_ih, k, j);
      accumulate4<T>(acc, hprev + r0 * c, c, w_hh, k, j);
    }
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int row = row_base + r0 + i;
      const bool ok = row < n;
      const float ig = sigmoid(acc[i][0] + bias[0]);
      const float fg = sigmoid(acc[i][1] + bias[1]);
      const float gg = tanhf(acc[i][2] + bias[2]);
      const float og = sigmoid(acc[i][3] + bias[3]);
      const size_t o = ((size_t)t * n + row) * c + j;
      const float c_t = ok ? cs[o] : 0.0f;
      const float c_prev =
          (ok && t > 0) ? cs[((size_t)(t - 1) * n + row) * c + j] : 0.0f;
      const float tc = tanhf(c_t);
      const float d_o = dh[i] * tc;
      const float dc = dcar[i] + dh[i] * og * (1.0f - tc * tc);
      float4 d;
      d.x = dc * gg * ig * (1.0f - ig);
      d.y = dc * c_prev * fg * (1.0f - fg);
      d.z = dc * ig * (1.0f - gg * gg);
      d.w = d_o * og * (1.0f - og);
      if (!ok) d = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      dcar[i] = ok ? dc * fg : 0.0f;
      *reinterpret_cast<float4*>(dgs + ((r0 + i) * c + j) * 4) = d;
      if (ok) {
        float* dgr = dg + ((size_t)t * n + row) * c4 + j;
        dgr[0] = d.x;
        dgr[c] = d.y;
        dgr[2 * c] = d.z;
        dgr[3 * c] = d.w;
      }
    }
    __syncthreads();  // dgates of every unit of the tile are in dgs

    // Thread k = threadIdx.x: dh_{t-1}[k] and dx_t[k] of its rows.
    const int k = j;
    float sh[kRowsPerThread], sx[kRowsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) sh[i] = sx[i] = 0.0f;
#pragma unroll 2
    for (int jj = 0; jj < c; ++jj) {
      float wh[4], wi[4];
      load_gates(w_hh_t + ((size_t)jj * c + k) * 4, wh);
      load_gates(w_ih_t + ((size_t)jj * c + k) * 4, wi);
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const float4 d =
            *reinterpret_cast<const float4*>(dgs + ((r0 + i) * c + jj) * 4);
        float s = sh[i];
        s = fmaf(d.x, wh[0], s);
        s = fmaf(d.y, wh[1], s);
        s = fmaf(d.z, wh[2], s);
        s = fmaf(d.w, wh[3], s);
        sh[i] = s;
        float u = sx[i];
        u = fmaf(d.x, wi[0], u);
        u = fmaf(d.y, wi[1], u);
        u = fmaf(d.z, wi[2], u);
        u = fmaf(d.w, wi[3], u);
        sx[i] = u;
      }
    }
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int row = row_base + r0 + i;
      dh[i] = row < n ? sh[i] : 0.0f;
      if (row < n) dx[((size_t)t * n + row) * c + k] = from_f32<T>(sx[i]);
    }
    __syncthreads();  // every read of xs, hprev and dgs is done
  }
}

// part[s][k][col] = sum over rows m of split s of A[m][k] * dg[m][col],
// with A[m] = a[t][row] (shift 0) or a[t-1][row], zero at t = 0 (shift 1),
// for m = t*N + row. With db_part, the k-tile-0 blocks also write the
// column sums of dg over the split.
template <typename TA>
__global__ void __launch_bounds__(256)
lstm_bwd_dw_kernel(const TA* __restrict__ a, int shift,
                   const float* __restrict__ dg, float* __restrict__ part,
                   float* __restrict__ db_part, int t_steps, int n, int c,
                   long long rows_per_split) {
  __shared__ __align__(16) float as[kDwDepth][kDwTile];
  __shared__ __align__(16) float gs[kDwDepth][kDwTile];
  const int c4 = 4 * c;
  const int col0 = blockIdx.x * kDwTile;
  const int k0 = blockIdx.y * kDwTile;
  const int s = blockIdx.z;
  const int tx = threadIdx.x % 16;  // 4 output columns each
  const int ty = threadIdx.x / 16;  // 4 output k each
  const long long m_total = (long long)t_steps * n;
  const long long m_begin = (long long)s * rows_per_split;
  const long long m_end =
      m_begin + rows_per_split < m_total ? m_begin + rows_per_split : m_total;

  float acc[4][4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[p][q] = 0.0f;
  float dbacc[4] = {0.0f, 0.0f, 0.0f, 0.0f};

  for (long long m0 = m_begin; m0 < m_end; m0 += kDwDepth) {
    for (int e = threadIdx.x; e < kDwDepth * kDwTile; e += blockDim.x) {
      const int mm = e / kDwTile;
      const int kk = e % kDwTile;
      const long long m = m0 + mm;
      float av = 0.0f, gv = 0.0f;
      if (m < m_end) {
        const int t = (int)(m / n);
        const int row = (int)(m % n);
        if (k0 + kk < c && t >= shift)
          av = to_f32(a[((size_t)(t - shift) * n + row) * c + k0 + kk]);
        if (col0 + kk < c4) gv = dg[(size_t)m * c4 + col0 + kk];
      }
      as[mm][kk] = av;
      gs[mm][kk] = gv;
    }
    __syncthreads();
#pragma unroll 4
    for (int mm = 0; mm < kDwDepth; ++mm) {
      const float4 av = *reinterpret_cast<const float4*>(&as[mm][ty * 4]);
      const float4 gv = *reinterpret_cast<const float4*>(&gs[mm][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float gr[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[p][q] = fmaf(ar[p], gr[q], acc[p][q]);
#pragma unroll
      for (int q = 0; q < 4; ++q) dbacc[q] += gr[q];
    }
    __syncthreads();
  }

  float* out = part + (size_t)s * c * c4;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int k = k0 + ty * 4 + p;
    if (k >= c) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int col = col0 + tx * 4 + q;
      if (col < c4) out[(size_t)k * c4 + col] = acc[p][q];
    }
  }
  if (db_part != nullptr && blockIdx.y == 0 && ty == 0) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int col = col0 + tx * 4 + q;
      if (col < c4) db_part[(size_t)s * c4 + col] = dbacc[q];
    }
  }
}

// out[e] = sum_{s = 0 .. splits-1} part[s][e], in that order.
__global__ void lstm_bwd_reduce_kernel(const float* __restrict__ part,
                                       float* __restrict__ out, int splits,
                                       long long len) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= len) return;
  float acc = 0.0f;
  for (int s = 0; s < splits; ++s) acc += part[(size_t)s * len + e];
  out[e] = acc;
}

static cudaError_t reduce(const float* part, float* out, int splits,
                          long long len, cudaStream_t stream) {
  const int threads = 256;
  const unsigned blocks = (unsigned)((len + threads - 1) / threads);
  lstm_bwd_reduce_kernel<<<blocks, threads, 0, stream>>>(part, out, splits,
                                                         len);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch(const void* x, const void* w_ih, const void* w_hh,
                          const void* w_ih_t, const void* w_hh_t,
                          const void* b, const void* dh, void* dx,
                          float* dw_ih, float* dw_hh, float* db, float* hs,
                          float* cs, float* dg, float* part, int t_steps,
                          int n, int c, int splits, cudaStream_t stream) {
  const Geometry g = geometry(n, c);
  const size_t smem = 6 * (size_t)g.rows * c * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        lstm_bwd_tile_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  lstm_bwd_tile_kernel<T><<<g.grid, g.block, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w_ih),
      static_cast<const T*>(w_hh), static_cast<const T*>(w_ih_t),
      static_cast<const T*>(w_hh_t), static_cast<const T*>(b),
      static_cast<const T*>(dh), static_cast<T*>(dx), hs, cs, dg, t_steps, n,
      c);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  const int c4 = 4 * c;
  const long long m_total = (long long)t_steps * n;
  const long long per = (m_total + splits - 1) / splits;
  const size_t mat = (size_t)c * c4;
  float* part_ih = part;
  float* part_hh = part + (size_t)splits * mat;
  float* part_db = part + 2 * (size_t)splits * mat;
  const dim3 grid((c4 + kDwTile - 1) / kDwTile, (c + kDwTile - 1) / kDwTile,
                  splits);
  lstm_bwd_dw_kernel<T><<<grid, 256, 0, stream>>>(
      static_cast<const T*>(x), 0, dg, part_ih, part_db, t_steps, n, c, per);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  lstm_bwd_dw_kernel<float><<<grid, 256, 0, stream>>>(
      hs, 1, dg, part_hh, nullptr, t_steps, n, c, per);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  if ((e = reduce(part_ih, dw_ih, splits, (long long)mat, stream)) !=
      cudaSuccess)
    return e;
  if ((e = reduce(part_hh, dw_hh, splits, (long long)mat, stream)) !=
      cudaSuccess)
    return e;
  return reduce(part_db, db, splits, (long long)c4, stream);
}

}  // namespace stf

// x [T,N,C]; w_ih / w_hh packed [C,C,4] and w_ih_t / w_hh_t packed
// transposed [C(j),C(k),4]; b [4C]; dh [N,C]; dx [T,N,C]: all of one dtype
// (0 = f32, 1 = bf16). dw_ih / dw_hh [C,4C], db [4C] f32 outputs. Scratch
// (f32, written before it is read): hs, cs [T,N,C], dg [T,N,4C], part
// [2*splits*C*4C + splits*4C]. All contiguous, on the current device.
// Returns a cudaError_t (0 on success). Asynchronous on `stream`;
// allocates nothing.
extern "C" int stf_lstm_last_x_bwd(
    const void* x, const void* w_ih, const void* w_hh, const void* w_ih_t,
    const void* w_hh_t, const void* b, const void* dh, void* dx,
    void* dw_ih, void* dw_hh, void* db, void* hs, void* cs, void* dg,
    void* part, int t_steps, int n, int c, int splits, int dtype,
    void* stream) {
  if (!stf::shape_ok(t_steps, n, c) || splits < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* f[7] = {static_cast<float*>(dw_ih), static_cast<float*>(dw_hh),
                 static_cast<float*>(db),    static_cast<float*>(hs),
                 static_cast<float*>(cs),    static_cast<float*>(dg),
                 static_cast<float*>(part)};
  if (dtype == stf::kF32)
    return (int)stf::launch<float>(x, w_ih, w_hh, w_ih_t, w_hh_t, b, dh, dx,
                                   f[0], f[1], f[2], f[3], f[4], f[5], f[6],
                                   t_steps, n, c, splits, s);
  if (dtype == stf::kBF16)
    return (int)stf::launch<__nv_bfloat16>(
        x, w_ih, w_hh, w_ih_t, w_hh_t, b, dh, dx, f[0], f[1], f[2], f[3],
        f[4], f[5], f[6], t_steps, n, c, splits, s);
  return (int)cudaErrorInvalidValue;
}
