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
// 0.080 ms at the 989 TFLOP/s bf16 tensor-core peak. The design recomputes
// the gates once more (+16*T*N*C^2) and keeps h, c and dg in an f32 global
// scratch: x read 3 times, h 3, c 2, dg [T, N, 4C] 2, so it moves ~1.6 GB
// per call at C=64 (0.48 ms at 3.35 TB/s) and ~0.8 GB at C=128 (0.25 ms):
// its own floor, above the bound.
//
// Two instantiations. f32 runs every product on CUDA cores in f32 FMA
// (the first version, unchanged). bf16 - the training dtype - runs its
// products on tensor cores (mma_bf16.cuh: WMMA bf16 16x16x16, f32
// accumulators):
//   * the gate recomputes from exactly-bf16 operands (x_t, round(h_{t-1}),
//     W), unsplit: the TPU's rounding point;
//   * dh and dx from the f32 dgates split into bf16 hi + lo (2 products);
//   * dW_ih from x and split dg (2 products), dW_hh from the split f32 h
//     and split dg (3 products: hi*hi + hi*lo + lo*hi). Without the lo
//     terms dW would miss the f32 sums by ~2e-3 of their max.
// The tile kernel takes tensor cores at C = 64 and 128, the fused
// training widths (C/16 warps to a block); other C run the CUDA-core tile
// kernel in bf16. The dW pass takes them at every C.
//
// Design, three kinds of launch on one stream:
//  1. the tile kernel, a block owns a tile of rows and all C units. Phase
//     1 replays the forward and stores h_t and c_t (f32) in global scratch
//     [T, N, C]; phase 2 walks t down, recomputing the gates from the
//     staged x_t and round(h_{t-1}), forming dgates per element and
//     writing them to global scratch dg [T, N, 4C] f32, then dh_{t-1} and
//     dx_t from the tile's dgates. The h/c scratch lives in global memory,
//     not shared memory: held for all T it would take 128 KB per block.
//     - lstm_bwd_tile_kernel (f32; bf16 at C other than 64, 128): thread j
//       owns unit j of its rows, dh / dc in registers across t; dgates in
//       shared memory [rows][C][4], from which thread k forms dh_{t-1}[k]
//       and dx_t[k] against transposed packed weights [C(j)][C(k)][4].
//     - lstm_bwd_tile_tc_kernel (bf16, C = 64 or 128): 32 rows, warp w
//       owns units 16w..16w+15; gate and dh/dx products on WMMA, the cell
//       math per element from accumulators staged in per-warp shared
//       memory (comment at the kernel).
//  2. the dW pass: the weight gradients as A^T dg over the T*N rows, A = x
//     (dW_ih) or h shifted by one step (dW_hh), db as the column sums of
//     dg. The TPU accumulates across row tiles with += on a sequential
//     grid (:258-262, :317-319); CUDA blocks run concurrently, so the T*N
//     rows are cut into `splits` contiguous ranges and each block writes
//     its f32 partial to a workspace. f32: lstm_bwd_dw_kernel, a 64x64
//     SIMT tile, one launch per matrix. bf16: lstm_bwd_dw_tc_kernel, one
//     launch for dW_ih, dW_hh and db, reading dg once per column tile.
//  3. lstm_bwd_reduce_kernel: sums the partials over the splits in a fixed
//     order. No atomics anywhere: the result is bitwise deterministic.

#include <type_traits>

#include "lstm_cell.cuh"
#include "lstm_tc.cuh"
#include "mma_bf16.cuh"

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

// bf16, C = 64 or 128: the tile kernel's products on tensor cores, on the
// tile of lstm_tc.cuh with kTcRows = 32 rows (two row fragments): warp w
// owns units 16w..16w+15, so C/16 warps; each lane keeps its elements'
// cell state c (phase 1) and dh / dc carry (phase 2) in registers.
//  * gates = x_t W_ih + round(h_{t-1}) W_hh: gates_mma (lstm_tc.cuh), both
//    A operands exactly bf16, W as given [C, 4C], f32 accumulators, bias
//    added per element. No split: this is the TPU's rounding point.
//  * each warp stores its 4 gate accumulators of one row fragment to its
//    own shared scratch and runs the cell (phase 1, cell_step, the same
//    code as K1's bf16 kernel) or the cell's backward (phase 2) per element
//    in f32, reading them back.
//  * phase 2: dgates go to the global dg (f32, for the dW pass) and, split
//    into bf16 hi + lo, to shared memory; then dh_{t-1} = dg_hi W_hh^T +
//    dg_lo W_hh^T and dx_t = dg_hi W_ih^T + dg_lo W_ih^T (W^T read as
//    col-major fragments of W), f32 accumulators, dx rounded to bf16.
// C is a template parameter, so the fragment loops unroll; at C=64 the
// register budget is held to three 128-thread blocks per SM.
constexpr int kTcRows = 32;
constexpr int kTcRf = kTcRows / kFrag;  // row fragments of the tile

// Row stride of the [rows][4C] bf16 dgates tiles (padded as tc_lda).
template <int C>
__host__ __device__ constexpr int tc_ldg() { return 4 * C + 8; }

// Shared memory of lstm_bwd_tile_tc_kernel<C>: the x tile and two h tiles
// and the per-warp scratch (lstm_tc.cuh), and the dgates hi / lo tiles.
template <int C>
constexpr size_t tile_tc_smem_bytes() {
  return tc_smem_bytes<C, kTcRf>(3) +
         2 * (size_t)kTcRows * tc_ldg<C>() * sizeof(__nv_bfloat16);
}

template <int C>
__global__ void __launch_bounds__(2 * C, C == 64 ? 3 : 1)
lstm_bwd_tile_tc_kernel(const __nv_bfloat16* __restrict__ x,
                        const __nv_bfloat16* __restrict__ w_ih,
                        const __nv_bfloat16* __restrict__ w_hh,
                        const __nv_bfloat16* __restrict__ b,
                        const __nv_bfloat16* __restrict__ dh_in,
                        __nv_bfloat16* __restrict__ dx,
                        float* __restrict__ hs, float* __restrict__ cs,
                        float* __restrict__ dg, int t_steps, int n) {
  extern __shared__ __align__(32) unsigned char smem_raw[];
  constexpr int c = C;
  constexpr int lda = tc_lda<C>();  // row stride of the [rows][C] tiles
  constexpr int ldg = tc_ldg<C>();  // row stride of the dgates tiles
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* hbuf0 = xs + kTcRows * lda;
  __nv_bfloat16* hbuf1 = hbuf0 + kTcRows * lda;
  __nv_bfloat16* ghi = hbuf1 + kTcRows * lda;
  __nv_bfloat16* glo = ghi + kTcRows * ldg;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* scr = reinterpret_cast<float*>(glo + kTcRows * ldg) +
               warp * kTcScratch;  // this warp's [4][16][16]
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int row_base = blockIdx.x * kTcRows;
  constexpr int c4 = 4 * c;
  constexpr int kfrags = c / kFrag;
  const int u0 = warp * kFrag;      // the warp's units
  const int j = u0 + lane % kFrag;  // the lane's unit

  float bias[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) bias[g] = __bfloat162float(b[g * c + j]);

  // ---- phase 1: forward replay, h_t / c_t to the scratch --------------
  for (int idx = tid; idx < kTcRows * lda; idx += nthreads)
    hbuf0[idx] = __float2bfloat16_rn(0.0f);
  float cst[kTcRf][8];
#pragma unroll
  for (int rf = 0; rf < kTcRf; ++rf)
#pragma unroll
    for (int q = 0; q < 8; ++q) cst[rf][q] = 0.0f;
  __nv_bfloat16* hcur = hbuf0;
  __nv_bfloat16* hnext = hbuf1;
  for (int t = 0; t < t_steps; ++t) {
    stage_x_tile<C, kTcRf>(x, xs, t, n, row_base, tid);
    __syncthreads();  // x_t staged; h_{t-1} complete
    FragC acc[kTcRf][4];
    gates_mma<C, kTcRf>(xs, hcur, w_ih, w_hh, u0, acc);
    cell_step<C, kTcRf>(acc, scr, bias, cst, hnext, lane, j,
                        [&](int r, float h, float c_t) {
                          const int row = row_base + r;
                          if (row < n) {
                            const size_t o = ((size_t)t * n + row) * c + j;
                            hs[o] = h;
                            cs[o] = c_t;
                          }
                        });
    __syncthreads();  // every read of x_t and h_{t-1} is done
    __nv_bfloat16* tmp = hcur;
    hcur = hnext;
    hnext = tmp;
  }

  // ---- phase 2: t = T-1 .. 0 -------------------------------------------
  __nv_bfloat16* hprev = hbuf0;  // round(h_{t-1})
  // dh, the dc carry and c_t of the lane's elements; c_{t-1} is loaded
  // at the top of step t (ahead of the products) and is step t-1's c_t.
  float dhr[2][8], dcar[2][8], ccur[2][8];
#pragma unroll
  for (int rf = 0; rf < 2; ++rf)
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int row = row_base + rf * kFrag + lane / kFrag + 2 * q;
      const bool ok = row < n;
      dhr[rf][q] = ok ? __bfloat162float(dh_in[(size_t)row * c + j]) : 0.0f;
      dcar[rf][q] = 0.0f;
      ccur[rf][q] =
          ok ? cs[((size_t)(t_steps - 1) * n + row) * c + j] : 0.0f;
    }
  for (int t = t_steps - 1; t >= 0; --t) {
    float cprev[2][8];
#pragma unroll
    for (int rf = 0; rf < 2; ++rf)
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int row = row_base + rf * kFrag + lane / kFrag + 2 * q;
        cprev[rf][q] = (row < n && t > 0)
                           ? cs[((size_t)(t - 1) * n + row) * c + j]
                           : 0.0f;
      }
    stage_x_tile<C, kTcRf>(x, xs, t, n, row_base, tid);
    const int quads = c / 4;
    for (int idx = tid; idx < kTcRows * quads; idx += nthreads) {
      const int r = idx / quads, k = (idx % quads) * 4;
      const int row = row_base + r;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (row < n && t > 0)
        v = *reinterpret_cast<const float4*>(
            hs + ((size_t)(t - 1) * n + row) * c + k);
      *reinterpret_cast<uint2*>(hprev + r * lda + k) =
          make_uint2(bits(__floats2bfloat162_rn(v.x, v.y)),
                     bits(__floats2bfloat162_rn(v.z, v.w)));
    }
    __syncthreads();  // x_t, round(h_{t-1}) staged; last step's dg read

    FragC acc[kTcRf][4];
    gates_mma<C, kTcRf>(xs, hprev, w_ih, w_hh, u0, acc);
#pragma unroll
    for (int rf = 0; rf < 2; ++rf) {
      to_scratch<4>(scr, acc[rf]);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int e = (lane / kFrag + 2 * q) * kFrag + lane % kFrag;
        const int r = rf * kFrag + lane / kFrag + 2 * q;
        const int row = row_base + r;
        const bool ok = row < n;
        const float ig = sigmoid(scr[e] + bias[0]);
        const float fg = sigmoid(scr[kFrag * kFrag + e] + bias[1]);
        const float gg = tanhf(scr[2 * kFrag * kFrag + e] + bias[2]);
        const float og = sigmoid(scr[3 * kFrag * kFrag + e] + bias[3]);
        const float c_t = ccur[rf][q];
        const float c_prev = cprev[rf][q];
        ccur[rf][q] = c_prev;
        const float tc = tanhf(c_t);
        const float dh = dhr[rf][q];
        const float d_o = dh * tc;
        const float dc = dcar[rf][q] + dh * og * (1.0f - tc * tc);
        float d[4];
        d[0] = dc * gg * ig * (1.0f - ig);
        d[1] = dc * c_prev * fg * (1.0f - fg);
        d[2] = dc * ig * (1.0f - gg * gg);
        d[3] = d_o * og * (1.0f - og);
        if (!ok) d[0] = d[1] = d[2] = d[3] = 0.0f;
        dcar[rf][q] = ok ? dc * fg : 0.0f;
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          if (ok) dg[((size_t)t * n + row) * c4 + g * c + j] = d[g];
          split_bf16(d[g], ghi[r * ldg + g * c + j], glo[r * ldg + g * c + j]);
        }
      }
      __syncwarp();  // scratch read before the next fragment's store
    }
    __syncthreads();  // dgates of every unit of the tile are staged

    // dh_{t-1} and dx_t of the warp's units: [rows, 4C] x W^T [4C, 16]
    FragC acc_h[2], acc_x[2];
#pragma unroll
    for (int rf = 0; rf < 2; ++rf) {
      wmma::fill_fragment(acc_h[rf], 0.0f);
      wmma::fill_fragment(acc_x[rf], 0.0f);
    }
#pragma unroll 4
    for (int kf = 0; kf < 4 * kfrags; ++kf) {
      FragBT bh, bi;
      const size_t o = (size_t)u0 * c4 + kf * kFrag;
      wmma::load_matrix_sync(bh, w_hh + o, c4);
      wmma::load_matrix_sync(bi, w_ih + o, c4);
#pragma unroll
      for (int rf = 0; rf < 2; ++rf) {
        FragA ah, al;
        wmma::load_matrix_sync(ah, ghi + rf * kFrag * ldg + kf * kFrag, ldg);
        wmma::load_matrix_sync(al, glo + rf * kFrag * ldg + kf * kFrag, ldg);
        wmma::mma_sync(acc_h[rf], ah, bh, acc_h[rf]);
        wmma::mma_sync(acc_h[rf], al, bh, acc_h[rf]);
        wmma::mma_sync(acc_x[rf], ah, bi, acc_x[rf]);
        wmma::mma_sync(acc_x[rf], al, bi, acc_x[rf]);
      }
    }
#pragma unroll
    for (int rf = 0; rf < 2; ++rf) {
      FragC both[2] = {acc_h[rf], acc_x[rf]};
      to_scratch<2>(scr, both);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int e = (lane / kFrag + 2 * q) * kFrag + lane % kFrag;
        const int row = row_base + rf * kFrag + lane / kFrag + 2 * q;
        const bool ok = row < n;
        dhr[rf][q] = ok ? scr[e] : 0.0f;
        if (ok)
          dx[((size_t)t * n + row) * c + j] =
              __float2bfloat16_rn(scr[kFrag * kFrag + e]);
      }
      __syncwarp();  // scratch read before the next fragment's store
    }
    // No barrier here: the next step's staging writes xs and hprev, whose
    // last reads (the gate products) precede the barrier above, and ghi /
    // glo are rewritten only after the next step's first barrier.
  }
}

// part[s][k][col] = sum over rows m of split s of A[m][k] * dg[m][col],
// with A[m] = a[t][row] (shift 0) or a[t-1][row], zero at t = 0 (shift 1),
// for m = t*N + row. With db_part, the k-tile-0 blocks also write the
// column sums of dg over the split. f32 only (bf16: lstm_bwd_dw_tc_kernel).
__global__ void __launch_bounds__(256)
lstm_bwd_dw_kernel(const float* __restrict__ a, int shift,
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
          av = a[((size_t)(t - shift) * n + row) * c + k0 + kk];
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

// bf16: the same partials on tensor cores, dW_ih, dW_hh and db in one pass
// over dg. A block owns a kTcK x kTcCols tile of both matrices over the
// rows of its split; per step it stages kTcDepth rows of x (bf16 as is),
// of the shifted f32 h (split into bf16 hi + lo) and of the f32 dg (split
// too; its column sums for db taken in f32 first), then each warp adds
// x^T dg_hi + x^T dg_lo and h_hi^T dg_hi + h_hi^T dg_lo + h_lo^T dg_hi
// into its 32 x 32 corner of both tiles. The next step's global loads are
// issued before this step's products (register prefetch).
constexpr int kTcK = 64;
constexpr int kTcCols = 128;
constexpr int kTcDepth = 32;
constexpr int kTcLdA = kTcK + 8;     // padded rows of the shared tiles
constexpr int kTcLdG = kTcCols + 8;  // (bf16 elements)

__global__ void __launch_bounds__(256)
lstm_bwd_dw_tc_kernel(const __nv_bfloat16* __restrict__ x,
                      const float* __restrict__ hs,
                      const float* __restrict__ dg,
                      float* __restrict__ part_ih,
                      float* __restrict__ part_hh,
                      float* __restrict__ db_part, int t_steps, int n, int c,
                      long long rows_per_split) {
  __shared__ __align__(32) __nv_bfloat16 xs[kTcDepth][kTcLdA];
  __shared__ __align__(32) __nv_bfloat16 hhi[kTcDepth][kTcLdA];
  __shared__ __align__(32) __nv_bfloat16 hlo[kTcDepth][kTcLdA];
  __shared__ __align__(32) __nv_bfloat16 ghi[kTcDepth][kTcLdG];
  __shared__ __align__(32) __nv_bfloat16 glo[kTcDepth][kTcLdG];
  __shared__ float dbs[8][kTcCols];
  const int c4 = 4 * c;
  const int k0 = blockIdx.x * kTcK;
  const int col0 = blockIdx.y * kTcCols;
  const int s = blockIdx.z;
  const int tid = threadIdx.x;
  const long long m_total = (long long)t_steps * n;
  const long long m_begin = (long long)s * rows_per_split;
  const long long m_end =
      m_begin + rows_per_split < m_total ? m_begin + rows_per_split : m_total;

  // Staging map: x one 16-byte run per thread, h two float4 (rows hr and
  // hr + 16), dg four float4 (rows gr + 8i) of fixed columns gq..gq+3.
  const int xr = tid / 8, xk = (tid % 8) * 8;
  const int hr = tid / 16, hk = (tid % 16) * 4;
  const int gr = tid / 32, gq = (tid % 32) * 4;
  uint4 xv;
  float4 hv[2], gv[4];
  float dbacc[4] = {0.0f, 0.0f, 0.0f, 0.0f};

  auto load = [&](long long m0) {
    const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    long long m = m0 + xr;
    xv = make_uint4(0, 0, 0, 0);
    if (m < m_end && k0 + xk < c)
      xv = __ldg(reinterpret_cast<const uint4*>(x + m * c + k0 + xk));
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m = m0 + hr + 16 * i;  // h_{t-1} of row m is h[m - n], zero at t = 0
      hv[i] = (m < m_end && m >= n && k0 + hk < c)
                  ? __ldg(reinterpret_cast<const float4*>(
                        hs + (m - n) * c + k0 + hk))
                  : z;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      m = m0 + gr + 8 * i;
      gv[i] = m < m_end ? __ldg(reinterpret_cast<const float4*>(
                              dg + m * c4 + col0 + gq))
                        : z;
    }
  };
  auto stage = [&]() {
    *reinterpret_cast<uint4*>(&xs[xr][xk]) = xv;
    uint2 hi, lo;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      split4(hv[i], hi, lo);
      *reinterpret_cast<uint2*>(&hhi[hr + 16 * i][hk]) = hi;
      *reinterpret_cast<uint2*>(&hlo[hr + 16 * i][hk]) = lo;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      split4(gv[i], hi, lo);
      *reinterpret_cast<uint2*>(&ghi[gr + 8 * i][gq]) = hi;
      *reinterpret_cast<uint2*>(&glo[gr + 8 * i][gq]) = lo;
      dbacc[0] += gv[i].x;
      dbacc[1] += gv[i].y;
      dbacc[2] += gv[i].z;
      dbacc[3] += gv[i].w;
    }
  };

  const int warp = tid / 32;
  const int wk = (warp / 4) * 32;  // the warp's rows of the k tile
  const int wc = (warp % 4) * 32;  // and its columns
  const bool active = k0 + wk < c;  // C a multiple of 32: all or nothing
  FragC acc_ih[2][2], acc_hh[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::fill_fragment(acc_ih[i][j], 0.0f);
      wmma::fill_fragment(acc_hh[i][j], 0.0f);
    }

  if (m_begin < m_end) load(m_begin);
  for (long long m0 = m_begin; m0 < m_end; m0 += kTcDepth) {
    stage();
    __syncthreads();
    if (m0 + kTcDepth < m_end) load(m0 + kTcDepth);
    if (active) {
#pragma unroll
      for (int ms = 0; ms < kTcDepth; ms += kFrag) {
        FragAT ax[2], ah[2], al[2];
        FragB bh[2], bl[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          wmma::load_matrix_sync(ax[i], &xs[ms][wk + kFrag * i], kTcLdA);
          wmma::load_matrix_sync(ah[i], &hhi[ms][wk + kFrag * i], kTcLdA);
          wmma::load_matrix_sync(al[i], &hlo[ms][wk + kFrag * i], kTcLdA);
          wmma::load_matrix_sync(bh[i], &ghi[ms][wc + kFrag * i], kTcLdG);
          wmma::load_matrix_sync(bl[i], &glo[ms][wc + kFrag * i], kTcLdG);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            wmma::mma_sync(acc_ih[i][j], ax[i], bh[j], acc_ih[i][j]);
            wmma::mma_sync(acc_ih[i][j], ax[i], bl[j], acc_ih[i][j]);
            wmma::mma_sync(acc_hh[i][j], ah[i], bh[j], acc_hh[i][j]);
            wmma::mma_sync(acc_hh[i][j], ah[i], bl[j], acc_hh[i][j]);
            wmma::mma_sync(acc_hh[i][j], al[i], bh[j], acc_hh[i][j]);
          }
      }
    }
    __syncthreads();  // every read of this step's tiles is done
  }

  if (active) {
    const size_t base = (size_t)s * c * c4;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const size_t o =
            base + (size_t)(k0 + wk + kFrag * i) * c4 + col0 + wc + kFrag * j;
        wmma::store_matrix_sync(part_ih + o, acc_ih[i][j], c4,
                                wmma::mem_row_major);
        wmma::store_matrix_sync(part_hh + o, acc_hh[i][j], c4,
                                wmma::mem_row_major);
      }
  }
  if (blockIdx.x == 0) {  // db: the 8 row groups summed in a fixed order
#pragma unroll
    for (int e = 0; e < 4; ++e) dbs[gr][gq + e] = dbacc[e];
    __syncthreads();
    if (tid < kTcCols) {
      float sum = 0.0f;
#pragma unroll
      for (int r = 0; r < 8; ++r) sum += dbs[r][tid];
      db_part[(size_t)s * c4 + col0 + tid] = sum;
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

template <int C>
static cudaError_t tile_tc(const void* x, const void* w_ih, const void* w_hh,
                           const void* b, const void* dh, void* dx,
                           float* hs, float* cs, float* dg, int t_steps,
                           int n, cudaStream_t stream) {
  const size_t smem = tile_tc_smem_bytes<C>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        lstm_bwd_tile_tc_kernel<C>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const unsigned blocks = (unsigned)((n + kTcRows - 1) / kTcRows);
  lstm_bwd_tile_tc_kernel<C><<<blocks, 2 * C, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w_ih),
      static_cast<const bf16*>(w_hh), static_cast<const bf16*>(b),
      static_cast<const bf16*>(dh), static_cast<bf16*>(dx), hs, cs, dg,
      t_steps, n);
  return cudaGetLastError();
}

static cudaError_t tile_tc(const void* x, const void* w_ih, const void* w_hh,
                           const void* b, const void* dh, void* dx,
                           float* hs, float* cs, float* dg, int t_steps,
                           int n, int c, cudaStream_t stream) {
  switch (c) {
    case 64:
      return tile_tc<64>(x, w_ih, w_hh, b, dh, dx, hs, cs, dg, t_steps, n,
                         stream);
    case 128:
      return tile_tc<128>(x, w_ih, w_hh, b, dh, dx, hs, cs, dg, t_steps, n,
                          stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
static cudaError_t tile_simt(const void* x, const void* w_ih,
                             const void* w_hh, const void* w_ih_t,
                             const void* w_hh_t, const void* b,
                             const void* dh, void* dx, float* hs, float* cs,
                             float* dg, int t_steps, int n, int c,
                             cudaStream_t stream) {
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
  return cudaGetLastError();
}

// tc_tile: the tile kernel on tensor cores (bf16, C = 64 or 128), with
// w_ih / w_hh in the [C, 4C] layout; otherwise the CUDA-core tile kernel
// with the packed weights.
template <typename T>
static cudaError_t launch(const void* x, const void* w_ih, const void* w_hh,
                          const void* w_ih_t, const void* w_hh_t,
                          const void* b, const void* dh, void* dx,
                          float* dw_ih, float* dw_hh, float* db, float* hs,
                          float* cs, float* dg, float* part, int t_steps,
                          int n, int c, int splits, bool tc_tile,
                          cudaStream_t stream) {
  cudaError_t e =
      tc_tile ? tile_tc(x, w_ih, w_hh, b, dh, dx, hs, cs, dg, t_steps, n, c,
                        stream)
              : tile_simt<T>(x, w_ih, w_hh, w_ih_t, w_hh_t, b, dh, dx, hs,
                             cs, dg, t_steps, n, c, stream);
  if (e != cudaSuccess) return e;

  const int c4 = 4 * c;
  const long long m_total = (long long)t_steps * n;
  const long long per = (m_total + splits - 1) / splits;
  const size_t mat = (size_t)c * c4;
  float* part_ih = part;
  float* part_hh = part + (size_t)splits * mat;
  float* part_db = part + 2 * (size_t)splits * mat;
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    const dim3 grid((c + kTcK - 1) / kTcK, c4 / kTcCols, splits);
    lstm_bwd_dw_tc_kernel<<<grid, 256, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), hs, dg, part_ih, part_hh,
        part_db, t_steps, n, c, per);
  } else {
    const dim3 grid((c4 + kDwTile - 1) / kDwTile,
                    (c + kDwTile - 1) / kDwTile, splits);
    lstm_bwd_dw_kernel<<<grid, 256, 0, stream>>>(
        static_cast<const float*>(x), 0, dg, part_ih, part_db, t_steps, n, c,
        per);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    lstm_bwd_dw_kernel<<<grid, 256, 0, stream>>>(hs, 1, dg, part_hh, nullptr,
                                                 t_steps, n, c, per);
  }
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
// transposed [C(j),C(k),4], or with tc_tile = 1 (bf16 only, C = 64 or
// 128) w_ih / w_hh as given [C,4C] and w_ih_t / w_hh_t unused; b [4C];
// dh [N,C]; dx [T,N,C]: all of one dtype (0 = f32, 1 = bf16). dw_ih /
// dw_hh [C,4C], db [4C] f32 outputs. Scratch (f32, written before it is
// read): hs, cs [T,N,C], dg [T,N,4C], part [2*splits*C*4C + splits*4C].
// All contiguous, on the current device. Returns a cudaError_t (0 on
// success). Asynchronous on `stream`; allocates nothing.
extern "C" int stf_lstm_last_x_bwd(
    const void* x, const void* w_ih, const void* w_hh, const void* w_ih_t,
    const void* w_hh_t, const void* b, const void* dh, void* dx,
    void* dw_ih, void* dw_hh, void* db, void* hs, void* cs, void* dg,
    void* part, int t_steps, int n, int c, int splits, int dtype,
    int tc_tile, void* stream) {
  if (!stf::shape_ok(t_steps, n, c) || splits < 1)
    return (int)cudaErrorInvalidValue;
  if (tc_tile && dtype != stf::kBF16) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* f[7] = {static_cast<float*>(dw_ih), static_cast<float*>(dw_hh),
                 static_cast<float*>(db),    static_cast<float*>(hs),
                 static_cast<float*>(cs),    static_cast<float*>(dg),
                 static_cast<float*>(part)};
  if (dtype == stf::kF32)
    return (int)stf::launch<float>(x, w_ih, w_hh, w_ih_t, w_hh_t, b, dh, dx,
                                   f[0], f[1], f[2], f[3], f[4], f[5], f[6],
                                   t_steps, n, c, splits, false, s);
  if (dtype == stf::kBF16)
    return (int)stf::launch<__nv_bfloat16>(
        x, w_ih, w_hh, w_ih_t, w_hh_t, b, dh, dx, f[0], f[1], f[2], f[3],
        f[4], f[5], f[6], t_steps, n, c, splits, tc_tile != 0, s);
  return (int)cudaErrorInvalidValue;
}
