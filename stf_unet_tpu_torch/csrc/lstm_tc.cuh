// The pixel-LSTM forward recurrence on tensor cores, bf16: the pieces K1's
// bf16 instantiation (lstm_last_x.cu) and phase 1 of K1b's tensor-core
// tile kernel (lstm_last_x_bwd.cu) share.
//
// Tile. A block owns 16*RF consecutive pixel rows (RF row fragments) and
// all C units; it runs C/16 warps, 2C threads, and warp w owns units
// 16w..16w+15 of every row fragment. Lane l owns the elements
// (l/16 + 2q, l%16), q = 0..7, of each 16 x 16 fragment of its warp, so
// their cell state stays in its registers across t.
//
// Products. gates = x_t W_ih + round(h_{t-1}) W_hh with WMMA bf16
// 16x16x16 products and f32 accumulators. Both A operands are exactly
// bf16 - x_t as given, h_{t-1} rounded to bf16 before the product, the
// TPU kernel's rounding point - so every product is exact in f32 and no
// hi/lo split is needed. They are staged in shared memory as [rows][C]
// tiles with a padded row stride; W is bf16 in its given [C, 4C] layout,
// read as fragments through L1/L2 (it does not fit in shared memory at
// C >= 128). Per 16-deep k block the x and the h product go into the same
// accumulator, x first.
//
// Cell. WMMA's accumulator layout is opaque, so each warp stores a row
// fragment's four gate accumulators to its own shared scratch [4][16][16]
// f32, and each lane reads back its elements' four gates, adds the bias
// and runs cell() (lstm_cell.cuh) in f32.
#pragma once

#include "lstm_cell.cuh"
#include "mma_bf16.cuh"

namespace stf {

using bf16 = __nv_bfloat16;

// Row stride of the [rows][C] bf16 tiles: 16 bytes of padding stagger the
// banks of WMMA's row loads; every fragment stays 32-byte aligned.
template <int C>
__host__ __device__ constexpr int tc_lda() { return C + 8; }

// Scratch floats per warp: one row fragment's four gate accumulators.
constexpr int kTcScratch = 4 * kFrag * kFrag;

// Shared memory of `tiles` [16*RF][C] bf16 tiles and one scratch per warp.
template <int C, int RF>
constexpr size_t tc_smem_bytes(int tiles) {
  return (size_t)tiles * kFrag * RF * tc_lda<C>() * sizeof(bf16) +
         (size_t)(C / kFrag) * kTcScratch * sizeof(float);
}

// x_t's rows [row_base, row_base + 16*RF) in 16-byte runs, RF per thread
// (2C threads, C/8 runs a row); rows past N are zero.
template <int C, int RF>
__device__ __forceinline__ void load_x_tile(const bf16* __restrict__ x,
                                            int t, int n, int row_base,
                                            int tid, uint4 (&v)[RF]) {
  constexpr int runs = C / 8;
#pragma unroll
  for (int i = 0; i < RF; ++i) {
    const int idx = tid + i * 2 * C;
    const int row = row_base + idx / runs, k = (idx % runs) * 8;
    v[i] = row < n ? __ldg(reinterpret_cast<const uint4*>(
                         x + ((size_t)t * n + row) * C + k))
                   : make_uint4(0, 0, 0, 0);
  }
}

template <int C, int RF>
__device__ __forceinline__ void store_x_tile(bf16* xs, int tid,
                                             const uint4 (&v)[RF]) {
  constexpr int runs = C / 8;
#pragma unroll
  for (int i = 0; i < RF; ++i) {
    const int idx = tid + i * 2 * C;
    *reinterpret_cast<uint4*>(xs + (idx / runs) * tc_lda<C>() +
                              (idx % runs) * 8) = v[i];
  }
}

template <int C, int RF>
__device__ __forceinline__ void stage_x_tile(const bf16* __restrict__ x,
                                             bf16* xs, int t, int n,
                                             int row_base, int tid) {
  uint4 v[RF];
  load_x_tile<C, RF>(x, t, n, row_base, tid, v);
  store_x_tile<C, RF>(xs, tid, v);
}

// acc[rf][g] = x_t W_ih + h W_hh over the tile's rows and units
// u0..u0+15 of gate g; xs and hs are the staged [rows][C] tiles.
template <int C, int RF>
__device__ __forceinline__ void gates_mma(const bf16* xs, const bf16* hs,
                                          const bf16* __restrict__ w_ih,
                                          const bf16* __restrict__ w_hh,
                                          int u0, FragC (&acc)[RF][4]) {
  constexpr int lda = tc_lda<C>();
  constexpr int c4 = 4 * C;
#pragma unroll
  for (int rf = 0; rf < RF; ++rf)
#pragma unroll
    for (int g = 0; g < 4; ++g) wmma::fill_fragment(acc[rf][g], 0.0f);
#pragma unroll
  for (int kf = 0; kf < C / kFrag; ++kf) {
    FragA ax[RF], ah[RF];
#pragma unroll
    for (int rf = 0; rf < RF; ++rf) {
      wmma::load_matrix_sync(ax[rf], xs + rf * kFrag * lda + kf * kFrag, lda);
      wmma::load_matrix_sync(ah[rf], hs + rf * kFrag * lda + kf * kFrag, lda);
    }
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      FragB bi, bh;
      const size_t o = (size_t)kf * kFrag * c4 + g * C + u0;
      wmma::load_matrix_sync(bi, w_ih + o, c4);
      wmma::load_matrix_sync(bh, w_hh + o, c4);
#pragma unroll
      for (int rf = 0; rf < RF; ++rf) {
        wmma::mma_sync(acc[rf][g], ax[rf], bi, acc[rf][g]);
        wmma::mma_sync(acc[rf][g], ah[rf], bh, acc[rf][g]);
      }
    }
  }
}

// frags[0..COUNT) -> the warp's scratch, row-major 16 x 16 each.
template <int COUNT>
__device__ __forceinline__ void to_scratch(float* scr, const FragC* frags) {
#pragma unroll
  for (int g = 0; g < COUNT; ++g)
    wmma::store_matrix_sync(scr + g * kFrag * kFrag, frags[g], kFrag,
                            wmma::mem_row_major);
  __syncwarp();
}

// Scratch index and tile row of lane's element q of a row fragment.
__device__ __forceinline__ int frag_elem(int lane, int q) {
  return (lane / kFrag + 2 * q) * kFrag + lane % kFrag;
}
__device__ __forceinline__ int frag_row(int rf, int lane, int q) {
  return rf * kFrag + lane / kFrag + 2 * q;
}

// One step's cell for the warp's units j over the tile's rows: gates from
// acc (through the scratch) plus bias, c carried in cst, bf16(h) to the
// [rows][C] tile hnext, and emit(r, h, c) with tile row r and the f32 h
// and c of the element.
template <int C, int RF, typename Emit>
__device__ __forceinline__ void cell_step(FragC (&acc)[RF][4], float* scr,
                                          const float (&bias)[4],
                                          float (&cst)[RF][8], bf16* hnext,
                                          int lane, int j, Emit&& emit) {
#pragma unroll
  for (int rf = 0; rf < RF; ++rf) {
    to_scratch<4>(scr, acc[rf]);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int e = frag_elem(lane, q);
      const int r = frag_row(rf, lane, q);
      float gates[4];
#pragma unroll
      for (int g = 0; g < 4; ++g)
        gates[g] = scr[g * kFrag * kFrag + e] + bias[g];
      const float h = cell(gates, cst[rf][q]);
      hnext[r * tc_lda<C>() + j] = __float2bfloat16_rn(h);
      emit(r, h, cst[rf][q]);
    }
    __syncwarp();  // scratch read before the next fragment's store
  }
}

}  // namespace stf
