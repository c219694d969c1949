// Shared pieces of the two pixel-LSTM forward kernels (lstm_last_x.cu,
// lstm_last.cu): element conversion, packed gate-weight loads, the block
// geometry and the LSTM cell update.
//
// Block geometry. A block owns `rows` consecutive pixel rows and ALL C
// hidden units of them. Thread (j, rg) = (threadIdx.x, threadIdx.y) owns
// hidden unit j of the kRowsPerThread rows rg*kRowsPerThread + i: it keeps
// their four gate sums and their cell state c in registers, so the cell
// update needs no exchange between threads. Only h is shared: every unit
// of a row reads the whole previous h row, so h lives in shared memory,
// double-buffered (step t reads one buffer and writes the other).
//
// Weight layout. The wrappers repack W [C, 4C] (gate order i, f, g, o) as
// [C, C, 4]: element (k, j, g) = W[k, g*C + j]. Thread j then reads the
// four gate weights of input k as one 16-byte (f32) or 8-byte (bf16) load,
// and a warp's 32 units read one contiguous run.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace stf {

constexpr int kRowsPerThread = 8;
constexpr int kTargetThreads = 256;
constexpr int kMaxC = 512;

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The value the kernel keeps after storing v in T (identity for f32).
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// Four gate weights (i, f, g, o) of one (k, j) from the packed layout.
__device__ __forceinline__ void load_gates(const float* __restrict__ p,
                                           float w[4]) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
}
__device__ __forceinline__ void load_gates(
    const __nv_bfloat16* __restrict__ p, float w[4]) {
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&v.y));
  w[0] = lo.x; w[1] = lo.y; w[2] = hi.x; w[3] = hi.y;
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// One LSTM cell update from the gate sums (bias included). Returns h.
__device__ __forceinline__ float cell(const float gates[4], float& c) {
  const float i = sigmoid(gates[0]);
  const float f = sigmoid(gates[1]);
  const float g = tanhf(gates[2]);
  const float o = sigmoid(gates[3]);
  c = f * c + i * g;
  return o * tanhf(c);
}

// acc[i][g] += sum_{k in [k0, k0+4)} a[row i][k] * W[k][j][g], with a
// (rows x C, f32) in shared memory and W packed [C][C][4].
template <typename T>
__device__ __forceinline__ void accumulate4(
    float acc[kRowsPerThread][4], const float* __restrict__ a, int c,
    const T* __restrict__ w, int k0, int j) {
  float wk[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    load_gates(w + ((size_t)(k0 + kk) * c + j) * 4, wk[kk]);
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const float4 av = *reinterpret_cast<const float4*>(a + i * c + k0);
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      float s = acc[i][g];
      s = fmaf(av.x, wk[0][g], s);
      s = fmaf(av.y, wk[1][g], s);
      s = fmaf(av.z, wk[2][g], s);
      s = fmaf(av.w, wk[3][g], s);
      acc[i][g] = s;
    }
  }
}

struct Geometry {
  dim3 block;
  dim3 grid;
  int rows;  // rows per block
};

inline Geometry geometry(int n, int c) {
  const int rg = c >= kTargetThreads ? 1 : kTargetThreads / c;
  Geometry g;
  g.rows = rg * kRowsPerThread;
  g.block = dim3(c, rg);
  g.grid = dim3((n + g.rows - 1) / g.rows);
  return g;
}

// Shapes the kernels take: C a multiple of 32 (whole warps of units, 16-byte
// aligned rows) up to kMaxC (one thread per unit, <= 48 KB shared memory).
inline bool shape_ok(int t_steps, int n, int c) {
  return t_steps >= 1 && n >= 1 && c >= 32 && c <= kMaxC && c % 32 == 0;
}

}  // namespace stf
