// K2: the training augmentation's fused affine warp.
//
// Replaces the TPU kernel stf_unet_tpu/ops/pallas/warp_kernel.py:
// _pallas_warp / _warp_kernel (public warp_bilinear_nearest_mxu). For a
// stacked uint8 source [B, Cs, H, W] (Cs-1 frames, then the mask), float
// source coordinates gy, gx [B, Ho, Wo] and the per-sample valid region
// valid [B, 2] = (valid_h, valid_w) it writes
//   bil  [B, Cs-1, Ho, Wo] f32: bilinear taps at floor(g) + {0, 1}, each
//        tap zeroed unless 0 <= y <= valid_h-1 and 0 <= x <= valid_w-1,
//        indices clipped to the canvas, then v*alpha + beta;
//   near [B, Ho, Wo] f32: the mask at (rint(gy), rint(gx)), `fill` outside
//        the valid region. rintf rounds half to even like jnp.round
//        (roundf would round half away from zero and move labels).
//
// The TPU kernel expresses the taps as one-hot matrix products on the MXU
// with bf16 hi/lo weights to avoid the TPU's gather unit. A GPU gathers
// natively, so this is the direct gather: the arithmetic of the JAX
// package's point-gather path (data/transforms.py:_warp_bilinear_and_
// nearest), every product and sum rounded as written (__fmul_rn /
// __fadd_rn keep nvcc from contracting them into FMAs), so it matches its
// plain PyTorch twin bit for bit.
//
// Bound on this card: bytes. At B=16, Cs=9, 256^2 -> 224^2 the function
// reads 9.4 MB of uint8 source and 6.4 MB of coordinates and writes
// 25.7 MB + 3.2 MB of f32, ~13 us at 3.35 TB/s. One thread per output
// pixel computes the tap indices and weights once and loops over the
// channels; neighbouring threads take neighbouring output columns, so the
// coordinate reads and the output writes are coalesced and the source
// reads of a warp fall in a few rows (the affine map is smooth).

#include <cuda_runtime.h>
#include <stdint.h>

namespace stf {

__device__ __forceinline__ bool inside(float y, float x, float vh, float vw) {
  return y >= 0.0f && y <= vh - 1.0f && x >= 0.0f && x <= vw - 1.0f;
}

__device__ __forceinline__ int clip_index(float v, int size) {
  return (int)fminf(fmaxf(v, 0.0f), (float)(size - 1));
}

__global__ void warp_kernel(const uint8_t* __restrict__ src,
                            const float* __restrict__ gy,
                            const float* __restrict__ gx,
                            const float* __restrict__ valid,
                            float* __restrict__ bil,
                            float* __restrict__ near, int bsz, int cs, int h,
                            int w, int ho, int wo, float alpha, float beta,
                            float fill) {
  const long long per = (long long)ho * wo;
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= bsz * per) return;
  const int b = (int)(p / per);
  const long long q = p % per;
  const float y = gy[p];
  const float x = gx[p];
  const float vh = valid[2 * b];
  const float vw = valid[2 * b + 1];
  const uint8_t* s = src + (size_t)b * cs * h * w;
  const size_t plane = (size_t)h * w;

  const float y0 = floorf(y);
  const float x0 = floorf(x);
  const float y1 = __fadd_rn(y0, 1.0f);
  const float x1 = __fadd_rn(x0, 1.0f);
  const float wy = __fsub_rn(y, y0);
  const float wx = __fsub_rn(x, x0);
  const float wy0 = __fsub_rn(1.0f, wy);
  const float wx0 = __fsub_rn(1.0f, wx);
  const bool in00 = inside(y0, x0, vh, vw);
  const bool in01 = inside(y0, x1, vh, vw);
  const bool in10 = inside(y1, x0, vh, vw);
  const bool in11 = inside(y1, x1, vh, vw);
  const size_t o00 = (size_t)clip_index(y0, h) * w + clip_index(x0, w);
  const size_t o01 = (size_t)clip_index(y0, h) * w + clip_index(x1, w);
  const size_t o10 = (size_t)clip_index(y1, h) * w + clip_index(x0, w);
  const size_t o11 = (size_t)clip_index(y1, h) * w + clip_index(x1, w);

  float* out = bil + (size_t)b * (cs - 1) * per + q;
  for (int ch = 0; ch < cs - 1; ++ch) {
    const uint8_t* sp = s + ch * plane;
    const float v00 = in00 ? (float)sp[o00] : 0.0f;
    const float v01 = in01 ? (float)sp[o01] : 0.0f;
    const float v10 = in10 ? (float)sp[o10] : 0.0f;
    const float v11 = in11 ? (float)sp[o11] : 0.0f;
    // v00*(1-wy)*(1-wx) + v01*(1-wy)*wx + v10*wy*(1-wx) + v11*wy*wx,
    // left to right
    float v = __fmul_rn(__fmul_rn(v00, wy0), wx0);
    v = __fadd_rn(v, __fmul_rn(__fmul_rn(v01, wy0), wx));
    v = __fadd_rn(v, __fmul_rn(__fmul_rn(v10, wy), wx0));
    v = __fadd_rn(v, __fmul_rn(__fmul_rn(v11, wy), wx));
    out[(size_t)ch * per] = __fadd_rn(__fmul_rn(v, alpha), beta);
  }

  const float ry = rintf(y);
  const float rx = rintf(x);
  const uint8_t* mask = s + (size_t)(cs - 1) * plane;
  near[p] = inside(ry, rx, vh, vw)
                ? (float)mask[(size_t)clip_index(ry, h) * w + clip_index(rx, w)]
                : fill;
}

}  // namespace stf

// src [B,Cs,H,W] uint8; gy, gx [B,Ho,Wo] f32; valid [B,2] f32; bil
// [B,Cs-1,Ho,Wo] f32; near [B,Ho,Wo] f32. All contiguous, on the current
// device. Returns a cudaError_t (0 on success). Asynchronous on `stream`;
// allocates nothing.
extern "C" int stf_warp(const void* src, const void* gy, const void* gx,
                        const void* valid, void* bil, void* near, int bsz,
                        int cs, int h, int w, int ho, int wo, float alpha,
                        float beta, float fill, void* stream) {
  if (bsz < 1 || cs < 2 || h < 1 || w < 1 || ho < 1 || wo < 1)
    return (int)cudaErrorInvalidValue;
  const long long total = (long long)bsz * ho * wo;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  stf::warp_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<const float*>(gy),
      static_cast<const float*>(gx), static_cast<const float*>(valid),
      static_cast<float*>(bil), static_cast<float*>(near), bsz, cs, h, w, ho,
      wo, alpha, beta, fill);
  return (int)cudaGetLastError();
}
