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
// The arithmetic is the JAX package's point-gather path (data/
// transforms.py:_warp_bilinear_and_nearest), every product and sum rounded
// as written (__fmul_rn / __fadd_rn keep nvcc from contracting them into
// FMAs), so it matches its plain PyTorch twin bit for bit.
//
// Bound on this card: bytes. At B=16, Cs=9, 256^2 -> 224^2 the function
// reads 9.4 MB of uint8 source and 6.4 MB of coordinates and writes
// 25.7 MB + 3.2 MB of f32: 44.8 MB, 13.4 us at 3.35 TB/s (Cs=12: 57.5 MB,
// 17.2 us).
//
// What held the first port back (PERF.md): one thread a pixel over a
// 1-D grid issued 4*(Cs-1)+1 one-byte global loads a pixel, and a warp's
// 32 pixels lie on a tilted line of the source, so each load touched many
// sectors in many rows. A trial build without those loads ran at ~the
// byte bound; with them, 2.3x it. The TPU kernel's band, one-hot MXU
// products and bf16 hi/lo weights answer a TPU without a fast gather; what
// carries over is only that a tile of an affine warp reads a small region
// of the source.
//
// Design: each 16x16 output tile (the square has the smallest source
// footprint under rotation) is one block, a thread a pixel, grid (Wo/16,
// Ho/16, B), so no 64-bit division. The box rule: the block reduces over
// its live pixels the min and max of the clipped integer tap indices (the
// four bilinear taps and the rint tap): exactly the region the tile reads,
// for any coordinates, since NaN, +-inf and off-canvas values clip as in
// the gather. Its left edge is rounded down to 8 bytes and a row holds an
// odd number of 8-byte chunks (rows up to 15 apart fall in different
// banks). Staged path, where a plane of the box fits its kPlane = 2,560 B
// region less 8 zero bytes and Cs <= 18 (2,560 B holds the training
// draws' largest box, 2,408 B = 43 rows of 56 B at 1/scale = 2 and 30
// degrees; Cs=9: 23 KB, Cs=12: 30 KB): the block copies every plane's box
// rows into shared memory with cp.async, 8 bytes a copy, all in flight at
// once (bytes where the source or W is not 8-byte aligned), and every tap
// then reads shared memory at its box-relative offset, an out-of-valid
// tap the plane's zero byte (no select a plane). 4 one-byte shared loads
// a plane replace the scattered global ones. Direct path, otherwise
// (scattered coordinates, extreme zoom): the first port's gather from
// global memory, a branch of this kernel. Stores stay coalesced: f32 a
// lane, 16 neighbouring columns a half-warp. At 40 registers 6 blocks fit
// an SM. What holds it back now: the copy's round trip, exposed once a
// block (PERF.md). ops/kernels/warp.warp_boxes emulates the box rule and
// tests/test_torch_warp_k2.py holds it to the training draws and the
// staged gather to the plain twin.

#include <climits>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace stf {

constexpr int kTileX = 16, kTileY = 16;  // output tile, a thread a pixel
constexpr int kThreads = kTileX * kTileY;
constexpr int kWarps = kThreads / 32;
static_assert(kWarps <= 32 && (kWarps & (kWarps - 1)) == 0, "warps a block");
// A staged plane's region of shared memory: its box rows, then zeros in
// the last 8 bytes (where an out-of-valid tap reads).
constexpr int kPlane = 2560;
constexpr int kMaxPlanes = 18;  // 45 KB, inside the 48 KB default limit

__device__ __forceinline__ bool inside(float y, float x, float vh, float vw) {
  return y >= 0.0f && y <= vh - 1.0f && x >= 0.0f && x <= vw - 1.0f;
}

__device__ __forceinline__ int clip_index(float v, int size) {
  return (int)fminf(fmaxf(v, 0.0f), (float)(size - 1));
}

// v00*(1-wy)*(1-wx) + v01*(1-wy)*wx + v10*wy*(1-wx) + v11*wy*wx, left to
// right, then *alpha + beta.
__device__ __forceinline__ float lerp4(float v00, float v01, float v10,
                                       float v11, float wy, float wy0,
                                       float wx, float wx0, float alpha,
                                       float beta) {
  float v = __fmul_rn(__fmul_rn(v00, wy0), wx0);
  v = __fadd_rn(v, __fmul_rn(__fmul_rn(v01, wy0), wx));
  v = __fadd_rn(v, __fmul_rn(__fmul_rn(v10, wy), wx0));
  v = __fadd_rn(v, __fmul_rn(__fmul_rn(v11, wy), wx));
  return __fadd_rn(__fmul_rn(v, alpha), beta);
}

// The direct path at one pixel: the bilinear planes and the mask tap
// from source planes `sp` (`plane` bytes apart) at offsets o** and `on`.
__device__ __forceinline__ void blend_direct(
    const uint8_t* sp, size_t plane, size_t o00, size_t o01, size_t o10,
    size_t o11, size_t on, bool in00, bool in01, bool in10, bool in11,
    bool inn, float wy, float wy0, float wx, float wx0, int cs, float alpha,
    float beta, float fill, float* out, size_t per, float* near) {
#pragma unroll 4
  for (int ch = 0; ch < cs - 1; ++ch) {
    const uint8_t* p = sp + ch * plane;
    out[(size_t)ch * per] =
        lerp4(in00 ? (float)p[o00] : 0.0f, in01 ? (float)p[o01] : 0.0f,
              in10 ? (float)p[o10] : 0.0f, in11 ? (float)p[o11] : 0.0f,
              wy, wy0, wx, wx0, alpha, beta);
  }
  *near = inn ? (float)sp[(cs - 1) * plane + on] : fill;
}

// The staged path's bilinear planes at one pixel: every tap at its offset
// in each kPlane region (kPlane - 1, a zero, for a tap outside the valid
// region, so no select a plane).
__device__ __forceinline__ void blend_staged(const uint8_t* box, int o00,
                                             int o01, int o10, int o11,
                                             float wy, float wy0, float wx,
                                             float wx0, int planes,
                                             float alpha, float beta,
                                             float* out, size_t per) {
#pragma unroll 4
  for (int ch = 0; ch < planes; ++ch) {
    const uint8_t* p = box + ch * kPlane;
    out[(size_t)ch * per] =
        lerp4((float)p[o00], (float)p[o01], (float)p[o10], (float)p[o11], wy,
              wy0, wx, wx0, alpha, beta);
  }
}

// n / d for 0 <= n < 2^22 and d >= 1, from inv_d = 1/d in float (the GPU
// has no integer divide): the quotient of n + 1/2 lies at least 1/(2d)
// from an integer, farther than its rounding error (< 2^-23 n/d).
__device__ __forceinline__ int div_small(int n, float inv_d) {
  return (int)(((float)n + 0.5f) * inv_d);
}

// The minimum over the block of each of v[0..3], into every thread: a
// warp reduction, one barrier, and each warp reducing the warps' minima.
__device__ __forceinline__ void block_min4(int (&v)[4], int (*red)[kWarps],
                                           int tid) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int m = __reduce_min_sync(0xffffffffu, v[k]);
    if ((tid & 31) == 0) red[k][tid >> 5] = m;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < 4; ++k)
    v[k] = __reduce_min_sync(0xffffffffu, red[k][tid & (kWarps - 1)]);
}

__global__ void __launch_bounds__(kThreads, 6)  // 40 registers
    warp_kernel(const uint8_t* __restrict__ src, const float* __restrict__ gy,
                const float* __restrict__ gx, const float* __restrict__ valid,
                float* __restrict__ bil, float* __restrict__ near, int cs,
                int h, int w, int ho, int wo, float alpha, float beta,
                float fill, bool vec8,
                unsigned long long* __restrict__ paths) {
  extern __shared__ uint32_t box[];
  __shared__ int red[4][kWarps];
  const int tid = threadIdx.y * kTileX + threadIdx.x;
  const int b = blockIdx.z;
  const int oy = blockIdx.y * kTileY + threadIdx.y;
  const int ox = blockIdx.x * kTileX + threadIdx.x;
  const bool live = oy < ho && ox < wo;
  const size_t per = (size_t)ho * wo;
  const size_t p = (size_t)b * per + (size_t)oy * wo + ox;
  const float y = live ? gy[p] : 0.0f;
  const float x = live ? gx[p] : 0.0f;
  const float vh = valid[2 * b];
  const float vw = valid[2 * b + 1];

  const float y0 = floorf(y);
  const float x0 = floorf(x);
  const float y1 = __fadd_rn(y0, 1.0f);
  const float x1 = __fadd_rn(x0, 1.0f);
  const float ry = rintf(y);
  const float rx = rintf(x);
  const int cy0 = clip_index(y0, h), cy1 = clip_index(y1, h);
  const int cx0 = clip_index(x0, w), cx1 = clip_index(x1, w);
  const int cry = clip_index(ry, h), crx = clip_index(rx, w);
  const bool in00 = inside(y0, x0, vh, vw);
  const bool in01 = inside(y0, x1, vh, vw);
  const bool in10 = inside(y1, x0, vh, vw);
  const bool in11 = inside(y1, x1, vh, vw);
  const bool inn = inside(ry, rx, vh, vw);
  const float wy = __fsub_rn(y, y0);
  const float wx = __fsub_rn(x, x0);
  const float wy0 = __fsub_rn(1.0f, wy);
  const float wx0 = __fsub_rn(1.0f, wx);

  // the box rule: the clipped tap indices' min and max over the tile
  // (maxima as minima of the negated indices)
  int ext[4] = {live ? min(min(cy0, cy1), cry) : INT_MAX,
                live ? -max(max(cy0, cy1), cry) : INT_MAX,
                live ? min(min(cx0, cx1), crx) : INT_MAX,
                live ? -max(max(cx0, cx1), crx) : INT_MAX};
  block_min4(ext, red, tid);
  const int lo[2] = {ext[0], ext[2]}, hi[2] = {-ext[1], -ext[3]};
  const int rows = hi[0] - lo[0] + 1;
  const int xb = lo[1] & ~7;                 // left edge, 8-byte aligned
  const int chunks = (hi[1] >> 3) - (lo[1] >> 3) + 1;
  const int stride = (chunks | 1) * 8;       // bytes a box row
  const bool staged = cs <= kMaxPlanes && rows * stride <= kPlane - 8;
  if (paths != nullptr && tid == 0) atomicAdd(&paths[staged ? 0 : 1], 1ull);

  const uint8_t* s = src + (size_t)b * cs * h * w;
  const size_t hw = (size_t)h * w;
  float* out = bil + (size_t)b * (cs - 1) * per + (size_t)oy * wo + ox;
  if (staged) {
    // every 8-byte chunk of the box's rows, of every plane, copied by
    // cp.async (no registers held, all in flight at once); bytes where
    // the source or W is not 8-byte aligned. An odd number of chunks a
    // row puts rows up to 15 apart in different banks. Thread tid takes
    // chunk tid % lanes of plane rows tid / lanes, + per_pass, ...
    uint8_t* sbox = reinterpret_cast<uint8_t*>(box);
    const int lanes = min(chunks, kThreads);
    const int per_pass = kThreads / lanes;
    const float inv_rows = 1.0f / rows;
    const int j = tid / lanes, k0 = tid - j * lanes;
    int c = div_small(j, inv_rows), r = j - c * rows;
    for (; j < per_pass && c < cs;) {
      const uint8_t* g = s + c * hw + (size_t)(lo[0] + r) * w + xb;
      uint8_t* d = sbox + c * kPlane + r * stride;
      for (int k = k0; k < chunks; k += lanes) {
        if (vec8) {
          __pipeline_memcpy_async(d + 8 * k, g + 8 * k, 8);
        } else {
          for (int e = 8 * k; e < 8 * k + 8; ++e)
            if (xb + e < w) d[e] = g[e];
        }
      }
      r += per_pass;
      const int q = div_small(r, inv_rows);
      c += q;
      r -= q * rows;
    }
    if (tid < cs)
      *reinterpret_cast<uint2*>(sbox + tid * kPlane + kPlane - 8) =
          make_uint2(0, 0);
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    if (!live) return;
    const int r0 = (cy0 - lo[0]) * stride, r1 = (cy1 - lo[0]) * stride;
    const int c0 = cx0 - xb, c1 = cx1 - xb;
    const int zero = kPlane - 1;
    blend_staged(sbox, in00 ? r0 + c0 : zero, in01 ? r0 + c1 : zero,
                 in10 ? r1 + c0 : zero, in11 ? r1 + c1 : zero, wy, wy0, wx,
                 wx0, cs - 1, alpha, beta, out, per);
    const int on = (cs - 1) * kPlane + (cry - lo[0]) * stride + crx - xb;
    near[p] = inn ? (float)sbox[on] : fill;
  } else {
    // the direct gather from global memory, one byte a tap and plane
    if (!live) return;
    const size_t r0 = (size_t)cy0 * w, r1 = (size_t)cy1 * w;
    blend_direct(s, hw, r0 + cx0, r0 + cx1, r1 + cx0, r1 + cx1,
                 (size_t)cry * w + crx, in00, in01, in10, in11, inn, wy, wy0,
                 wx, wx0, cs, alpha, beta, fill, out, per, near + p);
  }
}

}  // namespace stf

// src [B,Cs,H,W] uint8; gy, gx [B,Ho,Wo] f32; valid [B,2] f32; bil
// [B,Cs-1,Ho,Wo] f32; near [B,Ho,Wo] f32. All contiguous, on the current
// device. `paths` is null, or two unsigned 64-bit counters to which each
// block adds one: [0] if it took the staged path, [1] the direct one.
// Returns a cudaError_t (0 on success). Asynchronous on `stream`;
// allocates nothing.
extern "C" int stf_warp(const void* src, const void* gy, const void* gx,
                        const void* valid, void* bil, void* near, int bsz,
                        int cs, int h, int w, int ho, int wo, float alpha,
                        float beta, float fill, void* paths, void* stream) {
  using namespace stf;
  if (bsz < 1 || cs < 2 || h < 1 || w < 1 || ho < 1 || wo < 1)
    return (int)cudaErrorInvalidValue;
  const bool vec8 = w % 8 == 0 && reinterpret_cast<uintptr_t>(src) % 8 == 0;
  const int smem = (cs < kMaxPlanes ? cs : kMaxPlanes) * kPlane;
  const dim3 block(kTileX, kTileY);
  const size_t src_per = (size_t)cs * h * w, per = (size_t)ho * wo;
  for (int b0 = 0; b0 < bsz; b0 += 65535) {  // gridDim.z <= 65535
    const int nb = bsz - b0 < 65535 ? bsz - b0 : 65535;
    const dim3 grid((wo + kTileX - 1) / kTileX, (ho + kTileY - 1) / kTileY,
                    nb);
    warp_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(src) + b0 * src_per,
        static_cast<const float*>(gy) + b0 * per,
        static_cast<const float*>(gx) + b0 * per,
        static_cast<const float*>(valid) + 2 * (size_t)b0,
        static_cast<float*>(bil) + (size_t)b0 * (cs - 1) * per,
        static_cast<float*>(near) + b0 * per, cs, h, w, ho, wo, alpha, beta,
        fill, vec8, static_cast<unsigned long long*>(paths));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
