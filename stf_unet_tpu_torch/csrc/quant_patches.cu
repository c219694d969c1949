// K5: quantize an activation to int8 and gather its convolution patches.
//
// No TPU kernel is replaced: the JAX package's int8 convolution
// (stf_unet_tpu/ops/quant.py:_int8_conv) quantizes x with jnp ops and hands
// the int8 tensor to lax.conv_general_dilated, which XLA lowers. The port
// builds that convolution as a GEMM, torch._int_mm (cuBLASLt's int8
// tensor-core product) of this kernel's patch matrix with the packed int8
// weights, and this kernel is its operand pass. For x [N, C, H, W] (f32 or
// bf16, any strides: the wrapper passes NCHW-contiguous and channels-last
// tensors) and the per-tensor scale s = max(sx, 1e-8) / 127 (a device f32)
// it writes the int8 matrix P [rows, Kp]:
//   P[m, k] = clip(rint(float(x[n, c, oh*sh - ph + dy, ow*sw - pw + dx]) / s),
//                  -127, 127)
// with m = (n*Ho + oh)*Wo + ow and k = (dy*KW + dx)*C + c: a patch row is
// KH*KW runs of C contiguous bytes (the weights are packed to match, ops/
// quant.pack_weights). A tap outside x, and every column k >= K = KH*KW*C
// (the pad to Kp, a multiple of 8), is 0. The rows past m_total are not
// written: the wrapper zeroes them where it pads the GEMM's M.
//
// Arithmetic in the JAX package's order: a true IEEE division by s
// (__fdiv_rn, not a multiply by 1/s, which differs in the last ulp and
// flips the rounding at a .5 boundary), then rintf (round half to even, as
// jnp.round), then the clip.
//
// Bound on this card: bytes. Each x element is read once and each P byte
// written once: at the UNet's 3x3 conv at B = 8, 224^2, 64 channels, 51 MB
// of bf16 read and 231 MB written, 84 us at 3.35 TB/s.
//
// Design. A block takes a tile of TH x TW output pixels of one image and a
// chunk of channels; the grid is (tiles, chunks). The tile is at most 16 x
// 16 and 128 pixels (run mode) or 32 x 32 and 512 (row mode, whose rows
// are short), split evenly over the image (56^2 is 8 x 14, 14^2 7 x 14,
// 7^2 one 7 x 7 tile), and shrinks until the box fits 32 KB. Two modes:
//   run mode, when C is a multiple of 16 and Kp = K (every conv past the
//     stems): chunks of the largest power-of-two multiple of 16 that
//     divides C, at most 128 channels where the patch matrix has
//     kWideRows rows or more, else 64 (on the card, 128 was faster at
//     the UNet's 56^2 to 224^2 convs and slower at 28^2 and below, where
//     it halves a grid of a few hundred blocks); a tap's run of the chunk's
//     channels is contiguous in the box and in P, and one thread copies 16
//     bytes of it, consecutive threads on consecutive 16 bytes of a row.
//   row mode, otherwise (the stems at C = 1, 4, 8; C = 67..515 at the PK
//     model's fusion convs): one chunk of all C channels; a table of Kp
//     box offsets (-1 for a pad column) turns each 8-byte word of a patch
//     row into 8 shared-memory byte reads, and one thread writes the word.
//  1. The block loads the tile's source box, ((TH-1)*sh + KH) x ((TW-1)*sw
//     + KW) pixels by the chunk's channels, with the reads coalesced along
//     whichever axis of x is contiguous: 16-byte loads of 8 bf16 (4 f32)
//     channels when C allows (channels-last); else one element a thread,
//     along C (channels-last) or along W (NCHW). It quantizes each element
//     once (one division per element of the box, not one per patch byte:
//     ~9x fewer at 3x3 stride 1) into an int8 box in shared memory laid
//     out [row][col][c], a box pixel every `box_stride` bytes (in run mode
//     chunk + 16: eight 16-byte accesses of consecutive pixels hit 32
//     distinct banks).
//  2. It writes the patch rows from the box (run or row mode), every byte
//     of every row of the tile, pad columns included, once.
// Index arithmetic: the quotients of small non-negative integers (< 2^22)
// by per-block divisors are taken as (a + 0.5) * (1/d) in f32, exact there
// (the quotient sits at least 1/(2d) from an integer; the two roundings
// move it by less), three instructions where an integer division takes
// some twenty.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace stf {

constexpr int kThreads = 256;
constexpr int kBoxBudget = 32 * 1024;
constexpr int kMaxSmem = 227 * 1024;
constexpr long long kWideRows = 24576;

// the box's loaders: 16-byte channel-major, or one element a thread
// (W-major or C-major by a flag)
enum Load { kVecC = 0, kScalar = 1 };

struct Geometry {
  int c_in, h, w;
  long long sn, sc, sy, sx;  // x's strides in elements
  int kh, kw, sh, sw, ph, pw, ho, wo;
  int k_total, kp;
  int th, tw, bh, bw;        // output tile, source box
  int tiles_h, tiles_w;
  int chunk, box_stride;     // channels per block, box bytes per pixel
  int c_major;               // kScalar: consecutive threads along C
};

__device__ __forceinline__ float as_f32(float v) { return v; }
__device__ __forceinline__ float as_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ uint8_t quantize(float v, float s) {
  const float q = rintf(__fdiv_rn(v, s));
  return (uint8_t)(int8_t)(int)fminf(fmaxf(q, -127.0f), 127.0f);
}

// a / d for 0 <= a < 2^22, inv = 1.0f / d (module note)
__device__ __forceinline__ int quot(int a, float inv) {
  return (int)(((float)a + 0.5f) * inv);
}

__device__ __forceinline__ int align16(int bytes) {
  return (bytes + 15) & ~15;
}

template <typename T, bool kRun, int kLoad>
__global__ void __launch_bounds__(kThreads)
    quant_patches_kernel(const T* __restrict__ x,
                         const float* __restrict__ scale,
                         int8_t* __restrict__ out, const Geometry g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int taps = g.kh * g.kw;
  const int tile_px = g.th * g.tw;
  const int words = g.kp / 8;  // row mode: 8-byte words of a row
  int* tap_src = reinterpret_cast<int*>(smem);
  int* pix_src = reinterpret_cast<int*>(smem + align16(taps * 4));
  long long* pix_dst = reinterpret_cast<long long*>(
      smem + align16(taps * 4) + align16(tile_px * 4));
  int* col_src = reinterpret_cast<int*>(
      reinterpret_cast<unsigned char*>(pix_dst) + align16(tile_px * 8));
  unsigned char* box = reinterpret_cast<unsigned char*>(col_src) +
                       (kRun ? 0 : align16(g.kp * 4));

  const float s = *scale;
  int b = blockIdx.x;
  const int tile_w = b % g.tiles_w;
  b /= g.tiles_w;
  const int tile_h = b % g.tiles_h;
  const long long n = b / g.tiles_h;
  const int oh0 = tile_h * g.th, ow0 = tile_w * g.tw;
  const int ih0 = oh0 * g.sh - g.ph, iw0 = ow0 * g.sw - g.pw;
  const int c0 = blockIdx.y * g.chunk;
  const int cc = min(g.chunk, g.c_in - c0);

  for (int t = threadIdx.x; t < taps; t += kThreads) {
    const int dy = t / g.kw;
    tap_src[t] = (dy * g.bw + (t - dy * g.kw)) * g.box_stride;
  }
  for (int p = threadIdx.x; p < tile_px; p += kThreads) {
    const int ohl = p / g.tw, owl = p - ohl * g.tw;
    const int oh = oh0 + ohl, ow = ow0 + owl;
    pix_src[p] = (ohl * g.sh * g.bw + owl * g.sw) * g.box_stride;
    pix_dst[p] = oh < g.ho && ow < g.wo
                     ? ((n * g.ho + oh) * g.wo + ow) * g.kp : -1;
  }
  if constexpr (!kRun) {
    for (int k = threadIdx.x; k < g.kp; k += kThreads) {
      int off = -1;
      if (k < g.k_total) {
        const int tap = k / g.c_in, dy = tap / g.kw;
        off = (dy * g.bw + (tap - dy * g.kw)) * g.box_stride +
              (k - tap * g.c_in);
      }
      col_src[k] = off;
    }
  }

  // 1. the source box, each element quantized once
  const T* xn = x + n * g.sn + c0 * g.sc;
  const int box_px = g.bh * g.bw;
  const float inv_bw = 1.0f / g.bw;
  if constexpr (kLoad == kVecC) {
    constexpr int VL = 16 / sizeof(T);
    using VT = typename std::conditional<VL == 8, uint2, uint32_t>::type;
    const int nv = cc / VL;
    const float inv_nv = 1.0f / nv;
    for (int e = threadIdx.x; e < box_px * nv; e += kThreads) {
      const int px = quot(e, inv_nv), v = e - px * nv;
      const int r = quot(px, inv_bw);
      const int ih = ih0 + r, iw = iw0 + (px - r * g.bw);
      union { VT word; uint8_t q[VL]; } packed;
      packed.word = VT();
      if (ih >= 0 && ih < g.h && iw >= 0 && iw < g.w) {
        const uint4 raw = *reinterpret_cast<const uint4*>(
            xn + ih * g.sy + iw * g.sx + v * VL);
        const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int j = 0; j < VL; ++j)
          packed.q[j] = quantize(as_f32(vals[j]), s);
      }
      *reinterpret_cast<VT*>(box + px * g.box_stride + v * VL) = packed.word;
    }
  } else {
    const int inner = g.c_major ? cc : box_px;
    const float inv_inner = 1.0f / inner;
    for (int e = threadIdx.x; e < box_px * cc; e += kThreads) {
      const int hi = quot(e, inv_inner), lo = e - hi * inner;
      const int c = g.c_major ? lo : hi, px = g.c_major ? hi : lo;
      const int r = quot(px, inv_bw);
      const int ih = ih0 + r, iw = iw0 + (px - r * g.bw);
      uint8_t q = 0;
      if (ih >= 0 && ih < g.h && iw >= 0 && iw < g.w)
        q = quantize(as_f32(xn[c * g.sc + ih * g.sy + iw * g.sx]), s);
      box[px * g.box_stride + c] = q;
    }
  }
  __syncthreads();

  // 2. the patch rows
  if constexpr (kRun) {
    const int upt = cc / 16;  // units of 16 bytes a tap, a power of two
    const int shift = __ffs(upt) - 1;
    const int upr = taps * upt;
    const float inv_upr = 1.0f / upr;
    for (int i = threadIdx.x; i < tile_px * upr; i += kThreads) {
      const int p = quot(i, inv_upr), u = i - p * upr;
      const long long dst = pix_dst[p];
      if (dst < 0) continue;
      const int tap = u >> shift, cu = u & (upt - 1);
      *reinterpret_cast<uint4*>(out + dst + tap * g.c_in + c0 + cu * 16) =
          *reinterpret_cast<const uint4*>(box + pix_src[p] + tap_src[tap] +
                                          cu * 16);
    }
  } else {
    const float inv_words = 1.0f / words;
    for (int i = threadIdx.x; i < tile_px * words; i += kThreads) {
      const int p = quot(i, inv_words), wd = i - p * words;
      const long long dst = pix_dst[p];
      if (dst < 0) continue;
      const unsigned char* src = box + pix_src[p];
      uint32_t half[2] = {0, 0};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int off = col_src[wd * 8 + j];
        const uint32_t v = off < 0 ? 0u : src[off];
        half[j >> 2] |= v << (8 * (j & 3));
      }
      *reinterpret_cast<uint2*>(out + dst + wd * 8) =
          make_uint2(half[0], half[1]);
    }
  }
}

template <typename T, bool kRun, int kLoad>
int launch(const T* x, const float* scale, int8_t* out, const Geometry& g,
           dim3 grid, int smem, cudaStream_t st) {
  auto kern = quant_patches_kernel<T, kRun, kLoad>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<grid, kThreads, smem, st>>>(x, scale, out, g);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* scale, void* out, Geometry g,
             bool run, dim3 grid, int smem, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const float* s = static_cast<const float*>(scale);
  int8_t* o = static_cast<int8_t*>(out);
  constexpr int VL = 16 / sizeof(T);
  const bool vec_c = g.sc == 1 && g.c_in % VL == 0 && g.sn % VL == 0 &&
                     g.sy % VL == 0 && g.sx % VL == 0 &&
                     reinterpret_cast<uintptr_t>(x) % 16 == 0;
  g.c_major = g.sc == 1;
  if (run) {
    if (vec_c) return launch<T, true, kVecC>(xt, s, o, g, grid, smem, st);
    return launch<T, true, kScalar>(xt, s, o, g, grid, smem, st);
  }
  if (vec_c) return launch<T, false, kVecC>(xt, s, o, g, grid, smem, st);
  return launch<T, false, kScalar>(xt, s, o, g, grid, smem, st);
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// The tile's sides, at most side_h x side_w and `pixels`, each split
// evenly over the image; its source box; and the shared memory it needs.
long long plan_tile(Geometry* g, int side_h, int side_w, int pixels,
                    bool run) {
  g->tiles_w = ceil_div(g->wo, side_w < g->wo ? side_w : g->wo);
  g->tw = ceil_div(g->wo, g->tiles_w);
  const int most_h = pixels / g->tw < side_h ? pixels / g->tw : side_h;
  g->tiles_h = ceil_div(g->ho, most_h < g->ho ? most_h : g->ho);
  g->th = ceil_div(g->ho, g->tiles_h);
  g->bh = (g->th - 1) * g->sh + g->kh;
  g->bw = (g->tw - 1) * g->sw + g->kw;
  const int tile_px = g->th * g->tw;
  return ((g->kh * g->kw * 4 + 15) & ~15) + ((tile_px * 4 + 15) & ~15) +
         ((tile_px * 8 + 15) & ~15) + (run ? 0 : ((g->kp * 4 + 15) & ~15)) +
         (long long)g->bh * g->bw * g->box_stride;
}

}  // namespace stf

// dtype: 0 float32, 1 bfloat16 (ops/kernels/build.DTYPE_CODES). Strides in
// elements; the stride of a size-1 dimension may be anything.
extern "C" int stf_quant_patches(const void* x, const void* scale, void* out,
                                 int dtype, int n, int c_in, int h, int w,
                                 long long sn, long long sc, long long sy,
                                 long long sx, int kh, int kw, int sh, int sw,
                                 int ph, int pw, int ho, int wo, int k_total,
                                 int kp, void* stream) {
  if (n < 1 || ho < 1 || wo < 1 || kp % 8 != 0 || kp < k_total ||
      k_total != c_in * kh * kw || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  stf::Geometry g;
  g.c_in = c_in; g.h = h; g.w = w;
  g.sn = n > 1 ? sn : 0; g.sc = c_in > 1 ? sc : 0;
  g.sy = h > 1 ? sy : 0; g.sx = w > 1 ? sx : 0;
  g.kh = kh; g.kw = kw; g.sh = sh; g.sw = sw; g.ph = ph; g.pw = pw;
  g.ho = ho; g.wo = wo; g.k_total = k_total; g.kp = kp;
  g.c_major = 0;

  const bool run = c_in % 16 == 0 && kp == k_total;
  g.chunk = c_in;
  if (run) {
    const int most = (long long)n * ho * wo >= stf::kWideRows ? 128 : 64;
    g.chunk = 16;
    while (g.chunk * 2 <= most && c_in % (g.chunk * 2) == 0) g.chunk *= 2;
  }
  g.box_stride = run ? g.chunk + 16 : g.chunk;
  int side_h = run ? 16 : 32, side_w = side_h, pixels = run ? 128 : 512;
  long long smem;
  for (;;) {  // halve the tile's longer side until the box fits
    smem = stf::plan_tile(&g, side_h, side_w, pixels, run);
    if ((long long)g.bh * g.bw * g.box_stride <= stf::kBoxBudget ||
        g.th * g.tw == 1)
      break;
    if (g.th >= g.tw) side_h = (g.th + 1) / 2;
    else side_w = (g.tw + 1) / 2;
    pixels = side_h * side_w;
  }
  if (smem > stf::kMaxSmem) return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)n * g.tiles_h * g.tiles_w;
  const int chunks = (c_in + g.chunk - 1) / g.chunk;
  if (blocks > 0x7fffffffLL || chunks > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, (unsigned)chunks);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return stf::dispatch<float>(x, scale, out, g, run, grid, (int)smem, st);
  return stf::dispatch<__nv_bfloat16>(x, scale, out, g, run, grid,
                                      (int)smem, st);
}
