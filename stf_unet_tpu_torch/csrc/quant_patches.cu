// K5: quantize an activation to int8 and gather its convolution patches.
//
// No TPU kernel is replaced: the JAX package's int8 convolution
// (stf_unet_tpu/ops/quant.py:_int8_conv) quantizes x with jnp ops and hands
// the int8 tensor to lax.conv_general_dilated, which XLA lowers. The port
// builds that convolution as a GEMM, torch._int_mm (cuBLASLt's int8
// tensor-core product) of this kernel's patch matrix with the packed int8
// weights, and this kernel is its operand pass. For an NCHW activation x
// (f32 or bf16) and the per-tensor scale s = max(sx, 1e-8) / 127 (a device
// f32) it writes the int8 matrix P [rows, Kp]:
//   P[m, k] = clip(rint(float(x[n, c, oh*sh - ph + dy, ow*sw - pw + dx]) / s),
//                  -127, 127)
// with m = (n*Ho + oh)*Wo + ow and k = (c*KH + dy)*KW + dx, the torch
// weight order; a tap outside x, and every column k >= K = C*KH*KW (the pad
// to Kp, a multiple of 8), is 0. The rows past m_total are not written: the
// wrapper zeroes them where it pads the GEMM's M.
//
// Arithmetic in the JAX package's order: a true IEEE division by s
// (__fdiv_rn, not a multiply by 1/s, which differs in the last ulp and
// flips the rounding at a .5 boundary), then rintf (round half to even, as
// jnp.round), then the clip.
//
// Bound on this card: bytes. Each x element is read once and each P byte
// written once: at the UNet's 3x3 conv at B = 8, 224^2, 64 channels, 51 MB
// of bf16 read and 231 MB written, 84 us at 3.35 TB/s; there is one
// division per output byte, far below the card's rates.
//
// Design (right and simple first): a block of 256 threads takes a tile of
// 64 consecutive patch rows (output pixels) by 64 columns, and the grid is
// (row tiles, column tiles), so a deep layer's few rows and long K (1,568
// x 9,216 at the UNet's bottleneck, 25 row tiles) still fill the card.
// Gather: a warp reads one column k for 32 consecutive pixels,
// neighbouring addresses of x's W axis (coalesced at stride 1, every other
// element at stride 2); the (c, dy, dx) of the tile's columns are decoded
// once into shared memory, so the per-element work is two adds, a bounds
// check, the division and the rounding. The quantized bytes go to a
// shared-memory tile of 64 rows x 17 words (an odd word stride: the
// warp's 32 rows hit 32 banks). Store: each thread writes 4-byte words
// along K, a warp two 64-byte row segments. The tile is the transpose
// that turns x's pixel-major reads into P's K-major writes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace stf {

constexpr int kRows = 64;       // patch rows (output pixels) per block
constexpr int kCols = 64;       // patch columns per step
constexpr int kThreads = 256;
constexpr int kRowWords = kCols / 4 + 1;  // odd: no bank conflicts
constexpr int kOutside = -(1 << 20);      // a column past K: never in x

__device__ __forceinline__ float as_f32(float v) { return v; }
__device__ __forceinline__ float as_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    quant_patches_kernel(const T* __restrict__ x,
                         const float* __restrict__ scale,
                         int8_t* __restrict__ out, int c_in, int h, int w,
                         int kh, int kw, int sh, int sw, int ph, int pw,
                         int ho, int wo, long long m_total, int k_total,
                         int kp) {
  __shared__ uint32_t tile[kRows * kRowWords];
  __shared__ long long col_off[kCols];  // c*H*W + dy*W + dx
  __shared__ int col_dy[kCols];
  __shared__ int col_dx[kCols];
  int8_t* tile8 = reinterpret_cast<int8_t*>(tile);

  const float s = *scale;
  const int t = threadIdx.x;
  const int row = t % kRows;
  const long long m = (long long)blockIdx.x * kRows + row;
  const bool valid_row = m < m_total;
  int ih0 = kOutside, iw0 = kOutside;
  long long base = 0;
  if (valid_row) {
    const long long hw_out = (long long)ho * wo;
    const long long n = m / hw_out;
    const int r = (int)(m - n * hw_out);
    const int oh = r / wo;
    ih0 = oh * sh - ph;
    iw0 = (r - oh * wo) * sw - pw;
    base = n * c_in * (long long)h * w + (long long)ih0 * w + iw0;
  }
  const int khw = kh * kw;
  const int k0 = blockIdx.y * kCols;
  if (t < kCols) {
    const int k = k0 + t;
    if (k < k_total) {
      const int c = k / khw;
      const int r = k - c * khw;
      const int dy = r / kw;
      const int dx = r - dy * kw;
      col_off[t] = (long long)c * h * w + (long long)dy * w + dx;
      col_dy[t] = dy;
      col_dx[t] = dx;
    } else {
      col_off[t] = 0;
      col_dy[t] = kOutside;
      col_dx[t] = 0;
    }
  }
  __syncthreads();
  for (int col = t / kRows; col < kCols; col += kThreads / kRows) {
    int8_t q = 0;
    const int ih = ih0 + col_dy[col];
    const int iw = iw0 + col_dx[col];
    if (valid_row && ih >= 0 && ih < h && iw >= 0 && iw < w) {
      const float v = __fdiv_rn(as_f32(x[base + col_off[col]]), s);
      q = (int8_t)(int)fminf(fmaxf(rintf(v), -127.0f), 127.0f);
    }
    tile8[row * kRowWords * 4 + col] = q;
  }
  __syncthreads();
  const int words = min(kCols, kp - k0) / 4;
  for (int i = t; i < kRows * (kCols / 4); i += kThreads) {
    const int r = i / (kCols / 4);
    const int wd = i - r * (kCols / 4);
    const long long mr = (long long)blockIdx.x * kRows + r;
    if (mr < m_total && wd < words)
      reinterpret_cast<uint32_t*>(out + mr * kp + k0)[wd] =
          tile[r * kRowWords + wd];
  }
}

}  // namespace stf

// dtype: 0 float32, 1 bfloat16 (ops/kernels/build.DTYPE_CODES).
extern "C" int stf_quant_patches(const void* x, const void* scale, void* out,
                                 int dtype, int n, int c_in, int h, int w,
                                 int kh, int kw, int sh, int sw, int ph,
                                 int pw, int ho, int wo, int k_total, int kp,
                                 void* stream) {
  const long long m_total = (long long)n * ho * wo;
  if (m_total < 1 || kp % 8 != 0 || kp < k_total || k_total != c_in * kh * kw)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (m_total + stf::kRows - 1) / stf::kRows;
  const int col_tiles = (kp + stf::kCols - 1) / stf::kCols;
  if (blocks > 0x7fffffffLL || col_tiles > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, (unsigned)col_tiles);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* o = static_cast<int8_t*>(out);
  const float* s = static_cast<const float*>(scale);
  if (dtype == 0) {
    stf::quant_patches_kernel<float><<<grid, stf::kThreads, 0, st>>>(
        static_cast<const float*>(x), s, o, c_in, h, w, kh, kw, sh, sw, ph,
        pw, ho, wo, m_total, k_total, kp);
  } else if (dtype == 1) {
    stf::quant_patches_kernel<__nv_bfloat16>
        <<<grid, stf::kThreads, 0, st>>>(
            static_cast<const __nv_bfloat16*>(x), s, o, c_in, h, w, kh, kw,
            sh, sw, ph, pw, ho, wo, m_total, k_total, kp);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
