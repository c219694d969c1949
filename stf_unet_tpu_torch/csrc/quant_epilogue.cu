// K6: the int8 convolution's dequant epilogue in one pass.
//
// No TPU kernel is replaced: the JAX package leaves the whole int8
// convolution to XLA (stf_unet_tpu/ops/quant.py:_int8_conv), and this
// kernel stands for the f32 epilogue of that op (:97-102), which XLA fuses
// behind the integer product. The port's convolution is K5's patch matrix
// times the packed weights in torch._int_mm; this kernel reads the GEMM's
// int32 accumulators acc [rows, np] (row stride np, only the first m rows
// and o columns read) and writes y [m, o], contiguous, in f32 or bf16:
//   f[j] = sw[j] * scale                       (f32, rounded once)
//   y[r, j] = out(float(acc[r, j]) * f[j] (+ bias[j]))
// in the JAX package's order with no contraction: __fmul_rn, __fadd_rn
// (nvcc would otherwise fuse the multiply and the add into one FMA, which
// rounds once where XLA rounds twice), __int2float_rn (the accumulators
// pass 2^24 at K = 4,608, so the conversion rounds and its mode matters)
// and __float2bfloat16_rn for bf16. Bit-equal to dequant_epilogue_plain.
//
// Bound on this card: bytes. Each accumulator is read once (4 bytes) and
// each output written once (2 bytes in bf16): 6 bytes an element, where the
// eager chain it replaces (int32 -> f32, the scale, the bias, the cast)
// moved about 30; the STF-LSTM-UNet's 48 convs at B = 8, 224^2 read 1,020
// MB and write 509 MB, 0.456 ms at 3.35 TB/s.
//
// Design: a grid of a few blocks per SM strides over the output. Each
// block first puts f and the bias of all o columns in shared memory; each
// thread then turns 4 accumulators (one 16-byte load) into 4 outputs (an
// 8-byte bf16 or 16-byte f32 store), consecutive threads on consecutive
// columns of a row. Where o is not a multiple of 4 (a head of 1 or 2
// classes) or a pointer is not aligned for that, one element a thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace stf {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr int kMaxCols = 6144;  // f and bias in 48 KB of shared memory

__device__ __forceinline__ void put(float* y, float v) { *y = v; }
__device__ __forceinline__ void put(__nv_bfloat16* y, float v) {
  *y = __float2bfloat16_rn(v);
}

__device__ __forceinline__ void put4(float* y, float a, float b, float c,
                                     float d) {
  *reinterpret_cast<float4*>(y) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void put4(__nv_bfloat16* y, float a, float b,
                                     float c, float d) {
  union { uint2 word; __nv_bfloat16_raw h[4]; } packed;
  packed.h[0] = __nv_bfloat16_raw(__float2bfloat16_rn(a));
  packed.h[1] = __nv_bfloat16_raw(__float2bfloat16_rn(b));
  packed.h[2] = __nv_bfloat16_raw(__float2bfloat16_rn(c));
  packed.h[3] = __nv_bfloat16_raw(__float2bfloat16_rn(d));
  *reinterpret_cast<uint2*>(y) = packed.word;
}

__device__ __forceinline__ float dequant(int a, float f, float b,
                                         bool has_bias) {
  const float y = __fmul_rn(__int2float_rn(a), f);
  return has_bias ? __fadd_rn(y, b) : y;
}

template <typename TO, bool kVec>
__global__ void __launch_bounds__(kThreads)
    quant_epilogue_kernel(const int32_t* __restrict__ acc,
                          const float* __restrict__ sw,
                          const float* __restrict__ scale,
                          const float* __restrict__ bias,
                          TO* __restrict__ y, int m, int o, int np) {
  extern __shared__ float cols[];  // f[o], then bias[o]
  const bool has_bias = bias != nullptr;
  const float s = *scale;
  for (int j = threadIdx.x; j < o; j += kThreads) {
    cols[j] = __fmul_rn(sw[j], s);
    cols[o + j] = has_bias ? bias[j] : 0.0f;
  }
  __syncthreads();
  const unsigned stride = gridDim.x * kThreads;
  if constexpr (kVec) {
    const unsigned q = o / 4;
    const unsigned total = (unsigned)m * q;
    for (unsigned v = blockIdx.x * kThreads + threadIdx.x; v < total;
         v += stride) {
      const unsigned r = v / q;
      const int j = (int)(v - r * q) * 4;
      const int4 a =
          *reinterpret_cast<const int4*>(acc + (long long)r * np + j);
      put4(y + (long long)r * o + j,
           dequant(a.x, cols[j], cols[o + j], has_bias),
           dequant(a.y, cols[j + 1], cols[o + j + 1], has_bias),
           dequant(a.z, cols[j + 2], cols[o + j + 2], has_bias),
           dequant(a.w, cols[j + 3], cols[o + j + 3], has_bias));
    }
  } else {
    const unsigned total = (unsigned)m * o;
    for (unsigned e = blockIdx.x * kThreads + threadIdx.x; e < total;
         e += stride) {
      const unsigned r = e / o;
      const int j = (int)(e - r * o);
      put(y + e, dequant(acc[(long long)r * np + j], cols[j], cols[o + j],
                         has_bias));
    }
  }
}

template <typename TO>
int launch(const void* acc, const void* sw, const void* scale,
           const void* bias, void* y, int m, int o, int np,
           cudaStream_t st) {
  const bool vec = o % 4 == 0 && np % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(acc) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % (4 * sizeof(TO)) == 0;
  const long long work = vec ? (long long)m * (o / 4) : (long long)m * o;
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  long long blocks = (work + kThreads - 1) / kThreads;
  const long long most = (long long)(sms > 0 ? sms : 1) * kBlocksPerSm;
  if (blocks > most) blocks = most;
  const int smem = 2 * o * (int)sizeof(float);
  const int32_t* a = static_cast<const int32_t*>(acc);
  const float* f = static_cast<const float*>(sw);
  const float* s = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  TO* out = static_cast<TO*>(y);
  if (vec)
    quant_epilogue_kernel<TO, true><<<(unsigned)blocks, kThreads, smem, st>>>(
        a, f, s, b, out, m, o, np);
  else
    quant_epilogue_kernel<TO, false>
        <<<(unsigned)blocks, kThreads, smem, st>>>(a, f, s, b, out, m, o, np);
  return (int)cudaGetLastError();
}

}  // namespace stf

// out_dtype: 0 float32, 1 bfloat16 (ops/kernels/build.DTYPE_CODES). bias
// may be null.
extern "C" int stf_quant_epilogue(const void* acc, const void* sw,
                                  const void* scale, const void* bias,
                                  void* y, int out_dtype, int m, int o,
                                  int np, void* stream) {
  if (m < 1 || o < 1 || o > stf::kMaxCols || np < o ||
      (long long)m * o > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_dtype == 0)
    return stf::launch<float>(acc, sw, scale, bias, y, m, o, np, st);
  if (out_dtype == 1)
    return stf::launch<__nv_bfloat16>(acc, sw, scale, bias, y, m, o, np, st);
  return (int)cudaErrorInvalidValue;
}
