// K7: train-mode batch normalization over [N, C, H, W], forward and
// backward, in three launches each way.
//
// No TPU kernel is replaced: the JAX package leaves BatchNorm to XLA
// (flax nn.BatchNorm in stf_unet_tpu/models/blocks.py), which fuses it
// into its neighbours. The port's models call it 44 times a training step
// (STF-LSTM-UNet: ResNet-34 over B*T = 128 frames and the decoder) and 18
// times (UNet), and ATen's native kernels launch one block per channel for
// the statistics and the backward's sums: 64 blocks on 132 SMs at the
// stem, each walking 1.6 M rows alone. This file splits every channel's
// reduction over as many blocks as the card needs.
//
// Bound on this card: bytes. A train-mode BN must read x and write y
// forward, read x and dy and write dx backward: 10 bytes an element in
// bf16, 1.50 ms a step for the STF model's 502.6 M BN elements at
// 3.35 TB/s. This design moves 16: the statistics read x (2), the
// normalize reads x and writes y (4), the backward's sums read x and dy
// (4), its elementwise pass reads x and dy and writes dx (6).
//
// Design. Both layouts are read as runs of contiguous elements: NCHW as N
// runs of C*HW (a channel's plane is HW contiguous elements), channels-
// last as N*HW runs of C. A block covers `group` consecutive channels of
// a range of runs (and, for a wide plane, a range of its vectors): grid
// (splits, C / group). Each thread reads `vec` elements at a time (16
// bytes where the plane's length and the pointer allow, a scalar tail
// otherwise) and keeps to the same channel(s) throughout, so its
// per-channel constants sit in registers and its sums need no atomics:
//   - wide planes (HW / vec >= 256): group 1, the block's threads walk the
//     flattened (run, vector) range 256 vectors a step, balanced to one;
//   - small planes (HW = 49, 196, 784): `group` consecutive channels'
//     planes are one contiguous run of group*HW, and each of the block's
//     threads takes one vector of it in every run it visits (P runs at
//     once), so reads stay contiguous and the thread's channel is fixed;
//   - channels-last: each thread holds `vec` consecutive channels of a
//     row, P rows at once.
// Each thread keeps kUnroll loads in flight. The splits are picked by the
// wrapper (ops/kernels/batch_norm.tiling) from C, the rows, HW's alignment
// and the layout: a target of one block per 16 KB of x, between 2 and 16
// blocks an SM, rounded to whole splits (at least two blocks on each SM at
// every BN shape of both models).
//
// Statistics: each thread sums d = x - K and d*d in float32, K the
// channel's first element (a shift that keeps the variance's sums off
// cancellation); the block reduces them per channel in a fixed order and
// writes a partial (count, mean, M2) a channel and split. The finish
// merges a channel's partials by Chan's rule, in a fixed order (one warp a
// channel, then a fixed butterfly), so every run is bit-identical; it
// writes mean and invstd in float32 and moves the running statistics
// toward the batch's mean and biased variance, flax's BatchNorm rule (the
// JAX package's): new = (1 - momentum) * old + momentum * batch.
// Normalize: y = (x - mean) * (w * invstd) + b in x's dtype. Backward:
// the same tiling sums dy and dy * (x - mean) a channel and split; the
// finish gives grad_b = sum dy and grad_w = invstd * sum dy * (x - mean)
// in float32; the elementwise pass writes
// dx = w * invstd * (dy - sum(dy) / n - xhat * sum(dy * xhat) / n).
// No launch synchronizes or allocates: the wrapper hands in the partials'
// scratch, so a CUDA graph captures the passes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace stf {

constexpr int kMaxThreads = 256;
constexpr int kUnroll = 4;
constexpr int kFinishWarps = 8;

// The tiling (ops/kernels/batch_norm.tiling computes the same numbers).
struct Tile {
  long long runs;        // N (NCHW) or N*HW (channels-last)
  long long run_stride;  // elements from a run to the next: C*HW or C
  int c;                 // channels
  int inner;             // a channel's elements in a run: HW or 1
  int group;             // channels a block covers
  int rv;                // vectors of the group in a run: group*inner/vec
  int per_run;           // threads on one run: min(rv, kMaxThreads)
  int lanes;             // runs a block reads at once: kMaxThreads/per_run
  int splits_n, splits_j;
};

template <int Bytes> struct Word;
template <> struct Word<2> { using type = unsigned short; };
template <> struct Word<4> { using type = unsigned int; };
template <> struct Word<8> { using type = uint2; };
template <> struct Word<16> { using type = uint4; };

// E: float, or uint16_t holding bfloat16's bits
template <typename E, int V>
using WordOf = typename Word<static_cast<int>(V * sizeof(E))>::type;

template <typename E, int V> union Pack {
  WordOf<E, V> w;
  E e[V];
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(uint16_t v) {
  return __uint_as_float(static_cast<unsigned>(v) << 16);
}
__device__ __forceinline__ void put(float& o, float v) { o = v; }
__device__ __forceinline__ void put(uint16_t& o, float v) {
  o = __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

template <typename E, int V>
__device__ __forceinline__ Pack<E, V> load(const E* p) {
  Pack<E, V> pk;
  pk.w = *reinterpret_cast<const WordOf<E, V>*>(p);
  return pk;
}

template <typename E, int V>
__device__ __forceinline__ void store(E* p, const float (&f)[V]) {
  Pack<E, V> pk;
#pragma unroll
  for (int k = 0; k < V; ++k) put(pk.e[k], f[k]);
  *reinterpret_cast<WordOf<E, V>*>(p) = pk.w;
}

// A block's share: runs [n0, n1), vectors [j0, j1) of each, channels from
// c0; its partials go to column blockIdx.x of [C, splits].
struct Share {
  long long n0, n1, base;
  int j0, j1, c0;
};

__device__ __forceinline__ Share share_of(const Tile& t) {
  const int s = blockIdx.x;
  const int sn = s / t.splits_j, sj = s - sn * t.splits_j;
  Share b;
  b.n0 = t.runs * sn / t.splits_n;
  b.n1 = t.runs * (sn + 1) / t.splits_n;
  b.j0 = static_cast<int>(static_cast<long long>(t.rv) * sj / t.splits_j);
  b.j1 = static_cast<int>(static_cast<long long>(t.rv) * (sj + 1) /
                          t.splits_j);
  b.c0 = blockIdx.y * t.group;
  b.base = static_cast<long long>(b.c0) * t.inner;
  return b;
}

// A thread's walk over its share: (run n, vector j), the next j per_run
// further on, wrapping to the thread's next run (the share's width is at
// least per_run, so one wrap a step).
struct Walk {
  long long n, n1;
  int j, j1, width, step, lanes;
  __device__ __forceinline__ bool ok() const { return n < n1; }
  __device__ __forceinline__ void next() {
    j += step;
    if (j >= j1) {
      j -= width;
      n += lanes;
    }
  }
};

struct Thread {
  Walk walk;
  bool active;  // has a place in the block's lanes and something to read
  int jfirst;   // its vector in the run (its channel(s) follow from it)
};

__device__ __forceinline__ Thread thread_of(const Tile& t, const Share& b) {
  const int tid = threadIdx.x;
  const int p = tid / t.per_run, jj = tid - p * t.per_run;
  Thread th;
  th.jfirst = b.j0 + jj;
  th.walk = Walk{b.n0 + p, b.n1, th.jfirst, b.j1, b.j1 - b.j0, t.per_run,
                 t.lanes};
  th.active = p < t.lanes && th.jfirst < b.j1 && th.walk.ok();
  return th;
}

// Channel of lane k of a thread whose vector is jfirst: every lane of an
// NCHW vector lies in one plane; a channels-last vector holds vec channels.
template <int V>
__device__ __forceinline__ int lane_channel(const Tile& t, const Share& b,
                                            int jfirst, int k) {
  return b.c0 + (jfirst * V + k) / t.inner;
}

template <int V>
__device__ __forceinline__ long long offset(const Tile& t, const Share& b,
                                            const Walk& w) {
  return w.n * t.run_stride + b.base + static_cast<long long>(w.j) * V;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The block's two per-thread sums a1, a2 reduced per channel of its
// group in a fixed order; emit(g, s1, s2) once for channel c0 + g, by one
// thread. Every thread of the block calls it.
template <int V, typename Emit>
__device__ __forceinline__ void reduce_channels(const Tile& t, const Share& b,
                                                const float (&a1)[V],
                                                const float (&a2)[V],
                                                float* sm1, float* sm2,
                                                Emit emit) {
  const int tid = threadIdx.x;
  const bool cl = t.inner == 1;
  if (cl) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      sm1[tid * V + k] = a1[k];
      sm2[tid * V + k] = a2[k];
    }
  } else {
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      s1 += a1[k];
      s2 += a2[k];
    }
    sm1[tid] = s1;
    sm2[tid] = s2;
  }
  __syncthreads();
  if (cl) {
    // a thread a channel: channel g is lane g % V of the vector g / V of
    // each of the block's rows at once, `lanes` terms
    for (int g = tid; g < t.group; g += blockDim.x) {
      const int jj = g / V, k = g - jj * V;
      float s1 = 0.0f, s2 = 0.0f;
      for (int q = 0; q < t.lanes; ++q) {
        const int i = (q * t.per_run + jj) * V + k;
        s1 += sm1[i];
        s2 += sm2[i];
      }
      emit(g, s1, s2);
    }
    return;
  }
  // a warp a channel: the threads whose vector lies in channel g's plane,
  // in each run
  const int warp = tid >> 5, lane = tid & 31;
  const int warps = blockDim.x >> 5;
  const int per = t.inner / V;
  for (int g = warp; g < t.group; g += warps) {
    const int lo = max(g * per - b.j0, 0);
    const int hi = min((g + 1) * per - b.j0, t.per_run);
    const int w = hi - lo;
    float s1 = 0.0f, s2 = 0.0f;
    for (int q = lane; w > 0 && q < t.lanes * w; q += 32) {
      const int p = q / w;
      const int i = p * t.per_run + lo + (q - p * w);
      s1 += sm1[i];
      s2 += sm2[i];
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane == 0) emit(g, s1, s2);
  }
}

// Elements of channel c0 + g that one run of the share holds.
template <int V>
__device__ __forceinline__ long long elems(const Tile& t, const Share& b,
                                           int g) {
  const long long lo = max(static_cast<long long>(b.j0) * V,
                           static_cast<long long>(g) * t.inner);
  const long long hi = min(static_cast<long long>(b.j1) * V,
                           static_cast<long long>(g + 1) * t.inner);
  return hi > lo ? hi - lo : 0;
}

template <typename E, int V>
__global__ void __launch_bounds__(kMaxThreads)
    bn_stats_kernel(const E* __restrict__ x, Tile t,
                    float* __restrict__ part) {
  __shared__ float sm[2][kMaxThreads * V];
  const Share b = share_of(t);
  Thread th = thread_of(t, b);
  float shift[V], a1[V], a2[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    a1[k] = a2[k] = shift[k] = 0.0f;
    if (th.active)
      shift[k] = to_f(x[static_cast<long long>(
                            lane_channel<V>(t, b, th.jfirst, k)) *
                        t.inner]);
  }
  while (th.active && th.walk.ok()) {
    Pack<E, V> v[kUnroll];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      ok[u] = th.walk.ok();
      if (ok[u]) v[u] = load<E, V>(x + offset<V>(t, b, th.walk));
      th.walk.next();
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!ok[u]) continue;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float d = to_f(v[u].e[k]) - shift[k];
        a1[k] += d;
        a2[k] = fmaf(d, d, a2[k]);
      }
    }
  }
  const int splits = gridDim.x;
  reduce_channels<V>(t, b, a1, a2, sm[0], sm[1],
                     [&](int g, float s1, float s2) {
    const int c = b.c0 + g;
    float* o = part + (static_cast<long long>(c) * splits + blockIdx.x) * 3;
    const float n = static_cast<float>((b.n1 - b.n0) * elems<V>(t, b, g));
    if (n > 0.0f) {
      const float k0 = to_f(x[static_cast<long long>(c) * t.inner]);
      o[0] = n;
      o[1] = k0 + s1 / n;
      o[2] = fmaxf(s2 - s1 * (s1 / n), 0.0f);
    } else {
      o[0] = o[1] = o[2] = 0.0f;
    }
  });
}

// (na, ma, m2a) += (nb, mb, m2b), Chan et al.'s pairwise update.
__device__ __forceinline__ void chan_merge(float& na, float& ma, float& m2a,
                                           float nb, float mb, float m2b) {
  if (nb == 0.0f) return;
  const float n = na + nb;
  const float d = mb - ma;
  const float f = nb / n;
  ma = fmaf(d, f, ma);
  m2a = m2a + m2b + d * d * na * f;
  na = n;
}

__global__ void __launch_bounds__(kFinishWarps * 32)
    bn_finish_kernel(const float* __restrict__ part, int splits, int c,
                     float* __restrict__ mean, float* __restrict__ invstd,
                     float* __restrict__ running_mean,
                     float* __restrict__ running_var, float momentum,
                     float eps) {
  const int ch = blockIdx.x * kFinishWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (ch >= c) return;  // a whole warp
  const float* p = part + static_cast<long long>(ch) * splits * 3;
  float n = 0.0f, m = 0.0f, m2 = 0.0f;
  for (int s = lane; s < splits; s += 32)
    chan_merge(n, m, m2, p[3 * s], p[3 * s + 1], p[3 * s + 2]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float nb = __shfl_xor_sync(0xffffffffu, n, o);
    const float mb = __shfl_xor_sync(0xffffffffu, m, o);
    const float m2b = __shfl_xor_sync(0xffffffffu, m2, o);
    chan_merge(n, m, m2, nb, mb, m2b);
  }
  if (lane != 0) return;
  const float var = m2 / n;
  mean[ch] = m;
  invstd[ch] = 1.0f / sqrtf(var + eps);
  if (running_mean != nullptr) {
    running_mean[ch] = momentum * m + (1.0f - momentum) * running_mean[ch];
    running_var[ch] = momentum * var + (1.0f - momentum) * running_var[ch];
  }
}

template <typename E, int V>
__global__ void __launch_bounds__(kMaxThreads)
    bn_apply_kernel(const E* __restrict__ x, E* __restrict__ y, Tile t,
                    const float* __restrict__ mean,
                    const float* __restrict__ invstd,
                    const float* __restrict__ weight,
                    const float* __restrict__ bias) {
  const Share b = share_of(t);
  Thread th = thread_of(t, b);
  if (!th.active) return;
  float mu[V], sc[V], sh[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int c = lane_channel<V>(t, b, th.jfirst, k);
    mu[k] = mean[c];
    sc[k] = weight[c] * invstd[c];
    sh[k] = bias[c];
  }
  while (th.walk.ok()) {
    Pack<E, V> v[kUnroll];
    long long off[kUnroll];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      ok[u] = th.walk.ok();
      off[u] = offset<V>(t, b, th.walk);
      if (ok[u]) v[u] = load<E, V>(x + off[u]);
      th.walk.next();
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!ok[u]) continue;
      float o[V];
#pragma unroll
      for (int k = 0; k < V; ++k)
        o[k] = fmaf(to_f(v[u].e[k]) - mu[k], sc[k], sh[k]);
      store<E, V>(y + off[u], o);
    }
  }
}

template <typename E, int V>
__global__ void __launch_bounds__(kMaxThreads)
    bn_bwd_reduce_kernel(const E* __restrict__ x, const E* __restrict__ dy,
                         Tile t, const float* __restrict__ mean,
                         float* __restrict__ part) {
  __shared__ float sm[2][kMaxThreads * V];
  const Share b = share_of(t);
  Thread th = thread_of(t, b);
  float mu[V], a1[V], a2[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    a1[k] = a2[k] = mu[k] = 0.0f;
    if (th.active) mu[k] = mean[lane_channel<V>(t, b, th.jfirst, k)];
  }
  while (th.active && th.walk.ok()) {
    Pack<E, V> v[kUnroll], g[kUnroll];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      ok[u] = th.walk.ok();
      if (ok[u]) {
        const long long off = offset<V>(t, b, th.walk);
        v[u] = load<E, V>(x + off);
        g[u] = load<E, V>(dy + off);
      }
      th.walk.next();
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!ok[u]) continue;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float d = to_f(g[u].e[k]);
        a1[k] += d;
        a2[k] = fmaf(d, to_f(v[u].e[k]) - mu[k], a2[k]);
      }
    }
  }
  const int splits = gridDim.x;
  reduce_channels<V>(t, b, a1, a2, sm[0], sm[1],
                     [&](int g, float s1, float s2) {
    float* o = part +
               (static_cast<long long>(b.c0 + g) * splits + blockIdx.x) * 2;
    o[0] = s1;
    o[1] = s2;
  });
}

__global__ void __launch_bounds__(kFinishWarps * 32)
    bn_bwd_finish_kernel(const float* __restrict__ part, int splits, int c,
                         const float* __restrict__ invstd,
                         float* __restrict__ grad_w,
                         float* __restrict__ grad_b) {
  const int ch = blockIdx.x * kFinishWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (ch >= c) return;
  const float* p = part + static_cast<long long>(ch) * splits * 2;
  float s1 = 0.0f, s2 = 0.0f;
  for (int s = lane; s < splits; s += 32) {
    s1 += p[2 * s];
    s2 += p[2 * s + 1];
  }
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  if (lane != 0) return;
  grad_b[ch] = s1;
  grad_w[ch] = s2 * invstd[ch];
}

template <typename E, int V>
__global__ void __launch_bounds__(kMaxThreads)
    bn_bwd_dx_kernel(const E* __restrict__ x, const E* __restrict__ dy,
                     E* __restrict__ dx, Tile t,
                     const float* __restrict__ mean,
                     const float* __restrict__ invstd,
                     const float* __restrict__ weight,
                     const float* __restrict__ grad_w,
                     const float* __restrict__ grad_b, float inv_n) {
  const Share b = share_of(t);
  Thread th = thread_of(t, b);
  if (!th.active) return;
  // dx = A*dy + kx*(x - mean) + k0: A = w*invstd,
  // kx = -A*invstd*grad_w/n, k0 = -A*grad_b/n
  float mu[V], ka[V], kx[V], k0[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int c = lane_channel<V>(t, b, th.jfirst, k);
    const float is = invstd[c];
    mu[k] = mean[c];
    ka[k] = weight[c] * is;
    kx[k] = -ka[k] * is * (grad_w[c] * inv_n);
    k0[k] = -ka[k] * (grad_b[c] * inv_n);
  }
  while (th.walk.ok()) {
    Pack<E, V> v[kUnroll], g[kUnroll];
    long long off[kUnroll];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      ok[u] = th.walk.ok();
      off[u] = offset<V>(t, b, th.walk);
      if (ok[u]) {
        v[u] = load<E, V>(x + off[u]);
        g[u] = load<E, V>(dy + off[u]);
      }
      th.walk.next();
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!ok[u]) continue;
      float o[V];
#pragma unroll
      for (int k = 0; k < V; ++k)
        o[k] = fmaf(ka[k], to_f(g[u].e[k]),
                    fmaf(kx[k], to_f(v[u].e[k]) - mu[k], k0[k]));
      store<E, V>(dx + off[u], o);
    }
  }
}

struct Args {
  int backward;
  const void *x, *dy;
  void* out;
  const float *weight, *bias;
  float *mean, *invstd, *grad_w, *grad_b, *part, *running_mean,
      *running_var;
  float momentum, eps, inv_n;
  int threads;
  Tile t;
  cudaStream_t stream;
};

template <typename E, int V>
int run(const Args& a) {
  const Tile& t = a.t;
  const int splits = t.splits_n * t.splits_j;
  const dim3 grid(splits, t.c / t.group);
  const int fin = (t.c + kFinishWarps - 1) / kFinishWarps;
  const E* x = static_cast<const E*>(a.x);
  cudaError_t err;
  if (!a.backward) {
    bn_stats_kernel<E, V><<<grid, a.threads, 0, a.stream>>>(x, t, a.part);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    bn_finish_kernel<<<fin, kFinishWarps * 32, 0, a.stream>>>(
        a.part, splits, t.c, a.mean, a.invstd, a.running_mean,
        a.running_var, a.momentum, a.eps);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    bn_apply_kernel<E, V><<<grid, a.threads, 0, a.stream>>>(
        x, static_cast<E*>(a.out), t, a.mean, a.invstd, a.weight, a.bias);
    return (int)cudaGetLastError();
  }
  const E* dy = static_cast<const E*>(a.dy);
  bn_bwd_reduce_kernel<E, V><<<grid, a.threads, 0, a.stream>>>(x, dy, t,
                                                                a.mean,
                                                                a.part);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  bn_bwd_finish_kernel<<<fin, kFinishWarps * 32, 0, a.stream>>>(
      a.part, splits, t.c, a.invstd, a.grad_w, a.grad_b);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (a.out == nullptr) return 0;
  bn_bwd_dx_kernel<E, V><<<grid, a.threads, 0, a.stream>>>(
      x, dy, static_cast<E*>(a.out), t, a.mean, a.invstd, a.weight,
      a.grad_w, a.grad_b, a.inv_n);
  return (int)cudaGetLastError();
}

}  // namespace stf

// One direction of K7 on x [n, c, hw] (NCHW-contiguous, or channels-last:
// [n*hw, c]), element type `dtype` (0 float32, 1 bfloat16), float32
// weight, bias, statistics and gradients, on the current device.
// Forward (backward = 0): out = y; writes mean, invstd and, when
// running_mean is not null, updates running_mean and running_var. Backward:
// reads dy (the layout of x), mean, invstd and weight; writes grad_w,
// grad_b and, when out is not null, out = dx. `part` is scratch of
// c * splits_n * splits_j * 3 floats. The tiling (vec, group, splits_n,
// splits_j) is ops/kernels/batch_norm.tiling's. Returns a cudaError_t
// (0 on success). Asynchronous on `stream`; allocates nothing.
extern "C" int stf_batch_norm(int backward, int dtype, const void* x,
                              const void* dy, void* out, const void* weight,
                              const void* bias, void* mean, void* invstd,
                              void* grad_w, void* grad_b, void* part,
                              void* running_mean, void* running_var, int n,
                              int c, int hw, int channels_last, int vec,
                              int group, int splits_n, int splits_j,
                              float momentum, float eps, void* stream) {
  using namespace stf;
  const int itemsize = dtype == 0 ? 4 : 2;
  if ((dtype != 0 && dtype != 1) || n < 1 || c < 1 || hw < 1 ||
      static_cast<long long>(n) * hw < 2 || vec < 1 || vec > 8 ||
      (vec & (vec - 1)) != 0 || vec * itemsize > 16 || group < 1 ||
      c % group != 0 || splits_n < 1 || splits_j < 1)
    return (int)cudaErrorInvalidValue;
  Tile t;
  t.c = c;
  t.group = group;
  t.inner = channels_last ? 1 : hw;
  t.runs = channels_last ? static_cast<long long>(n) * hw : n;
  t.run_stride = channels_last ? c : static_cast<long long>(c) * hw;
  if (channels_last ? (c % vec != 0 || group % vec != 0) : hw % vec != 0)
    return (int)cudaErrorInvalidValue;
  const long long rv = static_cast<long long>(group) * t.inner / vec;
  // a block's threads keep to fixed channels: a group of several
  // channels fits one pass of the block, a wide plane is a group of one
  if (rv > kMaxThreads && group != 1) return (int)cudaErrorInvalidValue;
  if (rv / splits_j < (rv < kMaxThreads ? rv : kMaxThreads) ||
      splits_n > t.runs || rv > (1LL << 30))
    return (int)cudaErrorInvalidValue;
  t.rv = static_cast<int>(rv);
  t.per_run = t.rv < kMaxThreads ? t.rv : kMaxThreads;
  t.lanes = kMaxThreads / t.per_run;
  t.splits_n = splits_n;
  t.splits_j = splits_j;
  if (static_cast<long long>(c / group) > 65535)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.backward = backward;
  a.x = x;
  a.dy = dy;
  a.out = out;
  a.weight = static_cast<const float*>(weight);
  a.bias = static_cast<const float*>(bias);
  a.mean = static_cast<float*>(mean);
  a.invstd = static_cast<float*>(invstd);
  a.grad_w = static_cast<float*>(grad_w);
  a.grad_b = static_cast<float*>(grad_b);
  a.part = static_cast<float*>(part);
  a.running_mean = static_cast<float*>(running_mean);
  a.running_var = static_cast<float*>(running_var);
  a.momentum = momentum;
  a.eps = eps;
  a.inv_n = static_cast<float>(1.0 / (static_cast<double>(n) * hw));
  a.threads = (t.per_run * t.lanes + 31) / 32 * 32;
  a.t = t;
  a.stream = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    switch (vec) {
      case 1: return run<float, 1>(a);
      case 2: return run<float, 2>(a);
      case 4: return run<float, 4>(a);
    }
  } else {
    switch (vec) {
      case 1: return run<uint16_t, 1>(a);
      case 2: return run<uint16_t, 2>(a);
      case 4: return run<uint16_t, 4>(a);
      case 8: return run<uint16_t, 8>(a);
    }
  }
  return (int)cudaErrorInvalidValue;
}
