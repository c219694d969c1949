// K3: last-step pixel LSTM from a precomputed input projection.
//
// Replaces the TPU kernel stf_unet_tpu/ops/pallas/lstm_kernel.py:
// fused_lstm_last / _lstm_last_kernel. Computes, for x_proj [T, N, 4C]
// (= x @ W_ih, already rounded to its dtype by the caller), W_hh [C, 4C]
// (gate order i, f, g, o) and b [4C]:
//   gates_t = (x_proj_t + h_{t-1} @ W_hh) + b     (f32; h stays f32 in the
//                                                  product, lstm_kernel.py:52)
//   c_t = f*c_{t-1} + i*g,  h_t = o*tanh(c_t)
// and writes only h_T [N, C] in x_proj's dtype.
//
// Bound on this card: 8*T*N*C^2 operations against T*N*4C input elements,
// about 1,000 operations per byte at C=512 in bf16: at the B=8 serving
// shape (T=8, C=512, N=392) 6.6 GFLOP, 6.7 us at the 989 TFLOP/s bf16
// peak, against 12.8 MB of x_proj (3.8 us at 3.35 TB/s); bound by
// operations.
//
// Two kernels, chosen by a rule on dtype and C (the wrapper's
// tensor_core_last, TC_LAST_C), never as a fallback:
//  * bf16 at C = 256 and 512 runs lstm_last_tc_kernel: tensor cores, the
//    units split over the blocks of a thread-block cluster.
//    - Products. W_hh is exactly bf16, h_{t-1} is f32: it is split as
//      h = hi + lo, both bf16 (mma_bf16.cuh split_bf16), and each step
//      takes two WMMA bf16 products, hi W and lo W, into f32 accumulators
//      (each exact in f32; hi + lo equals h to 2^-16 relative). That
//      doubles the products: 13.2 GFLOP at the B=8 shape. x_proj and the
//      bias are added in f32 afterwards, in the TPU kernel's order,
//      (x_proj + h W) + b. At t = 0, h = 0 and the products are skipped.
//    - Cluster layout. A cluster of K blocks owns a tile of 32 rows;
//      block r of the cluster owns units [r*C/K, (r+1)*C/K) with all four
//      gates of each, so its cell runs locally. A warp pair per (row
//      fragment, 16 units): one warp forms gates i and f, the other g and
//      o; both put their accumulators in the pair's shared scratch (WMMA's
//      layout is opaque, as in lstm_tc.cuh) and each runs the cell of
//      half the rows. The block keeps its slice of W_hh, the 4C/K gate
//      columns of its units, resident in shared memory for the whole call
//      (loaded by cp.async while step 0, which needs no products, runs):
//      W is read from L2 once per block per call, not at every step.
//    - Exchange. Every block keeps the whole h_{t-1} (hi and lo, [32, C])
//      for its products. After the cell it stages its own slice of h_t
//      (one buffer per step parity); after one cluster barrier every
//      block pulls all K slices through distributed shared memory in
//      16-byte runs into its own h tiles. One cluster barrier a step: a
//      slice buffer is written again only two steps on, after the next
//      barrier, which every block reaches only after its pulls.
//    - C = 512: clusters of 16 (a non-portable size), 8 warps, 225 KB of
//      shared memory (W slice 136 KB); at N = 392, 13 clusters, 208
//      blocks. C = 256: clusters of 8, 8 warps, 125 KB.
//    - What limits it (PERF.md): one block per SM and 16 SMs of one GPC
//      per cluster, so the card runs 7 of these clusters at once (the
//      occupancy query on an H100 80GB HBM3, PERF.md) and N = 392 takes
//      two waves, N = 784 four; and
//      per step the products, the exchange of h (R x C x 4 bytes into
//      every block) and the cluster barrier, all latency-bound at 8 warps
//      an SM. Chosen by device time on an H100 80GB HBM3 at 700 W over
//      clusters of 8 with W streamed from L2 (the slice does not fit) and
//      over copies pushed into every block with two barriers a step.
//  * f32, and bf16 at any other C, runs lstm_last_kernel on CUDA cores in
//    f32 FMA (at best ~1/15 of the bf16 bound): a block loops over T and
//    owns a tile of rows with all C units (lstm_cell.cuh); h f32 and
//    double-buffered in shared memory; W_hh repacked [C, C, 4] read
//    through L1/L2 as 4-gate vectors by every block at every step; each
//    thread reads its own x_proj gate columns, issued before the recurrent
//    product so the loads overlap it.
// A cluster launch the card refuses returns its error, which the wrapper
// raises.

#include <cooperative_groups.h>

#include "lstm_cell.cuh"
#include "lstm_tc.cuh"

namespace stf {

namespace cg = cooperative_groups;

template <typename T>
__global__ void __launch_bounds__(kMaxC)
lstm_last_kernel(const T* __restrict__ xp, const T* __restrict__ w_hh,
                 const T* __restrict__ b, T* __restrict__ out, int t_steps,
                 int n, int c) {
  extern __shared__ float smem[];
  const int rows = blockDim.y * kRowsPerThread;
  float* hbuf0 = smem;  // [rows][c] h, two buffers
  float* hbuf1 = hbuf0 + rows * c;
  const int j = threadIdx.x;
  const int r0 = threadIdx.y * kRowsPerThread;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  const int row_base = blockIdx.x * rows;

  for (int idx = tid; idx < rows * c; idx += nthreads) hbuf0[idx] = 0.0f;
  float bias[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) bias[g] = to_f32(b[g * c + j]);
  float cst[kRowsPerThread], hlast[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) cst[i] = hlast[i] = 0.0f;
  __syncthreads();

  float* hcur = hbuf0;
  float* hnext = hbuf1;
  for (int t = 0; t < t_steps; ++t) {
    float xg[kRowsPerThread][4];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int row = row_base + r0 + i;
      const T* xr = xp + ((size_t)t * n + row) * 4 * c + j;
#pragma unroll
      for (int g = 0; g < 4; ++g)
        xg[i][g] = row < n ? to_f32(xr[g * c]) : 0.0f;
    }

    float acc[kRowsPerThread][4];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int g = 0; g < 4; ++g) acc[i][g] = 0.0f;
    for (int k = 0; k < c; k += 4)
      accumulate4<T>(acc, hcur + r0 * c, c, w_hh, k, j);
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      float gates[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) gates[g] = (xg[i][g] + acc[i][g]) + bias[g];
      hlast[i] = cell(gates, cst[i]);
      hnext[(r0 + i) * c + j] = hlast[i];
    }
    __syncthreads();  // h_t complete, every read of h_{t-1} done
    float* tmp = hcur;
    hcur = hnext;
    hnext = tmp;
  }
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int row = row_base + r0 + i;
    if (row < n) out[(size_t)row * c + j] = from_f32<T>(hlast[i]);
  }
}

template <typename T>
static cudaError_t launch(const void* xp, const void* w_hh, const void* b,
                          void* out, int t_steps, int n, int c,
                          cudaStream_t stream) {
  const Geometry g = geometry(n, c);
  const size_t smem = 2 * (size_t)g.rows * c * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        lstm_last_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  lstm_last_kernel<T><<<g.grid, g.block, smem, stream>>>(
      static_cast<const T*>(xp), static_cast<const T*>(w_hh),
      static_cast<const T*>(b), static_cast<T*>(out), t_steps, n, c);
  return cudaGetLastError();
}

// The tensor-core kernel's layout per C (see the note above): blocks per
// cluster, fixed here; 32 rows per cluster.
template <int C>
__host__ __device__ constexpr int tc_last_cluster() { return C == 512 ? 16 : 8; }

template <int C>
struct TcLast {
  static constexpr int K = tc_last_cluster<C>();  // blocks per cluster
  static constexpr int RF = 2;                    // row fragments
  static constexpr int R = RF * kFrag;            // rows per cluster
  static constexpr int U = C / K;                 // units per block
  static constexpr int UG = U / kFrag;            // 16-unit groups
  // A warp pair per (row fragment, unit group); warp 0 of a pair forms
  // gates i, f, warp 1 gates g, o; each runs the cell of half the rows.
  static constexpr int WARPS = 2 * RF * UG;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int LDA = tc_lda<C>();         // h tiles [R][LDA]
  static constexpr int LDW = 4 * U + 8;           // W slice [C][LDW]
  // 16-byte runs a thread pulls from the cluster per step.
  static constexpr int PULLS = K * 2 * (R * U / 8) / THREADS;
  // Shared memory, every part a multiple of 32 bytes: the W slice, h_hi
  // and h_lo [R][LDA], the own slice of h_hi and h_lo [2][R][U] (one
  // buffer per step parity), one [4][16][16] f32 scratch per warp pair.
  static constexpr size_t W_BYTES = (size_t)C * LDW * sizeof(bf16);
  static constexpr size_t H_BYTES = (size_t)R * LDA * sizeof(bf16);
  static constexpr size_t S_BYTES = (size_t)R * U * sizeof(bf16);
  static constexpr size_t SMEM = W_BYTES + 2 * H_BYTES + 4 * S_BYTES +
                                 (size_t)(WARPS / 2) * kTcScratch *
                                     sizeof(float);
  static_assert(U % kFrag == 0 && C % K == 0, "units split into fragments");
  static_assert(K * 2 * (R * U / 8) % THREADS == 0, "whole pulls a thread");
  static_assert(SMEM <= 232448, "shared memory of one block");
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

// bf16, C in {256, 512}: the recurrence on tensor cores, units split over
// a cluster (see the note above).
template <int C>
__global__ void __launch_bounds__(TcLast<C>::THREADS, 1)
lstm_last_tc_kernel(const bf16* __restrict__ xp,
                    const bf16* __restrict__ w_hh,
                    const bf16* __restrict__ b, bf16* __restrict__ out,
                    int t_steps, int n) {
  using L = TcLast<C>;
  constexpr int U = L::U, R = L::R, LDA = L::LDA, LDW = L::LDW;
  constexpr int C4 = 4 * C;
  constexpr int RUNS = R * U / 8;  // 16-byte runs of one slice array
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ws = reinterpret_cast<bf16*>(smem_raw);  // [C][LDW]
  bf16* h_hi = ws + C * LDW;                     // [R][LDA] h_{t-1}
  bf16* h_lo = h_hi + R * LDA;
  bf16* slice = h_lo + R * LDA;  // [2 parities][hi, lo][R][U] own h_t
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int pair = warp / 2, half = warp % 2;
  float* scr = reinterpret_cast<float*>(slice + 4 * R * U) +
               pair * kTcScratch;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int row_base = (int)(blockIdx.x / L::K) * R;
  const int rf = pair / L::UG;
  const int u_blk = (pair % L::UG) * kFrag;  // the pair's units in the block
  const int j = rank * U + u_blk + lane % kFrag;  // the lane's unit

  // The block's W slice: column g*U + u holds W[:, g*C + rank*U + u].
  constexpr int runs_g = U / 8;  // 16-byte runs per gate and k
  for (int idx = tid; idx < C * 4 * runs_g; idx += L::THREADS) {
    const int k = idx / (4 * runs_g), g = idx / runs_g % 4,
              v = idx % runs_g * 8;
    cp_async16(ws + k * LDW + g * U + v,
               w_hh + (size_t)k * C4 + g * C + rank * U + v);
  }
  asm volatile("cp.async.commit_group;\n" ::);

  float bias[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) bias[g] = __bfloat162float(b[g * C + j]);
  float cst[4];  // the cell state of the lane's rows q = 4*half + 0..3
#pragma unroll
  for (int q = 0; q < 4; ++q) cst[q] = 0.0f;
  cluster.sync();  // every block of the cluster runs before any pull

  for (int t = 0; t < t_steps; ++t) {
    const bool last = t == t_steps - 1;
    float xg[4][4];  // x_proj_t at the lane's cell elements, loaded first
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int row = row_base + frag_row(rf, lane, 4 * half + q);
      const bf16* xr = xp + ((size_t)t * n + row) * C4 + j;
#pragma unroll
      for (int g = 0; g < 4; ++g)
        xg[g][q] = row < n ? __bfloat162float(xr[g * C]) : 0.0f;
    }
    FragC acc[2];  // gates 2*half and 2*half + 1
#pragma unroll
    for (int g = 0; g < 2; ++g) wmma::fill_fragment(acc[g], 0.0f);
    if (t > 0) {  // h_{-1} = 0: no products at t = 0
      if (t == 1) {
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
        __syncthreads();  // the W slice is in shared memory
      }
      const bf16* a_hi = h_hi + rf * kFrag * LDA;
      const bf16* a_lo = h_lo + rf * kFrag * LDA;
      const bf16* w = ws + 2 * half * U + u_blk;
#pragma unroll 4
      for (int kf = 0; kf < C / kFrag; ++kf) {
        FragA ahi, alo;
        wmma::load_matrix_sync(ahi, a_hi + kf * kFrag, LDA);
        wmma::load_matrix_sync(alo, a_lo + kf * kFrag, LDA);
#pragma unroll
        for (int g = 0; g < 2; ++g) {
          FragB bw;
          wmma::load_matrix_sync(bw, w + kf * kFrag * LDW + g * U, LDW);
          wmma::mma_sync(acc[g], ahi, bw, acc[g]);
          wmma::mma_sync(acc[g], alo, bw, acc[g]);
        }
      }
    }
    to_scratch<2>(scr + 2 * half * kFrag * kFrag, acc);
    __syncthreads();  // both warps of every pair stored their gates
    bf16* s_hi = slice + t % 2 * 2 * R * U;
    bf16* s_lo = s_hi + R * U;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int e = frag_elem(lane, 4 * half + q);
      const int r = frag_row(rf, lane, 4 * half + q);
      float gates[4];
#pragma unroll
      for (int g = 0; g < 4; ++g)
        gates[g] = (xg[g][q] + scr[g * kFrag * kFrag + e]) + bias[g];
      const float h = cell(gates, cst[q]);
      if (last) {
        if (row_base + r < n)
          out[(size_t)(row_base + r) * C + j] = __float2bfloat16_rn(h);
      } else {
        const int s = r * U + u_blk + lane % kFrag;
        split_bf16(h, s_hi[s], s_lo[s]);
      }
    }
    if (last) break;
    // Every block's slice of h_t is staged and its products of h_{t-1}
    // are done. A slice buffer is written again two steps on, after the
    // next barrier, which every block reaches only after these pulls.
    cluster.sync();
    // h_t from every block of the cluster into the local h tiles, in
    // 16-byte runs: all loads first, then all stores. Block r takes the
    // sources in the order r, r+1, ...: no block is read by all at once.
    uint4 v[L::PULLS];
#pragma unroll
    for (int i = 0; i < L::PULLS; ++i) {
      const int idx = tid + i * L::THREADS;
      const int src = (idx / (2 * RUNS) + rank) % L::K, a = idx / RUNS % 2;
      const int run = idx % RUNS * 8;
      v[i] = *reinterpret_cast<const uint4*>(cluster.map_shared_rank(
          (a ? s_lo : s_hi) + run, src));
    }
#pragma unroll
    for (int i = 0; i < L::PULLS; ++i) {
      const int idx = tid + i * L::THREADS;
      const int src = (idx / (2 * RUNS) + rank) % L::K, a = idx / RUNS % 2;
      const int run = idx % RUNS * 8;
      *reinterpret_cast<uint4*>((a ? h_lo : h_hi) + run / U * LDA +
                                src * U + run % U) = v[i];
    }
    __syncthreads();  // h_t complete in the local tiles
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");  // T = 1
  cluster.sync();  // no block leaves while another still pulls from it
}

// The kernel's attributes: its shared memory, and a cluster above the
// portable 8 blocks.
template <int C>
static cudaError_t set_attributes() {
  using L = TcLast<C>;
  cudaError_t e = cudaFuncSetAttribute(
      lstm_last_tc_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L::SMEM);
  if (e != cudaSuccess) return e;
  if (L::K > 8) {
    e = cudaFuncSetAttribute(lstm_last_tc_kernel<C>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

static cudaLaunchAttribute cluster_dim(int k) {
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = k;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  return cluster;
}

template <int C>
static cudaError_t launch_tc(const void* xp, const void* w_hh, const void* b,
                             void* out, int t_steps, int n,
                             cudaStream_t stream) {
  using L = TcLast<C>;
  cudaError_t e = set_attributes<C>();
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute cluster = cluster_dim(L::K);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((n + L::R - 1) / L::R * L::K));
  cfg.blockDim = dim3(L::THREADS);
  cfg.dynamicSmemBytes = L::SMEM;
  cfg.stream = stream;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, lstm_last_tc_kernel<C>,
                         static_cast<const bf16*>(xp),
                         static_cast<const bf16*>(w_hh),
                         static_cast<const bf16*>(b), static_cast<bf16*>(out),
                         t_steps, n);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

static cudaError_t launch_tc(const void* xp, const void* w_hh, const void* b,
                             void* out, int t_steps, int n, int c,
                             cudaStream_t stream) {
  switch (c) {
    case 256:
      return launch_tc<256>(xp, w_hh, b, out, t_steps, n, stream);
    case 512:
      return launch_tc<512>(xp, w_hh, b, out, t_steps, n, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace stf

// x_proj [T,N,4C], b [4C], out [N,C]; all of one dtype (0 = f32, 1 =
// bf16), contiguous, on the current device. tensor_cores = 0: the
// CUDA-core kernel, w_hh packed [C,C,4]. tensor_cores = 1 (bf16 only,
// C = 256 or 512): the tensor-core cluster kernel, w_hh as given [C,4C],
// 32-byte aligned. Returns a cudaError_t (0 on success). Asynchronous on
// `stream`; allocates nothing.
extern "C" int stf_lstm_last(const void* xp, const void* w_hh, const void* b,
                             void* out, int t_steps, int n, int c, int dtype,
                             int tensor_cores, void* stream) {
  if (!stf::shape_ok(t_steps, n, c)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tensor_cores) {
    if (dtype != stf::kBF16) return (int)cudaErrorInvalidValue;
    return (int)stf::launch_tc(xp, w_hh, b, out, t_steps, n, c, s);
  }
  if (dtype == stf::kF32)
    return (int)stf::launch<float>(xp, w_hh, b, out, t_steps, n, c, s);
  if (dtype == stf::kBF16)
    return (int)stf::launch<__nv_bfloat16>(xp, w_hh, b, out, t_steps, n, c,
                                           s);
  return (int)cudaErrorInvalidValue;
}
