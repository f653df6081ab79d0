// Gaussian-mixture log density for the MIG/AAM entropy sweep, on Hopper.
//
// Replaces the Pallas TPU kernel `_log_qz_kernel` in
// disvae_tpu/ops/pallas_kernels.py (launched there by `log_qz`). For every
// (l, d, s) it computes
//
//   out[l, d, s] = logsumexp_m log N(values[l, d, s]; mu[l, m, d],
//                                    exp(logvar[l, m, d]))
//
// over all M mixture components; the -log M normalisation is the caller's.
// At dsprites scale M = 737,280 / L, D = 10 and S = 2,000 per call: 1.47e10
// log-densities, each one exp.
//
// What bounds it on this card: the exps. An SM's SFU gives 16 exps a clock
// while its four schedulers issue 128 thread-instructions a clock, so the
// SFU is the limit only while a log-density costs under 8 issue slots. An
// online (max, sum) logsumexp spends one exp per density but a subtract, a
// compare and two selects around it (13.9 slots in its SASS: issue-bound).
// The design:
//   * One reference per (l, d) instead of a running max. A Gaussian log
//     density is at most peak = -0.5 * (logvar + log 2pi), so with
//     G[l, d] = max_m peak (log_qz_peak_kernel; atomicMax on
//     order-preserving bits gives the same G whatever the order) every term
//     exp(ld - G) <= 1 and the sum cannot overflow.
//   * Log2 units staged once per component tile: mu, a = -0.5 * exp(-logvar)
//     * log2(e) and c = (peak - G) * log2(e) in shared memory, so a density
//     is d = v - mu; sum += ex2(d * d * a + c): FADD, FMUL, FFMA, one
//     MUFU.EX2 (`ex2.approx.ftz.f32`, no range fix-up) and FADD, 5 slots.
//     The `v - mu` form stays: the expanded (a v + b) v + c cancels at
//     tight posteriors (ops/log_qz.py `log_qz_fast`'s docstring).
//   * Each thread owns kR = 8 samples of one (l, d), so one broadcast
//     float4 shared-memory load feeds 8 densities.
//   * With 5.3 slots a density the SFU saturates while issue has slots to
//     spare, so kPoly = 1 of each thread's 8 exps runs on the FMA pipe
//     (ex2_fma, 11 slots): 7/8 of the exps on the SFU, 6.6 slots a
//     density. Measured against the all-SFU loop, 2 of 8 on the FMA pipe
//     and 16 samples a thread with 1-3 on it (PERF.md), 1 of 8 was fastest.
//   * A persistent grid of exactly one wave (blocks per SM from the
//     occupancy query, times the SMs): the (row, sample tile, component)
//     work is laid out as one line of nseg * M component steps, nseg =
//     L * D * ceil(S / kTileS), and block b takes the b-th `chunk` of it.
//     Every block gets the same number of steps (+-1) at every shape, so
//     no shape ends in a partial wave. Where a block's chunk crosses a
//     segment it writes one partial per segment piece.
//
// Exactness where the fixed reference underflows. On the SFU a term below
// 2^-126 is flushed to 0 (ftz); on the FMA pipe one below 2^-125 counts
// 2^-125. Either way a segment's float32 sum is off by less than
// M * 2^-125 in all. The merge flags every (l, d, s) whose sum falls under
// M * 2^kFlagLog2 (kFlagLog2 = -100): above it that error is under 2^-25
// of the sum, about 3e-8 in the log. log_qz_recompute_kernel, always
// launched, redoes each flagged entry with an exact max (one block per
// entry, two passes over M, accurate expf, the plain version's roundings)
// and does nothing when none is flagged. No host sync; the flag count
// stays on the device.
//
// The TPU grid ran in order and carried (max, sum) in VMEM across component
// chunks. Here blocks run in parallel and in no order, so each segment
// piece's sum goes to scratch the wrapper allocates, and the merge sums a
// segment's pieces in block order: the result is bitwise repeatable. Ragged
// S and M edges are masked; nothing is padded.
//
// Plain C interface (loaded with ctypes): each launch returns
// cudaGetLastError() and the wrapper raises on anything but 0.

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace {

constexpr int kThreads = 128;           // threads per partial block
constexpr int kR = 8;                   // samples per thread
constexpr int kTileS = kThreads * kR;   // samples per segment
constexpr int kPoly = 1;               // of kR, exps on the FMA pipe
constexpr int kTileM = 256;             // components per shared tile
constexpr int kFlagLog2 = -100;         // flag a sum under M * 2^kFlagLog2
constexpr int kPeakThreads = 256;
constexpr int kPeakPerThread = 4;
constexpr int kMergeThreads = 256;
constexpr int kRecomputeThreads = 256;
constexpr float kLog2Pi = 1.8378770664093453f;     // log(2 pi)
constexpr float kLog2E = 1.4426950408889634f;      // log2(e)
constexpr float kHalfLog2E = -0.7213475204444817f; // -0.5 log2(e)

__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 2^x for x <= 0 on the FMA pipe: x = j + r with j = rint(x) (the 1.5 *
// 2^23 trick) and |r| <= 1/2; 2^r by Cephes exp2f's polynomial (relative
// error about 1e-7); 2^j added to the exponent bits (one LEA). x is clamped
// at -125 so 2^j stays normal: a term under 2^-125 then counts 2^-125, not
// 0, and within the flag threshold's accounting (header). 11 issue slots,
// none on the SFU.
__device__ __forceinline__ float ex2_fma(float x) {
  x = fmaxf(x, -125.f);
  const float t = x + 12582912.f;
  const float r = x - (t - 12582912.f);
  float p = 1.535336188319500e-4f;
  p = fmaf(p, r, 1.339887440266574e-3f);
  p = fmaf(p, r, 9.618437357674640e-3f);
  p = fmaf(p, r, 5.550332471162809e-2f);
  p = fmaf(p, r, 2.402264791363012e-1f);
  p = fmaf(p, r, 6.931472028550421e-1f);
  p = fmaf(p, r, 1.f);
  return __uint_as_float(__float_as_uint(p) + (__float_as_uint(t) << 23));
}

// Order-preserving float bits, so atomicMax on unsigned ints is a float
// max. 0 (the memset) lies below every float's code.
__device__ __forceinline__ unsigned int ordered_bits(float f) {
  const unsigned int u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_ordered_bits(unsigned int u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

__device__ __forceinline__ float peak_of(float lv) {
  return -0.5f * (lv + kLog2Pi);
}

// G[l * D + d] = max_m peak(logvar[l, m, d]) as ordered bits. A block
// takes kPeakThreads * kPeakPerThread components of one l and walks d, so
// the lines of its components come from L1 after the first d; one atomicMax
// per block and d.
__global__ void __launch_bounds__(kPeakThreads)
log_qz_peak_kernel(const float* __restrict__ logvar,   // (L, M, D)
                   unsigned int* __restrict__ g_bits,   // (L * D), zeroed
                   int M, int D) {
  __shared__ float red[kPeakThreads / 32];
  const float* lv = logvar + static_cast<size_t>(blockIdx.y) * M * D;
  const int m0 = blockIdx.x * kPeakThreads * kPeakPerThread + threadIdx.x;
  for (int d = 0; d < D; ++d) {
    float best = -INFINITY;
#pragma unroll
    for (int k = 0; k < kPeakPerThread; ++k) {
      const int m = m0 + k * kPeakThreads;
      if (m < M) {
        best = fmaxf(best, peak_of(lv[static_cast<size_t>(m) * D + d]));
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      best = fmaxf(best, __shfl_xor_sync(0xffffffffu, best, o));
    }
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = best;
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 1; w < kPeakThreads / 32; ++w) best = fmaxf(best, red[w]);
      atomicMax(g_bits + blockIdx.y * D + d, ordered_bits(best));
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
log_qz_partial_kernel(const float* __restrict__ values,   // (L, D, S)
                      const float* __restrict__ mu,       // (L, M, D)
                      const float* __restrict__ logvar,   // (L, M, D)
                      const unsigned int* __restrict__ g_bits,
                      float* __restrict__ part,  // (nseg, pieces, kTileS)
                      int rows, int M, int D, int S, int n_stiles,
                      long long chunk, int pieces) {
  __shared__ float4 tile[kTileM];

  const long long n_seg = static_cast<long long>(rows) * n_stiles;
  const long long total = n_seg * M;
  long long q = static_cast<long long>(blockIdx.x) * chunk;
  const long long q_end = min(total, q + chunk);
  while (q < q_end) {  // block-uniform: every thread takes each piece
    const long long seg = q / M;
    const int m_begin = static_cast<int>(q - seg * M);
    const int m_end =
        static_cast<int>(min(static_cast<long long>(M), m_begin + q_end - q));
    const int row = static_cast<int>(seg / n_stiles);  // l * D + d
    const int stile = static_cast<int>(seg - static_cast<long long>(row) *
                                                 n_stiles);
    const int l = row / D;
    const int d = row - l * D;
    const float g = from_ordered_bits(g_bits[row]);
    const int s0 = stile * kTileS + threadIdx.x;

    const float* v_row = values + static_cast<size_t>(row) * S;
    float v[kR], sum[kR];
#pragma unroll
    for (int k = 0; k < kR; ++k) {
      const int s = s0 + k * kThreads;
      v[k] = s < S ? v_row[s] : 0.f;  // samples past S compute, never merge
      sum[k] = 0.f;
    }
    const float* mu_l = mu + static_cast<size_t>(l) * M * D;
    const float* lv_l = logvar + static_cast<size_t>(l) * M * D;

    for (int m0 = m_begin; m0 < m_end; m0 += kTileM) {
      const int n = min(kTileM, m_end - m0);
      __syncthreads();  // the previous tile is consumed
      for (int i = threadIdx.x; i < n; i += kThreads) {
        const size_t off = static_cast<size_t>(m0 + i) * D + d;
        const float lv = lv_l[off];
        tile[i] = make_float4(mu_l[off], kHalfLog2E * expf(-lv),
                              (peak_of(lv) - g) * kLog2E, 0.f);
      }
      __syncthreads();
#pragma unroll 4
      for (int i = 0; i < n; ++i) {
        const float4 c = tile[i];
#pragma unroll
        for (int k = 0; k < kR; ++k) {
          const float diff = v[k] - c.x;
          const float x = fmaf(diff * diff, c.y, c.z);
          sum[k] += k < kPoly ? ex2_fma(x) : ex2_ftz(x);
        }
      }
    }

    // piece j of the segment: the blocks whose chunks meet it, in order
    const int j = static_cast<int>(blockIdx.x - seg * M / chunk);
    float* out = part + (static_cast<size_t>(seg) * pieces + j) * kTileS;
#pragma unroll
    for (int k = 0; k < kR; ++k) out[threadIdx.x + k * kThreads] = sum[k];
    q = seg * M + m_end;
  }
}

// out = log(sum of the pieces, in block order) + G; appends the entries
// whose sum is under `threshold` to `list` (`*count` counts them, zeroed).
__global__ void __launch_bounds__(kMergeThreads)
log_qz_merge_kernel(const float* __restrict__ part,
                    const unsigned int* __restrict__ g_bits,
                    float* __restrict__ out, int* __restrict__ count,
                    int* __restrict__ list, int M, int S, int n_stiles, long long chunk, int pieces,
                    int total, float threshold) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int row = i / S;
  const int s = i - row * S;
  const int stile = s / kTileS;
  const long long seg = static_cast<long long>(row) * n_stiles + stile;
  const long long b_lo = seg * M / chunk;
  const int n = static_cast<int>((seg * M + M - 1) / chunk - b_lo) + 1;
  const float* p = part + static_cast<size_t>(seg) * pieces * kTileS +
                   (s - stile * kTileS);
  float sum = 0.f;
  for (int j = 0; j < n; ++j) sum += p[static_cast<size_t>(j) * kTileS];
  out[i] = logf(sum) + from_ordered_bits(g_bits[row]);
  if (sum < threshold) list[atomicAdd(count, 1)] = i;
}

__device__ __forceinline__ float exact_log_density(float v, float m,
                                                   float lv) {
  // the plain version's association and roundings:
  // -0.5 * ((log 2pi + logvar) + (v - mu)^2 * exp(-logvar))
  const float diff = v - m;
  return -0.5f * __fadd_rn(__fadd_rn(kLog2Pi, lv),
                           __fmul_rn(__fmul_rn(diff, diff), expf(-lv)));
}

// Block-wide reduction in a fixed order (warp butterflies, then warp 0 over
// the warps' results): the same bits on every run.
template <bool kMax>
__device__ float block_reduce(float x, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, o);
    x = kMax ? fmaxf(x, y) : x + y;
  }
  const int warp = threadIdx.x >> 5;
  __syncthreads();  // red is free
  if ((threadIdx.x & 31) == 0) red[warp] = x;
  __syncthreads();
  x = red[0];
  for (int w = 1; w < kRecomputeThreads / 32; ++w) {
    x = kMax ? fmaxf(x, red[w]) : x + red[w];
  }
  return x;
}

// Each flagged (l, d, s) again over all M with an exact max: one block per
// entry, a stride of the grid over the flag list.
__global__ void __launch_bounds__(kRecomputeThreads)
log_qz_recompute_kernel(const float* __restrict__ values,
                        const float* __restrict__ mu,
                        const float* __restrict__ logvar,
                        const int* __restrict__ count,
                        const int* __restrict__ list,
                        float* __restrict__ out, int M, int D, int S) {
  __shared__ float red[kRecomputeThreads / 32];
  const int n = *count;
  for (int e = blockIdx.x; e < n; e += gridDim.x) {
    const int i = list[e];
    const int row = i / S;
    const int l = row / D;
    const int d = row - l * D;
    const float v = values[i];
    const float* mu_l = mu + static_cast<size_t>(l) * M * D + d;
    const float* lv_l = logvar + static_cast<size_t>(l) * M * D + d;
    float mx = -INFINITY;
    for (int m = threadIdx.x; m < M; m += kRecomputeThreads) {
      const size_t off = static_cast<size_t>(m) * D;
      mx = fmaxf(mx, exact_log_density(v, mu_l[off], lv_l[off]));
    }
    mx = block_reduce<true>(mx, red);
    float sum = 0.f;
    for (int m = threadIdx.x; m < M; m += kRecomputeThreads) {
      const size_t off = static_cast<size_t>(m) * D;
      sum += expf(exact_log_density(v, mu_l[off], lv_l[off]) - mx);
    }
    sum = block_reduce<false>(sum, red);
    if (threadIdx.x == 0) out[i] = logf(sum) + mx;
  }
}

}  // namespace

extern "C" {

// The geometry the wrapper's plan and tests assume: samples per segment,
// per thread, and how many of a segment's first samples take ex2_fma.
void disvae_log_qz_geometry(int* out) {
  out[0] = kTileS;
  out[1] = kR;
  out[2] = kPoly * kThreads;
}

// Partial blocks resident on one SM (the persistent grid's size per SM).
int disvae_log_qz_blocks_per_sm() {
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, log_qz_partial_kernel, kThreads, 0) != cudaSuccess) {
    return -static_cast<int>(cudaGetLastError());
  }
  return n;
}

// One call: G, the partial sums, the merge, the recompute. `ints` holds
// 1 + L * D + L * D * S int32 (the flag count, G's bits, the flag list);
// `part` n_seg * pieces * kTileS float32. The plan (n_blocks, n_stiles,
// chunk, pieces) is the wrapper's (ops/log_qz.py `_plan`).
int disvae_log_qz_f32(const float* values, const float* mu,
                      const float* logvar, float* out, float* part, int* ints,
                      int L, int M, int D, int S, int n_blocks, int n_stiles,
                      long long chunk, int pieces, int n_recompute_blocks,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = L * D;
  int* count = ints;
  unsigned int* g_bits = reinterpret_cast<unsigned int*>(ints + 1);
  int* list = ints + 1 + rows;
  cudaError_t err = cudaMemsetAsync(ints, 0, sizeof(int) * (1 + rows), st);
  if (err != cudaSuccess) return static_cast<int>(err);

  const int per_block = kPeakThreads * kPeakPerThread;
  log_qz_peak_kernel<<<dim3((M + per_block - 1) / per_block, L),
                       kPeakThreads, 0, st>>>(logvar, g_bits, M, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  log_qz_partial_kernel<<<n_blocks, kThreads, 0, st>>>(
      values, mu, logvar, g_bits, part, rows, M, D, S, n_stiles, chunk,
      pieces);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int total = rows * S;
  log_qz_merge_kernel<<<(total + kMergeThreads - 1) / kMergeThreads,
                        kMergeThreads, 0, st>>>(
      part, g_bits, out, count, list, M, S, n_stiles, chunk, pieces, total,
      std::ldexp(static_cast<float>(M), kFlagLog2));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  log_qz_recompute_kernel<<<n_recompute_blocks, kRecomputeThreads, 0, st>>>(
      values, mu, logvar, count, list, out, M, D, S);
  return static_cast<int>(cudaGetLastError());
}

const char* disvae_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
