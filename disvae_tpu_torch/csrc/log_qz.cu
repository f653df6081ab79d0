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
// At dsprites scale M = 737,280, D = 10 and S = 2,000 per call.
//
// What bounds it on this card: per (m, d, s) it does one exp and a handful
// of FMAs, and it moves almost no bytes (mu/logvar are read once per sample
// tile), so the SFU exp rate bounds it, not memory. What the design does
// about that:
//   * the online logsumexp update spends ONE exp per (m, d, s): the larger
//     of (running max, new density) becomes the max, and exp(-|delta|)
//     either rescales the running sum or is added to it;
//   * each component's mu, -0.5 * exp(-logvar) and -0.5 * (logvar + log 2pi)
//     are staged in shared memory once per block, so the per-component exp
//     and global loads are shared by the block's 512 samples;
//   * each thread owns R samples of one latent dimension, so one
//     shared-memory load (a broadcast float4) feeds R densities.
//
// The TPU grid ran in order and carried (max, sum) in VMEM across component
// chunks. Hopper blocks run in parallel and in no order, so nothing is
// carried between blocks: M is split across grid.y, each block writes a
// partial (max, sum) to scratch the wrapper allocates, and a second small
// kernel merges the partials and takes the log. Ragged S and M edges are
// masked here; nothing is padded.
//
// Plain C interface (loaded with ctypes): the launch returns
// cudaGetLastError() and the wrapper raises on anything but 0.

#include <cuda_runtime.h>

#include <cfloat>
#include <cstddef>

namespace {

constexpr int kThreads = 128;             // threads per block
constexpr int kR = 4;                     // samples per thread
constexpr int kTileS = kThreads * kR;     // samples per block
constexpr int kTileM = 256;               // components per shared tile
constexpr int kBlocksPerSm = 8;           // occupancy target for the split
constexpr float kLog2Pi = 1.8378770664093453f;

__global__ void __launch_bounds__(kThreads)
log_qz_partial_kernel(const float* __restrict__ values,   // (L, D, S)
                      const float* __restrict__ mu,       // (L, M, D)
                      const float* __restrict__ logvar,   // (L, M, D)
                      float* __restrict__ part_max,       // (n_split, L, D, S)
                      float* __restrict__ part_sum,       // (n_split, L, D, S)
                      int L, int M, int D, int S, int m_per_split) {
  __shared__ float4 tile[kTileM];

  const int split = blockIdx.y;
  const int row = blockIdx.z;  // l * D + d
  const int l = row / D;
  const int d = row - l * D;
  const int s0 = blockIdx.x * kTileS + threadIdx.x;

  const float* v_row = values + static_cast<size_t>(row) * S;
  float v[kR], run_max[kR], run_sum[kR];
#pragma unroll
  for (int k = 0; k < kR; ++k) {
    const int s = s0 + k * kThreads;
    v[k] = s < S ? v_row[s] : 0.f;  // samples past S compute, never store
    // -FLT_MAX, not -inf: the first update then takes the up-branch with
    // exp(-huge) = 0 and no inf - inf NaN.
    run_max[k] = -FLT_MAX;
    run_sum[k] = 0.f;
  }

  const int m_begin = split * m_per_split;
  const int m_end = min(M, m_begin + m_per_split);
  const float* mu_l = mu + static_cast<size_t>(l) * M * D;
  const float* lv_l = logvar + static_cast<size_t>(l) * M * D;

  for (int m0 = m_begin; m0 < m_end; m0 += kTileM) {
    const int n = min(kTileM, m_end - m0);
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const size_t off = static_cast<size_t>(m0 + i) * D + d;
      const float lv = lv_l[off];
      tile[i] = make_float4(mu_l[off], -0.5f * expf(-lv),
                            -0.5f * (lv + kLog2Pi), 0.f);
    }
    __syncthreads();
    for (int i = 0; i < n; ++i) {
      const float4 c = tile[i];
#pragma unroll
      for (int k = 0; k < kR; ++k) {
        const float diff = v[k] - c.x;
        const float ld = fmaf(diff * diff, c.y, c.z);
        const float delta = ld - run_max[k];
        const float e = __expf(-fabsf(delta));
        const bool up = delta > 0.f;
        run_sum[k] = up ? fmaf(run_sum[k], e, 1.f) : run_sum[k] + e;
        run_max[k] = up ? ld : run_max[k];
      }
    }
  }

  const size_t out_row =
      (static_cast<size_t>(split) * L * D + row) * static_cast<size_t>(S);
#pragma unroll
  for (int k = 0; k < kR; ++k) {
    const int s = s0 + k * kThreads;
    if (s < S) {
      part_max[out_row + s] = run_max[k];
      part_sum[out_row + s] = run_sum[k];
    }
  }
}

__global__ void log_qz_merge_kernel(const float* __restrict__ part_max,
                                    const float* __restrict__ part_sum,
                                    float* __restrict__ out, int n_split,
                                    int total) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float mx = -FLT_MAX;
  for (int p = 0; p < n_split; ++p) {
    mx = fmaxf(mx, part_max[static_cast<size_t>(p) * total + i]);
  }
  float sum = 0.f;
  for (int p = 0; p < n_split; ++p) {
    const size_t j = static_cast<size_t>(p) * total + i;
    sum += part_sum[j] * expf(part_max[j] - mx);
  }
  out[i] = logf(sum) + mx;
}

}  // namespace

extern "C" {

// How many component splits the launch uses: enough blocks for
// kBlocksPerSm on every SM, never more splits than component tiles.
int disvae_log_qz_n_split(int L, int M, int D, int S, int sm_count) {
  const long long base =
      static_cast<long long>((S + kTileS - 1) / kTileS) * L * D;
  const long long target = static_cast<long long>(kBlocksPerSm) * sm_count;
  long long n = (target + base - 1) / base;
  const long long max_n = (M + kTileM - 1) / kTileM;
  if (n > max_n) n = max_n;
  if (n < 1) n = 1;
  return static_cast<int>(n);
}

int disvae_log_qz_f32(const float* values, const float* mu,
                      const float* logvar, float* out, float* part_max,
                      float* part_sum, int L, int M, int D, int S, int n_split,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int m_per_split = (M + n_split - 1) / n_split;
  const dim3 grid((S + kTileS - 1) / kTileS, n_split, L * D);
  log_qz_partial_kernel<<<grid, kThreads, 0, st>>>(
      values, mu, logvar, part_max, part_sum, L, M, D, S, m_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int total = L * D * S;
  log_qz_merge_kernel<<<(total + 255) / 256, 256, 0, st>>>(
      part_max, part_sum, out, n_split, total);
  return static_cast<int>(cudaGetLastError());
}

const char* disvae_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
