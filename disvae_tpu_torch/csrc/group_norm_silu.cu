// GroupNorm -> SiLU -> bf16 rounding in one kernel, forward and backward,
// on Hopper (K5).
//
// Replaces no TPU kernel. Stable Diffusion's kl-f8 autoencoder
// (models/autoencoder_kl.py) computes conv(silu(group_norm(x))) in every
// ResnetBlock and before both conv_outs, and under the `default` numerics
// the conv rounds its operand to bf16 values (ops/precision.py). Done by
// PyTorch's kernels that is GroupNorm's moments and apply, SiLU, the
// rounding's two casts, and the three matching backward kernels: about
// 16 float32 passes over each site's input, every kernel already near the
// card's bandwidth. K5 was added because these passes are memory-bound:
// the only gain is to move fewer bytes. It computes, for x (N, C, H, W)
// float32, G groups of C/G channels, per-channel gamma and beta,
//
//   y = round_bf16(silu(gamma_c * (x - mean_ng) * rstd_ng + beta_c))
//
// (round to nearest even, as `x.to(bfloat16)` does; y stays float32) and
// its backward, where the cotangent dy passes straight through the
// rounding (the conv's own backward treats its operand's rounding so).
//
// What bounds it on this card: bytes. Its compulsory traffic is five
// float32 passes over x's size: x read and y written forward, dy and x
// read and dx written backward. The design makes eight, the fewest that
// take the group's statistics and sums in separate launches:
//   forward  GroupNormSiLU_stats_kernel reads x once and writes Welford
//            partials (count, mean, M2) per block; GroupNormSiLU_fwd_kernel
//            merges its group's partials (a few dozen, from L2), then reads
//            x and writes y. The pre-SiLU value is never stored: mean and
//            rstd per (n, g) are what the backward keeps.
//   backward GroupNormSiLU_bwd_sums_kernel reads dy and x, recomputes
//            a = gamma x^ + beta and da = dy silu'(a), and writes per block
//            the sums of da and da x^; GroupNormSiLU_bwd_params_kernel
//            folds those into dgamma, dbeta and each group's two sums;
//            GroupNormSiLU_bwd_dx_kernel reads dy and x again and writes dx.
// Each streaming block owns a run of kChunk elements of one (n, c) row, so
// gamma and beta are one value a block and no index is divided per element;
// a thread issues its eight 16-byte loads (or 32 scalar ones where H W is
// not a multiple of 4) before it uses any, 32 KB of each operand in flight
// a block. At kl-f8's 256^2 maps a group is 1-2 MB and N G = 384 groups:
// one block per group would leave the card under three waves, so a group
// spreads over C/G * ceil(HW / kChunk) blocks (6,144 to 24,576 a launch
// at b12).
//
// No atomics: every sum runs in a fixed order (a thread's registers, a
// warp's shuffle tree, the warps in order, the partials in order), so two
// calls give the same bits and a CUDA graph of the step replays the eager
// step bit for bit. Variances come from two passes over a thread's
// registers and Chan's merge, not from sums of squares.
//
// Plain C interface (loaded with ctypes): each entry returns
// cudaGetLastError() and the wrapper raises on anything but 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 8192;                // elements of one row a block
constexpr int kPer = kChunk / kThreads;     // elements a thread
constexpr int kParamsThreads = 256;

struct Moments {
  float n, mean, m2;
};

// Chan et al.'s merge of two (count, mean, M2); either may be empty.
__device__ __forceinline__ Moments merge(Moments a, Moments b) {
  const float n = a.n + b.n;
  if (n == 0.f) return a;
  const float d = b.mean - a.mean;
  const float w = b.n / n;
  return {n, fmaf(d, w, a.mean), a.m2 + b.m2 + d * d * a.n * w};
}

__device__ __forceinline__ Moments shfl_down(Moments m, int off) {
  return {__shfl_down_sync(0xffffffffu, m.n, off),
          __shfl_down_sync(0xffffffffu, m.mean, off),
          __shfl_down_sync(0xffffffffu, m.m2, off)};
}

__device__ __forceinline__ Moments warp_merge(Moments m) {
  for (int off = 16; off > 0; off >>= 1) m = merge(m, shfl_down(m, off));
  return m;
}

__device__ __forceinline__ float2 warp_sum(float2 v) {
  for (int off = 16; off > 0; off >>= 1) {
    v.x += __shfl_down_sync(0xffffffffu, v.x, off);
    v.y += __shfl_down_sync(0xffffffffu, v.y, off);
  }
  return v;
}

// Element j of a thread's share of the block's run [lo, hi) of a row: with
// 16-byte accesses, element 4 * (tid + (j / 4) * kThreads) + j % 4 past lo
// (neighbouring threads on neighbouring 16 bytes); otherwise element
// tid + j * kThreads past lo.
template <bool kVec>
__device__ __forceinline__ int offset_of(int j) {
  return kVec ? 4 * (threadIdx.x + (j / 4) * kThreads) + (j % 4)
              : threadIdx.x + j * kThreads;
}

// The thread's share of row[lo, hi) into v (0 past hi).
template <bool kVec>
__device__ __forceinline__ void load(const float* __restrict__ row, int lo,
                                     int hi, float (&v)[kPer]) {
  if (kVec) {
#pragma unroll
    for (int q = 0; q < kPer / 4; ++q) {
      const int e = lo + offset_of<true>(4 * q);
      const float4 t = e < hi ? *reinterpret_cast<const float4*>(row + e)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
      v[4 * q] = t.x;
      v[4 * q + 1] = t.y;
      v[4 * q + 2] = t.z;
      v[4 * q + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int e = lo + offset_of<false>(j);
      v[j] = e < hi ? row[e] : 0.f;
    }
  }
}

template <bool kVec>
__device__ __forceinline__ void store(float* __restrict__ row, int lo, int hi,
                                      const float (&v)[kPer]) {
  if (kVec) {
#pragma unroll
    for (int q = 0; q < kPer / 4; ++q) {
      const int e = lo + offset_of<true>(4 * q);
      if (e < hi)
        *reinterpret_cast<float4*>(row + e) =
            make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int e = lo + offset_of<false>(j);
      if (e < hi) row[e] = v[j];
    }
  }
}

__device__ __forceinline__ float sigmoid(float a) {
  return 1.f / (1.f + expf(-a));
}

// silu(a) rounded to the nearest bf16, as a float
__device__ __forceinline__ float silu_bf16(float a) {
  return __bfloat162float(__float2bfloat16_rn(a / (1.f + expf(-a))));
}

// dy * silu'(a)
__device__ __forceinline__ float silu_grad(float dy, float a) {
  const float s = sigmoid(a);
  return dy * (s * (1.f + a * (1.f - s)));
}

// The block's (n, c) row, its run [lo, hi) and its place: blocks are laid
// out row-major over (n, c, chunk).
struct Place {
  int row, n, c, s, lo, hi;
};

__device__ __forceinline__ Place place_of(int C, int hw, int chunks) {
  Place p;
  p.row = blockIdx.x / chunks;
  p.s = blockIdx.x - p.row * chunks;
  p.n = p.row / C;
  p.c = p.row - p.n * C;
  p.lo = p.s * kChunk;
  p.hi = min(hw, p.lo + kChunk);
  return p;
}

// Pass 1 of the forward: (count, mean, M2) of the block's run, two passes
// over each thread's registers, then merged in a fixed order.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    GroupNormSiLU_stats_kernel(const float* __restrict__ x,
                               float* __restrict__ part, int C, int hw,
                               int chunks) {
  const Place p = place_of(C, hw, chunks);
  float v[kPer];
  load<kVec>(x + static_cast<size_t>(p.row) * hw, p.lo, p.hi, v);
  float count = 0.f, sum = 0.f;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if (p.lo + offset_of<kVec>(j) < p.hi) count += 1.f;
    sum += v[j];
  }
  Moments m = {count, count > 0.f ? sum / count : 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const float d = v[j] - m.mean;
    if (p.lo + offset_of<kVec>(j) < p.hi) m.m2 = fmaf(d, d, m.m2);
  }
  m = warp_merge(m);
  __shared__ Moments warps[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warps[warp] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    Moments t = warps[0];
    for (int i = 1; i < kWarps; ++i) t = merge(t, warps[i]);
    float* out = part + 3 * static_cast<size_t>(blockIdx.x);
    out[0] = t.n;
    out[1] = t.mean;
    out[2] = t.m2;
  }
}

// (mean, rstd) of the block's group from the stats kernel's partials, which
// lie contiguous for a group (its rows' chunks in order): the first warp
// merges them in a fixed order. Every block of the group computes the same
// bits.
__device__ __forceinline__ float2 group_stats(const float* __restrict__ part,
                                              int first, int count,
                                              float eps) {
  __shared__ float2 stats;
  if (threadIdx.x < 32) {
    Moments m = {0.f, 0.f, 0.f};
    for (int i = threadIdx.x; i < count; i += 32) {
      const float* q = part + 3 * static_cast<size_t>(first + i);
      m = merge(m, {q[0], q[1], q[2]});
    }
    m = warp_merge(m);
    if (threadIdx.x == 0)
      stats = make_float2(m.mean, rsqrtf(fmaxf(m.m2 / m.n, 0.f) + eps));
  }
  __syncthreads();
  return stats;
}

// Pass 2 of the forward: y = round_bf16(silu(x * scale + shift)) with
// scale = gamma_c rstd and shift = beta_c - mean scale; the group's first
// block writes mean and rstd for the backward.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    GroupNormSiLU_fwd_kernel(const float* __restrict__ x,
                             const float* __restrict__ gamma,
                             const float* __restrict__ beta,
                             const float* __restrict__ part,
                             float* __restrict__ y,
                             float* __restrict__ mean_out,
                             float* __restrict__ rstd_out, int C, int hw,
                             int chunks, int cpg, float eps) {
  const Place p = place_of(C, hw, chunks);
  const int g = p.c / cpg, groups = C / cpg;
  const float2 st = group_stats(part, (p.n * C + g * cpg) * chunks,
                                cpg * chunks, eps);
  if (threadIdx.x == 0 && p.s == 0 && p.c == g * cpg) {
    mean_out[p.n * groups + g] = st.x;
    rstd_out[p.n * groups + g] = st.y;
  }
  const float scale = gamma[p.c] * st.y;
  const float shift = fmaf(-st.x, scale, beta[p.c]);
  const size_t base = static_cast<size_t>(p.row) * hw;
  float v[kPer];
  load<kVec>(x + base, p.lo, p.hi, v);
#pragma unroll
  for (int j = 0; j < kPer; ++j) v[j] = silu_bf16(fmaf(v[j], scale, shift));
  store<kVec>(y + base, p.lo, p.hi, v);
}

// Pass 1 of the backward: the sums of da = dy silu'(a) and of da x^ over
// the block's run (past hi dy is 0, so da is 0 there).
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    GroupNormSiLU_bwd_sums_kernel(const float* __restrict__ dy,
                                  const float* __restrict__ x,
                                  const float* __restrict__ gamma,
                                  const float* __restrict__ beta,
                                  const float* __restrict__ mean,
                                  const float* __restrict__ rstd,
                                  float* __restrict__ part, int C, int hw,
                                  int chunks, int cpg) {
  const Place p = place_of(C, hw, chunks);
  const int ng = p.n * (C / cpg) + p.c / cpg;
  const float mu = mean[ng], rs = rstd[ng];
  const float scale = gamma[p.c] * rs;
  const float shift = fmaf(-mu, scale, beta[p.c]);
  const size_t base = static_cast<size_t>(p.row) * hw;
  float xv[kPer], gv[kPer];
  load<kVec>(x + base, p.lo, p.hi, xv);
  load<kVec>(dy + base, p.lo, p.hi, gv);
  float2 s = make_float2(0.f, 0.f);
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const float da = silu_grad(gv[j], fmaf(xv[j], scale, shift));
    s.x += da;
    s.y = fmaf(da, (xv[j] - mu) * rs, s.y);
  }
  s = warp_sum(s);
  __shared__ float2 warps[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warps[warp] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float2 t = warps[0];
    for (int i = 1; i < kWarps; ++i) {
      t.x += warps[i].x;
      t.y += warps[i].y;
    }
    reinterpret_cast<float2*>(part)[blockIdx.x] = t;
  }
}

// Pass 2 of the backward, one thread per output: for channel c, dbeta_c =
// sum_n da and dgamma_c = sum_n da x^; for group (n, g), A = sum_c gamma_c
// sum da and B = sum_c gamma_c sum da x^ over its channels. Sums in a fixed
// order: a row's chunks, then the rows.
__global__ void __launch_bounds__(kParamsThreads)
    GroupNormSiLU_bwd_params_kernel(const float* __restrict__ part,
                                    const float* __restrict__ gamma,
                                    float* __restrict__ dgamma,
                                    float* __restrict__ dbeta,
                                    float* __restrict__ coef, int N, int C,
                                    int chunks, int cpg) {
  const float2* p2 = reinterpret_cast<const float2*>(part);
  const int t = blockIdx.x * kParamsThreads + threadIdx.x;
  const int groups = C / cpg;
  auto row_sum = [&](int row) {
    float2 r = make_float2(0.f, 0.f);
    for (int s = 0; s < chunks; ++s) {
      const float2 q = p2[static_cast<size_t>(row) * chunks + s];
      r.x += q.x;
      r.y += q.y;
    }
    return r;
  };
  if (t < C) {
    float2 acc = make_float2(0.f, 0.f);
    for (int n = 0; n < N; ++n) {
      const float2 r = row_sum(n * C + t);
      acc.x += r.x;
      acc.y += r.y;
    }
    dbeta[t] = acc.x;
    dgamma[t] = acc.y;
  } else if (t < C + N * groups) {
    const int ng = t - C, n = ng / groups, g = ng - n * groups;
    float2 acc = make_float2(0.f, 0.f);
    for (int k = 0; k < cpg; ++k) {
      const int c = g * cpg + k;
      const float2 r = row_sum(n * C + c);
      acc.x = fmaf(gamma[c], r.x, acc.x);
      acc.y = fmaf(gamma[c], r.y, acc.y);
    }
    reinterpret_cast<float2*>(coef)[ng] = acc;
  }
}

// Pass 3 of the backward: dx = rstd (gamma_c da - (A + x^ B) / L), L the
// group's element count.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    GroupNormSiLU_bwd_dx_kernel(const float* __restrict__ dy,
                                const float* __restrict__ x,
                                const float* __restrict__ gamma,
                                const float* __restrict__ beta,
                                const float* __restrict__ mean,
                                const float* __restrict__ rstd,
                                const float* __restrict__ coef,
                                float* __restrict__ dx, int C, int hw,
                                int chunks, int cpg) {
  const Place p = place_of(C, hw, chunks);
  const int ng = p.n * (C / cpg) + p.c / cpg;
  const float mu = mean[ng], rs = rstd[ng];
  const float gm = gamma[p.c];
  const float scale = gm * rs;
  const float shift = fmaf(-mu, scale, beta[p.c]);
  const float2 ab = reinterpret_cast<const float2*>(coef)[ng];
  const float inv_l = 1.f / (static_cast<float>(cpg) * hw);
  const float ka = ab.x * inv_l, kb = ab.y * inv_l;
  const size_t base = static_cast<size_t>(p.row) * hw;
  float xv[kPer], gv[kPer];
  load<kVec>(x + base, p.lo, p.hi, xv);
  load<kVec>(dy + base, p.lo, p.hi, gv);
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const float da = silu_grad(gv[j], fmaf(xv[j], scale, shift));
    const float xh = (xv[j] - mu) * rs;
    gv[j] = rs * (gm * da - fmaf(xh, kb, ka));
  }
  store<kVec>(dx + base, p.lo, p.hi, gv);
}

int chunks_of(int hw) { return (hw + kChunk - 1) / kChunk; }

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

// Partials per (n, c) row: the stats and sums kernels' blocks a row.
int disvae_group_norm_silu_chunks(int hw) { return chunks_of(hw); }

// Forward of x (n, c, hw) float32, c / cpg groups: y, and mean and rstd
// (n, groups). part holds 3 * n * c * chunks floats.
int disvae_group_norm_silu_fwd(const float* x, const float* gamma,
                               const float* beta, float* part, float* y,
                               float* mean, float* rstd, int n, int c,
                               int hw, int cpg, float eps,
                               cudaStream_t stream) {
  const int chunks = chunks_of(hw);
  const int blocks = n * c * chunks;
  // 16-byte accesses where every row starts on 16 bytes
  if (hw % 4 == 0 && aligned16(x) && aligned16(y)) {
    GroupNormSiLU_stats_kernel<true>
        <<<blocks, kThreads, 0, stream>>>(x, part, c, hw, chunks);
    GroupNormSiLU_fwd_kernel<true><<<blocks, kThreads, 0, stream>>>(
        x, gamma, beta, part, y, mean, rstd, c, hw, chunks, cpg, eps);
  } else {
    GroupNormSiLU_stats_kernel<false>
        <<<blocks, kThreads, 0, stream>>>(x, part, c, hw, chunks);
    GroupNormSiLU_fwd_kernel<false><<<blocks, kThreads, 0, stream>>>(
        x, gamma, beta, part, y, mean, rstd, c, hw, chunks, cpg, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

// Backward: dx from dy and x, dgamma and dbeta (c). part holds 2 * n * c *
// chunks floats, coef 2 * n * groups.
int disvae_group_norm_silu_bwd(const float* dy, const float* x,
                               const float* gamma, const float* beta,
                               const float* mean, const float* rstd,
                               float* part, float* coef, float* dx,
                               float* dgamma, float* dbeta, int n, int c,
                               int hw, int cpg, cudaStream_t stream) {
  const int chunks = chunks_of(hw);
  const int blocks = n * c * chunks;
  const bool vec =
      hw % 4 == 0 && aligned16(dy) && aligned16(x) && aligned16(dx);
  if (vec)
    GroupNormSiLU_bwd_sums_kernel<true><<<blocks, kThreads, 0, stream>>>(
        dy, x, gamma, beta, mean, rstd, part, c, hw, chunks, cpg);
  else
    GroupNormSiLU_bwd_sums_kernel<false><<<blocks, kThreads, 0, stream>>>(
        dy, x, gamma, beta, mean, rstd, part, c, hw, chunks, cpg);
  const int outputs = c + n * (c / cpg);
  GroupNormSiLU_bwd_params_kernel<<<(outputs + kParamsThreads - 1) /
                                        kParamsThreads,
                                    kParamsThreads, 0, stream>>>(
      part, gamma, dgamma, dbeta, coef, n, c, chunks, cpg);
  if (vec)
    GroupNormSiLU_bwd_dx_kernel<true><<<blocks, kThreads, 0, stream>>>(
        dy, x, gamma, beta, mean, rstd, coef, dx, c, hw, chunks, cpg);
  else
    GroupNormSiLU_bwd_dx_kernel<false><<<blocks, kThreads, 0, stream>>>(
        dy, x, gamma, beta, mean, rstd, coef, dx, c, hw, chunks, cpg);
  return static_cast<int>(cudaGetLastError());
}

const char* disvae_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
