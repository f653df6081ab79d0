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
// float32 (NCHW or channels-last), G groups of C/G channels, per-channel
// gamma and beta,
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
// In NCHW each streaming block owns a run of kChunk elements of one (n, c)
// row, so gamma and beta are one value a block and no index is divided per
// element; a thread issues its eight 16-byte loads (or 32 scalar ones where
// H W is not a multiple of 4) before it uses any, 32 KB of each operand in
// flight a block. At kl-f8's 256^2 maps a group is 1-2 MB and N G = 384 groups:
// one block per group would leave the card under three waves, so a group
// spreads over C/G * ceil(HW / kChunk) blocks (6,144 to 24,576 a launch
// at b12).
//
// Two layouts, each read and written as it lies (ops/group_norm_silu.py
// picks by x's strides): NCHW x takes the kernels above, channels-last
// (NHWC) x the GroupNormSiLU_nhwc_* kernels, and y and dx come out in x's
// layout. cuDNN's Hopper convs are NHWC, so a channels-last model feeds
// them with no transform; K5 in NCHW alone would force one per conv.
// The NHWC design keeps the same eight passes and the same five-pass
// bound; what changes is which data a block owns. A group is cpg
// contiguous floats of each pixel (kl-f8's 32 groups: 4, 8 or 16, one to
// four float4s), so a block owns a run of pixels of one image and all C
// channels: each thread holds one float4 of channels (its gamma and beta
// loaded once) and strides over the run's pixels, eight 16-byte loads in
// flight before any use, carrying its sums across steps in registers.
//   forward  GroupNormSiLU_nhwc_stats_kernel writes a partial per (n,
//            slice, g); _nhwc_stats_merge_kernel merges each group's
//            partials into mean and rstd; _nhwc_fwd_kernel streams x to y.
//   backward _nhwc_bwd_sums_kernel writes the sums of da and da x^ per (n,
//            slice, c); _nhwc_bwd_reduce_kernel sums the slices per (n, c);
//            GroupNormSiLU_bwd_params_kernel folds them as above;
//            _nhwc_bwd_dx_kernel streams dy and x to dx.
// The grid is one wave of blocks (the card's SMs times the blocks one SM
// holds), so each block streams an equal run and the partials stay a few
// dozen a group; the two small merges read them from L2.
//
// No atomics: every sum runs in a fixed order (a thread's registers, a
// warp's shuffle tree, the warps or rows of threads in order, the
// partials in order), so two calls give the same bits and a CUDA graph of
// the step replays the eager step bit for bit. Variances come from two
// passes over a thread's registers and Chan's merge, not from sums of
// squares.
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

// ---------------------------------------------------------------------------
// The NHWC design: x channels-last, an (N H W, C) matrix of rows of C floats.
// A group is cpg contiguous floats of every row of its image, so a block
// owns a run of rows of one image and all C channels: thread (r, q) of the
// block holds the channel quad q (channels 4q..4q+3, a float4 of every
// row), whose gamma and beta it loads once, and takes rows r, r + R, ... of
// each step of kNhwcLoads R rows (R = kThreads / (C / 4) rows of threads).
// The cpg / 4 lanes that hold one group's quads are neighbours in a warp.
// The grid is (slices, N): slice s of image n takes steps [s ips, (s + 1)
// ips) of its image's rows, with as many slices as fill the card once (the
// host's `nhwc_slices`), so each thread carries its sums over several
// steps in registers and the partials stay few.

constexpr int kNhwcLoads = 8;  // float4 rows a thread loads a step

struct Nhwc {
  int q, r, R, g, active;  // quad, row of threads, rows of threads, group
  int n, first, last;      // image, first row, one past the last row
};

__device__ __forceinline__ Nhwc nhwc_of(int C, int hw, int ips, int cpg) {
  Nhwc t;
  const int Q = C / 4;
  t.R = kThreads / Q;
  t.q = threadIdx.x % Q;
  t.r = threadIdx.x / Q;
  t.active = t.r < t.R;
  t.g = 4 * t.q / cpg;
  t.n = blockIdx.y;
  const int step_rows = t.R * kNhwcLoads;
  t.first = blockIdx.x * ips * step_rows;
  t.last = min(hw, t.first + ips * step_rows);
  return t;
}

// Row u of a step that starts at row `row0`, for this thread.
__device__ __forceinline__ int nhwc_row(const Nhwc& t, int row0, int u) {
  return row0 + u * t.R + t.r;
}

__device__ __forceinline__ float4 ldg4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float comp(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// The thread's kNhwcLoads float4s of one step (zeros past the run).
__device__ __forceinline__ void nhwc_load(const float* __restrict__ img,
                                          const Nhwc& t, int C, int row0,
                                          float4 (&v)[kNhwcLoads]) {
#pragma unroll
  for (int u = 0; u < kNhwcLoads; ++u) {
    const int row = nhwc_row(t, row0, u);
    v[u] = t.active && row < t.last
               ? ldg4(img + static_cast<size_t>(row) * C + 4 * t.q)
               : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// Pass 1 of the forward: each thread's (count, mean, M2) of its group over
// its rows (two passes over a step's registers, Chan's merge across
// steps), merged over the group's cpg / 4 lanes by shuffle, then over the
// block's rows of threads in order; one partial per (n, slice, group).
__global__ void __launch_bounds__(kThreads)
    GroupNormSiLU_nhwc_stats_kernel(const float* __restrict__ x,
                                    float* __restrict__ part, int C, int hw,
                                    int ips, int cpg) {
  const Nhwc t = nhwc_of(C, hw, ips, cpg);
  const float* img = x + static_cast<size_t>(t.n) * hw * C;
  const int step_rows = t.R * kNhwcLoads;
  Moments m = {0.f, 0.f, 0.f};
  for (int row0 = t.first; row0 < t.last; row0 += step_rows) {
    float4 v[kNhwcLoads];
    nhwc_load(img, t, C, row0, v);
    float count = 0.f, sum = 0.f;
#pragma unroll
    for (int u = 0; u < kNhwcLoads; ++u) {
      if (t.active && nhwc_row(t, row0, u) < t.last) count += 4.f;
      sum += (v[u].x + v[u].y) + (v[u].z + v[u].w);
    }
    if (count == 0.f) continue;
    const float mean = sum / count;
    float m2 = 0.f;
#pragma unroll
    for (int u = 0; u < kNhwcLoads; ++u) {
      if (!(t.active && nhwc_row(t, row0, u) < t.last)) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float d = comp(v[u], j) - mean;
        m2 = fmaf(d, d, m2);
      }
    }
    m = merge(m, {count, mean, m2});
  }
  // the group's lanes, lowest first (a group's quads never straddle a warp)
  const int lanes = cpg / 4;
  for (int off = lanes / 2; off > 0; off >>= 1)
    m = merge(m, {__shfl_down_sync(0xffffffffu, m.n, off, lanes),
                  __shfl_down_sync(0xffffffffu, m.mean, off, lanes),
                  __shfl_down_sync(0xffffffffu, m.m2, off, lanes)});
  __shared__ Moments rows[kThreads];  // [r][g]
  const int groups = C / cpg;
  if (t.active && (4 * t.q) % cpg == 0) rows[t.r * groups + t.g] = m;
  __syncthreads();
  for (int g = threadIdx.x; g < groups; g += kThreads) {
    Moments s = rows[g];
    for (int r = 1; r < t.R; ++r) s = merge(s, rows[r * groups + g]);
    float* out = part + 3 * ((static_cast<size_t>(t.n) * gridDim.x +
                              blockIdx.x) * groups + g);
    out[0] = s.n;
    out[1] = s.mean;
    out[2] = s.m2;
  }
}

// Each (n, g)'s mean and rstd from its slices' partials: one warp a group,
// its lanes over the slices in turn, then the warp's tree.
__global__ void __launch_bounds__(kThreads)
    GroupNormSiLU_nhwc_stats_merge_kernel(const float* __restrict__ part,
                                          float* __restrict__ mean,
                                          float* __restrict__ rstd,
                                          int ngroups, int groups,
                                          int slices, float eps) {
  const int w = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= ngroups) return;  // the whole warp
  const int n = w / groups, g = w - n * groups;
  Moments m = {0.f, 0.f, 0.f};
  for (int s = lane; s < slices; s += 32) {
    const float* q = part + 3 * ((static_cast<size_t>(n) * slices + s) *
                                 groups + g);
    m = merge(m, {q[0], q[1], q[2]});
  }
  m = warp_merge(m);
  if (lane == 0) {
    mean[w] = m.mean;
    rstd[w] = rsqrtf(fmaxf(m.m2 / m.n, 0.f) + eps);
  }
}

// The thread's per-channel scale = gamma rstd and shift = beta - mean scale
// (as the NCHW kernels compute them).
__device__ __forceinline__ void nhwc_affine(const float* __restrict__ gamma,
                                            const float* __restrict__ beta,
                                            const Nhwc& t, float mu, float rs,
                                            float4& gm, float4& scale,
                                            float4& shift) {
  const float* g = gamma + 4 * t.q;
  const float* b = beta + 4 * t.q;
  gm = make_float4(g[0], g[1], g[2], g[3]);
  const float4 bt = make_float4(b[0], b[1], b[2], b[3]);
  scale = make_float4(gm.x * rs, gm.y * rs, gm.z * rs, gm.w * rs);
  shift = make_float4(fmaf(-mu, scale.x, bt.x), fmaf(-mu, scale.y, bt.y),
                      fmaf(-mu, scale.z, bt.z), fmaf(-mu, scale.w, bt.w));
}

// Pass 2 of the forward: y = round_bf16(silu(x scale + shift)).
__global__ void __launch_bounds__(kThreads)
    GroupNormSiLU_nhwc_fwd_kernel(const float* __restrict__ x,
                                  const float* __restrict__ gamma,
                                  const float* __restrict__ beta,
                                  const float* __restrict__ mean,
                                  const float* __restrict__ rstd,
                                  float* __restrict__ y, int C, int hw,
                                  int ips, int cpg) {
  const Nhwc t = nhwc_of(C, hw, ips, cpg);
  if (!t.active) return;
  const int ng = t.n * (C / cpg) + t.g;
  float4 gm, scale, shift;
  nhwc_affine(gamma, beta, t, mean[ng], rstd[ng], gm, scale, shift);
  const size_t base = static_cast<size_t>(t.n) * hw * C;
  const int step_rows = t.R * kNhwcLoads;
  for (int row0 = t.first; row0 < t.last; row0 += step_rows) {
    float4 v[kNhwcLoads];
    nhwc_load(x + base, t, C, row0, v);
#pragma unroll
    for (int u = 0; u < kNhwcLoads; ++u) {
      const int row = nhwc_row(t, row0, u);
      if (row < t.last)
        *reinterpret_cast<float4*>(y + base + static_cast<size_t>(row) * C +
                                   4 * t.q) =
            make_float4(silu_bf16(fmaf(v[u].x, scale.x, shift.x)),
                        silu_bf16(fmaf(v[u].y, scale.y, shift.y)),
                        silu_bf16(fmaf(v[u].z, scale.z, shift.z)),
                        silu_bf16(fmaf(v[u].w, scale.w, shift.w)));
    }
  }
}

// Pass 1 of the backward: per channel, the sums of da = dy silu'(a) and da
// x^ over the block's rows (each thread's in registers over its rows, then
// the block's rows of threads in order); C partials per (n, slice).
__global__ void __launch_bounds__(kThreads)
    GroupNormSiLU_nhwc_bwd_sums_kernel(const float* __restrict__ dy,
                                       const float* __restrict__ x,
                                       const float* __restrict__ gamma,
                                       const float* __restrict__ beta,
                                       const float* __restrict__ mean,
                                       const float* __restrict__ rstd,
                                       float* __restrict__ part, int C,
                                       int hw, int ips, int cpg) {
  const Nhwc t = nhwc_of(C, hw, ips, cpg);
  float4 sa = make_float4(0.f, 0.f, 0.f, 0.f), sx = sa;
  if (t.active) {
    const int ng = t.n * (C / cpg) + t.g;
    const float mu = mean[ng], rs = rstd[ng];
    float4 gm, scale, shift;
    nhwc_affine(gamma, beta, t, mu, rs, gm, scale, shift);
    const size_t base = static_cast<size_t>(t.n) * hw * C;
    const int step_rows = t.R * kNhwcLoads;
    for (int row0 = t.first; row0 < t.last; row0 += step_rows) {
      float4 xv[kNhwcLoads], gv[kNhwcLoads];
      nhwc_load(x + base, t, C, row0, xv);
      nhwc_load(dy + base, t, C, row0, gv);
#pragma unroll
      for (int u = 0; u < kNhwcLoads; ++u) {  // past the run dy is 0
        float da = silu_grad(gv[u].x, fmaf(xv[u].x, scale.x, shift.x));
        sa.x += da;
        sx.x = fmaf(da, (xv[u].x - mu) * rs, sx.x);
        da = silu_grad(gv[u].y, fmaf(xv[u].y, scale.y, shift.y));
        sa.y += da;
        sx.y = fmaf(da, (xv[u].y - mu) * rs, sx.y);
        da = silu_grad(gv[u].z, fmaf(xv[u].z, scale.z, shift.z));
        sa.z += da;
        sx.z = fmaf(da, (xv[u].z - mu) * rs, sx.z);
        da = silu_grad(gv[u].w, fmaf(xv[u].w, scale.w, shift.w));
        sa.w += da;
        sx.w = fmaf(da, (xv[u].w - mu) * rs, sx.w);
      }
    }
  }
  __shared__ float4 rows_a[kThreads], rows_x[kThreads];  // [r][q]
  if (t.active) {
    rows_a[threadIdx.x] = sa;
    rows_x[threadIdx.x] = sx;
  }
  __syncthreads();
  const int Q = C / 4;
  float2* out = reinterpret_cast<float2*>(part) +
                (static_cast<size_t>(t.n) * gridDim.x + blockIdx.x) * C;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const float* ra = reinterpret_cast<const float*>(rows_a);
    const float* rx = reinterpret_cast<const float*>(rows_x);
    float2 s = make_float2(ra[c], rx[c]);
    for (int r = 1; r < t.R; ++r) {
      s.x += ra[r * 4 * Q + c];
      s.y += rx[r * 4 * Q + c];
    }
    out[c] = s;
  }
}

// The sums per (n, c) from the slices' partials: 32 channels a block, its
// warps over the slices in turn, then the warps in order.
__global__ void __launch_bounds__(kThreads)
    GroupNormSiLU_nhwc_bwd_reduce_kernel(const float* __restrict__ part,
                                         float* __restrict__ sums, int C,
                                         int slices) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane, n = blockIdx.y;
  const float2* p2 = reinterpret_cast<const float2*>(part);
  float2 acc = make_float2(0.f, 0.f);
  if (c < C)
    for (int s = warp; s < slices; s += kWarps) {
      const float2 q = p2[(static_cast<size_t>(n) * slices + s) * C + c];
      acc.x += q.x;
      acc.y += q.y;
    }
  __shared__ float2 warps[kWarps][32];
  warps[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && c < C) {
    for (int i = 1; i < kWarps; ++i) {
      acc.x += warps[i][lane].x;
      acc.y += warps[i][lane].y;
    }
    reinterpret_cast<float2*>(sums)[static_cast<size_t>(n) * C + c] = acc;
  }
}

// Pass 3 of the backward: dx = rstd (gamma_c da - (A + x^ B) / L).
__global__ void __launch_bounds__(kThreads)
    GroupNormSiLU_nhwc_bwd_dx_kernel(const float* __restrict__ dy,
                                     const float* __restrict__ x,
                                     const float* __restrict__ gamma,
                                     const float* __restrict__ beta,
                                     const float* __restrict__ mean,
                                     const float* __restrict__ rstd,
                                     const float* __restrict__ coef,
                                     float* __restrict__ dx, int C, int hw,
                                     int ips, int cpg) {
  const Nhwc t = nhwc_of(C, hw, ips, cpg);
  if (!t.active) return;
  const int ng = t.n * (C / cpg) + t.g;
  const float mu = mean[ng], rs = rstd[ng];
  float4 gm, scale, shift;
  nhwc_affine(gamma, beta, t, mu, rs, gm, scale, shift);
  const float2 ab = reinterpret_cast<const float2*>(coef)[ng];
  const float inv_l = 1.f / (static_cast<float>(cpg) * hw);
  const float ka = ab.x * inv_l, kb = ab.y * inv_l;
  const size_t base = static_cast<size_t>(t.n) * hw * C;
  const int step_rows = t.R * kNhwcLoads;
  auto grad = [&](float g, float xv, float s, float sh, float w) {
    const float da = silu_grad(g, fmaf(xv, s, sh));
    return rs * (w * da - fmaf((xv - mu) * rs, kb, ka));
  };
  for (int row0 = t.first; row0 < t.last; row0 += step_rows) {
    float4 xv[kNhwcLoads], gv[kNhwcLoads];
    nhwc_load(x + base, t, C, row0, xv);
    nhwc_load(dy + base, t, C, row0, gv);
#pragma unroll
    for (int u = 0; u < kNhwcLoads; ++u) {
      const int row = nhwc_row(t, row0, u);
      if (row < t.last)
        *reinterpret_cast<float4*>(dx + base + static_cast<size_t>(row) * C +
                                   4 * t.q) =
            make_float4(grad(gv[u].x, xv[u].x, scale.x, shift.x, gm.x),
                        grad(gv[u].y, xv[u].y, scale.y, shift.y, gm.y),
                        grad(gv[u].z, xv[u].z, scale.z, shift.z, gm.z),
                        grad(gv[u].w, xv[u].w, scale.w, shift.w, gm.w));
    }
  }
}

int chunks_of(int hw) { return (hw + kChunk - 1) / kChunk; }

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Whether the NHWC kernels take C channels in groups of cpg: whole float4
// quads a group, a group's lanes a power of two within a warp, a row's
// quads within a block.
bool nhwc_fits(int c, int cpg) {
  const int lanes = cpg / 4;
  return cpg > 0 && c % cpg == 0 && cpg % 4 == 0 && lanes <= 32 &&
         32 % lanes == 0 && c / 4 <= kThreads;
}

// Blocks of the NHWC kernels that the card holds at once: its SMs times
// the fewest blocks of the four streaming kernels that fit one SM (read
// once; every card of a process is taken to be alike).
int nhwc_wave() {
  static int wave = 0;
  if (wave == 0) {
    int dev = 0, sms = 0, fit = kThreads, b = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const void* kernels[] = {
        reinterpret_cast<const void*>(GroupNormSiLU_nhwc_stats_kernel),
        reinterpret_cast<const void*>(GroupNormSiLU_nhwc_fwd_kernel),
        reinterpret_cast<const void*>(GroupNormSiLU_nhwc_bwd_sums_kernel),
        reinterpret_cast<const void*>(GroupNormSiLU_nhwc_bwd_dx_kernel)};
    for (const void* k : kernels) {
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, k, kThreads, 0);
      fit = min(fit, max(b, 1));
    }
    wave = max(sms, 1) * fit;
  }
  return wave;
}

// Slices per image of the NHWC grid, and their steps of rows each (ips):
// one wave of blocks over the n images, no slice empty.
int nhwc_slices(int n, int c, int hw, int* ips) {
  const int step_rows = kThreads / (c / 4) * kNhwcLoads;
  const int steps = (hw + step_rows - 1) / step_rows;
  const int want = max(1, min(steps, (nhwc_wave() + n - 1) / n));
  *ips = (steps + want - 1) / want;
  return (steps + *ips - 1) / *ips;
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

// Slices per image of the NHWC kernels' grid for x (n, hw, c) channels-last
// in groups of cpg channels, or 0 where they do not take that geometry.
// The forward's part holds 3 * n * slices * (c / cpg) floats, the
// backward's 2 * n * slices * c.
int disvae_group_norm_silu_nhwc_slices(int n, int c, int hw, int cpg) {
  if (!nhwc_fits(c, cpg) || n < 1 || n > 65535 || hw < 1) return 0;
  int ips;
  return nhwc_slices(n, c, hw, &ips);
}

// Forward of channels-last x (n, hw, c): y in x's layout, and mean and
// rstd (n, groups).
int disvae_group_norm_silu_nhwc_fwd(const float* x, const float* gamma,
                                    const float* beta, float* part, float* y,
                                    float* mean, float* rstd, int n, int c,
                                    int hw, int cpg, float eps,
                                    cudaStream_t stream) {
  if (!nhwc_fits(c, cpg) || !aligned16(x) || !aligned16(y))
    return static_cast<int>(cudaErrorInvalidValue);
  int ips;
  const int slices = nhwc_slices(n, c, hw, &ips);
  const dim3 grid(slices, n);
  GroupNormSiLU_nhwc_stats_kernel<<<grid, kThreads, 0, stream>>>(
      x, part, c, hw, ips, cpg);
  const int ngroups = n * (c / cpg);
  GroupNormSiLU_nhwc_stats_merge_kernel<<<(32 * ngroups + kThreads - 1) /
                                              kThreads,
                                          kThreads, 0, stream>>>(
      part, mean, rstd, ngroups, c / cpg, slices, eps);
  GroupNormSiLU_nhwc_fwd_kernel<<<grid, kThreads, 0, stream>>>(
      x, gamma, beta, mean, rstd, y, c, hw, ips, cpg);
  return static_cast<int>(cudaGetLastError());
}

// Backward of the NHWC forward: dx in x's layout, dgamma and dbeta (c).
// sums holds 2 * n * c floats, coef 2 * n * groups.
int disvae_group_norm_silu_nhwc_bwd(const float* dy, const float* x,
                                    const float* gamma, const float* beta,
                                    const float* mean, const float* rstd,
                                    float* part, float* sums, float* coef,
                                    float* dx, float* dgamma, float* dbeta,
                                    int n, int c, int hw, int cpg,
                                    cudaStream_t stream) {
  if (!nhwc_fits(c, cpg) || !aligned16(dy) || !aligned16(x) ||
      !aligned16(dx))
    return static_cast<int>(cudaErrorInvalidValue);
  int ips;
  const int slices = nhwc_slices(n, c, hw, &ips);
  const dim3 grid(slices, n);
  GroupNormSiLU_nhwc_bwd_sums_kernel<<<grid, kThreads, 0, stream>>>(
      dy, x, gamma, beta, mean, rstd, part, c, hw, ips, cpg);
  GroupNormSiLU_nhwc_bwd_reduce_kernel<<<dim3((c + 31) / 32, n), kThreads, 0,
                                         stream>>>(part, sums, c, slices);
  const int outputs = c + n * (c / cpg);
  GroupNormSiLU_bwd_params_kernel<<<(outputs + kParamsThreads - 1) /
                                        kParamsThreads,
                                    kParamsThreads, 0, stream>>>(
      sums, gamma, dgamma, dbeta, coef, n, c, 1, cpg);
  GroupNormSiLU_nhwc_bwd_dx_kernel<<<grid, kThreads, 0, stream>>>(
      dy, x, gamma, beta, mean, rstd, coef, dx, c, hw, ips, cpg);
  return static_cast<int>(cudaGetLastError());
}

const char* disvae_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
