// Backward of the decoder's final transposed conv (k4, s2, p1) on Hopper.
//
// Replaces the two Pallas TPU kernels of
// disvae_tpu/ops/pallas_convt_bwd.py, launched there by `convt3_bwd_pl`:
//   K1 `_dw_kernel` (weight gradient) -> convt3_dw_partial_kernel + merge,
//   K2 `_dx_kernel` (input gradient)  -> convt3_dx_kernel.
//
// Layouts are PyTorch's: x (N, Cin, H, W), dy (N, Cout, 2H, 2W) and the
// ConvTranspose2d weight w (Cin, Cout, 4, 4). The forward is
//   y[n, co, 2*iy - 1 + ky, 2*ix - 1 + kx] += x[n, ci, iy, ix] * w[ci, co, ky, kx]
// so, with dy read as zero outside the output,
//   dW[ci, co, ky, kx] = sum_{n, iy, ix} x[n, ci, iy, ix] * dy[n, co, 2iy-1+ky, 2ix-1+kx]
//   dx[n, ci, iy, ix]  = sum_{co, ky, kx} w[ci, co, ky, kx] * dy[n, co, 2iy-1+ky, 2ix-1+kx]
// This is the TPU kernels' aligned polyphase product written per input
// position: the 16 taps of (ky, kx) are the four (du, dv) shifts times the
// four (pi, pj) phases of Q, read straight from dy with bounds masks, so Q
// is never materialized.
//
// Operands are float or bf16 (template T); products and sums are float32,
// as the TPU kernels' preferred_element_type. dW is float32; dx is written
// in T (or float32, to check the sums before their rounding). The weight
// is rounded to T before use (the TPU K2 casts W2 to the contraction dtype
// too).
//
// What bounds them on this card, at the training path's shape (N = 256,
// Cin = 32, H = W = 32, Cout = 3, bf16): both read ~25 MB (x 8.4 M and
// dy 3.1 M elements) for 0.8 GFLOP each, far below the tensor-core ridge,
// so the bound is memory and the FP32 pipe, not the tensor cores. The
// small dimensions (Cout <= 3, 16 taps) leave no tile that fills wgmma.
// What the designs do about it:
//   * K1 stages a chunk of 64 input positions (x for every channel, dy for
//     every tap) in shared memory; each staging thread decodes one
//     position once per chunk, and lanes load consecutive positions. Each
//     compute thread owns a 4-channel x 8-tap register tile of dW, so
//     three shared loads (one float4 pair of taps, four channel values)
//     feed 32 FMAs. Blocks split the N*H*W positions; the TPU grid carried
//     one accumulator across batch blocks, Hopper blocks run in no order,
//     so each block writes its partial dW to scratch and a second kernel
//     sums the partials in a fixed order (warps over interleaved subsets,
//     then the subsets in turn): the result does not change from run to
//     run (no float atomics).
//   * K2 gives each thread one input position and 32 channels: it reads the
//     16 * Cout taps of dy around it once, and the weight (48 x 32 at
//     Cout = 3) sits in shared memory as float4 rows that every lane of a
//     warp reads at the same address (broadcast). Lanes own consecutive
//     ix, so the NCHW dx stores are coalesced.
//
// Plain C interface (loaded with ctypes): each launch returns
// cudaGetLastError() and the wrapper raises on anything but 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kDwThreads = 256;  // threads per K1 block
constexpr int kDwP = 64;         // input positions staged per chunk
constexpr int kStageRows = kDwThreads / kDwP;
static_assert(kDwThreads % kDwP == 0, "staging maps threads to positions");
constexpr int kRc = 4;           // channels per K1 thread tile
constexpr int kRk = 8;           // (co, ky, kx) taps per K1 thread tile
constexpr int kDwBlocksPerSm = 4;
constexpr int kDxThreads = 128;  // threads (input positions) per K2 block
constexpr int kDxC = 32;         // channels per K2 block
constexpr int kMaxCout = 16;
constexpr int kSmemLimit = 227 * 1024;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__host__ __device__ inline int round4(int c) {
  return (c + kRc - 1) / kRc * kRc;
}

// Shared memory of one K1 block, in floats: the staging buffers, later
// reused for the reduction over slices.
int dw_smem_floats(int Cin, int Cout) {
  const int cin4 = round4(Cin);
  const int K = 16 * Cout;
  const int staging = cin4 * kDwP + kDwP * (K + 4);
  const int reduce = cin4 * K;
  return staging > reduce ? staging : reduce;
}

// K1, first pass. Block b reduces input positions
// [b * per_block, (b + 1) * per_block) of the M = N*H*W into
// part[b, ci, k] with k = co * 16 + ky * 4 + kx (the dW layout).
template <typename T>
__global__ void __launch_bounds__(kDwThreads)
convt3_dw_partial_kernel(const T* __restrict__ x,   // (N, Cin, H, W)
                         const T* __restrict__ dy,  // (N, Cout, 2H, 2W)
                         float* __restrict__ part,  // (n_blocks, Cin, 16 Cout)
                         int N, int Cin, int H, int W, int Cout,
                         long long per_block) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int cin4 = round4(Cin);
  const int K = 16 * Cout;
  const int ks = K + 4;           // padded row stride of the staged taps
  float* xs = smem;               // [cin4][kDwP]
  float* ds = smem + cin4 * kDwP; // [kDwP][ks]

  const int n_ct = cin4 / kRc;
  const int n_tiles = n_ct * (K / kRk);
  const int n_slices = kDwThreads / n_tiles;  // >= 1, checked by the host
  const int t = threadIdx.x;
  const int tile = t % n_tiles;
  const int slice = t / n_tiles;  // slice >= n_slices: staging only
  const int c0 = (tile % n_ct) * kRc;
  const int k0 = (tile / n_ct) * kRk;
  const int sp = t % kDwP;
  const int sq = t / kDwP;

  float acc[kRc][kRk];
#pragma unroll
  for (int r = 0; r < kRc; ++r) {
#pragma unroll
    for (int j = 0; j < kRk; ++j) acc[r][j] = 0.f;
  }

  const int HW = H * W;
  const int H2 = 2 * H;
  const int W2 = 2 * W;
  const long long M = static_cast<long long>(N) * HW;
  const long long begin = static_cast<long long>(blockIdx.x) * per_block;
  const long long end = begin + per_block < M ? begin + per_block : M;

  for (long long p0 = begin; p0 < end; p0 += kDwP) {
    const int np = static_cast<int>(end - p0 < kDwP ? end - p0 : kDwP);
    __syncthreads();  // the previous chunk is consumed
    // Each thread stages one position sp of the chunk (decoded once) for
    // rows sq, sq + kStageRows, ...: lanes read consecutive positions.
    const bool valid = sp < np;
    long long n = 0;
    int pos = 0, iy = 0, ix = 0;  // position within the image
    if (valid) {
      const long long g = p0 + sp;
      n = g / HW;
      pos = static_cast<int>(g - n * HW);
      iy = pos / W;
      ix = pos - iy * W;
    }
    const T* xb = x + n * Cin * HW + pos;
    for (int c = sq; c < cin4; c += kStageRows) {
      xs[c * kDwP + sp] = valid && c < Cin ? to_f(xb[c * HW]) : 0.f;
    }
    // the 16 * Cout taps of dy around the position, zero off the output
    const T* db = dy + n * Cout * H2 * W2;
    for (int k = sq; k < K; k += kStageRows) {
      const int oy = 2 * iy - 1 + ((k >> 2) & 3);
      const int ox = 2 * ix - 1 + (k & 3);
      float v = 0.f;
      if (valid && oy >= 0 && oy < H2 && ox >= 0 && ox < W2) {
        v = to_f(db[((k >> 4) * H2 + oy) * W2 + ox]);
      }
      ds[sp * ks + k] = v;
    }
    __syncthreads();
    if (slice < n_slices) {
      for (int p = slice; p < np; p += n_slices) {
        float xv[kRc];
#pragma unroll
        for (int r = 0; r < kRc; ++r) xv[r] = xs[(c0 + r) * kDwP + p];
        const float4 a = *reinterpret_cast<const float4*>(ds + p * ks + k0);
        const float4 b =
            *reinterpret_cast<const float4*>(ds + p * ks + k0 + 4);
        const float dv[kRk] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
        for (int r = 0; r < kRc; ++r) {
#pragma unroll
          for (int j = 0; j < kRk; ++j) {
            acc[r][j] = fmaf(xv[r], dv[j], acc[r][j]);
          }
        }
      }
    }
  }

  // Sum the slices in a fixed order, reusing the staging buffers.
  __syncthreads();
  float* red = smem;  // [cin4][K]
  for (int s = 0; s < n_slices; ++s) {
    if (slice == s) {
#pragma unroll
      for (int r = 0; r < kRc; ++r) {
#pragma unroll
        for (int j = 0; j < kRk; ++j) {
          float* dst = red + (c0 + r) * K + k0 + j;
          *dst = (s == 0 ? 0.f : *dst) + acc[r][j];
        }
      }
    }
    __syncthreads();
  }
  float* out = part + static_cast<long long>(blockIdx.x) * Cin * K;
  for (int e = t; e < Cin * K; e += kDwThreads) out[e] = red[e];
}

// K1, second pass: dW[i] = the sum over blocks of part[b, i]. A block
// owns kMergeCols outputs; its kMergeGroups warps sum interleaved subsets
// of the partials, then one fixed-order pass adds the groups.
constexpr int kMergeCols = 32;
constexpr int kMergeGroups = 8;

__global__ void __launch_bounds__(kMergeCols * kMergeGroups)
convt3_dw_merge_kernel(const float* __restrict__ part,
                       float* __restrict__ dw, int n_blocks, int total) {
  __shared__ float sums[kMergeGroups][kMergeCols];
  const int col = threadIdx.x % kMergeCols;
  const int grp = threadIdx.x / kMergeCols;
  const int i = blockIdx.x * kMergeCols + col;
  float s = 0.f;
  if (i < total) {
    for (int b = grp; b < n_blocks; b += kMergeGroups) {
      s += part[static_cast<long long>(b) * total + i];
    }
  }
  sums[grp][col] = s;
  __syncthreads();
  if (grp == 0 && i < total) {
    float acc = sums[0][col];
#pragma unroll
    for (int g = 1; g < kMergeGroups; ++g) acc += sums[g][col];
    dw[i] = acc;
  }
}

// K2. One thread per input position (n, iy, ix) and kDxC channels
// (blockIdx.y picks the channel group). O is the output type: T on the
// training path, float32 for checking bf16 sums before their rounding.
template <typename T, typename O>
__global__ void __launch_bounds__(kDxThreads)
convt3_dx_kernel(const T* __restrict__ dy,     // (N, Cout, 2H, 2W)
                 const float* __restrict__ w,  // (Cin, Cout, 4, 4)
                 O* __restrict__ dx,           // (N, Cin, H, W)
                 int N, int Cin, int H, int W, int Cout) {
  extern __shared__ float4 ws4[];  // [16 Cout][kDxC / 4]
  float* ws = reinterpret_cast<float*>(ws4);
  const int K = 16 * Cout;
  const int c_base = blockIdx.y * kDxC;
  for (int e = threadIdx.x; e < K * kDxC; e += kDxThreads) {
    const int k = e / kDxC;
    const int ci = c_base + (e - k * kDxC);
    ws[e] = ci < Cin ? to_f(from_f<T>(w[static_cast<long long>(ci) * K + k]))
                     : 0.f;
  }
  __syncthreads();

  const int HW = H * W;
  const long long g =
      static_cast<long long>(blockIdx.x) * kDxThreads + threadIdx.x;
  if (g >= static_cast<long long>(N) * HW) return;
  const long long n = g / HW;
  const int r = static_cast<int>(g - n * HW);
  const int iy = r / W;
  const int ix = r - iy * W;
  const int H2 = 2 * H;
  const int W2 = 2 * W;

  float acc[kDxC];
#pragma unroll
  for (int c = 0; c < kDxC; ++c) acc[c] = 0.f;
  for (int co = 0; co < Cout; ++co) {
    const T* plane = dy + (n * Cout + co) * H2 * W2;
    for (int ky = 0; ky < 4; ++ky) {
      const int oy = 2 * iy - 1 + ky;
      if (oy < 0 || oy >= H2) continue;
      for (int kx = 0; kx < 4; ++kx) {
        const int ox = 2 * ix - 1 + kx;
        if (ox < 0 || ox >= W2) continue;
        const float v = to_f(plane[oy * W2 + ox]);
        const float4* wr = ws4 + (co * 16 + ky * 4 + kx) * (kDxC / 4);
#pragma unroll
        for (int q = 0; q < kDxC / 4; ++q) {
          const float4 w4 = wr[q];
          acc[4 * q] = fmaf(v, w4.x, acc[4 * q]);
          acc[4 * q + 1] = fmaf(v, w4.y, acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(v, w4.z, acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(v, w4.w, acc[4 * q + 3]);
        }
      }
    }
  }
#pragma unroll
  for (int c = 0; c < kDxC; ++c) {
    const int ci = c_base + c;
    if (ci < Cin) dx[(n * Cin + ci) * HW + r] = from_f<O>(acc[c]);
  }
}

template <typename T>
cudaError_t launch_dw(const void* x, const void* dy, float* part, float* dw,
                      int N, int Cin, int H, int W, int Cout, int n_blocks,
                      cudaStream_t st) {
  const int smem = dw_smem_floats(Cin, Cout) * static_cast<int>(sizeof(float));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        convt3_dw_partial_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const long long M = static_cast<long long>(N) * H * W;
  const long long n_chunks = (M + kDwP - 1) / kDwP;
  const long long per_block = (n_chunks + n_blocks - 1) / n_blocks * kDwP;
  convt3_dw_partial_kernel<T><<<n_blocks, kDwThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), part, N, Cin, H, W,
      Cout, per_block);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int total = Cin * 16 * Cout;
  convt3_dw_merge_kernel<<<(total + kMergeCols - 1) / kMergeCols,
                           kMergeCols * kMergeGroups, 0, st>>>(
      part, dw, n_blocks, total);
  return cudaGetLastError();
}

template <typename T, typename O>
cudaError_t launch_dx(const void* dy, const float* w, void* dx, int N,
                      int Cin, int H, int W, int Cout, cudaStream_t st) {
  const long long M = static_cast<long long>(N) * H * W;
  const dim3 grid(static_cast<unsigned>((M + kDxThreads - 1) / kDxThreads),
                  (Cin + kDxC - 1) / kDxC);
  const int smem = 16 * Cout * kDxC * static_cast<int>(sizeof(float));
  convt3_dx_kernel<T, O><<<grid, kDxThreads, smem, st>>>(
      static_cast<const T*>(dy), w, static_cast<O*>(dx), N, Cin, H, W, Cout);
  return cudaGetLastError();
}

bool shape_ok(int N, int Cin, int H, int W, int Cout) {
  if (N < 1 || Cin < 1 || H < 1 || W < 1 || Cout < 1 || Cout > kMaxCout) {
    return false;
  }
  const int n_tiles = round4(Cin) / kRc * (16 * Cout / kRk);
  if (n_tiles > kDwThreads) return false;
  return dw_smem_floats(Cin, Cout) * static_cast<int>(sizeof(float)) <=
         kSmemLimit;
}

}  // namespace

extern "C" {

// Blocks of the K1 first pass (and rows of its scratch): kDwBlocksPerSm on
// every SM, never more than there are 64-position chunks.
int disvae_convt3_dw_n_blocks(int N, int H, int W, int sm_count) {
  const long long M = static_cast<long long>(N) * H * W;
  long long n = (M + kDwP - 1) / kDwP;
  const long long target = static_cast<long long>(kDwBlocksPerSm) * sm_count;
  if (n > target) n = target;
  if (n < 1) n = 1;
  return static_cast<int>(n);
}

// dtype: 0 float32, 1 bfloat16 (x and dy); part: (n_blocks, Cin, 16 Cout)
// float32 scratch; dw: (Cin, Cout, 4, 4) float32.
int disvae_convt3_dw(int dtype, const void* x, const void* dy, float* part,
                     float* dw, int N, int Cin, int H, int W, int Cout,
                     int n_blocks, void* stream) {
  if (!shape_ok(N, Cin, H, W, Cout) || n_blocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return static_cast<int>(launch_dw<float>(x, dy, part, dw, N, Cin, H, W,
                                             Cout, n_blocks, st));
  }
  if (dtype == 1) {
    return static_cast<int>(launch_dw<__nv_bfloat16>(
        x, dy, part, dw, N, Cin, H, W, Cout, n_blocks, st));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// dtype: 0 float32, 1 bfloat16 (dy); out_dtype the same codes for dx,
// either dy's or float32; w: (Cin, Cout, 4, 4) float32.
int disvae_convt3_dx(int dtype, int out_dtype, const void* dy,
                     const float* w, void* dx, int N, int Cin, int H, int W,
                     int Cout, void* stream) {
  if (!shape_ok(N, Cin, H, W, Cout)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && out_dtype == 0) {
    return static_cast<int>(
        launch_dx<float, float>(dy, w, dx, N, Cin, H, W, Cout, st));
  }
  if (dtype == 1 && out_dtype == 1) {
    return static_cast<int>(launch_dx<__nv_bfloat16, __nv_bfloat16>(
        dy, w, dx, N, Cin, H, W, Cout, st));
  }
  if (dtype == 1 && out_dtype == 0) {
    return static_cast<int>(
        launch_dx<__nv_bfloat16, float>(dy, w, dx, N, Cin, H, W, Cout, st));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* disvae_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
