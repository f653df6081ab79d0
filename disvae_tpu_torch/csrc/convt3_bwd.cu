// Backward of the decoder's final transposed conv (k4, s2, p1) on Hopper.
//
// Replaces the two Pallas TPU kernels of
// disvae_tpu/ops/pallas_convt_bwd.py, launched there by `convt3_bwd_pl`:
//   K1 `_dw_kernel` (weight gradient) -> convt3_dw_band_kernel (bf16) or
//      convt3_dw_partial_kernel (float32), then convt3_dw_merge_kernel,
//   K2 `_dx_kernel` (input gradient)  -> convt3_dx_band_kernel (bf16) or
//      convt3_dx_kernel (float32).
// and K4, thin_conv_dw_band_kernel then thin_conv_dw_merge_kernel, the
// weight gradient of the encoder's first conv (below).
//
// Layouts are PyTorch's: x (N, Cin, H, W), dy (N, Cout, 2H, 2W) and the
// ConvTranspose2d weight w (Cin, Cout, 4, 4). The forward is
//   y[n, co, 2*iy - 1 + ky, 2*ix - 1 + kx] += x[n, ci, iy, ix] * w[ci, co, ky, kx]
// so, with dy read as zero outside the output,
//   dW[ci, co, ky, kx] = sum_{n, iy, ix} x[n, ci, iy, ix] * dy[n, co, 2iy-1+ky, 2ix-1+kx]
//   dx[n, ci, iy, ix]  = sum_{co, ky, kx} w[ci, co, ky, kx] * dy[n, co, 2iy-1+ky, 2ix-1+kx]
// This is the TPU kernels' aligned polyphase product: with
//   Q[i, j, (pi, pj, co)] = dy[co, 2i - pi, 2j - pj]   (i in [0, H], j in [0, W])
// and the shift (du, dv) = ((3 - ky) >> 1, (3 - kx) >> 1), phase
// (pi, pj) = ((3 - ky) & 1, (3 - kx) & 1),
//   dW[ci, co, ky, kx] = sum_{n, a, b} x[n, ci, a, b] * Q[n, a + 1 - du, b + 1 - dv, (pi, pj, co)].
//
// Operands are float or bf16; products and sums are float32, as the TPU
// kernels' preferred_element_type. dW is float32; dx is written in the
// operand type (or float32, to check the sums before their rounding). The
// weight is rounded to the operand type before use (the TPU K2 casts W2 to
// the contraction dtype too).
//
// What bounds them on this card, at the training path's shape (N = 256,
// Cin = 32, H = W = 32, Cout = 3, bf16): each moves 23.07 MB (K1 reads x,
// 16.78 MB, and dy, 6.29 MB; K2 reads dy and writes dx), 6.9 us at 3.35
// TB/s, for 0.8 GFLOP, 0.8 us on the bf16 tensor cores: memory-bound, 35
// FLOP per byte against the card's ridge near 295.
//
// K1 in bf16 (the training path's) is built for that bound:
//   * A work unit is a band of R <= 8 rows of x of one image. Persistent
//     blocks, two per SM, walk the bands with a stride of the grid. Each
//     band comes in with 16-byte cp.async copies, double buffered against
//     the compute of the block's previous band: x rows of every channel as
//     they lie (64 B a row at W = 32), and dy rows 2a0 - 1 .. 2a1 of every
//     output channel. Each x element is read from device memory once; dy's
//     halo row pair is read by both bands that share it (1.125x of dy at
//     R = 8).
//   * In shared memory the block rebuilds Q for the band's R + 1 rows,
//     positions as rows and the 4 Cout taps contiguous (a 48 B row at
//     Cout <= 4), zero off the image: each thread turns 9 words of a staged
//     dy row into 8 positions' (pj = 0, pj = 1) tap pairs, one byte
//     permute each. The staged dy rows carry 16 spare bytes so that the
//     lanes of a warp, on different rows, read different banks.
//   * The product runs on mma.sync.m16n8k16 (bf16 in, float32 out), with
//     positions as the contraction: A = x as staged (channels x positions,
//     ldmatrix), B = Q (positions x taps, ldmatrix.trans). A shift moves
//     only B, and by whole 16-byte rows: each lane gives ldmatrix the Q row
//     of its own position, so x never leaves its staged layout. Each of 8
//     warps owns all four shifts (du, dv) (two at Cin > 16 with Cout > 4)
//     and every 8th (4th) 16-position step, so the A fragments of a step
//     serve every shift; its float32 accumulators (64 a lane) live in
//     registers across all of the block's bands.
//   * Blocks run in no order, so each writes its partial dW, and a second
//     kernel, launched as a programmatic dependent so that its launch
//     overlaps the first pass's drain, sums the partials in a fixed order
//     (warps over interleaved subsets, then the subsets in turn): no float
//     atomics, so dW does not change from run to run.
//   Shapes that are not 16-byte aligned (W % 8 != 0) take synchronous
//   element loads into the same layout.
// K2 in bf16 (the training path's) walks the same bands, R <= 8 rows of dx
// of one image, with the same helpers: band_at, stage_dy (dy rows
// 2a0 - 1 .. 2a1 by cp.async, double buffered) and rebuild_q (Q for the
// band's R + 1 rows). It is the same product turned around, a GEMM of the
// band's positions against 16 (Cout <= 4) or 32 taps per shift:
//   * dx^T = sum over the shifts of W2^T[shift] (channels x taps) times Q
//     at the shifted positions (taps x positions), on mma.sync.m16n8k16
//     with the taps as the contraction. A is the bf16-rounded weight,
//     scattered once per block from w into shared memory and loaded with
//     ldmatrix into registers for the launch (4 shifts x 2 m-tiles x 4
//     registers at Cin = 32, Cout <= 4); B is Q read with
//     ldmatrix (non-trans), each lane giving the Q row of its own position
//     moved by the shift, as K1's B. A warp owns a 16-position step and all
//     its channels and shifts, so each dx element is summed by one warp in
//     one fixed order: no atomics, the same bits every launch.
//   * Q's taps 4 Cout .. 16 are zeroed once per launch (the rebuild never
//     writes them; zero weights times stale Inf or NaN would give NaN).
//   * The C fragments hold pairs of adjacent positions of one channel,
//     dx's NCHW order: they go to a (channels, R W) tile in shared memory
//     (pitch an odd multiple of 16 bytes, conflict-free), and a channel's
//     band of R W positions, contiguous in dx, leaves in 16-byte stores
//     (element stores where W % 8 != 0). dx is bf16, or float32 when the
//     caller asks for the sums before their rounding; both take this
//     kernel.
//   Its bound is K1's: the bytes, dy in (6.3 MB, 1.125x with the halo)
//   and dx out (16.8 MB); the product, 1.07 GFLOP with the taps padded
//   to 16, needs about 1 us of the tensor cores. Measured on an H100 (700
//   W) at the path's shape, the loads, the Q rebuild, the product and the
//   stores of three blocks per SM take 7.0, 2.7, 4.9 and 2.7 us of device
//   time one after another rather than overlapped (PERF.md section 5).
// K1 in float32 (never launched by the training path) stages 64 positions
// at a time, a 4-channel x 8-tap register tile per thread on the FP32
// pipe. K2 in float32 (never launched by the training path either) gives
// each thread one input position and 32 channels: it reads the 16 Cout
// taps of dy around it once, and the weight sits in shared memory as
// float4 rows that every lane of a warp reads at the same address; lanes
// own consecutive ix, so the NCHW dx stores are coalesced.
//
// K4 replaces no TPU kernel: it takes the weight gradient of a k4 s2 p1
// conv with few input channels (the encoder's conv1: x (N, C <= 8, H, W),
// dy (N, 32, H/2, W/2), dW (32, C, 4, 4)) off cuDNN's deterministic
// float32 direct wgrad, which took 0.594 ms of the b64 celeba train step's
// 2.07-2.23 ms. That weight gradient is K1's sum with the operands
// swapped:
//   dW_conv[co, ci, ky, kx] = sum_{n, oy, ox} dy[n, co, oy, ox] * x[n, ci, 2oy-1+ky, 2ox-1+kx]
// is K1's dW[ci', co', ky, kx] with the conv's dy as K1's x (ci' = co) and
// its x as K1's dy (co' = ci), and K1's (Cin, Cout, 4, 4) layout is the
// conv's (Cout, Cin, 4, 4). So K4 runs K1's bf16 band code (dw_bands:
// band_at, stage_dy, rebuild_q, the mma.sync loop, the partials and the
// fixed-order merge) under kernels of its own name, which keeps K1's
// executions and K4's apart in a trace. Its bound is K1's at the same
// shapes: 5.77 MB of bf16 operands at b64 celeba, 1.72 us at 3.35 TB/s.
//
// Plain C interface (loaded with ctypes): each launch returns
// cudaGetLastError() and the wrapper raises on anything but 0.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kDwThreads = 256;  // threads per float32 K1 block
constexpr int kDwP = 64;         // input positions staged per chunk
constexpr int kStageRows = kDwThreads / kDwP;
static_assert(kDwThreads % kDwP == 0, "staging maps threads to positions");
constexpr int kRc = 4;           // channels per float32 K1 thread tile
constexpr int kRk = 8;           // (co, ky, kx) taps per float32 K1 thread tile
constexpr int kDwBlocksPerSm = 4;
constexpr int kBandThreads = 256;  // bf16 K1: 8 warps
constexpr int kBandRows = 8;       // x rows per band, at most
constexpr int kBandStages = 2;     // cp.async ring: bands in flight
constexpr int kBandBlocksPerSm = 2;
constexpr int kRun = 8;            // Q positions rebuilt per item
constexpr int kBandMaxCin = 32;    // two m-tiles of 16 channels
constexpr int kBandMaxCout = 8;    // 4 Cout taps in four n-tiles of 8
constexpr int kDxBlocksPerSm = 3;  // bf16 K2 blocks resident per SM
constexpr int kDxThreads = 128;  // float32 K2: threads (positions) a block
constexpr int kDxC = 32;         // float32 K2: channels a block
constexpr int kMaxCout = 16;
constexpr int kSmemLimit = 227 * 1024;

__host__ __device__ inline int round4(int c) {
  return (c + kRc - 1) / kRc * kRc;
}

// Shared memory of one float32 K1 block, in floats: the staging buffers,
// later reused for the reduction over slices.
int dw_smem_floats(int Cin, int Cout) {
  const int cin4 = round4(Cin);
  const int K = 16 * Cout;
  const int staging = cin4 * kDwP + kDwP * (K + 4);
  const int reduce = cin4 * K;
  return staging > reduce ? staging : reduce;
}

// K1 in float32, first pass. Block b reduces input positions
// [b * per_block, (b + 1) * per_block) of the M = N*H*W into
// part[b, ci, k] with k = co * 16 + ky * 4 + kx (the dW layout).
__global__ void __launch_bounds__(kDwThreads)
convt3_dw_partial_kernel(const float* __restrict__ x,   // (N, Cin, H, W)
                         const float* __restrict__ dy,  // (N, Cout, 2H, 2W)
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
    const float* xb = x + n * Cin * HW + pos;
    for (int c = sq; c < cin4; c += kStageRows) {
      xs[c * kDwP + sp] = valid && c < Cin ? xb[c * HW] : 0.f;
    }
    // the 16 * Cout taps of dy around the position, zero off the output
    const float* db = dy + n * Cout * H2 * W2;
    for (int k = sq; k < K; k += kStageRows) {
      const int oy = 2 * iy - 1 + ((k >> 2) & 3);
      const int ox = 2 * ix - 1 + (k & 3);
      float v = 0.f;
      if (valid && oy >= 0 && oy < H2 && ox >= 0 && ox < W2) {
        v = db[((k >> 4) * H2 + oy) * W2 + ox];
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

// ---------------------------------------------------------------------
// K1 in bf16: row bands on the tensor cores (see the header).

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's newest groups of copies are
// still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned addr, unsigned (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned addr,
                                              unsigned (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// c += a (16 x 16, row) * b (16 x 8, col); bf16 in, float32 sums.
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two adjacent float32 sums into K2's dx tile, in its element type.
__device__ __forceinline__ void store_pair(__nv_bfloat16* o, float v0,
                                           float v1) {
  *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
}
__device__ __forceinline__ void store_pair(float* o, float v0, float v1) {
  *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
}

// How the 8 warps of a band block split the product: each warp owns
// kShifts of the four shifts (du, dv) and every kGroups-th 16-position
// step, so its float32 accumulators hold kShifts x MT x NT tiles of
// 16 x 8 (64 per lane).
template <int MT, int NT>
struct BandSplit {
  static constexpr int kShifts = MT * NT <= 4 ? 4 : 2;
  static constexpr int kGroups = kBandThreads / 32 * kShifts / 4;
  static constexpr int kAcc = kShifts * MT * NT * 4;
};

// The band geometry of one launch, in elements unless named bytes.
struct BandGeom {
  int rows;       // x rows per band (R); the last band of an image may be
                  // shorter
  int per_image;  // bands per image, ceil(H / R)
  int mt, nt;     // m-tiles of 16 channels, n-tiles of 8 taps
  int xp;         // staged x: elements per channel (the band's positions
                  // padded to whole 16-position steps, plus 8)
  int tp;         // Q: elements per position (nt * 8 taps, plus 8)
  int smem;       // bytes of shared memory per block
};

// Shared memory of a band of R rows, in bytes. Both kernels hold
// kBandStages dy buffers [Cout][2R + 2][2W + 8] (each rounded up to 16
// bytes, so Q stays 16-byte aligned) and Q [R + 1][W + 1][tp], bf16. K1
// (out_bytes 0) adds kBandStages x buffers [mt * 16][xp], bf16, and the
// sum over its k-step groups reuses it all from the start; K2 adds its dx
// tile [mt * 16][xp] of out_bytes an element and its weight blocks
// [4][mt * 16][tp], bf16. The pitches xp and tp are odd multiples of 16
// bytes in bf16, so the eight 16-byte rows of an ldmatrix fall in
// distinct bank groups, and xp (16k + 8 elements) keeps K2's fragment
// stores to its tile in distinct banks in either output type; the dy
// rows' 16 spare bytes skew the rows that the lanes of a warp read across
// banks.
int band_smem(int R, int W, int Cout, int mt, int nt, int out_bytes,
              int* xp, int* tp) {
  *xp = (R * W + 15) / 16 * 16 + 8;
  *tp = nt * 8 + 8;
  const int dbuf = (Cout * (2 * R + 2) * (2 * W + 8) + 7) / 8 * 8;
  const int dy_q = 2 * (kBandStages * dbuf + (R + 1) * (W + 1) * *tp);
  if (out_bytes > 0) {  // + the A blocks [4][mt * 16][tp], bf16
    return dy_q + mt * 16 * (*xp * out_bytes + 4 * 2 * *tp);
  }
  const int staging = 2 * kBandStages * mt * 16 * *xp + dy_q;
  const int acc = (mt * nt <= 4 ? 4 : 2) * mt * nt * 4;
  const int reduce = kBandThreads * acc * static_cast<int>(sizeof(float));
  return staging > reduce ? staging : reduce;
}

// The tallest band (R <= kBandRows) whose block fits blocks_per_sm on an
// SM, else the tallest that fits one; false when no band fits or the
// channels exceed the tiles. out_bytes as band_smem's: 0 for K1.
bool band_geom(int Cin, int H, int W, int Cout, int out_bytes,
               int blocks_per_sm, BandGeom* g) {
  if (Cin < 1 || Cin > kBandMaxCin || Cout < 1 || Cout > kBandMaxCout ||
      H < 1 || W < 1) {
    return false;
  }
  g->mt = Cin <= 16 ? 1 : 2;
  g->nt = 4 * Cout <= 16 ? 2 : 4;
  const int r_max = H < kBandRows ? H : kBandRows;
  const int budget[2] = {kSmemLimit / blocks_per_sm - 1024, kSmemLimit};
  for (int b : budget) {
    for (int r = r_max; r >= 1; --r) {
      const int smem = band_smem(r, W, Cout, g->mt, g->nt, out_bytes, &g->xp,
                                 &g->tp);
      if (smem <= b) {
        g->rows = r;
        g->per_image = (H + r - 1) / r;
        g->smem = smem;
        return true;
      }
    }
  }
  return false;
}

// A band: x (or dx) rows [a0, a1) of image n.
struct Band {
  int n, a0, a1;
};

__device__ __forceinline__ Band band_at(int band, int per_image, int rows,
                                        int H) {
  Band b;
  b.n = band / per_image;
  b.a0 = (band - b.n * per_image) * rows;
  b.a1 = min(b.a0 + rows, H);
  return b;
}

// Stage the dy rows [2a0 - 1, 2a1] of band b (those on the image) at
// db[co][r - (2a0 - 1)][c]: dr rows of dp elements per channel, 16-byte
// cp.async copies when vec (W % 8 == 0, dy 16-byte aligned), else
// synchronous element loads into the same layout.
__device__ __forceinline__ void stage_dy(const __nv_bfloat16* __restrict__ dy,
                                         __nv_bfloat16* db, const Band& b,
                                         int Cout, int H2, int W2, int dr,
                                         int dp, int vec) {
  const int r_lo = max(2 * b.a0 - 1, 0), r_hi = min(2 * b.a1, H2 - 1);
  const int d_first = r_lo - (2 * b.a0 - 1);  // buffer row of dy row r_lo
  const int d_rows = r_hi - r_lo + 1;
  const __nv_bfloat16* dg =
      dy + (static_cast<long long>(b.n) * Cout * H2 + r_lo) * W2;
  const long long d_plane = static_cast<long long>(H2) * W2;
  if (vec) {
    const int dc = W2 / 8;  // 16-byte chunks per dy row
    for (int e = threadIdx.x; e < Cout * d_rows * dc; e += kBandThreads) {
      const int t = e / dc, c = e - t * dc;
      const int co = t / d_rows, d = t - co * d_rows;
      cp_async16(db + (co * dr + d_first + d) * dp + c * 8,
                 dg + co * d_plane + d * W2 + c * 8);
    }
  } else {
    for (int e = threadIdx.x; e < Cout * d_rows * W2; e += kBandThreads) {
      const int t = e / W2, c = e - t * W2;
      const int co = t / d_rows, d = t - co * d_rows;
      db[(co * dr + d_first + d) * dp + c] = dg[co * d_plane + d * W2 + c];
    }
  }
}

// Q[a0 + il, j, tap] with tap = (pi * Cout + co) * 2 + pj holds
// dy[co, 2(a0 + il) - pi, 2j - pj], zero off the image, for il in
// [0, a1 - a0] and j in [0, W], from band b's staged dy rows db; Q's
// taps 4 Cout .. tp are not written. An item is a run of kRun positions
// of one (il, pi, co) row, the rows fastest across the lanes: it reads
// the staged dy row's 32-bit words j0 - 1 .. j0 + 7 (columns 2k, 2k + 1)
// and writes each position's (pj = 0, pj = 1) pair as one byte permute
// of two of them.
__device__ __forceinline__ void rebuild_q(const __nv_bfloat16* db,
                                          __nv_bfloat16* qs, const Band& b,
                                          int Cout, int H2, int W, int dr,
                                          int dp, int tp) {
  const int n_rows = (b.a1 - b.a0 + 1) * 2 * Cout;
  for (int e = threadIdx.x; e < n_rows * ((W + kRun) / kRun);
       e += kBandThreads) {
    const int run = e / n_rows, row = e - run * n_rows;
    const int j0 = run * kRun;
    const int il = row / (2 * Cout), pc = row - il * 2 * Cout;
    const int pi = pc / Cout, co = pc - pi * Cout;
    const int r = 2 * (b.a0 + il) - pi;
    const unsigned* words = reinterpret_cast<const unsigned*>(
        db + (co * dr + 2 * il - pi + 1) * dp);
    unsigned w[kRun + 1];
#pragma unroll
    for (int i = 0; i <= kRun; ++i) {
      const int k = j0 - 1 + i;
      w[i] = r >= 0 && r < H2 && k >= 0 && k < W ? words[k] : 0u;
    }
    unsigned* dst = reinterpret_cast<unsigned*>(
        qs + (il * (W + 1) + j0) * tp + pc * 2);
#pragma unroll
    for (int i = 0; i < kRun; ++i) {
      if (j0 + i <= W) {
        dst[i * tp / 2] = __byte_perm(w[i + 1], w[i], 0x7610);
      }
    }
  }
}

// K1 in bf16, the body of its band kernel and K4's. Block b takes bands
// b, b + gridDim.x, ... (band = image * per_image + band of rows) and
// writes part[b] in the dW layout (Cin, Cout, 4, 4). MT m-tiles of
// channels, NT n-tiles of taps.
template <int MT, int NT>
__device__ __forceinline__ void dw_bands(
    const __nv_bfloat16* __restrict__ x,   // (N, Cin, H, W)
    const __nv_bfloat16* __restrict__ dy,  // (N, Cout, 2H, 2W)
    float* __restrict__ part,              // (gridDim.x, Cin*Cout*16)
    int N, int Cin, int H, int W, int Cout, int rows, int per_image, int xp,
    int tp, int vec) {
  using bf16 = __nv_bfloat16;
  using Split = BandSplit<MT, NT>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int H2 = 2 * H, W2 = 2 * W;
  const int dr = 2 * rows + 2;          // dy rows staged per band
  const int dp = W2 + 8;                // elements per staged dy row
  const int xbuf = MT * 16 * xp;        // elements of one x buffer
  const int dbuf = (Cout * dr * dp + 7) / 8 * 8;  // one dy buffer, 16 B
  bf16* xs = reinterpret_cast<bf16*>(smem);  // [stages][MT * 16][xp]
  bf16* ds = xs + kBandStages * xbuf;        // [stages][Cout][dr][dp]
  bf16* qs = ds + kBandStages * dbuf;        // [rows + 1][W + 1][tp]
  const int n_bands = N * per_image;

  // Stage band `band` into buffer `buf`: x rows [a0, a1) of every channel
  // at xs[buf][ci][(a - a0) * W + b], dy rows [2a0 - 1, 2a1] (those on the
  // image) at ds[buf][co][r - (2a0 - 1)][c]; then zero x past the band's
  // positions up to the next 16-position step.
  auto load = [&](int band, int buf) {
    const Band bd = band_at(band, per_image, rows, H);
    const int len = (bd.a1 - bd.a0) * W;
    bf16* xb = xs + buf * xbuf;
    const bf16* xg = x + (static_cast<long long>(bd.n) * Cin * H + bd.a0) * W;
    const long long x_plane = static_cast<long long>(H) * W;
    if (vec) {  // 16-byte copies: W % 8 == 0 and both bases aligned
      const int xc = len / 8;
      for (int e = threadIdx.x; e < Cin * xc; e += kBandThreads) {
        const int ci = e / xc, c = e - ci * xc;
        cp_async16(xb + ci * xp + c * 8, xg + ci * x_plane + c * 8);
      }
    } else {
      for (int e = threadIdx.x; e < Cin * len; e += kBandThreads) {
        const int ci = e / len, c = e - ci * len;
        xb[ci * xp + c] = xg[ci * x_plane + c];
      }
    }
    stage_dy(dy, ds + buf * dbuf, bd, Cout, H2, W2, dr, dp, vec);
    const int tail = (len + 15) / 16 * 16 - len;
    for (int e = threadIdx.x; e < Cin * tail; e += kBandThreads) {
      const int ci = e / tail;
      xb[ci * xp + len + (e - ci * tail)] = __float2bfloat16(0.f);
    }
  };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int set = warp / Split::kGroups;  // shifts set * kShifts + sh
  const int grp = warp % Split::kGroups;  // k-step group
  const int mat = lane >> 3, mrow = lane & 7;  // ldmatrix: matrix, row
  float acc[Split::kShifts][MT][NT][4];
#pragma unroll
  for (int sh = 0; sh < Split::kShifts; ++sh) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int t = 0; t < NT; ++t) {
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[sh][m][t][c] = 0.f;
      }
    }
  }

  // a ring of kBandStages buffers, kBandStages - 1 bands ahead
#pragma unroll
  for (int i = 0; i < kBandStages - 1; ++i) {
    const int band = blockIdx.x + i * gridDim.x;
    if (band < n_bands) load(band, i);
    cp_async_commit();
  }
  int buf = 0;
  for (int band = blockIdx.x; band < n_bands; band += gridDim.x) {
    const int ahead = band + (kBandStages - 1) * gridDim.x;
    if (ahead < n_bands) {
      load(ahead, buf == 0 ? kBandStages - 1 : buf - 1);
    }
    cp_async_commit();
    cp_async_wait<kBandStages - 1>();
    __syncthreads();  // this band's x and dy are in shared memory

    const Band bd = band_at(band, per_image, rows, H);
    rebuild_q(ds + buf * dbuf, qs, bd, Cout, H2, W, dr, dp, tp);
    __syncthreads();  // Q is built

    // dk[shift][ci][tap] += sum over the band's positions k = (a, b) of
    // x[ci, k] * Q[a + 1 - du, b + 1 - dv, tap], 16 positions a step.
    const int len = (bd.a1 - bd.a0) * W;
    const int steps = (len + 15) / 16;
    const bf16* xb = xs + buf * xbuf;
    // A (x): matrices (ch 0-7, k 0-7), (ch 8-15, k 0-7), (ch 0-7, k 8-15),
    // (ch 8-15, k 8-15); row = channel, 16 bytes of positions
    const unsigned a_addr =
        smem_addr(xb + (mrow + (mat & 1) * 8) * xp + (mat >> 1) * 8);
    const unsigned q_addr = smem_addr(qs + (mat >> 1) * 8);
    for (int s = grp; s < steps; s += Split::kGroups) {
      const int k0 = s * 16;
      unsigned a[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        ldsm_x4(a_addr + 2 * (m * 16 * xp + k0), a[m]);
      }
      // B (Q): matrices (k 0-7, taps 0-7), (k 8-15, taps 0-7), (k 0-7,
      // taps 8-15), (k 8-15, taps 8-15); row = this lane's position under
      // each shift (positions past the band repeat its last one, against
      // zeros of x)
      const int k = min(k0 + mrow + (mat & 1) * 8, len - 1);
      const int ka = k / W, kb = k - ka * W;
      const int q0 = (ka + 1) * (W + 1) + kb + 1;  // Q row at shift (0, 0)
#pragma unroll
      for (int sh = 0; sh < Split::kShifts; ++sh) {
        const int shift = set * Split::kShifts + sh;
        const int qrow = q0 - (shift >> 1) * (W + 1) - (shift & 1);
#pragma unroll
        for (int t = 0; t < NT / 2; ++t) {
          unsigned b[4];
          ldsm_x4_trans(q_addr + 2 * qrow * tp + 32 * t, b);
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            mma_bf16(acc[sh][m][2 * t], a[m], b[0], b[1]);
            mma_bf16(acc[sh][m][2 * t + 1], a[m], b[2], b[3]);
          }
        }
      }
    }
    __syncthreads();  // before the next load overwrites this band's Q
    buf = buf == kBandStages - 1 ? 0 : buf + 1;
  }
  cp_async_wait<0>();

  // Sum the k-step groups in a fixed order through shared memory, then
  // write the block's partial: accumulator (sh, m, t, c) of a lane holds
  // channel m*16 + lane/4 (+ 8 for c >= 2) and tap t*8 + 2(lane%4) + c%2.
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);  // [warp][kAcc][32]
  {
    float* mine = red + warp * Split::kAcc * 32 + lane;
#pragma unroll
    for (int sh = 0; sh < Split::kShifts; ++sh) {
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int t = 0; t < NT; ++t) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            mine[(((sh * MT + m) * NT + t) * 4 + c) * 32] = acc[sh][m][t][c];
          }
        }
      }
    }
  }
  __syncthreads();
  float* out = part + static_cast<long long>(blockIdx.x) * Cin * Cout * 16;
  constexpr int kSets = 4 / Split::kShifts;
  for (int e = threadIdx.x; e < kSets * Split::kAcc * 32; e += kBandThreads) {
    const int l = e & 31, idx = (e >> 5) % Split::kAcc;
    const int s = (e >> 5) / Split::kAcc;
    float v = 0.f;
    for (int g = 0; g < Split::kGroups; ++g) {
      v += red[((s * Split::kGroups + g) * Split::kAcc + idx) * 32 + l];
    }
    const int c = idx & 3, t = (idx >> 2) % NT, m = (idx >> 2) / NT % MT;
    const int shift = s * Split::kShifts + (idx >> 2) / NT / MT;
    const int ci = m * 16 + (l >> 2) + (c >> 1) * 8;
    const int tap = t * 8 + 2 * (l & 3) + (c & 1);
    const int pc = tap >> 1;
    if (ci < Cin && pc < 2 * Cout) {
      const int pi = pc / Cout, co = pc - pi * Cout;
      const int ky = 3 - 2 * (shift >> 1) - pi;
      const int kx = 3 - 2 * (shift & 1) - (tap & 1);
      out[((ci * Cout + co) * 4 + ky) * 4 + kx] = v;
    }
  }
}

template <int MT, int NT>
__global__ void __launch_bounds__(kBandThreads, kBandBlocksPerSm)
convt3_dw_band_kernel(const __nv_bfloat16* __restrict__ x,
                      const __nv_bfloat16* __restrict__ dy,
                      float* __restrict__ part, int N, int Cin, int H, int W,
                      int Cout, int rows, int per_image, int xp, int tp,
                      int vec) {
  dw_bands<MT, NT>(x, dy, part, N, Cin, H, W, Cout, rows, per_image, xp, tp,
                   vec);
}

// K4: the same bands under a name of its own, launched with the conv's dy
// in x's place and its x in dy's (see the header), so that a trace tells
// K4's executions from K1's.
template <int MT, int NT>
__global__ void __launch_bounds__(kBandThreads, kBandBlocksPerSm)
thin_conv_dw_band_kernel(const __nv_bfloat16* __restrict__ x,
                         const __nv_bfloat16* __restrict__ dy,
                         float* __restrict__ part, int N, int Cin, int H,
                         int W, int Cout, int rows, int per_image, int xp,
                         int tp, int vec) {
  dw_bands<MT, NT>(x, dy, part, N, Cin, H, W, Cout, rows, per_image, xp, tp,
                   vec);
}

// K1's and K4's second pass: dW[i] = the sum over blocks of part[b, i]. A
// block owns kMergeCols outputs; its kMergeGroups warps sum interleaved
// subsets of the partials, then one fixed-order pass adds the groups.
constexpr int kMergeCols = 32;
constexpr int kMergeGroups = 32;

__device__ __forceinline__ void merge_partials(const float* __restrict__ part,
                                               float* __restrict__ dw,
                                               int n_blocks, int total) {
  __shared__ float sums[kMergeGroups][kMergeCols];
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
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

__global__ void __launch_bounds__(kMergeCols * kMergeGroups)
convt3_dw_merge_kernel(const float* __restrict__ part,
                       float* __restrict__ dw, int n_blocks, int total) {
  merge_partials(part, dw, n_blocks, total);
}

__global__ void __launch_bounds__(kMergeCols * kMergeGroups)
thin_conv_dw_merge_kernel(const float* __restrict__ part,
                          float* __restrict__ dw, int n_blocks, int total) {
  merge_partials(part, dw, n_blocks, total);
}

// K2 in bf16. Block b takes bands b, b + gridDim.x, ... as K1 does and
// writes each band's dx rows of every channel. MT m-tiles of 16
// channels, KT k-steps of 16 taps; O is the output type (bf16 on the
// training path, float32 for checking the sums before their rounding).
template <int MT, int KT, typename O>
__global__ void __launch_bounds__(kBandThreads, KT == 1 ? kDxBlocksPerSm : 2)
convt3_dx_band_kernel(const __nv_bfloat16* __restrict__ dy,  // (N, Cout, 2H, 2W)
                      const float* __restrict__ w,  // (Cin, Cout, 4, 4)
                      O* __restrict__ dx,           // (N, Cin, H, W)
                      int N, int Cin, int H, int W, int Cout, int rows,
                      int per_image, int xp, int tp, int vec) {
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem[];
  const int H2 = 2 * H, W2 = 2 * W;
  const int dr = 2 * rows + 2;          // dy rows staged per band
  const int dp = W2 + 8;                // elements per staged dy row
  const int dbuf = (Cout * dr * dp + 7) / 8 * 8;  // one dy buffer, 16 B
  bf16* ds = reinterpret_cast<bf16*>(smem);  // [stages][Cout][dr][dp]
  bf16* qs = ds + kBandStages * dbuf;        // [rows + 1][W + 1][tp]
  O* os = reinterpret_cast<O*>(qs + (rows + 1) * (W + 1) * tp);  // [MT*16][xp]
  constexpr int kAp = KT * 16 + 8;  // A row pitch, the host's tp
  bf16* as = reinterpret_cast<bf16*>(os + MT * 16 * xp);  // [4][MT*16][kAp]
  const int n_bands = N * per_image;

  // a ring of kBandStages dy buffers, kBandStages - 1 bands ahead
#pragma unroll
  for (int i = 0; i < kBandStages - 1; ++i) {
    const int band = blockIdx.x + i * gridDim.x;
    if (band < n_bands) {
      stage_dy(dy, ds + i * dbuf, band_at(band, per_image, rows, H), Cout,
               H2, W2, dr, dp, vec);
    }
    cp_async_commit();
  }
  // While they fly: zero Q's taps 4 Cout .. 16 KT, which the rebuild never
  // writes and the product contracts over (against zero weights: stale
  // Inf or NaN there would make NaN), once for the launch ...
  const int pad = KT * 16 - 4 * Cout;
  for (int e = threadIdx.x; e < (rows + 1) * (W + 1) * pad;
       e += kBandThreads) {
    const int q = e / pad;
    qs[q * tp + 4 * Cout + (e - q * pad)] = __float2bfloat16(0.f);
  }
  // ... and build A = W2^T[shift] in shared memory, bf16-rounded and zero
  // past Cin channels and 4 Cout taps, where W2^T[(du, dv)][ci][(pi * Cout
  // + co) * 2 + pj] = w[ci, co, 3 - 2du - pi, 3 - 2dv - pj]: zeros, then w
  // read once in order and scattered (built per lane in registers, it cost
  // each block 64 scattered loads a thread)
  for (int e = threadIdx.x; e < 4 * MT * 16 * kAp / 2; e += kBandThreads) {
    reinterpret_cast<unsigned*>(as)[e] = 0u;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < Cin * Cout * 16; e += kBandThreads) {
    const int ci = (e >> 4) / Cout, co = (e >> 4) - ci * Cout;
    const int ry = 3 - ((e >> 2) & 3), rx = 3 - (e & 3);  // 2du + pi, 2dv + pj
    const int sh = (ry >> 1) * 2 + (rx >> 1);
    as[(sh * MT * 16 + ci) * kAp + ((ry & 1) * Cout + co) * 2 + (rx & 1)] =
        __float2bfloat16(w[e]);
  }
  __syncthreads();
  // a[sh][m][ks]: the m16n8k16 A fragment of channels m*16 .. m*16 + 15
  // and taps ks*16 .. ks*16 + 15, kept in registers for the launch.
  // ldmatrix matrices (ch 0-7, taps 0-7), (ch 8-15, taps 0-7), (ch 0-7,
  // taps 8-15), (ch 8-15, taps 8-15); row = channel, 16 bytes of taps
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int mat = lane >> 3, mrow = lane & 7;  // ldmatrix: matrix, row
  unsigned a[4][MT][KT][4];
  {
    const unsigned a_addr =
        smem_addr(as + (mrow + (mat & 1) * 8) * kAp + (mat >> 1) * 8);
#pragma unroll
    for (int sh = 0; sh < 4; ++sh) {
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int ks = 0; ks < KT; ++ks) {
          ldsm_x4(a_addr + 2 * ((sh * MT * 16 + m * 16) * kAp + ks * 16),
                  a[sh][m][ks]);
        }
      }
    }
  }

  // B (Q): matrices (positions 0-7, taps 0-7), (0-7, taps 8-15), (8-15,
  // 0-7), (8-15, 8-15) of a 16-position step: the b0, b1 of its two
  // n-tiles of 8 positions
  const unsigned q_addr = smem_addr(qs + (mat & 1) * 8);
  const long long plane = static_cast<long long>(H) * W;
  int buf = 0;
  for (int band = blockIdx.x; band < n_bands; band += gridDim.x) {
    const int ahead = band + (kBandStages - 1) * gridDim.x;
    if (ahead < n_bands) {
      stage_dy(dy, ds + (buf == 0 ? kBandStages - 1 : buf - 1) * dbuf,
               band_at(ahead, per_image, rows, H), Cout, H2, W2, dr, dp,
               vec);
    }
    cp_async_commit();
    cp_async_wait<kBandStages - 1>();
    __syncthreads();  // this band's dy is in shared memory; the previous
                      // band's dx tile is stored
    const Band bd = band_at(band, per_image, rows, H);
    rebuild_q(ds + buf * dbuf, qs, bd, Cout, H2, W, dr, dp, tp);
    __syncthreads();  // Q is built

    // dx^T[ci][k] = sum over the shifts (du, dv) and taps of
    // W2^T[shift][ci][tap] * Q[a + 1 - du, b + 1 - dv, tap] for the band's
    // positions k = (a, b), 16 a step, each step one warp's: every dx
    // element is summed by one warp in one order (no atomics).
    const int len = (bd.a1 - bd.a0) * W;
    const int steps = (len + 15) / 16;
    for (int s = warp; s < steps; s += kBandThreads / 32) {
      const int k0 = s * 16;
      // this lane's ldmatrix row: its position (positions past the band
      // repeat its last one; their sums are not stored)
      const int k = min(k0 + mrow + (mat >> 1) * 8, len - 1);
      const int ka = k / W, kb = k - ka * W;
      const int q0 = (ka + 1) * (W + 1) + kb + 1;  // Q row at shift (0, 0)
      float acc[MT][2][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int t = 0; t < 2; ++t) {
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[m][t][i] = 0.f;
        }
      }
#pragma unroll
      for (int sh = 0; sh < 4; ++sh) {
        const int qrow = q0 - (sh >> 1) * (W + 1) - (sh & 1);
#pragma unroll
        for (int ks = 0; ks < KT; ++ks) {
          unsigned bq[4];
          ldsm_x4(q_addr + 2 * (qrow * tp + ks * 16), bq);
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            mma_bf16(acc[m][0], a[sh][m][ks], bq[0], bq[1]);
            mma_bf16(acc[m][1], a[sh][m][ks], bq[2], bq[3]);
          }
        }
      }
      // C: acc[m][t] holds channels m*16 + g (0, 1) and + 8 (2, 3) at
      // positions k0 + t*8 + 2c, + 1: adjacent positions of one channel,
      // dx's NCHW order
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          O* o = os + (m * 16 + g) * xp + k0 + t * 8 + 2 * c;
          store_pair(o, acc[m][t][0], acc[m][t][1]);
          store_pair(o + 8 * xp, acc[m][t][2], acc[m][t][3]);
        }
      }
    }
    __syncthreads();  // the band's dx tile is complete

    // dx rows a0 .. a1 - 1 of channel ci are contiguous in NCHW: len
    // elements from dx[n, ci, a0, 0]
    O* out = dx + (static_cast<long long>(bd.n) * Cin * H + bd.a0) * W;
    if (vec) {  // 16-byte stores: W % 8 == 0 and dx 16-byte aligned
      constexpr int kPer = 16 / static_cast<int>(sizeof(O));
      const int chunks = len / kPer;
      for (int e = threadIdx.x; e < Cin * chunks; e += kBandThreads) {
        const int ci = e / chunks, q = e - ci * chunks;
        *reinterpret_cast<uint4*>(out + ci * plane + q * kPer) =
            *reinterpret_cast<const uint4*>(os + ci * xp + q * kPer);
      }
    } else {
      for (int e = threadIdx.x; e < Cin * len; e += kBandThreads) {
        const int ci = e / len, q = e - ci * len;
        out[ci * plane + q] = os[ci * xp + q];
      }
    }
    buf = buf == kBandStages - 1 ? 0 : buf + 1;
  }
  cp_async_wait<0>();
}

// K2 in float32 (never launched by the training path). One thread per
// input position (n, iy, ix) and kDxC channels (blockIdx.y picks the
// channel group).
__global__ void __launch_bounds__(kDxThreads)
convt3_dx_kernel(const float* __restrict__ dy,  // (N, Cout, 2H, 2W)
                 const float* __restrict__ w,   // (Cin, Cout, 4, 4)
                 float* __restrict__ dx,        // (N, Cin, H, W)
                 int N, int Cin, int H, int W, int Cout) {
  extern __shared__ float4 ws4[];  // [16 Cout][kDxC / 4]
  float* ws = reinterpret_cast<float*>(ws4);
  const int K = 16 * Cout;
  const int c_base = blockIdx.y * kDxC;
  for (int e = threadIdx.x; e < K * kDxC; e += kDxThreads) {
    const int k = e / kDxC;
    const int ci = c_base + (e - k * kDxC);
    ws[e] = ci < Cin ? w[static_cast<long long>(ci) * K + k] : 0.f;
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
    const float* plane = dy + (n * Cout + co) * H2 * W2;
    for (int ky = 0; ky < 4; ++ky) {
      const int oy = 2 * iy - 1 + ky;
      if (oy < 0 || oy >= H2) continue;
      for (int kx = 0; kx < 4; ++kx) {
        const int ox = 2 * ix - 1 + kx;
        if (ox < 0 || ox >= W2) continue;
        const float v = plane[oy * W2 + ox];
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
    if (ci < Cin) dx[(n * Cin + ci) * HW + r] = acc[c];
  }
}

// The merge (K4's when thin) is launched as a programmatic dependent of
// the first pass: its blocks may be scheduled while the first pass drains,
// and wait (griddepcontrol.wait) until its partials are complete and
// visible.
cudaError_t launch_merge(const float* part, float* dw, int n_blocks,
                         int total, cudaStream_t st, bool thin = false) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((total + kMergeCols - 1) / kMergeCols);
  cfg.blockDim = dim3(kMergeCols * kMergeGroups);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(
      &cfg, thin ? thin_conv_dw_merge_kernel : convt3_dw_merge_kernel, part,
      dw, n_blocks, total);
}

cudaError_t launch_dw_f32(const float* x, const float* dy, float* part,
                          float* dw, int N, int Cin, int H, int W, int Cout,
                          int n_blocks, cudaStream_t st) {
  const int smem = dw_smem_floats(Cin, Cout) * static_cast<int>(sizeof(float));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        convt3_dw_partial_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const long long M = static_cast<long long>(N) * H * W;
  const long long n_chunks = (M + kDwP - 1) / kDwP;
  const long long per_block = (n_chunks + n_blocks - 1) / n_blocks * kDwP;
  convt3_dw_partial_kernel<<<n_blocks, kDwThreads, smem, st>>>(
      x, dy, part, N, Cin, H, W, Cout, per_block);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_merge(part, dw, n_blocks, Cin * 16 * Cout, st);
}

using BandKernel = void (*)(const __nv_bfloat16*, const __nv_bfloat16*,
                            float*, int, int, int, int, int, int, int, int,
                            int, int);

// K1's band kernel at geometry g, or K4's when thin.
BandKernel band_kernel(const BandGeom& g, bool thin) {
  if (thin) {
    if (g.mt == 1) {
      return g.nt == 2 ? thin_conv_dw_band_kernel<1, 2>
                       : thin_conv_dw_band_kernel<1, 4>;
    }
    return g.nt == 2 ? thin_conv_dw_band_kernel<2, 2>
                     : thin_conv_dw_band_kernel<2, 4>;
  }
  if (g.mt == 1) {
    return g.nt == 2 ? convt3_dw_band_kernel<1, 2> : convt3_dw_band_kernel<1, 4>;
  }
  return g.nt == 2 ? convt3_dw_band_kernel<2, 2> : convt3_dw_band_kernel<2, 4>;
}

template <typename O>
using DxBandKernel = void (*)(const __nv_bfloat16*, const float*, O*, int,
                              int, int, int, int, int, int, int, int, int);

template <typename O>
DxBandKernel<O> dx_band_kernel(const BandGeom& g) {
  if (g.mt == 1) {
    return g.nt == 2 ? convt3_dx_band_kernel<1, 1, O>
                     : convt3_dx_band_kernel<1, 2, O>;
  }
  return g.nt == 2 ? convt3_dx_band_kernel<2, 1, O>
                   : convt3_dx_band_kernel<2, 2, O>;
}

// Blocks of a band kernel at geometry g: as many as are resident at once,
// never more than there are bands; 0 if it cannot run there.
int resident_blocks(const void* kern, const BandGeom& g, int N,
                    int sm_count) {
  if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           g.smem) != cudaSuccess) {
    return 0;
  }
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                    kBandThreads,
                                                    g.smem) != cudaSuccess ||
      per_sm < 1) {
    return 0;
  }
  const long long n_bands = static_cast<long long>(N) * g.per_image;
  const long long target = static_cast<long long>(per_sm) * sm_count;
  return static_cast<int>(n_bands < target ? n_bands : target);
}

// Blocks of the bf16 K1 (K4 when thin), or of the bf16 K2 with dx of
// out_bytes an element; 0 if the shape does not fit the band geometry.
int band_blocks(int N, int Cin, int H, int W, int Cout, int sm_count,
                bool thin) {
  BandGeom g;
  if (!band_geom(Cin, H, W, Cout, 0, kBandBlocksPerSm, &g)) return 0;
  return resident_blocks(reinterpret_cast<const void*>(band_kernel(g, thin)),
                         g, N, sm_count);
}

template <typename O>
int dx_band_blocks(int N, int Cin, int H, int W, int Cout, int sm_count) {
  BandGeom g;
  if (!band_geom(Cin, H, W, Cout, sizeof(O), kDxBlocksPerSm, &g)) return 0;
  return resident_blocks(reinterpret_cast<const void*>(dx_band_kernel<O>(g)),
                         g, N, sm_count);
}

template <typename O>
cudaError_t launch_dx_bf16(const __nv_bfloat16* dy, const float* w, O* dx,
                           int N, int Cin, int H, int W, int Cout,
                           int n_blocks, cudaStream_t st) {
  BandGeom g;
  if (n_blocks < 1 ||
      !band_geom(Cin, H, W, Cout, sizeof(O), kDxBlocksPerSm, &g)) {
    return cudaErrorInvalidValue;
  }
  DxBandKernel<O> kern = dx_band_kernel<O>(g);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
  if (err != cudaSuccess) return err;
  const int vec = W % 8 == 0 && reinterpret_cast<uintptr_t>(dy) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(dx) % 16 == 0;
  kern<<<n_blocks, kBandThreads, g.smem, st>>>(dy, w, dx, N, Cin, H, W, Cout,
                                               g.rows, g.per_image, g.xp,
                                               g.tp, vec);
  return cudaGetLastError();
}

// The bf16 K1, or K4 on its own kernels when thin.
cudaError_t launch_dw_bf16(const __nv_bfloat16* x, const __nv_bfloat16* dy,
                           float* part, float* dw, int N, int Cin, int H,
                           int W, int Cout, int n_blocks, cudaStream_t st,
                           bool thin) {
  BandGeom g;
  if (!band_geom(Cin, H, W, Cout, 0, kBandBlocksPerSm, &g)) {
    return cudaErrorInvalidValue;
  }
  BandKernel kern = band_kernel(g, thin);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
  if (err != cudaSuccess) return err;
  const int vec = W % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(dy) % 16 == 0;
  kern<<<n_blocks, kBandThreads, g.smem, st>>>(x, dy, part, N, Cin, H, W,
                                               Cout, g.rows, g.per_image,
                                               g.xp, g.tp, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_merge(part, dw, n_blocks, Cin * 16 * Cout, st, thin);
}

cudaError_t launch_dx_f32(const float* dy, const float* w, float* dx, int N,
                          int Cin, int H, int W, int Cout, cudaStream_t st) {
  const long long M = static_cast<long long>(N) * H * W;
  const dim3 grid(static_cast<unsigned>((M + kDxThreads - 1) / kDxThreads),
                  (Cin + kDxC - 1) / kDxC);
  const int smem = 16 * Cout * kDxC * static_cast<int>(sizeof(float));
  convt3_dx_kernel<<<grid, kDxThreads, smem, st>>>(dy, w, dx, N, Cin, H, W,
                                                  Cout);
  return cudaGetLastError();
}

// For the tests: every word of the block's shared memory set to all ones
// (bf16 and float32 NaN), so that a kernel launched next on the SM finds
// NaN wherever it reads shared memory it did not write.
__global__ void poison_smem_kernel(int words) {
  extern __shared__ unsigned poison[];
  volatile unsigned* p = poison;
  for (int i = threadIdx.x; i < words; i += blockDim.x) p[i] = 0xffffffffu;
}

// The float32 K1's and K2's limits (the bf16 kernels have band_geom's).
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

// Blocks of the K1 first pass (and rows of its scratch) for dtype 0
// (float32: kDwBlocksPerSm on every SM, never more than there are
// 64-position chunks) or 1 (bf16: the resident band blocks). 0 if the
// shape exceeds the launch geometry.
int disvae_convt3_dw_n_blocks(int dtype, int N, int Cin, int H, int W,
                              int Cout, int sm_count) {
  if (N < 1 || sm_count < 1) return 0;
  if (dtype == 1) return band_blocks(N, Cin, H, W, Cout, sm_count, false);
  if (dtype != 0 || !shape_ok(N, Cin, H, W, Cout)) return 0;
  const long long M = static_cast<long long>(N) * H * W;
  long long n = (M + kDwP - 1) / kDwP;
  const long long target = static_cast<long long>(kDwBlocksPerSm) * sm_count;
  if (n > target) n = target;
  return static_cast<int>(n);
}

// dtype: 0 float32, 1 bfloat16 (x and dy); part: (n_blocks, Cin, 16 Cout)
// float32 scratch; dw: (Cin, Cout, 4, 4) float32.
int disvae_convt3_dw(int dtype, const void* x, const void* dy, float* part,
                     float* dw, int N, int Cin, int H, int W, int Cout,
                     int n_blocks, void* stream) {
  if (n_blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && shape_ok(N, Cin, H, W, Cout)) {
    return static_cast<int>(launch_dw_f32(
        static_cast<const float*>(x), static_cast<const float*>(dy), part, dw,
        N, Cin, H, W, Cout, n_blocks, st));
  }
  if (dtype == 1) {
    return static_cast<int>(launch_dw_bf16(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(dy), part, dw, N, Cin, H, W, Cout,
        n_blocks, st, false));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// K4 takes K1's arguments in K1's roles: x is the conv's dy (N, Cout, H/2,
// W/2), dy the conv's x (N, Cin, H, W), so Cin here is the conv's Cout and
// Cout its Cin, and dw (Cin, Cout, 4, 4) is the conv's (Cout, Cin, 4, 4).
// dtype must be 1 (bf16). Blocks of its first pass (rows of its scratch);
// 0 if the shape exceeds the band geometry.
int disvae_thin_conv_dw_n_blocks(int dtype, int N, int Cin, int H, int W,
                                 int Cout, int sm_count) {
  if (dtype != 1 || N < 1 || sm_count < 1) return 0;
  return band_blocks(N, Cin, H, W, Cout, sm_count, true);
}

int disvae_thin_conv_dw(int dtype, const void* x, const void* dy,
                        float* part, float* dw, int N, int Cin, int H, int W,
                        int Cout, int n_blocks, void* stream) {
  if (dtype != 1 || n_blocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(launch_dw_bf16(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(dy), part, dw, N, Cin, H, W, Cout,
      n_blocks, static_cast<cudaStream_t>(stream), true));
}

// Blocks of the bf16 K2 (the resident band blocks) with dx in out_dtype
// (0 float32, 1 bfloat16); 0 if the shape exceeds its band geometry.
int disvae_convt3_dx_n_blocks(int out_dtype, int N, int Cin, int H, int W,
                              int Cout, int sm_count) {
  if (N < 1 || sm_count < 1) return 0;
  if (out_dtype == 1) {
    return dx_band_blocks<__nv_bfloat16>(N, Cin, H, W, Cout, sm_count);
  }
  if (out_dtype == 0) return dx_band_blocks<float>(N, Cin, H, W, Cout, sm_count);
  return 0;
}

// dtype: 0 float32, 1 bfloat16 (dy); out_dtype the same codes for dx,
// either dy's or float32; w: (Cin, Cout, 4, 4) float32. n_blocks: the bf16
// kernel's, from disvae_convt3_dx_n_blocks (the float32 kernel ignores it).
int disvae_convt3_dx(int dtype, int out_dtype, const void* dy,
                     const float* w, void* dx, int N, int Cin, int H, int W,
                     int Cout, int n_blocks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* dyb = static_cast<const __nv_bfloat16*>(dy);
  if (dtype == 0 && out_dtype == 0 && shape_ok(N, Cin, H, W, Cout)) {
    return static_cast<int>(launch_dx_f32(static_cast<const float*>(dy), w,
                                          static_cast<float*>(dx), N, Cin, H,
                                          W, Cout, st));
  }
  if (dtype == 1 && out_dtype == 1) {
    return static_cast<int>(launch_dx_bf16(
        dyb, w, static_cast<__nv_bfloat16*>(dx), N, Cin, H, W, Cout,
        n_blocks, st));
  }
  if (dtype == 1 && out_dtype == 0) {
    return static_cast<int>(launch_dx_bf16(dyb, w, static_cast<float*>(dx), N,
                                           Cin, H, W, Cout, n_blocks, st));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Two blocks per SM of poison_smem_kernel, each holding all the shared
// memory a block may have (so one at a time per SM).
int disvae_poison_smem(int sm_count, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      poison_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemLimit);
  if (err != cudaSuccess) return static_cast<int>(err);
  poison_smem_kernel<<<2 * sm_count, 1024, kSmemLimit,
                       static_cast<cudaStream_t>(stream)>>>(kSmemLimit / 4);
  return static_cast<int>(cudaGetLastError());
}

const char* disvae_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
