// The fused 7x7 encoder stem on Hopper (sm_90a), forward and backward:
// pad 3 (reflect / replicate / zero) -> 7x7 stride-1 conv 3 -> C plus bias
// -> optional instance norm -> optional ReLU.
//
// Replaces the Pallas TPU kernel of dwcgan_tpu/ops/pallas/stem_kernels.py:
//   stem_conv7 forward  (_pack, _stem_fwd_kernel via _conv_stats)  -> dwc_stem_conv7
//   stem_conv7 backward (_stem_bwd_kernel, _unpad_grad)            -> dwc_stem_conv7_bwd
//
// What bounds it.  At [32,128,128,3] -> C 64 in bf16 the forward must read
// the image (3.1 MB) and write y (67 MB): about 21 us at the data-sheet
// 3.35 TB/s.  Its arithmetic, 2 * 147 * 64 flops per output pixel, is
// 9.9 GFLOP: 10 us on the bf16 tensor cores, but about 150 us for the fp32
// FMA units (67 TFLOP/s).  With the instance norm it computes the conv
// twice (moments, then apply), three times for "2pass"; the backward
// recomputes the conv once or twice more and does the dW and dX
// contractions, each as large as the conv.  So fp32, on the FMA units, is
// bound by operations; bf16, on the tensor cores, by bytes only if the
// shared-memory traffic that feeds them keeps up.
//
// In bf16 the conv tile and the backward's two contractions run on the
// tensor cores (`mma.sync.m16n8k16` bf16 x bf16 -> fp32, operands by 32-bit
// loads or `ldmatrix`): bf16 products are exact in fp32, so they compute
// what the FMA loops do, summed in another order.  All three are bound by
// shared-memory loads and their latency, not by the tensor cores, so each
// design counts shared loads per product:
//   the conv tile (`stem_tile_mma_kernel`, every pass): an implicit GEMM
//     with M = the tile's 256 pixels, N = C, K = 168 (taps in slots of 8
//     per (ci, dr), dc = 7 zero), the bias the accumulator's start.  An A
//     register is two neighbouring halo columns of one row, from a bf16
//     halo staged twice (the second copy shifted by one column: every
//     register one aligned 32-bit load, as in dW below); B the weights,
//     staged [c][k] per block from the packed fp32 rows and read by
//     `ldmatrix`.  A warp owns one tile row (two m16 tiles) x all C: per 16
//     products, 8 loads of A and 4 ldmatrix.x4 of B.  The epilogue works in
//     the fragment layout; per-tile partial sums go over the lanes by
//     shuffles and over the warps in order through shared memory.
//   dW (`stem_dw_mma_kernel`): dw[tap][c] = sum over pixels of
//     x_patch[pixel][tap] * gc[pixel][c], a GEMM with M = 160 taps (147, the
//     ones tap for db, 12 zero), N = C, K = pixels 16 at a time.  gc is
//     staged [pixel][channel] (row stride round16(C) + 8 bf16, so the 8 rows
//     of an ldmatrix fall on 8 different bank groups) and read transposed
//     as B by `ldmatrix.trans`; A is the im2col of the bf16 halo taken by
//     index: the two K-consecutive values of an A register are two
//     neighbouring halo columns of one tap, which start at an odd column for
//     odd dc, so the halo is staged twice, the second copy shifted by one
//     column, and each register is one aligned 32-bit load.  A warp owns 32
//     taps x all C: per 16 pixels, 8 loads of A and C / 16 ldmatrix.x4 of B
//     feed 2 * C / 8 products.  Two buffers: while a chunk multiplies, the
//     next chunk's gc (cp.async) and x halo (registers) are in flight; the
//     wrapper gives 4 blocks per SM, two full waves of the 2 that fit.
//     Partials and the ordered reduce as before.
//   dX (`stem_dxp_mma_kernel`): dxp[pixel][ci] = sum over (tap, c) of
//     gc[pixel - tap][c] * w[tap][ci][c], an implicit GEMM with M = padded
//     pixels (16 columns of one row per tile), N = 8 (ci 0..2, 5 zero
//     columns: still over ten times the FMA rate), K = 49 taps x C, 16
//     channels of the gc halo per stage.  A is the gc window shifted by the
//     tap, by `ldmatrix` from a [pixel][16 + 8] halo; B the bf16 weights.  A
//     warp owns 8 padded rows x 16 columns: one A fragment of halo row j
//     serves every (row, dr) with row - dr = j, so 14 ldmatrix.x4 feed 56
//     products per column tap, and the 7 row taps' B sit in registers.  Each
//     stage issues all its loads at once (the halo by cp.async, the weights
//     into registers) and waits once.  Not col2im (gc x W into [pixel][147],
//     then a scatter-add): that needs an intermediate 49 times dX's size and
//     a shared-memory scatter, where the implicit GEMM writes each dxp value
//     once from registers.
// The fp32 path keeps the FMA kernels (`stem_tile_kernel`, `stem_dw_kernel`,
// `stem_dxp_kernel`): bf16 operands would lose the fp32 checks' 1e-4, and
// TF32 keeps about three digits.
//
// Design.  No padded copy of the image exists: every halo load maps its
// padded coordinate back onto the image (reflect, replicate, or zero).  A
// block owns an output tile of 8 rows x 32 columns of one sample and all C
// channels (C a multiple of 8, at most 64).  The fp32 tile (`conv_tile`):
// one warp per group of 8 channels, one lane per column, each thread 8 rows
// x 8 channels of fp32 accumulators.  The 3 x 14 x 38 halo and the packed
// [148][C] weights (the bias as row 147, every value already rounded to the
// compute dtype by the wrapper) sit in shared memory; for one (input
// channel, column tap) a
// thread loads 14 halo values once and reuses them for the 7 row taps, and
// each weight load is a broadcast.  Every pass computes the conv tile with
// the same code in the same order, so its fp32 values are the same each
// time: the instance norm works on the un-rounded fp32 accumulator, as the
// Pallas kernel's does, and only the normalised output is written:
//   forward, norm none: conv + bias (+ ReLU) -> y, one pass;
//   forward, norm in:   per-(tile, sample) partial sums of y and y^2 (or of
//     (y - mean)^2 after a first finalize, for "2pass") -> a finalize per
//     sample -> a pass that recomputes the tile and writes (y-mean)*rstd.
// Backward, with the forward's saved [n][2][C] statistics:
//   (a) norm in: recompute, mask g' = g * [xh > 0] (ReLU), partial sums of
//       g' and g' * xh -> finalize per sample;
//   (b) gc = rstd * (g' - mean g' - xh * mean(g' xh)), or g * [y > 0]
//       without the norm, rounded to the compute dtype (the Pallas rule's
//       own rounding) and written once;
//   (c) dW, db: each block sums x-patch * gc over a strided set of 4 x 32
//       chunks of one sample into its own [148][C] fp32 partial (fp32: one
//       lane per tap, one warp per 8 channels; bf16: the GEMM above; the
//       bias row against a ones tap); a last launch sums the partials in a
//       fixed order, so no atomics and the same result every run;
//   (d) when the image needs a gradient: dX of every padded position (a
//       transposed conv of gc; fp32: 16 x 32 positions per block, 8
//       channels of gc at a time in shared memory; bf16: the GEMM above, 16
//       x 48 positions per block), rounded to the compute dtype as the
//       Pallas kernel stores it, then folded onto the image by the padding's
//       adjoint (_unpad_grad): each pixel sums the padded positions that
//       were copies of it, per axis itself plus its reflections or, for
//       replicate, the three border copies.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kTaps = 147;        // 7 * 7 * 3
constexpr int kRowsW = 148;       // taps + the bias row
constexpr float kEps = 1e-5f;
constexpr int kTileH = 8, kTileW = 32;
constexpr int kHaloH = kTileH + 6, kHaloW = kTileW + 6;
constexpr int kHalo = 3 * kHaloH * kHaloW;
constexpr int kMaxC = 64;

enum Pad { kReflect = 0, kReplicate = 1, kZero = 2 };

struct Geom {
  int n, h, w, c;
  int tiles_w, tiles;   // output tiles per row band, per sample
  int pad, relu;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// 8 consecutive fp32 channels
__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void store8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
// The image index that padded index i (image coordinates, -3 <= i < n + 3)
// reads, or -1 for a zero.  Outside that range (the ragged edge of a tile)
// it is -1 too: no output there is kept.
__device__ __forceinline__ int src_index(int i, int n, int pad) {
  if (i < -3 || i >= n + 3) return -1;
  if (pad == kZero) return (i < 0 || i >= n) ? -1 : i;
  if (pad == kReplicate) return min(max(i, 0), n - 1);
  if (i < 0) i = -i;
  if (i >= n) i = 2 * n - 2 - i;
  return i;
}

// The packed weights [148][C] into shared memory (float4 at a time).
__device__ __forceinline__ void stage_weights(const float* __restrict__ w2p, float* sw, int c) {
  const int n4 = kRowsW * c / 4;
  for (int i = threadIdx.x; i < n4; i += blockDim.x)
    reinterpret_cast<float4*>(sw)[i] = reinterpret_cast<const float4*>(w2p)[i];
}

// The padded 3 x rows x cols halo of the image whose top-left padded corner
// is image (r0 - 3, c0 - 3), as fp32 at sx[ci * ch_stride + row * row_stride
// + col] (dense by default).
template <typename T>
__device__ __forceinline__ void stage_halo(const T* __restrict__ x, float* sx, int rows,
                                           int cols, int r0, int c0, int n, const Geom& g,
                                           int row_stride = 0, int ch_stride = 0) {
  if (!row_stride) row_stride = cols;
  if (!ch_stride) ch_stride = rows * cols;
  const T* xs = x + (size_t)n * g.h * g.w * 3;
  for (int i = threadIdx.x; i < 3 * rows * cols; i += blockDim.x) {
    const int ci = i / (rows * cols), rem = i % (rows * cols);
    const int hr = rem / cols, hc = rem % cols;
    const int rr = src_index(r0 - 3 + hr, g.h, g.pad);
    const int cc = src_index(c0 - 3 + hc, g.w, g.pad);
    sx[ci * ch_stride + hr * row_stride + hc] =
        (rr < 0 || cc < 0) ? 0.f : to_f(xs[((size_t)rr * g.w + cc) * 3 + ci]);
  }
}

// The conv of this thread's 8 rows x 8 channels at column `lane` of the
// staged tile, in fp32, the bias first.  Always the same order.
__device__ __forceinline__ void conv_tile(const float* sx, const float* sw, int c, int cg,
                                          int lane, float acc[kTileH][8]) {
  const float* bias = sw + kTaps * c + cg * 8;
#pragma unroll
  for (int p = 0; p < kTileH; ++p)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[p][q] = bias[q];
#pragma unroll 1
  for (int ci = 0; ci < 3; ++ci) {
#pragma unroll
    for (int dc = 0; dc < 7; ++dc) {
      float xv[kHaloH];
#pragma unroll
      for (int j = 0; j < kHaloH; ++j) xv[j] = sx[(ci * kHaloH + j) * kHaloW + lane + dc];
#pragma unroll
      for (int dr = 0; dr < 7; ++dr) {
        float wv[8];
        const float4* wp = reinterpret_cast<const float4*>(sw + ((dr * 7 + dc) * 3 + ci) * c + cg * 8);
        const float4 wa = wp[0], wb = wp[1];
        wv[0] = wa.x; wv[1] = wa.y; wv[2] = wa.z; wv[3] = wa.w;
        wv[4] = wb.x; wv[5] = wb.y; wv[6] = wb.z; wv[7] = wb.w;
#pragma unroll
        for (int p = 0; p < kTileH; ++p)
#pragma unroll
          for (int q = 0; q < 8; ++q) acc[p][q] = fmaf(xv[p + dr], wv[q], acc[p][q]);
      }
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

enum Mode {
  kOut = 0,        // y = conv (+ ReLU)
  kMoments = 1,    // partial sums of y and y^2
  kCentred = 2,    // partial sums of (y - mean)^2
  kApply = 3,      // y = (conv - mean) * rstd (+ ReLU)
  kGradSums = 4,   // partial sums of g' and g' * xh
  kGradIn = 5,     // gc of the instance norm (+ ReLU)
  kGradRelu = 6,   // gc = g * [conv > 0]
};

// One output tile per block (fp32; bf16 runs stem_tile_mma_kernel): stage,
// conv, then the mode's epilogue.
// stats [n][2][c] (mean, rstd); gst [n][2][c] (mean g', mean g' xh);
// part_a, part_b [n][tiles][c].
template <typename T, int kMode>
__global__ void __launch_bounds__(256)
stem_tile_kernel(const T* __restrict__ x, const float* __restrict__ w2p,
                 const T* __restrict__ gr, const float* __restrict__ stats,
                 const float* __restrict__ gst, T* __restrict__ out,
                 float* __restrict__ part_a, float* __restrict__ part_b, Geom g) {
  extern __shared__ float smem[];
  float* sw = smem;
  float* sx = smem + kRowsW * g.c;
  const int tile = blockIdx.x, n = blockIdx.y;
  const int r0 = (tile / g.tiles_w) * kTileH, c0 = (tile % g.tiles_w) * kTileW;
  const int cg = threadIdx.x / 32, lane = threadIdx.x % 32;
  stage_weights(w2p, sw, g.c);
  stage_halo(x, sx, kHaloH, kHaloW, r0, c0, n, g);
  __syncthreads();
  float acc[kTileH][8];
  conv_tile(sx, sw, g.c, cg, lane, acc);

  const int col = c0 + lane, ch = cg * 8;
  const bool col_ok = col < g.w;
  float mean[8], rstd[8], m_g[8], m_gx[8];
  if (kMode == kCentred || kMode == kApply || kMode == kGradSums || kMode == kGradIn) {
    const float* st = stats + (size_t)n * 2 * g.c;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      mean[q] = st[ch + q];
      rstd[q] = st[g.c + ch + q];
    }
  }
  if (kMode == kGradIn) {
    const float* gs = gst + (size_t)n * 2 * g.c;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      m_g[q] = gs[ch + q];
      m_gx[q] = gs[g.c + ch + q];
    }
  }
  float sa[8], sb[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) sa[q] = sb[q] = 0.f;
#pragma unroll
  for (int p = 0; p < kTileH; ++p) {
    const int row = r0 + p;
    if (!col_ok || row >= g.h) continue;
    const size_t off = (((size_t)n * g.h + row) * g.w + col) * g.c + ch;
    float v[8], gv[8];
    if (kMode == kGradSums || kMode == kGradIn || kMode == kGradRelu) load8(gr + off, gv);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const float y = acc[p][q];
      if (kMode == kOut) {
        v[q] = g.relu ? fmaxf(y, 0.f) : y;
      } else if (kMode == kMoments) {
        sa[q] += y;
        sb[q] += y * y;
      } else if (kMode == kCentred) {
        const float d = y - mean[q];
        sb[q] += d * d;
      } else if (kMode == kApply) {
        const float t = (y - mean[q]) * rstd[q];
        v[q] = g.relu ? fmaxf(t, 0.f) : t;
      } else if (kMode == kGradRelu) {
        v[q] = y > 0.f ? gv[q] : 0.f;
      } else {
        const float xh = (y - mean[q]) * rstd[q];
        const float gp = (!g.relu || xh > 0.f) ? gv[q] : 0.f;
        if (kMode == kGradSums) {
          sa[q] += gp;
          sb[q] += gp * xh;
        } else {
          v[q] = rstd[q] * (gp - m_g[q] - xh * m_gx[q]);
        }
      }
    }
    if (kMode == kOut || kMode == kApply || kMode == kGradIn || kMode == kGradRelu)
      store8(out + off, v);
  }
  if (kMode == kMoments || kMode == kCentred || kMode == kGradSums) {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      sa[q] = warp_sum(sa[q]);
      sb[q] = warp_sum(sb[q]);
    }
    if (lane < 8) {
      float a = 0.f, b = 0.f;
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (q == lane) {
          a = sa[q];
          b = sb[q];
        }
      const size_t o = ((size_t)n * g.tiles + tile) * g.c + ch + lane;
      if (kMode != kCentred) part_a[o] = a;
      part_b[o] = b;
    }
  }
}

// One block per sample, one thread per channel: the tiles' partial sums ->
//   kFwd1pass: mean, rstd from E[y^2] - mean^2 (clamped at 0);
//   kFwdMean:  mean alone (the first half of "2pass");
//   kFwdVar:   rstd from the centred sums (mean already in place);
//   kBwd:      mean g' and mean g' xh.
enum Fin { kFwd1pass = 0, kFwdMean = 1, kFwdVar = 2, kBwd = 3 };

template <int kFin>
__global__ void stem_finalize_kernel(const float* __restrict__ part_a,
                                     const float* __restrict__ part_b,
                                     float* __restrict__ out, Geom g) {
  const int n = blockIdx.x;
  const float hw = (float)g.h * (float)g.w;
  for (int c = threadIdx.x; c < g.c; c += blockDim.x) {
    float a = 0.f, b = 0.f;
    for (int t = 0; t < g.tiles; ++t) {
      const size_t o = ((size_t)n * g.tiles + t) * g.c + c;
      if (kFin != kFwdVar) a += part_a[o];
      if (kFin != kFwdMean) b += part_b[o];
    }
    float* st = out + (size_t)n * 2 * g.c;
    if (kFin == kBwd) {
      st[c] = a / hw;
      st[g.c + c] = b / hw;
    } else if (kFin == kFwdVar) {
      st[g.c + c] = 1.f / sqrtf(b / hw + kEps);
    } else {
      const float mean = a / hw;
      st[c] = mean;
      if (kFin == kFwd1pass) st[g.c + c] = 1.f / sqrtf(fmaxf(b / hw - mean * mean, 0.f) + kEps);
    }
  }
}

// ------------------------------------------------------------ dW and db

constexpr int kChunkH = 4, kChunkW = 32, kChunk = kChunkH * kChunkW;
constexpr int kChunkHaloH = kChunkH + 6;
constexpr int kTapSets = 5;   // taps per lane: lane, lane + 32, ..., < 148
// Halo strides of the dW kernel, padded from 38 and 380 floats: the 32
// lanes of a warp read 32 different taps of one pixel, and with these
// strides every tap set falls on 32 different banks (dense, up to 3-way
// conflicts).
constexpr int kDwRowStride = 39, kDwChStride = 395;

// Block (j, n) sums over the chunks j, j + gridDim.x, ... of sample n:
// dw_part[(n * gridDim.x + j)][k][c] = sum x_patch[k] * gc[c], with tap 147
// the ones tap (db).  Warp = 8 channels, lane = a tap set.
template <typename T>
__global__ void __launch_bounds__(256)
stem_dw_kernel(const T* __restrict__ x, const T* __restrict__ gc,
               float* __restrict__ dw_part, Geom g) {
  __shared__ float sx[3 * kDwChStride];
  __shared__ __align__(16) float sg[kChunk * kMaxC];
  const int n = blockIdx.y, j0 = blockIdx.x;
  const int cg = threadIdx.x / 32, lane = threadIdx.x % 32, ch = cg * 8;
  const int chunks_w = (g.w + kChunkW - 1) / kChunkW;
  const int chunks = ((g.h + kChunkH - 1) / kChunkH) * chunks_w;
  int off[kTapSets];
#pragma unroll
  for (int m = 0; m < kTapSets; ++m) {
    const int k = lane + 32 * m;
    const int tap = k / 3, ci = k % 3;
    off[m] = k < kTaps ? ci * kDwChStride + (tap / 7) * kDwRowStride + tap % 7 : -1;
  }
  float acc[kTapSets][8];
#pragma unroll
  for (int m = 0; m < kTapSets; ++m)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[m][q] = 0.f;
  const T* gs = gc + (size_t)n * g.h * g.w * g.c;
  for (int chunk = j0; chunk < chunks; chunk += gridDim.x) {
    const int r0 = (chunk / chunks_w) * kChunkH, c0 = (chunk % chunks_w) * kChunkW;
    __syncthreads();   // the previous chunk is consumed
    stage_halo(x, sx, kChunkHaloH, kHaloW, r0, c0, n, g, kDwRowStride, kDwChStride);
    const int groups = g.c / 8;
    for (int i = threadIdx.x; i < kChunk * groups; i += blockDim.x) {
      const int p = i / groups, c = (i % groups) * 8;
      const int row = r0 + p / kChunkW, col = c0 + p % kChunkW;
      float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (row < g.h && col < g.w) load8(gs + ((size_t)row * g.w + col) * g.c + c, v);
      store8(sg + p * g.c + c, v);
    }
    __syncthreads();
    if (ch < g.c) {
      for (int p = 0; p < kChunk; ++p) {
        const int base = (p / kChunkW) * kDwRowStride + p % kChunkW;
        float gv[8];
        const float4* gp = reinterpret_cast<const float4*>(sg + p * g.c + ch);
        const float4 ga = gp[0], gb = gp[1];
        gv[0] = ga.x; gv[1] = ga.y; gv[2] = ga.z; gv[3] = ga.w;
        gv[4] = gb.x; gv[5] = gb.y; gv[6] = gb.z; gv[7] = gb.w;
#pragma unroll
        for (int m = 0; m < kTapSets; ++m) {
          const int k = lane + 32 * m;
          if (k > kTaps) continue;
          const float xv = k == kTaps ? 1.f : sx[off[m] + base];
#pragma unroll
          for (int q = 0; q < 8; ++q) acc[m][q] = fmaf(xv, gv[q], acc[m][q]);
        }
      }
    }
  }
  if (ch >= g.c) return;
  float* dp = dw_part + ((size_t)n * gridDim.x + j0) * kRowsW * g.c;
#pragma unroll
  for (int m = 0; m < kTapSets; ++m) {
    const int k = lane + 32 * m;
    if (k <= kTaps) store8(dp + (size_t)k * g.c + ch, acc[m]);
  }
}

// dw[k][c] = the partials summed in order, one thread per (k, c).
__global__ void stem_dw_reduce_kernel(const float* __restrict__ dw_part, float* __restrict__ dw,
                                      int parts, int size) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= size) return;
  float s = 0.f;
  for (int p = 0; p < parts; ++p) s += dw_part[(size_t)p * size + i];
  dw[i] = s;
}

// ------------------------------------------------------------------ dX

constexpr int kDxH = 16, kDxW = 32, kDxCh = 8;
constexpr int kDxHaloH = kDxH + 6, kDxHaloW = kDxW + 6;

// dxp[n][pr][pc][ci] = sum_{dr, dc, c} gc[pr - dr][pc - dc][c] * w[dr][dc][ci][c]
// over padded positions (hp = h + 6 rows, wp = w + 6 columns), rounded to T.
// Two warps per block, each 8 padded rows x 32 columns x 3 channels.
template <typename T>
__global__ void __launch_bounds__(64)
stem_dxp_kernel(const T* __restrict__ gc, const float* __restrict__ w2p,
                T* __restrict__ dxp, Geom g) {
  __shared__ float sg[kDxCh * kDxHaloH * kDxHaloW];
  __shared__ __align__(16) float swt[kDxCh * 49 * 4];
  const int hp = g.h + 6, wp = g.w + 6;
  const int tiles_w = (wp + kDxW - 1) / kDxW;
  const int n = blockIdx.y;
  const int r0 = (blockIdx.x / tiles_w) * kDxH, c0 = (blockIdx.x % tiles_w) * kDxW;
  const int wi = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* gs = gc + (size_t)n * g.h * g.w * g.c;
  float acc[8][3];
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int ci = 0; ci < 3; ++ci) acc[p][ci] = 0.f;
  for (int cb = 0; cb < g.c; cb += kDxCh) {
    __syncthreads();
    for (int i = threadIdx.x; i < kDxCh * kDxHaloH * kDxHaloW; i += blockDim.x) {
      const int c = i % kDxCh, rest = i / kDxCh;
      const int row = r0 - 6 + rest / kDxHaloW, col = c0 - 6 + rest % kDxHaloW;
      sg[(c * kDxHaloH + rest / kDxHaloW) * kDxHaloW + rest % kDxHaloW] =
          (row >= 0 && row < g.h && col >= 0 && col < g.w)
              ? to_f(gs[((size_t)row * g.w + col) * g.c + cb + c]) : 0.f;
    }
    for (int i = threadIdx.x; i < kDxCh * 49 * 4; i += blockDim.x) {
      const int c = i / (49 * 4), tap = (i / 4) % 49, ci = i % 4;
      swt[i] = ci < 3 ? w2p[(tap * 3 + ci) * g.c + cb + c] : 0.f;
    }
    __syncthreads();
#pragma unroll 1
    for (int c = 0; c < kDxCh; ++c) {
#pragma unroll
      for (int dc = 0; dc < 7; ++dc) {
        float gv[14];
#pragma unroll
        for (int jj = 0; jj < 14; ++jj)
          gv[jj] = sg[(c * kDxHaloH + 8 * wi + jj) * kDxHaloW + lane - dc + 6];
#pragma unroll
        for (int dr = 0; dr < 7; ++dr) {
          const float4 w4 = reinterpret_cast<const float4*>(swt)[c * 49 + dr * 7 + dc];
#pragma unroll
          for (int p = 0; p < 8; ++p) {
            const float v = gv[p - dr + 6];
            acc[p][0] = fmaf(v, w4.x, acc[p][0]);
            acc[p][1] = fmaf(v, w4.y, acc[p][1]);
            acc[p][2] = fmaf(v, w4.z, acc[p][2]);
          }
        }
      }
    }
  }
  const int col = c0 + lane;
  if (col >= wp) return;
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const int row = r0 + 8 * wi + p;
    if (row >= hp) continue;
    T* o = dxp + (((size_t)n * hp + row) * wp + col) * 3;
#pragma unroll
    for (int ci = 0; ci < 3; ++ci) o[ci] = from_f<T>(acc[p][ci]);
  }
}

// The padded indices (0 .. n + 5) that were copies of image index i: itself
// first, then its reflections, or for replicate the border's three copies.
__device__ __forceinline__ int copies(int i, int n, int pad, int* out) {
  int k = 0;
  out[k++] = i + 3;
  if (pad == kReflect) {
    if (i >= 1 && i <= 3) out[k++] = 3 - i;
    if (i >= n - 4 && i <= n - 2) out[k++] = 2 * n + 1 - i;
  } else if (pad == kReplicate) {
    if (i == 0) for (int j = 0; j < 3; ++j) out[k++] = j;
    if (i == n - 1) for (int j = 0; j < 3; ++j) out[k++] = n + 3 + j;
  }
  return k;
}

// dx[n][r][c][ci] = the padded copies of (r, c) summed in fp32 (the copy
// itself, then the row copies, then the column copies, then both), rounded
// to T: the adjoint of the padding.  One thread per pixel.
template <typename T>
__global__ void stem_fold_kernel(const T* __restrict__ dxp, T* __restrict__ dx, Geom g) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)g.n * g.h * g.w) return;
  const int col = i % g.w, row = (i / g.w) % g.h, n = i / ((size_t)g.w * g.h);
  const int hp = g.h + 6, wp = g.w + 6;
  int rows[6], cols[6];
  const int nr = copies(row, g.h, g.pad, rows), nc = copies(col, g.w, g.pad, cols);
  float s[3] = {0.f, 0.f, 0.f};
  for (int pass = 0; pass < 4; ++pass) {   // (self, self), (copy, self), (self, copy), (copy, copy)
    const int ra = pass & 1 ? 1 : 0, rb = pass & 1 ? nr : 1;
    const int ca = pass & 2 ? 1 : 0, cb = pass & 2 ? nc : 1;
    for (int a = ra; a < rb; ++a)
      for (int b = ca; b < cb; ++b) {
        const T* v = dxp + (((size_t)n * hp + rows[a]) * wp + cols[b]) * 3;
#pragma unroll
        for (int ci = 0; ci < 3; ++ci) s[ci] += to_f(v[ci]);
      }
  }
#pragma unroll
  for (int ci = 0; ci < 3; ++ci) dx[i * 3 + ci] = from_f<T>(s[ci]);
}

// ------------------------------------- bf16 dW and dX on the tensor cores

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 bf16 matrices from shared memory, lanes 8i..8i+7 giving the
// rows of matrix i; `.trans` hands out each matrix transposed.
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(addr));
}

// d[16 x 8] += a[16 x 16] * b[16 x 8], bf16 operands, fp32 sums.  Lane
// (grp = lane / 4, tig = lane % 4) holds a: rows grp, grp + 8 x columns
// 2 tig, 2 tig + 1 (+ 8); b: rows 2 tig, 2 tig + 1 (+ 8) x column grp; d:
// rows grp, grp + 8 x columns 2 tig, 2 tig + 1.  The lower half of a
// register is the lower column (a) or row (b).
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared without a register, or 16 zero bytes when
// !valid (src is then not read but must be a mapped address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// bf16 gc rows of round16(C) + 8 elements: a multiple of 16 bytes, and an
// odd number of 16-byte groups, so 8 consecutive rows meet 8 bank groups.
__device__ __forceinline__ int gc_row_stride(int c) { return ((c + 15) & ~15) + 8; }

// dW.  The x halo of a 4 x 32 chunk, 3 x 10 x 38 bf16, twice: at sx[0..]
// and shifted left by one column at sx[kMwCopy..].  Strides in bf16: a
// plane of 204 words and a copy of 612 (12 and 4 mod 32 banks) spread the
// 8 taps that one A load reads over the banks (at most 2-way conflicts:
// taps dc and dc + 2 sit one word apart).
constexpr int kMwThreads = 160;               // 5 warps x 32 taps = 160 >= 148
constexpr int kMwRow = 40, kMwPlane = 408, kMwCopy = 3 * kMwPlane;
constexpr uint32_t kOnes = 0x3F803F80u;       // two bf16 1.0: the ones tap (db)

constexpr int kMwHalo = 3 * kChunkHaloH * kHaloW;
constexpr int kMwXLoads = (kMwHalo + kMwThreads - 1) / kMwThreads;
constexpr int kMwGc = kChunk * (kMaxC + 8);   // bf16 per gc buffer

// Block (j, n) sums over the chunks j, j + gridDim.x, ... of sample n into
// dw_part[(n * gridDim.x + j)][k][c], as stem_dw_kernel.  Warp w owns the
// tap tiles 2w, 2w + 1 (16 taps each) and every channel.  Two buffers: the
// next chunk's gc (cp.async) and x halo (registers) are in flight while
// this chunk multiplies, so a chunk waits on memory once, not per load.
__global__ void __launch_bounds__(kMwThreads)
stem_dw_mma_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ gc,
                   float* __restrict__ dw_part, Geom g) {
  __shared__ __align__(16) uint16_t sx[2][2 * kMwCopy];
  __shared__ __align__(16) uint16_t sg[2][kMwGc];
  const int n = blockIdx.y, j0 = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane / 4, tig = lane % 4;
  const int ntiles = g.c / 8, gstride = gc_row_stride(g.c);
  const int chunks_w = (g.w + kChunkW - 1) / kChunkW;
  const int chunks = ((g.h + kChunkH - 1) / kChunkH) * chunks_w;
  // A rows of this lane: taps 16 mt' + grp (+ 8) of its tiles mt' = 2 warp
  // + mt, as a word offset into sx; a tap past 146 reads offset 0 and keeps
  // nothing of it (mask 0), then takes the ones (tap 147) or zero
  int off[2][2];
  uint32_t mask[2][2], fixed[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int tap = 16 * (2 * warp + mt) + grp + 8 * hi;
      const int dr = tap / 21, dc = (tap / 3) % 7, ci = tap % 3;
      const bool real = tap < kTaps;
      off[mt][hi] = real ? ((dc & 1) * kMwCopy + ci * kMwPlane + dr * kMwRow) / 2 + dc / 2 : 0;
      mask[mt][hi] = real ? 0xFFFFFFFFu : 0u;
      fixed[mt][hi] = tap == kTaps ? kOnes : 0u;
    }
  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.f;
  const uint16_t* xs = reinterpret_cast<const uint16_t*>(x) + (size_t)n * g.h * g.w * 3;
  const uint16_t* gs = reinterpret_cast<const uint16_t*>(gc) + (size_t)n * g.h * g.w * g.c;
  // this lane's ldmatrix.trans row: pixel (lane % 8) + 8 (lane / 8 % 2) of
  // the 16, channels 8 (lane / 16) on from the n-tile pair's first
  const uint32_t b_base =
      smem_u32(&sg[0][((lane % 8) + 8 * ((lane / 8) % 2)) * gstride + 8 * (lane / 16)]);
  uint16_t xv[kMwXLoads];
  // start the loads of a chunk: gc into buffer `buf`, the x halo into xv
  auto fetch = [&](int chunk, int buf) {
    const int r0 = (chunk / chunks_w) * kChunkH, c0 = (chunk % chunks_w) * kChunkW;
    for (int i = threadIdx.x; i < kChunk * ntiles; i += kMwThreads) {
      const int p = i / ntiles, c = (i % ntiles) * 8;
      const int row = r0 + p / kChunkW, col = c0 + p % kChunkW;
      const bool in = row < g.h && col < g.w;
      cp_async16(smem_u32(&sg[buf][p * gstride + c]),
                 in ? gs + ((size_t)row * g.w + col) * g.c + c : gs, in);
    }
#pragma unroll
    for (int q = 0; q < kMwXLoads; ++q) {
      const int i = threadIdx.x + q * kMwThreads;
      const int ci = i / (kChunkHaloH * kHaloW), rem = i % (kChunkHaloH * kHaloW);
      const int rr = src_index(r0 - 3 + rem / kHaloW, g.h, g.pad);
      const int cc = src_index(c0 - 3 + rem % kHaloW, g.w, g.pad);
      xv[q] = (i >= kMwHalo || rr < 0 || cc < 0) ? 0 : xs[((size_t)rr * g.w + cc) * 3 + ci];
    }
  };
  // finish them: the x halo into buffer `buf`, twice (the second copy one
  // column to the left); wait for this thread's gc copies
  auto land = [&](int buf) {
#pragma unroll
    for (int q = 0; q < kMwXLoads; ++q) {
      const int i = threadIdx.x + q * kMwThreads;
      if (i >= kMwHalo) break;
      const int ci = i / (kChunkHaloH * kHaloW), rem = i % (kChunkHaloH * kHaloW);
      const int hc = rem % kHaloW;
      const int o = ci * kMwPlane + (rem / kHaloW) * kMwRow + hc;
      sx[buf][o] = xv[q];
      if (hc > 0) sx[buf][kMwCopy + o - 1] = xv[q];
    }
    cp_async_wait_all();
  };
  if (j0 < chunks) {
    fetch(j0, 0);
    land(0);
  }
  __syncthreads();
  int buf = 0;
  for (int chunk = j0; chunk < chunks; chunk += gridDim.x, buf ^= 1) {
    const bool more = chunk + gridDim.x < chunks;   // the same for the whole block
    if (more) fetch(chunk + gridDim.x, buf ^ 1);    // buffer buf ^ 1 was consumed before the last barrier
    const uint32_t* sx32 = reinterpret_cast<const uint32_t*>(sx[buf]);
#pragma unroll
    for (int ks = 0; ks < kChunk / 16; ++ks) {   // 16 pixels: chunk row ks / 2, columns 16 (ks % 2) on
      const int xw = (ks / 2) * (kMwRow / 2) + 8 * (ks % 2) + tig;
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        a[mt][0] = (sx32[off[mt][0] + xw] & mask[mt][0]) | fixed[mt][0];
        a[mt][1] = (sx32[off[mt][1] + xw] & mask[mt][1]) | fixed[mt][1];
        a[mt][2] = (sx32[off[mt][0] + xw + 4] & mask[mt][0]) | fixed[mt][0];
        a[mt][3] = (sx32[off[mt][1] + xw + 4] & mask[mt][1]) | fixed[mt][1];
      }
      const uint32_t bk = b_base + (buf * kMwGc + ks * 16 * gstride) * 2;
#pragma unroll
      for (int nt = 0; nt < 8; nt += 2) {
        if (nt >= ntiles) break;
        uint32_t b[4];
        if (nt + 1 < ntiles) ldsm_x4_t(bk + nt * 16, b);   // 8 channels: 16 bytes
        else ldsm_x2_t(bk + nt * 16, b);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(acc[mt][nt], a[mt], b[0], b[1]);
          if (nt + 1 < ntiles) mma_bf16(acc[mt][nt + 1], a[mt], b[2], b[3]);
        }
      }
    }
    if (more) land(buf ^ 1);
    __syncthreads();
  }
  float* dp = dw_part + ((size_t)n * gridDim.x + j0) * kRowsW * g.c;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int tap = 16 * (2 * warp + mt) + grp + 8 * hi;
      if (tap > kTaps) continue;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        if (nt < ntiles)
          *reinterpret_cast<float2*>(dp + (size_t)tap * g.c + 8 * nt + 2 * tig) =
              make_float2(acc[mt][nt][2 * hi], acc[mt][nt][2 * hi + 1]);
    }
}

// dX.  A block owns 16 padded rows x 48 padded columns of one sample; warp
// (wr, wc) of its 2 x 3 owns rows 8 wr.. x columns 16 wc.. .  The gc halo
// of 22 x 54 pixels x 16 channels sits at [pixel][kMxPix] (48 bytes: 8
// consecutive pixels of an ldmatrix meet 8 bank groups), the 16 channels'
// weights at [tap * 3 + ci][kMxPix].  Dynamic shared memory (62.6 KB).
constexpr int kMxH = 16, kMxW = 48, kMxHaloH = kMxH + 6, kMxHaloW = kMxW + 6;
constexpr int kMxCh = 16, kMxPix = 24, kMxThreads = 192;
constexpr int kMxSmem = (kMxHaloH * kMxHaloW + kTaps) * kMxPix * 2;
constexpr int kMxWLoads = (kTaps * kMxCh / 2 + kMxThreads - 1) / kMxThreads;

__global__ void __launch_bounds__(kMxThreads)
stem_dxp_mma_kernel(const __nv_bfloat16* __restrict__ gc, const float* __restrict__ w2p,
                    __nv_bfloat16* __restrict__ dxp, Geom g) {
  extern __shared__ __align__(16) uint16_t mx_smem[];
  uint16_t* sh = mx_smem;
  uint16_t* sb = mx_smem + kMxHaloH * kMxHaloW * kMxPix;
  const int hp = g.h + 6, wp = g.w + 6;
  const int tiles_w = (wp + kMxW - 1) / kMxW;
  const int n = blockIdx.y;
  const int r0 = (blockIdx.x / tiles_w) * kMxH, c0 = (blockIdx.x % tiles_w) * kMxW;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = warp / 3, wc = warp % 3, grp = lane / 4, tig = lane % 4;
  const uint16_t* gs = reinterpret_cast<const uint16_t*>(gc) + (size_t)n * g.h * g.w * g.c;
  float acc[8][4];
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[p][q] = 0.f;
  // this lane's ldmatrix row: output column 16 wc + lane % 16 of the tile
  // at column tap 0 (halo column + 6), channels 8 (lane / 16); halo row 8 wr
  const uint32_t a_base =
      smem_u32(sh + (8 * wr * kMxHaloW + 16 * wc + lane % 16 + 6) * kMxPix + 8 * (lane / 16));
  const int brow = grp < 3 ? grp : 0;   // weights of ci = grp; columns 3..7 are zero
  for (int cb = 0; cb < g.c; cb += kMxCh) {
    __syncthreads();   // the previous stage is consumed
    // every load of the stage in flight at once: the halo by cp.async, the
    // weights (pairs of channels) into registers, rounded to bf16 (exact)
    for (int i = threadIdx.x; i < kMxHaloH * kMxHaloW * 2; i += kMxThreads) {
      const int pix = i / 2, ch = cb + 8 * (i % 2);
      const int row = r0 - 6 + pix / kMxHaloW, col = c0 - 6 + pix % kMxHaloW;
      const bool in = row >= 0 && row < g.h && col >= 0 && col < g.w && ch < g.c;
      cp_async16(smem_u32(sh + pix * kMxPix + 8 * (i % 2)),
                 in ? gs + ((size_t)row * g.w + col) * g.c + ch : gs, in);
    }
    float2 wv[kMxWLoads];
#pragma unroll
    for (int q = 0; q < kMxWLoads; ++q) {
      const int i = threadIdx.x + q * kMxThreads, c = cb + 2 * (i % (kMxCh / 2));
      wv[q] = (i < kTaps * kMxCh / 2 && c < g.c)
                  ? *reinterpret_cast<const float2*>(w2p + (i / (kMxCh / 2)) * g.c + c)
                  : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int q = 0; q < kMxWLoads; ++q) {
      const int i = threadIdx.x + q * kMxThreads;
      if (i < kTaps * kMxCh / 2)
        *reinterpret_cast<__nv_bfloat162*>(sb + (i / (kMxCh / 2)) * kMxPix + 2 * (i % (kMxCh / 2))) =
            __floats2bfloat162_rn(wv[q].x, wv[q].y);
    }
    cp_async_wait_all();
    __syncthreads();
#pragma unroll 1
    for (int dc = 0; dc < 7; ++dc) {
      uint32_t b[7][2];
#pragma unroll
      for (int dr = 0; dr < 7; ++dr) {
        const uint32_t* wp32 =
            reinterpret_cast<const uint32_t*>(sb + ((dr * 7 + dc) * 3 + brow) * kMxPix) + tig;
        b[dr][0] = grp < 3 ? wp32[0] : 0u;
        b[dr][1] = grp < 3 ? wp32[4] : 0u;
      }
      // gc row r0 - 6 + 8 wr + jj meets output row 8 wr + p at dr = p + 6 - jj
      const uint32_t a_dc = a_base - dc * kMxPix * 2;
#pragma unroll
      for (int jj = 0; jj < 14; ++jj) {
        uint32_t a[4];
        ldsm_x4(a_dc + jj * kMxHaloW * kMxPix * 2, a);
#pragma unroll
        for (int p = 0; p < 8; ++p)
          if (jj >= p && jj <= p + 6) mma_bf16(acc[p], a, b[p + 6 - jj][0], b[p + 6 - jj][1]);
      }
    }
  }
  // lane: ci 2 tig, 2 tig + 1 of columns grp, grp + 8; ci 0..2 are real
  if (2 * tig >= 3) return;
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const int row = r0 + 8 * wr + p;
    if (row >= hp) continue;
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int col = c0 + 16 * wc + grp + 8 * hi;
      if (col >= wp) continue;
      __nv_bfloat16* o = dxp + (((size_t)n * hp + row) * wp + col) * 3 + 2 * tig;
      o[0] = __float2bfloat16_rn(acc[p][2 * hi]);
      if (tig == 0) o[1] = __float2bfloat16_rn(acc[p][2 * hi + 1]);
    }
  }
}

// ------------------------------------ bf16 conv tile on the tensor cores

// The conv of an 8 x 32 tile as an implicit GEMM: M = the 256 pixels, N = C
// (n8 tiles), K = 168 taps, 16 at a time.  K runs k = (ci * 7 + dr) * 8 + dc:
// 8 slots per (input channel, row tap), dc = 7 and k >= 168 zero weights, so
// a k16 step is two (ci, dr) pairs and each A register two neighbouring halo
// columns dc, dc + 1 of one row.  The bias is the accumulator's start, as in
// `conv_tile`.  Warp w owns image row w of the tile (two m16 tiles, columns
// 0..15 and 16..31) x every channel: per k16 step 8 32-bit loads of A and
// C / 16 ldmatrix.x4 of B feed C / 4 products.
constexpr int kMtThreads = 256;               // 8 warps, one per tile row
constexpr int kMtK = 168, kMtKSteps = 11;     // 21 (ci, dr) pairs of 8; 176 / 16
constexpr int kMtBStride = 184;               // bf16 per weight row: 23 x 16 bytes, odd
// The bf16 halo, 3 planes x 14 rows x 40 columns (columns 38, 39 zero), as
// 32-bit words, twice: copy 0 as is, copy 1 shifted left by one column, so
// that a pair starting at an odd column is one aligned word of copy 1.  A
// copy of 848 words (16 mod 32 banks) puts the two copies' 7-word windows of
// one A load on different banks.
constexpr int kMtRowW = 20, kMtPlaneW = kHaloH * kMtRowW, kMtCopyW = 848;
constexpr int kMtHaloCols = 2 * kMtRowW;
constexpr int kMtWBatch = 7;                  // 84 K pairs x 64 channels = 3 batches of 256 x 7

// One output tile per block, as stem_tile_kernel: stage, conv on the tensor
// cores, then the same epilogue per mode in the fragment layout (lane: tile
// columns 16 h + grp and + 8, channels 8 nt + 2 tig and + 1).  The per-tile
// partials are summed over a lane's pixels, then over the 8 lanes of a
// channel pair by shuffles, then over the 8 warps in order through shared
// memory: the same [n][tiles][c] arrays, no atomics.
template <int kMode>
__global__ void __launch_bounds__(kMtThreads)
stem_tile_mma_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ w2p,
                     const __nv_bfloat16* __restrict__ gr, const float* __restrict__ stats,
                     const float* __restrict__ gst, __nv_bfloat16* __restrict__ out,
                     float* __restrict__ part_a, float* __restrict__ part_b, Geom g) {
  __shared__ __align__(16) uint16_t sb[kMaxC * kMtBStride];     // weights [c][k]
  __shared__ __align__(16) uint32_t sx[2 * kMtCopyW];           // the halo, twice
  __shared__ float s_bias[kMaxC], s_mean[kMaxC], s_rstd[kMaxC], s_mg[kMaxC], s_mgx[kMaxC];
  __shared__ float s_red[2][8][kMaxC];
  const int tile = blockIdx.x, n = blockIdx.y;
  const int r0 = (tile / g.tiles_w) * kTileH, c0 = (tile % g.tiles_w) * kTileW;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane / 4, tig = lane % 4;
  const int ntiles = g.c / 8;

  // weights: item = (K pair kp, channel c), the bf16 pair [c][2 kp], [c][2 kp
  // + 1] (exact: w2p holds bf16 values).  A warp's 32 items are 4 pairs x 8
  // channels: 4 rows x 32 bytes of w2p, and 32 different banks of sb.  Loads
  // in batches of kMtWBatch, all in flight before their stores.
  for (int base = 0; base < kMtK / 2 * g.c; base += kMtThreads * kMtWBatch) {
    float wa[kMtWBatch], wb[kMtWBatch];
#pragma unroll
    for (int q = 0; q < kMtWBatch; ++q) {
      const int i = base + threadIdx.x + q * kMtThreads, rest = i >> 5;
      const int kp = 4 * (rest % 21) + (i & 3), c = 8 * (rest / 21) + ((i >> 2) & 7);
      const int k = 2 * kp, ci = k / 56, dr = (k / 8) % 7, dc = k % 8;
      const bool real = i < kMtK / 2 * g.c;
      // dc is even: k is a real tap, k + 1 one unless dc + 1 == 7
      const float* wr = w2p + (size_t)((dr * 7 + dc) * 3 + ci) * g.c + c;
      wa[q] = real ? wr[0] : 0.f;
      wb[q] = real && dc < 6 ? wr[3 * g.c] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < kMtWBatch; ++q) {
      const int i = base + threadIdx.x + q * kMtThreads, rest = i >> 5;
      if (i >= kMtK / 2 * g.c) break;
      const int kp = 4 * (rest % 21) + (i & 3), c = 8 * (rest / 21) + ((i >> 2) & 7);
      *reinterpret_cast<__nv_bfloat162*>(sb + c * kMtBStride + 2 * kp) =
          __floats2bfloat162_rn(wa[q], wb[q]);
    }
  }
  // K rows 168..175 of every channel: zero
  for (int i = threadIdx.x; i < g.c * 4; i += kMtThreads)
    reinterpret_cast<uint32_t*>(sb + (i / 4) * kMtBStride + kMtK)[i % 4] = 0u;
  for (int c = threadIdx.x; c < g.c; c += kMtThreads) {
    s_bias[c] = w2p[kTaps * g.c + c];
    if (kMode == kCentred || kMode == kApply || kMode == kGradSums || kMode == kGradIn) {
      s_mean[c] = stats[(size_t)n * 2 * g.c + c];
      s_rstd[c] = stats[(size_t)n * 2 * g.c + g.c + c];
    }
    if (kMode == kGradIn) {
      s_mg[c] = gst[(size_t)n * 2 * g.c + c];
      s_mgx[c] = gst[(size_t)n * 2 * g.c + g.c + c];
    }
  }
  // the halo of the tile's image window, bf16, in both copies
  {
    const uint16_t* xs = reinterpret_cast<const uint16_t*>(x) + (size_t)n * g.h * g.w * 3;
    uint16_t* s0 = reinterpret_cast<uint16_t*>(sx);
    uint16_t* s1 = s0 + 2 * kMtCopyW;
    for (int i = threadIdx.x; i < 3 * kHaloH * kMtHaloCols; i += kMtThreads) {
      const int ci = i / (kHaloH * kMtHaloCols), rem = i % (kHaloH * kMtHaloCols);
      const int hr = rem / kMtHaloCols, hc = rem % kMtHaloCols;
      const int rr = src_index(r0 - 3 + hr, g.h, g.pad);
      const int cc = src_index(c0 - 3 + hc, g.w, g.pad);
      const uint16_t v = (hc >= kHaloW || rr < 0 || cc < 0) ? 0 : xs[((size_t)rr * g.w + cc) * 3 + ci];
      const int o = ci * 2 * kMtPlaneW + hr * kMtHaloCols + hc;
      s0[o] = v;
      if (hc > 0) s1[o - 1] = v;
      else s1[o + kMtHaloCols - 1] = 0;   // the last column of copy 1
    }
  }
  __syncthreads();

  // the conv: acc[h][nt] = rows (columns 16 h + grp, + 8) x channels 8 nt + 2 tig, + 1
  float acc[2][8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const float b0 = nt < ntiles ? s_bias[8 * nt + 2 * tig] : 0.f;
    const float b1 = nt < ntiles ? s_bias[8 * nt + 2 * tig + 1] : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      acc[h][nt][0] = acc[h][nt][2] = b0;
      acc[h][nt][1] = acc[h][nt][3] = b1;
    }
  }
  // this lane's A word: column 16 h + grp of tile row `warp`, from copy
  // grp & 1; its ldmatrix row of B: channel (lane % 8) + 8 (lane / 16),
  // K half 8 ((lane / 8) % 2)
  const uint32_t* xa = sx + (grp & 1) * kMtCopyW + warp * kMtRowW + (grp >> 1) + tig;
  const uint32_t b_base = smem_u32(sb + ((lane % 8) + 8 * (lane / 16)) * kMtBStride + 8 * ((lane / 8) % 2));
#pragma unroll
  for (int s = 0; s < kMtKSteps; ++s) {
    constexpr int kNone = -1;
    const int p0 = 2 * s, p1 = 2 * s + 1;   // (ci, dr) pairs; p1 == 21 is zero
    const int o0 = (p0 / 7) * kMtPlaneW + (p0 % 7) * kMtRowW;
    const int o1 = p1 < 21 ? (p1 / 7) * kMtPlaneW + (p1 % 7) * kMtRowW : kNone;
    uint32_t a[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      a[h][0] = xa[o0 + 8 * h];
      a[h][1] = xa[o0 + 8 * h + 4];
      a[h][2] = o1 == kNone ? 0u : xa[o1 + 8 * h];
      a[h][3] = o1 == kNone ? 0u : xa[o1 + 8 * h + 4];
    }
    const uint32_t bk = b_base + s * 32;   // 16 bf16 of K
#pragma unroll
    for (int nt = 0; nt < 8; nt += 2) {
      if (nt >= ntiles) break;
      uint32_t b[4];
      if (nt + 1 < ntiles) ldsm_x4(bk + nt * 8 * kMtBStride * 2, b);
      else ldsm_x2(bk + nt * 8 * kMtBStride * 2, b);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mma_bf16(acc[h][nt], a[h], b[0], b[1]);
        if (nt + 1 < ntiles) mma_bf16(acc[h][nt + 1], a[h], b[2], b[3]);
      }
    }
  }

  // the epilogue: the formulas of stem_tile_kernel, per (pixel, channel pair)
  const int row = r0 + warp;
  float sa[8][2], sbm[8][2];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) sa[nt][0] = sa[nt][1] = sbm[nt][0] = sbm[nt][1] = 0.f;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int col = c0 + 16 * h + grp + 8 * hi;
      if (row >= g.h || col >= g.w) continue;
      const size_t pix = ((size_t)n * g.h + row) * g.w + col;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        if (nt >= ntiles) break;
        const int ch = 8 * nt + 2 * tig;
        float gv[2], v[2];
        if (kMode == kGradSums || kMode == kGradIn || kMode == kGradRelu) {
          const float2 gf = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(gr + pix * g.c + ch));
          gv[0] = gf.x;
          gv[1] = gf.y;
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float y = acc[h][nt][2 * hi + j];
          if (kMode == kOut) {
            v[j] = g.relu ? fmaxf(y, 0.f) : y;
          } else if (kMode == kMoments) {
            sa[nt][j] += y;
            sbm[nt][j] += y * y;
          } else if (kMode == kCentred) {
            const float d = y - s_mean[ch + j];
            sbm[nt][j] += d * d;
          } else if (kMode == kApply) {
            const float t = (y - s_mean[ch + j]) * s_rstd[ch + j];
            v[j] = g.relu ? fmaxf(t, 0.f) : t;
          } else if (kMode == kGradRelu) {
            v[j] = y > 0.f ? gv[j] : 0.f;
          } else {
            const float xh = (y - s_mean[ch + j]) * s_rstd[ch + j];
            const float gp = (!g.relu || xh > 0.f) ? gv[j] : 0.f;
            if (kMode == kGradSums) {
              sa[nt][j] += gp;
              sbm[nt][j] += gp * xh;
            } else {
              v[j] = s_rstd[ch + j] * (gp - s_mg[ch + j] - xh * s_mgx[ch + j]);
            }
          }
        }
        if (kMode == kOut || kMode == kApply || kMode == kGradIn || kMode == kGradRelu)
          *reinterpret_cast<__nv_bfloat162*>(out + pix * g.c + ch) = __floats2bfloat162_rn(v[0], v[1]);
      }
    }
  if (kMode == kMoments || kMode == kCentred || kMode == kGradSums) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {   // over grp: the 8 lanes of a channel pair
          sa[nt][j] += __shfl_xor_sync(0xffffffffu, sa[nt][j], o);
          sbm[nt][j] += __shfl_xor_sync(0xffffffffu, sbm[nt][j], o);
        }
    if (grp == 0) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        if (nt < ntiles)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            s_red[0][warp][8 * nt + 2 * tig + j] = sa[nt][j];
            s_red[1][warp][8 * nt + 2 * tig + j] = sbm[nt][j];
          }
    }
    __syncthreads();
    for (int c = threadIdx.x; c < g.c; c += kMtThreads) {
      float a = 0.f, b = 0.f;
#pragma unroll
      for (int w = 0; w < 8; ++w) {
        a += s_red[0][w][c];
        b += s_red[1][w][c];
      }
      const size_t o = ((size_t)n * g.tiles + tile) * g.c + c;
      if (kMode != kCentred) part_a[o] = a;
      part_b[o] = b;
    }
  }
}

// ------------------------------------------------------------- launches

int make_geom(int n, int h, int w, int c, int pad, int relu, Geom* g) {
  if (n < 1 || h < 4 || w < 4 || c < 8 || c > kMaxC || c % 8 != 0 || pad < 0 || pad > 2)
    return (int)cudaErrorInvalidValue;
  const int tiles_w = (w + kTileW - 1) / kTileW;
  *g = Geom{n, h, w, c, tiles_w, tiles_w * ((h + kTileH - 1) / kTileH), pad, relu};
  return 0;
}

template <typename T, int kMode>
void tile_launch(const void* x, const float* w2p, const void* gr, const float* stats,
                 const float* gst, void* out, float* pa, float* pb, const Geom& g,
                 cudaStream_t st) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    stem_tile_mma_kernel<kMode><<<dim3(g.tiles, g.n), kMtThreads, 0, st>>>(
        static_cast<const T*>(x), w2p, static_cast<const T*>(gr), stats, gst,
        static_cast<T*>(out), pa, pb, g);
  } else {
    const size_t smem = (kRowsW * g.c + kHalo) * sizeof(float);
    stem_tile_kernel<T, kMode><<<dim3(g.tiles, g.n), 32 * (g.c / 8), smem, st>>>(
        static_cast<const T*>(x), w2p, static_cast<const T*>(gr), stats, gst,
        static_cast<T*>(out), pa, pb, g);
  }
}

template <typename T>
int forward(const void* x, const float* w2p, void* y, float* stats, float* ws, const Geom& g,
            int norm_in, int two_pass, cudaStream_t st) {
  if (!norm_in) {
    tile_launch<T, kOut>(x, w2p, nullptr, nullptr, nullptr, y, nullptr, nullptr, g, st);
    return (int)cudaGetLastError();
  }
  float* pa = ws;
  float* pb = ws + (size_t)g.n * g.tiles * g.c;
  if (two_pass) {
    tile_launch<T, kMoments>(x, w2p, nullptr, nullptr, nullptr, nullptr, pa, pb, g, st);
    stem_finalize_kernel<kFwdMean><<<g.n, 64, 0, st>>>(pa, pb, stats, g);
    tile_launch<T, kCentred>(x, w2p, nullptr, stats, nullptr, nullptr, pa, pb, g, st);
    stem_finalize_kernel<kFwdVar><<<g.n, 64, 0, st>>>(pa, pb, stats, g);
  } else {
    tile_launch<T, kMoments>(x, w2p, nullptr, nullptr, nullptr, nullptr, pa, pb, g, st);
    stem_finalize_kernel<kFwd1pass><<<g.n, 64, 0, st>>>(pa, pb, stats, g);
  }
  tile_launch<T, kApply>(x, w2p, nullptr, stats, nullptr, y, nullptr, nullptr, g, st);
  return (int)cudaGetLastError();
}

template <typename T>
int backward(const void* x, const float* w2p, const void* gr, const float* stats, void* gc,
             void* dxp, void* dx, float* dw, float* ws, int dw_blocks, const Geom& g,
             int norm_in, cudaStream_t st) {
  const size_t part = (size_t)g.n * g.tiles * g.c;
  float* pa = ws;
  float* pb = ws + part;
  float* gst = ws + 2 * part;
  float* dwp = gst + 2 * (size_t)g.n * g.c;
  const void* gcv = gr;   // norm none, act none: gc is g itself
  if (norm_in) {
    tile_launch<T, kGradSums>(x, w2p, gr, stats, nullptr, nullptr, pa, pb, g, st);
    stem_finalize_kernel<kBwd><<<g.n, 64, 0, st>>>(pa, pb, gst, g);
    tile_launch<T, kGradIn>(x, w2p, gr, stats, gst, gc, nullptr, nullptr, g, st);
    gcv = gc;
  } else if (g.relu) {
    tile_launch<T, kGradRelu>(x, w2p, gr, nullptr, nullptr, gc, nullptr, nullptr, g, st);
    gcv = gc;
  }
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  if constexpr (kBf16)
    stem_dw_mma_kernel<<<dim3(dw_blocks, g.n), kMwThreads, 0, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(gcv), dwp, g);
  else
    stem_dw_kernel<T><<<dim3(dw_blocks, g.n), 32 * (g.c / 8), 0, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(gcv), dwp, g);
  const int size = kRowsW * g.c;
  stem_dw_reduce_kernel<<<(size + 255) / 256, 256, 0, st>>>(dwp, dw, g.n * dw_blocks, size);
  if (dx) {
    if constexpr (kBf16) {
      // above 48 KB: allowed once per device, outside any stream capture
      // (the first call of a process runs before one)
      static unsigned allowed = 0;
      int dev = 0;
      cudaError_t err = cudaGetDevice(&dev);
      if (!err && dev < 32 && !(allowed >> dev & 1u)) {
        err = cudaFuncSetAttribute(stem_dxp_mma_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, kMxSmem);
        if (!err) allowed |= 1u << dev;
      }
      if (err) return (int)err;
      const int tiles = ((g.h + 6 + kMxH - 1) / kMxH) * ((g.w + 6 + kMxW - 1) / kMxW);
      stem_dxp_mma_kernel<<<dim3(tiles, g.n), kMxThreads, kMxSmem, st>>>(
          static_cast<const T*>(gcv), w2p, static_cast<T*>(dxp), g);
    } else {
      const int tiles = ((g.h + 6 + kDxH - 1) / kDxH) * ((g.w + 6 + kDxW - 1) / kDxW);
      stem_dxp_kernel<T><<<dim3(tiles, g.n), 64, 0, st>>>(
          static_cast<const T*>(gcv), w2p, static_cast<T*>(dxp), g);
    }
    const size_t pixels = (size_t)g.n * g.h * g.w;
    stem_fold_kernel<T><<<(unsigned)((pixels + 255) / 256), 256, 0, st>>>(
        static_cast<const T*>(dxp), static_cast<T*>(dx), g);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x: [n][h][w][3] (NHWC bytes), float32 (dtype 0) or bfloat16 (1).  w2p:
// float32 [148][c], row (dr * 7 + dc) * 3 + ci, row 147 the bias, every value
// already rounded to the compute dtype.  pad: 0 reflect, 1 replicate, 2 zero.
// c a multiple of 8, at most 64; h, w >= 4.  Each returns cudaGetLastError()
// after its launches (an invalid shape: cudaErrorInvalidValue, no launch).

// y: [n][h][w][c].  With norm_in, stats: float32 [n][2][c] (mean, rstd),
// written for the backward, and ws: float32 2 * n * tiles * c, tiles =
// ceil(h / 8) * ceil(w / 32).
extern "C" int dwc_stem_conv7(const void* x, const void* w2p, void* y, void* stats, void* ws,
                              int n, int h, int w, int c, int dtype, int norm_in, int relu,
                              int pad, int two_pass, void* stream) {
  Geom g;
  const int bad = make_geom(n, h, w, c, pad, relu, &g);
  if (bad) return bad;
  const float* wp = static_cast<const float*>(w2p);
  float* st = static_cast<float*>(stats);
  float* wk = static_cast<float*>(ws);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return forward<__nv_bfloat16>(x, wp, y, st, wk, g, norm_in, two_pass, s);
  return forward<float>(x, wp, y, st, wk, g, norm_in, two_pass, s);
}

// g: the incoming gradient [n][h][w][c]; stats: the forward's (norm_in).
// gc: scratch [n][h][w][c] of the data type (unused without norm and ReLU).
// dxp: scratch [n][h + 6][w + 6][3] and dx: [n][h][w][3], both NULL when the
// image needs no gradient.  dw: float32 [148][c] out (row 147 db).  ws:
// float32 2 * n * tiles * c + 2 * n * c + n * dw_blocks * 148 * c.
extern "C" int dwc_stem_conv7_bwd(const void* x, const void* w2p, const void* g,
                                  const void* stats, void* gc, void* dxp, void* dx, void* dw,
                                  void* ws, int n, int h, int w, int c, int dtype, int norm_in,
                                  int relu, int pad, int dw_blocks, void* stream) {
  Geom geo;
  const int bad = make_geom(n, h, w, c, pad, relu, &geo);
  if (bad) return bad;
  if (dw_blocks < 1 || (dx == nullptr) != (dxp == nullptr)) return (int)cudaErrorInvalidValue;
  const float* wp = static_cast<const float*>(w2p);
  const float* st = static_cast<const float*>(stats);
  float* d = static_cast<float*>(dw);
  float* wk = static_cast<float*>(ws);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return backward<__nv_bfloat16>(x, wp, g, st, gc, dxp, dx, d, wk, dw_blocks, geo, norm_in, s);
  return backward<float>(x, wp, g, st, gc, dxp, dx, d, wk, dw_blocks, geo, norm_in, s);
}
