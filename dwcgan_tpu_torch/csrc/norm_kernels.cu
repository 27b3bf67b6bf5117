// Normalisation kernels for NHWC activations on Hopper (sm_90a), forward and
// backward.
//
// Replaces the Pallas TPU kernels of dwcgan_tpu/ops/pallas/norm_kernels.py:
//   instance_norm_pallas  (_in_fwd_kernel)          -> dwc_instance_norm
//   adain_pallas          (_adain_fwd_kernel)       -> dwc_adain, residual == NULL
//   adain_residual_pallas (x + adain_pallas(y))     -> dwc_adain, residual == x
//   layer_norm_ref_pallas (_ln_fwd_kernel)          -> dwc_layer_norm_ref
//   instance_norm_pallas  backward (_in_bwd_kernel)    -> dwc_instance_norm_bwd
//   adain_pallas          backward (_adain_bwd_kernel) -> dwc_adain_bwd (also
//                         the residual form: its dx of x is the incoming grad)
//   layer_norm_ref_pallas backward (_ln_bwd_kernel)    -> dwc_layer_norm_ref_bwd
//
// What bounds them: each reads one or two activations and writes one of the
// same size, with a handful of flops per element, so all are bound by
// device-memory bytes.  At batch 32 in bf16 the content encoder's
// [32,128,128,64] instance norm must move 2 x 67 MB = 134 MB, about 40 us at
// the H100 SXM's data-sheet 3.35 TB/s; its backward reads x and the incoming
// gradient and writes dx: 3 x 67 MB, 60 us.
//
// Design.  The TPU kernel held one sample in VMEM and read it once.  A
// sample here is up to 2 MB, far beyond a block's 227 KB of shared memory,
// and one block per sample would leave 100 of the 132 SMs idle at batch 32.
// So every op is split over (row chunk, sample) blocks:
//   1. moments: each block sums x (and x^2 for "1pass") per channel over its
//      rows into a small fp32 workspace [n][splits][c];
//   2. finalize: one block per sample reduces the partial sums to the
//      statistics, per channel (instance norm, AdaIN) or per sample
//      (LayerNorm: all of H*W*C, unbiased std, divided as std + eps);
//   ("2pass" runs 1-2 twice: the second time the moments are the squares
//   centred on the finished mean, as in dwcgan_tpu/ops/norms.py:84-93)
//   3. apply: normalise, the affine, ReLU and the residual add in one pass.
// So "1pass" reads the activation twice and "2pass" three times; the
// repeat reads come from the 50 MB L2 when the tensor fits there.  Threads
// load 16 bytes at a time along the channels; a block walks its rows with
// consecutive threads on consecutive addresses.  Statistics and arithmetic
// are fp32 for fp32 and bf16 data alike; eps is 1e-5.  The statistics
// (mean, and the factor that multiplies x - mean) go to a separate fp32
// tensor [n][2][c] that the backward reuses, so it never recomputes moments.
//
// The backward has the same split.  With g' the incoming gradient (times the
// ReLU mask, which is read from the saved forward output: y > 0) and
// xh = (x - mean) * factor:
//   1. sums: per (row chunk, sample) block, per channel, sum g' and g' * xh;
//   2. finalize, one block per sample: the per-(n, c) sums (AdaIN: these are
//      dbias and dscale); the LayerNorm also forms its per-sample scalars
//      sum_c gamma_c sum g and sum_c gamma_c sum g * xh;
//   3. apply: IN   dx = f * (g' - mean g' - xh * mean(g' xh)),
//             AdaIN the same times scale[n, c],
//             LN   dx = (gamma_c g - A / m) * f - (x - mean) * B / ((m-1) s d)
//      with d = 1/f = std + eps, s = std, m = H*W*C (the Pallas rule's
//      dx = du - mean(du) with sum (x - mean) taken as 0);
//   4. LayerNorm only: dgamma[c] = sum_n sum g * xh, dbeta[c] = sum_n sum g,
//      a second small pass over the per-sample sums, so no atomics and the
//      sums do not depend on the order blocks run in.
// Both stats modes share this backward: the 1pass variance is the same
// function of x as the 2pass one (away from its clamp at 0).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kEps = 1e-5f;

// elements per 16-byte load
template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int kWidth = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int kWidth = 8; };

__device__ __forceinline__ void load16(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* v) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store16(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store16(__nv_bfloat16* p, const float* v) {
  uint4 a;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&a);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = a;
}

// v as a tensor of T holds it: rounded to bf16 and back, or fp32 as it is
template <typename T> __device__ __forceinline__ float rounded(float v) { return v; }
template <> __device__ __forceinline__ float rounded<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// activation [n, hw, c] (NHWC), cut into `splits` chunks of `rows` rows
struct Geom {
  int n, hw, c, splits, rows;
};

// workspace layout: part_sum [n][splits][c], part_sq [n][splits][c]; the
// statistics stats [n][2][c] (mean, then the factor that multiplies
// x - mean; a per-sample statistic sits at channel 0) are a tensor of their
// own, kept for the backward
struct Work {
  float* part_sum;
  float* part_sq;
  float* stats;
};

__device__ __forceinline__ float block_sum(float v, float* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // scratch may still be read from a previous call
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float t = 0.f;
  for (int i = 0; i < kThreads / 32; ++i) t += scratch[i];
  return t;
}

// Sum the per-lane partials of a block (red_*[lane][c]) over its lanes and
// store them as this block's row of the [n][splits][c] partial sums.
__device__ __forceinline__ void store_partials(const float* red_a, const float* red_b,
                                               float* out_a, float* out_b, int lanes,
                                               const Geom& g, int n, int s) {
  for (int c = threadIdx.x; c < g.c; c += kThreads) {
    float sa = 0.f, sb = 0.f;
    for (int l = 0; l < lanes; ++l) {
      sa += red_a[l * g.c + c];
      sb += red_b[l * g.c + c];
    }
    const size_t o = ((size_t)n * g.splits + s) * g.c + c;
    if (out_a) out_a[o] = sa;
    if (out_b) out_b[o] = sb;
  }
}

// ------------------------------------------------------------------ forward

// Pass 1.  kCentred == false: sums of x (and of x^2 when kSquares) per
// channel over this block's rows.  kCentred == true: sums of (x - mean)^2,
// the mean read from stats (per channel, or one per sample).
template <typename T, bool kCentred, bool kSquares, bool kPerSample>
__global__ void __launch_bounds__(kThreads)
moments_kernel(const T* __restrict__ x, Work w, Geom g) {
  constexpr int V = Vec<T>::kWidth;
  __shared__ float red_a[kThreads * V];
  __shared__ float red_b[kThreads * V];
  const int s = blockIdx.x, n = blockIdx.y;
  const int groups = g.c / V, lanes = kThreads / groups;
  const int grp = threadIdx.x % groups, lane = threadIdx.x / groups;
  const int c0 = grp * V;
  float a[V], b[V], mean[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    a[i] = 0.f;
    b[i] = 0.f;
    mean[i] = 0.f;
    if (kCentred) {
      const float* st = w.stats + (size_t)n * 2 * g.c;
      mean[i] = kPerSample ? st[0] : st[c0 + i];
    }
  }
  if (lane < lanes) {
    const T* xs = x + (size_t)n * g.hw * g.c + c0;
    const int r_end = min(g.hw, (s + 1) * g.rows);
    for (int r = s * g.rows + lane; r < r_end; r += lanes) {
      float v[V];
      load16(xs + (size_t)r * g.c, v);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        if (kCentred) {
          const float d = v[i] - mean[i];
          b[i] += d * d;
        } else {
          a[i] += v[i];
          if (kSquares) b[i] += v[i] * v[i];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < V; ++i) {
      red_a[lane * g.c + c0 + i] = a[i];
      red_b[lane * g.c + c0 + i] = b[i];
    }
  }
  __syncthreads();
  store_partials(red_a, red_b, kCentred ? nullptr : w.part_sum,
                 (kCentred || kSquares) ? w.part_sq : nullptr, lanes, g, n, s);
}

// Pass 2, one block per sample: statistics from the partial sums.
// Per channel (instance norm, AdaIN): mean = sum / hw, var = E[(x-mean)^2]
// (kTwoPass) or max(E[x^2] - mean^2, 0), factor = 1 / sqrt(var + eps).
// Per sample (reference LayerNorm over m = hw*c): unbiased var, centred
// (kTwoPass) or max(sum x^2 - m mean^2, 0) / (m - 1), factor = 1/(std + eps).
// kMeanOnly writes the mean alone, for the centred pass of "2pass".
template <bool kPerSample, bool kTwoPass, bool kMeanOnly>
__global__ void __launch_bounds__(kThreads) finalize_kernel(Work w, Geom g) {
  __shared__ float scratch[kThreads / 32];
  const int n = blockIdx.x;
  const float* ps = w.part_sum + (size_t)n * g.splits * g.c;
  const float* pq = w.part_sq + (size_t)n * g.splits * g.c;
  float* st = w.stats + (size_t)n * 2 * g.c;
  if (!kPerSample) {
    const float hw = (float)g.hw;
    for (int c = threadIdx.x; c < g.c; c += kThreads) {
      float sa = 0.f, sb = 0.f;
      for (int s = 0; s < g.splits; ++s) {
        sa += ps[s * g.c + c];
        if (!kMeanOnly) sb += pq[s * g.c + c];
      }
      const float mean = sa / hw;
      st[c] = mean;
      if (!kMeanOnly) {
        const float var = kTwoPass ? sb / hw : fmaxf(sb / hw - mean * mean, 0.f);
        st[g.c + c] = 1.f / sqrtf(var + kEps);
      }
    }
    return;
  }
  float sa = 0.f, sb = 0.f;
  for (int i = threadIdx.x; i < g.splits * g.c; i += kThreads) {
    sa += ps[i];
    if (!kMeanOnly) sb += pq[i];
  }
  sa = block_sum(sa, scratch);
  if (!kMeanOnly) sb = block_sum(sb, scratch);
  if (threadIdx.x == 0) {
    const float m = (float)g.hw * (float)g.c;
    const float mean = sa / m;
    st[0] = mean;
    if (!kMeanOnly) {
      const float dof = fmaxf(m - 1.f, 1.f);
      const float var = kTwoPass ? sb / dof : fmaxf(sb - m * mean * mean, 0.f) / dof;
      st[g.c] = 1.f / (sqrtf(var) + kEps);
    }
  }
}

enum Affine { kNoAffine = 0, kSampleChannel = 1, kChannel = 2 };

// Pass 3: y = (x - mean) * factor, then * mul + add (AdaIN: [n, c] scale and
// bias; LayerNorm: [c] gamma and beta), ReLU, + residual; one read, one write.
template <typename T, int kAffine, bool kPerSample, bool kRelu, bool kResidual>
__global__ void __launch_bounds__(kThreads)
apply_kernel(const T* __restrict__ x, const float* __restrict__ mul,
             const float* __restrict__ add, const T* __restrict__ residual,
             T* __restrict__ y, Work w, Geom g) {
  constexpr int V = Vec<T>::kWidth;
  const int s = blockIdx.x, n = blockIdx.y;
  const int groups = g.c / V, lanes = kThreads / groups;
  const int grp = threadIdx.x % groups, lane = threadIdx.x / groups;
  if (lane >= lanes) return;
  const int c0 = grp * V;
  const float* st = w.stats + (size_t)n * 2 * g.c;
  float mean[V], f[V], sc[V], bi[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = c0 + i;
    mean[i] = kPerSample ? st[0] : st[c];
    f[i] = kPerSample ? st[g.c] : st[g.c + c];
    sc[i] = 1.f;
    bi[i] = 0.f;
    if (kAffine == kSampleChannel) {
      sc[i] = mul[(size_t)n * g.c + c];
      bi[i] = add[(size_t)n * g.c + c];
    } else if (kAffine == kChannel) {
      sc[i] = mul[c];
      bi[i] = add[c];
    }
  }
  const size_t base = (size_t)n * g.hw * g.c + c0;
  const int r_end = min(g.hw, (s + 1) * g.rows);
  for (int r = s * g.rows + lane; r < r_end; r += lanes) {
    const size_t off = base + (size_t)r * g.c;
    float v[V], o[V], rv[V];
    load16(x + off, v);
    if (kResidual) load16(residual + off, rv);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      float t = (v[i] - mean[i]) * f[i];
      if (kAffine != kNoAffine) t = t * sc[i] + bi[i];
      if (kRelu) t = fmaxf(t, 0.f);
      // x + AdaIN(y) with AdaIN(y) already in T, as the reference adds
      // two tensors of the compute dtype: T rounds twice
      if (kResidual) t = rounded<T>(t) + rv[i];
      o[i] = t;
    }
    store16(y + off, o);
  }
}

template <typename T, int kAffine, bool kPerSample, bool kRelu, bool kResidual>
int launch(const void* x, const float* mul, const float* add, const void* residual,
           void* y, float* stats, float* ws, Geom g, bool two_pass, cudaStream_t stream) {
  const size_t part = (size_t)g.n * g.splits * g.c;
  const Work w{ws, ws + part, stats};
  const T* xt = static_cast<const T*>(x);
  const dim3 grid(g.splits, g.n);
  if (two_pass) {
    moments_kernel<T, false, false, kPerSample><<<grid, kThreads, 0, stream>>>(xt, w, g);
    finalize_kernel<kPerSample, true, true><<<g.n, kThreads, 0, stream>>>(w, g);
    moments_kernel<T, true, false, kPerSample><<<grid, kThreads, 0, stream>>>(xt, w, g);
    finalize_kernel<kPerSample, true, false><<<g.n, kThreads, 0, stream>>>(w, g);
  } else {
    moments_kernel<T, false, true, kPerSample><<<grid, kThreads, 0, stream>>>(xt, w, g);
    finalize_kernel<kPerSample, false, false><<<g.n, kThreads, 0, stream>>>(w, g);
  }
  apply_kernel<T, kAffine, kPerSample, kRelu, kResidual><<<grid, kThreads, 0, stream>>>(
      xt, mul, add, static_cast<const T*>(residual), static_cast<T*>(y), w, g);
  return (int)cudaGetLastError();
}

// 0 when the shape suits the kernels: whole 16-byte vectors along the
// channels and no more channel groups than threads in a block
int check(int n, int hw, int c, int splits, int width, Geom* g) {
  if (n < 1 || hw < 1 || c < width || c % width != 0 || c / width > kThreads ||
      splits < 1 || splits > hw)
    return (int)cudaErrorInvalidValue;
  *g = Geom{n, hw, c, splits, (hw + splits - 1) / splits};
  return 0;
}

template <typename T, int kAffine, bool kPerSample>
int dispatch(const void* x, const float* mul, const float* add, const void* residual,
             void* y, float* stats, float* ws, int n, int hw, int c, int splits,
             int two_pass, int relu, void* stream) {
  Geom g;
  const int bad = check(n, hw, c, splits, Vec<T>::kWidth, &g);
  if (bad) return bad;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (residual)
    return relu ? launch<T, kAffine, kPerSample, true, true>(x, mul, add, residual, y, stats, ws, g, two_pass, st)
                : launch<T, kAffine, kPerSample, false, true>(x, mul, add, residual, y, stats, ws, g, two_pass, st);
  return relu ? launch<T, kAffine, kPerSample, true, false>(x, mul, add, residual, y, stats, ws, g, two_pass, st)
              : launch<T, kAffine, kPerSample, false, false>(x, mul, add, residual, y, stats, ws, g, two_pass, st);
}

// ----------------------------------------------------------------- backward

// backward workspace: part_a, part_b [n][splits][c] (per-block sums of g'
// and g' * xh); sum_a, sum_b [n][c] (their totals per sample: for AdaIN the
// dbias and dscale outputs themselves); scal [n][2] (LayerNorm's A and B)
struct BwdWork {
  float* part_a;
  float* part_b;
  float* sum_a;
  float* sum_b;
  float* scal;
};

// Backward pass 1: per channel over this block's rows, sums of g' and
// g' * xh, with g' = g * [y > 0] when kRelu and xh = (x - mean) * factor.
template <typename T, bool kPerSample, bool kRelu>
__global__ void __launch_bounds__(kThreads)
bwd_sums_kernel(const T* __restrict__ x, const T* __restrict__ y,
                const T* __restrict__ gr, const float* __restrict__ stats,
                BwdWork w, Geom g) {
  constexpr int V = Vec<T>::kWidth;
  __shared__ float red_a[kThreads * V];
  __shared__ float red_b[kThreads * V];
  const int s = blockIdx.x, n = blockIdx.y;
  const int groups = g.c / V, lanes = kThreads / groups;
  const int grp = threadIdx.x % groups, lane = threadIdx.x / groups;
  const int c0 = grp * V;
  const float* st = stats + (size_t)n * 2 * g.c;
  float a[V], b[V], mean[V], f[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    a[i] = 0.f;
    b[i] = 0.f;
    mean[i] = kPerSample ? st[0] : st[c0 + i];
    f[i] = kPerSample ? st[g.c] : st[g.c + c0 + i];
  }
  if (lane < lanes) {
    const size_t base = (size_t)n * g.hw * g.c + c0;
    const int r_end = min(g.hw, (s + 1) * g.rows);
    for (int r = s * g.rows + lane; r < r_end; r += lanes) {
      const size_t off = base + (size_t)r * g.c;
      float xv[V], gv[V], yv[V];
      load16(x + off, xv);
      load16(gr + off, gv);
      if (kRelu) load16(y + off, yv);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float gi = (!kRelu || yv[i] > 0.f) ? gv[i] : 0.f;
        a[i] += gi;
        b[i] += gi * ((xv[i] - mean[i]) * f[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < V; ++i) {
      red_a[lane * g.c + c0 + i] = a[i];
      red_b[lane * g.c + c0 + i] = b[i];
    }
  }
  __syncthreads();
  store_partials(red_a, red_b, w.part_a, w.part_b, lanes, g, n, s);
}

// Backward pass 2, one block per sample: per-channel totals over the row
// chunks; with gamma (LayerNorm) also A = sum_c gamma_c sum_a[c] and
// B = sum_c gamma_c sum_b[c].
template <bool kPerSample>
__global__ void __launch_bounds__(kThreads)
bwd_finalize_kernel(const float* __restrict__ gamma, BwdWork w, Geom g) {
  __shared__ float scratch[kThreads / 32];
  const int n = blockIdx.x;
  const float* pa = w.part_a + (size_t)n * g.splits * g.c;
  const float* pb = w.part_b + (size_t)n * g.splits * g.c;
  float ta = 0.f, tb = 0.f;
  for (int c = threadIdx.x; c < g.c; c += kThreads) {
    float sa = 0.f, sb = 0.f;
    for (int s = 0; s < g.splits; ++s) {
      sa += pa[s * g.c + c];
      sb += pb[s * g.c + c];
    }
    w.sum_a[(size_t)n * g.c + c] = sa;
    w.sum_b[(size_t)n * g.c + c] = sb;
    if (kPerSample) {
      ta += gamma[c] * sa;
      tb += gamma[c] * sb;
    }
  }
  if (kPerSample) {
    ta = block_sum(ta, scratch);
    tb = block_sum(tb, scratch);
    if (threadIdx.x == 0) {
      w.scal[2 * n] = ta;
      w.scal[2 * n + 1] = tb;
    }
  }
}

enum BwdOp { kIn = 0, kAdain = 1, kLn = 2 };

// Backward pass 3: dx, one read of x, g (and y for the mask), one write.
template <typename T, int kOp, bool kRelu>
__global__ void __launch_bounds__(kThreads)
bwd_apply_kernel(const T* __restrict__ x, const T* __restrict__ y,
                 const T* __restrict__ gr, const float* __restrict__ stats,
                 const float* __restrict__ mul, T* __restrict__ dx, BwdWork w, Geom g) {
  constexpr int V = Vec<T>::kWidth;
  constexpr bool kPerSample = kOp == kLn;
  const int s = blockIdx.x, n = blockIdx.y;
  const int groups = g.c / V, lanes = kThreads / groups;
  const int grp = threadIdx.x % groups, lane = threadIdx.x / groups;
  if (lane >= lanes) return;
  const int c0 = grp * V;
  const float* st = stats + (size_t)n * 2 * g.c;
  // dx = cg * g' - c0v - (x - mean) * cu, per channel constants
  float mean[V], cg[V], cc[V], cu[V];
  if (kPerSample) {
    const float f = st[g.c];
    const float d = 1.f / f, sd = d - kEps;
    const float m = (float)g.hw * (float)g.c;
    const float a = w.scal[2 * n], b = w.scal[2 * n + 1];
    const float k = b / (fmaxf(m - 1.f, 1.f) * sd * d);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      mean[i] = st[0];
      cg[i] = mul[c0 + i] * f;
      cc[i] = a / m * f;
      cu[i] = k;
    }
  } else {
    const float hw = (float)g.hw;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int c = c0 + i;
      const size_t nc = (size_t)n * g.c + c;
      const float f = st[g.c + c];
      const float k = kOp == kAdain ? f * mul[nc] : f;
      mean[i] = st[c];
      cg[i] = k;
      cc[i] = k * w.sum_a[nc] / hw;
      cu[i] = k * f * w.sum_b[nc] / hw;   // xh * mean(g' xh) = (x - mean) f ...
    }
  }
  const size_t base = (size_t)n * g.hw * g.c + c0;
  const int r_end = min(g.hw, (s + 1) * g.rows);
  for (int r = s * g.rows + lane; r < r_end; r += lanes) {
    const size_t off = base + (size_t)r * g.c;
    float xv[V], gv[V], yv[V], o[V];
    load16(x + off, xv);
    load16(gr + off, gv);
    if (kRelu) load16(y + off, yv);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float gi = (!kRelu || yv[i] > 0.f) ? gv[i] : 0.f;
      o[i] = cg[i] * gi - cc[i] - (xv[i] - mean[i]) * cu[i];
    }
    store16(dx + off, o);
  }
}

// Backward pass 4 (LayerNorm): dgamma[c] = sum_n sum_b[n][c] and
// dbeta[c] = sum_n sum_a[n][c], one thread per channel, samples in order.
__global__ void __launch_bounds__(kThreads)
ln_param_grads_kernel(BwdWork w, float* __restrict__ dgamma, float* __restrict__ dbeta,
                      Geom g) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= g.c) return;
  float da = 0.f, db = 0.f;
  for (int n = 0; n < g.n; ++n) {
    da += w.sum_a[(size_t)n * g.c + c];
    db += w.sum_b[(size_t)n * g.c + c];
  }
  dbeta[c] = da;
  dgamma[c] = db;
}

template <typename T, int kOp, bool kRelu>
int launch_bwd(const void* x, const void* y, const void* gr, const float* stats,
               const float* mul, void* dx, BwdWork w, Geom g, cudaStream_t stream) {
  constexpr bool kPerSample = kOp == kLn;
  const T* xt = static_cast<const T*>(x);
  const T* yt = static_cast<const T*>(y);
  const T* gt = static_cast<const T*>(gr);
  const dim3 grid(g.splits, g.n);
  bwd_sums_kernel<T, kPerSample, kRelu><<<grid, kThreads, 0, stream>>>(xt, yt, gt, stats, w, g);
  bwd_finalize_kernel<kPerSample><<<g.n, kThreads, 0, stream>>>(mul, w, g);
  bwd_apply_kernel<T, kOp, kRelu><<<grid, kThreads, 0, stream>>>(
      xt, yt, gt, stats, mul, static_cast<T*>(dx), w, g);
  return (int)cudaGetLastError();
}

template <typename T, int kOp>
int dispatch_bwd(const void* x, const void* y, const void* gr, const float* stats,
                 const float* mul, void* dx, BwdWork w, int n, int hw, int c, int splits,
                 void* stream, Geom* geom) {
  const int bad = check(n, hw, c, splits, Vec<T>::kWidth, geom);
  if (bad) return bad;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (y) return launch_bwd<T, kOp, true>(x, y, gr, stats, mul, dx, w, *geom, st);
  return launch_bwd<T, kOp, false>(x, y, gr, stats, mul, dx, w, *geom, st);
}

BwdWork bwd_work(void* ws, int n, int c, int splits, float* sum_a, float* sum_b) {
  float* f = static_cast<float*>(ws);
  const size_t part = (size_t)n * splits * c;
  BwdWork w{f, f + part, sum_a, sum_b, nullptr};
  if (!sum_a) {  // the totals live in the workspace too
    w.sum_a = f + 2 * part;
    w.sum_b = f + 2 * part + (size_t)n * c;
    w.scal = f + 2 * part + 2 * (size_t)n * c;
  }
  return w;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  stats: float32 [n][2][c], written by
// the forward and read by the backward.  ws: float32 workspace; forward:
// 2 * n * splits * c elements; backward: 2 * n * splits * c + 2 * n * c + 2 * n.
// Each returns cudaGetLastError() after its launches.

extern "C" int dwc_instance_norm(const void* x, void* y, void* stats, void* ws, int n,
                                 int hw, int c, int splits, int dtype, int two_pass,
                                 int relu, void* stream) {
  float* w = static_cast<float*>(ws);
  float* st = static_cast<float*>(stats);
  if (dtype == 1)
    return dispatch<__nv_bfloat16, kNoAffine, false>(x, nullptr, nullptr, nullptr, y, st, w, n,
                                                     hw, c, splits, two_pass, relu, stream);
  return dispatch<float, kNoAffine, false>(x, nullptr, nullptr, nullptr, y, st, w, n, hw, c,
                                           splits, two_pass, relu, stream);
}

// residual: NULL for AdaIN, else the tensor added after it (adain_residual)
extern "C" int dwc_adain(const void* x, const void* scale, const void* bias,
                         const void* residual, void* y, void* stats, void* ws, int n, int hw,
                         int c, int splits, int dtype, int two_pass, int relu, void* stream) {
  const float* s = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  float* w = static_cast<float*>(ws);
  float* st = static_cast<float*>(stats);
  if (dtype == 1)
    return dispatch<__nv_bfloat16, kSampleChannel, false>(x, s, b, residual, y, st, w, n, hw,
                                                          c, splits, two_pass, relu, stream);
  return dispatch<float, kSampleChannel, false>(x, s, b, residual, y, st, w, n, hw, c, splits,
                                                two_pass, relu, stream);
}

extern "C" int dwc_layer_norm_ref(const void* x, const void* gamma, const void* beta, void* y,
                                  void* stats, void* ws, int n, int hw, int c, int splits,
                                  int dtype, int two_pass, void* stream) {
  const float* ga = static_cast<const float*>(gamma);
  const float* be = static_cast<const float*>(beta);
  float* w = static_cast<float*>(ws);
  float* st = static_cast<float*>(stats);
  if (dtype == 1)
    return dispatch<__nv_bfloat16, kChannel, true>(x, ga, be, nullptr, y, st, w, n, hw, c,
                                                   splits, two_pass, 0, stream);
  return dispatch<float, kChannel, true>(x, ga, be, nullptr, y, st, w, n, hw, c, splits,
                                         two_pass, 0, stream);
}

// y: the forward output when the forward fused a ReLU (its mask is y > 0),
// else NULL.
extern "C" int dwc_instance_norm_bwd(const void* x, const void* y, const void* g,
                                     const void* stats, void* dx, void* ws, int n, int hw,
                                     int c, int splits, int dtype, void* stream) {
  const float* st = static_cast<const float*>(stats);
  const BwdWork w = bwd_work(ws, n, c, splits, nullptr, nullptr);
  Geom geom;
  if (dtype == 1)
    return dispatch_bwd<__nv_bfloat16, kIn>(x, y, g, st, nullptr, dx, w, n, hw, c, splits,
                                            stream, &geom);
  return dispatch_bwd<float, kIn>(x, y, g, st, nullptr, dx, w, n, hw, c, splits, stream, &geom);
}

// dscale, dbias: float32 [n][c] outputs.  The residual form x + AdaIN(y)
// calls this for its y with y's output mask off (its x gradient is g).
extern "C" int dwc_adain_bwd(const void* x, const void* y, const void* g, const void* stats,
                             const void* scale, void* dx, void* dscale, void* dbias, void* ws,
                             int n, int hw, int c, int splits, int dtype, void* stream) {
  const float* st = static_cast<const float*>(stats);
  const float* sc = static_cast<const float*>(scale);
  const BwdWork w = bwd_work(ws, n, c, splits, static_cast<float*>(dbias),
                             static_cast<float*>(dscale));
  Geom geom;
  if (dtype == 1)
    return dispatch_bwd<__nv_bfloat16, kAdain>(x, y, g, st, sc, dx, w, n, hw, c, splits,
                                               stream, &geom);
  return dispatch_bwd<float, kAdain>(x, y, g, st, sc, dx, w, n, hw, c, splits, stream, &geom);
}

// dgamma, dbeta: float32 [c] outputs, summed over the batch.
extern "C" int dwc_layer_norm_ref_bwd(const void* x, const void* g, const void* stats,
                                      const void* gamma, void* dx, void* dgamma, void* dbeta,
                                      void* ws, int n, int hw, int c, int splits, int dtype,
                                      void* stream) {
  const float* st = static_cast<const float*>(stats);
  const float* ga = static_cast<const float*>(gamma);
  const BwdWork w = bwd_work(ws, n, c, splits, nullptr, nullptr);
  Geom geom;
  const int err = dtype == 1
      ? dispatch_bwd<__nv_bfloat16, kLn>(x, nullptr, g, st, ga, dx, w, n, hw, c, splits,
                                         stream, &geom)
      : dispatch_bwd<float, kLn>(x, nullptr, g, st, ga, dx, w, n, hw, c, splits, stream, &geom);
  if (err) return err;
  ln_param_grads_kernel<<<(c + kThreads - 1) / kThreads, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      w, static_cast<float*>(dgamma), static_cast<float*>(dbeta), geom);
  return (int)cudaGetLastError();
}
