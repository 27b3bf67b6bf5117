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
// The instance-norm and AdaIN backwards (rows 5 and 6 of the port's kernel
// table) are one launch each: a thread-block cluster per sample.  With g'
// the incoming gradient times the ReLU mask and xh = (x - mean) * factor,
// they need per (n, c) the sums of g' and g' * xh over H*W, then
//   IN     dx = f * (g' - mean g' - xh * mean(g' xh)),
//   AdaIN  the same times scale[n, c]; dbias = sum g', dscale = sum g' xh.
// Bound: bytes; x and g read once and dx written once (3 tensors).  A
// split into sums, finalize and apply kernels moved 5 (7 with a ReLU mask
// read from y) and crossed two kernel boundaries per call.  So:
//   - k <= 8 blocks of a cluster split a sample's rows into k contiguous
//     slabs; each block copies as much of its slab's x and g as fits in
//     half an SM's shared memory (two blocks per SM) with bulk asynchronous
//     copies (cp.async.bulk on mbarriers), all requested at once, and
//     streams the rest;
//   - each block sums its slab per channel in a fixed order, then every
//     block reads the k partial vectors through distributed shared memory
//     in rank order: all hold the same totals, bit-equal from run to run,
//     with no workspace, atomics or second launch;
//   - dx from the staged slab (the streamed rows read again, from L2
//     where they are still there), stored 16 bytes at a time;
//   - the ReLU mask is recomputed from x and the statistics: rounded<T>(t)
//     > 0 with t the forward's own fp32 expression (normed / affine below,
//     called by both kernels), which is y > 0 exactly; y is not read.
// The reference LayerNorm's backward keeps the (row chunk, sample) split:
//   1. sums of g and g * xh per channel per block; 2. finalize, one block
//   per sample: the per-channel totals and the per-sample scalars
//   A = sum_c gamma_c sum g, B = sum_c gamma_c sum g * xh; 3. apply:
//   dx = (gamma_c g - A / m) * f - (x - mean) * B / ((m-1) s d), with
//   d = 1/f = std + eps, s = std, m = H*W*C (the Pallas rule's dx = du -
//   mean(du) with sum (x - mean) taken as 0); 4. dgamma[c] = sum_n sum g *
//   xh, dbeta[c] = sum_n sum g, a small pass over the per-sample sums, so no
//   atomics and the sums do not depend on the order blocks run in.
// Both stats modes share the backwards: the 1pass variance is the same
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

// 16 bytes of T (V elements) as fp32
template <typename T> __device__ __forceinline__ void unpack16(uint4 a, float* v);
template <> __device__ __forceinline__ void unpack16<float>(uint4 a, float* v) {
  v[0] = __uint_as_float(a.x);
  v[1] = __uint_as_float(a.y);
  v[2] = __uint_as_float(a.z);
  v[3] = __uint_as_float(a.w);
}
template <> __device__ __forceinline__ void unpack16<__nv_bfloat16>(uint4 a, float* v) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ uint4 ld16(const void* p) {
  return *reinterpret_cast<const uint4*>(p);
}

template <typename T> __device__ __forceinline__ void load16(const T* p, float* v) {
  unpack16<T>(ld16(p), v);
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

// The forward's value before its ReLU at one element, in two steps that
// apply_kernel and the backward's mask both call: xh = (x - mean) * factor,
// then, with an affine, xh * scale + bias.  The round-to-nearest intrinsics
// keep the compiler from contracting either kernel's copy differently, so
// rounded<T>(t) > 0 in the backward is y > 0 of the forward, bit for bit.
__device__ __forceinline__ float normed(float v, float mean, float f) {
  return __fmul_rn(__fsub_rn(v, mean), f);
}
__device__ __forceinline__ float affine(float t, float sc, float bi) {
  return __fmaf_rn(t, sc, bi);
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
      float t = normed(v[i], mean[i], f[i]);
      if (kAffine != kNoAffine) t = affine(t, sc[i], bi[i]);
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

enum BwdOp { kIn = 0, kAdain = 1 };

// ------------------------------- backward: instance norm and AdaIN, clusters

// One cluster of k blocks per sample: grid (k, n), cluster (k, 1).  Block
// `rank` owns rows [rank * hw / k, (rank + 1) * hw / k) of its sample, an
// NHWC slab that is one contiguous byte range.  Its first `resident` rows
// of x and g come into shared memory by bulk asynchronous copies
// (cp.async.bulk, kChunks of them, each completing on its own mbarrier),
// all requested at once; the rest of the slab is streamed from device
// memory twice, the second time from L2 where it is still there.  Shared memory, in bytes
// from its base (bwd_smem, mirrored by ops/cuda/kernels.py's bwd_plan):
//   xs, gs  resident * c elements of T each
//   red     2 * kThreads * V floats: each lane's partial sums
//   part    2 * c floats: this block's sums of g' and g' * xh, which every
//           block of the cluster reads through distributed shared memory
//   tot     2 * c floats: the cluster's totals
//   bar     kChunks mbarriers
constexpr int kChunks = 4;
constexpr int kUnroll = 4;       // streamed rows in flight per thread
constexpr int kMaxCluster = 8;   // the portable cluster size

struct BwdSmem {
  size_t gs, red, part, tot, bar, total;
};

__host__ __device__ __forceinline__ BwdSmem bwd_smem(int c, int resident, int size,
                                                     int width) {
  BwdSmem s;
  s.gs = (size_t)resident * c * size;
  s.red = 2 * s.gs;
  s.part = s.red + 2 * (size_t)kThreads * width * sizeof(float);
  s.tot = s.part + 2 * (size_t)c * sizeof(float);
  s.bar = s.tot + 2 * (size_t)c * sizeof(float);
  s.total = s.bar + kChunks * sizeof(uint64_t);
  return s;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Wait for phase `parity` of the mbarrier to complete.  A copy that never
// lands traps (a launch error) after some seconds instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t spin = 0; !done; ++spin) {
    if (spin == (1u << 24)) __trap();
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// `bytes` (a multiple of 16) from device memory into this block's shared
// memory; completes on the mbarrier `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// the address `local` of this block's shared memory in the block of cluster
// rank `rank` (a shared::cluster address)
__device__ __forceinline__ uint32_t cluster_addr(uint32_t local, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(local), "r"(rank));
  return remote;
}

// a load from a shared::cluster address; not volatile, so that several are
// in flight at once (the address comes from mapa after the cluster barrier,
// which keeps the load after it)
__device__ __forceinline__ float ld_cluster(uint32_t addr) {
  float v;
  asm("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}

// What one thread keeps: its V channels' statistics and affine, its sums
// of g' and g' * xh, then the terms of dx = kk (g' - ma - xh mb), the
// plain rule's order: kk = f (AdaIN: f * scale), ma = mean g', mb =
// mean(g' xh); where g' - ma cancels (one pixel) dx is exactly 0
template <typename T, bool kAdain, bool kRelu>
struct BwdLane {
  static constexpr int V = Vec<T>::kWidth;
  float mean[V], f[V], sc[V], bi[V], a[V], b[V], kk[V], ma[V], mb[V];
  unsigned bad = 0;   // elements whose mask differs from y > 0 (the check)

  // g' = g where the forward's ReLU passed, else 0: rounded<T>(t) > 0
  __device__ __forceinline__ bool on(float xh, int i) const {
    if (!kRelu) return true;
    return rounded<T>(kAdain ? affine(xh, sc[i], bi[i]) : xh) > 0.f;
  }

  // one row's 16 bytes of x and of g (yp: of y, read by the check only)
  template <bool kCheck>
  __device__ __forceinline__ void sum(uint4 xr, uint4 gq, const T* yp) {
    float xv[V], gv[V], yv[V];
    unpack16<T>(xr, xv);
    unpack16<T>(gq, gv);
    if (kCheck) load16(yp, yv);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float xh = normed(xv[i], mean[i], f[i]);
      const bool pass = on(xh, i);
      if (kCheck) bad += pass != (yv[i] > 0.f);
      const float gi = pass ? gv[i] : 0.f;
      a[i] += gi;
      b[i] += gi * xh;
    }
  }

  __device__ __forceinline__ void dx(uint4 xr, uint4 gq, T* out) const {
    float xv[V], gv[V], o[V];
    unpack16<T>(xr, xv);
    unpack16<T>(gq, gv);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float xh = normed(xv[i], mean[i], f[i]);
      const float gi = on(xh, i) ? gv[i] : 0.f;
      o[i] = kk[i] * (gi - ma[i] - xh * mb[i]);
    }
    store16(out, o);
  }
};

// dx (and for AdaIN dscale = sum g' xh, dbias = sum g' per (n, c)) in one
// launch.  kCheck: also read y and count the elements whose mask differs
// from y > 0 into *mismatch (a check, never on the training path).
template <typename T, bool kAdain, bool kRelu, bool kCheck>
__global__ void __launch_bounds__(kThreads)
norm_bwd_cluster_kernel(const T* __restrict__ x, const T* __restrict__ gr,
                        const float* __restrict__ stats, const float* __restrict__ scale,
                        const float* __restrict__ bias, T* __restrict__ dx,
                        float* __restrict__ dscale, float* __restrict__ dbias,
                        const T* __restrict__ y, unsigned* __restrict__ mismatch, int hw,
                        int c, int resident) {
  constexpr int V = Vec<T>::kWidth;
  extern __shared__ __align__(16) unsigned char smem[];
  const int k = gridDim.x, rank = blockIdx.x, n = blockIdx.y;
  const int r0 = (int)((long long)rank * hw / k);
  const int rows = (int)((long long)(rank + 1) * hw / k) - r0;
  const int res = min(resident, rows);
  const BwdSmem L = bwd_smem(c, resident, sizeof(T), V);
  T* xs = reinterpret_cast<T*>(smem);
  T* gs = reinterpret_cast<T*>(smem + L.gs);
  float* red = reinterpret_cast<float*>(smem + L.red);
  float* part = reinterpret_cast<float*>(smem + L.part);
  float* tot = reinterpret_cast<float*>(smem + L.tot);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L.bar);
  const size_t base = ((size_t)n * hw + r0) * c;   // the slab's first element
  const int chunks = min(kChunks, res);

  // 1. the whole resident part requested at once, in `chunks` pieces
  if (threadIdx.x == 0) {
    for (int j = 0; j < chunks; ++j) mbar_init(smem_addr(bar + j));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int j = 0; j < chunks; ++j) {
      const size_t ra = (size_t)j * res / chunks, rb = (size_t)(j + 1) * res / chunks;
      const uint32_t bytes = (uint32_t)((rb - ra) * c * sizeof(T));
      const uint32_t mb = smem_addr(bar + j);
      mbar_expect_tx(mb, 2 * bytes);
      bulk_load(smem_addr(xs + ra * c), x + base + ra * c, bytes, mb);
      bulk_load(smem_addr(gs + ra * c), gr + base + ra * c, bytes, mb);
    }
  }
  __syncthreads();   // the mbarriers exist before anyone waits on them

  const int groups = c / V, lanes = kThreads / groups;
  const int grp = threadIdx.x % groups, lane = threadIdx.x / groups;
  const bool active = lane < lanes;
  const int c0 = grp * V;
  const float* st = stats + (size_t)n * 2 * c;
  BwdLane<T, kAdain, kRelu> t;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const size_t nc = (size_t)n * c + c0 + i;
    t.mean[i] = st[c0 + i];
    t.f[i] = st[c + c0 + i];
    t.sc[i] = kAdain ? scale[nc] : 1.f;
    t.bi[i] = kAdain && kRelu ? bias[nc] : 0.f;
    t.a[i] = 0.f;
    t.b[i] = 0.f;
  }

  // 2. sums over the slab, in one fixed order per thread: the streamed rows
  //    first (from device memory, while the copies land), then the resident
  //    rows chunk by chunk as each lands
  if (active) {
    int r = res + lane;
    for (; r + (kUnroll - 1) * lanes < rows; r += kUnroll * lanes) {
      // start the loads of kUnroll rows before using any of them
      uint4 xr[kUnroll], gq[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const size_t off = base + (size_t)(r + u * lanes) * c + c0;
        xr[u] = ld16(x + off);
        gq[u] = ld16(gr + off);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        t.template sum<kCheck>(xr[u], gq[u], y + base + (size_t)(r + u * lanes) * c + c0);
    }
    for (; r < rows; r += lanes) {
      const size_t off = base + (size_t)r * c + c0;
      t.template sum<kCheck>(ld16(x + off), ld16(gr + off), y + off);
    }
  }
  for (int j = 0; j < chunks; ++j) {
    mbar_wait(smem_addr(bar + j), 0);
    if (!active) continue;
    const int ra = (int)((size_t)j * res / chunks), rb = (int)((size_t)(j + 1) * res / chunks);
#pragma unroll 4
    for (int r = ra + lane; r < rb; r += lanes) {
      const size_t so = (size_t)r * c + c0;
      t.template sum<kCheck>(ld16(xs + so), ld16(gs + so), y + base + so);
    }
  }
  if (kCheck && t.bad) atomicAdd(mismatch, t.bad);

  // 3. this block's sums: each lane's, then over the lanes in order
  if (active) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      red[lane * c + c0 + i] = t.a[i];
      red[kThreads * V + lane * c + c0 + i] = t.b[i];
    }
  }
  __syncthreads();
  for (int ch = threadIdx.x; ch < c; ch += kThreads) {
    float sa = 0.f, sb = 0.f;
    for (int l = 0; l < lanes; ++l) {
      sa += red[l * c + ch];
      sb += red[kThreads * V + l * c + ch];
    }
    part[ch] = sa;
    part[c + ch] = sb;
  }

  // 4. the cluster's totals: every block reads the k partial vectors through
  //    distributed shared memory in rank order, so all hold the same fp32
  //    values, the same from run to run; no workspace, no atomics
  cluster_arrive();   // release: this block's part is written
  cluster_wait();     // acquire: so is every other block's
  for (int ch = threadIdx.x; ch < c; ch += kThreads) {
    // the k pairs requested at once, then summed in rank order
    float pa[kMaxCluster], pb[kMaxCluster];
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q) {
      if (q < k) {
        const uint32_t remote = cluster_addr(smem_addr(part + ch), q);
        pa[q] = ld_cluster(remote);
        pb[q] = ld_cluster(remote + (uint32_t)(c * sizeof(float)));
      }
    }
    float sa = 0.f, sb = 0.f;
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q) {
      if (q < k) {
        sa += pa[q];
        sb += pb[q];
      }
    }
    tot[ch] = sa;
    tot[c + ch] = sb;
    if (kAdain && rank == 0) {
      dbias[(size_t)n * c + ch] = sa;
      dscale[(size_t)n * c + ch] = sb;
    }
  }
  cluster_arrive();   // this block is done reading the others' shared memory
  __syncthreads();    // tot

  // 5. dx: the streamed rows again (first, while they are still in L2),
  //    then the resident rows from shared memory (IN: dx = f (g' - mean g'
  //    - xh mean(g' xh)); AdaIN the same times scale[n, c])
  if (active) {
    const float hwf = (float)hw;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      t.kk[i] = kAdain ? t.f[i] * t.sc[i] : t.f[i];
      t.ma[i] = tot[c0 + i] / hwf;
      t.mb[i] = tot[c + c0 + i] / hwf;
    }
    int r = res + lane;
    for (; r + (kUnroll - 1) * lanes < rows; r += kUnroll * lanes) {
      uint4 xr[kUnroll], gq[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const size_t off = base + (size_t)(r + u * lanes) * c + c0;
        xr[u] = ld16(x + off);
        gq[u] = ld16(gr + off);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        t.dx(xr[u], gq[u], dx + base + (size_t)(r + u * lanes) * c + c0);
    }
    for (; r < rows; r += lanes) {
      const size_t off = base + (size_t)r * c + c0;
      t.dx(ld16(x + off), ld16(gr + off), dx + off);
    }
#pragma unroll 4
    for (r = lane; r < res; r += lanes) {
      const size_t so = (size_t)r * c + c0;
      t.dx(ld16(xs + so), ld16(gs + so), dx + base + so);
    }
  }
  cluster_wait();   // no block leaves while another may still read its part
}

struct BwdArgs {
  const void* x;
  const void* g;
  const float* stats;
  const float* scale;
  const float* bias;
  void* dx;
  float* dscale;
  float* dbias;
  const void* y;        // the check's forward output, else NULL
  unsigned* mismatch;   // the check's count, else NULL
  int n, hw, c, k, resident, smem;
};

// Launch the kernel, or (clusters != NULL) set it up: opt in to the largest
// shared memory, and ask how many clusters of this configuration fit on the
// card at once.
template <typename T, bool kAdain, bool kRelu, bool kCheck>
int launch_cluster(const BwdArgs& p, cudaStream_t stream, int* clusters) {
  auto kern = norm_bwd_cluster_kernel<T, kAdain, kRelu, kCheck>;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.k, p.n, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)p.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.k;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (clusters) {
    int dev = 0, optin = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (!e) e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (!e) e = cudaFuncSetAttribute((const void*)kern,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (!e) e = cudaOccupancyMaxActiveClusters(clusters, (const void*)kern, &cfg);
    return (int)e;
  }
  return (int)cudaLaunchKernelEx(
      &cfg, kern, static_cast<const T*>(p.x), static_cast<const T*>(p.g), p.stats, p.scale,
      p.bias, static_cast<T*>(p.dx), p.dscale, p.dbias, static_cast<const T*>(p.y),
      p.mismatch, p.hw, p.c, p.resident);
}

template <typename T, bool kAdain>
int dispatch_cluster(const BwdArgs& p, int relu, int check, cudaStream_t stream,
                     int* clusters) {
  constexpr int V = Vec<T>::kWidth;
  if (p.n < 1 || p.n > 65535 || p.hw < 1 || p.c < V || p.c % V || p.c / V > kThreads ||
      p.k < 1 || p.k > kMaxCluster || p.resident < 0 || (check && !relu) ||
      (size_t)p.smem < bwd_smem(p.c, p.resident, sizeof(T), V).total)
    return (int)cudaErrorInvalidValue;
  if (check) return launch_cluster<T, kAdain, true, true>(p, stream, clusters);
  if (relu) return launch_cluster<T, kAdain, true, false>(p, stream, clusters);
  return launch_cluster<T, kAdain, false, false>(p, stream, clusters);
}

// check: the variant that reads y and counts mismatches (p.y, p.mismatch)
int run_cluster(const BwdArgs& p, int adain, int dtype, int relu, int check, void* stream,
                int* clusters) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return adain ? dispatch_cluster<__nv_bfloat16, true>(p, relu, check, s, clusters)
                 : dispatch_cluster<__nv_bfloat16, false>(p, relu, check, s, clusters);
  return adain ? dispatch_cluster<float, true>(p, relu, check, s, clusters)
               : dispatch_cluster<float, false>(p, relu, check, s, clusters);
}

// ------------------------------------------------ backward: the LayerNorm

// LayerNorm backward workspace: part_a, part_b [n][splits][c] (per-block
// sums of g and g * xh); sum_a, sum_b [n][c] (their totals per sample);
// scal [n][2] (A and B below)
struct BwdWork {
  float* part_a;
  float* part_b;
  float* sum_a;
  float* sum_b;
  float* scal;
};

// Pass 1: per channel over this block's rows, sums of g and g * xh with
// xh = (x - mean) * factor, the statistics per sample.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ln_bwd_sums_kernel(const T* __restrict__ x, const T* __restrict__ gr,
                   const float* __restrict__ stats, BwdWork w, Geom g) {
  constexpr int V = Vec<T>::kWidth;
  __shared__ float red_a[kThreads * V];
  __shared__ float red_b[kThreads * V];
  const int s = blockIdx.x, n = blockIdx.y;
  const int groups = g.c / V, lanes = kThreads / groups;
  const int grp = threadIdx.x % groups, lane = threadIdx.x / groups;
  const int c0 = grp * V;
  const float* st = stats + (size_t)n * 2 * g.c;
  const float mean = st[0], f = st[g.c];
  float a[V], b[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    a[i] = 0.f;
    b[i] = 0.f;
  }
  if (lane < lanes) {
    const size_t base = (size_t)n * g.hw * g.c + c0;
    const int r_end = min(g.hw, (s + 1) * g.rows);
    for (int r = s * g.rows + lane; r < r_end; r += lanes) {
      const size_t off = base + (size_t)r * g.c;
      float xv[V], gv[V];
      load16(x + off, xv);
      load16(gr + off, gv);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        a[i] += gv[i];
        b[i] += gv[i] * ((xv[i] - mean) * f);
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

// Pass 2, one block per sample: per-channel totals over the row chunks,
// and A = sum_c gamma_c sum_a[c], B = sum_c gamma_c sum_b[c].
__global__ void __launch_bounds__(kThreads)
ln_bwd_finalize_kernel(const float* __restrict__ gamma, BwdWork w, Geom g) {
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
    ta += gamma[c] * sa;
    tb += gamma[c] * sb;
  }
  ta = block_sum(ta, scratch);
  tb = block_sum(tb, scratch);
  if (threadIdx.x == 0) {
    w.scal[2 * n] = ta;
    w.scal[2 * n + 1] = tb;
  }
}

// Pass 3: dx = (gamma_c g - A / m) * f - (x - mean) * B / ((m-1) s d), one
// read of x and g, one write.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ln_bwd_apply_kernel(const T* __restrict__ x, const T* __restrict__ gr,
                    const float* __restrict__ stats, const float* __restrict__ gamma,
                    T* __restrict__ dx, BwdWork w, Geom g) {
  constexpr int V = Vec<T>::kWidth;
  const int s = blockIdx.x, n = blockIdx.y;
  const int groups = g.c / V, lanes = kThreads / groups;
  const int grp = threadIdx.x % groups, lane = threadIdx.x / groups;
  if (lane >= lanes) return;
  const int c0 = grp * V;
  const float* st = stats + (size_t)n * 2 * g.c;
  const float mean = st[0], f = st[g.c];
  const float d = 1.f / f, sd = d - kEps;
  const float m = (float)g.hw * (float)g.c;
  const float a = w.scal[2 * n], b = w.scal[2 * n + 1];
  const float cc = a / m * f, cu = b / (fmaxf(m - 1.f, 1.f) * sd * d);
  float cg[V];
#pragma unroll
  for (int i = 0; i < V; ++i) cg[i] = gamma[c0 + i] * f;
  const size_t base = (size_t)n * g.hw * g.c + c0;
  const int r_end = min(g.hw, (s + 1) * g.rows);
  for (int r = s * g.rows + lane; r < r_end; r += lanes) {
    const size_t off = base + (size_t)r * g.c;
    float xv[V], gv[V], o[V];
    load16(x + off, xv);
    load16(gr + off, gv);
#pragma unroll
    for (int i = 0; i < V; ++i) o[i] = cg[i] * gv[i] - cc - (xv[i] - mean) * cu;
    store16(dx + off, o);
  }
}

// Pass 4: dgamma[c] = sum_n sum_b[n][c] and dbeta[c] = sum_n sum_a[n][c],
// one thread per channel, samples in order.
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

template <typename T>
int launch_ln_bwd(const void* x, const void* gr, const float* stats, const float* gamma,
                  void* dx, float* dgamma, float* dbeta, void* ws, int n, int hw, int c,
                  int splits, cudaStream_t stream) {
  Geom g;
  const int bad = check(n, hw, c, splits, Vec<T>::kWidth, &g);
  if (bad) return bad;
  float* f = static_cast<float*>(ws);
  const size_t part = (size_t)n * splits * c;
  const BwdWork w{f, f + part, f + 2 * part, f + 2 * part + (size_t)n * c,
                  f + 2 * part + 2 * (size_t)n * c};
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(gr);
  const dim3 grid(g.splits, g.n);
  ln_bwd_sums_kernel<T><<<grid, kThreads, 0, stream>>>(xt, gt, stats, w, g);
  ln_bwd_finalize_kernel<<<g.n, kThreads, 0, stream>>>(gamma, w, g);
  ln_bwd_apply_kernel<T><<<grid, kThreads, 0, stream>>>(xt, gt, stats, gamma,
                                                        static_cast<T*>(dx), w, g);
  ln_param_grads_kernel<<<(c + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      w, dgamma, dbeta, g);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  stats: float32 [n][2][c], written by
// the forward and read by the backward.  ws: float32 workspace; forward:
// 2 * n * splits * c elements; LayerNorm backward: 2 * n * splits * c +
// 2 * n * c + 2 * n.  Each returns cudaGetLastError() after its launches
// (the cluster kernels: what cudaLaunchKernelEx returned).

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

// The cluster backward of the instance norm and AdaIN: k blocks per sample
// (one cluster), each keeping `resident` rows of its slab in `smem` bytes of
// shared memory (ops/cuda/kernels.py's bwd_plan).  relu: the forward fused a
// ReLU; its mask is recomputed from x and the statistics.  y, mismatch: a
// check only (NULL on the training path): the forward's output, and a
// counter to which the elements whose recomputed mask differs from y > 0
// are added.

extern "C" int dwc_instance_norm_bwd(const void* x, const void* g, const void* stats,
                                     void* dx, const void* y, void* mismatch, int n, int hw,
                                     int c, int dtype, int relu, int k, int resident,
                                     int smem, void* stream) {
  const BwdArgs p{x, g, static_cast<const float*>(stats), nullptr, nullptr, dx, nullptr,
                  nullptr, y, static_cast<unsigned*>(mismatch), n, hw, c, k, resident, smem};
  return run_cluster(p, kIn, dtype, relu, y != nullptr, stream, nullptr);
}

// dscale, dbias: float32 [n][c] outputs.  The residual form x + AdaIN(y)
// calls this for its y with relu off (its x gradient is g); bias is read
// only for the ReLU's mask.
extern "C" int dwc_adain_bwd(const void* x, const void* g, const void* stats,
                             const void* scale, const void* bias, void* dx, void* dscale,
                             void* dbias, const void* y, void* mismatch, int n, int hw, int c,
                             int dtype, int relu, int k, int resident, int smem,
                             void* stream) {
  const BwdArgs p{x, g, static_cast<const float*>(stats), static_cast<const float*>(scale),
                  static_cast<const float*>(bias), dx, static_cast<float*>(dscale),
                  static_cast<float*>(dbias), y, static_cast<unsigned*>(mismatch), n, hw, c,
                  k, resident, smem};
  return run_cluster(p, kAdain, dtype, relu, y != nullptr, stream, nullptr);
}

// Set up one configuration of the cluster backward (op: 0 instance norm, 1
// AdaIN; check: the mask-check variant) and write to *clusters how many of
// its clusters fit on the current card at once (0: none does).
extern "C" int dwc_norm_bwd_clusters(int op, int dtype, int relu, int check, int c, int k,
                                     int resident, int smem, int* clusters) {
  const BwdArgs p{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                  nullptr, nullptr, 1, k, c, k, resident, smem};
  return run_cluster(p, op, dtype, relu, check, nullptr, clusters);
}

// dgamma, dbeta: float32 [c] outputs, summed over the batch.
extern "C" int dwc_layer_norm_ref_bwd(const void* x, const void* g, const void* stats,
                                      const void* gamma, void* dx, void* dgamma, void* dbeta,
                                      void* ws, int n, int hw, int c, int splits, int dtype,
                                      void* stream) {
  const float* st = static_cast<const float*>(stats);
  const float* ga = static_cast<const float*>(gamma);
  float* dg = static_cast<float*>(dgamma);
  float* db = static_cast<float*>(dbeta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_ln_bwd<__nv_bfloat16>(x, g, st, ga, dx, dg, db, ws, n, hw, c, splits, s);
  return launch_ln_bwd<float>(x, g, st, ga, dx, dg, db, ws, n, hw, c, splits, s);
}
