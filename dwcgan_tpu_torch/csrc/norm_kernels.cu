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
// So every kernel here, forward and backward, is one launch per call: a
// thread-block cluster of k <= 8 blocks per sample (the LayerNorm's
// backward up to 16, Hopper's non-portable cluster size).
//   - block `rank` owns rows [rank * hw / k, (rank + 1) * hw / k) of its
//     sample, an NHWC slab that is one contiguous byte range; it copies as
//     much of the slab (x; the backward x and g) as its plan gives it into
//     shared memory with bulk asynchronous copies (cp.async.bulk on
//     mbarriers), all requested at once, and streams the rest, summing the
//     streamed rows while the copies land;
//   - each block sums its slab per channel in a fixed order, then every
//     block reads the k partial vectors through distributed shared memory
//     in rank order: all hold the same fp32 totals, bit-equal from run to
//     run, with no workspace, atomics or second launch;
//   - the output from the staged slab (the streamed rows read again, from
//     L2 where they are still there), stored 16 bytes at a time.
// Forward: y = (x - mean) * factor (AdaIN: then * scale[n, c] + bias[n, c]),
// an optional ReLU, and for the residual form x + AdaIN(y) the add fused
// into the store (its slab prefetched into L2 during the exchange).  Six
// blocks a sample, each taking only the shared memory its slab needs, up
// to a whole SM: a 512 KB sample is resident in 109 KB blocks, two to an
// SM, all 32 clusters of a served batch on the card at once; a 2 MB one
// keeps 61 % of its rows.  A streamed row is read for the sums with L2
// evict_last and read again last-read-first; what is read or written once
// goes evict_first.  "1pass" exchanges the sums of x and x^2 once; "2pass"
// exchanges the sums of x, then the squares centred on the finished mean
// (as in dwcgan_tpu/ops/norms.py:84-93): the staged rows from shared
// memory, the streamed ones read again.  Bound: x read once and y written
// once (the residual form also reads x).  The statistics (mean, and the
// factor that multiplies x - mean) go to a separate fp32 tensor [n][2][c]
// that the backward reuses, so it never recomputes moments.
// Backward: with g' the incoming gradient times the ReLU mask and xh =
// (x - mean) * factor, the sums of g' and g' * xh over H*W per (n, c), then
//   IN     dx = f * (g' - mean g' - xh * mean(g' xh)),
//   AdaIN  the same times scale[n, c]; dbias = sum g', dscale = sum g' xh.
// Bound: x and g read once, dx written once (3 tensors).  The loads and
// stores take the forward's L2 policies (the streamed rows evict_last for
// the sums and read again last-read-first; the bulk copies and dx
// evict_first).  The ReLU mask is recomputed from x and the statistics:
// rounded<T>(t) > 0 with t the forward's own fp32 expression (normed /
// affine below, called by both kernels), which is y > 0 exactly; y is not
// read.
// Statistics and arithmetic are fp32 for fp32 and bf16 data alike; eps is
// 1e-5.
//
// The reference LayerNorm (per-sample statistics over all of H*W*C,
// unbiased std, divided as std + eps, then a per-channel affine) runs the
// same clusters (ln_fwd_cluster_kernel, ln_bwd_cluster_kernel, sharing the
// bodies above): after the per-channel exchange every block sums the c
// channel totals in one fixed order (channel_totals), so all hold the same
// per-sample values.  Forward: mean = sum x / m, m = H*W*C; "1pass" var =
// max(sum x^2 - m mean^2, 0) / (m - 1), "2pass" a centred second pass and
// exchange; factor = 1 / (std + eps); y = (x - mean) factor gamma_c + beta_c.
// Backward: the per-channel sums of g and g * xh as above, then
//   A = sum_c gamma_c sum g, B = sum_c gamma_c sum g * xh,
//   dx = (gamma_c g - A / m) * f - (x - mean) * B / ((m-1) s d), with
//   d = 1/f = std + eps, s = std (the Pallas rule's dx = du - mean(du) with
//   sum (x - mean) taken as 0); dgamma[c] = sum_n sum g * xh and dbeta[c] =
//   sum_n sum g, which the last cluster to finish sums over the per-sample
//   rows of a small workspace, in sample order: no float atomics, and the
//   sums do not depend on the order clusters run in.
// Threads load 16 bytes at a time along the channels; a block walks its
// rows with consecutive threads on consecutive addresses.
// Both stats modes share the backwards: the 1pass variance is the same
// function of x as the 2pass one (away from its clamp at 0).
//
// norm_compute "bf16" (arith = 1, bf16 data only; the instance norm and
// AdaIN, forward and backward; dwcgan_tpu/ops/norms.py:53-81, 101-150):
// the statistics stay fp32, but the normalise chain runs in the activation
// dtype, rounded after every op as XLA does it:
//   y = bf16(bf16(x - bf16(mean)) * bf16(factor)), AdaIN then
//   bf16(bf16(y * bf16(scale)) + bf16(bias)),
// each an explicit __fsub_rn / __fmul_rn / __fadd_rn rounded by
// __float2bfloat16_rn, so no multiply-add is contracted across a rounding
// point.  Its backward is the VJP of that chain: with d = bf16(x - bf16(mean)),
// g' the masked gradient, gy = g' (AdaIN: bf16(g' * bf16(scale))),
//   gd = bf16(gy * bf16(f)), gm = -bf16(sum gd), gr = bf16(sum bf16(gy * d)),
//   AdaIN: dbias = bf16(sum g'), dscale = bf16(sum bf16(g' * y1)), y1 =
//   bf16(d * bf16(f)),
//   dx = bf16(gd + bf16(gm / hw - gr f^3 (x - mean) / hw)),
// every sum accumulated in fp32 and rounded once (the port's rule for a
// bf16 reduction), the last term the statistics' own gradient in fp32.
// The same plans and exchanges; AdaIN's backward exchanges four sums per
// channel through the space of its two sums and its totals, the totals
// kept in the lane partials' space.  fp32 data ignores arith.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

// V values as 16 bytes of T (bf16: rounded to nearest)
template <typename T> __device__ __forceinline__ uint4 pack16(const float* v);
template <> __device__ __forceinline__ uint4 pack16<float>(const float* v) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                    __float_as_uint(v[3]));
}
template <> __device__ __forceinline__ uint4 pack16<__nv_bfloat16>(const float* v) {
  uint4 a;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&a);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  return a;
}

// v as a tensor of T holds it: rounded to bf16 and back, or fp32 as it is
template <typename T> __device__ __forceinline__ float rounded(float v) { return v; }
template <> __device__ __forceinline__ float rounded<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The forward's value before its ReLU at one element, in two steps that
// the forwards and the backward's mask all call: xh = (x - mean) * factor,
// then, with an affine, xh * scale + bias.  The round-to-nearest intrinsics
// keep the compiler from contracting either kernel's copy differently, so
// rounded<T>(t) > 0 in the backward is y > 0 of the forward, bit for bit.
__device__ __forceinline__ float normed(float v, float mean, float f) {
  return __fmul_rn(__fsub_rn(v, mean), f);
}
__device__ __forceinline__ float affine(float t, float sc, float bi) {
  return __fmaf_rn(t, sc, bi);
}


// ------------------------------------------ clusters: the common machinery

// One cluster of k blocks per sample: grid (k, n), cluster (k, 1).  Block
// `rank` owns rows [rank * hw / k, (rank + 1) * hw / k) of its sample.  Its
// first `resident` rows (of x; the backward also of g) come into shared
// memory by bulk asynchronous copies (cp.async.bulk, kChunks of them, each
// completing on its own mbarrier), all requested at once; the rest of the
// slab is streamed from device memory, again for each later pass, from L2
// where it is still there.
constexpr int kChunks = 4;
constexpr int kUnroll = 4;       // streamed rows in flight per thread
constexpr int kMaxCluster = 8;   // the portable cluster size
constexpr int kMaxLnCluster = 16;  // the LayerNorm's backward: Hopper's non-portable size
constexpr int kPrefetch = 32768;  // bytes of one L2 prefetch

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

// L2 policies of the cluster kernels' global accesses.  A streamed row is
// read for the sums with evict_last, so that it is still in L2 when the
// apply (the backward: dx) reads it again; what is read or written once
// (the bulk copies, the second read, the residual, y or dx) goes with
// evict_first, so that it does not push the streamed rows out.
__device__ __forceinline__ uint64_t policy_keep() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}

__device__ __forceinline__ uint64_t policy_once() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}

// 16 bytes from device memory under the L2 policy `pol`
__device__ __forceinline__ uint4 ld16_hint(const void* p, uint64_t pol) {
  uint4 v;
  asm volatile("ld.global.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p), "l"(pol));
  return v;
}

// 16 bytes to device memory, streamed (evict first: not read again here)
__device__ __forceinline__ void st16_stream(void* p, uint4 v) {
  asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"l"(p), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}

// ask L2 to fetch `bytes` (a multiple of 16) of device memory ahead of use
__device__ __forceinline__ void prefetch_l2(const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(src), "r"(bytes)
               : "memory");
}

// the bulk copy of bulk_load under the L2 policy `pol`
__device__ __forceinline__ void bulk_load_hint(uint32_t dst, const void* src, uint32_t bytes,
                                               uint32_t bar, uint64_t pol) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint "
      "[%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar), "l"(pol)
      : "memory");
}

// The slab's first `res` rows of each of the kM tensors src[m] (a row: c
// elements of T) into dst[m], requested at once by thread 0 in `chunks`
// pieces, piece j completing on bar[j]; under the L2 policy *pol where
// given.  Every thread of the block calls it.
template <typename T, int kM>
__device__ __forceinline__ void stage_slab(T* const (&dst)[kM], const T* const (&src)[kM],
                                           uint64_t* bar, int res, int c, int chunks,
                                           const uint64_t* pol = nullptr) {
  if (threadIdx.x == 0) {
    for (int j = 0; j < chunks; ++j) mbar_init(smem_addr(bar + j));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int j = 0; j < chunks; ++j) {
      const size_t ra = (size_t)j * res / chunks, rb = (size_t)(j + 1) * res / chunks;
      const uint32_t bytes = (uint32_t)((rb - ra) * c * sizeof(T));
      const uint32_t mb = smem_addr(bar + j);
      mbar_expect_tx(mb, kM * bytes);
#pragma unroll
      for (int m = 0; m < kM; ++m) {
        if (pol)
          bulk_load_hint(smem_addr(dst[m] + ra * c), src[m] + ra * c, bytes, mb, *pol);
        else
          bulk_load(smem_addr(dst[m] + ra * c), src[m] + ra * c, bytes, mb);
      }
    }
  }
  __syncthreads();   // the mbarriers exist before anyone waits on them
}

// The block's per-channel sums: each active thread's partials a[V] (and
// b[V] when `b` is given) of channels c0 + i (c0 = grp * V) through red,
// laid out [lane][i][grp] so that a warp's stores and loads fall on
// distinct banks, then summed over the lanes in order into out[0, c) (and
// out[c, 2c)).
template <int V>
__device__ __forceinline__ void block_sums(float* red, float* out, const float* a,
                                           const float* b, bool active, int lane, int lanes,
                                           int c0, int c) {
  const int groups = c / V;
  if (active) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int o = (lane * V + i) * groups + c0 / V;
      red[o] = a[i];
      if (b) red[kThreads * V + o] = b[i];
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < c; j += kThreads) {
    const int g = j % groups, i = j / groups;   // channel g * V + i
    float sa = 0.f, sb = 0.f;
    for (int l = 0; l < lanes; ++l) {
      const int o = (l * V + i) * groups + g;
      sa += red[o];
      if (b) sb += red[kThreads * V + o];
    }
    out[g * V + i] = sa;
    if (b) out[c + g * V + i] = sb;
  }
}

// The cluster's totals of kM floats, `local[m * stride]` of each of the k
// (at most kMax) blocks' shared memory (read after a cluster barrier), all
// requested at once, then summed in rank order: every block gets the same
// fp32 values.
template <int kM, int kMax = kMaxCluster>
__device__ __forceinline__ void cluster_sums(const float* local, int stride, int k,
                                             float (&s)[kM]) {
  float p[kMax][kM];
#pragma unroll
  for (int q = 0; q < kMax; ++q) {
    if (q < k) {
      const uint32_t remote = cluster_addr(smem_addr(local), q);
#pragma unroll
      for (int m = 0; m < kM; ++m)
        p[q][m] = ld_cluster(remote + (uint32_t)(m * stride * sizeof(float)));
    }
  }
#pragma unroll
  for (int m = 0; m < kM; ++m) s[m] = 0.f;
#pragma unroll
  for (int q = 0; q < kMax; ++q) {
    if (q < k) {
#pragma unroll
      for (int m = 0; m < kM; ++m) s[m] += p[q][m];
    }
  }
}

// The LayerNorm's per-sample sums over the c channels of the cluster's
// per-channel totals tot[m * c + ch] (weighted by w[ch] where w is given),
// in one fixed order: each lane of every warp sums the channels lane,
// lane + 32, ..., then a butterfly over the warp.  Each pair of lanes adds
// the same two values, so every thread of every block of the cluster gets
// the same fp32 values, with no further barrier.  Every thread calls it,
// after the barrier that completes tot.
template <int kM>
__device__ __forceinline__ void channel_totals(const float* tot, const float* w, int c,
                                               float (&s)[kM]) {
#pragma unroll
  for (int m = 0; m < kM; ++m) s[m] = 0.f;
  for (int ch = threadIdx.x % 32; ch < c; ch += 32) {
    const float wc = w ? w[ch] : 1.f;
#pragma unroll
    for (int m = 0; m < kM; ++m) s[m] += wc * tot[m * c + ch];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int m = 0; m < kM; ++m) s[m] += __shfl_xor_sync(0xffffffffu, s[m], o);
  }
}

// Launch `kern` as n clusters of k blocks with `smem` bytes of dynamic
// shared memory each, or (clusters != NULL) set it up: opt in to the
// largest shared memory (and, for k > 8, to a non-portable cluster size),
// and ask how many clusters of this configuration fit on the card at once.
template <typename... Params, typename... Args>
int cluster_launch(void (*kern)(Params...), int k, int n, int smem, cudaStream_t stream,
                   int* clusters, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(k, n, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = k;
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
    if (!e && k > kMaxCluster)
      e = cudaFuncSetAttribute((const void*)kern,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (!e) e = cudaOccupancyMaxActiveClusters(clusters, (const void*)kern, &cfg);
    return (int)e;
  }
  return (int)cudaLaunchKernelEx(&cfg, kern, args...);
}

// 0 when a cluster call suits the kernels: at most 65535 samples (the
// grid's second dimension), whole 16-byte vectors along the channels, no
// more channel groups than threads, 1..max_k blocks a cluster, and `smem`
// bytes enough for `need`
inline int check_cluster(int n, int hw, int c, int width, int k, int resident, int smem,
                         size_t need, int max_k = kMaxCluster) {
  if (n < 1 || n > 65535 || hw < 1 || c < width || c % width || c / width > kThreads ||
      k < 1 || k > max_k || resident < 0 || (size_t)smem < need)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// ------------------------------------ forward: instance norm and AdaIN

// Shared memory of the forward, in bytes from its base (fwd_smem, mirrored
// by ops/cuda/kernels.py's fwd_plan):
//   xs    resident * c elements of T
//   red   2 * kThreads * V floats: each lane's partial sums
//   part  3 * c floats: this block's sums of x and x^2, then ("2pass") of
//         (x - mean)^2, which every block of the cluster reads through
//         distributed shared memory
//   tot   2 * c floats: the statistics, mean and factor
//   bar   kChunks mbarriers
struct FwdSmem {
  size_t red, part, tot, bar, total;
};

__host__ __device__ __forceinline__ FwdSmem fwd_smem(int c, int resident, int size,
                                                     int width) {
  FwdSmem s;
  s.red = (size_t)resident * c * size;
  s.part = s.red + 2 * (size_t)kThreads * width * sizeof(float);
  s.tot = s.part + 3 * (size_t)c * sizeof(float);
  s.bar = s.tot + 2 * (size_t)c * sizeof(float);
  s.total = s.bar + kChunks * sizeof(uint64_t);
  return s;
}

// What one thread keeps: its V channels' partial sums, then their
// statistics and affine, and the output rule.
template <typename T, bool kAffine, bool kRelu, bool kResidual, bool kArith = false>
struct FwdLane {
  static constexpr int V = Vec<T>::kWidth;
  float a[V], b[V], mean[V], f[V], sc[V], bi[V];

  // sums of x and x^2 (kCentred: of (x - mean)^2, into b) of one row
  template <bool kCentred>
  __device__ __forceinline__ void sum(uint4 xr) {
    float v[V];
    unpack16<T>(xr, v);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      if (kCentred) {
        const float d = v[i] - mean[i];
        b[i] += d * d;
      } else {
        a[i] += v[i];
        b[i] += v[i] * v[i];
      }
    }
  }

  // y of one row: normed, the affine, the ReLU, and x + AdaIN(y) with
  // AdaIN(y) already in T, as the reference adds two tensors of the compute
  // dtype (T rounds twice); rr: the residual's row.  kArith: the chain in
  // T, each op rounded (mean, f, sc, bi hold their roundings to T)
  __device__ __forceinline__ uint4 out(uint4 xr, uint4 rr) const {
    float v[V], rv[V];
    unpack16<T>(xr, v);
    if (kResidual) unpack16<T>(rr, rv);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      float t;
      if (kArith) {
        t = rounded<T>(__fmul_rn(rounded<T>(__fsub_rn(v[i], mean[i])), f[i]));
        if (kAffine) t = rounded<T>(__fadd_rn(rounded<T>(__fmul_rn(t, sc[i])), bi[i]));
      } else {
        t = normed(v[i], mean[i], f[i]);
        if (kAffine) t = affine(t, sc[i], bi[i]);
      }
      if (kRelu) t = fmaxf(t, 0.f);
      if (kResidual) t = __fadd_rn(rounded<T>(t), rv[i]);
      v[i] = t;
    }
    return pack16<T>(v);
  }
};

// The sums of this thread's rows of [ra, rb) (ra + lane, then every
// `lanes`-th), kUnroll loads in flight: `src` is the slab's first element
// of the thread's channels, in device memory (kGlobal: read with the L2
// policy `pol`) or shared memory.
template <bool kCentred, bool kGlobal, typename Lane, typename T>
__device__ __forceinline__ void sum_rows(Lane& t, const T* src, int ra, int rb, int c,
                                         int lane, int lanes, uint64_t pol) {
  auto load = [&](int r) {
    const T* p = src + (size_t)r * c;
    return kGlobal ? ld16_hint(p, pol) : ld16(p);
  };
  int r = ra + lane;
  for (; r + (kUnroll - 1) * lanes < rb; r += kUnroll * lanes) {
    uint4 xr[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) xr[u] = load(r + u * lanes);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) t.template sum<kCentred>(xr[u]);
  }
  for (; r < rb; r += lanes) t.template sum<kCentred>(load(r));
}

// y of this thread's rows of [ra, rb), kUnroll rows in flight, last row
// first (kReverse: the streamed rows, so that those read last for the sums,
// the likeliest still in L2, come first): x from `src` (device memory,
// kGlobal, or shared memory), the residual from `res`, y to `y`, each the
// slab's first element of the thread's channels.
template <bool kGlobal, bool kReverse, bool kResidual, typename Lane, typename T>
__device__ __forceinline__ void apply_rows(const Lane& t, const T* src, const T* res, T* y,
                                           int ra, int rb, int c, int lane, int lanes,
                                           uint64_t once) {
  auto row = [&](int r) { return (size_t)(kReverse ? ra + rb - 1 - r : r) * c; };
  auto load = [&](const T* p) { return kGlobal ? ld16_hint(p, once) : ld16(p); };
  int r = ra + lane;
  for (; r + (kUnroll - 1) * lanes < rb; r += kUnroll * lanes) {
    uint4 xr[kUnroll], rr[kUnroll] = {};
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const size_t o = row(r + u * lanes);
      xr[u] = load(src + o);
      if (kResidual) rr[u] = ld16_hint(res + o, once);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) st16_stream(y + row(r + u * lanes), t.out(xr[u], rr[u]));
  }
  for (; r < rb; r += lanes) {
    const size_t o = row(r);
    uint4 rr = {};
    if (kResidual) rr = ld16_hint(res + o, once);
    st16_stream(y + o, t.out(load(src + o), rr));
  }
}

// The forward's phase trace, a diagnostic (dwc_norm_fwd_trace): when set,
// thread 0 of every block writes the card's nanosecond clock at kStamps
// points, [n][k][kStamps]: start; its slab summed; the block's sums
// formed; the statistics known; its part of y stored; the end.
constexpr int kStamps = 6;
__device__ unsigned long long* g_fwd_trace;

__device__ __forceinline__ void stamp(unsigned long long* trace, int i) {
  if (trace && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
    trace[((size_t)blockIdx.y * gridDim.x + blockIdx.x) * kStamps + i] = t;
  }
}

// y (and the statistics, written by rank 0) in one launch: the body of both
// forward kernels.  scale, bias: AdaIN's fp32 [n, c], or (kLayer) the
// LayerNorm's gamma and beta, fp32 [c]; residual: the residual form's x,
// else NULL.
template <typename T, bool kAffine, bool kRelu, bool kResidual, bool kLayer,
          bool kArith = false>
__device__ __forceinline__ void norm_fwd(const T* __restrict__ x, const float* __restrict__ scale,
                                         const float* __restrict__ bias,
                                         const T* __restrict__ residual, T* __restrict__ y,
                                         float* __restrict__ stats, int hw, int c, int resident,
                                         int two_pass) {
  constexpr int V = Vec<T>::kWidth;
  extern __shared__ __align__(16) unsigned char smem[];
  const int k = gridDim.x, rank = blockIdx.x, n = blockIdx.y;
  const int r0 = (int)((long long)rank * hw / k);
  const int rows = (int)((long long)(rank + 1) * hw / k) - r0;
  const int res = min(resident, rows);
  const FwdSmem L = fwd_smem(c, resident, sizeof(T), V);
  T* xs = reinterpret_cast<T*>(smem);
  float* red = reinterpret_cast<float*>(smem + L.red);
  float* part = reinterpret_cast<float*>(smem + L.part);
  float* tot = reinterpret_cast<float*>(smem + L.tot);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L.bar);
  const size_t base = ((size_t)n * hw + r0) * c;   // the slab's first element
  const int chunks = min(kChunks, res);
  const uint64_t keep = policy_keep(), once = policy_once();
  unsigned long long* const trace = g_fwd_trace;
  stamp(trace, 0);

  // 1. the whole resident part requested at once, read once (evict first)
  {
    T* const dst[1] = {xs};
    const T* const src[1] = {x + base};
    stage_slab<T, 1>(dst, src, bar, res, c, chunks, &once);
  }

  const int groups = c / V, lanes = kThreads / groups;
  const int grp = threadIdx.x % groups, lane = threadIdx.x / groups;
  const bool active = lane < lanes;
  const int c0 = grp * V;
  const T* xg = x + base + c0;   // this thread's channels of the slab
  const T* xl = xs + c0;
  FwdLane<T, kAffine, kRelu, kResidual, kArith> t;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    t.a[i] = 0.f;
    t.b[i] = 0.f;
  }

  // 2. sums of x and x^2 over the slab, in one fixed order per thread: the
  //    streamed rows while the copies land (kept in L2 for the apply), then
  //    the resident rows chunk by chunk as each lands; then this block's
  //    sums
  if (active) sum_rows<false, true>(t, xg, res, rows, c, lane, lanes, keep);
  for (int j = 0; j < chunks; ++j) {
    mbar_wait(smem_addr(bar + j), 0);
    if (active)
      sum_rows<false, false>(t, xl, (int)((size_t)j * res / chunks),
                             (int)((size_t)(j + 1) * res / chunks), c, lane, lanes, keep);
  }
  stamp(trace, 1);
  if (kResidual && threadIdx.x == 0) {
    // the residual's slab into L2 while the cluster exchanges its sums, when
    // device memory is otherwise idle; the apply reads it from there
    const char* r = reinterpret_cast<const char*>(residual + base);
    for (size_t o = 0, end = (size_t)rows * c * sizeof(T); o < end; o += kPrefetch)
      prefetch_l2(r + o, (uint32_t)(end - o < kPrefetch ? end - o : kPrefetch));
  }
  block_sums<V>(red, part, t.a, t.b, active, lane, lanes, c0, c);
  stamp(trace, 2);

  // 3. the cluster's totals, the same in every block.  Per channel: mean =
  //    sum / hw, and "1pass" var = max(E[x^2] - mean^2, 0), factor = 1 /
  //    sqrt(var + eps).  The LayerNorm's per sample, over m = hw * c (as
  //    the split kernels formed them): mean = sum / m, "1pass" var =
  //    max(sum x^2 - m mean^2, 0) / (m - 1), factor = 1 / (std + eps).
  const float hwf = (float)hw;
  const float m = hwf * (float)c, dof = fmaxf(m - 1.f, 1.f);
  float* st = stats + (size_t)n * 2 * c;
  float ln_mean = 0.f, ln_fac = 0.f;   // the LayerNorm's statistics
  cluster_arrive();   // release: this block's part is written
  cluster_wait();     // acquire: so is every other block's
  for (int ch = threadIdx.x; ch < c; ch += kThreads) {
    float s[2];
    cluster_sums<2>(part + ch, c, k, s);
    if (kLayer) {
      tot[ch] = s[0];
      tot[c + ch] = s[1];
      continue;
    }
    const float mean = s[0] / hwf;
    tot[ch] = mean;
    if (rank == 0) st[ch] = mean;
    if (!two_pass) {
      const float fac = 1.f / sqrtf(fmaxf(s[1] / hwf - mean * mean, 0.f) + kEps);
      tot[c + ch] = fac;
      if (rank == 0) st[c + ch] = fac;
    }
  }
  if (kLayer) {
    __syncthreads();   // tot's channel totals
    float s[2];
    channel_totals<2>(tot, nullptr, c, s);
    ln_mean = s[0] / m;
    ln_fac = 1.f / (sqrtf(fmaxf(s[1] - m * ln_mean * ln_mean, 0.f) / dof) + kEps);
  }
  if (two_pass) {
    // 4. "2pass": var = E[(x - mean)^2] (the LayerNorm's: sum (x - mean)^2
    //    / (m - 1)), a second pass over the slab (the resident rows from
    //    shared memory, the streamed ones read again) and a second exchange
    __syncthreads();   // tot's means
    if (active) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        t.mean[i] = kLayer ? ln_mean : tot[c0 + i];
        t.b[i] = 0.f;
      }
      sum_rows<true, true>(t, xg, res, rows, c, lane, lanes, keep);
      sum_rows<true, false>(t, xl, 0, res, c, lane, lanes, keep);
    }
    block_sums<V>(red, part + 2 * c, t.b, nullptr, active, lane, lanes, c0, c);
    cluster_arrive();
    cluster_wait();
    for (int ch = threadIdx.x; ch < c; ch += kThreads) {
      float s[1];
      cluster_sums<1>(part + 2 * c + ch, c, k, s);
      if (kLayer) {
        tot[ch] = s[0];
        continue;
      }
      const float fac = 1.f / sqrtf(s[0] / hwf + kEps);
      tot[c + ch] = fac;
      if (rank == 0) st[c + ch] = fac;
    }
    if (kLayer) {
      __syncthreads();   // tot's channel totals
      float s[1];
      channel_totals<1>(tot, nullptr, c, s);
      ln_fac = 1.f / (sqrtf(s[0] / dof) + kEps);
    }
  }
  if (kLayer && rank == 0) {
    // the per-sample statistics, at every channel of stats
    for (int ch = threadIdx.x; ch < c; ch += kThreads) {
      st[ch] = ln_mean;
      st[c + ch] = ln_fac;
    }
  }
  cluster_arrive();   // this block is done reading the others' shared memory
  __syncthreads();    // tot
  stamp(trace, 3);

  // 5. y: the streamed rows again (first, while they are still in L2, the
  //    last read first), then the resident rows from shared memory
  if (active) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const size_t nc = kLayer ? (size_t)c0 + i : (size_t)n * c + c0 + i;
      t.mean[i] = kLayer ? ln_mean : tot[c0 + i];
      t.f[i] = kLayer ? ln_fac : tot[c + c0 + i];
      t.sc[i] = kAffine ? scale[nc] : 1.f;
      t.bi[i] = kAffine ? bias[nc] : 0.f;
      if (kArith) {   // the chain's operands in T (the statistics stay fp32)
        t.mean[i] = rounded<T>(t.mean[i]);
        t.f[i] = rounded<T>(t.f[i]);
        t.sc[i] = rounded<T>(t.sc[i]);
        t.bi[i] = rounded<T>(t.bi[i]);
      }
    }
    const T* rg = residual + base + c0;
    T* yg = y + base + c0;
    apply_rows<true, true, kResidual>(t, xg, rg, yg, res, rows, c, lane, lanes, once);
    apply_rows<false, false, kResidual>(t, xl, rg, yg, 0, res, c, lane, lanes, once);
  }
  stamp(trace, 4);
  cluster_wait();   // no block leaves while another may still read its part
  stamp(trace, 5);
}

// The instance norm and AdaIN forward: one cluster of k blocks per sample
// (kArith: norm_compute bf16).
template <typename T, bool kAffine, bool kRelu, bool kResidual, bool kArith>
__global__ void __launch_bounds__(kThreads)
norm_fwd_cluster_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                        const float* __restrict__ bias, const T* __restrict__ residual,
                        T* __restrict__ y, float* __restrict__ stats, int hw, int c,
                        int resident, int two_pass) {
  norm_fwd<T, kAffine, kRelu, kResidual, false, kArith>(x, scale, bias, residual, y, stats,
                                                        hw, c, resident, two_pass);
}

// The reference LayerNorm forward: the same cluster per sample, its
// statistics summed over the channels too; gamma, beta fp32 [c].
template <typename T>
__global__ void __launch_bounds__(kThreads)
ln_fwd_cluster_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                      const float* __restrict__ beta, T* __restrict__ y,
                      float* __restrict__ stats, int hw, int c, int resident, int two_pass) {
  norm_fwd<T, true, false, false, true>(x, gamma, beta, nullptr, y, stats, hw, c, resident,
                                        two_pass);
}

struct FwdArgs {
  const void* x;
  const float* scale;     // AdaIN's [n][c]; the LayerNorm's gamma [c]
  const float* bias;      // AdaIN's [n][c]; the LayerNorm's beta [c]
  const void* residual;   // the residual form's x, else NULL
  void* y;
  float* stats;
  int n, hw, c, k, resident, smem, two_pass;
};

enum FwdOp { kFwdIn = 0, kFwdAdain = 1, kFwdLn = 2 };

template <typename T, bool kAffine, bool kRelu, bool kResidual, bool kArith>
int launch_fwd(const FwdArgs& p, cudaStream_t stream, int* clusters) {
  return cluster_launch(norm_fwd_cluster_kernel<T, kAffine, kRelu, kResidual, kArith>, p.k, p.n,
                        p.smem, stream, clusters, static_cast<const T*>(p.x), p.scale,
                        p.bias, static_cast<const T*>(p.residual), static_cast<T*>(p.y),
                        p.stats, p.hw, p.c, p.resident, p.two_pass);
}

// the instance norm or AdaIN (kArith: norm_compute bf16): no affine or the
// affine, optional ReLU, or the residual form (relu off)
template <typename T, bool kArith>
int dispatch_in_adain(const FwdArgs& p, int op, int relu, int residual, cudaStream_t s,
                      int* clusters) {
  if (op == kFwdAdain) {
    if (residual) return relu ? (int)cudaErrorInvalidValue
                              : launch_fwd<T, true, false, true, kArith>(p, s, clusters);
    return relu ? launch_fwd<T, true, true, false, kArith>(p, s, clusters)
                : launch_fwd<T, true, false, false, kArith>(p, s, clusters);
  }
  if (op != kFwdIn || residual) return (int)cudaErrorInvalidValue;
  return relu ? launch_fwd<T, false, true, false, kArith>(p, s, clusters)
              : launch_fwd<T, false, false, false, kArith>(p, s, clusters);
}

// the instance norm (no affine, optional ReLU), AdaIN (optional ReLU, or
// the residual form, relu off) or the LayerNorm (neither); arith: the
// instance norm's and AdaIN's norm_compute bf16, bf16 data only (fp32
// data and the LayerNorm ignore it)
template <typename T>
int dispatch_fwd(const FwdArgs& p, int op, int relu, int residual, int arith, cudaStream_t s,
                 int* clusters) {
  constexpr int V = Vec<T>::kWidth;
  const int bad = check_cluster(p.n, p.hw, p.c, V, p.k, p.resident, p.smem,
                                fwd_smem(p.c, p.resident, sizeof(T), V).total);
  if (bad) return bad;
  if (op == kFwdLn) {
    if (relu || residual) return (int)cudaErrorInvalidValue;
    return cluster_launch(ln_fwd_cluster_kernel<T>, p.k, p.n, p.smem, s, clusters,
                          static_cast<const T*>(p.x), p.scale, p.bias, static_cast<T*>(p.y),
                          p.stats, p.hw, p.c, p.resident, p.two_pass);
  }
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (arith) return dispatch_in_adain<T, true>(p, op, relu, residual, s, clusters);
  }
  return dispatch_in_adain<T, false>(p, op, relu, residual, s, clusters);
}

int run_fwd(const FwdArgs& p, int op, int dtype, int relu, int residual, int arith,
            void* stream, int* clusters) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return dispatch_fwd<__nv_bfloat16>(p, op, relu, residual, arith, s, clusters);
  return dispatch_fwd<float>(p, op, relu, residual, arith, s, clusters);
}

// ----------------------------------- backward: instance norm and AdaIN

// Shared memory of the backward, in bytes from its base (bwd_smem,
// mirrored by ops/cuda/kernels.py's bwd_plan):
//   xs, gs  resident * c elements of T each
//   red     2 * kThreads * V floats: each lane's partial sums
//   part    2 * c floats: this block's sums of g' and g' * xh, which every
//           block of the cluster reads through distributed shared memory
//   tot     2 * c floats: the cluster's totals
//   bar     kChunks mbarriers
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

enum BwdOp { kIn = 0, kAdain = 1, kLn = 2 };

// What one thread keeps: its V channels' statistics and affine, its sums
// of g' and g' * xh, then the terms of dx.  The instance norm and AdaIN:
// dx = kk (g' - ma - xh mb), the plain rule's order: kk = f (AdaIN: f *
// scale), ma = mean g', mb = mean(g' xh); where g' - ma cancels (one pixel)
// dx is exactly 0.  The LayerNorm (no ReLU, g' = g): dx = kk g - ma -
// (x - mean) mb with kk = gamma_c f and the per-sample ma = A f / m, mb =
// B / ((m - 1) s d).
//
// kArith (norm_compute bf16, the instance norm and AdaIN): mean holds the
// fp32 mean, kk its rounding to T, f, sc and bi the roundings of the factor,
// scale and bias; a and b sum gd and bf16(gy * d), AdaIN's a2 and b2 g' and
// bf16(g' * y1) (the header's rule); dx = gd + bf16(ma + mb (x - mean)) with
// ma = gm / hw, mb = -gr f^3 / hw.
template <typename T, int kOp, bool kRelu, bool kArith = false>
struct BwdLane {
  static constexpr int V = Vec<T>::kWidth;
  float mean[V], f[V], sc[V], bi[V], a[V], b[V], kk[V], ma[V], mb[V], a2[V], b2[V];
  unsigned bad = 0;   // elements whose mask differs from y > 0 (the check)

  // kArith: the forward's chain at one element, d = bf16(x - bf16(mean))
  // and y1 = bf16(d * bf16(f)); returns whether its ReLU passed
  __device__ __forceinline__ bool chain(float xv, int i, float& d, float& y1) const {
    d = rounded<T>(__fsub_rn(xv, kk[i]));
    y1 = rounded<T>(__fmul_rn(d, f[i]));
    if (!kRelu) return true;
    const float t = kOp == kAdain
                        ? rounded<T>(__fadd_rn(rounded<T>(__fmul_rn(y1, sc[i])), bi[i]))
                        : y1;
    return t > 0.f;
  }

  // g' = g where the forward's ReLU passed, else 0: rounded<T>(t) > 0
  __device__ __forceinline__ bool on(float xh, int i) const {
    if (!kRelu) return true;
    return rounded<T>(kOp == kAdain ? affine(xh, sc[i], bi[i]) : xh) > 0.f;
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
      if (kArith) {
        float d, y1;
        const bool pass = chain(xv[i], i, d, y1);
        if (kCheck) bad += pass != (yv[i] > 0.f);
        const float gi = pass ? gv[i] : 0.f;
        float gy = gi;
        if (kOp == kAdain) {
          a2[i] += gi;
          b2[i] += rounded<T>(__fmul_rn(gi, y1));
          gy = rounded<T>(__fmul_rn(gi, sc[i]));
        }
        a[i] += rounded<T>(__fmul_rn(gy, f[i]));
        b[i] += rounded<T>(__fmul_rn(gy, d));
        continue;
      }
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
      if (kArith) {
        float d, y1;
        const float gi = chain(xv[i], i, d, y1) ? gv[i] : 0.f;
        const float gy = kOp == kAdain ? rounded<T>(__fmul_rn(gi, sc[i])) : gi;
        const float gd = rounded<T>(__fmul_rn(gy, f[i]));
        const float u = __fadd_rn(ma[i], __fmul_rn(mb[i], __fsub_rn(xv[i], mean[i])));
        o[i] = __fadd_rn(gd, rounded<T>(u));
      } else if (kOp == kLn) {
        o[i] = kk[i] * gv[i] - ma[i] - (xv[i] - mean[i]) * mb[i];
      } else {
        const float xh = normed(xv[i], mean[i], f[i]);
        const float gi = on(xh, i) ? gv[i] : 0.f;
        o[i] = kk[i] * (gi - ma[i] - xh * mb[i]);
      }
    }
    st16_stream(out, pack16<T>(o));
  }
};

// dx in one launch, the body of both backward kernels.  The instance norm:
// dx alone.  AdaIN: also dscale = sum g' xh, dbias = sum g' per (n, c).
// The LayerNorm (scale: gamma [c]): also dgamma[c] = sum_n sum g xh and
// dbeta[c] = sum_n sum g (into dscale, dbias, [c]): rank 0 of each cluster
// writes its sample's per-channel sums to ws [n][2][c], and the last of
// them to finish (an atomic count in *counter, after a fence) sums them
// over the samples in order and sets the count back to 0, for the next call
// and for a CUDA graph's replay; no float atomics, the same bits every run.
// kCheck: also read y and count the elements whose mask differs from y > 0
// into *mismatch (a check, never on the training path).
template <typename T, int kOp, bool kRelu, bool kCheck, int kMax, bool kArith = false>
__device__ __forceinline__ void norm_bwd(const T* __restrict__ x, const T* __restrict__ gr,
                                         const float* __restrict__ stats,
                                         const float* __restrict__ scale,
                                         const float* __restrict__ bias, T* __restrict__ dx,
                                         float* __restrict__ dscale, float* __restrict__ dbias,
                                         const T* __restrict__ y, unsigned* __restrict__ mismatch,
                                         float* __restrict__ ws, unsigned* __restrict__ counter,
                                         int hw, int c, int resident) {
  constexpr int V = Vec<T>::kWidth;
  constexpr bool kAffineIn = kOp == kAdain;
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
  // kArith AdaIN: its four sums are exchanged through part and tot (4 c
  // floats), and the totals go to the lane partials' space, free by then
  constexpr bool kFour = kArith && kOp == kAdain;
  float* tot = reinterpret_cast<float*>(smem + (kFour ? L.red : L.tot));
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L.bar);
  const size_t base = ((size_t)n * hw + r0) * c;   // the slab's first element
  const int chunks = min(kChunks, res);

  // 1. the whole resident part of x and g requested at once, read once
  //    (evict first; the forward's L2 policies: a streamed row is read for
  //    the sums with evict_last and again for dx last-read-first, dx is
  //    stored evict-first)
  const uint64_t keep = policy_keep(), once = policy_once();
  {
    T* const dst[2] = {xs, gs};
    const T* const src[2] = {x + base, gr + base};
    stage_slab<T, 2>(dst, src, bar, res, c, chunks, &once);
  }

  const int groups = c / V, lanes = kThreads / groups;
  const int grp = threadIdx.x % groups, lane = threadIdx.x / groups;
  const bool active = lane < lanes;
  const int c0 = grp * V;
  const float* st = stats + (size_t)n * 2 * c;
  BwdLane<T, kOp, kRelu, kArith> t;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const size_t nc = (size_t)n * c + c0 + i;
    // the LayerNorm's statistics: per sample, at channel 0
    t.mean[i] = st[kOp == kLn ? 0 : c0 + i];
    t.f[i] = st[c + (kOp == kLn ? 0 : c0 + i)];
    t.sc[i] = kAffineIn ? scale[nc] : 1.f;
    t.bi[i] = kAffineIn && kRelu ? bias[nc] : 0.f;
    t.a[i] = 0.f;
    t.b[i] = 0.f;
    t.a2[i] = 0.f;
    t.b2[i] = 0.f;
    if (kArith) {   // the chain's operands in T
      t.kk[i] = rounded<T>(t.mean[i]);
      t.f[i] = rounded<T>(t.f[i]);
      t.sc[i] = rounded<T>(t.sc[i]);
      t.bi[i] = rounded<T>(t.bi[i]);
    }
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
        xr[u] = ld16_hint(x + off, keep);
        gq[u] = ld16_hint(gr + off, keep);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        t.template sum<kCheck>(xr[u], gq[u], y + base + (size_t)(r + u * lanes) * c + c0);
    }
    for (; r < rows; r += lanes) {
      const size_t off = base + (size_t)r * c + c0;
      t.template sum<kCheck>(ld16_hint(x + off, keep), ld16_hint(gr + off, keep), y + off);
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
  block_sums<V>(red, part, t.a, t.b, active, lane, lanes, c0, c);
  if (kFour) {
    __syncthreads();   // every thread is done reading red
    block_sums<V>(red, part + 2 * c, t.a2, t.b2, active, lane, lanes, c0, c);
  }

  // 4. the cluster's totals, the same in every block and from run to run
  cluster_arrive();   // release: this block's part is written
  cluster_wait();     // acquire: so is every other block's
  for (int ch = threadIdx.x; ch < c; ch += kThreads) {
    if (kFour) {
      float s[4];
      cluster_sums<4, kMax>(part + ch, c, k, s);
      tot[ch] = s[0];
      tot[c + ch] = s[1];
      if (rank == 0) {   // the sums of g' and bf16(g' y1), rounded once
        dbias[(size_t)n * c + ch] = rounded<T>(s[2]);
        dscale[(size_t)n * c + ch] = rounded<T>(s[3]);
      }
      continue;
    }
    float s[2];
    cluster_sums<2, kMax>(part + ch, c, k, s);
    tot[ch] = s[0];
    tot[c + ch] = s[1];
    if (kOp == kAdain && rank == 0) {
      dbias[(size_t)n * c + ch] = s[0];
      dscale[(size_t)n * c + ch] = s[1];
    }
    if (kOp == kLn && rank == 0) {
      ws[(size_t)n * 2 * c + ch] = s[0];
      ws[(size_t)n * 2 * c + c + ch] = s[1];
    }
  }
  cluster_arrive();   // this block is done reading the others' shared memory
  __syncthreads();    // tot
  float ab[2] = {0.f, 0.f};   // the LayerNorm's A and B
  if (kOp == kLn) channel_totals<2>(tot, scale, c, ab);

  // 5. dx: the streamed rows again (first, while they are still in L2, the
  //    last read first), then the resident rows from shared memory (IN: dx
  //    = f (g' - mean g' - xh mean(g' xh)); AdaIN the same times scale[n,
  //    c]; the LayerNorm
  //    dx = (gamma_c g - A / m) f - (x - mean) B / ((m - 1) s d), d = 1 / f =
  //    std + eps, s = std, m = hw * c: the Pallas rule's dx = du - mean(du)
  //    with sum (x - mean) taken as 0)
  if (active) {
    const float hwf = (float)hw;
    const float m = hwf * (float)c;
    const float d = 1.f / t.f[0], sd = d - kEps;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      if (kArith) {
        // gm = -bf16(sum gd), gr = bf16(sum bf16(gy d)), f the fp32 factor
        const float ff = st[c + c0 + i];
        const float gr = rounded<T>(tot[c + c0 + i]);
        t.ma[i] = __fdiv_rn(-rounded<T>(tot[c0 + i]), hwf);
        t.mb[i] = __fdiv_rn(-__fmul_rn(gr, __fmul_rn(__fmul_rn(ff, ff), ff)), hwf);
      } else if (kOp == kLn) {
        t.kk[i] = scale[c0 + i] * t.f[i];
        t.ma[i] = ab[0] / m * t.f[i];
        t.mb[i] = ab[1] / (fmaxf(m - 1.f, 1.f) * sd * d);
      } else {
        t.kk[i] = kAffineIn ? t.f[i] * t.sc[i] : t.f[i];
        t.ma[i] = tot[c0 + i] / hwf;
        t.mb[i] = tot[c + c0 + i] / hwf;
      }
    }
    // the streamed rows [res, rows), the last first
    auto off = [&](int r) { return base + (size_t)(res + rows - 1 - r) * c + c0; };
    int r = res + lane;
    for (; r + (kUnroll - 1) * lanes < rows; r += kUnroll * lanes) {
      uint4 xr[kUnroll], gq[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        xr[u] = ld16_hint(x + off(r + u * lanes), once);
        gq[u] = ld16_hint(gr + off(r + u * lanes), once);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) t.dx(xr[u], gq[u], dx + off(r + u * lanes));
    }
    for (; r < rows; r += lanes)
      t.dx(ld16_hint(x + off(r), once), ld16_hint(gr + off(r), once), dx + off(r));
#pragma unroll 4
    for (r = lane; r < res; r += lanes) {
      const size_t so = (size_t)r * c + c0;
      t.dx(ld16(xs + so), ld16(gs + so), dx + base + so);
    }
  }

  // 6. the LayerNorm's dgamma and dbeta: the last sample's rank 0 to get
  //    here sums every sample's channel sums, in sample order
  if (kOp == kLn && rank == 0) {
    __threadfence();   // this sample's ws rows, before the count says so
    __syncthreads();
    int last = 0;
    if (threadIdx.x == 0) last = atomicAdd(counter, 1u) == gridDim.y - 1;
    if (__syncthreads_or(last)) {
      __threadfence();
      const int samples = gridDim.y;
      for (int ch = threadIdx.x; ch < c; ch += kThreads) {
        float sa = 0.f, sb = 0.f;
#pragma unroll 8
        for (int q = 0; q < samples; ++q) {
          sa += __ldcg(ws + (size_t)q * 2 * c + ch);
          sb += __ldcg(ws + (size_t)q * 2 * c + c + ch);
        }
        dbias[ch] = sa;
        dscale[ch] = sb;
      }
      if (threadIdx.x == 0) *counter = 0u;
    }
  }
  cluster_wait();   // no block leaves while another may still read its part
}

// The instance-norm and AdaIN backward: one cluster of k blocks per sample
// (kArith: norm_compute bf16).
template <typename T, bool kAdainOp, bool kRelu, bool kCheck, bool kArith>
__global__ void __launch_bounds__(kThreads)
norm_bwd_cluster_kernel(const T* __restrict__ x, const T* __restrict__ gr,
                        const float* __restrict__ stats, const float* __restrict__ scale,
                        const float* __restrict__ bias, T* __restrict__ dx,
                        float* __restrict__ dscale, float* __restrict__ dbias,
                        const T* __restrict__ y, unsigned* __restrict__ mismatch, int hw,
                        int c, int resident) {
  norm_bwd<T, kAdainOp ? kAdain : kIn, kRelu, kCheck, kMaxCluster, kArith>(
      x, gr, stats, scale, bias, dx, dscale, dbias, y, mismatch, nullptr, nullptr, hw, c,
      resident);
}

// The reference LayerNorm's backward: the same cluster per sample, up to
// 16 blocks; dgamma, dbeta fp32 [c] summed over the batch (ws: [n][2][c]).
template <typename T>
__global__ void __launch_bounds__(kThreads)
ln_bwd_cluster_kernel(const T* __restrict__ x, const T* __restrict__ gr,
                      const float* __restrict__ stats, const float* __restrict__ gamma,
                      T* __restrict__ dx, float* __restrict__ dgamma, float* __restrict__ dbeta,
                      float* __restrict__ ws, unsigned* __restrict__ counter, int hw, int c,
                      int resident) {
  norm_bwd<T, kLn, false, false, kMaxLnCluster>(x, gr, stats, gamma, nullptr, dx, dgamma,
                                                dbeta, nullptr, nullptr, ws, counter, hw, c,
                                                resident);
}

struct BwdArgs {
  const void* x;
  const void* g;
  const float* stats;
  const float* scale;   // AdaIN's [n][c]; the LayerNorm's gamma [c]
  const float* bias;
  void* dx;
  float* dscale;        // AdaIN's [n][c]; the LayerNorm's dgamma [c]
  float* dbias;         // AdaIN's [n][c]; the LayerNorm's dbeta [c]
  const void* y;        // the check's forward output, else NULL
  unsigned* mismatch;   // the check's count, else NULL
  float* ws;            // the LayerNorm's [n][2][c], else NULL
  unsigned* counter;    // the LayerNorm's count, 0 between calls, else NULL
  int n, hw, c, k, resident, smem;
};

template <typename T, bool kAdainOp, bool kRelu, bool kCheck, bool kArith>
int launch_bwd(const BwdArgs& p, cudaStream_t stream, int* clusters) {
  return cluster_launch(norm_bwd_cluster_kernel<T, kAdainOp, kRelu, kCheck, kArith>, p.k,
                        p.n, p.smem,
                        stream, clusters, static_cast<const T*>(p.x),
                        static_cast<const T*>(p.g), p.stats, p.scale, p.bias,
                        static_cast<T*>(p.dx), p.dscale, p.dbias,
                        static_cast<const T*>(p.y), p.mismatch, p.hw, p.c, p.resident);
}

// the instance norm or AdaIN (kArith: norm_compute bf16), optional ReLU;
// check: the variant that reads y and counts mismatches
template <typename T, bool kArith>
int dispatch_in_adain_bwd(const BwdArgs& p, int op, int relu, int check, cudaStream_t stream,
                          int* clusters) {
  if (op == kAdain) {
    if (check) return launch_bwd<T, true, true, true, kArith>(p, stream, clusters);
    return relu ? launch_bwd<T, true, true, false, kArith>(p, stream, clusters)
                : launch_bwd<T, true, false, false, kArith>(p, stream, clusters);
  }
  if (op != kIn) return (int)cudaErrorInvalidValue;
  if (check) return launch_bwd<T, false, true, true, kArith>(p, stream, clusters);
  return relu ? launch_bwd<T, false, true, false, kArith>(p, stream, clusters)
              : launch_bwd<T, false, false, false, kArith>(p, stream, clusters);
}

template <typename T>
int dispatch_bwd(const BwdArgs& p, int op, int relu, int check, int arith,
                 cudaStream_t stream, int* clusters) {
  constexpr int V = Vec<T>::kWidth;
  const int bad = check_cluster(p.n, p.hw, p.c, V, p.k, p.resident, p.smem,
                                bwd_smem(p.c, p.resident, sizeof(T), V).total,
                                op == kLn ? kMaxLnCluster : kMaxCluster);
  if (bad || (check && !relu)) return bad ? bad : (int)cudaErrorInvalidValue;
  if (op == kLn) {
    if (relu) return (int)cudaErrorInvalidValue;
    return cluster_launch(ln_bwd_cluster_kernel<T>, p.k, p.n, p.smem, stream, clusters,
                          static_cast<const T*>(p.x), static_cast<const T*>(p.g), p.stats,
                          p.scale, static_cast<T*>(p.dx), p.dscale, p.dbias, p.ws, p.counter,
                          p.hw, p.c, p.resident);
  }
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (arith) return dispatch_in_adain_bwd<T, true>(p, op, relu, check, stream, clusters);
  }
  return dispatch_in_adain_bwd<T, false>(p, op, relu, check, stream, clusters);
}

// op: 0 instance norm, 1 AdaIN, 2 the LayerNorm; check: the variant that
// reads y and counts mismatches (p.y, p.mismatch); arith: norm_compute bf16
// (the instance norm and AdaIN on bf16 data; ignored otherwise)
int run_bwd(const BwdArgs& p, int op, int dtype, int relu, int check, int arith,
            void* stream, int* clusters) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return dispatch_bwd<__nv_bfloat16>(p, op, relu, check, arith, s, clusters);
  return dispatch_bwd<float>(p, op, relu, check, arith, s, clusters);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  stats: float32 [n][2][c], written by
// the forward and read by the backward.  Each returns what its launch
// returned (cudaLaunchKernelEx), or cudaErrorInvalidValue for a call the
// kernels cannot take.
//
// Every one is one cluster of k blocks per sample, each keeping `resident`
// rows of its slab in `smem` bytes of shared memory (ops/cuda/kernels.py's
// fwd_plan, bwd_plan and ln_bwd_plan).

// arith (here and in the backwards): 1 for norm_compute bf16 (bf16 data
// only; see the header), 0 for fp32 arithmetic
extern "C" int dwc_instance_norm(const void* x, void* y, void* stats, int n, int hw, int c,
                                 int dtype, int two_pass, int relu, int arith, int k,
                                 int resident, int smem, void* stream) {
  const FwdArgs p{x, nullptr, nullptr, nullptr, y, static_cast<float*>(stats),
                  n, hw, c, k, resident, smem, two_pass};
  return run_fwd(p, kFwdIn, dtype, relu, 0, arith, stream, nullptr);
}

// scale, bias: float32 [n][c].  residual: NULL for AdaIN, else the tensor
// added after it (adain_residual; relu off)
extern "C" int dwc_adain(const void* x, const void* scale, const void* bias,
                         const void* residual, void* y, void* stats, int n, int hw, int c,
                         int dtype, int two_pass, int relu, int arith, int k, int resident,
                         int smem, void* stream) {
  const FwdArgs p{x, static_cast<const float*>(scale), static_cast<const float*>(bias),
                  residual, y, static_cast<float*>(stats), n, hw, c, k, resident, smem,
                  two_pass};
  return run_fwd(p, kFwdAdain, dtype, relu, residual != nullptr, arith, stream, nullptr);
}

// gamma, beta: float32 [c].  stats: the per-sample mean and factor 1 / (std
// + eps), written at every channel (the backward reads channel 0).
extern "C" int dwc_layer_norm_ref(const void* x, const void* gamma, const void* beta, void* y,
                                  void* stats, int n, int hw, int c, int dtype, int two_pass,
                                  int k, int resident, int smem, void* stream) {
  const FwdArgs p{x, static_cast<const float*>(gamma), static_cast<const float*>(beta),
                  nullptr, y, static_cast<float*>(stats), n, hw, c, k, resident, smem,
                  two_pass};
  return run_fwd(p, kFwdLn, dtype, 0, 0, 0, stream, nullptr);
}

// Set up one configuration of the cluster forward (op: 0 instance norm, 1
// AdaIN, 2 the LayerNorm; residual: AdaIN's residual form; arith: as the
// forwards') and write to *clusters how many of its clusters fit on the
// current card at once (0: none does).
extern "C" int dwc_norm_fwd_clusters(int op, int dtype, int relu, int residual, int arith,
                                     int c, int k, int resident, int smem, int* clusters) {
  const FwdArgs p{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                  1, k, c, k, resident, smem, 0};
  return run_fwd(p, op, dtype, relu, residual, arith, nullptr, clusters);
}

// Set (buf: a device buffer of n * k * 6 uint64) or clear (NULL) the
// forward's phase trace; every later forward launch writes into it.
extern "C" int dwc_norm_fwd_trace(void* buf) {
  return (int)cudaMemcpyToSymbol(g_fwd_trace, &buf, sizeof(buf));
}

// relu: the forward fused a ReLU; its mask is recomputed from x and the
// statistics.  y, mismatch: a check only (NULL on the training path): the
// forward's output, and a counter to which the elements whose recomputed
// mask differs from y > 0 are added.

extern "C" int dwc_instance_norm_bwd(const void* x, const void* g, const void* stats,
                                     void* dx, const void* y, void* mismatch, int n, int hw,
                                     int c, int dtype, int relu, int arith, int k,
                                     int resident, int smem, void* stream) {
  const BwdArgs p{x, g, static_cast<const float*>(stats), nullptr, nullptr, dx, nullptr,
                  nullptr, y, static_cast<unsigned*>(mismatch), nullptr, nullptr,
                  n, hw, c, k, resident, smem};
  return run_bwd(p, kIn, dtype, relu, y != nullptr, arith, stream, nullptr);
}

// dscale, dbias: float32 [n][c] outputs (arith 1: each a bf16 value).  The
// residual form x + AdaIN(y) calls this for its y with relu off (its x
// gradient is g); bias is read only for the ReLU's mask.
extern "C" int dwc_adain_bwd(const void* x, const void* g, const void* stats,
                             const void* scale, const void* bias, void* dx, void* dscale,
                             void* dbias, const void* y, void* mismatch, int n, int hw, int c,
                             int dtype, int relu, int arith, int k, int resident, int smem,
                             void* stream) {
  const BwdArgs p{x, g, static_cast<const float*>(stats), static_cast<const float*>(scale),
                  static_cast<const float*>(bias), dx, static_cast<float*>(dscale),
                  static_cast<float*>(dbias), y, static_cast<unsigned*>(mismatch), nullptr,
                  nullptr, n, hw, c, k, resident, smem};
  return run_bwd(p, kAdain, dtype, relu, y != nullptr, arith, stream, nullptr);
}

// dgamma, dbeta: float32 [c] outputs, summed over the batch.  ws: float32
// workspace [n][2][c]; counter: one uint32 that is 0 before the call (the
// kernel leaves it 0).
extern "C" int dwc_layer_norm_ref_bwd(const void* x, const void* g, const void* stats,
                                      const void* gamma, void* dx, void* dgamma, void* dbeta,
                                      void* ws, void* counter, int n, int hw, int c, int dtype,
                                      int k, int resident, int smem, void* stream) {
  const BwdArgs p{x, g, static_cast<const float*>(stats), static_cast<const float*>(gamma),
                  nullptr, dx, static_cast<float*>(dgamma), static_cast<float*>(dbeta),
                  nullptr, nullptr, static_cast<float*>(ws), static_cast<unsigned*>(counter),
                  n, hw, c, k, resident, smem};
  return run_bwd(p, kLn, dtype, 0, 0, 0, stream, nullptr);
}

// Set up one configuration of the cluster backward (op: 0 instance norm, 1
// AdaIN, 2 the LayerNorm; check: the mask-check variant; arith: as the
// backwards') and write to *clusters how many of its clusters fit on the
// current card at once (0: none does).
extern "C" int dwc_norm_bwd_clusters(int op, int dtype, int relu, int check, int arith, int c,
                                     int k, int resident, int smem, int* clusters) {
  const BwdArgs p{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                  nullptr, nullptr, nullptr, nullptr, 1, k, c, k, resident, smem};
  return run_bwd(p, op, dtype, relu, check, arith, nullptr, clusters);
}
