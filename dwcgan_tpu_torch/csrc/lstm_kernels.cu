// The text encoder's bi-LSTM recurrence on Hopper (sm_90a), forward and
// backward: one launch runs one layer's every time step, both directions.
//
// Replaces no TPU kernel.  The JAX package runs this recurrence as a
// `lax.scan` (dwcgan_tpu/ops/lstm.py::_LSTMBiFused, :92-154) that XLA
// compiles into one loop on the device; the port's counterpart of that
// scan was a Python loop of about a dozen torch ops a step
// (ops/lstm.py::MaskedBiLSTM._layer), so a served batch of 32 dispatched
// some 1,270 ops for its two layers and the host's dispatch, not the card,
// set the batch's pace.
//
// What bounds it.  A step is a [rows x H] x [H x 4H] product (at a served
// batch of 32 and H = 300: 11.5 M multiply-adds, about 0.02 us of the
// tensor cores) and some elementwise work, and step t + 1 needs all of step
// t's h.  So the recurrence is bound by latency, not by operations or
// bytes: T dependent steps, each at least one exchange of h among the
// blocks that share the product and one cluster barrier.  The design keeps
// every step on chip: no launch, no round trip through device memory
// between steps.
//
// Design.
//   - One thread-block cluster of K blocks per direction and group of up to
//     32 rows: grid (K, 2 x groups), cluster (K, 1, 1).  Block r owns the
//     hidden units [r U, r U + U) (ops/cuda/kernels.py::lstm_plan: bf16 U =
//     40, K = 8; fp32 U = 20, K = 15, a non-portable cluster) and keeps the
//     four gate rows of w_hh for them ([4U, H]) in shared memory for the
//     whole launch; the cell state c and h of its (row, unit) pairs stay in
//     registers.
//   - A forward step: (1) gates = h_{t-1} @ w_hh[own gates]^T for every row
//     of the group, bf16 on the tensor cores (mma.sync m16n8k16, fp32 sums),
//     fp32 by FFMA (the loop's fp32 product is full fp32, not TF32); (2)
//     plus the input projection of step t (one matrix product per layer
//     before the launch; the reverse direction reads its own valid prefix
//     reversed, so no reversed copy is made); (3) the cell, masked by each
//     row's length: past it the carry is frozen and the output is zero; (4)
//     the block's slice of h_t into every block's next-step h buffer through
//     distributed shared memory, 16 bytes a store, double-buffered; (5) one
//     cluster barrier.  The next step's input projection is loaded between
//     the barrier's arrive and its wait.
//   - Rounding: as the loop rounds.  bf16 rounds the product, the add of
//     the projection, every op of the sigmoid 1 / (1 + exp(-x)), tanh, each
//     multiply and add of the cell, and h, each by __float2bfloat16_rn
//     after an explicit __fadd_rn / __fmul_rn / __fdiv_rn (no multiply-add
//     contracted across a rounding point); expf and tanhf are the CUDA math
//     library's, as torch's kernels call them.  So in bf16 the kernel
//     differs from the loop only by the product's summation order.
//   - The backward runs the same layout backwards in time.  Each step
//     takes dh_t (the output's gradient plus the recurrent one), forms dc
//     and the gate gradients by the loop's rules (the sigmoid's JAX rule g *
//     (s * (1 - s)), tanh's g * (1 - y^2) as torch's kernel rounds it),
//     masks them by length, writes them for every step (dproj), and forms
//     its part of dgates_t @ w_hh over its own 4U gate columns for every
//     hidden unit; each part goes to the unit's owner through distributed
//     shared memory, which sums the K parts in rank order and rounds once.  The forward saves the gate
//     activations and c of every step (only when a gradient is wanted).
//     dW_hh, dW_ih, dx and the bias gradient are plain products over all
//     (step, row) outside, each summed in fp32 and rounded once.
//   - No atomics: every sum is taken in a fixed order, so two runs are
//     bit-equal.
//   - `steps` is the tensors' time extent, an upper bound: each cluster
//     reads its rows' lengths on the card and runs to the longest of them,
//     and zeroes its outputs (the backward: its gate gradients) past it.
//     A caller that cannot read the lengths on the host (a CUDA graph of the
//     training step, which passes the text's full width) pays for the
//     padded steps only that zeroing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPairs = 5;          // (row, unit) pairs a thread carries
constexpr int kMaxLstmCluster = 16;  // Hopper's non-portable size
constexpr int kFwdTiles = 3;       // 8-column tiles a warp sums at once (forward)
constexpr int kBwdTiles = 5;       // (backward)

__host__ __device__ constexpr int round_up(int a, int b) { return (a + b - 1) / b * b; }

// One launch's layout, the same on the host and in the kernels (mirrored by
// ops/cuda/kernels.py::lstm_plan).  Shared memory of the forward, in order:
//   w      [4U][ks] T     the block's gate rows of w_hh (k padded with 0)
//   h      [2][RB][ks] T  h_{t-1} of every row, double-buffered
//   gates  [RB][gs] fp32  the product of the step, rounded to T
//   hnew   [RB][U] T      the block's slice of h_t, staged for the exchange
// Of the backward:
//   w      bf16 [round_up(H, 8)][gs] (unit-major), fp32 [4U][round_up(H, 4)]
//   dg     [RB][gs] T     the gate gradients of the step
//   recv   [2][K][RB][U] fp32  every block's part of dgates @ w_hh for the
//                         block's units, double-buffered
// Row strides: bf16 ks = 8 mod 16 and gs = 8 mod 16 elements, fp32 ks an odd
// number of float4s, so the operand loads hit 32 different banks.
struct Geo {
  int H;    // hidden units
  int U;    // units a block owns
  int RB;   // rows a cluster takes (16 or 32)
  int K;    // blocks a cluster
  int bf;   // bf16 (else fp32)
  __host__ __device__ int nc() const { return 4 * U; }
  __host__ __device__ int esize() const { return bf ? 2 : 4; }
  __host__ __device__ int ks() const {
    if (bf) return round_up(H, 16) + 8;
    const int k = round_up(H, 4);
    return (k / 4) % 2 ? k : k + 4;
  }
  __host__ __device__ int gs() const { return 4 * U + 8; }
  __host__ __device__ size_t fwd_smem() const {
    return (size_t)nc() * ks() * esize() + (size_t)2 * RB * ks() * esize() +
           (size_t)RB * gs() * 4 + (size_t)RB * U * esize();
  }
  __host__ __device__ size_t wb_elems() const {
    return bf ? (size_t)round_up(H, 8) * gs() : (size_t)nc() * round_up(H, 4);
  }
  __host__ __device__ size_t bwd_smem() const {
    return wb_elems() * esize() + (size_t)RB * gs() * esize() + (size_t)2 * K * RB * U * 4;
  }
};

// ------------------------------------------------------------ small helpers

template <typename T> __device__ __forceinline__ float rnd(float v) { return v; }
template <> __device__ __forceinline__ float rnd<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }

template <typename T> __device__ __forceinline__ T cvt(float v);
template <> __device__ __forceinline__ float cvt<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 cvt<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// 1 / (1 + exp(-x)), each op rounded to T (ops/blocks.py::_logistic)
template <typename T> __device__ __forceinline__ float logistic(float x) {
  const float e = rnd<T>(expf(-x));
  const float d = rnd<T>(__fadd_rn(1.f, e));
  return rnd<T>(__fdiv_rn(1.f, d));
}

// the sigmoid's gradient by JAX's rule, g * (s * (1 - s)), each op rounded
template <typename T> __device__ __forceinline__ float logistic_grad(float g, float s) {
  return rnd<T>(__fmul_rn(g, rnd<T>(__fmul_rn(s, rnd<T>(__fsub_rn(1.f, s))))));
}

// tanh's gradient as torch's CUDA kernel forms it from the output y, g *
// (1 - y * y) in T's own arithmetic: bf16 rounds each op, fp32 contracts
// 1 - y * y into one multiply-add
template <typename T> __device__ __forceinline__ float tanh_grad(float g, float y) {
  return __fmul_rn(g, __fmaf_rn(-y, y, 1.f));
}
template <> __device__ __forceinline__ float tanh_grad<__nv_bfloat16>(float g, float y) {
  using B = __nv_bfloat16;
  return rnd<B>(__fmul_rn(g, rnd<B>(__fsub_rn(1.f, rnd<B>(__fmul_rn(y, y))))));
}

// The longest of a cluster's `nrows` (at most 32) lengths, at most `steps`:
// the steps its loop runs.  Every warp reads them, a row a lane, and takes
// their maximum itself, so no barrier is needed.  (A loop over the rows in
// every thread cost the forward 17-21 % of its time on the H100: the
// compiler laid the step loop's registers out differently.)
__device__ __forceinline__ int longest(const int* __restrict__ lens, int nrows, int steps) {
  const int lane = threadIdx.x & 31;
  return min(__reduce_max_sync(0xffffffffu, lane < nrows ? lens[lane] : 0), steps);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
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

__device__ __forceinline__ void st_cluster(uint32_t addr, uint4 v) {
  asm volatile("st.shared::cluster.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v.x),
               "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

__device__ __forceinline__ void st_cluster(uint32_t addr, float a, float b) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(a), "f"(b)
               : "memory");
}

__device__ __forceinline__ void st_cluster(uint32_t addr, float a, float b, float c, float d) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "f"(a),
               "f"(b), "f"(c), "f"(d)
               : "memory");
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d[16 x 8] += a[16 x 16] * b[16 x 8], bf16 operands, fp32 sums.  Lane
// (g = lane / 4, t = lane % 4) holds a: rows g, g + 8 x columns 2t, 2t + 1
// (+ 8); b: rows 2t, 2t + 1 (+ 8) x column g; d: rows g, g + 8 x columns
// 2t, 2t + 1.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a[16 x 16] of a row-major bf16 matrix with row stride `stride` at (row0, k)
__device__ __forceinline__ void load_a(uint32_t* a, const __nv_bfloat16* base, int stride,
                                       int g, int t) {
  const __nv_bfloat16* r0 = base + g * stride + 2 * t;
  const __nv_bfloat16* r1 = r0 + 8 * stride;
  a[0] = lds32(r0);
  a[1] = lds32(r1);
  a[2] = lds32(r0 + 8);
  a[3] = lds32(r1 + 8);
}

// ------------------------------------------------------- the step's products

// Forward: gates[b][c] = rounded(sum_k h[b][k] w[c][k]) for the rows of the
// group (16-row tiles), every gate column c of the block.
__device__ void gate_product(const __nv_bfloat16* w, const __nv_bfloat16* h, float* gates,
                             int nrows, const Geo& geo) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int ks = geo.ks(), gs = geo.gs(), nt_all = geo.nc() / 8;
  const int kt_all = round_up(geo.H, 16) / 16;
  const bool two = nrows > 16;
  for (int base = warp; base < nt_all; base += kWarps * kFwdTiles) {
    float acc[2][kFwdTiles][4] = {};
    for (int kt = 0; kt < kt_all; ++kt) {
      const int k = kt * 16;
      uint32_t a[2][4];
      load_a(a[0], h + k, ks, g, t);
      if (two) load_a(a[1], h + 16 * ks + k, ks, g, t);
#pragma unroll
      for (int j = 0; j < kFwdTiles; ++j) {
        const int nt = base + j * kWarps;
        if (nt < nt_all) {
          const __nv_bfloat16* wr = w + (nt * 8 + g) * ks + k + 2 * t;
          const uint32_t b0 = lds32(wr), b1 = lds32(wr + 8);
          mma_bf16(acc[0][j], a[0], b0, b1);
          if (two) mma_bf16(acc[1][j], a[1], b0, b1);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      if (m && !two) break;
#pragma unroll
      for (int j = 0; j < kFwdTiles; ++j) {
        const int nt = base + j * kWarps;
        if (nt >= nt_all) continue;
        float* row = gates + (m * 16 + g) * gs + nt * 8 + 2 * t;
        const float* d = acc[m][j];
        *reinterpret_cast<float2*>(row) =
            make_float2(rnd<__nv_bfloat16>(d[0]), rnd<__nv_bfloat16>(d[1]));
        *reinterpret_cast<float2*>(row + 8 * gs) =
            make_float2(rnd<__nv_bfloat16>(d[2]), rnd<__nv_bfloat16>(d[3]));
      }
    }
  }
}

__device__ void gate_product(const float* w, const float* h, float* gates, int nrows,
                             const Geo& geo) {
  const int ks = geo.ks(), gs = geo.gs(), nc = geo.nc(), h4 = round_up(geo.H, 4);
  const int items = (nrows + 3) / 4 * nc;
  for (int it = threadIdx.x; it < items; it += kThreads) {
    const int q = it / nc, c = it - q * nc;
    const float* wr = w + c * ks;
    const float* hr = h + q * 4 * ks;
    float acc[4] = {};
    for (int k = 0; k < h4; k += 4) {
      const float4 wv = *reinterpret_cast<const float4*>(wr + k);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float4 hv = *reinterpret_cast<const float4*>(hr + r * ks + k);
        acc[r] = fmaf(hv.x, wv.x, acc[r]);
        acc[r] = fmaf(hv.y, wv.y, acc[r]);
        acc[r] = fmaf(hv.z, wv.z, acc[r]);
        acc[r] = fmaf(hv.w, wv.w, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) gates[(q * 4 + r) * gs + c] = acc[r];
  }
}

// Backward: this block's part of dgates @ w_hh, sum over its 4U gate
// columns for every row of the group and every hidden unit n, stored into
// the owner of n's `recv` (same offset in every block) at [rank][row][n - owner U].
__device__ void recur_product(const __nv_bfloat16* w, const __nv_bfloat16* dg, float* recv,
                              int rank, int nrows, const Geo& geo) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int gs = geo.gs(), nt_all = round_up(geo.H, 8) / 8, kt_all = geo.nc() / 16;
  const int U = geo.U, RB = geo.RB;
  const bool two = nrows > 16;
  const uint32_t base_addr = smem_addr(recv + (size_t)rank * RB * U);
  for (int base = warp; base < nt_all; base += kWarps * kBwdTiles) {
    float acc[2][kBwdTiles][4] = {};
    for (int kt = 0; kt < kt_all; ++kt) {
      const int k = kt * 16;
      uint32_t a[2][4];
      load_a(a[0], dg + k, gs, g, t);
      if (two) load_a(a[1], dg + 16 * gs + k, gs, g, t);
#pragma unroll
      for (int j = 0; j < kBwdTiles; ++j) {
        const int nt = base + j * kWarps;
        if (nt < nt_all) {
          const __nv_bfloat16* wr = w + (nt * 8 + g) * gs + k + 2 * t;
          const uint32_t b0 = lds32(wr), b1 = lds32(wr + 8);
          mma_bf16(acc[0][j], a[0], b0, b1);
          if (two) mma_bf16(acc[1][j], a[1], b0, b1);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      if (m && !two) break;
#pragma unroll
      for (int j = 0; j < kBwdTiles; ++j) {
        const int nt = base + j * kWarps;
        const int n = nt * 8 + 2 * t;
        if (nt >= nt_all || n >= geo.H) continue;
        const int owner = n / U, col = n - owner * U;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = m * 16 + g + 8 * half;
          if (row < nrows) {
            const uint32_t local = base_addr + (uint32_t)((row * U + col) * 4);
            st_cluster(cluster_addr(local, owner), acc[m][j][2 * half], acc[m][j][2 * half + 1]);
          }
        }
      }
    }
  }
}

__device__ void recur_product(const float* w, const float* dg, float* recv, int rank, int nrows,
                              const Geo& geo) {
  const int gs = geo.gs(), nc = geo.nc(), h4 = round_up(geo.H, 4), quads = h4 / 4;
  const int U = geo.U, RB = geo.RB;
  const int items = (nrows + 3) / 4 * quads;
  const uint32_t base_addr = smem_addr(recv + (size_t)rank * RB * U);
  for (int it = threadIdx.x; it < items; it += kThreads) {
    const int q = it / quads, n = (it - q * quads) * 4;
    float acc[4][4] = {};
    for (int c = 0; c < nc; ++c) {
      const float4 wv = *reinterpret_cast<const float4*>(w + c * h4 + n);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float d = dg[(q * 4 + r) * gs + c];
        acc[r][0] = fmaf(d, wv.x, acc[r][0]);
        acc[r][1] = fmaf(d, wv.y, acc[r][1]);
        acc[r][2] = fmaf(d, wv.z, acc[r][2]);
        acc[r][3] = fmaf(d, wv.w, acc[r][3]);
      }
    }
    if (n >= geo.H) continue;
    const int owner = n / U, col = n - owner * U;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = q * 4 + r;
      if (row < nrows) {
        const uint32_t local = base_addr + (uint32_t)((row * U + col) * 4);
        st_cluster(cluster_addr(local, owner), acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      }
    }
  }
}

// ------------------------------------------------------------------ forward

// proj [B, steps, 2 x 4H] (direction d's gates at d x 4H, in the order i, f,
// g, o), w_hh [2, 4H, H], lens [B] int32 (1..steps); out [B, steps, 2H]
// (zero past each length), hn, cn [2, B, H]; acts [2, steps, B, 4H] (the
// gate activations) and cs [2, steps, B, H], or NULL.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    lstm_fwd_kernel(const T* __restrict__ proj, const T* __restrict__ whh,
                    const int* __restrict__ lens, T* __restrict__ out, T* __restrict__ hn,
                    T* __restrict__ cn, T* __restrict__ acts, T* __restrict__ cs, int batch,
                    int steps, Geo geo) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = geo.H, U = geo.U, RB = geo.RB, K = geo.K, g4 = 4 * H;
  const int nc = geo.nc(), ks = geo.ks(), gs = geo.gs();
  const int tid = threadIdx.x, rank = cluster_rank();
  const int dir = blockIdx.y & 1, b0 = (blockIdx.y >> 1) * RB;
  const int nrows = min(RB, batch - b0);
  const int u0 = rank * U, ur = min(U, H - u0);
  T* w = reinterpret_cast<T*>(smem);
  T* hbuf = w + (size_t)nc * ks;
  float* gates = reinterpret_cast<float*>(hbuf + (size_t)2 * RB * ks);
  T* hnew = reinterpret_cast<T*>(gates + (size_t)RB * gs);

  const T* wd = whh + (size_t)dir * g4 * H;
  for (int i = tid; i < nc * ks; i += kThreads) {
    const int c = i / ks, k = i - c * ks, j = c % U;
    w[i] = (j < ur && k < H) ? wd[(size_t)((c / U) * H + u0 + j) * H + k] : cvt<T>(0.f);
  }
  for (int i = tid; i < 2 * RB * ks; i += kThreads) hbuf[i] = cvt<T>(0.f);
  for (int i = tid; i < RB * U; i += kThreads) hnew[i] = cvt<T>(0.f);

  // the thread's (row, unit) pairs: p = tid + i x kThreads
  bool on[kPairs];
  int pb[kPairs], pj[kPairs], len[kPairs];
  float hr[kPairs], cr[kPairs], pre[kPairs][4];
#pragma unroll
  for (int i = 0; i < kPairs; ++i) {
    const int p = tid + i * kThreads, b = p / U, j = p - b * U;
    on[i] = b < nrows && j < ur;
    pb[i] = b;
    pj[i] = j;
    len[i] = on[i] ? lens[b0 + b] : 0;
    hr[i] = cr[i] = 0.f;
  }
  const int last = longest(lens + b0, nrows, steps);
  // the input projection of step s at each running pair (the reverse
  // direction's step s reads position len - 1 - s)
  auto prefetch = [&](int s) {
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      if (on[i] && s < len[i]) {
        const int pos = dir ? len[i] - 1 - s : s;
        const T* p = proj + ((size_t)(b0 + pb[i]) * steps + pos) * 2 * g4 + dir * g4 + u0 + pj[i];
#pragma unroll
        for (int q = 0; q < 4; ++q) pre[i][q] = ld(p + q * H);
      }
    }
  };

  cluster_arrive();   // every block's buffers are zero before any h arrives
  prefetch(0);
  cluster_wait();
  for (int s = 0; s < last; ++s) {
    const int cur = s & 1;
    gate_product(w, hbuf + (size_t)cur * RB * ks, gates, nrows, geo);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      if (!on[i]) continue;
      const int b = pb[i], j = pj[i];
      T* o = out + (size_t)(b0 + b) * steps * 2 * H + dir * H + u0 + j;
      if (s < len[i]) {
        const float* gr = gates + b * gs + j;
        float x[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) x[q] = rnd<T>(__fadd_rn(pre[i][q], gr[q * U]));
        const float ig = logistic<T>(x[0]), fg = logistic<T>(x[1]);
        const float gg = rnd<T>(tanhf(x[2])), og = logistic<T>(x[3]);
        const float c = rnd<T>(
            __fadd_rn(rnd<T>(__fmul_rn(fg, cr[i])), rnd<T>(__fmul_rn(ig, gg))));
        const float h = rnd<T>(__fmul_rn(og, rnd<T>(tanhf(c))));
        cr[i] = c;
        hr[i] = h;
        const int pos = dir ? len[i] - 1 - s : s;
        o[(size_t)pos * 2 * H] = cvt<T>(h);
        if (acts) {
          const size_t row = ((size_t)dir * steps + s) * batch + b0 + b;
          T* a = acts + row * g4 + u0 + j;
          a[0] = cvt<T>(ig);
          a[H] = cvt<T>(fg);
          a[2 * H] = cvt<T>(gg);
          a[3 * H] = cvt<T>(og);
          cs[row * H + u0 + j] = cvt<T>(c);
        }
      } else {
        o[(size_t)s * 2 * H] = cvt<T>(0.f);
      }
      hnew[b * U + j] = cvt<T>(hr[i]);
    }
    if (s + 1 == last) break;
    __syncthreads();
    // h_t of the block's units into every block's next buffer
    const int chunks = (ur * (int)sizeof(T) + 15) / 16, per = nrows * chunks;
    const uint32_t dst = smem_addr(hbuf + (size_t)(cur ^ 1) * RB * ks + u0);
    for (int i = tid; i < K * per; i += kThreads) {
      const int q = i / per, rem = i - q * per, b = rem / chunks, ch = rem - b * chunks;
      const uint4 v = *reinterpret_cast<const uint4*>(
          reinterpret_cast<const char*>(hnew + b * U) + ch * 16);
      st_cluster(cluster_addr(dst + (uint32_t)(b * ks * (int)sizeof(T) + ch * 16), q), v);
    }
    cluster_arrive();   // release: this block's h_t is delivered
    prefetch(s + 1);
    cluster_wait();     // acquire: so is every other block's
  }
#pragma unroll
  for (int i = 0; i < kPairs; ++i) {
    if (!on[i]) continue;
    const size_t at = ((size_t)dir * batch + b0 + pb[i]) * H + u0 + pj[i];
    hn[at] = cvt<T>(hr[i]);
    cn[at] = cvt<T>(cr[i]);
    T* o = out + (size_t)(b0 + pb[i]) * steps * 2 * H + dir * H + u0 + pj[i];
    for (int s = last; s < steps; ++s) o[(size_t)s * 2 * H] = cvt<T>(0.f);
  }
}

// ----------------------------------------------------------------- backward

// The forward's w_hh, lens, acts and cs; d_out [B, steps, 2H], d_h, d_c
// [2, B, H] (each NULL for a zero gradient); dproj [B, steps, 2 x 4H], the
// gate pre-activations' gradient at the positions the forward read them
// (zero past each length).
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    lstm_bwd_kernel(const T* __restrict__ whh, const int* __restrict__ lens,
                    const T* __restrict__ acts, const T* __restrict__ cs,
                    const T* __restrict__ dout, const T* __restrict__ dhn,
                    const T* __restrict__ dcn, T* __restrict__ dproj, int batch, int steps,
                    Geo geo) {
  constexpr bool kBf = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = geo.H, U = geo.U, RB = geo.RB, K = geo.K, g4 = 4 * H;
  const int nc = geo.nc(), gs = geo.gs();
  const int tid = threadIdx.x, rank = cluster_rank();
  const int dir = blockIdx.y & 1, b0 = (blockIdx.y >> 1) * RB;
  const int nrows = min(RB, batch - b0);
  const int u0 = rank * U, ur = min(U, H - u0);
  T* w = reinterpret_cast<T*>(smem);
  T* dg = w + geo.wb_elems();
  float* recv = reinterpret_cast<float*>(dg + (size_t)RB * gs);

  const T* wd = whh + (size_t)dir * g4 * H;
  const int nw = kBf ? round_up(H, 8) : round_up(H, 4);
  for (int i = tid; i < nc * nw; i += kThreads) {
    const int c = i / nw, n = i - c * nw, j = c % U;
    const T v = (j < ur && n < H) ? wd[(size_t)((c / U) * H + u0 + j) * H + n] : cvt<T>(0.f);
    if (kBf)
      w[n * gs + c] = v;   // unit-major: the product's b operand
    else
      w[c * nw + n] = v;
  }
  for (int i = tid; i < RB * gs; i += kThreads) dg[i] = cvt<T>(0.f);

  bool on[kPairs];
  int pb[kPairs], pj[kPairs], len[kPairs];
  float dh[kPairs], dc[kPairs], a[kPairs][4], c1[kPairs], c0[kPairs], go[kPairs];
#pragma unroll
  for (int i = 0; i < kPairs; ++i) {
    const int p = tid + i * kThreads, b = p / U, j = p - b * U;
    on[i] = b < nrows && j < ur;
    pb[i] = b;
    pj[i] = j;
    len[i] = on[i] ? lens[b0 + b] : 0;
    const size_t at = ((size_t)dir * batch + b0 + b) * H + u0 + j;
    dh[i] = on[i] && dhn ? ld(dhn + at) : 0.f;
    dc[i] = on[i] && dcn ? ld(dcn + at) : 0.f;
  }
  const int last = longest(lens + b0, nrows, steps);
#pragma unroll
  for (int i = 0; i < kPairs; ++i) {
    if (!on[i]) continue;
    T* dp = dproj + (size_t)(b0 + pb[i]) * steps * 2 * g4 + dir * g4 + u0 + pj[i];
    for (int s = last; s < steps; ++s)
#pragma unroll
      for (int q = 0; q < 4; ++q) dp[(size_t)s * 2 * g4 + q * H] = cvt<T>(0.f);
  }
  // what step s of each running pair reads: its gate activations, c_s,
  // c_{s-1} and the output's gradient
  auto prefetch = [&](int s) {
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      if (on[i] && s < len[i]) {
        const size_t row = ((size_t)dir * steps + s) * batch + b0 + pb[i];
        const T* ap = acts + row * g4 + u0 + pj[i];
#pragma unroll
        for (int q = 0; q < 4; ++q) a[i][q] = ld(ap + q * H);
        c1[i] = ld(cs + row * H + u0 + pj[i]);
        c0[i] = s ? ld(cs + (row - batch) * H + u0 + pj[i]) : 0.f;
        const int pos = dir ? len[i] - 1 - s : s;
        go[i] = dout ? ld(dout + ((size_t)(b0 + pb[i]) * steps + pos) * 2 * H + dir * H + u0 +
                          pj[i])
                     : 0.f;
      }
    }
  };

  cluster_arrive();   // every block runs before any part arrives
  if (last) prefetch(last - 1);
  cluster_wait();
  for (int s = last - 1; s >= 0; --s) {
    if (s + 1 < last) {
      // dh_s: the K parts of step s + 1's dgates @ w_hh, in rank order
      const float* rv = recv + (size_t)((s + 1) & 1) * K * RB * U;
#pragma unroll
      for (int i = 0; i < kPairs; ++i) {
        if (!on[i] || s + 1 >= len[i]) continue;
        float sum = 0.f;
        for (int q = 0; q < K; ++q) sum = __fadd_rn(sum, rv[((size_t)q * RB + pb[i]) * U + pj[i]]);
        dh[i] = rnd<T>(sum);
      }
    }
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      if (!on[i]) continue;
      const int b = pb[i], j = pj[i];
      T* dp = dproj + (size_t)(b0 + b) * steps * 2 * g4 + dir * g4 + u0 + j;
      T* dgr = dg + b * gs + j;
      if (s < len[i]) {
        const float ig = a[i][0], fg = a[i][1], gg = a[i][2], og = a[i][3];
        const float tc = rnd<T>(tanhf(c1[i]));
        const float gh = rnd<T>(__fadd_rn(go[i], dh[i]));
        const float d_o = rnd<T>(__fmul_rn(gh, tc));
        const float dcs = rnd<T>(__fadd_rn(tanh_grad<T>(rnd<T>(__fmul_rn(gh, og)), tc), dc[i]));
        const float d_i = rnd<T>(__fmul_rn(dcs, gg));
        const float d_g = rnd<T>(__fmul_rn(dcs, ig));
        const float d_f = rnd<T>(__fmul_rn(dcs, c0[i]));
        dc[i] = rnd<T>(__fmul_rn(dcs, fg));
        const float v[4] = {logistic_grad<T>(d_i, ig), logistic_grad<T>(d_f, fg),
                            tanh_grad<T>(d_g, gg), logistic_grad<T>(d_o, og)};
        const int pos = dir ? len[i] - 1 - s : s;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          dp[(size_t)pos * 2 * g4 + q * H] = cvt<T>(v[q]);
          dgr[q * U] = cvt<T>(v[q]);
        }
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          dp[(size_t)s * 2 * g4 + q * H] = cvt<T>(0.f);
          dgr[q * U] = cvt<T>(0.f);
        }
      }
    }
    if (s == 0) break;
    __syncthreads();
    recur_product(w, dg, recv + (size_t)(s & 1) * K * RB * U, rank, nrows, geo);
    cluster_arrive();   // release: this block's parts are delivered
    prefetch(s - 1);
    cluster_wait();     // acquire: so is every other block's
  }
}

// The recurrence's sequential floor: a cluster of k blocks that does
// nothing but `steps` cluster barriers (chip_smoke.py times it beside the
// kernels).
__global__ void __launch_bounds__(kThreads, 1) lstm_barriers_kernel(int steps) {
  for (int s = 0; s < steps; ++s) {
    cluster_arrive();
    cluster_wait();
  }
}

// ------------------------------------------------------------------ launch

// 0 when (hidden, units, rows, k) is a layout the kernels take
int check_geo(const Geo& g) {
  const int align = g.bf ? 8 : 4;
  if (g.H < 1 || g.U < align || g.U % align || (g.RB != 16 && g.RB != 32) ||
      g.RB * g.U > kPairs * kThreads || g.K < 1 || g.K > kMaxLstmCluster ||
      (size_t)g.K * g.U < (size_t)g.H || (size_t)(g.K - 1) * g.U >= (size_t)g.H)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// Launch `kern` as clusters of k blocks, grid (k, grid_y), with `smem` bytes
// of dynamic shared memory each; the first launch on a card opts the kernel
// in to the largest shared memory and to a non-portable cluster size.
template <typename... Params, typename... Args>
int cluster_launch(void (*kern)(Params...), int k, int grid_y, size_t smem, cudaStream_t stream,
                   Args... args) {
  static unsigned ready = 0;   // a bit per card
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e) return (int)e;
  if (dev >= 32) return (int)cudaErrorInvalidDevice;
  if (!(ready >> dev & 1u)) {
    int optin = 0;
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (!e) e = cudaFuncSetAttribute((const void*)kern,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (!e) e = cudaFuncSetAttribute((const void*)kern,
                                     cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e) return (int)e;
    ready |= 1u << dev;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(k, grid_y, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = k;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kern, args...);
}

Geo make_geo(int hidden, int units, int rows, int k, int dtype) {
  return Geo{hidden, units, rows, k, dtype == 1};
}

}  // namespace

// Bytes of dynamic shared memory of the forward (bwd 0) or the backward
// (bwd 1) at this layout; -1 for a layout the kernels do not take.
extern "C" long long dwc_lstm_smem(int hidden, int units, int rows, int k, int dtype, int bwd) {
  const Geo g = make_geo(hidden, units, rows, k, dtype);
  if (check_geo(g) || (dtype != 0 && dtype != 1)) return -1;
  return (long long)(bwd ? g.bwd_smem() : g.fwd_smem());
}

// dtype 0 fp32, 1 bf16; rows: the rows a cluster takes (16 or 32).
extern "C" int dwc_lstm(const void* proj, const void* w_hh, const void* lens, void* out, void* hn,
                        void* cn, void* acts, void* cs, int batch, int steps, int hidden,
                        int dtype, int k, int units, int rows, void* stream) {
  const Geo g = make_geo(hidden, units, rows, k, dtype);
  if (check_geo(g) || batch < 1 || steps < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int grid_y = 2 * ((batch + rows - 1) / rows);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    using T = __nv_bfloat16;
    return cluster_launch(lstm_fwd_kernel<T>, k, grid_y, g.fwd_smem(), st,
                          static_cast<const T*>(proj), static_cast<const T*>(w_hh),
                          static_cast<const int*>(lens), static_cast<T*>(out),
                          static_cast<T*>(hn), static_cast<T*>(cn), static_cast<T*>(acts),
                          static_cast<T*>(cs), batch, steps, g);
  }
  using T = float;
  return cluster_launch(lstm_fwd_kernel<T>, k, grid_y, g.fwd_smem(), st,
                        static_cast<const T*>(proj), static_cast<const T*>(w_hh),
                        static_cast<const int*>(lens), static_cast<T*>(out), static_cast<T*>(hn),
                        static_cast<T*>(cn), static_cast<T*>(acts), static_cast<T*>(cs), batch,
                        steps, g);
}

extern "C" int dwc_lstm_bwd(const void* w_hh, const void* lens, const void* acts, const void* cs,
                            const void* d_out, const void* d_h, const void* d_c, void* dproj,
                            int batch, int steps, int hidden, int dtype, int k, int units,
                            int rows, void* stream) {
  const Geo g = make_geo(hidden, units, rows, k, dtype);
  if (check_geo(g) || batch < 1 || steps < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int grid_y = 2 * ((batch + rows - 1) / rows);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    using T = __nv_bfloat16;
    return cluster_launch(lstm_bwd_kernel<T>, k, grid_y, g.bwd_smem(), st,
                          static_cast<const T*>(w_hh), static_cast<const int*>(lens),
                          static_cast<const T*>(acts), static_cast<const T*>(cs),
                          static_cast<const T*>(d_out), static_cast<const T*>(d_h),
                          static_cast<const T*>(d_c), static_cast<T*>(dproj), batch, steps, g);
  }
  using T = float;
  return cluster_launch(lstm_bwd_kernel<T>, k, grid_y, g.bwd_smem(), st,
                        static_cast<const T*>(w_hh), static_cast<const int*>(lens),
                        static_cast<const T*>(acts), static_cast<const T*>(cs),
                        static_cast<const T*>(d_out), static_cast<const T*>(d_h),
                        static_cast<const T*>(d_c), static_cast<T*>(dproj), batch, steps, g);
}

// `steps` cluster barriers of one cluster of k blocks (a measurement).
extern "C" int dwc_lstm_barriers(int k, int steps, void* stream) {
  if (k < 1 || k > kMaxLstmCluster || steps < 0) return (int)cudaErrorInvalidValue;
  return cluster_launch(lstm_barriers_kernel, k, 1, 0, static_cast<cudaStream_t>(stream),
                        steps);
}
