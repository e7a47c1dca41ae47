// GroupNorm + affine, then optionally the timestep's scale-shift and SiLU,
// over NCHW groups, and its backward (ADM's AdaGN chain,
// cat_tpu_torch/models/adm.py):
//   for each (n, group g): μ, var over the group's (C/G)·H·W values
//   (float32, centred, biased), rstd = rsqrt(var + eps);
//   y = (x - μ)·rstd·γ[c] + β[c];
//   u = y·(1 + s[n, c]) + t[n, c] (s, t read in place from the timestep
//   linear's (N, 2C) output: C scales, then C shifts), or u = y;
//   out = SiLU(u) or u, rounded once to x's dtype.
//
// Replaces no TPU kernel: the JAX package runs ADM's GroupNorm through XLA.
// It was added because the ADM cell's step spent about half its device time
// on this chain in separate kernels: a float32 upcast, ATen's group norm
// (three kernels), a cast back, then the scale-shift and SiLU, each a pass
// over device memory (~30 bytes a value forward, ~44 backward).
//
// Bound on an H100: bytes.  ~12 flops a value forward and ~25 backward
// against 4 (bf16) or 8 (f32) bytes moved.  The forward must read x once and
// write the output once; the backward must read x and g once and write dx
// once.  (The statistics, γ, β, s and t are a few KiB.)
//
// Layout: x is NCHW-contiguous, so group g of sample n is one contiguous slab
// of M = (C/G)·H·W values: channel c of the group is the run
// [(c mod C/G)·H·W, +H·W) of it.  A (B, C, T) tensor is the same with
// H·W = T.
//
// The design (group_norm_act_fwd, group_norm_act_bwd) follows
// instance_norm.cu's staged kernels.  A slab is read from device memory
// once, into shared memory, by 1-D bulk copies (cp.async.bulk ...
// mbarrier::complete_tx) that one thread issues in up to four chunks, each
// on its own mbarrier.  Everything else is taken from shared memory and the
// output is stored with 16-byte stores.  At ~17 instructions and two MUFU
// operations a value forward, the bytes bound asks for ~45% of the SMs'
// issue rate and ~40% of their MUFU rate (the backward, had it taken SiLU'
// twice, more), so the arithmetic is kept lean: the fast exp and reciprocal
// in SiLU, bf16 converted two values at a time, each access's channel found
// by a multiply and a shift, and the backward's du kept in registers
// between its two passes.  The host plans by shape
// (ops/group_norm.py::group_norm_plan):
//   - a slab of at most 64 KiB (x and g together in the backward) is one
//     CTA's ("cta");
//   - a larger one is split over a thread-block cluster of k CTAs
//     ("cluster"; past 8, the portable size, a non-portable one), each
//     staging <= 64 KiB: whole channels or an equal piece of one channel.
//     Up to three CTAs of 512 threads share an SM, so one CTA's copies
//     overlap another's arithmetic;
//   - anything else ("split": a cluster past 16 forward or 8 backward, where
//     the split path measured faster; more than 64 channels a group; an
//     unaligned tensor) takes two passes over device memory with one CTA a
//     piece of one channel: group_norm_piece_stats / group_norm_act_apply
//     forward, group_norm_piece_grads / group_norm_act_bwd_apply backward.
// Measured on an H100 at the ADM cell's sites (batch 16, bf16): 54% of the
// bytes bound forward and 41% backward over a step, 65% at best for one
// shape.  At that speed the arithmetic takes ~28% of the issue rate; the
// likely limits (not measured apart) are that a slab's CTAs load, sum and
// store in step, so a grid of few waves (512 slabs) streams unevenly, and
// that a cluster of 16 waits for its slowest CTA and for 16 free slots in
// one GPC.
// No slabs are packed several to a CTA, as instance_norm.cu packs small
// planes: the ADM cell has N·G = 512 slabs a site, which one wave of
// resident CTAs (132 SMs x 4 of 512 threads) holds, so packing would only
// leave SMs idle.
//
// Statistics.  Slabs reach 2M values, where Σx² - (Σx)²/M in float32 loses
// digits, so the variance is centred: each CTA takes the mean of its slice
// from shared memory, then Σ(x - mean)² in a second pass over shared memory
// (not over device memory).  A cluster's CTAs then merge their (count, mean,
// M2) by Chan's formula in rank order through distributed shared memory, so
// every CTA of a slab uses the same μ and rstd bit for bit; a second cluster
// barrier keeps each CTA alive until its peers have read it.  The split path
// merges its pieces' centred moments the same way, in a fixed order.
//
// The backward keeps only x and the forward's (N, G) μ and rstd; it
// recomputes x̂ = (x - μ)·rstd, u and SiLU'(u) from x.  With
// a_c = γ_c·(1 + s_c) and du = g·SiLU'(u) (g without SiLU):
//   P_c = Σ du, Q_c = Σ du·x̂ over the channel's H·W values;
//   s1 = Σ_c a_c·P_c, s2 = Σ_c a_c·Q_c over the group's channels;
//   dx = rstd·(a_c·du - (s1 + x̂·s2)/M).
// Each thread of a staged CTA keeps the du of its (at most four) 16-byte
// accesses in registers from the first pass to the second, so SiLU' is
// taken once; the accesses' (P, Q) go to shared memory and one warp a
// channel piece sums them (no atomics).  The CTA writes each piece's (P, Q)
// to an (N, C, pieces) buffer, and its share of s1 and s2 goes through the
// cluster as the statistics do.
// group_norm_bwd_channels then sums the buffer, n in order, into
//   dγ_c = Σ_n (1 + s)·Q, dβ_c = Σ_n (1 + s)·P,
//   d scale[n, c] = γ_c·Q + β_c·P, d shift[n, c] = P
// (the last two as one (N, 2C) gradient of the linear's output in its
// dtype): no float atomics anywhere, so two calls give the same bits.
//
// Limits (checked by the Python wrapper): x (and g) contiguous, bf16 or f32;
// γ, β float32 (C,); the scale-shift (N, 2C) contiguous in x's dtype.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunks = 4;   // bulk copies of a slice, one mbarrier each
constexpr int kMaxSegs = 64;    // channels a staged CTA touches
constexpr int kPortable = 8;    // the portable cluster size
constexpr int kBwdVecs = 4;     // 16-byte accesses a thread of the staged backward holds:
                                // its x and g slices of <= 32 KiB each over 512 threads
constexpr unsigned long long kHangNs = 2000000000ull;  // a 2 s wait is a fault: trap

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// SiLU and its derivative with the fast exp and reciprocal (~2 ulp each,
// far under a bf16 rounding; within the float32 tests' 1e-5).
__device__ __forceinline__ float act(float u, int silu) {
  return silu ? __fdividef(u, 1.f + __expf(-u)) : u;
}

// d act / du at u: σ + u·σ·(1 - σ) = σ·(1 + u - u·σ).
__device__ __forceinline__ float act_grad(float u, int silu) {
  if (!silu) return 1.f;
  const float sg = __fdividef(1.f, 1.f + __expf(-u));
  return sg * (1.f + fmaf(-u, sg, u));
}

// (a, b) of channel c of sample n, so that u = x̂·a + b with x̂ = (x - μ)·rstd
// times `r`: a = r·γ·(1 + s), b = β·(1 + s) + t (s, t from emb when given).
template <typename T>
__device__ __forceinline__ float2 channel_coef(float r, const float* gamma, const float* beta,
                                               const T* emb, long long n, int C, int c) {
  float a = r * gamma[c], b = beta[c];
  if (emb != nullptr) {
    const float sc = 1.f + to_f(emb[n * 2 * C + c]), sh = to_f(emb[n * 2 * C + C + c]);
    a *= sc;
    b = b * sc + sh;
  }
  return make_float2(a, b);
}

// Sum of v over the CTA, returned to every thread with the same bits.
__device__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();  // red may still be read from a previous call
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += red[w];
  return s;
}

// (count, mean, M2) of some values; merge is Chan's formula, b after a.
struct Moments {
  float n, mean, m2;
};

__device__ __forceinline__ Moments merge(Moments a, Moments b) {
  if (b.n == 0.f) return a;
  if (a.n == 0.f) return b;
  const float n = a.n + b.n, d = b.mean - a.mean, w = b.n / n;
  return {n, a.mean + d * w, a.m2 + b.m2 + d * d * a.n * w};
}

// 16 bytes at p as floats; V floats to 16 bytes at p (bf16: two at a time).
__device__ __forceinline__ void load16(const float* p, float (&v)[4]) {
  const float4 r = *reinterpret_cast<const float4*>(p);
  v[0] = r.x;
  v[1] = r.y;
  v[2] = r.z;
  v[3] = r.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = __uint_as_float(w[k] << 16);
    v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

__device__ __forceinline__ void store16(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store16(__nv_bfloat16* p, const float (&v)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    w[k] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// n / d for n < 2^31 by a multiply and a shift (Granlund-Montgomery): the
// staged kernels find each 16-byte access's channel this way.
struct Div {
  uint32_t m;
  int s;
};

__device__ __forceinline__ Div make_div(uint32_t d) {
  const int l = d > 1 ? 32 - __clz(d - 1) : 0;  // ceil(log2 d)
  return {static_cast<uint32_t>(((1ull << (31 + l)) + d - 1) / d), l - 1};
}

__device__ __forceinline__ uint32_t divide(uint32_t n, Div dv) {
  return dv.s < 0 ? n : __umulhi(n, dv.m) >> dv.s;
}

// f(i0, a[i], b[i]) for every i in [lo, hi), thread t of nt: i0 is the first
// index of the 16-byte access that holds i when vec (lo a multiple of its
// values), i itself otherwise; b may be null (0 then).
template <typename T, typename F>
__device__ __forceinline__ void each(const T* a, const T* b, long long lo, long long hi, int t,
                                     int nt, int vec, F&& f) {
  constexpr int V = 16 / sizeof(T);
  if (vec) {
#pragma unroll 2
    for (long long i = lo + static_cast<long long>(t) * V; i < hi;
         i += static_cast<long long>(nt) * V) {
      float va[V], vb[V] = {};
      load16(a + i, va);
      if (b) load16(b + i, vb);
#pragma unroll
      for (int q = 0; q < V; ++q) f(i, va[q], vb[q]);
    }
  } else {
    for (long long i = lo + t; i < hi; i += nt) f(i, to_f(a[i]), b ? to_f(b[i]) : 0.f);
  }
}

// out[i] = f(i0, a[i], b[i]) over [lo, hi) by all the CTA's threads, as each.
template <typename T, typename F>
__device__ __forceinline__ void map(const T* a, const T* b, T* out, long long lo, long long hi,
                                    int vec, F&& f) {
  constexpr int V = 16 / sizeof(T);
  if (vec) {
#pragma unroll 2
    for (long long i = lo + static_cast<long long>(threadIdx.x) * V; i < hi;
         i += static_cast<long long>(kThreads) * V) {
      float va[V], vb[V] = {};
      load16(a + i, va);
      if (b) load16(b + i, vb);
#pragma unroll
      for (int q = 0; q < V; ++q) va[q] = f(i, va[q], vb[q]);
      store16(out + i, va);
    }
  } else {
    for (long long i = lo + threadIdx.x; i < hi; i += kThreads)
      out[i] = from_f<T>(f(i, to_f(a[i]), b ? to_f(b[i]) : 0.f));
  }
}

// ---------------------------------------------------------------------------
// mbarrier, bulk copy and cluster primitives (as instance_norm.cu's)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed; trap after 2 s.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .u64 t0, t1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "mov.u64 t0, %%globaltimer;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "mov.u64 t1, %%globaltimer;\n"
      "sub.u64 t1, t1, t0;\n"
      "setp.gt.u64 p, t1, %2;\n"
      "@p trap;\n"
      "bra WAIT;\n"
      "DONE:\n}\n" ::"r"(bar),
      "r"(parity), "l"(kHangNs)
      : "memory");
}

// Copy `bytes` (a multiple of 16) from global `src` to shared `dst` (both
// 16-byte aligned); completion counts the bytes on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// A staged CTA's share: slab n·G + g, its rank in the slab's cluster, the
// values [start, start + len) of the slab it holds, and the channels of the
// group it touches (c0, c0 + nseg).
struct Slice {
  long long slab;
  int rank;
  long long start, len;
  int c0, nseg;
};

__device__ __forceinline__ Slice slice_of(long long M, long long HW, int k, long long slice) {
  Slice s;
  s.slab = blockIdx.x / k;
  s.rank = static_cast<int>(blockIdx.x % k);
  s.start = s.rank * slice;
  s.len = min(slice, M - s.start);
  s.c0 = static_cast<int>(s.start / HW);
  s.nseg = static_cast<int>((s.start + s.len - 1) / HW) - s.c0 + 1;
  return s;
}

// Thread 0: init the chunks' mbarriers and issue every chunk's copies of
// `kArrays` tensors (x, or x and g), array a landing at smem + a·slice.
// Returns the number of chunks.
template <typename T, int kArrays>
__device__ __forceinline__ int stage(const Slice& s, uint64_t* bars, T* smem,
                                     const T* const (&src)[kArrays], long long M,
                                     long long slice, long long chunk) {
  const int nch = static_cast<int>((s.len + chunk - 1) / chunk);
  if (threadIdx.x == 0) {
    for (int i = 0; i < nch; ++i) mbar_init(smem_u32(&bars[i]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < nch; ++i) {
      const long long off = i * chunk;
      const uint32_t bytes = static_cast<uint32_t>(min(chunk, s.len - off) * sizeof(T));
      const uint32_t bar = smem_u32(&bars[i]);
      mbar_expect_tx(bar, kArrays * bytes);
#pragma unroll
      for (int a = 0; a < kArrays; ++a)
        bulk_load(smem_u32(smem + a * slice + off), src[a] + s.slab * M + s.start + off, bytes,
                  bar);
    }
  }
  __syncthreads();  // the barriers are initialised before anyone waits on them
  return nch;
}

// ---------------------------------------------------------------------------
// Forward, staged: one HBM read of the slab and one write
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
group_norm_act_fwd(const T* __restrict__ x, const float* __restrict__ gamma,
                   const float* __restrict__ beta, const T* __restrict__ emb, T* __restrict__ y,
                   float* __restrict__ mean_out, float* __restrict__ rstd_out, int C, int cpg,
                   long long HW, int k, long long slice, long long chunk, float eps, int silu) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);
  __shared__ __align__(8) uint64_t bars[kMaxChunks];
  __shared__ float red[kWarps];
  __shared__ float2 part;  // this CTA's (mean, M2), read by its cluster's peers
  __shared__ float2 coef[kMaxSegs];

  const long long M = static_cast<long long>(cpg) * HW;
  const Slice s = slice_of(M, HW, k, slice);
  const T* const srcs[1] = {x};
  const int nch = stage<T, 1>(s, bars, xs, srcs, M, slice, chunk);

  // the slice's mean, chunk by chunk as the copies land, then its centred M2
  float sum = 0.f;
  for (int i = 0; i < nch; ++i) {
    mbar_wait(smem_u32(&bars[i]), 0);
    each<T>(xs, nullptr, i * chunk, min(s.len, (i + 1) * chunk), threadIdx.x, kThreads, 1,
            [&](long long, float v, float) { sum += v; });
  }
  const float mean_i = block_sum(sum, red) / static_cast<float>(s.len);
  float m2 = 0.f;
  each<T>(xs, nullptr, 0, s.len, threadIdx.x, kThreads, 1, [&](long long, float v, float) {
    const float d = v - mean_i;
    m2 += d * d;
  });
  m2 = block_sum(m2, red);
  float mean = mean_i;
  if (k > 1) {
    if (threadIdx.x == 0) part = make_float2(mean_i, m2);
    cluster_arrive();
    cluster_wait();  // every peer's (mean, M2) is written
    cg::cluster_group cluster = cg::this_cluster();
    Moments t = {0.f, 0.f, 0.f};
    for (int r = 0; r < k; ++r) {
      const float2 p = *cluster.map_shared_rank(&part, r);
      t = merge(t, {static_cast<float>(min(slice, M - r * slice)), p.x, p.y});
    }
    cluster_arrive();  // done reading the peers; the matching wait is before exit
    mean = t.mean;
    m2 = t.m2;
  }
  const float rstd = rsqrtf(m2 / static_cast<float>(M) + eps);
  const int G = C / cpg;
  const long long n = s.slab / G;
  const int cb = static_cast<int>(s.slab % G) * cpg + s.c0;  // the first channel touched
  if (s.rank == 0 && threadIdx.x == 0) {
    mean_out[s.slab] = mean;
    rstd_out[s.slab] = rstd;
  }
  for (int i = threadIdx.x; i < s.nseg; i += kThreads)
    coef[i] = channel_coef(rstd, gamma, beta, emb, n, C, cb + i);
  __syncthreads();

  const Div hw = make_div(static_cast<uint32_t>(HW));
  const uint32_t first = static_cast<uint32_t>(s.start - s.c0 * HW);  // into channel c0
  map<T>(xs, nullptr, y + s.slab * M + s.start, 0, s.len, 1, [&](long long i, float v, float) {
    const float2 cf = coef[divide(static_cast<uint32_t>(i) + first, hw)];
    return act(fmaf(v - mean, cf.x, cf.y), silu);
  });
  if (k > 1) cluster_wait();  // the peers have read this CTA's (mean, M2)
}

// ---------------------------------------------------------------------------
// Backward, staged: one HBM read of x and of g, one write of dx
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
group_norm_act_bwd(const T* __restrict__ x, const T* __restrict__ g,
                   const float* __restrict__ mean_in, const float* __restrict__ rstd_in,
                   const float* __restrict__ gamma, const float* __restrict__ beta,
                   const T* __restrict__ emb, T* __restrict__ dx, float2* __restrict__ parts,
                   int C, int cpg, long long HW, int k, long long slice, long long chunk,
                   int pieces, int silu) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);
  const T* gs = xs + slice;
  float2* pv = reinterpret_cast<float2*>(xs + 2 * slice);  // (P, Q) a 16-byte access
  __shared__ __align__(8) uint64_t bars[kMaxChunks];
  __shared__ float2 coef[kMaxSegs];  // (a, b) a channel, without rstd
  __shared__ float2 pq[kMaxSegs];    // (P, Q) a warp's piece
  __shared__ float2 part;            // this CTA's (Σ a·P, Σ a·Q), read by its peers
  __shared__ float2 tot;             // the slab's (s1, s2)

  const long long M = static_cast<long long>(cpg) * HW;
  const Slice s = slice_of(M, HW, k, slice);
  const T* const srcs[2] = {x, g};
  const int nch = stage<T, 2>(s, bars, xs, srcs, M, slice, chunk);
  const int G = C / cpg;
  const long long n = s.slab / G;
  const int cb = static_cast<int>(s.slab % G) * cpg + s.c0;
  const float mean = mean_in[s.slab], rstd = rstd_in[s.slab];
  for (int i = threadIdx.x; i < s.nseg; i += kThreads)
    coef[i] = channel_coef(1.f, gamma, beta, emb, n, C, cb + i);
  __syncthreads();  // coef is written
  const Div hw = make_div(static_cast<uint32_t>(HW));
  const uint32_t first = static_cast<uint32_t>(s.start - s.c0 * HW);  // into channel c0

  // Pass 1: du of each value, kept in registers for pass 2 (each thread holds
  // the same kBwdVecs 16-byte accesses in both), and (P, Q) of each access
  float du[kBwdVecs][V];
  int waited = 0;
#pragma unroll
  for (int r = 0; r < kBwdVecs; ++r) {
    const long long e = static_cast<long long>(threadIdx.x + r * kThreads) * V;
    if (e < s.len) {
      for (const long long need = (e + V - 1) / chunk; waited <= need; ++waited)
        mbar_wait(smem_u32(&bars[waited]), 0);
      const float2 cf = coef[divide(static_cast<uint32_t>(e) + first, hw)];
      float xv[V], gv[V];
      load16(xs + e, xv);
      load16(gs + e, gv);
      float P = 0.f, Q = 0.f;
#pragma unroll
      for (int q = 0; q < V; ++q) {
        const float xh = (xv[q] - mean) * rstd;
        du[r][q] = gv[q] * act_grad(fmaf(xh, cf.x, cf.y), silu);
        P += du[r][q];
        Q = fmaf(du[r][q], xh, Q);
      }
      pv[e / V] = make_float2(P, Q);
    }
  }
  for (; waited < nch; ++waited) mbar_wait(smem_u32(&bars[waited]), 0);  // before exit
  __syncthreads();

  // (P, Q) of each channel piece from the accesses' sums: a channel segment
  // is cut into q pieces so that there are at least as many pieces as
  // warps; one warp a piece
  const int q = s.nseg >= kWarps ? 1 : (kWarps + s.nseg - 1) / s.nseg;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int p = warp; p < s.nseg * q; p += kWarps) {
    const int seg = p / q, j = p % q;
    const long long lo = max(0ll, (s.c0 + seg) * HW - s.start) / V;
    const long long nv = min(s.len, (s.c0 + seg + 1) * HW - s.start) / V - lo;
    float P = 0.f, Q = 0.f;
    for (long long v = lo + nv * j / q + lane; v < lo + nv * (j + 1) / q; v += 32) {
      P += pv[v].x;
      Q += pv[v].y;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      P += __shfl_xor_sync(0xffffffffu, P, o);
      Q += __shfl_xor_sync(0xffffffffu, Q, o);
    }
    if (lane == 0) pq[p] = make_float2(P, Q);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const long long jp = (s.start % HW) / slice;  // the piece of its channel (0: whole channels)
    float s1 = 0.f, s2 = 0.f;
    for (int seg = 0; seg < s.nseg; ++seg) {
      float P = 0.f, Q = 0.f;
      for (int j = 0; j < q; ++j) {
        P += pq[seg * q + j].x;
        Q += pq[seg * q + j].y;
      }
      parts[(n * C + cb + seg) * pieces + jp] = make_float2(P, Q);
      s1 += coef[seg].x * P;
      s2 += coef[seg].x * Q;
    }
    part = make_float2(s1, s2);
  }
  if (k > 1) {
    cluster_arrive();
    cluster_wait();  // every peer's share is written
    if (threadIdx.x == 0) {
      cg::cluster_group cluster = cg::this_cluster();
      float s1 = 0.f, s2 = 0.f;
      for (int r = 0; r < k; ++r) {
        const float2 p = *cluster.map_shared_rank(&part, r);
        s1 += p.x;
        s2 += p.y;
      }
      tot = make_float2(s1, s2);
    }
    cluster_arrive();  // done reading the peers; the matching wait is before exit
  } else if (threadIdx.x == 0) {
    tot = part;
  }
  __syncthreads();

  // Pass 2: dx = rstd·a·du + d1·x̂ + d0
  const float d0 = -rstd * tot.x / static_cast<float>(M);
  const float d1 = -rstd * tot.y / static_cast<float>(M);
  T* out = dx + s.slab * M + s.start;
#pragma unroll
  for (int r = 0; r < kBwdVecs; ++r) {
    const long long e = static_cast<long long>(threadIdx.x + r * kThreads) * V;
    if (e < s.len) {
      const float ar = rstd * coef[divide(static_cast<uint32_t>(e) + first, hw)].x;
      float xv[V];
      load16(xs + e, xv);
#pragma unroll
      for (int q = 0; q < V; ++q) xv[q] = fmaf(ar, du[r][q], fmaf(d1, (xv[q] - mean) * rstd, d0));
      store16(out + e, xv);
    }
  }
  if (k > 1) cluster_wait();  // the peers have read this CTA's share
}

// dγ_c = Σ_n (1 + s)·Q, dβ_c = Σ_n (1 + s)·P (P, Q summed over the channel's
// pieces first), n in order; with the scale-shift also its gradient,
// demb[n, c] = γ_c·Q + β_c·P and demb[n, C + c] = P, in its dtype.
template <typename T>
__global__ void group_norm_bwd_channels(const float2* __restrict__ parts,
                                        const float* __restrict__ gamma,
                                        const float* __restrict__ beta, const T* __restrict__ emb,
                                        T* __restrict__ demb, float* __restrict__ dgamma,
                                        float* __restrict__ dbeta, int N, int C, int pieces) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float dg = 0.f, db = 0.f;
  for (int n = 0; n < N; ++n) {
    float P = 0.f, Q = 0.f;
    for (int j = 0; j < pieces; ++j) {
      const float2 pq = parts[(static_cast<long long>(n) * C + c) * pieces + j];
      P += pq.x;
      Q += pq.y;
    }
    float sc = 1.f;
    if (emb != nullptr) {
      const long long row = static_cast<long long>(n) * 2 * C;
      sc += to_f(emb[row + c]);
      demb[row + c] = from_f<T>(gamma[c] * Q + beta[c] * P);
      demb[row + C + c] = from_f<T>(P);
    }
    dg += sc * Q;
    db += sc * P;
  }
  dgamma[c] = dg;
  dbeta[c] = db;
}

// ---------------------------------------------------------------------------
// The split path: one CTA a piece of `piece` values of one channel
// (index (n·C + c)·pieces + j), two passes over device memory
// ---------------------------------------------------------------------------

__device__ __forceinline__ long long piece_len(long long HW, long long piece, int j) {
  return min(piece, HW - j * piece);
}

// Forward, pass 1: each piece's centred (mean, M2).
template <typename T>
__global__ void __launch_bounds__(kThreads)
group_norm_piece_stats(const T* __restrict__ x, float2* __restrict__ parts, long long HW,
                       long long piece, int pieces, int vec) {
  __shared__ float red[kWarps];
  const long long idx = blockIdx.x, nc = idx / pieces;
  const int j = static_cast<int>(idx % pieces);
  const long long lo = nc * HW + j * piece, hi = lo + piece_len(HW, piece, j);
  float sum = 0.f;
  each<T>(x, nullptr, lo, hi, threadIdx.x, kThreads, vec,
          [&](long long, float v, float) { sum += v; });
  const float mean = block_sum(sum, red) / static_cast<float>(hi - lo);
  float m2 = 0.f;
  each<T>(x, nullptr, lo, hi, threadIdx.x, kThreads, vec, [&](long long, float v, float) {
    const float d = v - mean;
    m2 += d * d;
  });
  m2 = block_sum(m2, red);
  if (threadIdx.x == 0) parts[idx] = make_float2(mean, m2);
}

// The moments of group (n, g) from its channels' pieces, merged in a fixed
// order (thread t: entries t, t + 256, ...; then lanes down a tree; then
// warps in order); every CTA of the group gets the same bits.
__device__ Moments group_moments(const float2* parts, long long first, int entries, int pieces,
                                 long long HW, long long piece, Moments* red) {
  Moments m = {0.f, 0.f, 0.f};
  for (int e = threadIdx.x; e < entries; e += kThreads) {
    const float2 p = parts[first + e];
    m = merge(m, {static_cast<float>(piece_len(HW, piece, e % pieces)), p.x, p.y});
  }
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const Moments other = {__shfl_down_sync(0xffffffffu, m.n, o),
                           __shfl_down_sync(0xffffffffu, m.mean, o),
                           __shfl_down_sync(0xffffffffu, m.m2, o)};
    if (lane + o < 32) m = merge(m, other);
  }
  if (lane == 0) red[threadIdx.x / 32] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    Moments t = red[0];
    for (int w = 1; w < kWarps; ++w) t = merge(t, red[w]);
    red[0] = t;
  }
  __syncthreads();
  return red[0];
}

// Forward, pass 2: the group's μ and rstd from its pieces, then the output.
template <typename T>
__global__ void __launch_bounds__(kThreads)
group_norm_act_apply(const T* __restrict__ x, const float2* __restrict__ parts,
                     const float* __restrict__ gamma, const float* __restrict__ beta,
                     const T* __restrict__ emb, T* __restrict__ y, float* __restrict__ mean_out,
                     float* __restrict__ rstd_out, int C, int cpg, long long HW, long long piece,
                     int pieces, float eps, int silu, int vec) {
  __shared__ Moments red[kWarps];
  const long long idx = blockIdx.x, nc = idx / pieces, n = nc / C;
  const int j = static_cast<int>(idx % pieces), c = static_cast<int>(nc % C);
  const int c0 = c - c % cpg;
  const Moments t = group_moments(parts, (n * C + c0) * pieces, cpg * pieces, pieces, HW, piece,
                                  red);
  const float rstd = rsqrtf(t.m2 / (static_cast<float>(cpg) * static_cast<float>(HW)) + eps);
  if (c == c0 && j == 0 && threadIdx.x == 0) {
    mean_out[n * (C / cpg) + c / cpg] = t.mean;
    rstd_out[n * (C / cpg) + c / cpg] = rstd;
  }
  const float2 cf = channel_coef(rstd, gamma, beta, emb, n, C, c);
  const float mean = t.mean;
  const long long lo = nc * HW + j * piece;
  map<T>(x, nullptr, y, lo, lo + piece_len(HW, piece, j), vec,
         [&](long long, float v, float) { return act(fmaf(v - mean, cf.x, cf.y), silu); });
}

// Backward, pass 1: each piece's (P, Q).
template <typename T>
__global__ void __launch_bounds__(kThreads)
group_norm_piece_grads(const T* __restrict__ x, const T* __restrict__ g,
                       const float* __restrict__ mean_in, const float* __restrict__ rstd_in,
                       const float* __restrict__ gamma, const float* __restrict__ beta,
                       const T* __restrict__ emb, float2* __restrict__ parts, int C, int cpg,
                       long long HW, long long piece, int pieces, int silu, int vec) {
  __shared__ float red[kWarps];
  const long long idx = blockIdx.x, nc = idx / pieces, n = nc / C;
  const int j = static_cast<int>(idx % pieces), c = static_cast<int>(nc % C);
  const long long slab = n * (C / cpg) + c / cpg;
  const float mean = mean_in[slab], rstd = rstd_in[slab];
  const float2 cf = channel_coef(1.f, gamma, beta, emb, n, C, c);
  const long long lo = nc * HW + j * piece;
  float P = 0.f, Q = 0.f;
  each<T>(x, g, lo, lo + piece_len(HW, piece, j), threadIdx.x, kThreads, vec,
          [&](long long, float xv, float gv) {
            const float xh = (xv - mean) * rstd;
            const float du = gv * act_grad(fmaf(xh, cf.x, cf.y), silu);
            P += du;
            Q = fmaf(du, xh, Q);
          });
  P = block_sum(P, red);
  Q = block_sum(Q, red);
  if (threadIdx.x == 0) parts[idx] = make_float2(P, Q);
}

// Backward, pass 2: the group's s1, s2 from its pieces, then dx.
template <typename T>
__global__ void __launch_bounds__(kThreads)
group_norm_act_bwd_apply(const T* __restrict__ x, const T* __restrict__ g,
                         const float* __restrict__ mean_in, const float* __restrict__ rstd_in,
                         const float* __restrict__ gamma, const float* __restrict__ beta,
                         const T* __restrict__ emb, const float2* __restrict__ parts,
                         T* __restrict__ dx, int C, int cpg, long long HW, long long piece,
                         int pieces, int silu, int vec) {
  __shared__ float red[kWarps];
  const long long idx = blockIdx.x, nc = idx / pieces, n = nc / C;
  const int j = static_cast<int>(idx % pieces), c = static_cast<int>(nc % C);
  const int c0 = c - c % cpg;
  const long long slab = n * (C / cpg) + c / cpg;
  float s1 = 0.f, s2 = 0.f;
  for (int e = threadIdx.x; e < cpg * pieces; e += kThreads) {
    const float a = channel_coef(1.f, gamma, beta, emb, n, C, c0 + e / pieces).x;
    const float2 p = parts[(n * C + c0) * pieces + e];
    s1 += a * p.x;
    s2 += a * p.y;
  }
  s1 = block_sum(s1, red);
  s2 = block_sum(s2, red);
  const float mean = mean_in[slab], rstd = rstd_in[slab];
  const float m = static_cast<float>(cpg) * static_cast<float>(HW);
  const float d0 = -rstd * s1 / m, d1 = -rstd * s2 / m;  // dx = rstd·a·du + d1·x̂ + d0
  const float2 cf = channel_coef(1.f, gamma, beta, emb, n, C, c);
  const float ar = rstd * cf.x;
  const long long lo = nc * HW + j * piece;
  map<T>(x, g, dx, lo, lo + piece_len(HW, piece, j), vec, [&](long long, float xv, float gv) {
    const float xh = (xv - mean) * rstd;
    const float du = gv * act_grad(fmaf(xh, cf.x, cf.y), silu);
    return fmaf(ar, du, fmaf(d1, xh, d0));
  });
}

// Launch a staged kernel over `grid` CTAs, as clusters of k when k > 1, with
// `smem` bytes of dynamic shared memory.
template <typename... Params, typename... Args>
cudaError_t launch_staged(void (*kernel)(Params...), long long grid, int k, size_t smem,
                          cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err == cudaSuccess && k > kPortable)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(grid));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = k;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = k > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T>
int fwd_launch(const void* x, const void* gamma, const void* beta, const void* emb, void* y,
               void* mean, void* rstd, void* parts, int N, int C, int cpg, long long HW,
               float eps, int silu, int k, long long slice, long long chunk, int pieces, int vec,
               void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T *xp = static_cast<const T*>(x), *ep = static_cast<const T*>(emb);
  const float *gp = static_cast<const float*>(gamma), *bp = static_cast<const float*>(beta);
  T* yp = static_cast<T*>(y);
  float *mp = static_cast<float*>(mean), *rp = static_cast<float*>(rstd);
  if (k == 0) {  // split: `slice` is the piece
    const unsigned grid = static_cast<unsigned>(static_cast<long long>(N) * C * pieces);
    float2* pp = static_cast<float2*>(parts);
    group_norm_piece_stats<T><<<grid, kThreads, 0, st>>>(xp, pp, HW, slice, pieces, vec);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    group_norm_act_apply<T><<<grid, kThreads, 0, st>>>(xp, pp, gp, bp, ep, yp, mp, rp, C, cpg,
                                                        HW, slice, pieces, eps, silu, vec);
    return static_cast<int>(cudaGetLastError());
  }
  const long long grid = static_cast<long long>(N) * (C / cpg) * k;
  return static_cast<int>(launch_staged(group_norm_act_fwd<T>, grid, k,
                                        static_cast<size_t>(slice) * sizeof(T), st, xp, gp, bp,
                                        ep, yp, mp, rp, C, cpg, HW, k, slice, chunk, eps, silu));
}

template <typename T>
int bwd_launch(const void* x, const void* g, const void* mean, const void* rstd,
               const void* gamma, const void* beta, const void* emb, void* dx, void* parts,
               void* dgamma, void* dbeta, void* demb, int N, int C, int cpg, long long HW,
               int silu, int k, long long slice, long long chunk, int pieces, int vec,
               void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T *xp = static_cast<const T*>(x), *gp = static_cast<const T*>(g);
  const T* ep = static_cast<const T*>(emb);
  const float *mp = static_cast<const float*>(mean), *rp = static_cast<const float*>(rstd);
  const float *wp = static_cast<const float*>(gamma), *bp = static_cast<const float*>(beta);
  T* dp = static_cast<T*>(dx);
  float2* pp = static_cast<float2*>(parts);
  cudaError_t err;
  if (k == 0) {
    const unsigned grid = static_cast<unsigned>(static_cast<long long>(N) * C * pieces);
    group_norm_piece_grads<T><<<grid, kThreads, 0, st>>>(xp, gp, mp, rp, wp, bp, ep, pp, C, cpg,
                                                          HW, slice, pieces, silu, vec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    group_norm_act_bwd_apply<T><<<grid, kThreads, 0, st>>>(xp, gp, mp, rp, wp, bp, ep, pp, dp, C,
                                                            cpg, HW, slice, pieces, silu, vec);
    err = cudaGetLastError();
  } else {
    const long long grid = static_cast<long long>(N) * (C / cpg) * k;
    const size_t smem = 2 * static_cast<size_t>(slice) * sizeof(T)  // x and g
                        + static_cast<size_t>(slice) * sizeof(T) / 16 * sizeof(float2);
    err = launch_staged(group_norm_act_bwd<T>, grid, k, smem, st, xp, gp, mp, rp, wp, bp, ep, dp,
                        pp, C, cpg, HW, k, slice, chunk, pieces, silu);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  group_norm_bwd_channels<T><<<(C + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      pp, wp, bp, ep, static_cast<T*>(demb), static_cast<float*>(dgamma),
      static_cast<float*>(dbeta), N, C, pieces);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The forward.  x, y: (N, C, ...) contiguous, HW values a channel; gamma,
// beta: (C,) float32; emb: (N, 2C) in x's dtype, or null (no scale-shift);
// mean, rstd: (N·G,) float32 outputs, G = C / cpg; parts: (N·C·pieces, 2)
// float32 scratch of the split path.  The plan
// (ops/group_norm.py::group_norm_plan): k == 0 takes the split path with
// pieces of `slice` values (vec: 16-byte accesses); k >= 1 the staged kernel,
// k CTAs a slab (a cluster when k > 1), `slice` values a CTA, bulk copies of
// `chunk` values.
int cat_group_norm_fwd_bf16(const void* x, const void* gamma, const void* beta, const void* emb,
                            void* y, void* mean, void* rstd, void* parts, int N, int C, int cpg,
                            long long HW, float eps, int silu, int k, long long slice,
                            long long chunk, int pieces, int vec, void* stream) {
  return fwd_launch<__nv_bfloat16>(x, gamma, beta, emb, y, mean, rstd, parts, N, C, cpg, HW, eps,
                                   silu, k, slice, chunk, pieces, vec, stream);
}

int cat_group_norm_fwd_f32(const void* x, const void* gamma, const void* beta, const void* emb,
                           void* y, void* mean, void* rstd, void* parts, int N, int C, int cpg,
                           long long HW, float eps, int silu, int k, long long slice,
                           long long chunk, int pieces, int vec, void* stream) {
  return fwd_launch<float>(x, gamma, beta, emb, y, mean, rstd, parts, N, C, cpg, HW, eps, silu,
                           k, slice, chunk, pieces, vec, stream);
}

// The backward.  x, g, dx: (N, C, ...) contiguous in one dtype; mean, rstd:
// the forward's; dgamma, dbeta: (C,) float32 outputs; demb: (N, 2C) in x's
// dtype, or null with emb; parts: (N·C·pieces, 2) float32 scratch (each
// channel piece's P and Q).  The plan as above, for x and g together.
int cat_group_norm_bwd_bf16(const void* x, const void* g, const void* mean, const void* rstd,
                            const void* gamma, const void* beta, const void* emb, void* dx,
                            void* parts, void* dgamma, void* dbeta, void* demb, int N, int C,
                            int cpg, long long HW, int silu, int k, long long slice,
                            long long chunk, int pieces, int vec, void* stream) {
  return bwd_launch<__nv_bfloat16>(x, g, mean, rstd, gamma, beta, emb, dx, parts, dgamma, dbeta,
                                   demb, N, C, cpg, HW, silu, k, slice, chunk, pieces, vec,
                                   stream);
}

int cat_group_norm_bwd_f32(const void* x, const void* g, const void* mean, const void* rstd,
                           const void* gamma, const void* beta, const void* emb, void* dx,
                           void* parts, void* dgamma, void* dbeta, void* demb, int N, int C,
                           int cpg, long long HW, int silu, int k, long long slice,
                           long long chunk, int pieces, int vec, void* stream) {
  return bwd_launch<float>(x, g, mean, rstd, gamma, beta, emb, dx, parts, dgamma, dbeta, demb, N,
                           C, cpg, HW, silu, k, slice, chunk, pieces, vec, stream);
}

}  // extern "C"
