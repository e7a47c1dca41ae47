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
//
// NHWC (group_norm_nhwc_*): the same function over x stored channels
// innermost (a channels_last (N, C, H, W) tensor, or (N, C, T) stored as
// (N, T, C)), so that ADM's UNet runs channels-last end to end and cuDNN's
// NHWC convolutions need no transposes.  Sample n is an (H·W, C) matrix; a
// group is C/G neighbouring columns at every pixel, C values apart, not one
// slab.  The design:
//   - the unit of work is a sample and a run of whole groups: all C
//     channels where they are at most 256 16-byte vectors (every ADM site in
//     bf16), so a CTA's pixels are one contiguous run of memory, read and
//     written in whole lines, and a group of 4 channels (8 bytes) costs no
//     more than one of 64.  (Units of 16-128 bytes a pixel, tried first,
//     read each DRAM page partly and were 10-40% slower at 128² and 256².)
//   - thread t of 256 keeps one vector column j = t mod (C/V) and walks
//     pixels t / (C/V), + 256/(C/V), ...: its channels, so its γ, β,
//     scale-shift, mean and rstd, stay in registers for the whole pass;
//     each walk loads its next chunk of pixels while it computes the last;
//   - "cta"/"cluster" (group_norm_nhwc_fwd, group_norm_nhwc_bwd): a sample
//     of at most 8 CTAs' 64 KiB (a CTA a 16 KiB of x forward, 32 KiB
//     backward, as measured) is staged once by 1-D bulk copies on up to four
//     mbarriers, a CTA a contiguous run of pixels; forward, each CTA centres
//     its groups exactly over its pixels (Σx, then Σ(x - mean)², from shared
//     memory) and the cluster's CTAs, of equal counts, merge their (mean, M2)
//     in rank order through distributed shared memory (their loads all in
//     flight at once); backward, their shares of s1, s2 likewise;
//   - "split": a larger sample is cut into k runs of pixels, one CTA each,
//     about one wave of resident CTAs: a stats pass (group_norm_nhwc_stats:
//     each thread's channels centred chunk by chunk, U pixels a chunk,
//     merged by Chan's formula; then the CTA's threads a group in a fixed
//     order, one warp a group) and an apply pass (group_norm_nhwc_apply:
//     the k runs merged in order, then x read again and written); backward
//     group_norm_nhwc_grads ((P, Q) a channel and run) and
//     group_norm_nhwc_bwd_apply.  A sample of 8 MiB or more does not stay
//     in L2 between the passes, so the forward moves 1.5x and the backward
//     5/3x the bytes bound, at 2.3-2.5 TB/s.
// Both backward paths write the (P, Q) of each channel and run to the same
// (N, C, k) buffer the NCHW kernels use, so group_norm_bwd_channels sums
// dγ, dβ and the scale-shift's gradient in order: no atomics anywhere.
// NHWC limits (checked by the wrapper): C·itemsize a multiple of 16 bytes,
// every pointer 16-byte aligned, a group at most 256 vectors, N·H·W < 2^31.

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
                          int threads, cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err == cudaSuccess && k > kPortable)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(grid));
  cfg.blockDim = dim3(threads);
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
                                        static_cast<size_t>(slice) * sizeof(T), kThreads, st, xp,
                                        gp, bp, ep, yp, mp, rp, C, cpg, HW, k, slice, chunk, eps,
                                        silu));
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
    err = launch_staged(group_norm_act_bwd<T>, grid, k, smem, kThreads, st, xp, gp, mp, rp, wp, bp,
                        ep, dp, pp, C, cpg, HW, k, slice, chunk, pieces, silu);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  group_norm_bwd_channels<T><<<(C + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      pp, wp, bp, ep, static_cast<T*>(demb), static_cast<float*>(dgamma),
      static_cast<float*>(dbeta), N, C, pieces);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// NHWC: a unit is sample n and channels [c0, c0 + wc), a CTA a run of its
// pixels; thread t keeps vector column j of the unit (see the file's notes)
// ---------------------------------------------------------------------------

constexpr int kNhwcThreads = 256;
constexpr int kNhwcWarps = kNhwcThreads / 32;
constexpr int kMaxGroups = 256;   // groups of a unit
constexpr int kMaxCluster = 8;    // CTAs of a staged unit (ops/group_norm.py plans at most 8)
constexpr int kNhwcChunks = 4;    // bulk copies of a staged CTA's pixels, one mbarrier each
constexpr int kMaxUnitVecs = 256; // 16-byte vectors of a unit's pixel: one a thread
constexpr int kMaxParts = 2048;   // a split unit's groups times its runs

// The CTA's share: sample n, the unit's first channel c0, its rank among the
// unit's k CTAs, and the pixels [r0, r0 + rows) of the sample it takes.
struct Unit {
  long long n;
  int c0, rank, r0, rows;
};

__device__ __forceinline__ Unit unit_of(int C, int wc, int k, int HW, int rows) {
  const long long unit = blockIdx.x / k;
  const int nb = C / wc;
  Unit u;
  u.n = unit / nb;
  u.c0 = static_cast<int>(unit % nb) * wc;
  u.rank = static_cast<int>(blockIdx.x % k);
  u.r0 = u.rank * rows;
  u.rows = min(rows, HW - u.r0);
  return u;
}

// Thread t's vector column j, its first pixel r and the pixels nr apart it
// walks; `on` is false for the last 256 mod (wc/V) threads.
struct Lane {
  int j, r, nr;
  bool on;
};

__device__ __forceinline__ Lane lane_of(int wc, int V) {
  const int vr = wc / V;
  Lane l;
  l.j = threadIdx.x % vr;
  l.r = threadIdx.x / vr;
  l.nr = kNhwcThreads / vr;
  l.on = l.r < l.nr;
  return l;
}

// The raw coefficients of the thread's V channels from c0 on: γ, β, and
// the timestep's scale and shift (with emb); coefs() forms channel_coef's
// (a, b) from them.  The staged kernels load them while their copies fly.
template <int V>
struct RawCoefs {
  float g[V], b[V], s[V], t[V];
};

template <int V, typename T>
__device__ __forceinline__ void load_coefs(RawCoefs<V>& w, const float* gamma, const float* beta,
                                           const T* emb, long long n, int C, int c0) {
#pragma unroll
  for (int q = 0; q < V; ++q) {
    w.g[q] = gamma[c0 + q];
    w.b[q] = beta[c0 + q];
    if (emb != nullptr) {
      w.s[q] = to_f(emb[n * 2 * C + c0 + q]);
      w.t[q] = to_f(emb[n * 2 * C + C + c0 + q]);
    }
  }
}

template <int V>
__device__ __forceinline__ float2 coefs(const RawCoefs<V>& w, int q, float r, bool has_emb) {
  float a = r * w.g[q], b = w.b[q];
  if (has_emb) {
    const float sc = 1.f + w.s[q];
    a *= sc;
    b = b * sc + w.t[q];
  }
  return make_float2(a, b);
}

// 16 bytes at p, raw; and as V floats (bf16 two at a time).
__device__ __forceinline__ uint4 ld16(const void* p) { return *reinterpret_cast<const uint4*>(p); }

template <typename T>
__device__ __forceinline__ void unpack(const uint4& r, float (&v)[16 / sizeof(T)]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
  if (sizeof(T) == 4) {
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = __uint_as_float(w[k]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[2 * k] = __uint_as_float(w[k] << 16);
      v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
}

// The raw 16 bytes of the thread's pixels base, base + nr, ... (U of them,
// those below `rows`) of each of the n arrays p[] (pixels `stride` values
// apart): the walkers below load a chunk's while they compute the last.
template <typename T, int U, int kN>
__device__ __forceinline__ void load_chunk(const T* const (&p)[kN], long long stride, int base,
                                           int rows, int nr, uint4 (&raw)[kN][U]) {
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (base + u * nr < rows)
#pragma unroll
      for (int i = 0; i < kN; ++i) raw[i][u] = ld16(p[i] + (base + u * nr) * stride);
}

// Moments of each of the thread's V channels over its pixels r, r + nr, ...
// below `rows` (p: its column at pixel 0, pixels `stride` values apart), U
// pixels a chunk: the chunk's mean and centred M2, merged by Chan's formula.
// Returns the thread's count of pixels.
template <typename T, int U>
__device__ __forceinline__ float thread_moments(const T* p, long long stride, int r, int rows,
                                                int nr, float (&mean)[16 / sizeof(T)],
                                                float (&m2)[16 / sizeof(T)]) {
  constexpr int V = 16 / sizeof(T);
  const T* const src[1] = {p};
  float cnt = 0.f;
#pragma unroll
  for (int q = 0; q < V; ++q) mean[q] = m2[q] = 0.f;
  uint4 next[1][U];
  load_chunk<T, U, 1>(src, stride, r, rows, nr, next);
  for (int base = r; base < rows; base += U * nr) {
    uint4 cur[U];
#pragma unroll
    for (int u = 0; u < U; ++u) cur[u] = next[0][u];
    load_chunk<T, U, 1>(src, stride, base + U * nr, rows, nr, next);  // in flight meanwhile
    float v[U][V];
    int nv = 0;
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (base + u * nr < rows) {
        unpack<T>(cur[u], v[u]);
        ++nv;
      }
    const float inv = 1.f / static_cast<float>(nv);
    const float w = static_cast<float>(nv) / (cnt + static_cast<float>(nv));
#pragma unroll
    for (int q = 0; q < V; ++q) {
      float s = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (u < nv) s += v[u][q];
      const float cm = s * inv;
      float c2 = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (u < nv) {
          const float d = v[u][q] - cm;
          c2 = fmaf(d, d, c2);
        }
      const float d = cm - mean[q];
      mean[q] = fmaf(d, w, mean[q]);
      m2[q] += c2 + d * d * cnt * w;
    }
    cnt += static_cast<float>(nv);
  }
  return cnt;
}

// Moments of lane 0's and its peers' values, merged down a shuffle tree in a
// fixed order; lane 0 holds the warp's.
__device__ __forceinline__ Moments warp_merge(Moments m) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const Moments other = {__shfl_down_sync(0xffffffffu, m.n, o),
                           __shfl_down_sync(0xffffffffu, m.mean, o),
                           __shfl_down_sync(0xffffffffu, m.m2, o)};
    if (lane + o < 32) m = merge(m, other);
  }
  return m;
}

// The CTA's moments of each group of the unit, out[gl] (gl < wc/cpg), from
// its threads' per-channel ones: entries ent[r·wc + channel] for thread rows
// r < nr, cnts[r] values each; one warp a group merges its (row, channel)
// entries lane by lane in order, then down the shuffle tree.
template <int V>
__device__ void cta_group_moments(float2* ent, float* cnts, const Lane& l, int wc, int cpg,
                                  float cnt, const float (&mean)[V], const float (&m2)[V],
                                  Moments* out) {
  if (l.on) {
#pragma unroll
    for (int q = 0; q < V; ++q) ent[l.r * wc + l.j * V + q] = make_float2(mean[q], m2[q]);
    if (l.j == 0) cnts[l.r] = cnt;
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, ng = wc / cpg, ne = l.nr * cpg;
  const Div dv = make_div(static_cast<uint32_t>(cpg));
  for (int gl = warp; gl < ng; gl += kNhwcWarps) {
    Moments m = {0.f, 0.f, 0.f};
    for (int e = lane; e < ne; e += 32) {
      const int r = static_cast<int>(divide(static_cast<uint32_t>(e), dv));
      const float2 p = ent[r * wc + gl * cpg + (e - r * cpg)];
      m = merge(m, {cnts[r], p.x, p.y});
    }
    m = warp_merge(m);
    if (lane == 0) out[gl] = m;
  }
  __syncthreads();
}

// Σ x (kSq false) or Σ (x - m)² (kSq true) of each of the thread's channels
// over its pixels r, r + nr, ... below `rows`, U a chunk; with `bars`, the
// pixels' bulk copies (`chunk` pixels each) are waited for as they are
// reached (`waited` counts the chunks already waited for).
template <typename T, int U, bool kSq>
__device__ __forceinline__ void thread_sums(const T* p, long long stride, int r, int rows, int nr,
                                            const float (&m)[16 / sizeof(T)],
                                            float (&s)[16 / sizeof(T)], const uint64_t* bars,
                                            int chunk, int& waited) {
  constexpr int V = 16 / sizeof(T);
#pragma unroll
  for (int q = 0; q < V; ++q) s[q] = 0.f;
  for (int base = r; base < rows; base += U * nr) {
    if (bars != nullptr)
      for (const int need = min(base + (U - 1) * nr, rows - 1) / chunk; waited <= need; ++waited)
        mbar_wait(smem_u32(&bars[waited]), 0);
    float v[U][V];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (base + u * nr < rows) load16(p + (base + u * nr) * stride, v[u]);
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (base + u * nr < rows)
#pragma unroll
        for (int q = 0; q < V; ++q) {
          if (kSq) {
            const float d = v[u][q] - m[q];
            s[q] = fmaf(d, d, s[q]);
          } else {
            s[q] += v[u][q];
          }
        }
  }
}

// Σ of the threads' per-channel values over each group of the unit, out[gl]:
// the values through ent[r·wc + channel], one warp a group summing its
// (row, channel) entries lane by lane, then down a xor tree.
template <int V>
__device__ void cta_group_sums(float* ent, const Lane& l, int wc, int cpg, const float (&v)[V],
                               float* out) {
  if (l.on)
#pragma unroll
    for (int q = 0; q < V; ++q) ent[l.r * wc + l.j * V + q] = v[q];
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, ng = wc / cpg, ne = l.nr * cpg;
  const Div dv = make_div(static_cast<uint32_t>(cpg));
  for (int gl = warp; gl < ng; gl += kNhwcWarps) {
    float s = 0.f;
    for (int e = lane; e < ne; e += 32) {
      const int r = static_cast<int>(divide(static_cast<uint32_t>(e), dv));
      s += ent[r * wc + gl * cpg + (e - r * cpg)];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) out[gl] = s;
  }
  __syncthreads();
}

// The thread's per-channel (mean, a, b) of u = (x - mean)·a + b (rstd in a
// when `fold`), from the unit's (mean, rstd) a group.
template <int V, typename T>
__device__ __forceinline__ void thread_coefs(const float2* stat, const float* gamma,
                                             const float* beta, const T* emb, const Unit& u,
                                             const Lane& l, int C, int cpg, bool fold,
                                             float (&mu)[V], float (&rs)[V], float (&a)[V],
                                             float (&b)[V]) {
  RawCoefs<V> w;
  load_coefs<V>(w, gamma, beta, emb, u.n, C, u.c0 + l.j * V);
#pragma unroll
  for (int q = 0; q < V; ++q) {
    const float2 st = stat[(l.j * V + q) / cpg];
    const float2 cf = coefs<V>(w, q, fold ? st.y : 1.f, emb != nullptr);
    mu[q] = st.x;
    rs[q] = st.y;
    a[q] = cf.x;
    b[q] = cf.y;
  }
}

// out = act((x - μ)·a + b) for the thread's pixels, U a chunk, from src
// (pixels sstride values apart) to dst (dstride apart).
template <typename T, int U>
__device__ __forceinline__ void apply_rows(const T* src, long long sstride, T* dst,
                                           long long dstride, int r, int rows, int nr,
                                           const float (&mu)[16 / sizeof(T)],
                                           const float (&a)[16 / sizeof(T)],
                                           const float (&b)[16 / sizeof(T)], int silu) {
  constexpr int V = 16 / sizeof(T);
  const T* const in[1] = {src};
  uint4 next[1][U];
  load_chunk<T, U, 1>(in, sstride, r, rows, nr, next);
  for (int base = r; base < rows; base += U * nr) {
    uint4 cur[U];
#pragma unroll
    for (int u = 0; u < U; ++u) cur[u] = next[0][u];
    load_chunk<T, U, 1>(in, sstride, base + U * nr, rows, nr, next);  // in flight meanwhile
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int row = base + u * nr;
      if (row < rows) {
        float v[V];
        unpack<T>(cur[u], v);
#pragma unroll
        for (int q = 0; q < V; ++q) v[q] = act(fmaf(v[q] - mu[q], a[q], b[q]), silu);
        store16(dst + row * dstride, v);
      }
    }
  }
}

// P = Σ du and Q = Σ du·x̂ of each of the thread's channels over its pixels
// (du = g·act'(x̂·a + b), x̂ = (x - μ)·rstd), U a chunk; with `bars`, the
// pixels' bulk copies (`chunk` pixels each) are waited for as they are
// reached (`waited` counts the chunks already waited for).
template <typename T, int U>
__device__ __forceinline__ void thread_grads(const T* xp, const T* gp, long long stride, int r,
                                             int rows, int nr, const float (&mu)[16 / sizeof(T)],
                                             const float (&rs)[16 / sizeof(T)],
                                             const float (&a)[16 / sizeof(T)],
                                             const float (&b)[16 / sizeof(T)], int silu,
                                             float (&P)[16 / sizeof(T)],
                                             float (&Q)[16 / sizeof(T)], const uint64_t* bars,
                                             int chunk, int& waited) {
  constexpr int V = 16 / sizeof(T);
  const T* const in[2] = {xp, gp};
  // the copies holding pixels up to `base`'s chunk's last have landed
  auto land = [&](int base) {
    if (bars != nullptr && base < rows)
      for (const int need = min(base + (U - 1) * nr, rows - 1) / chunk; waited <= need; ++waited)
        mbar_wait(smem_u32(&bars[waited]), 0);
  };
#pragma unroll
  for (int q = 0; q < V; ++q) P[q] = Q[q] = 0.f;
  uint4 next[2][U];
  land(r);
  load_chunk<T, U, 2>(in, stride, r, rows, nr, next);
  for (int base = r; base < rows; base += U * nr) {
    uint4 cur[2][U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      cur[0][u] = next[0][u];
      cur[1][u] = next[1][u];
    }
    land(base + U * nr);
    load_chunk<T, U, 2>(in, stride, base + U * nr, rows, nr, next);  // in flight meanwhile
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (base + u * nr < rows) {
        float xv[V], gv[V];
        unpack<T>(cur[0][u], xv);
        unpack<T>(cur[1][u], gv);
#pragma unroll
        for (int q = 0; q < V; ++q) {
          const float xh = (xv[q] - mu[q]) * rs[q];
          const float du = gv[q] * act_grad(fmaf(xh, a[q], b[q]), silu);
          P[q] += du;
          Q[q] = fmaf(du, xh, Q[q]);
        }
      }
  }
}

// dx = rstd·a·du + d1·x̂ + d0 for the thread's pixels, U a chunk (x and g
// from xp, gp `sstride` apart; dx to dst `dstride` apart).
template <typename T, int U>
__device__ __forceinline__ void dx_rows(const T* xp, const T* gp, long long sstride, T* dst,
                                        long long dstride, int r, int rows, int nr,
                                        const float (&mu)[16 / sizeof(T)],
                                        const float (&rs)[16 / sizeof(T)],
                                        const float (&a)[16 / sizeof(T)],
                                        const float (&b)[16 / sizeof(T)],
                                        const float (&d0)[16 / sizeof(T)],
                                        const float (&d1)[16 / sizeof(T)], int silu) {
  constexpr int V = 16 / sizeof(T);
  const T* const in[2] = {xp, gp};
  uint4 next[2][U];
  load_chunk<T, U, 2>(in, sstride, r, rows, nr, next);
  for (int base = r; base < rows; base += U * nr) {
    uint4 cur[2][U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      cur[0][u] = next[0][u];
      cur[1][u] = next[1][u];
    }
    load_chunk<T, U, 2>(in, sstride, base + U * nr, rows, nr, next);  // in flight meanwhile
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int row = base + u * nr;
      if (row < rows) {
        float xv[V], gv[V];
        unpack<T>(cur[0][u], xv);
        unpack<T>(cur[1][u], gv);
#pragma unroll
        for (int q = 0; q < V; ++q) {
          const float xh = (xv[q] - mu[q]) * rs[q];
          const float du = gv[q] * act_grad(fmaf(xh, a[q], b[q]), silu);
          xv[q] = fmaf(rs[q] * a[q], du, fmaf(d1[q], xh, d0[q]));
        }
        store16(dst + row * dstride, xv);
      }
    }
  }
}

// The (P, Q) of each of the unit's channels over the CTA's pixels, from the
// threads' own (summed over thread rows in order), to parts[(n·C + c)·k +
// rank] and, given, chan[].
template <int V>
__device__ void cta_channel_sums(float2* ent, float2* chan, float2* __restrict__ parts,
                                 const Unit& u, const Lane& l, int C, int wc, int k,
                                 const float (&P)[V], const float (&Q)[V]) {
  if (l.on)
#pragma unroll
    for (int q = 0; q < V; ++q) ent[l.r * wc + l.j * V + q] = make_float2(P[q], Q[q]);
  __syncthreads();
  for (int cu = threadIdx.x; cu < wc; cu += kNhwcThreads) {
    float2 s = make_float2(0.f, 0.f);
    for (int r = 0; r < l.nr; ++r) {
      s.x += ent[r * wc + cu].x;
      s.y += ent[r * wc + cu].y;
    }
    if (chan != nullptr) chan[cu] = s;
    parts[(u.n * C + u.c0 + cu) * k + u.rank] = s;
  }
  __syncthreads();
}

// The first 128-byte boundary at or after p (the launch adds 128 bytes).
__device__ __forceinline__ unsigned char* align128(unsigned char* p) {
  return p + ((128 - (smem_u32(p) & 127)) & 127);
}

// Thread 0: init the chunks' mbarriers and issue, for each of kArrays
// tensors, the bulk copies of the CTA's `rows` pixels of a whole sample
// (wc = C, so contiguous), `chunk` pixels a copy, array i landing at smem +
// i·rows·C.  Returns the number of chunks.
template <typename T, int kArrays>
__device__ __forceinline__ int stage_rows(const T* const (&src)[kArrays], uint64_t* bars, T* smem,
                                          const Unit& u, int HW, int C, int rows, int chunk) {
  const int nch = (rows + chunk - 1) / chunk;
  if (threadIdx.x == 0) {
    for (int i = 0; i < nch; ++i) mbar_init(smem_u32(&bars[i]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < nch; ++i) {
      const int r = i * chunk;
      const uint32_t bytes = static_cast<uint32_t>(min(chunk, rows - r)) * C * sizeof(T);
      const uint32_t bar = smem_u32(&bars[i]);
      mbar_expect_tx(bar, kArrays * bytes);
#pragma unroll
      for (int a = 0; a < kArrays; ++a)
        bulk_load(smem_u32(smem + (static_cast<long long>(a) * rows + r) * C),
                  src[a] + (u.n * HW + u.r0 + r) * C, bytes, bar);
    }
  }
  __syncthreads();  // the barriers are initialised before anyone waits on them
  return nch;
}

// Forward, staged: the whole of sample n (wc = C) over a cluster of k CTAs
// (k may be 1), read once.  Each CTA's groups are centred exactly over its
// pixels (Σx, then Σ(x - mean)² over shared memory); the cluster's CTAs,
// of equal counts, merge their (mean, M2) in rank order.
template <typename T>
__global__ void __launch_bounds__(kNhwcThreads, 2)
group_norm_nhwc_fwd(const T* __restrict__ x, const float* __restrict__ gamma,
                    const float* __restrict__ beta, const T* __restrict__ emb,
                    T* __restrict__ y, float* __restrict__ mean_out,
                    float* __restrict__ rstd_out, int C, int cpg, int HW, int k, int rows,
                    int chunk, float eps, int silu) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(align128(smem_raw));
  __shared__ __align__(8) uint64_t bars[kNhwcChunks];
  __shared__ float ent[kNhwcThreads * V];
  __shared__ float gsum[2][kMaxGroups];  // the CTA's Σx, Σ(x - mean)² a group
  __shared__ float2 part[kMaxGroups];    // the CTA's (mean, M2) a group, read by its peers
  __shared__ float2 stat[kMaxGroups];    // the sample's (mean, rstd) a group
  const Unit u = unit_of(C, C, k, HW, rows);
  const Lane l = lane_of(C, V);
  const T* const srcs[1] = {x};
  const int nch = stage_rows<T, 1>(srcs, bars, xs, u, HW, C, rows, chunk);
  RawCoefs<V> w;
  load_coefs<V>(w, gamma, beta, emb, u.n, C, l.j * V);

  const int G = C / cpg;
  const float cnt = static_cast<float>(rows) * static_cast<float>(cpg);
  const float M = static_cast<float>(cpg) * static_cast<float>(HW);
  const T* xp = xs + l.j * V;
  float v[V], mu[V];
  int waited = 0;
  if (l.on) thread_sums<T, 4, false>(xp, C, l.r, rows, l.nr, mu, v, bars, chunk, waited);
  for (; waited < nch; ++waited) mbar_wait(smem_u32(&bars[waited]), 0);  // every copy landed
  cta_group_sums<V>(ent, l, C, cpg, v, gsum[0]);
#pragma unroll
  for (int q = 0; q < V; ++q) mu[q] = gsum[0][(l.j * V + q) / cpg] / cnt;
  if (l.on) thread_sums<T, 4, true>(xp, C, l.r, rows, l.nr, mu, v, nullptr, chunk, waited);
  cta_group_sums<V>(ent, l, C, cpg, v, gsum[1]);
  for (int g = threadIdx.x; g < G; g += kNhwcThreads)
    part[g] = make_float2(gsum[0][g] / cnt, gsum[1][g]);
  if (k > 1) {
    cluster_arrive();
    cluster_wait();  // every peer's moments are written
    cg::cluster_group cluster = cg::this_cluster();
    for (int g = threadIdx.x; g < G; g += kNhwcThreads) {
      float2 p[kMaxCluster];
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r)
        if (r < k) p[r] = *cluster.map_shared_rank(&part[g], r);  // all in flight at once
      float mean = 0.f, m2 = 0.f, dd = 0.f;
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r)
        if (r < k) mean += p[r].x;
      mean /= static_cast<float>(k);
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r)
        if (r < k) {
          const float d = p[r].x - mean;
          m2 += p[r].y;
          dd = fmaf(d, d, dd);
        }
      stat[g] = make_float2(mean, rsqrtf(fmaf(cnt, dd, m2) / M + eps));
    }
    cluster_arrive();  // done reading the peers; the matching wait is before exit
  } else {
    __syncthreads();  // part is written
    for (int g = threadIdx.x; g < G; g += kNhwcThreads)
      stat[g] = make_float2(part[g].x, rsqrtf(part[g].y / M + eps));
  }
  __syncthreads();
  if (u.rank == 0)
    for (int g = threadIdx.x; g < G; g += kNhwcThreads) {
      mean_out[u.n * G + g] = stat[g].x;
      rstd_out[u.n * G + g] = stat[g].y;
    }
  float a[V], bb[V];
#pragma unroll
  for (int q = 0; q < V; ++q) {
    const float2 st = stat[(l.j * V + q) / cpg];
    const float2 cf = coefs<V>(w, q, st.y, emb != nullptr);
    mu[q] = st.x;
    a[q] = cf.x;
    bb[q] = cf.y;
  }
  if (l.on)
    apply_rows<T, 4>(xp, C, y + (u.n * HW + u.r0) * C + l.j * V, C, l.r, rows, l.nr, mu, a, bb,
                     silu);
  if (k > 1) cluster_wait();  // the peers have read this CTA's moments
}

// Forward, split, pass 1: the (mean, M2) of each group of the unit over the
// CTA's pixels, to parts[(n·G + g)·k + rank].
template <typename T>
__global__ void __launch_bounds__(kNhwcThreads, 2)
group_norm_nhwc_stats(const T* __restrict__ x, float2* __restrict__ parts, int C, int cpg,
                      int HW, int wc, int k, int rows) {
  constexpr int V = 16 / sizeof(T);
  __shared__ float2 ent[kNhwcThreads * V];
  __shared__ float cnts[kNhwcThreads];
  __shared__ Moments part[kMaxGroups];
  const Unit u = unit_of(C, wc, k, HW, rows);
  const Lane l = lane_of(wc, V);
  float mean[V], m2[V];
  const T* xp = x + (u.n * HW + u.r0) * C + u.c0 + l.j * V;
  const float cnt = l.on ? thread_moments<T, 4>(xp, C, l.r, u.rows, l.nr, mean, m2) : 0.f;
  cta_group_moments<V>(ent, cnts, l, wc, cpg, cnt, mean, m2, part);
  const int ng = wc / cpg, G = C / cpg;
  for (int gl = threadIdx.x; gl < ng; gl += kNhwcThreads)
    parts[(u.n * G + u.c0 / cpg + gl) * k + u.rank] = make_float2(part[gl].mean, part[gl].m2);
}

// Forward, split, pass 2: each group's k parts merged in order, then the
// CTA's pixels read again and written.
template <typename T>
__global__ void __launch_bounds__(kNhwcThreads, 2)
group_norm_nhwc_apply(const T* __restrict__ x, const float2* __restrict__ parts,
                      const float* __restrict__ gamma, const float* __restrict__ beta,
                      const T* __restrict__ emb, T* __restrict__ y, float* __restrict__ mean_out,
                      float* __restrict__ rstd_out, int C, int cpg, int HW, int wc, int k, int rows,
                      float eps, int silu) {
  constexpr int V = 16 / sizeof(T);
  __shared__ float2 stat[kMaxGroups];
  __shared__ float2 got[kMaxParts];  // the unit's parts, loaded all at once
  const Unit u = unit_of(C, wc, k, HW, rows);
  const Lane l = lane_of(wc, V);
  const int ng = wc / cpg, G = C / cpg;
  const float M = static_cast<float>(cpg) * static_cast<float>(HW);
  const long long first = (u.n * G + u.c0 / cpg) * k;  // the unit's groups' parts are adjacent
  for (int i = threadIdx.x; i < ng * k; i += kNhwcThreads) got[i] = parts[first + i];
  __syncthreads();
  for (int gl = threadIdx.x; gl < ng; gl += kNhwcThreads) {
    const long long g = u.n * G + u.c0 / cpg + gl;
    Moments t = {0.f, 0.f, 0.f};
    for (int s = 0; s < k; ++s) {
      const float2 p = got[gl * k + s];
      t = merge(t, {static_cast<float>(min(rows, HW - s * rows) * cpg), p.x, p.y});
    }
    stat[gl] = make_float2(t.mean, rsqrtf(t.m2 / M + eps));
    if (u.rank == 0) {
      mean_out[g] = stat[gl].x;
      rstd_out[g] = stat[gl].y;
    }
  }
  __syncthreads();
  float mu[V], rs[V], a[V], b[V];
  thread_coefs<V>(stat, gamma, beta, emb, u, l, C, cpg, true, mu, rs, a, b);
  const long long off = (u.n * HW + u.r0) * C + u.c0 + l.j * V;
  if (l.on) apply_rows<T, 4>(x + off, C, y + off, C, l.r, u.rows, l.nr, mu, a, b, silu);
}

// Backward, staged: x and g of the whole of sample n (wc = C) over a
// cluster of k CTAs, read once.
template <typename T>
__global__ void __launch_bounds__(kNhwcThreads, 2)
group_norm_nhwc_bwd(const T* __restrict__ x, const T* __restrict__ g,
                    const float* __restrict__ mean_in, const float* __restrict__ rstd_in,
                    const float* __restrict__ gamma, const float* __restrict__ beta,
                    const T* __restrict__ emb, T* __restrict__ dx, float2* __restrict__ parts,
                    int C, int cpg, int HW, int k, int rows, int chunk, int silu) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(align128(smem_raw));
  const T* gs = xs + static_cast<long long>(rows) * C;
  float2* chan = reinterpret_cast<float2*>(xs + 2ll * rows * C);  // (P, Q) a channel
  float* ach = reinterpret_cast<float*>(chan + C);                // a = γ·(1 + scale) a channel
  __shared__ __align__(8) uint64_t bars[kNhwcChunks];
  __shared__ float2 ent[kNhwcThreads * V];
  __shared__ float2 part[kMaxGroups];  // this CTA's (Σ a·P, Σ a·Q) a group, read by its peers
  __shared__ float2 stat[kMaxGroups];  // the sample's (s1, s2) a group
  const Unit u = unit_of(C, C, k, HW, rows);
  const Lane l = lane_of(C, V);
  const int G = C / cpg;
  const T* const srcs[2] = {x, g};
  const int nch = stage_rows<T, 2>(srcs, bars, xs, u, HW, C, rows, chunk);
  RawCoefs<V> w;
  load_coefs<V>(w, gamma, beta, emb, u.n, C, l.j * V);
  float mu[V], rs[V], a[V], bb[V], P[V], Q[V];
#pragma unroll
  for (int q = 0; q < V; ++q) {
    const long long gi = u.n * G + (l.j * V + q) / cpg;
    mu[q] = mean_in[gi];
    rs[q] = rstd_in[gi];
    const float2 cf = coefs<V>(w, q, 1.f, emb != nullptr);
    a[q] = cf.x;
    bb[q] = cf.y;
  }
  if (l.on && l.r == 0)
#pragma unroll
    for (int q = 0; q < V; ++q) ach[l.j * V + q] = a[q];

  const T *xp = xs + l.j * V, *gp = gs + l.j * V;
  int waited = 0;
  if (l.on)
    thread_grads<T, 2>(xp, gp, C, l.r, rows, l.nr, mu, rs, a, bb, silu, P, Q, bars, chunk,
                       waited);
  for (; waited < nch; ++waited) mbar_wait(smem_u32(&bars[waited]), 0);  // every copy landed
  cta_channel_sums<V>(ent, chan, parts, u, l, C, C, k, P, Q);  // its barriers cover ach
  for (int gi = threadIdx.x; gi < G; gi += kNhwcThreads) {
    float s1 = 0.f, s2 = 0.f;
    for (int i = gi * cpg; i < (gi + 1) * cpg; ++i) {
      s1 += ach[i] * chan[i].x;
      s2 += ach[i] * chan[i].y;
    }
    part[gi] = make_float2(s1, s2);
  }
  if (k > 1) {
    cluster_arrive();
    cluster_wait();  // every peer's share is written
    cg::cluster_group cluster = cg::this_cluster();
    for (int gi = threadIdx.x; gi < G; gi += kNhwcThreads) {
      float2 p[kMaxCluster];
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r)
        if (r < k) p[r] = *cluster.map_shared_rank(&part[gi], r);  // all in flight at once
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r)
        if (r < k) {
          s1 += p[r].x;
          s2 += p[r].y;
        }
      stat[gi] = make_float2(s1, s2);
    }
    cluster_arrive();  // done reading the peers; the matching wait is before exit
  } else {
    __syncthreads();  // part is written
    for (int gi = threadIdx.x; gi < G; gi += kNhwcThreads) stat[gi] = part[gi];
  }
  __syncthreads();
  const float M = static_cast<float>(cpg) * static_cast<float>(HW);
  float d0[V], d1[V];
#pragma unroll
  for (int q = 0; q < V; ++q) {
    const float2 st = stat[(l.j * V + q) / cpg];
    d0[q] = -rs[q] * st.x / M;
    d1[q] = -rs[q] * st.y / M;
  }
  if (l.on)
    dx_rows<T, 2>(xp, gp, C, dx + (u.n * HW + u.r0) * C + l.j * V, C, l.r, rows, l.nr, mu, rs, a,
                  bb, d0, d1, silu);
  if (k > 1) cluster_wait();  // the peers have read this CTA's share
}

// Backward, split, pass 1: the (P, Q) of each channel of the unit over the
// CTA's pixels, to parts[(n·C + c)·k + rank].
template <typename T>
__global__ void __launch_bounds__(kNhwcThreads, 2)
group_norm_nhwc_grads(const T* __restrict__ x, const T* __restrict__ g,
                      const float* __restrict__ mean_in, const float* __restrict__ rstd_in,
                      const float* __restrict__ gamma, const float* __restrict__ beta,
                      const T* __restrict__ emb, float2* __restrict__ parts, int C, int cpg, int HW,
                      int wc, int k, int rows, int silu) {
  constexpr int V = 16 / sizeof(T);
  __shared__ float2 ent[kNhwcThreads * V];
  __shared__ float2 stat[kMaxGroups];
  const Unit u = unit_of(C, wc, k, HW, rows);
  const Lane l = lane_of(wc, V);
  const int ng = wc / cpg, G = C / cpg;
  for (int gl = threadIdx.x; gl < ng; gl += kNhwcThreads) {
    const long long gi = u.n * G + u.c0 / cpg + gl;
    stat[gl] = make_float2(mean_in[gi], rstd_in[gi]);
  }
  __syncthreads();
  float mu[V], rs[V], a[V], b[V], P[V], Q[V];
  thread_coefs<V>(stat, gamma, beta, emb, u, l, C, cpg, false, mu, rs, a, b);
  const long long off = (u.n * HW + u.r0) * C + u.c0 + l.j * V;
  int waited = 0;
  if (l.on)
    thread_grads<T, 2>(x + off, g + off, C, l.r, u.rows, l.nr, mu, rs, a, b, silu, P, Q, nullptr,
                       1, waited);
  cta_channel_sums<V>(ent, nullptr, parts, u, l, C, wc, k, P, Q);
}

// Backward, split, pass 2: each group's s1, s2 from its channels' k parts
// (in order), then dx over the CTA's pixels.
template <typename T>
__global__ void __launch_bounds__(kNhwcThreads, 2)
group_norm_nhwc_bwd_apply(const T* __restrict__ x, const T* __restrict__ g,
                          const float* __restrict__ mean_in, const float* __restrict__ rstd_in,
                          const float* __restrict__ gamma, const float* __restrict__ beta,
                          const T* __restrict__ emb, const float2* __restrict__ parts,
                          T* __restrict__ dx, int C, int cpg, int HW, int wc, int k, int rows,
                          int silu) {
  constexpr int V = 16 / sizeof(T);
  __shared__ float2 stat[kMaxGroups];  // (mean, rstd) a group
  __shared__ float2 sums[kMaxGroups];  // (s1, s2) a group
  __shared__ float2 apq[kMaxUnitVecs * V];  // (a·P, a·Q) a channel
  const Unit u = unit_of(C, wc, k, HW, rows);
  const Lane l = lane_of(wc, V);
  const int ng = wc / cpg, G = C / cpg;
  for (int cu = threadIdx.x; cu < wc; cu += kNhwcThreads) {  // a thread a channel, in parallel
    const int c = u.c0 + cu;
    float P = 0.f, Q = 0.f;
    for (int s = 0; s < k; ++s) {
      const float2 pq = parts[(u.n * C + c) * k + s];
      P += pq.x;
      Q += pq.y;
    }
    const float ac = channel_coef(1.f, gamma, beta, emb, u.n, C, c).x;
    apq[cu] = make_float2(ac * P, ac * Q);
  }
  __syncthreads();
  for (int gl = threadIdx.x; gl < ng; gl += kNhwcThreads) {
    const long long gi = u.n * G + u.c0 / cpg + gl;
    stat[gl] = make_float2(mean_in[gi], rstd_in[gi]);
    float s1 = 0.f, s2 = 0.f;
    for (int i = gl * cpg; i < (gl + 1) * cpg; ++i) {
      s1 += apq[i].x;
      s2 += apq[i].y;
    }
    sums[gl] = make_float2(s1, s2);
  }
  __syncthreads();
  float mu[V], rs[V], a[V], b[V], d0[V], d1[V];
  thread_coefs<V>(stat, gamma, beta, emb, u, l, C, cpg, false, mu, rs, a, b);
  const float M = static_cast<float>(cpg) * static_cast<float>(HW);
#pragma unroll
  for (int q = 0; q < V; ++q) {
    const float2 s = sums[(l.j * V + q) / cpg];
    d0[q] = -rs[q] * s.x / M;
    d1[q] = -rs[q] * s.y / M;
  }
  const long long off = (u.n * HW + u.r0) * C + u.c0 + l.j * V;
  if (l.on)
    dx_rows<T, 2>(x + off, g + off, C, dx + off, C, l.r, u.rows, l.nr, mu, rs, a, b, d0, d1,
                  silu);
}

// The NHWC forward on its plan: chunk > 0 staged (wc = C, a cluster when
// k > 1, k·rows = H·W); chunk == 0 the split path.
template <typename T>
int nhwc_fwd_launch(const void* x, const void* gamma, const void* beta, const void* emb, void* y,
                    void* mean, void* rstd, void* parts, int N, int C, int cpg, int HW, float eps,
                    int silu, int wc, int k, int rows, int chunk, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T *xp = static_cast<const T*>(x), *ep = static_cast<const T*>(emb);
  const float *gp = static_cast<const float*>(gamma), *bp = static_cast<const float*>(beta);
  T* yp = static_cast<T*>(y);
  float *mp = static_cast<float*>(mean), *rp = static_cast<float*>(rstd);
  const long long grid = static_cast<long long>(N) * (C / wc) * k;
  if (chunk == 0) {  // split
    float2* pp = static_cast<float2*>(parts);
    group_norm_nhwc_stats<T><<<static_cast<unsigned>(grid), kNhwcThreads, 0, st>>>(
        xp, pp, C, cpg, HW, wc, k, rows);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    group_norm_nhwc_apply<T><<<static_cast<unsigned>(grid), kNhwcThreads, 0, st>>>(
        xp, pp, gp, bp, ep, yp, mp, rp, C, cpg, HW, wc, k, rows, eps, silu);
    return static_cast<int>(cudaGetLastError());
  }
  if (k > kMaxCluster) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_staged(group_norm_nhwc_fwd<T>, grid, k,
                                        static_cast<size_t>(rows) * C * sizeof(T) + 128,
                                        kNhwcThreads, st, xp, gp, bp, ep, yp, mp, rp, C, cpg, HW,
                                        k, rows, chunk, eps, silu));
}

// The NHWC backward on its plan (as the forward's), then the channel sums.
template <typename T>
int nhwc_bwd_launch(const void* x, const void* g, const void* mean, const void* rstd,
                    const void* gamma, const void* beta, const void* emb, void* dx, void* parts,
                    void* dgamma, void* dbeta, void* demb, int N, int C, int cpg, int HW, int silu,
                    int wc, int k, int rows, int chunk, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T *xp = static_cast<const T*>(x), *gp = static_cast<const T*>(g);
  const T* ep = static_cast<const T*>(emb);
  const float *mp = static_cast<const float*>(mean), *rp = static_cast<const float*>(rstd);
  const float *wp = static_cast<const float*>(gamma), *bp = static_cast<const float*>(beta);
  T* dp = static_cast<T*>(dx);
  float2* pp = static_cast<float2*>(parts);
  const long long grid = static_cast<long long>(N) * (C / wc) * k;
  cudaError_t err;
  if (chunk == 0) {  // split
    group_norm_nhwc_grads<T><<<static_cast<unsigned>(grid), kNhwcThreads, 0, st>>>(
        xp, gp, mp, rp, wp, bp, ep, pp, C, cpg, HW, wc, k, rows, silu);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    group_norm_nhwc_bwd_apply<T><<<static_cast<unsigned>(grid), kNhwcThreads, 0, st>>>(
        xp, gp, mp, rp, wp, bp, ep, pp, dp, C, cpg, HW, wc, k, rows, silu);
    err = cudaGetLastError();
  } else if (k > kMaxCluster) {
    err = cudaErrorInvalidValue;
  } else {
    const size_t smem = 2 * static_cast<size_t>(rows) * C * sizeof(T)  // x and g
                        + static_cast<size_t>(C) * (sizeof(float2) + sizeof(float)) + 128;
    err = launch_staged(group_norm_nhwc_bwd<T>, grid, k, smem, kNhwcThreads, st, xp, gp, mp, rp,
                        wp, bp, ep, dp, pp, C, cpg, HW, k, rows, chunk, silu);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  group_norm_bwd_channels<T><<<(C + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      pp, wp, bp, ep, static_cast<T*>(demb), static_cast<float*>(dgamma),
      static_cast<float*>(dbeta), N, C, k);
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

// NHWC (x, g, dx, y channels innermost: (N, H·W, C) in memory).  The forward
// and backward as above, on the plan of ops/group_norm.py::
// group_norm_nhwc_plan: units of wc channels, k CTAs a unit of `rows`
// pixels each; chunk > 0: staged (wc = C) by bulk copies of `chunk` pixels
// (a cluster when k > 1, k·rows = H·W); chunk == 0: the split path, whose
// forward parts are (N·G·k, 2) float32 scratch.  The backward's parts:
// (N·C·k, 2).
int cat_group_norm_nhwc_fwd_bf16(const void* x, const void* gamma, const void* beta,
                                 const void* emb, void* y, void* mean, void* rstd, void* parts,
                                 int N, int C, int cpg, int HW, float eps, int silu, int wc, int k,
                                 int rows, int chunk, void* stream) {
  return nhwc_fwd_launch<__nv_bfloat16>(x, gamma, beta, emb, y, mean, rstd, parts, N, C, cpg, HW,
                                        eps, silu, wc, k, rows, chunk, stream);
}

int cat_group_norm_nhwc_fwd_f32(const void* x, const void* gamma, const void* beta,
                                const void* emb, void* y, void* mean, void* rstd, void* parts,
                                int N, int C, int cpg, int HW, float eps, int silu, int wc, int k,
                                int rows, int chunk, void* stream) {
  return nhwc_fwd_launch<float>(x, gamma, beta, emb, y, mean, rstd, parts, N, C, cpg, HW, eps,
                                silu, wc, k, rows, chunk, stream);
}

int cat_group_norm_nhwc_bwd_bf16(const void* x, const void* g, const void* mean,
                                 const void* rstd, const void* gamma, const void* beta,
                                 const void* emb, void* dx, void* parts, void* dgamma,
                                 void* dbeta, void* demb, int N, int C, int cpg, int HW, int silu,
                                 int wc, int k, int rows, int chunk, void* stream) {
  return nhwc_bwd_launch<__nv_bfloat16>(x, g, mean, rstd, gamma, beta, emb, dx, parts, dgamma,
                                        dbeta, demb, N, C, cpg, HW, silu, wc, k, rows, chunk,
                                        stream);
}

int cat_group_norm_nhwc_bwd_f32(const void* x, const void* g, const void* mean,
                                const void* rstd, const void* gamma, const void* beta,
                                const void* emb, void* dx, void* parts, void* dgamma,
                                void* dbeta, void* demb, int N, int C, int cpg, int HW, int silu,
                                int wc, int k, int rows, int chunk, void* stream) {
  return nhwc_bwd_launch<float>(x, g, mean, rstd, gamma, beta, emb, dx, parts, dgamma, dbeta,
                                demb, N, C, cpg, HW, silu, wc, k, rows, chunk, stream);
}

}  // extern "C"
