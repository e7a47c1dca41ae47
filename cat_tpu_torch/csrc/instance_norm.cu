// Fused instance norm + affine + activation over NCHW planes, and its
// backward:
//   for each (n, c): mean = E[x], var = E[x²] - mean² (float32, over H×W),
//   y = (x - mean) · rsqrt(var + eps) · scale[c] + bias[c], then relu,
//   leaky relu (slope 0.01) or nothing; y has x's dtype.
//
// Replaces: cat_tpu/ops/pallas_norm.py::_kernel, launched by
// instance_norm_act_pallas (the TPU Pallas kernel), and the backward that
// cat_tpu/ops/pallas_norm.py::_fused_bwd leaves to XLA.  Written in CUDA C++.
// The TPU kernel is NHWC with a grid over (sample, channel tile) and keeps a
// whole (H, W, ctile) slab in VMEM; its channel tiling (_channel_tile) and
// its XLA fallback for planes that do not fit VMEM do not carry over.  Here
// the input is NCHW-contiguous, so each (n, c) plane is one contiguous run
// of H·W values.
//
// Bound on an H100: bytes.  ~10 flops per element against 4 (bf16) or 8
// (f32) bytes moved.  The forward must read x once and write y once:
// 2·N·C·H·W·sizeof(T) bytes at 3.35 TB/s.  The backward reads x and g once
// and writes dx once: 3·N·C·H·W·sizeof(T) bytes.
//
// Why the first design stopped at 62% of that bound.  It gave one CTA of
// 256 threads to each plane and read the plane twice from device memory:
// once for Σx and Σx², once to normalise.  About a thousand CTAs are in
// flight (132 SMs x 8), so at 256² the planes in flight take 135-270 MB,
// several times the 50 MB L2, and the second read came back from HBM.  Three
// passes of traffic where the bound counts two cap it at 67%.  At 64² each
// thread made two 16-byte loads before two CTA barriers, so latency, not
// bandwidth, set the pace.
//
// What this design does (inorm_act_smem, inorm_act_bwd_smem).  The plane
// is read from HBM once, into shared memory, by 1-D bulk copies
// (cp.async.bulk ... mbarrier::complete_tx) that one thread issues in up to
// four chunks, each on its own mbarrier, so the sums start on the first
// chunk while the others are in flight.  Σx and Σx² are taken from shared
// memory, then the plane is normalised from shared memory and stored with
// 16-byte stores.  The host plans by shape (ops/instance_norm.py::norm_plan):
//   - a plane of at most 128 KiB (x and g together in the backward) is one
//     CTA's; planes of less than 16 KiB are packed 2, 4 or 8 to a CTA (each
//     on its own warps) so that a CTA keeps ~32 KiB in flight;
//   - a larger plane is split over a thread-block cluster of k <= 8 CTAs,
//     each staging one contiguous slice of <= 64 KiB.  Each CTA writes its
//     partial (Σx, Σx²) to its own shared memory; after a cluster barrier
//     every CTA reads all k partials through distributed shared memory and
//     adds them in rank order, so all CTAs of a plane use the same mean and
//     rstd bit for bit; a second cluster barrier keeps each CTA alive until
//     its peers have read its partial.
// At <= 64 KiB a CTA, three CTAs share an SM, so one CTA's copies overlap
// another's normalise-and-store; a whole plane of 64-128 KiB in one CTA
// measured faster than the same plane over a cluster of two (its four
// chunks overlap its own sums), and slices of 64 KiB faster than of 128.
// The statistics keep the formula E[x²] - mean² (not Welford) to match the
// JAX package.
//
// The backward (inorm_act_bwd_smem) stages x and g of the plane (or
// slice) the same way, takes xhat = (x - mean)·rstd with the forward's
// saved mean and rstd, z = scale·xhat + bias, g' = g·act'(z) (relu: 1
// above 0, ½ at exactly 0, as jnp.maximum's gradient, 0 below; leaky relu:
// 1 at z >= 0, else 0.01), s1 = Σg' and s2 = Σg'·xhat (float32, over the
// plane, through the cluster as above), and writes
//   dx = scale·rstd·(g' - s1/n - xhat·s2/n)
// in x's dtype.  var = E[x²] - mean² has the centred form's derivative, so
// this is the derivative of the forward's formula.  Each plane's (s1, s2)
// goes to an (N·C, 2) buffer; inorm_bwd_channels then sums it over n in
// order into dbias[c] = Σn s1 and dscale[c] = Σn s2: no float atomics, so
// two calls give the same bits.
//
// Planes the on-chip path cannot take go to the two-pass loops
// (inorm_act, inorm_act_bwd_loop): a plane that needs more than 8 slices,
// or one whose H·W·sizeof(T) or pointers are not 16-byte aligned.  The
// host chooses by shape before the launch; a launch that fails raises.
//
// Limits (checked by the Python wrapper): x (and g) contiguous NCHW, bf16
// or f32; scale and bias float32 (C,).
//
// Split planes.  When image height is split over ranks (--n_spatial), a
// rank holds only its rows of each plane, and the statistics are those of
// the whole plane.  Two more entry points run the forward's two passes
// apart, with the all-reduce of the partial sums between them:
// inorm_stats writes each local plane's float32 (Σx, Σx²), one CTA a
// plane; inorm_apply normalises with the given per-plane mean and rstd,
// then affine and activation, one CTA a plane.  Both are bound by bytes:
// the first reads the tensor once, the second reads and writes it once.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChunks = 8;  // mbarriers a CTA: 4 chunks of a slice, or 8 packed planes
constexpr unsigned long long kHangNs = 2000000000ull;  // a 2 s wait is a fault: trap

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float act_fn(float y, int act) {
  if (act == 1) return fmaxf(y, 0.f);
  if (act == 2) return y >= 0.f ? y : 0.01f * y;
  return y;
}

// The activation's derivative at z, as JAX differentiates it: jnp.maximum
// gives ½ at a tie; jnp.where(z >= 0, ...) gives 1 there.
__device__ __forceinline__ float act_grad(float z, int act) {
  if (act == 1) return z > 0.f ? 1.f : (z == 0.f ? 0.5f : 0.f);
  if (act == 2) return z >= 0.f ? 1.f : 0.01f;
  return 1.f;
}

// Sum of v over the CTA, returned to every thread.
__device__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // red may still be read from a previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) s += red[w];
  return s;
}

// ---------------------------------------------------------------------------
// mbarrier, bulk copy and cluster primitives
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

// Wait until the phase of parity `parity` has completed; a phase that has
// not completed after 2 s is a fault in the copies' bookkeeping: trap
// rather than hang.
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

// The CTA's share of the staging: which planes and which slice of them it
// holds, and how its bulk copies are cut.
struct Stage {
  long long p0;    // first plane
  int nplanes;     // planes it holds (ppc, fewer in the last CTA)
  int rank;        // its rank in the plane's cluster (0 when k == 1)
  long long start;  // first value of its slice within a plane
  long long len;   // values of its slice (HW when k == 1)
  int nch;         // chunks, one mbarrier each
};

__device__ __forceinline__ Stage stage_of(long long planes, long long HW, int k, int ppc,
                                          long long slice, long long chunk) {
  Stage s;
  s.rank = static_cast<int>(blockIdx.x % k);
  s.p0 = static_cast<long long>(blockIdx.x / k) * ppc;
  s.nplanes = static_cast<int>(min(static_cast<long long>(ppc), planes - s.p0));
  s.start = s.rank * slice;
  s.len = min(slice, HW - s.start);
  s.nch = ppc > 1 ? s.nplanes : static_cast<int>((s.len + chunk - 1) / chunk);
  return s;
}

// Thread 0: init the chunks' mbarriers, then issue every chunk's copies of
// `arrays` tensors (x, or x and g), array a of plane j landing at
// smem + (a·ppc + j)·slice.  Chunk i of a packed CTA is plane i; of a
// single-plane CTA, values [i·chunk, (i+1)·chunk) of its slice.
template <typename T, int kArrays>
__device__ __forceinline__ void issue_copies(const Stage& s, uint64_t* bars, T* smem,
                                             const T* const (&src)[kArrays], long long HW,
                                             int ppc, long long slice, long long chunk) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < s.nch; ++i) mbar_init(smem_u32(&bars[i]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < s.nch; ++i) {
      const long long off = ppc > 1 ? i * slice : i * chunk;
      const long long n = ppc > 1 ? HW : min(chunk, s.len - off);
      const uint32_t bytes = static_cast<uint32_t>(n * sizeof(T));
      const uint32_t bar = smem_u32(&bars[i]);
      mbar_expect_tx(bar, kArrays * bytes);
      const long long from = ppc > 1 ? i * HW : s.start + off;  // past plane p0's start
#pragma unroll
      for (int a = 0; a < kArrays; ++a)
        bulk_load(smem_u32(smem + a * ppc * slice + off), src[a] + s.p0 * HW + from, bytes, bar);
    }
  }
  __syncthreads();  // the barriers are initialised before anyone waits on them
}

// Sum (a, b) over the threads of one plane's group (gsize threads, whole
// warps, group grp), then over the plane's cluster in rank order when
// k > 1.  Every thread of the group gets the same bits.  With k > 1 the
// caller must call cluster_wait() once before it exits.
__device__ __forceinline__ float2 plane_sum(float a, float b, int gsize, int grp, int k,
                                           float (*red)[kThreads / 32], float2* part) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    red[0][warp] = a;
    red[1][warp] = b;
  }
  __syncthreads();
  const int wpg = gsize / 32;
  float sa = 0.f, sb = 0.f;
  for (int w = 0; w < wpg; ++w) {
    sa += red[0][grp * wpg + w];
    sb += red[1][grp * wpg + w];
  }
  if (k > 1) {
    if (threadIdx.x == 0) *part = make_float2(sa, sb);
    cluster_arrive();
    cluster_wait();  // every peer's partial is written
    cg::cluster_group cluster = cg::this_cluster();
    sa = 0.f;
    sb = 0.f;
    for (int r = 0; r < k; ++r) {
      const float2 p = *cluster.map_shared_rank(part, r);
      sa += p.x;
      sb += p.y;
    }
    cluster_arrive();  // done reading the peers; the matching wait is before exit
  }
  return make_float2(sa, sb);
}

// ---------------------------------------------------------------------------
// Forward, on chip: one HBM read and one HBM write per plane
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
inorm_act_smem(const T* __restrict__ x, const float* __restrict__ scale,
               const float* __restrict__ bias, T* __restrict__ y, float* __restrict__ mean_out,
               float* __restrict__ rstd_out, long long planes, int C, long long HW, int k,
               int ppc, long long slice, long long chunk, float eps, int act) {
  constexpr int V = 16 / sizeof(T);  // values per 16-byte access
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);
  __shared__ __align__(8) uint64_t bars[kMaxChunks];
  __shared__ float red[2][kThreads / 32];
  __shared__ float2 part;  // this CTA's (Σx, Σx²), read by its cluster's peers

  const Stage s = stage_of(planes, HW, k, ppc, slice, chunk);
  const T* const srcs[1] = {x};
  issue_copies<T, 1>(s, bars, xs, srcs, HW, ppc, slice, chunk);

  const int gsize = kThreads / ppc;  // threads of one plane
  const int grp = threadIdx.x / gsize, lt = threadIdx.x % gsize;
  const bool mine = grp < s.nplanes;
  const long long plane = s.p0 + grp;
  const int c = static_cast<int>(plane % C);
  const float sc = mine ? scale[c] : 0.f, bi = mine ? bias[c] : 0.f;
  const T* base = xs + grp * slice;

  float sx = 0.f, sx2 = 0.f;
  if (mine) {
    const int my_nch = ppc > 1 ? 1 : s.nch;
    for (int i = 0; i < my_nch; ++i) {
      mbar_wait(smem_u32(&bars[ppc > 1 ? grp : i]), 0);
      const long long lo = ppc > 1 ? 0 : i * chunk;
      const long long hi = ppc > 1 ? s.len : min(s.len, lo + chunk);
#pragma unroll 4
      for (long long e = lo + static_cast<long long>(lt) * V; e < hi;
           e += static_cast<long long>(gsize) * V) {
        const uint4 raw = *reinterpret_cast<const uint4*>(base + e);
        const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int q = 0; q < V; ++q) {
          const float f = to_f(v[q]);
          sx += f;
          sx2 += f * f;
        }
      }
    }
  }
  const float2 tot = plane_sum(sx, sx2, gsize, grp, k, red, &part);
  const float inv_n = 1.f / static_cast<float>(HW);
  const float mean = tot.x * inv_n;
  const float var = tot.y * inv_n - mean * mean;
  const float rstd = rsqrtf(var + eps);
  if (mine) {
    if (s.rank == 0 && lt == 0) {
      mean_out[plane] = mean;
      rstd_out[plane] = rstd;
    }
    T* out = y + plane * HW + s.start;
#pragma unroll 4
    for (long long e = static_cast<long long>(lt) * V; e < s.len;
         e += static_cast<long long>(gsize) * V) {
      const uint4 raw = *reinterpret_cast<const uint4*>(base + e);
      const T* v = reinterpret_cast<const T*>(&raw);
      uint4 outraw;
      T* o = reinterpret_cast<T*>(&outraw);
#pragma unroll
      for (int q = 0; q < V; ++q) o[q] = from_f<T>(act_fn((to_f(v[q]) - mean) * rstd * sc + bi, act));
      *reinterpret_cast<uint4*>(out + e) = outraw;
    }
  }
  if (k > 1) cluster_wait();  // the peers have read this CTA's partial
}

// ---------------------------------------------------------------------------
// Forward, two passes (a plane past 8 slices, or unaligned): one CTA a plane
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
inorm_act(const T* __restrict__ x, const float* __restrict__ scale,
          const float* __restrict__ bias, T* __restrict__ y, float* __restrict__ mean_out,
          float* __restrict__ rstd_out, int C, long long HW, float eps, int act, int vec) {
  constexpr int V = 16 / sizeof(T);  // values per 16-byte access
  __shared__ float red[kThreads / 32];
  const long long plane = blockIdx.x;
  const T* xp = x + plane * HW;
  T* yp = y + plane * HW;

  float s = 0.f, s2 = 0.f;
  if (vec) {
#pragma unroll 4
    for (long long i = (long long)threadIdx.x * V; i < HW; i += (long long)kThreads * V) {
      uint4 raw = *reinterpret_cast<const uint4*>(xp + i);
      const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float f = to_f(v[k]);
        s += f;
        s2 += f * f;
      }
    }
  } else {
    for (long long i = threadIdx.x; i < HW; i += kThreads) {
      const float f = to_f(xp[i]);
      s += f;
      s2 += f * f;
    }
  }
  s = block_sum(s, red);
  s2 = block_sum(s2, red);
  const float inv_n = 1.f / static_cast<float>(HW);
  const float mean = s * inv_n;
  const float var = s2 * inv_n - mean * mean;
  const float rstd = rsqrtf(var + eps);
  const int c = static_cast<int>(plane % C);
  const float sc = scale[c], bi = bias[c];
  if (threadIdx.x == 0) {
    mean_out[plane] = mean;
    rstd_out[plane] = rstd;
  }

  if (vec) {
#pragma unroll 4
    for (long long i = (long long)threadIdx.x * V; i < HW; i += (long long)kThreads * V) {
      uint4 raw = *reinterpret_cast<const uint4*>(xp + i);
      const T* v = reinterpret_cast<const T*>(&raw);
      uint4 outraw;
      T* o = reinterpret_cast<T*>(&outraw);
#pragma unroll
      for (int k = 0; k < V; ++k)
        o[k] = from_f<T>(act_fn((to_f(v[k]) - mean) * rstd * sc + bi, act));
      *reinterpret_cast<uint4*>(yp + i) = outraw;
    }
  } else {
    for (long long i = threadIdx.x; i < HW; i += kThreads)
      yp[i] = from_f<T>(act_fn((to_f(xp[i]) - mean) * rstd * sc + bi, act));
  }
}

// ---------------------------------------------------------------------------
// Backward, on chip: one HBM read of x and of g, one write of dx
// ---------------------------------------------------------------------------

// g' = g·act'(z) and xhat of one value.  z = xhat·scale + bias is rounded
// twice, as the plain twin rounds it (no fused multiply-add), so that twin
// and kernel given the same mean and rstd take relu's mask on the same z
// bit for bit; an exact tie (x == mean, bias 0) is a tie either way.
struct Grad {
  float gp, xh;
};

__device__ __forceinline__ Grad grad_at(float xv, float gv, float m, float r, float sc,
                                        float bi, int act) {
  const float xh = __fmul_rn(xv - m, r);
  return {gv * act_grad(__fadd_rn(__fmul_rn(xh, sc), bi), act), xh};
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
inorm_act_bwd_smem(const T* __restrict__ x, const T* __restrict__ g,
                   const float* __restrict__ mean_in, const float* __restrict__ rstd_in,
                   const float* __restrict__ scale, const float* __restrict__ bias,
                   T* __restrict__ dx, float* __restrict__ sums, long long planes, int C,
                   long long HW, int k, int ppc, long long slice, long long chunk, int act) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);
  __shared__ __align__(8) uint64_t bars[kMaxChunks];
  __shared__ float red[2][kThreads / 32];
  __shared__ float2 part;

  const Stage s = stage_of(planes, HW, k, ppc, slice, chunk);
  const T* const srcs[2] = {x, g};
  issue_copies<T, 2>(s, bars, xs, srcs, HW, ppc, slice, chunk);

  const int gsize = kThreads / ppc;
  const int grp = threadIdx.x / gsize, lt = threadIdx.x % gsize;
  const bool mine = grp < s.nplanes;
  const long long plane = s.p0 + grp;
  const int c = static_cast<int>(plane % C);
  const float sc = mine ? scale[c] : 0.f, bi = mine ? bias[c] : 0.f;
  const float m = mine ? mean_in[plane] : 0.f, r = mine ? rstd_in[plane] : 0.f;
  const T* xb = xs + grp * slice;
  const T* gb = xs + (ppc + grp) * slice;

  float s1 = 0.f, s2 = 0.f;
  if (mine) {
    const int my_nch = ppc > 1 ? 1 : s.nch;
    for (int i = 0; i < my_nch; ++i) {
      mbar_wait(smem_u32(&bars[ppc > 1 ? grp : i]), 0);
      const long long lo = ppc > 1 ? 0 : i * chunk;
      const long long hi = ppc > 1 ? s.len : min(s.len, lo + chunk);
#pragma unroll 2
      for (long long e = lo + static_cast<long long>(lt) * V; e < hi;
           e += static_cast<long long>(gsize) * V) {
        const uint4 xr = *reinterpret_cast<const uint4*>(xb + e);
        const uint4 gr = *reinterpret_cast<const uint4*>(gb + e);
        const T* xv = reinterpret_cast<const T*>(&xr);
        const T* gv = reinterpret_cast<const T*>(&gr);
#pragma unroll
        for (int q = 0; q < V; ++q) {
          const Grad d = grad_at(to_f(xv[q]), to_f(gv[q]), m, r, sc, bi, act);
          s1 += d.gp;
          s2 += d.gp * d.xh;
        }
      }
    }
  }
  const float2 tot = plane_sum(s1, s2, gsize, grp, k, red, &part);
  if (mine) {
    if (s.rank == 0 && lt == 0) {
      sums[2 * plane] = tot.x;
      sums[2 * plane + 1] = tot.y;
    }
    const float inv_n = 1.f / static_cast<float>(HW);
    const float a = sc * r, m1 = tot.x * inv_n, m2 = tot.y * inv_n;
    T* out = dx + plane * HW + s.start;
#pragma unroll 2
    for (long long e = static_cast<long long>(lt) * V; e < s.len;
         e += static_cast<long long>(gsize) * V) {
      const uint4 xr = *reinterpret_cast<const uint4*>(xb + e);
      const uint4 gr = *reinterpret_cast<const uint4*>(gb + e);
      const T* xv = reinterpret_cast<const T*>(&xr);
      const T* gv = reinterpret_cast<const T*>(&gr);
      uint4 outraw;
      T* o = reinterpret_cast<T*>(&outraw);
#pragma unroll
      for (int q = 0; q < V; ++q) {
        const Grad d = grad_at(to_f(xv[q]), to_f(gv[q]), m, r, sc, bi, act);
        o[q] = from_f<T>(a * (d.gp - m1 - d.xh * m2));
      }
      *reinterpret_cast<uint4*>(out + e) = outraw;
    }
  }
  if (k > 1) cluster_wait();
}

// ---------------------------------------------------------------------------
// Backward, two passes over x and g (a plane past 8 slices, or unaligned)
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
inorm_act_bwd_loop(const T* __restrict__ x, const T* __restrict__ g,
                   const float* __restrict__ mean_in, const float* __restrict__ rstd_in,
                   const float* __restrict__ scale, const float* __restrict__ bias,
                   T* __restrict__ dx, float* __restrict__ sums, int C, long long HW, int act,
                   int vec) {
  constexpr int V = 16 / sizeof(T);
  __shared__ float red[kThreads / 32];
  const long long plane = blockIdx.x;
  const T* xp = x + plane * HW;
  const T* gp = g + plane * HW;
  T* dp = dx + plane * HW;
  const int c = static_cast<int>(plane % C);
  const float sc = scale[c], bi = bias[c], m = mean_in[plane], r = rstd_in[plane];
  const int W = vec ? V : 1;  // values a thread takes at once

  float s1 = 0.f, s2 = 0.f;
  for (long long i = static_cast<long long>(threadIdx.x) * W; i < HW;
       i += static_cast<long long>(kThreads) * W) {
    alignas(16) T xv[V];
    alignas(16) T gv[V];
    if (vec) {
      *reinterpret_cast<uint4*>(xv) = *reinterpret_cast<const uint4*>(xp + i);
      *reinterpret_cast<uint4*>(gv) = *reinterpret_cast<const uint4*>(gp + i);
    } else {
      xv[0] = xp[i];
      gv[0] = gp[i];
    }
    for (int q = 0; q < W; ++q) {
      const Grad d = grad_at(to_f(xv[q]), to_f(gv[q]), m, r, sc, bi, act);
      s1 += d.gp;
      s2 += d.gp * d.xh;
    }
  }
  s1 = block_sum(s1, red);
  s2 = block_sum(s2, red);
  if (threadIdx.x == 0) {
    sums[2 * plane] = s1;
    sums[2 * plane + 1] = s2;
  }
  const float inv_n = 1.f / static_cast<float>(HW);
  const float a = sc * r, m1 = s1 * inv_n, m2 = s2 * inv_n;
  for (long long i = static_cast<long long>(threadIdx.x) * W; i < HW;
       i += static_cast<long long>(kThreads) * W) {
    alignas(16) T xv[V];
    alignas(16) T gv[V];
    alignas(16) T o[V];
    if (vec) {
      *reinterpret_cast<uint4*>(xv) = *reinterpret_cast<const uint4*>(xp + i);
      *reinterpret_cast<uint4*>(gv) = *reinterpret_cast<const uint4*>(gp + i);
    } else {
      xv[0] = xp[i];
      gv[0] = gp[i];
    }
    for (int q = 0; q < W; ++q) {
      const Grad d = grad_at(to_f(xv[q]), to_f(gv[q]), m, r, sc, bi, act);
      o[q] = from_f<T>(a * (d.gp - m1 - d.xh * m2));
    }
    if (vec) {
      *reinterpret_cast<uint4*>(dp + i) = *reinterpret_cast<const uint4*>(o);
    } else {
      dp[i] = o[0];
    }
  }
}

// dbias[c] = Σn sums[n, c, 0], dscale[c] = Σn sums[n, c, 1], n in order.
__global__ void inorm_bwd_channels(const float* __restrict__ sums, float* __restrict__ dscale,
                                   float* __restrict__ dbias, int N, int C) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float a = 0.f, b = 0.f;
  for (int n = 0; n < N; ++n) {
    const long long p = static_cast<long long>(n) * C + c;
    a += sums[2 * p];
    b += sums[2 * p + 1];
  }
  dbias[c] = a;
  dscale[c] = b;
}

// Per-plane float32 (Σx, Σx²) of x's local rows: stats[2·plane + {0, 1}].
template <typename T>
__global__ void __launch_bounds__(kThreads)
inorm_stats(const T* __restrict__ x, float* __restrict__ stats, long long HW, int vec) {
  constexpr int V = 16 / sizeof(T);
  __shared__ float red[kThreads / 32];
  const long long plane = blockIdx.x;
  const T* xp = x + plane * HW;
  float s = 0.f, s2 = 0.f;
  if (vec) {
#pragma unroll 4
    for (long long i = (long long)threadIdx.x * V; i < HW; i += (long long)kThreads * V) {
      uint4 raw = *reinterpret_cast<const uint4*>(xp + i);
      const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float f = to_f(v[k]);
        s += f;
        s2 += f * f;
      }
    }
  } else {
    for (long long i = threadIdx.x; i < HW; i += kThreads) {
      const float f = to_f(xp[i]);
      s += f;
      s2 += f * f;
    }
  }
  s = block_sum(s, red);
  s2 = block_sum(s2, red);
  if (threadIdx.x == 0) {
    stats[2 * plane] = s;
    stats[2 * plane + 1] = s2;
  }
}

// y = act((x - mean[plane]) · rstd[plane] · scale[c] + bias[c]).
template <typename T>
__global__ void __launch_bounds__(kThreads)
inorm_apply(const T* __restrict__ x, const float* __restrict__ mean,
            const float* __restrict__ rstd, const float* __restrict__ scale,
            const float* __restrict__ bias, T* __restrict__ y, int C, long long HW, int act,
            int vec) {
  constexpr int V = 16 / sizeof(T);
  const long long plane = blockIdx.x;
  const T* xp = x + plane * HW;
  T* yp = y + plane * HW;
  const int c = static_cast<int>(plane % C);
  const float m = mean[plane], r = rstd[plane], sc = scale[c], bi = bias[c];
  if (vec) {
#pragma unroll 4
    for (long long i = (long long)threadIdx.x * V; i < HW; i += (long long)kThreads * V) {
      uint4 raw = *reinterpret_cast<const uint4*>(xp + i);
      const T* v = reinterpret_cast<const T*>(&raw);
      uint4 outraw;
      T* o = reinterpret_cast<T*>(&outraw);
#pragma unroll
      for (int k = 0; k < V; ++k) o[k] = from_f<T>(act_fn((to_f(v[k]) - m) * r * sc + bi, act));
      *reinterpret_cast<uint4*>(yp + i) = outraw;
    }
  } else {
    for (long long i = threadIdx.x; i < HW; i += kThreads)
      yp[i] = from_f<T>(act_fn((to_f(xp[i]) - m) * r * sc + bi, act));
  }
}

// Launch an on-chip kernel over ceil(planes / ppc) groups of k CTAs, as
// clusters of k when k > 1, with `smem` bytes of dynamic shared memory.
template <typename... Params, typename... Args>
cudaError_t launch_staged(void (*kernel)(Params...), long long planes, int k, int ppc,
                          size_t smem, cudaStream_t stream, Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(((planes + ppc - 1) / ppc) * k));
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
int inorm_act_launch(const void* x, const void* scale, const void* bias, void* y, void* mean,
                     void* rstd, long long planes, int C, long long HW, float eps, int act,
                     int k, int ppc, long long slice, long long chunk, int vec, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* xp = static_cast<const T*>(x);
  const float *sp = static_cast<const float*>(scale), *bp = static_cast<const float*>(bias);
  T* yp = static_cast<T*>(y);
  float *mp = static_cast<float*>(mean), *rp = static_cast<float*>(rstd);
  if (k == 0) {
    inorm_act<T><<<static_cast<unsigned>(planes), kThreads, 0, st>>>(xp, sp, bp, yp, mp, rp, C,
                                                                    HW, eps, act, vec);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(launch_staged(inorm_act_smem<T>, planes, k, ppc,
                                        static_cast<size_t>(ppc) * slice * sizeof(T), st, xp,
                                        sp, bp, yp, mp, rp, planes, C, HW, k, ppc, slice, chunk,
                                        eps, act));
}

template <typename T>
int inorm_act_bwd_launch(const void* x, const void* g, const void* mean, const void* rstd,
                         const void* scale, const void* bias, void* dx, void* sums,
                         void* dscale, void* dbias, int N, int C, long long HW, int act, int k,
                         int ppc, long long slice, long long chunk, int vec, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T *xp = static_cast<const T*>(x), *gp = static_cast<const T*>(g);
  const float *mp = static_cast<const float*>(mean), *rp = static_cast<const float*>(rstd);
  const float *sp = static_cast<const float*>(scale), *bp = static_cast<const float*>(bias);
  T* dp = static_cast<T*>(dx);
  float* up = static_cast<float*>(sums);
  const long long planes = static_cast<long long>(N) * C;
  cudaError_t err;
  if (k == 0) {
    inorm_act_bwd_loop<T><<<static_cast<unsigned>(planes), kThreads, 0, st>>>(
        xp, gp, mp, rp, sp, bp, dp, up, C, HW, act, vec);
    err = cudaGetLastError();
  } else {
    err = launch_staged(inorm_act_bwd_smem<T>, planes, k, ppc,
                        2 * static_cast<size_t>(ppc) * slice * sizeof(T), st, xp, gp, mp, rp,
                        sp, bp, dp, up, planes, C, HW, k, ppc, slice, chunk, act);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  inorm_bwd_channels<<<(C + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      up, static_cast<float*>(dscale), static_cast<float*>(dbias), N, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x, y: (N, C, H, W) contiguous; scale, bias: (C,) float32; mean, rstd:
// (N·C,) float32 outputs.  act: 0 none, 1 relu, 2 leaky relu (0.01).  The
// plan (ops/instance_norm.py::norm_plan): k == 0 takes the two-pass loop
// (vec: HW and the pointers allow 16-byte accesses); k >= 1 the on-chip
// kernel, k CTAs a plane (a cluster when k > 1), ppc planes a CTA, `slice`
// values a CTA, bulk copies of `chunk` values.
int cat_inorm_act_bf16(const void* x, const void* scale, const void* bias, void* y, void* mean,
                       void* rstd, long long planes, int C, long long HW, float eps, int act,
                       int k, int ppc, long long slice, long long chunk, int vec, void* stream) {
  return inorm_act_launch<__nv_bfloat16>(x, scale, bias, y, mean, rstd, planes, C, HW, eps, act,
                                         k, ppc, slice, chunk, vec, stream);
}

int cat_inorm_act_f32(const void* x, const void* scale, const void* bias, void* y, void* mean,
                      void* rstd, long long planes, int C, long long HW, float eps, int act,
                      int k, int ppc, long long slice, long long chunk, int vec, void* stream) {
  return inorm_act_launch<float>(x, scale, bias, y, mean, rstd, planes, C, HW, eps, act, k, ppc,
                                 slice, chunk, vec, stream);
}

// The backward.  x, g, dx: (N, C, H, W) contiguous in one dtype; mean,
// rstd: (N·C,) float32 from the forward; scale, bias, dscale, dbias: (C,)
// float32; sums: (N·C, 2) float32 scratch.  The plan as above, for x and g
// together.
int cat_inorm_act_bwd_bf16(const void* x, const void* g, const void* mean, const void* rstd,
                           const void* scale, const void* bias, void* dx, void* sums,
                           void* dscale, void* dbias, int N, int C, long long HW, int act, int k,
                           int ppc, long long slice, long long chunk, int vec, void* stream) {
  return inorm_act_bwd_launch<__nv_bfloat16>(x, g, mean, rstd, scale, bias, dx, sums, dscale,
                                             dbias, N, C, HW, act, k, ppc, slice, chunk, vec,
                                             stream);
}

int cat_inorm_act_bwd_f32(const void* x, const void* g, const void* mean, const void* rstd,
                          const void* scale, const void* bias, void* dx, void* sums,
                          void* dscale, void* dbias, int N, int C, long long HW, int act, int k,
                          int ppc, long long slice, long long chunk, int vec, void* stream) {
  return inorm_act_bwd_launch<float>(x, g, mean, rstd, scale, bias, dx, sums, dscale, dbias, N,
                                     C, HW, act, k, ppc, slice, chunk, vec, stream);
}

// The split planes' passes.  stats: (N·C, 2) float32; mean, rstd: (N·C,)
// float32; the rest as above.
int cat_inorm_stats_bf16(const void* x, void* stats, int N, int C, long long HW, int vec,
                         void* stream) {
  inorm_stats<__nv_bfloat16><<<N * C, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<float*>(stats), HW, vec);
  return static_cast<int>(cudaGetLastError());
}

int cat_inorm_stats_f32(const void* x, void* stats, int N, int C, long long HW, int vec,
                        void* stream) {
  inorm_stats<float><<<N * C, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(stats), HW, vec);
  return static_cast<int>(cudaGetLastError());
}

int cat_inorm_apply_bf16(const void* x, const void* mean, const void* rstd, const void* scale,
                         const void* bias, void* y, int N, int C, long long HW, int act, int vec,
                         void* stream) {
  inorm_apply<__nv_bfloat16><<<N * C, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(mean),
      static_cast<const float*>(rstd), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(y), C, HW, act, vec);
  return static_cast<int>(cudaGetLastError());
}

int cat_inorm_apply_f32(const void* x, const void* mean, const void* rstd, const void* scale,
                        const void* bias, void* y, int N, int C, long long HW, int act, int vec,
                        void* stream) {
  inorm_apply<float><<<N * C, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(mean),
      static_cast<const float*>(rstd), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<float*>(y), C, HW, act, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
