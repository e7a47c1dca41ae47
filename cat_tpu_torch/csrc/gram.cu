// Gram matrix G = X·Xᵀ (float32 result) of a batch-major X (B, F), for the
// kernel-alignment (KA) distillation loss.
//
// Replaces: cat_tpu/distill/ka.py::_gram_kernel, launched by _gram_pallas
// (the TPU Pallas kernel).  The TPU version walks F in 2048-wide tiles on a
// sequential grid and carries one (B, B) accumulator in VMEM from step to
// step.  On Hopper blocks run in no order and nothing carries over between
// them, so the work is split in two kernels launched back to back on the
// caller's stream by one C entry point:
//
//   1. gram_partial_*: F is cut into equal chunks, one CTA per chunk.  A CTA
//      stages (rows, KT) tiles of its chunk in shared memory (zero rows past
//      B, zero columns past F: zeros add nothing) and accumulates a float32
//      partial Gram in registers.  bf16 inputs go through tensor cores with
//      mma.sync m16n8k16 (bf16 x bf16 -> f32; a product of two bf16 values
//      is exact in f32, as on the TPU's MXU); their tiles arrive by cp.async
//      in two buffers, so the next tile's copy overlaps this tile's
//      products, and each warp reuses one 16-row A fragment across its
//      8-column tiles.  B is padded to 16, 32, 64 or 128 rows, one kernel
//      instance each, so the tile offsets are compile-time constants.  float32 inputs use CUDA-core FMAs, each thread an
//      8 x 8 register block of entries.
//      Each CTA writes its partial to a scratch buffer the caller allocates.
//   2. gram_reduce: each output entry sums the partials over the chunks in a
//      fixed order (eight interleaved runs, then the eight run sums in
//      order).  No atomics, so a run is bit-reproducible.
//
// One entry point call computes one operand's Gram; KA launches it once per
// operand (the teacher's and the student's F differ), two per tap.
//
// Bound on an H100: bytes.  The work is B·F reads of X and 2·B²·F flops; at
// B = 128 that is 128 flops per bf16 byte, under the ~295 the card needs to
// be compute-bound, so the kernel can at best stream X once at the memory
// rate (B·F·2 bytes / 3.35 TB/s).  The design reads X exactly once with
// 16-byte asynchronous copies when F allows, keeps a tile per CTA in flight
// while the previous one is multiplied, and sizes the chunks so that the
// partials (chunks·Bp²·4 bytes, written and read once more) stay a small
// share of the traffic.  This version has no TMA, no wgmma and only two
// buffers: deeper pipelines are later work.
//
// Limits (checked by the Python wrapper): 1 <= B <= 128, X contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxB = 128;
constexpr int kBfKT = 64;         // bf16 columns staged per step
constexpr int kBfKS = kBfKT + 8;  // row stride: 144 bytes, no bank conflicts
constexpr int kF32KT = 32;        // float32 columns staged per step
constexpr int kF32KS = kF32KT + 1;
constexpr int kF32Block = kMaxB / 16;  // 8 x 8 entries per thread

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* p) {
  a[0] = *reinterpret_cast<const uint32_t*>(p);
  a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * kBfKS);
  a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * kBfKS + 8);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes));
}

// Stage columns [k0, k0 + KT) of rows [0, Bp) into sm: rows past B and
// columns past f1 become zeros.  vec: F % 8 == 0 and chunk % 64 == 0, so a
// group of 8 columns is all in or all out and its 16 bytes are aligned; it
// is copied with cp.async (zero-filled by a source size of 0), without
// waiting.  Otherwise the copy is synchronous, one value at a time.
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* sm, const __nv_bfloat16* x, int B,
                                           int Bp, long long F, long long k0, long long f1,
                                           int vec) {
  if (vec) {
    for (int e = threadIdx.x; e < Bp * (kBfKT / 8); e += kThreads) {
      const int r = e / (kBfKT / 8), c = (e % (kBfKT / 8)) * 8;
      const bool in = r < B && k0 + c < f1;
      cp_async16(sm + r * kBfKS + c, in ? x + (long long)r * F + k0 + c : x, in ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < Bp * kBfKT; e += kThreads) {
      const int r = e / kBfKT, c = e % kBfKT;
      sm[r * kBfKS + c] =
          (r < B && k0 + c < f1) ? x[(long long)r * F + k0 + c] : __float2bfloat16(0.f);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// One CTA: partial[cta] = X[:, f0:f1] · X[:, f0:f1]ᵀ over its chunk, with
// two shared-memory buffers: the copy of step s+1 is in flight while the
// tensor cores work on step s.
// Bp = 16·MT rows (MT = 1, 2, 4 or 8).  Output tiles are m16 x n8: warp w
// owns row tile w % MT and the column tiles w / MT + i·(8 / MT), so it loads
// one A fragment per k-step and reuses it, and every offset but the warp's
// own is a compile-time constant.
template <int MT>
__global__ void __launch_bounds__(kThreads)
gram_partial_bf16(const __nv_bfloat16* __restrict__ x, int B, long long F, long long chunk,
                  int vec, float* __restrict__ partial) {
  constexpr int Bp = 16 * MT;
  constexpr int kTiles = (2 * MT * MT + kWarps - 1) / kWarps;  // per warp
  constexpr int kNStep = kWarps / MT;  // column tiles between a warp's tiles
  __shared__ __align__(16) __nv_bfloat16 sm[2][Bp * kBfKS];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const long long f0 = (long long)blockIdx.x * chunk;
  const long long f1 = min(f0 + chunk, F);
  const bool active = warp < 2 * MT * MT;  // MT = 1 has two tiles only
  const int a_off = ((warp % MT) * 16 + g) * kBfKS + 2 * t4;
  const int b_off = ((warp / MT) * 8 + g) * kBfKS + 2 * t4;

  float acc[kTiles][4];
#pragma unroll
  for (int i = 0; i < kTiles; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  stage_bf16(sm[0], x, B, Bp, F, f0, f1, vec);
  int buf = 0;
  for (long long k0 = f0; k0 < f1; k0 += kBfKT, buf ^= 1) {
    if (k0 + kBfKT < f1) {
      stage_bf16(sm[buf ^ 1], x, B, Bp, F, k0 + kBfKT, f1, vec);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();  // step k0 has landed for every thread
    if (active) {
      const __nv_bfloat16* cur = sm[buf];
#pragma unroll
      for (int kk = 0; kk < kBfKT; kk += 16) {
        uint32_t a[4];
        load_a(a, cur + a_off + kk);
#pragma unroll
        for (int i = 0; i < kTiles; ++i) {
          const __nv_bfloat16* pb = cur + b_off + i * kNStep * 8 * kBfKS + kk;
          uint32_t b[2];
          b[0] = *reinterpret_cast<const uint32_t*>(pb);
          b[1] = *reinterpret_cast<const uint32_t*>(pb + 8);
          mma_bf16_16816(acc[i], a, b);
        }
      }
    }
    __syncthreads();  // every warp is done with sm[buf] before it is refilled
  }

  if (!active) return;
  float* out = partial + (long long)blockIdx.x * Bp * Bp;
  const int r = (warp % MT) * 16 + g;
#pragma unroll
  for (int i = 0; i < kTiles; ++i) {
    const int c = ((warp / MT) + i * kNStep) * 8 + 2 * t4;
    out[r * Bp + c] = acc[i][0];
    out[r * Bp + c + 1] = acc[i][1];
    out[(r + 8) * Bp + c] = acc[i][2];
    out[(r + 8) * Bp + c + 1] = acc[i][3];
  }
}

// float32 operands: thread (ti, tj) = (tid / 16, tid % 16) owns the entries
// (ti + 16a, tj + 16b) for a, b < ceil(B / 16) and accumulates them with
// FMAs over the staged (rows, KT) tile: 2·nb loads for nb² FMAs per column.
__global__ void __launch_bounds__(kThreads)
gram_partial_f32(const float* __restrict__ x, int B, long long F, long long chunk,
                 float* __restrict__ partial) {
  __shared__ float sm[kMaxB * kF32KS];
  const int tid = threadIdx.x, ti = tid / 16, tj = tid % 16;
  const long long f0 = (long long)blockIdx.x * chunk;
  const long long f1 = min(f0 + chunk, F);
  const int nb = (B + 15) / 16;
  const int rows = nb * 16;

  float acc[kF32Block][kF32Block];
#pragma unroll
  for (int a = 0; a < kF32Block; ++a)
#pragma unroll
    for (int b = 0; b < kF32Block; ++b) acc[a][b] = 0.f;

  for (long long k0 = f0; k0 < f1; k0 += kF32KT) {
    __syncthreads();
    for (int e = tid; e < rows * kF32KT; e += kThreads) {
      const int r = e / kF32KT, c = e % kF32KT;
      sm[r * kF32KS + c] = (r < B && k0 + c < f1) ? x[(long long)r * F + k0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kF32KT; ++k) {
      float va[kF32Block], vb[kF32Block];
#pragma unroll
      for (int q = 0; q < kF32Block; ++q) {
        va[q] = q < nb ? sm[(ti + 16 * q) * kF32KS + k] : 0.f;
        vb[q] = q < nb ? sm[(tj + 16 * q) * kF32KS + k] : 0.f;
      }
#pragma unroll
      for (int a = 0; a < kF32Block; ++a)
#pragma unroll
        for (int b = 0; b < kF32Block; ++b) acc[a][b] = fmaf(va[a], vb[b], acc[a][b]);
    }
  }

  float* out = partial + (long long)blockIdx.x * B * B;
#pragma unroll
  for (int a = 0; a < kF32Block; ++a)
#pragma unroll
    for (int b = 0; b < kF32Block; ++b) {
      const int i = ti + 16 * a, j = tj + 16 * b;
      if (i < B && j < B) out[i * B + j] = acc[a][b];
    }
}

// G[e] = sum over chunks of partial[c, e] (e = i*B + j, read at i*Bp + j),
// in a fixed order: warp w sums chunks w, w+8, w+16, ... in turn, then the
// eight warp sums are added in warp order.  One lane per entry.
__global__ void __launch_bounds__(kThreads)
gram_reduce(const float* __restrict__ partial, int nchunks, int B, int Bp,
            float* __restrict__ g) {
  __shared__ float red[kWarps][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int e = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (e < B * B) {
    const float* p = partial + (e / B) * Bp + (e % B);
    const long long stride = (long long)Bp * Bp;
#pragma unroll 8
    for (int c = warp; c < nchunks; c += kWarps) s += p[c * stride];
  }
  red[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && e < B * B) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += red[w][lane];
    g[e] = t;
  }
}

}  // namespace

extern "C" {

// x: (B, F) bf16, contiguous.  partial: nchunks * Bp * Bp floats, Bp = 16,
// 32, 64 or 128, the first that is >= B.  g: (B, B) floats.  chunk: a
// multiple of 64.
int cat_gram_bf16(const void* x, int B, long long F, long long chunk, int nchunks,
                  int vec, void* partial, void* g, void* stream) {
  const int Bp = B <= 16 ? 16 : B <= 32 ? 32 : B <= 64 ? 64 : 128;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  float* p = static_cast<float*>(partial);
  switch (Bp) {
    case 16: gram_partial_bf16<1><<<nchunks, kThreads, 0, s>>>(xb, B, F, chunk, vec, p); break;
    case 32: gram_partial_bf16<2><<<nchunks, kThreads, 0, s>>>(xb, B, F, chunk, vec, p); break;
    case 64: gram_partial_bf16<4><<<nchunks, kThreads, 0, s>>>(xb, B, F, chunk, vec, p); break;
    default: gram_partial_bf16<8><<<nchunks, kThreads, 0, s>>>(xb, B, F, chunk, vec, p); break;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gram_reduce<<<(B * B + 31) / 32, kThreads, 0, s>>>(p, nchunks, B, Bp, static_cast<float*>(g));
  return static_cast<int>(cudaGetLastError());
}

// x: (B, F) float32, contiguous.  partial: nchunks * B * B floats.  chunk:
// a multiple of 32.
int cat_gram_f32(const void* x, int B, long long F, long long chunk, int nchunks,
                 void* partial, void* g, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  gram_partial_f32<<<nchunks, kThreads, 0, s>>>(static_cast<const float*>(x), B, F,
                                                chunk, static_cast<float*>(partial));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gram_reduce<<<(B * B + 31) / 32, kThreads, 0, s>>>(static_cast<const float*>(partial),
                                                     nchunks, B, B, static_cast<float*>(g));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
