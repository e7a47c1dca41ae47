// Gram matrix G = X·Xᵀ (float32 result) of a batch-major X (B, F), for the
// kernel-alignment (KA) distillation loss.
//
// Replaces: cat_tpu/distill/ka.py::_gram_kernel, launched by _gram_pallas
// (the TPU Pallas kernel).  The TPU version walks F in 2048-wide tiles on a
// sequential grid and carries one (B, B) accumulator in VMEM from step to
// step.  On Hopper blocks run in no order and nothing carries over between
// them, so each C entry point launches two kernels back to back on the
// caller's stream: a partial-Gram kernel, in which each CTA sums the
// products of its own range of F into a float32 (Bp, Bp) partial, and
// gram_reduce, which sums the partials of every entry in a fixed order
// (eight interleaved runs, then the eight run sums in order).  No atomics,
// so a run is bit-reproducible.  The bf16 kernels pad B to Bp = 16, 32, 64
// or 128 rows (zero rows add nothing), one kernel instance each.
//
// Bound on an H100, for bf16: bytes.  The work is B·F reads of X and B(B+1)·F
// flops (the triangle); at B = 128 that is 64 flops per bf16 byte, under the
// ~295 the card needs to be compute-bound, so a kernel can at best stream X once at the memory
// rate (B·F·2 bytes / 3.35 TB/s).  To stream at that rate an SM needs about
// 48 KiB of loads in flight, and the partials (written and read once more)
// must stay a small share of the traffic.
//
// Four partial-Gram kernels; the Python wrapper (distill/ka.py::_gram_path)
// picks one by dtype and shape:
//
//   gram_partial_tma (bf16, F % 8 == 0, 16-byte-aligned X: TMA's rules for
//      the row stride and the base address).  One persistent CTA per SM owns
//      a contiguous range of F in 64-column tiles (128 bytes of each row: one
//      128-byte swizzle row), balanced to within one tile.  One producer lane
//      keeps a ring of 128 KiB of tiles in flight with TMA (one tensor map
//      over X; rows past B and columns past F arrive as zeros), each stage
//      with a "full" and an "empty" mbarrier.  Consumer warpgroups multiply
//      with wgmma: G = X·Xᵀ is a product of two K-major operands read from
//      the same swizzled tile, warpgroup w taking rows [64w, 64w + 64) as A
//      and all Bp rows as B (m64nBpk16, 4 per tile, 32 bytes apart inside
//      the swizzle row).  A stage returns to the producer once wgmma.wait_group
//      shows its reads are done.  The tensor cores' running sum drops low
//      bits with a bias, so wgmma sums runs of 4 tiles and ordinary float32
//      adds sum the runs.  132 partials of Bp² floats (8.65 MB at Bp = 128).
//   gram_partial_bf16 (every other bf16 operand).  ~4 CTAs per SM, each
//      staging (Bp, 64) tiles by cp.async in two buffers and multiplying with
//      mma.sync m16n8k16 from fragments loaded out of shared memory.
//   gram_partial_f32_tma (float32, F % 4 == 0, 16-byte-aligned X).  The
//      recipe runs float32 with TF32 off, so the products are exact float32
//      FMAs on the CUDA cores, and the bound moves: at B = 80 the lower
//      triangle's B(B+1)·F flops at 67 TFLOP/s take as long as streaming X
//      (0.101 against 0.100 ms on the teacher's tap), so the kernel must both
//      stream at the memory rate and keep every FMA pipe fed.  The loads are
//      the bf16 kernel's: one persistent CTA per SM, a contiguous range of
//      64-column tiles (256 bytes of each row; 128 columns when B <= 40),
//      one producer lane keeping a 128 KiB TMA ring full, rows padded to Bp
//      (B rounded up to a multiple of 8) by TMA's zero fill.  The work is
//      sized to B and to the triangle: only the (Bp/8)(Bp/8 + 1)/2 8 x 8
//      register blocks on or below the diagonal are computed.  An SM reads
//      32 words of shared memory per clock and issues 128 FMAs, so a block
//      loads 16-byte column groups of its 8 + 8 rows (16 words) for 64 FMAs
//      per column: 4 FMAs per word.  A block alone is too little work for an
//      SM (55 blocks at B = 80), so `groups` threads share each block, each
//      taking the column groups ≡ its lane (mod groups) of every tile:
//      9-15 consumer warps from B = 25 up.  Eight neighbouring lanes read 8
//      consecutive column groups of their rows, so with 256- or 512-byte
//      rows (no swizzle) their 16-byte loads hit 8 different bank groups.
//      The groups' sums are added by a fixed butterfly of warp shuffles, the
//      CTAs' by gram_reduce, which reads the triangle for both halves: G is
//      bit-reproducible and exactly symmetric.  What bounds it on the card:
//      shared memory fills an SM's registers at 128 bytes per clock, so at
//      4 FMAs per word the loads take as many cycles as the FMAs, and the
//      two overlap only in part (about half the FMA rate on an H100;
//      PERF.md).
//   gram_partial_f32 (every other float32 operand): CUDA-core FMAs, each
//      thread an 8 x 8 register block of entries, staged synchronously.
//
// Past 128 rows the two TMA kernels run as pair kernels (section "Work
// units" below): B is cut into 128-row blocks and every block pair X_i·X_jᵀ
// is computed in one launch, reading X in place through one tensor map, on
// a plan of work units that gram_reduce also reads to sum and mirror them.
// The wrapper hands them an operand TMA can map (a zero-padded copy of one
// it cannot).
//
// One entry point call computes one operand's Gram; KA launches it once per
// operand (the teacher's and the student's F differ), two per tap.
//
// Limits (checked by the Python wrapper): X contiguous; 1 <= B <= 128 but
// for the TMA kernels' pair plans, which take B > 128.

#include <cuda.h>  // CUtensorMap and cuTensorMapEncodeTiled's types (no -lcuda: see tma_encoder)
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

// G[r, c] = the sum of partial[v, r % Bp, c % Bp] over the partials v of
// the entry, in a fixed order: warp w sums v0 + w, v0 + w + 8, ... in turn,
// then the eight warp sums are added in warp order.  One lane per entry.
// Without `starts` v runs over [0, nchunks) (B <= Bp).  With it (the pair
// plans; `lower` set), (r, c) lies in pair p = i(i+1)/2 + j of Bp-row blocks
// (i = r / Bp, j = c / Bp) and v over the pair's units [starts[p],
// starts[p + 1]).  With `lower` the partials hold the lower triangle only:
// the lane of (r, c), c <= r, writes both G[r, c] and G[c, r], so G comes
// out exactly symmetric.
__global__ void __launch_bounds__(kThreads)
gram_reduce(const float* __restrict__ partial, int nchunks, const int* __restrict__ starts,
            int B, int Bp, int lower, float* __restrict__ g) {
  __shared__ float red[kWarps][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long e = static_cast<long long>(blockIdx.x) * 32 + lane;
  const int r = static_cast<int>(e / B), c = static_cast<int>(e % B);
  const bool mine = e < static_cast<long long>(B) * B && (!lower || c <= r);
  float s = 0.f;
  if (mine) {
    const int p = r / Bp * (r / Bp + 1) / 2 + c / Bp;
    const int v0 = starts != nullptr ? starts[p] : 0;
    const int v1 = starts != nullptr ? starts[p + 1] : nchunks;
    const float* q = partial + (r % Bp) * Bp + c % Bp;
    const long long stride = static_cast<long long>(Bp) * Bp;
#pragma unroll 8
    for (int v = v0 + warp; v < v1; v += kWarps) s += q[v * stride];
  }
  red[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && mine) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += red[w][lane];
    g[static_cast<long long>(r) * B + c] = t;
    if (lower) g[static_cast<long long>(c) * B + r] = t;
  }
}

// ---------------------------------------------------------------------------
// TMA, mbarrier and wgmma primitives
// ---------------------------------------------------------------------------

constexpr int kTmaKT = 64;               // columns per tile: 128 bytes of a row
constexpr int kRingBytes = 128 * 1024;   // tiles in flight per CTA
constexpr int kRun = 4;                  // tiles wgmma sums before a float32 add
constexpr unsigned long long kHangNs = 2000000000ull;  // a 2 s wait is a fault: trap

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed.  The loop is in PTX,
// so the compiler sees no divergent branch around the wgmma code.  A phase
// that has not completed after 2 s is a fault in the ring's bookkeeping:
// trap rather than hang.
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

// Copy the tensor map's box at column c0, row r0 into shared memory;
// completion counts the box's bytes on `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int r0) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(r0), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major operand in the 128-byte swizzle
// written by TMA: start address >> 4, leading byte offset unused (1), stride
// byte offset 1024 >> 4 (8 rows of 128 bytes), base offset 0 (the tile is
// 1024-byte aligned), layout 1 = 128-byte swizzle.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// D (64 x N, float32, in registers) = A (64 x 16) · B (N x 16)ᵀ + (scale_d ? D : 0),
// A and B bf16, K-major in shared memory.
template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], uint64_t a, uint64_t b, int scale_d);

template <>
__device__ __forceinline__ void wgmma_bf16<16>(float (&d)[8], uint64_t a, uint64_t b,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7 "
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_bf16<32>(float (&d)[16], uint64_t a, uint64_t b,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15 "
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_bf16<64>(float (&d)[32], uint64_t a, uint64_t b,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_bf16<128>(float (&d)[64], uint64_t a, uint64_t b,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// Keep the compiler from moving accumulator accesses across the asynchronous
// wgmma instructions (no code is emitted).
template <int K>
__device__ __forceinline__ void fence_acc(float (&d)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// ---------------------------------------------------------------------------
// Work units and the TMA ring of both dtypes; block pairs (B > 128)
// ---------------------------------------------------------------------------
//
// Past 128 rows the TMA kernels run on a plan of work units.  The rows are
// cut into n = ⌈B/128⌉ blocks, and pair p = i(i+1)/2 + j (i >= j) yields
// the (128, 128) block X_i·X_jᵀ.  The tensor map covers the whole (B, F)
// operand with a box of 128 rows, so a block is read in place at row 128·i;
// rows past B (a ragged last block) arrive as zeros.  CTA u runs
// unit u of the plan (distill/ka.py::_pair_plan, passed as a table): pair
// (bi, bj) over the 64-column tiles first, first + stride, ... of F, into
// its own (128, 128) float32 partial.  A diagonal pair loads one box per
// tile, an off-diagonal pair two (block i's and block j's) for the same
// products, so an off-diagonal pair gets twice a diagonal pair's CTAs (twice
// the stride).  Then every CTA moves about as many bytes per second, and the
// CTAs of all pairs step through F together, round-robin over the tiles: at
// any time the card reads a window of ~2·stride tiles (4 MB at B = 256), and
// of the n reads of a block's tile, one comes from HBM and the others from
// the 50 MB L2.  A CTA that falls behind reads from L2, which is faster, so
// it catches up.  gram_reduce sums each pair's partials.  Bounds on an H100
// at B = 256: bf16 by bytes (streaming X once; the n - 1 other reads of a
// tile must hit L2), float32 by the lower triangle's FMAs, which the
// kernels compute and no more (diagonal pairs take their triangle only in
// float32; in bf16 the tensor cores have room for the full square).
//
// Without a plan (B <= 128) a CTA's unit is a contiguous range of tiles of
// the one block, an even split of F among the CTAs.

// No L2 promotion past 128 rows: a tile's neighbour belongs to another CTA,
// and fetching it with this one's rows (the 256-byte promotion of the B <=
// 128 kernels) made the bf16 pair kernel slower at B = 256 on an H100.
constexpr CUtensorMapL2promotion kPairPromotion = CU_TENSOR_MAP_L2_PROMOTION_NONE;

// The work of a CTA: n tiles first, first + stride, ... of X, the products
// of row block bi with row block bj.
struct Unit {
  int bi, bj, n;
  long long first, stride;
};

// CTA blockIdx.x's unit: with kPairs, its row (bi, bj, first, stride) of
// `plan`; else tiles [t0, t1) of the one block, balanced to within one tile.
// kPairs is a template argument so that the B <= 128 instances know at
// compile time that their unit is diagonal (a runtime test cost the float32
// kernel 5-7% at B = 80 and 128 on an H100).
template <bool kPairs>
__device__ __forceinline__ Unit cta_unit(const int4* plan, long long ntiles) {
  if (kPairs) {
    const int4 u = plan[blockIdx.x];
    const int n = u.z < ntiles ? static_cast<int>((ntiles - u.z + u.w - 1) / u.w) : 0;
    return {u.x, u.y, n, u.z, u.w};
  }
  const long long t0 = blockIdx.x * ntiles / gridDim.x;
  return {0, 0, static_cast<int>((blockIdx.x + 1) * ntiles / gridDim.x - t0), t0, 1};
}

// A ring of `stages` stages: full[s] completes on the producer's expect_tx
// and the bytes it counts, empty[s] on one arrival per consumer warp.
__device__ __forceinline__ void ring_init(uint64_t* full, uint64_t* empty, int stages,
                                          int consumer_warps) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), consumer_warps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The producer (one lane) keeps the ring full with unit u's tiles of `cols`
// columns: each stage holds block bi's box (rows from bi·rows) and, for an
// off-diagonal pair, block bj's box behind it.  Round ph of a stage waits
// for the consumers' ph-th release (parity ph ^ 1 passes at once for ph = 0).
__device__ __forceinline__ void ring_produce(const CUtensorMap* map, uint64_t* full,
                                             uint64_t* empty, uint32_t ring, int stages,
                                             uint32_t box_bytes, const Unit& u, int cols,
                                             int rows) {
  const bool off = u.bi != u.bj;
  const uint32_t stage_bytes = off ? 2 * box_bytes : box_bytes;
  for (int i = 0, s = 0, ph = 0; i < u.n; ++i) {
    mbar_wait(smem_u32(&empty[s]), ph ^ 1);
    mbar_expect_tx(smem_u32(&full[s]), stage_bytes);  // whole boxes, even at edges
    const int c0 = static_cast<int>((u.first + i * u.stride) * cols);
    const uint32_t dst = ring + s * stage_bytes;
    tma_load_2d(dst, map, smem_u32(&full[s]), c0, u.bi * rows);
    if (off) tma_load_2d(dst + box_bytes, map, smem_u32(&full[s]), c0, u.bj * rows);
    if (++s == stages) s = 0, ph ^= 1;
  }
}

// ---------------------------------------------------------------------------
// bf16: the TMA ring + wgmma
// ---------------------------------------------------------------------------

// Persistent CTA `blockIdx.x`: partial[cta] = the products of its unit's
// tiles (cta_unit), rows [0, N) of block bi against those of block bj; a
// diagonal unit's stage is its one box, used as A and B.  Threads: kWG
// consumer warpgroups (warps 0 .. 4·kWG-1, warpgroup-aligned), then one
// producer warp.  A diagonal pair computes the whole square: the kernel is
// bound by bytes, and sparing warpgroup 0 the columns its rows do not need
// (m64n64) was tried and was not faster on an H100.
template <int N, bool kPairs>
__global__ void __launch_bounds__(128 * (N == 128 ? 2 : 1) + 32, 1)
gram_partial_tma(const __grid_constant__ CUtensorMap xmap, const int4* __restrict__ plan,
                 long long ntiles, float* __restrict__ partial) {
  constexpr int kWG = N == 128 ? 2 : 1;  // consumer warpgroups, 64 rows each
  constexpr int kBoxBytes = 64 * kWG * kTmaKT * 2;
  constexpr int kStages = kRingBytes / kBoxBytes;  // half of them with two boxes a stage
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  extern __shared__ uint8_t dyn[];  // kRingBytes + 1024, aligned below
  const uint32_t ring = (smem_u32(dyn) + 1023u) & ~1023u;
  const Unit u = cta_unit<kPairs>(plan, ntiles);
  const bool off = u.bi != u.bj;
  const uint32_t stage_bytes = off ? 2 * kBoxBytes : kBoxBytes;
  const int stages = kRingBytes / stage_bytes;
  ring_init(full, empty, stages, 4 * kWG);

  // warpgroup index, from lane 0 so that the compiler knows it is uniform
  // across the warp (else it serialises the wgmma instructions)
  const int wg = __shfl_sync(0xffffffff, threadIdx.x / 128, 0);
  if (wg == kWG) {
    if (threadIdx.x == 128 * kWG)
      ring_produce(&xmap, full, empty, ring, stages, kBoxBytes, u, kTmaKT, 64 * kWG);
    return;
  }

  // wgmma sums a run of kRun tiles in acc; sum adds the runs with ordinary
  // (round-to-nearest) float32 adds.  The tensor cores' own running sum
  // loses low bits with a bias; over a CTA's whole range (~8k columns on the
  // teacher) that bias exceeds 1e-5 of the largest entry.
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  float acc[N / 2], sum[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = sum[i] = 0.f;
  for (int i = 0, s = 0, ph = 0, prev = 0; i < u.n; ++i) {
    mbar_wait(smem_u32(&full[s]), ph);
    const uint32_t tile = ring + s * stage_bytes;
    const uint64_t da = sw128_desc(tile + wg * 64 * 128);
    const uint64_t db = sw128_desc(off ? tile + kBoxBytes : tile);
    fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < kTmaKT / 16; ++kk)  // 16 columns = 32 bytes = 2 units of 16
      wgmma_bf16<N>(acc, da + 2 * kk, db + 2 * kk, kk > 0 || i % kRun != 0);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    if (i % kRun == kRun - 1 || i == u.n - 1) {  // the run ends: fold it into sum
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_acc(acc);
#pragma unroll
      for (int j = 0; j < N / 2; ++j) sum[j] += acc[j];
    } else {
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");  // tile i-1 is read
      fence_acc(acc);
    }
    if (i > 0 && lane == 0) mbar_arrive(smem_u32(&empty[prev]));  // one release per warp
    prev = s;
    if (++s == stages) s = 0, ph ^= 1;
  }

  // accumulator layout of m64nN: sum[4j + 2h + e] is entry (row, 8j + 2·(lane % 4) + e),
  // row = 64·wg + 16·warp + lane / 4 + 8h.  Rows past Bp (N < 64) are zeros.
  float* out = partial + static_cast<long long>(blockIdx.x) * N * N;
  const int r = 64 * wg + 16 * warp + lane / 4;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int c = 8 * j + 2 * (lane % 4);
    if (r < N) *reinterpret_cast<float2*>(out + r * N + c) = make_float2(sum[4 * j], sum[4 * j + 1]);
    if (r + 8 < N)
      *reinterpret_cast<float2*>(out + (r + 8) * N + c) =
          make_float2(sum[4 * j + 2], sum[4 * j + 3]);
  }
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime's entry-point
// query so that the library needs no -lcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled tma_encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

constexpr int kEncodeError = 10000;  // + the CUresult of a failed encode

// A tensor map over the row-major (B, F) matrix at x, with elements of
// `elem_bytes` bytes (F·elem_bytes a multiple of 16, x 16-byte aligned), and
// a box of box_rows x box_cols; rows past B and columns past F read as zeros.
// `promotion`: how far past a box row L2 fetches (see kPairPromotion).
int encode_x(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes, const void* x, int B,
             long long F, int box_rows, int box_cols, CUtensorMapSwizzle swizzle,
             CUtensorMapL2promotion promotion) {
  const EncodeTiled encode = tma_encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(F), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(F) * elem_bytes};  // bytes
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map, type, 2, const_cast<void*>(x), dims, strides, box, elem,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, promotion,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);  // out of bounds: zeros
  return r == CUDA_SUCCESS ? 0 : kEncodeError + static_cast<int>(r);
}

// gram_partial_tma on `ctas` CTAs, over the units of `plan` (kPairs, N =
// 128) or, without one, an even split of F.
template <int N, bool kPairs>
int launch_tma(const void* x, int B, long long F, const int* plan, int ctas, float* partial,
               cudaStream_t s) {
  constexpr int kWG = N == 128 ? 2 : 1;
  constexpr int kSmem = kRingBytes + 1024;  // + room to align the ring to 1024 bytes
  cudaError_t err = cudaFuncSetAttribute(gram_partial_tma<N, kPairs>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap map;
  const int rc = encode_x(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, B, F, 64 * kWG, kTmaKT,
                          CU_TENSOR_MAP_SWIZZLE_128B,
                          kPairs ? kPairPromotion : CU_TENSOR_MAP_L2_PROMOTION_L2_256B);
  if (rc != 0) return rc;
  const long long ntiles = (F + kTmaKT - 1) / kTmaKT;
  gram_partial_tma<N, kPairs><<<ctas, 128 * kWG + 32, kSmem, s>>>(
      map, reinterpret_cast<const int4*>(plan), ntiles, partial);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// TMA ring + CUDA-core FMAs (float32)
// ---------------------------------------------------------------------------

constexpr int kF32MaxThreads = 512;  // at most 15 consumer warps, then the producer warp
constexpr int kMaxStages = 32;

// volatile: kept in order after the mbarrier wait that makes the tile valid
__device__ __forceinline__ float4 lds128(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr));
  return v;
}

// (bi, bj), bi >= bj: block k of the lower triangle of nb x nb blocks of
// 8 x 8 entries, the nb diagonal blocks first, then the others in row-major
// order.
__device__ __forceinline__ void tri_block(int k, int nb, int& bi, int& bj) {
  if (k < nb) {
    bi = bj = k;
    return;
  }
  k -= nb;
  bi = 1;
  while (k >= bi) k -= bi++;
  bj = k;
}

// acc[r][c] += the products over one 16-byte column group of the 8 rows at
// a_addr and the 8 rows at b_addr (kRowBytes apart).  kDiag: the two row
// sets are one, so b_addr is not read and only the entries c <= r are
// computed.
template <bool kDiag, int kRowBytes>
__device__ __forceinline__ void f32_step(float (&acc)[8][8], uint32_t a_addr, uint32_t b_addr) {
  float4 a[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) a[r] = lds128(a_addr + r * kRowBytes);
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float4 b = kDiag ? a[c] : lds128(b_addr + c * kRowBytes);
#pragma unroll
    for (int r = kDiag ? c : 0; r < 8; ++r) {
      acc[r][c] = fmaf(a[r].x, b.x, acc[r][c]);
      acc[r][c] = fmaf(a[r].y, b.y, acc[r][c]);
      acc[r][c] = fmaf(a[r].z, b.z, acc[r][c]);
      acc[r][c] = fmaf(a[r].w, b.w, acc[r][c]);
    }
  }
}

// Persistent CTA `blockIdx.x`: partial[cta] = the 8 x 8 blocks of the
// products of its unit's tiles (cta_unit; Bp rows of kCG 16-byte column
// groups per box) that gram_reduce reads.  A diagonal unit computes the
// lower triangle of the Gram of its box: not the upper blocks, nor, in
// diagonal blocks, the entries above the diagonal.  An off-diagonal pair
// (Bp = 128) computes all 16 x 16 blocks of its two boxes.
// Threads: consumer warps, then one producer warp.  Diagonal unit: consumer
// thread t owns block t / groups of the triangle (threads past the last
// block idle) and, in every tile, the column groups ≡ t (mod groups).  The
// diagonal blocks come first, so they fill whole warps, and those warps
// take f32_step's diagonal path: half the loads and 36 of 64 entries.
// Warps 0 and 1, on the two schedulers that also get a 4th consumer warp at
// Bp = 80, are such.  Off-diagonal pair: thread t owns block (t / 16,
// t % 16) of box bi against box bj, alone (two threads a block would exceed
// kF32MaxThreads).  Its tile is twice a diagonal one's FMAs and its pair has
// twice the stride, so the CTAs' work per tile-step is balanced in FMAs as
// the bf16 kernel's is in bytes.
template <int kCG, bool kPairs>
__global__ void __launch_bounds__(kF32MaxThreads, 1)
gram_partial_f32_tma(const __grid_constant__ CUtensorMap xmap, const int4* __restrict__ plan,
                     int Bp, int groups, long long ntiles, float* __restrict__ partial) {
  constexpr int kRowBytes = 16 * kCG;
  __shared__ __align__(8) uint64_t full[kMaxStages], empty[kMaxStages];
  extern __shared__ uint8_t dyn[];  // the ring + 1024, aligned below
  const uint32_t ring = (smem_u32(dyn) + 1023u) & ~1023u;
  const Unit u = cta_unit<kPairs>(plan, ntiles);
  const bool off = u.bi != u.bj;
  const uint32_t box_bytes = Bp * kRowBytes, stage_bytes = off ? 2 * box_bytes : box_bytes;
  const int stages = min(kMaxStages, static_cast<int>(kRingBytes / stage_bytes));
  const int consumers = blockDim.x / 32 - 1;  // warps
  ring_init(full, empty, stages, consumers);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == consumers) {
    if (lane == 0) ring_produce(&xmap, full, empty, ring, stages, box_bytes, u, 4 * kCG, Bp);
    return;
  }

  const int nb = Bp / 8;
  if (off) groups = 1;
  const int k = threadIdx.x / groups;
  const bool active = k < (off ? nb * nb : nb * (nb + 1) / 2);
  int bi = 0, bj = 0;
  if (active) {
    if (off)
      bi = k / nb, bj = k % nb;
    else
      tri_block(k, nb, bi, bj);
  }
  // uniform across the warp (idle lanes hold (0, 0)), so no lane diverges
  const bool diag = !off && __all_sync(0xffffffffu, bi == bj);
  const uint32_t a_off = 8 * bi * kRowBytes, b_off = (off ? box_bytes : 0) + 8 * bj * kRowBytes;
  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;

  for (int i = 0, s = 0, ph = 0; i < u.n; ++i) {
    mbar_wait(smem_u32(&full[s]), ph);
    if (active) {
      const uint32_t tile = ring + s * stage_bytes;
      for (int q = lane; q < lane + kCG; q += groups) {
        const uint32_t col = 16 * (q & (kCG - 1));
        if (diag)
          f32_step<true, kRowBytes>(acc, tile + a_off + col, 0);
        else
          f32_step<false, kRowBytes>(acc, tile + a_off + col, tile + b_off + col);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_u32(&empty[s]));
    if (++s == stages) s = 0, ph ^= 1;
  }

  // the block's groups are neighbouring lanes: a butterfly adds their sums
  // in the same order on every run
  for (int o = groups / 2; o > 0; o /= 2)
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] += __shfl_xor_sync(0xffffffffu, acc[r][c], o);
  if (active && threadIdx.x % groups == 0) {
    float* out = partial + static_cast<long long>(blockIdx.x) * Bp * Bp + 8 * bi * Bp + 8 * bj;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      *reinterpret_cast<float4*>(out + r * Bp) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      *reinterpret_cast<float4*>(out + r * Bp + 4) =
          make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
    }
  }
}

// gram_partial_f32_tma on `ctas` CTAs, over the units of `plan` (kPairs: Bp
// = 128, kCG = 16, so 64-column tiles) or, without one, an even split of F.
template <int kCG, bool kPairs>
int launch_f32_tma(const void* x, int B, long long F, int Bp, int groups, const int* plan,
                   int ctas, float* partial, cudaStream_t s) {
  const int nb = Bp / 8;
  const int consumers = max(kPairs ? nb * nb : 0, nb * (nb + 1) / 2 * groups);
  const int threads = 32 * ((consumers + 31) / 32 + 1);
  const int box_bytes = Bp * 16 * kCG;
  const int smem = min(kMaxStages, kRingBytes / box_bytes) * box_bytes + 1024;  // + alignment
  if (threads > kF32MaxThreads) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(gram_partial_f32_tma<kCG, kPairs>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap map;
  const int rc = encode_x(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, x, B, F, Bp, 4 * kCG,
                          CU_TENSOR_MAP_SWIZZLE_NONE,
                          kPairs ? kPairPromotion : CU_TENSOR_MAP_L2_PROMOTION_L2_256B);
  if (rc != 0) return rc;
  const long long ntiles = (F + 4 * kCG - 1) / (4 * kCG);
  gram_partial_f32_tma<kCG, kPairs><<<ctas, threads, smem, s>>>(
      map, reinterpret_cast<const int4*>(plan), Bp, groups, ntiles, partial);
  return static_cast<int>(cudaGetLastError());
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
  gram_reduce<<<(B * B + 31) / 32, kThreads, 0, s>>>(p, nchunks, nullptr, B, Bp, 0,
                                                     static_cast<float*>(g));
  return static_cast<int>(cudaGetLastError());
}

// x: (B, F) bf16, contiguous, F % 8 == 0, 16-byte aligned.  B <= 128:
// plan null, ctas one per SM, partial ctas * Bp * Bp floats, Bp as for
// cat_gram_bf16.  B > 128: plan int32 on the device, `ctas` rows of (bi, bj,
// first tile, tile stride), then the n(n+1)/2 + 1 starts of the pairs' rows
// (distill/ka.py::_pair_plan), and partial ctas * 128 * 128 floats.  g: (B,
// B) floats, exactly symmetric past 128 rows.  Returns a CUDA error code, or
// 10000 + the CUresult of a failed tensor-map encode.
int cat_gram_bf16_tma(const void* x, int B, long long F, const void* plan, int ctas,
                      void* partial, void* g, void* stream) {
  const auto* pl = static_cast<const int*>(plan);
  if (B < 1 || ctas < 1 || (pl != nullptr) != (B > kMaxB))
    return static_cast<int>(cudaErrorInvalidValue);
  const int Bp = B <= 16 ? 16 : B <= 32 ? 32 : B <= 64 ? 64 : 128;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partial);
  int rc;
  switch (Bp) {
    case 16: rc = launch_tma<16, false>(x, B, F, nullptr, ctas, p, s); break;
    case 32: rc = launch_tma<32, false>(x, B, F, nullptr, ctas, p, s); break;
    case 64: rc = launch_tma<64, false>(x, B, F, nullptr, ctas, p, s); break;
    default:
      rc = pl != nullptr ? launch_tma<128, true>(x, B, F, pl, ctas, p, s)
                         : launch_tma<128, false>(x, B, F, nullptr, ctas, p, s);
  }
  if (rc != 0) return rc;
  const long long entries = static_cast<long long>(B) * B;
  gram_reduce<<<static_cast<unsigned>((entries + 31) / 32), kThreads, 0, s>>>(
      p, ctas, pl != nullptr ? pl + 4 * ctas : nullptr, B, Bp, pl != nullptr,
      static_cast<float*>(g));
  return static_cast<int>(cudaGetLastError());
}

// x: (B, F) float32, contiguous, F % 4 == 0, 16-byte aligned.  Bp: B rounded
// up to a multiple of 8, or 128 with a plan.  groups: threads per 8 x 8
// block of the triangle (of a diagonal pair's, with a plan), 1, 2, 4, 8, 16
// or 32 (32 takes 128-column tiles, the others 64), with at most 480
// consumer threads.  plan and ctas as for cat_gram_bf16_tma.  partial: ctas
// * Bp * Bp floats.  g: (B, B) floats, exactly symmetric.  Returns a CUDA
// error code, or 10000 + the CUresult of a failed tensor-map encode.
int cat_gram_f32_tma(const void* x, int B, long long F, int Bp, int groups, const void* plan,
                     int ctas, void* partial, void* g, void* stream) {
  const auto* pl = static_cast<const int*>(plan);
  const bool rows_ok = pl != nullptr ? B > kMaxB && Bp == kMaxB : B <= Bp && Bp <= kMaxB;
  if (B < 1 || !rows_ok || Bp % 8 != 0 || groups < 1 || 32 % groups != 0 || ctas < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partial);
  const int rc = pl != nullptr ? launch_f32_tma<16, true>(x, B, F, Bp, groups, pl, ctas, p, s)
                 : groups == 32 ? launch_f32_tma<32, false>(x, B, F, Bp, groups, pl, ctas, p, s)
                                : launch_f32_tma<16, false>(x, B, F, Bp, groups, pl, ctas, p, s);
  if (rc != 0) return rc;
  const long long entries = static_cast<long long>(B) * B;
  gram_reduce<<<static_cast<unsigned>((entries + 31) / 32), kThreads, 0, s>>>(
      p, ctas, pl != nullptr ? pl + 4 * ctas : nullptr, B, Bp, 1, static_cast<float*>(g));
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
                                                     nchunks, nullptr, B, B, 0,
                                                     static_cast<float*>(g));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
