// Fused instance norm + affine + activation over NCHW planes:
//   for each (n, c): mean = E[x], var = E[x²] - mean² (float32, over H×W),
//   y = (x - mean) · rsqrt(var + eps) · scale[c] + bias[c], then relu,
//   leaky relu (slope 0.01) or nothing; y has x's dtype.
//
// Replaces: cat_tpu/ops/pallas_norm.py::_kernel, launched by
// instance_norm_act_pallas (the TPU Pallas kernel).  Written in CUDA C++.
// The TPU kernel is NHWC with a grid over (sample, channel tile) and keeps
// a whole (H, W, ctile) slab in VMEM; its channel tiling (_channel_tile)
// and its XLA fallback for planes that do not fit VMEM do not carry over.
// Here the input is NCHW-contiguous, so each (n, c) plane is one contiguous
// run of H·W values, and one CTA normalises one plane of any size: the
// 256² stem as well as the 64² bottleneck.
//
// Bound on an H100: bytes.  A plane is read for Σx and Σx², then read again
// to normalise and written once: ~10 flops per element against 4 (bf16) or
// 8 (f32) bytes moved.  The least traffic is one read and one write of the
// tensor (2·N·C·H·W·sizeof(T) bytes at 3.35 TB/s).  The second read of a
// plane hits the 50 MB L2 when the planes in flight at once fit there (a
// 64² bf16 plane is 8 KB); a 256² plane is 128 KB, about a thousand of them
// are in flight, and their second read goes back to HBM.  Keeping large
// planes on chip between the passes is later work.  Loads and stores are
// 16 bytes wide when the plane allows it, and the loops are unrolled by 4 so
// that each thread has several loads in flight.  Statistics keep the formula
// E[x²] - mean² (not Welford) to match the JAX package.
//
// Limits (checked by the Python wrapper): x contiguous NCHW, bf16 or f32;
// scale and bias float32 (C,).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
inorm_act(const T* __restrict__ x, const float* __restrict__ scale,
          const float* __restrict__ bias, T* __restrict__ y, int C, long long HW,
          float eps, int act, int vec) {
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

}  // namespace

extern "C" {

// x, y: (N, C, H, W) contiguous; scale, bias: (C,) float32.  act: 0 none,
// 1 relu, 2 leaky relu (0.01).  vec: HW and both pointers allow 16-byte
// accesses.
int cat_inorm_act_bf16(const void* x, const void* scale, const void* bias, void* y,
                       int N, int C, long long HW, float eps, int act, int vec,
                       void* stream) {
  inorm_act<__nv_bfloat16><<<N * C, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(y), C, HW, eps, act, vec);
  return static_cast<int>(cudaGetLastError());
}

int cat_inorm_act_f32(const void* x, const void* scale, const void* bias, void* y,
                      int N, int C, long long HW, float eps, int act, int vec,
                      void* stream) {
  inorm_act<float><<<N * C, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<float*>(y), C, HW, eps, act, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
