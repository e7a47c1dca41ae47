// Direct int8 convolution over NCHW with an int32 accumulator, for the
// grouped (depthwise) convs of the int8 frozen teacher:
//   acc[n, o, ho, wo] = Σ_{c < Cin/G, i, j} x[n, g·Cin/G + c, ho·sh - ph + i·dh,
//                                              wo·sw - pw + j·dw] · w[o, c, i, j],
//   g = o / (O/G),
// zero outside the input.  The store writes acc itself (int32) or, fused,
// float(acc) · scale[o] in float32, optionally cast to bf16: the
// dequantisation acc · (qx · qw[o]) of cat_tpu_torch/ops/quant.py, whose
// plain version it equals bit for bit (int32 -> float rounds to nearest, one
// float32 multiply, round-to-nearest-even to bf16).
//
// Replaces no TPU kernel: the JAX package hands its int8 convs to XLA
// (cat_tpu/ops/quant.py:85-86, lax.conv_general_dilated with
// preferred_element_type=int32).  The port's groups == 1 convs go to
// torch._int_mm over an im2col; a grouped conv there would be one product a
// group (256 launches for a depthwise conv over 256 channels), so the
// grouped ones come here, one launch a conv.
//
// Bound on an H100: a depthwise conv does k² multiply-adds per output
// against one byte read per input value and 2-4 bytes written per output,
// so bytes bound it (the outputs' write dominates).  The design is simple
// and right first: one thread per output value, CTAs of 256 threads over
// one (n, o) plane's outputs, so neighbouring threads read neighbouring
// input bytes (coalesced for stride 1) and the same kernel bytes (an L1
// broadcast).  A tiled version (input rows staged in shared memory, 4
// outputs a thread, dp4a for Cin/G >= 4) is later work.
//
// Limits (checked by the Python wrapper): x, w int8 contiguous; y
// contiguous of the output's shape; scale float32 (O,) unless y is int32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void store(int32_t* y, int acc, float) { *y = acc; }
__device__ __forceinline__ void store(float* y, int acc, float s) {
  *y = __fmul_rn(__int2float_rn(acc), s);
}
__device__ __forceinline__ void store(__nv_bfloat16* y, int acc, float s) {
  *y = __float2bfloat16_rn(__fmul_rn(__int2float_rn(acc), s));
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads)
int8_conv_direct(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                 OutT* __restrict__ y, const float* __restrict__ scale, int C, int H, int W,
                 int O, int Ho, int Wo, int KH, int KW, int sh, int sw, int ph, int pw, int dh,
                 int dw, int cin_g, int cout_g, int tiles) {
  const long long plane = blockIdx.x / tiles;  // n · O + o
  const int p = (blockIdx.x % tiles) * kThreads + threadIdx.x;
  if (p >= Ho * Wo) return;
  const int o = static_cast<int>(plane % O);
  const long long n = plane / O;
  const int g = o / cout_g;
  const int ho = p / Wo, wo = p % Wo;
  const int h0 = ho * sh - ph, w0 = wo * sw - pw;
  const long long hw = static_cast<long long>(H) * W;
  const int8_t* xb = x + (n * C + static_cast<long long>(g) * cin_g) * hw;
  const int8_t* wb = w + static_cast<long long>(o) * cin_g * KH * KW;
  int acc = 0;
  for (int c = 0; c < cin_g; ++c) {
    const int8_t* xc = xb + c * hw;
    const int8_t* wc = wb + c * KH * KW;
    for (int i = 0; i < KH; ++i) {
      const int hi = h0 + i * dh;
      if (hi < 0 || hi >= H) continue;
      const int8_t* xr = xc + static_cast<long long>(hi) * W;
      for (int j = 0; j < KW; ++j) {
        const int wi = w0 + j * dw;
        if (wi >= 0 && wi < W)
          acc += static_cast<int>(xr[wi]) * static_cast<int>(__ldg(wc + i * KW + j));
      }
    }
  }
  store(y + plane * Ho * Wo + p, acc, scale == nullptr ? 0.f : __ldg(scale + o));
}

template <typename OutT>
int launch(const void* x, const void* w, void* y, const void* scale, int N, int C, int H, int W,
           int O, int Ho, int Wo, int KH, int KW, int sh, int sw, int ph, int pw, int dh, int dw,
           int groups, cudaStream_t stream) {
  const int tiles = (Ho * Wo + kThreads - 1) / kThreads;
  const long long blocks = static_cast<long long>(N) * O * tiles;
  if (blocks <= 0 || blocks > 2147483647LL || groups <= 0 || C % groups || O % groups)
    return cudaErrorInvalidConfiguration;
  int8_conv_direct<OutT><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), static_cast<OutT*>(y),
      static_cast<const float*>(scale), C, H, W, O, Ho, Wo, KH, KW, sh, sw, ph, pw, dh, dw,
      C / groups, O / groups, tiles);
  return cudaGetLastError();
}

}  // namespace

// out_kind: 0 int32 accumulator, 1 float32, 2 bfloat16 (dequantised by scale).
extern "C" int cat_int8_conv(const void* x, const void* w, void* y, const void* scale,
                             int out_kind, int N, int C, int H, int W, int O, int Ho, int Wo,
                             int KH, int KW, int sh, int sw, int ph, int pw, int dh, int dw,
                             int groups, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (out_kind) {
    case 0:
      return launch<int32_t>(x, w, y, nullptr, N, C, H, W, O, Ho, Wo, KH, KW, sh, sw, ph, pw,
                             dh, dw, groups, s);
    case 1:
      return launch<float>(x, w, y, scale, N, C, H, W, O, Ho, Wo, KH, KW, sh, sw, ph, pw, dh,
                           dw, groups, s);
    case 2:
      return launch<__nv_bfloat16>(x, w, y, scale, N, C, H, W, O, Ho, Wo, KH, KW, sh, sw, ph,
                                   pw, dh, dw, groups, s);
    default:
      return cudaErrorInvalidValue;
  }
}
