// The fp8 quantization arithmetic shared by quant_pack.cu (quant_rows) and
// kfac_factor.cu (factor_syrk_wire): one scale per row or block, the JAX
// package's ref arithmetic step for step (repro/quant/quant.py
// compute_scale and quantize_rows), so payloads and scales are bit-identical
// to the plain PyTorch versions.
//
//   s = amax * inv_max       inv_max is the f32 value of 1/FMT_MAX, passed
//                            from Python: no reciprocal is computed here
//   pow2: s rounded UP to a power of two from its exponent bits (exact;
//         log2f/exp2f are not correctly rounded on the GPU)
//   amax == 0 (or NaN) -> s = 1
//   q = x / s                IEEE division (the build has no fast math)
//   clip to +-FMT_MAX (NaN stays NaN, as torch.clamp), then round to
//   nearest even into e4m3fn / e5m2
//
// amax travels between blocks as the bits of |x|: for non-negative floats
// the unsigned order is the float order (NaN above inf), so atomicMax on
// the bits is a max that keeps a NaN, as torch's amax does.
#pragma once

#include "common.cuh"

namespace fp8q {

constexpr float kMinNormal = 1.17549435082228750797e-38f;  // 2^-126

__device__ __forceinline__ float fmt_max(int fmt) {
  return fmt == DT_E4M3 ? 448.f : 57344.f;
}

__device__ __forceinline__ float scale_of(float amax, float inv_max, int pow2) {
  float s = amax * inv_max;
  if (pow2) {
    s = s < kMinNormal ? kMinNormal : s;
    unsigned bits = __float_as_uint(s);
    if (bits & 0x7FFFFFu) bits = (bits & 0xFF800000u) + 0x800000u;
    s = __uint_as_float(bits);
  }
  return amax > 0.f ? s : 1.f;
}

__device__ __forceinline__ unsigned char quant_one(float x, float s, float fmax, int fmt) {
  float q = x / s;
  q = q < -fmax ? -fmax : (q > fmax ? fmax : q);
  return (unsigned char)__nv_cvt_float_to_fp8(q, __NV_SATFINITE,
                                              fmt == DT_E4M3 ? __NV_E4M3 : __NV_E5M2);
}

// dequantize: fp8 -> f16 (exact for both formats), f16 -> f32 (exact),
// one f32 product: the plain version's payload.f32 * scale, bit for bit.
// Two codes a cvt (cvt.rn.f16x2.e4m3x2 / .e5m2x2): the low byte of the
// pair is .x
template <int FMT>
__device__ __forceinline__ float2 dequant_pair(unsigned short pair, float s) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(pair, FMT == DT_E4M3 ? __NV_E4M3 : __NV_E5M2);
  const float2 f = __half22float2(__half2(h));
  return make_float2(f.x * s, f.y * s);
}

template <int FMT>
__device__ __forceinline__ float dequant_one(unsigned char p, float s) {
  return dequant_pair<FMT>(p, s).x;
}

// bits of |x|, for the amax max
__device__ __forceinline__ unsigned abs_bits(float x) { return __float_as_uint(x) & 0x7FFFFFFFu; }

// max over the block of each thread's v; the result is valid in thread 0.
// Needs blockDim.x a multiple of 32, at most 1024.
__device__ __forceinline__ unsigned block_max(unsigned v) {
  __shared__ unsigned part[32];
  v = __reduce_max_sync(0xffffffffu, v);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) part[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x / 32) ? part[lane] : 0u;
    v = __reduce_max_sync(0xffffffffu, v);
  }
  return v;
}

}  // namespace fp8q
