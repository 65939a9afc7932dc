// Shared helpers of the attention kernels: element conversions and the
// dtype codes the Python wrappers pass through the plain C interface.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <stdint.h>

// Finite on purpose (as in the JAX package): exp(m_prev - m_new) never
// becomes exp(-inf + inf) while a row has seen no visible key yet.
#define REPRO_NEG_INF (-1e30f)
// Scores below this are masked entries.
#define REPRO_MASKED (-5e29f)

// dtype codes; kernels/build.py DTYPE_CODES holds the same table
enum DTypeCode { DT_F32 = 0, DT_BF16 = 1, DT_E4M3 = 2, DT_E5M2 = 3 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_f32(__nv_fp8_e5m2 x) { return static_cast<float>(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
