// The f32 CUDA-core tile product shared by the K-FAC kernels: a 64 x 64
// output tile per block of 256 threads, each thread a 4 x 4 patch, the
// operands staged through shared memory 16 deep along the contraction.
//
// The caller fills, for each 16-deep slice, As[k][m] (64 rows of the left
// operand) and Bs[k][n] (64 columns of the right one) as f32, then calls
// tile_fma to add the slice's products into acc. Masked (out-of-range)
// operand entries are stored as 0, so ragged edges need no padding.
#pragma once

#include "common.cuh"

namespace simt {

constexpr int TILE = 64;      // output tile edge
constexpr int BK = 16;        // contraction depth per shared-memory slice
constexpr int NT = 256;       // threads per block (16 x 16, 4 x 4 each)
constexpr int PAD = 4;        // keeps rows 16-byte aligned, spreads banks

struct Smem {
  float a[BK][TILE + PAD];
  float b[BK][TILE + PAD];
};

// acc[r][c] += sum_k As[k][ty*4 + r] * Bs[k][tx*4 + c]
__device__ __forceinline__ void tile_fma(const Smem& sm, float (&acc)[4][4], int ty,
                                         int tx) {
#pragma unroll
  for (int k = 0; k < BK; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(&sm.a[k][ty * 4]);
    const float4 b = *reinterpret_cast<const float4*>(&sm.b[k][tx * 4]);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
  }
}

}  // namespace simt
