// Blocked preconditioner application, f32 throughout (no TF32).
//
// Replaces the TPU kernel repro/kernels/kfac_precond.py::block_precond
// (_precond_kernel) with its wrapper repro/kernels/ops.py
// kfac_block_precond, and the transposes through which
// repro/kernels/dispatch.py _precond_right_pallas reuses it from the right.
//
//   binv (nb, b, b) f32 contiguous, the inverse of each diagonal block
//   left mode  (A^-1 dW):  w (dim, other), rows in blocks of b, row stride ldw
//                          out[kb + r, :] = sum_c binv[k, r, c] * w[kb + c, :]
//   right mode (dW G^-1):  w (other, dim), columns in blocks of b
//                          out[:, kb + p] = sum_c w[:, kb + c] * binv[k, c, p]
//   out has w's shape, contiguous (row stride ldo)
//
// One launch covers every block (grid.z). Each block of threads owns a
// 64 x 64 output tile and walks the contraction 16 deep through shared
// memory; both modes read w in place through its row stride, so the right
// mode needs no transpose. The ragged last block (dim not a multiple of b)
// is masked on load and store instead of padding w to nb*b and b to
// lcm(bm, bk) as the TPU wrapper does.
//
// Bound: 2*dim*b*other operations on dim*other + nb*b*b f32 inputs and
// dim*other f32 outputs; at the training path's shapes (b 2048, other 512
// to 128256) far above the bytes/operation ratio of the card, so bound by
// f32 operations (67 TFLOP/s). The products run on the CUDA cores with
// fmaf: TF32 would lose the 1e-4 agreement the preconditioning is held to.

#include "simt_tile.cuh"

namespace {

using simt::BK;
using simt::NT;
using simt::TILE;

__global__ void __launch_bounds__(NT)
block_precond_kernel(const float* __restrict__ binv, const float* __restrict__ w,
                     float* __restrict__ out, int b, int dim, int other, int ldw, int ldo,
                     int right) {
  const int blk = blockIdx.z;
  const int valid = min(b, dim - blk * b);   // rows/columns of w in this block
  const float* A;
  const float* B;
  float* C;
  int lda, ldb, m_lim, n_lim;
  if (!right) {                 // C[b x other] = binv[k] @ w[kb:kb+valid, :]
    A = binv + (size_t)blk * b * b;
    lda = b;
    B = w + (size_t)blk * b * ldw;
    ldb = ldw;
    C = out + (size_t)blk * b * ldo;
    m_lim = valid;
    n_lim = other;
  } else {                      // C[other x b] = w[:, kb:kb+valid] @ binv[k]
    A = w + (size_t)blk * b;
    lda = ldw;
    B = binv + (size_t)blk * b * b;
    ldb = b;
    C = out + (size_t)blk * b;
    m_lim = other;
    n_lim = valid;
  }
  const int k_lim = valid;
  const int row0 = blockIdx.y * TILE;
  const int col0 = blockIdx.x * TILE;
  if (row0 >= m_lim || col0 >= n_lim) return;   // uniform over the block

  __shared__ __align__(16) simt::Smem sm;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  // A slice (64 rows x 16 deep, contiguous along the depth): 4 per thread
  const int ar = tid / 4;
  const int ak = (tid % 4) * 4;
  // B slice (16 deep x 64 columns, contiguous along the columns)
  const int br = tid / 16;
  const int bc = (tid % 16) * 4;

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  for (int k0 = 0; k0 < k_lim; k0 += BK) {
    float av[4], bv[4];
    const int arow = row0 + ar;
    const int bk = k0 + br;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ak_e = k0 + ak + e;
      av[e] = (arow < m_lim && ak_e < k_lim) ? A[(size_t)arow * lda + ak_e] : 0.f;
      const int bcol = col0 + bc + e;
      bv[e] = (bk < k_lim && bcol < n_lim) ? B[(size_t)bk * ldb + bcol] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sm.a[ak + e][ar] = av[e];
      sm.b[br][bc + e] = bv[e];
    }
    __syncthreads();
    simt::tile_fma(sm, acc, ty, tx);
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = row0 + ty * 4 + r;
    if (i >= m_lim) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = col0 + tx * 4 + c;
      if (j < n_lim) C[(size_t)i * ldo + j] = acc[r][c];
    }
  }
}

}  // namespace

extern "C" int block_precond(const void* binv, const void* w, void* out, int b, int dim,
                             int other, int ldw, int ldo, int nb, int right,
                             void* stream) {
  if (nb < 1 || b < 1 || (long long)(nb - 1) * b >= dim || (long long)nb * b < dim)
    return (int)cudaErrorInvalidValue;
  const int rows = right ? other : b;
  const int cols = right ? b : other;
  const dim3 grid((cols + TILE - 1) / TILE, (rows + TILE - 1) / TILE, nb);
  if (grid.y > 65535u || nb > 65535) return (int)cudaErrorInvalidValue;
  block_precond_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(binv), static_cast<const float*>(w),
      static_cast<float*>(out), b, dim, other, ldw, ldo, right);
  return (int)cudaGetLastError();
}
