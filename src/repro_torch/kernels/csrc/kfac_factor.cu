// Blocked K-FAC factor sum: A[k] = X_k^T X_k for every diagonal block k of
// a token matrix, f32 sums from bf16 or f32 inputs; and the same sum with
// the fp8 wire epilogue (factor_syrk_wire).
//
// Replaces the TPU kernel repro/kernels/kfac_factor.py::factor_syrk
// (_factor_kernel) with its wrapper repro/kernels/ops.py kfac_factor and
// the per-block vmap of repro/kernels/dispatch.py _factor_sum_pallas; and
// the TPU kernel ::factor_syrk_wire (_factor_wire_kernel, wrapper
// ops.kfac_factor_wire, dispatch _factor_sum_wire_pallas).
//
//   x   (n, ld) row-major, the first d columns hold the features; block k
//       covers columns [k*b, k*b + b), the last one ragged
//   out (nb, b, b) f32, out[k] = sum_t x[t, kb:kb+b]^T x[t, kb:kb+b]
//
// All blocks of a site run in one launch (grid.y = block). Each block of
// threads owns one 64 x 64 output tile with tile row <= tile column (the
// upper triangle of tiles, grid.x enumerates those pairs) and walks the n
// tokens 16 at a time; it writes its tile and, off the diagonal, the
// mirrored tile, so out comes back whole. Token rows past n and the zero
// columns past d of the last block are masked on load: nothing is padded
// or copied (the TPU wrapper pads x and the dispatch moves the block axis).
//
// factor_syrk_wire: the TPU kernel keeps the (b, b) f32 sum in VMEM and
// quantizes it in its last grid step; a b <= 1024 block (4 MB) does not fit
// one SM's 227 KB. Here the same tile kernel writes the f32 sums to a
// scratch (nb, b, b) that stays in L2 at the path's b 512, and its epilogue
// atomicMax-es each tile's max |A| into the block's amax. A second launch
// reads the lower triangle row by row from the scratch and writes the
// sym-packed fp8 payload (nb, b(b+1)/2) and one scale per block, with the
// arithmetic of fp8_quant.cuh (that of quant_rows). A ragged b is masked.
//
// Bound: n*b*(b+1) operations per block against n*d input elements and
// nb*b*b f32 outputs (the wire variant: nb*b(b+1)/2 fp8 bytes and nb
// scales); at the training path's shapes (n 4096, b 512 or 2048) that is
// far above the H100's bytes/operation ratio, so the ideal kernel is bound
// by operations. This one runs its products on the f32 CUDA cores (exact
// for bf16 inputs), not the tensor cores: that is what limits it.

#include "fp8_quant.cuh"
#include "simt_tile.cuh"

namespace {

using simt::BK;
using simt::NT;
using simt::TILE;

template <typename T>
__global__ void __launch_bounds__(NT)
factor_syrk_kernel(const T* __restrict__ x, float* __restrict__ out, unsigned* __restrict__ amax,
                   int n, int ld, int d, int b, int tiles) {
  // decode the upper-triangle tile pair (ti <= tj) of blockIdx.x
  int ti = 0;
  int rem = blockIdx.x;
  while (rem >= tiles - ti) {
    rem -= tiles - ti;
    ++ti;
  }
  const int tj = ti + rem;
  const int blk = blockIdx.y;
  const int col0 = blk * b;
  const int valid = min(b, d - col0);   // columns of this block holding data
  const int i0 = ti * TILE;
  const int j0 = tj * TILE;

  __shared__ __align__(16) simt::Smem sm;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int lr = tid / 16;         // token row of the slice this thread loads
  const int lc = (tid % 16) * 4;   // first of its 4 feature columns

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  for (int t0 = 0; t0 < n; t0 += BK) {
    const int t = t0 + lr;
    float av[4], bv[4];
    const T* row = x + (size_t)t * ld + col0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ci = i0 + lc + e;
      const int cj = j0 + lc + e;
      av[e] = (t < n && ci < valid) ? to_f32(row[ci]) : 0.f;
      bv[e] = (t < n && cj < valid) ? to_f32(row[cj]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sm.a[lr][lc + e] = av[e];
      sm.b[lr][lc + e] = bv[e];
    }
    __syncthreads();
    simt::tile_fma(sm, acc, ty, tx);
  }

  float* o = out + (size_t)blk * b * b;
  unsigned m = 0u;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty * 4 + r;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = j0 + tx * 4 + c;
      if (i < b && j < b) {
        o[(size_t)i * b + j] = acc[r][c];
        if (ti != tj) o[(size_t)j * b + i] = acc[r][c];
        m = max(m, fp8q::abs_bits(acc[r][c]));
      }
    }
  }
  if (amax) {
    m = __reduce_max_sync(0xffffffffu, m);
    if (tid % 32 == 0 && m) atomicMax(amax + blk, m);
  }
}

// sym-pack + quantize each block of f (nb, b, b) f32: warp w of block of
// threads bx handles row r = 8 bx + w, packed positions tri(r) + c for
// c <= r, reading f[k][r][c] (the lower triangle; f is symmetric)
__global__ void __launch_bounds__(256)
pack_quant_kernel(const float* __restrict__ f, unsigned char* __restrict__ payload,
                  float* __restrict__ scale, const unsigned* __restrict__ amax, int b, int fmt,
                  int pow2, float inv_max) {
  const int blk = blockIdx.y;
  const int r = blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const float s = fp8q::scale_of(__uint_as_float(amax[blk]), inv_max, pow2);
  if (blockIdx.x == 0 && threadIdx.x == 0) scale[blk] = s;
  if (r >= b) return;
  const float fmax = fp8q::fmt_max(fmt);
  const long long t = (long long)b * (b + 1) / 2;
  const float* row = f + ((size_t)blk * b + r) * b;
  unsigned char* out = payload + blk * t + (long long)r * (r + 1) / 2;
  for (int c = lane; c <= r; c += 32) out[c] = fp8q::quant_one(row[c], s, fmax, fmt);
}

template <typename T>
void launch(const void* x, void* out, unsigned* amax, int n, int ld, int d, int nb, int b,
            cudaStream_t stream) {
  const int tiles = (b + TILE - 1) / TILE;
  const dim3 grid(tiles * (tiles + 1) / 2, nb);
  factor_syrk_kernel<T><<<grid, NT, 0, stream>>>(static_cast<const T*>(x),
                                                 static_cast<float*>(out), amax, n, ld, d, b,
                                                 tiles);
}

int launch_syrk(const void* x, void* out, unsigned* amax, int n, int ld, int d, int nb, int b,
                int dtype, cudaStream_t st) {
  if (nb < 1 || b < 1 || (long long)(nb - 1) * b >= d || (long long)nb * b < d || ld < d)
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case DT_F32:
      launch<float>(x, out, amax, n, ld, d, nb, b, st);
      break;
    case DT_BF16:
      launch<__nv_bfloat16>(x, out, amax, n, ld, d, nb, b, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int factor_syrk(const void* x, void* out, int n, int ld, int d, int nb, int b,
                           int dtype, void* stream) {
  return launch_syrk(x, out, nullptr, n, ld, d, nb, b, dtype, static_cast<cudaStream_t>(stream));
}

// scratch (nb, b, b) f32 and amax (nb,) u32 are the caller's; amax is
// zeroed here. payload (nb, b(b+1)/2) fp8, scale (nb,) f32.
extern "C" int factor_syrk_wire(const void* x, void* scratch, void* amax, void* payload,
                                void* scale, int n, int ld, int d, int nb, int b, int dtype,
                                int fmt, int pow2, float inv_max, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fmt != DT_E4M3 && fmt != DT_E5M2) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaMemsetAsync(amax, 0, (size_t)nb * sizeof(unsigned), st);
  if (e != cudaSuccess) return (int)e;
  const int rc = launch_syrk(x, scratch, static_cast<unsigned*>(amax), n, ld, d, nb, b, dtype, st);
  if (rc) return rc;
  const dim3 grid((b + 7) / 8, nb);
  pack_quant_kernel<<<grid, 256, 0, st>>>(
      static_cast<const float*>(scratch), static_cast<unsigned char*>(payload),
      static_cast<float*>(scale), static_cast<const unsigned*>(amax), b, fmt, pow2, inv_max);
  return (int)cudaGetLastError();
}
