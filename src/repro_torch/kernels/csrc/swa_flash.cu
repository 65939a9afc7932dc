// Causal(-window) attention forward in the (BH, S, hd) layout, heads
// flattened into the batch axis (a GQA caller repeats KV first).
//
// Replaces the TPU kernel repro/kernels/swa_attention.py::swa_flash
// (_swa_kernel; src/repro/kernels/swa_attention.py:104) and its wrapper
// repro/kernels/ops.py swa_attention, which pads S to lcm(bq, bk) and
// slices the result back. Here the ragged edge is masked in the kernel, so
// the wrapper pads nothing and the result is the same.
//
//   q, k, v (BH, S, HD)  bf16 | f32
//   out     (BH, S, HD)  q's dtype
//
// Key j is visible to query i iff i - window < j <= i (window 0: causal).
// One block of 128 threads per (64-row query tile, head): the tile walk of
// swa_flash_tile.cuh, shared with swa_flash_fwd.cu, with no logsumexp
// written. Scores at hd^-0.5, online softmax in f32, denominator clamped at
// 1e-30.
//
// Bound: 4*HD*BH*sum_i|visible keys of i| operations against the bytes of
// q, k, v and out, each moved once. Causal at BH 32, S 1024, hd 64, bf16:
// 4.30e9 operations (0.0043 ms at 989 TFLOP/s) against 16.8 MB (0.0050 ms
// at 3.35 TB/s), so bound by bytes: the caller already expanded KV. At
// S 32768 with window 8192: 1.92e12 operations (1.95 ms) against 0.537 GB
// (0.16 ms), bound by operations. This kernel runs both products on the
// f32 CUDA cores (no tensor cores yet), which is what limits it; moving
// them to mma/wgmma is later work.

#include "swa_flash_tile.cuh"

namespace {

using swa_tile::BQ;
using swa_tile::NTHREADS;

constexpr int MAX_GRID_Y = 65535;  // heads ride on gridDim.y

template <typename T, int HD>
__global__ void __launch_bounds__(NTHREADS)
swa_flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int S, int window,
                 float scale) {
  const size_t rows = (size_t)blockIdx.y * S;
  swa_tile::forward<T, HD, false>(q + rows * HD, k + rows * HD, v + rows * HD,
                                  out + rows * HD, nullptr, S, window, scale);
}

template <typename T, int HD>
void launch(const void* q, const void* k, const void* v, void* out, int bh, int S,
            int window, float scale, cudaStream_t stream) {
  const dim3 grid((S + BQ - 1) / BQ, bh);
  swa_flash_kernel<T, HD><<<grid, NTHREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), S, window, scale);
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, void* out, int bh, int S,
              int hd, int window, float scale, cudaStream_t stream) {
  if (hd == 64) {
    launch<T, 64>(q, k, v, out, bh, S, window, scale, stream);
  } else if (hd == 128) {
    launch<T, 128>(q, k, v, out, bh, S, window, scale, stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace

extern "C" int swa_flash(const void* q, const void* k, const void* v, void* out, int bh,
                         int S, int hd, int window, int dtype, float scale,
                         void* stream) {
  if (bh < 1 || bh > MAX_GRID_Y || S < 1 || window < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  switch (dtype) {
    case DT_F32:
      rc = launch_hd<float>(q, k, v, out, bh, S, hd, window, scale, st);
      break;
    case DT_BF16:
      rc = launch_hd<__nv_bfloat16>(q, k, v, out, bh, S, hd, window, scale, st);
      break;
    default:
      rc = (int)cudaErrorInvalidValue;
  }
  if (rc) return rc;
  return (int)cudaGetLastError();
}
