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
// Scores at hd^-0.5, online softmax in f32, denominator clamped at 1e-30.
//
// Bound: 4*HD*BH*sum_i|visible keys of i| operations against the bytes of
// q, k, v and out, each moved once. Causal at BH 32, S 1024, hd 64, bf16:
// 4.30e9 operations (0.0043 ms at 989 TFLOP/s) against 16.8 MB (0.0050 ms
// at 3.35 TB/s), so bound by bytes: the caller already expanded KV. At
// S 32768 with window 8192: 1.92e12 operations (1.95 ms) against 0.537 GB
// (0.16 ms), bound by operations, which for bf16 means the tensor cores.
//
// bf16 runs the tensor-core walk of swa_flash_wgmma.cuh (the kernel
// swa_flash_fwd.cu launches, with G = 1 and no logsumexp): persistent
// blocks of a TMA producer and two wgmma consumer warpgroups, taking
// (128-row query tile, head) items longest first. Both products run on the
// tensor cores, P split in two bf16 terms for f32 accuracy; the softmax's
// instructions then bound it. On an H100 80GB HBM3 at 700 W (chip_smoke.py,
// CUDA-event medians, L2 flushed): 5.88 ms at S 32768, window 8192 (bound
// 1.95; the CUDA-core walk 103.2) and 0.0278 ms causal at S 1024 (SDPA
// 0.0284; the CUDA-core walk 0.487). f32 keeps the CUDA-core walk of
// swa_flash_tile.cuh: one block of 128 threads per (query tile of 64 rows,
// 32 at hd 192 and 256; head), f32 FMAs, the heads folded into grid x.
// Both take any hd from 1 to 256 on the smallest of their instances 64,
// 128, 192 and 256 that holds it (swa_flash_wgmma.cuh, swa_flash_tile.cuh).

#include "swa_flash_tile.cuh"
#include "swa_flash_wgmma.cuh"

namespace {

// one block per (query tile, head), the heads folded into grid x (any
// number of them: a 65,535 bound on grid y would cap BH)
template <int HD, bool PAD>
__global__ void __launch_bounds__(swa_tile::NTHREADS)
swa_flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, int qtiles, int S,
                 int width, int window, float scale) {
  const int hd = PAD ? width : HD;   // the rows' width
  const int qt = blockIdx.x % qtiles;
  const size_t rows = (size_t)(blockIdx.x / qtiles) * S;
  swa_tile::forward<float, HD, false, PAD>(q + rows * hd, k + rows * hd, v + rows * hd,
                                      out + rows * hd, nullptr, qt, S, hd, window, scale);
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* out, int bh, int S, int hd,
               int window, float scale, int bq, int bk, cudaStream_t stream) {
  if (!swa_tile::geometry<HD>(bq, bk)) return (int)cudaErrorInvalidValue;
  const long long qtiles = (S + swa_tile::Geo<HD>::BQ - 1) / swa_tile::Geo<HD>::BQ;
  if (qtiles * bh > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  auto kernel = hd < HD ? swa_flash_kernel<HD, true> : swa_flash_kernel<HD, false>;
  kernel<<<(unsigned)(qtiles * bh), swa_tile::NTHREADS, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), (int)qtiles, S, hd, window, scale);
  return 0;
}

}  // namespace

// (bq, bk): the caller's walk geometry (kernels/swa_attention.py
// walk_geometry), refused unless it is the dtype's kernel's
extern "C" int swa_flash(const void* q, const void* k, const void* v, void* out, int bh,
                         int S, int hd, int window, int bq, int bk, int blocks, int dtype,
                         float scale, void* stream) {
  if (bh < 1 || S < 1 || window < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  switch (dtype) {
    case DT_F32:
      rc = by_instance(hd, [&](auto inst) {
        return launch_f32<decltype(inst)::value>(q, k, v, out, bh, S, hd, window, scale, bq, bk,
                                                 st);
      });
      break;
    case DT_BF16:
      rc = swa_tc::launch_hd<false>(q, k, v, out, nullptr, bh, bh, S, hd, window, scale, bq, bk,
                                    blocks, st);
      break;
    default:
      rc = (int)cudaErrorInvalidValue;
  }
  if (rc) return rc;
  return (int)cudaGetLastError();
}
