// Prefill and training attention forward: GQA causal(-window) flash
// attention with the logsumexp residual.
//
// Replaces the TPU kernel repro/kernels/swa_attention.py::swa_flash_fwd
// (_swa_fwd_res_kernel) and its wrapper repro/kernels/ops.py
// swa_attention_fwd_res.
//
//   q   (BKV, G, S, HD)  bf16 | f32, query head h = c*G + r under KV head c
//   k,v (BKV, S, HD)     same dtype, KV unexpanded
//   out (BKV, G, S, HD)  q's dtype
//   lse (BKV, G, S)      f32, lse = m + log(d)
//
// Bound: 4*HD*G*BKV*sum_q|visible keys| operations against q, k, v, out and
// lse each moved once. At the serving prefill (BKV 8, G 4, S 1024, hd 64,
// causal) that is 4.30e9 operations (0.0043 ms at 989 TFLOP/s) against
// 10.6 MB (0.0032 ms at 3.35 TB/s): bound by operations, which for bf16
// means the tensor cores.
//
// bf16 (every serving and training call) runs the tensor-core walk of
// swa_flash_wgmma.cuh: persistent blocks of a TMA producer and two wgmma
// consumer warpgroups, taking (128-row query tile, query head) items
// longest first; the G query heads of a KV head are neighbouring items,
// so their shared K/V tiles come from L2. Its f32 products and P split in
// two bf16 terms keep the output within one bf16 rounding of the f32
// attention; the split's third product and the softmax's instructions are
// what it spends beyond the bound. On an H100 80GB HBM3 at 700 W
// (chip_smoke.py, CUDA-event medians, L2 flushed): 0.0275 ms at the
// serving prefill (SDPA 0.0282; the CUDA-core walk 0.376) and 0.0808 ms at
// the training call, BKV 32 (SDPA 0.0637).
// f32 (the 2-layer f32 route checks) keeps the CUDA-core walk of
// swa_flash_tile.cuh: one block of 128 threads per (query tile of 64 rows,
// 32 at hd 192 and 256; group head, KV head), f32 FMAs, folded into grid
// x. Both take any hd from 1 to 256 on the smallest of their instances
// 64, 128, 192 and 256 that holds it.

#include "swa_flash_tile.cuh"
#include "swa_flash_wgmma.cuh"

namespace {

// one block per (query tile, group head, KV head), folded into grid x
template <int HD, bool PAD>
__global__ void __launch_bounds__(swa_tile::NTHREADS)
swa_flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, int qtiles, int G, int S, int width,
                     int window, float scale) {
  const int hd = PAD ? width : HD;   // the rows' width
  const int qt = blockIdx.x % qtiles;
  const int head = blockIdx.x / qtiles;   // b * G + g
  const size_t rows = (size_t)head * S;
  const size_t kv = (size_t)(head / G) * S;
  swa_tile::forward<float, HD, true, PAD>(q + rows * hd, k + kv * hd, v + kv * hd, out + rows * hd,
                                     lse + rows, qt, S, hd, window, scale);
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* out, void* lse, int bkv,
               int G, int S, int hd, int window, float scale, int bq, int bk,
               cudaStream_t stream) {
  if (!swa_tile::geometry<HD>(bq, bk)) return (int)cudaErrorInvalidValue;
  const long long qtiles = (S + swa_tile::Geo<HD>::BQ - 1) / swa_tile::Geo<HD>::BQ;
  if (qtiles * G * bkv > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  auto kernel = hd < HD ? swa_flash_fwd_kernel<HD, true> : swa_flash_fwd_kernel<HD, false>;
  kernel<<<(unsigned)(qtiles * G * bkv), swa_tile::NTHREADS, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), static_cast<float*>(lse), (int)qtiles, G, S, hd, window, scale);
  return 0;
}

}  // namespace

// (bq, bk): the caller's walk geometry (kernels/swa_attention.py
// walk_geometry), refused unless it is the dtype's kernel's
extern "C" int swa_flash_fwd(const void* q, const void* k, const void* v, void* out,
                             void* lse, int bkv, int G, int S, int hd, int window, int bq,
                             int bk, int blocks, int dtype, float scale, void* stream) {
  if (bkv < 1 || G < 1 || S < 1 || window < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  switch (dtype) {
    case DT_F32:
      rc = by_instance(hd, [&](auto inst) {
        return launch_f32<decltype(inst)::value>(q, k, v, out, lse, bkv, G, S, hd, window, scale,
                                                 bq, bk, st);
      });
      break;
    case DT_BF16:
      rc = swa_tc::launch_hd<true>(q, k, v, out, static_cast<float*>(lse), bkv * G, bkv, S, hd,
                                   window, scale, bq, bk, blocks, st);
      break;
    default:
      rc = (int)cudaErrorInvalidValue;
  }
  if (rc) return rc;
  return (int)cudaGetLastError();
}
