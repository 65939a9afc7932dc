// Prefill attention forward: GQA causal(-window) flash attention with the
// logsumexp residual.
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
// One block of 128 threads per (64-row query tile, group head, KV head),
// walking the band of its query tile as swa_flash_tile.cuh sets out (the
// tile walk swa_flash.cu shares) and writing lse beside the output.
//
// Bound: 4*HD*G*BKV*sum_q|visible keys| operations. At the prefill shapes
// of the serving path that is far above the H100's bytes/operation ratio,
// so the ideal kernel is bound by operations; this one runs its products
// on the f32 CUDA cores (no tensor cores yet), which is what limits it.
// Moving the two products to wgmma is later work.

#include "swa_flash_tile.cuh"

namespace {

using swa_tile::BQ;
using swa_tile::NTHREADS;

template <typename T, int HD>
__global__ void __launch_bounds__(NTHREADS)
swa_flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse, int G, int S, int window,
                     float scale) {
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const size_t rows = (size_t)(b * G + g) * S;
  const size_t kv = (size_t)b * S;
  swa_tile::forward<T, HD, true>(q + rows * HD, k + kv * HD, v + kv * HD, out + rows * HD,
                                 lse + rows, S, window, scale);
}

template <typename T, int HD>
void launch(const void* q, const void* k, const void* v, void* out, void* lse,
            int bkv, int G, int S, int window, float scale, cudaStream_t stream) {
  const dim3 grid((S + BQ - 1) / BQ, G, bkv);
  swa_flash_fwd_kernel<T, HD><<<grid, NTHREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), static_cast<float*>(lse), G, S, window, scale);
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, void* out, void* lse,
              int bkv, int G, int S, int hd, int window, float scale,
              cudaStream_t stream) {
  if (hd == 64) {
    launch<T, 64>(q, k, v, out, lse, bkv, G, S, window, scale, stream);
  } else if (hd == 128) {
    launch<T, 128>(q, k, v, out, lse, bkv, G, S, window, scale, stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace

extern "C" int swa_flash_fwd(const void* q, const void* k, const void* v, void* out,
                             void* lse, int bkv, int G, int S, int hd, int window,
                             int dtype, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  switch (dtype) {
    case DT_F32:
      rc = launch_hd<float>(q, k, v, out, lse, bkv, G, S, hd, window, scale, st);
      break;
    case DT_BF16:
      rc = launch_hd<__nv_bfloat16>(q, k, v, out, lse, bkv, G, S, hd, window, scale, st);
      break;
    default:
      rc = (int)cudaErrorInvalidValue;
  }
  if (rc) return rc;
  return (int)cudaGetLastError();
}
