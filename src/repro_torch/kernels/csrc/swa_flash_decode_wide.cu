// The single-query flash decode at any G and any hd up to 256: the kernel
// of swa_flash_decode.cu (which says what it does and how it walks G in
// chunks and hd on a wider instance) with GENERAL set, in a library of its
// own so that nvcc builds its instances beside the others. The wrappers
// (kernels/swa_attention.py swa_flash_decode) take it where G > 16 or hd
// is not an instance's.
//
// Replaces the TPU kernel repro/kernels/swa_attention.py::swa_flash_decode
// (_swa_decode_kernel) at those shapes, as swa_flash_decode.cu does at the
// others.
//
// Bound: bytes, those of the visible k/v rows (+ their scales) and of q and
// out: each staged tile serves every chunk of query rows, so the cache is
// read once whatever G; the chunks' state moves through L2 beside it.

#include "swa_flash_decode.cuh"

// as swa_flash_decode, for any G >= 1 and hd 1..256
extern "C" int swa_flash_decode_wide(const void* q, const void* k, const void* v,
                                     const void* k_scale, const void* v_scale,
                                     const void* pos, void* out, void* part, void* arrived,
                                     int N, int G, int C, int hd, int window, int q_dtype,
                                     int kv_dtype, int splits, int per, float scale, int kvh,
                                     long long s_b, long long s_h, long long s_c,
                                     long long sc_b, long long sc_h, long long sc_c,
                                     void* stream) {
  const int rc =
      decode_entry<true>(q, k, v, k_scale, v_scale, pos, out, part, arrived, N, G, C, hd, window,
                         q_dtype, kv_dtype, splits, per, scale, kvh, s_b, s_h, s_c, sc_b, sc_h,
                         sc_c, stream);
  if (rc) return rc;
  return (int)cudaGetLastError();
}
