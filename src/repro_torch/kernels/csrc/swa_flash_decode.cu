// Single-query flash decode over the serving KV cache.
//
// Replaces the TPU kernel repro/kernels/swa_attention.py::swa_flash_decode
// (_swa_decode_kernel) and its wrapper repro/kernels/ops.py swa_decode.
//
//   q        (N, G, hd)  f32 | bf16, N = B * KV heads, any G, hd 1..256
//   k, v     (N, C, hd)  the cache in its STORED dtype: f32 | bf16 |
//                        fp8 e4m3 | fp8 e5m2, read through strides: row
//                        (n, slot) starts at (n / KVH) * s_b + (n % KVH) * s_h
//                        + slot * s_c elements, so the serving cache's
//                        (B, C, KV, hd) layout is read in place (no copy)
//   k_scale, v_scale (N, C) f32 per-row dequant scales, or null (scale 1),
//                        through strides sc_b, sc_h, sc_c the same way
//   pos      (N,) i32    query position (its own k/v already written)
//   out      (N, G, hd)  f32
//
// window > 0: ring of capacity C == window; slot s holds the latest
// position p <= pos with p % C == s, visible iff 0 <= p <= pos and
// p > pos - window. window == 0: dense cache, slot s holds position s,
// visible iff s <= pos. In both, no slot at or past min(C, pos + 1) is
// visible (a ring slot s > pos < C holds no position yet), and no slot
// that is not visible is read.
//
// Bound: bytes, those of the visible k/v rows (+ their scales) and of q
// and out, against the card's memory rate. One block per (lane, KV head)
// would be 64 blocks on 132 SMs at the main path, each walking its cache
// alone; so the launch is split-K, a grid of (N, S) blocks of 256 threads,
// split s taking slots [s * per, (s + 1) * per): S and per (a whole number
// of tiles) come from the host, kernels/swa_attention.py decode_splits,
// from N, C and the SM count, never from pos. A block loads its G query
// rows beside pos, scales them into shared memory and walks its split in
// tiles of T = 4096 / HD slots: it copies a K and a V tile with 16-byte
// cp.async in the stored dtype (a slot not visible is zero-filled, not
// read); bf16 and fp8 tiles (and scaled ones) are dequantized in shared
// memory, cast then one multiply by the row scale, so no f32 copy of the
// cache exists in device memory. Then the G x T scores (float4 dots), a
// per-head online softmax in f32 (one warp a head) and the acc update,
// each thread owning G*hd/256 accumulator entries. Two blocks an SM at
// most (__launch_bounds__(256, 2) leaves ptxas room to spill nothing).
//
// Any G: the query rows go in chunks of GC = 16 (the register count of
// the accumulators sets it: 16 HD / 256 a thread, 16 at hd 256). Each
// staged K/V tile is read from device memory once and serves every chunk
// from shared memory, so the bytes of a KV head's cache stay those of one
// pass; the chunk's q rows are staged per tile (from L2: they are a few
// KB), so shared memory does not grow with G. With one chunk (G <= 16)
// its accumulators stay in registers from tile to tile, as they always
// did; with more, each chunk's (acc, m, d) rests between tiles in the
// block's own slot of the merge's partial, which holds G hd + 2 G floats
// a split in any case (written and read back by the same thread, in L2).
//
// Any hd from 1 to 256: the kernel is instanced at HD = 64, 128, 192 and
// 256, rows of hd on the smallest that holds them (the tile's T = 4096 /
// HD slots), the columns hd..HD - 1 of the staged tiles and q rows zero.
// Rows that are not a whole number of 16-byte chunks (an f32 hd % 4, a
// bf16 hd % 8 or an fp8 hd % 16 that is not 0) take the element loads.
//
// The splits at or past min(C, pos + 1) hold nothing visible: they return
// at once, write nothing and do not arrive (every split before them has a
// visible slot). If one split is live it writes out itself. Else each
// live split writes its partial (acc, m, d) to f32 scratch, and the last
// to arrive (an arrival counter after a fence; it clears the counter, so
// the caller's counters stay zero) merges the partials in split order,
// not arrival order, online: m' = max(m, m_s), d' = d e^(m - m') +
// d_s e^(m_s - m'), acc likewise, out = acc / d; a partial with d = 0
// (m = -1e30, nothing visible) takes no weight. Each thread folds its
// entries with eight splits' loads in flight, so the merge costs one
// round trip to L2 per eight splits; the counter's line is prefetched
// into L2 at the start. Twin launches are bit-identical.

#include "swa_flash_decode.cuh"

// part: (N, splits, G*hd + 2G) f32 scratch; arrived: (N,) i32, zero at
// entry and left zero. splits and per are kernels/swa_attention.py
// decode_splits(N, C, hd, SMs); any other split of C is refused. G <= 16
// and hd 64, 128, 192 or 256 (anything else: swa_flash_decode_wide).
extern "C" int swa_flash_decode(const void* q, const void* k, const void* v,
                                const void* k_scale, const void* v_scale, const void* pos,
                                void* out, void* part, void* arrived, int N, int G, int C,
                                int hd, int window, int q_dtype, int kv_dtype, int splits,
                                int per, float scale, int kvh, long long s_b, long long s_h,
                                long long s_c, long long sc_b, long long sc_h, long long sc_c,
                                void* stream) {
  const int rc =
      decode_entry<false>(q, k, v, k_scale, v_scale, pos, out, part, arrived, N, G, C, hd, window,
                          q_dtype, kv_dtype, splits, per, scale, kvh, s_b, s_h, s_c, sc_b, sc_h,
                          sc_c, stream);
  if (rc) return rc;
  return (int)cudaGetLastError();
}
