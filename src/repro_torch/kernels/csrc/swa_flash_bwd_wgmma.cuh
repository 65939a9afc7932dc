// The tensor-core backward of the causal(-window) GQA attention for bf16
// inputs: dq, and dk/dv per KV head, from the forward's (lse) and the
// caller's delta = rowsum(do * o), all five products on wgmma, operands
// brought by TMA. swa_flash_bwd.cu launches both kernels; its f32
// instances keep the CUDA-core bodies.
//
// Both kernels reuse the forward walk's machinery (swa_flash_wgmma.cuh:
// wgmma_ss, wgmma_rs, split_p, fence_split, exp2_, key_tiles, interior,
// item_of, encode_rows) and its block shape: persistent blocks, one per
// SM, of 384 threads, a producer warpgroup whose thread 0 issues every TMA
// load and two consumer warpgroups that rise to 232 registers (setmaxnreg)
// while the producer drops to 40. Tensor maps are 3-D (hd, S, heads), so rows past S arrive
// as zeros; queries and keys past S are also masked explicitly, or not
// stored. Items go out longest first, block b of B taking items b,
// 2B - 1 - b, 2B + b, ... (item_of). No atomics: each output row is summed
// by one block in a fixed order, so two launches give the same bits.
//
// dq (swa_bwd_dq_wgmma): a work item is one 128-row query tile of one query
// head -- the forward's item and walk (kernels/swa_attention.py
// walk_geometry, key_tiles, tile_masked, block_items). Q, dO (the item's
// rows, double-buffered across items; one buffer at hd 192, where two
// would need 289 KB of shared memory) and each row's lse and delta stay
// resident; a ring of DQ_STAGES K/V stages (BK keys: 128 at hd 64, 64 at
// hd 128 and 192) streams through mbarriers. Two stages in each ring
// measured as fast as three or four. Per key tile, consumer w (rows
// 64w..64w+63):
//   S  = Q K^T    wgmma_ss m64nBK, both K-major; P = exp2(S c - lse log2e)
//                 with c = hd^-0.5 log2e applied to the f32 score
//   dP = dO V^T   wgmma_ss m64nBK; dS = P (dP - delta) in f32
//   dQ += dS K    dS split as dS_hi (cut to its top 16 bits) + dS_lo =
//                 bf16(dS - dS_hi), two wgmma_rs m64nHDk16 per 16 keys, A
//                 from registers (the score fragment is the A layout), K
//                 MN-major through the transpose bit
// and dq = hd^-0.5 dQ is stored in f32. Only tiles that cross the band's
// edge evaluate the mask; rows past S are not stored.
//
// dk/dv (swa_bwd_dkdv_wgmma): a work item is one 128-key tile of one KV
// head; consumer w owns its keys 64w..64w+63. At hd 192 the dK and dV
// accumulators of 64 keys alone are 192 registers a thread, so an item is
// one 64-key tile and its two consumers split the work instead: consumer
// 0 sums dV (S^T, P^T, dV += P^T dO), consumer 1 dK (S^T and dP^T again,
// dS^T, dK += dS^T Q), each holding 96 accumulators; S^T is computed by
// both, 7 products where one consumer would do 6. The producer loads the item's
// K and V once (one buffer: a second, to load the next item's K and V
// early, measured no faster), then streams a ring of KV_STAGES stages of
// 64 query rows of Q and dO for each of the G query heads of the KV head
// and each query tile of the band (causal: from the key tile's diagonal
// to S; a window: up to k_hi + window); warp 1 of the
// producer warpgroup writes the stage's lse log2e and delta into shared
// memory with plain loads (an f32 row of S = 517 is not 16-byte strided, so
// not TMA-able) and arrives on the stage's barrier. Per stage, each
// consumer:
//   S^T  = K Q^T    wgmma_ss m64n64, both K-major; P^T = exp2(S^T c - lse
//                   log2e), lse read per column from shared memory
//   dP^T = V dO^T   wgmma_ss m64n64; dS^T = P^T (dP^T - delta)
//   dV  += P^T dO   P split in two, two wgmma_rs m64nHDk16 per 16 queries,
//                   dO MN-major
//   dK  += dS^T Q   dS split in two, the same with Q
// and stores dk = hd^-0.5 dK and dv in f32. A consumer skips the stages in
// which none of its keys is visible to any query (the first causal stage
// of the upper half) and evaluates the mask only on stages that cross the
// band's edge or S (kernels/swa_attention.py dkdv_geometry, query_tiles,
// stage_kind).
//
// The splits: rounding P or dS to one bf16 puts a relative error of up to
// 2^-9 in every term, which leaves BWD_REL_TOL (1e-3 of the largest
// gradient entry; tests/test_torch_swa_bwd_walk.py shows it); hi + lo is
// within 2^-16 of the f32 value. S = Q K^T and dP = dO V^T are single
// products: their bf16 inputs are exact and their sums f32. So dq does
// 8 hd operations per visible pair (the function needs 6) and dk/dv 12 hd
// (the function needs 8).
//
// What bounds it: at hd 64 the tensor cores' work per score (8 or 12 hd
// operations) and the f32 instructions that rebuild P and dS (about a
// dozen per score, more on masked tiles) are of one order, as in the
// forward walk.
#pragma once

#include "swa_flash_wgmma.cuh"

namespace swa_tc {

constexpr int BQS = 64;     // dk/dv: query rows per stage

template <int HD>
struct BwdGeo {
  static constexpr int HALVES = HD / 64;   // 64-column (128-byte) atoms of a row
  // dq: resident Q and dO of BQ rows, K/V stages of BK keys
  static constexpr int BK = Geo<HD>::BK;
  static constexpr int Q_HALF = BQ * 128;
  static constexpr int Q_BYTES = HALVES * Q_HALF;       // one of Q, dO
  static constexpr int KV_HALF = BK * 128;
  static constexpr int KV_BYTES = HALVES * KV_HALF;     // one of K, V
  static constexpr int DQ_STAGES = 2;
  static constexpr int Q_BUFS = HD == 192 ? 1 : 2;      // (Q, dO) buffers
  static constexpr int DQ_SMEM = Q_BUFS * 2 * Q_BYTES + DQ_STAGES * 2 * KV_BYTES + 1024;
  static constexpr int DQ_FRAG = HD / 2;                // dQ accumulators per thread
  // dk/dv: resident K and V of BKEY rows, Q/dO stages of BQS rows; at hd
  // 192 consumer 0 sums dV and consumer 1 dK of the same 64 keys
  static constexpr bool SPLIT = HD == 192;
  static constexpr int BKEY = SPLIT ? 64 : 128;         // keys per item
  static constexpr int K_HALF = BKEY * 128;
  static constexpr int K_BYTES = HALVES * K_HALF;       // one of K, V
  static constexpr int S_HALF = BQS * 128;
  static constexpr int S_BYTES = HALVES * S_HALF;       // one of Q, dO
  static constexpr int KV_STAGES = 2;
  static constexpr int KV_SMEM = 2 * K_BYTES + KV_STAGES * 2 * S_BYTES + 1024;
};

// The query tiles (BQS rows) that key tile k0 (its first key, bkey keys)
// visits: from the one holding k0 to the one holding the last query that
// sees its last key (kernels/swa_attention.py query_tiles).
__device__ __forceinline__ void query_tiles(int k0, int bkey, int S, int window, int& lo,
                                            int& hi) {
  const int k_hi = min(k0 + bkey - 1, S - 1);
  const int q_end = window > 0 ? min(S, k_hi + window) : S;
  lo = k0 / BQS;
  hi = (q_end - 1) / BQS;
}

// A consumer's 64 keys from kc against the stage's queries from q0: 0 when
// no pair is visible (skipped), 2 when every pair is (no mask), else 1
// (kernels/swa_attention.py stage_kind)
__device__ __forceinline__ int stage_kind(int kc, int q0, int S, int window) {
  if (kc >= S || kc > q0 + BQS - 1 || (window > 0 && kc + 63 <= q0 - window)) return 0;
  if (kc + 63 <= q0 && q0 + BQS - 1 < S && (window <= 0 || kc > q0 + BQS - 1 - window))
    return 2;
  return 1;
}

// dq: a consumer thread's rows row0 and row0 + 8 against keys from k0. s
// holds the raw scores (entry r: row row0 + 8 ((r >> 1) & 1), key k0 + 8
// (r >> 2) + 2 (lane mod 4) + r mod 2), dp the rows' dO V^T; s becomes
// dS = P (dP - delta), P = exp2(s c - lse log2e).
template <int BK, bool MASK>
__device__ __forceinline__ void ds_of_rows(float (&s)[BK / 2], const float (&dp)[BK / 2],
                                           const float (&l2)[2], const float (&dl)[2], int row0,
                                           int k0, int lane, int window, float c) {
#pragma unroll
  for (int r = 0; r < BK / 2; ++r) {
    const int h = (r >> 1) & 1;
    float p = exp2_(fmaf(s[r], c, -l2[h]));
    if (MASK) {
      const int row = row0 + 8 * h;
      const int key = k0 + (r >> 2) * 8 + (lane & 3) * 2 + (r & 1);
      p = key <= row && (window <= 0 || key > row - window) ? p : 0.f;
    }
    s[r] = p * (dp[r] - dl[h]);
  }
}

// dk/dv: a consumer thread's keys key0 and key0 + 8 against the stage's
// queries from q0 (entry r: key key0 + 8 ((r >> 1) & 1), query q0 + 8
// (r >> 2) + 2 (lane mod 4) + r mod 2). rows[0] and rows[1] hold the
// stage's lse log2e and delta; s becomes P^T and, when DS, dp dS^T.
template <bool MASK, bool DS = true>
__device__ __forceinline__ void p_ds_of_cols(float (&s)[32], float (&dp)[32],
                                             const float (*rows)[BQS], int key0, int q0,
                                             int lane, int S, int window, float c) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 8 * j + 2 * (lane & 3);
    const float2 l = *reinterpret_cast<const float2*>(&rows[0][col]);
    const float2 d = *reinterpret_cast<const float2*>(&rows[1][col]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 4 * j + e;
      float p = exp2_(fmaf(s[r], c, -((e & 1) ? l.y : l.x)));
      if (MASK) {
        const int key = key0 + 8 * (e >> 1);
        const int q = q0 + col + (e & 1);
        p = q < S && key <= q && (window <= 0 || key > q - window) ? p : 0.f;
      }
      s[r] = p;
      if (DS) dp[r] = p * (dp[r] - ((e & 1) ? d.y : d.x));
    }
  }
}

// q/do maps (hd, S, query heads), k/v maps (hd, S, KV heads); query head h
// reads KV head h / G; lse, delta (heads, S) f32; dq (heads, S, HD) f32
template <int HD>
__global__ void __launch_bounds__(NT, 1)
swa_bwd_dq_wgmma(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
             const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap domap,
             const float* __restrict__ lse, const float* __restrict__ delta,
             float* __restrict__ dq, int S, int G, int heads, int qtiles, int window,
             float scale) {
  using Gm = BwdGeo<HD>;
  constexpr int BK = Gm::BK;
  constexpr int STAGES = Gm::DQ_STAGES;
  constexpr int QB = Gm::Q_BUFS;
  const int items = heads * qtiles;

  extern __shared__ unsigned char smem_raw[];
  // qfull[2], qempty[2], full[STAGES], empty[STAGES]
  __shared__ __align__(8) uint64_t bars[4 + 2 * STAGES];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t qfull0 = smem_addr(bars);
  const uint32_t qempty0 = qfull0 + 16;
  const uint32_t full0 = qfull0 + 32;
  const uint32_t empty0 = full0 + 8 * STAGES;
  const uint32_t kv0 = base + QB * 2 * Gm::Q_BYTES;   // after the (Q, dO) buffers
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(qfull0 + 8 * s, 1);
      mbar_init(qempty0 + 8 * s, 8);   // one arrival per consumer warp
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: per item, its Q and dO tiles into buffer n % QB once the
    // consumers are done with that buffer's previous item, then the K/V
    // tiles of its band through the ring
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x != 0) return;
    int it = 0;
    for (int n = 0;; ++n) {
      const int i = item_of(n, blockIdx.x, gridDim.x);
      if (i >= items) break;
      const int q0 = (qtiles - 1 - i / heads) * BQ;
      const int h = i % heads;
      const int kvh = h / G;
      const uint32_t qf = qfull0 + 8 * (n % QB);
      const uint32_t qs = base + (n % QB) * 2 * Gm::Q_BYTES;
      mbar_wait(qempty0 + 8 * (n % QB), ((n / QB) & 1) ^ 1);
      mbar_expect_tx(qf, 2 * Gm::Q_BYTES);
#pragma unroll
      for (int a = 0; a < Gm::HALVES; ++a) {
        tma_load(qs + a * Gm::Q_HALF, &qmap, 64 * a, q0, h, qf);
        tma_load(qs + Gm::Q_BYTES + a * Gm::Q_HALF, &domap, 64 * a, q0, h, qf);
      }
      int t_lo, t_hi;
      key_tiles(q0, S, window, BK, t_lo, t_hi);
      for (int kt = t_lo; kt <= t_hi; ++kt, ++it) {
        const int st = it % STAGES;
        const uint32_t full = full0 + 8 * st;
        const uint32_t ks = kv0 + st * 2 * Gm::KV_BYTES;
        mbar_wait(empty0 + 8 * st, ((it / STAGES) & 1) ^ 1);
        mbar_expect_tx(full, 2 * Gm::KV_BYTES);
#pragma unroll
        for (int a = 0; a < Gm::HALVES; ++a) {
          tma_load(ks + a * Gm::KV_HALF, &kmap, 64 * a, kt * BK, kvh, full);
          tma_load(ks + Gm::KV_BYTES + a * Gm::KV_HALF, &vmap, 64 * a, kt * BK, kvh, full);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg - 1 owns rows 64 (wg - 1) .. + 63 of each tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int cw = wg - 1;
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const float c = scale * LOG2E;
  int it = 0;
  for (int n = 0;; ++n) {
    const int i = item_of(n, blockIdx.x, gridDim.x);
    if (i >= items) break;
    const int q0 = (qtiles - 1 - i / heads) * BQ;
    const int h = i % heads;
    const int row0 = q0 + cw * 64 + (t / 32) * 16 + lane / 4;
    const uint32_t qa = base + (n % QB) * 2 * Gm::Q_BYTES + cw * 64 * 128;
    const uint32_t da = qa + Gm::Q_BYTES;
    float l2[2], dl[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + 8 * hh;
      l2[hh] = row < S ? lse[(size_t)h * S + row] * LOG2E : 0.f;
      dl[hh] = row < S ? delta[(size_t)h * S + row] : 0.f;
    }
    int t_lo, t_hi;
    key_tiles(q0, S, window, BK, t_lo, t_hi);
    float acc[Gm::DQ_FRAG];
#pragma unroll
    for (int r = 0; r < Gm::DQ_FRAG; ++r) acc[r] = 0.f;
    mbar_wait(qfull0 + 8 * (n % QB), (n / QB) & 1);

    for (int kt = t_lo; kt <= t_hi; ++kt, ++it) {
      const int st = it % STAGES;
      const uint32_t ks = kv0 + st * 2 * Gm::KV_BYTES;
      const uint32_t vs = ks + Gm::KV_BYTES;
      mbar_wait(full0 + 8 * st, (it / STAGES) & 1);

      float s[BK / 2], dp[BK / 2];
#pragma unroll
      for (int r = 0; r < BK / 2; ++r) s[r] = dp[r] = 0.f;
      fence_operands(s);
      fence_operands(dp);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        // hd 16 kk..: 32 bytes into atom column kk / 4 (K-major, SBO the
        // 1 KB between 8-row groups)
        const uint32_t off = (kk / 4) * Gm::Q_HALF + (kk % 4) * 32;
        const uint32_t koff = (kk / 4) * Gm::KV_HALF + (kk % 4) * 32;
        wgmma_ss<BK>(s, desc(qa + off, 16, 1024), desc(ks + koff, 16, 1024), 1);
        wgmma_ss<BK>(dp, desc(da + off, 16, 1024), desc(vs + koff, 16, 1024), 1);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_operands(s);
      fence_operands(dp);

      const int k0 = kt * BK;
      if (interior(q0, k0, window, BK))
        ds_of_rows<BK, false>(s, dp, l2, dl, row0, k0, lane, window, c);
      else
        ds_of_rows<BK, true>(s, dp, l2, dl, row0, k0, lane, window, c);
      uint32_t dsa[BK / 16][2][4];
      split_p<BK>(s, dsa);
      fence_split(dsa);
      fence_operands(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // keys 16 kk.. of K: 16 rows of 128 bytes; LBO the atom columns of
        // hd 128 and 192, SBO the 1 KB between 8-key groups
        const uint64_t db = desc(ks + kk * 16 * 128, Gm::KV_HALF, 1024);
        wgmma_rs<HD>(acc, dsa[kk][0], db);
        wgmma_rs<HD>(acc, dsa[kk][1], db);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_operands(acc);
      // this warp's products of the tile are done: release its stage
      if (lane == 0) mbar_arrive(empty0 + 8 * st);
    }
    // every product of the item has read its (Q, dO) buffer
    if (lane == 0) mbar_arrive(qempty0 + 8 * (n % QB));

#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + 8 * hh;
      if (row >= S) continue;
      float* op = dq + ((size_t)h * S + row) * HD + (lane & 3) * 2;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<float2*>(op + 8 * j) =
            make_float2(acc[4 * j + 2 * hh] * scale, acc[4 * j + 2 * hh + 1] * scale);
    }
  }
}

// One dk/dv consumer warpgroup's walk over its block's items: the dK sum of
// its 64 keys when DK, the dV sum when DV (both at hd 64 and 128; at hd 192
// consumer 0 takes DV and consumer 1 DK, so each holds 96 accumulators and
// the two never share a code path). key_off: its keys' offset within an
// item; rows: each stage's lse log2e and delta.
template <int HD, bool DK, bool DV>
__device__ __forceinline__ void dkdv_consumer(uint32_t base, uint32_t st0, uint32_t kvfull,
                                              uint32_t kvempty, uint32_t full0,
                                              uint32_t empty0, float (*rows)[2][BQS],
                                              float* __restrict__ dk, float* __restrict__ dv,
                                              int S, int G, int kv_heads, int items,
                                              int window, float scale, int key_off) {
  using Gm = BwdGeo<HD>;
  constexpr int STAGES = Gm::KV_STAGES;
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const float c = scale * LOG2E;
  const uint32_t ka = base + key_off * 128;
  const uint32_t va = ka + Gm::K_BYTES;
  int it = 0;
  for (int n = 0;; ++n) {
    const int i = item_of(n, blockIdx.x, gridDim.x);
    if (i >= items) break;
    const int k0 = (i / kv_heads) * Gm::BKEY;
    const int kvh = i % kv_heads;
    const int kc = k0 + key_off;
    const int key0 = kc + (t / 32) * 16 + lane / 4;
    float dka[DK ? HD / 2 : 1], dva[DV ? HD / 2 : 1];
#pragma unroll
    for (int r = 0; r < HD / 2; ++r) {
      if constexpr (DK) dka[r] = 0.f;
      if constexpr (DV) dva[r] = 0.f;
    }
    int t_lo, t_hi;
    query_tiles(k0, Gm::BKEY, S, window, t_lo, t_hi);
    mbar_wait(kvfull, n & 1);

    for (int g = 0; g < G; ++g) {
      for (int qt = t_lo; qt <= t_hi; ++qt, ++it) {
        const int st = it % STAGES;
        const uint32_t qs = st0 + st * 2 * Gm::S_BYTES;
        const uint32_t ds = qs + Gm::S_BYTES;
        const int q0 = qt * BQS;
        // wait even on a skipped stage: its release must follow the
        // producer's refill, or it would count toward the previous round
        mbar_wait(full0 + 8 * st, (it / STAGES) & 1);
        const int kind = stage_kind(kc, q0, S, window);
        if (kind != 0) {
          float s[32], dp[32];
#pragma unroll
          for (int r = 0; r < 32; ++r) s[r] = dp[r] = 0.f;
          fence_operands(s);
          if constexpr (DK) fence_operands(dp);
          asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
          for (int kk = 0; kk < HD / 16; ++kk) {
            const uint32_t koff = (kk / 4) * Gm::K_HALF + (kk % 4) * 32;
            const uint32_t qoff = (kk / 4) * Gm::S_HALF + (kk % 4) * 32;
            wgmma_ss<64>(s, desc(ka + koff, 16, 1024), desc(qs + qoff, 16, 1024), 1);
            if constexpr (DK)
              wgmma_ss<64>(dp, desc(va + koff, 16, 1024), desc(ds + qoff, 16, 1024), 1);
          }
          asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
          asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
          fence_operands(s);
          if constexpr (DK) fence_operands(dp);

          if (kind == 2)
            p_ds_of_cols<false, DK>(s, dp, rows[st], key0, q0, lane, S, window, c);
          else
            p_ds_of_cols<true, DK>(s, dp, rows[st], key0, q0, lane, S, window, c);
          uint32_t pa[4][2][4], sa[4][2][4];
          if constexpr (DV) {
            split_p<64>(s, pa);
            fence_split(pa);
            fence_operands(dva);
          }
          if constexpr (DK) {
            split_p<64>(dp, sa);
            fence_split(sa);
            fence_operands(dka);
          }
          asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            // queries 16 kk.. of dO and Q: MN-major, LBO the atom columns
            // of hd 128 and 192, SBO the 1 KB between 8-query groups
            if constexpr (DV) {
              const uint64_t dbo = desc(ds + kk * 16 * 128, Gm::S_HALF, 1024);
              wgmma_rs<HD>(dva, pa[kk][0], dbo);
              wgmma_rs<HD>(dva, pa[kk][1], dbo);
            }
            if constexpr (DK) {
              const uint64_t dbq = desc(qs + kk * 16 * 128, Gm::S_HALF, 1024);
              wgmma_rs<HD>(dka, sa[kk][0], dbq);
              wgmma_rs<HD>(dka, sa[kk][1], dbq);
            }
          }
          asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
          asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
          if constexpr (DV) fence_operands(dva);
          if constexpr (DK) fence_operands(dka);
        }
        if (lane == 0) mbar_arrive(empty0 + 8 * st);
      }
    }
    // every product of the item has read its K and V
    if (lane == 0) mbar_arrive(kvempty);

#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int key = key0 + 8 * hh;
      if (key >= S) continue;
      const size_t off = ((size_t)kvh * S + key) * HD + (lane & 3) * 2;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        if constexpr (DK)
          *reinterpret_cast<float2*>(dk + off + 8 * j) =
              make_float2(dka[4 * j + 2 * hh] * scale, dka[4 * j + 2 * hh + 1] * scale);
        if constexpr (DV)
          *reinterpret_cast<float2*>(dv + off + 8 * j) =
              make_float2(dva[4 * j + 2 * hh], dva[4 * j + 2 * hh + 1]);
      }
    }
  }
}

// q/do maps (hd, S, query heads), k/v maps (hd, S, KV heads); KV head c
// serves query heads c G .. c G + G - 1; lse, delta (heads, S) f32; dk, dv
// (kv_heads, S, HD) f32
template <int HD>
__global__ void __launch_bounds__(NT, 1)
swa_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
               const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap domap,
               const float* __restrict__ lse, const float* __restrict__ delta,
               float* __restrict__ dk, float* __restrict__ dv, int S, int G, int kv_heads,
               int ktiles, int window, float scale) {
  using Gm = BwdGeo<HD>;
  constexpr int STAGES = Gm::KV_STAGES;
  const int items = kv_heads * ktiles;

  extern __shared__ unsigned char smem_raw[];
  // kvfull, kvempty, full[STAGES], empty[STAGES]
  __shared__ __align__(8) uint64_t bars[2 + 2 * STAGES];
  // each stage's lse log2e and delta, per query row
  __shared__ __align__(16) float rows[STAGES][2][BQS];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t kvfull = smem_addr(bars);
  const uint32_t kvempty = kvfull + 8;
  const uint32_t full0 = kvfull + 16;
  const uint32_t empty0 = full0 + 8 * STAGES;
  const uint32_t st0 = base + 2 * Gm::K_BYTES;   // after K and V
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    mbar_init(kvfull, 1);
    mbar_init(kvempty, 8);   // one arrival per consumer warp
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1 + 32);   // the TMA thread and warp 1's lanes
      mbar_init(empty0 + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: thread 0 loads an item's K and V once the consumers are
    // done with the previous item's, then the (Q, dO)
    // stages of its band; warp 1 fills each stage's lse and delta
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const int pw = threadIdx.x / 32;
    if (pw > 1 || (pw == 0 && threadIdx.x != 0)) return;
    const int lane = threadIdx.x % 32;
    int it = 0;
    for (int n = 0;; ++n) {
      const int i = item_of(n, blockIdx.x, gridDim.x);
      if (i >= items) break;
      const int k0 = (i / kv_heads) * Gm::BKEY;
      const int kvh = i % kv_heads;
      if (pw == 0) {
        mbar_wait(kvempty, (n & 1) ^ 1);
        mbar_expect_tx(kvfull, 2 * Gm::K_BYTES);
#pragma unroll
        for (int a = 0; a < Gm::HALVES; ++a) {
          tma_load(base + a * Gm::K_HALF, &kmap, 64 * a, k0, kvh, kvfull);
          tma_load(base + Gm::K_BYTES + a * Gm::K_HALF, &vmap, 64 * a, k0, kvh, kvfull);
        }
      }
      int t_lo, t_hi;
      query_tiles(k0, Gm::BKEY, S, window, t_lo, t_hi);
      for (int g = 0; g < G; ++g) {
        const int hq = kvh * G + g;
        for (int qt = t_lo; qt <= t_hi; ++qt, ++it) {
          const int st = it % STAGES;
          const uint32_t full = full0 + 8 * st;
          mbar_wait(empty0 + 8 * st, ((it / STAGES) & 1) ^ 1);
          if (pw == 0) {
            const uint32_t sb = st0 + st * 2 * Gm::S_BYTES;
            mbar_expect_tx(full, 2 * Gm::S_BYTES);
#pragma unroll
            for (int a = 0; a < Gm::HALVES; ++a) {
              tma_load(sb + a * Gm::S_HALF, &qmap, 64 * a, qt * BQS, hq, full);
              tma_load(sb + Gm::S_BYTES + a * Gm::S_HALF, &domap, 64 * a, qt * BQS, hq, full);
            }
          } else {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int j = 2 * lane + e;
              const int q = qt * BQS + j;
              rows[st][0][j] = q < S ? lse[(size_t)hq * S + q] * LOG2E : 0.f;
              rows[st][1][j] = q < S ? delta[(size_t)hq * S + q] : 0.f;
            }
            mbar_arrive(full);
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg - 1 owns keys 64 (wg - 1) .. + 63 of each item
  // and sums both dK and dV; at hd 192 both own the item's 64 keys, the
  // first summing dV and the second dK
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int cw = wg - 1;
  if constexpr (Gm::SPLIT) {
    if (cw == 0)
      dkdv_consumer<HD, false, true>(base, st0, kvfull, kvempty, full0, empty0, rows, dk, dv, S,
                                     G, kv_heads, items, window, scale, 0);
    else
      dkdv_consumer<HD, true, false>(base, st0, kvfull, kvempty, full0, empty0, rows, dk, dv, S,
                                     G, kv_heads, items, window, scale, 0);
  } else {
    dkdv_consumer<HD, true, true>(base, st0, kvfull, kvempty, full0, empty0, rows, dk, dv, S, G,
                                  kv_heads, items, window, scale, cw * 64);
  }
}

// the four tensor maps of a backward launch: q and do in boxes of qrows, k
// and v in boxes of krows; every base 16-byte aligned
inline int bwd_maps(CUtensorMap (&maps)[4], const void* q, const void* k, const void* v,
                    const void* dout, int hd, int S, int heads, int kv_heads, int qrows,
                    int krows) {
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout)) % 16)
    return (int)cudaErrorInvalidValue;
  memset(maps, 0, sizeof(maps));
  int rc = encode_rows(&maps[0], q, hd, S, heads, qrows);
  if (!rc) rc = encode_rows(&maps[1], k, hd, S, kv_heads, krows);
  if (!rc) rc = encode_rows(&maps[2], v, hd, S, kv_heads, krows);
  if (!rc) rc = encode_rows(&maps[3], dout, hd, S, heads, qrows);
  return rc;
}

// 0 or a CUDA error code. q, do (heads, S, HD), k, v (kv_heads, S, HD), all
// bf16 on 16-byte aligned bases; (bq, bk, blocks) the caller's geometry
// (kernels/swa_attention.py dq_geometry and walk_blocks), refused unless
// (bq, bk) is this kernel's and 1 <= blocks <= the work items.
template <int HD>
int launch_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                  const float* lse, const float* delta, float* dq, int heads, int kv_heads,
                  int S, int window, float scale, int bq, int bk, int blocks, cudaStream_t st) {
  using Gm = BwdGeo<HD>;
  const long long qtiles = (S + BQ - 1) / BQ;
  if (bq != BQ || bk != Gm::BK || heads % kv_heads || blocks < 1 ||
      blocks > qtiles * heads || qtiles * heads > (1LL << 30))
    return (int)cudaErrorInvalidValue;
  CUtensorMap maps[4];
  int rc = bwd_maps(maps, q, k, v, dout, HD, S, heads, kv_heads, BQ, Gm::BK);
  if (rc) return rc;
  auto kernel = swa_bwd_dq_wgmma<HD>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Gm::DQ_SMEM);
  if (e != cudaSuccess) return (int)e;
  kernel<<<blocks, NT, Gm::DQ_SMEM, st>>>(maps[0], maps[1], maps[2], maps[3], lse, delta, dq, S,
                                          heads / kv_heads, heads, (int)qtiles, window, scale);
  return 0;
}

// The same for dk/dv (kv_heads, S, HD); (bkey, bqs, blocks) from
// kernels/swa_attention.py dkdv_geometry and walk_blocks.
template <int HD>
int launch_bwd_dkdv(const void* q, const void* k, const void* v, const void* dout,
                    const float* lse, const float* delta, float* dk, float* dv, int heads,
                    int kv_heads, int S, int window, float scale, int bkey, int bqs, int blocks,
                    cudaStream_t st) {
  using Gm = BwdGeo<HD>;
  const long long ktiles = (S + Gm::BKEY - 1) / Gm::BKEY;
  if (bkey != Gm::BKEY || bqs != BQS || heads % kv_heads || blocks < 1 ||
      blocks > ktiles * kv_heads || ktiles * kv_heads > (1LL << 30))
    return (int)cudaErrorInvalidValue;
  CUtensorMap maps[4];
  int rc = bwd_maps(maps, q, k, v, dout, HD, S, heads, kv_heads, BQS, Gm::BKEY);
  if (rc) return rc;
  auto kernel = swa_bwd_dkdv_wgmma<HD>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Gm::KV_SMEM);
  if (e != cudaSuccess) return (int)e;
  kernel<<<blocks, NT, Gm::KV_SMEM, st>>>(maps[0], maps[1], maps[2], maps[3], lse, delta, dk, dv,
                                          S, heads / kv_heads, kv_heads, (int)ktiles, window,
                                          scale);
  return 0;
}

}  // namespace swa_tc
