// f32-accurate matrix products on Hopper's tensor cores: the product tile
// shared by block_precond (kfac_precond.cu) and the three Newton-Schulz
// kernels, resident and tiled (newton_schulz.cu).
//
// A tile is C[TN x TM] of C = Q P, for Q (rows x K) and P (K x cols), both
// f32 and row-major. It runs on wgmma m64nTNk8 .f32.tf32.tf32 as
// C^T = P^T Q^T: wgmma reads a 32-bit operand from shared memory only
// K-major (the transpose bits exist for 16-bit types alone), and Q's rows
// are K-contiguous, so Q is the B operand (N = C's rows), read from shared
// memory in the 128-byte swizzle TMA writes; P^T is the A operand (M = C's
// columns), taken from registers, which each consumer thread gathers from
// P's rows in shared memory (in any layout: here column panels in the
// 64-byte swizzle, free of bank conflicts, p_offset). Consumer warpgroup
// cw owns C's columns 64 cw .. 64 cw + 63 of the tile. Inside a
// warpgroup's 64, wgmma row 16 w + g + 8 h (warp w, lane group g, h 0 or 1)
// stands for column 16 w + 2 g + h, so a thread's A fragment is two 8-byte
// loads and its output two adjacent columns.
//
// The split (3xTF32): x = hi + lo with hi = tf32(x) (cvt.rna, to nearest)
// and lo = tf32(x - hi); x - hi is exact in f32, so hi + lo keeps x to
// about 2^-22 of |x| where one TF32 keeps 2^-11. Each k8 step runs three
// products, lo_A hi_B, hi_A lo_B and hi_A hi_B (lo lo is below 2^-22 of
// the product), which puts the result at f32 accuracy: the split product
// holds the 1e-4 (block preconditioning) and 1e-5 (Newton-Schulz) bounds
// that one TF32 product leaves (tests/test_torch_f32_split_gemm.py). A
// operands (P) split in registers as they are gathered; the B operand (Q)
// splits once per stage in shared memory: TMA lands the raw tile where hi
// goes, seven producer warps overwrite it with hi and write lo beside it.
// The tensor cores do not add into their accumulator as an f32 fmaf does
// (round to nearest): so that their rounding acts over a stage's 32 terms
// only, not over all of K, a stage's twelve products go to a fresh partial
// (the first with scale-d 0), which an f32 add folds into the tile's
// accumulator.
//
// Rates: three TF32 products at 495 TFLOP/s dense are 165 TFLOP/s of f32
// work, 2.5x the f32 CUDA cores' 67 (chip_smoke.py PEAK_SPLIT_F32_OPS_PER_S).
//
// The pipeline: a block is four warpgroups, two producers and two
// consumers, over a ring of STAGES stages of BK = 32 deep (Q hi, Q lo, P).
// With TMA, one producer thread loads each stage's Q box (K-major,
// swizzled) and P panels (p_offset) and completes the stage's `raw`
// barrier; the other seven producer warps split Q and arrive on `full`
// (the split is the producers' costliest step, so it gets seven warps, not
// the three one producer warpgroup would leave); each consumer
// warp releases the stage on `empty` once its products are done. Without
// TMA (rows or blocks off 16-byte alignment), the 256 producer threads load
// the elements, split Q in registers and write the same layout. Every tile
// sums its K in one fixed order in one block, with no atomics, so two
// launches give the same bits.
#pragma once

#include <string.h>

#include "common.cuh"
#include "hopper.cuh"

namespace f32g {

using namespace hopper;

constexpr int BK = 32;     // contraction per stage: one 128-byte row of f32
constexpr int TM = 128;    // C columns per tile: two consumer warpgroups of 64
constexpr int PRODUCERS = 256;  // two producer warpgroups
constexpr int NT = PRODUCERS + 256;   // + two consumer warpgroups
constexpr int SPLITTERS = PRODUCERS - 32;   // producer threads that split Q (warps 1-7)

template <int TN>
struct Geo {
  static_assert(TN == 64 || TN == 128, "C rows per tile: 64 or 128");
  static constexpr int Q_BYTES = TN * BK * 4;     // one copy of the Q tile
  static constexpr int P_BYTES = BK * TM * 4;     // 16 KB
  static constexpr int STAGE = 2 * Q_BYTES + P_BYTES;
  static constexpr int STAGES = 192 * 1024 / STAGE;   // 4 at TN 128, 6 at TN 64
  static constexpr int SMEM = STAGES * STAGE + 1024;  // + room to align to 1 KB
  static constexpr int FRAG = TN / 2;   // accumulators per consumer thread (m64nTN)
  static constexpr int TX = Q_BYTES + P_BYTES;        // TMA bytes per stage
};

// The ring: stage st holds Q hi (TMA lands raw Q there), Q lo, P; barriers
// raw[st] (TMA), full[st] (Q split) and empty[st] (released). P is stored
// as TM / 16 column panels of BK rows of 64 bytes in the 64-byte swizzle
// (p_offset), which spreads a consumer warp's fragment loads over all 32
// banks (plain 512-byte rows would put the four rows a warp reads on the
// same 16 banks).
template <int TN>
struct Ring {
  uint32_t base, raw0, full0, empty0;
  __device__ __forceinline__ uint32_t q_hi(int st) const { return base + st * Geo<TN>::STAGE; }
  __device__ __forceinline__ uint32_t q_lo(int st) const { return q_hi(st) + Geo<TN>::Q_BYTES; }
  __device__ __forceinline__ uint32_t p(int st) const { return q_hi(st) + 2 * Geo<TN>::Q_BYTES; }
  __device__ __forceinline__ uint32_t raw(int st) const { return raw0 + 8 * st; }
  __device__ __forceinline__ uint32_t full(int st) const { return full0 + 8 * st; }
  __device__ __forceinline__ uint32_t empty(int st) const { return empty0 + 8 * st; }
};

// bars: 3 * STAGES mbarriers in shared memory; the caller syncs the block
// (or cluster) before anyone uses the ring
template <int TN>
__device__ __forceinline__ Ring<TN> ring_init(unsigned char* smem, uint64_t* bars, bool tma) {
  constexpr int S = Geo<TN>::STAGES;
  Ring<TN> r;
  r.base = (smem_addr(smem) + 1023u) & ~1023u;
  r.raw0 = smem_addr(bars);
  r.full0 = r.raw0 + 8 * S;
  r.empty0 = r.full0 + 8 * S;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(r.raw(s), 1);
      mbar_init(r.full(s), tma ? SPLITTERS : PRODUCERS);
      mbar_init(r.empty(s), 8);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  return r;
}

// byte offset of P's element (row k, column m) in a stage: panel m / 16,
// row k of 64 bytes, its 16-byte chunk XOR-ed with (k / 2) mod 4 (what TMA
// writes for a {16, BK} box in CU_TENSOR_MAP_SWIZZLE_64B)
__device__ __forceinline__ uint32_t p_offset(int k, int m) {
  return (m >> 4) * (BK * 64) + k * 64 + ((((m & 15) >> 2) ^ ((k >> 1) & 3)) << 4) + (m & 3) * 4;
}

// the P box of one stage, columns col0 .. col0 + TM - 1 and rows k0 ..
// k0 + BK - 1 of a 2-D (rank 2, z ignored) or 3-D map, as TM / 16 panels
__device__ __forceinline__ void tma_load_p(uint32_t dst, const CUtensorMap* map, int rank,
                                           int col0, int k0, int z, uint32_t bar) {
#pragma unroll
  for (int j = 0; j < TM / 16; ++j) {
    if (rank == 2)
      tma_load(dst + j * (BK * 64), map, col0 + 16 * j, k0, bar);
    else
      tma_load(dst + j * (BK * 64), map, col0 + 16 * j, k0, z, bar);
  }
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both TF32 (low 13 bits zero), hi rounded to nearest
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void st_shared_v4(uint32_t addr, const uint32_t (&v)[4]) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v[0]), "r"(v[1]),
               "r"(v[2]), "r"(v[3])
               : "memory");
}

// the producers' splitter warps (sp = 0 .. SPLITTERS - 1): the stage's raw
// Q (where TMA landed it) becomes hi in place, and lo beside it
template <int TN>
__device__ __forceinline__ void split_stage(const Ring<TN>& ring, int st, int sp) {
  const uint32_t hi = ring.q_hi(st), lo = ring.q_lo(st);
  for (int u = sp; u < Geo<TN>::Q_BYTES / 16; u += SPLITTERS) {
    float x[4];
    asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                 : "=f"(x[0]), "=f"(x[1]), "=f"(x[2]), "=f"(x[3])
                 : "r"(hi + 16 * u)
                 : "memory");
    uint32_t h[4], l[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split(x[e], h[e], l[e]);
    st_shared_v4(hi + 16 * u, h);
    st_shared_v4(lo + 16 * u, l);
  }
}

// The element loaders of the PRODUCERS threads (lt), for shapes TMA
// cannot address. Q: rows [row0, row0 + TN) x K [k0, k0 + BK) of q (row
// stride ld), entries at or past row `rows` or K `k_lim` as 0, split, at
// the swizzled K-major places TMA writes (row n's 16-byte chunk c at
// n * 128 + ((c ^ (n mod 8)) << 4)).
template <int TN>
__device__ __forceinline__ void load_q_elements(const Ring<TN>& ring, int st,
                                                const float* __restrict__ q, int ld, int rows,
                                                int k_lim, int row0, int k0, int lt) {
  for (int u = lt; u < TN * BK / 4; u += PRODUCERS) {
    const int n = u / 8, c = u % 8;
    const int row = row0 + n;
    uint32_t h[4], l[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = k0 + 4 * c + e;
      const float x = (row < rows && k < k_lim) ? __ldcg(q + (size_t)row * ld + k) : 0.f;
      split(x, h[e], l[e]);
    }
    const uint32_t off = n * 128 + ((c ^ (n & 7)) << 4);
    st_shared_v4(ring.q_hi(st) + off, h);
    st_shared_v4(ring.q_lo(st) + off, l);
  }
}

// P: rows (K) [k0, k0 + BK) x columns [col0, col0 + TM) of p (row stride
// ld), entries at or past K `k_lim` or column `cols` as 0, at p_offset
template <int TN>
__device__ __forceinline__ void load_p_elements(const Ring<TN>& ring, int st,
                                                const float* __restrict__ p, int ld, int k_lim,
                                                int cols, int k0, int col0, int lt) {
  const uint32_t dst = ring.p(st);
  for (int u = lt; u < BK * TM; u += PRODUCERS) {
    const int k = k0 + u / TM, m = col0 + u % TM;
    const float x = (k < k_lim && m < cols) ? __ldcg(p + (size_t)k * ld + m) : 0.f;
    asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(dst + p_offset(u / TM, u % TM)), "f"(x)
                 : "memory");
  }
}

#define F32G_D8(i)                                                                     \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),         \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define F32G_D32 F32G_D8(0), F32G_D8(8), F32G_D8(16), F32G_D8(24)
#define F32G_D64 F32G_D32, F32G_D8(32), F32G_D8(40), F32G_D8(48), F32G_D8(56)
#define F32G_R32                                                                       \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "             \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define F32G_R64                                                                       \
  F32G_R32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "  \
           "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, " \
           "%61, %62, %63"

// d[64 x N] (+)= A[64 x 8] B[8 x N], TF32: A from registers (a0..a3: rows
// g and g + 8 of the warp's 16 at K q, then at K q + 4), B K-major in
// shared memory; acc 0 overwrites d
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db,
                                           int acc);

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                               int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {" F32G_R32
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : F32G_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_tf32<128>(float (&d)[64], const uint32_t (&a)[4],
                                                uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {" F32G_R64
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : F32G_D64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

#undef F32G_D8
#undef F32G_D32
#undef F32G_D64
#undef F32G_R32
#undef F32G_R64

// A consumer thread's A fragments of stage st (warpgroup cw, thread t of
// its 128): P[K 8 kk + lane mod 4 (+ 4)][column 64 cw + 16 warp + 2 (lane
// / 4), + 1] for the four k8 steps kk, split into hi and lo
__device__ __forceinline__ void gather_frags(uint32_t (&hi)[BK / 8][4], uint32_t (&lo)[BK / 8][4],
                                             uint32_t p_stage, int cw, int t) {
  const int lane = t % 32;
  const int m = cw * 64 + (t / 32) * 16 + (lane / 4) * 2;
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float x, y;
      asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
                   : "=f"(x), "=f"(y)
                   : "r"(p_stage + p_offset(8 * kk + 4 * h + lane % 4, m))
                   : "memory");
      split(x, hi[kk][2 * h], lo[kk][2 * h]);
      split(y, hi[kk][2 * h + 1], lo[kk][2 * h + 1]);
    }
  }
}

// Issue one stage's twelve products into part (the first overwrites it):
// per k8 step lo_A hi_B, hi_A lo_B, hi_A hi_B, in a fixed order. Not
// waited for.
template <int TN>
__device__ __forceinline__ void issue_stage(float (&part)[TN / 2], const uint32_t (&hi)[BK / 8][4],
                                            const uint32_t (&lo)[BK / 8][4], uint32_t qh,
                                            uint32_t ql) {
  fence_operands(part);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk) {
    // K 8 kk .. 8 kk + 7 of every Q row: 32 bytes into its 128-byte row
    const uint64_t bh = desc(qh + kk * 32, 16, 1024);
    const uint64_t bl = desc(ql + kk * 32, 16, 1024);
    wgmma_tf32<TN>(part, lo[kk], bh, kk);
    wgmma_tf32<TN>(part, hi[kk], bl, 1);
    wgmma_tf32<TN>(part, hi[kk], bh, 1);
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// f(row, col, c0, c1) for each pair of a consumer thread's accumulators:
// C[row][col] is c0 and C[row][col + 1] is c1 (references into acc), row
// and col relative to the tile (col even)
template <int TN, typename F>
__device__ __forceinline__ void for_each_pair(float (&acc)[TN / 2], int cw, int t, F&& f) {
  const int lane = t % 32;
  const int col = cw * 64 + (t / 32) * 16 + (lane / 4) * 2;
#pragma unroll
  for (int j = 0; j < TN / 8; ++j) {
    const int row = 8 * j + 2 * (lane % 4);
    f(row, col, acc[4 * j], acc[4 * j + 2]);
    f(row + 1, col, acc[4 * j + 1], acc[4 * j + 3]);
  }
}

// A consumer's whole tile: `stages` stages from ring position `it` on,
// summed into acc (zeroed first); `it` advances past them. Each stage's
// products are waited for before the next stage's fragments are gathered
// (gathering them while the products ran, in a second register set, was
// tried: no faster, and it spilled in the resident kernel).
template <int TN, bool TMA>
__device__ __forceinline__ void tile_product(float (&acc)[TN / 2], const Ring<TN>& ring, int& it,
                                             int stages, int cw, int t) {
  constexpr int S = Geo<TN>::STAGES;
  float part[TN / 2];
  uint32_t hi[BK / 8][4], lo[BK / 8][4];
#pragma unroll
  for (int r = 0; r < TN / 2; ++r) acc[r] = 0.f;
  for (int s = 0; s < stages; ++s, ++it) {
    const int st = it % S;
    const uint32_t par = (it / S) & 1;
    if (TMA) mbar_wait(ring.raw(st), par);   // P arrived (the splitters saw it too)
    mbar_wait(ring.full(st), par);
    gather_frags(hi, lo, ring.p(st), cw, t);
    issue_stage<TN>(part, hi, lo, ring.q_hi(st), ring.q_lo(st));
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_operands(part);
    if (t % 32 == 0) mbar_arrive(ring.empty(st));
#pragma unroll
    for (int r = 0; r < TN / 2; ++r) acc[r] += part[r];
  }
}

// The producer side of one tile with TMA: producer thread 0 (pt) issues
// `load(dst_q, dst_p, bar, k0)` per stage once the stage is free; the
// splitter warps (pt 32 .. PRODUCERS - 1) split each stage's Q.
template <int TN, typename Load>
__device__ __forceinline__ void tile_produce_tma(const Ring<TN>& ring, int& it, int stages, int pt,
                                                 Load&& load) {
  constexpr int S = Geo<TN>::STAGES;
  for (int s = 0; s < stages; ++s, ++it) {
    const int st = it % S;
    const uint32_t par = (it / S) & 1;
    if (pt == 0) {
      mbar_wait(ring.empty(st), par ^ 1);
      mbar_expect_tx(ring.raw(st), Geo<TN>::TX);
      load(ring.q_hi(st), ring.p(st), ring.raw(st), s * BK);
    } else if (pt >= 32) {
      mbar_wait(ring.raw(st), par);
      split_stage<TN>(ring, st, pt - 32);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(ring.full(st));
    }
  }
}

// The producer side of one tile without TMA: all PRODUCERS threads load,
// split and store each stage once it is free.
template <int TN>
__device__ __forceinline__ void tile_produce_elements(const Ring<TN>& ring, int& it, int stages,
                                                      int pt, const float* q, int ldq, int q_rows,
                                                      int q_row0, const float* p, int ldp,
                                                      int p_cols, int p_col0, int k_lim) {
  constexpr int S = Geo<TN>::STAGES;
  for (int s = 0; s < stages; ++s, ++it) {
    const int st = it % S;
    mbar_wait(ring.empty(st), ((it / S) & 1) ^ 1);
    load_q_elements<TN>(ring, st, q, ldq, q_rows, k_lim, q_row0, s * BK, pt);
    load_p_elements<TN>(ring, st, p, ldp, k_lim, p_cols, s * BK, p_col0, pt);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_arrive(ring.full(st));
  }
}

// An f32 tensor map of `rank` dimensions (innermost first; strides in bytes
// of dimensions 1..rank-1) read in boxes: the Q operand's {BK, TN} in the
// 128-byte swizzle (K-major rows of 128 bytes), the P operand's {16, BK}
// panels in the 64-byte swizzle. Out-of-range elements read as zero.
inline int encode_q(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
                    const cuuint64_t* strides, int tn) {
  const cuuint32_t box[3] = {BK, (cuuint32_t)tn, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, base, rank, dims, strides, box,
                CU_TENSOR_MAP_SWIZZLE_128B);
}

inline int encode_p(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
                    const cuuint64_t* strides) {
  const cuuint32_t box[3] = {16, BK, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, base, rank, dims, strides, box,
                CU_TENSOR_MAP_SWIZZLE_64B);
}

}  // namespace f32g
