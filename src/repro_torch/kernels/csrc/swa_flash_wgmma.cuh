// The tensor-core tile walk of the two causal(-window) attention forwards
// for bf16 inputs: each query tile's online-softmax sweep over the key
// tiles of its band, both products on wgmma, operands brought by TMA.
// swa_flash_fwd.cu (GQA layout, with the logsumexp residual) and
// swa_flash.cu ((BH, S, hd) layout, output only) launch the same kernel;
// their f32 instances keep the CUDA-core walk of swa_flash_tile.cuh.
//
// A work item is one 128-row query tile of one query head. A block of 384
// threads is a producer warpgroup, of which one thread issues every TMA
// load, and two consumer warpgroups, consumer w owning rows 64w..64w+63 of
// the item's tile. The blocks are persistent, one per SM: the producer
// loads an item's Q tile into one of two buffers (the next item's Q comes
// in while the consumers finish the current one), then keeps a ring of
// Geo<hd>::ST K/V tiles in flight through mbarriers (BK keys a tile: 128
// at hd 64, 64 at hd 128 and 192, so a stage is 32 KB at hd 64 and 128,
// three of them, and 48 KB at hd 192, two of them: three would need 241 KB
// of the 227 KB a block may have), running on from one item into the next. Each consumer warp releases a stage once its products
// of that tile are done, and a Q buffer once its item's products are, so
// no block-wide barrier runs in the loop. The tensor maps are 3-D (hd, S,
// heads), so rows past S arrive as zeros rather than the next head's rows;
// keys past S are masked and queries past S are not stored, so the
// wrappers pad nothing.
//
// Per key tile, each consumer warpgroup:
//   S = Q K^T   wgmma m64nBKk16 .f32.bf16.bf16, Q and K both K-major (hd
//               contiguous) in the 128-byte swizzle TMA writes; the bf16
//               products are exact in f32, the scale hd^-0.5 is applied to
//               the f32 score (exact at hd 64)
//   softmax     online, in f32 on the accumulator fragment: a thread holds
//               two rows, their max taken by two shuffles within the four
//               threads of a row, the row sums joined once at the end;
//               only the tiles that cross the band's edge (or S) evaluate
//               the mask
//   O += P V    P split as P_hi = P cut to its top 16 bits (a bf16) and
//               P_lo = bf16(P - P_hi), two wgmma m64nHDk16 with A (P) from
//               registers and B = V from shared memory, read MN-major
//               through the transpose bit. One bf16 P would put a relative
//               error of up to 2^-9 in every term; P_hi + P_lo is within
//               2^-16 of P, which keeps the result within one bf16
//               rounding of the f32 attention.
// Key j is visible to query i iff i - window < j <= i (window 0: causal).
// The denominator is clamped at 1e-30 and lse = m + log(d) in f32.
//
// Registers: the producer warpgroup drops to 40 a thread (setmaxnreg) and
// the consumers rise to 232, so ptxas keeps the scores, the split P and the
// output accumulators of a 128-key tile in registers with no spill (at hd
// 192: 96 output accumulators, 32 scores and 32 words of split P).
//
// What bounds it: at hd 64 the softmax's f32 instructions (about ten per
// score) and the tensor cores' work (three products of 2 * 64 * hd
// operations per 64 x 16 score slice) are of one order, so the instruction
// count of the softmax sets the time as much as the products do.
//
// Items go out longest first (query tiles from the last, heads fastest),
// and block b of B takes items b, 2B - 1 - b, 2B + b, ... (a snake, so the
// blocks with the longest causal tiles get the shortest ones next). Each
// item's sums run in a fixed order in one block, so two launches on the
// same inputs give the same bits. kernels/swa_attention.py walk_geometry,
// key_tiles, tile_masked, walk_blocks and block_items mirror the geometry
// for the CPU tests.
#pragma once

#include <string.h>

#include "common.cuh"
#include "hopper.cuh"

namespace swa_tc {

using namespace hopper;

constexpr int BQ = 128;      // query rows per block: two consumer warpgroups of 64
constexpr int NT = 384;      // producer warpgroup + two consumer warpgroups
constexpr float LOG2E = 1.4426950408889634f;

// 2^x in one MUFU instruction (relative error ~2^-22; results below 2^-126
// flush to 0, where P is far below anything the sums can hold)
__device__ __forceinline__ float exp2_(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int HD>
struct Geo {
  static_assert(HD == 64 || HD == 128 || HD == 192, "head dims 64, 128, 192");
  static constexpr int BK = HD == 64 ? 128 : 64;   // keys per tile
  static constexpr int ST = HD == 192 ? 2 : 3;      // K/V ring depth
  static constexpr int HALVES = HD / 64;            // 64-column (128-byte) atoms of a row
  static constexpr int Q_HALF = BQ * 128;           // one atom column of the Q tile
  static constexpr int KV_HALF = BK * 128;          // of a K or V tile
  static constexpr int Q_BYTES = HALVES * Q_HALF;
  static constexpr int KV_BYTES = HALVES * KV_HALF;
  static constexpr int STAGE = 2 * KV_BYTES;        // K then V
  static constexpr int SMEM = 2 * Q_BYTES + ST * STAGE + 1024;   // + room to align to 1 KB
  static constexpr int SFRAG = BK / 2;   // score accumulators per consumer thread (m64nBK)
  static constexpr int OFRAG = HD / 2;   // output accumulators (m64nHD)
};

// The key tiles of query tile q0 (its first row): from the one holding the
// lowest row's first visible key to the one holding the last row
// (kernels/swa_attention.py key_tiles).
__device__ __forceinline__ void key_tiles(int q0, int S, int window, int bk, int& lo, int& hi) {
  const int q_hi = min(q0 + BQ - 1, S - 1);
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  lo = k_lo / bk;
  hi = q_hi / bk;
}

// every key of the tile visible to every row of the query tile, so no mask
// (kernels/swa_attention.py tile_masked)
__device__ __forceinline__ bool interior(int q0, int k0, int window, int bk) {
  return k0 + bk - 1 <= q0 && (window <= 0 || k0 > q0 + BQ - 1 - window);
}

#define SWA_D8(i)                                                                      \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),         \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define SWA_D32 SWA_D8(0), SWA_D8(8), SWA_D8(16), SWA_D8(24)
#define SWA_D64 SWA_D32, SWA_D8(32), SWA_D8(40), SWA_D8(48), SWA_D8(56)
#define SWA_D96 SWA_D64, SWA_D8(64), SWA_D8(72), SWA_D8(80), SWA_D8(88)
#define SWA_R32                                                                        \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "             \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define SWA_R64                                                                        \
  SWA_R32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "   \
          "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, "  \
          "%61, %62, %63"
#define SWA_R96                                                                        \
  SWA_R64 ", %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, "   \
          "%78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "  \
          "%93, %94, %95"

// d[64 x N] (+)= A[64 x 16] B[16 x N], A and B K-major in shared memory;
// acc 0 overwrites d
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int acc);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" SWA_R32
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : SWA_D32
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" SWA_R64
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : SWA_D64
      : "l"(da), "l"(db), "r"(acc));
}

// d[64 x N] += A[64 x 16] B[16 x N], A (bf16 pairs) from registers in the
// accumulator's row/column layout, B MN-major in shared memory
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" SWA_R32
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : SWA_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" SWA_R64
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : SWA_D64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<192>(float (&d)[96], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {" SWA_R96
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : SWA_D96
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef SWA_D8
#undef SWA_D32
#undef SWA_D64
#undef SWA_D96
#undef SWA_R32
#undef SWA_R64
#undef SWA_R96

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// One key tile's softmax update of a consumer thread's two rows (row0 and
// row0 + 8 of the warpgroup's 64): s holds its raw scores (entry r: row
// row0 + 8 ((r >> 1) & 1), key k0 + 8 (r >> 2) + 2 (lane mod 4) + r mod 2)
// and becomes P = exp(scale (s - m_new)); m and d are updated, and corr
// is the factor the rows' output must be rescaled by.
template <int BK, bool MASK>
__device__ __forceinline__ void softmax_scores(float (&s)[BK / 2], float (&m)[2], float (&d)[2],
                                               float (&corr)[2], int row0, int k0, int lane,
                                               int window, float c) {
  constexpr int SF = BK / 2;
  if (MASK) {
#pragma unroll
    for (int r = 0; r < SF; ++r) {
      const int row = row0 + ((r >> 1) & 1) * 8;
      const int key = k0 + (r >> 2) * 8 + (lane & 3) * 2 + (r & 1);
      const bool vis = key <= row && (window <= 0 || key > row - window);
      s[r] = vis ? s[r] : REPRO_NEG_INF;
    }
  }
  float mx[2] = {REPRO_NEG_INF, REPRO_NEG_INF};
#pragma unroll
  for (int r = 0; r < SF; ++r) mx[(r >> 1) & 1] = fmaxf(mx[(r >> 1) & 1], s[r]);
  float mc[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(m[h], mx[h]);
    corr[h] = exp2_((m[h] - m_new) * c);
    mc[h] = m_new * c;
    m[h] = m_new;
  }
  float ps[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < SF; ++r) {
    const int h = (r >> 1) & 1;
    float p = exp2_(fmaf(s[r], c, -mc[h]));
    if (MASK) p = s[r] > REPRO_MASKED ? p : 0.f;
    s[r] = p;
    ps[h] += p;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) d[h] = d[h] * corr[h] + ps[h];
}

// P (the scores' registers after softmax_scores) split into pa[k16
// slice][hi, lo][4] in wgmma's A layout
template <int BK>
__device__ __forceinline__ void split_p(const float (&s)[BK / 2], uint32_t (&pa)[BK / 16][2][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      // e: (row0, keys +0/1), (row0 + 8, +0/1), (row0, +8/9), (row0 + 8, +8/9)
      const float a = s[8 * kk + 2 * e];
      const float b = s[8 * kk + 2 * e + 1];
      // P_hi: the top 16 bits (bf16 by truncation), the pair packed by one
      // byte permute; P_lo = bf16(P - P_hi), P - P_hi exact in f32
      const uint32_t ab = __float_as_uint(a) & 0xffff0000u;
      const uint32_t bb = __float_as_uint(b) & 0xffff0000u;
      pa[kk][0][e] = __byte_perm(ab, bb, 0x7632);
      pa[kk][1][e] = pack_bf16(a - __uint_as_float(ab), b - __uint_as_float(bb));
    }
  }
}

// keep split operands in registers ahead of the products that read them
template <int K16>
__device__ __forceinline__ void fence_split(uint32_t (&a)[K16][2][4]) {
#pragma unroll
  for (int kk = 0; kk < K16; ++kk)
#pragma unroll
    for (int e = 0; e < 8; ++e) asm volatile("" : "+r"(a[kk][e / 4][e % 4])::"memory");
}

// A bf16 tensor map (hd, S, heads) over rows of hd elements, boxes of 64
// columns (one 128-byte swizzle atom) by `rows` rows; rows past S read as
// zero. 0 or a CUDA error code.
inline int encode_rows(CUtensorMap* map, const void* base, int hd, int S, int heads, int rows) {
  const cuuint64_t strides[2] = {(cuuint64_t)hd * 2, (cuuint64_t)S * hd * 2};
  const cuuint64_t dims[3] = {(cuuint64_t)hd, (cuuint64_t)S, (cuuint64_t)heads};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  return encode_bf16(map, base, 3, dims, strides, box);
}

// Work item i of a launch: query tile qtiles - 1 - i / heads (longest
// first), query head i % heads. Block b of `blocks` takes items b,
// 2 blocks - 1 - b, 2 blocks + b, ... (a snake over rounds of `blocks`
// items, so a block with a long item in one round gets a short one in the
// next); kernels/swa_attention.py block_items.
__device__ __forceinline__ int item_of(int r, int b, int blocks) {
  return r * blocks + ((r & 1) ? blocks - 1 - b : b);
}

// q map (hd, S, query heads), k/v maps (hd, S, KV heads); query head h
// reads KV head h / G; out (heads, S, HD) bf16; lse (heads, S) when LSE
template <int HD, bool LSE>
__global__ void __launch_bounds__(NT, 1)
forward_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
               const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ out,
               float* __restrict__ lse, int S, int G, int heads, int qtiles, int window,
               float scale) {
  using Gm = Geo<HD>;
  constexpr int BK = Gm::BK;
  constexpr int STAGES = Gm::ST;
  const int items = heads * qtiles;

  extern __shared__ unsigned char smem_raw[];
  // qfull[2], qempty[2], full[STAGES], empty[STAGES]
  __shared__ __align__(8) uint64_t bars[4 + 2 * STAGES];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t qfull0 = smem_addr(bars);
  const uint32_t qempty0 = qfull0 + 16;
  const uint32_t full0 = qfull0 + 32;
  const uint32_t empty0 = full0 + 8 * STAGES;
  const uint32_t kv0 = base + 2 * Gm::Q_BYTES;   // after the two Q buffers
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
    // producer: per item, its Q tile into buffer n % 2 once the consumers
    // are done with that buffer's previous item, then K/V tile `it` into
    // stage it % STAGES once the consumers have released its previous round
    // its warpgroup gives registers back for the consumers' (40 + 2 x 232
    // per thread = 504 of the SM's 512)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x != 0) return;
    int it = 0;
    for (int n = 0;; ++n) {
      const int i = item_of(n, blockIdx.x, gridDim.x);
      if (i >= items) break;
      const int q0 = (qtiles - 1 - i / heads) * BQ;
      const int h = i % heads;
      const int kvh = h / G;
      const uint32_t qf = qfull0 + 8 * (n & 1);
      const uint32_t qs = base + (n & 1) * Gm::Q_BYTES;
      mbar_wait(qempty0 + 8 * (n & 1), ((n >> 1) & 1) ^ 1);
      mbar_expect_tx(qf, Gm::Q_BYTES);
#pragma unroll
      for (int a = 0; a < Gm::HALVES; ++a) tma_load(qs + a * Gm::Q_HALF, &qmap, 64 * a, q0, h, qf);
      int t_lo, t_hi;
      key_tiles(q0, S, window, BK, t_lo, t_hi);
      for (int kt = t_lo; kt <= t_hi; ++kt, ++it) {
        const int st = it % STAGES;
        const uint32_t full = full0 + 8 * st;
        const uint32_t ks = kv0 + st * Gm::STAGE;
        mbar_wait(empty0 + 8 * st, ((it / STAGES) & 1) ^ 1);
        mbar_expect_tx(full, Gm::STAGE);
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
    const uint32_t qa = base + (n & 1) * Gm::Q_BYTES + cw * 64 * 128;
    int t_lo, t_hi;
    key_tiles(q0, S, window, BK, t_lo, t_hi);
    float o[Gm::OFRAG];
#pragma unroll
    for (int r = 0; r < Gm::OFRAG; ++r) o[r] = 0.f;
    float m[2] = {REPRO_NEG_INF, REPRO_NEG_INF};
    float d[2] = {0.f, 0.f};
    mbar_wait(qfull0 + 8 * (n & 1), (n >> 1) & 1);

    for (int kt = t_lo; kt <= t_hi; ++kt, ++it) {
      const int st = it % STAGES;
      const uint32_t ks = kv0 + st * Gm::STAGE;
      const uint32_t vs = ks + Gm::KV_BYTES;
      mbar_wait(full0 + 8 * st, (it / STAGES) & 1);

      float s[Gm::SFRAG];
#pragma unroll
      for (int r = 0; r < Gm::SFRAG; ++r) s[r] = 0.f;
      fence_operands(s);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        // hd 16 kk.. of Q's and K's rows: 32 bytes into atom column kk / 4
        // (K-major, 128-byte swizzle: SBO the 1 KB between 8-row groups)
        const uint32_t off = (kk % 4) * 32;
        wgmma_ss<BK>(s, desc(qa + (kk / 4) * Gm::Q_HALF + off, 16, 1024),
                     desc(ks + (kk / 4) * Gm::KV_HALF + off, 16, 1024), 1);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_operands(s);

      uint32_t pa[BK / 16][2][4];
      float corr[2];
      const int k0 = kt * BK;
      if (interior(q0, k0, window, BK))
        softmax_scores<BK, false>(s, m, d, corr, row0, k0, lane, window, c);
      else
        softmax_scores<BK, true>(s, m, d, corr, row0, k0, lane, window, c);
#pragma unroll
      for (int r = 0; r < Gm::OFRAG; ++r) o[r] *= corr[(r >> 1) & 1];
      split_p<BK>(s, pa);
      fence_split(pa);
      fence_operands(o);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // keys 16 kk.. of V: 16 rows of 128 bytes; LBO the atom columns of
        // hd 128 and 192, SBO the 1 KB between 8-key groups
        const uint64_t db = desc(vs + kk * 16 * 128, Gm::KV_HALF, 1024);
        wgmma_rs<HD>(o, pa[kk][0], db);
        wgmma_rs<HD>(o, pa[kk][1], db);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_operands(o);
      // this warp's products of the tile are done: release its stage
      if (lane == 0) mbar_arrive(empty0 + 8 * st);
    }
    // every product of the item has read its Q buffer
    if (lane == 0) mbar_arrive(qempty0 + 8 * (n & 1));

    // epilogue: the four threads of a row join their partial denominators
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      d[hh] += __shfl_xor_sync(0xffffffffu, d[hh], 1);
      d[hh] += __shfl_xor_sync(0xffffffffu, d[hh], 2);
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + 8 * hh;
      if (row >= S) continue;
      const float den = fmaxf(d[hh], 1e-30f);
      const float inv = 1.f / den;
      __nv_bfloat16* op = out + ((size_t)h * S + row) * HD + (lane & 3) * 2;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        const __nv_bfloat162 v =
            __floats2bfloat162_rn(o[4 * j + 2 * hh] * inv, o[4 * j + 2 * hh + 1] * inv);
        *reinterpret_cast<__nv_bfloat162*>(op + 8 * j) = v;
      }
      if (LSE && (lane & 3) == 0) lse[(size_t)h * S + row] = m[hh] * scale + logf(den);
    }
  }
}

// 0 or a CUDA error code. q (heads, S, HD), k/v (kv_heads, S, HD), all
// bf16 on 16-byte aligned bases; (bq, bk, blocks) the caller's geometry
// (kernels/swa_attention.py walk_geometry and walk_blocks), refused
// unless (bq, bk) is this kernel's and 1 <= blocks <= the work items.
template <int HD, bool LSE>
int launch(const void* q, const void* k, const void* v, void* out, float* lse, int heads,
           int kv_heads, int S, int window, float scale, int bq, int bk, int blocks,
           cudaStream_t st) {
  using Gm = Geo<HD>;
  const long long qtiles = (S + BQ - 1) / BQ;
  if (bq != BQ || bk != Gm::BK || heads % kv_heads || blocks < 1 ||
      blocks > qtiles * heads || qtiles * heads > (1LL << 30)) {
    return (int)cudaErrorInvalidValue;
  }
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16)
    return (int)cudaErrorInvalidValue;
  CUtensorMap maps[3];
  memset(maps, 0, sizeof(maps));
  int rc = encode_rows(&maps[0], q, HD, S, heads, BQ);
  if (!rc) rc = encode_rows(&maps[1], k, HD, S, kv_heads, Gm::BK);
  if (!rc) rc = encode_rows(&maps[2], v, HD, S, kv_heads, Gm::BK);
  if (rc) return rc;
  auto kernel = forward_kernel<HD, LSE>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Gm::SMEM);
  if (e != cudaSuccess) return (int)e;
  kernel<<<blocks, NT, Gm::SMEM, st>>>(maps[0], maps[1], maps[2],
                                       static_cast<__nv_bfloat16*>(out), lse, S,
                                       heads / kv_heads, heads, (int)qtiles, window, scale);
  return 0;
}

// hd 64, 128 or 192
template <bool LSE>
int launch_hd(const void* q, const void* k, const void* v, void* out, float* lse, int heads,
              int kv_heads, int S, int hd, int window, float scale, int bq, int bk, int blocks,
              cudaStream_t st) {
  if (hd == 64)
    return launch<64, LSE>(q, k, v, out, lse, heads, kv_heads, S, window, scale, bq, bk, blocks,
                           st);
  if (hd == 128)
    return launch<128, LSE>(q, k, v, out, lse, heads, kv_heads, S, window, scale, bq, bk, blocks,
                            st);
  if (hd == 192)
    return launch<192, LSE>(q, k, v, out, lse, heads, kv_heads, S, window, scale, bq, bk, blocks,
                            st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace swa_tc
