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
// Bound: n*b*(b+1) operations per block against n*d input elements and
// nb*b*b f32 outputs (the wire variant: nb*b(b+1)/2 fp8 bytes and nb
// scales); at the training path's shapes (n 4096, b 512 or 2048) that is
// far above the H100's bytes/operation ratio, so the kernel is bound by
// operations, which for bf16 inputs means the tensor cores.
//
// bf16 inputs (every training, serving and fp8 path) take the tensor
// cores: wgmma.mma_async m64n128k16 .f32.bf16.bf16 (not the mma.sync
// fallback). A block owns one 128 x 128 output tile with tile row <= tile
// column (the upper triangle of tiles, grid.x enumerates those pairs;
// grid.z is the diagonal block of x, so all blocks of a site run in one
// launch). It is three warpgroups: a producer and two consumers; consumer
// w computes the tile's rows 64w..64w+63 against all 128 columns. x is
// (tokens, features) with features contiguous, so both operands of X^T X
// are MN-major: a stage holds a 64-token slice of the tile's row range and
// of its column range, each as two 64-feature halves of 64 rows of 128
// bytes in the 128-byte swizzle, which wgmma reads directly through its
// transpose bits (descriptor: LBO = the 8 KB between the halves, SBO = the
// 1 KB between 8-token groups). A diagonal tile loads one range and uses
// it for both operands. The producer fills a ring of STAGES = 6 stages
// (192 KB) through mbarriers: one thread issues TMA loads (64 x 64 boxes of
// a tensor map over x, swizzled by the copy engine; tokens past n and
// features past d arrive as zeros), and a consumer warpgroup releases a
// stage once its products of that slice are done, so no block-wide barrier
// runs in the loop. Shapes whose rows or block starts are not 16-byte
// aligned (a row stride or b that is not a multiple of 8 elements, e.g.
// d 2050 in blocks of 684), which TMA cannot address, take the same
// pipeline with the producer's 128 threads loading elements into the same
// swizzled layout. The products are exact in f32 and summed in f32, so
// only the summation order differs from the plain version.
//
// Filling the card: the work is the upper tiles times their 64-token
// slices, tile-major, and block w of the grid takes an equal contiguous
// run of it (stream-K; the wrapper, kernels/kfac.py syrk_geometry, picks
// the block count). A tile inside one block's run is stored from its
// registers; a tile that several blocks share gets a partial from each in
// a workspace, counted in the tile's arrival counter, and the last to
// arrive sums the partials in block order (so the result does not depend
// on which block finished last and is the same in every run; no float
// atomics) and stores the tile. The producer runs on into the next tile
// while the consumers store. At n 4096 on 132 SMs: b 512 (10 tiles) takes
// 80 blocks of 8 slices (each tile shared by 8), b 2048 nb 1 (136 tiles)
// 132 blocks of 66 slices; from two tiles per SM on (d 8192 nb 4, 544
// tiles), one block per tile, in waves, shares nothing.
//
// f32 inputs (the 2-layer f32 route checks) do not take the tensor cores:
// they keep the CUDA-core tile of simt_tile.cuh, 64 x 64 per block of 256
// threads, 4 x 4 per thread, 16 tokens deep, no split.
//
// Both bodies write each finished tile and, off the diagonal, its mirror,
// so out comes back whole and exactly symmetric (a diagonal tile of the
// tensor-core body writes its lower half and mirrors it).
//
// factor_syrk_wire: the TPU kernel keeps the (b, b) f32 sum in VMEM and
// quantizes it in its last grid step; a b <= 1024 block (4 MB) does not fit
// one SM's 227 KB. Here the same kernel writes the f32 sums to a scratch
// (nb, b, b) that stays in L2 at b <= 1024, and its epilogue atomicMax-es
// the bits of |A| of the finished tiles' lower-triangle entries (the ones
// the pack reads; an integer max is exact and independent of order) into
// the block's amax. A second launch reads the lower triangle row by row
// from the scratch and writes the sym-packed fp8 payload (nb, b(b+1)/2)
// and one scale per block, with the arithmetic of fp8_quant.cuh (that of
// quant_rows), so payload and scale are those of quant_rows on the
// scratch's sym-pack, bit for bit. A ragged b is masked.

#include <cuda.h>
#include <string.h>

#include "fp8_quant.cuh"
#include "simt_tile.cuh"

namespace {

// the upper-triangle tile pair (ti <= tj) of pair index bx, for both
// bodies (the CPU tests mirror it)
__device__ __forceinline__ void tile_pair(int bx, int tiles, int& ti, int& tj) {
  ti = 0;
  while (bx >= tiles - ti) {
    bx -= tiles - ti;
    ++ti;
  }
  tj = ti + bx;
}

// ---------------------------------------------------------------------------
// f32: the CUDA-core tile
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(simt::NT)
factor_syrk_kernel(const T* __restrict__ x, float* __restrict__ out, unsigned* __restrict__ amax,
                   int n, int ld, int d, int b, int tiles) {
  using simt::BK;
  using simt::TILE;
  int ti, tj;
  tile_pair(blockIdx.x, tiles, ti, tj);
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

// ---------------------------------------------------------------------------
// bf16: the tensor-core tile
// ---------------------------------------------------------------------------

namespace tc {

constexpr int TILE = 128;            // output tile edge
constexpr int BK = 64;               // tokens per stage
constexpr int STAGES = 6;            // ring depth
constexpr int NT = 384;              // producer warpgroup + two consumer warpgroups
constexpr int FRAG = 64;             // f32 accumulators per consumer thread (m64n128)
constexpr int HALF = 64 * BK * 2;    // one 64-feature half of a slice: 8 KB
constexpr int OPND = 2 * HALF;       // one operand's 128 features: 16 KB
constexpr int STAGE = 2 * OPND;      // both operands: 32 KB
constexpr int SMEM = STAGES * STAGE + 1024;   // + room to align to 1 KB

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of the 16-byte chunk c (features 8c..8c+7 of the operand's
// 128) of token k in a slice: half c/8, row k of 128 bytes, the chunk's
// place XOR-ed with k mod 8 (the 128-byte swizzle, on 1 KB-aligned rows;
// what TMA writes for a 64 x 64 box in CU_TENSOR_MAP_SWIZZLE_128B)
__device__ __forceinline__ uint32_t swizzled(int k, int c) {
  return (c >> 3) * HALF + k * 128 + (((c & 7) ^ (k & 7)) << 4);
}

// wgmma shared-memory descriptor, 128-byte swizzle
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | (uint64_t)1 << 62;
}

// d[64 x 128] += A[64 x 16] B[16 x 128], A and B MN-major in shared memory
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[FRAG], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void fence_operands(float (&d)[FRAG]) {
#pragma unroll
  for (int r = 0; r < FRAG; ++r) asm volatile("" : "+f"(d[r])::"memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// spin until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// one 64-feature x 64-token box of x (features c0.., tokens c1..) into
// shared memory at dst, completing `bar`'s transaction bytes
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// the element loader (rows or blocks off 16-byte alignment): BK tokens
// [t0, t0 + BK) x the 128 features [f0, f0 + 128) of the block into the
// operand slice at dst, by the producer warpgroup's 128 threads, in the
// layout TMA writes. Tokens at or past t_end and features at or past
// `valid` read as zero.
__device__ __forceinline__ void load_elements(uint32_t dst, const unsigned short* __restrict__ x,
                                              int ld, int col0, int f0, int valid, int t0,
                                              int t_end, int lt) {
#pragma unroll 4
  for (int r = 0; r < BK * 16 / 128; ++r) {
    const int q = lt + r * 128;
    const int k = q >> 4;
    const int c = q & 15;
    const int t = t0 + k;
    const int f = f0 + c * 8;
    const unsigned short* row = x + (size_t)t * ld + col0;
    unsigned v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const unsigned lo = (t < t_end && f + 2 * e < valid) ? row[f + 2 * e] : 0u;
      const unsigned hi = (t < t_end && f + 2 * e + 1 < valid) ? row[f + 2 * e + 1] : 0u;
      v[e] = lo | hi << 16;
    }
    asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst + swizzled(k, c)),
                 "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3])
                 : "memory");
  }
}

// The work is the (tile, slice) pairs in tile-major order: tile q = blk *
// pairs + pair index, slices of 64 tokens. Block w takes [w * per,
// (w + 1) * per) of it, so every block does the same work (stream-K); a
// tile that two or more blocks share is summed by the last of them to
// arrive, from their partials, in block order.
struct Work {
  int pairs, tiles, slices, per, total;
  __device__ __forceinline__ int first(int q) const { return q * slices / per; }
  __device__ __forceinline__ int last(int q) const { return ((q + 1) * slices - 1) / per; }
  // workspace slot of block w's partial of tile q: 2w for the tile its
  // range starts in, 2w + 1 for the one it ends in
  __device__ __forceinline__ int slot(int w, int q) const {
    return 2 * w + (q != (w * per) / slices);
  }
};

// store the finished tile (ti, tj) of block o (b x b) from consumer
// thread ct's accumulators, with its mirror (a diagonal tile: its lower
// half, mirrored), and fold its max |A| into *amax
__device__ __forceinline__ void store_tile(float* o, unsigned* amax, int b, int ti, int tj,
                                           int cw, int ct, const float (&acc)[FRAG]) {
  const bool diag = ti == tj;
  const int lane = ct % 32;
  unsigned m = 0u;
#pragma unroll
  for (int r = 0; r < FRAG; r += 2) {
    // accumulator r: row 16 warp + lane/4 (+8 for r mod 4 in {2, 3}) of
    // the warpgroup's 64, column 8 (r/4) + 2 (lane mod 4) + r mod 2
    const int i = ti * TILE + cw * 64 + ((ct % 128) / 32) * 16 + lane / 4 + ((r >> 1) & 1) * 8;
    const int j = tj * TILE + (lane % 4) * 2 + (r >> 2) * 8;
    if (i >= b) continue;
    // entries r and r + 1 are (i, j) and (i, j + 1), j even
    if (!diag && j + 1 < b && b % 2 == 0) {
      *reinterpret_cast<float2*>(o + (size_t)i * b + j) = make_float2(acc[r], acc[r + 1]);
      o[(size_t)j * b + i] = acc[r];
      o[(size_t)(j + 1) * b + i] = acc[r + 1];
      m = max(m, max(fp8q::abs_bits(acc[r]), fp8q::abs_bits(acc[r + 1])));
      continue;
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (j + e < b && (!diag || i >= j + e)) {
        o[(size_t)i * b + j + e] = acc[r + e];
        if (i != j + e) o[(size_t)(j + e) * b + i] = acc[r + e];
        m = max(m, fp8q::abs_bits(acc[r + e]));
      }
    }
  }
  if (amax) {
    m = __reduce_max_sync(0xffffffffu, m);
    if (ct % 32 == 0 && m) atomicMax(amax, m);
  }
}

template <bool TMA>
__global__ void __launch_bounds__(NT, 1)
factor_syrk_tc_kernel(const __grid_constant__ CUtensorMap map,
                      const __nv_bfloat16* __restrict__ x, float* __restrict__ out,
                      unsigned* __restrict__ amax, float* __restrict__ ws,
                      int* __restrict__ arrived, int n, int ld, int d, int b, Work wk) {
  const int w = blockIdx.x;
  const int g0 = w * wk.per;
  const int g1 = min(wk.total, g0 + wk.per);

  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * STAGES];   // full[s], then empty[s]
  __shared__ int is_last;
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t full0 = smem_addr(bars);
  const uint32_t empty0 = full0 + 8 * STAGES;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, TMA ? 1 : 128);
      mbar_init(empty0 + 8 * s, 2);   // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: fill stage it % STAGES with the block's it-th slice once
    // the consumers have released its previous round
    const int lt = threadIdx.x;
    if (TMA && lt != 0) return;
    int it = 0;
    for (int g = g0; g < g1;) {
      const int q = g / wk.slices;
      const int s0 = g - q * wk.slices;
      const int seg = min(g1, (q + 1) * wk.slices) - g;
      const int blk = q / wk.pairs;
      int ti, tj;
      tile_pair(q - blk * wk.pairs, wk.tiles, ti, tj);
      const int col0 = blk * b;
      const int ci = col0 + ti * TILE;
      const int cj = col0 + tj * TILE;
      const bool diag = ti == tj;
      const int valid = min(b, d - col0);
      g += seg;
      for (int k = 0; k < seg; ++k, ++it) {
        const int t0 = (s0 + k) * BK;
        const int st = it % STAGES;
        const uint32_t dst = base + st * STAGE;
        const uint32_t full = full0 + 8 * st;
        mbar_wait(empty0 + 8 * st, ((it / STAGES) & 1) ^ 1);
        if (TMA) {
          mbar_expect_tx(full, diag ? OPND : STAGE);
          // tokens past n and features past d come in as zeros; features
          // of the next block only feed outputs past b, never stored
          tma_load(dst, &map, ci, t0, full);
          tma_load(dst + HALF, &map, ci + 64, t0, full);
          if (!diag) {
            tma_load(dst + OPND, &map, cj, t0, full);
            tma_load(dst + OPND + HALF, &map, cj + 64, t0, full);
          }
        } else {
          const unsigned short* xs = reinterpret_cast<const unsigned short*>(x);
          load_elements(dst, xs, ld, col0, ti * TILE, valid, t0, n, lt);
          if (!diag) load_elements(dst + OPND, xs, ld, col0, tj * TILE, valid, t0, n, lt);
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          mbar_arrive(full);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg - 1 computes rows 64 (wg - 1) .. + 63 of the
  // tile against all 128 columns
  const int cw = wg - 1;
  const int ct = threadIdx.x - 128;   // 0..255
  int it = 0;
  int released = 0;
  for (int g = g0; g < g1;) {
    const int q = g / wk.slices;
    const int seg = min(g1, (q + 1) * wk.slices) - g;   // this tile's slices here
    const int blk = q / wk.pairs;
    int ti, tj;
    tile_pair(q % wk.pairs, wk.tiles, ti, tj);
    const bool diag = ti == tj;
    float acc[FRAG];
#pragma unroll
    for (int r = 0; r < FRAG; ++r) acc[r] = 0.f;
    fence_operands(acc);
    for (int k = 0; k < seg; ++k, ++it) {
      const int st = it % STAGES;
      mbar_wait(full0 + 8 * st, (it / STAGES) & 1);
      const uint32_t a = base + st * STAGE + cw * HALF;
      const uint32_t bo = base + st * STAGE + (diag ? 0 : OPND);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_m64n128k16(acc, desc(a + kk * 16 * 128, HALF, 1024),
                         desc(bo + kk * 16 * 128, HALF, 1024));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      // the products of the previous slice are done: release its stage
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      for (; released < it; ++released)
        if (ct % 128 == 0) mbar_arrive(empty0 + 8 * (released % STAGES));
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_operands(acc);
    for (; released < it; ++released)
      if (ct % 128 == 0) mbar_arrive(empty0 + 8 * (released % STAGES));
    g += seg;

    const int first = wk.first(q);
    const int c = wk.last(q) - first + 1;   // blocks summing tile q
    if (c > 1) {
      // a shared tile: the partial goes to the workspace in fragment order
      // (coalesced); the tile's last block to arrive sums all partials in
      // block order
#pragma unroll
      for (int r = 0; r < FRAG; ++r)
        __stcg(ws + ((size_t)wk.slot(w, q) * FRAG + r) * 256 + ct, acc[r]);
      __threadfence();
      asm volatile("bar.sync 1, 256;\n" ::: "memory");
      if (ct == 0) is_last = atomicAdd(arrived + q, 1) == c - 1;
      asm volatile("bar.sync 1, 256;\n" ::: "memory");
      if (!is_last) continue;
      __threadfence();
      for (int u = first; u < first + c; ++u) {
        const float* part = ws + (size_t)wk.slot(u, q) * FRAG * 256 + ct;
#pragma unroll
        for (int r = 0; r < FRAG; ++r) {
          const float x = __ldcg(part + r * 256);
          acc[r] = u == first ? x : acc[r] + x;
        }
      }
    }
    store_tile(out + (size_t)blk * b * b, amax ? amax + blk : nullptr, b, ti, tj, cw, ct, acc);
  }
}

// cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint (the
// build links no libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

int encode_map(CUtensorMap* map, const void* x, int n, int ld, int d) {
  static EncodeTiled encode = nullptr;
  if (!encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &q);
    if (e != cudaSuccess) return (int)e;
    if (q != cudaDriverEntryPointSuccess || !fn) return (int)cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  // features (contiguous) by tokens; a box is 64 x 64, read in the
  // 128-byte swizzle; out of range reads as zero
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)max(n, 1)};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {64, BK};
  const cuuint32_t one[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(x), dims,
                            strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

int launch_tc(const void* x, void* out, unsigned* amax, void* ws, void* arrived, int n, int ld,
              int d, int nb, int b, int ctas, cudaStream_t st) {
  // TMA needs a 16-byte aligned base and row stride; b a multiple of 8
  // keeps every block's first column on a 16-byte boundary too
  const bool tma =
      n > 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 && ld % 8 == 0 && b % 8 == 0;
  CUtensorMap map;
  memset(&map, 0, sizeof(map));
  if (tma) {
    const int rc = encode_map(&map, x, n, ld, d);
    if (rc) return rc;
  }
  Work wk;
  wk.tiles = (b + TILE - 1) / TILE;
  wk.pairs = wk.tiles * (wk.tiles + 1) / 2;
  wk.slices = max((n + BK - 1) / BK, 1);
  wk.total = nb * wk.pairs * wk.slices;
  if (ctas < 1 || ctas > wk.total) return (int)cudaErrorInvalidValue;
  wk.per = (wk.total + ctas - 1) / ctas;
  if ((long long)(ctas - 1) * wk.per >= wk.total) return (int)cudaErrorInvalidValue;
  if (wk.per % wk.slices && (!ws || !arrived)) return (int)cudaErrorInvalidValue;
  auto kernel = tma ? factor_syrk_tc_kernel<true> : factor_syrk_tc_kernel<false>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return (int)e;
  kernel<<<ctas, NT, SMEM, st>>>(map, static_cast<const __nv_bfloat16*>(x),
                                 static_cast<float*>(out), amax, static_cast<float*>(ws),
                                 static_cast<int*>(arrived), n, ld, d, b, wk);
  return 0;
}

}  // namespace tc

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

// ws and arrived: the workspace of the partials of shared tiles (2 * ctas
// * 64 KB f32) and one zeroed arrival counter per tile (bf16 only; unused
// when no tile is shared)
int launch_syrk(const void* x, void* out, unsigned* amax, void* ws, void* arrived, int n, int ld,
                int d, int nb, int b, int dtype, int ctas, cudaStream_t st) {
  if (nb < 1 || b < 1 || (long long)(nb - 1) * b >= d || (long long)nb * b < d || ld < d)
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case DT_F32: {
      const int tiles = (b + simt::TILE - 1) / simt::TILE;
      const dim3 grid(tiles * (tiles + 1) / 2, nb);
      factor_syrk_kernel<float><<<grid, simt::NT, 0, st>>>(
          static_cast<const float*>(x), static_cast<float*>(out), amax, n, ld, d, b, tiles);
      break;
    }
    case DT_BF16: {
      const int rc = tc::launch_tc(x, out, amax, ws, arrived, n, ld, d, nb, b, ctas, st);
      if (rc) return rc;
      break;
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int factor_syrk(const void* x, void* out, void* ws, void* arrived, int n, int ld,
                           int d, int nb, int b, int dtype, int ctas, void* stream) {
  return launch_syrk(x, out, nullptr, ws, arrived, n, ld, d, nb, b, dtype, ctas,
                     static_cast<cudaStream_t>(stream));
}

// scratch (nb, b, b) f32 and amax (nb,) u32 (zeroed) are the caller's;
// payload (nb, b(b+1)/2) fp8, scale (nb,) f32.
extern "C" int factor_syrk_wire(const void* x, void* scratch, void* amax, void* ws, void* arrived,
                                void* payload, void* scale, int n, int ld, int d, int nb, int b,
                                int dtype, int ctas, int fmt, int pow2, float inv_max,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fmt != DT_E4M3 && fmt != DT_E5M2) return (int)cudaErrorInvalidValue;
  const int rc = launch_syrk(x, scratch, static_cast<unsigned*>(amax), ws, arrived, n, ld, d, nb,
                             b, dtype, ctas, st);
  if (rc) return rc;
  const dim3 grid((b + 7) / 8, nb);
  pack_quant_kernel<<<grid, 256, 0, st>>>(
      static_cast<const float*>(scratch), static_cast<unsigned char*>(payload),
      static_cast<float*>(scale), static_cast<const unsigned*>(amax), b, fmt, pow2, inv_max);
  return (int)cudaGetLastError();
}
