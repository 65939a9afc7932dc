// Blocked K-FAC factor sum: A[k] = X_k^T X_k for every diagonal block k of
// a token matrix, f32 sums from bf16 or f32 inputs; and the same sum with
// the fp8 wire epilogue (factor_syrk_wire).
//
// Replaces the TPU kernel repro/kernels/kfac_factor.py::factor_syrk
// (_factor_kernel) with its wrapper repro/kernels/ops.py kfac_factor and
// the vmap over blocks and leading axes of repro/kernels/dispatch.py
// _factor_sum_pallas (:120-129); and
// the TPU kernel ::factor_syrk_wire (_factor_wire_kernel, wrapper
// ops.kfac_factor_wire, dispatch _factor_sum_wire_pallas).
//
//   x   (lead, n, ld) row-major, lead matrices lstride elements apart
//       (the experts of an MoE site; lead 1 for every other site), the
//       first d columns hold the features; block k covers columns
//       [k*b, k*b + b), the last one ragged
//   out (lead, nb, b, b) f32,
//       out[e, k] = sum_t x[e, t, kb:kb+b]^T x[e, t, kb:kb+b]
//
// All lead x nb blocks are one launch: the work below runs over the
// flattened (matrix, block) index e * nb + k, which is also the block's
// place in out, so the output side does not see the lead at all.
//
// Bound: n*b*(b+1) operations per block against n*d input elements and
// nb*b*b f32 outputs (the wire variant: nb*b(b+1)/2 fp8 bytes and nb
// scales). At the LM training path's shapes (bf16, n 4096, b 512 or 2048)
// that is far above the H100's bytes/operation ratio: bound by operations
// on the tensor cores. The ConvNet's f32 sums (n 65,536 to 1,048,576)
// read x once for (b + 1) / 4 operations a byte: 7 at b 27 and 16 at b 64,
// under the f32 CUDA cores' 20 (67 TFLOP/s over 3.35 TB/s), so bound by
// bytes; 36 at b 144 and 72 at b 288, about the split-f32 products' 49
// (165 TFLOP/s): bytes at 144, operations from 288 on.
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
// only the summation order differs from the plain version. The Hopper
// helpers (shared-memory descriptor, mbarriers, TMA loads, the tensor-map
// encoder) are hopper.cuh's, shared with the attention walk.
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
// tiles; an MoE site's 60 experts of 341 tokens at d 2048, 8,160 tiles of
// 6 slices), one block per tile, in waves, shares nothing.
//
// f32 inputs (the ConvNet path, the 2-layer f32 route checks) take one of
// three bodies, by n and b (kernels/kfac.py syrk_f32_route):
//
// * below F32_SPLIT_ROWS (16,384) rows, the CUDA-core tile of
//   simt_tile.cuh: 64 x 64 per block of 256 threads, 4 x 4 per thread, 16
//   tokens deep, one block per tile pair over every token, written
//   directly. Its single accumulator's sums at n 4096 equal those of the
//   plain f32 product (torch.mm on the card) bit for bit, and the
//   unchanged e5m2 one-step check of the fused fp8 capture at n 4000
//   failed under another summation order: the LM's f32 routes, the
//   ConvNet's head and those checks keep this order.
// * from there the tokens split into chunks (one f32 accumulator over a
//   million rows was off by 4.8e-4 of max|A|), each chunk's partial of
//   every (matrix, block) goes to a workspace, and factor_syrk_reduce_kernel
//   sums the partials in a fixed order (chunk z into group z mod 8 in
//   chunk order, then the groups), writes each entry and its mirror, and
//   takes the wire variant's amax. No float atomics: the same bits every
//   launch.
//   - b <= NARROW_MAX_B (64; the stem's A of 27, every G of 16 to 64): one
//     streaming pass on the CUDA cores, bound by bytes. A block of 256
//     threads takes one chunk of one (matrix, block); its rows stream
//     through a ring of 4 stages of ~16 KB with cp.async (nb 1 and rows d
//     apart, as every ConvNet site: a stage is one contiguous range, 16
//     bytes a copy whatever d's alignment; otherwise element by element),
//     and thread (slot, q) keeps the 16 sums of lower 4 x 4 patch q over
//     every slots-th row: b(b+1)/2 sums and their padding spread over the
//     block (28 patches a slot at b 27, 9 slots). The 0.79 G operations of
//     (1,048,576, 27) take 12 us at 67 TFLOP/s, under the 34 us of reading
//     x: the CUDA cores keep up up to b ~64, where a tensor-core tile would
//     leave half of a 128-column operand empty.
//   - b > 64 (the ConvNet's 144, 288, 576): 3xTF32 on wgmma, the split
//     products of f32_split_gemm.cuh (hi/lo split, three products per k8
//     step, a fresh partial for each 32-token stage folded in by an f32
//     add), at 165 TFLOP/s of f32 work. An item is (chunk, matrix block,
//     lower tile pair r >= c): C rows 128 r .. (Q, the wgmma B operand,
//     N = 128, the last row tile 16/32/64 to fit b, or, when 16 rows or
//     fewer are left, those joined to the tile before at N = 144: b 144
//     is a 144-row item and a 16 x 16 corner, not three items) against
//     columns 128 c .. (P, two consumer warpgroups of 64; a strip past
//     the block's data skipped).
//     TF32 wgmma reads a shared-memory operand only K-major, and K is the
//     token axis while x is token-major: TMA lands Q's columns of x in P's
//     panel layout and the splitter warps transpose them into K-major
//     hi/lo as they split (a diagonal item loads one range for both); P
//     is gathered into registers from its panels. One item a block of
//     threads, pair fastest, so the items of one chunk run together and
//     read its rows from device memory once; the ring holds as many
//     stages as fit (Ring). Rows or matrices off 16-byte alignment take
//     the producers' element loads (masked) through the same ring.
//   Chunks (kernels/kfac.py syrk_f32_split) are a multiple of the route's
//   stage, at most 16,384 rows: narrow, 2 blocks of threads an SM; wide,
//   6 waves of items (they differ in cost), at least 1,024 rows each.
//
// Every body writes each entry and its mirror, so out comes back whole
// and exactly symmetric (a diagonal tile of the bf16 body writes its lower
// half and mirrors it; the f32 reduce reads the lower partials only).
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

#include <string.h>

#include "f32_split_gemm.cuh"
#include "fp8_quant.cuh"
#include "hopper.cuh"
#include "simt_tile.cuh"

// the other widths of f32_split_gemm.cuh's product the wide f32 factor sum
// takes: 16 or 32 rows of C (a last row tile), 144 (b 144)
namespace f32g {

template <>
__device__ __forceinline__ void wgmma_tf32<16>(float (&d)[8], const uint32_t (&a)[4], uint64_t db,
                                               int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_tf32<32>(float (&d)[16], const uint32_t (&a)[4],
                                               uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

#define KF_D8(i)                                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),          \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// the 144-row tile (128 rows and a last 16 absorbed: b 144)
template <>
__device__ __forceinline__ void wgmma_tf32<144>(float (&d)[72], const uint32_t (&a)[4],
                                                uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %77, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n144k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71}, {%72, %73, %74, %75}, %76, p, 1, 1;\n}\n"
      : KF_D8(0), KF_D8(8), KF_D8(16), KF_D8(24), KF_D8(32), KF_D8(40), KF_D8(48), KF_D8(56),
        KF_D8(64)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

#undef KF_D8

}  // namespace f32g

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
// f32 below F32_SPLIT_ROWS rows: the CUDA-core tile, one accumulator
// ---------------------------------------------------------------------------

constexpr int F32_SPLIT_ROWS = 16384;   // kernels/kfac.py F32_SPLIT_ROWS
constexpr int NARROW_MAX_B = 64;        // kernels/kfac.py F32_NARROW_MAX

// block (pair, k): every token of one 64 x 64 tile pair of block k, written
// to out with its mirror, its max |A| folded into the wire variant's amax;
// grid x is pair + pairs * (e * nb + k), any number of blocks
template <typename T>
__global__ void __launch_bounds__(simt::NT)
factor_syrk_kernel(const T* __restrict__ x, float* __restrict__ out, unsigned* __restrict__ amax,
                   int n, int ld, int d, int b, int tiles, int nb, long long lstride) {
  using simt::BK;
  using simt::TILE;
  const int pairs = tiles * (tiles + 1) / 2;
  int ti, tj;
  tile_pair(blockIdx.x % pairs, tiles, ti, tj);
  const int blk = blockIdx.x / pairs;   // e * nb + k: the matrix e, its block k
  const int col0 = (blk % nb) * b;
  const int valid = min(b, d - col0);   // columns of this block holding data
  x += (size_t)(blk / nb) * lstride;
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

// rows per chunk from the chunks asked: a multiple of the route's unit (a
// stage), the chunks covering n (kernels/kfac.py syrk_f32_split)
__host__ __forceinline__ int chunk_rows(int n, int asked, int unit) {
  const int per = (n + asked - 1) / asked;
  return (per + unit - 1) / unit * unit;
}

// ---------------------------------------------------------------------------
// f32 from F32_SPLIT_ROWS rows, b <= NARROW_MAX_B: one streaming pass
// ---------------------------------------------------------------------------

namespace narrow {

constexpr int NT = 256;
constexpr int STAGES = 4;
constexpr int STAGE_FLOATS = 4096;   // about 16 KB of rows a stage

// rows a stage holds, a multiple of 4 so that a flat stage starts on a
// 16-byte boundary (kernels/kfac.py narrow_stage_rows)
__host__ __device__ __forceinline__ int stage_rows(int b) {
  const int s = STAGE_FLOATS / b / 4 * 4;
  return s > 4 ? s : 4;
}

// floats of shared memory: STAGES stages of S b floats and 4 of slack (a
// patch past b reads up to 3 floats beyond a row); after the loop the same
// memory holds the slots' sums (at most 256 x 16 floats)
__host__ __device__ __forceinline__ int smem_floats(int b) {
  return STAGES * (stage_rows(b) * b + 4);
}

// lower 4 x 4 patch q (pi >= pj), q = pi (pi + 1) / 2 + pj
__device__ __forceinline__ void patch_of(int q, int& pi, int& pj) {
  pi = 0;
  while (q > pi) {
    q -= pi + 1;
    ++pi;
  }
  pj = q;
}

__device__ __forceinline__ void cp4(uint32_t dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp16(uint32_t dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Block of threads (z, blk): chunk z's rows of (matrix, block) blk into the
// partial part[z][blk] (b x b; the entries of the lower patches). Thread
// (slot, q) keeps patch q's 16 sums over the rows slot, slot + slots, ...
// of every stage; the slots' sums are then added in slot order.
__global__ void __launch_bounds__(NT)
factor_syrk_narrow_kernel(const float* __restrict__ x, float* __restrict__ part, int n, int ld,
                          int d, int b, int nb, int blocks, long long lstride, int rows,
                          int chunks, int flat) {
  extern __shared__ __align__(16) float sm[];
  const int S = stage_rows(b);
  const int sstride = S * b + 4;   // a multiple of 4: every stage 16-byte aligned
  const int z = blockIdx.x % chunks;   // grid x: z + chunks * (matrix, block)
  const int blk = blockIdx.x / chunks;
  const int e = blk / nb;
  const int col0 = (blk - e * nb) * b;
  const int valid = min(b, d - col0);
  const float* xe = x + (size_t)e * lstride;
  const int t_begin = z * rows;
  const int t_end = min(n, t_begin + rows);
  const int nst = (t_end - t_begin + S - 1) / S;
  const int p4 = (b + 3) / 4;
  const int npatch = p4 * (p4 + 1) / 2;
  const int slots = NT / npatch;
  const int tid = threadIdx.x;
  const int slot = tid / npatch;
  const int q = tid - slot * npatch;
  int pi, pj;
  patch_of(q, pi, pj);
  const uint32_t sbase = hopper::smem_addr(sm);

  // stage s (rows t_begin + s S ..) into ring slot s mod STAGES, packed b
  // floats a row; a ragged last block's columns past its data as zeros
  auto load = [&](int s) {
    const int r0 = t_begin + s * S;
    const int nr = min(S, t_end - r0);
    const uint32_t dst = sbase + (uint32_t)((s % STAGES) * sstride) * 4u;
    if (flat) {
      // nb 1 and rows d apart: the stage is one contiguous range of x
      const float* src = xe + (size_t)r0 * d;
      const int cnt = nr * d;
      for (int u = tid; u < cnt / 4; u += NT) cp16(dst + 16u * u, src + 4 * u);
      for (int u = cnt / 4 * 4 + tid; u < cnt; u += NT) cp4(dst + 4u * u, src + u);
    } else {
      for (int u = tid; u < nr * b; u += NT) {
        const int r = u / b;
        const int c = u - r * b;
        if (c < valid)
          cp4(dst + 4u * u, xe + (size_t)(r0 + r) * ld + col0 + c);
        else
          asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(dst + 4u * u), "f"(0.f) : "memory");
      }
    }
  };

  float acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nst) load(s);
    commit();
  }
  for (int s = 0; s < nst; ++s) {
    wait_groups<STAGES - 2>();   // stage s has landed (one group a stage)
    __syncthreads();             // ... for every thread; stage s - 1 is free
    if (s + STAGES - 1 < nst) load(s + STAGES - 1);
    commit();
    if (slot < slots) {
      const float* buf = sm + (s % STAGES) * sstride;
      const int nr = min(S, t_end - (t_begin + s * S));
      for (int r = slot; r < nr; r += slots) {
        const float* row = buf + r * b;
        float a[4], c[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a[i] = row[4 * pi + i];
          c[i] = row[4 * pj + i];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[4 * i + j] = fmaf(a[i], c[j], acc[4 * i + j]);
      }
    }
  }
  wait_groups<0>();
  __syncthreads();
  if (slot < slots) {
#pragma unroll
    for (int i = 0; i < 16; ++i) sm[(slot * npatch + q) * 16 + i] = acc[i];
  }
  __syncthreads();
  float* p = part + ((size_t)z * blocks + blk) * b * b;
  for (int u = tid; u < npatch * 16; u += NT) {
    const int pq = u / 16;
    const int w = u - pq * 16;
    float s = 0.f;
    for (int k = 0; k < slots; ++k) s += sm[(k * npatch + pq) * 16 + w];
    int qi, qj;
    patch_of(pq, qi, qj);
    const int i = 4 * qi + w / 4;
    const int j = 4 * qj + w % 4;
    if (i < b && j < b) p[(size_t)i * b + j] = s;
  }
}

int launch(const float* x, float* part, int lead, long long lstride, int n, int ld, int d,
           int nb, int b, int asked, cudaStream_t st, int& chunks) {
  const int rows = chunk_rows(n, asked, stage_rows(b));
  chunks = (n + rows - 1) / rows;
  // flat: the block is the whole row (nb 1, b = d), rows d apart, and every
  // matrix starts on a 16-byte boundary
  const int flat = nb == 1 && ld == d && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   (lead == 1 || lstride % 4 == 0);
  const int smem = smem_floats(b) * 4;
  const cudaError_t e = cudaFuncSetAttribute(
      factor_syrk_narrow_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  if ((long long)chunks * lead * nb > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  factor_syrk_narrow_kernel<<<(unsigned)(chunks * lead * nb), NT, smem, st>>>(
      x, part, n, ld, d, b, nb, lead * nb, lstride, rows, chunks, flat);
  return 0;
}

}  // namespace narrow

// ---------------------------------------------------------------------------
// f32 from F32_SPLIT_ROWS rows, b > NARROW_MAX_B: 3xTF32 on the tensor cores
// ---------------------------------------------------------------------------

namespace wide {

using namespace f32g;

constexpr int TILE = 128;              // C tile edge, columns (TM) and rows
constexpr int PART = TILE * BK * 4;    // P: 32 tokens x 128 columns, 16 KB
constexpr int RING = 192 * 1024;       // the stages' shared memory
constexpr int MAX_STAGES = 8;
constexpr int SMEM = RING + 1024;      // + room to align to 1 KB

// The ring of one item: stage st holds P (column panels, p_offset; 128
// columns, or on a 144-row diagonal item 144, which the splitters read as
// raw Q), Q hi and Q lo (tn rows of 128 bytes, K-major in the 128-byte
// swizzle, the wgmma B operand) and, off the diagonal, raw Q (the row
// tile's columns of x where TMA lands them, in P's layout); as many stages
// as RING holds, up to MAX_STAGES (4 for a 128-row diagonal item, 3 off it
// and for a 144-row diagonal one, 2 for a 144-row one off it, 8 at 16
// rows). Barriers raw (TMA), full (Q split) and empty (released).
struct Ring {
  uint32_t base, raw0, full0, empty0;
  int stage, pb, qb, stages;   // bytes a stage, of P, of one Q copy; stages
  __device__ __forceinline__ uint32_t p(int st) const { return base + st * stage; }
  __device__ __forceinline__ uint32_t q_hi(int st) const { return p(st) + pb; }
  __device__ __forceinline__ uint32_t q_lo(int st) const { return q_hi(st) + qb; }
  __device__ __forceinline__ uint32_t rq(int st) const { return q_lo(st) + qb; }
  __device__ __forceinline__ uint32_t raw(int st) const { return raw0 + 8 * st; }
  __device__ __forceinline__ uint32_t full(int st) const { return full0 + 8 * st; }
  __device__ __forceinline__ uint32_t empty(int st) const { return empty0 + 8 * st; }
};

// Row tiles of 128; when b leaves 16 rows or fewer after the last full
// one, those rows join the tile before (144 rows) and the last row tile
// keeps only its diagonal pair: b 144 is one 144-row item and a 16 x 16
// corner, not three items (kernels/kfac.py wide_pairs, wide_tile_rows)
__host__ __device__ __forceinline__ bool absorbs(int b) {
  return b > TILE && b - (b - 1) / TILE * TILE <= 16;
}

__host__ __device__ __forceinline__ int pair_count(int b) {
  const int tiles = (b + TILE - 1) / TILE;
  return absorbs(b) ? tiles * (tiles - 1) / 2 + 1 : tiles * (tiles + 1) / 2;
}

// lower tile pair q -> (row tile r, column tile c), c <= r, q = r (r + 1) /
// 2 + c; with absorbs(b), the last pair is the last diagonal one
__host__ __device__ __forceinline__ void pair_of(int q, int b, int& r, int& c) {
  if (absorbs(b) && q == pair_count(b) - 1) {
    r = c = (b - 1) / TILE;
    return;
  }
  r = 0;
  while (q > r) {
    q -= r + 1;
    ++r;
  }
  c = q;
}

// C rows of row tile r: 128; 144 for the tile that absorbs the last rows;
// the last tile 16, 32, 64 or 128, the least that covers what is left of b
__host__ __device__ __forceinline__ int tile_rows(int r, int b) {
  const int rest = b - r * TILE;
  if (rest > TILE) return absorbs(b) && rest <= TILE + 16 ? TILE + 16 : TILE;
  return rest > 64 ? 128 : rest > 32 ? 64 : rest > 16 ? 32 : 16;
}

struct Work {
  int n, ld, d, b, nb, blocks, rows, pairs;
  long long lstride;
};

// Raw Q (at src, P's panel layout, columns [0, tn)) into Q hi and Q lo at
// the K-major places, by splitter sp of nsp. A unit is one row n of Q and 4
// tokens (one 16-byte chunk of its 128-byte row). The two half-warps read
// their 4 tokens in orders one apart, so that they hit the two halves of the
// banks (panels are 2 KB apart, rows of one panel 64 bytes).
__device__ __forceinline__ void split_transpose(uint32_t src, uint32_t qh, uint32_t ql, int tn,
                                                int sp, int nsp) {
  for (int u = sp; u < tn * (BK / 4); u += nsp) {
    const int nn = u % tn;
    const int cq = u / tn;
    const int h = (u >> 4) & 1;
    float y[4];
#pragma unroll
    for (int s = 0; s < 4; ++s)
      asm volatile("ld.shared.f32 %0, [%1];\n"
                   : "=f"(y[s])
                   : "r"(src + p_offset(4 * cq + ((s + h) & 3), nn))
                   : "memory");
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split(h ? y[(e + 3) & 3] : y[e], hi[e], lo[e]);
    const uint32_t off = nn * 128 + ((cq ^ (nn & 7)) << 4);
    st_shared_v4(qh + off, hi);
    st_shared_v4(ql + off, lo);
  }
}

// The producers' element loads of one stage, for shapes TMA cannot address:
// tokens [t0, t0 + BK) of P (columns j0 .. j0 + 127 of the block) at
// p_offset, and of Q (its rows i0 .. i0 + tn - 1) split at the K-major
// places; tokens at or past t_end and features at or past valid as 0
__device__ __forceinline__ void load_elements(const Ring& ring, int st, const float* xe, int ld,
                                              int col0, int valid, int i0, int j0, int tn, int t0,
                                              int t_end, int lt) {
  for (int u = lt; u < BK * TM; u += PRODUCERS) {
    const int k = u / TM;
    const int m = u - k * TM;
    const int t = t0 + k;
    const float v =
        (t < t_end && j0 + m < valid) ? __ldcg(xe + (size_t)t * ld + col0 + j0 + m) : 0.f;
    asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(ring.p(st) + p_offset(k, m)), "f"(v)
                 : "memory");
  }
  for (int u = lt; u < tn * (BK / 4); u += PRODUCERS) {
    const int nn = u % tn;
    const int cq = u / tn;
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = t0 + 4 * cq + e;
      const float v = (t < t_end && i0 + nn < valid)
                          ? __ldcg(xe + (size_t)t * ld + col0 + i0 + nn)
                          : 0.f;
      split(v, hi[e], lo[e]);
    }
    const uint32_t off = nn * 128 + ((cq ^ (nn & 7)) << 4);
    st_shared_v4(ring.q_hi(st) + off, hi);
    st_shared_v4(ring.q_lo(st) + off, lo);
  }
}

// A consumer warpgroup's strip (C rows i0 .. i0 + TN - 1, columns j0 + 64 cw
// .. + 63): `stages` stages, each into a fresh partial added to acc in f32;
// then the entries inside b x b stored to o (zeros where not active)
template <int TN, bool TMA>
__device__ __forceinline__ void consume(const Ring& ring, int stages, int cw, int t, bool active,
                                        float* o, int b, int i0, int j0) {
  float acc[TN / 2];
#pragma unroll
  for (int r = 0; r < TN / 2; ++r) acc[r] = 0.f;
  if (active) {
    float part[TN / 2];
    uint32_t hi[BK / 8][4], lo[BK / 8][4];
    for (int s = 0; s < stages; ++s) {
      const int st = s % ring.stages;
      const uint32_t par = (s / ring.stages) & 1;
      if (TMA) mbar_wait(ring.raw(st), par);   // P arrived
      mbar_wait(ring.full(st), par);           // Q split
      gather_frags(hi, lo, ring.p(st), cw, t);
      issue_stage<TN>(part, hi, lo, ring.q_hi(st), ring.q_lo(st));
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_operands(part);
      if (t % 32 == 0) mbar_arrive(ring.empty(st));
#pragma unroll
      for (int r = 0; r < TN / 2; ++r) acc[r] += part[r];
    }
  }
  for_each_pair<TN>(acc, cw, t, [&](int row, int col, float& v0, float& v1) {
    const int i = i0 + row;
    const int j = j0 + col;
    if (i >= b || j >= b) return;
    float* q = o + (size_t)i * b + j;
    if (j + 1 < b && (reinterpret_cast<uintptr_t>(q) & 7) == 0) {
      *reinterpret_cast<float2*>(q) = make_float2(v0, v1);
    } else {
      q[0] = v0;
      if (j + 1 < b) q[1] = v1;
    }
  });
}

// Block of threads i: item i = (chunk z, matrix-block blk, lower pair q),
// the pair fastest, so the blocks summing one chunk's tiles run together and
// read its rows once from device memory. C = Q P with Q = X[:, rows]^T (the
// B operand, transposed by the splitters) and P = X[:, columns] (the A
// operand, gathered into registers); a diagonal pair loads one range for
// both. The partial goes to part[z][blk].
template <bool TMA>
__global__ void __launch_bounds__(NT, 1)
factor_syrk_wide_kernel(const __grid_constant__ CUtensorMap map, const float* __restrict__ x,
                        float* __restrict__ part, Work w) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[3 * MAX_STAGES];
  const int per_chunk = w.blocks * w.pairs;
  const int z = blockIdx.x / per_chunk;
  const int rest = blockIdx.x - z * per_chunk;
  const int blk = rest / w.pairs;
  int r, c;
  pair_of(rest - blk * w.pairs, w.b, r, c);
  const int e = blk / w.nb;
  const int col0 = (blk - e * w.nb) * w.b;
  const int valid = min(w.b, w.d - col0);
  const int i0 = r * TILE;
  const int j0 = c * TILE;
  const int tn = tile_rows(r, w.b);
  const bool diag = r == c;
  const int t_begin = z * w.rows;
  const int t_end = min(w.n, t_begin + w.rows);
  const int stages = (t_end - t_begin + BK - 1) / BK;
  // strips (64 columns each) with data; none when the rows hold none
  const int nactive = i0 < valid ? (j0 < valid) + (j0 + 64 < valid) : 0;

  Ring ring;
  ring.base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  // P's columns: 128, or on a diagonal 144-row item all 144 (its raw Q)
  const int pcols = diag && tn > TILE ? tn : TILE;
  ring.pb = pcols * BK * 4;
  ring.qb = tn * BK * 4;   // multiples of 1 KB: every region stays aligned
  ring.stage = ring.pb + (diag ? 2 : 3) * ring.qb;
  ring.stages = min(MAX_STAGES, RING / ring.stage);
  ring.raw0 = smem_addr(bars);
  ring.full0 = ring.raw0 + 8 * MAX_STAGES;
  ring.empty0 = ring.full0 + 8 * MAX_STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < ring.stages; ++s) {
      mbar_init(ring.raw(s), 1);
      mbar_init(ring.full(s), TMA ? SPLITTERS : PRODUCERS);
      mbar_init(ring.empty(s), 4 * max(nactive, 1));   // one arrival per active consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg < 2) {
    // producers: registers go to the consumers (2 x 40 + 2 x 216 a thread)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const int pt = threadIdx.x;
    if (!nactive || (TMA && pt > 0 && pt < 32)) return;
    const float* xe = x + (size_t)e * w.lstride;
    for (int s = 0; s < stages; ++s) {
      const int st = s % ring.stages;
      const uint32_t par = (s / ring.stages) & 1;
      const int t0 = t_begin + s * BK;
      if (TMA) {
        if (pt == 0) {
          // rows per chunk are a multiple of BK: a stage never crosses into
          // the next chunk; tokens past n arrive as zeros
          mbar_wait(ring.empty(st), par ^ 1);
          mbar_expect_tx(ring.raw(st), ring.pb + (diag ? 0 : ring.qb));
          for (int j = 0; j < pcols / 16; ++j)
            tma_load(ring.p(st) + j * (BK * 64), &map, col0 + j0 + 16 * j, t0, e, ring.raw(st));
          if (!diag)
            for (int j = 0; j < tn / 16; ++j)
              tma_load(ring.rq(st) + j * (BK * 64), &map, col0 + i0 + 16 * j, t0, e,
                       ring.raw(st));
        } else {
          mbar_wait(ring.raw(st), par);
          split_transpose(diag ? ring.p(st) : ring.rq(st), ring.q_hi(st), ring.q_lo(st), tn,
                          pt - 32, SPLITTERS);
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          mbar_arrive(ring.full(st));
        }
      } else {
        mbar_wait(ring.empty(st), par ^ 1);
        load_elements(ring, st, xe, w.ld, col0, valid, i0, j0, tn, t0, t_end, pt);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(ring.full(st));
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 216;\n" ::: "memory");
  const int cw = wg - 2;
  const int t = threadIdx.x % 128;
  const bool active = nactive && j0 + 64 * cw < valid;
  float* o = part + ((size_t)z * w.blocks + blk) * w.b * w.b;
  switch (tn) {
    case 16:
      consume<16, TMA>(ring, stages, cw, t, active, o, w.b, i0, j0);
      break;
    case 32:
      consume<32, TMA>(ring, stages, cw, t, active, o, w.b, i0, j0);
      break;
    case 64:
      consume<64, TMA>(ring, stages, cw, t, active, o, w.b, i0, j0);
      break;
    case 144:
      consume<144, TMA>(ring, stages, cw, t, active, o, w.b, i0, j0);
      break;
    default:
      consume<128, TMA>(ring, stages, cw, t, active, o, w.b, i0, j0);
  }
}

int launch(const float* x, float* part, int lead, long long lstride, int n, int ld, int d,
           int nb, int b, int asked, cudaStream_t st, int& chunks) {
  Work w;
  w.n = n;
  w.ld = ld;
  w.d = d;
  w.b = b;
  w.nb = nb;
  w.blocks = lead * nb;
  w.lstride = lstride;
  w.rows = chunk_rows(n, asked, BK);
  chunks = (n + w.rows - 1) / w.rows;
  w.pairs = pair_count(b);
  const long long items = (long long)chunks * w.blocks * w.pairs;
  if (items > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // TMA needs a 16-byte aligned base and row and matrix strides (matrices
  // apart, as a contiguous (lead, n, ld) tensor has them)
  const bool tma = reinterpret_cast<uintptr_t>(x) % 16 == 0 && ld % 4 == 0 && lstride % 4 == 0 &&
                   lstride >= (long long)n * ld;
  CUtensorMap map;
  memset(&map, 0, sizeof(map));
  if (tma) {
    const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)n, (cuuint64_t)lead};
    const cuuint64_t strides[2] = {(cuuint64_t)ld * 4, (cuuint64_t)lstride * 4};
    if (encode_p(&map, x, 3, dims, strides)) return (int)cudaErrorInvalidValue;
  }
  auto kernel = tma ? factor_syrk_wide_kernel<true> : factor_syrk_wide_kernel<false>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)items, NT, SMEM, st>>>(map, x, part, w);
  return 0;
}

}  // namespace wide

// the chunks' partials summed: chunk z into group z mod RED_GROUPS in chunk
// order, the groups then in group order (a fixed order, so every launch
// gives the same bits). A block of threads takes 32 consecutive entries of
// one (matrix, block) (grid x: the entry run + runs * (matrix, block)), its
// warp g group g; the lower entries (i
// >= j, the ones every route's partial holds) are read, written at (i, j)
// and (j, i), and their max |A| folded into the wire variant's amax (the
// entries its pack reads).
constexpr int RED_GROUPS = 8;   // kernels/kfac.py SYRK_REDUCE_GROUPS

__global__ void __launch_bounds__(32 * RED_GROUPS)
factor_syrk_reduce_kernel(const float* __restrict__ part, float* __restrict__ out,
                          unsigned* __restrict__ amax, int chunks, int blocks, int b,
                          int runs) {
  __shared__ float red[RED_GROUPS][33];
  const int blk = blockIdx.x / runs;
  const long long bb = (long long)b * b;
  const int tx = threadIdx.x % 32;
  const int ty = threadIdx.x / 32;
  const long long e = (long long)(blockIdx.x % runs) * 32 + tx;
  const int i = (int)(e / b);
  const int j = (int)(e - (long long)i * b);
  const bool low = e < bb && j <= i;
  float s = 0.f;
  if (low) {
    const float* p = part + (size_t)blk * bb + e;
    for (int z = ty; z < chunks; z += RED_GROUPS) s += __ldcg(p + (size_t)z * blocks * bb);
  }
  red[ty][tx] = s;
  __syncthreads();
  if (ty) return;
  float v = red[0][tx];
#pragma unroll
  for (int g = 1; g < RED_GROUPS; ++g) v += red[g][tx];
  unsigned m = 0u;
  if (low) {
    float* o = out + (size_t)blk * bb;
    o[e] = v;
    if (i != j) o[(size_t)j * b + i] = v;
    m = fp8q::abs_bits(v);
  }
  if (amax) {
    m = __reduce_max_sync(0xffffffffu, m);
    if (tx == 0 && m) atomicMax(amax + blk, m);
  }
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core tile
// ---------------------------------------------------------------------------

namespace tc {

using namespace hopper;

constexpr int TILE = 128;            // output tile edge
constexpr int BK = 64;               // tokens per stage
constexpr int STAGES = 6;            // ring depth
constexpr int NT = 384;              // producer warpgroup + two consumer warpgroups
constexpr int FRAG = 64;             // f32 accumulators per consumer thread (m64n128)
constexpr int HALF = 64 * BK * 2;    // one 64-feature half of a slice: 8 KB
constexpr int OPND = 2 * HALF;       // one operand's 128 features: 16 KB
constexpr int STAGE = 2 * OPND;      // both operands: 32 KB
constexpr int SMEM = STAGES * STAGE + 1024;   // + room to align to 1 KB

// byte offset of the 16-byte chunk c (features 8c..8c+7 of the operand's
// 128) of token k in a slice: half c/8, row k of 128 bytes, the chunk's
// place XOR-ed with k mod 8 (the 128-byte swizzle, on 1 KB-aligned rows;
// what TMA writes for a 64 x 64 box in CU_TENSOR_MAP_SWIZZLE_128B)
__device__ __forceinline__ uint32_t swizzled(int k, int c) {
  return (c >> 3) * HALF + k * 128 + (((c & 7) ^ (k & 7)) << 4);
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
  int nb;               // blocks per matrix: tile q's block q / pairs is e * nb + k
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
                      int* __restrict__ arrived, int n, int ld, int d, int b, long long lstride,
                      Work wk) {
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
      const int e = blk / wk.nb;
      int ti, tj;
      tile_pair(q - blk * wk.pairs, wk.tiles, ti, tj);
      const int col0 = (blk - e * wk.nb) * b;
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
          tma_load(dst, &map, ci, t0, e, full);
          tma_load(dst + HALF, &map, ci + 64, t0, e, full);
          if (!diag) {
            tma_load(dst + OPND, &map, cj, t0, e, full);
            tma_load(dst + OPND + HALF, &map, cj + 64, t0, e, full);
          }
        } else {
          const unsigned short* xs =
              reinterpret_cast<const unsigned short*>(x) + (size_t)e * lstride;
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

int encode_map(CUtensorMap* map, const void* x, int lead, int n, int ld, int d,
               long long lstride) {
  // features (contiguous) by tokens by matrices; a box is 64 x 64 of one
  // matrix, read in the 128-byte swizzle; out of range reads as zero, so
  // a slice past a matrix's n tokens never reads the next matrix's rows
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)max(n, 1), (cuuint64_t)lead};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * 2, (cuuint64_t)lstride * 2};
  const cuuint32_t box[3] = {64, BK, 1};
  return hopper::encode_bf16(map, x, 3, dims, strides, box);
}

int launch_tc(const void* x, void* out, unsigned* amax, void* ws, void* arrived, int lead,
              long long lstride, int n, int ld, int d, int nb, int b, int ctas,
              cudaStream_t st) {
  // TMA needs a 16-byte aligned base and row and matrix strides (matrices
  // apart, as a contiguous (lead, n, ld) tensor has them); b a multiple
  // of 8 keeps every block's first column on a 16-byte boundary too
  const bool tma = n > 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 && ld % 8 == 0 &&
                   b % 8 == 0 && lstride % 8 == 0 && lstride >= (long long)n * ld;
  CUtensorMap map;
  memset(&map, 0, sizeof(map));
  if (tma) {
    const int rc = encode_map(&map, x, lead, n, ld, d, lstride);
    if (rc) return rc;
  }
  Work wk;
  wk.nb = nb;
  wk.tiles = (b + TILE - 1) / TILE;
  wk.pairs = wk.tiles * (wk.tiles + 1) / 2;
  wk.slices = max((n + BK - 1) / BK, 1);
  const long long total = (long long)lead * nb * wk.pairs * wk.slices;
  if (total > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  wk.total = (int)total;
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
                                 static_cast<int*>(arrived), n, ld, d, b, lstride, wk);
  return 0;
}

}  // namespace tc

// sym-pack + quantize each block of f (lead * nb, b, b) f32 (block blk = e *
// nb + k; grid x bx + (b + 7) / 8 * blk): warp w of block of threads bx
// handles row r = 8 bx + w, packed positions tri(r) + c for c <= r, reading
// f[k][r][c] (the lower triangle; f is symmetric)
__global__ void __launch_bounds__(256)
pack_quant_kernel(const float* __restrict__ f, unsigned char* __restrict__ payload,
                  float* __restrict__ scale, const unsigned* __restrict__ amax, int b, int fmt,
                  int pow2, float inv_max) {
  const int rows8 = (b + 7) / 8;
  const int bx = blockIdx.x % rows8;
  const int blk = blockIdx.x / rows8;
  const int r = bx * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const float s = fp8q::scale_of(__uint_as_float(amax[blk]), inv_max, pow2);
  if (bx == 0 && threadIdx.x == 0) scale[blk] = s;
  if (r >= b) return;
  const float fmax = fp8q::fmt_max(fmt);
  const long long t = (long long)b * (b + 1) / 2;
  const float* row = f + ((size_t)blk * b + r) * b;
  unsigned char* out = payload + (long long)blk * t + (long long)r * (r + 1) / 2;
  for (int c = lane; c <= r; c += 32) out[c] = fp8q::quant_one(row[c], s, fmax, fmt);
}

// bf16: ws and arrived are the workspace of the partials of shared tiles
// (2 * ctas * 64 KB f32) and one zeroed arrival counter per tile (unused
// when no tile is shared). f32 from F32_SPLIT_ROWS rows: ctas is the chunk
// count asked (kernels/kfac.py syrk_f32_split) and ws holds the launched
// chunks' lead * nb * b * b f32 partials each.
int launch_syrk(const void* x, void* out, unsigned* amax, void* ws, void* arrived, int lead,
                long long lstride, int n, int ld, int d, int nb, int b, int dtype, int ctas,
                cudaStream_t st) {
  // every grid folds the (matrix, block) index into x, so only x's 2^31 - 1
  // bounds the blocks (each launch checks its own product)
  if (nb < 1 || b < 1 || (long long)(nb - 1) * b >= d || (long long)nb * b < d || ld < d ||
      lead < 1 || lstride < 0 || (long long)lead * nb > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case DT_F32: {
      const float* xf = static_cast<const float*>(x);
      float* o = static_cast<float*>(out);
      if (n < F32_SPLIT_ROWS) {
        const int tiles = (b + simt::TILE - 1) / simt::TILE;
        const long long grid = (long long)tiles * (tiles + 1) / 2 * lead * nb;
        if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
        factor_syrk_kernel<float><<<(unsigned)grid, simt::NT, 0, st>>>(xf, o, amax, n, ld, d, b,
                                                                       tiles, nb, lstride);
        break;
      }
      if (ctas < 1 || !ws) return (int)cudaErrorInvalidValue;
      float* part = static_cast<float*>(ws);
      int chunks = 0;
      const int rc = b <= NARROW_MAX_B
                         ? narrow::launch(xf, part, lead, lstride, n, ld, d, nb, b, ctas, st, chunks)
                         : wide::launch(xf, part, lead, lstride, n, ld, d, nb, b, ctas, st, chunks);
      if (rc) return rc;
      const long long runs = ((long long)b * b + 31) / 32;
      if (runs * lead * nb > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
      factor_syrk_reduce_kernel<<<(unsigned)(runs * lead * nb), 32 * RED_GROUPS, 0, st>>>(
          part, o, amax, chunks, lead * nb, b, (int)runs);
      break;
    }
    case DT_BF16: {
      const int rc =
          tc::launch_tc(x, out, amax, ws, arrived, lead, lstride, n, ld, d, nb, b, ctas, st);
      if (rc) return rc;
      break;
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x (lead, n, ld), matrices lstride elements apart; out (lead, nb, b, b)
extern "C" int factor_syrk(const void* x, void* out, void* ws, void* arrived, int lead,
                           long long lstride, int n, int ld, int d, int nb, int b, int dtype,
                           int ctas, void* stream) {
  return launch_syrk(x, out, nullptr, ws, arrived, lead, lstride, n, ld, d, nb, b, dtype, ctas,
                     static_cast<cudaStream_t>(stream));
}

// x (lead, n, ld), matrices lstride elements apart; scratch (lead, nb, b, b)
// f32 and amax (lead * nb,) u32 (zeroed) are the caller's; payload
// (lead, nb, b(b+1)/2) fp8, scale (lead, nb) f32. Every (matrix, block) of
// the lead in the one SYRK launch and the one pack launch (folded into grid
// x, as every launch of launch_syrk).
extern "C" int factor_syrk_wire(const void* x, void* scratch, void* amax, void* ws, void* arrived,
                                void* payload, void* scale, int lead, long long lstride, int n,
                                int ld, int d, int nb, int b, int dtype, int ctas, int fmt,
                                int pow2, float inv_max, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fmt != DT_E4M3 && fmt != DT_E5M2) return (int)cudaErrorInvalidValue;
  const int rc = launch_syrk(x, scratch, static_cast<unsigned*>(amax), ws, arrived, lead,
                             lstride, n, ld, d, nb, b, dtype, ctas, st);
  if (rc) return rc;
  const long long grid = (long long)(b + 7) / 8 * lead * nb;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  pack_quant_kernel<<<(unsigned)grid, 256, 0, st>>>(
      static_cast<const float*>(scratch), static_cast<unsigned char*>(payload),
      static_cast<float*>(scale), static_cast<const unsigned*>(amax), b, fmt, pow2, inv_max);
  return (int)cudaGetLastError();
}
