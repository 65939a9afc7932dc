// Newton-Schulz damped inverse of symmetric factor blocks (Stage 4).
//
// Replaces the TPU kernels of repro/kernels/newton_schulz.py:
//
//   ns_inverse_blocks  (_ns_kernel, wrapper ops.ns_inverse)     -> ns_inverse_blocks
//   ns_tiled_residual  (_ns_resid_kernel, ops.ns_inverse_tiled) -> ns_tiled_residual
//   ns_tiled_update    (_ns_update_kernel, ops.ns_inverse_tiled)-> ns_tiled_update
//
// Every block is the already-damped, already-symmetrized M = F + lambda I
// (b, b), row-major and contiguous. The iteration, from
// X0 = M / (||M||_1 ||M||_inf), is
//
//   R = I - M X,   res = ||R||_F / sqrt(b),   X <- X + X R   while res > tol
//
// and a block freezes for good once res <= tol (a frozen iterate never
// changes again, so stopping there gives the same output as running on).
// A ragged b is masked on load and store; nothing is padded.
//
// ns_inverse_blocks: one cluster of up to 8 blocks of threads per factor
// block runs the whole method in one launch (norms, X0, up to `iters`
// trips with the freeze, the residual of the returned iterate, the trip
// count). On the TPU M, X and the step temporary sat in VMEM; here 3 b^2
// f32 (3 MB at b 512) do not fit the 227 KB of shared memory, so X, the
// other iterate and R live in scratch in device memory, allocated by the
// wrapper; at the training path's g 16, b 512 they stay in the 50 MB L2.
// Both products of a trip are f32-accurate split products on the tensor
// cores, the tile of f32_split_gemm.cuh (3xTF32 on wgmma, C = Q P with
// Q = M, P = X for R and Q = X, P = R for X R; every operand is row-major,
// so nothing is transposed). A block of threads is two producer
// warpgroups and two consumer warpgroups over a ring of four 32-deep
// stages, each role running its own copy of the trip loop (the producers
// give their registers to the consumers); its share of a product is the
// 128 x 128 output tiles rank, rank + csize, ... of the b x b result
// (64-row tiles would stream 1.5x the bytes per operation). With b a
// multiple of 4, TMA brings the tiles from 3-D maps over the (g, b, b)
// buffers (rows and columns past b read as zeros); otherwise the
// producers load elements. The iterates are written with plain stores and read back by
// TMA in the next product, so each writer fences the async proxy before
// the cluster barrier that separates one product from the next. ||R||^2
// is a block reduction, then each block adds the cluster's partial sums
// through distributed shared memory in rank order: every block computes
// the same residual, so the freeze is a cluster-uniform break, and it is
// deterministic (every tile sums its K in a fixed order). The cluster size
// adapts to g (pick_cluster), so that the clusters run in one wave where
// the card can hold them.
//
// ns_tiled_residual / ns_tiled_update: one launch each per trip, on the
// same split-TF32 tile: the residual is C = Q P with Q = M, P = X and
// C = I - Q P, plus each block's ||R||_F^2; the update Q = X, P = R and
// C = X + Q P, out of place (X's tile read with __ldcg in the epilogue).
// The work items are (factor block, 128 x 128 output tile), block-major
// (the tiles in flight share one block's operands, 32 MB at b 2048, in
// an H100's 50 MB L2), the tiles of a block row-major; the blocks of
// threads are persistent, one per SM (the ring's 193 KB of shared memory
// fills one): block w takes items w, w + B, ... (kernels/newton_schulz.py
// tiled_geometry and tiled_item mirror the partition, and the wrapper
// passes B). TMA brings both operands from 3-D maps over the (g, b, b)
// buffers when b is a multiple of 4; otherwise the producers load
// elements. Each tile's sum of r^2 is reduced by the consumers alone
// (their own named barrier: the producers are already filling the ring
// for the next item) into a (g, tiles) partials buffer, and the consumer
// thread whose tile is the block's last to finish adds the block's
// partials in a fixed order, so ss does not depend on the order tiles
// finish in and two launches give the same bits. A per-block `active`
// flag (device memory, no host read) makes both roles skip the items of a
// frozen factor block: the residual writes nothing for it (its ss stays
// the caller's 0) and the update's consumers copy its X tile unchanged
// (bit-stable) without touching the ring. The freeze logic and the trip
// loop are in the wrapper (kernels/newton_schulz.py ns_inverse_tiled).
//
// Bound: one trip is two b x b x b products, 4 b^3 operations a block, on
// 3 b^2 f32 of data: far above the card's operations-per-byte ratio at the
// path's b 512 and 2048, so bound by f32-accurate operations: 165 TFLOP/s
// of f32 work for the split products (three TF32 products at 495; an
// H100 SXM's data sheet at its 700 W limit), where the f32 CUDA cores'
// fmaf gives 67. One TF32 product would miss the residual tolerance 1e-4
// and the 1e-5 agreement with the plain iteration; the split keeps both
// (f32_split_gemm.cuh). The resident kernel occupies up to 8 g SMs, the
// tiled pair every SM.

#include <cooperative_groups.h>

#include "f32_split_gemm.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_CLUSTER = 8;         // blocks per factor block, at most (portable)

// The largest of v over the block's threads; every thread gets the result.
template <int NT>
__device__ __forceinline__ float block_max(float v, float* red) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  v = warp_max(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float s = lane < NT / 32 ? red[lane] : 0.f;
    s = warp_max(s);
    if (lane == 0) red[32] = s;
  }
  __syncthreads();
  return red[32];
}

// --- the resident kernel ------------------------------------------------------

namespace res {

using namespace f32g;
using f32g::BK;
using f32g::NT;
using f32g::TM;

constexpr int TN = 128;    // rows of an output tile (TM = 128 columns)
using G = Geo<TN>;

// tensor maps over the (g, b, b) buffers: as the Q operand (K-major boxes)
// and as the P operand (row boxes)
struct Maps {
  CUtensorMap mq, xq, aq;   // M, X, alt
  CUtensorMap xp, ap, rp;   // X, alt, R
};

struct Smem {
  float red[33];
  float part;                      // this block's sum of r^2, read by the cluster
};

// the output tiles of one b x b product: 128 x 128, row-major; block
// `rank` of the cluster takes tiles rank, rank + csize, ...
__host__ __device__ __forceinline__ int tiles_of(int b) {
  const int n = (b + TN - 1) / TN;
  return n * n;
}

// the block's barrier, reached from the producers' and the consumers' code
__device__ __forceinline__ void block_bar() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(NT) : "memory");
}

// This block's share of one product C = Q P of factor block g, for one
// role: the producers load, the consumers multiply and store.
// RESIDUAL: C = I - Q P (a consumer returns its sum of r^2); else
// C = A + Q P (the update, Q = A = the current iterate, P = R). The caller
// syncs the cluster before anyone reads C.
template <bool TMA, bool RESIDUAL, bool PRODUCER>
__device__ __forceinline__ float product(const CUtensorMap* qm, const CUtensorMap* pm,
                                         const float* Q, const float* P, float* C,
                                         const float* A, int b, int g, int rank, int csize,
                                         const Ring<TN>& ring, int& it) {
  const int nc = (b + TM - 1) / TM;
  const int tiles = tiles_of(b), stages = (b + BK - 1) / BK;
  if constexpr (PRODUCER) {
    const int pt = threadIdx.x;
    if (TMA && pt > 0 && pt < 32) return 0.f;
    // the iterates were written with plain stores before the cluster barrier
    if (TMA && pt == 0) asm volatile("fence.proxy.async.global;\n" ::: "memory");
    for (int tile = rank; tile < tiles; tile += csize) {
      const int row0 = (tile / nc) * TN, col0 = (tile % nc) * TM;
      if (TMA)
        tile_produce_tma<TN>(ring, it, stages, pt,
                             [&](uint32_t dq, uint32_t dp, uint32_t bar, int k0) {
                               tma_load(dq, qm, k0, row0, g, bar);
                               tma_load_p(dp, pm, 3, col0, k0, g, bar);
                             });
      else
        tile_produce_elements<TN>(ring, it, stages, pt, Q, b, b, row0, P, b, b, col0, b);
    }
    return 0.f;
  } else {
    const int cw = threadIdx.x / 128 - 2, t = threadIdx.x % 128;
    float ss = 0.f;
    for (int tile = rank; tile < tiles; tile += csize) {
      const int row0 = (tile / nc) * TN, col0 = (tile % nc) * TM;
      float acc[G::FRAG];
      tile_product<TN, TMA>(acc, ring, it, stages, cw, t);
      if (!RESIDUAL)   // X + X R: all of the tile's X reads before any store
        for_each_pair<TN>(acc, cw, t, [&](int row, int col, float& v0, float& v1) {
          const int i = row0 + row, j = col0 + col;
          if (i >= b) return;
          if (j < b) v0 += __ldcg(A + (size_t)i * b + j);
          if (j + 1 < b) v1 += __ldcg(A + (size_t)i * b + j + 1);
        });
      for_each_pair<TN>(acc, cw, t, [&](int row, int col, float& v0, float& v1) {
        const int i = row0 + row;
        if (i >= b) return;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = col0 + col + e;
          if (j >= b) continue;
          float v = e ? v1 : v0;
          if (RESIDUAL) {
            v = (i == j ? 1.f : 0.f) - v;
            ss = fmaf(v, v, ss);
          }
          C[(size_t)i * b + j] = v;
        }
      });
    }
    // the next product's TMA loads read C
    if (TMA) asm volatile("fence.proxy.async.global;\n" ::: "memory");
    return ss;
  }
}

// ||R||_F / sqrt(b) of the residual the cluster just stored, from each
// thread's sum `ss` (0 on the producers): a block sum in a fixed order,
// then every block adds the blocks' partial sums in rank order, so all hold
// the same value. Syncs the cluster (R complete).
__device__ float cluster_residual(float ss, float rnorm, cg::cluster_group& cluster,
                                  int csize, Smem& sm) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  ss = warp_sum(ss);
  block_bar();                     // red may still be read from the last call
  if (lane == 0) sm.red[warp] = ss;
  block_bar();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int w = 0; w < NT / 32; ++w) s += sm.red[w];
    sm.part = s;
  }
  cluster.sync();
  float total = 0.f;
  for (int q = 0; q < csize; ++q) total += *cluster.map_shared_rank(&sm.part, q);
  return sqrtf(total) * rnorm;
}

struct Iterates {
  const float* M;
  float *X, *alt, *R;
};

// The trips of one role (both roles take the same branches: the residual
// is cluster-uniform), then the copy of the returned iterate into X and the
// block's result.
template <bool TMA, bool PRODUCER>
__device__ __forceinline__ void trips_of(const Maps& maps, Iterates v, float* res_out,
                                         int* trips_out, int b, int g, int iters, float tol,
                                         int rank, int csize, const Ring<TN>& ring,
                                         cg::cluster_group& cluster, Smem& sm) {
  const float rnorm = (float)(1.0 / sqrt((double)b));
  float* cur = v.X;
  float* nxt = v.alt;
  float res = 0.f;
  int trips = 0;
  int it = 0;                      // ring position (each role keeps its own)
  bool frozen = false;
  for (int k = 0; k < iters; ++k) {
    const bool at_x = cur == v.X;
    res = cluster_residual(
        product<TMA, true, PRODUCER>(&maps.mq, at_x ? &maps.xp : &maps.ap, v.M, cur, v.R,
                                     nullptr, b, g, rank, csize, ring, it),
        rnorm, cluster, csize, sm);
    if (!(res > tol)) {            // cluster-uniform: every thread holds res
      frozen = true;
      break;
    }
    product<TMA, false, PRODUCER>(at_x ? &maps.xq : &maps.aq, &maps.rp, cur, v.R, nxt, cur, b,
                                  g, rank, csize, ring, it);
    cluster.sync();                // nxt complete; partial sums read
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
    ++trips;
  }
  if (!frozen)                     // the residual of the returned iterate
    res = cluster_residual(
        product<TMA, true, PRODUCER>(&maps.mq, cur == v.X ? &maps.xp : &maps.ap, v.M, cur,
                                     v.R, nullptr, b, g, rank, csize, ring, it),
        rnorm, cluster, csize, sm);
  if (cur != v.X) {                // nobody reads X (the previous iterate) any more
    const int n = b * b;
    for (int e = rank * NT + threadIdx.x; e < n; e += csize * NT) v.X[e] = __ldcg(cur + e);
  }
  if (rank == 0 && threadIdx.x == 0) {
    res_out[g] = res;
    trips_out[g] = trips;
  }
  cluster.sync();                  // no block leaves while others read its `part`
}

// Launched with a cluster of csize (1..MAX_CLUSTER) blocks along x, one
// cluster per factor block along y (see pick_cluster).
template <bool TMA>
__global__ void __launch_bounds__(NT, 1)
ns_inverse_blocks_kernel(const __grid_constant__ Maps maps, const float* __restrict__ m_all,
                         float* x_all, float* alt_all, float* r_all,
                         float* __restrict__ res_out, int* __restrict__ trips_out, int b,
                         int iters, float tol) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[3 * G::STAGES];
  __shared__ Smem sm;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int csize = (int)cluster.num_blocks();
  const int g = blockIdx.y;
  const size_t off = (size_t)g * b * b;
  const Iterates v{m_all + off, x_all + off, alt_all + off, r_all + off};
  const Ring<TN> ring = ring_init<TN>(smem_raw, bars, TMA);

  // ||M||_1 (largest column sum of |M|) and ||M||_inf (largest row sum),
  // computed alike by every block of the cluster
  float c1 = 0.f, cinf = 0.f;
  for (int j = threadIdx.x; j < b; j += NT) {
    float s = 0.f;
    for (int i = 0; i < b; ++i) s += fabsf(v.M[(size_t)i * b + j]);
    c1 = fmaxf(c1, s);
  }
  for (int i = threadIdx.x; i < b; i += NT) {
    float s = 0.f;
    for (int j = 0; j < b; ++j) s += fabsf(v.M[(size_t)i * b + j]);
    cinf = fmaxf(cinf, s);
  }
  const float n1 = block_max<NT>(c1, sm.red);
  const float ninf = block_max<NT>(cinf, sm.red);
  const float inv = 1.f / (n1 * ninf);
  const int n = b * b;
  for (int e = rank * NT + threadIdx.x; e < n; e += csize * NT)
    v.X[e] = v.M[e] * inv;         // M = M^T
  if (TMA) asm volatile("fence.proxy.async.global;\n" ::: "memory");
  cluster.sync();

  if (threadIdx.x < PRODUCERS) {
    // the producers give registers back for the consumers' (2 x 40 + 2 x
    // 216 per thread = the SM's 512)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    trips_of<TMA, true>(maps, v, res_out, trips_out, b, g, iters, tol, rank, csize, ring,
                        cluster, sm);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 216;\n" ::: "memory");
    trips_of<TMA, false>(maps, v, res_out, trips_out, b, g, iters, tol, rank, csize, ring,
                         cluster, sm);
  }
}

}  // namespace res

// --- the tiled pair -----------------------------------------------------------

namespace tiled {

using namespace f32g;
using f32g::BK;
using f32g::NT;
using f32g::TM;

constexpr int TN = 128;    // rows of an output tile (TM = 128 columns)
using G = Geo<TN>;
constexpr int CONSUMERS = NT - PRODUCERS;

struct Shape {
  int g, b;
  int nc, tiles;           // tiles along a block's edge, tiles per block
};

// item i -> factor block gi, the tile's index t within it and its first
// row and column: g-major, the tiles of a block row-major
// (kernels/newton_schulz.py tiled_item)
__device__ __forceinline__ int item_tile(const Shape& s, int i, int& t, int& row0, int& col0) {
  const int gi = i / s.tiles;
  t = i - gi * s.tiles;
  row0 = (t / s.nc) * TN;
  col0 = (t % s.nc) * TM;
  return gi;
}

// the consumers' own barrier: the producers have run ahead into the next
// items and never reach it
__device__ __forceinline__ void consumer_bar() {
  asm volatile("bar.sync 2, %0;\n" ::"n"(CONSUMERS) : "memory");
}

// C[i][j], C[i][j + 1] = v0, v1 where inside b x b (i < b, j even)
__device__ __forceinline__ void store_pair(float* C, int b, int i, int j, float v0, float v1) {
  float* o = C + (size_t)i * b + j;
  if (j + 1 < b && (reinterpret_cast<uintptr_t>(o) & 7) == 0) {
    *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
  } else {
    if (j < b) o[0] = v0;
    if (j + 1 < b) o[1] = v1;
  }
}

// A frozen block's tile of the update: X's tile copied as it is (bit for
// bit) by the consumers (ct = 0 .. CONSUMERS - 1), outside the ring
__device__ __forceinline__ void copy_tile(const float* X, float* O, int b, int row0, int col0,
                                          int ct) {
  const int rows = min(TN, b - row0), cols = min(TM, b - col0);
  for (int e = ct; e < rows * TM; e += CONSUMERS) {
    const int r = e / TM, c = e % TM;
    if (c >= cols) continue;
    const size_t o = (size_t)(row0 + r) * b + col0 + c;
    O[o] = __ldcg(X + o);
  }
}

// The residual's sum of r^2 over one tile (tile t of factor block gi) from
// each consumer thread's own sum: warp sums, then the eight warps' in
// order, into partials[gi, t]. The consumer thread whose arrival brings
// block gi's count to `tiles` adds the block's partials (lane-strided, then
// a fixed shuffle tree in its warp) into ss_out[gi] and resets the count.
// Every sum is in a fixed order, whatever order the tiles finish in.
__device__ __forceinline__ void tile_ss(float ss, float* red, const Shape& s, int gi, int t,
                                        float* partials, unsigned int* counter, float* ss_out,
                                        int ct) {
  const int lane = ct % 32;
  ss = warp_sum(ss);
  consumer_bar();                  // red may still be read for the last tile
  if (lane == 0) red[ct / 32] = ss;
  consumer_bar();
  if (ct >= 32) return;            // the first consumer warp goes on
  float* part = partials + (size_t)gi * s.tiles;
  unsigned last = 0;
  if (ct == 0) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < CONSUMERS / 32; ++w) sum += red[w];
    part[t] = sum;
    __threadfence();               // the partial before the arrival
    last = atomicAdd(&counter[gi], 1u) == (unsigned)(s.tiles - 1);
  }
  if (!__shfl_sync(0xffffffffu, last, 0)) return;
  __threadfence();                 // every partial of gi is in L2
  float sum = 0.f;
  for (int e = lane; e < s.tiles; e += 32) sum += __ldcg(part + e);
  sum = warp_sum(sum);
  if (lane == 0) {
    ss_out[gi] = sum;
    counter[gi] = 0u;              // ready for another launch
  }
}

// One launch of the pair: C = Q P of every active factor block, tile by
// tile. RESIDUAL: Q = M, P = X, C = R = I - Q P with its sum of squares;
// else Q = X, P = R, C = X + Q P (out of place; a frozen block's tiles
// copied). Persistent blocks: block w takes items w, w + gridDim.x, ...
// R and X were written with plain stores by an earlier launch of the
// pair (or by PyTorch); the kernel boundary orders those stores before
// this launch's TMA reads (the async proxy), so no fence is needed here.
// Within a launch C is never read.
template <bool TMA, bool RESIDUAL>
__global__ void __launch_bounds__(NT, 1)
ns_tiled_kernel(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap pmap, const float* __restrict__ q_all,
                const float* __restrict__ p_all, const int* __restrict__ active,
                float* __restrict__ c_all, float* partials, unsigned int* counter,
                float* __restrict__ ss_out, Shape s) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[3 * G::STAGES];
  __shared__ float red[CONSUMERS / 32];
  const Ring<TN> ring = ring_init<TN>(smem_raw, bars, TMA);
  __syncthreads();
  const int b = s.b;
  const int items = s.g * s.tiles, stages = (b + BK - 1) / BK;
  const size_t bb = (size_t)b * b;
  // every row of X and C starts 8-byte aligned (the update's fast epilogue)
  const bool interior =
      b % 2 == 0 &&
      ((reinterpret_cast<uintptr_t>(q_all) | reinterpret_cast<uintptr_t>(c_all)) & 7) == 0;
  int it = 0;                      // ring position (each role keeps its own)

  if (threadIdx.x < PRODUCERS) {
    // producers: give registers back for the consumers' (2 x 40 + 2 x 216
    // per thread = the SM's 512)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const int pt = threadIdx.x;
    if (TMA && pt > 0 && pt < 32) return;
    for (int i = blockIdx.x; i < items; i += gridDim.x) {
      int t, row0, col0;
      const int gi = item_tile(s, i, t, row0, col0);
      if (active != nullptr && !active[gi]) continue;   // frozen: no stage for it
      if (TMA)
        tile_produce_tma<TN>(ring, it, stages, pt,
                             [&](uint32_t dq, uint32_t dp, uint32_t bar, int k0) {
                               tma_load(dq, &qmap, k0, row0, gi, bar);
                               tma_load_p(dp, &pmap, 3, col0, k0, gi, bar);
                             });
      else
        tile_produce_elements<TN>(ring, it, stages, pt, q_all + gi * bb, b, b, row0,
                                  p_all + gi * bb, b, b, col0, b);
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 216;\n" ::: "memory");
  const int ct = threadIdx.x - PRODUCERS;
  const int cw = ct / 128, t128 = ct % 128;
  for (int i = blockIdx.x; i < items; i += gridDim.x) {
    int t, row0, col0;
    const int gi = item_tile(s, i, t, row0, col0);
    const size_t off = gi * bb;
    float* C = c_all + off;
    if (active != nullptr && !active[gi]) {     // frozen: uniform over the block
      if (!RESIDUAL) copy_tile(q_all + off, C, b, row0, col0, ct);
      continue;
    }
    float acc[G::FRAG];
    tile_product<TN, TMA>(acc, ring, it, stages, cw, t128);
    if (RESIDUAL) {
      float ss = 0.f;
      for_each_pair<TN>(acc, cw, t128, [&](int row, int col, float& v0, float& v1) {
        const int r = row0 + row, j = col0 + col;
        if (r >= b) return;
        v0 = (r == j ? 1.f : 0.f) - v0;
        v1 = (r == j + 1 ? 1.f : 0.f) - v1;
        if (j < b) ss = fmaf(v0, v0, ss);
        if (j + 1 < b) ss = fmaf(v1, v1, ss);
        store_pair(C, b, r, j, v0, v1);
      });
      tile_ss(ss, red, s, gi, t, partials, counter, ss_out, ct);
    } else if (interior && row0 + TN <= b && col0 + TM <= b) {
      // a whole tile, 8-byte pairs: no branch between the loads, so they
      // are all in flight at once; all of them before any store
      const float* X = q_all + off + (size_t)row0 * b + col0;
      for_each_pair<TN>(acc, cw, t128, [&](int row, int col, float& v0, float& v1) {
        const float2 u = __ldcg(reinterpret_cast<const float2*>(X + (size_t)row * b + col));
        v0 += u.x;
        v1 += u.y;
      });
      float* O = C + (size_t)row0 * b + col0;
      for_each_pair<TN>(acc, cw, t128, [&](int row, int col, float& v0, float& v1) {
        *reinterpret_cast<float2*>(O + (size_t)row * b + col) = make_float2(v0, v1);
      });
    } else {
      const float* X = q_all + off;
      // all of the tile's X reads before any store
      for_each_pair<TN>(acc, cw, t128, [&](int row, int col, float& v0, float& v1) {
        const int r = row0 + row, j = col0 + col;
        if (r >= b) return;
        const float* x = X + (size_t)r * b + j;
        if (j + 1 < b && (reinterpret_cast<uintptr_t>(x) & 7) == 0) {
          const float2 u = __ldcg(reinterpret_cast<const float2*>(x));
          v0 += u.x;
          v1 += u.y;
        } else {
          if (j < b) v0 += __ldcg(x);
          if (j + 1 < b) v1 += __ldcg(x + 1);
        }
      });
      for_each_pair<TN>(acc, cw, t128, [&](int row, int col, float& v0, float& v1) {
        const int r = row0 + row;
        if (r < b) store_pair(C, b, r, col0 + col, v0, v1);
      });
    }
  }
}

// One launch: TMA from 3-D maps over the (g, b, b) buffers when b is a
// multiple of 4 and Q's and P's bases are 16-byte aligned, else the
// producers' element loads. blocks: the persistent blocks of threads
// (kernels/newton_schulz.py tiled_geometry), 1 .. the launch's items.
template <bool RESIDUAL>
int launch(const void* q, const void* p, const void* active, void* c, void* partials,
           void* counter, void* ss, int g, int b, int blocks, void* stream) {
  if (g < 1 || b < 1) return (int)cudaErrorInvalidValue;
  Shape s{g, b, (b + TN - 1) / TN, 0};
  s.tiles = s.nc * s.nc;
  const long long items = (long long)g * s.tiles;
  if (items > 0x7fffffffLL || blocks < 1 || blocks > items) return (int)cudaErrorInvalidValue;
  const bool tma =
      b % 4 == 0 &&
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(p)) % 16 == 0;
  CUtensorMap qmap, pmap;
  memset(&qmap, 0, sizeof(qmap));
  memset(&pmap, 0, sizeof(pmap));
  if (tma) {
    const cuuint64_t dims[3] = {(cuuint64_t)b, (cuuint64_t)b, (cuuint64_t)g};
    const cuuint64_t strides[2] = {(cuuint64_t)b * 4, (cuuint64_t)b * b * 4};
    if (encode_q(&qmap, q, 3, dims, strides, TN) || encode_p(&pmap, p, 3, dims, strides))
      return (int)cudaErrorInvalidValue;
  }
  auto kernel = tma ? ns_tiled_kernel<true, RESIDUAL> : ns_tiled_kernel<false, RESIDUAL>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (e != cudaSuccess) return (int)e;
  kernel<<<blocks, NT, G::SMEM, static_cast<cudaStream_t>(stream)>>>(
      qmap, pmap, static_cast<const float*>(q), static_cast<const float*>(p),
      static_cast<const int*>(active), static_cast<float*>(c), static_cast<float*>(partials),
      static_cast<unsigned int*>(counter), static_cast<float*>(ss), s);
  return (int)cudaGetLastError();
}

}  // namespace tiled

cudaLaunchConfig_t resident_config(int csize, int g, cudaStream_t stream,
                                   cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(csize, g);
  cfg.blockDim = dim3(res::NT);
  cfg.dynamicSmemBytes = res::G::SMEM;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = csize;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// TMA needs 16-byte rows (b a multiple of 4); torch's allocations are
// aligned beyond that
bool resident_tma(int b) { return b % 4 == 0; }

// the kernel instance for blocks of b, its shared memory raised to the
// ring's 193 KB
int resident_kernel(int b, decltype(&res::ns_inverse_blocks_kernel<true>)* kernel) {
  *kernel = resident_tma(b) ? res::ns_inverse_blocks_kernel<true>
                            : res::ns_inverse_blocks_kernel<false>;
  return (int)cudaFuncSetAttribute(*kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   res::G::SMEM);
}

// Blocks per cluster for g factor blocks of size b: the size with the
// fewest rounds of tiles (a block works one 128 x 128 output tile at a
// time) times waves of clusters, from the card's own count of clusters of
// that size it holds at once (a block's 193 KB of shared memory fills an
// SM and a cluster must sit in one GPC: an H100 SXM holds 15 clusters of 8,
// so at the training path's g = 16 the 16th would wait for a whole second
// wave). Ties go to the larger cluster. The counts are asked once per
// device, kernel instance and size.
int pick_cluster(int g, int b, int* csize) {
  static int held[2][16][MAX_CLUSTER + 1];        // 0 = not asked yet
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  decltype(&res::ns_inverse_blocks_kernel<true>) kernel;
  const int rk = resident_kernel(b, &kernel);
  if (rk) return rk;
  const int tma = resident_tma(b);
  const int tiles = res::tiles_of(b);
  long best = -1;
  for (int cs = MAX_CLUSTER; cs >= 1; --cs) {
    int n = dev < 16 ? held[tma][dev][cs] : 0;
    if (n == 0) {
      cudaLaunchAttribute attr;
      const cudaLaunchConfig_t cfg = resident_config(cs, 1, nullptr, &attr);
      err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
      if (err != cudaSuccess) return (int)err;
      if (n < 1) continue;
      if (dev < 16) held[tma][dev][cs] = n;
    }
    const long rounds = (tiles + cs - 1) / cs;
    const long waves = (g + n - 1) / n;
    if (best < 0 || rounds * waves < best) {
      best = rounds * waves;
      *csize = cs;
    }
  }
  return best < 0 ? (int)cudaErrorInvalidConfiguration : (int)cudaSuccess;
}

}  // namespace

// The cluster size ns_inverse_blocks launches with for g blocks of b (for
// reports): 1..8, or minus a CUDA error code.
extern "C" int ns_resident_cluster(int g, int b) {
  int cs = 0;
  const int err = pick_cluster(g, b, &cs);
  return err ? -err : cs;
}

// m (g, b, b) -> x (g, b, b), res (g,), trips (g,) i32; alt and r are
// (g, b, b) f32 scratch.
extern "C" int ns_inverse_blocks(const void* m, void* x, void* alt, void* r, void* res,
                                 void* trips, int g, int b, int iters, float tol,
                                 void* stream) {
  if (g < 1 || b < 1 || iters < 0 || g > 65535) return (int)cudaErrorInvalidValue;
  int cs = 0;
  const int err = pick_cluster(g, b, &cs);
  if (err) return err;
  decltype(&res::ns_inverse_blocks_kernel<true>) kernel;
  const int rk = resident_kernel(b, &kernel);
  if (rk) return rk;
  res::Maps maps;
  memset(&maps, 0, sizeof(maps));
  if (resident_tma(b)) {
    if ((reinterpret_cast<uintptr_t>(m) | reinterpret_cast<uintptr_t>(x) |
         reinterpret_cast<uintptr_t>(alt) | reinterpret_cast<uintptr_t>(r)) % 16)
      return (int)cudaErrorMisalignedAddress;
    const cuuint64_t dims[3] = {(cuuint64_t)b, (cuuint64_t)b, (cuuint64_t)g};
    const cuuint64_t strides[2] = {(cuuint64_t)b * 4, (cuuint64_t)b * b * 4};
    if (f32g::encode_q(&maps.mq, m, 3, dims, strides, res::TN) ||
        f32g::encode_q(&maps.xq, x, 3, dims, strides, res::TN) ||
        f32g::encode_q(&maps.aq, alt, 3, dims, strides, res::TN) ||
        f32g::encode_p(&maps.xp, x, 3, dims, strides) ||
        f32g::encode_p(&maps.ap, alt, 3, dims, strides) ||
        f32g::encode_p(&maps.rp, r, 3, dims, strides))
      return (int)cudaErrorInvalidValue;
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      resident_config(cs, g, static_cast<cudaStream_t>(stream), &attr);
  return (int)cudaLaunchKernelEx(&cfg, kernel, maps, static_cast<const float*>(m),
                                 static_cast<float*>(x), static_cast<float*>(alt),
                                 static_cast<float*>(r), static_cast<float*>(res),
                                 static_cast<int*>(trips), b, iters, tol);
}

// m, x (g, b, b), active (g,) i32 or null -> r (g, b, b), ss (g,) (zeroed
// by the caller: a frozen block's stays 0); partials (g, tiles) f32
// scratch, counter (g,) u32 zeroed before the first launch; blocks as
// tiled::launch takes it
extern "C" int ns_tiled_residual(const void* m, const void* x, const void* active, void* r,
                                 void* partials, void* counter, void* ss, int g, int b,
                                 int blocks, void* stream) {
  return tiled::launch<true>(m, x, active, r, partials, counter, ss, g, b, blocks, stream);
}

// x, r (g, b, b), active (g,) i32 or null -> out (g, b, b) = x + x r (x where
// frozen); out must not alias x or r
extern "C" int ns_tiled_update(const void* x, const void* r, const void* active, void* out,
                               int g, int b, int blocks, void* stream) {
  return tiled::launch<false>(x, r, active, out, nullptr, nullptr, nullptr, g, b, blocks,
                              stream);
}
