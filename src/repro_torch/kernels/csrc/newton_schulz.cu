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
// ns_tiled_residual / ns_tiled_update: one block of 256 threads per
// (factor block, 64 x 64 output tile); the contraction is a loop inside the
// block (it replaces the TPU's sequential k grid axis). The identity is
// added on the diagonal; each tile's sum of r^2 goes into a (g, tiles)
// partials buffer and the last block of a factor block to finish adds them
// in a fixed order, so ss does not depend on the order blocks run in. A
// per-block `active` flag (device memory, no host read) makes the
// residual's blocks of a frozen factor block return at once and the update's
// copy their X tile unchanged (bit-stable). The freeze logic and the trip
// loop are in the wrapper (kernels/newton_schulz.py ns_inverse_tiled).
// Their products still run on the CUDA cores with fmaf (simt_tile.cuh).
//
// Bound: one trip is two b x b x b products, 4 b^3 operations a block, on
// 3 b^2 f32 of data: far above the card's operations-per-byte ratio at the
// path's b 512 and 2048, so bound by f32-accurate operations: 165 TFLOP/s
// of f32 work for the split products (three TF32 products at 495), 67 for
// the tiled pair's fmaf. One TF32 product would miss the residual
// tolerance 1e-4 and the 1e-5 agreement with the plain iteration; the
// split keeps both (f32_split_gemm.cuh). The resident kernel occupies up
// to 8 g SMs.

#include <cooperative_groups.h>

#include "f32_split_gemm.cuh"
#include "simt_tile.cuh"

namespace cg = cooperative_groups;

namespace {

using simt::BK;
using simt::TILE;

constexpr int GROUP = simt::NT;        // threads of one 64 x 64 tile product (tiled pair)
constexpr int MAX_CLUSTER = 8;         // blocks per factor block, at most (portable)

// acc = A[row0 : row0+64, 0:b] @ B[0:b, col0 : col0+64] for b x b row-major
// A and B, entries past b read as 0, by the block's 256 threads (t).
__device__ __forceinline__ void simt_product(const float* A, const float* B, int b, int row0,
                                             int col0, simt::Smem& sm, float (&acc)[4][4],
                                             int t) {
  const int tx = t % 16, ty = t / 16;
  const int ar = t / 4, ak = (t % 4) * 4;      // A slice: 64 rows x 16 deep
  const int br = t / 16, bc = (t % 16) * 4;    // B slice: 16 deep x 64 columns
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  for (int k0 = 0; k0 < b; k0 += BK) {
    float av[4], bv[4];
    const int arow = row0 + ar;
    const int bk = k0 + br;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ak_e = k0 + ak + e;
      av[e] = (arow < b && ak_e < b) ? A[(size_t)arow * b + ak_e] : 0.f;
      const int bcol = col0 + bc + e;
      bv[e] = (bk < b && bcol < b) ? B[(size_t)bk * b + bcol] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sm.a[ak + e][ar] = av[e];
      sm.b[br][bc + e] = bv[e];
    }
    __syncthreads();
    simt::tile_fma(sm, acc, ty, tx);
  }
}

// Sum of v over the block's threads in a fixed order (warp shuffles, then
// the warps' sums by warp 0); every thread gets the result.
template <int NT>
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  v = warp_sum(v);
  __syncthreads();                 // red may still be read from the last call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float s = lane < NT / 32 ? red[lane] : 0.f;
    s = warp_sum(s);
    if (lane == 0) red[32] = s;
  }
  __syncthreads();
  return red[32];
}

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
using f32g::BK;            // not simt's
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

__global__ void __launch_bounds__(GROUP)
ns_tiled_residual_kernel(const float* __restrict__ m_all, const float* __restrict__ x_all,
                         const int* __restrict__ active, float* __restrict__ r_all,
                         float* partials, unsigned int* counter, float* __restrict__ ss_out,
                         int b) {
  const int g = blockIdx.z;
  if (active != nullptr && !active[g]) return;     // frozen: uniform over the block
  __shared__ __align__(16) simt::Smem sm;
  __shared__ float red[33];
  __shared__ bool last;
  const size_t off = (size_t)g * b * b;
  const int nt = gridDim.x;
  const int row0 = blockIdx.y * TILE, col0 = blockIdx.x * TILE;
  const int t = threadIdx.x, tx = t % 16, ty = t / 16;
  float acc[4][4];
  simt_product(m_all + off, x_all + off, b, row0, col0, sm, acc, t);
  float ss = 0.f;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = row0 + ty * 4 + r;
    if (i >= b) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = col0 + tx * 4 + c;
      if (j >= b) continue;
      const float v = (i == j ? 1.f : 0.f) - acc[r][c];
      ss = fmaf(v, v, ss);
      r_all[off + (size_t)i * b + j] = v;
    }
  }
  ss = block_sum<GROUP>(ss, red);
  const int tiles = nt * nt;
  if (t == 0) {
    partials[(size_t)g * tiles + blockIdx.y * nt + blockIdx.x] = ss;
    __threadfence();
    last = atomicAdd(&counter[g], 1u) == (unsigned)(tiles - 1);
  }
  __syncthreads();
  if (!last) return;               // uniform: `last` is in shared memory
  __threadfence();
  float s = 0.f;
  for (int e = t; e < tiles; e += GROUP) s += __ldcg(&partials[(size_t)g * tiles + e]);
  s = block_sum<GROUP>(s, red);
  if (t == 0) {
    ss_out[g] = s;
    counter[g] = 0u;               // ready for the next launch
  }
}

__global__ void __launch_bounds__(GROUP)
ns_tiled_update_kernel(const float* __restrict__ x_all, const float* __restrict__ r_all,
                       const int* __restrict__ active, float* __restrict__ out_all, int b) {
  const int g = blockIdx.z;
  const size_t off = (size_t)g * b * b;
  const int row0 = blockIdx.y * TILE, col0 = blockIdx.x * TILE;
  const int t = threadIdx.x, tx = t % 16, ty = t / 16;
  const float* X = x_all + off;
  float* O = out_all + off;
  if (active != nullptr && !active[g]) {           // frozen: copy the tile as it is
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = row0 + ty * 4 + r;
      if (i >= b) continue;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = col0 + tx * 4 + c;
        if (j < b) O[(size_t)i * b + j] = X[(size_t)i * b + j];
      }
    }
    return;
  }
  __shared__ __align__(16) simt::Smem sm;
  float acc[4][4];
  simt_product(X, r_all + off, b, row0, col0, sm, acc, t);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = row0 + ty * 4 + r;
    if (i >= b) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = col0 + tx * 4 + c;
      if (j < b) O[(size_t)i * b + j] = X[(size_t)i * b + j] + acc[r][c];
    }
  }
}

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

// m, x (g, b, b), active (g,) i32 or null -> r (g, b, b), ss (g,); partials
// (g, tiles) f32 scratch, counter (g,) u32 zeroed before the first launch.
extern "C" int ns_tiled_residual(const void* m, const void* x, const void* active, void* r,
                                 void* partials, void* counter, void* ss, int g, int b,
                                 void* stream) {
  const int nt = (b + TILE - 1) / TILE;
  if (g < 1 || b < 1 || g > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(nt, nt, g);
  ns_tiled_residual_kernel<<<grid, GROUP, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(m), static_cast<const float*>(x),
      static_cast<const int*>(active), static_cast<float*>(r), static_cast<float*>(partials),
      static_cast<unsigned int*>(counter), static_cast<float*>(ss), b);
  return (int)cudaGetLastError();
}

// x, r (g, b, b), active (g,) i32 or null -> out (g, b, b) = x + x r (x where
// frozen)
extern "C" int ns_tiled_update(const void* x, const void* r, const void* active, void* out,
                               int g, int b, void* stream) {
  const int nt = (b + TILE - 1) / TILE;
  if (g < 1 || b < 1 || g > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(nt, nt, g);
  ns_tiled_update_kernel<<<grid, GROUP, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(r),
      static_cast<const int*>(active), static_cast<float*>(out), b);
  return (int)cudaGetLastError();
}
