// Newton-Schulz damped inverse of symmetric factor blocks (Stage 4), f32
// throughout with fmaf (no TF32).
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
// ns_inverse_blocks: one cluster of up to 8 blocks of 1024 threads per
// factor block runs the whole method in one launch (norms, X0, up to
// `iters` trips with the freeze, the residual of the returned iterate, the
// trip count). On the TPU M, X and the step temporary sat in VMEM; here
// 3 b^2 f32 (3 MB at b 512) do not fit the 227 KB of shared memory, so X,
// the other iterate and R live in scratch in device memory, allocated by
// the wrapper; at the training path's g 16, b 512 they stay in the 50 MB
// L2. Each product walks 64 x 64 output tiles through shared memory, four
// at a time in each block of the cluster (one per group of 256 threads,
// each group on its own named barrier, so the groups interleave). A
// cluster barrier separates one product's stores from the next product's
// loads, which read the iterates from L2. ||R||^2 is a block reduction,
// then each block adds the cluster's partial sums through distributed
// shared memory in rank order: every block computes the same residual, so
// the freeze is a cluster-uniform break, and it is deterministic. The
// cluster size adapts to g (pick_cluster), so that the clusters run in
// one wave where the card can hold them.
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
//
// Bound: one trip is two b x b x b products, 4 b^3 operations a block, on
// 3 b^2 f32 of data: far above the card's operations-per-byte ratio at the
// path's b 512 and 2048, so bound by f32 operations (67 TFLOP/s). The
// residual tolerance 1e-4 rules out TF32 (10-bit mantissa): the products
// run on the CUDA cores with fmaf. The resident kernel occupies up to 8 g
// SMs.

#include <cooperative_groups.h>

#include "simt_tile.cuh"

namespace cg = cooperative_groups;

namespace {

using simt::BK;
using simt::TILE;

constexpr int GROUP = simt::NT;        // threads of one 64 x 64 tile product
constexpr int NGROUPS = 4;             // tiles in flight in the resident kernel
constexpr int RES_NT = GROUP * NGROUPS;
constexpr int MAX_CLUSTER = 8;         // blocks per factor block, at most (portable)

// Barrier of the threads that share one tile's shared memory: the whole
// block of 256, or (RESIDENT) the group of 256 `grp` within the block of
// 1024 (named barrier grp + 1), so the four groups do not wait on each
// other and one group's loads overlap another's arithmetic.
template <bool RESIDENT>
__device__ __forceinline__ void tile_sync(int grp) {
  if constexpr (RESIDENT) {
    asm volatile("bar.sync %0, %1;" ::"r"(grp + 1), "n"(GROUP) : "memory");
  } else {
    __syncthreads();
  }
}

// acc = A[row0 : row0+64, 0:b] @ B[0:b, col0 : col0+64] for b x b row-major
// A and B, entries past b read as 0. All threads of the group call it the
// same number of times (it holds tile_sync); `t` is the thread's index
// within its group of 256, `grp` the group's index in the block (RESIDENT:
// see tile_sync).
template <bool RESIDENT>
__device__ __forceinline__ void tile_product(const float* A, const float* B, int b, int row0,
                                             int col0, simt::Smem& sm, float (&acc)[4][4],
                                             int t, int grp) {
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
    tile_sync<RESIDENT>(grp);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sm.a[ak + e][ar] = av[e];
      sm.b[br][bc + e] = bv[e];
    }
    tile_sync<RESIDENT>(grp);
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

struct ResidentSmem {
  simt::Smem tile[NGROUPS];
  float red[33];
  float part;                      // this block's sum of r^2, read by the cluster
};

// This block's share of one product over the cluster of `csize` blocks
// (block `rank` takes tiles rank*NGROUPS + grp, stepping by
// csize*NGROUPS). RESIDUAL: C = I - A B (returns the thread's sum of
// r^2); else C = A + A B (the update, A = the current iterate, B = R).
// The caller syncs the cluster before anyone reads C.
template <bool RESIDUAL>
__device__ __forceinline__ float resident_product(const float* A, const float* B, float* C,
                                                  int b, int rank, int csize,
                                                  ResidentSmem& sm) {
  const int grp = threadIdx.x / GROUP, t = threadIdx.x % GROUP;
  const int tx = t % 16, ty = t / 16;
  const int nt = (b + TILE - 1) / TILE;
  const int tiles = nt * nt;
  float ss = 0.f;
  float acc[4][4];
  for (int tile = rank * NGROUPS + grp; tile < tiles; tile += csize * NGROUPS) {
    const int row0 = (tile / nt) * TILE, col0 = (tile % nt) * TILE;
    tile_product<true>(A, B, b, row0, col0, sm.tile[grp], acc, t, grp);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = row0 + ty * 4 + r;
      if (i >= b) continue;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = col0 + tx * 4 + c;
        if (j >= b) continue;
        const size_t at = (size_t)i * b + j;
        float v;
        if constexpr (RESIDUAL) {
          v = (i == j ? 1.f : 0.f) - acc[r][c];
          ss = fmaf(v, v, ss);
        } else {
          v = __ldcg(A + at) + acc[r][c];
        }
        C[at] = v;
      }
    }
  }
  return ss;
}

// ||R||_F / sqrt(b) of the residual the cluster just stored, from each
// block's thread sums `ss`: every block adds the blocks' partial sums in
// rank order, so all hold the same value. Syncs the cluster (R complete).
__device__ float cluster_residual(float ss, float rnorm, cg::cluster_group& cluster,
                                  int csize, ResidentSmem& sm) {
  ss = block_sum<RES_NT>(ss, sm.red);
  if (threadIdx.x == 0) sm.part = ss;
  cluster.sync();
  float total = 0.f;
  for (int q = 0; q < csize; ++q) total += *cluster.map_shared_rank(&sm.part, q);
  return sqrtf(total) * rnorm;
}

// Launched with a cluster of csize (1..MAX_CLUSTER) blocks along x, one
// cluster per factor block along y (see pick_cluster).
__global__ void __launch_bounds__(RES_NT, 1)
ns_inverse_blocks_kernel(const float* __restrict__ m_all, float* x_all, float* alt_all,
                         float* r_all, float* __restrict__ res_out, int* __restrict__ trips_out,
                         int b, int iters, float tol) {
  __shared__ __align__(16) ResidentSmem sm;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int csize = (int)cluster.num_blocks();
  const size_t off = (size_t)blockIdx.y * b * b;
  const float* M = m_all + off;
  float* X = x_all + off;
  float* alt = alt_all + off;
  float* R = r_all + off;
  const int n = b * b;

  // ||M||_1 (largest column sum of |M|) and ||M||_inf (largest row sum),
  // computed alike by every block of the cluster
  float c1 = 0.f, cinf = 0.f;
  for (int j = threadIdx.x; j < b; j += RES_NT) {
    float s = 0.f;
    for (int i = 0; i < b; ++i) s += fabsf(M[(size_t)i * b + j]);
    c1 = fmaxf(c1, s);
  }
  for (int i = threadIdx.x; i < b; i += RES_NT) {
    float s = 0.f;
    for (int j = 0; j < b; ++j) s += fabsf(M[(size_t)i * b + j]);
    cinf = fmaxf(cinf, s);
  }
  const float n1 = block_max<RES_NT>(c1, sm.red);
  const float ninf = block_max<RES_NT>(cinf, sm.red);
  const float inv = 1.f / (n1 * ninf);
  const int share = csize * RES_NT;               // this block's slice of X
  for (int e = rank * RES_NT + threadIdx.x; e < n; e += share) X[e] = M[e] * inv;  // M = M^T
  cluster.sync();

  const float rnorm = (float)(1.0 / sqrt((double)b));
  float* cur = X;
  float* nxt = alt;
  float res = 0.f;
  int trips = 0;
  bool frozen = false;
  for (int it = 0; it < iters; ++it) {
    res = cluster_residual(resident_product<true>(M, cur, R, b, rank, csize, sm), rnorm,
                           cluster, csize, sm);
    if (!(res > tol)) {            // cluster-uniform: every thread holds res
      frozen = true;
      break;
    }
    resident_product<false>(cur, R, nxt, b, rank, csize, sm);
    cluster.sync();                // nxt complete; partial sums read
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
    ++trips;
  }
  if (!frozen)                     // the residual of the returned iterate
    res = cluster_residual(resident_product<true>(M, cur, R, b, rank, csize, sm), rnorm,
                           cluster, csize, sm);
  if (cur != X) {                  // nobody reads X (the previous iterate) any more
    for (int e = rank * RES_NT + threadIdx.x; e < n; e += share) X[e] = __ldcg(cur + e);
  }
  if (rank == 0 && threadIdx.x == 0) {
    res_out[blockIdx.y] = res;
    trips_out[blockIdx.y] = trips;
  }
  cluster.sync();                  // no block leaves while others read its `part`
}

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
  tile_product<false>(m_all + off, x_all + off, b, row0, col0, sm, acc, t, 0);
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
  tile_product<false>(X, r_all + off, b, row0, col0, sm, acc, t, 0);
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
  cfg.blockDim = dim3(RES_NT);
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = csize;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Blocks per cluster for g factor blocks of size b: the size with the
// fewest rounds of tiles (a block works 4 tiles at a time) times waves of
// clusters, from the card's own count of clusters of that size it holds at
// once (a block of 1024 threads fills an SM and a cluster must sit in one
// GPC: an H100 SXM holds 15 clusters of 8, so at the training path's
// g = 16 the 16th would wait for a whole second wave). Ties go to the
// larger cluster. The counts are asked once per device and size.
int pick_cluster(int g, int b, int* csize) {
  static int held[16][MAX_CLUSTER + 1];           // 0 = not asked yet
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const int nt = (b + TILE - 1) / TILE;
  const int tiles = nt * nt;
  long best = -1;
  for (int cs = MAX_CLUSTER; cs >= 1; --cs) {
    int n = dev < 16 ? held[dev][cs] : 0;
    if (n == 0) {
      cudaLaunchAttribute attr;
      const cudaLaunchConfig_t cfg = resident_config(cs, 1, nullptr, &attr);
      err = cudaOccupancyMaxActiveClusters(&n, ns_inverse_blocks_kernel, &cfg);
      if (err != cudaSuccess) return (int)err;
      if (n < 1) continue;
      if (dev < 16) held[dev][cs] = n;
    }
    const long rounds = (tiles + cs * NGROUPS - 1) / (cs * NGROUPS);
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
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      resident_config(cs, g, static_cast<cudaStream_t>(stream), &attr);
  return (int)cudaLaunchKernelEx(&cfg, ns_inverse_blocks_kernel, static_cast<const float*>(m),
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
