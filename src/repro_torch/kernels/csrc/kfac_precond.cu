// Blocked preconditioner application at f32 accuracy on the tensor cores:
// split TF32 products (3xTF32) on wgmma, the tile of f32_split_gemm.cuh.
//
// Replaces the TPU kernel repro/kernels/kfac_precond.py::block_precond
// (_precond_kernel) with its wrapper repro/kernels/ops.py
// kfac_block_precond, and the transposes through which
// repro/kernels/dispatch.py _precond_right_pallas reuses it from the right.
//
//   binv (lead, nb, b, b) f32, the inverse of each diagonal block (not
//        assumed symmetric), rows contiguous, matrices lb elements apart
//   left mode  (A^-1 dW):  w (lead, dim, other), rows in blocks of b, row
//                          stride ldw, matrices lw elements apart
//                          out[e, kb + r, :] = sum_c binv[e, k, r, c] * w[e, kb + c, :]
//   right mode (dW G^-1):  w (lead, other, dim), columns in blocks of b
//                          out[e, :, kb + p] = sum_c w[e, :, kb + c] * binv[e, k, c, p]
//   out has w's shape, row stride ldo, matrices lo elements apart
//
// lead is the expert axis of an MoE site (1 for every other site): all its
// matrices are one launch, their (matrix, block) pairs one list of items.
//
// Each block k is one product C = Q P of f32_split_gemm.cuh, with both
// operands read in place through their row strides (no transpose): left,
// Q = binv[k] and P = w's rows kb..kb+b; right, Q = w's columns kb..kb+b
// and P = binv[k]. C is cut into 128 x 128 tiles. The work items are
// (matrix e, block k, tile), matrix- then block-major, the tile index
// along binv's side of C
// fastest (so the items in flight share one panel of w and sweep binv,
// which stays in L2); a block whose valid rows (left) or columns (right)
// end before a tile skips it. The blocks of threads are persistent, one
// per SM: block w of B takes items w, w + B, w + 2B, ...
// (kernels/kfac.py precond_geometry mirrors the partition, and the wrapper
// passes B). Each tile sums its K in one block in a fixed order, with no
// atomics, so two launches give the same bits.
//
// Operands: 16-byte aligned bases and row strides (b and ldw multiples of
// 4; binv's matrices contiguous, w's apart by a multiple of 4 and at least
// a whole matrix) go through TMA: 3-D maps over binv (b, b, lead * nb) and
// over w (columns, rows, lead), so a box past binv's edge or past w's last
// row or column reads zeros, never the next matrix's. The
// ragged last block (dim not a multiple of b) needs nothing else: its K
// range stops at its valid rows of w, and w reads as zero past dim, so
// the binv entries past the valid range multiply zeros; a K range that
// runs past b reads zeros from binv's side. Other shapes (the expanded
// (3, 97, 97) identity of a fresh optimizer state) go through the same
// pipeline with the producer's element loads, masked on both sides.
//
// Bound: 2*dim*b*other operations on dim*other + nb*b*b f32 inputs and
// dim*other f32 outputs; at the training path's shapes (b 2048, other 512
// to 128256) far above the card's bytes per operation, so bound by
// f32-accurate operations: the split products' 165 TFLOP/s of f32 work
// (three TF32 products at 495). The f32 CUDA cores (67 TFLOP/s, fmaf) are
// not used: one TF32 product alone would miss the 1e-4 agreement, the
// split keeps it (f32_split_gemm.cuh).

#include "f32_split_gemm.cuh"

namespace {

using namespace f32g;

constexpr int TN = 128;    // C rows per tile (TM = 128 columns)
using G = Geo<TN>;

struct Shape {
  int b, dim, other, ldw, ldo, nb, right;
  int tiles_r, tiles_c;    // tiles along one block's C rows and columns
  int lead;                // matrices
  long long lb, lw, lo;    // elements between matrices of binv, w, out
};

// item i -> (matrix e, block k, tile row tr, tile column tc) and the
// block's valid rows of w (left) or columns (right); false when the tile
// lies past them
__device__ __forceinline__ bool item_tile(const Shape& s, int i, int& e, int& k, int& tr,
                                          int& tc, int& valid) {
  const int per = s.tiles_r * s.tiles_c;
  k = i / per;
  const int t = i - k * per;
  e = k / s.nb;
  k -= e * s.nb;
  if (s.right) {
    tc = t % s.tiles_c;
    tr = t / s.tiles_c;
  } else {
    tr = t % s.tiles_r;
    tc = t / s.tiles_r;
  }
  valid = min(s.b, s.dim - k * s.b);
  return (s.right ? tc * TM : tr * TN) < valid;
}

template <bool TMA>
__global__ void __launch_bounds__(NT, 1)
block_precond_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap pmap, const float* __restrict__ binv,
                     const float* __restrict__ w, float* __restrict__ out, Shape s) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[3 * G::STAGES];
  const Ring<TN> ring = ring_init<TN>(smem_raw, bars, TMA);
  __syncthreads();
  const int wg = threadIdx.x / 128;
  const int items = s.lead * s.nb * s.tiles_r * s.tiles_c;
  int it = 0;

  if (wg < 2) {
    // producers: give registers back for the consumers' (2 x 40 + 2 x 216
    // per thread = the SM's 512)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const int pt = threadIdx.x;
    if (TMA && pt > 0 && pt < 32) return;
    for (int i = blockIdx.x; i < items; i += gridDim.x) {
      int e, k, tr, tc, valid;
      if (!item_tile(s, i, e, k, tr, tc, valid)) continue;
      const int stages = (valid + BK - 1) / BK;
      if (TMA) {
        const int kb = k * s.b;
        const int bk = e * s.nb + k;   // binv[e, k] in the flattened map
        tile_produce_tma<TN>(ring, it, stages, pt,
                             [&](uint32_t dq, uint32_t dp, uint32_t bar, int k0) {
                               if (s.right) {
                                 tma_load(dq, &qmap, kb + k0, tr * TN, e, bar);   // w[e]
                                 tma_load_p(dp, &pmap, 3, tc * TM, k0, bk, bar);  // binv[e, k]
                               } else {
                                 tma_load(dq, &qmap, k0, tr * TN, bk, bar);       // binv[e, k]
                                 tma_load_p(dp, &pmap, 3, tc * TM, kb + k0, e, bar);  // w[e]
                               }
                             });
      } else {
        const size_t kb = (size_t)k * s.b;
        const float* we = w + (size_t)e * s.lw;
        const float* be = binv + (size_t)e * s.lb;
        if (s.right)
          tile_produce_elements<TN>(ring, it, stages, pt, we + kb, s.ldw, s.other, tr * TN,
                                    be + kb * s.b, s.b, valid, tc * TM, valid);
        else
          tile_produce_elements<TN>(ring, it, stages, pt, be + kb * s.b, s.b, valid, tr * TN,
                                    we + kb * s.ldw, s.ldw, s.other, tc * TM, valid);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 216;\n" ::: "memory");
  const int cw = wg - 2, t = threadIdx.x % 128;
  for (int i = blockIdx.x; i < items; i += gridDim.x) {
    int e, k, tr, tc, valid;
    if (!item_tile(s, i, e, k, tr, tc, valid)) continue;
    float acc[G::FRAG];
    tile_product<TN, TMA>(acc, ring, it, (valid + BK - 1) / BK, cw, t);
    const int rows = s.right ? s.other : valid;   // C's extent in bounds
    const int cols = s.right ? valid : s.other;
    float* c = out + (size_t)e * s.lo + (s.right ? (size_t)k * s.b : (size_t)k * s.b * s.ldo);
    const int r0 = tr * TN, c0 = tc * TM;
    for_each_pair<TN>(acc, cw, t, [&](int row, int col, float& v0, float& v1) {
      const int i_ = r0 + row, j = c0 + col;
      if (i_ >= rows || j >= cols) return;
      float* o = c + (size_t)i_ * s.ldo + j;
      if (j + 1 < cols && (reinterpret_cast<uintptr_t>(o) & 7) == 0) {
        *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
      } else {
        o[0] = v0;
        if (j + 1 < cols) o[1] = v1;
      }
    });
  }
}

}  // namespace

// blocks: the persistent blocks of threads (kernels/kfac.py
// precond_geometry), 1 .. the launch's items; lead matrices of binv, w
// and out, lb, lw and lo elements apart
extern "C" int block_precond(const void* binv, const void* w, void* out, int lead,
                             long long lb, long long lw, long long lo, int b, int dim,
                             int other, int ldw, int ldo, int nb, int right, int blocks,
                             void* stream) {
  if (nb < 1 || b < 1 || other < 1 || lead < 1 || (long long)(nb - 1) * b >= dim ||
      (long long)nb * b < dim || lb < 0 || lw < 0 || lo < 0)
    return (int)cudaErrorInvalidValue;
  Shape s{b, dim, other, ldw, ldo, nb, right, 0, 0, lead, lb, lw, lo};
  s.tiles_r = ((right ? other : b) + TN - 1) / TN;
  s.tiles_c = ((right ? b : other) + TM - 1) / TM;
  const long long items = (long long)lead * nb * s.tiles_r * s.tiles_c;
  if (items > 0x7fffffffLL || blocks < 1 || blocks > items) return (int)cudaErrorInvalidValue;
  const long long wrows = right ? other : dim;
  const bool tma = reinterpret_cast<uintptr_t>(binv) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0 && ldw % 4 == 0 && b % 4 == 0 &&
                   lb == (long long)nb * b * b && lw % 4 == 0 && lw >= wrows * ldw;
  CUtensorMap qmap, pmap;
  memset(&qmap, 0, sizeof(qmap));
  memset(&pmap, 0, sizeof(pmap));
  if (tma) {
    const cuuint64_t bdims[3] = {(cuuint64_t)b, (cuuint64_t)b, (cuuint64_t)lead * nb};
    const cuuint64_t bstrides[2] = {(cuuint64_t)b * 4, (cuuint64_t)b * b * 4};
    const cuuint64_t wdims[3] = {(cuuint64_t)(right ? dim : other), (cuuint64_t)wrows,
                                 (cuuint64_t)lead};
    const cuuint64_t wstrides[2] = {(cuuint64_t)ldw * 4, (cuuint64_t)lw * 4};
    const int rc = right ? (encode_q(&qmap, w, 3, wdims, wstrides, TN) ||
                            encode_p(&pmap, binv, 3, bdims, bstrides))
                         : (encode_q(&qmap, binv, 3, bdims, bstrides, TN) ||
                            encode_p(&pmap, w, 3, wdims, wstrides));
    if (rc) return (int)cudaErrorInvalidValue;
  }
  auto kernel = tma ? block_precond_kernel<true> : block_precond_kernel<false>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (e != cudaSuccess) return (int)e;
  kernel<<<blocks, NT, G::SMEM, static_cast<cudaStream_t>(stream)>>>(
      qmap, pmap, static_cast<const float*>(binv), static_cast<const float*>(w),
      static_cast<float*>(out), s);
  return (int)cudaGetLastError();
}
