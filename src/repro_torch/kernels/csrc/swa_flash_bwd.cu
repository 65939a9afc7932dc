// Attention backward from the forward's residuals (FlashAttention-2 style):
// dq, and dk/dv per KV head, of the GQA causal(-window) attention.
//
// Replaces the TPU kernels repro/kernels/swa_attention.py::swa_flash_bwd_dq
// (_swa_bwd_dq_kernel) and ::swa_flash_bwd_dkdv (_swa_bwd_dkdv_kernel),
// with their wrapper repro/kernels/ops.py swa_attention_bwd.
//
//   q, do  (BKV, G, S, HD)  bf16 | f32, query head h = c*G + r under KV head c
//   k, v   (BKV, S, HD)     same dtype, KV unexpanded
//   lse    (BKV, G, S)      f32, the forward's m + log(d)
//   delta  (BKV, G, S)      f32, rowsum(do * o), computed by the caller
//   dq     (BKV, G, S, HD)  f32
//   dk, dv (BKV, S, HD)     f32, summed over the G query heads of the group
//
// p = exp(scale q.k - lse) is rebuilt from the residual, ds = p * (do.v -
// delta), dq = scale * sum_j ds k_j, dk = scale * sum_i ds q_i, dv = sum_i
// p do_i. Key j is visible to query i iff i - window < j <= i (window 0:
// causal).
//
// Bound: about 14*HD*G*BKV*(visible (i, j) pairs) operations between the
// two kernels (6 for dq, 8 for dk/dv) against a few MB of inputs: at the
// training path's shapes (BKV 32, G 4, S 1024, HD 64) bound by operations,
// which for bf16 means the tensor cores.
//
// bf16 (every training call) runs the tensor-core kernels of
// swa_flash_bwd_wgmma.cuh: persistent blocks of a TMA producer and two
// wgmma consumer warpgroups; dq takes (128-row query tile, query head)
// items as the forward walk does, dk/dv (128-key tile, KV head) items
// streaming 64-query stages of every head of the group; P and dS are each
// split in two bf16 terms for the products that take them, which keeps the
// gradients within BWD_REL_TOL. On an H100 80GB HBM3 at 700 W the pair runs
// about 16x faster than the CUDA-core bodies at the training call, a little
// faster than SDPA's whole backward and at about 3.6x its bound
// (chip_smoke.py times both kernels beside their bound and SDPA; PERF.md
// keeps the numbers).
//
// f32 (the 2-layer f32 route checks) keeps the CUDA-core bodies below,
// with q scaled by HD^-0.5 as it is read (exact enough in f32):
// dq: one block of 128 threads per (query tile, group head, KV head); TPR
// threads share a query row (HD/32 at hd 64 and 128, 8 at hd 192, where 6
// would not divide a warp, and 256), each owning HD/TPR of its dims (interleaved
// float4 groups) in registers, and a dot product is their partial sums
// joined by shuffles. The block walks only the key tiles (32 keys, 16 at
// hd 192 and 256, so that two f32 tiles stay inside 48 KB of static shared memory)
// that meet the band of its query tile, staging K and V in shared memory.
// dkdv: one block per (key tile, KV head), the key rows and their dk/dv
// sums in registers. It walks the G query heads and, for each, the query
// tiles (32 rows, 16 at hd 192 and 256) that can see its keys, so the sum over the group stays a
// register sum: no atomics and no second pass. Query rows past S are
// masked explicitly (the TPU wrapper pads S and relies on zero-padded
// do/delta), as are key rows past S. These f32 products run on the CUDA
// cores. Head dims as in the forward: instances at HD = 64, 128, 192 and
// 256, rows of any hd <= HD on the smallest that holds them, columns past
// hd zero in registers and shared memory and not stored.

#include "swa_flash_bwd_wgmma.cuh"

namespace {

constexpr int NTHREADS = 128;
constexpr int LCH = 8;    // loads in flight per thread while staging a tile

// the f32 bodies' geometry at head dim HD: threads a row, the float4 groups
// each of them owns, rows (dq) or keys (dkdv) a block, and keys (dq) or
// query rows (dkdv) a shared-memory tile
template <int HD>
struct Simt {
  static_assert(HD == 64 || HD == 128 || HD == 192 || HD == 256,
                "head dim instances 64, 128, 192, 256");
  static constexpr int TPR = HD >= 192 ? 8 : HD / 32;
  static constexpr int NGR = HD / TPR / 4;
  static constexpr int ROWS = NTHREADS / TPR;
  static constexpr int TILE = HD >= 192 ? 16 : 32;
};

__device__ __forceinline__ bool visible(int qp, int kp, int S, int window) {
  return qp < S && kp < S && kp <= qp && (window <= 0 || kp > qp - window);
}

// Sum of a partial dot product over the TPR threads that share a row
// (consecutive lanes, aligned groups of TPR).
template <int TPR>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 1; o < TPR; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Stage rows [r0, r0 + ROWS) of a (S, hd) matrix into dst as f32 (rows past
// S and columns past hd read 0), optionally scaled; LCH loads in flight
// per thread.
template <typename T, int HD, int ROWS>
__device__ __forceinline__ void stage(float (*dst)[HD], const T* src, int r0, int S, int hd,
                                      float mul) {
  constexpr int LOADS = ROWS * HD / NTHREADS;
  static_assert(LOADS % LCH == 0, "tile loads must batch evenly");
  const int tid = threadIdx.x;
#pragma unroll
  for (int c0 = 0; c0 < LOADS; c0 += LCH) {
    float val[LCH];
#pragma unroll
    for (int u = 0; u < LCH; ++u) {
      const int e = tid + (c0 + u) * NTHREADS;
      const int r = r0 + e / HD;
      const int col = e % HD;
      val[u] = r < S && col < hd ? to_f32(src[(size_t)r * hd + col]) * mul : 0.f;
    }
#pragma unroll
    for (int u = 0; u < LCH; ++u) {
      const int e = tid + (c0 + u) * NTHREADS;
      dst[e / HD][e % HD] = val[u];
    }
  }
}

// Load this thread's 4 NGR dims of one row (dims (i*TPR + h)*4 + c; 0 past hd).
template <typename T, int TPR, int NGR>
__device__ __forceinline__ void load_row(float (&r)[4 * NGR], const T* src, int h, int hd,
                                         float mul) {
#pragma unroll
  for (int i = 0; i < NGR; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = (i * TPR + h) * 4 + c;
      r[4 * i + c] = col < hd ? to_f32(src[col]) * mul : 0.f;
    }
}

template <int TPR, int NGR>
__device__ __forceinline__ float dot_part(const float (&r)[4 * NGR], const float* row, int h) {
  const float4* p = reinterpret_cast<const float4*>(row);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < NGR; ++i) {
    const float4 x = p[i * TPR + h];
    s += r[4 * i] * x.x + r[4 * i + 1] * x.y + r[4 * i + 2] * x.z + r[4 * i + 3] * x.w;
  }
  return s;
}

template <int TPR, int NGR>
__device__ __forceinline__ void axpy(float (&acc)[4 * NGR], float a, const float* row, int h) {
  const float4* p = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int i = 0; i < NGR; ++i) {
    const float4 x = p[i * TPR + h];
    acc[4 * i] += a * x.x;
    acc[4 * i + 1] += a * x.y;
    acc[4 * i + 2] += a * x.z;
    acc[4 * i + 3] += a * x.w;
  }
}

// PAD: hd < HD (rows on a wider instance); rows that fill the instance take
// its constant width, which spares the registers a runtime width costs
template <typename T, int HD, bool PAD>
__global__ void __launch_bounds__(NTHREADS)
swa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  const T* __restrict__ dout, float* __restrict__ dq, int G, int S, int width,
                  int window, float scale) {
  const int hd = PAD ? width : HD;   // the rows' width
  constexpr int TPR = Simt<HD>::TPR;
  constexpr int NGR = Simt<HD>::NGR;
  constexpr int DPT = 4 * NGR;   // dims a thread
  constexpr int BQ = Simt<HD>::ROWS;
  constexpr int BKT = Simt<HD>::TILE;
  __shared__ __align__(16) float ks[BKT][HD];
  __shared__ __align__(16) float vs[BKT][HD];

  const int tid = threadIdx.x;
  const int row = tid / TPR;
  const int h = tid % TPR;
  const int q0 = blockIdx.x * BQ;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int qpos = q0 + row;
  const size_t rows = (size_t)(b * G + g) * S;

  float qr[DPT], dor[DPT], acc[DPT];
  float l = 0.f, dl = 0.f;
  if (qpos < S) {
    load_row<T, TPR, NGR>(qr, q + (rows + qpos) * hd, h, hd, scale);
    load_row<T, TPR, NGR>(dor, dout + (rows + qpos) * hd, h, hd, 1.f);
    l = lse[rows + qpos];
    dl = delta[rows + qpos];
  } else {
#pragma unroll
    for (int c = 0; c < DPT; ++c) qr[c] = dor[c] = 0.f;
  }
#pragma unroll
  for (int c = 0; c < DPT; ++c) acc[c] = 0.f;

  const int q_hi = min(q0 + BQ - 1, S - 1);
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const T* kb = k + (size_t)b * S * hd;
  const T* vb = v + (size_t)b * S * hd;
  for (int kt = (k_lo / BKT) * BKT; kt <= q_hi; kt += BKT) {
    __syncthreads();
    stage<T, HD, BKT>(ks, kb, kt, S, hd, 1.f);
    stage<T, HD, BKT>(vs, vb, kt, S, hd, 1.f);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < BKT; ++j) {
      const float s = row_sum<TPR>(dot_part<TPR, NGR>(qr, &ks[j][0], h));
      const float dp = row_sum<TPR>(dot_part<TPR, NGR>(dor, &vs[j][0], h));
      const float p = visible(qpos, kt + j, S, window) ? expf(s - l) : 0.f;
      axpy<TPR, NGR>(acc, p * (dp - dl), &ks[j][0], h);
    }
  }

  if (qpos < S) {
    float* o = dq + (rows + qpos) * hd;
#pragma unroll
    for (int i = 0; i < NGR; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if ((i * TPR + h) * 4 + c < hd) o[(i * TPR + h) * 4 + c] = acc[4 * i + c] * scale;
  }
}

template <typename T, int HD, bool PAD>
__global__ void __launch_bounds__(NTHREADS)
swa_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ lse,
                    const float* __restrict__ delta, const T* __restrict__ dout,
                    float* __restrict__ dk, float* __restrict__ dv, int G, int S, int width,
                    int window, float scale) {
  const int hd = PAD ? width : HD;   // the rows' width
  constexpr int TPR = Simt<HD>::TPR;
  constexpr int NGR = Simt<HD>::NGR;
  constexpr int DPT = 4 * NGR;   // dims a thread
  constexpr int BKEY = Simt<HD>::ROWS;
  constexpr int BQT = Simt<HD>::TILE;
  __shared__ __align__(16) float qs[BQT][HD];
  __shared__ __align__(16) float dos[BQT][HD];
  __shared__ float ls[BQT];
  __shared__ float dls[BQT];

  const int tid = threadIdx.x;
  const int row = tid / TPR;
  const int h = tid % TPR;
  const int k0 = blockIdx.x * BKEY;
  const int b = blockIdx.y;
  const int kpos = k0 + row;
  const size_t krow = (size_t)b * S + kpos;

  float kr[DPT], vr[DPT], dka[DPT], dva[DPT];
  if (kpos < S) {
    load_row<T, TPR, NGR>(kr, k + krow * hd, h, hd, 1.f);
    load_row<T, TPR, NGR>(vr, v + krow * hd, h, hd, 1.f);
  } else {
#pragma unroll
    for (int c = 0; c < DPT; ++c) kr[c] = vr[c] = 0.f;
  }
#pragma unroll
  for (int c = 0; c < DPT; ++c) dka[c] = dva[c] = 0.f;

  // queries that can see a key of [k0, k_hi]: k0 <= i < k_hi + window
  const int k_hi = min(k0 + BKEY - 1, S - 1);
  const int q_end = window > 0 ? min(S, k_hi + window) : S;
  for (int g = 0; g < G; ++g) {
    const size_t base = (size_t)(b * G + g) * S;
    for (int qt = (k0 / BQT) * BQT; qt < q_end; qt += BQT) {
      __syncthreads();
      stage<T, HD, BQT>(qs, q + base * hd, qt, S, hd, scale);
      stage<T, HD, BQT>(dos, dout + base * hd, qt, S, hd, 1.f);
      if (tid < BQT) {
        const int r = qt + tid;
        ls[tid] = r < S ? lse[base + r] : 0.f;
        dls[tid] = r < S ? delta[base + r] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int i = 0; i < BQT; ++i) {
        const float s = row_sum<TPR>(dot_part<TPR, NGR>(kr, &qs[i][0], h));
        const float dp = row_sum<TPR>(dot_part<TPR, NGR>(vr, &dos[i][0], h));
        const float p = visible(qt + i, kpos, S, window) ? expf(s - ls[i]) : 0.f;
        axpy<TPR, NGR>(dva, p, &dos[i][0], h);
        axpy<TPR, NGR>(dka, p * (dp - dls[i]), &qs[i][0], h);
      }
    }
  }

  if (kpos < S) {
    float* ok = dk + krow * hd;
    float* ov = dv + krow * hd;
#pragma unroll
    for (int i = 0; i < NGR; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = (i * TPR + h) * 4 + c;
        if (col >= hd) continue;
        ok[col] = dka[4 * i + c];
        ov[col] = dva[4 * i + c];
      }
  }
}

// the f32 bodies' geometry: query rows (dq) or keys (dkdv) per block, and
// keys (dq) or query rows (dkdv) per shared-memory tile
// (kernels/swa_attention.py dq_geometry, dkdv_geometry)
template <int HD>
inline bool simt_geometry(int rows, int tile) {
  return rows == Simt<HD>::ROWS && tile == Simt<HD>::TILE;
}

template <int HD>
int launch_dq(const void* q, const void* k, const void* v, const void* lse, const void* delta,
              const void* dout, void* dq, int bkv, int G, int S, int hd, int window,
              float scale, int bq, int bk, cudaStream_t st) {
  if (!simt_geometry<HD>(bq, bk)) return (int)cudaErrorInvalidValue;
  constexpr int BQ = Simt<HD>::ROWS;
  const dim3 grid((S + BQ - 1) / BQ, G, bkv);
  auto kernel = hd < HD ? swa_bwd_dq_kernel<float, HD, true> : swa_bwd_dq_kernel<float, HD, false>;
  kernel<<<grid, NTHREADS, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const float*>(dout), static_cast<float*>(dq), G, S, hd, window, scale);
  return 0;
}

template <int HD>
int launch_dkdv(const void* q, const void* k, const void* v, const void* lse,
                const void* delta, const void* dout, void* dk, void* dv, int bkv, int G, int S,
                int hd, int window, float scale, int bkey, int bqs, cudaStream_t st) {
  if (!simt_geometry<HD>(bkey, bqs)) return (int)cudaErrorInvalidValue;
  constexpr int BKEY = Simt<HD>::ROWS;
  const dim3 grid((S + BKEY - 1) / BKEY, bkv);
  auto kernel =
      hd < HD ? swa_bwd_dkdv_kernel<float, HD, true> : swa_bwd_dkdv_kernel<float, HD, false>;
  kernel<<<grid, NTHREADS, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const float*>(dout), static_cast<float*>(dk), static_cast<float*>(dv), G, S,
      hd, window, scale);
  return 0;
}

}  // namespace

// (bq, bk, blocks): the caller's geometry (kernels/swa_attention.py
// dq_geometry), refused unless it is the dtype's kernel's
extern "C" int swa_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* lse, const void* delta, const void* dout,
                                void* dq, int bkv, int G, int S, int hd, int window, int bq,
                                int bk, int blocks, int dtype, float scale, void* stream) {
  if (bkv < 1 || G < 1 || S < 1 || window < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(delta);
  int rc = 0;
  float* dqf = static_cast<float*>(dq);
  switch (dtype) {
    case DT_F32:
      rc = by_instance(hd, [&](auto inst) {
        return launch_dq<decltype(inst)::value>(q, k, v, lse, delta, dout, dq, bkv, G, S, hd,
                                                window, scale, bq, bk, st);
      });
      break;
    case DT_BF16:
      rc = by_instance(hd, [&](auto inst) {
        return swa_tc::launch_bwd_dq<decltype(inst)::value>(q, k, v, dout, l, d, dqf, bkv * G, bkv,
                                                            S, hd, window, scale, bq, bk, blocks,
                                                            st);
      });
      break;
    default:
      rc = (int)cudaErrorInvalidValue;
  }
  if (rc) return rc;
  return (int)cudaGetLastError();
}

// (bkey, bqs, blocks): the caller's geometry (kernels/swa_attention.py
// dkdv_geometry), refused unless it is the dtype's kernel's
extern "C" int swa_flash_bwd_dkdv(const void* q, const void* k, const void* v,
                                  const void* lse, const void* delta, const void* dout,
                                  void* dk, void* dv, int bkv, int G, int S, int hd,
                                  int window, int bkey, int bqs, int blocks, int dtype,
                                  float scale, void* stream) {
  if (bkv < 1 || G < 1 || S < 1 || window < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(delta);
  float* dkf = static_cast<float*>(dk);
  float* dvf = static_cast<float*>(dv);
  int rc = 0;
  switch (dtype) {
    case DT_F32:
      rc = by_instance(hd, [&](auto inst) {
        return launch_dkdv<decltype(inst)::value>(q, k, v, lse, delta, dout, dk, dv, bkv, G, S,
                                                  hd, window, scale, bkey, bqs, st);
      });
      break;
    case DT_BF16:
      rc = by_instance(hd, [&](auto inst) {
        return swa_tc::launch_bwd_dkdv<decltype(inst)::value>(q, k, v, dout, l, d, dkf, dvf,
                                                              bkv * G, bkv, S, hd, window, scale,
                                                              bkey, bqs, blocks, st);
      });
      break;
    default:
      rc = (int)cudaErrorInvalidValue;
  }
  if (rc) return rc;
  return (int)cudaGetLastError();
}
