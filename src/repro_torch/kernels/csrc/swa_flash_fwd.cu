// Prefill attention forward: GQA causal(-window) flash attention with the
// logsumexp residual.
//
// Replaces the TPU kernel repro/kernels/swa_attention.py::swa_flash_fwd
// (_swa_fwd_res_kernel) and its wrapper repro/kernels/ops.py
// swa_attention_fwd_res.
//
//   q   (BKV, G, S, HD)  bf16 | f32, query head h = c*G + r under KV head c
//   k,v (BKV, S, HD)     same dtype, KV unexpanded
//   out (BKV, G, S, HD)  q's dtype
//   lse (BKV, G, S)      f32, lse = m + log(d)
//
// One block of 128 threads per (64-row query tile, group head, KV head).
// Two threads share a query row, each owning half of the head dim in
// registers (interleaved float4 groups, so the pair reads K/V rows from
// shared memory without bank conflicts); a score is their two partial dot
// products joined by one shuffle. The block walks only the 32-key tiles
// that intersect the causal/window band of its query tile, staging each
// K/V tile in shared memory as f32, with the online softmax (m, d, acc) in
// f32 registers. The ragged edge (k_pos < S, q_pos < S) is masked here, so
// the wrapper pads nothing.
//
// Bound: 4*HD*G*BKV*sum_q|visible keys| operations. At the prefill shapes
// of the serving path that is far above the H100's bytes/operation ratio,
// so the ideal kernel is bound by operations; this one runs its products
// on the f32 CUDA cores (no tensor cores yet), which is what limits it.
// Moving the two products to wgmma is later work.

#include "common.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BK = 32;
constexpr int NTHREADS = 128;

template <typename T, int HD>
__global__ void __launch_bounds__(NTHREADS)
swa_flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse, int G, int S, int window,
                     float scale) {
  constexpr int HALF = HD / 2;
  constexpr int NG = HD / 8;  // float4 groups each thread owns
  constexpr int LOADS = BK * HD / NTHREADS;  // elements of a tile per thread
  constexpr int LCH = 8;                     // loads in flight per thread
  __shared__ __align__(16) float ks[BK][HD];
  __shared__ __align__(16) float vs[BK][HD];

  const int tid = threadIdx.x;
  const int row = tid >> 1;
  const int h = tid & 1;
  const int q0 = blockIdx.x * BQ;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int qpos = q0 + row;
  const size_t rows = (size_t)(b * G + g) * S;

  float qr[HALF];
  float acc[HALF];
  if (qpos < S) {
    const T* qp = q + (rows + qpos) * HD;
#pragma unroll
    for (int i = 0; i < NG; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) qr[4 * i + c] = to_f32(qp[8 * i + 4 * h + c]) * scale;
  } else {
#pragma unroll
    for (int c = 0; c < HALF; ++c) qr[c] = 0.f;
  }
#pragma unroll
  for (int c = 0; c < HALF; ++c) acc[c] = 0.f;
  float m = REPRO_NEG_INF;
  float d = 0.f;

  const int q_hi = min(q0 + BQ - 1, S - 1);
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const T* kb = k + (size_t)b * S * HD;
  const T* vb = v + (size_t)b * S * HD;

  for (int kt = (k_lo / BK) * BK; kt <= q_hi; kt += BK) {
    __syncthreads();
    // LCH loads of k and of v in flight per thread before any is stored
#pragma unroll
    for (int c0 = 0; c0 < LOADS; c0 += LCH) {
      float kv[LCH], vv[LCH];
#pragma unroll
      for (int u = 0; u < LCH; ++u) {
        const int e = tid + (c0 + u) * NTHREADS;
        const int kp = kt + e / HD;
        kv[u] = 0.f;
        vv[u] = 0.f;
        if (kp < S) {
          kv[u] = to_f32(kb[(size_t)kp * HD + e % HD]);
          vv[u] = to_f32(vb[(size_t)kp * HD + e % HD]);
        }
      }
#pragma unroll
      for (int u = 0; u < LCH; ++u) {
        const int e = tid + (c0 + u) * NTHREADS;
        ks[e / HD][e % HD] = kv[u];
        vs[e / HD][e % HD] = vv[u];
      }
    }
    __syncthreads();

    float s[BK];
    float tmax = REPRO_NEG_INF;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(&ks[j][0]);
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < NG; ++i) {
        const float4 kk = kr[2 * i + h];
        part += qr[4 * i] * kk.x + qr[4 * i + 1] * kk.y + qr[4 * i + 2] * kk.z +
                qr[4 * i + 3] * kk.w;
      }
      const float sc = part + __shfl_xor_sync(0xffffffffu, part, 1);
      const int kp = kt + j;
      const bool vis = kp <= qpos && kp < S && (window <= 0 || kp > qpos - window);
      s[j] = vis ? sc : REPRO_NEG_INF;
      tmax = fmaxf(tmax, s[j]);
    }
    const float m_new = fmaxf(m, tmax);
    const float corr = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = s[j] > REPRO_MASKED ? expf(s[j] - m_new) : 0.f;
      s[j] = p;
      psum += p;
    }
    d = d * corr + psum;
#pragma unroll
    for (int c = 0; c < HALF; ++c) acc[c] *= corr;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = s[j];
      const float4* vr = reinterpret_cast<const float4*>(&vs[j][0]);
#pragma unroll
      for (int i = 0; i < NG; ++i) {
        const float4 vv = vr[2 * i + h];
        acc[4 * i] += p * vv.x;
        acc[4 * i + 1] += p * vv.y;
        acc[4 * i + 2] += p * vv.z;
        acc[4 * i + 3] += p * vv.w;
      }
    }
    m = m_new;
  }

  if (qpos < S) {
    const float den = fmaxf(d, 1e-30f);
    const float inv = 1.f / den;
    T* op = out + (rows + qpos) * HD;
#pragma unroll
    for (int i = 0; i < NG; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) op[8 * i + 4 * h + c] = from_f32<T>(acc[4 * i + c] * inv);
    if (h == 0) lse[rows + qpos] = m + logf(den);
  }
}

template <typename T, int HD>
void launch(const void* q, const void* k, const void* v, void* out, void* lse,
            int bkv, int G, int S, int window, float scale, cudaStream_t stream) {
  const dim3 grid((S + BQ - 1) / BQ, G, bkv);
  swa_flash_fwd_kernel<T, HD><<<grid, NTHREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), static_cast<float*>(lse), G, S, window, scale);
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, void* out, void* lse,
              int bkv, int G, int S, int hd, int window, float scale,
              cudaStream_t stream) {
  if (hd == 64) {
    launch<T, 64>(q, k, v, out, lse, bkv, G, S, window, scale, stream);
  } else if (hd == 128) {
    launch<T, 128>(q, k, v, out, lse, bkv, G, S, window, scale, stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace

extern "C" int swa_flash_fwd(const void* q, const void* k, const void* v, void* out,
                             void* lse, int bkv, int G, int S, int hd, int window,
                             int dtype, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  switch (dtype) {
    case DT_F32:
      rc = launch_hd<float>(q, k, v, out, lse, bkv, G, S, hd, window, scale, st);
      break;
    case DT_BF16:
      rc = launch_hd<__nv_bfloat16>(q, k, v, out, lse, bkv, G, S, hd, window, scale, st);
      break;
    default:
      rc = (int)cudaErrorInvalidValue;
  }
  if (rc) return rc;
  return (int)cudaGetLastError();
}
