// The CUDA-core tile walk of the two causal(-window) attention forwards,
// their f32 body (bf16 takes the tensor cores, swa_flash_wgmma.cuh): one
// query head's online-softmax sweep over the key tiles of its band.
// swa_flash_fwd.cu (GQA layout, with the logsumexp residual) and
// swa_flash.cu ((BH, S, hd) layout, output only) each wrap it in their own
// kernel, which points it at the head's rows.
//
// One block of 128 threads per query tile (blockIdx.x) of one head: 64
// rows at hd 64 and 128, 32 at hd 192 (Geo<HD>). TPR threads share a query
// row (2, or 4 at hd 192), each owning HD / TPR of its dims in registers
// (interleaved float4 groups, so the threads of a row read K/V rows from
// shared memory without bank conflicts); a score is their partial dot
// products joined by shuffles. The block walks only the key tiles (32
// keys, 16 at hd 192, where two 32-row f32 tiles would fill the whole 48 KB
// of static shared memory) that intersect the causal/window band of its
// query tile, staging each K/V tile in shared memory as f32, with the
// online softmax (m, d, acc) in f32 registers. Key j is visible to query i iff i - window < j <= i
// (window 0: causal); the ragged edge (k_pos < S, q_pos < S) is masked
// here, so the wrappers pad nothing.
#pragma once

#include "common.cuh"

namespace swa_tile {

constexpr int NTHREADS = 128;

template <int HD>
struct Geo {
  static_assert(HD == 64 || HD == 128 || HD == 192, "head dims 64, 128, 192");
  static constexpr int TPR = HD == 192 ? 4 : 2;   // threads a query row
  static constexpr int BQ = NTHREADS / TPR;       // query rows a block
  static constexpr int BK = HD == 192 ? 16 : 32;  // keys a shared-memory tile
};

// (bq, bk) is the walk's own (kernels/swa_attention.py walk_geometry)
template <int HD>
inline bool geometry(int bq, int bk) {
  return bq == Geo<HD>::BQ && bk == Geo<HD>::BK;
}

// q, out: the head's S rows of HD; k, v: the S key/value rows it attends;
// lse: the head's S entries (written only when LSE).
template <typename T, int HD, bool LSE>
__device__ __forceinline__ void forward(const T* __restrict__ q, const T* __restrict__ k,
                                        const T* __restrict__ v, T* __restrict__ out,
                                        float* __restrict__ lse, int S, int window,
                                        float scale) {
  constexpr int TPR = Geo<HD>::TPR;
  constexpr int BQ = Geo<HD>::BQ;
  constexpr int BK = Geo<HD>::BK;
  constexpr int HALF = HD / TPR;             // dims each thread owns
  constexpr int NG = HALF / 4;               // its float4 groups: TPR i + h
  constexpr int LOADS = BK * HD / NTHREADS;  // elements of a tile per thread
  constexpr int LCH = 8;                     // loads in flight per thread
  static_assert(LOADS % LCH == 0, "tile loads must batch evenly");
  __shared__ __align__(16) float ks[BK][HD];
  __shared__ __align__(16) float vs[BK][HD];

  const int tid = threadIdx.x;
  const int row = tid / TPR;
  const int h = tid % TPR;
  const int q0 = blockIdx.x * BQ;
  const int qpos = q0 + row;

  float qr[HALF];
  float acc[HALF];
  if (qpos < S) {
    const T* qp = q + (size_t)qpos * HD;
#pragma unroll
    for (int i = 0; i < NG; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) qr[4 * i + c] = to_f32(qp[4 * (TPR * i + h) + c]) * scale;
  } else {
#pragma unroll
    for (int c = 0; c < HALF; ++c) qr[c] = 0.f;
  }
#pragma unroll
  for (int c = 0; c < HALF; ++c) acc[c] = 0.f;
  float m = REPRO_NEG_INF;
  float d = 0.f;

  // first tile: the one holding the lowest query's first visible key
  const int q_hi = min(q0 + BQ - 1, S - 1);
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;

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
          kv[u] = to_f32(k[(size_t)kp * HD + e % HD]);
          vv[u] = to_f32(v[(size_t)kp * HD + e % HD]);
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
        const float4 kk = kr[TPR * i + h];
        part += qr[4 * i] * kk.x + qr[4 * i + 1] * kk.y + qr[4 * i + 2] * kk.z +
                qr[4 * i + 3] * kk.w;
      }
      float sc = part;
#pragma unroll
      for (int o = 1; o < TPR; o <<= 1) sc += __shfl_xor_sync(0xffffffffu, sc, o);
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
        const float4 vv = vr[TPR * i + h];
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
    T* op = out + (size_t)qpos * HD;
#pragma unroll
    for (int i = 0; i < NG; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) op[4 * (TPR * i + h) + c] = from_f32<T>(acc[4 * i + c] * inv);
    if constexpr (LSE) {
      if (h == 0) lse[qpos] = m + logf(den);
    }
  }
}

}  // namespace swa_tile
