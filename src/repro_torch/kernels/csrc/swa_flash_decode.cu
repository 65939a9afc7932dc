// Single-query flash decode over the serving KV cache.
//
// Replaces the TPU kernel repro/kernels/swa_attention.py::swa_flash_decode
// (_swa_decode_kernel) and its wrapper repro/kernels/ops.py swa_decode.
//
//   q        (N, G, HD)  f32 | bf16, N = B * KV heads
//   k, v     (N, C, HD)  the cache in its STORED dtype: f32 | bf16 |
//                        fp8 e4m3 | fp8 e5m2, read through strides: row
//                        (n, slot) starts at (n / KVH) * s_b + (n % KVH) * s_h
//                        + slot * s_c elements, so the serving cache's
//                        (B, C, KV, HD) layout is read in place (no copy)
//   k_scale, v_scale (N, C) f32 per-row dequant scales, or null (scale 1),
//                        through strides sc_b, sc_h, sc_c the same way
//   pos      (N,) i32    query position (its own k/v already written)
//   out      (N, G, HD)  f32
//
// window > 0: ring of capacity C == window; slot s holds the latest
// position p <= pos with p % C == s, visible iff 0 <= p <= pos and
// p > pos - window. window == 0: dense cache, slot s holds position s,
// visible iff s <= pos, and slots past pos are never read.
//
// One block of 128 threads per n. The block sweeps the cache in tiles of
// 4096/HD slots: it stages a K and a V tile in shared memory, dequantizing
// on read (cast, then one multiply by the row scale, in registers), so no
// f32 copy of the cache ever exists in device memory; then the G x tile
// scores (masked in-kernel, no padding of C), a per-head online softmax
// (one warp per head), and the acc update, each thread owning G*HD/128
// accumulator entries. K/V rows are padded by one float in shared memory
// so a warp reading 32 different rows hits 32 banks.
//
// Bound: the bytes of the visible k/v rows (+ their scales) and of q and
// out, against the card's memory rate. At 8 lanes x 8 KV heads this is 64
// blocks on 132 SMs and each block walks its cache alone: the card is far
// from its memory rate. Splitting C across blocks (split-K) is later work.

#include "common.cuh"

namespace {

constexpr int NTHREADS = 128;
constexpr int NWARPS = NTHREADS / 32;
constexpr int MAX_G = 16;

template <typename TQ, typename TK, int HD>
__global__ void __launch_bounds__(NTHREADS)
swa_flash_decode_kernel(const TQ* __restrict__ q, const TK* __restrict__ k,
                        const TK* __restrict__ v, const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale, const int* __restrict__ pos,
                        float* __restrict__ out, int G, int C, int window, float scale,
                        int kvh, long long s_b, long long s_h, long long s_c,
                        long long sc_b, long long sc_h, long long sc_c) {
  constexpr int T = 4096 / HD;     // slots per tile
  constexpr int LD = HD + 1;       // padded shared-memory row
  constexpr int MAXE = MAX_G * HD / NTHREADS;
  constexpr int LOADS = T * HD / NTHREADS;   // elements of a tile per thread
  constexpr int LCH = 16;                    // loads in flight per thread
  extern __shared__ float smem[];
  float* qs = smem;                // G * HD
  float* ks = qs + G * HD;         // T * LD
  float* vs = ks + T * LD;         // T * LD
  float* ss = vs + T * LD;         // G * T
  float* ms = ss + G * T;          // G running max
  float* ds = ms + G;              // G running denominator
  float* cs = ds + G;              // G correction of this tile

  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int p = pos[n];
  const int GH = G * HD;

  for (int e = tid; e < GH; e += NTHREADS) qs[e] = to_f32(q[(size_t)n * GH + e]) * scale;
  for (int g = tid; g < G; g += NTHREADS) {
    ms[g] = REPRO_NEG_INF;
    ds[g] = 0.f;
  }
  float acc[MAXE];
#pragma unroll
  for (int i = 0; i < MAXE; ++i) acc[i] = 0.f;

  const int c_end = window > 0 ? C : min(C, p + 1);
  const int r = window > 0 ? p % window : 0;
  const int base = p - r;
  const long long row0 = (long long)(n / kvh) * s_b + (long long)(n % kvh) * s_h;
  const long long srow0 = (long long)(n / kvh) * sc_b + (long long)(n % kvh) * sc_h;
  const TK* kb = k + row0;
  const TK* vb = v + row0;
  const float* ksb = k_scale ? k_scale + srow0 : nullptr;
  const float* vsb = v_scale ? v_scale + srow0 : nullptr;

  for (int t0 = 0; t0 < c_end; t0 += T) {
    __syncthreads();
    // LCH loads of k, v and their scales in flight per thread, in the
    // stored dtype, before any is converted or stored: one at a time, each
    // would wait out the full memory latency
#pragma unroll
    for (int c0 = 0; c0 < LOADS; c0 += LCH) {
      TK kraw[LCH], vraw[LCH];
      float ksc[LCH], vsc[LCH];
#pragma unroll
      for (int u = 0; u < LCH; ++u) {
        const int e = tid + (c0 + u) * NTHREADS;
        const int slot = min(t0 + e / HD, c_end - 1);   // in bounds; masked below
        kraw[u] = kb[slot * s_c + e % HD];
        vraw[u] = vb[slot * s_c + e % HD];
        ksc[u] = ksb ? ksb[slot * sc_c] : 1.f;
        vsc[u] = vsb ? vsb[slot * sc_c] : 1.f;
      }
#pragma unroll
      for (int u = 0; u < LCH; ++u) {
        const int e = tid + (c0 + u) * NTHREADS;
        const bool live = t0 + e / HD < c_end;
        ks[(e / HD) * LD + e % HD] = live ? to_f32(kraw[u]) * ksc[u] : 0.f;
        vs[(e / HD) * LD + e % HD] = live ? to_f32(vraw[u]) * vsc[u] : 0.f;
      }
    }
    __syncthreads();

    for (int e = tid; e < G * T; e += NTHREADS) {
      const int g = e / T;
      const int j = e % T;
      const int slot = t0 + j;
      bool valid;
      if (window > 0) {
        const int pp = slot <= r ? base + slot : base - window + slot;
        valid = slot < C && pp >= 0 && pp <= p && pp > p - window;
      } else {
        valid = slot < c_end;
      }
      float sc = REPRO_NEG_INF;
      if (valid) {
        const float* qg = qs + g * HD;
        const float* kr = ks + j * LD;
        float dot = 0.f;
#pragma unroll 16
        for (int dd = 0; dd < HD; ++dd) dot += qg[dd] * kr[dd];
        sc = dot;
      }
      ss[e] = sc;
    }
    __syncthreads();

    for (int g = warp; g < G; g += NWARPS) {
      float* sg = ss + g * T;
      float mx = REPRO_NEG_INF;
      for (int j = lane; j < T; j += 32) mx = fmaxf(mx, sg[j]);
      mx = warp_max(mx);
      const float m_old = ms[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < T; j += 32) {
        const float sv = sg[j];
        const float pv = sv > REPRO_MASKED ? expf(sv - m_new) : 0.f;
        sg[j] = pv;
        sum += pv;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        cs[g] = corr;
        ds[g] = ds[g] * corr + sum;
        ms[g] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < MAXE; ++i) {
      const int e = tid + i * NTHREADS;
      if (e < GH) {
        const int g = e / HD;
        const int dd = e % HD;
        const float* pg = ss + g * T;
        float a = acc[i] * cs[g];
#pragma unroll 8
        for (int j = 0; j < T; ++j) a += pg[j] * vs[j * LD + dd];
        acc[i] = a;
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < MAXE; ++i) {
    const int e = tid + i * NTHREADS;
    if (e < GH) out[(size_t)n * GH + e] = acc[i] / fmaxf(ds[e / HD], 1e-30f);
  }
}

struct Strides {
  int kvh;
  long long s_b, s_h, s_c, sc_b, sc_h, sc_c;
};

template <int HD>
size_t smem_bytes(int G) {
  constexpr int T = 4096 / HD;
  return sizeof(float) * (size_t)(G * HD + 2 * T * (HD + 1) + G * T + 3 * G);
}

template <typename TQ, typename TK, int HD>
void launch(const void* q, const void* k, const void* v, const float* ks,
            const float* vs, const int* pos, float* out, int N, int G, int C,
            int window, float scale, const Strides& st, cudaStream_t stream) {
  swa_flash_decode_kernel<TQ, TK, HD><<<N, NTHREADS, smem_bytes<HD>(G), stream>>>(
      static_cast<const TQ*>(q), static_cast<const TK*>(k), static_cast<const TK*>(v),
      ks, vs, pos, out, G, C, window, scale, st.kvh, st.s_b, st.s_h, st.s_c, st.sc_b,
      st.sc_h, st.sc_c);
}

template <typename TQ, typename TK>
int launch_hd(const void* q, const void* k, const void* v, const float* ks,
              const float* vs, const int* pos, float* out, int N, int G, int C,
              int hd, int window, float scale, const Strides& st, cudaStream_t stream) {
  if (hd == 64) {
    launch<TQ, TK, 64>(q, k, v, ks, vs, pos, out, N, G, C, window, scale, st, stream);
  } else if (hd == 128) {
    launch<TQ, TK, 128>(q, k, v, ks, vs, pos, out, N, G, C, window, scale, st, stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

template <typename TQ>
int launch_kv(const void* q, const void* k, const void* v, const float* ks,
              const float* vs, const int* pos, float* out, int N, int G, int C,
              int hd, int window, int kv_dtype, float scale, const Strides& st,
              cudaStream_t stream) {
  switch (kv_dtype) {
    case DT_F32:
      return launch_hd<TQ, float>(q, k, v, ks, vs, pos, out, N, G, C, hd, window, scale, st, stream);
    case DT_BF16:
      return launch_hd<TQ, __nv_bfloat16>(q, k, v, ks, vs, pos, out, N, G, C, hd, window,
                                          scale, st, stream);
    case DT_E4M3:
      return launch_hd<TQ, __nv_fp8_e4m3>(q, k, v, ks, vs, pos, out, N, G, C, hd, window,
                                          scale, st, stream);
    case DT_E5M2:
      return launch_hd<TQ, __nv_fp8_e5m2>(q, k, v, ks, vs, pos, out, N, G, C, hd, window,
                                          scale, st, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int swa_flash_decode(const void* q, const void* k, const void* v,
                                const void* k_scale, const void* v_scale, const void* pos,
                                void* out, int N, int G, int C, int hd, int window,
                                int q_dtype, int kv_dtype, float scale, int kvh,
                                long long s_b, long long s_h, long long s_c,
                                long long sc_b, long long sc_h, long long sc_c,
                                void* stream) {
  if (G < 1 || G > MAX_G || kvh < 1) return (int)cudaErrorInvalidValue;
  const Strides strides{kvh, s_b, s_h, s_c, sc_b, sc_h, sc_c};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int* ps = static_cast<const int*>(pos);
  float* o = static_cast<float*>(out);
  int rc;
  switch (q_dtype) {
    case DT_F32:
      rc = launch_kv<float>(q, k, v, ks, vs, ps, o, N, G, C, hd, window, kv_dtype, scale, strides, st);
      break;
    case DT_BF16:
      rc = launch_kv<__nv_bfloat16>(q, k, v, ks, vs, ps, o, N, G, C, hd, window, kv_dtype,
                                    scale, strides, st);
      break;
    default:
      rc = (int)cudaErrorInvalidValue;
  }
  if (rc) return rc;
  return (int)cudaGetLastError();
}
