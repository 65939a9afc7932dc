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
// visible iff s <= pos. In both, no slot at or past min(C, pos + 1) is
// visible (a ring slot s > pos < C holds no position yet), and no slot
// that is not visible is read.
//
// Bound: bytes, those of the visible k/v rows (+ their scales) and of q
// and out, against the card's memory rate. One block per (lane, KV head)
// would be 64 blocks on 132 SMs at the main path, each walking its cache
// alone; so the launch is split-K, a grid of (N, S) blocks of 256 threads,
// split s taking slots [s * per, (s + 1) * per): S and per (a whole number
// of tiles) come from the host, kernels/swa_attention.py decode_splits,
// from N, C and the SM count, never from pos. A block loads its G query
// rows beside pos, scales them into shared memory and walks its split in
// tiles of T = 4096 / HD slots: it copies a K and a V tile with 16-byte
// cp.async in the stored dtype (a slot not visible is zero-filled, not
// read); bf16 and fp8 tiles (and scaled ones) are dequantized in shared
// memory, cast then one multiply by the row scale, so no f32 copy of the
// cache exists in device memory. Then the G x T scores (float4 dots), a
// per-head online softmax in f32 (one warp a head) and the acc update,
// each thread owning G*HD/256 accumulator entries. Two blocks an SM at
// most (__launch_bounds__(256, 2) leaves ptxas room to spill nothing).
//
// The splits at or past min(C, pos + 1) hold nothing visible: they return
// at once, write nothing and do not arrive (every split before them has a
// visible slot). If one split is live it writes out itself. Else each
// live split writes its partial (acc, m, d) to f32 scratch, and the last
// to arrive (an arrival counter after a fence; it clears the counter, so
// the caller's counters stay zero) merges the partials in split order,
// not arrival order, online: m' = max(m, m_s), d' = d e^(m - m') +
// d_s e^(m_s - m'), acc likewise, out = acc / d; a partial with d = 0
// (m = -1e30, nothing visible) takes no weight. Each thread folds its
// entries with eight splits' loads in flight, so the merge costs one
// round trip to L2 per eight splits; the counter's line is prefetched
// into L2 at the start. Twin launches are bit-identical.

#include "common.cuh"

namespace {

constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr int MAX_G = 16;
constexpr int MAX_SPLITS = 64;   // kernels/swa_attention.py DECODE_MAX_SPLITS

template <int HD>
struct Tile {
  static constexpr int T = 4096 / HD;    // slots per tile (21 at hd 192: the
                                         // walk takes any count)
  static constexpr int LD = HD + 4;      // f32 row in shared memory: 16-byte rows,
                                         // float4 reads of 8 rows hit 32 banks
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool read) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(read ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

template <typename T>
__device__ __forceinline__ void to_f32x4(const T* src, float* dst, float s) {
#pragma unroll
  for (int i = 0; i < 4; ++i) dst[i] = to_f32(src[i]) * s;
}

template <typename TQ, typename TK, int HD>
__global__ void __launch_bounds__(NTHREADS, 2)
swa_flash_decode_kernel(const TQ* __restrict__ q, const TK* __restrict__ k,
                        const TK* __restrict__ v, const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale, const int* __restrict__ pos,
                        float* __restrict__ out, float* __restrict__ part,
                        int* __restrict__ arrived, int G, int C, int window, int per,
                        float scale, int kvh, long long s_b, long long s_h, long long s_c,
                        long long sc_b, long long sc_h, long long sc_c, int vec) {
  constexpr int T = Tile<HD>::T;
  constexpr int LD = Tile<HD>::LD;
  constexpr int MAXE = MAX_G * HD / NTHREADS;
  constexpr bool RAW = sizeof(TK) < 4;            // staged in the stored dtype first
  constexpr int CPR = HD * (int)sizeof(TK) / 16;  // 16-byte chunks of a row
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                // G * HD
  float* ks = qs + G * HD;         // T * LD
  float* vs = ks + T * LD;         // T * LD
  TK* kraw = reinterpret_cast<TK*>(vs + T * LD);  // T * HD stored elements (RAW)
  TK* vraw = kraw + (RAW ? T * HD : 0);
  float* ss = reinterpret_cast<float*>(vraw + (RAW ? T * HD : 0));  // G * T
  float* ksc = ss + G * T;         // T row scales
  float* vsc = ksc + T;            // T
  float* ms = vsc + T;             // G running max
  float* ds = ms + G;              // G running denominator
  float* cs = ds + G;              // G correction of this tile
  __shared__ int last;

  const int n = blockIdx.x;
  const int split = blockIdx.y;
  const int S = gridDim.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int GH = G * HD;
  // the query rows load beside pos, not after it
  TQ qv[MAXE];
#pragma unroll
  for (int i = 0; i < MAXE; ++i) {
    const int e = tid + i * NTHREADS;
    if (e < GH) qv[i] = q[(size_t)n * GH + e];
  }
  const int p = pos[n];
  const int PS = GH + 2 * G;       // floats of one partial
  float* mine = part + ((size_t)n * S + split) * PS;

  const int v_end = min(C, p + 1);
  // splits past v_end hold no visible slot: they write nothing and do not
  // arrive; the merge reads the first `live` splits
  const int live = max(1, (v_end + per - 1) / per);
  if (split >= live) return;
  // the arrival counter's line into L2 now, not on the critical path later
  if (tid == 0 && live > 1) asm volatile("prefetch.global.L2 [%0];\n" ::"l"(arrived + n));
  const int c0 = split * per;
  const int c1 = min(c0 + per, v_end);
  const int r = window > 0 ? p % window : 0;
  const int base = p - r;
  auto visible = [&](int slot) {
    if (window > 0) {
      const int pp = slot <= r ? base + slot : base - window + slot;
      return slot < C && pp >= 0 && pp <= p && pp > p - window;
    }
    return slot < v_end;
  };

  float acc[MAXE];
#pragma unroll
  for (int i = 0; i < MAXE; ++i) {
    const int e = tid + i * NTHREADS;
    if (e < GH) qs[e] = to_f32(qv[i]) * scale;
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += NTHREADS) {
    ms[g] = REPRO_NEG_INF;
    ds[g] = 0.f;
  }
  const long long row0 = (long long)(n / kvh) * s_b + (long long)(n % kvh) * s_h;
  const long long srow0 = (long long)(n / kvh) * sc_b + (long long)(n % kvh) * sc_h;
  const TK* kb = k + row0;
  const TK* vb = v + row0;
  const float* ksb = k_scale ? k_scale + srow0 : nullptr;
  const float* vsb = v_scale ? v_scale + srow0 : nullptr;
  const bool scaled = ksb != nullptr;

  for (int t0 = c0; t0 < c1; t0 += T) {
    __syncthreads();                 // the previous tile's reads are done
    if (vec) {
      TK* kd = RAW ? kraw : reinterpret_cast<TK*>(ks);
      TK* vd = RAW ? vraw : reinterpret_cast<TK*>(vs);
      constexpr int ROW = RAW ? HD : LD;           // destination row, elements of TK
      for (int c = tid; c < T * CPR; c += NTHREADS) {
        const int j = c / CPR, cc = c % CPR;
        const int slot = t0 + j;
        const bool read = slot < c1 && visible(slot);
        const long long off = (long long)(read ? slot : t0) * s_c + cc * (16 / (int)sizeof(TK));
        cp_async16(kd + j * ROW + cc * (16 / (int)sizeof(TK)), kb + off, read);
        cp_async16(vd + j * ROW + cc * (16 / (int)sizeof(TK)), vb + off, read);
      }
    }
    // the tile's row scales while the copies fly
    for (int j = tid; j < T; j += NTHREADS) {
      const int slot = t0 + j;
      const bool read = slot < c1 && visible(slot);
      ksc[j] = read && scaled ? ksb[slot * sc_c] : 1.f;
      vsc[j] = read && scaled ? vsb[slot * sc_c] : 1.f;
    }
    if (vec) cp_async_wait_all();
    __syncthreads();
    if (!vec) {
      // rows off 16-byte boundaries: one element at a time
      for (int e = tid; e < T * HD; e += NTHREADS) {
        const int j = e / HD, d = e % HD;
        const int slot = t0 + j;
        const bool read = slot < c1 && visible(slot);
        ks[j * LD + d] = read ? to_f32(kb[slot * s_c + d]) * ksc[j] : 0.f;
        vs[j * LD + d] = read ? to_f32(vb[slot * s_c + d]) * vsc[j] : 0.f;
      }
      __syncthreads();
    } else if (RAW || scaled) {
      // dequantize in shared memory: cast, then one multiply by the row scale
      for (int e4 = tid; e4 < T * HD / 4; e4 += NTHREADS) {
        const int j = (4 * e4) / HD, d = (4 * e4) % HD;
        float kf[4], vf[4];
        if (RAW) {
          to_f32x4(kraw + j * HD + d, kf, ksc[j]);
          to_f32x4(vraw + j * HD + d, vf, vsc[j]);
        } else {
          to_f32x4(reinterpret_cast<const float*>(ks + j * LD + d), kf, ksc[j]);
          to_f32x4(reinterpret_cast<const float*>(vs + j * LD + d), vf, vsc[j]);
        }
        *reinterpret_cast<float4*>(ks + j * LD + d) = make_float4(kf[0], kf[1], kf[2], kf[3]);
        *reinterpret_cast<float4*>(vs + j * LD + d) = make_float4(vf[0], vf[1], vf[2], vf[3]);
      }
      __syncthreads();
    }

    for (int e = tid; e < G * T; e += NTHREADS) {
      const int g = e / T;
      const int j = e % T;
      const int slot = t0 + j;
      float sc = REPRO_NEG_INF;
      if (slot < c1 && visible(slot)) {
        const float4* qg = reinterpret_cast<const float4*>(qs + g * HD);
        const float4* kr = reinterpret_cast<const float4*>(ks + j * LD);
        float dot = 0.f;
#pragma unroll 4
        for (int d4 = 0; d4 < HD / 4; ++d4) {
          const float4 a = qg[d4], b = kr[d4];
          dot += a.x * b.x;
          dot += a.y * b.y;
          dot += a.z * b.z;
          dot += a.w * b.w;
        }
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

  if (live == 1) {
    // one split: the merge below would scale by exp(0) = 1 and add nothing
#pragma unroll
    for (int i = 0; i < MAXE; ++i) {
      const int e = tid + i * NTHREADS;
      if (e < GH) out[(size_t)n * GH + e] = acc[i] / fmaxf(ds[e / HD], 1e-30f);
    }
    return;
  }

  // this split's partial: acc, then m and d per head (m = -1e30, d = 0
  // where the split saw nothing visible)
#pragma unroll
  for (int i = 0; i < MAXE; ++i) {
    const int e = tid + i * NTHREADS;
    if (e < GH) mine[e] = acc[i];
  }
  for (int g = tid; g < G; g += NTHREADS) {
    mine[GH + g] = ms[g];
    mine[GH + G + g] = ds[g];
  }
  __threadfence();                   // each writer: its partial before the arrival
  __syncthreads();
  if (tid == 0) {
    const int done = atomicAdd(arrived + n, 1) + 1;
    last = done == live;
    if (last) arrived[n] = 0;        // every live split of n has arrived
  }
  __syncthreads();
  if (!last) return;
  __threadfence();                   // each reader: the arrivals before the partials

  // merge, in split order, online: each thread folds the partials of its
  // entries' head, eight splits' loads in flight at a time
  const float* all = part + (size_t)n * S * PS;
  for (int e = tid; e < GH; e += NTHREADS) {
    const int g = e / HD;
    float m = REPRO_NEG_INF, d = 0.f, o = 0.f;
    for (int s0 = 0; s0 < live; s0 += 8) {
      float mv[8], dv[8], av[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const float* ps = all + (size_t)min(s0 + u, live - 1) * PS;
        mv[u] = __ldcg(ps + GH + g);
        dv[u] = __ldcg(ps + GH + G + g);
        av[u] = __ldcg(ps + e);
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (s0 + u < live && dv[u] != 0.f) {
          const float m_new = fmaxf(m, mv[u]);
          const float a = expf(m - m_new), b = expf(mv[u] - m_new);
          d = d * a + dv[u] * b;
          o = o * a + av[u] * b;
          m = m_new;
        }
      }
    }
    out[(size_t)n * GH + e] = o / fmaxf(d, 1e-30f);
  }
}

struct Strides {
  int kvh;
  long long s_b, s_h, s_c, sc_b, sc_h, sc_c;
};

template <typename TK, int HD>
size_t smem_bytes(int G) {
  constexpr int T = Tile<HD>::T;
  const size_t raw = sizeof(TK) < 4 ? 2 * (size_t)T * HD * sizeof(TK) : 0;
  return sizeof(float) * (size_t)(G * HD + 2 * T * Tile<HD>::LD + G * T + 2 * T + 3 * G) + raw;
}

struct Launch {
  const void *q, *k, *v;
  const float *ks, *vs;
  const int* pos;
  float *out, *part;
  int* arrived;
  int N, G, C, window, splits, per;
  float scale;
  Strides st;
  cudaStream_t stream;
};

template <typename TQ, typename TK, int HD>
int launch(const Launch& a) {
  auto kernel = swa_flash_decode_kernel<TQ, TK, HD>;
  const size_t smem = smem_bytes<TK, HD>(a.G);
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const size_t es = sizeof(TK);
  const auto a16 = [](long long x) { return x % 16 == 0; };
  const int vec = a16(reinterpret_cast<uintptr_t>(a.k)) && a16(reinterpret_cast<uintptr_t>(a.v)) &&
                  a16(a.st.s_b * (long long)es) && a16(a.st.s_h * (long long)es) &&
                  a16(a.st.s_c * (long long)es);
  kernel<<<dim3(a.N, a.splits), NTHREADS, smem, a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TK*>(a.k), static_cast<const TK*>(a.v),
      a.ks, a.vs, a.pos, a.out, a.part, a.arrived, a.G, a.C, a.window, a.per, a.scale,
      a.st.kvh, a.st.s_b, a.st.s_h, a.st.s_c, a.st.sc_b, a.st.sc_h, a.st.sc_c, vec);
  return 0;
}

template <typename TQ, typename TK>
int launch_hd(const Launch& a, int hd) {
  if (hd == 64) return launch<TQ, TK, 64>(a);
  if (hd == 128) return launch<TQ, TK, 128>(a);
  if (hd == 192) return launch<TQ, TK, 192>(a);
  return (int)cudaErrorInvalidValue;
}

template <typename TQ>
int launch_kv(const Launch& a, int hd, int kv_dtype) {
  switch (kv_dtype) {
    case DT_F32:
      return launch_hd<TQ, float>(a, hd);
    case DT_BF16:
      return launch_hd<TQ, __nv_bfloat16>(a, hd);
    case DT_E4M3:
      return launch_hd<TQ, __nv_fp8_e4m3>(a, hd);
    case DT_E5M2:
      return launch_hd<TQ, __nv_fp8_e5m2>(a, hd);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// part: (N, splits, G*HD + 2G) f32 scratch; arrived: (N,) i32, zero at
// entry and left zero. splits and per are kernels/swa_attention.py
// decode_splits(N, C, hd, SMs); any other split of C is refused.
extern "C" int swa_flash_decode(const void* q, const void* k, const void* v,
                                const void* k_scale, const void* v_scale, const void* pos,
                                void* out, void* part, void* arrived, int N, int G, int C,
                                int hd, int window, int q_dtype, int kv_dtype, int splits,
                                int per, float scale, int kvh, long long s_b, long long s_h,
                                long long s_c, long long sc_b, long long sc_h, long long sc_c,
                                void* stream) {
  if (G < 1 || G > MAX_G || kvh < 1 || N < 1 || C < 1) return (int)cudaErrorInvalidValue;
  if (hd != 64 && hd != 128 && hd != 192) return (int)cudaErrorInvalidValue;
  const int T = 4096 / hd;
  if (splits < 1 || splits > MAX_SPLITS || per < T || per % T ||
      (long long)(splits - 1) * per >= C || (long long)splits * per < C)
    return (int)cudaErrorInvalidValue;
  Launch a{q, k, v, static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
           static_cast<const int*>(pos), static_cast<float*>(out), static_cast<float*>(part),
           static_cast<int*>(arrived), N, G, C, window, splits, per, scale,
           Strides{kvh, s_b, s_h, s_c, sc_b, sc_h, sc_c}, static_cast<cudaStream_t>(stream)};
  int rc;
  switch (q_dtype) {
    case DT_F32:
      rc = launch_kv<float>(a, hd, kv_dtype);
      break;
    case DT_BF16:
      rc = launch_kv<__nv_bfloat16>(a, hd, kv_dtype);
      break;
    default:
      rc = (int)cudaErrorInvalidValue;
  }
  if (rc) return rc;
  return (int)cudaGetLastError();
}
