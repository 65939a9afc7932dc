// The single-query flash decode's kernel and launch, shared by
// swa_flash_decode.cu (G <= 16 query rows a KV head, rows of hd 64, 128,
// 192 or 256: GENERAL false) and swa_flash_decode_wide.cu (any G, any hd up
// to 256: GENERAL true), two libraries so that nvcc builds the two sets of
// instances in parallel; swa_flash_decode.cu says what the kernel does.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr int GC = 16;           // query rows of a chunk
constexpr int MAX_SPLITS = 64;   // kernels/swa_attention.py DECODE_MAX_SPLITS

template <int HD>
struct Tile {
  static_assert(HD == 64 || HD == 128 || HD == 192 || HD == 256,
                "head dim instances 64, 128, 192, 256");
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

// GENERAL: any G and rows of hd <= HD (swa_flash_decode_wide.cu); else G
// <= GC and rows of exactly HD (swa_flash_decode.cu), where every test
// below on G or hd is a constant and the kernel keeps the registers (and
// so the blocks an SM) of a decode that takes nothing else
template <typename TQ, typename TK, int HD, bool GENERAL>
__global__ void __launch_bounds__(NTHREADS, 2)
swa_flash_decode_kernel(const TQ* __restrict__ q, const TK* __restrict__ k,
                        const TK* __restrict__ v, const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale, const int* __restrict__ pos,
                        float* __restrict__ out, float* __restrict__ part,
                        int* __restrict__ arrived, int G, int width, int C, int window,
                        int per, float scale, int kvh, long long s_b, long long s_h,
                        long long s_c, long long sc_b, long long sc_h, long long sc_c,
                        int vec, int q_bf16) {
  constexpr int T = Tile<HD>::T;
  constexpr int LD = Tile<HD>::LD;
  constexpr int MAXE = GC * HD / NTHREADS;         // a chunk's accumulators a thread
  constexpr bool RAW = sizeof(TK) < 4;            // staged in the stored dtype first
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                // GC * HD: the chunk's query rows, scaled
  float* ks = qs + GC * HD;        // T * LD
  float* vs = ks + T * LD;         // T * LD
  TK* kraw = reinterpret_cast<TK*>(vs + T * LD);  // T * HD stored elements (RAW)
  TK* vraw = kraw + (RAW ? T * HD : 0);
  float* ss = reinterpret_cast<float*>(vraw + (RAW ? T * HD : 0));  // GC * T
  float* ksc = ss + GC * T;        // T row scales
  float* vsc = ksc + T;            // T
  float* ms = vsc + T;             // GC running max of the chunk's rows
  float* ds = ms + GC;             // GC running denominator
  float* cs = ds + GC;             // GC correction of this tile
  __shared__ int last;

  const int n = blockIdx.x;
  const int split = blockIdx.y;
  const int S = gridDim.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int hd = GENERAL ? width : HD;   // the rows' width
  const int GH = G * hd;
  const int chunks = GENERAL ? (G + GC - 1) / GC : 1;
  // one chunk: its accumulators stay in registers from tile to tile; more:
  // each chunk's (acc, m, d) rests in this split's partial between tiles
  const bool resident = chunks == 1;
  // query element idx as f32: TQ's; the general instances are built once
  // for both query dtypes (TQ f32), reading bf16 where q_bf16
  auto q_at = [&](size_t idx) -> float {
    if constexpr (GENERAL) {
      if (q_bf16) return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(q)[idx]);
    }
    return to_f32(q[idx]);
  };
  // the query rows of chunk 0 load beside pos, not after it
  std::conditional_t<GENERAL, float, TQ> qv[MAXE];
#pragma unroll
  for (int i = 0; i < MAXE; ++i) {
    const int e = tid + i * NTHREADS;
    if (resident && e < GH) {
      if constexpr (GENERAL)
        qv[i] = q_at((size_t)n * GH + e);
      else
        qv[i] = q[(size_t)n * GH + e];
    }
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

  // this thread's accumulator entries of a chunk: entry e = tid + i 256 is
  // row e / hd of the chunk, column e % hd (division by the constant HD
  // where the rows fill the instance)
  const bool padded = GENERAL && hd < HD;   // rows on a wider instance
  auto row_of = [&](int e) { return padded ? e / hd : e / HD; };
  auto col_of = [&](int e) { return padded ? e % hd : e % HD; };
  // columns hd..HD - 1 of the K/V tiles stay zero: no copy writes them
  if (padded)
    for (int e = tid; e < 2 * T * LD; e += NTHREADS) ks[e] = 0.f;
  float acc[MAXE];
#pragma unroll
  for (int i = 0; i < MAXE; ++i) {
    const int e = tid + i * NTHREADS;
    if (resident && e < GH) qs[row_of(e) * HD + col_of(e)] = to_f32(qv[i]) * scale;
    acc[i] = 0.f;
  }
  if (resident) {
    if (padded)
      for (int e = tid; e < G * HD; e += NTHREADS)
        if (e % HD >= hd) qs[e] = 0.f;
    for (int g = tid; g < G; g += NTHREADS) {
      ms[g] = REPRO_NEG_INF;
      ds[g] = 0.f;
    }
  }
  const long long row0 = (long long)(n / kvh) * s_b + (long long)(n % kvh) * s_h;
  const long long srow0 = (long long)(n / kvh) * sc_b + (long long)(n % kvh) * sc_h;
  const TK* kb = k + row0;
  const TK* vb = v + row0;
  const float* ksb = k_scale ? k_scale + srow0 : nullptr;
  const float* vsb = v_scale ? v_scale + srow0 : nullptr;
  const bool scaled = ksb != nullptr;
  // the copies walk the instance's row of HD and skip its columns past hd
  // (hd is a whole number of 16-byte chunks on the vec path)
  constexpr int CPR = HD * (int)sizeof(TK) / 16;  // 16-byte chunks of an instance row
  constexpr int EPC = 16 / (int)sizeof(TK);       // elements of a chunk

  for (int t0 = c0; t0 < c1; t0 += T) {
    const bool first = t0 == c0;
    const bool closing = t0 + T >= c1;   // the split's last tile
    __syncthreads();                 // the previous tile's reads are done
    if (vec) {
      TK* kd = RAW ? kraw : reinterpret_cast<TK*>(ks);
      TK* vd = RAW ? vraw : reinterpret_cast<TK*>(vs);
      constexpr int ROW = RAW ? HD : LD;           // destination row, elements of TK
      for (int c = tid; c < T * CPR; c += NTHREADS) {
        const int j = c / CPR, cc = c % CPR;
        if (cc * EPC >= hd) continue;
        const int slot = t0 + j;
        const bool read = slot < c1 && visible(slot);
        const long long off = (long long)(read ? slot : t0) * s_c + cc * EPC;
        cp_async16(kd + j * ROW + cc * EPC, kb + off, read);
        cp_async16(vd + j * ROW + cc * EPC, vb + off, read);
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
      // rows off 16-byte boundaries (or of a width that is not a whole
      // number of 16-byte chunks): one element at a time
      for (int e = tid; e < T * HD; e += NTHREADS) {
        const int j = e / HD, d = e % HD;
        if (d >= hd) continue;
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
        if (d >= hd) continue;
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

    // every chunk of query rows against the staged tile
    for (int ch = 0; ch < chunks; ++ch) {
      const int g0 = ch * GC;
      const int gc = min(GC, G - g0);
      const int ce = gc * hd;        // the chunk's accumulator entries
      if (!resident) {
        __syncthreads();             // the previous chunk's reads of qs, ss, cs are done
        for (int e = tid; e < gc * HD; e += NTHREADS) {
          const int d = e % HD;
          qs[e] = d < hd ? q_at((size_t)n * GH + (size_t)(g0 + e / HD) * hd + d) * scale : 0.f;
        }
        // its running state: fresh on the split's first tile, else where
        // this thread left it in the partial
#pragma unroll
        for (int i = 0; i < MAXE; ++i) {
          const int e = tid + i * NTHREADS;
          acc[i] = !first && e < ce ? __ldcg(mine + (size_t)g0 * hd + e) : 0.f;
        }
        for (int g = tid; g < gc; g += NTHREADS) {
          ms[g] = first ? REPRO_NEG_INF : __ldcg(mine + GH + g0 + g);
          ds[g] = first ? 0.f : __ldcg(mine + GH + G + g0 + g);
        }
        __syncthreads();
      }

      for (int e = tid; e < gc * T; e += NTHREADS) {
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

      for (int g = warp; g < gc; g += NWARPS) {
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
        if (e < ce) {
          const int g = row_of(e);
          const int dd = col_of(e);
          const float* pg = ss + g * T;
          float a = acc[i] * cs[g];
#pragma unroll 8
          for (int j = 0; j < T; ++j) a += pg[j] * vs[j * LD + dd];
          acc[i] = a;
        }
      }
      if (!resident) {
        // the chunk's state back into the partial, or, on the split's last
        // tile with one split live, its rows of out
#pragma unroll
        for (int i = 0; i < MAXE; ++i) {
          const int e = tid + i * NTHREADS;
          if (e >= ce) continue;
          if (closing && live == 1)
            out[(size_t)n * GH + (size_t)g0 * hd + e] = acc[i] / fmaxf(ds[row_of(e)], 1e-30f);
          else
            __stcg(mine + (size_t)g0 * hd + e, acc[i]);
        }
        if (!(closing && live == 1)) {
          for (int g = tid; g < gc; g += NTHREADS) {
            __stcg(mine + GH + g0 + g, ms[g]);
            __stcg(mine + GH + G + g0 + g, ds[g]);
          }
        }
      }
    }
  }
  __syncthreads();

  if (resident) {
    if (live == 1) {
      // one split: the merge below would scale by exp(0) = 1 and add nothing
#pragma unroll
      for (int i = 0; i < MAXE; ++i) {
        const int e = tid + i * NTHREADS;
        if (e < GH) out[(size_t)n * GH + e] = acc[i] / fmaxf(ds[row_of(e)], 1e-30f);
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
  }
  if (live == 1) return;
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
    const int g = e / hd;
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
constexpr size_t smem_bytes() {
  constexpr int T = Tile<HD>::T;
  constexpr size_t raw = sizeof(TK) < 4 ? 2 * (size_t)T * HD * sizeof(TK) : 0;
  return sizeof(float) * (size_t)(GC * HD + 2 * T * Tile<HD>::LD + GC * T + 2 * T + 3 * GC) + raw;
}

struct Launch {
  const void *q, *k, *v;
  const float *ks, *vs;
  const int* pos;
  float *out, *part;
  int* arrived;
  int N, G, hd, C, window, splits, per, q_bf16;
  float scale;
  Strides st;
  cudaStream_t stream;
};

template <typename TQ, typename TK, int HD, bool GENERAL>
int launch(const Launch& a) {
  auto kernel = swa_flash_decode_kernel<TQ, TK, HD, GENERAL>;
  constexpr size_t smem = smem_bytes<TK, HD>();
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const size_t es = sizeof(TK);
  const auto a16 = [](long long x) { return x % 16 == 0; };
  const int vec = a16(reinterpret_cast<uintptr_t>(a.k)) && a16(reinterpret_cast<uintptr_t>(a.v)) &&
                  a16(a.st.s_b * (long long)es) && a16(a.st.s_h * (long long)es) &&
                  a16(a.st.s_c * (long long)es) && a16(a.hd * (long long)es);
  kernel<<<dim3(a.N, a.splits), NTHREADS, smem, a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TK*>(a.k), static_cast<const TK*>(a.v),
      a.ks, a.vs, a.pos, a.out, a.part, a.arrived, a.G, a.hd, a.C, a.window, a.per, a.scale,
      a.st.kvh, a.st.s_b, a.st.s_h, a.st.s_c, a.st.sc_b, a.st.sc_h, a.st.sc_c, vec, a.q_bf16);
  return 0;
}

template <typename TQ, typename TK, bool GENERAL>
int launch_hd(const Launch& a, int hd) {
  return by_instance(hd, [&](auto inst) {
    return launch<TQ, TK, decltype(inst)::value, GENERAL>(a);
  });
}

template <typename TQ, bool GENERAL>
int launch_kv(const Launch& a, int hd, int kv_dtype) {
  switch (kv_dtype) {
    case DT_F32:
      return launch_hd<TQ, float, GENERAL>(a, hd);
    case DT_BF16:
      return launch_hd<TQ, __nv_bfloat16, GENERAL>(a, hd);
    case DT_E4M3:
      return launch_hd<TQ, __nv_fp8_e4m3, GENERAL>(a, hd);
    case DT_E5M2:
      return launch_hd<TQ, __nv_fp8_e5m2, GENERAL>(a, hd);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// 0 or a CUDA error of the launch's set-up (the caller checks the launch).
// part: (N, splits, G*hd + 2G) f32 scratch; arrived: (N,) i32, zero at
// entry and left zero. splits and per are kernels/swa_attention.py
// decode_splits(N, C, hd, SMs); any other split of C is refused.
template <bool GENERAL>
int decode_entry(const void* q, const void* k, const void* v, const void* k_scale,
                 const void* v_scale, const void* pos, void* out, void* part, void* arrived,
                 int N, int G, int C, int hd, int window, int q_dtype, int kv_dtype, int splits,
                 int per, float scale, int kvh, long long s_b, long long s_h, long long s_c,
                 long long sc_b, long long sc_h, long long sc_c, void* stream) {
  if (G < 1 || kvh < 1 || N < 1 || C < 1 || (long long)G * hd + 2 * G > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (!hd_instance(hd) || (!GENERAL && (G > GC || hd != hd_instance(hd))))
    return (int)cudaErrorInvalidValue;
  const int T = 4096 / hd_instance(hd);
  if (splits < 1 || splits > MAX_SPLITS || per < T || per % T ||
      (long long)(splits - 1) * per >= C || (long long)splits * per < C)
    return (int)cudaErrorInvalidValue;
  Launch a{q, k, v, static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
           static_cast<const int*>(pos), static_cast<float*>(out), static_cast<float*>(part),
           static_cast<int*>(arrived), N, G, hd, C, window, splits, per, q_dtype == DT_BF16, scale,
           Strides{kvh, s_b, s_h, s_c, sc_b, sc_h, sc_c}, static_cast<cudaStream_t>(stream)};
  int rc;
  switch (q_dtype) {
    case DT_F32:
      rc = launch_kv<float, GENERAL>(a, hd, kv_dtype);
      break;
    case DT_BF16:   // the general instances read bf16 queries at run time
      if constexpr (GENERAL)
        rc = launch_kv<float, GENERAL>(a, hd, kv_dtype);
      else
        rc = launch_kv<__nv_bfloat16, GENERAL>(a, hd, kv_dtype);
      break;
    default:
      rc = (int)cudaErrorInvalidValue;
  }
  return rc;
}

}  // namespace
