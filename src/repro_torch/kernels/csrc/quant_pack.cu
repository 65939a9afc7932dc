// Per-row fp8 quantize and dequantize of sym-packed factor rows: the fp8
// factor history (encode on refresh, decode on read) and the b > 1024 wire
// capture route.
//
// Replaces the TPU kernel repro/kernels/quant_pack.py::quant_rows
// (_quant_rows_kernel, wrapper repro/kernels/ops.py fp8_quant_rows) and
// ::dequant_rows (_dequant_rows_kernel, ops.fp8_dequant_rows).
//
//   quant_rows    x (g, t) f32 -> payload (g, t) e4m3fn | e5m2, scale (g,) f32
//   dequant_rows  payload (g, t), scale (g,) -> out (g, t) f32
//
// The TPU kernel quantizes whole rows in one sweep because a row of up to
// 8.4 MB (t = 2,098,176 at b 2048) fits its VMEM. A block here has 227 KB
// of shared memory and a family has only 16-64 rows, so one block per row
// would leave most of the 132 SMs idle. quant_rows therefore runs two
// launches over row chunks: a max pass (each block of threads reduces one
// chunk of one row and atomicMax-es the bits of its |x| into the row's
// amax), then a quantize pass over the flat (g, t) range, 16 elements a
// thread (four 16-byte loads, one 16-byte store), each element with the
// scale of its row. dequant_rows is the same flat pass in reverse (one
// 16-byte load, four 16-byte stores). Both fall back to one element at a
// time where a 16-group straddles a row or the pointers are not aligned.
//
// Bound: bytes. quant_rows must read 4 B and write 1 B per element (plus
// 4 B a row); dequant_rows reads 1 B and writes 4 B. This design reads x
// twice (the quantize pass re-reads it from HBM, or L2 where it fits), so
// it moves 9 B per element against the bound's 5.

#include "fp8_quant.cuh"

namespace {

constexpr int NT = 256;              // threads per block
constexpr int CHUNK = NT * 32;       // elements of a row per block, max pass
constexpr int VEC = 16;              // elements per thread, flat passes

__global__ void __launch_bounds__(NT)
rows_amax_kernel(const float* __restrict__ x, unsigned* __restrict__ amax, long long t,
                 int chunks) {
  const long long row = blockIdx.x / chunks;
  const long long c0 = (long long)(blockIdx.x % chunks) * CHUNK;
  const long long c1 = min(c0 + CHUNK, t);
  const float* xr = x + row * t;
  unsigned m = 0u;
#pragma unroll 8
  for (long long i = c0 + threadIdx.x; i < c1; i += NT) m = max(m, fp8q::abs_bits(xr[i]));
  m = fp8q::block_max(m);
  if (threadIdx.x == 0 && m) atomicMax(amax + row, m);
}

__global__ void __launch_bounds__(NT)
rows_quant_kernel(const float* __restrict__ x, unsigned char* __restrict__ payload,
                  float* __restrict__ scale, const unsigned* __restrict__ amax, long long g,
                  long long t, int fmt, int pow2, float inv_max, int vec) {
  const long long total = g * t;
  const long long groups = (total + VEC - 1) / VEC;
  const float fmax = fp8q::fmt_max(fmt);
  for (long long v = (long long)blockIdx.x * NT + threadIdx.x; v < groups;
       v += (long long)gridDim.x * NT) {
    const long long i0 = v * VEC;
    const long long i1 = min(i0 + VEC, total);
    const long long r0 = i0 / t;
    const long long r1 = (i1 - 1) / t;
    // the thread whose group holds the start of a row writes its scale
    for (long long r = (i0 + t - 1) / t; r < g && r * t < i1; ++r)
      scale[r] = fp8q::scale_of(__uint_as_float(amax[r]), inv_max, pow2);
    if (vec && r0 == r1 && i1 - i0 == VEC) {
      const float s = fp8q::scale_of(__uint_as_float(amax[r0]), inv_max, pow2);
      const float4* src = reinterpret_cast<const float4*>(x + i0);
      unsigned w[VEC / 4];
#pragma unroll
      for (int k = 0; k < VEC / 4; ++k) {
        const float4 f = src[k];
        w[k] = (unsigned)fp8q::quant_one(f.x, s, fmax, fmt) |
               ((unsigned)fp8q::quant_one(f.y, s, fmax, fmt) << 8) |
               ((unsigned)fp8q::quant_one(f.z, s, fmax, fmt) << 16) |
               ((unsigned)fp8q::quant_one(f.w, s, fmax, fmt) << 24);
      }
      *reinterpret_cast<uint4*>(payload + i0) = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
      for (long long i = i0; i < i1; ++i) {
        const float s = fp8q::scale_of(__uint_as_float(amax[i / t]), inv_max, pow2);
        payload[i] = fp8q::quant_one(x[i], s, fmax, fmt);
      }
    }
  }
}

__global__ void __launch_bounds__(NT)
rows_dequant_kernel(const unsigned char* __restrict__ payload, const float* __restrict__ scale,
                    float* __restrict__ out, long long g, long long t, int fmt, int vec) {
  const long long total = g * t;
  const long long groups = (total + VEC - 1) / VEC;
  for (long long v = (long long)blockIdx.x * NT + threadIdx.x; v < groups;
       v += (long long)gridDim.x * NT) {
    const long long i0 = v * VEC;
    const long long i1 = min(i0 + VEC, total);
    const long long r0 = i0 / t;
    if (vec && r0 == (i1 - 1) / t && i1 - i0 == VEC) {
      const float s = scale[r0];
      const uint4 raw = *reinterpret_cast<const uint4*>(payload + i0);
      const unsigned w[VEC / 4] = {raw.x, raw.y, raw.z, raw.w};
      float4* dst = reinterpret_cast<float4*>(out + i0);
#pragma unroll
      for (int k = 0; k < VEC / 4; ++k)
        dst[k] = make_float4(fp8q::dequant_one(w[k] & 0xFFu, s, fmt),
                             fp8q::dequant_one((w[k] >> 8) & 0xFFu, s, fmt),
                             fp8q::dequant_one((w[k] >> 16) & 0xFFu, s, fmt),
                             fp8q::dequant_one(w[k] >> 24, s, fmt));
    } else {
      for (long long i = i0; i < i1; ++i) out[i] = fp8q::dequant_one(payload[i], scale[i / t], fmt);
    }
  }
}

int flat_grid(long long total) {
  const long long groups = (total + VEC - 1) / VEC;
  const long long blocks = (groups + NT - 1) / NT;
  return (int)(blocks < 132LL * 16 ? blocks : 132LL * 16);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

// amax: (g,) u32 scratch, zeroed here
extern "C" int quant_rows(const void* x, void* payload, void* scale, void* amax, long long g,
                          long long t, int fmt, int pow2, float inv_max, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (g < 1 || t < 1 || (fmt != DT_E4M3 && fmt != DT_E5M2)) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaMemsetAsync(amax, 0, g * sizeof(unsigned), st);
  if (e != cudaSuccess) return (int)e;
  const long long chunks = (t + CHUNK - 1) / CHUNK;
  if (g * chunks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  rows_amax_kernel<<<(unsigned)(g * chunks), NT, 0, st>>>(
      static_cast<const float*>(x), static_cast<unsigned*>(amax), t, (int)chunks);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int vec = aligned16(x) && aligned16(payload);
  rows_quant_kernel<<<flat_grid(g * t), NT, 0, st>>>(
      static_cast<const float*>(x), static_cast<unsigned char*>(payload),
      static_cast<float*>(scale), static_cast<const unsigned*>(amax), g, t, fmt, pow2, inv_max,
      vec);
  return (int)cudaGetLastError();
}

extern "C" int dequant_rows(const void* payload, const void* scale, void* out, long long g,
                            long long t, int fmt, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (g < 1 || t < 1 || (fmt != DT_E4M3 && fmt != DT_E5M2)) return (int)cudaErrorInvalidValue;
  const int vec = aligned16(payload) && aligned16(out);
  rows_dequant_kernel<<<flat_grid(g * t), NT, 0, st>>>(
      static_cast<const unsigned char*>(payload), static_cast<const float*>(scale),
      static_cast<float*>(out), g, t, fmt, vec);
  return (int)cudaGetLastError();
}
