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
// Bound: bytes. quant_rows must read 4 B and write 1 B per element (plus
// 4 B a row); dequant_rows reads 1 B and writes 4 B.
//
// quant_rows, resident route (rows_resident_kernel). The TPU kernel keeps
// a whole row (up to 8.4 MB, t = 2,098,176 at b 2048) in VMEM and
// quantizes it in one sweep. No SM holds such a row, but the card does: a
// cooperative launch of blocks that are all resident (one an SM, from the
// occupancy API), each with three buffers of up to SLICE_MAX elements in
// shared memory. The rows are cut into items of `slice` elements (P =
// ceil(t / slice) a row, P <= grid), and each wave holds floor(grid / P)
// whole rows: block b takes slice b % P of one row a wave, in row order
// (kernels/quant.py quant_slice picks the slice, quant_items lists the
// schedule). A block copies an item into shared memory with one bulk async
// copy (cp.async.bulk completing an mbarrier; the few elements off 16-byte
// boundaries by plain loads), takes the item's amax from shared memory,
// atomicMax-es it into the row's amax (the bits of |x|, as fp8_quant.cuh)
// and bumps the row's counter after a fence. When the count reaches P it
// reads the row's amax (a fence between the two reads: acquire) and
// quantizes the item from shared memory, 16 elements a thread, one 16-byte
// store. x is read from HBM once: 5 B an element. A block's step k: read
// the count of item k's row, start the copy of item k + 2 (into the buffer
// item k - 1 left), publish item k + 1, look at the count (read again
// until it is full), quantize item k. Thread 0 reads while thread 32
// publishes, so the two round trips overlap.
//
// Deadlock freedom. Every block is resident (the cooperative launch fails
// rather than run a grid that is not), and a row's items all lie in one
// wave. A block publishes its item of wave w + 1 before it waits on its
// item of wave w, and its wave-0 item before any wait. So, by induction on
// w, every row of wave w completes: each block passes its waits of the
// waves before w, then publishes its wave-w item. The same order gives a
// wait a step of slack: the rows of wave w were published during step
// w - 1. While a block waits, the copy of the item after next is already
// in flight (three buffers: quantizing, published, loading).
//
// Counters. amax and the arrival counter of each row are a caller-owned
// u32 scratch that is zero at entry and zero at exit: each reader adds one
// more arrival after it has read amax, and the reader that brings the
// count to 2P clears both. So no memset is launched.
//
// quant_rows, long-row route (rows_amax_kernel + rows_quant_kernel): a row
// of more than grid * SLICE_MAX elements would have more items than
// blocks; the wrapper chooses this route by size (kernels/quant.py
// quant_slice). It zeroes the amax scratch, runs a max pass over row
// chunks and a flat quantize pass that re-reads x: 9 B an element.
//
// The long-row route's quantize pass is flat, 16 elements a thread; it
// falls back to one element at a time where a 16-group straddles a row or
// the pointers are not aligned.
//
// dequant_rows (rows_dequant_kernel) is one block per (row, tile) of
// DQ_TILE words (4 elements each, 8 KB of payload, 32 KB of output), the
// row's scale read once a block, offsets within the row in 32 bits. A
// warp's load takes 128 contiguous payload bytes (a 32-bit word a lane)
// and its store writes 512 contiguous output bytes (a float4 a lane): both
// sides coalesced, and a thread's DQ_UNROLL loads are all in flight before
// its first store. fmt is a template parameter and each cvt converts two
// codes (cvt.rn.f16x2.e4m3x2 / .e5m2x2). The row's few elements before its
// first 16-byte aligned output address and after its last whole word are
// written one by one; a payload that is not 4-byte aligned (a view) reads
// each word as four bytes, the stores stay vector.
//
// The arithmetic is fp8_quant.cuh's (shared with factor_syrk_wire): a max
// is order-free, so payloads and scales are bit-identical to the plain
// versions on every route.

#include "fp8_quant.cuh"
#include "hopper.cuh"

namespace {

constexpr int NT = 256;              // threads per block, flat passes
constexpr int CHUNK = NT * 32;       // elements of a row per block, max pass
constexpr int VEC = 16;              // elements per thread, flat passes

// dequant_rows
constexpr int DQ_NT = 256;           // threads per block
constexpr int DQ_UNROLL = 8;         // words (4 elements) a thread per tile
constexpr int DQ_TILE = DQ_NT * DQ_UNROLL;  // words a tile (kernels/quant.py)

// resident route
constexpr int RT = 512;              // threads per block
constexpr int SLICE_MAX = 18432;     // elements of an item at most (kernels/quant.py)
constexpr int SLICE_ALIGN = 64;      // an item's length is a multiple of this
constexpr int STAGES = 3;
constexpr int BUF = SLICE_MAX + 8;   // an item and up to 3 + 4 elements to 16-byte boundaries
constexpr size_t RES_SMEM = (size_t)STAGES * BUF * sizeof(float);

__device__ __forceinline__ unsigned ld_relaxed(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// max over the block; every thread gets it (red: RT / 32 words)
__device__ __forceinline__ unsigned block_max_all(unsigned v, unsigned* red) {
  v = __reduce_max_sync(0xffffffffu, v);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();                   // red is free again
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < RT / 32 ? red[lane] : 0u;
  return __reduce_max_sync(0xffffffffu, v);
}

// One item: elements [e0, e1) of the flat (g, t) range, all of one row.
// Its buffer holds x[f0 .. ), f0 = e0 rounded down to a 16-byte boundary of
// x where the bulk copy is used (vec), else e0; the bulk copy brings
// [a0, a1), the 16-byte aligned interior, plain loads the rest, and the
// buffer's positions outside [e0, e1) up to the next 16-byte boundary are
// zero (amax-neutral).
struct Item {
  long long row, e0, e1, f0, a0, a1;
};

__device__ __forceinline__ Item item_of(long long row, int s, long long t, int slice, int vec) {
  Item it;
  it.row = row;
  const long long lo = (long long)s * slice;
  it.e0 = it.row * t + lo;
  it.e1 = it.row * t + min(lo + (long long)slice, t);
  if (vec) {
    it.f0 = it.e0 & ~3LL;
    it.a0 = min((it.e0 + 3) & ~3LL, it.e1);
    it.a1 = max(it.e1 & ~3LL, it.a0);
  } else {
    it.f0 = it.e0;
    it.a0 = it.a1 = it.e1;
  }
  return it;
}

// start the copy of an item into buf (all threads; the caller syncs after)
__device__ __forceinline__ void start_copy(const Item& it, const float* __restrict__ x, float* buf,
                                      uint32_t bar) {
  // the buffer's earlier contents were read (and its pads written) by the
  // generic proxy; order those before the async proxy's writes
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (threadIdx.x == 0) {
    const uint32_t bytes = (uint32_t)(it.a1 - it.a0) * 4u;
    if (bytes) {
      hopper::mbar_expect_tx(bar, bytes);
      bulk_load(hopper::smem_addr(buf + (it.a0 - it.f0)), x + it.a0, bytes, bar);
    } else {
      hopper::mbar_arrive(bar);
    }
  }
  const long long end4 = it.f0 + ((it.e1 - it.f0 + 3) & ~3LL);
  const int head = (int)(it.a0 - it.f0);   // [f0, a0): pads, then plain loads
  const int tail = (int)(end4 - it.a1);    // [a1, end4): plain loads, then pads
  for (int j = threadIdx.x; j < head + tail; j += RT) {
    const long long e = j < head ? it.f0 + j : it.a1 + (j - head);
    buf[e - it.f0] = e >= it.e0 && e < it.e1 ? x[e] : 0.f;
  }
}

__device__ __forceinline__ unsigned sel4(const unsigned (&w)[4], int i) {
  return i == 0 ? w[0] : i == 1 ? w[1] : i == 2 ? w[2] : w[3];
}

__global__ void __launch_bounds__(RT, 1)
rows_resident_kernel(const float* __restrict__ x, unsigned char* __restrict__ payload,
                     float* __restrict__ scale, unsigned* __restrict__ amax,
                     unsigned* __restrict__ count, long long g, long long t, int slice,
                     int per_row, int fmt, int pow2, float inv_max, int vec) {
  extern __shared__ __align__(128) float bufs[];
  __shared__ __align__(8) uint64_t bars[STAGES];
  __shared__ unsigned red[RT / 32];
  __shared__ float row_scale;
  const int tid = threadIdx.x;
  // a wave holds `rows` whole rows: block b takes slice b % P of row
  // b / P + k * rows in wave k
  const int rows = gridDim.x / per_row;
  const int b = blockIdx.x;
  const long long row0 = b / per_row;
  if (b >= rows * per_row || row0 >= g) return;
  const int sl = b % per_row;
  const int mine = (int)((g - 1 - row0) / rows + 1);
  const float fmax = fp8q::fmt_max(fmt);
  const unsigned full = (unsigned)per_row;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) hopper::mbar_init(hopper::smem_addr(&bars[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto buf_of = [&](int k) { return bufs + (size_t)(k % STAGES) * BUF; };
  auto bar_of = [&](int k) { return hopper::smem_addr(&bars[k % STAGES]); };
  auto item_k = [&](int k) { return item_of(row0 + (long long)k * rows, sl, t, slice, vec); };

  // the amax of item k (its copy complete) into its row, then one
  // arrival (release), from thread 32: thread 0 polls
  auto publish = [&](int k) {
    const Item it = item_k(k);
    hopper::mbar_wait(bar_of(k), (uint32_t)((k / STAGES) & 1));
    const float4* v = reinterpret_cast<const float4*>(buf_of(k));
    const int n4 = (int)((it.e1 - it.f0 + 3) >> 2);
    unsigned m = 0u;
#pragma unroll 4
    for (int j = tid; j < n4; j += RT) {
      const float4 f = v[j];
      m = max(max(m, fp8q::abs_bits(f.x)), max(fp8q::abs_bits(f.y), max(fp8q::abs_bits(f.z),
                                                                        fp8q::abs_bits(f.w))));
    }
    m = block_max_all(m, red);
    if (tid == 32) {
      if (m) atomicMax(amax + it.row, m);
      __threadfence();
      atomicAdd(count + it.row, 1u);
    }
  };

  start_copy(item_k(0), x, buf_of(0), bar_of(0));
  if (mine > 1) start_copy(item_k(1), x, buf_of(1), bar_of(1));
  __syncthreads();
  publish(0);
  for (int k = 0; k < mine; ++k) {
    const Item it = item_k(k);
    // thread 0 reads the row's count now; it looks at the value after the
    // copy is started and item k + 1 is published (the row was published a
    // step ago, so the read usually finds it complete)
    unsigned seen = tid == 0 ? ld_relaxed(count + it.row) : 0u;
    // the buffer of item k - 1 is free: start the copy of k + 2 first, so
    // two copies are in flight while k + 1 is published and k waits
    if (k + 2 < mine) {
      start_copy(item_k(k + 2), x, buf_of(k + 2), bar_of(k + 2));
      __syncthreads();
    }
    if (k + 1 < mine) publish(k + 1);
    unsigned arrivals = 0u;
    if (tid == 0) {
      while (seen < full) {
        __nanosleep(20);
        seen = ld_relaxed(count + it.row);
      }
      __threadfence();                       // acquire: the maxes before the count
      const unsigned a = ld_relaxed(amax + it.row);
      const float s = fp8q::scale_of(__uint_as_float(a), inv_max, pow2);
      row_scale = s;
      if (it.e0 == it.row * t) scale[it.row] = s;
      // amax has been read (its value is used above); the reply is looked
      // at after the quantize
      arrivals = atomicAdd(count + it.row, 1u);
    }
    __syncthreads();
    const float s = row_scale;
    const float* buf = buf_of(k);
    long long q0 = it.e1, q1 = it.e1;        // [q0, q1): whole 16-groups
    if (vec) {
      q0 = min((it.e0 + 15) & ~15LL, it.e1);
      q1 = max(it.e1 & ~15LL, q0);
    }
    const int groups = (int)((q1 - q0) >> 4);
    const float4* v4 = reinterpret_cast<const float4*>(buf + (q0 - it.f0));
    for (int c = tid; c < groups; c += RT) {
      // four float4 reads, in an order swizzled by the group so that eight
      // neighbouring threads hit 32 distinct banks
      const int sw = (c >> 1) & 3;
      unsigned w[4];
#pragma unroll
      for (int k4 = 0; k4 < 4; ++k4) {
        const float4 f = v4[4 * c + (k4 ^ sw)];
        w[k4] = (unsigned)fp8q::quant_one(f.x, s, fmax, fmt) |
                ((unsigned)fp8q::quant_one(f.y, s, fmax, fmt) << 8) |
                ((unsigned)fp8q::quant_one(f.z, s, fmax, fmt) << 16) |
                ((unsigned)fp8q::quant_one(f.w, s, fmax, fmt) << 24);
      }
      *reinterpret_cast<uint4*>(payload + q0 + 16LL * c) =
          make_uint4(sel4(w, sw), sel4(w, 1 ^ sw), sel4(w, 2 ^ sw), sel4(w, 3 ^ sw));
    }
    const int head = (int)(q0 - it.e0);
    const int rest = head + (int)(it.e1 - q1);
    for (int j = tid; j < rest; j += RT) {
      const long long e = j < head ? it.e0 + j : q1 + (j - head);
      payload[e] = fp8q::quant_one(buf[e - it.f0], s, fmax, fmt);
    }
    if (tid == 0 && arrivals == 2 * full - 1) {
      amax[it.row] = 0u;                     // the last reader: leave zeros
      count[it.row] = 0u;
    }
  }
}

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

// dequant_rows: block b takes tile b % tiles of row b / tiles. The row's
// elements before the first 4-aligned flat index (head) and after its last
// whole word (tail) are written one by one by the row's first and last
// tile; the words between go DQ_UNROLL a thread, the block's threads on
// consecutive words: a warp reads 128 contiguous payload bytes and writes
// 512 contiguous, 16-byte aligned output bytes per instruction. All of a
// thread's loads are issued before its first store. ALIGNED: the payload's
// words are 4-byte aligned (else each word is read as 4 bytes). Offsets
// within a row are 32-bit (t < 2^31, checked by the wrapper).
template <int FMT, bool ALIGNED>
__global__ void __launch_bounds__(DQ_NT)
rows_dequant_kernel(const unsigned char* __restrict__ payload, const float* __restrict__ scale,
                    float* __restrict__ out, int t, int tiles) {
  const long long row = blockIdx.x / tiles;
  const int tile = blockIdx.x % tiles;
  const long long base = row * (long long)t;
  const int head = min((int)((4 - (base & 3)) & 3), t);
  const int words = (t - head) >> 2;
  const float s = scale[row];
  const unsigned char* prow = payload + base;
  float* orow = out + base;
  const int tid = threadIdx.x;
  if (tile == 0 && tid < head) orow[tid] = fp8q::dequant_one<FMT>(prow[tid], s);
  if (tile == tiles - 1) {
    const int e = head + 4 * words + tid;
    if (e < t) orow[e] = fp8q::dequant_one<FMT>(prow[e], s);
  }
  const int w0 = tile * DQ_TILE;
  const int w1 = min(w0 + DQ_TILE, words);
  const unsigned char* pv = prow + head;
  float4* ov = reinterpret_cast<float4*>(orow + head);
  auto load = [&](int j) -> unsigned {
    if (ALIGNED) return __ldcs(reinterpret_cast<const unsigned*>(pv) + j);
    const unsigned char* b = pv + 4 * j;
    return (unsigned)__ldcs(b) | ((unsigned)__ldcs(b + 1) << 8) |
           ((unsigned)__ldcs(b + 2) << 16) | ((unsigned)__ldcs(b + 3) << 24);
  };
  auto convert = [&](unsigned w) {
    const float2 lo = fp8q::dequant_pair<FMT>((unsigned short)(w & 0xFFFFu), s);
    const float2 hi = fp8q::dequant_pair<FMT>((unsigned short)(w >> 16), s);
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  };
  unsigned w[DQ_UNROLL];
  if (w1 - w0 == DQ_TILE) {
#pragma unroll
    for (int i = 0; i < DQ_UNROLL; ++i) w[i] = load(w0 + i * DQ_NT + tid);
#pragma unroll
    for (int i = 0; i < DQ_UNROLL; ++i) ov[w0 + i * DQ_NT + tid] = convert(w[i]);
  } else {
#pragma unroll
    for (int i = 0; i < DQ_UNROLL; ++i) {
      const int j = w0 + i * DQ_NT + tid;
      w[i] = j < w1 ? load(j) : 0u;
    }
#pragma unroll
    for (int i = 0; i < DQ_UNROLL; ++i) {
      const int j = w0 + i * DQ_NT + tid;
      if (j < w1) ov[j] = convert(w[i]);
    }
  }
}

// blocks of a flat pass: enough for 16 of them an SM
int flat_grid(long long total, int sms) {
  const long long groups = (total + VEC - 1) / VEC;
  const long long blocks = (groups + NT - 1) / NT;
  const long long most = 16LL * (sms > 0 ? sms : 1);
  return (int)(blocks < most ? blocks : most);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// blocks of the resident route that the current device holds at once (its
// shared memory raised first); asked once per device
int resident_grid(int* grid) {
  static int held[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 64 && held[dev]) {
    *grid = held[dev];
    return 0;
  }
  e = cudaFuncSetAttribute(rows_resident_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)RES_SMEM);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rows_resident_kernel, RT, RES_SMEM);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  *grid = per_sm * sms;
  if (dev < 64) held[dev] = *grid;
  return 0;
}

// The dequant kernel's instances by (fmt, aligned payload)
template <int FMT>
const void* dequant_instance(int aligned) {
  return aligned ? (const void*)rows_dequant_kernel<FMT, true>
                 : (const void*)rows_dequant_kernel<FMT, false>;
}

}  // namespace

// The resident route's grid on the current device (kernels/quant.py
// resident_grid), or minus a CUDA error code.
extern "C" int quant_rows_grid() {
  int grid = 0;
  const int e = resident_grid(&grid);
  return e ? -e : grid;
}

// slice > 0: the resident route on `grid` blocks, scratch (2g,) u32 zero at
// entry (left zero): amax, then the arrival counters. slice == 0: the
// long-row route, scratch (g,) u32 amax zeroed here, flat pass on `sms`.
extern "C" int quant_rows(const void* x, void* payload, void* scale, void* scratch, long long g,
                          long long t, int fmt, int pow2, float inv_max, int grid, int slice,
                          int sms, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (g < 1 || t < 1 || (fmt != DT_E4M3 && fmt != DT_E5M2)) return (int)cudaErrorInvalidValue;
  const int vec = aligned16(x) && aligned16(payload);
  if (slice > 0) {
    int most = 0;
    const int e = resident_grid(&most);
    if (e) return e;
    const long long per_row = (t + slice - 1) / slice;
    if (slice % SLICE_ALIGN || slice > SLICE_MAX || grid < 1 || grid > most || per_row > grid)
      return (int)cudaErrorInvalidValue;
    const float* xp = static_cast<const float*>(x);
    unsigned char* pp = static_cast<unsigned char*>(payload);
    float* sp = static_cast<float*>(scale);
    unsigned* ap = static_cast<unsigned*>(scratch);
    unsigned* cp = ap + g;
    int pr = (int)per_row;
    void* args[] = {&xp, &pp, &sp, &ap, &cp, &g, &t, &slice, &pr, &fmt, &pow2, &inv_max,
                    (void*)&vec};
    return (int)cudaLaunchCooperativeKernel((const void*)rows_resident_kernel, dim3(grid),
                                            dim3(RT), args, RES_SMEM, st);
  }
  cudaError_t e = cudaMemsetAsync(scratch, 0, g * sizeof(unsigned), st);
  if (e != cudaSuccess) return (int)e;
  const long long chunks = (t + CHUNK - 1) / CHUNK;
  if (g * chunks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  rows_amax_kernel<<<(unsigned)(g * chunks), NT, 0, st>>>(
      static_cast<const float*>(x), static_cast<unsigned*>(scratch), t, (int)chunks);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  rows_quant_kernel<<<flat_grid(g * t, sms), NT, 0, st>>>(
      static_cast<const float*>(x), static_cast<unsigned char*>(payload),
      static_cast<float*>(scale), static_cast<const unsigned*>(scratch), g, t, fmt, pow2,
      inv_max, vec);
  return (int)cudaGetLastError();
}

// tiles: the tiles a row (kernels/quant.py dequant_geometry), refused if
// it is not max(1, ceil(floor(t / 4) / DQ_TILE)); out must be 16-byte
// aligned (the wrapper allocates it)
extern "C" int dequant_rows(const void* payload, const void* scale, void* out, long long g,
                            long long t, int fmt, int tiles, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (g < 1 || t < 1 || t > 0x7FFFFFFFLL || (fmt != DT_E4M3 && fmt != DT_E5M2) ||
      !aligned16(out))
    return (int)cudaErrorInvalidValue;
  const long long want = ((t / 4) + DQ_TILE - 1) / DQ_TILE;
  if (tiles != (want > 1 ? want : 1) || g * tiles > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const int aligned = (reinterpret_cast<uintptr_t>(payload) & 3u) == 0;
  const void* kernel = fmt == DT_E4M3 ? dequant_instance<DT_E4M3>(aligned)
                                      : dequant_instance<DT_E5M2>(aligned);
  const unsigned char* pp = static_cast<const unsigned char*>(payload);
  const float* sp = static_cast<const float*>(scale);
  float* op = static_cast<float*>(out);
  int ti = (int)t;
  void* args[] = {&pp, &sp, &op, &ti, &tiles};
  return (int)cudaLaunchKernel(kernel, dim3((unsigned)(g * tiles)), dim3(DQ_NT), args, 0, st);
}

// Registers and local memory (stack frame, spills included) a thread of
// each dequant instance, from cudaFuncGetAttributes: attrs[4] pairs in the
// order (e4m3, aligned), (e4m3, bytes), (e5m2, aligned), (e5m2, bytes)
extern "C" int dequant_rows_attrs(void* attrs) {
  int* a = static_cast<int*>(attrs);
  const void* k[4] = {dequant_instance<DT_E4M3>(1), dequant_instance<DT_E4M3>(0),
                      dequant_instance<DT_E5M2>(1), dequant_instance<DT_E5M2>(0)};
  for (int i = 0; i < 4; ++i) {
    cudaFuncAttributes fa;
    const cudaError_t e = cudaFuncGetAttributes(&fa, k[i]);
    if (e != cudaSuccess) return (int)e;
    a[2 * i] = fa.numRegs;
    a[2 * i + 1] = (int)fa.localSizeBytes;
  }
  return 0;
}
