// Sparse top-k softmax readout (K1) and its group-0 usage pass.
//
// Replaces: xmem2_tpu/ops/readout_kernel.py `_make_kernel` (the Pallas kernel
// launched by `_pallas_pass_chunk`), which fuses threshold masking, exp,
// normalisation, the per-object value product and the group-0 usage sum.
//
// Contract, for one memory segment: sim [P, N] f32, values [O, N, Cv] f32 or
// bf16, valid [G, N] bool, tau / rmax / invz [P, G] f32 softmax stats shared
// by all segments, and a group id per object. With
//     w_g[p, n] = exp(sim[p, n] - rmax[p, g]) * invz[p, g]
//                 where sim[p, n] >= tau[p, g] and valid[g, n], else 0,
// topk_readout writes out[o, p, :] = sum_n w_{g(o)}[p, n] * values[o, n, :]
// and topk_usage writes usage[n] = sum_p w_0[p, n].
//
// Rules kept from the Pallas kernel:
//   * the validity gate sits inside the exp, not after it: a masked slot
//     never evaluates exp(sim - rmax), which overflows for strongly negative
//     rows, and a masked weight is an exact 0 that never meets invz;
//   * bf16 values: the weight rounds to bf16 and the product accumulates in
//     f32 (bf16 x bf16 products are exact in f32); f32 values take an f32
//     product;
//   * usage comes from group 0 only.
// The ragged memory edge (n >= N) and the ragged query edge are masked by
// bounds checks, so no operand needs padding.
//
// Any number of objects and groups: a CTA keeps a hit list per group in
// shared memory (kCap x 8 B = 16 KB each), so it handles at most kMaxGroups
// groups and kMaxObjects objects. The objects come in consecutive chunks
// (readout_kernel.plan_object_chunks), each within both limits, in a table
// passed by value; the grid is (query row, chunk). A CTA compacts only its
// chunk's groups and gathers only its chunk's objects, so shared memory
// stays at the 8-group worst case, and a row is read once per chunk. With
// at most 8 groups and 64 objects the table is one chunk and the launch is
// the one before chunking.
//
// Bound on this card: bytes. Only the ~k slots a row with sim >= tau carry
// weight (30 of 17,820 at the main path's shape), so the useful work is
// ~2 k Cv flops a row and object, while the similarity row has to be read
// once. Design of topk_readout:
//   * Stream and compact. A CTA owns one query row and reads it once for all
//     groups and objects, in tiles of 1,024 slots (8 warps x 32 lanes x one
//     16-byte load), the next tile's loads issued before the current one is
//     compacted. Each group's hits become a (slot, weight) list in shared
//     memory, in slot order: a warp prefix of the lanes' counts, then a CTA
//     prefix of the warps' counts.
//   * Gather. Threads span objects x channels, four channels a thread, so a
//     warp reads 128 contiguous channels of one value row (512 B in f32,
//     256 B in bf16) per hit; the sum runs in list (slot) order, in f32
//     registers, so the result is deterministic. A segment's value bank
//     (at most 17,820 slots x 1 KB x 2 objects in bf16) fits the 50 MB L2,
//     so slots shared by neighbouring pixels are read from L2.
//   * Flush path. A list holds kCap entries. When a tile could overflow one
//     (boundary ties, an under-full group whose tau is -inf, top_k > 256),
//     the CTA gathers the lists into the output row, empties them and scans
//     on: no hit is dropped, and later flushes add to the row.
// What keeps it above the byte bound (PERF.md has the times): two
// block-wide barriers per tile, and a row's tiles walked by one CTA.
// topk_usage is a reduction over queries: CTAs own 32 memory slots and loop
// over query rows; the 8 row-partials of a slot are added in a fixed order,
// so usage is deterministic (it ranks prototypes at consolidation).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = kThreads * 4;  // slots a CTA compacts per step
constexpr int kCap = 2 * kTile;      // list entries a group holds
constexpr int kMaxObjects = 64;  // objects of a chunk
constexpr int kMaxGroups = 8;    // groups of a chunk (bits of `need`)
constexpr int kMaxChunks = 16;   // chunks of a launch: the table stays well
                                 // inside the 4 KB of kernel parameters

struct Chunk {
  int o0, no;                      // objects [o0, o0 + no)
  int ng;                          // distinct groups, local ids 0..ng-1
  int g[kMaxGroups];               // their global ids
  unsigned char lg[kMaxObjects];   // local group id of object o0 + i
};

struct ChunkTable {
  Chunk c[kMaxChunks];
};

struct Tile {
  float x[4];
  uint32_t inr;                 // bit i: slot n0 + i < N
  uint32_t vraw[kMaxGroups];    // validity bytes of the 4 slots, per group
};

// validity of the chunk's local groups: local group g reads the row of
// global group ch.g[g]
template <int G>
__device__ __forceinline__ void load_tile(Tile& t, const float* row,
                                          const uint8_t* valid,
                                          const Chunk& ch, int N, int n0,
                                          bool vec, uint32_t need) {
  if (vec && n0 + 3 < N) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(row + n0));
    t.x[0] = v.x; t.x[1] = v.y; t.x[2] = v.z; t.x[3] = v.w;
    t.inr = 0xfu;
#pragma unroll
    for (int g = 0; g < G; ++g)
      t.vraw[g] = (need >> g) & 1
          ? __ldg(reinterpret_cast<const unsigned int*>(
                valid + (size_t)ch.g[g] * N + n0))
          : 0u;
  } else {
    t.inr = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool ok = n0 + i < N;
      t.x[i] = ok ? __ldg(row + n0 + i) : -INFINITY;
      t.inr |= (uint32_t)ok << i;
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      uint32_t r = 0;
      if ((need >> g) & 1) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if ((t.inr >> i) & 1)
            r |= (uint32_t)__ldg(valid + (size_t)ch.g[g] * N + n0 + i)
                 << (8 * i);
      }
      t.vraw[g] = r;
    }
  }
}

// slots of the lane's 4 that group g keeps
__device__ __forceinline__ uint32_t kept(const Tile& t, uint32_t vraw,
                                         float tau) {
  uint32_t m = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    m |= (uint32_t)(((t.inr >> i) & 1) && ((vraw >> (8 * i)) & 0xffu) &&
                    t.x[i] >= tau) << i;
  return m;
}

__device__ __forceinline__ void fma4(float (&a)[4], float w, const float* v) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(v));
  a[0] = fmaf(w, q.x, a[0]); a[1] = fmaf(w, q.y, a[1]);
  a[2] = fmaf(w, q.z, a[2]); a[3] = fmaf(w, q.w, a[3]);
}

__device__ __forceinline__ void fma4(float (&a)[4], float w,
                                     const __nv_bfloat16* v) {
  const uint2 q = __ldg(reinterpret_cast<const uint2*>(v));
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&q.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&q.y);
  a[0] = fmaf(w, __low2float(lo), a[0]); a[1] = fmaf(w, __high2float(lo), a[1]);
  a[2] = fmaf(w, __low2float(hi), a[2]); a[3] = fmaf(w, __high2float(hi), a[3]);
}

// out[o, p, :] (+)= sum over group g(o)'s list of w * values[o, slot, :],
// for the chunk's objects
template <typename VT>
__device__ void gather(const VT* __restrict__ values,
                       const int* __restrict__ lslot,
                       const float* __restrict__ lw, const int* lcnt,
                       float* __restrict__ out, int p, int P, int N, int Cv,
                       const Chunk& ch, bool add) {
  const int q4 = Cv / 4;
  for (int u = threadIdx.x; u < ch.no * q4; u += kThreads) {
    const int i = u / q4;
    const int o = ch.o0 + i;
    const int c = (u - i * q4) * 4;
    const int g = ch.lg[i];
    const int n = lcnt[g];
    const int* sl = lslot + g * kCap;
    const float* w = lw + g * kCap;
    const VT* vb = values + (size_t)o * N * Cv + c;
    float* dst = out + ((size_t)o * P + p) * Cv + c;
    float a[4] = {0.f, 0.f, 0.f, 0.f};
    if (add) {
      const float4 prev = *reinterpret_cast<const float4*>(dst);
      a[0] = prev.x; a[1] = prev.y; a[2] = prev.z; a[3] = prev.w;
    }
#pragma unroll 4
    for (int j = 0; j < n; ++j) fma4(a, w[j], vb + (size_t)sl[j] * Cv);
    *reinterpret_cast<float4*>(dst) = make_float4(a[0], a[1], a[2], a[3]);
  }
}

template <typename VT, int G>
__global__ void __launch_bounds__(kThreads)
topk_readout_kernel(const float* __restrict__ sim, const VT* __restrict__ values,
                    const uint8_t* __restrict__ valid,
                    const float* __restrict__ tau,
                    const float* __restrict__ rmax,
                    const float* __restrict__ invz, float* __restrict__ out,
                    int P, int N, int Cv, int Gs,
                    const __grid_constant__ ChunkTable tbl, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* lslot = reinterpret_cast<int*>(smem);                 // [G][kCap]
  float* lw = reinterpret_cast<float*>(lslot + G * kCap);     // [G][kCap]
  int* wcnt = reinterpret_cast<int*>(lw + G * kCap);          // [2][G][kWarps]
  int* lcnt = wcnt + 2 * G * kWarps;                          // [G]
  constexpr bool kBf16 = sizeof(VT) == 2;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x;
  const Chunk& ch = tbl.c[blockIdx.y];
  const uint32_t need = (1u << ch.ng) - 1;  // G >= ch.ng: the rest unused
  const float* row = sim + (size_t)p * N;

  // stats [P, Gs] of the chunk's groups
  float t_[G], m_[G], z_[G];
  int cnt[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const size_t at = (size_t)p * Gs + (g < ch.ng ? ch.g[g] : 0);
    t_[g] = tau[at];
    m_[g] = rmax[at];
    z_[g] = invz[at];
    cnt[g] = 0;
  }
  bool flushed = false;

  Tile cur;
  load_tile<G>(cur, row, valid, ch, N, warp * 128 + lane * 4, vec, need);
  for (int t0 = 0, step = 0; t0 < N; t0 += kTile, ++step) {
    const int n0 = t0 + warp * 128 + lane * 4;
    Tile nxt;
    if (t0 + kTile < N)
      load_tile<G>(nxt, row, valid, ch, N, n0 + kTile, vec, need);
    int* wc = wcnt + (step & 1) * G * kWarps;  // double-buffered counts

    uint32_t keep[G];
    int excl[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      keep[g] = (need >> g) & 1 ? kept(cur, cur.vraw[g], t_[g]) : 0u;
      const int c = __popc(keep[g]);
      int incl = c;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += y;
      }
      excl[g] = incl - c;
      if (lane == 31) wc[g * kWarps + warp] = incl;
    }
    __syncthreads();
    bool full = false;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      int before = 0, total = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const int c = wc[g * kWarps + w];
        before += w < warp ? c : 0;
        total += c;
      }
      int pos = cnt[g] + before + excl[g];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if ((keep[g] >> i) & 1) {
          float w = expf(cur.x[i] - m_[g]) * z_[g];
          if (kBf16) w = __bfloat162float(__float2bfloat16(w));
          lslot[g * kCap + pos] = n0 + i;
          lw[g * kCap + pos] = w;
          ++pos;
        }
      }
      cnt[g] += total;
      full |= cnt[g] > kCap - kTile;
    }
    if (full) {  // flush path: the next tile could overflow a list
      if (threadIdx.x == 0) {
#pragma unroll
        for (int g = 0; g < G; ++g) lcnt[g] = cnt[g];
      }
      __syncthreads();
      gather<VT>(values, lslot, lw, lcnt, out, p, P, N, Cv, ch, flushed);
      __syncthreads();
      flushed = true;
#pragma unroll
      for (int g = 0; g < G; ++g) cnt[g] = 0;
    }
    cur = nxt;
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) lcnt[g] = cnt[g];
  }
  __syncthreads();
  gather<VT>(values, lslot, lw, lcnt, out, p, P, N, Cv, ch, flushed);
}

constexpr int kUsageRows = 8;  // row partials per slot, added in fixed order

__global__ void __launch_bounds__(32 * kUsageRows)
topk_usage_kernel(const float* __restrict__ sim,
                  const uint8_t* __restrict__ valid0,
                  const float* __restrict__ tau, const float* __restrict__ rmax,
                  const float* __restrict__ invz, float* __restrict__ usage,
                  int P, int N, int G) {
  __shared__ float part[kUsageRows][32];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int n = blockIdx.x * 32 + tx;
  float acc = 0.f;
  if (n < N && valid0[n]) {
    for (int p = ty; p < P; p += kUsageRows) {
      const float s = sim[(size_t)p * N + n];
      if (s >= tau[(size_t)p * G]) acc += expf(s - rmax[(size_t)p * G]) * invz[(size_t)p * G];
    }
  }
  part[ty][tx] = acc;
  __syncthreads();
  if (ty == 0 && n < N) {
    float u = 0.f;
#pragma unroll
    for (int y = 0; y < kUsageRows; ++y) u += part[y][tx];
    usage[n] = u;
  }
}

template <typename VT, int G>
int launch_readout(const float* sim, const VT* values, const uint8_t* valid,
                   const float* tau, const float* rmax, const float* invz,
                   const ChunkTable& tbl, int nchunks, float* out, int P,
                   int N, int Cv, int Gs, cudaStream_t stream) {
  const size_t bytes = (size_t)G * kCap * 8 + (size_t)(2 * kWarps + 1) * G * 4;
  cudaError_t e = cudaFuncSetAttribute(
      topk_readout_kernel<VT, G>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  const bool vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(sim) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(valid) % 4 == 0;
  topk_readout_kernel<VT, G><<<dim3(P, nchunks), kThreads, bytes, stream>>>(
      sim, values, valid, tau, rmax, invz, out, P, N, Cv, Gs, tbl,
      vec ? 1 : 0);
  return (int)cudaGetLastError();
}

// G: the most groups a chunk of the table has
template <typename VT>
int launch_readout_g(int G, const float* sim, const VT* values,
                     const uint8_t* valid, const float* tau,
                     const float* rmax, const float* invz,
                     const ChunkTable& tbl, int nchunks, float* out, int P,
                     int N, int Cv, int Gs, cudaStream_t s) {
#define XMEM_CASE(n)                                                       \
  case n:                                                                  \
    return launch_readout<VT, n>(sim, values, valid, tau, rmax, invz, tbl, \
                                 nchunks, out, P, N, Cv, Gs, s);
  switch (G) {
    XMEM_CASE(1) XMEM_CASE(2) XMEM_CASE(3) XMEM_CASE(4)
    XMEM_CASE(5) XMEM_CASE(6) XMEM_CASE(7) XMEM_CASE(8)
    default: return (int)cudaErrorInvalidValue;
  }
#undef XMEM_CASE
}

}  // namespace

// The chunk table, as readout_kernel._k1_table writes it: chunks holds per
// chunk (o0, o1, number of groups, kMaxGroups global group ids), local the
// local group id of every object of the chunks, in order. G: the groups of
// the stats [P, G] and the validity [G, N]. Cv must be a multiple of 4 and
// the value rows 16-byte (f32) or 8-byte (bf16) aligned; the wrapper checks
// both.
extern "C" int topk_readout_launch(const float* sim, const void* values,
                                   int values_bf16, const uint8_t* valid,
                                   const float* tau, const float* rmax,
                                   const float* invz, const int* chunks,
                                   const int* local, int nchunks, float* out,
                                   int P, int N, int Cv, int G, void* stream) {
  if (nchunks <= 0 || nchunks > kMaxChunks || Cv % 4 != 0)
    return (int)cudaErrorInvalidValue;
  ChunkTable tbl;
  int maxg = 0, at = 0;
  for (int c = 0; c < nchunks; ++c) {
    const int* r = chunks + c * (3 + kMaxGroups);
    Chunk& ch = tbl.c[c];
    ch.o0 = r[0];
    ch.no = r[1] - r[0];
    ch.ng = r[2];
    if (ch.no <= 0 || ch.no > kMaxObjects || ch.ng <= 0 ||
        ch.ng > kMaxGroups)
      return (int)cudaErrorInvalidValue;
    for (int g = 0; g < kMaxGroups; ++g) {
      ch.g[g] = g < ch.ng ? r[3 + g] : 0;
      if (g < ch.ng && (ch.g[g] < 0 || ch.g[g] >= G))
        return (int)cudaErrorInvalidValue;
    }
    for (int i = 0; i < kMaxObjects; ++i) {
      const int lg = i < ch.no ? local[at + i] : 0;
      if (lg < 0 || lg >= ch.ng) return (int)cudaErrorInvalidValue;
      ch.lg[i] = (unsigned char)lg;
    }
    at += ch.no;
    maxg = ch.ng > maxg ? ch.ng : maxg;
  }
  if (P <= 0 || Cv <= 0) return 0;
  const int o0 = tbl.c[0].o0;
  if (N <= 0)
    return (int)cudaMemsetAsync(out + (size_t)o0 * P * Cv, 0,
                                (size_t)at * P * Cv * 4, (cudaStream_t)stream);
  cudaStream_t s = (cudaStream_t)stream;
  if (values_bf16)
    return launch_readout_g<__nv_bfloat16>(
        maxg, sim, (const __nv_bfloat16*)values, valid, tau, rmax, invz, tbl,
        nchunks, out, P, N, Cv, G, s);
  return launch_readout_g<float>(maxg, sim, (const float*)values, valid, tau,
                                 rmax, invz, tbl, nchunks, out, P, N, Cv, G,
                                 s);
}

extern "C" int topk_usage_launch(const float* sim, const uint8_t* valid0,
                                 const float* tau, const float* rmax,
                                 const float* invz, float* usage, int P, int N,
                                 int G, void* stream) {
  if (N <= 0) return 0;
  dim3 grid((N + 31) / 32);
  dim3 block(32, kUsageRows);
  topk_usage_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      sim, valid0, tau, rmax, invz, usage, P, N, G);
  return (int)cudaGetLastError();
}
