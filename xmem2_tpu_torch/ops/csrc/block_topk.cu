// One-pass exact top-k with the k-th value's tie count (K2).
//
// Replaces: xmem2_tpu/ops/readout_kernel.py `_make_cand_kernel` (the Pallas
// kernel launched by `block_topk_candidates`), which extracts the exact top-k
// values of every 512-slot block by k rounds of max + tie count, and the
// merge rounds and dense tie-count passes built on it.
//
// Contract, per (group g, query row p) of one memory segment:
//   vals[g, p, :k]  the k largest values among the group's valid slots,
//                   sorted descending, each repeated as often as it occurs
//                   (tie multiplicities), -inf past the valid count;
//   kcnt[g, p]      the number of valid slots whose value equals
//                   vals[g, p, k-1] (the segment's own k-th value).
// Two input modes:
//   * shared:  sim [P, N] with valid [G, N] (one byte a slot): every group
//              reads the same similarity row, so the row is read ONCE for all
//              groups;
//   * grouped: sim [G, P, N] with no validity (every slot valid), the
//              cross-segment merge of the per-segment lists.
// Only selection happens here, so the result is bit-identical to the plain
// version (readout_kernel.block_topk_candidates_plain).
//
// Bound on this card: bytes. Every similarity element is read once (115 MB
// at P = 1620 rows and N = 17820 slots); the output is k+1 words per row and
// group. Once a row's running k-th value is known, the work per element is
// one compare: in random order only ~k ln(N/k) elements beat it. Design:
//   * A warp owns one query row and streams it in 512-element steps (four
//     16-byte loads a lane), the next step's loads issued before the current
//     one is processed. For each group it keeps a running k-th value `kth`;
//     a 128-element chunk where no element reaches it costs one vote on each
//     lane's largest valid element. (A row split over 2 or 4 warps measured
//     slower: every warp pays its own warm-up and survivors; a vote for all
//     groups at once gained nothing, the scan is not what bounds it.)
//   * k <= 32 (the main path): the row's top-k lives in registers, lane i
//     holding the i-th largest value. A survivor is inserted with one ballot
//     (its rank) and one shuffle (the shift); a chunk with more than kBulk
//     survivors (the warm-up, or a row whose values rise along the memory) is
//     sorted in registers and merged into the list by one bitonic merge.
//     `extra` counts the elements equal to kth that the list does not hold,
//     so ties of any multiplicity cost no space.
//   * 32 < k <= 512 (larger top_k settings): survivors go to a shared-memory
//     buffer of the elements strictly above a threshold `thr`. Flush path:
//     when the next chunk could overflow the buffer, the warp bitonic-sorts
//     it, raises thr to its k-th value, keeps the elements above it and
//     counts the ones equal to it, so boundary ties (duplicated memory, or an
//     under-full group where every valid slot counts) never occupy it.
// What bounds it now: issuing the survivors' inserts and the bulk merges
// (about 190 inserts a row and group in random order), not the bytes.
//
// Any number of groups: a warp keeps the lists of at most kMaxGroups groups
// in registers, so in shared mode the groups come in ceil(G / 8) chunks of
// equal width GL (readout_kernel.plan_group_width; the last chunk may be
// narrower, its missing groups read as invalid) on the grid's second
// dimension: a row is read once per chunk. Grouped mode has one group a
// grid row. G <= 8 is one chunk, the launch it was before chunking.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kChunk = 128;     // elements a warp takes per step (4 a lane)
constexpr int kUnroll = 4;      // chunks loaded before any is processed
constexpr int kRowsPerCta = 4;  // one warp a row
constexpr int kMaxGroups = 8;   // groups a warp keeps lists of
constexpr int kBulk = 16;       // survivors of a chunk above which it is
                                // sorted and merged, not inserted one by one

// Raw loads of kUnroll chunks of one row from `base`: 4 values a lane per
// chunk and, per group, the 4 validity bytes as one word. Decoding waits for
// use, so the next step's loads are in flight while this one is processed.
template <int GL>
struct Step {
  float x[kUnroll][4];
  uint32_t vraw[kUnroll][GL];
};

// Groups g0 + g >= G (the padding of a narrower last chunk) load as
// invalid.
template <int GL>
__device__ __forceinline__ void load_step(Step<GL>& t, const float* row,
                                          const uint8_t* valid, int g0,
                                          int G, int N, int base, int lane,
                                          bool vec) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int n0 = base + u * kChunk + lane * 4;
    if (vec && n0 + 3 < N) {
      const float4 v4 = __ldg(reinterpret_cast<const float4*>(row + n0));
      t.x[u][0] = v4.x; t.x[u][1] = v4.y; t.x[u][2] = v4.z; t.x[u][3] = v4.w;
#pragma unroll
      for (int g = 0; g < GL; ++g)
        t.vraw[u][g] = g0 + g >= G ? 0u
                       : valid ? __ldg(reinterpret_cast<const unsigned int*>(
                                     valid + (size_t)(g0 + g) * N + n0))
                               : 0x01010101u;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        t.x[u][i] = n0 + i < N ? __ldg(row + n0 + i) : -INFINITY;
#pragma unroll
      for (int g = 0; g < GL; ++g) {
        uint32_t r = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (n0 + i < N && g0 + g < G)
            r |= (uint32_t)(valid ? __ldg(valid + (size_t)(g0 + g) * N + n0 + i)
                                  : 1) << (8 * i);
        t.vraw[u][g] = r;
      }
    }
  }
}

// bit i: element i of the lane is in range and valid (out-of-range bytes
// were loaded as 0)
__device__ __forceinline__ uint32_t keep_bits(uint32_t vraw) {
  return (vraw & 0xffu ? 1u : 0u) | (vraw & 0xff00u ? 2u : 0u) |
         (vraw & 0xff0000u ? 4u : 0u) | (vraw & 0xff000000u ? 8u : 0u);
}

// The lane's elements above thr, and equal to it, among those it keeps.
__device__ __forceinline__ void classify(const float (&x)[4], uint32_t keep,
                                         float thr, uint32_t& gt,
                                         uint32_t& eq) {
  gt = eq = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const bool k = (keep >> i) & 1;
    gt |= (uint32_t)(k && x[i] > thr) << i;
    eq |= (uint32_t)(k && x[i] == thr) << i;
  }
}

__device__ __forceinline__ float pick(const float (&x)[4], int i) {
  return i == 0 ? x[0] : i == 1 ? x[1] : i == 2 ? x[2] : x[3];
}

// ---------------------------------------------------------------------------
// k <= 32: the top-k in registers
// ---------------------------------------------------------------------------

struct RegList {
  float v;      // lane i: the i-th largest value seen (-inf past nreal)
  float kth;    // v of lane k-1
  int extra;    // elements seen equal to kth and not in the list
  int nreal;    // finite values in the list (min(k, seen))
};

// Insert c > l.kth: rank by ballot, shift by shuffle. The evicted k-th value
// (when the list was full) either ties the new k-th value and joins `extra`,
// or lies below it and is gone with every element equal to it.
__device__ __forceinline__ void reg_insert(RegList& l, float c, int k,
                                           int lane) {
  const int pos = __popc(__ballot_sync(kFull, lane < k && l.v >= c));
  const float up = __shfl_up_sync(kFull, l.v, 1);
  l.v = lane < pos ? l.v : lane == pos ? c : lane < k ? up : -INFINITY;
  const float kth = __shfl_sync(kFull, l.v, k - 1);
  l.extra = kth == l.kth ? l.extra + (l.nreal == k) : 0;
  l.nreal = min(l.nreal + 1, k);
  l.kth = kth;
}

// Descending bitonic sort of the warp's 128 values a[i] of lane l, at
// position i * 32 + l. Compare-and-select keeps every step a permutation.
__device__ __forceinline__ void sort128_desc(float (&a)[4], int lane) {
#pragma unroll
  for (int size = 2; size <= 128; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool desc = ((i * 32 + lane) & size) == 0;
        if (stride >= 32) {
          const int j = i | (stride >> 5);
          if (j == i) continue;
          const float lo = a[i], hi = a[j];
          const bool swap = desc ? hi > lo : hi < lo;
          a[i] = swap ? hi : lo;
          a[j] = swap ? lo : hi;
        } else {
          const float y = __shfl_xor_sync(kFull, a[i], stride);
          const bool keep_max = ((lane & stride) == 0) == desc;
          a[i] = keep_max ? (y > a[i] ? y : a[i]) : (y < a[i] ? y : a[i]);
        }
      }
    }
  }
}

// Bulk insert of a chunk with many survivors (the warm-up, mostly): sort the
// chunk, then merge its top 32 with the list by one bitonic merge. `extra`
// must already count the chunk's elements equal to the old kth. Out of line,
// with everything passed by value: one copy of the sorting network, and the
// callers' lists stay in registers.
__device__ __noinline__ RegList reg_merge(RegList l, float x0, float x1,
                                          float x2, float x3, uint32_t gt,
                                          int k, int lane) {
  float a[4] = {x0, x1, x2, x3};
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = (gt >> i) & 1 ? a[i] : -INFINITY;
  const int ns = __reduce_add_sync(kFull, __popc(gt));
  sort128_desc(a, lane);
  // list (descending) against the chunk's top 32 reversed: the larger of
  // each pair is a bitonic sequence holding the top 32 of the union
  const float t = __shfl_sync(kFull, a[0], 31 - lane);
  float c = t > l.v ? t : l.v;
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1) {
    const float y = __shfl_xor_sync(kFull, c, stride);
    c = (lane & stride) == 0 ? (y > c ? y : c) : (y < c ? y : c);
  }
  const float v = lane < k ? c : -INFINITY;
  const float kth = __shfl_sync(kFull, v, k - 1);
  if (kth != -INFINITY) {
    // equal to the new kth: in list or chunk, less those kept, plus the
    // old extras when kth did not move
    int in_union = __popc(__ballot_sync(kFull, l.v == kth));
#pragma unroll
    for (int i = 0; i < 4; ++i) in_union += __popc(__ballot_sync(kFull, a[i] == kth));
    const int kept = __popc(__ballot_sync(kFull, v == kth));
    l.extra = in_union - kept + (kth == l.kth ? l.extra : 0);
  }
  l.nreal = min(l.nreal + ns, k);
  l.v = v;
  l.kth = kth;
  return l;
}

template <int GL>
__global__ void __launch_bounds__(kRowsPerCta * 32)
block_topk_reg_kernel(const float* __restrict__ sim, long long sim_gstride,
                const uint8_t* __restrict__ valid, float* __restrict__ vals,
                int* __restrict__ kcnt, int P, int N, int G, int k, int vec) {
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * kRowsPerCta + (threadIdx.x >> 5);
  const int g0 = blockIdx.y * GL;  // the CTA's first group
  if (p >= P) return;
  const float* row = sim + (size_t)g0 * sim_gstride + (size_t)p * N;

  RegList st[GL];
#pragma unroll
  for (int g = 0; g < GL; ++g) st[g] = {-INFINITY, -INFINITY, 0, 0};

  // the next step's loads are issued before this one is processed
  constexpr int kStep = kChunk * kUnroll;
  Step<GL> cur, nxt;
  load_step<GL>(cur, row, valid, g0, G, N, 0, lane, vec);
  for (int base = 0; base < N; base += kStep) {
    if (base + kStep < N)
      load_step<GL>(nxt, row, valid, g0, G, N, base + kStep, lane, vec);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float (&x)[4] = cur.x[u];
#pragma unroll
      for (int g = 0; g < GL; ++g) {
        RegList& l = st[g];
        const uint32_t keep = keep_bits(cur.vraw[u][g]);
        // one vote on the lane's largest kept element
        float mx = -INFINITY;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          mx = (keep >> i) & 1 && x[i] > mx ? x[i] : mx;
        if (!__any_sync(kFull, keep != 0 && mx >= l.kth)) continue;
        uint32_t gt, eq;
        classify(x, keep, l.kth, gt, eq);
        l.extra += __reduce_add_sync(kFull, __popc(eq));
        if (__reduce_add_sync(kFull, __popc(gt)) > kBulk) {
          l = reg_merge(l, x[0], x[1], x[2], x[3], gt, k, lane);
          continue;
        }
        // a few survivors: one at a time, re-tested as kth rises
        for (unsigned lanes; (lanes = __ballot_sync(kFull, gt != 0));) {
          const int src = __ffs(lanes) - 1;
          const float c = __shfl_sync(kFull, pick(x, __ffs(gt) - 1), src);
          if (lane == src) gt &= gt - 1;
          if (c > l.kth)
            reg_insert(l, c, k, lane);
          else if (c == l.kth)
            ++l.extra;
        }
      }
    }
    cur = nxt;
  }

#pragma unroll
  for (int g = 0; g < GL; ++g) {
    if (g0 + g >= G) break;
    const RegList& l = st[g];
    const size_t r = (size_t)(g0 + g) * P + p;
    if (lane < k) vals[r * k + lane] = l.v;
    // list entries equal to kth are finite (-inf never enters the list)
    const int in_list =
        __popc(__ballot_sync(kFull, lane < l.nreal && l.v == l.kth));
    if (kcnt && lane == 0) kcnt[r] = l.extra + in_list;
  }
}

// ---------------------------------------------------------------------------
// 32 < k <= 512: a shared-memory buffer with a flush path
// ---------------------------------------------------------------------------

// Descending bitonic sort of n (a power of two, >= 64) keys in shared memory
// by one warp.
__device__ void warp_sort_desc(float* key, int n, int lane) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = lane; t < (n >> 1); t += 32) {
        const int i = 2 * t - (t & (stride - 1));
        const int j = i + stride;
        const bool desc = (i & size) == 0;
        const float a = key[i], b = key[j];
        if (desc ? a < b : a > b) {
          key[i] = b;
          key[j] = a;
        }
      }
      __syncwarp();
    }
  }
}

struct BufState {
  float thr;  // the row's k-th value so far (-inf until k values were seen)
  int eq;     // elements seen equal to thr
  int m;      // buffered elements, all strictly above thr
};

// Flush path: sort the buffer and, once it holds k values, raise thr to its
// k-th value; leaves at most k-1 buffered values, sorted. (The state goes by
// value so that the caller's per-group states stay in registers.)
__device__ BufState compact(float* buf, int cap, int k, BufState s,
                            int lane) {
  for (int t = s.m + lane; t < cap; t += 32) buf[t] = -INFINITY;
  __syncwarp();
  warp_sort_desc(buf, cap, lane);
  if (s.m >= k) {
    const float kth = buf[k - 1];
    int above = 0, equal = 0;
    for (int t = lane; t < s.m; t += 32) {
      above += buf[t] > kth;
      equal += buf[t] == kth;
    }
    s.thr = kth;  // > the old thr: the buffer held values above it only
    s.eq = __reduce_add_sync(kFull, equal);
    s.m = __reduce_add_sync(kFull, above);
  }
  __syncwarp();
  return s;
}

template <int GL>
__global__ void __launch_bounds__(kRowsPerCta * 32)
block_topk_buf_kernel(const float* __restrict__ sim, long long sim_gstride,
                const uint8_t* __restrict__ valid, float* __restrict__ vals,
                int* __restrict__ kcnt, int P, int N, int G, int k, int cap,
                int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * kRowsPerCta + warp;
  const int g0 = blockIdx.y * GL;
  if (p >= P) return;
  float* bufs = reinterpret_cast<float*>(smem) + (size_t)warp * GL * cap;
  const float* row = sim + (size_t)g0 * sim_gstride + (size_t)p * N;

  BufState st[GL];
#pragma unroll
  for (int g = 0; g < GL; ++g) st[g] = {-INFINITY, 0, 0};

  for (int base = 0; base < N; base += kChunk * kUnroll) {
    Step<GL> t;
    load_step<GL>(t, row, valid, g0, G, N, base, lane, vec);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float (&x)[4] = t.x[u];
#pragma unroll
      for (int g = 0; g < GL; ++g) {
        BufState& s = st[g];
        const uint32_t keep = keep_bits(t.vraw[u][g]);
        uint32_t gt, eq;
        classify(x, keep, s.thr, gt, eq);
        if (!__any_sync(kFull, (gt | eq) != 0)) continue;
        float* buf = bufs + (size_t)g * cap;
        if (s.m > cap - kChunk) {
          // the chunk could overflow the buffer: flush, then re-test the
          // chunk against the raised thr
          s = compact(buf, cap, k, s, lane);
          classify(x, keep, s.thr, gt, eq);
        }
        // exclusive prefix of the lanes' survivor counts
        const int c = __popc(gt);
        int incl = c;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int y = __shfl_up_sync(kFull, incl, d);
          if (lane >= d) incl += y;
        }
        int pos = s.m + incl - c;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if ((gt >> i) & 1) buf[pos++] = x[i];
        s.m += __shfl_sync(kFull, incl, 31);
        s.eq += __reduce_add_sync(kFull, __popc(eq));
        __syncwarp();
      }
    }
  }

  // sorted buffer (values above thr), then thr eq times, then -inf: once k
  // values were seen m + eq >= k and thr is the k-th value; before that thr
  // is -inf and eq counts the valid -inf elements. Either way kcnt = eq.
#pragma unroll
  for (int g = 0; g < GL; ++g) {
    if (g0 + g >= G) break;
    const BufState s = compact(bufs + (size_t)g * cap, cap, k, st[g], lane);
    const size_t r = (size_t)(g0 + g) * P + p;
    const float* buf = bufs + (size_t)g * cap;
    for (int t = lane; t < k; t += 32)
      vals[r * k + t] = t < s.m ? buf[t] : t < s.m + s.eq ? s.thr : -INFINITY;
    if (kcnt && lane == 0) kcnt[r] = s.eq;
  }
}

int pow2_at_least(int x) {
  int p = 64;
  while (p < x) p <<= 1;
  return p;
}

template <int GL>
int launch(const float* sim, long long sim_gstride, const uint8_t* valid,
           float* vals, int* kcnt, int P, int N, int G, int k,
           cudaStream_t stream) {
  const int vec = N % 4 == 0 && sim_gstride % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(sim) % 16 == 0 &&
                  (!valid || reinterpret_cast<uintptr_t>(valid) % 4 == 0);
  const dim3 grid((P + kRowsPerCta - 1) / kRowsPerCta, (G + GL - 1) / GL);
  if (k <= 32) {
    block_topk_reg_kernel<GL><<<grid, kRowsPerCta * 32, 0, stream>>>(
        sim, sim_gstride, valid, vals, kcnt, P, N, G, k, vec);
    return (int)cudaGetLastError();
  }
  const int cap = pow2_at_least(k + kChunk);
  const size_t bytes = (size_t)kRowsPerCta * GL * cap * 4;
  if (bytes > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      block_topk_buf_kernel<GL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return (int)e;
  block_topk_buf_kernel<GL><<<grid, kRowsPerCta * 32, bytes, stream>>>(
      sim, sim_gstride, valid, vals, kcnt, P, N, G, k, cap, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// sim_gstride == 0: shared mode, sim [P, N], valid [G, N], groups in chunks
//                   of `width` (1..8) on the grid's second dimension.
// sim_gstride > 0:  grouped mode, sim [G, P, N] (group g at g * sim_gstride),
//                   valid must be null, width 1. kcnt may be null.
extern "C" int block_topk_launch(const float* sim, long long sim_gstride,
                                 const uint8_t* valid, float* vals, int* kcnt,
                                 int P, int N, int G, int k, int width,
                                 void* stream) {
  if (P <= 0 || G <= 0 || k <= 0 || N <= 0) return 0;
  if (width < 1 || width > kMaxGroups || k > 512 ||
      (G + width - 1) / width > 65535 ||
      (sim_gstride != 0 && (valid != nullptr || width != 1)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define XMEM_CASE(n) \
  case n: return launch<n>(sim, sim_gstride, valid, vals, kcnt, P, N, G, k, s);
  switch (width) {
    XMEM_CASE(1) XMEM_CASE(2) XMEM_CASE(3) XMEM_CASE(4)
    XMEM_CASE(5) XMEM_CASE(6) XMEM_CASE(7) XMEM_CASE(8)
    default: return (int)cudaErrorInvalidValue;
  }
#undef XMEM_CASE
}
