// Streamed top-k softmax readout (K1) and its group-0 usage pass.
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
// The ragged memory edge (n >= N) and the ragged query edge (p >= P) are
// masked by bounds checks, so no operand needs padding. (The JAX package
// pads the similarity but not the values, readout_kernel.py:450, and its
// kernel reads value blocks past their end.)
//
// The TPU grid ran in order and carried the readout sum across memory blocks
// and the usage sum across query blocks. Here CTAs run in no order, so:
//   * a readout CTA owns a 64-row query tile, one object and a 128-channel
//     slice and loops over the memory tiles itself (no carry between CTAs);
//   * usage is a reduction over queries, so it is its own kernel whose CTAs
//     own 32 memory slots and loop over query rows; the 8 row-partials of a
//     slot are added in a fixed order, so usage is deterministic (it ranks
//     prototypes at consolidation).
//
// Bound on this card: bytes. The work the data needs is only the ~k nonzero
// weights per row, while the similarity (223 MB at P = 1620, N = 34k) has to
// be read once. This first design is a dense SIMT product over all N slots
// (2 * P * N * Cv flops per object), so it is bound by f32 FMA throughput, far
// above the byte bound; the sparse redesign (gather the rows with
// sim >= tau) is the lever for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kQT = 64;    // query rows per CTA
constexpr int kCT = 128;   // value channels per CTA
constexpr int kNT = 32;    // memory slots per step
constexpr int kThreads = 256;
constexpr int kMaxObjects = 64;

struct GroupIds {
  int g[kMaxObjects];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename VT>
__global__ void __launch_bounds__(kThreads)
topk_readout_kernel(const float* __restrict__ sim, const VT* __restrict__ values,
                    const uint8_t* __restrict__ valid,
                    const float* __restrict__ tau,
                    const float* __restrict__ rmax,
                    const float* __restrict__ invz, float* __restrict__ out,
                    int P, int N, int Cv, int G, GroupIds gids) {
  // +1 column: the weight tile is written transposed, one column per warp
  __shared__ float ws[kNT][kQT + 1];
  __shared__ __align__(16) float vs[kNT][kCT];

  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * kCT;
  const int p0 = blockIdx.y * kQT;
  const int o = blockIdx.z;
  const int g = gids.g[o];
  constexpr bool kBf16 = sizeof(VT) == 2;

  // weight-tile loads: lane lj reads slot n0 + lj of rows lr, lr + 8, ...
  const int lj = tid & 31;
  const int lr = tid >> 5;
  float t_[kQT / 8], m_[kQT / 8], z_[kQT / 8];
  bool rok[kQT / 8];
#pragma unroll
  for (int i = 0; i < kQT / 8; ++i) {
    const int p = p0 + lr + 8 * i;
    rok[i] = p < P;
    t_[i] = rok[i] ? tau[(size_t)p * G + g] : INFINITY;
    m_[i] = rok[i] ? rmax[(size_t)p * G + g] : 0.f;
    z_[i] = rok[i] ? invz[(size_t)p * G + g] : 0.f;
  }

  // compute mapping: 4 rows x 8 channels a thread; the 8 channels are two
  // float4 runs 64 apart so that 16 threads read 64 contiguous floats
  const int tx = tid & 15;
  const int ty = tid >> 4;
  float acc[4][8];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;

  const VT* vbase = values + (size_t)o * N * Cv;
  const uint8_t* vrow = valid + (size_t)g * N;
  const int vc = tid & (kCT - 1);
  const int vr = tid / kCT;

  for (int n0 = 0; n0 < N; n0 += kNT) {
    const int n = n0 + lj;
    const bool nok = n < N && vrow[n];
#pragma unroll
    for (int i = 0; i < kQT / 8; ++i) {
      float w = 0.f;
      if (nok && rok[i]) {
        const float s = sim[(size_t)(p0 + lr + 8 * i) * N + n];
        if (s >= t_[i]) {
          w = expf(s - m_[i]) * z_[i];
          if (kBf16) w = __bfloat162float(__float2bfloat16(w));
        }
      }
      ws[lj][lr + 8 * i] = w;
    }
#pragma unroll
    for (int i = 0; i < kNT / (kThreads / kCT); ++i) {
      const int j = vr + (kThreads / kCT) * i;
      const int nn = n0 + j;
      const int c = c0 + vc;
      vs[j][vc] = (nn < N && c < Cv) ? to_f32(vbase[(size_t)nn * Cv + c]) : 0.f;
    }
    __syncthreads();

#pragma unroll 8
    for (int j = 0; j < kNT; ++j) {
      float a[4], b[8];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = ws[j][ty * 4 + r];
      const float4 b0 = *reinterpret_cast<const float4*>(&vs[j][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&vs[j][64 + tx * 4]);
      b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
      b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int p = p0 + ty * 4 + r;
    if (p >= P) continue;
    float* orow = out + ((size_t)o * P + p) * Cv;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int ch = c0 + (c < 4 ? tx * 4 + c : 64 + tx * 4 + (c - 4));
      if (ch < Cv) orow[ch] = acc[r][c];
    }
  }
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

}  // namespace

extern "C" int topk_readout_launch(const float* sim, const void* values,
                                   int values_bf16, const uint8_t* valid,
                                   const float* tau, const float* rmax,
                                   const float* invz, const int* group_ids,
                                   int O, float* out, int P, int N, int Cv,
                                   int G, void* stream) {
  if (O > kMaxObjects) return (int)cudaErrorInvalidValue;
  if (P <= 0 || O <= 0 || Cv <= 0) return 0;
  GroupIds gids;
  for (int o = 0; o < kMaxObjects; ++o) gids.g[o] = o < O ? group_ids[o] : 0;
  dim3 grid((Cv + kCT - 1) / kCT, (P + kQT - 1) / kQT, O);
  cudaStream_t s = (cudaStream_t)stream;
  if (values_bf16) {
    topk_readout_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        sim, (const __nv_bfloat16*)values, valid, tau, rmax, invz, out, P, N,
        Cv, G, gids);
  } else {
    topk_readout_kernel<float><<<grid, kThreads, 0, s>>>(
        sim, (const float*)values, valid, tau, rmax, invz, out, P, N, Cv, G,
        gids);
  }
  return (int)cudaGetLastError();
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
