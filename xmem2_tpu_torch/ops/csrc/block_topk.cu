// Per-block exact top-k candidate values (K2).
//
// Replaces: xmem2_tpu/ops/readout_kernel.py `_make_cand_kernel` (the Pallas
// kernel launched by `block_topk_candidates`).
//
// Contract: sim [P, N] f32, valid [G, N] bool (one byte per slot) ->
// out [G, P, nb * k] f32, nb = ceil(N / 512). For every (group, query row,
// 512-slot block) the k largest values among the group's valid slots, sorted
// descending, each value repeated as often as it occurs (tie multiplicities),
// and -inf past the block's valid count. Slots at or past N are invalid, so
// the ragged edge of the last block is masked here by a bounds check and no
// caller pads the similarity.
//
// Bound on this card: bytes. Every similarity element is read once (223 MB at
// P = 1620 rows and N = 34k slots) and the output is k/512 of that; the work
// per element is a handful of compares. Design: one warp owns one (row, block)
// pair, holds the block's 512 values in registers (16 a lane, loaded so that a
// warp reads 128 contiguous bytes at a time), and runs k rounds of warp-wide
// max and tie-count reductions with shuffles. Blocks carry nothing between
// them, so each (row tile, block, group) is an independent CTA and the grid
// fills the card without any cross-CTA reduction. Only selection happens
// here, so the result is bit-identical to the plain version.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockN = 512;            // slots per candidate block (contract)
constexpr int kPerLane = kBlockN / 32;  // values a lane holds
constexpr int kWarps = 8;               // query rows per CTA

__global__ void __launch_bounds__(kWarps * 32)
block_topk_kernel(const float* __restrict__ sim,
                  const uint8_t* __restrict__ valid,
                  float* __restrict__ out, int P, int N, int k, int nb) {
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int b = blockIdx.y;
  const int g = blockIdx.z;
  if (p >= P) return;

  const float* row = sim + (size_t)p * N;
  const uint8_t* vrow = valid + (size_t)g * N;
  const int n0 = b * kBlockN;

  float v[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int n = n0 + i * 32 + lane;
    v[i] = (n < N && vrow[n]) ? row[n] : -INFINITY;
  }

  float* dst = out + (((size_t)g * P + p) * nb + b) * k;
  int cum = 0;
  while (cum < k) {
    float m = v[0];
#pragma unroll
    for (int i = 1; i < kPerLane; ++i) m = fmaxf(m, v[i]);
#pragma unroll
    for (int s = 16; s > 0; s >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, s));
    if (m == -INFINITY) {
      // everything left is invalid: the rest of the k slots are -inf
      for (int t = cum + lane; t < k; t += 32) dst[t] = -INFINITY;
      break;
    }
    int c = 0;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      if (v[i] == m) {
        ++c;
        v[i] = -INFINITY;
      }
    }
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) c += __shfl_xor_sync(0xffffffffu, c, s);
    const int end = min(cum + c, k);
    for (int t = cum + lane; t < end; t += 32) dst[t] = m;
    cum += c;
  }
}

}  // namespace

extern "C" int block_topk_launch(const float* sim, const uint8_t* valid,
                                 float* out, int P, int N, int G, int k,
                                 void* stream) {
  const int nb = (N + kBlockN - 1) / kBlockN;
  if (P <= 0 || nb <= 0 || G <= 0 || k <= 0) return 0;
  dim3 grid((P + kWarps - 1) / kWarps, nb, G);
  block_topk_kernel<<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(
      sim, valid, out, P, N, k, nb);
  return (int)cudaGetLastError();
}
