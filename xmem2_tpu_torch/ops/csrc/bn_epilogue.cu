// Frozen batch norm with an optional residual add and ReLU, in one pass
// (bn_epilogue).
//
// Replaces no TPU kernel: the JAX package leaves batch norm to XLA, which
// fuses the scale, the shift, the residual add and the ReLU into the
// convolution's output. On the card the port ran them as a chain of PyTorch
// kernels a batch norm: five small ones for scale and shift, then a bf16 ->
// f32 copy, an f32 multiply, an f32 add and an f32 -> bf16 copy over the
// whole activation (28 bytes an element in bf16), then a ReLU and, at the
// end of a residual block, an add and another ReLU.
//
// Contract: x [N, C, H, W], bf16 or f32, contiguous in NCHW order; weight,
// bias, mean, var [C] f32; residual (or null) and out of x's shape, dtype
// and order. Per channel c:
//     r     = rsqrtf(var[c] + eps)
//     scale = weight[c] * r,   shift = bias[c] - mean[c] * scale
// and per element, each operation rounded on its own (no FMA contraction):
//     y = to_T(x * scale + shift)          (multiply, then add, in f32)
//     y = to_T(y + residual)               (in f32, where there is one)
//     y = y < 0 ? 0 : y                    (where relu)
// where to_T rounds to x's dtype, to nearest even. These are the operations,
// in order, of nn/functional.batch_norm followed by `+ residual` and
// torch.relu, so the output equals that composition bit for bit.
//
// Bound on this card: bytes. A few flops an element against 4 bytes read and
// written in bf16 (6 with a residual), far below the ~295 flops a byte where
// the tensor cores would bound it: the least time is (input + residual +
// output bytes) / 3.35 TB/s. Design:
//   * One pass: the element is read once, the residual once, the result
//     written once; scale and shift never reach device memory.
//   * A CTA owns a tile of one (n, c) plane of the contiguous tensor, so its
//     channel is one integer division of its block index, and it computes the
//     plane's scale and shift itself in registers: no separate launches.
//   * Vector loads and stores of V elements, V chosen by the wrapper as the
//     widest of 16 bytes or less that divides the plane (H * W) and fits the
//     pointers' alignment: 16-byte vectors for the trunk's planes at 480p
//     (103,680 / 25,920 / 6,480 elements), 8-byte ones for 1,620 in bf16,
//     single elements for a ragged plane. No vector crosses a plane.
//   * Each thread keeps kUnroll vectors of input (and residual) in flight
//     before it computes, so a tile's loads overlap.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;                  // vectors a thread loads at once
constexpr int kTile = kThreads * kUnroll;   // vectors a CTA handles

struct Bf16 {
  using Bits = unsigned short;
  static __device__ __forceinline__ float load(Bits b) {
    return __uint_as_float(static_cast<unsigned>(b) << 16);
  }
  static __device__ __forceinline__ Bits store(float f) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(f));
  }
};

struct F32 {
  using Bits = float;
  static __device__ __forceinline__ float load(Bits b) { return b; }
  static __device__ __forceinline__ Bits store(float f) { return f; }
};

template <typename Bits, int V>
struct alignas(sizeof(Bits) * V) Pack {
  Bits v[V];
};

// One element: norm, rounded to T; + the residual r where there is one,
// rounded; ReLU.
template <typename T>
__device__ __forceinline__ typename T::Bits apply(typename T::Bits x,
                                                  float scale, float shift,
                                                  bool residual,
                                                  typename T::Bits r,
                                                  bool relu) {
  typename T::Bits y = T::store(__fadd_rn(__fmul_rn(T::load(x), scale),
                                          shift));
  if (residual) y = T::store(__fadd_rn(T::load(y), T::load(r)));
  if (relu && T::load(y) < 0.f) y = T::store(0.f);
  return y;
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads) bn_epilogue_kernel(
    const typename T::Bits* __restrict__ x, const float* __restrict__ weight,
    const float* __restrict__ bias, const float* __restrict__ mean,
    const float* __restrict__ var, const typename T::Bits* __restrict__ res,
    typename T::Bits* __restrict__ out, int C, int plane_vecs,
    int tiles_per_plane, float eps, bool relu) {
  using Bits = typename T::Bits;
  using P = Pack<Bits, V>;
  const long long plane = blockIdx.x / tiles_per_plane;
  const int tile = static_cast<int>(blockIdx.x - plane * tiles_per_plane);
  const int c = static_cast<int>(plane % C);
  const float r = rsqrtf(__fadd_rn(var[c], eps));
  const float scale = __fmul_rn(weight[c], r);
  const float shift = __fsub_rn(bias[c], __fmul_rn(mean[c], scale));

  const long long base = plane * plane_vecs;
  const P* xp = reinterpret_cast<const P*>(x) + base;
  const P* rp = res ? reinterpret_cast<const P*>(res) + base : nullptr;
  P* op = reinterpret_cast<P*>(out) + base;
  const int first = tile * kTile + threadIdx.x;

  P in[kUnroll], add[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int i = first + u * kThreads;
    if (i < plane_vecs) {
      in[u] = xp[i];
      if (rp) add[u] = rp[i];
    }
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int i = first + u * kThreads;
    if (i >= plane_vecs) continue;
    P o;
#pragma unroll
    for (int j = 0; j < V; ++j)
      o.v[j] = apply<T>(in[u].v[j], scale, shift, rp != nullptr, add[u].v[j],
                        relu);
    op[i] = o;
  }
}

template <typename T, int V>
int launch(const void* x, const float* weight, const float* bias,
           const float* mean, const float* var, const void* res, void* out,
           int planes, int C, int hw, float eps, int relu,
           cudaStream_t stream) {
  using Bits = typename T::Bits;
  const int plane_vecs = hw / V;
  const int tiles = (plane_vecs + kTile - 1) / kTile;
  const long long blocks = static_cast<long long>(planes) * tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  bn_epilogue_kernel<T, V><<<static_cast<unsigned>(blocks), kThreads, 0,
                             stream>>>(
      static_cast<const Bits*>(x), weight, bias, mean, var,
      static_cast<const Bits*>(res), static_cast<Bits*>(out), C, plane_vecs,
      tiles, eps, relu != 0);
  return (int)cudaGetLastError();
}

}  // namespace

// planes = N * C, hw = H * W. dtype: 0 bf16, 1 f32. vec: elements a
// vector, at most 16 bytes; it divides hw, and the wrapper has checked that
// x, res and out are aligned to it. res may be null. Returns a CUDA error
// code, 0 on success.
extern "C" int bn_epilogue_launch(const void* x, const float* weight,
                                  const float* bias, const float* mean,
                                  const float* var, const void* res, void* out,
                                  int planes, int C, int hw, float eps,
                                  int relu, int dtype, int vec,
                                  void* stream) {
  if (planes < 0 || C <= 0 || hw < 0 || vec <= 0 || planes % C != 0 ||
      hw % vec != 0)
    return (int)cudaErrorInvalidValue;
  if (planes == 0 || hw == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
#define XMEM_CASE(T, n)                                                     \
  case n:                                                                   \
    return launch<T, n>(x, weight, bias, mean, var, res, out, planes, C,   \
                        hw, eps, relu, s);
  if (dtype == 0) {
    switch (vec) {
      XMEM_CASE(Bf16, 1) XMEM_CASE(Bf16, 2) XMEM_CASE(Bf16, 4)
      XMEM_CASE(Bf16, 8)
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (dtype == 1) {
    switch (vec) {
      XMEM_CASE(F32, 1) XMEM_CASE(F32, 2) XMEM_CASE(F32, 4)
      default: return (int)cudaErrorInvalidValue;
    }
  }
#undef XMEM_CASE
  return (int)cudaErrorInvalidValue;
}
