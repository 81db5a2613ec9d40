// The Delta pre-pass of the flash-attention backward, shared by both plans
// (flash_attention_bwd.cu, the fused plan; flash_attention_bwd_split.cu, the
// split plan). The JAX package computes the same sum in XLA before its
// backward kernels (tensorflowonspark_tpu/ops/flash_attention.py _bwd_impl
// :576-578):
//   Delta[b, h, s] = sum_d dO[b, s, h, d] * O[b, s, h, d]  - g_lse[b, h, s]
// (the lse cotangent folds in with the opposite sign; null g_lse means none).
// One warp per (b, s, h) row; f32 sum of the products in lane order.
#pragma once

#include "common.cuh"

namespace tos {
namespace {

constexpr int kDeltaThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kDeltaThreads)
    flash_bwd_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                           const float* __restrict__ g_lse, float* __restrict__ delta,
                           long rows, int sq, int h, int d) {
  const int lane = threadIdx.x & 31;
  const long row = static_cast<long>(blockIdx.x) * (kDeltaThreads / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;  // row = (b * sq + s) * h + head
  float acc = 0.f;
  for (int c = lane; c < d; c += 32)
    acc += to_float(dout[row * d + c]) * to_float(out[row * d + c]);
  acc = warp_sum(acc);
  const long b = row / (static_cast<long>(sq) * h);
  const int s = static_cast<int>((row / h) % sq);
  const int head = static_cast<int>(row % h);
  const long idx = (b * h + head) * sq + s;  // [b, h, sq]
  if (lane == 0) delta[idx] = g_lse ? acc - g_lse[idx] : acc;
}

// Launches the pre-pass on `stream` over out, dout [b, sq, h, d] (contiguous,
// in T); returns cudaGetLastError().
template <typename T>
cudaError_t launch_flash_bwd_delta(const void* out, const void* dout, const float* g_lse,
                                   float* delta, int b, int sq, int h, int d,
                                   cudaStream_t stream) {
  const long rows = static_cast<long>(b) * sq * h;
  const int warps = kDeltaThreads / 32;
  flash_bwd_delta_kernel<T><<<static_cast<unsigned>((rows + warps - 1) / warps), kDeltaThreads,
                              0, stream>>>(static_cast<const T*>(out),
                                           static_cast<const T*>(dout), g_lse, delta, rows,
                                           sq, h, d);
  return cudaGetLastError();
}

}  // namespace
}  // namespace tos
