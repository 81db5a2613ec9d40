// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel library exposes a plain C interface (loaded with ctypes by
// tensorflowonspark_tpu_torch/ops/_build.py): entry points take raw device
// pointers and the caller's stream, launch, and return cudaGetLastError() so
// the Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace tos {

// dtype codes shared with the Python wrappers (ops/_build.py DTYPE_CODES)
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

// the TPU kernels' mask value: finite, so masked rows never produce NaN
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as PyTorch casts
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// floor division for possibly negative numerators (Python's //)
__host__ __device__ __forceinline__ int floor_div(int a, int b) {
  int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

__host__ __device__ __forceinline__ int clamp_int(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// The tile width the flash-attention kernels are built for: a head_dim d with
// 8 <= d <= 128 and d % 8 == 0 runs padded to 64 columns (d <= 64) or to 128;
// 0 for a head_dim they do not take. The columns past d are zeros in every
// staged tile and are never stored, so the padding changes no result.
__host__ __device__ __forceinline__ int padded_head_dim(int d) {
  if (d < 8 || d > 128 || d % 8 != 0) return 0;
  return d <= 64 ? 64 : 128;
}

}  // namespace tos

extern "C" const char* tos_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
