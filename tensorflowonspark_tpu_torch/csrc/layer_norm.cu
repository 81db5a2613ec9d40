// LayerNorm (no bias) for Hopper: the forward y = (x - mean) * rsqrt(var + eps) * w
// and its backward (dx, dw).
//
// Forward. Replaces: tensorflowonspark_tpu/ops/layer_norm.py _ln_fwd_kernel (the
// Pallas kernel launched by _ln_fwd). Same arithmetic: f32 statistics over bf16
// or f32 rows, the CENTERED variance mean((x - mean)^2), output in x's dtype.
//
// Bound on the H100: device memory. Each row is read once and written once
// (rows * H * itemsize bytes each way, plus the H f32 weights) against about
// eight flops per element, far under the card's flops-per-byte balance.
//
// Design: one warp per row, four rows per 128-thread block, so the whole
// reduction is warp shuffles with no shared memory or block barrier. Loads and
// stores are 16-byte vectors when the row width and pointers allow it. The row
// is walked three times (sum, centered squares, normalize); the second and
// third walks hit L1, so device memory still sees one read and one write.
// Rows are independent: no ordering between blocks is assumed. Rows wider
// than kWarpRowMax (8192) take a block per row instead (the *_wide kernels):
// 256 threads walk the row, and each sum is a warp sum followed by the warps'
// partial sums added in warp order, so every thread holds the same value.
//
// Backward. Replaces: tensorflowonspark_tpu/ops/layer_norm.py _ln_bwd_kernel
// (launched by _ln_bwd_rule). Same arithmetic: the row statistics are
// RECOMPUTED from x (nothing is saved by the forward), xhat = (x - mean) * rstd,
// dy = g * w, dx = rstd * (dy - mean(dy) - xhat * mean(dy * xhat)) in f32 and
// stored in x's dtype; dw = sum over rows of g * xhat, in f32.
//
// Bound on the H100: device memory again — x and g read once, dx written once,
// about twenty flops per element.
//
// Design. The TPU kernel carries dw across its sequential grid; here blocks run
// in parallel, so dw takes two passes and no atomics (the gradient must be
// bitwise reproducible): pass 1 runs a fixed grid of at most kMaxPartials
// 128-thread blocks, each warp walking rows warp, warp + 4 * grid, ... (one warp
// per row as in the forward) and adding g * xhat into its own f32 row of shared
// memory; each block then sums its four warp rows in order into one partial
// row of a [grid, H] f32 scratch. Pass 2 sums the partials in block order, one
// thread per column. The shared rows are laid out (pack, element, lane) so the
// 32 lanes of a warp touch 32 consecutive floats: no bank conflicts. Rows
// wider than kWarpRowMax take a block per row (layer_norm_bwd_wide_kernel):
// the same grid of partial rows, each block walking rows blockIdx.x, +grid,
// ... and adding g * xhat straight into its partial row in device memory,
// each column always by the same thread (no shared row, no atomics).

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kRowsPerBlock = 4;
constexpr int kWarpRowMax = 8192;   // widest row of the warp-per-row kernels
constexpr int kWideThreads = 256;   // block per row past it

template <typename T, int VW>
struct alignas(sizeof(T) * VW) Pack {
  T v[VW];
};

template <typename T, int VW>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
    layer_norm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                          T* __restrict__ y, int rows, int h, float eps) {
  const int lane = threadIdx.x & 31;
  const long row = static_cast<long>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + row * h;
  T* yr = y + row * h;
  using P = Pack<T, VW>;

  float sum = 0.f;
  for (int i = lane * VW; i < h; i += 32 * VW) {
    const P p = *reinterpret_cast<const P*>(xr + i);
#pragma unroll
    for (int j = 0; j < VW; ++j) sum += tos::to_float(p.v[j]);
  }
  const float mean = tos::warp_sum(sum) / h;

  float sq = 0.f;
  for (int i = lane * VW; i < h; i += 32 * VW) {
    const P p = *reinterpret_cast<const P*>(xr + i);
#pragma unroll
    for (int j = 0; j < VW; ++j) {
      const float d = tos::to_float(p.v[j]) - mean;
      sq += d * d;
    }
  }
  const float rstd = rsqrtf(tos::warp_sum(sq) / h + eps);

  for (int i = lane * VW; i < h; i += 32 * VW) {
    const P p = *reinterpret_cast<const P*>(xr + i);
    P o;
#pragma unroll
    for (int j = 0; j < VW; ++j)
      o.v[j] = tos::from_float<T>((tos::to_float(p.v[j]) - mean) * rstd * w[i + j]);
    *reinterpret_cast<P*>(yr + i) = o;
  }
}

template <typename T>
void launch(const void* x, const float* w, void* y, int rows, int h, float eps,
            cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const dim3 grid((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  const dim3 block(32 * kRowsPerBlock);
  const bool vec = (h % kVec == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(y) % 16 == 0);
  if (vec) {
    layer_norm_fwd_kernel<T, kVec><<<grid, block, 0, stream>>>(
        static_cast<const T*>(x), w, static_cast<T*>(y), rows, h, eps);
  } else {
    layer_norm_fwd_kernel<T, 1><<<grid, block, 0, stream>>>(
        static_cast<const T*>(x), w, static_cast<T*>(y), rows, h, eps);
  }
}

// The sum of v over the block's threads, the same bits in every thread: warp
// sums, then the warps' sums in warp order. `red` holds one float per warp.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = tos::warp_sum(v);
  __syncthreads();  // the previous sum's reads of red are done
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kWideThreads / 32; ++w) s += red[w];
  return s;
}

// a block per row, rows blockIdx.x, + gridDim.x, ...
template <typename T, int VW>
__global__ void __launch_bounds__(kWideThreads)
    layer_norm_fwd_wide_kernel(const T* __restrict__ x, const float* __restrict__ w,
                               T* __restrict__ y, int rows, int h, float eps) {
  __shared__ float red[kWideThreads / 32];
  using P = Pack<T, VW>;
  for (long row = blockIdx.x; row < rows; row += gridDim.x) {
    const T* xr = x + row * h;
    T* yr = y + row * h;
    float sum = 0.f;
    for (int i = threadIdx.x * VW; i < h; i += kWideThreads * VW) {
      const P p = *reinterpret_cast<const P*>(xr + i);
#pragma unroll
      for (int j = 0; j < VW; ++j) sum += tos::to_float(p.v[j]);
    }
    const float mean = block_sum(sum, red) / h;
    float sq = 0.f;
    for (int i = threadIdx.x * VW; i < h; i += kWideThreads * VW) {
      const P p = *reinterpret_cast<const P*>(xr + i);
#pragma unroll
      for (int j = 0; j < VW; ++j) {
        const float d = tos::to_float(p.v[j]) - mean;
        sq += d * d;
      }
    }
    const float rstd = rsqrtf(block_sum(sq, red) / h + eps);
    for (int i = threadIdx.x * VW; i < h; i += kWideThreads * VW) {
      const P p = *reinterpret_cast<const P*>(xr + i);
      P o;
#pragma unroll
      for (int j = 0; j < VW; ++j)
        o.v[j] = tos::from_float<T>((tos::to_float(p.v[j]) - mean) * rstd * w[i + j]);
      *reinterpret_cast<P*>(yr + i) = o;
    }
  }
}

template <typename T>
void launch_wide(const void* x, const float* w, void* y, int rows, int h, float eps,
                 cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const unsigned grid = static_cast<unsigned>(rows < 65535 ? rows : 65535);
  const bool vec = (h % kVec == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(y) % 16 == 0);
  if (vec)
    layer_norm_fwd_wide_kernel<T, kVec><<<grid, kWideThreads, 0, stream>>>(
        static_cast<const T*>(x), w, static_cast<T*>(y), rows, h, eps);
  else
    layer_norm_fwd_wide_kernel<T, 1><<<grid, kWideThreads, 0, stream>>>(
        static_cast<const T*>(x), w, static_cast<T*>(y), rows, h, eps);
}

// -- backward ------------------------------------------------------------------

constexpr int kMaxPartials = 256;  // pass-1 blocks: rows of the dw scratch

__host__ __device__ inline int acc_floats(int h, int vw) {
  // shared floats per warp: whole (pack, element, lane) groups covering h
  return (h + 32 * vw - 1) / (32 * vw) * 32 * vw;
}

template <typename T, int VW>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
    layer_norm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                          const T* __restrict__ g, T* __restrict__ dx,
                          float* __restrict__ partial, int rows, int h, float eps) {
  extern __shared__ float acc[];  // [kRowsPerBlock][acc_floats(h, VW)]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int per_warp = acc_floats(h, VW);
  float* my = acc + warp * per_warp;
  for (int i = lane; i < per_warp; i += 32) my[i] = 0.f;
  using P = Pack<T, VW>;
  // element i = t * 32 * VW + lane * VW + j lives at shared slot
  // (t * VW + j) * 32 + lane
  const long stride = static_cast<long>(gridDim.x) * kRowsPerBlock;
  for (long row = static_cast<long>(blockIdx.x) * kRowsPerBlock + warp; row < rows;
       row += stride) {
    const T* xr = x + row * h;
    const T* gr = g + row * h;
    T* dr = dx + row * h;

    float sum = 0.f;
    for (int i = lane * VW; i < h; i += 32 * VW) {
      const P p = *reinterpret_cast<const P*>(xr + i);
#pragma unroll
      for (int j = 0; j < VW; ++j) sum += tos::to_float(p.v[j]);
    }
    const float mean = tos::warp_sum(sum) / h;
    float sq = 0.f;
    for (int i = lane * VW; i < h; i += 32 * VW) {
      const P p = *reinterpret_cast<const P*>(xr + i);
#pragma unroll
      for (int j = 0; j < VW; ++j) {
        const float d = tos::to_float(p.v[j]) - mean;
        sq += d * d;
      }
    }
    const float rstd = rsqrtf(tos::warp_sum(sq) / h + eps);

    float s1 = 0.f, s2 = 0.f;  // sums of dy and dy * xhat
    for (int i = lane * VW; i < h; i += 32 * VW) {
      const P px = *reinterpret_cast<const P*>(xr + i);
      const P pg = *reinterpret_cast<const P*>(gr + i);
#pragma unroll
      for (int j = 0; j < VW; ++j) {
        const float xhat = (tos::to_float(px.v[j]) - mean) * rstd;
        const float dy = tos::to_float(pg.v[j]) * w[i + j];
        s1 += dy;
        s2 += dy * xhat;
      }
    }
    const float m1 = tos::warp_sum(s1) / h;
    const float m2 = tos::warp_sum(s2) / h;

    for (int i = lane * VW, t = 0; i < h; i += 32 * VW, ++t) {
      const P px = *reinterpret_cast<const P*>(xr + i);
      const P pg = *reinterpret_cast<const P*>(gr + i);
      P o;
#pragma unroll
      for (int j = 0; j < VW; ++j) {
        const float xhat = (tos::to_float(px.v[j]) - mean) * rstd;
        const float gv = tos::to_float(pg.v[j]);
        const float dy = gv * w[i + j];
        o.v[j] = tos::from_float<T>(rstd * (dy - m1 - xhat * m2));
        my[(t * VW + j) * 32 + lane] += gv * xhat;
      }
      *reinterpret_cast<P*>(dr + i) = o;
    }
  }
  __syncthreads();
  // this block's partial: its warps' rows summed in warp order
  float* out = partial + static_cast<long>(blockIdx.x) * h;
  for (int slot = threadIdx.x; slot < per_warp; slot += blockDim.x) {
    const int l = slot & 31, tj = slot >> 5;
    const int i = (tj / VW) * 32 * VW + l * VW + tj % VW;
    if (i >= h) continue;
    float s = 0.f;
#pragma unroll
    for (int wi = 0; wi < kRowsPerBlock; ++wi) s += acc[wi * per_warp + slot];
    out[i] = s;
  }
}

__global__ void layer_norm_dw_kernel(const float* __restrict__ partial,
                                     float* __restrict__ dw, int n_partial, int h) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= h) return;
  float s = 0.f;
  for (int p = 0; p < n_partial; ++p) s += partial[static_cast<long>(p) * h + col];
  dw[col] = s;
}

// a block per row (rows wider than kWarpRowMax): block blockIdx.x walks rows
// blockIdx.x, + gridDim.x, ... and adds g * xhat into its own partial row,
// each column always by the same thread
template <typename T, int VW>
__global__ void __launch_bounds__(kWideThreads)
    layer_norm_bwd_wide_kernel(const T* __restrict__ x, const float* __restrict__ w,
                               const T* __restrict__ g, T* __restrict__ dx,
                               float* __restrict__ partial, int rows, int h, float eps) {
  __shared__ float red[kWideThreads / 32];
  using P = Pack<T, VW>;
  float* part = partial + static_cast<long>(blockIdx.x) * h;
  for (int i = threadIdx.x * VW; i < h; i += kWideThreads * VW)
#pragma unroll
    for (int j = 0; j < VW; ++j) part[i + j] = 0.f;
  for (long row = blockIdx.x; row < rows; row += gridDim.x) {
    const T* xr = x + row * h;
    const T* gr = g + row * h;
    T* dr = dx + row * h;
    float sum = 0.f;
    for (int i = threadIdx.x * VW; i < h; i += kWideThreads * VW) {
      const P p = *reinterpret_cast<const P*>(xr + i);
#pragma unroll
      for (int j = 0; j < VW; ++j) sum += tos::to_float(p.v[j]);
    }
    const float mean = block_sum(sum, red) / h;
    float sq = 0.f;
    for (int i = threadIdx.x * VW; i < h; i += kWideThreads * VW) {
      const P p = *reinterpret_cast<const P*>(xr + i);
#pragma unroll
      for (int j = 0; j < VW; ++j) {
        const float d = tos::to_float(p.v[j]) - mean;
        sq += d * d;
      }
    }
    const float rstd = rsqrtf(block_sum(sq, red) / h + eps);
    float s1 = 0.f, s2 = 0.f;  // sums of dy and dy * xhat
    for (int i = threadIdx.x * VW; i < h; i += kWideThreads * VW) {
      const P px = *reinterpret_cast<const P*>(xr + i);
      const P pg = *reinterpret_cast<const P*>(gr + i);
#pragma unroll
      for (int j = 0; j < VW; ++j) {
        const float xhat = (tos::to_float(px.v[j]) - mean) * rstd;
        const float dy = tos::to_float(pg.v[j]) * w[i + j];
        s1 += dy;
        s2 += dy * xhat;
      }
    }
    const float m1 = block_sum(s1, red) / h;
    const float m2 = block_sum(s2, red) / h;
    for (int i = threadIdx.x * VW; i < h; i += kWideThreads * VW) {
      const P px = *reinterpret_cast<const P*>(xr + i);
      const P pg = *reinterpret_cast<const P*>(gr + i);
      P o;
#pragma unroll
      for (int j = 0; j < VW; ++j) {
        const float xhat = (tos::to_float(px.v[j]) - mean) * rstd;
        const float gv = tos::to_float(pg.v[j]);
        o.v[j] = tos::from_float<T>(rstd * (gv * w[i + j] - m1 - xhat * m2));
        part[i + j] += gv * xhat;
      }
      *reinterpret_cast<P*>(dr + i) = o;
    }
  }
}

template <typename T, int VW>
cudaError_t launch_bwd_vw(const void* x, const float* w, const void* g, void* dx,
                          float* partial, float* dw, int rows, int h, float eps,
                          int n_partial, int device, cudaStream_t stream) {
  const size_t smem = h > kWarpRowMax ? 0 : sizeof(float) * kRowsPerBlock * acc_floats(h, VW);
  if (smem > 48 * 1024) {
    // the opt-in is set once per instantiation and device
    static unsigned long long configured = 0;
    const unsigned long long bit = 1ull << (device & 63);
    if (!(configured & bit)) {
      const cudaError_t e = cudaFuncSetAttribute(
          layer_norm_bwd_kernel<T, VW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(kRowsPerBlock * sizeof(float) * acc_floats(kWarpRowMax, VW)));
      if (e != cudaSuccess) return e;
      configured |= bit;
    }
  }
  if (h > kWarpRowMax)
    layer_norm_bwd_wide_kernel<T, VW><<<n_partial, kWideThreads, 0, stream>>>(
        static_cast<const T*>(x), w, static_cast<const T*>(g), static_cast<T*>(dx), partial,
        rows, h, eps);
  else
    layer_norm_bwd_kernel<T, VW><<<n_partial, 32 * kRowsPerBlock, smem, stream>>>(
        static_cast<const T*>(x), w, static_cast<const T*>(g), static_cast<T*>(dx), partial,
        rows, h, eps);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  layer_norm_dw_kernel<<<(h + 127) / 128, 128, 0, stream>>>(partial, dw, n_partial, h);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* x, const float* w, const void* g, void* dx,
                       float* partial, float* dw, int rows, int h, float eps,
                       int n_partial, int device, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = (h % kVec == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(g) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(dx) % 16 == 0);
  if (vec)
    return launch_bwd_vw<T, kVec>(x, w, g, dx, partial, dw, rows, h, eps, n_partial,
                                  device, stream);
  return launch_bwd_vw<T, 1>(x, w, g, dx, partial, dw, rows, h, eps, n_partial, device,
                             stream);
}

}  // namespace

// Rows of the dw scratch the backward needs for `rows` rows: the caller
// allocates a [tos_layer_norm_bwd_partials(rows), h] f32 scratch.
extern "C" int tos_layer_norm_bwd_partials(int rows) {
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  return blocks < kMaxPartials ? blocks : kMaxPartials;
}

// x, g, dx: [rows, h] contiguous in `dtype` on CUDA device `device`; w, dw: [h]
// f32; partial: [tos_layer_norm_bwd_partials(rows), h] f32 scratch. Launches
// pass 1 and pass 2 on `stream`. Returns cudaGetLastError().
extern "C" int tos_layer_norm_bwd(const void* x, const void* w, const void* g, void* dx,
                                  void* partial, void* dw, int rows, int h, float eps,
                                  int dtype, int device, void* stream) {
  cudaGetLastError();  // start from a clean error state
  if (rows <= 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (h <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  float* pf = static_cast<float*>(partial);
  float* dwf = static_cast<float*>(dw);
  const int n_partial = tos_layer_norm_bwd_partials(rows);
  if (dtype == tos::kFloat32)
    return static_cast<int>(
        launch_bwd<float>(x, wf, g, dx, pf, dwf, rows, h, eps, n_partial, device, s));
  if (dtype == tos::kBFloat16)
    return static_cast<int>(launch_bwd<__nv_bfloat16>(x, wf, g, dx, pf, dwf, rows, h, eps,
                                                      n_partial, device, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// x, y: [rows, h] contiguous in `dtype` on CUDA device `device`; w: [h] f32.
// Returns cudaGetLastError().
extern "C" int tos_layer_norm_fwd(const void* x, const void* w, void* y, int rows, int h,
                                  float eps, int dtype, int device, void* stream) {
  cudaGetLastError();  // start from a clean error state
  if (rows <= 0) return 0;
  // this library links its own CUDA runtime: select the tensors' device here
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (h <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const bool wide = h > kWarpRowMax;
  if (dtype == tos::kFloat32) {
    if (wide) launch_wide<float>(x, wf, y, rows, h, eps, s);
    else launch<float>(x, wf, y, rows, h, eps, s);
  } else if (dtype == tos::kBFloat16) {
    if (wide) launch_wide<__nv_bfloat16>(x, wf, y, rows, h, eps, s);
    else launch<__nv_bfloat16>(x, wf, y, rows, h, eps, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
