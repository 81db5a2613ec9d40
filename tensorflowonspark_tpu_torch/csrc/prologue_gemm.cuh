// A matrix product out = f(x) @ w whose A operand passes through an elementwise
// prologue f on its way from device memory into shared memory, so the
// transformed [rows, k] activation never exists in device memory. Shared by
// ln_matmul.cu (f = LayerNorm, with per-row statistics) and act_matmul.cu
// (f = tanh-GELU). A bf16 product with k and n multiples of 8 runs the
// tensor-core body of prologue_gemm_wgmma.cuh (wgmma + TMA, the prologue in
// registers), for both prologues; the bf16 body here keeps only the widths
// TMA cannot take, and the f32 body the f32 model. The LayerNorm row
// statistics kernel below serves all three bodies.
//
// Layouts: x [rows, k] row-major, w [k, n] row-major (n contiguous), out
// [rows, n] row-major in x's dtype, the pointers 16-byte aligned (the wrappers
// see to it); rows, k and n need not divide the tiles: ragged edges are
// masked. Every element past k or n reads as 0.
//
// Two paths:
//
// * bf16, k or n not a multiple of 8 (rows start off a 16-byte boundary):
//   tensor cores through WMMA (16x16x16 bf16 fragments, f32 accumulators).
//   A 256-thread CTA owns a 128 x 128 output tile; its eight warps (2 x 4)
//   own 64 x 32 each. K advances 32 at a time. The raw x and w tiles are
//   read element by element, bounds-checked, into a ring of four
//   shared-memory stages. Each K step the CTA first runs the prologue over
//   the raw x tile: shared memory -> f32 -> f -> bf16 (as the TPU kernel
//   rounds xn.astype(w.dtype)) -> the tile the tensor cores read. Rows of
//   that tile and of w's are padded 8 elements against bank conflicts;
//   matrix B is read row-major straight from w, with no transposed copy.
//   The epilogue stages each 16 x 16 accumulator through shared memory and
//   writes bf16 elements.
// * f32: CUDA cores in full f32 (no TF32), a 64 x 64 tile per 256-thread CTA,
//   4 x 4 outputs per thread, K 16 at a time, A stored k-major; 16-byte
//   vectors when k and n are multiples of 4 (kVec), else element loads. It
//   exists so the f32 model agrees with its plain version to float rounding.
//
// What bounds it: 2 * rows * k * n operations against ~2 bytes per x
// element, far above the card's operations-per-byte balance. The WMMA body
// issues warp-level mma from shared memory, at 12-14% of that bound on the
// H100 where it ran the aligned widths (PERF.md); prologue_gemm_wgmma.cuh is
// its wgmma successor.
#pragma once

#include <mma.h>
#include <stdint.h>

#include "common.cuh"

namespace tos {
namespace pgemm {

enum class Prologue { kLayerNorm, kGelu };

constexpr int kThreads = 256;

// bf16 tensor-core tile
constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kAStride = kBK + 8;   // 40 bf16 = 80 bytes per A row
constexpr int kBStride = kBN + 8;   // 136 bf16 = 272 bytes per B row
constexpr int kAElems = kBM * kAStride;
constexpr int kBElems = kBK * kBStride;
constexpr int kStages = 4;          // K tiles in flight (cp.async ring)

// f32 CUDA-core tile
constexpr int kFM = 64, kFN = 64, kFK = 16;

struct alignas(16) Bf16x8 {
  __nv_bfloat16 v[8];
};

// jax.nn.gelu(approximate=True) in f32: x * 0.5 * (1 + tanh(sqrt(2/pi) *
// (x + 0.044715 x^3))). tanhf, not tanh.approx.f32 (2^-11 relative): the f32
// path must agree with the plain version to float rounding.
__device__ __forceinline__ float gelu_tanh(float x) {
  const float kSqrt2OverPi = 0.7978845608028654f;
  const float cdf = 0.5f * (1.0f + tanhf(kSqrt2OverPi * (x + 0.044715f * (x * x * x))));
  return x * cdf;
}

// Row mean and rstd of every row of x [rows, h], one warp per row, with the
// reference's two-pass formula: mean, then mean((x - mean)^2), then
// rsqrt(var + eps); stats[row] = (mean, rstd). VW elements per load (16
// bytes when h allows it, else 1). The second pass re-reads the row from L1.
template <typename T, int VW>
__global__ void __launch_bounds__(kThreads)
    ln_matmul_stats_kernel(const T* __restrict__ x, float2* __restrict__ stats, int rows,
                           int h, float eps) {
  struct alignas(sizeof(T) * VW) V {
    T v[VW];
  };
  const int lane = threadIdx.x & 31;
  const long row = static_cast<long>(blockIdx.x) * (kThreads / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + row * h;
  float s = 0.f;
  for (int i = lane * VW; i < h; i += 32 * VW) {
    const V p = *reinterpret_cast<const V*>(xr + i);
#pragma unroll
    for (int j = 0; j < VW; ++j) s += to_float(p.v[j]);
  }
  const float mean = warp_sum(s) / h;
  float q = 0.f;
  for (int i = lane * VW; i < h; i += 32 * VW) {
    const V p = *reinterpret_cast<const V*>(xr + i);
#pragma unroll
    for (int j = 0; j < VW; ++j) {
      const float d = to_float(p.v[j]) - mean;
      q += d * d;
    }
  }
  const float rstd = rsqrtf(warp_sum(q) / h + eps);
  if (lane == 0) stats[row] = make_float2(mean, rstd);
}

// A CTA's rows' statistics [row0, row0 + count) into shared memory (rows
// past `rows` get 0 and 0); the caller synchronises before reading them.
__device__ __forceinline__ void load_stats(const float2* __restrict__ stats, long row0,
                                           int count, int rows, float* mu, float* rstd) {
  for (int r = threadIdx.x; r < count; r += kThreads) {
    const float2 st = row0 + r < rows ? stats[row0 + r] : make_float2(0.f, 0.f);
    mu[r] = st.x;
    rstd[r] = st.y;
  }
}

// f(v) for element (local row r, column kk) of x: LayerNorm as the TPU
// kernel orders it, (x - mu) * rstd * w_ln, or tanh-GELU.
template <Prologue P>
__device__ __forceinline__ float prologue(float v, int r, int kk, const float* __restrict__ w_ln,
                                          const float* mu, const float* rstd) {
  if constexpr (P == Prologue::kLayerNorm) {
    return (v - mu[r]) * rstd[r] * __ldg(w_ln + kk);
  } else {
    return gelu_tanh(v);
  }
}

// dynamic shared memory of the bf16 kernel: kStages raw A and B tiles, and
// the transformed A tile the tensor cores read
constexpr int kRawA = kBM * kBK;                       // bf16, unpadded
constexpr size_t kBf16Smem = sizeof(__nv_bfloat16) *
                             (kStages * (kRawA + kBElems) + kAElems);

template <Prologue P>
__global__ void __launch_bounds__(kThreads, 2)
    prologue_gemm_bf16(const __nv_bfloat16* __restrict__ x, const float* __restrict__ w_ln,
                       const float2* __restrict__ stats, const __nv_bfloat16* __restrict__ w,
                       __nv_bfloat16* __restrict__ out, int rows, int k, int n) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* raw_a = reinterpret_cast<__nv_bfloat16*>(smem);   // [kStages][128][32]
  __nv_bfloat16* s_b = raw_a + kStages * kRawA;                     // [kStages][32][136]
  __nv_bfloat16* s_a = s_b + kStages * kBElems;                     // [128][40]
  __shared__ float s_mu[kBM], s_rstd[kBM];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;   // warp tile: rows wm*64, cols wn*32
  const int n0 = blockIdx.x * kBN;
  const long row0 = static_cast<long>(blockIdx.y) * kBM;
  const int nk = (k + kBK - 1) / kBK;

  // one K tile into stage `stage`: each thread reads two 8-element slices
  // of A (128 rows x 4) and two of B (32 rows x 16), element by element;
  // out-of-range elements are zero-filled
  auto issue = [&](int kt, int stage) {
    const int k0 = kt * kBK;
    __nv_bfloat16* a = raw_a + stage * kRawA;
    __nv_bfloat16* b = s_b + stage * kBElems;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * kThreads;
      const int ar = idx >> 2, ac = (idx & 3) * 8;
      const bool a_row = row0 + ar < rows;
      Bf16x8 v;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        v.v[j] = a_row && k0 + ac + j < k ? x[(row0 + ar) * k + k0 + ac + j]
                                          : __float2bfloat16(0.f);
      *reinterpret_cast<Bf16x8*>(a + ar * kBK + ac) = v;
      const int br = idx >> 4, bc = (idx & 15) * 8;
      const bool b_row = k0 + br < k;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        v.v[j] = b_row && n0 + bc + j < n ? w[static_cast<long>(k0 + br) * n + n0 + bc + j]
                                          : __float2bfloat16(0.f);
      *reinterpret_cast<Bf16x8*>(b + br * kBStride + bc) = v;
    }
  };

  // the first kStages - 1 tiles go in before the row statistics are read
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s)
    if (s < nk) issue(s, s);
  if constexpr (P == Prologue::kLayerNorm) load_stats(stats, row0, kBM, rows, s_mu, s_rstd);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int kt = 0; kt < nk; ++kt) {
    const int stage = kt % kStages;
    // every thread's stores of tile kt landed; every warp finished tile
    // kt - 1, so its stage and the transformed tile are free (and the
    // statistics are in)
    __syncthreads();
    {
      // raw A -> f32 -> prologue -> bf16 (xn.astype(w.dtype)) -> s_a
      const int k0 = kt * kBK;
      const __nv_bfloat16* a = raw_a + stage * kRawA;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int idx = tid + i * kThreads;
        const int ar = idx >> 2, ac = (idx & 3) * 8;
        Bf16x8 o = {};
        if (row0 + ar < rows && k0 + ac < k) {
          const Bf16x8 v = *reinterpret_cast<const Bf16x8*>(a + ar * kBK + ac);
#pragma unroll
          for (int j = 0; j < 8; ++j)
            o.v[j] = k0 + ac + j < k
                         ? __float2bfloat16(prologue<P>(__bfloat162float(v.v[j]), ar,
                                                        k0 + ac + j, w_ln, s_mu, s_rstd))
                         : __float2bfloat16(0.f);
        }
        *reinterpret_cast<Bf16x8*>(s_a + ar * kAStride + ac) = o;
      }
    }
    // refill the stage tile kt - 1 used, kStages - 1 tiles ahead
    if (kt + kStages - 1 < nk) issue(kt + kStages - 1, (kt + kStages - 1) % kStages);
    __syncthreads();   // s_a ready
    const __nv_bfloat16* b = s_b + stage * kBElems;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(fa[i], s_a + (wm * 64 + i * 16) * kAStride + kk, kAStride);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], b + kk * kBStride + wn * 32 + j * 16, kBStride);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  __syncthreads();   // every warp is done reading s_a

  // epilogue: each warp stages one 16 x 16 f32 tile at a time in s_a (1 KB
  // per warp); lane l writes row l / 2, columns (l % 2) * 8 .. + 8
  float* st = reinterpret_cast<float*>(s_a) + warp * 256;
  const int er = lane >> 1, ec = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const long row = row0 + wm * 64 + i * 16 + er;
      const int col = n0 + wn * 32 + j * 16 + ec;
      if (row < rows && col < n) {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (col + e < n) out[row * n + col + e] = __float2bfloat16(st[er * 16 + ec + e]);
      }
      __syncwarp();
    }
  }
}

// kVec: k and n multiples of 4, every row of x and w on a 16-byte boundary
template <Prologue P, bool kVec>
__global__ void __launch_bounds__(kThreads)
    prologue_gemm_f32(const float* __restrict__ x, const float* __restrict__ w_ln,
                      const float2* __restrict__ stats, const float* __restrict__ w,
                      float* __restrict__ out, int rows, int k, int n) {
  __shared__ __align__(16) float sA[kFK][kFM + 4];   // k-major
  __shared__ __align__(16) float sB[kFK][kFN + 4];
  __shared__ float s_mu[kFM], s_rstd[kFM];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int n0 = blockIdx.x * kFN;
  const long row0 = static_cast<long>(blockIdx.y) * kFM;
  if constexpr (P == Prologue::kLayerNorm) {
    load_stats(stats, row0, kFM, rows, s_mu, s_rstd);
    __syncthreads();
  }
  float acc[4][4] = {};
  const int ar = tid >> 2, ac = (tid & 3) * 4;    // A: 64 rows x 4 float4
  const int br = tid >> 4, bc = (tid & 15) * 4;   // B: 16 rows x 16 float4
  for (int k0 = 0; k0 < k; k0 += kFK) {
    float av[4] = {0.f, 0.f, 0.f, 0.f};
    if (row0 + ar < rows && k0 + ac < k) {
      const float* xr = x + (row0 + ar) * k + k0 + ac;
      if constexpr (kVec) {
        const float4 v = *reinterpret_cast<const float4*>(xr);
        av[0] = prologue<P>(v.x, ar, k0 + ac, w_ln, s_mu, s_rstd);
        av[1] = prologue<P>(v.y, ar, k0 + ac + 1, w_ln, s_mu, s_rstd);
        av[2] = prologue<P>(v.z, ar, k0 + ac + 2, w_ln, s_mu, s_rstd);
        av[3] = prologue<P>(v.w, ar, k0 + ac + 3, w_ln, s_mu, s_rstd);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          av[j] = k0 + ac + j < k ? prologue<P>(xr[j], ar, k0 + ac + j, w_ln, s_mu, s_rstd)
                                  : 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) sA[ac + j][ar] = av[j];
    float4 bv = make_float4(0.f, 0.f, 0.f, 0.f);
    if (k0 + br < k && n0 + bc < n) {
      const float* wr = w + static_cast<long>(k0 + br) * n + n0 + bc;
      if constexpr (kVec) {
        bv = *reinterpret_cast<const float4*>(wr);
      } else {
        bv.x = wr[0];
        bv.y = n0 + bc + 1 < n ? wr[1] : 0.f;
        bv.z = n0 + bc + 2 < n ? wr[2] : 0.f;
        bv.w = n0 + bc + 3 < n ? wr[3] : 0.f;
      }
    }
    *reinterpret_cast<float4*>(&sB[br][bc]) = bv;
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sA[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sB[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long row = row0 + ty * 4 + i;
    if (row >= rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < n) out[row * n + col] = acc[i][j];
    }
  }
}

// The LayerNorm prologue's row statistics on `stream`
template <typename T>
void launch_stats(const void* x, float2* stats, int rows, int h, float eps,
                  cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const unsigned blocks = static_cast<unsigned>((rows + kThreads / 32 - 1) / (kThreads / 32));
  if (h % kVec == 0)
    ln_matmul_stats_kernel<T, kVec><<<blocks, kThreads, 0, stream>>>(static_cast<const T*>(x),
                                                                     stats, rows, h, eps);
  else
    ln_matmul_stats_kernel<T, 1><<<blocks, kThreads, 0, stream>>>(static_cast<const T*>(x),
                                                                  stats, rows, h, eps);
}

// The bf16 product on `stream`, with the shared-memory opt-in past 48 KB set
// once per instantiation and device
template <Prologue P>
cudaError_t launch_bf16(const void* x, const float* w_ln, float2* stats, const void* w,
                        void* out, int rows, int k, int n, dim3 grid, cudaStream_t stream) {
  static unsigned long long configured = 0;
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = 1ull << (device & 63);
  if (!(configured & bit)) {
    e = cudaFuncSetAttribute(prologue_gemm_bf16<P>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kBf16Smem));
    if (e != cudaSuccess) return e;
    configured |= bit;
  }
  prologue_gemm_bf16<P><<<grid, kThreads, kBf16Smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), w_ln, stats, static_cast<const __nv_bfloat16*>(w),
      static_cast<__nv_bfloat16*>(out), rows, k, n);
  return cudaGetLastError();
}

// Launch f(x) @ w on `stream`; returns cudaGetLastError(). The LayerNorm
// prologue first fills `stats` ([rows] float2 scratch) with each row's
// (mean, rstd) in a kernel of its own, then reads them with w_ln; the GELU
// prologue reads neither.
template <Prologue P>
cudaError_t launch(const void* x, const float* w_ln, float2* stats, const void* w, void* out,
                   int rows, int k, int n, float eps, int dtype, cudaStream_t stream) {
  if (k <= 0) return cudaErrorInvalidValue;
  if (dtype != kBFloat16 && dtype != kFloat32) return cudaErrorInvalidValue;
  const bool bf16 = dtype == kBFloat16;
  const dim3 grid(bf16 ? (n + kBN - 1) / kBN : (n + kFN - 1) / kFN,
                  bf16 ? (rows + kBM - 1) / kBM : (rows + kFM - 1) / kFM);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  if constexpr (P == Prologue::kLayerNorm) {
    if (bf16) launch_stats<__nv_bfloat16>(x, stats, rows, k, eps, stream);
    else launch_stats<float>(x, stats, rows, k, eps, stream);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  // bf16 with k and n multiples of 8 runs the wgmma body
  // (prologue_gemm_wgmma.cuh), routed there by act_matmul.cu and ln_matmul.cu
  if (bf16) return launch_bf16<P>(x, w_ln, stats, w, out, rows, k, n, grid, stream);
  if (k % 4 == 0 && n % 4 == 0)
    prologue_gemm_f32<P, true><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(x), w_ln, stats, static_cast<const float*>(w),
        static_cast<float*>(out), rows, k, n);
  else
    prologue_gemm_f32<P, false><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(x), w_ln, stats, static_cast<const float*>(w),
        static_cast<float*>(out), rows, k, n);
  return cudaGetLastError();
}

}  // namespace pgemm
}  // namespace tos
