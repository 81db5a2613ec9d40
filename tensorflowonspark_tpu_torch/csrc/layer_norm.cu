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
// about twenty flops per element: 75 MB, 0.0225 ms, at 16384 x 768 in bf16.
//
// Design. The TPU kernel carries dw across its sequential grid; here blocks run
// in parallel, so dw takes two passes and no atomics (the gradient must be
// bitwise reproducible, so every sum has a fixed order). Pass 1
// (layer_norm_bwd_kernel) keeps the row in registers: a team of 1, 2, 4 or
// 8 warps holds one row, each lane at most kMaxPacks 16-byte packs of x and
// as many of g (at H 768 in bf16, one warp a row and three packs of each a
// lane), so x and g are read from device memory once, all of a lane's
// loads issued together, and the statistics, both means and dx come from
// registers. Each lane keeps its columns of w and its running sum of
// g * xhat over the rows it walks in registers too. 256-thread blocks hold
// 8 / team rows at a time and walk rows in steps of the grid; the grid is
// the SM count times the blocks an SM holds (the occupancy calculator), so
// every SM keeps as many loads in flight as it can, and no more blocks than
// that write partial rows. At the end each block adds its teams' sums in
// team order into one partial row of a [grid, H] f32 scratch. Pass 2
// (layer_norm_dw_kernel) sums the partials: a block per 32 columns, 32
// groups of threads each adding every 32nd partial row in order, then the
// groups' sums in order. Rows that do not fit (past 8 warps of packs: f32
// past H 4096, unvectorised past H 1024, any row past H 8192) take a block
// per row (layer_norm_bwd_wide_kernel): a grid of at most kMaxWideParts
// blocks, each walking rows blockIdx.x, +grid, ... and adding g * xhat
// straight into its partial row in device memory, each column always by the
// same thread; the same pass 2 follows.

#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>

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

constexpr int kBwdThreads = 256;       // register kernel: 8 warps a block
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kMaxPacks = 4;           // packs of x (and of g) a lane holds
constexpr int kMaxWideParts = 256;     // block-per-row kernel: rows of the dw scratch
constexpr int kDwCols = 32, kDwGroups = 32;   // pass 2: columns x groups a block

// Warps that share a row in the register kernel for h elements in packs of
// vw: the fewest of 1, 2, 4 or 8 whose lanes hold the row in at most
// kMaxPacks packs each; 0 when 8 cannot (the block-per-row kernel takes it).
inline int bwd_team(int h, int vw) {
  const int packs = (h + vw - 1) / vw;
  for (int team = 1; team <= kBwdWarps; team *= 2)
    if (packs <= 32 * team * kMaxPacks) return team;
  return 0;
}

// The sum of v over the `team` warps of this thread's team, the same bits in
// each of their threads: a warp sum, then the team's warp sums in warp order
// through `red` (a float per warp). Every thread of the block calls it
// together: with team > 1 it synchronises the block.
__device__ __forceinline__ float team_sum(float v, float* red, int team) {
  v = tos::warp_sum(v);
  if (team == 1) return v;
  const int warp = threadIdx.x >> 5;
  __syncthreads();  // the previous sum's reads of red are done
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
  for (int i = warp - warp % team; i < warp - warp % team + team; ++i) s += red[i];
  return s;
}

// Pass 1 for rows of at most 32 * team * NP packs of VW elements. Thread t of
// a team holds packs t, t + 32 team, ... of its row (element (p * 32 team +
// t) * VW + j is pack p's element j). The block's 8 / team teams take rows
// r0, r0 + 1, ..., and r0 steps by the grid's teams; the block's threads go
// through every row step together, a team past the last row with zeros
// (team_sum synchronises the block).
template <typename T, int VW, int NP>
__global__ void __launch_bounds__(kBwdThreads)
    layer_norm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                          const T* __restrict__ g, T* __restrict__ dx,
                          float* __restrict__ partial, int rows, int h, float eps, int team) {
  extern __shared__ float fold[];  // [teams][h]: the teams' dw sums
  __shared__ float red[kBwdWarps];
  using P = Pack<T, VW>;
  const int warp = threadIdx.x >> 5;
  const int teams = kBwdWarps / team;
  const int my_team = warp / team;
  const int t = (warp % team) * 32 + (threadIdx.x & 31);
  const int stride = 32 * team * VW;   // elements between a thread's packs
  bool in[NP];                         // pack p lies inside the row
  float wv[NP][VW], dw[NP][VW];
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    in[p] = p * stride + t * VW < h;
#pragma unroll
    for (int j = 0; j < VW; ++j) {
      wv[p][j] = in[p] ? w[p * stride + t * VW + j] : 0.f;
      dw[p][j] = 0.f;
    }
  }
  for (long r0 = static_cast<long>(blockIdx.x) * teams; r0 < rows;
       r0 += static_cast<long>(gridDim.x) * teams) {
    const long row = r0 + my_team;
    const bool live = row < rows;
    P px[NP], pg[NP];
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      px[p] = P{};
      pg[p] = P{};
      if (live && in[p]) {
        px[p] = *reinterpret_cast<const P*>(x + row * h + p * stride + t * VW);
        pg[p] = *reinterpret_cast<const P*>(g + row * h + p * stride + t * VW);
      }
    }
    float sum = 0.f;
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int j = 0; j < VW; ++j) sum += tos::to_float(px[p].v[j]);
    const float mean = team_sum(sum, red, team) / h;
    float sq = 0.f;
#pragma unroll
    for (int p = 0; p < NP; ++p)
      if (in[p])
#pragma unroll
        for (int j = 0; j < VW; ++j) {
          const float d = tos::to_float(px[p].v[j]) - mean;
          sq += d * d;
        }
    const float rstd = rsqrtf(team_sum(sq, red, team) / h + eps);
    float s1 = 0.f, s2 = 0.f;  // sums of dy and dy * xhat
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int j = 0; j < VW; ++j) {
        const float xhat = (tos::to_float(px[p].v[j]) - mean) * rstd;
        const float dy = tos::to_float(pg[p].v[j]) * wv[p][j];
        s1 += dy;
        s2 += dy * xhat;
      }
    const float m1 = team_sum(s1, red, team) / h;
    const float m2 = team_sum(s2, red, team) / h;
    if (!live) continue;
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      if (!in[p]) continue;
      P o;
#pragma unroll
      for (int j = 0; j < VW; ++j) {
        const float xhat = (tos::to_float(px[p].v[j]) - mean) * rstd;
        const float gv = tos::to_float(pg[p].v[j]);
        o.v[j] = tos::from_float<T>(rstd * (gv * wv[p][j] - m1 - xhat * m2));
        dw[p][j] += gv * xhat;
      }
      *reinterpret_cast<P*>(dx + row * h + p * stride + t * VW) = o;
    }
  }
  // this block's partial: its teams' sums added in team order
  __syncthreads();
#pragma unroll
  for (int p = 0; p < NP; ++p)
    if (in[p])
#pragma unroll
      for (int j = 0; j < VW; ++j) fold[my_team * h + p * stride + t * VW + j] = dw[p][j];
  __syncthreads();
  float* out = partial + static_cast<long>(blockIdx.x) * h;
  for (int i = threadIdx.x; i < h; i += kBwdThreads) {
    float s = 0.f;
    for (int m = 0; m < teams; ++m) s += fold[m * h + i];
    out[i] = s;
  }
}

// Pass 2: dw[c] = column c of the n_partial partial rows, summed in a fixed
// tree. Thread (c, y) of a block adds rows y, y + kDwGroups, ... in order;
// then thread (c, 0) adds the kDwGroups sums in order.
__global__ void __launch_bounds__(kDwCols * kDwGroups)
    layer_norm_dw_kernel(const float* __restrict__ partial, float* __restrict__ dw,
                         int n_partial, int h) {
  __shared__ float part[kDwGroups][kDwCols + 1];
  const int col = blockIdx.x * kDwCols + threadIdx.x;
  float s = 0.f;
  if (col < h)
    for (int p = threadIdx.y; p < n_partial; p += kDwGroups)
      s += partial[static_cast<long>(p) * h + col];
  part[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && col < h) {
    float total = 0.f;
    for (int y = 0; y < kDwGroups; ++y) total += part[y][threadIdx.x];
    dw[col] = total;
  }
}

// a block per row (rows the register kernel cannot hold): block blockIdx.x
// walks rows blockIdx.x, + gridDim.x, ... and adds g * xhat into its own
// partial row, each column always by the same thread
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
using BwdKernel = void (*)(const T*, const float*, const T*, T*, float*, int, int, float, int);

template <typename T, int VW>
BwdKernel<T, VW> bwd_kernel(int np) {
  switch (np) {
    case 1: return layer_norm_bwd_kernel<T, VW, 1>;
    case 2: return layer_norm_bwd_kernel<T, VW, 2>;
    case 3: return layer_norm_bwd_kernel<T, VW, 3>;
    default: return layer_norm_bwd_kernel<T, VW, kMaxPacks>;
  }
}

// Where pass 1 runs for rows of h elements in packs of VW: the register
// kernel (team warps a row, np packs a lane, `smem` bytes of fold) or, with
// team 0, the block-per-row kernel; `grid` blocks, each writing a partial row.
struct BwdPlan {
  int team, np, grid;
  size_t smem;
};

// The blocks of `kernel` (kBwdThreads threads, `smem` bytes of dynamic
// shared memory) that all of `device`'s SMs hold at once: the SM count times
// the occupancy calculator's blocks an SM. Asked once per (kernel, device,
// smem) and kept, so a call's host path does not run the calculator.
cudaError_t resident_blocks(const void* kernel, size_t smem, int device, int* blocks) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, size_t>, int> known;
  const auto key = std::make_tuple(kernel, device, smem);
  {
    std::lock_guard<std::mutex> lock(mu);
    const auto it = known.find(key);
    if (it != known.end()) {
      *blocks = it->second;
      return cudaSuccess;
    }
  }
  int sms = 0, per_sm = 0;
  cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kBwdThreads, smem);
  if (e != cudaSuccess) return e;
  *blocks = sms * (per_sm > 0 ? per_sm : 1);
  std::lock_guard<std::mutex> lock(mu);
  known[key] = *blocks;
  return cudaSuccess;
}

template <typename T, int VW>
cudaError_t plan_bwd(int rows, int h, int device, BwdPlan* plan) {
  const int team = bwd_team(h, VW);
  if (team == 0) {
    const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
    *plan = {0, 0, blocks < kMaxWideParts ? blocks : kMaxWideParts, 0};
    return cudaSuccess;
  }
  const int packs = (h + VW - 1) / VW;
  const int np = (packs + 32 * team - 1) / (32 * team);
  const int teams = kBwdWarps / team;
  const size_t smem = sizeof(float) * teams * h;
  int resident = 0;
  const cudaError_t e = resident_blocks(reinterpret_cast<const void*>(bwd_kernel<T, VW>(np)),
                                        smem, device, &resident);
  if (e != cudaSuccess) return e;
  const long steps = (static_cast<long>(rows) + teams - 1) / teams;
  *plan = {team, np, static_cast<int>(steps < resident ? steps : resident), smem};
  return cudaSuccess;
}

template <typename T, int VW>
cudaError_t launch_bwd_vw(const void* x, const float* w, const void* g, void* dx,
                          float* partial, int n_partial, float* dw, int rows, int h,
                          float eps, int device, cudaStream_t stream) {
  BwdPlan plan;
  cudaError_t e = plan_bwd<T, VW>(rows, h, device, &plan);
  if (e != cudaSuccess) return e;
  if (plan.grid > n_partial) return cudaErrorInvalidValue;
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  T* dxt = static_cast<T*>(dx);
  if (plan.team == 0)
    layer_norm_bwd_wide_kernel<T, VW><<<plan.grid, kWideThreads, 0, stream>>>(
        xt, w, gt, dxt, partial, rows, h, eps);
  else
    bwd_kernel<T, VW>(plan.np)<<<plan.grid, kBwdThreads, plan.smem, stream>>>(
        xt, w, gt, dxt, partial, rows, h, eps, plan.team);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  layer_norm_dw_kernel<<<(h + kDwCols - 1) / kDwCols, dim3(kDwCols, kDwGroups), 0, stream>>>(
      partial, dw, plan.grid, h);
  return cudaGetLastError();
}

// The backward's plan for `dtype`: packs of 16 bytes when h allows them
// (the pointers must then be 16-byte aligned), else single elements.
template <typename T>
bool bwd_vec(int h) {
  return h % (16 / sizeof(T)) == 0;
}

template <typename T>
cudaError_t plan_bwd_dtype(int rows, int h, int device, BwdPlan* plan) {
  return bwd_vec<T>(h) ? plan_bwd<T, 16 / sizeof(T)>(rows, h, device, plan)
                       : plan_bwd<T, 1>(rows, h, device, plan);
}

template <typename T>
cudaError_t launch_bwd(const void* x, const float* w, const void* g, void* dx,
                       float* partial, int n_partial, float* dw, int rows, int h, float eps,
                       int device, cudaStream_t stream) {
  if (!bwd_vec<T>(h))
    return launch_bwd_vw<T, 1>(x, w, g, dx, partial, n_partial, dw, rows, h, eps, device,
                               stream);
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(g) |
       reinterpret_cast<uintptr_t>(dx)) % 16 != 0)
    return cudaErrorMisalignedAddress;
  return launch_bwd_vw<T, 16 / sizeof(T)>(x, w, g, dx, partial, n_partial, dw, rows, h, eps,
                                          device, stream);
}

}  // namespace

// Rows of the dw scratch the backward needs for `rows` rows of h elements in
// `dtype` on CUDA device `device`: the caller allocates a
// [tos_layer_norm_bwd_partials(...), h] f32 scratch; -1 on an error.
extern "C" int tos_layer_norm_bwd_partials(int rows, int h, int dtype, int device) {
  if (rows <= 0 || h <= 0) return 0;
  if (cudaSetDevice(device) != cudaSuccess) return -1;
  BwdPlan plan;
  cudaError_t e = cudaErrorInvalidValue;
  if (dtype == tos::kFloat32) e = plan_bwd_dtype<float>(rows, h, device, &plan);
  else if (dtype == tos::kBFloat16) e = plan_bwd_dtype<__nv_bfloat16>(rows, h, device, &plan);
  return e == cudaSuccess ? plan.grid : -1;
}

// x, g, dx: [rows, h] contiguous in `dtype` on CUDA device `device`, 16-byte
// aligned when h is a multiple of 16 bytes' elements; w, dw: [h] f32;
// partial: [n_partial, h] f32 scratch, n_partial at least
// tos_layer_norm_bwd_partials(rows, h, dtype, device). Launches pass 1 and
// pass 2 on `stream`. Returns cudaGetLastError().
extern "C" int tos_layer_norm_bwd(const void* x, const void* w, const void* g, void* dx,
                                  void* partial, int n_partial, void* dw, int rows, int h,
                                  float eps, int dtype, int device, void* stream) {
  cudaGetLastError();  // start from a clean error state
  if (rows <= 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (h <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  float* pf = static_cast<float*>(partial);
  float* dwf = static_cast<float*>(dw);
  if (dtype == tos::kFloat32)
    return static_cast<int>(
        launch_bwd<float>(x, wf, g, dx, pf, n_partial, dwf, rows, h, eps, device, s));
  if (dtype == tos::kBFloat16)
    return static_cast<int>(launch_bwd<__nv_bfloat16>(x, wf, g, dx, pf, n_partial, dwf, rows,
                                                      h, eps, device, s));
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
