// Flash-attention backward for Hopper, the split plan: dQ in one kernel, dK/dV
// in another, with unexpanded grouped K/V and absolute position bases.
//
// Replaces: tensorflowonspark_tpu/ops/flash_attention.py
//   _attn_bwd_dq_kernel (:166-194, launched by _bwd_impl at :667)
//     -> flash_bwd_dq_kernel_wgmma (bf16), flash_bwd_dq_kernel (f32);
//   _attn_bwd_dkv_kernel (:197-229, MHA, launched at :723)
//     -> flash_bwd_dkv_kernel_wgmma (bf16), flash_bwd_dkv_kernel (f32);
//   _attn_bwd_dkv_gqa_kernel (:281-329, grouped KV, launched at :689)
//     -> flash_bwd_dkv_gqa_kernel_wgmma (bf16), flash_bwd_dkv_gqa_kernel (f32).
// Same function, term for term (_pair_p_ds :109-118):
//   s = (q * scale) . k in f32, masked like the forward (keep = kv_base + j <=
//   q_base + i, and > q_base + i - window);
//   P is recomputed from the forward's lse: p = exp(s - lse), forced to 0 where
//   the entry is masked or the row saw no key (lse = -1e30);
//   dS = P * (dO . V^T - Delta), Delta from the pre-pass (flash_bwd_delta.cuh,
//   the lse cotangent folded in);
//   dQ = scale * sum_k dS K over the visible k tiles (_causal_k_hi /
//   _window_k_lo), cast once from f32 to q's dtype;
//   dV = sum_q P^T dO, dK = sum_q dS^T (q * scale) over the visible q tiles
//   (_causal_q_lo / _window_q_hi); grouped KV sums the g query heads of each KV
//   head in f32, in head order, and casts once to k's dtype (:715-721).
// Tile bounds use floor division (tos::floor_div): C's / truncates, and with a
// negative numerator (keys ahead of every query) it would visit one more tile.
// Head dims: every d with 8 <= d <= 128 and d % 8 == 0, in bodies built for a
// padded tile width D (64 or 128, padded_head_dim) that stage zeros past
// column d (TMA fills them in the tensor-core body) and store no column past
// d; the scale stays 1/sqrt(d).
//
// Bound on the H100: per visible (q, k) pair the dQ kernel does 3 products of
// 2 * D flops (S, dP, dS K) and the dK/dV kernel 4 (S, dP, P^T dO, dS^T Q): 7
// products where the fused plan does 5, since S and dP are computed by both. At
// the long-context shape (B 1, S 16384, H 12, Hk 4, D 64, causal) that is
// about 1.4 TFLOP against ~0.1 GB of inputs and outputs: compute-bound on the
// tensor cores (~1.4 ms there).
//
// Each kernel has two bodies, chosen by dtype (DqLauncher, DkvLauncher).
//
// bf16 dQ -> flash_bwd_dq_kernel_wgmma (tensor cores). Its CUDA-core body
// (below) ran at 2-3% of the bound: K, V, Q and dO staged as f32 in shared
// memory, three CTA-wide barriers and scalar FMAs for S, dP and dS K on every
// key tile, and every K/V load stalling the CTA. This body is the forward's
// loop (flash_attention.cu, flash_fwd_kernel_wgmma) with the lse already
// known: one CTA per (batch * query head, 128-row q tile), two warpgroups of
// 64 rows, two CTAs an SM at a padded width of 64 (96 KB of shared memory
// each). Thread 0 loads Q and dO once by TMA and streams 64-key K/V tiles
// through a 4-stage ring of full/empty mbarriers, so the next tiles' copies
// overlap this tile's products. Per key tile each warpgroup issues S = Q K^T
// and dP = dO V^T (wgmma, all operands K-major) and waits once; forms P =
// exp2(s * scale * log2e - lse) and dS = P (dP - Delta) in the accumulators'
// registers, lse (log2 units, +inf for dead rows and rows past Sq) and Delta
// held per row in registers, masking only on the causal diagonal, the
// window's edge and a ragged last key tile; rounds dS to bf16 in registers
// and accumulates dQ += dS K (wgmma, A from registers, B = the same K tile
// read MN-major: the forward's O += P V with K in V's place). A warpgroup
// skips the tiles none of its rows can see. dQ takes the scale once at the
// end and is stored once (no row past Sq, no column past d): no atomics,
// bitwise reproducible. dS in bf16 before dS K is the one rounding the
// reference (an f32 product) does not have; the fused and dK/dV bodies round
// the same way.
//
// bf16 dK/dV -> flash_bwd_dkv_kernel_wgmma / flash_bwd_dkv_gqa_kernel_wgmma (tensor
// cores, dkv_tile_wgmma; the fused plan's tensor-core body runs the same step
// with dQ added, flash_bwd_wgmma.cuh). One CTA per (batch * KV head, 128-key
// tile): two
// consumer warpgroups of 64 keys and one producer warp (at a padded width of
// 128 one warpgroup and 64 keys, see bwd_wg::consumers). The producer loads
// the CTA's K and V tiles once by TMA and streams the (query head, q tile)
// pairs through a 2-stage ring: Q and dO by TMA (hopper_mma.cuh, 128-byte
// swizzle), lse (in log2 units, +inf for rows past Sq or rows that saw no key)
// and Delta by its lanes. Per pair each consumer computes S^T = K Q^T and
// dP^T = V dO^T with wgmma (A = K or V, B = Q or dO, all K-major in shared
// memory), P^T and dS^T in the accumulators' registers with the masks and
// guards of pair_p_ds (masked only on the causal diagonal and the window's
// edge), rounds them to bf16 in registers and accumulates dV += P^T dO and
// dK += dS^T Q with wgmma (A from registers, B = dO or Q MN-major: tnspB).
// q tiles are 64 rows at D 64 and 32 at D 128, where dK and dV hold 128 f32
// registers a thread. dK takes the scale once at the end (the reference
// pre-scales q: equal up to f32 rounding); dK and dV stay in f32 registers
// across the whole query group, walked in head order, and are stored once:
// no atomics, bitwise reproducible.
//
// f32 dK/dV -> flash_bwd_dkv_kernel / flash_bwd_dkv_gqa_kernel (CUDA cores,
// dkv_tile): the first body, products as f32 FMAs over tiles staged as f32 in
// shared memory. Tensor cores have no full-precision f32 product and the f32
// parity paths hold the card to the CPU at 1e-4, so f32 keeps it; so does
// f32 dQ (flash_bwd_dq_kernel).
//
// Design of the CUDA-core bodies. The TPU runs each grid in order on one
// core; here every (query head or KV head, 64-row tile) is its own CTA, which
// is what fills the card at long sequence and small batch: (B * H) x S/64 CTAs
// for dQ and (B * Hk) x S/64 for dK/dV (3072 and 1024 at the shape above,
// where the fused plan has 12). The sequential TPU grid axis becomes a loop
// inside the CTA:
//   dQ: the CTA stages its q tile (pre-scaled), its dO tile, lse and Delta once,
//   then walks the visible k tiles of its query head's KV head (qh / g, the
//   reference's _kv_row_map), staging K/V as f32 in shared memory, and keeps
//   its dQ tile in f32 registers (4 rows x D/16 dims per thread);
//   dK/dV: the CTA stages its K/V tile once and, for each of the g query heads
//   of its KV head in order (the Pallas grid's innermost group axis), walks the
//   visible q tiles, keeping dK/dV in f32 registers across the whole group.
// Each output element is written by one thread after one fixed-order sum: no
// atomics, bitwise reproducible. Under the causal mask the q tiles with the
// most visible keys are launched first (and the k tiles with the most visible
// queries), so the long CTAs do not trail the launch. Shared-memory tiles are
// padded by one float per row, so lanes reading different rows hit different
// banks.

#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "flash_bwd_delta.cuh"
#include "flash_bwd_wgmma.cuh"
#include "hopper_mma.cuh"

namespace {

constexpr int kBlk = 64;            // q rows and keys per tile
constexpr int kThreads = 256;       // 16 x 16 threads
constexpr int kLP = kBlk + 1;       // padded stride of the P / dS tiles

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (4 * kBlk * (D + 1)   // Q, dO, K, V
                          + kBlk * kLP         // dS
                          + 2 * kBlk);         // lse, Delta of the q tile
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (4 * kBlk * (D + 1)   // Q, dO, K, V
                          + 2 * kBlk * kLP     // P, dS
                          + 2 * kBlk);         // lse, Delta of the q tile
}

// S = Q K^T and dP = dO V^T for one (q tile, k tile) pair, then P and dS:
// thread (ty, tx) owns rows ty + 16 i and keys tx + 16 j. Writes dS (and P when
// ps is not null) into shared memory; the caller syncs before reading them.
template <int D>
__device__ __forceinline__ void pair_p_ds(const float* qs, const float* dos, const float* ks,
                                          const float* vs, const float* lse_s,
                                          const float* delta_s, float* ps, float* dss, int q0,
                                          int k0, int sq, int sk, int q_base, int kv_base,
                                          int causal, int window) {
  constexpr int LD = D + 1;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float sc[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int c = 0; c < D; ++c) {
    float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[i] = qs[(ty + 16 * i) * LD + c];
      ov[i] = dos[(ty + 16 * i) * LD + c];
      kv[i] = ks[(tx + 16 * i) * LD + c];
      vv[i] = vs[(tx + 16 * i) * LD + c];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
        dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int qi = q0 + r;
    const float l = lse_s[r];
    const float dl = delta_s[r];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const int kj = k0 + c;
      bool keep = qi < sq && kj < sk;
      if (causal) {
        const int qpos = q_base + qi, kpos = kv_base + kj;
        keep = keep && kpos <= qpos;
        if (window > 0) keep = keep && kpos > qpos - window;
      }
      const float p = (keep && l > tos::kNegInf) ? expf(sc[i][j] - l) : 0.f;
      if (ps != nullptr) ps[r * kLP + c] = p;
      dss[r * kLP + c] = p * (dp[i][j] - dl);
    }
  }
}

// Stages rows [r0, r0 + 64) of one head of x ([.., S, heads, d] with `row`
// elements between positions; rows past `s` and columns past d read 0) into a
// padded f32 tile D columns wide, times `mul`.
template <int D, typename T>
__device__ __forceinline__ void stage_tile(float* dst, const T* src, long row, int r0, int s,
                                           int d, float mul) {
  constexpr int LD = D + 1;
  for (int idx = threadIdx.x; idx < kBlk * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    const int pos = r0 + r;
    dst[r * LD + c] = pos < s && c < d ? tos::to_float(src[pos * row + c]) * mul : 0.f;
  }
}

// dQ of one (batch, query head, 64-row q tile): grid (B * H, Sq / 64), the q
// tile with the most visible keys first.
template <int D, typename T>
__global__ void __launch_bounds__(kThreads, D == 64 ? 2 : 1)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        T* __restrict__ dq, int sq, int sk, int h, int hk, int d, int q_base,
                        int kv_base, int causal, int window, float scale) {
  constexpr int LD = D + 1;
  constexpr int kDC = D / 16;  // dims per thread in the D-wide product
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + kBlk * LD;
  float* ks = dos + kBlk * LD;
  float* vs = ks + kBlk * LD;
  float* dss = vs + kBlk * LD;
  float* lse_s = dss + kBlk * kLP;
  float* delta_s = lse_s + kBlk;

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int b = blockIdx.x / h;
  const int qh = blockIdx.x % h;
  const int kvh = qh / (h / hk);
  const int n_qt = (sq + kBlk - 1) / kBlk;
  const int n_kt = (sk + kBlk - 1) / kBlk;
  const int qt = causal ? n_qt - 1 - static_cast<int>(blockIdx.y) : static_cast<int>(blockIdx.y);
  const int q0 = qt * kBlk;
  const int q_rows = min(kBlk, sq - q0);
  const long q_row = static_cast<long>(h) * d;   // stride between positions
  const long kv_row = static_cast<long>(hk) * d;
  const long head_off = static_cast<long>(b) * sq * q_row + static_cast<long>(qh) * d;
  const long kv_off = static_cast<long>(b) * sk * kv_row + static_cast<long>(kvh) * d;
  const float* lse_h = lse + (static_cast<long>(b) * h + qh) * sq;
  const float* delta_h = delta + (static_cast<long>(b) * h + qh) * sq;

  stage_tile<D>(qs, q + head_off, q_row, q0, sq, d, scale);
  stage_tile<D>(dos, dout + head_off, q_row, q0, sq, d, 1.f);
  if (tid < kBlk) {
    lse_s[tid] = tid < q_rows ? lse_h[q0 + tid] : tos::kNegInf;
    delta_s[tid] = tid < q_rows ? delta_h[q0 + tid] : 0.f;
  }

  // visible k tiles: _window_k_lo .. _causal_k_hi, from the tile's first and
  // last row
  int lo = 0, hi = n_kt;
  if (causal)
    hi = tos::clamp_int(tos::floor_div(q_base + q0 + q_rows - 1 - kv_base, kBlk) + 1, 0, n_kt);
  if (causal && window > 0)
    lo = tos::clamp_int(tos::floor_div(q_base + q0 - (window - 1) - kv_base, kBlk), 0, n_kt);

  float acc[4][kDC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kDC; ++j) acc[i][j] = 0.f;

  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * kBlk;
    __syncthreads();  // the previous tile's K and dS are no longer read
    stage_tile<D>(ks, k + kv_off, kv_row, k0, sk, d, 1.f);
    stage_tile<D>(vs, v + kv_off, kv_row, k0, sk, d, 1.f);
    __syncthreads();
    pair_p_ds<D>(qs, dos, ks, vs, lse_s, delta_s, nullptr, dss, q0, k0, sq, sk, q_base,
                 kv_base, causal, window);
    __syncthreads();
    // dQ tile += dS K: rows ty + 16 i, dims tx + 16 j
#pragma unroll 4
    for (int c = 0; c < kBlk; ++c) {
      float sv[4], kv[kDC];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = dss[(ty + 16 * i) * kLP + c];
#pragma unroll
      for (int j = 0; j < kDC; ++j) kv[j] = ks[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kDC; ++j) acc[i][j] = fmaf(sv[i], kv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= q_rows) continue;
    T* dst = dq + head_off + (q0 + r) * q_row;
#pragma unroll
    for (int j = 0; j < kDC; ++j)
      if (tx + 16 * j < d) dst[tx + 16 * j] = tos::from_float<T>(acc[i][j] * scale);
  }
}

// dK / dV of one (batch, KV head, 64-key tile), summed over the g = H / Hk
// query heads of the KV head in head order: grid (B * Hk, Sk / 64), the k tile
// with the most visible queries first. g == 1 is the MHA kernel.
template <int D, typename T>
__device__ __forceinline__ void dkv_tile(const T* __restrict__ q, const T* __restrict__ k,
                                         const T* __restrict__ v, const T* __restrict__ dout,
                                         const float* __restrict__ lse,
                                         const float* __restrict__ delta, T* __restrict__ dk,
                                         T* __restrict__ dv, int sq, int sk, int h, int hk,
                                         int d, int q_base, int kv_base, int causal, int window,
                                         float scale, float* smem) {
  constexpr int LD = D + 1;
  constexpr int kDC = D / 16;
  float* qs = smem;
  float* dos = qs + kBlk * LD;
  float* ks = dos + kBlk * LD;
  float* vs = ks + kBlk * LD;
  float* ps = vs + kBlk * LD;
  float* dss = ps + kBlk * kLP;
  float* lse_s = dss + kBlk * kLP;
  float* delta_s = lse_s + kBlk;

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int b = blockIdx.x / hk;
  const int kvh = blockIdx.x % hk;
  const int grp = h / hk;
  const int n_qt = (sq + kBlk - 1) / kBlk;
  const int k0 = static_cast<int>(blockIdx.y) * kBlk;
  const int k_rows = min(kBlk, sk - k0);
  const long q_row = static_cast<long>(h) * d;
  const long kv_row = static_cast<long>(hk) * d;
  const long kv_off = static_cast<long>(b) * sk * kv_row + static_cast<long>(kvh) * d;

  stage_tile<D>(ks, k + kv_off, kv_row, k0, sk, d, 1.f);
  stage_tile<D>(vs, v + kv_off, kv_row, k0, sk, d, 1.f);

  // visible q tiles: _causal_q_lo .. _window_q_hi, from the tile's first and
  // last key
  int lo = 0, hi = n_qt;
  if (causal) lo = max(0, tos::floor_div(kv_base + k0 - q_base, kBlk));
  if (causal && window > 0)
    hi = tos::clamp_int(
        tos::floor_div(kv_base + k0 + k_rows - 1 + (window - 1) - q_base, kBlk) + 1, 0, n_qt);

  float dk_acc[4][kDC], dv_acc[4][kDC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kDC; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  for (int gh = 0; gh < grp; ++gh) {
    const int qh = kvh * grp + gh;
    const long head_off = static_cast<long>(b) * sq * q_row + static_cast<long>(qh) * d;
    const float* lse_h = lse + (static_cast<long>(b) * h + qh) * sq;
    const float* delta_h = delta + (static_cast<long>(b) * h + qh) * sq;
    for (int qt = lo; qt < hi; ++qt) {
      const int q0 = qt * kBlk;
      __syncthreads();  // the previous pair's tiles are no longer read
      stage_tile<D>(qs, q + head_off, q_row, q0, sq, d, scale);
      stage_tile<D>(dos, dout + head_off, q_row, q0, sq, d, 1.f);
      if (tid < kBlk) {
        const int s = q0 + tid;
        lse_s[tid] = s < sq ? lse_h[s] : tos::kNegInf;
        delta_s[tid] = s < sq ? delta_h[s] : 0.f;
      }
      __syncthreads();
      pair_p_ds<D>(qs, dos, ks, vs, lse_s, delta_s, ps, dss, q0, k0, sq, sk, q_base, kv_base,
                   causal, window);
      __syncthreads();
      // dV += P^T dO, dK += dS^T Q: keys ty + 16 i, dims tx + 16 j
#pragma unroll 4
      for (int r = 0; r < kBlk; ++r) {
        float pv[4], sv[4], ov[kDC], qv[kDC];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = ps[r * kLP + ty + 16 * i];
          sv[i] = dss[r * kLP + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < kDC; ++j) {
          ov[j] = dos[r * LD + tx + 16 * j];
          qv[j] = qs[r * LD + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < kDC; ++j) {
            dv_acc[i][j] = fmaf(pv[i], ov[j], dv_acc[i][j]);
            dk_acc[i][j] = fmaf(sv[i], qv[j], dk_acc[i][j]);
          }
      }
    }
  }

  // q was pre-scaled, so dK absorbs the scale; one rounding to k's dtype
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= k_rows) continue;
    const long off = kv_off + (k0 + r) * kv_row;
#pragma unroll
    for (int j = 0; j < kDC; ++j) {
      if (tx + 16 * j >= d) continue;
      dk[off + tx + 16 * j] = tos::from_float<T>(dk_acc[i][j]);
      dv[off + tx + 16 * j] = tos::from_float<T>(dv_acc[i][j]);
    }
  }
}

// Two entry kernels over one body, so a profile tells the MHA plan
// (_attn_bwd_dkv_kernel) from the grouped one (_attn_bwd_dkv_gqa_kernel).
template <int D, typename T>
__global__ void __launch_bounds__(kThreads, D == 64 ? 2 : 1)
    flash_bwd_dkv_kernel(const T* q, const T* k, const T* v, const T* dout, const float* lse,
                         const float* delta, T* dk, T* dv, int sq, int sk, int h, int hk, int d,
                         int q_base, int kv_base, int causal, int window, float scale) {
  extern __shared__ float smem[];
  dkv_tile<D, T>(q, k, v, dout, lse, delta, dk, dv, sq, sk, h, hk, d, q_base, kv_base, causal,
                 window, scale, smem);
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads, D == 64 ? 2 : 1)
    flash_bwd_dkv_gqa_kernel(const T* q, const T* k, const T* v, const T* dout,
                             const float* lse, const float* delta, T* dk, T* dv, int sq,
                             int sk, int h, int hk, int d, int q_base, int kv_base, int causal,
                             int window, float scale) {
  extern __shared__ float smem[];
  dkv_tile<D, T>(q, k, v, dout, lse, delta, dk, dv, sq, sk, h, hk, d, q_base, kv_base, causal,
                 window, scale, smem);
}

// Sets a kernel's dynamic shared-memory limit once per device.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, int device, unsigned long long* configured) {
  const unsigned long long bit = 1ull << (device & 63);
  if (*configured & bit) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (e == cudaSuccess) *configured |= bit;
  return e;
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  int b, sq, sk, h, hk, d, q_base, kv_base, causal, window;
  float scale;
  int device;
  cudaStream_t stream;
};

template <int D, typename T>
cudaError_t launch_dq(const Args& a, void* dq) {
  static unsigned long long configured = 0;
  constexpr size_t smem = dq_smem_bytes<D>();
  cudaError_t e = allow_smem(flash_bwd_dq_kernel<D, T>, smem, a.device, &configured);
  if (e != cudaSuccess) return e;
  const dim3 grid(a.b * a.h, (a.sq + kBlk - 1) / kBlk);
  flash_bwd_dq_kernel<D, T><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.delta, static_cast<T*>(dq), a.sq, a.sk, a.h,
      a.hk, a.d, a.q_base, a.kv_base, a.causal, a.window, a.scale);
  return cudaGetLastError();
}

template <int D, typename T>
cudaError_t launch_dkv(const Args& a, void* dk, void* dv) {
  static unsigned long long configured_mha = 0, configured_gqa = 0;
  constexpr size_t smem = dkv_smem_bytes<D>();
  const bool grouped = a.h != a.hk;
  auto kernel = grouped ? &flash_bwd_dkv_gqa_kernel<D, T> : &flash_bwd_dkv_kernel<D, T>;
  cudaError_t e =
      allow_smem(kernel, smem, a.device, grouped ? &configured_gqa : &configured_mha);
  if (e != cudaSuccess) return e;
  const dim3 grid(a.b * a.hk, (a.sk + kBlk - 1) / kBlk);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.delta, static_cast<T*>(dk), static_cast<T*>(dv),
      a.sq, a.sk, a.h, a.hk, a.d, a.q_base, a.kv_base, a.causal, a.window, a.scale);
  return cudaGetLastError();
}

// -- bf16 dK/dV: wgmma + TMA -------------------------------------------------

namespace sm90 = tos::sm90;
namespace wg = tos::bwd_wg;

template <int D>
struct WgDkvSmem {
  static constexpr int kWgKeys = wg::keys<D>();
  static constexpr int kBQ = wg::block_q<D>();
  static constexpr int kKVBytes = kWgKeys * D * 2;   // the CTA's K (or V) tile
  static constexpr int kQBytes = kBQ * D * 2;        // one Q (or dO) tile
  static constexpr int kStageBytes = 2 * kQBytes;    // Q then dO
  static constexpr size_t kBytes = 1024 + 2 * kKVBytes + wg::kStages * kStageBytes;
};

// dK / dV of one (batch, KV head, 128-key tile; 64 at a padded width of
// 128), summed over the g = H / Hk query heads of the KV head in head order
// (g == 1: MHA). d: the head_dim.
template <int D>
__device__ __forceinline__ void dkv_tile_wgmma(const CUtensorMap* tm_q, const CUtensorMap* tm_k,
                                               const CUtensorMap* tm_v, const CUtensorMap* tm_do,
                                               const float* __restrict__ lse,
                                               const float* __restrict__ delta,
                                               __nv_bfloat16* __restrict__ dk,
                                               __nv_bfloat16* __restrict__ dv, int sq, int sk,
                                               int h, int hk, int d, int q_base, int kv_base,
                                               int causal, int window, float scale) {
  using S = WgDkvSmem<D>;
  constexpr int kBQ = S::kBQ;
  constexpr int kWgKeys = S::kWgKeys;
  constexpr int kStages = wg::kStages;
  constexpr int kProducer = 4 * wg::consumers<D>();  // the producer warp's index
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bar_kv, full[kStages], empty[kStages];
  __shared__ float lse_s[kStages][kBQ], delta_s[kStages][kBQ];
  uint8_t* k_tile = sm90::align_1024(smem_raw);
  uint8_t* v_tile = k_tile + S::kKVBytes;
  uint8_t* ring = v_tile + S::kKVBytes;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x / hk;
  const int kvh = blockIdx.x % hk;
  const int grp = h / hk;
  const int n_qt = (sq + kBQ - 1) / kBQ;
  const int k0 = static_cast<int>(blockIdx.y) * kWgKeys;  // under causal: most queries first
  const int k_last = min(sk, k0 + kWgKeys) - 1;

  // visible q tiles of the CTA: _causal_q_lo .. _window_q_hi from its first
  // and last key
  int lo = 0, hi = n_qt;
  if (causal) lo = tos::clamp_int(tos::floor_div(kv_base + k0 - q_base, kBQ), 0, n_qt);
  if (causal && window > 0)
    hi = tos::clamp_int(tos::floor_div(kv_base + k_last + (window - 1) - q_base, kBQ) + 1, 0,
                        n_qt);
  const int steps = grp * max(0, hi - lo);   // (query head, q tile) pairs, head-major

  if (threadIdx.x == 0) {
    sm90::mbar_init(&bar_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 32);    // every producer lane (lse, Delta) + the TMA bytes
      sm90::mbar_init(&empty[s], kProducer);  // one arrival per consumer warp
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (warp == kProducer) {  // producer warp
    if (lane == 0 && steps > 0) {  // no copy may be left in flight at exit
      sm90::mbar_arrive_expect_tx(&bar_kv, 2 * S::kKVBytes);
#pragma unroll
      for (int j = 0; j < D / 64; ++j) {
        sm90::tma_load_4d(k_tile + j * kWgKeys * sm90::kRowBytes, tm_k, &bar_kv, 64 * j, kvh, k0,
                          b);
        sm90::tma_load_4d(v_tile + j * kWgKeys * sm90::kRowBytes, tm_v, &bar_kv, 64 * j, kvh, k0,
                          b);
      }
    }
    for (int i = 0; i < steps; ++i) {
      const int qh = kvh * grp + i / (hi - lo);
      const int q0 = (lo + i % (hi - lo)) * kBQ;
      const int s = i % kStages, use = i / kStages;
      if (use > 0) sm90::mbar_wait(&empty[s], (use - 1) & 1);
      if (lane == 0) {
        uint8_t* q_tile = ring + s * S::kStageBytes;
        uint8_t* do_tile = q_tile + S::kQBytes;
        sm90::mbar_expect_tx(&full[s], S::kStageBytes);
#pragma unroll
        for (int j = 0; j < D / 64; ++j) {
          sm90::tma_load_4d(q_tile + j * kBQ * sm90::kRowBytes, tm_q, &full[s], 64 * j, qh, q0, b);
          sm90::tma_load_4d(do_tile + j * kBQ * sm90::kRowBytes, tm_do, &full[s], 64 * j, qh, q0,
                            b);
        }
      }
      wg::stage_rows<kBQ>(lse, delta, (static_cast<long>(b) * h + qh) * sq, q0, sq, lse_s[s],
                          delta_s[s], lane);
      sm90::mbar_arrive(&full[s]);
    }
    return;
  }

  const int wgi = warp >> 2;
  const int quad = lane & 3;
  const int key0 = k0 + wgi * 64 + (warp & 3) * 16 + (lane >> 2);   // and key0 + 8
  const int wg_first = k0 + wgi * 64;
  const int wg_last = min(sk, wg_first + 64) - 1;
  const bool has_keys = wg_first < sk;
  // the q tiles this warpgroup's keys are visible from
  int wg_lo = lo, wg_hi = hi;
  if (causal) wg_lo = max(lo, tos::floor_div(kv_base + wg_first - q_base, kBQ));
  if (causal && window > 0)
    wg_hi = min(hi, tos::floor_div(kv_base + wg_last + (window - 1) - q_base, kBQ) + 1);

  const float sl2 = scale * wg::kLog2e;
  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int x = 0; x < D / 2; ++x) dk_acc[x] = dv_acc[x] = 0.f;
  const uint32_t k_addr = sm90::smem_u32(k_tile) + wgi * 64 * sm90::kRowBytes;
  const uint32_t v_addr = sm90::smem_u32(v_tile) + wgi * 64 * sm90::kRowBytes;

  if (steps > 0) sm90::mbar_wait(&bar_kv, 0);
  for (int i = 0; i < steps; ++i) {
    const int qt = lo + i % (hi - lo);
    const int q0 = qt * kBQ;
    const int s = i % kStages;
    sm90::mbar_wait(&full[s], (i / kStages) & 1);
    if (has_keys && qt >= wg_lo && qt < wg_hi) {
      const uint32_t q_addr = sm90::smem_u32(ring + s * S::kStageBytes);
      const uint32_t do_addr = q_addr + S::kQBytes;
      // S^T = K Q^T and dP^T = V dO^T: keys x q rows, K-major operands
      float st[kBQ / 2], dpt[kBQ / 2];
      sm90::wgmma_fence();
#pragma unroll
      for (int k = 0; k < D / 16; ++k) {
        sm90::wgmma_ss<kBQ>(st, sm90::desc_k_major(k_addr, kWgKeys * sm90::kRowBytes, k),
                               sm90::desc_k_major(q_addr, kBQ * sm90::kRowBytes, k), k > 0);
        sm90::wgmma_ss<kBQ>(dpt, sm90::desc_k_major(v_addr, kWgKeys * sm90::kRowBytes, k),
                               sm90::desc_k_major(do_addr, kBQ * sm90::kRowBytes, k), k > 0);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(st);
      sm90::fence_regs(dpt);

      // P^T = exp(s * scale - lse), 0 where masked or where the row saw no
      // key; dS^T = P^T (dP^T - Delta). Masks only on the causal diagonal
      // and the window's edge: keys past sk are never stored, and rows past
      // sq carry lse = +inf.
      const bool need =
          causal && (kv_base + wg_last > q_base + q0 ||
                     (window > 0 && kv_base + wg_first <= q_base + q0 + kBQ - 1 - window));
#pragma unroll
      for (int j = 0; j < kBQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + 2 * quad + e;
          const float lc = lse_s[s][c], dc = delta_s[s][c];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int x = 4 * j + 2 * r + e;
            float p = sm90::exp2_approx(fmaf(st[x], sl2, -lc));
            if (need) {
              const int qpos = q_base + q0 + c, kpos = kv_base + key0 + 8 * r;
              bool keep = kpos <= qpos;
              if (window > 0) keep = keep && kpos > qpos - window;
              p = keep ? p : 0.f;
            }
            st[x] = p;
            dpt[x] = p * (dpt[x] - dc);
          }
        }
      // dV += P^T dO and dK += dS^T Q: A from registers, B MN-major
      uint32_t pf[kBQ / 16][4], dsf[kBQ / 16][4];
#pragma unroll
      for (int k = 0; k < kBQ / 16; ++k) {
        sm90::a_frag_from_acc(st, k, pf[k]);
        sm90::a_frag_from_acc(dpt, k, dsf[k]);
      }
      sm90::wgmma_fence();
#pragma unroll
      for (int k = 0; k < kBQ / 16; ++k) {
        sm90::wgmma_rs<D>(dv_acc, pf[k], sm90::desc_mn_major(do_addr, kBQ * sm90::kRowBytes, k),
                             1);
        sm90::wgmma_rs<D>(dk_acc, dsf[k], sm90::desc_mn_major(q_addr, kBQ * sm90::kRowBytes, k),
                             1);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dv_acc);
      sm90::fence_regs(dk_acc);
    }
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&empty[s]);  // this warp is done with the stage
  }

  // dK takes the scale once (q was not pre-scaled); one rounding to bf16
  const long kv_row = static_cast<long>(hk) * d;
  wg::store_dkv<D>(dk_acc, dv_acc, dk, dv,
                   (static_cast<long>(b) * sk + key0) * kv_row + static_cast<long>(kvh) * d,
                   kv_row, key0, sk, d, scale);
}

// Two entry kernels over one body, so a profile tells the MHA plan
// (_attn_bwd_dkv_kernel) from the grouped one (_attn_bwd_dkv_gqa_kernel).
template <int D>
__global__ void __launch_bounds__(wg::threads<D>(), 1)
    flash_bwd_dkv_kernel_wgmma(const __grid_constant__ CUtensorMap tm_q,
                               const __grid_constant__ CUtensorMap tm_k,
                               const __grid_constant__ CUtensorMap tm_v,
                               const __grid_constant__ CUtensorMap tm_do, const float* lse,
                               const float* delta, __nv_bfloat16* dk, __nv_bfloat16* dv, int sq,
                               int sk, int h, int hk, int d, int q_base, int kv_base, int causal,
                               int window, float scale) {
  dkv_tile_wgmma<D>(&tm_q, &tm_k, &tm_v, &tm_do, lse, delta, dk, dv, sq, sk, h, hk, d, q_base,
                    kv_base, causal, window, scale);
}

template <int D>
__global__ void __launch_bounds__(wg::threads<D>(), 1)
    flash_bwd_dkv_gqa_kernel_wgmma(const __grid_constant__ CUtensorMap tm_q,
                                   const __grid_constant__ CUtensorMap tm_k,
                                   const __grid_constant__ CUtensorMap tm_v,
                                   const __grid_constant__ CUtensorMap tm_do, const float* lse,
                                   const float* delta, __nv_bfloat16* dk, __nv_bfloat16* dv,
                                   int sq, int sk, int h, int hk, int d, int q_base, int kv_base,
                                   int causal, int window, float scale) {
  dkv_tile_wgmma<D>(&tm_q, &tm_k, &tm_v, &tm_do, lse, delta, dk, dv, sq, sk, h, hk, d, q_base,
                    kv_base, causal, window, scale);
}

// -- bf16 dQ: wgmma + TMA ----------------------------------------------------

constexpr int kDqRows = 128;               // q rows per CTA: two warpgroups of 64
constexpr int kDqKeys = 64;                // keys per K/V tile
constexpr int kDqStages = 4;               // K/V ring depth
constexpr int kDqThreads = 256;            // thread 0 also issues the copies

template <int D>
struct WgDqSmem {
  static constexpr int kQBytes = kDqRows * D * 2;    // the Q (or dO) tile
  static constexpr int kKVBytes = kDqKeys * D * 2;   // one K (or V) tile
  static constexpr int kStageBytes = 2 * kKVBytes;   // K then V
  static constexpr size_t kBytes = 1024 + 2 * kQBytes + kDqStages * kStageBytes;
};

// Copies K/V tile `kt` into the ring stage of the `i`-th visible tile.
template <int D>
__device__ __forceinline__ void issue_dq_kv(uint8_t* ring, uint64_t* full,
                                            const CUtensorMap* tm_k, const CUtensorMap* tm_v,
                                            int i, int kt, int kvh, int b) {
  using S = WgDqSmem<D>;
  const int s = i % kDqStages;
  uint8_t* k_tile = ring + s * S::kStageBytes;
  uint8_t* v_tile = k_tile + S::kKVBytes;
  sm90::mbar_arrive_expect_tx(&full[s], S::kStageBytes);
#pragma unroll
  for (int j = 0; j < D / 64; ++j) {
    sm90::tma_load_4d(k_tile + j * kDqKeys * sm90::kRowBytes, tm_k, &full[s], 64 * j, kvh,
                      kt * kDqKeys, b);
    sm90::tma_load_4d(v_tile + j * kDqKeys * sm90::kRowBytes, tm_v, &full[s], 64 * j, kvh,
                      kt * kDqKeys, b);
  }
}

// dQ of one (batch, query head, 128-row q tile): the forward's loop
// (flash_attention.cu, flash_fwd_kernel_wgmma) with the lse already known.
// Two CTAs an SM at a padded width D of 64, one at 128. d: the head_dim.
template <int D>
__global__ void __launch_bounds__(kDqThreads, D == 64 ? 2 : 1)
    flash_bwd_dq_kernel_wgmma(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              const __grid_constant__ CUtensorMap tm_do,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              __nv_bfloat16* __restrict__ dq, int sq, int sk, int h, int hk,
                              int d, int q_base, int kv_base, int causal, int window,
                              float scale) {
  using S = WgDqSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bar_q, full[kDqStages], empty[kDqStages];
  uint8_t* q_tile = sm90::align_1024(smem_raw);
  uint8_t* do_tile = q_tile + S::kQBytes;
  uint8_t* ring = do_tile + S::kQBytes;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int bh = blockIdx.x;
  const int b = bh / h;
  const int qh = bh % h;
  const int kvh = qh / (h / hk);
  const int n_qt = (sq + kDqRows - 1) / kDqRows;
  const int qt = causal ? n_qt - 1 - static_cast<int>(blockIdx.y) : static_cast<int>(blockIdx.y);
  const int q0 = qt * kDqRows;
  const int n_kt = (sk + kDqKeys - 1) / kDqKeys;

  // visible k tiles of the CTA: _window_k_lo .. _causal_k_hi from its first
  // and last real row
  int lo = 0, hi = n_kt;
  if (causal)
    hi = tos::clamp_int(tos::floor_div(q_base + min(sq, q0 + kDqRows) - 1 - kv_base, kDqKeys) + 1,
                        0, n_kt);
  if (causal && window > 0)
    lo = tos::clamp_int(tos::floor_div(q_base + q0 - (window - 1) - kv_base, kDqKeys), 0, n_kt);

  if (threadIdx.x == 0) {
    sm90::mbar_init(&bar_q, 1);
    for (int s = 0; s < kDqStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], kDqThreads / 32);  // one arrival per warp
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  // thread 0 issues every copy: Q and dO here with the first kDqStages K/V
  // tiles, each later tile once every warp is done with the stage it reuses
  const int n_tiles = hi - lo;
  if (threadIdx.x == 0 && n_tiles > 0) {
    sm90::mbar_arrive_expect_tx(&bar_q, 2 * S::kQBytes);
#pragma unroll
    for (int j = 0; j < D / 64; ++j) {
      sm90::tma_load_4d(q_tile + j * kDqRows * sm90::kRowBytes, &tm_q, &bar_q, 64 * j, qh, q0, b);
      sm90::tma_load_4d(do_tile + j * kDqRows * sm90::kRowBytes, &tm_do, &bar_q, 64 * j, qh, q0,
                        b);
    }
    for (int i = 0; i < min(n_tiles, kDqStages); ++i)
      issue_dq_kv<D>(ring, full, &tm_k, &tm_v, i, lo + i, kvh, b);
  }

  // consumer warpgroup g: q rows q0 + 64 g .. + 63; this thread's two rows
  const int wgi = warp >> 2;
  const int quad = lane & 3;
  const int row0 = q0 + wgi * 64 + (warp & 3) * 16 + (lane >> 2);   // and row0 + 8
  const int wg_first = q0 + wgi * 64;
  const int wg_last = min(sq, wg_first + 64) - 1;
  // the tiles this warpgroup's rows can see (none when it has no real row)
  int wg_lo = lo, wg_hi = wg_first < sq ? hi : lo;
  if (causal && wg_first < sq)
    wg_hi = min(hi, tos::clamp_int(tos::floor_div(q_base + wg_last - kv_base, kDqKeys) + 1, 0,
                                   n_kt));
  if (causal && window > 0)
    wg_lo = max(lo, tos::clamp_int(
                        tos::floor_div(q_base + wg_first - (window - 1) - kv_base, kDqKeys), 0,
                        n_kt));

  // this thread's rows' lse (log2 units, +inf for a row past sq or one that
  // saw no key: its P is 0) and Delta, held in registers
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const long at = static_cast<long>(bh) * sq + row;
    lse2[r] = wg::lse_log2(row < sq ? lse[at] : tos::kNegInf);
    dlt[r] = row < sq ? delta[at] : 0.f;
  }

  const float sl2 = scale * wg::kLog2e;
  float acc[D / 2];
#pragma unroll
  for (int x = 0; x < D / 2; ++x) acc[x] = 0.f;
  const uint32_t q_addr = sm90::smem_u32(q_tile) + wgi * 64 * sm90::kRowBytes;
  const uint32_t do_addr = sm90::smem_u32(do_tile) + wgi * 64 * sm90::kRowBytes;

  if (lo < hi) sm90::mbar_wait(&bar_q, 0);
  for (int kt = lo; kt < hi; ++kt) {
    const int i = kt - lo, s = i % kDqStages;
    sm90::mbar_wait(&full[s], (i / kDqStages) & 1);
    if (kt >= wg_lo && kt < wg_hi) {
      const uint32_t k_addr = sm90::smem_u32(ring + s * S::kStageBytes);
      const uint32_t v_addr = k_addr + S::kKVBytes;
      // S = Q K^T and dP = dO V^T: q rows x keys, K-major operands, one wait
      float sc[kDqKeys / 2], dp[kDqKeys / 2];
      sm90::wgmma_fence();
#pragma unroll
      for (int k = 0; k < D / 16; ++k) {
        sm90::wgmma_ss<kDqKeys>(sc, sm90::desc_k_major(q_addr, kDqRows * sm90::kRowBytes, k),
                                sm90::desc_k_major(k_addr, kDqKeys * sm90::kRowBytes, k), k > 0);
        sm90::wgmma_ss<kDqKeys>(dp, sm90::desc_k_major(do_addr, kDqRows * sm90::kRowBytes, k),
                                sm90::desc_k_major(v_addr, kDqKeys * sm90::kRowBytes, k), k > 0);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sc);
      sm90::fence_regs(dp);

      // P = exp(s * scale - lse), 0 where masked or where the row saw no
      // key; dS = P (dP - Delta), into sc. Masks only where a key of the
      // tile can be hidden from a row of the warpgroup: the causal diagonal,
      // the window's edge, keys past sk (TMA reads them as zeros, and exp2
      // of a zero score against a very negative lse need not be finite)
      const int k0 = kt * kDqKeys;
      const bool need = k0 + kDqKeys > sk ||
                        (causal && kv_base + k0 + kDqKeys - 1 > q_base + wg_first) ||
                        (causal && window > 0 && kv_base + k0 <= q_base + wg_last - window);
#pragma unroll
      for (int j = 0; j < kDqKeys / 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int x = 4 * j + 2 * r + e;
            float p = sm90::exp2_approx(fmaf(sc[x], sl2, -lse2[r]));
            if (need) {
              const int col = k0 + 8 * j + 2 * quad + e;
              const int qpos = q_base + row0 + 8 * r, kpos = kv_base + col;
              bool keep = col < sk;
              if (causal) {
                keep = keep && kpos <= qpos;
                if (window > 0) keep = keep && kpos > qpos - window;
              }
              p = keep ? p : 0.f;
            }
            sc[x] = p * (dp[x] - dlt[r]);
          }
      // dQ += dS K: A = dS rounded to bf16 in registers, B = the same K tile
      // read MN-major (the forward's O += P V with K in V's place)
      uint32_t dsf[kDqKeys / 16][4];
#pragma unroll
      for (int k = 0; k < kDqKeys / 16; ++k) sm90::a_frag_from_acc(sc, k, dsf[k]);
      sm90::wgmma_fence();
#pragma unroll
      for (int k = 0; k < kDqKeys / 16; ++k)
        sm90::wgmma_rs<D>(acc, dsf[k], sm90::desc_mn_major(k_addr, kDqKeys * sm90::kRowBytes, k),
                          1);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
    }
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&empty[s]);  // this warp is done with the stage
    // the previous tile's stage takes the tile kDqStages after it; waiting
    // one tile back leaves the other warpgroup a tile of slack
    const int prev = i - 1;
    if (threadIdx.x == 0 && prev >= 0 && prev + kDqStages < n_tiles) {
      sm90::mbar_wait(&empty[prev % kDqStages], (prev / kDqStages) & 1);
      issue_dq_kv<D>(ring, full, &tm_k, &tm_v, prev + kDqStages, lo + prev + kDqStages, kvh, b);
    }
    __syncwarp();
  }

  // dQ = scale * sum dS K, one rounding to bf16; no row past sq, no column
  // past d. A row (or warpgroup) that saw no key stores zeros.
  const long q_row = static_cast<long>(h) * d;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= sq) continue;
    __nv_bfloat16* dst = dq + (static_cast<long>(b) * sq + row) * q_row +
                         static_cast<long>(qh) * d + 2 * quad;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      if (8 * j < d)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
            __floats2bfloat162_rn(acc[4 * j + 2 * r] * scale, acc[4 * j + 2 * r + 1] * scale);
  }
}

template <int D>
cudaError_t launch_dq_wgmma(const Args& a, void* dq) {
  static unsigned long long configured = 0;
  constexpr size_t smem = WgDqSmem<D>::kBytes;
  cudaError_t e = allow_smem(flash_bwd_dq_kernel_wgmma<D>, smem, a.device, &configured);
  if (e != cudaSuccess) return e;
  CUtensorMap mq, mk, mv, mdo;
  e = sm90::encode_bshd_map(&mq, a.q, a.b, a.sq, a.h, a.d, kDqRows);
  if (e == cudaSuccess) e = sm90::encode_bshd_map(&mdo, a.dout, a.b, a.sq, a.h, a.d, kDqRows);
  if (e == cudaSuccess) e = sm90::encode_bshd_map(&mk, a.k, a.b, a.sk, a.hk, a.d, kDqKeys);
  if (e == cudaSuccess) e = sm90::encode_bshd_map(&mv, a.v, a.b, a.sk, a.hk, a.d, kDqKeys);
  if (e != cudaSuccess) return e;
  const dim3 grid(a.b * a.h, (a.sq + kDqRows - 1) / kDqRows);
  flash_bwd_dq_kernel_wgmma<D><<<grid, kDqThreads, smem, a.stream>>>(
      mq, mk, mv, mdo, a.lse, a.delta, static_cast<__nv_bfloat16*>(dq), a.sq, a.sk, a.h, a.hk,
      a.d, a.q_base, a.kv_base, a.causal, a.window, a.scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_wgmma(const Args& a, void* dk, void* dv) {
  static unsigned long long configured_mha = 0, configured_gqa = 0;
  constexpr size_t smem = WgDkvSmem<D>::kBytes;
  const bool grouped = a.h != a.hk;
  auto kernel = grouped ? &flash_bwd_dkv_gqa_kernel_wgmma<D> : &flash_bwd_dkv_kernel_wgmma<D>;
  cudaError_t e =
      allow_smem(kernel, smem, a.device, grouped ? &configured_gqa : &configured_mha);
  if (e != cudaSuccess) return e;
  CUtensorMap mq, mk, mv, mdo;
  constexpr int kBQ = wg::block_q<D>();
  e = sm90::encode_bshd_map(&mq, a.q, a.b, a.sq, a.h, a.d, kBQ);
  if (e == cudaSuccess) e = sm90::encode_bshd_map(&mdo, a.dout, a.b, a.sq, a.h, a.d, kBQ);
  constexpr int kKeys = wg::keys<D>();
  if (e == cudaSuccess) e = sm90::encode_bshd_map(&mk, a.k, a.b, a.sk, a.hk, a.d, kKeys);
  if (e == cudaSuccess) e = sm90::encode_bshd_map(&mv, a.v, a.b, a.sk, a.hk, a.d, kKeys);
  if (e != cudaSuccess) return e;
  const dim3 grid(a.b * a.hk, (a.sk + kKeys - 1) / kKeys);
  kernel<<<grid, wg::threads<D>(), smem, a.stream>>>(
      mq, mk, mv, mdo, a.lse, a.delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), a.sq, a.sk, a.h, a.hk, a.d, a.q_base, a.kv_base,
      a.causal, a.window, a.scale);
  return cudaGetLastError();
}

// Runs `launch<D, T>` for the dtype and the padded width of the head_dim.
template <template <int, typename> class L, typename... X>
cudaError_t dispatch(int dtype, int d, X... x) {
  const int dp = tos::padded_head_dim(d);
  if (dtype == tos::kBFloat16 && dp == 64) return L<64, __nv_bfloat16>::run(x...);
  if (dtype == tos::kBFloat16 && dp == 128) return L<128, __nv_bfloat16>::run(x...);
  if (dtype == tos::kFloat32 && dp == 64) return L<64, float>::run(x...);
  if (dtype == tos::kFloat32 && dp == 128) return L<128, float>::run(x...);
  return cudaErrorInvalidValue;
}

// bf16 runs on the tensor cores, f32 on the CUDA cores (see the note above)
template <int D, typename T>
struct DqLauncher {
  static cudaError_t run(const Args& a, void* dq) {
    if constexpr (std::is_same<T, __nv_bfloat16>::value) return launch_dq_wgmma<D>(a, dq);
    else return launch_dq<D, T>(a, dq);
  }
};

template <int D, typename T>
struct DkvLauncher {
  static cudaError_t run(const Args& a, void* dk, void* dv) {
    if constexpr (std::is_same<T, __nv_bfloat16>::value) return launch_dkv_wgmma<D>(a, dk, dv);
    else return launch_dkv<D, T>(a, dk, dv);
  }
};

// Validates the shared arguments and selects the device; returns 0 to go on,
// -1 when there is nothing to do, else a CUDA error code.
int prepare(const Args& a) {
  cudaGetLastError();  // start from a clean error state
  if (a.b <= 0 || a.sq <= 0 || a.sk <= 0 || a.h <= 0) return -1;
  if (a.hk <= 0 || a.h % a.hk != 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaSetDevice(a.device));
}

}  // namespace

// out, dout: [b, sq, h, d] contiguous in `dtype`; g_lse: [b, h, sq] f32 or null;
// delta: [b, h, sq] f32 output. Launches the Delta pre-pass on `stream`.
extern "C" int tos_flash_attention_bwd_delta(const void* out, const void* dout,
                                             const void* g_lse, void* delta, int b, int sq,
                                             int h, int d, int dtype, int device,
                                             void* stream) {
  cudaGetLastError();
  if (b <= 0 || sq <= 0 || h <= 0 || d <= 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gl = static_cast<const float*>(g_lse);
  float* dl = static_cast<float*>(delta);
  if (dtype == tos::kBFloat16)
    return static_cast<int>(
        tos::launch_flash_bwd_delta<__nv_bfloat16>(out, dout, gl, dl, b, sq, h, d, s));
  if (dtype == tos::kFloat32)
    return static_cast<int>(tos::launch_flash_bwd_delta<float>(out, dout, gl, dl, b, sq, h, d, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// q, dout, dq: [b, sq, h, d] and k, v: [b, sk, hk, d], contiguous in `dtype` on
// CUDA device `device`; lse, delta: [b, h, sq] f32 (the forward's lse, the
// pre-pass's Delta). window <= 0 means no window. Launches the dQ kernel on
// `stream`; returns cudaGetLastError().
extern "C" int tos_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                          const void* dout, const void* lse,
                                          const void* delta, void* dq, int b, int sq, int sk,
                                          int h, int hk, int d, int q_base, int kv_base,
                                          int causal, int window, float scale, int dtype,
                                          int device, void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
               b, sq, sk, h, hk, d, q_base, kv_base, causal, window, scale, device,
               static_cast<cudaStream_t>(stream)};
  const int rc = prepare(a);
  if (rc != 0) return rc < 0 ? 0 : rc;
  return static_cast<int>(dispatch<DqLauncher>(dtype, d, a, dq));
}

// As tos_flash_attention_bwd_dq, with dk, dv: [b, sk, hk, d] outputs in
// `dtype`. Launches the MHA dK/dV kernel when h == hk, else the grouped one.
extern "C" int tos_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                           const void* dout, const void* lse,
                                           const void* delta, void* dk, void* dv, int b,
                                           int sq, int sk, int h, int hk, int d, int q_base,
                                           int kv_base, int causal, int window, float scale,
                                           int dtype, int device, void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
               b, sq, sk, h, hk, d, q_base, kv_base, causal, window, scale, device,
               static_cast<cudaStream_t>(stream)};
  const int rc = prepare(a);
  if (rc != 0) return rc < 0 ? 0 : rc;
  return static_cast<int>(dispatch<DkvLauncher>(dtype, d, a, dk, dv));
}
