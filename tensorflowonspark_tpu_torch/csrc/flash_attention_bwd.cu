// Flash-attention backward for Hopper: dQ, dK, dV of causal or windowed
// attention in one pass, with unexpanded grouped K/V and absolute position bases.
//
// Replaces: tensorflowonspark_tpu/ops/flash_attention.py _attn_bwd_fused_kernel
// (MHA, launched by _bwd_impl at :637) and _attn_bwd_fused_gqa_kernel (grouped
// KV, launched at :600). One kernel serves both: a group of g = H / Hk query
// heads shares each KV head, and g == 1 is the MHA kernel. Same function, term
// for term (_pair_p_ds):
//   s = (q * scale) . k in f32, masked like the forward (keep = kv_base + j <=
//   q_base + i, and > q_base + i - window);
//   P is recomputed from the forward's lse: p = exp(s - lse), forced to 0 where
//   the entry is masked or the row saw no key (lse = -1e30);
//   dS = P * (dO . V^T - Delta), Delta = sum_d dO * O - g_lse (the lse cotangent
//   folds into Delta, as in flash_attention_block's VJP);
//   dV = sum_q P^T dO; dK = sum_q dS^T (q * scale); dQ = scale * sum_k dS K;
//   the q-tile loop of each k-tile is bounded like _causal_q_lo / _window_q_hi.
// dQ is accumulated in f32 and cast to q's dtype at the end; dK/dV are
// accumulated in f32 (over the group's heads too) and stored once in k's dtype.
//
// Head dims: every d with 8 <= d <= 128 and d % 8 == 0, in bodies built for a
// padded tile width D (64 or 128, padded_head_dim) that read zeros past
// column d and store no column past d; the scale stays 1/sqrt(d).
//
// Bound on the H100: at the training shape (B 16, S 1024, H 12, D 64, causal)
// the work is 5 products of 2 * D flops for each visible (q, k) pair, about 64
// GFLOP, against ~0.2 GB of inputs and outputs: compute-bound on the bf16
// tensor cores (~0.07 ms).
//
// Grid and ownership (both bodies; deterministic, no atomics). On the TPU, dQ
// rides a block resident in VMEM across the sequential k grid axis. Here that
// grid axis becomes a loop: ONE CTA per (batch, query head) walks every key
// tile in order and, for each, the visible q tiles, keeping the tile's dK/dV
// in registers until the walk over q ends, and adding into an f32 dQ that
// only this CTA owns, rounded once to q's dtype. Every dQ sum therefore runs
// in one fixed order. For MHA the CTA stores its
// dK/dV tile straight into dk/dv. For grouped KV the g query heads of a KV
// head live in g CTAs, so each stores its tile's dK/dV in f32 to a per-head
// partial [B, Hk, g, Sk, D], and a second kernel of this source sums the g
// partials in head order and casts: the sum over the group that the TPU
// kernel carries across its grid, made a fixed-order second pass instead of
// atomics. The gradients are bitwise reproducible. Walking the group inside
// one CTA instead would give B * Hk CTAs, too few to fill the card's 132 SMs
// at the grouped training shape (32 at B 8, Hk 4); this gives B * H (192 at
// the MHA training shape). At a long sequence and a small batch B * H CTAs
// leave most of the card idle (12 at B 1, H 12), which is where the
// reference's rule moves grouped K/V to the split plan. A pre-pass kernel
// (flash_bwd_delta.cuh, shared with the split plan) computes Delta, one warp
// per row. The JAX package switches grouped K/V to its split plan past
// _gqa_fused_fits; the port's wrapper applies the same rule
// (ops/flash_attention.py bwd_plan), so both packages run the same plan.
//
// Two bodies, chosen by dtype in tos_flash_attention_bwd:
//
// bf16 -> flash_bwd_kernel_wgmma (tensor cores). The CTA is two warpgroups
// of 64 keys each, key tiles of 128 keys and q tiles of 64 rows (at a padded
// width of 128: one warpgroup, 64 keys, 32 rows; as the split plan's dK/dV,
// flash_bwd_wgmma.cuh). It has no producer warp: a ninth warp would cap the
// CTA at 168 registers a thread (the register file's four quarters would hold
// 3, 2, 2 and 2 warps), too few for the step, dK, dV and a dQ tile (a first
// version with one spilled). Thread 0 issues every TMA copy and warp 0 stages
// lse (log2 units, +inf for dead rows) and Delta: each key tile's K and V go
// to one of two buffers, issued once the tile before the current one is done,
// so the next tile lands while this one runs; each visible q tile's Q and dO
// go to a 3-stage ring, two pairs ahead, its lse and Delta read into warp 0's
// registers a pair before they are stored. Per (key tile, q tile) each
// warpgroup runs the split dK/dV kernel's step over its 64 keys
// (flash_bwd_wgmma.cuh: S^T, dP^T, P^T, dS^T; dV += P^T dO, dK += dS^T Q, all
// on wgmma) and also writes dS^T in bf16 (the values dK uses) to a swizzled
// shared tile; after a barrier, the new product dQ_tile = dS K runs over all
// the tile's keys on wgmma with both operands MN-major in shared memory (A =
// dS^T read transposed, B = the K tile), each warpgroup computing half the
// columns (at 128: one warpgroup, two 64-column halves; the 64-row product's
// rows past the 32-row q tile are discarded). Every dQ element thus comes
// from one product per (key tile, q tile), added in key-tile order into the
// CTA's f32 dQ, which stays in L2. The key tiles that meet a q tile are
// consecutive, so the first writes its dQ tile (no zeroing pass), the ones
// after read and add (each thread reads the dQ it adds to before the barrier,
// so that read's latency hides behind the wait), and the last writes dq in
// q's dtype, times the scale (no cast pass); rows of q tiles that no key tile
// meets get 0. dS^T tiles are double-buffered by pair parity, so the one
// barrier per pair orders both warpgroups' writes before the product, and the
// product, the stage and the key tile before their reuse.
//
// f32 -> flash_bwd_kernel (CUDA cores). Tensor cores have no full-precision
// f32 product and the f32 parity paths hold the card to the CPU at 1e-4, so
// f32 keeps the first body: one 256-thread CTA, 64-key and 64-row tiles, with
// Q (pre-scaled), dO, K, V staged in shared memory as f32 (rows padded by one
// float, so lanes reading different rows hit different banks): S and dP (64 x
// 64, 4 x 4 per thread), then P and dS to shared memory, then dV/dK (+= P^T
// dO, dS^T Q) and the dQ tile (dS K), all as f32 FMAs; dQ, zeroed at the
// start, is the output itself.

#include <limits.h>
#include <stdint.h>

#include "common.cuh"
#include "flash_bwd_delta.cuh"
#include "flash_bwd_wgmma.cuh"
#include "hopper_mma.cuh"

namespace {

constexpr int kBlk = 64;            // q rows and keys per tile
constexpr int kThreads = 256;       // 16 x 16 threads
constexpr int kLP = kBlk + 1;       // padded stride of the P / dS tiles

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (4 * kBlk * (D + 1)   // Q, dO, K, V
                          + 2 * kBlk * kLP     // P, dS
                          + 2 * kBlk);         // lse, Delta of the q tile
}

// D: the padded tile width; d: the head_dim (columns past it stage as 0).
// kFull: d == D, so that the column guards fold away, as they must for the
// f32 body to keep its speed at head_dim 64 and 128.
template <int D, typename T, bool kFull>
__global__ void __launch_bounds__(kThreads, D == 64 ? 2 : 1)
    flash_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* dq_acc, T* dq, T* __restrict__ dk, T* __restrict__ dv,
                     float* __restrict__ dkv_part, int sq, int sk, int h, int hk, int d_arg,
                     int q_base, int kv_base, int causal, int window, float scale) {
  const int d = kFull ? D : d_arg;
  constexpr int LD = D + 1;
  constexpr int kDC = D / 16;  // dims per thread in the D-wide products
  extern __shared__ float smem[];
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
  const int b = blockIdx.x / h;
  const int qh = blockIdx.x % h;
  const int grp = h / hk;
  const int kvh = qh / grp, gh = qh % grp;
  const long q_row = static_cast<long>(h) * d;   // stride between positions
  const long kv_row = static_cast<long>(hk) * d;
  const T* kp = k + static_cast<long>(b) * sk * kv_row + static_cast<long>(kvh) * d;
  const T* vp = v + static_cast<long>(b) * sk * kv_row + static_cast<long>(kvh) * d;
  const int n_qt = (sq + kBlk - 1) / kBlk;
  const int n_kt = (sk + kBlk - 1) / kBlk;

  const long head_off = static_cast<long>(b) * sq * q_row + static_cast<long>(qh) * d;
  const T* qp = q + head_off;
  const T* dop = dout + head_off;
  float* dqh = dq_acc + head_off;
  const float* lse_h = lse + (static_cast<long>(b) * h + qh) * sq;
  const float* delta_h = delta + (static_cast<long>(b) * h + qh) * sq;

  // this CTA owns dQ of its head: zero it
  for (long idx = tid; idx < static_cast<long>(sq) * d; idx += kThreads)
    dqh[(idx / d) * q_row + idx % d] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBlk;
    int lo = 0, hi = n_qt;
    if (causal) lo = max(0, tos::floor_div(kv_base + k0 - q_base, kBlk));
    if (window > 0)
      hi = tos::clamp_int(
          tos::floor_div(kv_base + k0 + kBlk - 1 + (window - 1) - q_base, kBlk) + 1, 0,
          n_qt);
    float dk_acc[4][kDC], dv_acc[4][kDC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kDC; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

    __syncthreads();  // the previous k tile's K/V are no longer read
    for (int idx = tid; idx < kBlk * D; idx += kThreads) {
      const int r = idx / D, c = idx % D;
      const int s = k0 + r;
      const bool in = s < sk && c < d;
      ks[r * LD + c] = in ? tos::to_float(kp[s * kv_row + c]) : 0.f;
      vs[r * LD + c] = in ? tos::to_float(vp[s * kv_row + c]) : 0.f;
    }

    for (int qt = lo; qt < hi; ++qt) {
      const int q0 = qt * kBlk;
      __syncthreads();  // the previous pair's tiles are no longer read
      for (int idx = tid; idx < kBlk * D; idx += kThreads) {
        const int r = idx / D, c = idx % D;
        const int s = q0 + r;
        const bool in = s < sq && c < d;
        qs[r * LD + c] = in ? tos::to_float(qp[s * q_row + c]) * scale : 0.f;
        dos[r * LD + c] = in ? tos::to_float(dop[s * q_row + c]) : 0.f;
      }
      if (tid < kBlk) {
        const int s = q0 + tid;
        lse_s[tid] = s < sq ? lse_h[s] : tos::kNegInf;
        delta_s[tid] = s < sq ? delta_h[s] : 0.f;
      }
      __syncthreads();

      // S = Q K^T and dP = dO V^T: rows ty + 16 i, keys tx + 16 j
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
          ps[r * kLP + c] = p;
          dss[r * kLP + c] = p * (dp[i][j] - dl);
        }
      }
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

      // dQ tile = scale * dS K: rows ty + 16 i, dims tx + 16 j; this thread
      // always owns the same dQ entries, so the read-modify-write needs no
      // barrier across pairs
      float dq_t[4][kDC];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kDC; ++j) dq_t[i][j] = 0.f;
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
          for (int j = 0; j < kDC; ++j) dq_t[i][j] = fmaf(sv[i], kv[j], dq_t[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = q0 + ty + 16 * i;
        if (s >= sq) continue;
#pragma unroll
        for (int j = 0; j < kDC; ++j) {
          if (tx + 16 * j >= d) continue;
          float* dst = dqh + s * q_row + tx + 16 * j;
          *dst = *dst + dq_t[i][j] * scale;
        }
      }
    }

    // this k tile's dK / dV, summed over the q tiles: MHA stores them, a
    // grouped head stores its f32 partial for the group sum
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = k0 + ty + 16 * i;
      if (s >= sk) continue;
      if (grp == 1) {
        const long off = (static_cast<long>(b) * sk + s) * kv_row + kvh * d;
#pragma unroll
        for (int j = 0; j < kDC; ++j) {
          if (tx + 16 * j >= d) continue;
          dk[off + tx + 16 * j] = tos::from_float<T>(dk_acc[i][j]);
          dv[off + tx + 16 * j] = tos::from_float<T>(dv_acc[i][j]);
        }
      } else {
        // partial [2][b][hk][grp][sk][d]: dK at 0, dV at half
        const long half = static_cast<long>(gridDim.x) * sk * d;
        const long off = (((static_cast<long>(b) * hk + kvh) * grp + gh) * sk + s) * d;
#pragma unroll
        for (int j = 0; j < kDC; ++j) {
          if (tx + 16 * j >= d) continue;
          dkv_part[off + tx + 16 * j] = dk_acc[i][j];
          dkv_part[half + off + tx + 16 * j] = dv_acc[i][j];
        }
      }
    }
  }

  if (static_cast<const void*>(dq) == static_cast<const void*>(dq_acc)) return;
  __syncthreads();  // every thread's dQ writes are done
  for (long idx = tid; idx < static_cast<long>(sq) * d; idx += kThreads) {
    const long off = head_off + (idx / d) * q_row + idx % d;
    dq[off] = tos::from_float<T>(dq_acc[off]);
  }
}

// dK / dV of grouped KV: the g per-head f32 partials summed in head order,
// cast to k's dtype. One thread per element of dk (and of dv).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_group_sum_kernel(const float* __restrict__ part, T* __restrict__ dk,
                               T* __restrict__ dv, int b, int sk, int hk, int grp,
                               int d) {
  const long n = static_cast<long>(b) * sk * hk * d;
  const long e = static_cast<long>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= n) return;  // e indexes dk [b, sk, hk, d]
  const int c = static_cast<int>(e % d);
  const int kvh = static_cast<int>((e / d) % hk);
  const long s = (e / (static_cast<long>(d) * hk)) % sk;
  const long bi = e / (static_cast<long>(d) * hk * sk);
  const long half = n * grp;
  const float* pk = part + ((bi * hk + kvh) * grp * sk + s) * d + c;
  float sum_k = 0.f, sum_v = 0.f;
  for (int gh = 0; gh < grp; ++gh) {
    sum_k += pk[static_cast<long>(gh) * sk * d];
    sum_v += pk[half + static_cast<long>(gh) * sk * d];
  }
  dk[e] = tos::from_float<T>(sum_k);
  dv[e] = tos::from_float<T>(sum_v);
}

// -- bf16: wgmma + TMA -------------------------------------------------------

namespace sm90 = tos::sm90;
namespace wg = tos::bwd_wg;

// Q / dO stages: the tile of pair i + 2 is copied while pair i runs
constexpr int kRing = 3;

template <int D>
struct WgFusedSmem {
  static constexpr int kKeys = wg::keys<D>();        // keys per key tile
  static constexpr int kBQ = wg::block_q<D>();       // q rows per q tile
  static constexpr int kKVBytes = kKeys * D * 2;     // one K (or V) tile
  static constexpr int kKVStage = 2 * kKVBytes;      // K then V
  static constexpr int kQBytes = kBQ * D * 2;        // one Q (or dO) tile
  static constexpr int kStageBytes = 2 * kQBytes;    // Q then dO
  static constexpr int kDsBytes = kKeys * sm90::kRowBytes;  // dS^T: keys x 64 q columns
  static constexpr size_t kBytes = 1024 + 2 * kKVStage + kRing * kStageBytes + 2 * kDsBytes;
};

// q tiles [lo, hi) that key tile kt (kKeys keys) is visible from:
// _causal_q_lo .. _window_q_hi from its first and last key
template <int kKeys, int kBQ>
__device__ __forceinline__ void fused_q_bounds(int kt, int sq, int sk, int q_base, int kv_base,
                                               int causal, int window, int& lo, int& hi) {
  const int n_qt = (sq + kBQ - 1) / kBQ;
  const int k0 = kt * kKeys, k_last = min(sk, k0 + kKeys) - 1;
  lo = 0;
  hi = n_qt;
  if (causal) lo = tos::clamp_int(tos::floor_div(kv_base + k0 - q_base, kBQ), 0, n_qt);
  if (causal && window > 0)
    hi = tos::clamp_int(tos::floor_div(kv_base + k_last + (window - 1) - q_base, kBQ) + 1, 0,
                        n_qt);
}

// The first key tile at or after kt that some q tile sees, or n_kt
template <int kKeys, int kBQ>
__device__ __forceinline__ int next_key_tile(int kt, int n_kt, int sq, int sk, int q_base,
                                             int kv_base, int causal, int window) {
  for (; kt < n_kt; ++kt) {
    int lo, hi;
    fused_q_bounds<kKeys, kBQ>(kt, sq, sk, q_base, kv_base, causal, window, lo, hi);
    if (hi > lo) break;
  }
  return kt;
}

// This thread's part of a 64-row dQ tile, N columns from col0 (accumulator
// fragment order): rows row0 and row0 + 8, columns col0 + 8 j + 2 quad, + 1.
// Rows past `rows` and columns past d read 0 and are never stored.
template <int N>
struct DqPart {
  float2 v[2][N / 8];
};

template <typename T>
__device__ __forceinline__ T* dq_part_row(T* dqh, long q_row, int q0, int r, int col0) {
  const int lane = threadIdx.x & 31;
  const int row = ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2) + 8 * r;
  return dqh + static_cast<long>(q0 + row) * q_row + col0 + 2 * (lane & 3);
}

__device__ __forceinline__ bool dq_part_in(int r, int j, int rows, int col0, int d) {
  const int row = ((threadIdx.x >> 5) & 3) * 16 + ((threadIdx.x & 31) >> 2) + 8 * r;
  return row < rows && col0 + 8 * j < d;
}

template <int N>
__device__ __forceinline__ void dq_load(DqPart<N>& p, const float* dqh, long q_row, int q0,
                                        int rows, int col0, int d) {
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      p.v[r][j] = dq_part_in(r, j, rows, col0, d)
                      ? *reinterpret_cast<const float2*>(dq_part_row(dqh, q_row, q0, r, col0) +
                                                         8 * j)
                      : make_float2(0.f, 0.f);
}

// dQ_tile = dS K for this warpgroup's N columns from col0: A = the dS^T tile
// (MN-major, all kKeys rows), B = the K tile's columns col0.. (MN-major).
// The tile's real rows and columns, plus `old` (the key tiles before this
// one), go back to the CTA's f32 dQ, or, on the last key tile that meets
// this q tile, times the scale to dq in bf16: one rounding.
template <int kKeys, int N>
__device__ __forceinline__ void dq_product(uint32_t ds_addr, uint32_t k_tile, int col0,
                                           const DqPart<N>& old, bool last, float scale,
                                           float* __restrict__ dqh, __nv_bfloat16* __restrict__ dqo,
                                           long q_row, int q0, int rows, int d) {
  const uint32_t b_addr = k_tile + (col0 / 64) * kKeys * sm90::kRowBytes + (col0 % 64) * 2;
  float acc[N / 2];
  sm90::wgmma_fence();
#pragma unroll
  for (int k = 0; k < kKeys / 16; ++k)
    sm90::wgmma_ss_mn<N>(acc, sm90::desc_mn_major(ds_addr, sm90::kAtomBytes, k),
                         sm90::desc_mn_major(b_addr, kKeys * sm90::kRowBytes, k), k > 0);
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(acc);
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      if (!dq_part_in(r, j, rows, col0, d)) continue;
      const float x = old.v[r][j].x + acc[4 * j + 2 * r];
      const float y = old.v[r][j].y + acc[4 * j + 2 * r + 1];
      if (last)
        *reinterpret_cast<__nv_bfloat162*>(dq_part_row(dqo, q_row, q0, r, col0) + 8 * j) =
            __floats2bfloat162_rn(x * scale, y * scale);
      else
        *reinterpret_cast<float2*>(dq_part_row(dqh, q_row, q0, r, col0) + 8 * j) =
            make_float2(x, y);
    }
}

// dQ, dK, dV of one (batch, query head); see the note at the top
template <int D>
__global__ void __launch_bounds__(128 * wg::consumers<D>(), 1)
    flash_bwd_kernel_wgmma(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_do,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           float* __restrict__ dq_acc, __nv_bfloat16* __restrict__ dq,
                           __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                           float* __restrict__ dkv_part, int sq, int sk, int h, int hk, int d,
                           int q_base, int kv_base, int causal, int window, float scale) {
  using S = WgFusedSmem<D>;
  constexpr int kBQ = S::kBQ;
  constexpr int kKeys = S::kKeys;
  constexpr int kThreadsWg = 128 * wg::consumers<D>();
  constexpr int kCols = D / wg::consumers<D>();       // dQ columns per warpgroup
  constexpr int kN = kCols < 64 ? kCols : 64;         // per dQ product
  constexpr int kRowsLane = kBQ / 32;                 // lse / Delta rows per lane of warp 0
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t kv_full[2], full[kRing];
  __shared__ float lse_s[kRing][kBQ], delta_s[kRing][kBQ];
  uint8_t* kv_buf = sm90::align_1024(smem_raw);
  uint8_t* ring = kv_buf + 2 * S::kKVStage;
  uint8_t* ds_buf = ring + kRing * S::kStageBytes;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x / h;
  const int qh = blockIdx.x % h;
  const int grp = h / hk;
  const int kvh = qh / grp, gh = qh % grp;
  const int n_kt = (sk + kKeys - 1) / kKeys;
  const long row_lse = (static_cast<long>(b) * h + qh) * sq;   // the head's rows in lse

  // Thread 0 issues every copy; warp 0 stages lse (wg::lse_log2) and Delta. A key tile's K and V go to
  // buffer t % 2 (t counts the key tiles some q tile sees), the q tile of
  // pair i to ring stage i % kRing with its lse and Delta.
  auto load_kv = [&](int kt, int t) {
    if (threadIdx.x != 0) return;
    uint8_t* k_tile = kv_buf + (t & 1) * S::kKVStage;
    uint8_t* v_tile = k_tile + S::kKVBytes;
    sm90::mbar_arrive_expect_tx(&kv_full[t & 1], S::kKVStage);
#pragma unroll
    for (int j = 0; j < D / 64; ++j) {
      sm90::tma_load_4d(k_tile + j * kKeys * sm90::kRowBytes, &tm_k, &kv_full[t & 1], 64 * j,
                        kvh, kt * kKeys, b);
      sm90::tma_load_4d(v_tile + j * kKeys * sm90::kRowBytes, &tm_v, &kv_full[t & 1], 64 * j,
                        kvh, kt * kKeys, b);
    }
  };
  auto load_q = [&](int qt, int i) {
    if (threadIdx.x != 0) return;
    const int s = i % kRing;
    uint8_t* q_tile = ring + s * S::kStageBytes;
    uint8_t* do_tile = q_tile + S::kQBytes;
    sm90::mbar_arrive_expect_tx(&full[s], S::kStageBytes);
#pragma unroll
    for (int j = 0; j < D / 64; ++j) {
      sm90::tma_load_4d(q_tile + j * kBQ * sm90::kRowBytes, &tm_q, &full[s], 64 * j, qh,
                        qt * kBQ, b);
      sm90::tma_load_4d(do_tile + j * kBQ * sm90::kRowBytes, &tm_do, &full[s], 64 * j, qh,
                        qt * kBQ, b);
    }
  };
  // warp 0's lanes read a q tile's lse and Delta into registers (issued a
  // pair ahead of their stores, so the reads' latency hides behind a step)
  float pre_l[kRowsLane], pre_d[kRowsLane];
  auto read_rows = [&](int qt) {
#pragma unroll
    for (int m = 0; m < kRowsLane; ++m) {
      const int pos = qt * kBQ + lane + 32 * m;
      pre_l[m] = pos < sq ? lse[row_lse + pos] : tos::kNegInf;
      pre_d[m] = pos < sq ? delta[row_lse + pos] : 0.f;
    }
  };
  auto store_rows = [&](int i) {
    const int s = i % kRing;
#pragma unroll
    for (int m = 0; m < kRowsLane; ++m) {
      lse_s[s][lane + 32 * m] = wg::lse_log2(pre_l[m]);
      delta_s[s][lane + 32 * m] = pre_d[m];
    }
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) sm90::mbar_init(&kv_full[s], 1);
    for (int s = 0; s < kRing; ++s) sm90::mbar_init(&full[s], 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();

  // the copies ahead of the walk: the first two key tiles, the first kRing
  // pairs; (ak, aq) is the next pair to load
  int kv_next = next_key_tile<kKeys, kBQ>(0, n_kt, sq, sk, q_base, kv_base, causal, window);
  for (int t = 0; t < 2 && kv_next < n_kt; ++t) {
    load_kv(kv_next, t);
    kv_next = next_key_tile<kKeys, kBQ>(kv_next + 1, n_kt, sq, sk, q_base, kv_base, causal,
                                        window);
  }
  int ak = next_key_tile<kKeys, kBQ>(0, n_kt, sq, sk, q_base, kv_base, causal, window);
  int aq = 0, ahi = 0;
  if (ak < n_kt) fused_q_bounds<kKeys, kBQ>(ak, sq, sk, q_base, kv_base, causal, window, aq, ahi);
  auto advance = [&]() {
    if (++aq < ahi) return;
    ak = next_key_tile<kKeys, kBQ>(ak + 1, n_kt, sq, sk, q_base, kv_base, causal, window);
    if (ak < n_kt)
      fused_q_bounds<kKeys, kBQ>(ak, sq, sk, q_base, kv_base, causal, window, aq, ahi);
  };
  for (int i = 0; i < kRing && ak < n_kt; ++i, advance()) {
    load_q(aq, i);
    if (warp == 0) {
      read_rows(aq);
      store_rows(i);
    }
  }

  const int wgi = warp >> 2;
  const long q_row = static_cast<long>(h) * d;
  // this CTA owns dQ of its head: an f32 sum between the key tiles that meet
  // a q tile, in bf16 after the last
  float* dqh = dq_acc + static_cast<long>(b) * sq * q_row + static_cast<long>(qh) * d;
  __nv_bfloat16* dqo = dq + static_cast<long>(b) * sq * q_row + static_cast<long>(qh) * d;
  __syncthreads();  // the first stages' lse and Delta are staged

  const float sl2 = scale * wg::kLog2e;
  const long kv_row = static_cast<long>(hk) * d;
  // grouped KV: partial [2][b][hk][grp][sk][d], dK at 0 and dV at half
  const long half = static_cast<long>(gridDim.x) * sk * d;
  // The key tiles that meet q tile qt are consecutive (both bounds grow with
  // kt, and a tile's range reaches the next one's start): the first is the
  // one after the last tile with hi <= qt, the last the one before the first
  // tile with lo > qt. q tiles that no key tile meets get dq = 0 at the end.
  int i = 0, t = 0, hi_prev = 0, q_lo = -1, q_hi = 0;
  for (int kt = 0; kt < n_kt; ++kt) {
    int lo, hi, lo_next = n_kt, hi_next;
    fused_q_bounds<kKeys, kBQ>(kt, sq, sk, q_base, kv_base, causal, window, lo, hi);
    if (kt + 1 < n_kt)
      fused_q_bounds<kKeys, kBQ>(kt + 1, sq, sk, q_base, kv_base, causal, window, lo_next,
                                 hi_next);
    else
      lo_next = INT_MAX;
    if (hi > lo) {
      if (q_lo < 0) q_lo = lo;
      q_hi = hi;
    }
    const int wg_first = kt * kKeys + wgi * 64;
    const int wg_last = min(sk, wg_first + 64) - 1;
    const int key0 = wg_first + (warp & 3) * 16 + (lane >> 2);   // and key0 + 8
    const bool has_keys = wg_first < sk;
    int wg_lo = lo, wg_hi = hi;
    if (causal) wg_lo = max(lo, tos::floor_div(kv_base + wg_first - q_base, kBQ));
    if (causal && window > 0)
      wg_hi = min(hi, tos::floor_div(kv_base + wg_last + (window - 1) - q_base, kBQ) + 1);
    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int x = 0; x < D / 2; ++x) dk_acc[x] = dv_acc[x] = 0.f;

    if (hi > lo) {
      sm90::mbar_wait(&kv_full[t & 1], (t >> 1) & 1);
      const uint32_t k_tile = sm90::smem_u32(kv_buf + (t & 1) * S::kKVStage);
      const uint32_t k_addr = k_tile + wgi * 64 * sm90::kRowBytes;
      const uint32_t v_addr = k_addr + S::kKVBytes;
      for (int qt = lo; qt < hi; ++qt, ++i) {
        const int s = i % kRing;
        const bool refill = i >= 1 && ak < n_kt;   // pair i + kRing - 1 into pair i - 1's stage
        if (refill && warp == 0) read_rows(aq);
        sm90::mbar_wait(&full[s], (i / kRing) & 1);
        const uint32_t q_addr = sm90::smem_u32(ring + s * S::kStageBytes);
        uint8_t* ds_tile = ds_buf + (i & 1) * S::kDsBytes;
        const bool visible = has_keys && qt >= wg_lo && qt < wg_hi;
        wg::step<D, kBQ, kKeys>(k_addr, v_addr, q_addr, q_addr + S::kQBytes, lse_s[s],
                                      delta_s[s], dk_acc, dv_acc,
                                      ds_tile + wgi * 64 * sm90::kRowBytes, visible, qt * kBQ,
                                      key0, wg_first, wg_last, sk, q_base, kv_base, causal,
                                      window, sl2);
        // the dQ this warpgroup adds to (none on the first key tile that
        // meets this q tile), read while the barrier waits (in one product's
        // columns; at a padded width of 128 each half is read before its
        // product, which leaves the registers to dK and dV)
        const int rows = min(kBQ, sq - qt * kBQ);
        const int col0 = kCols * wgi;
        const bool first = qt >= hi_prev, last = qt < lo_next;
        DqPart<kN> old = {};
        if constexpr (kCols == kN)
          if (!first) dq_load<kN>(old, dqh, q_row, qt * kBQ, rows, col0, d);
        // every warpgroup's dS^T rows are written, and every thread is done
        // with pair i - 1 (its products waited on) and so with its stage and
        // dS^T tile, and, on a key tile's first pair, with the key tile
        // before this one
        sm90::fence_proxy_async();
        __syncthreads();
        if (qt == lo && t >= 1 && kv_next < n_kt) {
          load_kv(kv_next, t + 1);
          kv_next = next_key_tile<kKeys, kBQ>(kv_next + 1, n_kt, sq, sk, q_base, kv_base,
                                              causal, window);
        }
        if (refill) {
          load_q(aq, i + kRing - 1);
          if (warp == 0) store_rows(i + kRing - 1);
          advance();
        }
        // dQ_tile = dS K over all the tile's keys, this warpgroup's columns
        // (the first wait inside also completes the step's dK / dV products)
        const uint32_t ds_addr = sm90::smem_u32(ds_tile);
#pragma unroll
        for (int c = 0; c < kCols / kN; ++c) {
          if constexpr (kCols != kN)
            if (!first) dq_load<kN>(old, dqh, q_row, qt * kBQ, rows, col0 + c * kN, d);
          dq_product<kKeys, kN>(ds_addr, k_tile, col0 + c * kN, old, last, scale, dqh, dqo,
                                q_row, qt * kBQ, rows, d);
        }
        sm90::fence_regs(dv_acc);
        sm90::fence_regs(dk_acc);
      }
      ++t;
    }
    hi_prev = hi;

    // this key tile's dK / dV, summed over its q tiles: MHA stores them, a
    // grouped head stores its f32 partial for the group sum
    if (grp == 1)
      wg::store_dkv<D>(dk_acc, dv_acc, dk, dv,
                       (static_cast<long>(b) * sk + key0) * kv_row + static_cast<long>(kvh) * d,
                       kv_row, key0, sk, d, scale);
    else
      wg::store_dkv<D>(dk_acc, dv_acc, dkv_part, dkv_part + half,
                       (((static_cast<long>(b) * hk + kvh) * grp + gh) * sk + key0) * d,
                       static_cast<long>(d), key0, sk, d, scale);
  }

  // dq = 0 in the rows of q tiles that no key tile meets: [0, r0) and
  // [r1, sq) (every row when none does)
  const int r0 = q_lo < 0 ? sq : q_lo * kBQ;
  const int r1 = q_lo < 0 ? sq : min(sq, q_hi * kBQ);
  const int dead = r0 + (sq - r1);
  for (long idx = threadIdx.x; idx < static_cast<long>(dead) * d / 2; idx += kThreadsWg) {
    const long e = idx * 2, r = e / d;
    const long row = r < r0 ? r : r1 + (r - r0);
    *reinterpret_cast<__nv_bfloat162*>(dqo + row * q_row + e % d) =
        __floats2bfloat162_rn(0.f, 0.f);
  }
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
  const void *q, *k, *v, *out, *dout;
  const float *lse, *g_lse;
  float *delta, *dq_acc, *dkv_part;
  void *dq, *dk, *dv;
  int b, sq, sk, h, hk, d, q_base, kv_base, causal, window;
  float scale;
  int device;
  cudaStream_t stream;
};

// the group sum of grouped KV's per-head partials (after either body)
template <typename T>
cudaError_t launch_group_sum(const Args& a) {
  if (a.h == a.hk) return cudaSuccess;
  const long n = static_cast<long>(a.b) * a.sk * a.hk * a.d;
  flash_bwd_group_sum_kernel<T><<<static_cast<unsigned>((n + kThreads - 1) / kThreads),
                                  kThreads, 0, a.stream>>>(
      a.dkv_part, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.b, a.sk, a.hk, a.h / a.hk,
      a.d);
  return cudaGetLastError();
}

template <int D, bool kFull>
cudaError_t launch_f32(const Args& a) {
  static unsigned long long configured = 0;
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t e = allow_smem(flash_bwd_kernel<D, float, kFull>, smem, a.device, &configured);
  if (e != cudaSuccess) return e;
  e = tos::launch_flash_bwd_delta<float>(a.out, a.dout, a.g_lse, a.delta, a.b, a.sq, a.h, a.d,
                                         a.stream);
  if (e != cudaSuccess) return e;
  flash_bwd_kernel<D, float, kFull><<<a.b * a.h, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse, a.delta,
      a.dq_acc, static_cast<float*>(a.dq), static_cast<float*>(a.dk), static_cast<float*>(a.dv),
      a.dkv_part, a.sq, a.sk, a.h, a.hk, a.d, a.q_base, a.kv_base, a.causal, a.window, a.scale);
  e = cudaGetLastError();
  return e != cudaSuccess ? e : launch_group_sum<float>(a);
}

template <int D>
cudaError_t launch_wgmma(const Args& a) {
  static unsigned long long configured = 0;
  constexpr size_t smem = WgFusedSmem<D>::kBytes;
  cudaError_t e = allow_smem(flash_bwd_kernel_wgmma<D>, smem, a.device, &configured);
  if (e != cudaSuccess) return e;
  CUtensorMap mq, mk, mv, mdo;
  constexpr int kBQ = wg::block_q<D>(), kKeys = wg::keys<D>();
  e = sm90::encode_bshd_map(&mq, a.q, a.b, a.sq, a.h, a.d, kBQ);
  if (e == cudaSuccess) e = sm90::encode_bshd_map(&mdo, a.dout, a.b, a.sq, a.h, a.d, kBQ);
  if (e == cudaSuccess) e = sm90::encode_bshd_map(&mk, a.k, a.b, a.sk, a.hk, a.d, kKeys);
  if (e == cudaSuccess) e = sm90::encode_bshd_map(&mv, a.v, a.b, a.sk, a.hk, a.d, kKeys);
  if (e != cudaSuccess) return e;
  e = tos::launch_flash_bwd_delta<__nv_bfloat16>(a.out, a.dout, a.g_lse, a.delta, a.b, a.sq,
                                                 a.h, a.d, a.stream);
  if (e != cudaSuccess) return e;
  flash_bwd_kernel_wgmma<D><<<a.b * a.h, 128 * wg::consumers<D>(), smem, a.stream>>>(
      mq, mk, mv, mdo, a.lse, a.delta, a.dq_acc, static_cast<__nv_bfloat16*>(a.dq),
      static_cast<__nv_bfloat16*>(a.dk), static_cast<__nv_bfloat16*>(a.dv), a.dkv_part, a.sq,
      a.sk, a.h, a.hk, a.d, a.q_base, a.kv_base, a.causal, a.window, a.scale);
  e = cudaGetLastError();
  return e != cudaSuccess ? e : launch_group_sum<__nv_bfloat16>(a);
}

}  // namespace

// q, out, dout, dq: [b, sq, h, d] and k, v, dk, dv: [b, sk, hk, d], all
// contiguous in `dtype` on CUDA device `device` (bf16 bases 16-byte aligned:
// TMA reads them); d in 8..128, a multiple of 8; lse: [b, h, sq] f32 from the
// forward; g_lse: the lse cotangent [b, h, sq] f32, or null; delta: [b, h, sq]
// f32 scratch; dq_acc: [b, sq, h, d] f32 scratch (may be dq itself when dtype
// is f32); dkv_part: [2, b, hk, h / hk, sk, d] f32 scratch when h > hk, else
// null. window <= 0 means no window. Launches the Delta pre-pass, the backward
// and (grouped KV) the group sum on `stream`. Returns cudaGetLastError().
extern "C" int tos_flash_attention_bwd(const void* q, const void* k, const void* v,
                                       const void* out, const void* dout, const void* lse,
                                       const void* g_lse, void* delta, void* dq_acc,
                                       void* dq, void* dk, void* dv, void* dkv_part, int b,
                                       int sq, int sk, int h, int hk, int d, int q_base,
                                       int kv_base,
                                       int causal, int window, float scale, int dtype,
                                       int device, void* stream) {
  cudaGetLastError();  // start from a clean error state
  if (b <= 0 || sq <= 0 || sk <= 0 || h <= 0) return 0;
  if (hk <= 0 || h % hk != 0) return static_cast<int>(cudaErrorInvalidValue);
  if ((dtype == tos::kBFloat16 && dq == dq_acc) || (h != hk && dkv_part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const Args a{q, k, v, out, dout, static_cast<const float*>(lse),
               static_cast<const float*>(g_lse), static_cast<float*>(delta),
               static_cast<float*>(dq_acc), static_cast<float*>(dkv_part), dq, dk, dv, b, sq,
               sk, h, hk, d, q_base, kv_base, causal, window, scale, device,
               static_cast<cudaStream_t>(stream)};
  // bf16 runs on the tensor cores, f32 on the CUDA cores (see the note above)
  const int dp = tos::padded_head_dim(d);
  cudaError_t e = cudaErrorInvalidValue;
  if (dtype == tos::kBFloat16 && dp == 64) e = launch_wgmma<64>(a);
  else if (dtype == tos::kBFloat16 && dp == 128) e = launch_wgmma<128>(a);
  else if (dtype == tos::kFloat32 && dp == 64)
    e = d == 64 ? launch_f32<64, true>(a) : launch_f32<64, false>(a);
  else if (dtype == tos::kFloat32 && dp == 128)
    e = d == 128 ? launch_f32<128, true>(a) : launch_f32<128, false>(a);
  return static_cast<int>(e);
}
