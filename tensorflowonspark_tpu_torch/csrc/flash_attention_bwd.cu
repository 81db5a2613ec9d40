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
// Bound on the H100: at the training shape (B 16, S 1024, H 12, D 64, causal)
// the work is 5 products of 2 * D flops for each visible (q, k) pair, about 64
// GFLOP, against ~0.2 GB of inputs and outputs: compute-bound (tensor cores
// would take ~0.07 ms). This first version runs the products on the CUDA cores
// in f32 (no wgmma, no TMA), so it is bound by shared-memory operand loads and
// f32 FMA issue; wgmma and TMA are later work.
//
// Design (deterministic, no atomics). On the TPU, dQ rides a block resident in
// VMEM across the sequential k grid axis. Here that grid axis becomes a loop:
// ONE 256-thread CTA per (batch, query head) walks every 64-key tile in order
// and, for each, the visible 64-row q tiles, keeping the tile's dK/dV in
// registers (4 keys x D/16 dims per thread) until the walk over q ends, and
// read-modify-writing an f32 dQ that only this CTA owns (zeroed at the start,
// cast to q's dtype at the end). Every dQ sum therefore runs in one fixed order.
// For MHA the CTA stores its dK/dV tile straight into dk/dv. For grouped KV the
// g query heads of a KV head live in g CTAs, so each stores its tile's dK/dV in
// f32 to a per-head partial [B, Hk, g, Sk, D], and a second kernel of this
// source sums the g partials in head order and casts: the sum over the group
// that the TPU kernel carries across its grid, made a fixed-order second pass
// instead of atomics. The gradients are bitwise reproducible. Walking the group
// inside one CTA instead would give B * Hk CTAs, too few to fill the card's 132
// SMs at the grouped training shape (32 at B 8, Hk 4); this gives B * H (192 at
// the MHA training shape, 2 CTAs per SM at D 64). This kernel keeps one 64-key
// tile of dK/dV in registers and could run at any length, but at a long
// sequence and a small batch B * H CTAs leave most of the card idle (12 at
// B 1, H 12), which is where the reference's rule moves to the split plan.
//
// Per (q tile, k tile) pair, with Q (pre-scaled), dO, K, V staged in shared
// memory as f32 (rows padded by one float, so lanes reading different rows hit
// different banks): S and dP (64 x 64, 4 x 4 per thread), then P and dS to
// shared memory, then dV/dK (+= P^T dO, dS^T Q) and the dQ tile (dS K).
// A pre-pass kernel (flash_bwd_delta.cuh, shared with the split plan)
// computes Delta, one warp per row; the grouped partial sum is the third
// kernel. The JAX package switches grouped K/V to its split plan past
// _gqa_fused_fits; the port's wrapper applies the same rule
// (ops/flash_attention.py bwd_plan), so both packages run the same plan.

#include <stdint.h>

#include "common.cuh"
#include "flash_bwd_delta.cuh"

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

template <int D, typename T>
__global__ void __launch_bounds__(kThreads, D == 64 ? 2 : 1)
    flash_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* dq_acc, T* dq, T* __restrict__ dk, T* __restrict__ dv,
                     float* __restrict__ dkv_part, int sq, int sk, int h, int hk,
                     int q_base, int kv_base, int causal, int window, float scale) {
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
  const long q_row = static_cast<long>(h) * D;   // stride between positions
  const long kv_row = static_cast<long>(hk) * D;
  const T* kp = k + static_cast<long>(b) * sk * kv_row + static_cast<long>(kvh) * D;
  const T* vp = v + static_cast<long>(b) * sk * kv_row + static_cast<long>(kvh) * D;
  const int n_qt = (sq + kBlk - 1) / kBlk;
  const int n_kt = (sk + kBlk - 1) / kBlk;

  const long head_off = static_cast<long>(b) * sq * q_row + static_cast<long>(qh) * D;
  const T* qp = q + head_off;
  const T* dop = dout + head_off;
  float* dqh = dq_acc + head_off;
  const float* lse_h = lse + (static_cast<long>(b) * h + qh) * sq;
  const float* delta_h = delta + (static_cast<long>(b) * h + qh) * sq;

  // this CTA owns dQ of its head: zero it
  for (long idx = tid; idx < static_cast<long>(sq) * D; idx += kThreads)
    dqh[(idx / D) * q_row + idx % D] = 0.f;

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
      const bool in = s < sk;
      ks[r * LD + c] = in ? tos::to_float(kp[s * kv_row + c]) : 0.f;
      vs[r * LD + c] = in ? tos::to_float(vp[s * kv_row + c]) : 0.f;
    }

    for (int qt = lo; qt < hi; ++qt) {
      const int q0 = qt * kBlk;
      __syncthreads();  // the previous pair's tiles are no longer read
      for (int idx = tid; idx < kBlk * D; idx += kThreads) {
        const int r = idx / D, c = idx % D;
        const int s = q0 + r;
        const bool in = s < sq;
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
        const long off = (static_cast<long>(b) * sk + s) * kv_row + kvh * D;
#pragma unroll
        for (int j = 0; j < kDC; ++j) {
          dk[off + tx + 16 * j] = tos::from_float<T>(dk_acc[i][j]);
          dv[off + tx + 16 * j] = tos::from_float<T>(dv_acc[i][j]);
        }
      } else {
        // partial [2][b][hk][grp][sk][D]: dK at 0, dV at half
        const long half = static_cast<long>(gridDim.x) * sk * D;
        const long off = (((static_cast<long>(b) * hk + kvh) * grp + gh) * sk + s) * D;
#pragma unroll
        for (int j = 0; j < kDC; ++j) {
          dkv_part[off + tx + 16 * j] = dk_acc[i][j];
          dkv_part[half + off + tx + 16 * j] = dv_acc[i][j];
        }
      }
    }
  }

  if (static_cast<const void*>(dq) == static_cast<const void*>(dq_acc)) return;
  __syncthreads();  // every thread's dQ writes are done
  for (long idx = tid; idx < static_cast<long>(sq) * D; idx += kThreads) {
    const long off = head_off + (idx / D) * q_row + idx % D;
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

template <int D, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* out,
                   const void* dout, const float* lse, const float* g_lse, float* delta,
                   float* dq_acc, void* dq, void* dk, void* dv, float* dkv_part, int b,
                   int sq, int sk, int h, int hk, int q_base, int kv_base, int causal,
                   int window, float scale, int device, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  // the shared-memory attribute is set once per instantiation and device
  static unsigned long long configured = 0;
  const unsigned long long bit = 1ull << (device & 63);
  if (!(configured & bit)) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    configured |= bit;
  }
  cudaError_t e = tos::launch_flash_bwd_delta<T>(out, dout, g_lse, delta, b, sq, h, D, stream);
  if (e != cudaSuccess) return e;
  flash_bwd_kernel<D, T><<<b * h, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, dq_acc, static_cast<T*>(dq),
      static_cast<T*>(dk), static_cast<T*>(dv), dkv_part, sq, sk, h, hk, q_base, kv_base,
      causal, window, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess || h == hk) return e;
  const long n = static_cast<long>(b) * sk * hk * D;
  flash_bwd_group_sum_kernel<T><<<static_cast<unsigned>((n + kThreads - 1) / kThreads),
                                  kThreads, 0, stream>>>(
      dkv_part, static_cast<T*>(dk), static_cast<T*>(dv), b, sk, hk, h / hk, D);
  return cudaGetLastError();
}

}  // namespace

// q, out, dout, dq: [b, sq, h, d] and k, v, dk, dv: [b, sk, hk, d], all
// contiguous in `dtype` on CUDA device `device`; lse: [b, h, sq] f32 from the
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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* gl = static_cast<const float*>(g_lse);
  float* dl = static_cast<float*>(delta);
  float* acc = static_cast<float*>(dq_acc);
  float* part = static_cast<float*>(dkv_part);
  cudaError_t e = cudaErrorInvalidValue;
  if (dtype == tos::kBFloat16 && d == 64) {
    e = launch<64, __nv_bfloat16>(q, k, v, out, dout, l, gl, dl, acc, dq, dk, dv, part, b,
                                  sq, sk, h, hk, q_base, kv_base, causal, window, scale,
                                  device, s);
  } else if (dtype == tos::kBFloat16 && d == 128) {
    e = launch<128, __nv_bfloat16>(q, k, v, out, dout, l, gl, dl, acc, dq, dk, dv, part, b,
                                   sq, sk, h, hk, q_base, kv_base, causal, window, scale,
                                   device, s);
  } else if (dtype == tos::kFloat32 && d == 64) {
    e = launch<64, float>(q, k, v, out, dout, l, gl, dl, acc, dq, dk, dv, part, b, sq, sk, h,
                          hk, q_base, kv_base, causal, window, scale, device, s);
  } else if (dtype == tos::kFloat32 && d == 128) {
    e = launch<128, float>(q, k, v, out, dout, l, gl, dl, acc, dq, dk, dv, part, b, sq, sk, h,
                           hk, q_base, kv_base, causal, window, scale, device, s);
  }
  return static_cast<int>(e);
}
