// Flash-attention forward for Hopper: causal or windowed online-softmax attention
// with unexpanded grouped K/V and absolute position bases; writes out and lse.
//
// Replaces: tensorflowonspark_tpu/ops/flash_attention.py _attn_fwd_kernel (the
// Pallas kernel launched by _fwd_impl). Same function, term for term:
//   s = (q * scale) . k in f32, scale = 1/sqrt(d);
//   keep = kv_base + j <= q_base + i (causal), and kv_base + j > q_base + i - window;
//   masked scores are -1e30 (not -inf); online softmax in f32 with the TPU
//   kernel's guards (m_safe, corr, p = 0 for masked entries);
//   out = acc / l cast to q's dtype, lse = m + log(l); an empty row gives
//   out = 0 and lse = -1e30;
//   query head qh reads KV head qh / (H / Hk) (the blocked GQA map, _kv_row_map);
//   the k-tile loop is bounded like _causal_k_hi / _window_k_lo, so a causal
//   prefill visits about half the tiles.
//
// Head dims: every d with 8 <= d <= 128 and d % 8 == 0. Each body is built
// for a padded tile width DP (64 for d <= 64, else 128, padded_head_dim) and
// takes the real d at run time: tiles are staged with zeros past column d
// (TMA fills them in the tensor-core body), which add nothing to q . k or to
// P V, and no column past d is stored. The scale stays 1/sqrt(d).
//
// Bound on the H100: 4 * pairs * D flops for the visible (q, k) pairs against
// |q| + |k| + |v| + |o| bytes: compute-bound on the bf16 tensor cores at
// training and long-context shapes (B16 S1024: 0.03 ms; B1 S16384 H12: 0.42
// ms), memory-light at the serving prefill chunks.
//
// Two bodies, chosen by dtype in tos_flash_attention_fwd:
//
// bf16 -> flash_fwd_kernel_wgmma (tensor cores). One CTA per (batch * head,
// 128-row q tile): two warpgroups of 64 rows, two CTAs an SM at head_dim 64.
// Thread 0 loads the q tile once by TMA (hopper_mma.cuh, 128-byte swizzle)
// and streams 64-key K/V tiles through a 4-stage ring with full/empty
// mbarriers, so the next tiles' copies overlap this tile's products; it
// refills the stage of the tile before last, so a warpgroup may run one tile
// ahead of the other. (A dedicated producer warp would make 9 warps a CTA,
// whose registers leave room for one CTA an SM.) Each warpgroup computes
// S = Q K^T with wgmma (A = Q, B = K, both K-major in shared
// memory; f32 accumulators), masks and runs the online softmax on the
// accumulator's registers (row max and sum over the 4 lanes of a quad), rounds
// P to bf16 in registers and accumulates O += P V with wgmma (A = P from
// registers, B = V MN-major: tnspB). P in bf16 is the one rounding the TPU
// kernel (which multiplies p in f32) does not have: out is a convex average of
// V rows, so its error stays inside bf16 output rounding; S and lse come from
// exact bf16 products summed in f32. Only tiles on the causal diagonal or the
// window edge are masked; a warpgroup skips tiles none of its rows can see.
// Causal q tiles with the most visible keys launch first. TMA zero-fills reads
// past Sq / Sk; keys >= Sk are masked and rows >= Sq are not stored.
//
// f32 -> flash_fwd_kernel (CUDA cores). Tensor cores have no full-precision
// f32 product and the f32 parity paths hold the card to the CPU at 2e-5, so
// f32 keeps the first body: one 128-thread CTA per (batch * head, 64-row q
// tile), q and each 64-key K/V tile staged as f32 in shared memory (K rows
// padded by one float), each warp owning 16 query rows with m, l and the
// accumulator in registers, P through a per-warp shared buffer. Nothing
// carries between CTAs, so blocks run in any order.

#include <stdint.h>

#include "common.cuh"
#include "hopper_mma.cuh"

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kWarps = 4;
constexpr int kRowsPerWarp = kBlockQ / kWarps;

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBlockQ * D            // q tile
                          + kBlockK * (D + 1)    // k tile, padded rows
                          + kBlockK * D          // v tile
                          + kWarps * kRowsPerWarp * kBlockK);  // P per warp
}

// D: the padded tile width; d: the head_dim (columns past it stage as 0)
template <int D, typename T>
__global__ void __launch_bounds__(32 * kWarps)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse, int sq, int sk, int h, int hk, int d,
                     int q_base, int kv_base, int causal, int window, float scale) {
  constexpr int kCols = D / 32;  // output columns per lane
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kBlockQ * D;
  float* vs = ks + kBlockK * (D + 1);
  float* ps = vs + kBlockK * D;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int bh = blockIdx.y;
  const int b = bh / h;
  const int qh = bh % h;
  const int kvh = qh / (h / hk);
  const int q0 = blockIdx.x * kBlockQ;

  const long q_row = static_cast<long>(h) * d;   // stride between positions
  const long kv_row = static_cast<long>(hk) * d;
  const T* qp = q + static_cast<long>(b) * sq * q_row + static_cast<long>(qh) * d;
  const T* kp = k + static_cast<long>(b) * sk * kv_row + static_cast<long>(kvh) * d;
  const T* vp = v + static_cast<long>(b) * sk * kv_row + static_cast<long>(kvh) * d;

  for (int idx = tid; idx < kBlockQ * D; idx += 32 * kWarps) {
    const int r = idx / D, c = idx % D;
    const int s = q0 + r;
    qs[idx] = s < sq && c < d ? tos::to_float(qp[s * q_row + c]) * scale : 0.f;
  }

  const int n_kt = (sk + kBlockK - 1) / kBlockK;
  int hi = n_kt, lo = 0;
  if (causal) {
    const int q_hi = q_base + q0 + kBlockQ - 1;  // the tile's last absolute position
    hi = tos::clamp_int(tos::floor_div(q_hi - kv_base, kBlockK) + 1, 0, n_kt);
  }
  if (window > 0) {
    const int k_lo = q_base + q0 - (window - 1) - kv_base;
    lo = tos::clamp_int(tos::floor_div(k_lo, kBlockK), 0, n_kt);
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kCols];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = tos::kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  }
  float* pw = ps + warp * kRowsPerWarp * kBlockK;

  for (int kt = lo; kt < hi; ++kt) {
    __syncthreads();  // the previous tile is fully consumed (and q is staged)
    const int k0 = kt * kBlockK;
    for (int idx = tid; idx < kBlockK * D; idx += 32 * kWarps) {
      const int r = idx / D, c = idx % D;
      const int s = k0 + r;
      const bool in = s < sk && c < d;
      ks[r * (D + 1) + c] = in ? tos::to_float(kp[s * kv_row + c]) : 0.f;
      vs[idx] = in ? tos::to_float(vp[s * kv_row + c]) : 0.f;
    }
    __syncthreads();

    const int j0 = k0 + lane, j1 = j0 + 32;  // this lane's two keys
    const float* kr0 = ks + lane * (D + 1);
    const float* kr1 = ks + (lane + 32) * (D + 1);
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = warp * kRowsPerWarp + r;
      const float* qr = qs + row * D;
      float s0 = 0.f, s1 = 0.f;
#pragma unroll 8
      for (int c = 0; c < D; ++c) {
        const float qv = qr[c];
        s0 = fmaf(qv, kr0[c], s0);
        s1 = fmaf(qv, kr1[c], s1);
      }
      bool keep0 = j0 < sk, keep1 = j1 < sk;
      if (causal) {
        const int qpos = q_base + q0 + row;
        const int kp0 = kv_base + j0, kp1 = kv_base + j1;
        keep0 = keep0 && kp0 <= qpos;
        keep1 = keep1 && kp1 <= qpos;
        if (window > 0) {
          keep0 = keep0 && kp0 > qpos - window;
          keep1 = keep1 && kp1 > qpos - window;
        }
      }
      s0 = keep0 ? s0 : tos::kNegInf;
      s1 = keep1 ? s1 : tos::kNegInf;
      const float m_new = fmaxf(m[r], tos::warp_max(fmaxf(s0, s1)));
      const float m_safe = m_new <= tos::kNegInf ? 0.f : m_new;
      const float p0 = s0 <= tos::kNegInf ? 0.f : expf(s0 - m_safe);
      const float p1 = s1 <= tos::kNegInf ? 0.f : expf(s1 - m_safe);
      const float corr = m[r] <= tos::kNegInf ? 0.f : expf(m[r] - m_safe);
      l[r] = l[r] * corr + tos::warp_sum(p0 + p1);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] *= corr;
      pw[r * kBlockK + lane] = p0;
      pw[r * kBlockK + lane + 32] = p1;
    }
    __syncwarp();

#pragma unroll 4
    for (int j = 0; j < kBlockK; ++j) {
      float vv[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) vv[c] = vs[j * D + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float p = pw[r * kBlockK + j];
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[r][c] = fmaf(p, vv[c], acc[r][c]);
      }
    }
    __syncwarp();
  }

  T* op = out + static_cast<long>(b) * sq * q_row + static_cast<long>(qh) * d;
  float* lp = lse + static_cast<long>(bh) * sq;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int s = q0 + warp * kRowsPerWarp + r;
    if (s >= sq) continue;
    const float l_safe = l[r] == 0.f ? 1.f : l[r];
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      if (lane + 32 * c < d)
        op[s * q_row + lane + 32 * c] = tos::from_float<T>(acc[r][c] / l_safe);
    if (lane == 0) lp[s] = l[r] == 0.f ? tos::kNegInf : m[r] + logf(l_safe);
  }
}

template <int D, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* lse,
                   int b, int sq, int sk, int h, int hk, int d, int q_base, int kv_base,
                   int causal, int window, float scale, int device, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  // the shared-memory attribute is set once per instantiation and device
  static unsigned long long configured = 0;
  const unsigned long long bit = 1ull << (device & 63);
  if (!(configured & bit)) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    configured |= bit;
  }
  const dim3 grid((sq + kBlockQ - 1) / kBlockQ, b * h);
  flash_fwd_kernel<D, T><<<grid, 32 * kWarps, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, sq, sk, h, hk, d, q_base, kv_base, causal, window, scale);
  return cudaGetLastError();
}

// -- bf16: wgmma + TMA -------------------------------------------------------

namespace sm90 = tos::sm90;

constexpr int kWgQ = 128;                 // q rows per CTA
constexpr int kWgK = 64;                  // keys per K/V tile
constexpr int kWgStages = 4;              // K/V ring depth
constexpr int kWgConsumers = 2;           // warpgroups of 64 q rows
constexpr int kWgThreads = 128 * kWgConsumers;  // thread 0 also issues the copies
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct WgFwdSmem {
  static constexpr int kQBytes = kWgQ * D * 2;       // D / 64 boxes of kWgQ rows
  static constexpr int kKVBytes = kWgK * D * 2;      // one K (or V) tile
  static constexpr int kStageBytes = 2 * kKVBytes;   // K then V
  static constexpr size_t kBytes = 1024 + kQBytes + kWgStages * kStageBytes;  // + alignment
};

// Copies K/V tile `kt` into the ring stage of the `i`-th visible tile.
template <int D>
__device__ __forceinline__ void issue_kv(uint8_t* kv_ring, uint64_t* full, const CUtensorMap* tm_k,
                                         const CUtensorMap* tm_v, int i, int kt, int kvh, int b) {
  using S = WgFwdSmem<D>;
  const int s = i % kWgStages;
  uint8_t* k_tile = kv_ring + s * S::kStageBytes;
  uint8_t* v_tile = k_tile + S::kKVBytes;
  sm90::mbar_arrive_expect_tx(&full[s], S::kStageBytes);
#pragma unroll
  for (int j = 0; j < D / 64; ++j) {
    sm90::tma_load_4d(k_tile + j * kWgK * sm90::kRowBytes, tm_k, &full[s], 64 * j, kvh, kt * kWgK,
                      b);
    sm90::tma_load_4d(v_tile + j * kWgK * sm90::kRowBytes, tm_v, &full[s], 64 * j, kvh, kt * kWgK,
                      b);
  }
}

// Two CTAs an SM at a padded width D of 64 (106 registers a thread fit the
// 128 that allows); one at 128. d: the head_dim.
template <int D>
__global__ void __launch_bounds__(kWgThreads, D == 64 ? 2 : 1)
    flash_fwd_kernel_wgmma(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int sq,
                           int sk, int h, int hk, int d, int q_base, int kv_base, int causal,
                           int window, float scale) {
  using S = WgFwdSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bar_q, full[kWgStages], empty[kWgStages];
  uint8_t* q_tile = sm90::align_1024(smem_raw);
  uint8_t* kv_ring = q_tile + S::kQBytes;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int bh = blockIdx.x;
  const int b = bh / h;
  const int qh = bh % h;
  const int kvh = qh / (h / hk);
  const int n_qt = (sq + kWgQ - 1) / kWgQ;
  const int qt = causal ? n_qt - 1 - static_cast<int>(blockIdx.y) : static_cast<int>(blockIdx.y);
  const int q0 = qt * kWgQ;
  const int n_kt = (sk + kWgK - 1) / kWgK;

  // visible k tiles of the CTA: _window_k_lo .. _causal_k_hi from its first
  // and last real row
  int lo = 0, hi = n_kt;
  if (causal)
    hi = tos::clamp_int(tos::floor_div(q_base + min(sq, q0 + kWgQ) - 1 - kv_base, kWgK) + 1, 0,
                        n_kt);
  if (causal && window > 0)
    lo = tos::clamp_int(tos::floor_div(q_base + q0 - (window - 1) - kv_base, kWgK), 0, n_kt);

  if (threadIdx.x == 0) {
    sm90::mbar_init(&bar_q, 1);
    for (int s = 0; s < kWgStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 4 * kWgConsumers);  // one arrival per consumer warp
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  // thread 0 issues every copy: the q tile and the first kWgStages K/V tiles
  // here, each later tile once every warp is done with the stage it reuses
  const int n_tiles = hi - lo;
  if (threadIdx.x == 0 && n_tiles > 0) {
    sm90::mbar_arrive_expect_tx(&bar_q, S::kQBytes);
#pragma unroll
    for (int j = 0; j < D / 64; ++j)
      sm90::tma_load_4d(q_tile + j * kWgQ * sm90::kRowBytes, &tm_q, &bar_q, 64 * j, qh, q0, b);
    for (int i = 0; i < min(n_tiles, kWgStages); ++i)
      issue_kv<D>(kv_ring, full, &tm_k, &tm_v, i, lo + i, kvh, b);
  }

  // consumer warpgroup wg: q rows q0 + 64 wg .. + 63; this thread's two rows
  const int wg = warp >> 2;
  const int wr = (warp & 3) * 16 + (lane >> 2);   // row within the warpgroup
  const int quad = lane & 3;
  const int row0 = q0 + wg * 64 + wr;             // and row0 + 8
  const int wg_first = q0 + wg * 64;
  const int wg_last = min(sq, wg_first + 64) - 1;
  // the tiles this warpgroup's rows can see (none when it has no real row)
  int wg_lo = lo, wg_hi = wg_first < sq ? hi : lo;
  if (causal && wg_first < sq)
    wg_hi = min(hi, tos::clamp_int(tos::floor_div(q_base + wg_last - kv_base, kWgK) + 1, 0, n_kt));
  if (causal && window > 0)
    wg_lo = max(lo, tos::clamp_int(tos::floor_div(q_base + wg_first - (window - 1) - kv_base, kWgK),
                                   0, n_kt));

  const float sl2 = scale * kLog2e;
  float m[2] = {tos::kNegInf, tos::kNegInf};   // running max of the raw scores q . k
  float l[2] = {0.f, 0.f};                     // this thread's share of the row sums
  float o[D / 2];
#pragma unroll
  for (int x = 0; x < D / 2; ++x) o[x] = 0.f;

  const uint32_t q_addr = sm90::smem_u32(q_tile) + wg * 64 * sm90::kRowBytes;
  if (lo < hi) sm90::mbar_wait(&bar_q, 0);
  for (int kt = lo; kt < hi; ++kt) {
    const int i = kt - lo, s = i % kWgStages;
    sm90::mbar_wait(&full[s], (i / kWgStages) & 1);
    if (kt >= wg_lo && kt < wg_hi) {
      const uint32_t k_addr = sm90::smem_u32(kv_ring + s * S::kStageBytes);
      const uint32_t v_addr = k_addr + S::kKVBytes;
      float sc[kWgK / 2];
      sm90::wgmma_fence();
#pragma unroll
      for (int k = 0; k < D / 16; ++k)
        sm90::wgmma_ss<kWgK>(sc, sm90::desc_k_major(q_addr, kWgQ * sm90::kRowBytes, k),
                                sm90::desc_k_major(k_addr, kWgK * sm90::kRowBytes, k), k > 0);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sc);

      const int k0 = kt * kWgK;
      // masks only where a key of the tile can be hidden from a row of the
      // warpgroup: the causal diagonal, the window's edge, keys past sk
      const bool need = k0 + kWgK > sk ||
                        (causal && kv_base + k0 + kWgK - 1 > q_base + wg_first) ||
                        (causal && window > 0 && kv_base + k0 <= q_base + wg_last - window);
      if (need) {
#pragma unroll
        for (int j = 0; j < kWgK / 8; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = k0 + 8 * j + 2 * quad + e;
              const int qpos = q_base + row0 + 8 * r, kpos = kv_base + col;
              bool keep = col < sk;
              if (causal) {
                keep = keep && kpos <= qpos;
                if (window > 0) keep = keep && kpos > qpos - window;
              }
              if (!keep) sc[4 * j + 2 * r + e] = tos::kNegInf;
            }
      }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = tos::kNegInf;
#pragma unroll
        for (int j = 0; j < kWgK / 8; ++j)
          mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[r], mx);
        const float m_safe = m_new <= tos::kNegInf ? 0.f : m_new;
        const float off = m_safe * sl2;
        corr[r] = m[r] <= tos::kNegInf ? 0.f : sm90::exp2_approx(fmaf(m[r], sl2, -off));
        m[r] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < kWgK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = sc[4 * j + 2 * r + e];
            x = x <= tos::kNegInf ? 0.f : sm90::exp2_approx(fmaf(x, sl2, -off));
            sum += x;
          }
        l[r] = l[r] * corr[r] + sum;
      }
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j + 0] *= corr[0];
        o[4 * j + 1] *= corr[0];
        o[4 * j + 2] *= corr[1];
        o[4 * j + 3] *= corr[1];
      }
      uint32_t pf[kWgK / 16][4];
#pragma unroll
      for (int k = 0; k < kWgK / 16; ++k) sm90::a_frag_from_acc(sc, k, pf[k]);
      sm90::wgmma_fence();
#pragma unroll
      for (int k = 0; k < kWgK / 16; ++k)
        sm90::wgmma_rs<D>(o, pf[k], sm90::desc_mn_major(v_addr, kWgK * sm90::kRowBytes, k), 1);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(o);
    }
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&empty[s]);  // this warp is done with the stage
    // the previous tile's stage takes the tile kWgStages after it; waiting
    // one tile back leaves the other warpgroup a tile of slack
    const int prev = i - 1;
    if (threadIdx.x == 0 && prev >= 0 && prev + kWgStages < n_tiles) {
      sm90::mbar_wait(&empty[prev % kWgStages], (prev / kWgStages) & 1);
      issue_kv<D>(kv_ring, full, &tm_k, &tm_v, prev + kWgStages, lo + prev + kWgStages, kvh, b);
    }
    __syncwarp();
  }

  // out = acc / l, lse = m * scale + log(l); the row sums over the quad
  __nv_bfloat16* op = out + static_cast<long>(b) * sq * h * d + static_cast<long>(qh) * d;
  float* lp = lse + static_cast<long>(bh) * sq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const int row = row0 + 8 * r;
    if (row >= sq) continue;
    const float l_safe = lr == 0.f ? 1.f : lr;
    const float inv = 1.f / l_safe;
    __nv_bfloat16* dst = op + static_cast<long>(row) * h * d + 2 * quad;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      if (8 * j < d)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
            __floats2bfloat162_rn(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
    if (quad == 0) lp[row] = lr == 0.f ? tos::kNegInf : m[r] * scale + logf(l_safe);
  }
}

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* out, float* lse,
                         int b, int sq, int sk, int h, int hk, int d, int q_base, int kv_base,
                         int causal, int window, float scale, int device, cudaStream_t stream) {
  constexpr size_t smem = WgFwdSmem<D>::kBytes;
  static unsigned long long configured = 0;
  const unsigned long long bit = 1ull << (device & 63);
  if (!(configured & bit)) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    configured |= bit;
  }
  // with no keys the kernel loads no K/V tile: map q in their place
  const bool keys = sk > 0;
  CUtensorMap mq, mk, mv;
  cudaError_t e = sm90::encode_bshd_map(&mq, q, b, sq, h, d, kWgQ);
  if (e == cudaSuccess)
    e = sm90::encode_bshd_map(&mk, keys ? k : q, b, keys ? sk : sq, keys ? hk : h, d, kWgK);
  if (e == cudaSuccess)
    e = sm90::encode_bshd_map(&mv, keys ? v : q, b, keys ? sk : sq, keys ? hk : h, d, kWgK);
  if (e != cudaSuccess) return e;
  const dim3 grid(b * h, (sq + kWgQ - 1) / kWgQ);
  flash_fwd_kernel_wgmma<D><<<grid, kWgThreads, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(out), lse, sq, sk, h, hk, d, q_base, kv_base,
      causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

// q, out: [b, sq, h, d]; k, v: [b, sk, hk, d], all contiguous in `dtype` on CUDA
// device `device`; lse: [b, h, sq] f32; d in 8..128, a multiple of 8. window
// <= 0 means no window. Returns cudaGetLastError().
extern "C" int tos_flash_attention_fwd(const void* q, const void* k, const void* v,
                                       void* out, void* lse, int b, int sq, int sk, int h,
                                       int hk, int d, int q_base, int kv_base, int causal,
                                       int window, float scale, int dtype, int device,
                                       void* stream) {
  cudaGetLastError();  // start from a clean error state
  if (b <= 0 || sq <= 0 || h <= 0) return 0;
  if (hk <= 0 || h % hk != 0 || sk < 0) return static_cast<int>(cudaErrorInvalidValue);
  // this library links its own CUDA runtime: select the tensors' device here
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  cudaError_t e = cudaErrorInvalidValue;
  // bf16 runs on the tensor cores, f32 on the CUDA cores (see the note above)
  const int dp = tos::padded_head_dim(d);
  if (dtype == tos::kBFloat16 && dp == 64) {
    e = launch_wgmma<64>(q, k, v, out, l, b, sq, sk, h, hk, d, q_base, kv_base, causal, window,
                         scale, device, s);
  } else if (dtype == tos::kBFloat16 && dp == 128) {
    e = launch_wgmma<128>(q, k, v, out, l, b, sq, sk, h, hk, d, q_base, kv_base, causal, window,
                          scale, device, s);
  } else if (dtype == tos::kFloat32 && dp == 64) {
    e = launch<64, float>(q, k, v, out, l, b, sq, sk, h, hk, d, q_base, kv_base, causal, window,
                          scale, device, s);
  } else if (dtype == tos::kFloat32 && dp == 128) {
    e = launch<128, float>(q, k, v, out, l, b, sq, sk, h, hk, d, q_base, kv_base, causal, window,
                           scale, device, s);
  }
  return static_cast<int>(e);
}
