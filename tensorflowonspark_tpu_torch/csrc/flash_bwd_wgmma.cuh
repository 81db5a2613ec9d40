// The bf16 fused flash-attention backward's tensor-core step
// (flash_attention_bwd.cu, flash_bwd_kernel_wgmma), and the tiling and
// helpers it shares with the split plan's dK/dV (flash_attention_bwd_split.cu,
// dkv_tile_wgmma), whose consumer loop runs the same step without dS.
//
// One consumer warpgroup owns 64 keys of a key tile and meets one q tile (kBQ
// rows) of one query head per step. With K, V (the warpgroup's 64 rows), Q
// and dO in shared memory as TMA wrote them (hopper_mma.cuh, 128-byte
// swizzle, D / 64 boxes) and the q tile's lse (log2 units, +inf for rows past
// Sq or rows that saw no key) and Delta beside them, a step computes, term for
// term as the reference's _pair_p_ds:
//   S^T = K Q^T and dP^T = V dO^T (wgmma, A and B K-major in shared memory);
//   P^T = exp2(s * scale * log2e - lse), 0 where the causal / window mask or
//   a key past Sk hides the entry (masked only on the tiles that need it);
//   dS^T = P^T (dP^T - Delta);
//   P^T and dS^T rounded to bf16 in registers, then dV += P^T dO and dK +=
//   dS^T Q (wgmma, A from registers, B MN-major: tnspB).
// For dQ = dS K the step also writes dS^T (the same bf16 values dK uses) into
// a [keys x kBQ] tile of shared memory in the 128-byte swizzled layout, which
// a later wgmma reads as an MN-major A operand, and leaves the dK / dV
// products in flight behind it. (The split dK/dV keeps its own copy of the
// loop: built from this shared function it ran 10-20% slower on the card,
// scheduled differently by the compiler; PERF.md, section 6.)
#pragma once

#include <stdint.h>

#include "common.cuh"
#include "hopper_mma.cuh"

namespace tos {
namespace bwd_wg {

namespace sm90 = tos::sm90;

constexpr int kStages = 2;                 // the split plan's Q / dO ring depth
constexpr float kLog2e = 1.4426950408889634f;

// Warpgroups of 64 keys per CTA, and q rows per tile, at a padded head width
// D: at 128, dK and dV take 128 f32 registers a thread, so the q tile is 32
// rows and the CTA one warpgroup (with the split plan's producer warp, 5
// warps: up to 255 registers a thread; 9 warps would leave 168, and the body
// would spill)
template <int D>
__host__ __device__ constexpr int consumers() { return D == 64 ? 2 : 1; }
template <int D>
__host__ __device__ constexpr int block_q() { return D == 64 ? 64 : 32; }
template <int D>
__host__ __device__ constexpr int keys() { return 64 * consumers<D>(); }
// the split plan's CTA: the consumer warpgroups and the producer warp
template <int D>
__host__ __device__ constexpr int threads() { return 128 * consumers<D>() + 32; }

// A row's lse as a step reads it: in log2 units, +inf for a row that saw no
// key (lse -1e30; rows past sq read as such), so that exp2(s * scale * log2e
// - lse) is 0 there
__device__ __forceinline__ float lse_log2(float l) {
  return l > tos::kNegInf ? l * kLog2e : __int_as_float(0x7f800000);
}

// The producer's share of a step: the q tile's lse (lse_log2) and Delta, one
// lane per row. `row` is the head's first row in lse.
template <int kBQ>
__device__ __forceinline__ void stage_rows(const float* __restrict__ lse,
                                           const float* __restrict__ delta, long row, int q0,
                                           int sq, float* lse_s, float* delta_s, int lane) {
  for (int c = lane; c < kBQ; c += 32) {
    const int pos = q0 + c;
    lse_s[c] = lse_log2(pos < sq ? lse[row + pos] : tos::kNegInf);
    delta_s[c] = pos < sq ? delta[row + pos] : 0.f;
  }
}

// One step of a consumer warpgroup (see the note above). k_addr / v_addr: the
// warpgroup's 64 rows of the K / V tile (boxes kKeys rows apart); q_addr /
// do_addr: the Q / dO tile; key0: the absolute index of this thread's first
// key row (and key0 + 8); wg_first / wg_last: the warpgroup's first and last
// real key; ds_rows: the warpgroup's first row of the dS^T tile. A step the
// warpgroup cannot see (`visible` false) issues no product and writes zeros
// for its rows of dS^T.
template <int D, int kBQ, int kKeys>
__device__ __forceinline__ void step(uint32_t k_addr, uint32_t v_addr, uint32_t q_addr,
                                     uint32_t do_addr, const float* lse_s, const float* delta_s,
                                     float (&dk)[D / 2], float (&dv)[D / 2], uint8_t* ds_rows,
                                     bool visible, int q0, int key0, int wg_first, int wg_last,
                                     int sk, int q_base, int kv_base, int causal, int window,
                                     float sl2) {
  const int lane = threadIdx.x & 31;
  const int quad = lane & 3;
  // this thread's two key rows in the warpgroup's 64
  const int wr = ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
  uint32_t pf[kBQ / 16][4], dsf[kBQ / 16][4];
  if (visible) {
    // S^T = K Q^T and dP^T = V dO^T: keys x q rows, K-major operands
    float st[kBQ / 2], dpt[kBQ / 2];
    sm90::wgmma_fence();
#pragma unroll
    for (int k = 0; k < D / 16; ++k) {
      sm90::wgmma_ss<kBQ>(st, sm90::desc_k_major(k_addr, kKeys * sm90::kRowBytes, k),
                          sm90::desc_k_major(q_addr, kBQ * sm90::kRowBytes, k), k > 0);
      sm90::wgmma_ss<kBQ>(dpt, sm90::desc_k_major(v_addr, kKeys * sm90::kRowBytes, k),
                          sm90::desc_k_major(do_addr, kBQ * sm90::kRowBytes, k), k > 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(st);
    sm90::fence_regs(dpt);

    // P^T = exp(s * scale - lse), 0 where masked or where the row saw no
    // key; dS^T = P^T (dP^T - Delta). Masks only on the causal diagonal, the
    // window's edge and a ragged last key tile: rows past sq carry lse = +inf,
    // and keys past sk are masked because their dS meets dQ (K's zero rows
    // times a finite dS add nothing, but exp2 of a zero score against a very
    // negative lse need not be finite)
    const bool need =
        wg_first + 63 >= sk ||
        (causal && (kv_base + wg_last > q_base + q0 ||
                    (window > 0 && kv_base + wg_first <= q_base + q0 + kBQ - 1 - window)));
#pragma unroll
    for (int j = 0; j < kBQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * quad + e;
        const float lc = lse_s[c], dc = delta_s[c];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int x = 4 * j + 2 * r + e;
          float p = sm90::exp2_approx(fmaf(st[x], sl2, -lc));
          if (need) {
            const int key = key0 + 8 * r;
            const int qpos = q_base + q0 + c, kpos = kv_base + key;
            bool keep = key < sk;
            if (causal) {
              keep = keep && kpos <= qpos;
              if (window > 0) keep = keep && kpos > qpos - window;
            }
            p = keep ? p : 0.f;
          }
          st[x] = p;
          dpt[x] = p * (dpt[x] - dc);
        }
      }
#pragma unroll
    for (int k = 0; k < kBQ / 16; ++k) {
      sm90::a_frag_from_acc(st, k, pf[k]);
      sm90::a_frag_from_acc(dpt, k, dsf[k]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < kBQ / 16; ++k)
#pragma unroll
      for (int x = 0; x < 4; ++x) dsf[k][x] = 0u;
  }
  // dS^T row r (key), columns c (q): 16-byte chunk c / 8 of the row at chunk
  // (c / 8) ^ (r % 8); dsf[k][x] holds columns 8 j + 2 quad, + 1 of row wr +
  // 8 (x & 1), j = 2 k + x / 2. Lanes of a warp hit 32 banks.
#pragma unroll
  for (int k = 0; k < kBQ / 16; ++k)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int r = wr + 8 * (x & 1), j = 2 * k + (x >> 1);
      *reinterpret_cast<uint32_t*>(ds_rows + r * sm90::kRowBytes + ((j ^ (r & 7)) << 4) +
                                   4 * quad) = dsf[k][x];
    }
  if (visible) {
    // dV += P^T dO and dK += dS^T Q: A from registers, B MN-major
    sm90::wgmma_fence();
#pragma unroll
    for (int k = 0; k < kBQ / 16; ++k) {
      sm90::wgmma_rs<D>(dv, pf[k], sm90::desc_mn_major(do_addr, kBQ * sm90::kRowBytes, k), 1);
      sm90::wgmma_rs<D>(dk, dsf[k], sm90::desc_mn_major(q_addr, kBQ * sm90::kRowBytes, k), 1);
    }
    sm90::wgmma_commit();
  }
}

// dK (times the scale: q was not pre-scaled) and dV of this thread's two key
// rows from the accumulators: as bf16 into dk / dv [.., S, Hk, d] rows (`off`
// the element offset of row key0, `row` elements between rows), or as f32
// into a partial [.., S, d] (`row` = d). Keys past sk and columns past d are
// not stored.
template <int D, typename T>
__device__ __forceinline__ void store_dkv(const float (&dk)[D / 2], const float (&dv)[D / 2],
                                          T* __restrict__ out_k, T* __restrict__ out_v, long off,
                                          long row, int key0, int sk, int d, float scale) {
  const int quad = threadIdx.x & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key0 + 8 * r >= sk) continue;
    const long o = off + 8 * r * row + 2 * quad;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      if (8 * j >= d) continue;
      const float k0 = dk[4 * j + 2 * r] * scale, k1 = dk[4 * j + 2 * r + 1] * scale;
      const float v0 = dv[4 * j + 2 * r], v1 = dv[4 * j + 2 * r + 1];
      if constexpr (sizeof(T) == 2) {
        *reinterpret_cast<__nv_bfloat162*>(out_k + o + 8 * j) = __floats2bfloat162_rn(k0, k1);
        *reinterpret_cast<__nv_bfloat162*>(out_v + o + 8 * j) = __floats2bfloat162_rn(v0, v1);
      } else {
        *reinterpret_cast<float2*>(out_k + o + 8 * j) = make_float2(k0, k1);
        *reinterpret_cast<float2*>(out_v + o + 8 * j) = make_float2(v0, v1);
      }
    }
  }
}

}  // namespace bwd_wg
}  // namespace tos
