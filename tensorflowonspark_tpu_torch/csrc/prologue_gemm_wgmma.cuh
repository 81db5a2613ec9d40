// The bf16 body of out = f(x) @ w on Hopper's tensor cores (wgmma + TMA),
// with the elementwise prologue f applied in registers, on the A fragments
// the products read. Templated on the prologue as prologue_gemm.cuh is, and
// instantiated for both: tanh-GELU (act_matmul.cu) and LayerNorm
// (ln_matmul.cu). Widths that are not multiples of 8 keep
// prologue_gemm.cuh's WMMA body, f32 its CUDA-core body (body() below says
// which a shape takes).
//
// Replaces: tensorflowonspark_tpu/ops/act_matmul.py _act_matmul_kernel and
// tensorflowonspark_tpu/ops/ln_matmul.py _ln_matmul_kernel (the Pallas
// kernels launched by _act_matmul_fwd and _ln_matmul_fwd) for bf16 x and w
// whose widths k and n are multiples of 8 (TMA's 16-byte row strides). Same
// arithmetic: f(x) in f32, rounded to bf16 (w's dtype) before the product,
// the product summed in f32, the output written in bf16 (x's dtype).
// LayerNorm: (x - mean) * rstd * w_ln in that order, from the row
// statistics a kernel of its own wrote before (prologue_gemm.cuh
// ln_matmul_stats_kernel); the centred subtraction comes first, as the
// reference computes it, so a row whose mean is large against its spread
// keeps its digits.
//
// What bounds it on the H100: operations. At the training shapes (16384
// rows; GELU f 3072, n 768; LayerNorm h 768, n 2304 or 3072) the product is
// 58-77 GFLOP (0.058-0.078 ms at 989 TFLOP/s) against ~0.1 GB moved. The
// WMMA body it replaces ran at 12-13% of that bound: legacy mma.sync from
// shared memory, a 32-deep K step with two CTA-wide barriers, and the
// prologue as a separate shared -> registers -> shared pass serialised with
// the products. Beside the product the prologue itself is CUDA-core work,
// run once per element of x for every column tile of the output (n / 256
// times). GELU with tanhf set this body's pace on the card, so GELU is
// evaluated as x / (1 + 2^(-2 u log2 e)), the same function: one
// ex2.approx, one rcp.approx and a few FMAs, a few ulp of f32 from tanhf's
// value (PERF.md, section 6, has both times and errors). LayerNorm is three
// f32 operations an element.
//
// Design. A CTA owns a 128 x 256 output tile: two consumer warpgroups of 64
// rows, each holding 64 x 256 f32 accumulators (128 registers a thread),
// one CTA an SM. Thread 0 streams 64-deep K steps through a 4-stage ring of
// full/empty mbarriers by TMA (hopper_mma.cuh, 128-byte swizzle): the raw x
// tile [128 rows x 64] (K-major) and w's [64 x 256] (four 64-column boxes,
// n contiguous: MN-major for B, tnspB), and for LayerNorm the step's 64
// values of w_ln (f32, unswizzled, in a slot per stage past the ring).
// Each warpgroup reads its 64 rows of the raw x stage straight into wgmma
// A fragments (ldmatrix on the swizzled rows), applies f in f32 and rounds
// to bf16 in registers, and issues the 64 x 256 x 64 product as wgmma with
// A from registers (two N-128 halves per 16-deep step). A thread's
// fragment rows are fixed (rows 16 w + l / 4 and + 8 of its warpgroup's
// 64, for warp w and lane l), so it loads their (mean, rstd) once, before
// the K loop; its columns of each 16-deep step are 2 (l % 4) + {0, 1} and
// + 8, whose w_ln it reads as two float2 from the stage's slot. No CTA-wide
// barrier separates a prologue from a product: the fragments are
// double-buffered, so a warpgroup's prologue for step k + 1 runs while its
// products of step k are in flight (wgmma_wait<1>), and the two
// warpgroups' prologues overlap each other's products. A stage is released
// once both warpgroups' products on it are done. Ragged rows, k and n need
// no masking in the loop: TMA reads zeros past every edge (w_ln included),
// so GELU(0) = 0, rows past `rows` get (mean, rstd) = (0, 0), columns past
// k stay finite, and zero rows of w add nothing. The epilogue rounds to
// bf16, stages the tile in shared memory (16-byte chunks XOR-swizzled by
// row against bank conflicts) and writes 16-byte vectors, no row past
// `rows` and no column past n.
#pragma once

#include <stdint.h>

#include "common.cuh"
#include "hopper_mma.cuh"
#include "prologue_gemm.cuh"

namespace tos {
namespace pgemm_wg {

namespace sm90 = tos::sm90;
using pgemm::Prologue;

constexpr int kBM = 128;                       // rows per CTA: two warpgroups of 64
constexpr int kBN = 256;                       // output columns per CTA: one CTA an SM
constexpr int kBK = 64;                        // K per stage: one 128-byte swizzle row
constexpr int kStages = 4;
constexpr int kThreads = 256;                  // thread 0 also issues the copies
constexpr int kHalves = kBN / 128;             // N-128 products per 16-deep step
constexpr int kXBytes = kBM * kBK * 2;         // the raw x tile of a stage
constexpr int kWBox = kBK * sm90::kRowBytes;   // one 64-column box of w's tile
constexpr int kWBytes = (kBN / 64) * kWBox;
constexpr int kStageBytes = kXBytes + kWBytes;
constexpr size_t kSmem = 1024 + static_cast<size_t>(kStages) * kStageBytes;
static_assert(2 * 64 * kBN * 2 <= kStages * kStageBytes, "the epilogue reuses the ring");
constexpr int kWlnBytes = kBK * 4;             // LayerNorm: a stage's w_ln, past the ring

// bytes a stage's TMA copies bring, and the dynamic shared memory, by prologue
template <Prologue P>
__host__ __device__ constexpr int stage_tx_bytes() {
  return kStageBytes + (P == Prologue::kLayerNorm ? kWlnBytes : 0);
}
template <Prologue P>
constexpr size_t smem_bytes() {
  return kSmem + (P == Prologue::kLayerNorm ? kStages * kWlnBytes : 0);
}

// Which body f(x) @ w runs for k, n and dtype (tos::kBFloat16 / kFloat32):
// 2 this one, 1 prologue_gemm.cuh's WMMA body, 0 its f32 body, -1 none
inline int body(int k, int n, int dtype) {
  if (dtype == kBFloat16) return k > 0 && k % 8 == 0 && n % 8 == 0 ? 2 : 1;
  return dtype == kFloat32 ? 0 : -1;
}

// GELU in f32, tanh-approximated as jax.nn.gelu(approximate=True) writes it,
// evaluated as x * sigmoid(2 u): 0.5 (1 + tanh u) = 1 / (1 + e^(-2 u))
__device__ __forceinline__ float gelu(float x) {
  // -2 sqrt(2/pi) log2(e), folded
  const float kNeg2Log2eSqrt2OverPi = -2.0f * 1.4426950408889634f * 0.7978845608028654f;
  const float e = sm90::exp2_approx(kNeg2Log2eSqrt2OverPi * (x + 0.044715f * (x * x * x)));
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(1.0f + e));
  return x * r;
}

// What a thread's prologue knows besides its fragments: nothing for GELU;
// for LayerNorm the (mean, rstd) of its two fragment rows
template <Prologue P>
struct RowStats {};
template <>
struct RowStats<Prologue::kLayerNorm> {
  float2 row[2];   // rows 16 w + l / 4 and + 8 of the warpgroup's 64
};

// The prologue on the four A-fragment registers of one 16-deep step (each
// two bf16 of x, the low half the lower column; af[i] holds row i % 2 and
// columns + 8 (i / 2) of the thread's): f in f32, rounded to bf16 as the
// reference rounds f(x).astype(w.dtype). `wln` is the stage's w_ln slot.
template <Prologue P>
__device__ __forceinline__ void prologue_frag(uint32_t (&af)[4], const uint32_t (&raw)[4],
                                              const RowStats<P>& rs, const float* wln, int k) {
  if constexpr (P == Prologue::kGelu) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw[i]));
      af[i] = sm90::pack_bf16x2(gelu(f.x), gelu(f.y));
    }
  } else {
    const float* wc = wln + 16 * k + 2 * (threadIdx.x & 3);
    const float2 w[2] = {*reinterpret_cast<const float2*>(wc),
                         *reinterpret_cast<const float2*>(wc + 8)};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw[i]));
      const float2 st = rs.row[i & 1];
      af[i] = sm90::pack_bf16x2((f.x - st.x) * st.y * w[i >> 1].x,
                                (f.y - st.x) * st.y * w[i >> 1].y);
    }
  }
}

// Thread 0: K step `kt` into its ring stage (and, for LayerNorm, the
// step's w_ln into the stage's slot past the ring).
template <Prologue P>
__device__ __forceinline__ void issue_stage(uint8_t* ring, uint64_t* full, const CUtensorMap* tm_x,
                                            const CUtensorMap* tm_w, const CUtensorMap* tm_wln,
                                            int kt, int m0, int n0) {
  const int s = kt % kStages;
  uint8_t* x_tile = ring + s * kStageBytes;
  uint8_t* w_tile = x_tile + kXBytes;
  sm90::mbar_arrive_expect_tx(&full[s], stage_tx_bytes<P>());
  sm90::tma_load_2d(x_tile, tm_x, &full[s], kt * kBK, m0);
#pragma unroll
  for (int j = 0; j < kBN / 64; ++j)
    sm90::tma_load_2d(w_tile + j * kWBox, tm_w, &full[s], n0 + 64 * j, kt * kBK);
  if constexpr (P == Prologue::kLayerNorm)
    sm90::tma_load_2d(ring + kStages * kStageBytes + s * kWlnBytes, tm_wln, &full[s], kt * kBK, 0);
}

// keeps fragment registers live, and unmoved, up to this point: the
// registers a wgmma in flight reads must not be reused before the wait that
// retires it
__device__ __forceinline__ void hold_frags(uint32_t (&af)[4][4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(af[k][i])::"memory");
}

// One K step of a consumer warpgroup: the A fragments of its 64 rows from
// the raw x stage through the prologue into `af`, then the products, left in
// flight (the first step's first product overwrites the accumulators, so no
// other instruction writes them while products are in flight); waits for
// the previous step's products, whose fragments `af_prev` it then frees,
// and releases their stage.
template <Prologue P>
__device__ __forceinline__ void consume_stage(uint8_t* ring, uint64_t* full, uint64_t* empty,
                                              const CUtensorMap* tm_x, const CUtensorMap* tm_w,
                                              const CUtensorMap* tm_wln, const RowStats<P>& rs,
                                              int kt, int nk, int m0, int n0,
                                              float (&acc)[kHalves][64], uint32_t (&af)[4][4],
                                              uint32_t (&af_prev)[4][4]) {
  const int s = kt % kStages;
  sm90::mbar_wait(&full[s], (kt / kStages) & 1);
  const int lane = threadIdx.x & 31;
  const int wgi = threadIdx.x >> 7;
  // lane l gives row (l % 8) + 8 ((l / 8) % 2) of its warp's 16, 16-byte
  // chunk (l / 16) of the 16-deep step: ldmatrix_x4's A-fragment order
  const int row = wgi * 64 + ((threadIdx.x >> 5) & 3) * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
  const uint32_t x_row = sm90::smem_u32(ring + s * kStageBytes) + row * sm90::kRowBytes;
  const float* wln = reinterpret_cast<const float*>(ring + kStages * kStageBytes + s * kWlnBytes);
#pragma unroll
  for (int k = 0; k < kBK / 16; ++k) {
    uint32_t raw[4];
    sm90::ldmatrix_x4(raw, x_row + (((2 * k + (lane >> 4)) ^ (lane & 7)) << 4));
    prologue_frag<P>(af[k], raw, rs, wln, k);
  }
  const uint32_t w_addr = sm90::smem_u32(ring + s * kStageBytes + kXBytes);
  sm90::wgmma_fence();
#pragma unroll
  for (int k = 0; k < kBK / 16; ++k)
#pragma unroll
    for (int h = 0; h < kHalves; ++h)
      sm90::wgmma_rs<128>(acc[h], af[k], sm90::desc_mn_major(w_addr + 2 * h * kWBox, kWBox, k),
                          kt > 0 || k > 0);
  sm90::wgmma_commit();
  // the previous step's products are done: its fragments and stage are free
  sm90::wgmma_wait<1>();
  hold_frags(af_prev);
  if (kt == 0) return;
  const int prev = kt - 1;
  __syncwarp();
  if (lane == 0) sm90::mbar_arrive(&empty[prev % kStages]);
  if (threadIdx.x == 0 && prev + kStages < nk) {
    sm90::mbar_wait(&empty[prev % kStages], (prev / kStages) & 1);
    issue_stage<P>(ring, full, tm_x, tm_w, tm_wln, prev + kStages, m0, n0);
  }
  __syncwarp();
}

template <Prologue P>
__global__ void __launch_bounds__(kThreads, 1)
    prologue_gemm_wgmma(const __grid_constant__ CUtensorMap tm_x,
                        const __grid_constant__ CUtensorMap tm_w,
                        const __grid_constant__ CUtensorMap tm_wln,
                        const float2* __restrict__ stats, __nv_bfloat16* __restrict__ out,
                        int rows, int k, int n) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[kStages], empty[kStages];
  uint8_t* ring = sm90::align_1024(smem_raw);
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int nk = (k + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], kThreads / 32);  // one arrival per warp
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int kt = 0; kt < min(nk, kStages); ++kt)
      issue_stage<P>(ring, full, &tm_x, &tm_w, &tm_wln, kt, m0, n0);

  // LayerNorm: the statistics of the thread's two fragment rows, read while
  // the first stages arrive (rows past `rows` get 0 and 0)
  RowStats<P> rs;
  if constexpr (P == Prologue::kLayerNorm) {
    const int r0 = m0 + (threadIdx.x >> 7) * 64 + ((threadIdx.x >> 5) & 3) * 16 +
                   ((threadIdx.x & 31) >> 2);
#pragma unroll
    for (int i = 0; i < 2; ++i)
      rs.row[i] = r0 + 8 * i < rows ? stats[r0 + 8 * i] : make_float2(0.f, 0.f);
  }

  // the accumulators: written first by the first step's products
  float acc[kHalves][64];
  // two fragment buffers, alternating steps: step kt + 1 fills one while
  // the products of step kt read the other
  uint32_t af0[4][4] = {}, af1[4][4] = {};
  for (int kt = 0; kt < nk; kt += 2) {
    consume_stage<P>(ring, full, empty, &tm_x, &tm_w, &tm_wln, rs, kt, nk, m0, n0, acc, af0, af1);
    if (kt + 1 < nk)
      consume_stage<P>(ring, full, empty, &tm_x, &tm_w, &tm_wln, rs, kt + 1, nk, m0, n0, acc,
                       af1, af0);
  }
  sm90::wgmma_wait<0>();
#pragma unroll
  for (int h = 0; h < kHalves; ++h) sm90::fence_regs(acc[h]);

  // epilogue: every stage is consumed; each warpgroup rounds its 64 x kBN
  // tile to bf16 into the ring, rows of kBN / 8 16-byte chunks, chunk c of
  // row r at c ^ (r % 8), then writes 16-byte vectors
  __syncthreads();
  const int wgi = threadIdx.x >> 7;
  const int lane = threadIdx.x & 31;
  const int quad = lane & 3;
  const int wr = ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);   // and wr + 8
  uint8_t* tile = ring + wgi * 64 * kBN * 2;
#pragma unroll
  for (int h = 0; h < kHalves; ++h)
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int rr = wr + 8 * r, c = 16 * h + j;   // chunk: columns 8 c .. 8 c + 7
        *reinterpret_cast<uint32_t*>(tile + rr * kBN * 2 + ((c ^ (rr & 7)) << 4) + 4 * quad) =
            sm90::pack_bf16x2(acc[h][4 * j + 2 * r], acc[h][4 * j + 2 * r + 1]);
      }
  __syncthreads();
  constexpr int kChunks = kBN / 8;
  const int t = threadIdx.x & 127;
#pragma unroll 4
  for (int idx = t; idx < 64 * kChunks; idx += 128) {
    const int rr = idx / kChunks, c = idx % kChunks;
    const long grow = static_cast<long>(m0) + wgi * 64 + rr;
    const int col = n0 + 8 * c;
    if (grow < rows && col < n)   // n % 8 == 0: a chunk is all in or all out
      *reinterpret_cast<uint4*>(out + grow * n + col) =
          *reinterpret_cast<const uint4*>(tile + rr * kBN * 2 + ((c ^ (rr & 7)) << 4));
  }
}

// Launches f(x) @ w on `stream` for bf16 x [rows, k] and w [k, n], k and n
// multiples of 8, 16-byte aligned bases; LayerNorm also reads w_ln [k] f32
// (16-byte aligned) and the row statistics `stats` [rows] that
// ln_matmul_stats_kernel wrote before on the same stream. Returns
// cudaGetLastError().
template <Prologue P>
cudaError_t launch(const void* x, const void* w, void* out, int rows, int k, int n,
                   cudaStream_t stream, const float* w_ln = nullptr,
                   const float2* stats = nullptr) {
  if (body(k, n, kBFloat16) != 2) return cudaErrorInvalidValue;
  const dim3 grid((n + kBN - 1) / kBN, (rows + kBM - 1) / kBM);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  static unsigned long long configured = 0;
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = 1ull << (device & 63);
  if (!(configured & bit)) {
    e = cudaFuncSetAttribute(prologue_gemm_wgmma<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_bytes<P>()));
    if (e != cudaSuccess) return e;
    configured |= bit;
  }
  CUtensorMap mx, mw, mwln = {};
  e = sm90::encode_2d_map(&mx, x, rows, k, kBM);
  if (e == cudaSuccess) e = sm90::encode_2d_map(&mw, w, k, n, kBK);
  if (e == cudaSuccess && P == Prologue::kLayerNorm) e = sm90::encode_f32_row_map(&mwln, w_ln, k);
  if (e != cudaSuccess) return e;
  prologue_gemm_wgmma<P><<<grid, kThreads, smem_bytes<P>(), stream>>>(
      mx, mw, mwln, stats, static_cast<__nv_bfloat16*>(out), rows, k, n);
  return cudaGetLastError();
}

}  // namespace pgemm_wg
}  // namespace tos
