// LayerNorm fused into the matrix product that consumes it, for Hopper:
// out = ((x - mean) * rsqrt(var + eps) * w_ln) @ w.
//
// Replaces: tensorflowonspark_tpu/ops/ln_matmul.py _ln_matmul_kernel (the
// Pallas kernel launched by _ln_matmul_fwd). Same arithmetic: f32 row
// statistics with the centered variance mean((x - mean)^2), the normalized
// row scaled by w_ln in f32 and rounded to w's dtype before the product, the
// product summed in f32 and written in x's dtype. The normalized [rows, h]
// activation never exists in device memory.
//
// Bound on the H100: operations. At the training shapes (16384 rows, h 768,
// n 2304 for the fused QKV projection or 3072 for the MLP up-projection) the
// product is 2 * rows * h * n operations against ~2 bytes per element moved,
// above the card's balance of ~295 bf16 operations per byte.
//
// Two kernels on the caller's stream. The first computes every row's mean
// and rstd over the full h once (prologue_gemm.cuh ln_matmul_stats_kernel,
// one warp per row), into an 8-byte-per-row scratch: 25 MB read at 16384 x
// 768, a bound of ~0.0075 ms. The TPU kernel re-derives its rows'
// statistics for every N tile instead; here a 128-row panel of x cannot stay
// in shared memory beside the product's ring, so each CTA would read its
// rows again. The second kernel, the product, reads each row's statistics
// once and normalizes x on its way into the tensor cores. Three bodies,
// chosen by dtype and width (tos::pgemm_wg::body):
//
// bf16, h and n multiples of 8 -> prologue_gemm_wgmma<kLayerNorm>
// (prologue_gemm_wgmma.cuh): wgmma with TMA-fed tiles, a 128 x 256 output
// tile per CTA, the LayerNorm applied in registers to the A fragments the
// products read, each thread holding its two fragment rows' (mean, rstd)
// and reading the step's w_ln from the stage TMA brought. Every config in
// the repo takes this body (h 768 or 256; n 2304, 1280, 3072, 768 or 1024).
//
// bf16 of other widths -> prologue_gemm_bf16<kLayerNorm> (prologue_gemm.cuh):
// WMMA on a 128 x 128 tile, each 32-wide slice normalized on its way into
// shared memory, element loads.
//
// f32 -> prologue_gemm_f32<kLayerNorm> (prologue_gemm.cuh): CUDA cores in
// full f32, so the f32 model agrees with its plain version to float rounding.

#include "prologue_gemm.cuh"
#include "prologue_gemm_wgmma.cuh"

// x: [rows, h] in `dtype` (bf16 or f32); w_ln: [h] f32; stats: [rows, 2] f32
// scratch; w: [h, n] in `dtype`; out: [rows, n] in `dtype`; all contiguous on
// CUDA device `device`, pointers 16-byte aligned; h and n any width.
// Launches the statistics kernel and the product on `stream` and returns
// cudaGetLastError().
extern "C" int tos_ln_matmul(const void* x, const void* w_ln, void* stats, const void* w,
                             void* out, int rows, int h, int n, float eps, int dtype,
                             int device, void* stream) {
  cudaGetLastError();  // start from a clean error state
  if (rows <= 0 || n <= 0) return 0;
  // this library links its own CUDA runtime: select the tensors' device here
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  constexpr auto kLn = tos::pgemm::Prologue::kLayerNorm;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w_ln);
  float2* st = static_cast<float2*>(stats);
  if (tos::pgemm_wg::body(h, n, dtype) == 2) {
    tos::pgemm::launch_stats<__nv_bfloat16>(x, st, rows, h, eps, s);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(tos::pgemm_wg::launch<kLn>(x, w, out, rows, h, n, s, wf, st));
  }
  return static_cast<int>(
      tos::pgemm::launch<kLn>(x, wf, st, w, out, rows, h, n, eps, dtype, s));
}

// Which body tos_ln_matmul runs for these widths and dtype: 2 the wgmma
// body, 1 WMMA, 0 the f32 body, -1 none (tos::pgemm_wg::body).
extern "C" int tos_ln_matmul_body(int h, int n, int dtype) {
  return tos::pgemm_wg::body(h, n, dtype);
}
