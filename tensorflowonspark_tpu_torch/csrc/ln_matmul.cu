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
// Design (prologue_gemm.cuh): two kernels. The first computes every row's
// mean and rstd over the full h once (one warp per row), into an 8-byte-per-
// row scratch. The TPU kernel re-derives its rows' statistics for every N
// tile instead; here that would have each 128 x 128 CTA read its 128 rows
// twice more, doubling the traffic between L2 and the SMs that bounds this
// first GEMM. The second kernel, the product, gives each CTA a 128 x 128
// output tile (64 x 64 in f32): it loads its rows' statistics, and its K
// loop normalizes each 32-wide slice of x in f32 on the way from the
// staged copy into the tile the tensor cores read, then multiplies it by
// the matching slice of w. Rows, h and n may be ragged against the tiles.

#include "prologue_gemm.cuh"

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
  return static_cast<int>(tos::pgemm::launch<tos::pgemm::Prologue::kLayerNorm>(
      x, static_cast<const float*>(w_ln), static_cast<float2*>(stats), w, out, rows, h, n,
      eps, dtype, static_cast<cudaStream_t>(stream)));
}
