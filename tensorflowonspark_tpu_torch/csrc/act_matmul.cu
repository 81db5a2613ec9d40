// tanh-GELU fused into the matrix product that consumes it, for Hopper:
// out = gelu(x) @ w, gelu(x) = x * 0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 x^3))).
//
// Replaces: tensorflowonspark_tpu/ops/act_matmul.py _act_matmul_kernel (the
// Pallas kernel launched by _act_matmul_fwd). Same arithmetic: GELU of the
// pre-activation in f32 (jax.nn.gelu(approximate=True)), rounded to w's
// dtype before the product, the product summed in f32 and written in x's
// dtype. The activated [rows, f] tensor — the widest in the block — never
// exists in device memory.
//
// Bound on the H100: operations. At the training shape (16384 rows, f 3072,
// n 768, the MLP down-projection) the product is 2 * rows * f * n operations
// against ~2 bytes per element moved, above the card's balance.
//
// Design (prologue_gemm.cuh): a CTA owns a 128 x 128 output tile (64 x 64 in
// f32) and streams K: each 32-wide slice of the pre-activation goes through
// GELU in f32 (tanhf, accurate to a few ulp) on its way from registers into
// shared memory, and the tensor cores multiply it by the matching slice of
// w. Unlike ln_matmul there are no row statistics: the prologue is purely
// elementwise. At f 3072 a 128-row panel of the activation (768 KB in bf16)
// could not stay in shared memory anyway. Each CTA applies GELU to its rows
// once per column tile (n / 128 = 6 times at n 768), as the TPU kernel does
// once per N tile.

#include "prologue_gemm.cuh"

// x: [rows, f] in `dtype` (bf16 or f32); w: [f, n] in `dtype`; out: [rows, n]
// in `dtype`; all contiguous on CUDA device `device`, pointers 16-byte
// aligned; f and n any width. Launches one kernel on `stream` and returns
// cudaGetLastError().
extern "C" int tos_gelu_matmul(const void* x, const void* w, void* out, int rows, int f,
                               int n, int dtype, int device, void* stream) {
  cudaGetLastError();  // start from a clean error state
  if (rows <= 0 || n <= 0) return 0;
  // this library links its own CUDA runtime: select the tensors' device here
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  return static_cast<int>(tos::pgemm::launch<tos::pgemm::Prologue::kGelu>(
      x, nullptr, nullptr, w, out, rows, f, n, 0.f, dtype, static_cast<cudaStream_t>(stream)));
}
