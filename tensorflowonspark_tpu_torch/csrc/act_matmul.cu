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
// Three bodies, chosen by dtype and width in tos_gelu_matmul:
//
// bf16, f and n multiples of 8 -> prologue_gemm_wgmma<kGelu>
// (prologue_gemm_wgmma.cuh): wgmma with TMA-fed tiles, a 128 x 256 output
// tile per CTA, GELU applied in registers to the A fragments the products
// read (as x * sigmoid(2 u), a few ulp of f32 from the tanh form), so x goes
// through GELU n / 256 = 3 times at n 768, as the TPU kernel applies it once
// per N tile. Every config in the repo takes this body (f 3072, 1024 or 256;
// n 768 or 256).
//
// bf16 of other widths -> prologue_gemm_bf16<kGelu>
// (prologue_gemm.cuh): WMMA on a 128 x 128 tile, each 32-wide slice of the
// pre-activation through GELU on its way into shared memory, element loads
// (rows off a 16-byte boundary).
//
// f32 -> prologue_gemm_f32<kGelu> (prologue_gemm.cuh): CUDA cores in full
// f32, so the f32 model agrees with its plain version to float rounding.
//
// Unlike ln_matmul there are no row statistics: the prologue is purely
// elementwise. At f 3072 a 128-row panel of the activation (768 KB in bf16)
// could not stay in shared memory anyway.

#include "prologue_gemm.cuh"
#include "prologue_gemm_wgmma.cuh"

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
  constexpr auto kGelu = tos::pgemm::Prologue::kGelu;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tos::pgemm_wg::body(f, n, dtype) == 2)
    return static_cast<int>(tos::pgemm_wg::launch<kGelu>(x, w, out, rows, f, n, s));
  return static_cast<int>(
      tos::pgemm::launch<kGelu>(x, nullptr, nullptr, w, out, rows, f, n, 0.f, dtype, s));
}

// Which body tos_gelu_matmul runs for these widths and dtype: 2 the wgmma
// body, 1 WMMA, 0 the f32 body, -1 none (tos::pgemm_wg::body).
extern "C" int tos_gelu_matmul_body(int f, int n, int dtype) {
  return tos::pgemm_wg::body(f, n, dtype);
}
