// Hopper (sm_90a) building blocks shared by the port's tensor-core kernels:
// warpgroup matrix multiply (wgmma), the Tensor Memory Accelerator (TMA) and
// mbarriers, as inline PTX, plus the host-side encoding of a TMA tensor map.
//
// Shared-memory tiles are what TMA writes with CU_TENSOR_MAP_SWIZZLE_128B:
// rows of 64 bf16 (128 bytes), 8-row atoms of 1024 bytes in which the 16-byte
// chunk c of row r sits at chunk c ^ (r % 8). A tile wider than 64 columns
// (a padded head_dim of 128) is two such boxes, one per 64 columns, one after
// the other. A head_dim d under the padded width (d = 32 in a 64-wide tile,
// 96 in a 128-wide one) is read with the tensor's real inner dimension d: TMA
// fills the columns past d with zeros, which add nothing to any product.
// Every box starts on a 1024-byte boundary, so descriptors carry no base
// offset. The same tile serves as a wgmma operand in two roles:
//   K-major (the reduction runs along the 64 contiguous columns): advance 16
//   columns by adding 32 bytes to the start address inside a box, and move to
//   the next box past column 64; 8-row groups are 1024 bytes apart (SBO);
//   MN-major (the reduction runs along the rows; tnspA / tnspB = 1, legal for
//   16-bit types): advance 16 rows by 2048 bytes; 8-row groups 1024 bytes
//   apart (SBO) and 64-column boxes `box_bytes` apart (LBO). A product N = 32
//   wide reads columns 32..63 of a box from the start address plus 64 bytes,
//   as a K-major step reads columns 16 k.. from plus 32 k bytes.
//
// Fragments (PTX ISA, "Register Fragments and Shared Memory Matrix Layouts"
// for wgmma .m64nNk16): thread t of a warpgroup, warp w = t / 32, g = (t %
// 32) / 4, q = t % 4, holds accumulator element
//   d[4 j + 2 i + e]  at row 16 w + g + 8 i, column 8 j + 2 q + e
// (i, e in {0, 1}, j < N / 8), and A-operand registers (bf16x2, low half the
// lower column) a[0] = (16 w + g, 2 q..), a[1] = (16 w + g + 8, 2 q..), a[2] =
// (16 w + g, 2 q + 8..), a[3] = (16 w + g + 8, 2 q + 8..) of a 64 x 16 slice.
// So the accumulator's columns 16 k .. 16 k + 15 are, pair by pair, the A
// operand of the k-th 16-deep step of the next product (a_frag_from_acc):
// P = softmax(S) feeds P V without leaving registers.
//
// Ordering rules the kernels keep: wgmma_fence() before a wgmma that reads
// registers written by ordinary instructions (A fragments, a rescaled
// accumulator); wgmma_wait<0>() before reading or rescaling an accumulator and
// before reusing the shared tiles a wgmma read; fence_proxy_async() after
// ordinary stores to a shared tile that a wgmma then reads (the tensor cores
// read shared memory through the async proxy), before the barrier that
// publishes it.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tos {
namespace sm90 {

// bytes of one 64-column box row, and of one 8-row swizzle atom
constexpr int kRowBytes = 128;
constexpr int kAtomBytes = 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the first 1024-byte boundary at or after p: where a 128-byte-swizzled TMA
// tile may start
__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// -- mbarriers ---------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the async proxy (TMA); then sync
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// one arrival that also expects `bytes` of TMA transactions in this phase
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// expects `bytes` of TMA transactions in this phase, without arriving
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// spins until the phase of parity `parity` has completed. A phase that never
// completes (a copy that faulted, a lost arrival) traps after about ten
// seconds: the launch then fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  long long start = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) start = clock64();
    else if (clock64() - start > (1ll << 34)) __trap();
  }
}

// -- TMA ---------------------------------------------------------------------

// Copies the box at coordinates (c0, c1, c2, c3) (innermost first) of `map`
// into shared memory at `dst`; completes `bytes` on `bar`. One thread issues.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// Copies the box at coordinates (c0, c1) (innermost first) of a 2-D `map`
// into shared memory at `dst`; completes its bytes on `bar`. One thread issues.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// -- shared memory to registers ----------------------------------------------

// Four 8 x 8 bf16 matrices, lanes 8 i .. 8 i + 7 giving the addresses of
// matrix i's rows (16 bytes each); r[i] of lane t holds row t / 4, columns
// 2 (t % 4) and + 1 of matrix i. With matrix i = rows 8 (i % 2) .., columns
// 8 (i / 2) .. of a warp's 16 x 16 slice, r is that slice's wgmma A fragment
// (the layout below).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// -- wgmma -------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads across wgmma_wait
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// ordinary shared-memory stores made visible to the async proxy (wgmma, TMA)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle (layout type 1 in bits
// 62-63), start address and byte offsets in 16-byte units.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// K-major operand: `rows` rows of a tile whose columns (the reduction) come
// in 64-wide boxes of `box_bytes`; the k-th 16-column slice.
__device__ __forceinline__ uint64_t desc_k_major(uint32_t tile, int box_bytes, int k) {
  return make_desc(tile + (k >> 2) * box_bytes + (k & 3) * 32, 16, kAtomBytes);
}

// MN-major operand (the B of wgmma_rs, both operands of wgmma_ss_mn): rows are
// the reduction; the k-th 16-row slice, 64-column boxes `box_bytes` apart.
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t tile, int box_bytes, int k) {
  return make_desc(tile + k * 16 * kRowBytes, box_bytes, kAtomBytes);
}

// D[64 x 32] (+)= A[64 x 16] * B[16 x 32]: A and B from shared memory, both
// K-major (tnspB = 0)
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t desc_a, uint64_t desc_b,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D[64 x 64] (+)= A[64 x 16] * B[16 x 64]: A and B from shared memory, both
// K-major (tnspB = 0)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D[64 x 64] (+)= A[64 x 16] * B[16 x 64]: A from registers (a_frag_from_acc), B from
// shared memory MN-major (tnspB = 1)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                           uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// D[64 x 128] (+)= A[64 x 16] * B[16 x 128]: A from registers (a_frag_from_acc), B from
// shared memory MN-major (tnspB = 1)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                           uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// D[64 x 32] (+)= A[64 x 16] * B[16 x 32]: A and B from shared memory, both
// MN-major (tnspA = tnspB = 1): A stored as its transpose, rows = the
// reduction
__device__ __forceinline__ void wgmma_ss_mn_n32(float (&d)[16], uint64_t desc_a, uint64_t desc_b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D[64 x 64] (+)= A[64 x 16] * B[16 x 64]: as wgmma_ss_mn_n32, 64 columns
__device__ __forceinline__ void wgmma_ss_mn_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D (+)= A * B for B N columns wide (N in 32, 64); A and B from shared
// memory, both K-major.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b,
                                         int accumulate) {
  if constexpr (N == 32) wgmma_ss_n32(d, desc_a, desc_b, accumulate);
  else wgmma_ss_n64(d, desc_a, desc_b, accumulate);
}

// D (+)= A * B for B N columns wide (N in 32, 64); A and B from shared
// memory, both MN-major.
template <int N>
__device__ __forceinline__ void wgmma_ss_mn(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b,
                                            int accumulate) {
  if constexpr (N == 32) wgmma_ss_mn_n32(d, desc_a, desc_b, accumulate);
  else wgmma_ss_mn_n64(d, desc_a, desc_b, accumulate);
}

// D (+)= A * B for B N columns wide (N in 64, 128); A from registers, B
// MN-major.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t desc_b, int accumulate) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, desc_b, accumulate);
  else wgmma_rs_n128(d, a, desc_b, accumulate);
}

// -- fragments ---------------------------------------------------------------

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo: the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A operand of the k-th 16-deep step from columns 16 k .. 16 k + 15 of an
// f32 accumulator, rounded to bf16.
template <int R>
__device__ __forceinline__ void a_frag_from_acc(const float (&acc)[R], int k, uint32_t (&a)[4]) {
  a[0] = pack_bf16x2(acc[8 * k + 0], acc[8 * k + 1]);
  a[1] = pack_bf16x2(acc[8 * k + 2], acc[8 * k + 3]);
  a[2] = pack_bf16x2(acc[8 * k + 4], acc[8 * k + 5]);
  a[3] = pack_bf16x2(acc[8 * k + 6], acc[8 * k + 7]);
}

// ex2.approx: 2^x in two ulp, 0 for very negative x
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// -- host: TMA tensor maps ---------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, reached through the runtime so that
// the library needs no -lcuda; null if the driver does not offer it.
static inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A map over a contiguous bf16 tensor [b, s, heads, d] whose box is `rows`
// positions x 64 columns of one head of one batch row (128-byte swizzle;
// reads past s, and past column d, give zeros). Coordinates: (column, head,
// position, batch). Needs a 16-byte aligned base and d a multiple of 8 (TMA's
// row stride is a multiple of 16 bytes); d may be under 64, the box's width.
// Every box copies 64 x `rows` x 2 bytes, its zero-filled part included, and
// counts them all on the mbarrier. Returns cudaSuccess or
// cudaErrorInvalidValue.
static inline cudaError_t encode_bshd_map(CUtensorMap* map, const void* base, int b, int s,
                                          int heads, int d, int rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  if ((reinterpret_cast<uintptr_t>(base) & 15) != 0 || d < 8 || d % 8 != 0 || rows < 1 ||
      rows > 256 || b < 1 || s < 1 || heads < 1)
    return cudaErrorInvalidValue;
  const cuuint64_t esz = sizeof(__nv_bfloat16);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(s), static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {d * esz, static_cast<cuuint64_t>(heads) * d * esz,
                                 static_cast<cuuint64_t>(s) * heads * d * esz};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A map over a row-major bf16 matrix [rows, cols] (cols contiguous) whose
// box is `box_rows` rows x 64 columns (128-byte swizzle; reads past either
// edge give zeros, and count on the mbarrier as the whole box does).
// Coordinates: (column, row). Needs a 16-byte aligned base and cols a
// multiple of 8 (TMA's row stride is a multiple of 16 bytes). Returns
// cudaSuccess or cudaErrorInvalidValue.
static inline cudaError_t encode_2d_map(CUtensorMap* map, const void* base, long rows, long cols,
                                        int box_rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  if ((reinterpret_cast<uintptr_t>(base) & 15) != 0 || cols < 8 || cols % 8 != 0 || rows < 1 ||
      box_rows < 1 || box_rows > 256)
    return cudaErrorInvalidValue;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * sizeof(__nv_bfloat16)};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A map over a contiguous f32 vector [cols] seen as one row, whose box is
// 64 columns (no swizzle; reads past cols give zeros, and count on the
// mbarrier as the whole box does). Coordinates: (column, 0). Needs a
// 16-byte aligned base and cols a multiple of 4. Returns cudaSuccess or
// cudaErrorInvalidValue.
static inline cudaError_t encode_f32_row_map(CUtensorMap* map, const float* base, long cols) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  if ((reinterpret_cast<uintptr_t>(base) & 15) != 0 || cols < 4 || cols % 4 != 0)
    return cudaErrorInvalidValue;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), 1};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * sizeof(float)};
  const cuuint32_t box[2] = {64, 1};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(base), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace sm90
}  // namespace tos
