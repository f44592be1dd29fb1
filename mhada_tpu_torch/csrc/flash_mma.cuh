// Warp-level building blocks of the tensor-core kernels
// (decoder_*_mma.cuh, ln_matmul_mma.cuh, and the pieces the wgmma kernels
// take from them): the alignment check of their entry points, the bf16
// m16n8k16 product with float32 accumulators,
// ldmatrix (plain and transposed), 16-byte cp.async copies with zero fill,
// the quad reductions over an accumulator fragment, and the conversion of a
// float32 accumulator fragment into a bf16 A-operand fragment in registers,
// and the bf16 square of a packed operand pair (MHAda's V^2).
//
// Fragment layouts of mma.sync.m16n8k16 (PTX ISA, "Matrix Fragments for
// mma.m16n8k16"), with g = lane / 4 and t = lane % 4:
//   A (16 x 16, row-major) a[0..3], each two bf16 at columns c, c+1:
//     (g, 2t), (g+8, 2t), (g, 2t+8), (g+8, 2t+8);
//   B (16 x 8, column-major) b[0..1]: rows 2t, 2t+1 (b[0]) and 2t+8, 2t+9
//     (b[1]) of column g;
//   C / D (16 x 8) c[0..3]: (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1).
// So the accumulators of two neighbouring n-tiles (16 columns) hold exactly
// the A fragment of a 16 x 16 k-step once packed to bf16 pairs
// (FlashAttention-2: P never leaves the registers).
//
// Shared tiles hold 64 rows of 64 bf16 channels with rows padded to
// kMmaStride = 72 elements (144 bytes): the eight 16-byte row reads of one
// ldmatrix phase then fall on eight distinct groups of four banks.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include <initializer_list>

namespace mhada {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// True when every pointer is 16-byte aligned and channels is a multiple of
// 8, as the 16-byte copies of the rows of the bf16 kernels need.
inline bool mma_aligned(std::initializer_list<const void*> ptrs,
                        int channels) {
  uintptr_t any = 0;
  for (const void* p : ptrs) any |= reinterpret_cast<uintptr_t>(p);
  return any % 16 == 0 && channels % 8 == 0;
}

namespace mma {

constexpr int kMmaStride = 72;   // bf16 elements per shared row (144 bytes)
constexpr int kMmaTileElems = 64 * kMmaStride;
constexpr int kMmaTileBytes = kMmaTileElems * 2;   // 9216

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// d += a b: one m16n8k16 product, bf16 operands, float32 accumulators.
__device__ __forceinline__ void mma_16816(float (&d)[4],
                                          const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 bf16 matrices; lanes 8i..8i+7 give the row addresses of
// matrix i, and r[i] receives matrix i in the A / B fragment layout.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// The same with each matrix transposed: from a row-major (k, n) tile this
// gives the column-major B fragment.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// 16 bytes global -> shared, bypassing L1; valid = false writes 16 zero
// bytes and reads nothing (the src-size operand is 0), so ragged rows need
// no branch around the copy.
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes global -> shared (row statistics), zero when !valid.
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most `kPending` of this thread's groups are in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Round two floats to bf16 and pack them, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The two bf16 of a packed pair (lo in the low half) as float32.
__device__ __forceinline__ float2 unpack_bf16(uint32_t x) {
  return make_float2(__uint_as_float(x << 16),
                     __uint_as_float(x & 0xffff0000u));
}

// Both bf16 of a packed pair squared with one rounding to bf16 (the exact
// product, then round to nearest even): what jnp.square gives on a bf16
// array.  The -0 addend leaves x * x unchanged.
__device__ __forceinline__ uint32_t square_bf16x2(uint32_t x) {
  uint32_t y;
  asm("fma.rn.bf16x2 %0, %1, %1, %2;\n" : "=r"(y) : "r"(x), "r"(0x80008000u));
  return y;
}

// Max and sum over the four lanes of a quad (the lanes that share a
// fragment row).
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Accumulators of n-tiles 2k and 2k+1 (16 x 16, float32) -> the A
// fragment of k-step k, rounded to bf16.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                         const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// Lane addresses of ldmatrix_x4 on a padded tile, for the 16 x 16 block
// at (row0, col0):
//   a_addr:  the A fragment of rows row0..+15, columns (k) col0..+15 (rows
//            `stride` elements apart, kMmaStride unless given);
//   b_addr:  B fragments from an n-major tile (rows are n, columns k): n
//            rows row0..+7 -> r[0], r[1]; row0+8..+15 -> r[2], r[3];
//   bt_addr: B fragments from a k-major tile (rows are k, columns n),
//            through ldmatrix_x4_trans: n columns col0..+7 -> r[0], r[1];
//            col0+8..+15 -> r[2], r[3].
__device__ __forceinline__ uint32_t a_addr(const __nv_bfloat16* tile,
                                           int row0, int col0,
                                           int stride = kMmaStride) {
  const int l = threadIdx.x % 32;
  return smem_addr(tile + (row0 + (l % 16)) * stride + col0 + (l / 16) * 8);
}
__device__ __forceinline__ uint32_t b_addr(const __nv_bfloat16* tile,
                                           int row0, int col0) {
  const int l = threadIdx.x % 32;
  return smem_addr(tile + (row0 + (l % 8) + (l / 16) * 8) * kMmaStride +
                   col0 + ((l / 8) % 2) * 8);
}
__device__ __forceinline__ uint32_t bt_addr(const __nv_bfloat16* tile,
                                            int row0, int col0) {
  const int l = threadIdx.x % 32;
  return smem_addr(tile + (row0 + (l % 8) + ((l / 8) % 2) * 8) * kMmaStride +
                   col0 + (l / 16) * 8);
}

}  // namespace mma
}  // namespace mhada
