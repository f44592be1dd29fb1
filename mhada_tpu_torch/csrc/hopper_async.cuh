// The port's Hopper building blocks for warp-specialised kernels: mbarrier
// waits and arrivals, TMA tensor loads completing on an mbarrier, named
// barriers, the wgmma fence / commit / wait, the register-A m64n64k16
// product and the m64nNk16 products with both operands in shared memory,
// the wgmma shared-memory descriptor of a tile in the
// 128-byte swizzle, the host's encoder of tensor maps and the K / V map of
// 64 x 64 boxes, and 1-D bulk copies.  Used by the MHAda tile of K3, K4,
// P2 and K7's forward (mhada_wgmma.cuh), K7's backward
// (mhada_bwd_wgmma.cuh), the bf16 attention tile (attention_wgmma.cuh), P1
// (mm_wgmma.cuh), the bf16 decoder tail of K5 and K8
// (decoder_tail_wgmma.cuh) and K13 (decoder_c6_f32.cuh,
// decoder_c6_mma.cuh).
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <stdint.h>

#include "common.cuh"

namespace mhada {
namespace wg {

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
// Arrive and add `bytes` to the transactions the current phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// Wait until the barrier's phase of parity `parity` has completed (the
// phases complete in turn: 0, 1, 0, ...).
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// mbar_wait that gives up: after about 2^30 polls (seconds) the kernel
// traps, so a phase that never completes (a lost TMA transaction, a wrong
// parity) ends the launch with an error instead of hanging the card.  Its
// poll counter costs a register: P2's producer, held to 32, spills with it.
__device__ __forceinline__ void mbar_wait_or_trap(uint32_t bar, int parity) {
  uint32_t done;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 30)) __trap();
  }
}
// `bytes` contiguous bytes of device memory into shared memory by the TMA
// unit, completing on `bar` (dst and src 16-byte aligned, bytes a multiple
// of 16): the issuing thread does not wait for it.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// One box of a 3-D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}
// One box of a 2-D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most kPending of this warpgroup's wgmma groups are in flight.
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}
// Keep the compiler from moving reads or writes of accumulators across the
// asynchronous products (it sees a wgmma write them when it is issued).
// A register-A product reads its A fragments asynchronously too: their
// definitions must not sink past wgmma.fence (ptxas then serialises the
// products, C7513), nor their registers be reused before the wait.
template <int kRegs>
__device__ __forceinline__ void fence_regs(float (&d)[kRegs]) {
#pragma unroll
  for (int i = 0; i < kRegs; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// fence_regs for a register-A product's A fragments (4 registers a
// k-step).
template <int kSteps>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[kSteps][4]) {
#pragma unroll
  for (int i = 0; i < 4 * kSteps; ++i)
    asm volatile("" : "+r"(a[i / 4][i % 4])::"memory");
}

// 2^x with denormal results flushed to 0 (one MUFU.EX2); 2^-inf = 0.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The accumulator operands of a wgmma, c(d[i]) for d[0 .. 32 / 64 / 128).
#define MHADA_D8(c, i)                                                     \
  c(d[i]), c(d[i + 1]), c(d[i + 2]), c(d[i + 3]), c(d[i + 4]), c(d[i + 5]), \
      c(d[i + 6]), c(d[i + 7])
#define MHADA_D32(c, i) \
  MHADA_D8(c, i), MHADA_D8(c, i + 8), MHADA_D8(c, i + 16), MHADA_D8(c, i + 24)
#define MHADA_D64(c, i) MHADA_D32(c, i), MHADA_D32(c, i + 32)
#define MHADA_D128(c, i) MHADA_D64(c, i), MHADA_D64(c, i + 64)
// Their placeholders.
#define MHADA_P16 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, " \
  "%10, %11, %12, %13, %14, %15"
#define MHADA_P32 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, " \
  "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31"
#define MHADA_P64 \
  MHADA_P32 ", " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, " \
  "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, " \
  "%52, %53, %54, %55, %56, %57, %58, %59, %60, %61, " \
  "%62, %63"
#define MHADA_P128 \
  MHADA_P64 ", " \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, " \
  "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, " \
  "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, " \
  "%94, %95, %96, %97, %98, %99, %100, %101, %102, %103, " \
  "%104, %105, %106, %107, %108, %109, %110, %111, %112, %113, " \
  "%114, %115, %116, %117, %118, %119, %120, %121, %122, %123, " \
  "%124, %125, %126, %127"

// d (+)= a b: wgmma.m64nNk16 with N = 32, 64, 128 or 256 by the size of d
// (16, 32, 64 or 128 accumulators a thread), both bf16 operands from shared
// memory by descriptor, A K-major; kTransB: B is MN-major (the transpose
// bit); float32 sums.  kFirst: d is written only, its old values no input
// (scale-d 0), so that nothing that defined them can serialise the
// products.  The operands `da`, `db`, the scale flag and kTransB follow
// the accumulators.
#define MHADA_WGMMA_SS(n, plist, da, db, scale, trans)                  \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %" scale ", 0;\n"                   \
  "wgmma.mma_async.sync.aligned.m64n" n "k16.f32.bf16.bf16 {" plist     \
  "}, %" da ", %" db ", p, 1, 1, 0, %" trans ";\n}\n"
template <bool kFirst, int kTransB>
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da,
                                         uint64_t db) {
  if constexpr (kFirst)
    asm volatile(MHADA_WGMMA_SS("32", MHADA_P16, "16", "17", "18", "19")
                 : MHADA_D8("=f", 0), MHADA_D8("=f", 8)
                 : "l"(da), "l"(db), "n"(0), "n"(kTransB));
  else
    asm volatile(MHADA_WGMMA_SS("32", MHADA_P16, "16", "17", "18", "19")
                 : MHADA_D8("+f", 0), MHADA_D8("+f", 8)
                 : "l"(da), "l"(db), "n"(1), "n"(kTransB));
}
template <bool kFirst, int kTransB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db) {
  if constexpr (kFirst)
    asm volatile(MHADA_WGMMA_SS("64", MHADA_P32, "32", "33", "34", "35")
                 : MHADA_D32("=f", 0)
                 : "l"(da), "l"(db), "n"(0), "n"(kTransB));
  else
    asm volatile(MHADA_WGMMA_SS("64", MHADA_P32, "32", "33", "34", "35")
                 : MHADA_D32("+f", 0)
                 : "l"(da), "l"(db), "n"(1), "n"(kTransB));
}
template <bool kFirst, int kTransB>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db) {
  if constexpr (kFirst)
    asm volatile(MHADA_WGMMA_SS("128", MHADA_P64, "64", "65", "66", "67")
                 : MHADA_D64("=f", 0)
                 : "l"(da), "l"(db), "n"(0), "n"(kTransB));
  else
    asm volatile(MHADA_WGMMA_SS("128", MHADA_P64, "64", "65", "66", "67")
                 : MHADA_D64("+f", 0)
                 : "l"(da), "l"(db), "n"(1), "n"(kTransB));
}
template <bool kFirst, int kTransB>
__device__ __forceinline__ void wgmma_ss(float (&d)[128], uint64_t da,
                                         uint64_t db) {
  if constexpr (kFirst)
    asm volatile(MHADA_WGMMA_SS("256", MHADA_P128, "128", "129", "130",
                                "131")
                 : MHADA_D128("=f", 0)
                 : "l"(da), "l"(db), "n"(0), "n"(kTransB));
  else
    asm volatile(MHADA_WGMMA_SS("256", MHADA_P128, "128", "129", "130",
                                "131")
                 : MHADA_D128("+f", 0)
                 : "l"(da), "l"(db), "n"(1), "n"(kTransB));
}

// d[0..31] (+)= a b: m64n64k16, A (bf16) from registers in the
// m16n8k16 A layout of each warp's 16 rows, B from shared memory by
// descriptor; kTransB: B is MN-major.  scale_d = 0 overwrites d.
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32],
                                          const uint32_t (&a)[4],
                                          uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d),
        "n"(kTransB));
}

// d[0..31] = a b: m64n64k16 as above, d written only: its old values are
// no input, so nothing that defined them can serialise the products.
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n64k16_rs_first(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]),
        "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]),
        "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]),
        "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]),
        "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]),
        "=f"(d[30]), "=f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(0),
        "n"(kTransB));
}

// A wgmma shared-memory descriptor of a tile in the 128-byte swizzle (the
// layout TMA writes with CU_TENSOR_MAP_SWIZZLE_128B; tiles 1024-byte
// aligned, so the base offset is 0), at byte address `addr`.  K-major B:
// sbo steps 8 rows of 128 bytes, lbo is unused.  MN-major B: sbo steps 8
// rows of k, lbo steps 64 columns of n (PTX ISA, "Matrix Descriptor").
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// cuTensorMapEncodeTiled through the runtime's driver entry point: the
// library links no -lcuda.
inline PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// One 64 x 64 bf16 box a key tile of (B, M, C) K or V with rows of `rs`
// elements (rs >= C, a multiple of 8; batches M rows apart): a 3-D tensor
// map (C, M, B) in the 128-byte swizzle (a 64-wide bf16 row is 128 bytes),
// so that a box past M is zero-filled inside its own batch (a 2-D (B M, C)
// view would read the next batch's keys).
inline bool kv_tensor_map(CUtensorMap* map, const void* ptr, int batch, int m,
                          int c, long long rs) {
  const auto encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(c),
                              static_cast<cuuint64_t>(m),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(rs) * 2,
                                 static_cast<cuuint64_t>(m) * rs * 2};
  const cuuint32_t box[3] = {64, 64, 1}, elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace wg
}  // namespace mhada
