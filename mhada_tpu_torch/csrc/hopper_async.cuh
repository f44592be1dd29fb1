// The port's Hopper building blocks for warp-specialised kernels: mbarrier
// waits and arrivals, TMA tensor loads completing on an mbarrier, named
// barriers, the wgmma fence / commit / wait, the wgmma shared-memory
// descriptor of a tile in the 128-byte swizzle, the host's encoder of
// tensor maps, and 1-D bulk copies.  Used by P2 (mhada_wgmma.cuh), P1
// (mm_wgmma.cuh) and K13 (decoder_c6_f32.cuh, decoder_c6_mma.cuh).
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

}  // namespace wg
}  // namespace mhada
