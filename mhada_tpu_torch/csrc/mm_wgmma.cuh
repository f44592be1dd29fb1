// P1 on Hopper's asynchronous units: a bf16 GEMM repeated in one launch,
// warp-specialised, TMA loads into an mbarrier ring, wgmma from shared
// memory.
//
// Counterpart of scripts/mxu_probe.py::_mm_kernel (pallas_call at
// mxu_probe.py:42): out = round_bf16(a b), a (m, k) and b (k, n) bf16 and
// row-major, summed in float32, computed `reps` times into the same output
// (the grid's third dimension), so that after the first rep the operands
// come from L2 and the launch measures the tensor cores' rate at the
// probe's shapes.  probes/mm_probe.py::mm_plain is the plain version.
//
// Bound: 2 m k n reps flops at the bf16 tensor-core rate (989 TFLOP/s;
// 0.109 ms for 100 products of 512 x 2048 x 512) against the operands read
// once and the output written once: operations.
//
// Design (the card's GEMM, as P2 built it for the MHAda tile):
// - A block owns BM x BN outputs of one rep (BM = 64 or 128, BN = 64, 128
//   or 256; probes/mm_probe.py::tile picks one per shape) and walks k in
//   steps of kBK = 64 bf16, one 128-byte swizzle row.
// - Producer (the last warpgroup, registers lowered by setmaxnreg.dec):
//   one thread issues the TMA loads of each step, a BM x 64 box of a (the
//   2-D tensor map (k, m)) and BN / 64 boxes of 64 x 64 of b (the map (n,
//   k)), all in the 128-byte swizzle, into a ring of kStages stages whose
//   full barrier counts the transaction bytes; it refills a stage once
//   every consumer warp has released it (the empty barrier).
// - Consumers (BM / 64 warpgroups, registers raised by setmaxnreg.inc):
//   warpgroup w owns rows 64 w .. + 63 and all BN columns, BN / 2 float32
//   accumulators a thread.  Per step, four wgmma.m64nBNk16 with both
//   operands from shared memory: A K-major (the descriptor steps 32 bytes
//   a k16), B N-major, the transpose bit set (the descriptor steps 16 rows
//   of 128 bytes; its leading offset is the 8 KB between 64-column
//   boxes).  The step's products are committed as one group; after the
//   next step's group is issued, wait_group 1 retires this one and the
//   stage is released, so two steps' products are in flight.  The first
//   product writes the accumulators without reading them, and nothing
//   but the products writes them until the last wait (ptxas would
//   otherwise serialise the products: C7513).
// - Epilogue: each accumulator pair is rounded to bf16 in registers and
//   stored straight to the output.  A pair of lanes swaps one word per
//   two 8-column chunks so that a lane holds 4 consecutive columns: a
//   quad stores 32 contiguous bytes of a row (a whole sector) with 8-byte
//   stores, and C never passes through shared memory.
// - One block an SM with two consumers (168 registers at launch, 232 a
//   consumer thread, 40 the producer's); two where one consumer and the
//   ring allow it, or where two consumers' BN / 2 accumulators fit 96
//   registers (BM x BN = 128 x 64).
//
// On an H100 (700 W), 100 products of 512 x 2048 x 512 take 0.166 ms at
// 128 x 256, 65 % of the bound: 800 blocks of one an SM are 6.06 waves,
// run as 7.  The k = 64 shapes reach 13 %: each product stores its 2 MB
// output (chip_smoke.py's P1 gates; mm_probe --sweep for every tile).
//
// m, n and k are multiples of BM, BN and 64; the pointers 16-byte aligned.
#pragma once

#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "flash_mma.cuh"  // mma::smem_addr, pack_bf16
#include "hopper_async.cuh"

namespace mhada {
namespace mmwg {

using bf16 = __nv_bfloat16;
using namespace wg;

constexpr int kBK = 64;                    // k a stage: 128 bytes of bf16
constexpr int kBoxBytes = 64 * kBK * 2;    // a 64 x 64 box of b
constexpr int kStages = 4;
constexpr int kProducerRegs = 40;
constexpr int kSmemPerSm = 228 * 1024;

// Registers a thread at launch for `blocks` blocks of `consumers` + 1
// warpgroups an SM, and what a consumer thread may then raise its count to.
constexpr int launch_regs(int consumers, int blocks) {
  const int r = 65536 / (blocks * 128 * (consumers + 1));
  return (r < 255 ? r : 255) / 8 * 8;
}
constexpr int consumer_regs(int consumers, int blocks) {
  const int r = ((consumers + 1) * launch_regs(consumers, blocks) -
                 kProducerRegs) / consumers / 8 * 8;
  return r < 240 ? r : 240;
}

template <int BM, int BN>
struct MmCfg {
  static constexpr int kConsumers = BM / 64;
  static constexpr int kThreads = 128 * (kConsumers + 1);
  static constexpr int kABytes = BM * kBK * 2;
  static constexpr int kBBytes = BN * kBK * 2;
  static constexpr int kStageBytes = kABytes + kBBytes;
  // the ring, its barriers, the alignment
  static constexpr size_t kSmem = kStages * kStageBytes + 2 * kStages * 8 +
                                  1024;
  // Two blocks an SM where their rings fit (with 1 KB reserved a block)
  // and a consumer keeps its accumulators and 56 registers more.
  static constexpr int kBlocks =
      2 * (kSmem + 1024) <= kSmemPerSm &&
              consumer_regs(kConsumers, 2) >= BN / 2 + 56
          ? 2
          : 1;
  static constexpr int kConsumerRegs = consumer_regs(kConsumers, kBlocks);
  static_assert(kConsumers * kConsumerRegs + kProducerRegs <=
                    (kConsumers + 1) * launch_regs(kConsumers, kBlocks),
                "setmaxnreg must stay within the block's allocation");
  static_assert(kConsumerRegs >= BN / 2 + 56, "the accumulators must fit");
};

// out (m, n) = a (m, k) b (k, n) for the block's BM x BN tile; grid (n /
// BN, m / BM, reps).
template <int BM, int BN>
__global__ void __launch_bounds__(MmCfg<BM, BN>::kThreads,
                                  MmCfg<BM, BN>::kBlocks)
    mm_wgmma_kernel(const __grid_constant__ CUtensorMap amap,
                    const __grid_constant__ CUtensorMap bmap,
                    bf16* __restrict__ out, int k, int n) {
  using Cfg = MmCfg<BM, BN>;
  extern __shared__ unsigned char smem_raw[];
  // The 128-byte swizzle repeats every 1024 bytes: align the base to it.
  unsigned char* smem =
      smem_raw + (1024 - mma::smem_addr(smem_raw) % 1024) % 1024;
  const uint32_t base = mma::smem_addr(smem);
  const uint32_t bars = base + kStages * Cfg::kStageBytes;
  // full: the stage's bytes landed (TMA); empty: every consumer warp
  // released it.
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };
  auto stage = [&](int s) { return base + s * Cfg::kStageBytes; };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int group = warp / 4;   // a consumer below kConsumers, or the producer
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int steps = k / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * Cfg::kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (group == Cfg::kConsumers) {
    // ---- producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 128 * Cfg::kConsumers) {
      for (int j = 0; j < steps; ++j) {
        const int s = j % kStages;
        // stage s is free once every consumer released step j - kStages
        if (j >= kStages)
          mbar_wait_or_trap(empty(s), ((j / kStages) & 1) ^ 1);
        mbar_expect_tx(full(s), Cfg::kStageBytes);
        tma_load_2d(stage(s), &amap, full(s), j * kBK, m0);
#pragma unroll
        for (int c = 0; c < BN / 64; ++c)
          tma_load_2d(stage(s) + Cfg::kABytes + c * kBoxBytes, &bmap, full(s),
                      n0 + 64 * c, j * kBK);
      }
    }
  } else {
    // ---- consumer `group`: rows 64 group .. + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        Cfg::kConsumerRegs));
    float acc[BN / 2];
    // The step's four k16 products on stage s; the first of the first step
    // writes acc without reading it.
    auto issue = [&](auto first, int s) {
      const uint32_t at = stage(s) + group * 64 * kBK * 2;
      const uint32_t bt = stage(s) + Cfg::kABytes;
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint64_t da = sw128_desc(at + 32 * kk, 16, 1024);
        const uint64_t db = sw128_desc(bt + 2048 * kk, kBoxBytes, 1024);
        if (decltype(first)::value && kk == 0)
          wgmma_ss<true, 1>(acc, da, db);
        else
          wgmma_ss<false, 1>(acc, da, db);
      }
    };
    auto release = [&](int s) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));
    };
    mbar_wait_or_trap(full(0), 0);
    wgmma_fence();
    issue(std::true_type{}, 0);
    wgmma_commit();
    for (int j = 1; j < steps; ++j) {
      const int s = j % kStages;
      mbar_wait_or_trap(full(s), (j / kStages) & 1);
      wgmma_fence();
      issue(std::false_type{}, s);
      wgmma_commit();
      wgmma_wait<1>();   // step j - 1's products are done
      release((j - 1) % kStages);
    }
    wgmma_wait<0>();
    fence_regs(acc);

    // Element e of n8 chunk c is acc[4 c + e]: row 16 (warp % 4) + lane / 4
    // + 8 (e / 2) of the warpgroup's 64, column 8 c + 2 (lane % 4) + e % 2.
    // Per row half r and chunk pair (c, c + 1): an even lane keeps chunk
    // c's pair and takes its odd neighbour's (columns 8 c + 2 t .. + 3), an
    // odd lane keeps chunk c + 1's and takes its even neighbour's.
    const int t = lane % 4;
    const bool odd = t & 1;
    bf16* orow = out + static_cast<long long>(m0 + 64 * group +
                                              16 * (warp % 4) + lane / 4) *
                           n +
                 n0;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int c = 0; c < BN / 8; c += 2) {
        const uint32_t lo = mma::pack_bf16(acc[4 * c + 2 * r],
                                           acc[4 * c + 2 * r + 1]);
        const uint32_t hi = mma::pack_bf16(acc[4 * c + 4 + 2 * r],
                                           acc[4 * c + 5 + 2 * r]);
        const uint32_t got = __shfl_xor_sync(0xffffffffu, odd ? lo : hi, 1);
        const int col = odd ? 8 * c + 8 + 2 * (t - 1) : 8 * c + 2 * t;
        *reinterpret_cast<uint2*>(orow + 8 * r * static_cast<long long>(n) +
                                  col) =
            odd ? make_uint2(got, hi) : make_uint2(lo, got);
      }
    }
  }
}

// a b as above on `stream`: 2-D tensor maps of a (k, m) in BM x 64 boxes
// and of b (n, k) in 64 x 64 boxes, both in the 128-byte swizzle.
template <int BM, int BN>
cudaError_t launch_mm_wgmma(const bf16* a, const bf16* b, bf16* out, int m,
                            int k, int n, int reps, cudaStream_t stream) {
  using Cfg = MmCfg<BM, BN>;
  const auto encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorInvalidValue;
  auto map = [&](CUtensorMap* tm, const bf16* p, int inner, int outer,
                 int box_outer) {
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner),
                                static_cast<cuuint64_t>(outer)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(inner) * 2};
    const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_outer)};
    const cuuint32_t elem[2] = {1, 1};
    return encode(tm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                  const_cast<bf16*>(p), dims, strides, box, elem,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
  };
  CUtensorMap amap, bmap;
  if (!map(&amap, a, k, m, BM) || !map(&bmap, b, n, k, kBK))
    return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      mm_wgmma_kernel<BM, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Cfg::kSmem));
  if (err != cudaSuccess) return err;
  const dim3 grid(n / BN, m / BM, reps);
  mm_wgmma_kernel<BM, BN>
      <<<grid, Cfg::kThreads, Cfg::kSmem, stream>>>(amap, bmap, out, k, n);
  return cudaGetLastError();
}

}  // namespace mmwg
}  // namespace mhada
