// The bf16 K2 on Hopper's asynchronous units: out = round(LN(x) W^T + b),
// a warp-specialised wgmma + TMA GEMM whose A tile is the LayerNorm,
// written once into shared memory in the layout the products read.
//
// Replaces, at bf16, mhada_tpu/ops/ln_matmul_pallas.py::_ln_matmul_pallas
// (_ln_matmul_kernel, pallas_call at ln_matmul_pallas.py:44) with its
// numerics: the row statistics in float32, two-pass (the mean, then the
// mean of (x - mean)^2, then rsqrt(var + eps)); the affine in float32; h
// rounded once to bf16 before the product (ln_matmul_pallas.py:30); the
// product accumulated in float32; the bf16 bias widened and added in
// float32; one rounding of the sum to bf16.  The LN is not folded into the
// epilogue algebraically: that would drop the rounding of h and cancel
// when |mean| is large.
//
// Bound: 2 N E F flops (6.4 + 8.6 GFLOP for the 1536- and 2048-wide calls
// at N = 4096, E = 512) against N (E + F) + E F bf16 of traffic:
// operations, at the bf16 tensor-core rate.
//
// Design.  A block of kConsumers + 1 warpgroups owns kBM = 128 rows (64 a
// consumer) and a group of `tiles_per_block` output column tiles of kBN;
// ops/ln_matmul.py::launch_plan picks the group so that the grid fills the
// SMs once (N = 4096: 3 or 4 tiles a block; N >= 16384: every column tile
// of a row tile in one block), and one LN serves every tile of the group.
// - Loads: before the roles split, one thread of the producer warpgroup
//   asks TMA for the block's x rows, each consumer's 64 rows as E_k / 64
//   boxes of 64 x 64 (E_k: E rounded up to 64) into the h tile itself, in
//   the 128-byte swizzle, zero past the last row and past E, and for the
//   ring's first round of W boxes of kBN x 64 (the map (E, F), 128-byte
//   swizzle, zero past E and F), which land while the statistics run.
//   W (F, E) is nn.Linear's (out, in): each output column's k run is
//   contiguous, so the box is B K-major, as K is for S = Q K^T in
//   attention_wgmma.cuh, and no transpose bit is needed.
// - Producer (the last warpgroup, registers lowered by setmaxnreg.dec):
//   the same thread then refills each stage once every consumer warp has
//   released it, column tile after column tile.
// - Consumers (registers raised by setmaxnreg.inc): once its x rows have
//   landed, each consumer normalises its 64 rows in place, a warp a row
//   (two at a time): a lane reads its 16-byte chunks of the row into
//   float32 registers, takes both passes of the statistics there (x -
//   mean kept for the affine) and writes h, rounded once, over them.
//   Chunk c of row r sits at c ^ (r % 8) of the row's 128-byte line in its
//   box (the swizzle TMA wrote and the wgmma descriptor reads), so a
//   quarter warp touches one whole line: no bank conflicts.  Columns past
//   E keep TMA's zeros; rows past the end hold zeros and become the
//   affine's bias, finite and never stored.  fence.proxy.async.shared::cta
//   then makes the generic stores visible to the products' async proxy,
//   and the warpgroup syncs.  The normalised tensor never reaches device
//   memory: the point of the TPU kernel (ln_matmul_pallas.py:1-13).
// - Main loop: per 64-wide k step of a column tile, four wgmma.m64nBNk16
//   with both operands from shared memory (A the consumer's rows of h box
//   k, B the ring stage, both K-major: the descriptor steps 32 bytes a
//   k16), committed as one group; after the next step's group is issued,
//   wait_group 1 retires this one and the stage is released, so two
//   steps' products are in flight.  A consumer thread holds kBN / 2
//   float32 accumulators; each tile's first product writes them without
//   reading them, and nothing but the products writes them (ptxas would
//   otherwise serialise the products: C7513).
// - Epilogue, after each column tile's last step (wait_group 0): the
//   tile's bias, its loads issued together, added in float32, each pair
//   rounded once, and P1's lane-pair swap (mm_wgmma.cuh) so that a lane
//   holds 4 consecutive columns: 8-byte stores (the output's rows are a
//   multiple of 4 apart: ops/ln_matmul.py pads them where F is not),
//   nothing past the last row or F.  The producer meanwhile refills the
//   ring with the next tile's first steps.  (Loading the bias before the
//   tile's products or a pair at a time, and staging the tile for a TMA
//   store at the cost of two ring stages, each measured slower on an
//   H100.)
//
// Shared memory: h (kBM x E_k bf16: 128 KB at E = 512, 160 KB at E = 640),
// the ring (16 KB a stage), the barriers; launch_plan takes as many stages
// (at most 8) as fit 227 KB: 6 at E = 512, 4 at E = 640.  One block an SM
// (the shared memory), 168 registers a thread at launch, 232 a consumer.
// Requires E % 8 == 0, E <= kMaxE and 16-byte-aligned x and W (TMA).
#pragma once

#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "flash_mma.cuh"   // mma::smem_addr, pack_bf16, unpack_bf16
#include "hopper_async.cuh"
#include "mm_wgmma.cuh"    // mmwg::launch_regs, consumer_regs

namespace mhada {
namespace lnwg {

using bf16 = __nv_bfloat16;
using namespace wg;

constexpr int kBM = 128;                // rows of a block
constexpr int kBN = 128;                // output columns of a tile
constexpr int kBK = 64;                 // k a step: one 128-byte swizzle row
constexpr int kBlocksPerSm = 1;
constexpr int kConsumers = kBM / 64;
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kProducer = 128 * kConsumers;    // the thread issuing TMA
constexpr int kMaxE = 640;
constexpr int kMaxStages = 8;
constexpr int kSmemPerSm = 228 * 1024;
constexpr int kLineBytes = kBK * 2;             // a row of a box
constexpr int kBoxBytes = kBM * kLineBytes;     // an h box: kBM x 64
constexpr int kStageBytes = kBN * kLineBytes;   // a W box: kBN x 64
// 16-byte chunks of a row a lane holds in the LN (kMaxE / 8 / 32, up)
constexpr int kRowChunks = (kMaxE / 8 + 31) / 32;
constexpr int kRowsAtOnce = 2;   // rows a warp normalises together
constexpr int kProducerRegs = mmwg::kProducerRegs;
constexpr int kConsumerRegs = mmwg::consumer_regs(kConsumers, kBlocksPerSm);
static_assert(kConsumers * kConsumerRegs + kProducerRegs <=
                  (kConsumers + 1) *
                      mmwg::launch_regs(kConsumers, kBlocksPerSm),
              "setmaxnreg must stay within the block's allocation");
static_assert(kConsumerRegs >= kBN / 2 + 56, "the accumulators must fit");

__host__ __device__ constexpr int k_boxes(int e) {
  return (e + kBK - 1) / kBK;
}
// The 1024-byte alignment slack, h, the ring, the full and empty barriers
// of each stage and one x barrier a consumer (ops/ln_matmul.py::smem_bytes).
__host__ __device__ constexpr size_t smem_bytes(int e, int stages) {
  return 1024 + static_cast<size_t>(k_boxes(e)) * kBoxBytes +
         static_cast<size_t>(stages) * kStageBytes +
         8 * (2 * stages + kConsumers);
}

struct LnWgArgs {
  const bf16* ln_w;   // (e,)
  const bf16* ln_b;   // (e,)
  const bf16* bias;   // (f,)
  bf16* out;          // (rows, f), rows ldo elements apart
  int ldo;            // a multiple of 4: 8-byte stores stay aligned
  int rows, e, f;
  float eps;
  int tiles_per_block;   // column tiles of kBN a block runs
  int stages;            // W boxes in the ring
};

// The LN in place on rows row0 .. row0 + nrows - 1 of the block's x, which
// TMA has landed in the h boxes at `hs`: warp `warp` of `warps` turns rows
// row0 + warp, + warps, ... into h, kRowsAtOnce rows at a time
// (independent shuffle chains); lane l reads, and overwrites, chunks l, l
// + 32, ... of a row.
__device__ __forceinline__ void ln_rows(unsigned char* hs, const LnWgArgs& a,
                                        int row0, int nrows, int warp,
                                        int warps) {
  const int lane = threadIdx.x % 32;
  const int ce = a.e / 8;   // 16-byte chunks of a row
  const float inv_e = 1.f / a.e;
  // chunk c of row r: box c / 8, line r, slot (c % 8) ^ (r % 8)
  auto chunk = [&](int r, int c) {
    return reinterpret_cast<uint4*>(hs + (c / 8) * kBoxBytes +
                                    r * kLineBytes +
                                    (((c % 8) ^ (r % 8)) << 4));
  };
  // this lane's columns of the LN affine, widened (2-byte reads: the
  // affine need not be aligned)
  float gw[kRowChunks][8], gb[kRowChunks][8];
#pragma unroll
  for (int j = 0; j < kRowChunks; ++j) {
    const int c = lane + 32 * j;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      gw[j][i] = c < ce ? __bfloat162float(a.ln_w[8 * c + i]) : 0.f;
      gb[j][i] = c < ce ? __bfloat162float(a.ln_b[8 * c + i]) : 0.f;
    }
  }
  for (int r = row0 + warp; r < row0 + nrows; r += warps * kRowsAtOnce) {
    // x, then x - mean, of kRowsAtOnce rows
    float xf[kRowsAtOnce][kRowChunks][8];
    float sum[kRowsAtOnce], sq[kRowsAtOnce];
#pragma unroll
    for (int q = 0; q < kRowsAtOnce; ++q) {
      sum[q] = 0.f;
#pragma unroll
      for (int j = 0; j < kRowChunks; ++j) {
        const int c = lane + 32 * j;
        const uint4 v = c < ce ? *chunk(r + q * warps, c)
                               : make_uint4(0, 0, 0, 0);
        const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 p = mma::unpack_bf16(u[i]);
          xf[q][j][2 * i] = p.x;
          xf[q][j][2 * i + 1] = p.y;
          sum[q] += p.x + p.y;
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int q = 0; q < kRowsAtOnce; ++q)
        sum[q] += __shfl_xor_sync(0xffffffffu, sum[q], off);
#pragma unroll
    for (int q = 0; q < kRowsAtOnce; ++q) {
      const float mean = sum[q] * inv_e;
      sq[q] = 0.f;
#pragma unroll
      for (int j = 0; j < kRowChunks; ++j) {
        const bool in = lane + 32 * j < ce;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          xf[q][j][i] -= mean;
          if (in) sq[q] += xf[q][j][i] * xf[q][j][i];
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int q = 0; q < kRowsAtOnce; ++q)
        sq[q] += __shfl_xor_sync(0xffffffffu, sq[q], off);
#pragma unroll
    for (int q = 0; q < kRowsAtOnce; ++q) {
      const float rstd = rsqrtf(sq[q] * inv_e + a.eps);
#pragma unroll
      for (int j = 0; j < kRowChunks; ++j) {
        const int c = lane + 32 * j;
        if (c >= ce) continue;
        uint32_t u[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          u[i] = mma::pack_bf16(
              xf[q][j][2 * i] * rstd * gw[j][2 * i] + gb[j][2 * i],
              xf[q][j][2 * i + 1] * rstd * gw[j][2 * i + 1] +
                  gb[j][2 * i + 1]);
        *chunk(r + q * warps, c) = make_uint4(u[0], u[1], u[2], u[3]);
      }
    }
  }
}

// Rows blockIdx.y * kBM .. + kBM - 1 against column tiles t0 .. t0 +
// tiles_per_block - 1 (fewer in the last group), t0 = blockIdx.x *
// tiles_per_block.  xmap: x (rows, E) in boxes of 64 x 64; wmap: W (F, E)
// in boxes of kBN x 64; both in the 128-byte swizzle.
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    ln_matmul_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                           const __grid_constant__ CUtensorMap wmap,
                           const LnWgArgs a) {
  extern __shared__ unsigned char smem_raw[];
  // The 128-byte swizzle repeats every 1024 bytes: align the base to it.
  unsigned char* smem =
      smem_raw + (1024 - mma::smem_addr(smem_raw) % 1024) % 1024;
  const uint32_t base = mma::smem_addr(smem);
  const int nkb = k_boxes(a.e), stages = a.stages;
  const uint32_t ring = base + nkb * kBoxBytes;
  const uint32_t bars = ring + stages * kStageBytes;
  // full: the stage's W landed (TMA bytes); empty: every consumer warp
  // released it; xbar(g): consumer g's x rows landed.
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (stages + s); };
  auto xbar = [&](int g) { return bars + 8 * (2 * stages + g); };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int role = warp / 4;   // a consumer below kConsumers, or the producer
  const int r0 = blockIdx.y * kBM;
  const int t0 = blockIdx.x * a.tiles_per_block;
  const int ntiles = min(a.tiles_per_block, (a.f + kBN - 1) / kBN - t0);
  const int nq = ntiles * nkb;   // W steps: nkb a column tile
  // W step q (step q % nkb of column tile q / nkb) into its stage
  auto load_w = [&](int q) {
    const int s = q % stages;
    mbar_expect_tx(full(s), kStageBytes);
    tma_load_2d(ring + s * kStageBytes, &wmap, full(s), q % nkb * kBK,
                (t0 + q / nkb) * kBN);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * kConsumers);
    }
    for (int g = 0; g < kConsumers; ++g) mbar_init(xbar(g), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == kProducer) {
    // x first, consumer g's 64 rows into h box by box, then the ring's
    // first round, which lands while the statistics run
    for (int g = 0; g < kConsumers; ++g) {
      mbar_expect_tx(xbar(g), nkb * 64 * kLineBytes);
      for (int b = 0; b < nkb; ++b)
        tma_load_2d(base + b * kBoxBytes + g * 64 * kLineBytes, &xmap,
                    xbar(g), b * kBK, r0 + 64 * g);
    }
    for (int q = 0; q < min(stages, nq); ++q) load_w(q);
  }

  if (role == kConsumers) {
    // ---- producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == kProducer) {
      for (int q = stages; q < nq; ++q) {
        // the stage is free once every consumer released step q - stages
        mbar_wait_or_trap(empty(q % stages), (q / stages - 1) & 1);
        load_w(q);
      }
    }
    return;
  }

  // ---- consumer `role`: rows 64 role .. + 63 of the block
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int g = role, w = warp % 4;
  mbar_wait_or_trap(xbar(g), 0);
  ln_rows(smem, a, 64 * g, 64, w, 4);
  // the generic-proxy stores of h, visible to the products' async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  named_sync(1 + g, 128);

  float acc[kBN / 2];
  // Step ks's four k16 products on stage s; the first of a tile's first
  // step writes acc without reading it.
  auto issue = [&](auto first, int ks, int s) {
    const uint32_t at = base + ks * kBoxBytes + g * 64 * kLineBytes;
    const uint32_t bt = ring + s * kStageBytes;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t da = sw128_desc(at + 32 * kk, 16, 1024);
      const uint64_t db = sw128_desc(bt + 32 * kk, 16, 1024);
      if (decltype(first)::value && kk == 0)
        wgmma_ss<true, 0>(acc, da, db);
      else
        wgmma_ss<false, 0>(acc, da, db);
    }
  };
  auto release = [&](int s) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
  };
  // the ring's cursor: stage s of round rnd
  int s = 0, rnd = 0;
  // Step ks's products on the next stage, committed as one group -> the
  // stage.  A tile's first step is its own call (not a branch between the
  // two forms of the products, whose accumulators ptxas would then move
  // between the wgmma fence and the products: C7519).
  auto step = [&](auto first, int ks) {
    mbar_wait_or_trap(full(s), rnd & 1);
    wgmma_fence();
    issue(first, ks, s);
    wgmma_commit();
    const int cur = s;
    if (++s == stages) {
      s = 0;
      ++rnd;
    }
    return cur;
  };

  // Element e of n8 chunk c is acc[4 c + e]: row 16 w + lane / 4 + 8 (e /
  // 2) of the consumer's 64, column 8 c + 2 t + e % 2 of the tile.
  const int t = lane % 4;
  const bool odd = t & 1;
  const int row0 = r0 + 64 * g + 16 * w + lane / 4;
  for (int lt = 0; lt < ntiles; ++lt) {
    int prev = step(std::true_type{}, 0);
    for (int ks = 1; ks < nkb; ++ks) {
      const int cur = step(std::false_type{}, ks);
      wgmma_wait<1>();   // step ks - 1's products are done
      release(prev);
      prev = cur;
    }
    wgmma_wait<0>();
    release(prev);
    fence_regs(acc);

    // the tile's epilogue: + bias (bf16, widened; the tile's loads issued
    // together) in float32, one rounding.  Per chunk pair (c, c + 1) and
    // row half r: an even lane keeps chunk c's pair and takes its odd
    // neighbour's (columns 8 c + 2 t .. + 3), an odd lane keeps chunk c +
    // 1's and takes its even neighbour's; 8-byte stores, none past the
    // last row or past F.
    const int c0 = (t0 + lt) * kBN;
    float bv[kBN / 8][2];
#pragma unroll
    for (int c = 0; c < kBN / 8; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = c0 + 8 * c + 2 * t + e;
        bv[c][e] = col < a.f ? __bfloat162float(a.bias[col]) : 0.f;
      }
#pragma unroll
    for (int c = 0; c < kBN / 8; c += 2) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        const uint32_t lo = mma::pack_bf16(acc[4 * c + 2 * r] + bv[c][0],
                                           acc[4 * c + 2 * r + 1] + bv[c][1]);
        const uint32_t hi =
            mma::pack_bf16(acc[4 * c + 4 + 2 * r] + bv[c + 1][0],
                           acc[4 * c + 5 + 2 * r] + bv[c + 1][1]);
        const uint32_t got = __shfl_xor_sync(0xffffffffu, odd ? lo : hi, 1);
        const int col = c0 + (odd ? 8 * c + 8 + 2 * (t - 1) : 8 * c + 2 * t);
        if (row < a.rows && col < a.f)
          *reinterpret_cast<uint2*>(
              a.out + static_cast<long long>(row) * a.ldo + col) =
              odd ? make_uint2(got, hi) : make_uint2(lo, got);
      }
    }
  }
}

// The bf16 K2 on `stream`: x (rows, e) and w (f, e) 16-byte aligned, e % 8
// == 0, e <= kMaxE; out (rows, ldo), ldo >= f a multiple of 4, 8-byte
// aligned; a.tiles_per_block and a.stages from launch_plan.
inline cudaError_t launch_ln_matmul_wgmma(const bf16* x, const bf16* w,
                                          bf16* out, int ldo, LnWgArgs a,
                                          cudaStream_t stream) {
  const size_t smem = smem_bytes(a.e, a.stages);
  if (a.e > kMaxE || a.tiles_per_block < 1 || a.stages < 2 ||
      a.stages > kMaxStages || ldo < a.f || ldo % 4 ||
      smem + 1024 > kSmemPerSm / kBlocksPerSm)
    return cudaErrorInvalidValue;
  const auto encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorInvalidValue;
  // (inner, outer), rows contiguous, in boxes of 64 x box_outer
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
  CUtensorMap xmap, wmap;
  if (!map(&xmap, x, a.e, a.rows, 64) || !map(&wmap, w, a.e, a.f, kBN))
    return cudaErrorInvalidValue;
  a.out = out;
  a.ldo = ldo;
  const int col_tiles = (a.f + kBN - 1) / kBN;
  const dim3 grid((col_tiles + a.tiles_per_block - 1) / a.tiles_per_block,
                  (a.rows + kBM - 1) / kBM);
  return launch_with_smem(ln_matmul_wgmma_kernel, grid, dim3(kThreads), smem,
                          stream, xmap, wmap, a);
}

}  // namespace lnwg
}  // namespace mhada
