// K6's bf16 backward as two warp-specialised wgmma + TMA kernels: dQ, and
// dK with dV.
//
// Replaces, at bf16, mhada_tpu/ops/attention_pallas.py::_tm_bwd_kernel
// (_attn_tm_bwd_impl, pallas_call at attention_pallas.py:351), and through
// K6 the TPU's K12 flash backward (_attn_stream_bwd_impl: dQ at :868, dK
// and dV at :888).  Per (batch b, head h), with P rebuilt from the
// forward's row log-sum-exp (natural-log units) and delta = rowsum(dO O)
// from the wrapper:
//
//   S  = scale Q K^T,  P = exp(S - lse)             keys >= L: P = 0
//   dP = dO V^T
//   dS = P (dP - delta) scale
//   dV = P^T dO,  dK = dS^T Q,  dQ = dS K
//
// with the JAX backward's rounding points (attention_pallas.py:280-312):
// every product takes bf16 operands and sums in float32; P is rounded to
// bf16 only as the operand of P^T dO, dS (formed from the float32 P) only
// as the operand of dS K and dS^T Q.  Q, K and V are read in place from
// the packed (B, L, 3C) qkv (head h at channels h*64, C + h*64 and 2C +
// h*64, rows of 3C), dO from (B, L, C), and dQ, dK and dV written straight
// into the packed (B, L, 3C) gradient at the same offsets.
//
// Bound: 10 L^2 d flops per head without the recompute of S and dP, 14 L^2
// d as done here (S and dP in both kernels): 481 GFLOP at B = 4, L = 4096,
// 8 heads, against 7 L C bf16 values and 2 L heads floats moved:
// operations, at the bf16 tensor-core rate.
//
// Design: K7's pair (mhada_bwd_wgmma.cuh) without its V^2 half, with the
// scale.  The FlashAttention-2 split, with no atomics, so the result
// repeats bit for bit.  Every operand of a product comes from shared
// memory by descriptor (TMA boxes of 3-D tensor maps (C, L, B) in the
// 128-byte swizzle, zero-filled past L inside their own batch) except P
// and dS, whose A fragments are the accumulators of S and dP rounded in
// registers.  The consumers issue their products in turns (named
// barriers, round robin), each running its elementwise work while the
// others' products run.  A register that a product reads is written only
// between a wgmma.wait_group and the next wgmma.fence, and every fresh S
// and dP starts with a write-only k-step, or ptxas serialises every
// product (C7513).  The exponent of P is one FFMA, s (scale log2 e) - lse
// log2 e, as the forward tile's is (attention_wgmma.cuh).  Which pieces
// pay was measured piece by piece on an H100
// (probes/attention_bwd_ablate.py).
// - attention_wgmma_dq_kernel: two consumer warpgroups of 64 queries
//   (registers raised to kDqConsumerRegs by setmaxnreg) and a producer
//   warpgroup whose first thread streams K and V tiles through a ring of
//   kStages stages (a full barrier of TMA bytes and an empty barrier of
//   one arrival per consumer warp a stage).  Each consumer's Q and dO
//   tiles arrive by TMA once; the rows' lse and delta sit in registers.
//   Per key tile: S = Q K^T and dP = dO V^T (4 k-steps each, K and V
//   K-major), P and dS in float32 (keys past L masked in the ragged last
//   tile only: their zero rows would give P = exp(-lse)), then dQ += dS K
//   (K MN-major).  A consumer keeps two product groups in flight: turn j
//   issues tile j's S and dP and tile j - 1's dQ, and forms tile j's P and
//   dS while they run (the forward tile's pattern).  With three consumers
//   of 160 registers ptxas spills that and serialises the products
//   (C7512, as in K7's dQ kernel); two consumers of 232 hold it without a
//   spill, 5-16 % faster than three with one group in flight.  dQ is
//   written once, rounded from float32.
// - attention_wgmma_dkv_kernel: two consumer warpgroups of 64 keys (K and
//   V tiles by TMA once), registers raised to kDkvConsumerRegs by
//   setmaxnreg; the producer's first thread streams Q and dO tiles through
//   a TMA ring, and two of its warps copy each tile's lse (in log2 units)
//   and delta into the stage (0 past L).  Per 64-query tile: S^T = K Q^T
//   and dP^T = V dO^T (m64n64), P^T and dS^T in float32, then dV +=
//   bf16(P^T) dO and dK += bf16(dS^T) Q (dO and Q MN-major).  Whole tiles
//   fit: the accumulators that stay live are dK and dV (64 registers),
//   S^T and dP^T (64), where K7's [dV1 | dV2] took 64 alone.  One product
//   group in flight a consumer: with two, or with three consumers of 152
//   registers, ptxas spills and serialises the products (C7512).  A query
//   row past L has Q and dO zero, lse and delta 0: P^T = 1 and dS^T = 0
//   there, which add nothing.  Keys past L are not masked: their rows of
//   dK and dV are not stored.
#pragma once

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "flash_mma.cuh"
#include "hopper_async.cuh"
#include "wgmma_bwd_parts.cuh"

namespace mhada {
namespace xbw {

using bf16 = __nv_bfloat16;
using wg::Turns;

struct AttnBwdArgs {
  const float* lse;     // (B, heads, L), natural-log units
  const float* delta;   // (B, heads, L)
  bf16* dqkv;           // (B, L, 3C)
  int seq, channels;
  float scale;
};

constexpr int kTileBytes = 64 * 64 * 2;   // one 64 x 64 bf16 box
constexpr int kStages = 4;

// The dQ kernel: two consumers of 64 queries and a producer warpgroup; a
// stage holds K and V, then each consumer's Q and dO tiles, then the
// barriers (full, empty: kStages each) and the Q / dO barrier.
constexpr int kDqConsumers = 2;
constexpr int kDqThreads = 128 * (kDqConsumers + 1);
constexpr int kDqRows = 64 * kDqConsumers;   // queries of a block
constexpr int kDqConsumerRegs = 232, kDqProducerRegs = 40;
static_assert(kDqConsumers * 128 * kDqConsumerRegs + 128 * kDqProducerRegs
                  <= 65536 / kDqThreads / 8 * 8 * kDqThreads,
              "setmaxnreg must stay within the block's allocation");
constexpr int kDqStageBytes = 2 * kTileBytes;
constexpr int kDqTileOff = kStages * kDqStageBytes;
constexpr int kDqBarOff = kDqTileOff + kDqConsumers * 2 * kTileBytes;
constexpr size_t kDqSmemBytes = kDqBarOff + (2 * kStages + 1) * 8 + 1024;

// The dK / dV kernel: two consumers of 64 keys and a producer warpgroup; a
// stage holds Q and dO, then 64 lse and 64 delta floats, padded to the
// swizzle's 1024 bytes; then each consumer's K and V tiles, then the
// barriers (full, empty: kStages each) and the K / V barrier.
constexpr int kDkvConsumers = 2;
constexpr int kDkvThreads = 128 * (kDkvConsumers + 1);
constexpr int kDkvRows = 64 * kDkvConsumers;        // keys of a block
constexpr int kDkvConsumerRegs = 232, kDkvProducerRegs = 40;
static_assert(kDkvConsumers * 128 * kDkvConsumerRegs + 128 * kDkvProducerRegs
                  <= 65536 / kDkvThreads / 8 * 8 * kDkvThreads,
              "setmaxnreg must stay within the block's allocation");
constexpr int kDkvHelpers = 64;   // producer threads copying lse and delta
constexpr int kDkvStageBytes = 2 * kTileBytes + 1024;
constexpr int kDkvKvOff = kStages * kDkvStageBytes;
constexpr int kDkvBarOff = kDkvKvOff + kDkvConsumers * 2 * kTileBytes;
constexpr size_t kDkvSmemBytes = kDkvBarOff + (2 * kStages + 1) * 8 + 1024;

// Named barriers (0 is __syncthreads): consumer w's turn to issue its
// products (kBarTurn + w).
constexpr int kBarTurn = 1;

// S = A B^T and dP = A2 B2^T, m64n64, every operand a 64 x 64 tile in the
// 128-byte swizzle, K-major (the channels): 4 + 4 k-steps, the first of
// each write-only.
__device__ __forceinline__ void issue_s_dp(float (&s)[32], float (&dp)[32],
                                           uint32_t a, uint32_t b,
                                           uint32_t a2, uint32_t b2) {
  using namespace wg;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {   // channels 16 kk..: 32 bytes a step
    const uint64_t da = sw128_desc(a + 32 * kk, 16, 1024);
    const uint64_t db = sw128_desc(b + 32 * kk, 16, 1024);
    if (kk == 0)
      wgmma_ss<true, 0>(s, da, db);
    else
      wgmma_ss<false, 0>(s, da, db);
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t da = sw128_desc(a2 + 32 * kk, 16, 1024);
    const uint64_t db = sw128_desc(b2 + 32 * kk, 16, 1024);
    if (kk == 0)
      wgmma_ss<true, 0>(dp, da, db);
    else
      wgmma_ss<false, 0>(dp, da, db);
  }
}

// d += a b over one 64-row tile `b` (MN-major: 4 k-steps of 16 rows of 128
// bytes), a's A fragments in registers.
__device__ __forceinline__ void issue_rs(float (&d)[32],
                                         const uint32_t (&a)[4][4],
                                         uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wg::wgmma_m64n64k16_rs<1>(
        d, a[kk], wg::sw128_desc(b + 2048 * kk, kTileBytes, 1024), 1);
}

// P = exp(S scale - lse) and dS = P (dP - delta) scale over an m64n64
// accumulator pair in place: s becomes P and dp becomes dS (float32).
// lse2(i) and delta(i): element i's lse in log2 units and its delta;
// keep(i): false where P must be 0.
template <typename Lse, typename Delta, typename Keep>
__device__ __forceinline__ void p_and_ds(float (&s)[32], float (&dp)[32],
                                         float sl2, float scale, Lse lse2,
                                         Delta delta, Keep keep) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    float p = wg::exp2_ftz(fmaf(s[i], sl2, -lse2(i)));
    if (!keep(i)) p = 0.f;
    dp[i] = p * (dp[i] - delta(i)) * scale;
    s[i] = p;
  }
}

__global__ void __launch_bounds__(kDqThreads, 1)
    attention_wgmma_dq_kernel(const __grid_constant__ CUtensorMap qmap,
                              const __grid_constant__ CUtensorMap kmap,
                              const __grid_constant__ CUtensorMap vmap,
                              const __grid_constant__ CUtensorMap gmap,
                              AttnBwdArgs a) {
  using namespace mma;
  using namespace wg;
  extern __shared__ unsigned char smem_raw[];
  // The 128-byte swizzle repeats every 1024 bytes: align the base to it.
  unsigned char* smem = smem_raw + (1024 - smem_addr(smem_raw) % 1024) % 1024;
  const uint32_t base = smem_addr(smem);
  const uint32_t bars = base + kDqBarOff;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };
  const uint32_t qbar = bars + 8 * 2 * kStages;   // Q and dO landed

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int role = warp / 4;   // a consumer below kDqConsumers, or producer
  const int h = blockIdx.y, b = blockIdx.z;
  const int L = a.seq, C = a.channels;
  const int qb = blockIdx.x;
  const int ntiles = (L + 63) / 64;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * kDqConsumers);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (role == kDqConsumers) {
    // ---- producer: one thread issues the TMA loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kDqProducerRegs));
    if (warp == 4 * kDqConsumers && lane == 0) {
      // each consumer's Q and dO rows, zero past L
      mbar_expect_tx(qbar, kDqConsumers * 2 * kTileBytes);
      for (int c = 0; c < kDqConsumers; ++c) {
        const uint32_t dst = base + kDqTileOff + c * 2 * kTileBytes;
        const int row = qb * kDqRows + c * 64;
        tma_load_3d(dst, &qmap, qbar, h * 64, row, b);
        tma_load_3d(dst + kTileBytes, &gmap, qbar, h * 64, row, b);
      }
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % kStages;
        // stage s is free once every consumer released tile j - kStages
        if (j >= kStages) mbar_wait(empty(s), ((j / kStages) & 1) ^ 1);
        const uint32_t kt = base + s * kDqStageBytes;
        mbar_expect_tx(full(s), 2 * kTileBytes);
        tma_load_3d(kt, &kmap, full(s), h * 64, j * 64, b);
        tma_load_3d(kt + kTileBytes, &vmap, full(s), h * 64, j * 64, b);
      }
    }
    return;
  }

  // ---- consumer `role`: 64 queries
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      kDqConsumerRegs));
  const int w = warp % 4, g = lane / 4, t = lane % 4;
  const int q0 = qb * kDqRows + role * 64;
  const uint32_t qt = base + kDqTileOff + role * 2 * kTileBytes;
  const uint32_t gt = qt + kTileBytes;
  const long long bh = static_cast<long long>(b) * gridDim.y + h;
  const float sl2 = a.scale * kLog2e, scale = a.scale;
  // this thread's rows g and g + 8 of the warp's 16: lse in log2 units
  // and delta (0 past L, where Q and dO are 0 and nothing is stored)
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + w * 16 + g + 8 * r;
    lse2[r] = row < L ? a.lse[bh * L + row] * kLog2e : 0.f;
    dl[r] = row < L ? a.delta[bh * L + row] : 0.f;
  }

  // S, dP and dQ: element e of n8 tile n is x[4 n + e], row g + 8 (e / 2)
  // of the warp's 16, column 8 n + 2 t + e % 2 (S, dP: the tile's keys;
  // dQ: the head's channels).
  float s[32], dp[32], dq[32];
  uint32_t df[4][4];   // dS rounded to bf16: dQ's A fragments
#pragma unroll
  for (int i = 0; i < 32; ++i) dq[i] = 0.f;

  // P and dS of key tile j; only the ragged last tile holds keys past L
  auto ds = [&](int j) {
    const int k0 = 64 * j;
    const bool ragged = k0 + 64 > L;
    p_and_ds(
        s, dp, sl2, scale, [&](int i) { return lse2[(i % 4) / 2]; },
        [&](int i) { return dl[(i % 4) / 2]; }, [&](int i) {
          return !ragged || k0 + 8 * (i / 4) + 2 * t + i % 2 < L;
        });
  };
  auto release = [&](int st) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(st));
  };
  const Turns turns(role, kDqConsumers, kBarTurn);

  // Consumers issue in turn, 0 first; each takes ntiles + 1 turns.  In
  // turn j it issues tile j's S and dP and tile j - 1's dQ += dS K, then
  // forms tile j's P and dS while they run.
  if (turns.last) named_arrive(kBarTurn, 256);
  mbar_wait_or_trap(qbar, 0);
  mbar_wait_or_trap(full(0), 0);
  named_sync(turns.turn, 256);
  wgmma_fence();
  issue_s_dp(s, dp, qt, base, gt, base + kTileBytes);
  wgmma_commit();
  named_arrive(turns.next, 256);
  wgmma_wait<0>();
  fence_regs(s);
  fence_regs(dp);
  ds(0);
  pack_frags(df, dp);
  for (int j = 1; j < ntiles; ++j) {
    const int st = j % kStages, sp = (j - 1) % kStages;
    const uint32_t kt = base + st * kDqStageBytes;
    mbar_wait_or_trap(full(st), (j / kStages) & 1);
    named_sync(turns.turn, 256);
    fence_regs(dq);
    fence_frags(df);
    wgmma_fence();
    issue_s_dp(s, dp, qt, kt, gt, kt + kTileBytes);
    wgmma_commit();
    issue_rs(dq, df, base + sp * kDqStageBytes);
    wgmma_commit();
    named_arrive(turns.next, 256);
    wgmma_wait<1>();   // S and dP of tile j; dQ of tile j - 1 may still run
    fence_regs(s);
    fence_regs(dp);
    ds(j);
    wgmma_wait<0>();
    fence_regs(dq);
    fence_frags(df);
    release(sp);
    pack_frags(df, dp);
  }
  {
    const int sl = (ntiles - 1) % kStages;
    named_sync(turns.turn, 256);
    fence_regs(dq);
    fence_frags(df);
    wgmma_fence();
    issue_rs(dq, df, base + sl * kDqStageBytes);
    wgmma_commit();
    if (!turns.last) named_arrive(turns.next, 256);   // its last turn
    wgmma_wait<0>();
    fence_regs(dq);
    release(sl);
  }

  // element 2 r + (0, 1) of n8 tile n: row g + 8 r, channels 8 n + 2 t, + 1
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + w * 16 + g + 8 * r;
    if (row >= L) continue;
    bf16* drow = a.dqkv + (static_cast<long long>(b) * L + row) * 3 * C +
                 h * 64 + 2 * t;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      *reinterpret_cast<uint32_t*>(drow + 8 * n) =
          pack_bf16(dq[4 * n + 2 * r], dq[4 * n + 2 * r + 1]);
  }
}

__global__ void __launch_bounds__(kDkvThreads, 1)
    attention_wgmma_dkv_kernel(const __grid_constant__ CUtensorMap qmap,
                               const __grid_constant__ CUtensorMap kmap,
                               const __grid_constant__ CUtensorMap vmap,
                               const __grid_constant__ CUtensorMap gmap,
                               AttnBwdArgs a) {
  using namespace mma;
  using namespace wg;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + (1024 - smem_addr(smem_raw) % 1024) % 1024;
  const uint32_t base = smem_addr(smem);
  const uint32_t bars = base + kDkvBarOff;
  // full: Q and dO arrived (TMA bytes) and the lse and delta copied (the
  // helpers); empty: every consumer warp released the stage
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };
  const uint32_t kvbar = bars + 8 * 2 * kStages;   // K and V landed

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int role = warp / 4;
  const int h = blockIdx.y, b = blockIdx.z;
  const int L = a.seq, C = a.channels;
  const int ntiles = (L + 63) / 64;
  const long long bh = static_cast<long long>(b) * gridDim.y + h;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1 + kDkvHelpers);
      mbar_init(empty(s), 4 * kDkvConsumers);
    }
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (role == kDkvConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kDkvProducerRegs));
    const int pw = warp % 4;
    if (pw == 0 && lane == 0) {
      mbar_expect_tx(kvbar, kDkvConsumers * 2 * kTileBytes);
      for (int c = 0; c < kDkvConsumers; ++c) {
        const uint32_t dst = base + kDkvKvOff + c * 2 * kTileBytes;
        const int key = blockIdx.x * kDkvRows + c * 64;
        tma_load_3d(dst, &kmap, kvbar, h * 64, key, b);
        tma_load_3d(dst + kTileBytes, &vmap, kvbar, h * 64, key, b);
      }
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(empty(s), ((i / kStages) & 1) ^ 1);
        const uint32_t qt = base + s * kDkvStageBytes;
        mbar_expect_tx(full(s), 2 * kTileBytes);
        tma_load_3d(qt, &qmap, full(s), h * 64, i * 64, b);
        tma_load_3d(qt + kTileBytes, &gmap, full(s), h * 64, i * 64, b);
      }
    } else if (pw == 1 || pw == 2) {   // the helpers: lse and delta
      const int x = threadIdx.x % 128 - 32;
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(empty(s), ((i / kStages) & 1) ^ 1);
        float* dst = reinterpret_cast<float*>(smem + s * kDkvStageBytes +
                                              2 * kTileBytes);
        const int row = i * 64 + x;
        dst[x] = row < L ? a.lse[bh * L + row] * kLog2e : 0.f;
        dst[64 + x] = row < L ? a.delta[bh * L + row] : 0.f;
        mbar_arrive(full(s));
      }
    }
    return;
  }

  // ---- consumer `role`: 64 keys
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      kDkvConsumerRegs));
  const int w = warp % 4, g = lane / 4, t = lane % 4;
  const int k0 = blockIdx.x * kDkvRows + role * 64;
  const uint32_t kt = base + kDkvKvOff + role * 2 * kTileBytes;
  const uint32_t vt = kt + kTileBytes;
  const float sl2 = a.scale * kLog2e, scale = a.scale;

  // S^T, dP^T: element e of n8 tile n is x[4 n + e], key g + 8 (e / 2) of
  // the warp's 16, query 8 n + 2 t + e % 2 of the tile's; dK, dV: the same
  // layout over the head's 64 channels.
  float sT[32], dpT[32], dk[32], dv[32];
  uint32_t pf[4][4], dsf[4][4];   // bf16 P^T, dS^T
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
  auto ds = [&](int st) {
    const float* ld = reinterpret_cast<const float*>(
        smem + st * kDkvStageBytes + 2 * kTileBytes);   // [lse2 64][delta 64]
    p_and_ds(
        sT, dpT, sl2, scale,
        [&](int i) { return ld[8 * (i / 4) + 2 * t + i % 2]; },
        [&](int i) { return ld[64 + 8 * (i / 4) + 2 * t + i % 2]; },
        [](int) { return true; });
  };
  auto release = [&](int st) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(st));
  };
  const Turns turns(role, kDkvConsumers, kBarTurn);

  // One product group in flight: each turn issues tile i's S^T and dP^T;
  // dV and dK follow outside the turns.
  if (turns.last) named_arrive(kBarTurn, 256);
  mbar_wait_or_trap(kvbar, 0);
  for (int i = 0; i < ntiles; ++i) {
    const int st = i % kStages;
    const uint32_t qt = base + st * kDkvStageBytes;
    mbar_wait_or_trap(full(st), (i / kStages) & 1);
    named_sync(turns.turn, 256);
    wgmma_fence();
    issue_s_dp(sT, dpT, kt, qt, vt, qt + kTileBytes);
    wgmma_commit();
    if (i + 1 < ntiles || !turns.last) named_arrive(turns.next, 256);
    wgmma_wait<0>();
    fence_regs(sT);
    fence_regs(dpT);
    ds(st);
    pack_frags(pf, sT);
    pack_frags(dsf, dpT);
    fence_regs(dk);
    fence_regs(dv);
    fence_frags(pf);
    fence_frags(dsf);
    wgmma_fence();
    issue_rs(dv, pf, qt + kTileBytes);
    issue_rs(dk, dsf, qt);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dk);
    fence_regs(dv);
    fence_frags(pf);
    fence_frags(dsf);
    release(st);
  }

  // element 2 r + (0, 1) of n8 tile n: key g + 8 r, channels 8 n + 2 t, + 1
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + w * 16 + g + 8 * r;
    if (key >= L) continue;
    bf16* drow = a.dqkv + (static_cast<long long>(b) * L + key) * 3 * C + C +
                 h * 64 + 2 * t;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      *reinterpret_cast<uint32_t*>(drow + 8 * n) =
          pack_bf16(dk[4 * n + 2 * r], dk[4 * n + 2 * r + 1]);
      *reinterpret_cast<uint32_t*>(drow + C + 8 * n) =
          pack_bf16(dv[4 * n + 2 * r], dv[4 * n + 2 * r + 1]);
    }
  }
}

// qkv (B, L, 3C) and g = dO (B, L, C) bf16, lse and delta (B, heads, L)
// float32; every pointer 16-byte aligned and C a multiple of 8 (as the
// entry always refused otherwise), C = 64 heads.  The dK / dV kernel, then
// the dQ kernel, on the caller's stream.
inline cudaError_t launch_attention_wgmma_bwd(const AttnBwdArgs& a,
                                              const void* qkv, const void* g,
                                              int batch, int heads,
                                              cudaStream_t stream) {
  if (!mma_aligned({qkv, g, a.dqkv}, a.channels)) return cudaErrorInvalidValue;
  if (a.seq < 1 || a.channels != 64 * heads) return cudaErrorInvalidValue;
  const int C = a.channels;
  const bf16* x = static_cast<const bf16*>(qkv);
  CUtensorMap qmap, kmap, vmap, gmap;
  if (!wg::kv_tensor_map(&qmap, x, batch, a.seq, C, 3LL * C) ||
      !wg::kv_tensor_map(&kmap, x + C, batch, a.seq, C, 3LL * C) ||
      !wg::kv_tensor_map(&vmap, x + 2 * C, batch, a.seq, C, 3LL * C) ||
      !wg::kv_tensor_map(&gmap, g, batch, a.seq, C, C))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      attention_wgmma_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kDkvSmemBytes));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(attention_wgmma_dq_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kDqSmemBytes));
  if (err != cudaSuccess) return err;
  attention_wgmma_dkv_kernel<<<dim3((a.seq + kDkvRows - 1) / kDkvRows, heads,
                                    batch),
                               kDkvThreads, kDkvSmemBytes, stream>>>(
      qmap, kmap, vmap, gmap, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_wgmma_dq_kernel<<<dim3((a.seq + kDqRows - 1) / kDqRows, heads,
                                   batch),
                              kDqThreads, kDqSmemBytes, stream>>>(
      qmap, kmap, vmap, gmap, a);
  return cudaGetLastError();
}

}  // namespace xbw
}  // namespace mhada
