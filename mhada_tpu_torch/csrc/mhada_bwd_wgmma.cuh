// K7's bf16 backward as two warp-specialised wgmma + TMA kernels: dQ, and
// dK with dV.
//
// Replaces, at bf16, mhada_tpu/ops/mhada_pallas.py::_mhada_tm_bwd_kernel
// (_mhada_tm_bwd_impl, pallas_call at mhada_pallas.py:468), and through K7
// the TPU's K11 flash backward (_mhada_stream_bwd_impl: dQ at :903, dK and
// dV at :925).  Per (batch b, head h), with P rebuilt from the forward's
// row log-sum-exp and the wrapper's elementwise prologue giving G1 = dM1,
// G2 = dE2 (bf16) and delta (float32):
//
//   S  = Q K^T,  P = exp(S - lse)                   UNSCALED; keys >= M: 0
//   dP = [G1 | G2] [V | V^2]^T                      V^2 rounded to bf16
//   dS = P (dP - delta)
//   dQ = dS K,  dK = dS^T Q
//   dV = P^T G1 + 2 V * (P^T G2)                    float32, rounded once
//
// with the JAX backward's rounding points (mhada_pallas.py:362-421): every
// product takes bf16 operands and sums in float32; P is rounded to bf16
// only as the operand of P^T [G1 | G2], dS (formed from the float32 P) only
// as the operand of dS K and dS^T Q.  q, G1, G2 and dQ are (B, N, C), k, v,
// dK and dV (B, M, C), head h at channels [h*64, (h+1)*64).
//
// Bound: 14 N M d flops per head without the recompute of S and dP, 20 N M
// d as done here (S and dP in both kernels), 481 and 687 GFLOP at B = 4, N
// = M = 4096, 8 heads, against (4 N + 4 M) C bf16 values and 2 N heads
// floats moved: operations, at the bf16 tensor-core rate.
//
// Design: the FlashAttention-2 split, with no atomics, so the result
// repeats bit for bit.  Both kernels take every operand of a product from
// shared memory (wgmma's A by descriptor too) except P and dS, whose A
// fragments are the accumulators of S and dP rounded in registers (the
// m64nN accumulator is, per warp, the m16n8k16 layout).  Their consumers
// issue S and dP in turns (named barriers, round robin), each running its
// elementwise work and its products with P or dS while the others' S and
// dP run.  A consumer keeps one product group in flight: with a second
// (the next tile's S and dP under this one's dQ, or dV and dK) ptxas
// reports too few registers and serialises every product (C7512), and
// spills.  A register that a product reads is written only between a
// wgmma.wait_group and the next wgmma.fence, and every fresh S and dP
// starts with a write-only k-step, or ptxas serialises every product
// (C7513).
// - mhada_wgmma_dq_kernel: the MHAda tile's shape (mhada_wgmma.cuh): three
//   consumer warpgroups of 64 queries and its producer warpgroup and ring
//   unchanged (kv_producer: K and V tiles by TMA, V^2 squared by three
//   warps).  Q's, G1's and G2's tiles of each consumer arrive by TMA once,
//   zero-filled past N; the rows' lse and delta sit in registers.  Per key
//   tile: S = Q K^T (4 k-steps, K K-major), dP = [G1 | G2] [V | V^2]^T as
//   one k = 128 product (V's and V^2's tiles K-major, 8 k-steps), P and dS
//   in float32, then dQ += dS K (K MN-major).  dQ is written once, rounded
//   from float32.
// - mhada_wgmma_dkv_kernel: two consumer warpgroups of 64 keys (K, V and
//   V^2 tiles by TMA, V^2 squared by the consumer), registers raised to
//   kDkvConsumerRegs by setmaxnreg; the producer's first thread streams
//   Q, G1 and G2 tiles through a TMA ring, rows past N zero-filled, and two
//   of its warps copy each tile's lse (in log2 units) and delta into the
//   stage (0 past N).  A query tile is taken in halves of 32 queries
//   (m64n32 S^T and dP^T: with whole tiles the accumulators that stay live,
//   dK (32), [dV1 | dV2] (64), S^T and dP^T (64), spill; kDkvPart).  Per
//   half: S^T =
//   K Q^T, dP^T = [V | V^2] [G1 | G2]^T, P^T and dS^T in float32, then [dV1 |
//   dV2] += P^T [G1 | G2] as one m64n128 product and dK += dS^T Q (G1, G2
//   and Q MN-major).  A query row past N has Q, G1 and G2 zero, lse and
//   delta 0: P^T = 1 and dS^T = 0 there, which add nothing.  The epilogue
//   forms dV = dV1 + 2 V dV2 in float32 (V read at the accumulators'
//   positions) and rounds it once, as the JAX finalize does
//   (mhada_pallas.py:416-421).
#pragma once

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "flash_mma.cuh"
#include "hopper_async.cuh"
#include "mhada_wgmma.cuh"
#include "wgmma_bwd_parts.cuh"

namespace mhada {
namespace wg {

struct BwdArgs {
  const bf16* v;        // (B, M, C): dV's epilogue
  const float* lse;     // (B, heads, N)
  const float* delta;   // (B, heads, N)
  bf16* dq;             // (B, N, C)
  bf16* dk;             // (B, M, C)
  bf16* dv;             // (B, M, C)
  int n, m, channels;
};

// The dQ kernel: the MHAda tile's ring and barriers (kStages x (K, V, V^2)
// at 0), then each consumer's Q, G1 and G2 tiles, then its barriers
// (landed, full, empty, kStages each) and the Q / G barrier.
constexpr int kDqTileOff = kStages * kStageBytes;
constexpr int kDqBarOff = kDqTileOff + kConsumers * 3 * kTileBytes;
constexpr size_t kDqSmemBytes = kDqBarOff + (3 * kStages + 1) * 8 + 1024;

// The dK / dV kernel: two consumers of 64 keys and a producer warpgroup.
constexpr int kDkvConsumers = 2;
constexpr int kDkvThreads = 128 * (kDkvConsumers + 1);
constexpr int kDkvRows = 64 * kDkvConsumers;        // keys of a block
constexpr int kDkvConsumerRegs = 232, kDkvProducerRegs = 40;
static_assert(kDkvConsumers * 128 * kDkvConsumerRegs + 128 * kDkvProducerRegs
                  <= 65536 / kDkvThreads / 8 * 8 * kDkvThreads,
              "setmaxnreg must stay within the block's allocation");
constexpr int kDkvHelpers = 64;   // producer threads copying lse and delta
// Queries of a step: a query tile is taken in kDkvParts parts (S^T and dP^T
// m64n32; 64, whole tiles, spill).
constexpr int kDkvPart = 32, kDkvParts = 64 / kDkvPart;
// A stage: Q, G1, G2 (G1 and G2 adjacent: one MN-major operand), then 64
// lse and 64 delta floats, padded to the swizzle's 1024 bytes.
constexpr int kDkvStageBytes = 3 * kTileBytes + 1024;
constexpr int kDkvKvOff = kStages * kDkvStageBytes;   // per consumer: K, V, V^2
constexpr int kDkvBarOff = kDkvKvOff + kDkvConsumers * 3 * kTileBytes;
constexpr size_t kDkvSmemBytes = kDkvBarOff + (2 * kStages + 1) * 8 + 1024;
// Named barriers (0 is __syncthreads): consumer w's own (kBarOwn + w) and
// its turn (kBarTurn + w), as the MHAda tile's.

// P = exp(S - lse) and dS = P (dP - delta) over an m64nN accumulator pair
// in place (kE = N / 2 elements a thread): s becomes P and dp becomes dS
// (float32).  lse2(i) and delta(i): element i's lse in log2 units and its
// delta; keep(i): false where P must be 0.
template <int kE, typename Lse, typename Delta, typename Keep>
__device__ __forceinline__ void p_and_ds(float (&s)[kE], float (&dp)[kE],
                                         Lse lse2, Delta delta, Keep keep) {
#pragma unroll
  for (int i = 0; i < kE; ++i) {
    float p = exp2_ftz(fmaf(s[i], kLog2e, -lse2(i)));
    if (!keep(i)) p = 0.f;
    dp[i] = p * (dp[i] - delta(i));
    s[i] = p;
  }
}

// S = A B^T and dP = [A1 | A2] [B1 | B2]^T, m64nN (N = 64 or 32 by the
// accumulators' size), each operand in the 128-byte swizzle, K-major (the
// channels): 4 + 8 k-steps, the first of each write-only.
template <int kE>
__device__ __forceinline__ void issue_s_dp(float (&s)[kE], float (&dp)[kE],
                                           uint32_t a, uint32_t b,
                                           uint32_t a1, uint32_t b1,
                                           uint32_t a2, uint32_t b2) {
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
    const uint64_t da = sw128_desc(a1 + 32 * kk, 16, 1024);
    const uint64_t db = sw128_desc(b1 + 32 * kk, 16, 1024);
    if (kk == 0)
      wgmma_ss<true, 0>(dp, da, db);
    else
      wgmma_ss<false, 0>(dp, da, db);
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss<false, 0>(dp, sw128_desc(a2 + 32 * kk, 16, 1024),
                           sw128_desc(b2 + 32 * kk, 16, 1024));
}

__global__ void __launch_bounds__(kThreads, 1)
    mhada_wgmma_dq_kernel(const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap g1map,
                          const __grid_constant__ CUtensorMap g2map,
                          BwdArgs a) {
  using namespace mma;
  extern __shared__ unsigned char smem_raw[];
  // The 128-byte swizzle repeats every 1024 bytes: align the base to it.
  unsigned char* smem = smem_raw + (1024 - smem_addr(smem_raw) % 1024) % 1024;
  const uint32_t base = smem_addr(smem);
  const uint32_t bars = base + kDqBarOff;
  auto landed = [&](int s) { return bars + 8 * s; };
  auto full = [&](int s) { return bars + 8 * (kStages + s); };
  auto empty = [&](int s) { return bars + 8 * (2 * kStages + s); };
  const uint32_t qbar = bars + 8 * 3 * kStages;   // Q, G1 and G2 landed

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int role = warp / 4;   // a consumer below kConsumers, or the producer
  const int h = blockIdx.y, b = blockIdx.z;
  const int N = a.n, M = a.m, C = a.channels;
  const int qb = blockIdx.x;
  const int ntiles = (M + 63) / 64;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(landed(s), 1);
      mbar_init(full(s), kSquarers);
      mbar_init(empty(s), 4 * kConsumers);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (role == kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp == 4 * kConsumers && lane == 0) {
      // each consumer's Q, G1 and G2 rows, zero past N
      mbar_expect_tx(qbar, kConsumers * 3 * kTileBytes);
      for (int c = 0; c < kConsumers; ++c) {
        const uint32_t dst = base + kDqTileOff + c * 3 * kTileBytes;
        const int row = qb * kRows + c * 64;
        tma_load_3d(dst, &qmap, qbar, h * 64, row, b);
        tma_load_3d(dst + kTileBytes, &g1map, qbar, h * 64, row, b);
        tma_load_3d(dst + 2 * kTileBytes, &g2map, qbar, h * 64, row, b);
      }
    }
    kv_producer(&kmap, &vmap, smem, bars, h, b, 0, ntiles);
    return;
  }

  // ---- consumer `role`: 64 queries
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int w = warp % 4, g = lane / 4, t = lane % 4;
  const int q0 = qb * kRows + role * 64;
  const uint32_t qt = base + kDqTileOff + role * 3 * kTileBytes;
  const uint32_t g1t = qt + kTileBytes, g2t = qt + 2 * kTileBytes;
  const long long bh = static_cast<long long>(b) * gridDim.y + h;
  // this thread's rows g and g + 8 of the warp's 16: lse in log2 units
  // and delta (0 past N, where Q, G1 and G2 are 0 and nothing is stored)
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + w * 16 + g + 8 * r;
    lse2[r] = row < N ? a.lse[bh * N + row] * kLog2e : 0.f;
    dl[r] = row < N ? a.delta[bh * N + row] : 0.f;
  }

  // S, dP and dQ: element e of n8 tile n is x[4 n + e], row g + 8 (e / 2)
  // of the warp's 16, column 8 n + 2 t + e % 2 (S, dP: the tile's keys;
  // dQ: the head's channels).
  float s[32], dp[32], dq[32];
  uint32_t df[4][4];   // dS rounded to bf16: dQ's A fragments
#pragma unroll
  for (int i = 0; i < 32; ++i) dq[i] = 0.f;

  auto issue_sdp = [&](int st) {
    const uint32_t kt = base + st * kStageBytes;
    issue_s_dp(s, dp, qt, kt, g1t, kt + kTileBytes, g2t,
               kt + 2 * kTileBytes);
  };
  auto issue_dq = [&](int st) {
    const uint32_t kt = base + st * kStageBytes;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)   // keys 16 kk..: 16 rows of 128 bytes
      wgmma_m64n64k16_rs<1>(
          dq, df[kk], sw128_desc(kt + 2048 * kk, kTileBytes, 1024), 1);
  };
  // P and dS of key tile j; only the ragged last tile holds keys past M,
  // whose zero rows would give P = exp(-lse)
  auto ds = [&](int j) {
    const int k0 = 64 * j;
    const bool ragged = k0 + 64 > M;
    p_and_ds(
        s, dp, [&](int i) { return lse2[(i % 4) / 2]; },
        [&](int i) { return dl[(i % 4) / 2]; },
        [&](int i) { return !ragged || k0 + 8 * (i / 4) + 2 * t + i % 2 < M; });
  };
  auto release = [&](int st) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(st));
  };
  const Turns turns(role, kConsumers, kBarTurn);

  // Consumers issue S and dP in turn, 0 first, one turn a key tile; each
  // runs P and dS, then issues dQ += dS K outside the turns and waits for
  // it (no second group in flight: with one, ptxas serialises every
  // product for want of registers, C7512).
  if (turns.last) named_arrive(kBarTurn, 256);
  mbar_wait_or_trap(qbar, 0);
  for (int j = 0; j < ntiles; ++j) {
    const int st = j % kStages;
    mbar_wait_or_trap(full(st), (j / kStages) & 1);
    named_sync(turns.turn, 256);
    wgmma_fence();
    issue_sdp(st);
    wgmma_commit();
    if (j + 1 < ntiles || !turns.last) named_arrive(turns.next, 256);
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    ds(j);
    pack_frags(df, dp);
    fence_regs(dq);
    fence_frags(df);
    wgmma_fence();
    issue_dq(st);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    fence_frags(df);
    release(st);
  }

  // element 2 r + (0, 1) of n8 tile n: row g + 8 r, channels 8 n + 2 t, + 1
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + w * 16 + g + 8 * r;
    if (row >= N) continue;
    bf16* drow = a.dq + (static_cast<long long>(b) * N + row) * C + h * 64 +
                 2 * t;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      *reinterpret_cast<uint32_t*>(drow + 8 * n) =
          pack_bf16(dq[4 * n + 2 * r], dq[4 * n + 2 * r + 1]);
  }
}

__global__ void __launch_bounds__(kDkvThreads, 1)
    mhada_wgmma_dkv_kernel(const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap,
                           const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap g1map,
                           const __grid_constant__ CUtensorMap g2map,
                           BwdArgs a) {
  using namespace mma;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + (1024 - smem_addr(smem_raw) % 1024) % 1024;
  const uint32_t base = smem_addr(smem);
  const uint32_t bars = base + kDkvBarOff;
  // full: Q, G1, G2 arrived (TMA bytes) and the lse and delta copied (the
  // helpers); empty: every consumer warp released the stage
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };
  const uint32_t kvbar = bars + 8 * 2 * kStages;   // K and V landed

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int role = warp / 4;
  const int h = blockIdx.y, b = blockIdx.z;
  const int N = a.n, M = a.m, C = a.channels;
  const int ntiles = (N + 63) / 64;
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
        const uint32_t dst = base + kDkvKvOff + c * 3 * kTileBytes;
        const int key = blockIdx.x * kDkvRows + c * 64;
        tma_load_3d(dst, &kmap, kvbar, h * 64, key, b);
        tma_load_3d(dst + kTileBytes, &vmap, kvbar, h * 64, key, b);
      }
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(empty(s), ((i / kStages) & 1) ^ 1);
        const uint32_t qt = base + s * kDkvStageBytes;
        mbar_expect_tx(full(s), 3 * kTileBytes);
        tma_load_3d(qt, &qmap, full(s), h * 64, i * 64, b);
        tma_load_3d(qt + kTileBytes, &g1map, full(s), h * 64, i * 64, b);
        tma_load_3d(qt + 2 * kTileBytes, &g2map, full(s), h * 64, i * 64, b);
      }
    } else if (pw == 1 || pw == 2) {   // the helpers: lse and delta
      const int x = threadIdx.x % 128 - 32;
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(empty(s), ((i / kStages) & 1) ^ 1);
        float* dst = reinterpret_cast<float*>(smem + s * kDkvStageBytes +
                                              3 * kTileBytes);
        const int row = i * 64 + x;
        dst[x] = row < N ? a.lse[bh * N + row] * kLog2e : 0.f;
        dst[64 + x] = row < N ? a.delta[bh * N + row] : 0.f;
        mbar_arrive(full(s));
      }
    }
    return;
  }

  // ---- consumer `role`: 64 keys
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      kDkvConsumerRegs));
  const int tid = threadIdx.x % 128, w = warp % 4, g = lane / 4, t = lane % 4;
  const int k0 = blockIdx.x * kDkvRows + role * 64;
  const uint32_t kt = base + kDkvKvOff + role * 3 * kTileBytes;
  const uint32_t vt = kt + kTileBytes, v2t = kt + 2 * kTileBytes;

  // V^2 from the consumer's V tile (elementwise: the swizzle carries over)
  mbar_wait_or_trap(kvbar, 0);
  {
    const uint4* v = reinterpret_cast<const uint4*>(smem + (vt - base));
    uint4* v2 = reinterpret_cast<uint4*>(smem + (v2t - base));
#pragma unroll
    for (int u = 0; u < kTileBytes / 16 / 128; ++u) {
      uint4 x = v[tid + 128 * u];
      x.x = square_bf16x2(x.x);
      x.y = square_bf16x2(x.y);
      x.z = square_bf16x2(x.z);
      x.w = square_bf16x2(x.w);
      v2[tid + 128 * u] = x;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    named_sync(kBarOwn + role, 128);
  }

  // Query tile i is taken in kDkvParts steps of kDkvPart queries (steps
  // kDkvParts i ..).  S^T, dP^T: element e of n8 tile n is x[4 n + e], key
  // g + 8 (e / 2) of the warp's 16, query 8 n + 2 t + e % 2 of the step's;
  // dK: the same layout over the head's 64 channels; [dV1 | dV2]: n8 tiles
  // 0-7 dV1's channels, 8-15 dV2's.
  float sT[kDkvPart / 2], dpT[kDkvPart / 2], dk[32], dv[64];
  uint32_t pf[kDkvPart / 16][4], dsf[kDkvPart / 16][4];   // bf16 P^T, dS^T
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) dv[i] = 0.f;
  const int steps = kDkvParts * ntiles;
  auto stage = [](int u) { return u / kDkvParts % kStages; };
  // the step's first query row in its stage (a shared address)
  auto rows = [&](int u) {
    return base + stage(u) * kDkvStageBytes + u % kDkvParts * kDkvPart * 128;
  };
  auto issue_sdp = [&](int u) {
    const uint32_t qt = rows(u);
    issue_s_dp(sT, dpT, kt, qt, vt, qt + kTileBytes, v2t,
               qt + 2 * kTileBytes);
  };
  auto issue_dkv = [&](int u) {
    const uint32_t qt = rows(u);
#pragma unroll
    for (int kk = 0; kk < kDkvPart / 16; ++kk)   // queries 16 kk..: 16 rows
      wgmma_m64n128k16_rs<1>(                    // of 128 bytes
          dv, pf[kk],
          sw128_desc(qt + kTileBytes + 2048 * kk, kTileBytes, 1024), 1);
#pragma unroll
    for (int kk = 0; kk < kDkvPart / 16; ++kk)
      wgmma_m64n64k16_rs<1>(dk, dsf[kk],
                            sw128_desc(qt + 2048 * kk, kTileBytes, 1024), 1);
  };
  auto ds = [&](int u) {
    const float* ld = reinterpret_cast<const float*>(
                          smem + stage(u) * kDkvStageBytes + 3 * kTileBytes) +
                      u % kDkvParts * kDkvPart;   // [lse2 64][delta 64]
    p_and_ds(
        sT, dpT, [&](int i) { return ld[8 * (i / 4) + 2 * t + i % 2]; },
        [&](int i) { return ld[64 + 8 * (i / 4) + 2 * t + i % 2]; },
        [](int) { return true; });
  };
  auto pack = [&]() {
    pack_frags(pf, sT);
    pack_frags(dsf, dpT);
  };
  auto release = [&](int u) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(stage(u)));
  };
  const Turns turns(role, kDkvConsumers, kBarTurn);

  // One product group in flight: each turn issues step u's S^T and dP^T;
  // dV and dK follow outside the turns.
  if (turns.last) named_arrive(kBarTurn, 256);
  for (int u = 0; u < steps; ++u) {
    if (u % kDkvParts == 0)
      mbar_wait_or_trap(full(stage(u)), u / kDkvParts / kStages & 1);
    named_sync(turns.turn, 256);
    wgmma_fence();
    issue_sdp(u);
    wgmma_commit();
    if (u + 1 < steps || !turns.last) named_arrive(turns.next, 256);
    wgmma_wait<0>();
    fence_regs(sT);
    fence_regs(dpT);
    ds(u);
    pack();
    fence_regs(dk);
    fence_regs(dv);
    fence_frags(pf);
    fence_frags(dsf);
    wgmma_fence();
    issue_dkv(u);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dk);
    fence_regs(dv);
    fence_frags(pf);
    fence_frags(dsf);
    if (u % kDkvParts == kDkvParts - 1) release(u);
  }

  // element 2 r + (0, 1) of n8 tile n: key g + 8 r, channels 8 n + 2 t, + 1
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + w * 16 + g + 8 * r;
    if (key >= M) continue;
    const long long o = (static_cast<long long>(b) * M + key) * C + h * 64 +
                        2 * t;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 vv = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(a.v + o + 8 * n));
      *reinterpret_cast<uint32_t*>(a.dk + o + 8 * n) =
          pack_bf16(dk[4 * n + 2 * r], dk[4 * n + 2 * r + 1]);
      *reinterpret_cast<uint32_t*>(a.dv + o + 8 * n) = pack_bf16(
          dv[4 * n + 2 * r] + 2.f * vv.x * dv[32 + 4 * n + 2 * r],
          dv[4 * n + 2 * r + 1] + 2.f * vv.y * dv[32 + 4 * n + 2 * r + 1]);
    }
  }
}

// q, g1 (dM1), g2 (dE2) (B, N, C) and k, v (B, M, C) bf16, lse and delta
// (B, heads, N) float32; every pointer 16-byte aligned, C = 64 heads.  The
// dK / dV kernel, then the dQ kernel, on the caller's stream.
inline cudaError_t launch_mhada_wgmma_bwd(const BwdArgs& a, const void* q,
                                          const void* k, const void* g1,
                                          const void* g2, int batch,
                                          int heads, cudaStream_t stream) {
  if (a.n < 1 || a.m < 1 || a.channels != 64 * heads ||
      !mma_aligned({q, k, a.v, g1, g2, a.dq, a.dk, a.dv}, a.channels))
    return cudaErrorInvalidValue;
  CUtensorMap kmap, vmap, qmap, g1map, g2map;
  const int C = a.channels;
  if (!kv_tensor_map(&kmap, k, batch, a.m, C, C) ||
      !kv_tensor_map(&vmap, a.v, batch, a.m, C, C) ||
      !kv_tensor_map(&qmap, q, batch, a.n, C, C) ||
      !kv_tensor_map(&g1map, g1, batch, a.n, C, C) ||
      !kv_tensor_map(&g2map, g2, batch, a.n, C, C))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      mhada_wgmma_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kDkvSmemBytes));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(mhada_wgmma_dq_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kDqSmemBytes));
  if (err != cudaSuccess) return err;
  mhada_wgmma_dkv_kernel<<<dim3((a.m + kDkvRows - 1) / kDkvRows, heads,
                                batch),
                           kDkvThreads, kDkvSmemBytes, stream>>>(
      kmap, vmap, qmap, g1map, g2map, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mhada_wgmma_dq_kernel<<<dim3((a.n + kRows - 1) / kRows, heads, batch),
                          kThreads, kDqSmemBytes, stream>>>(
      kmap, vmap, qmap, g1map, g2map, a);
  return cudaGetLastError();
}

}  // namespace wg
}  // namespace mhada
