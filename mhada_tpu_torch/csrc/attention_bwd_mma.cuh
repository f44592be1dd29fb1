// K6's bf16 backward on the tensor cores.
//
// Replaces, at bf16, mhada_tpu/ops/attention_pallas.py::_tm_bwd_kernel
// (_attn_tm_bwd_impl, pallas_call at attention_pallas.py:351), and through
// K6 the TPU's K12 flash backward (:868, :888).  Per (batch b, head h), with
// P rebuilt from the forward's row log-sum-exp:
//
//   S = scale Q K^T, P = exp(S - lse), dP = dO V^T,
//   dS = P (dP - delta) scale      (delta = rowsum(dO O), from the wrapper)
//   dV = P^T dO, dK = dS^T Q, dQ = dS K,
//
// written straight into the packed (B, L, 3C) gradient at channel offsets
// C + h*64, 2C + h*64 and h*64.
//
// Bound: 14 L^2 d flops per head with the recompute of S and dP in both
// kernels (10 L^2 d without it; 343.6 GFLOP at B = 4, L = 4096, 8 heads)
// against 7 L C bf16 values and 2 L heads floats moved: compute-bound at
// the bf16 tensor-core rate.
//
// Design: the FlashAttention-2 split with no atomics, so the result does not
// depend on scheduling and repeats bit for bit.  Both kernels use 4 warps of
// 16 rows and the building blocks of flash_mma.cuh.
// - attention_mma_dkv_kernel owns 64 keys (16 a warp).  K's and V's A
//   fragments are loaded once into registers.  Q, dO and the tile's lse and
//   delta stream through a two-stage cp.async ring, query rows past L
//   zero-filled (their Q and dO rows are 0, so they add nothing).  Per
//   query tile: S^T = K Q^T and dP^T = V dO^T (Q and dO as non-transposed
//   B fragments), P^T and dS^T in float32 registers, then dV += P^T dO and
//   dK += dS^T Q with dO and Q as transposed B fragments of the same
//   shared tiles.
// - attention_mma_dq_kernel owns 64 queries (16 a warp).  Q's and dO's A
//   fragments and the rows' lse and delta stay in registers; K and V tiles
//   stream through the ring.  Per key tile: S = Q K^T, dP = dO V^T, dS
//   (keys >= L give P = 0), then dQ += dS K with K transposed.
// Rounding follows the JAX backward (attention_pallas.py:280-312): P is
// rounded to bf16 only as the operand of P^T dO, dS (from the float32 P) as
// the operand of dS K and dS^T Q; every product accumulates in float32.
#pragma once

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "flash_mma.cuh"

namespace mhada {

struct AttnMmaArgs {
  const __nv_bfloat16* qkv;   // (B, L, 3C)
  const __nv_bfloat16* g;     // dO (B, L, C)
  const float* lse_in;        // (B, heads, L), natural-log units
  const float* delta;         // (B, heads, L)
  __nv_bfloat16* out;         // d qkv (B, L, 3C)
  int seq, channels;
  float scale;
};

// Fill the kernels' arguments for the packed (B, L, 3C) qkv -> false
// unless the pointers are 16-byte aligned and channels a multiple of 8, as
// the 16-byte copies of the rows need.
inline bool make_mma_args(AttnMmaArgs& a, const void* qkv, const void* g,
                          void* out, int seq, int channels, float scale) {
  if (!mma_aligned({qkv, g, out}, channels)) return false;
  a.qkv = static_cast<const __nv_bfloat16*>(qkv);
  a.g = static_cast<const __nv_bfloat16*>(g);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.seq = seq;
  a.channels = channels;
  a.scale = scale;
  return true;
}

// One stage of the dkv kernel's ring: Q and dO tiles, then 64 lse and 64
// delta values.
constexpr int kDkvStageBytes = 2 * mma::kMmaTileBytes + 2 * 64 * 4;
// K and V tiles, then the ring.
constexpr size_t kDkvSmemBytes =
    2 * mma::kMmaTileBytes + kMmaStages * kDkvStageBytes;
// Q and dO tiles, then kMmaStages x (K, V) tiles.
constexpr size_t kDqSmemBytes = (2 + 2 * kMmaStages) * mma::kMmaTileBytes;

__global__ void __launch_bounds__(kMmaThreads)
    attention_mma_dkv_kernel(AttnMmaArgs a) {
  using namespace mma;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + kMmaTileElems;
  unsigned char* ring = smem_raw + 2 * kMmaTileBytes;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int k0 = blockIdx.x * kMmaRows;
  const int L = a.seq, C = a.channels, h = blockIdx.y;
  const long long rs = 3LL * C, b = blockIdx.z;
  const long long bh = b * gridDim.y + h;
  const __nv_bfloat16* qb = a.qkv + b * L * rs + h * 64;
  const __nv_bfloat16* gb = a.g + b * L * C + h * 64;
  const int ntiles = (L + 63) / 64;

  auto load_q = [&](int tile) {
    unsigned char* st = ring + (tile % kMmaStages) * kDkvStageBytes;
    auto* qt = reinterpret_cast<__nv_bfloat16*>(st);
    load_tile_async<kMmaThreads>(qt, qb, rs, tile * 64, L);
    load_tile_async<kMmaThreads>(qt + kMmaTileElems, gb, C, tile * 64, L);
    // threads 0-63: lse, 64-127: delta
    const int i = threadIdx.x % 64, row = tile * 64 + i;
    const float* src = (threadIdx.x < 64 ? a.lse_in : a.delta) + bh * L;
    float* dst = reinterpret_cast<float*>(st + 2 * kMmaTileBytes) +
                 (threadIdx.x / 64) * 64 + i;
    cp_async_4(smem_addr(dst), src + (row < L ? row : 0), row < L);
  };
  load_tile_async<kMmaThreads>(ks, qb + C, rs, k0, L);
  load_tile_async<kMmaThreads>(vs, qb + 2 * C, rs, k0, L);
#pragma unroll
  for (int s = 0; s < kMmaStages - 1; ++s) {
    if (s < ntiles) load_q(s);
    cp_async_commit();
  }

  const float sl2 = a.scale * kLog2e;
  uint32_t kf[4][4], vf[4][4];
  float dk[8][4], dv[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<kMmaStages - 2>();
    __syncthreads();
    if (i + kMmaStages - 1 < ntiles) load_q(i + kMmaStages - 1);
    cp_async_commit();
    if (i == 0) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        ldmatrix_x4(kf[kk], a_addr(ks, warp * 16, kk * 16));
        ldmatrix_x4(vf[kk], a_addr(vs, warp * 16, kk * 16));
      }
    }
    const unsigned char* st = ring + (i % kMmaStages) * kDkvStageBytes;
    const auto* qt = reinterpret_cast<const __nv_bfloat16*>(st);
    const __nv_bfloat16* gt = qt + kMmaTileElems;
    const float* lse_s =
        reinterpret_cast<const float*>(st + 2 * kMmaTileBytes);
    const float* delta_s = lse_s + 64;

    // S^T = K Q^T and dP^T = V dO^T: n-tile n holds queries 8n..8n+7.
    float sT[8][4], dpT[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sT[n][e] = dpT[n][e] = 0.f;
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t r[4];
        ldmatrix_x4(r, b_addr(qt, p * 16, kk * 16));
        mma_16816(sT[2 * p], kf[kk], r[0], r[1]);
        mma_16816(sT[2 * p + 1], kf[kk], r[2], r[3]);
        ldmatrix_x4(r, b_addr(gt, p * 16, kk * 16));
        mma_16816(dpT[2 * p], vf[kk], r[0], r[1]);
        mma_16816(dpT[2 * p + 1], vf[kk], r[2], r[3]);
      }

    // P^T and dS^T; element e of n-tile n is query 8 n + 2 t + e % 2.
    // Keys past L are not masked: their rows of dK and dV are not stored.
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * n + 2 * t + e % 2;
        const float p = exp2f(sT[n][e] * sl2 - lse_s[c] * kLog2e);
        dpT[n][e] = p * (dpT[n][e] - delta_s[c]) * a.scale;
        sT[n][e] = p;
      }

    // dV += P^T dO, dK += dS^T Q: k-step kk is queries 16 kk..16 kk + 15.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[4], da[4];
      acc_to_a(pa, sT[2 * kk], sT[2 * kk + 1]);
      acc_to_a(da, dpT[2 * kk], dpT[2 * kk + 1]);
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, bt_addr(gt, kk * 16, p * 16));
        mma_16816(dv[2 * p], pa, r[0], r[1]);
        mma_16816(dv[2 * p + 1], pa, r[2], r[3]);
        ldmatrix_x4_trans(r, bt_addr(qt, kk * 16, p * 16));
        mma_16816(dk[2 * p], da, r[0], r[1]);
        mma_16816(dk[2 * p + 1], da, r[2], r[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + warp * 16 + g + 8 * r;
    if (key >= L) continue;
    __nv_bfloat16* drow = a.out + (b * L + key) * rs + C + h * 64 + 2 * t;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      *reinterpret_cast<uint32_t*>(drow + 8 * n) =
          pack_bf16(dk[n][2 * r], dk[n][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(drow + C + 8 * n) =
          pack_bf16(dv[n][2 * r], dv[n][2 * r + 1]);
    }
  }
}

__global__ void __launch_bounds__(kMmaThreads)
    attention_mma_dq_kernel(AttnMmaArgs a) {
  using namespace mma;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* gs = qs + kMmaTileElems;
  __nv_bfloat16* ring = gs + kMmaTileElems;   // stage s: K, then V

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * kMmaRows;
  const int L = a.seq, C = a.channels, h = blockIdx.y;
  const long long rs = 3LL * C, b = blockIdx.z;
  const long long bh = b * gridDim.y + h;
  const __nv_bfloat16* qb = a.qkv + b * L * rs + h * 64;
  const int ntiles = (L + 63) / 64;

  auto load_kv = [&](int tile) {
    __nv_bfloat16* st = ring + (tile % kMmaStages) * 2 * kMmaTileElems;
    load_tile_async<kMmaThreads>(st, qb + C, rs, tile * 64, L);
    load_tile_async<kMmaThreads>(st + kMmaTileElems, qb + 2 * C, rs,
                                 tile * 64, L);
  };
  load_tile_async<kMmaThreads>(qs, qb, rs, q0, L);
  load_tile_async<kMmaThreads>(gs, a.g + b * L * C + h * 64, C, q0, L);
#pragma unroll
  for (int s = 0; s < kMmaStages - 1; ++s) {
    if (s < ntiles) load_kv(s);
    cp_async_commit();
  }

  // This thread's rows g and g + 8: lse in log2 units and delta (0 past L,
  // where Q and dO are 0 and nothing is stored).
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    lse2[r] = row < L ? a.lse_in[bh * L + row] * kLog2e : 0.f;
    dl[r] = row < L ? a.delta[bh * L + row] : 0.f;
  }

  const float sl2 = a.scale * kLog2e;
  uint32_t qf[4][4], gf[4][4];
  float dq[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    cp_async_wait<kMmaStages - 2>();
    __syncthreads();
    if (j + kMmaStages - 1 < ntiles) load_kv(j + kMmaStages - 1);
    cp_async_commit();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        ldmatrix_x4(qf[kk], a_addr(qs, warp * 16, kk * 16));
        ldmatrix_x4(gf[kk], a_addr(gs, warp * 16, kk * 16));
      }
    }
    const __nv_bfloat16* kt = ring + (j % kMmaStages) * 2 * kMmaTileElems;
    const __nv_bfloat16* vt = kt + kMmaTileElems;

    // S = Q K^T and dP = dO V^T: n-tile n holds keys 8n..8n+7.
    float s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t r[4];
        ldmatrix_x4(r, b_addr(kt, p * 16, kk * 16));
        mma_16816(s[2 * p], qf[kk], r[0], r[1]);
        mma_16816(s[2 * p + 1], qf[kk], r[2], r[3]);
        ldmatrix_x4(r, b_addr(vt, p * 16, kk * 16));
        mma_16816(dp[2 * p], gf[kk], r[0], r[1]);
        mma_16816(dp[2 * p + 1], gf[kk], r[2], r[3]);
      }

    // dS; element e of n-tile n is row g + 8 (e / 2), key 64 j + 8 n + 2 t
    // + e % 2.
    const bool ragged = 64 * (j + 1) > L;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(s[n][e] * sl2 - lse2[e / 2]);
        if (ragged && 64 * j + 8 * n + 2 * t + (e % 2) >= L) p = 0.f;
        dp[n][e] = p * (dp[n][e] - dl[e / 2]) * a.scale;
      }

    // dQ += dS K: k-step kk is keys 16 kk..16 kk + 15.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t da[4];
      acc_to_a(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, bt_addr(kt, kk * 16, p * 16));
        mma_16816(dq[2 * p], da, r[0], r[1]);
        mma_16816(dq[2 * p + 1], da, r[2], r[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= L) continue;
    __nv_bfloat16* drow = a.out + (b * L + row) * rs + h * 64 + 2 * t;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      *reinterpret_cast<uint32_t*>(drow + 8 * n) =
          pack_bf16(dq[n][2 * r], dq[n][2 * r + 1]);
  }
}

// Both kernels on the caller's stream: dK and dV, then dQ.
inline cudaError_t launch_attention_mma_bwd(const AttnMmaArgs& a, int heads,
                                            int batch, cudaStream_t stream) {
  const dim3 grid((a.seq + kMmaRows - 1) / kMmaRows, heads, batch);
  const cudaError_t err =
      launch_with_smem(attention_mma_dkv_kernel, grid, dim3(kMmaThreads),
                       kDkvSmemBytes, stream, a);
  if (err != cudaSuccess) return err;
  return launch_with_smem(attention_mma_dq_kernel, grid, dim3(kMmaThreads),
                          kDqSmemBytes, stream, a);
}

}  // namespace mhada
