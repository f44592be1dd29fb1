// K7's bf16 backward on the tensor cores.
//
// Replaces, at bf16, mhada_tpu/ops/mhada_pallas.py::_mhada_tm_bwd_kernel
// (_mhada_tm_bwd_impl, pallas_call at mhada_pallas.py:468), and through K7
// the TPU's K11 flash backward (:903, :925).  Per (batch b, head h), with P
// rebuilt from the forward's row log-sum-exp and the wrapper's elementwise
// prologue giving G1 = dM1, G2 = dE2 (bf16) and delta (float32):
//
//   S  = Q K^T,  P = exp(S - lse)                   UNSCALED; keys >= M: 0
//   dP = G1 V^T + G2 (V^2)^T                        V^2 rounded to bf16
//   dS = P (dP - delta)
//   dQ = dS K,  dK = dS^T Q
//   dV = P^T G1 + 2 V * (P^T G2)                    float32, rounded once
//
// q, G1, G2 and dQ are (B, N, C), k, v, dK and dV (B, M, C), head h at
// channels [h*64, (h+1)*64).
//
// Bound: 14 N M d flops per head without the recompute of S and dP, 20 N M
// d as done here (481 and 687 GFLOP at B = 4, N = M = 4096, 8 heads),
// against (4 N + 4 M) C bf16 values and 2 N heads floats moved:
// compute-bound at the bf16 tensor-core rate.
//
// Design: the FlashAttention-2 split of attention_bwd_mma.cuh, with no
// atomics, so the result repeats bit for bit; 4 warps of 16 rows, the
// building blocks of flash_mma.cuh.
// - mhada_mma_dq_kernel owns 64 queries.  Q's, G1's and G2's A fragments
//   and the rows' lse and delta stay in registers; K and V tiles stream
//   through a two-stage cp.async ring.  Per key tile: S = Q K^T; dP = G1
//   V^T + G2 (V^2)^T over 4 k-steps with V's non-transposed B fragments
//   (ldmatrix, as K's in S) and 4 with V^2's, squared from V's in
//   registers; dS in float32, rounded to bf16 as the A fragment of dQ += dS
//   K (K transposed).
// - mhada_mma_dkv_kernel owns 64 keys.  K's and V's A fragments stay in
//   registers (V^2's are squared from V's at each use); Q, G1, G2 and the
//   tile's lse and delta stream through the ring, query rows past N
//   zero-filled (their Q, G1 and G2 rows are 0, so they add nothing).  Per
//   query tile, in two halves of 32 queries to stay under 255 registers
//   with no spill: S^T = K Q^T and dP^T = V G1^T + V^2 G2^T, P^T and dS^T
//   in float32, then dV1 += P^T G1, dV2 += P^T G2 (P^T rounded to bf16) and
//   dK += dS^T Q (dS^T rounded to bf16), G1, G2 and Q as transposed B
//   fragments of the same shared tiles.  The epilogue forms dV = dV1 + 2 V
//   dV2 in float32 from V's A fragments, which hold exactly the
//   accumulators' elements, and rounds it once, as the JAX finalize does
//   (mhada_pallas.py:416-421).
// Rounding follows the JAX backward (mhada_pallas.py:362-421): P rounded to
// bf16 only as the operand of P^T G, dS (from the float32 P) as the operand
// of dS K and dS^T Q; every product accumulates in float32.
#pragma once

#include "mhada_mma.cuh"

namespace mhada {

struct MhadaBwdArgs {
  const __nv_bfloat16* q;    // (B, N, C)
  const __nv_bfloat16* k;    // (B, M, C)
  const __nv_bfloat16* v;    // (B, M, C)
  const __nv_bfloat16* g1;   // dM1 (B, N, C)
  const __nv_bfloat16* g2;   // dE2 (B, N, C)
  const float* lse;          // (B, heads, N)
  const float* delta;        // (B, heads, N)
  __nv_bfloat16* dq;         // (B, N, C)
  __nv_bfloat16* dk;         // (B, M, C)
  __nv_bfloat16* dv;         // (B, M, C)
  int n, m, channels;
};

// One stage of the dkv kernel's ring: Q, G1 and G2 tiles, then 64 lse and
// 64 delta values.
constexpr int kMhadaDkvStageBytes = 3 * mma::kMmaTileBytes + 2 * 64 * 4;
// K and V tiles, then the ring.
constexpr size_t kMhadaDkvSmemBytes =
    2 * mma::kMmaTileBytes + kMmaStages * kMhadaDkvStageBytes;
// Q, G1 and G2 tiles, then kMmaStages x (K, V) tiles.
constexpr size_t kMhadaDqSmemBytes = (3 + 2 * kMmaStages) * mma::kMmaTileBytes;
// Queries of one half of the dkv kernel's query tile.
constexpr int kDkvPart = 32;

__global__ void __launch_bounds__(kMmaThreads)
    mhada_mma_dkv_kernel(MhadaBwdArgs a) {
  using namespace mma;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + kMmaTileElems;
  unsigned char* ring = smem_raw + 2 * kMmaTileBytes;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int k0 = blockIdx.x * kMmaRows, h = blockIdx.y;
  const int N = a.n, M = a.m, C = a.channels;
  const long long b = blockIdx.z, hoff = h * 64;
  const long long bh = b * gridDim.y + h;
  const long long qoff = b * N * C + hoff;
  const int ntiles = (N + 63) / 64;

  auto load_q = [&](int tile) {
    unsigned char* st = ring + (tile % kMmaStages) * kMhadaDkvStageBytes;
    auto* qt = reinterpret_cast<__nv_bfloat16*>(st);
    load_tile_async<kMmaThreads>(qt, a.q + qoff, C, tile * 64, N);
    load_tile_async<kMmaThreads>(qt + kMmaTileElems, a.g1 + qoff, C,
                                 tile * 64, N);
    load_tile_async<kMmaThreads>(qt + 2 * kMmaTileElems, a.g2 + qoff, C,
                                 tile * 64, N);
    // threads 0-63: lse, 64-127: delta
    const int i = threadIdx.x % 64, row = tile * 64 + i;
    const float* src = (threadIdx.x < 64 ? a.lse : a.delta) + bh * N;
    float* dst = reinterpret_cast<float*>(st + 3 * kMmaTileBytes) +
                 (threadIdx.x / 64) * 64 + i;
    cp_async_4(smem_addr(dst), src + (row < N ? row : 0), row < N);
  };
  load_tile_async<kMmaThreads>(ks, a.k + b * M * C + hoff, C, k0, M);
  load_tile_async<kMmaThreads>(vs, a.v + b * M * C + hoff, C, k0, M);
#pragma unroll
  for (int s = 0; s < kMmaStages - 1; ++s) {
    if (s < ntiles) load_q(s);
    cp_async_commit();
  }

  uint32_t kf[4][4], vf[4][4];
  float dk[8][4], dv1[8][4], dv2[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv1[n][e] = dv2[n][e] = 0.f;

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
    const unsigned char* st = ring + (i % kMmaStages) * kMhadaDkvStageBytes;
    const auto* qt = reinterpret_cast<const __nv_bfloat16*>(st);
    const __nv_bfloat16* g1t = qt + kMmaTileElems;
    const __nv_bfloat16* g2t = qt + 2 * kMmaTileElems;
    const float* lse_s =
        reinterpret_cast<const float*>(st + 3 * kMmaTileBytes);
    const float* delta_s = lse_s + 64;

#pragma unroll
    for (int part = 0; part < 64 / kDkvPart; ++part) {
      constexpr int kN = kDkvPart / 8;     // n-tiles of the half
      constexpr int kG = kDkvPart / 16;    // 16-query groups of the half
      // S^T = K Q^T and dP^T = V G1^T + V^2 G2^T: n-tile n holds queries
      // part * kDkvPart + 8 n .. + 7.
      float sT[kN][4], dpT[kN][4];
#pragma unroll
      for (int n = 0; n < kN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sT[n][e] = dpT[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t v2f[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) v2f[e] = square_bf16x2(vf[kk][e]);
#pragma unroll
        for (int p = 0; p < kG; ++p) {
          const int row0 = part * kDkvPart + p * 16;
          uint32_t r[4];
          ldmatrix_x4(r, b_addr(qt, row0, kk * 16));
          mma_16816(sT[2 * p], kf[kk], r[0], r[1]);
          mma_16816(sT[2 * p + 1], kf[kk], r[2], r[3]);
          ldmatrix_x4(r, b_addr(g1t, row0, kk * 16));
          mma_16816(dpT[2 * p], vf[kk], r[0], r[1]);
          mma_16816(dpT[2 * p + 1], vf[kk], r[2], r[3]);
          ldmatrix_x4(r, b_addr(g2t, row0, kk * 16));
          mma_16816(dpT[2 * p], v2f, r[0], r[1]);
          mma_16816(dpT[2 * p + 1], v2f, r[2], r[3]);
        }
      }

      // P^T and dS^T; element e of n-tile n is query part * kDkvPart + 8 n
      // + 2 t + e % 2.  Keys past M are not masked: their rows of dK and
      // dV are not stored.
#pragma unroll
      for (int n = 0; n < kN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = part * kDkvPart + 8 * n + 2 * t + e % 2;
          const float p = exp2f(sT[n][e] * kLog2e - lse_s[c] * kLog2e);
          dpT[n][e] = p * (dpT[n][e] - delta_s[c]);
          sT[n][e] = p;
        }

      // dV1 += P^T G1, dV2 += P^T G2, dK += dS^T Q: k-step kq is queries
      // part * kDkvPart + 16 kq .. + 15.
#pragma unroll
      for (int kq = 0; kq < kG; ++kq) {
        const int row0 = part * kDkvPart + kq * 16;
        uint32_t pa[4], da[4];
        acc_to_a(pa, sT[2 * kq], sT[2 * kq + 1]);
        acc_to_a(da, dpT[2 * kq], dpT[2 * kq + 1]);
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          uint32_t r[4];
          ldmatrix_x4_trans(r, bt_addr(g1t, row0, p * 16));
          mma_16816(dv1[2 * p], pa, r[0], r[1]);
          mma_16816(dv1[2 * p + 1], pa, r[2], r[3]);
          ldmatrix_x4_trans(r, bt_addr(g2t, row0, p * 16));
          mma_16816(dv2[2 * p], pa, r[0], r[1]);
          mma_16816(dv2[2 * p + 1], pa, r[2], r[3]);
          ldmatrix_x4_trans(r, bt_addr(qt, row0, p * 16));
          mma_16816(dk[2 * p], da, r[0], r[1]);
          mma_16816(dk[2 * p + 1], da, r[2], r[3]);
        }
      }
    }
  }

  // Element 2 r + (0, 1) of n-tile n = 2 kk + hi is key g + 8 r, channels
  // 8 n + 2 t, + 1: V's A fragment vf[kk][2 hi + r] holds those two values.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + warp * 16 + g + 8 * r;
    if (key >= M) continue;
    const long long o = (b * M + key) * C + hoff + 2 * t;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 vv = unpack_bf16(vf[n / 2][2 * (n % 2) + r]);
      *reinterpret_cast<uint32_t*>(a.dk + o + 8 * n) =
          pack_bf16(dk[n][2 * r], dk[n][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(a.dv + o + 8 * n) =
          pack_bf16(dv1[n][2 * r] + 2.f * vv.x * dv2[n][2 * r],
                    dv1[n][2 * r + 1] + 2.f * vv.y * dv2[n][2 * r + 1]);
    }
  }
}

__global__ void __launch_bounds__(kMmaThreads)
    mhada_mma_dq_kernel(MhadaBwdArgs a) {
  using namespace mma;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* g1s = qs + kMmaTileElems;
  __nv_bfloat16* g2s = g1s + kMmaTileElems;
  __nv_bfloat16* ring = g2s + kMmaTileElems;   // stage s: K, then V

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * kMmaRows, h = blockIdx.y;
  const int N = a.n, M = a.m, C = a.channels;
  const long long b = blockIdx.z, hoff = h * 64;
  const long long bh = b * gridDim.y + h;
  const long long qoff = b * N * C + hoff, koff = b * M * C + hoff;
  const int ntiles = (M + 63) / 64;

  auto load_kv = [&](int tile) {
    __nv_bfloat16* st = ring + (tile % kMmaStages) * 2 * kMmaTileElems;
    load_tile_async<kMmaThreads>(st, a.k + koff, C, tile * 64, M);
    load_tile_async<kMmaThreads>(st + kMmaTileElems, a.v + koff, C,
                                 tile * 64, M);
  };
  load_tile_async<kMmaThreads>(qs, a.q + qoff, C, q0, N);
  load_tile_async<kMmaThreads>(g1s, a.g1 + qoff, C, q0, N);
  load_tile_async<kMmaThreads>(g2s, a.g2 + qoff, C, q0, N);
#pragma unroll
  for (int s = 0; s < kMmaStages - 1; ++s) {
    if (s < ntiles) load_kv(s);
    cp_async_commit();
  }

  // This thread's rows g and g + 8: lse in log2 units and delta (0 past N,
  // where Q, G1 and G2 are 0 and nothing is stored).
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    lse2[r] = row < N ? a.lse[bh * N + row] * kLog2e : 0.f;
    dl[r] = row < N ? a.delta[bh * N + row] : 0.f;
  }

  uint32_t qf[4][4], g1f[4][4], g2f[4][4];
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
        ldmatrix_x4(g1f[kk], a_addr(g1s, warp * 16, kk * 16));
        ldmatrix_x4(g2f[kk], a_addr(g2s, warp * 16, kk * 16));
      }
    }
    const __nv_bfloat16* kt = ring + (j % kMmaStages) * 2 * kMmaTileElems;
    const __nv_bfloat16* vt = kt + kMmaTileElems;

    // S = Q K^T and dP = G1 V^T + G2 (V^2)^T: n-tile n holds keys 8n..8n+7.
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
        mma_16816(dp[2 * p], g1f[kk], r[0], r[1]);
        mma_16816(dp[2 * p + 1], g1f[kk], r[2], r[3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) r[e] = square_bf16x2(r[e]);
        mma_16816(dp[2 * p], g2f[kk], r[0], r[1]);
        mma_16816(dp[2 * p + 1], g2f[kk], r[2], r[3]);
      }

    // dS; element e of n-tile n is row g + 8 (e / 2), key 64 j + 8 n + 2 t
    // + e % 2.
    const bool ragged = 64 * (j + 1) > M;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(s[n][e] * kLog2e - lse2[e / 2]);
        if (ragged && 64 * j + 8 * n + 2 * t + (e % 2) >= M) p = 0.f;
        dp[n][e] = p * (dp[n][e] - dl[e / 2]);
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
    if (row >= N) continue;
    __nv_bfloat16* drow = a.dq + (b * N + row) * C + hoff + 2 * t;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      *reinterpret_cast<uint32_t*>(drow + 8 * n) =
          pack_bf16(dq[n][2 * r], dq[n][2 * r + 1]);
  }
}

// Both kernels on the caller's stream: dK and dV, then dQ.
inline cudaError_t launch_mhada_mma_bwd(const MhadaBwdArgs& a, int heads,
                                        int batch, cudaStream_t stream) {
  const cudaError_t err = launch_with_smem(
      mhada_mma_dkv_kernel, dim3((a.m + kMmaRows - 1) / kMmaRows, heads,
                                 batch),
      dim3(kMmaThreads), kMhadaDkvSmemBytes, stream, a);
  if (err != cudaSuccess) return err;
  return launch_with_smem(
      mhada_mma_dq_kernel, dim3((a.n + kMmaRows - 1) / kMmaRows, heads,
                                batch),
      dim3(kMmaThreads), kMhadaDqSmemBytes, stream, a);
}

}  // namespace mhada
