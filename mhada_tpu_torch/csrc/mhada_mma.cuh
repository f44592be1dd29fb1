// The bf16 MHAda forward tile on the tensor cores for K7's forward (also
// writing M1, E2 and the row log-sum-exp for the backward), the port of
// mhada_tpu/ops/mhada_pallas.py::_tm_res_kernel (_mhada_tm_fwd_impl,
// pallas_call at mhada_pallas.py:336) and through it of the TPU's K10
// forward with its residuals (:622).  K3 and K4, which it also ran before,
// run on the warp-specialised wgmma + TMA tile of mhada_wgmma.cuh.  Per
// (batch b, head h), with every tensor token-major and head h at channels
// [h*64, (h+1)*64):
//
//   A  = softmax(q K^T)                             UNSCALED
//   M1 = A V,  E2 = A V^2                           float32
//   out = sqrt(max(E2 - M1^2, 1e-6)) * fcs_n + M1
//
// Bound: 6 N M d flops per head (51.5 GFLOP at N = M = 4096, 8 heads)
// against (3 N + 2 M) C bf16 values moved and M1 and E2 in float32:
// compute-bound at the bf16 tensor-core rate.
//
// Design: K1's former mma.sync tile with a second product.  A block of
// 4 warps owns 64 queries of one (b, h), 16 rows a warp, and streams the
// keys in tiles of 64 through the two-stage cp.async ring of K and V, rows
// past M zero-filled:
// - Q's A fragments by ldmatrix from its shared tile.
// - S = Q K^T with K's B fragments by ldmatrix, scale 1; exp2f on float32
//   scores times log2 e, as K1; keys >= M masked to -inf (their zero-filled
//   rows would give S = 0, not -inf).
// - The online softmax runs on the accumulator fragments; P is rounded to
//   bf16 in registers (acc_to_a) as the JAX kernels round it (p.astype(
//   v.dtype), mhada_pallas.py:295-301) and never leaves them; the row sum
//   takes P before rounding, as the JAX denominator does.
// - [V | V^2]: P's A fragment of a k-step feeds 16 n-tiles, 8 with V's B
//   fragments (ldmatrix.trans) and 8 with V^2's.  V^2 is made from V's
//   fragments in registers (square_bf16x2: each bf16 squared and rounded to
//   bf16, as jnp.square on a bf16 array), one instruction a register: no
//   third shared tile and no extra barrier, at the price of each warp
//   squaring the tile's V again.
// - O1 and O2 accumulate in float32 (32 registers each).  The epilogue
//   divides by the row sum (M1 = O1 / l, E2 = O2 / l, float32), clamps the
//   variance and writes out rounded to bf16; kRes also writes M1 and E2
//   (float32, (B, N, C)) and lse = m + log l ((B, heads, N)).
#pragma once

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "flash_mma.cuh"

namespace mhada {

struct MhadaMmaArgs {
  const __nv_bfloat16* q;    // (B, N, C)
  const __nv_bfloat16* k;    // (B, M, C)
  const __nv_bfloat16* v;    // (B, M, C)
  const __nv_bfloat16* f;    // fcs_n (B, N, C)
  __nv_bfloat16* out;        // (B, N, C)
  float* m1;                 // kRes: (B, N, C)
  float* e2;                 // kRes: (B, N, C)
  float* lse;                // kRes: (B, heads, N)
  int n, m, channels;
};

// Shared memory: the Q tile, then kMmaStages x (K, V) tiles.
constexpr size_t mhada_mma_fwd_smem_bytes() {
  return (1 + 2 * kMmaStages) * mma::kMmaTileBytes;
}

template <bool kRes>
__global__ void __launch_bounds__(kMmaThreads)
    mhada_mma_fwd_kernel(MhadaMmaArgs a) {
  using namespace mma;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ring = qs + kMmaTileElems;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * kMmaRows, h = blockIdx.y;
  const int N = a.n, M = a.m, C = a.channels;
  const long long b = blockIdx.z, hoff = h * 64;
  const __nv_bfloat16* kb = a.k + b * M * C + hoff;
  const __nv_bfloat16* vb = a.v + b * M * C + hoff;
  const int ntiles = (M + 63) / 64;

  auto load_kv = [&](int tile) {
    __nv_bfloat16* st = ring + (tile % kMmaStages) * 2 * kMmaTileElems;
    load_tile_async<kMmaThreads>(st, kb, C, tile * 64, M);
    load_tile_async<kMmaThreads>(st + kMmaTileElems, vb, C, tile * 64, M);
  };
  load_tile_async<kMmaThreads>(qs, a.q + b * N * C + hoff, C, q0, N);
#pragma unroll
  for (int s = 0; s < kMmaStages - 1; ++s) {
    if (s < ntiles) load_kv(s);
    cp_async_commit();
  }
  cp_async_wait<0>();   // Q and the first K/V tile
  __syncthreads();

  uint32_t qf[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    ldmatrix_x4(qf[kk], a_addr(qs, warp * 16, kk * 16));

  float o1[8][4], o2[8][4];
  float mrow[2] = {-INFINITY, -INFINITY}, lrow[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o1[n][e] = o2[n][e] = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    cp_async_wait<kMmaStages - 2>();   // tile j landed
    __syncthreads();                   // ... for every thread; stage j-1 free
    if (j + kMmaStages - 1 < ntiles) load_kv(j + kMmaStages - 1);
    cp_async_commit();
    const __nv_bfloat16* ks = ring + (j % kMmaStages) * 2 * kMmaTileElems;
    const __nv_bfloat16* vs = ks + kMmaTileElems;

    // S = Q K^T: n-tile n holds keys 8n..8n+7 of the tile.
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t r[4];
        ldmatrix_x4(r, b_addr(ks, p * 16, kk * 16));
        mma_16816(s[2 * p], qf[kk], r[0], r[1]);
        mma_16816(s[2 * p + 1], qf[kk], r[2], r[3]);
      }

    // Online softmax in log2 units; element e of n-tile n is row g + 8
    // (e / 2), key 64 j + 8 n + 2 t + e % 2.
    const bool ragged = 64 * (j + 1) > M;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * kLog2e;
        if (ragged && 64 * j + 8 * n + 2 * t + (e % 2) >= M) x = -INFINITY;
        s[n][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // finite: key 64 j < M is in every tile
      const float m_new = fmaxf(mrow[r], quad_max(mx[r]));
      const float alpha = exp2f(mrow[r] - m_new);
      mrow[r] = m_new;
      lrow[r] *= alpha;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        o1[n][2 * r] *= alpha;
        o1[n][2 * r + 1] *= alpha;
        o2[n][2 * r] *= alpha;
        o2[n][2 * r + 1] *= alpha;
      }
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[n][e] - mrow[e / 2]);
        lrow[e / 2] += p;
        s[n][e] = p;
      }

    // O1 += P V and O2 += P V^2: P's k-step kk is keys 16 kk..16 kk + 15.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[4];
      acc_to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, bt_addr(vs, kk * 16, p * 16));
        mma_16816(o1[2 * p], pa, r[0], r[1]);
        mma_16816(o1[2 * p + 1], pa, r[2], r[3]);
#pragma unroll
        for (int i = 0; i < 4; ++i) r[i] = square_bf16x2(r[i]);
        mma_16816(o2[2 * p], pa, r[0], r[1]);
        mma_16816(o2[2 * p + 1], pa, r[2], r[3]);
      }
    }
  }

  // Epilogue: element 2 r + (0, 1) of n-tile n is row g + 8 r, channels
  // 8 n + 2 t and 8 n + 2 t + 1.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    const float l = quad_sum(lrow[r]);
    if (row >= N) continue;
    const long long o = (b * N + row) * C + hoff + 2 * t;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float m1x = o1[n][2 * r] / l, m1y = o1[n][2 * r + 1] / l;
      const float e2x = o2[n][2 * r] / l, e2y = o2[n][2 * r + 1] / l;
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(a.f + o + 8 * n));
      // E2 - M1^2 cancels: both stay float32 until the clamp.
      const float sdx = sqrtf(fmaxf(e2x - m1x * m1x, 1e-6f));
      const float sdy = sqrtf(fmaxf(e2y - m1y * m1y, 1e-6f));
      *reinterpret_cast<uint32_t*>(a.out + o + 8 * n) =
          pack_bf16(sdx * f.x + m1x, sdy * f.y + m1y);
      if (kRes) {
        *reinterpret_cast<float2*>(a.m1 + o + 8 * n) = make_float2(m1x, m1y);
        *reinterpret_cast<float2*>(a.e2 + o + 8 * n) = make_float2(e2x, e2y);
      }
    }
    if (kRes && t == 0)
      a.lse[(b * gridDim.y + h) * N + row] = mrow[r] * kLn2 + logf(l);
  }
}

template <bool kRes>
cudaError_t launch_mhada_mma_fwd(const MhadaMmaArgs& a, int heads, int batch,
                                 cudaStream_t stream) {
  const dim3 grid((a.n + kMmaRows - 1) / kMmaRows, heads, batch);
  return launch_with_smem(mhada_mma_fwd_kernel<kRes>, grid,
                          dim3(kMmaThreads),
                          mhada_mma_fwd_smem_bytes(), stream, a);
}

}  // namespace mhada
