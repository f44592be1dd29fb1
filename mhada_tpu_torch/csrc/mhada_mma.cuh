// The bf16 MHAda forward tile on the tensor cores: K3 (kPrologue, the block
// core on cached style K/V with the instance norm and the Q projection
// fused in), K7's forward (kRes, also writing M1, E2 and the row
// log-sum-exp for the backward) and K4 (neither: q and fcs_n given, only
// out written).
//
// Replaces, at bf16, mhada_tpu/ops/mhada_pallas.py::_fused_kernel
// (mhada_fused_prologue, pallas_call at mhada_pallas.py:239),
// _tm_res_kernel (_mhada_tm_fwd_impl, pallas_call at :336) and _kernel
// (_mhada_pallas_fwd_impl, pallas_call at :114); through K7 and K4 also
// the TPU's K10 forward, with its residuals and without (:622).  Per
// (batch b, head h), with every tensor token-major and head h at channels
// [h*64, (h+1)*64):
//
//   K3:  qn = (fc - mean_fc) * rstd_fc              float32, rounded to bf16
//        q  = qn Wf_h + fb_h                        float32, rounded to bf16
//   K4, K7:  q given
//   A  = softmax(q K^T)                             UNSCALED
//   M1 = A V,  E2 = A V^2                           float32
//   out = sqrt(max(E2 - M1^2, 1e-6)) * f + M1       f = IN(fcs) (K3, from
//                                                   raw fcs and the stats)
//                                                   or fcs_n (K4, K7)
//
// Bound: 6 N M d flops per head (51.5 GFLOP at N = M = 4096, 8 heads; K3
// adds 2 N d^2 for the projection) against (3 N + 2 M) C bf16 values
// moved (K7: also M1 and E2 in float32): compute-bound at the bf16
// tensor-core rate.
//
// Design: K1's tile (attention_mma.cuh) with a second product.  A block of
// 4 warps owns 64 queries of one (b, h), 16 rows a warp, and streams the
// keys in tiles of 64 through the two-stage cp.async ring of K and V, rows
// past M zero-filled:
// - K3's prologue: the raw fc tile and Wf_h (64 x 64, (in, out)) arrive by
//   cp.async; each thread normalises its 16-byte chunks of fc in place with
//   the float32 stats and rounds them to bf16; each warp loads its qn A
//   fragments, multiplies them by Wf_h's B fragments (ldmatrix.trans) in
//   float32, adds fb_h and packs the rounded q straight into its Q A
//   fragments (acc_to_a).  q never reaches shared memory or device memory.
// - S = Q K^T with K's B fragments by ldmatrix, scale 1; exp2f on float32
//   scores times log2 e, as K1; keys >= M masked to -inf (their zero-filled
//   rows would give S = 0, not -inf).
// - The online softmax runs on the accumulator fragments; P is rounded to
//   bf16 in registers (acc_to_a) as the JAX kernels round it (p.astype(
//   v.dtype), mhada_pallas.py:65-72, 186-191, 295-301) and never leaves
//   them; the row sum takes P before rounding, as the JAX denominator does.
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
  const __nv_bfloat16* q;    // K4, K7: q; K3: raw fc (B, N, C)
  const __nv_bfloat16* k;    // (B, M, C)
  const __nv_bfloat16* v;    // (B, M, C)
  const __nv_bfloat16* f;    // K4, K7: fcs_n; K3: raw fcs (B, N, C)
  __nv_bfloat16* out;        // (B, N, C)
  float* m1;                 // K7: (B, N, C)
  float* e2;                 // K7: (B, N, C)
  float* lse;                // K7: (B, heads, N)
  const float* stats;        // K3: (B, 4, C): mean_fc, rstd_fc, mean_fcs,
                             // rstd_fcs
  const __nv_bfloat16* wf;   // K3: (heads, 64, 64) as (in, out)
  const float* fb;           // K3: (heads, 64)
  int n, m, channels;
};

// Shared memory: the Q (K3: fc) tile, K3's Wf_h tile, then kMmaStages x
// (K, V) tiles.
template <bool kPrologue>
constexpr size_t mhada_mma_fwd_smem_bytes() {
  return (1 + kPrologue + 2 * kMmaStages) * mma::kMmaTileBytes;
}

template <bool kPrologue, bool kRes>
__global__ void __launch_bounds__(kMmaThreads)
    mhada_mma_fwd_kernel(MhadaMmaArgs a) {
  using namespace mma;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ws = qs + kMmaTileElems;              // K3: Wf_h
  __nv_bfloat16* ring = ws + (kPrologue ? kMmaTileElems : 0);

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
  if (kPrologue)
    load_tile_async<kMmaThreads>(ws, a.wf + hoff * 64, 64, 0, 64);
#pragma unroll
  for (int s = 0; s < kMmaStages - 1; ++s) {
    if (s < ntiles) load_kv(s);
    cp_async_commit();
  }
  cp_async_wait<0>();   // Q (K3: fc and Wf_h) and the first K/V tile
  __syncthreads();

  uint32_t qf[4][4];
  if constexpr (kPrologue) {
    // qn = (fc - mean_fc) * rstd_fc in float32, rounded to bf16 in place.
    // Rows past N (zero-filled) give finite rows that are never stored.
    const float* mean = a.stats + b * 4 * C + hoff;
    const float* rstd = mean + C;
#pragma unroll
    for (int j = 0; j < 64 * 8 / kMmaThreads; ++j) {
      const int i = threadIdx.x + j * kMmaThreads;
      const int r = i / 8, c = (i % 8) * 8;
      uint4* p = reinterpret_cast<uint4*>(qs + r * kMmaStride + c);
      uint4 chunk = *p;
      __nv_bfloat162* x = reinterpret_cast<__nv_bfloat162*>(&chunk);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 raw = __bfloat1622float2(x[e]);
        const int ch = c + 2 * e;
        x[e] = __floats2bfloat162_rn((raw.x - mean[ch]) * rstd[ch],
                                     (raw.y - mean[ch + 1]) * rstd[ch + 1]);
      }
      *p = chunk;
    }
    __syncthreads();
    // q = qn Wf_h + fb_h in float32, rounded to bf16 into Q's A fragments.
    uint32_t xf[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      ldmatrix_x4(xf[kk], a_addr(qs, warp * 16, kk * 16));
    float acc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, bt_addr(ws, kk * 16, p * 16));
        mma_16816(acc[2 * p], xf[kk], r[0], r[1]);
        mma_16816(acc[2 * p + 1], xf[kk], r[2], r[3]);
      }
#pragma unroll
    for (int n = 0; n < 8; ++n) {   // columns 8 n + 2 t and 8 n + 2 t + 1
      const float2 bias =
          *reinterpret_cast<const float2*>(a.fb + hoff + 8 * n + 2 * t);
      acc[n][0] += bias.x;
      acc[n][1] += bias.y;
      acc[n][2] += bias.x;
      acc[n][3] += bias.y;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      acc_to_a(qf[kk], acc[2 * kk], acc[2 * kk + 1]);
  } else {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      ldmatrix_x4(qf[kk], a_addr(qs, warp * 16, kk * 16));
  }

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
      float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(a.f + o + 8 * n));
      if constexpr (kPrologue) {   // IN(fcs) from raw fcs and the stats
        const float* mean_f =
            a.stats + b * 4 * C + 2 * C + hoff + 8 * n + 2 * t;
        const float* rstd_f = mean_f + C;
        f.x = (f.x - mean_f[0]) * rstd_f[0];
        f.y = (f.y - mean_f[1]) * rstd_f[1];
      }
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

template <bool kPrologue, bool kRes>
cudaError_t launch_mhada_mma_fwd(const MhadaMmaArgs& a, int heads, int batch,
                                 cudaStream_t stream) {
  const dim3 grid((a.n + kMmaRows - 1) / kMmaRows, heads, batch);
  return launch_with_smem(mhada_mma_fwd_kernel<kPrologue, kRes>, grid,
                          dim3(kMmaThreads),
                          mhada_mma_fwd_smem_bytes<kPrologue>(), stream, a);
}

}  // namespace mhada
