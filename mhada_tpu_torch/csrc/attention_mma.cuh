// The bf16 ViT self-attention forward on the tensor cores: K1 (kRes =
// false) and K6's forward (kRes = true, also writing the row log-sum-exp).
//
// Replaces, at bf16, mhada_tpu/ops/attention_pallas.py::_tm_kernel
// (attention_pallas_tm, pallas_call at attention_pallas.py:154) and
// _tm_res_kernel (_attn_tm_fwd_impl, pallas_call at :236); through K1 and
// K6 also the TPU's K9 and K12 forwards.  Per (batch b, head h):
// out = softmax(scale Q K^T) V with Q, K and V read in place from the
// (B, L, 3C) qkv at channel offsets h*64, C + h*64 and 2C + h*64; out is
// (B, L, C) and lse (B, heads, L) float32 in natural-log units.
//
// Bound: 4 L^2 d flops per head (34.4 GFLOP at L = 4096, 8 heads) against
// 2 L (3C + C) bytes: compute-bound at the bf16 tensor-core rate.
//
// Design.  A block of 4 warps owns 64 queries of one (b, h), 16 rows a warp,
// and streams the keys in tiles of 64:
// - Q's tile is copied once to shared memory and each warp keeps its A
//   fragments (16 x 64) in registers, loaded by ldmatrix;
// - K and V tiles (64 keys x 64 channels, 9 KB each with 144-byte rows) go
//   through a two-stage cp.async ring, so the next tile loads while this one
//   is multiplied; rows past L are zero-filled by the copy;
// - S = Q K^T is 8 n-tiles x 4 k-steps of mma.sync m16n8k16 per warp, in
//   float32; `scale` (times log2 e, for exp2f) is applied to the float32
//   scores, as the JAX kernel applies it after its product (Q is not
//   pre-scaled in bf16); keys >= L are masked to -inf;
// - the online softmax runs on the accumulator fragments: a thread holds
//   rows g and g+8 of its warp, the row max reduces over the quad, the row
//   sum stays per thread until the epilogue;
// - P is rounded to bf16 in registers as the A fragment of P V, as the JAX
//   kernel rounds it (p.astype(v.dtype), attention_pallas.py:114, 197); the
//   row sum takes P before rounding, as the JAX denominator does; V's B
//   fragments come through ldmatrix.trans; O accumulates in float32.
// - epilogue: O / l rounded to bf16 for rows < L, and (kRes) one lane a
//   quad writes lse = m + log(l) for its two rows.
#pragma once

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "flash_mma.cuh"

namespace mhada {

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMmaRows = 16 * kMmaWarps;   // rows of a block: 64
constexpr int kMmaStages = 2;              // depth of the cp.async rings
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct AttnMmaArgs {
  const __nv_bfloat16* qkv;   // (B, L, 3C)
  const __nv_bfloat16* g;     // backward: dO (B, L, C)
  const float* lse_in;        // backward: (B, heads, L)
  const float* delta;         // backward: (B, heads, L)
  __nv_bfloat16* out;         // forward: (B, L, C); backward: d qkv
  float* lse;                 // K6's forward: (B, heads, L)
  int seq, channels;
  float scale;
};

// Fill the bf16 kernels' arguments (g: the backward's dO, else unused) ->
// false unless the pointers are 16-byte aligned and channels a multiple of
// 8, as the 16-byte copies of the rows need.
inline bool make_mma_args(AttnMmaArgs& a, const void* qkv, const void* g,
                          void* out, int seq, int channels, float scale) {
  if (((uintptr_t)qkv | (uintptr_t)g | (uintptr_t)out) % 16 || channels % 8)
    return false;
  a.qkv = static_cast<const __nv_bfloat16*>(qkv);
  a.g = static_cast<const __nv_bfloat16*>(g);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.seq = seq;
  a.channels = channels;
  a.scale = scale;
  return true;
}

// Q tile + kMmaStages x (K, V) tiles.
constexpr size_t kMmaFwdSmemBytes = (1 + 2 * kMmaStages) * mma::kMmaTileBytes;

template <bool kRes>
__global__ void __launch_bounds__(kMmaThreads)
    attention_mma_fwd_kernel(AttnMmaArgs a) {
  using namespace mma;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ring = qs + kMmaTileElems;   // stage s: K, then V

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * kMmaRows;
  const int L = a.seq, C = a.channels;
  const long long rs = 3LL * C, b = blockIdx.z;
  const __nv_bfloat16* qb = a.qkv + b * L * rs + blockIdx.y * 64;
  const __nv_bfloat16* kb = qb + C;
  const __nv_bfloat16* vb = qb + 2 * C;
  const int ntiles = (L + 63) / 64;

  auto load_kv = [&](int tile) {
    __nv_bfloat16* st = ring + (tile % kMmaStages) * 2 * kMmaTileElems;
    load_tile_async<kMmaThreads>(st, kb, rs, tile * 64, L);
    load_tile_async<kMmaThreads>(st + kMmaTileElems, vb, rs, tile * 64, L);
  };
  load_tile_async<kMmaThreads>(qs, qb, rs, q0, L);
#pragma unroll
  for (int s = 0; s < kMmaStages - 1; ++s) {
    if (s < ntiles) load_kv(s);
    cp_async_commit();
  }

  const float sl2 = a.scale * kLog2e;
  uint32_t qf[4][4];
  float o[8][4];
  float mrow[2] = {-INFINITY, -INFINITY}, lrow[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    cp_async_wait<kMmaStages - 2>();   // tile j (and Q) landed
    __syncthreads();                   // ... for every thread; stage j-1 free
    if (j + kMmaStages - 1 < ntiles) load_kv(j + kMmaStages - 1);
    cp_async_commit();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        ldmatrix_x4(qf[kk], a_addr(qs, warp * 16, kk * 16));
    }
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
    const bool ragged = 64 * (j + 1) > L;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * sl2;
        if (ragged && 64 * j + 8 * n + 2 * t + (e % 2) >= L) x = -INFINITY;
        s[n][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // finite: key 64 j < L is in every tile
      const float m_new = fmaxf(mrow[r], quad_max(mx[r]));
      const float alpha = exp2f(mrow[r] - m_new);
      mrow[r] = m_new;
      lrow[r] *= alpha;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        o[n][2 * r] *= alpha;
        o[n][2 * r + 1] *= alpha;
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

    // O += P V: P's k-step kk is keys 16 kk..16 kk + 15.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[4];
      acc_to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, bt_addr(vs, kk * 16, p * 16));
        mma_16816(o[2 * p], pa, r[0], r[1]);
        mma_16816(o[2 * p + 1], pa, r[2], r[3]);
      }
    }
  }

  const int h = blockIdx.y;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    const float l = quad_sum(lrow[r]);
    if (row >= L) continue;
    __nv_bfloat16* orow = a.out + (b * L + row) * C + h * 64 + 2 * t;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      *reinterpret_cast<uint32_t*>(orow + 8 * n) =
          pack_bf16(o[n][2 * r] / l, o[n][2 * r + 1] / l);
    if (kRes && t == 0)
      a.lse[(b * gridDim.y + h) * L + row] = mrow[r] * kLn2 + logf(l);
  }
}

template <bool kRes>
cudaError_t launch_attention_mma_fwd(const AttnMmaArgs& a, int heads,
                                     int batch, cudaStream_t stream) {
  const dim3 grid((a.seq + kMmaRows - 1) / kMmaRows, heads, batch);
  return launch_with_smem(attention_mma_fwd_kernel<kRes>, grid,
                          dim3(kMmaThreads), kMmaFwdSmemBytes, stream, a);
}

}  // namespace mhada
