// The fused prologue and epilogue of K3's CUDA-core tile
// (mhada_prologue.cu, float32), shared with the probe P2
// (mhada_prologue_pipe.cu, both dtypes), which computes the same function
// with another key loop.  Per head h, with the float32 per-channel stats
// [mean_fc, rstd_fc, mean_fcs, rstd_fcs] of batch b:
//
//   qn  = (fc - mean_fc) * rstd_fc               float32, rounded to T
//   q   = qn Wf_h + fb_h                         float32, rounded to T
//   out = sqrt(max(E2 - M1^2, 1e-6)) * (fcs - mean_fcs) * rstd_fcs + M1
#pragma once

#include "flash_tile.cuh"

namespace mhada {

// Q^T of the block's 64 query rows into qs: Wf_h staged in wfs (64 x 64
// float32), qn^T in qn_t (a [d][kTPad] buffer free until the key loop).
// Ends without a barrier after the Q^T writes.
template <typename T>
__device__ __forceinline__ void prologue_queries(
    const FlashArgs& a, const float* __restrict__ stats,
    const T* __restrict__ wf, const float* __restrict__ fb, int channels,
    float* qn_t, float* wfs, float* qs) {
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * kBQ;
  const int hoff = blockIdx.y * kHeadDim;
  const long long b = blockIdx.z;
  const float* mean_fc = stats + b * 4 * channels + hoff;
  const float* rstd_fc = mean_fc + channels;

  const T* w = wf + (long long)blockIdx.y * kHeadDim * kHeadDim;
  for (int idx = tid; idx < kHeadDim * kHeadDim; idx += kFlashThreads)
    wfs[idx] = to_f32(w[idx]);
  const T* fc = static_cast<const T*>(a.q);
  for (int idx = tid; idx < kBQ * kHeadDim; idx += kFlashThreads) {
    const int r = idx / kHeadDim, d = idx % kHeadDim;
    const int row = q0 + r;
    float x = 0.f;
    if (row < a.n) {
      const float raw = to_f32(fc[b * a.q_bs + row * a.q_rs + hoff + d]);
      x = round_to<T>((raw - mean_fc[d]) * rstd_fc[d]);
    }
    qn_t[d * kTPad + r] = x;
  }
  __syncthreads();

  // q = qn Wf_h + fb_h: this thread's rows ty + 16 i, outputs tx + 16 j.
  float qa[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) qa[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < kHeadDim; ++d) {
    float xv[4], wv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) xv[i] = qn_t[d * kTPad + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < 4; ++j) wv[j] = wfs[d * kHeadDim + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) qa[i][j] = fmaf(xv[i], wv[j], qa[i][j]);
  }
  const float* fbh = fb + hoff;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = tx + 16 * j;
      qs[e * kTPad + ty + 16 * i] = round_to<T>(qa[i][j] + fbh[e]);
    }
}

// The output rows from the finished accumulators, with IN(fcs) from raw
// fcs (a.f) and the stats.
template <typename T>
__device__ __forceinline__ void prologue_epilogue(
    const FlashArgs& a, const float* __restrict__ stats, int channels,
    const FlashAcc& acc) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = blockIdx.x * kBQ;
  const int hoff = blockIdx.y * kHeadDim;
  const long long b = blockIdx.z;
  const float* mean_fcs = stats + b * 4 * channels + 2 * channels + hoff;
  const float* rstd_fcs = mean_fcs + channels;
  const T* fcs = static_cast<const T*>(a.f);
  T* out = static_cast<T*>(a.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= a.n) continue;
    const float inv = 1.f / acc.lrow[i];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int d = tx + 16 * j;
      const float m1 = acc.o1[i][j] * inv;
      // E2 - M1^2 cancels: both stay float32 until the clamp.
      const float e2 = acc.o2[i][j] * inv;
      const float sd = sqrtf(fmaxf(e2 - m1 * m1, 1e-6f));
      const float raw = to_f32(fcs[b * a.f_bs + row * a.f_rs + hoff + d]);
      const float fn = (raw - mean_fcs[d]) * rstd_fcs[d];
      out[b * a.o_bs + row * a.o_rs + hoff + d] = from_f32<T>(sd * fn + m1);
    }
  }
}

// K3's and P2's arguments: fc, fcs and out (B, N, C), k and v (B, M, C).
inline FlashArgs prologue_args(const void* fc, const void* fcs,
                               const void* k, const void* v, void* out,
                               int n, int m, int channels) {
  FlashArgs a{};
  a.q = fc;
  a.k = k;
  a.v = v;
  a.f = fcs;
  a.out = out;
  a.n = n;
  a.m = m;
  a.q_bs = a.f_bs = a.o_bs = (long long)n * channels;
  a.kv_bs = (long long)m * channels;
  a.q_rs = a.kv_rs = a.f_rs = a.o_rs = channels;
  a.scale = 1.f;
  return a;
}

}  // namespace mhada
