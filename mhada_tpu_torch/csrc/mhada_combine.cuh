// K3, K4 and K7's forward at bf16 split over the keys: the layout of the
// float32 partials that each split's block of the MHAda tile writes, and
// the kernel that combines them and applies the MHAda epilogue (K7: also
// writing M1, E2 and the row lse = ln 2 max_s m_s + log L, the formula of
// attention_combine.cuh).
//
// Part of the redesign of mhada_prologue.cu::mhada_mhada_prologue (K3, the
// counterpart of mhada_tpu/ops/mhada_pallas.py::mhada_fused_prologue,
// pallas_call at mhada_pallas.py:239) and mhada_fwd.cu::mhada_mhada_fwd (K4,
// _mhada_pallas_fwd_impl, pallas_call at :114).  The TPU kernels walk every
// key of a query block in one program; on the H100 a grid of (query blocks
// x heads x batch) blocks of the MHAda tile (mhada_wgmma.cuh: 192 queries,
// one block an SM) leaves SMs idle at the B = 1 shapes (176 blocks on 132
// SMs at 512^2: a second wave a third full), so each (b, h, query block)
// takes `splits` blocks, split s walking key tiles [s T / splits, (s + 1) T
// / splits) of the T = ceil(M / 64) (attention_combine.cuh's split_first).
// Each writes, for its rows,
//
//   m_s  = the row maximum of the logits, in log2 units
//   l_s  = sum_k 2^(x_k - m_s)              (x: logits in log2 units)
//   O1_s = sum_k p_k v_k,  O2_s = sum_k p_k v_k^2    unnormalised, float32
//
// with p_k = 2^(x_k - m_s) rounded to bf16 against the split's own running
// maximum and v^2 each bf16 squared and rounded, and
// mhada_combine_kernel forms, in a fixed order over s (no atomics: the
// output is deterministic),
//
//   m = max_s m_s,  w_s = 2^(m_s - m),  L = sum_s w_s l_s
//   M1 = sum_s w_s O1_s / L,  E2 = sum_s w_s O2_s / L
//   out = sqrt(max(E2 - M1^2, 1e-6)) * f + M1       rounded once to bf16
//   K7: M1, E2 and lse = m ln 2 + log L            float32
//
// f = IN(fcs) from raw fcs and the stats (K3) or fcs_n (K4, K7).  E2 - M1^2
// cancels, so every sum stays float32 until the clamp.  The buffer is
// attention_combine.cuh's Partials with channels = 2 C: [O1 | O2] a row,
// head h's O1 at h*64 and its O2 at C + h*64.
//
// Bound: the combine reads splits (2 C + 2 heads) floats and C bf16 values
// of f a row and writes C: bytes, a few microseconds at the path's shapes
// (25 MB of partials at 512^2 with 3 splits, mostly still in L2).  One
// thread takes 4 channels of one row.
#pragma once

#include <math.h>
#include <stdint.h>

#include "attention_combine.cuh"
#include "common.cuh"

namespace mhada {
namespace wg {

// out (B, N, C) bf16 from the partials (p.channels = 2 C); f (B, N, C):
// K3 raw fcs, normalised with stats (B, 4, C) rows 2 and 3; K4 and K7
// fcs_n.  K7's forward also takes the residuals: m1, e2 (B, N, C) and lse
// (B, heads, N), float32 (null for K3 and K4), the lse written by the
// thread that holds a head's first four channels.
template <bool kPrologue>
__global__ void __launch_bounds__(xsplit::kCombineThreads)
    mhada_combine_kernel(xsplit::Partials p, const __nv_bfloat16* f,
                         const float* stats, __nv_bfloat16* out, float* m1s,
                         float* e2s, float* lse) {
  const int C = p.channels / 2, quads = C / 4;
  const long long i =
      blockIdx.x * (long long)xsplit::kCombineThreads + threadIdx.x;
  if (i >= (long long)p.batch * p.n * quads) return;
  const int ch = 4 * (int)(i % quads);
  const long long row_all = i / quads;
  const int row = (int)(row_all % p.n);
  const long long b = row_all / p.n;
  const int h = ch / 64;
  const float* ms = p.m();
  const float* ls = p.l();
  float mx = -INFINITY;
  for (int s = 0; s < p.splits; ++s)
    mx = fmaxf(mx, ms[p.stat(s, b, h, row)]);
  float l = 0.f, o1[4] = {0.f, 0.f, 0.f, 0.f}, o2[4] = {0.f, 0.f, 0.f, 0.f};
  for (int s = 0; s < p.splits; ++s) {
    const float w = exp2f(ms[p.stat(s, b, h, row)] - mx);
    const float* o = p.o(s, b, row);
    const float4 x1 = *reinterpret_cast<const float4*>(o + ch);
    const float4 x2 = *reinterpret_cast<const float4*>(o + C + ch);
    l = fmaf(w, ls[p.stat(s, b, h, row)], l);
    o1[0] = fmaf(w, x1.x, o1[0]);
    o1[1] = fmaf(w, x1.y, o1[1]);
    o1[2] = fmaf(w, x1.z, o1[2]);
    o1[3] = fmaf(w, x1.w, o1[3]);
    o2[0] = fmaf(w, x2.x, o2[0]);
    o2[1] = fmaf(w, x2.y, o2[1]);
    o2[2] = fmaf(w, x2.z, o2[2]);
    o2[3] = fmaf(w, x2.w, o2[3]);
  }
  const long long at = row_all * C + ch;
  const uint2 raw = *reinterpret_cast<const uint2*>(f + at);
  const __nv_bfloat162* fx = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 f01 = __bfloat1622float2(fx[0]), f23 = __bfloat1622float2(fx[1]);
  float fv[4] = {f01.x, f01.y, f23.x, f23.y};
  if (kPrologue) {   // IN(fcs) from raw fcs and the stats
    const float* mean = stats + b * 4 * C + 2 * C + ch;
    const float* rstd = mean + C;
#pragma unroll
    for (int e = 0; e < 4; ++e) fv[e] = (fv[e] - mean[e]) * rstd[e];
  }
  float res[4], m1[4], e2[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    m1[e] = o1[e] / l;
    e2[e] = o2[e] / l;
    // E2 - M1^2 cancels: both stay float32 until the clamp.
    res[e] = sqrtf(fmaxf(e2[e] - m1[e] * m1[e], 1e-6f)) * fv[e] + m1[e];
  }
  if (m1s != nullptr) {
    *reinterpret_cast<float4*>(m1s + at) =
        make_float4(m1[0], m1[1], m1[2], m1[3]);
    *reinterpret_cast<float4*>(e2s + at) =
        make_float4(e2[0], e2[1], e2[2], e2[3]);
    if (ch % 64 == 0)
      lse[(b * p.heads + h) * p.n + row] = mx * xsplit::kCombineLn2 + logf(l);
  }
  uint2 packed;
  __nv_bfloat162* px = reinterpret_cast<__nv_bfloat162*>(&packed);
  px[0] = __floats2bfloat162_rn(res[0], res[1]);
  px[1] = __floats2bfloat162_rn(res[2], res[3]);
  *reinterpret_cast<uint2*>(out + at) = packed;
}

template <bool kPrologue>
cudaError_t launch_mhada_combine(const xsplit::Partials& p,
                                 const __nv_bfloat16* f, const float* stats,
                                 __nv_bfloat16* out, float* m1, float* e2,
                                 float* lse, cudaStream_t stream) {
  const long long threads = (long long)p.batch * p.n * (p.channels / 8);
  const long long blocks =
      (threads + xsplit::kCombineThreads - 1) / xsplit::kCombineThreads;
  mhada_combine_kernel<kPrologue>
      <<<(unsigned)blocks, xsplit::kCombineThreads, 0, stream>>>(
          p, f, stats, out, m1, e2, lse);
  return cudaGetLastError();
}

}  // namespace wg
}  // namespace mhada
