// The attention tiles split over the keys: the layout of the float32
// partials that each split's block writes, and the kernel that combines
// them.
//
// Part of the bf16 attention tile (attention_wgmma.cuh: K1, K6's forward and
// K1's cross form, the counterparts of mhada_tpu/ops/attention_pallas.py's
// _tm_kernel, _tm_res_kernel, _attention_pallas_call and _attn_stream_fwd_impl,
// pallas_calls at attention_pallas.py:154, :236, :62 and :488) and of K1's
// cross form at float32 (mhada_f32_tile.cuh).  The TPU kernels walk every key
// of a query block in one program; on the H100 a grid of (query blocks x heads
// x batch) blocks of one key walk each leaves most SMs idle at the
// sequence-parallel shapes (32 blocks of 132 at 1024 queries, f32), so each
// (b, h, query block) takes `splits` blocks, split s walking key tiles
// [s T / splits, (s + 1) T / splits) of the T = ceil(M / 64).  Each writes,
// for its rows,
//
//   m_s = the row maximum of the scaled logits, in log2 units
//   l_s = sum_k 2^(x_k - m_s)          (x: scaled logits in log2 units)
//   O_s = sum_k 2^(x_k - m_s) v_k      unnormalised, float32
//
// and attention_combine_kernel forms, in a fixed order over s (no atomics:
// the output is deterministic),
//
//   m = max_s m_s,  w_s = 2^(m_s - m),  out = sum_s w_s O_s / sum_s w_s l_s
//
// rounded once to the output's type, and, where the caller asks for it (K6's
// forward), the row log-sum-exp in natural-log units,
//
//   lse = m ln 2 + log sum_s w_s l_s
//
// Every split holds at least one key tile with a key below M, so every m_s
// is finite and l_s >= 1.
//
// Bound: the combine reads splits (C + 2 heads) floats a row and writes C
// values: bytes, a few microseconds at the path's shapes (8 MB of
// partials at 1024 x 4096 with 4 splits, mostly still in L2).  One thread
// takes 4 channels of one row: float4 loads of each O_s, the row's m_s and
// l_s broadcast within the 16 threads of a head.
#pragma once

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace mhada {
namespace xsplit {

// The partials of `splits` splits of a (batch, n, channels) output with
// `heads` heads of 64, one float32 buffer: O (splits, B, N, C), then m
// (splits, B, heads, N), then l (splits, B, heads, N).
struct Partials {
  float* base;
  int splits, batch, n, channels, heads;
  __host__ __device__ float* o(int s, long long b, int row) const {
    return base + ((s * (long long)batch + b) * n + row) * channels;
  }
  __host__ __device__ long long stat(int s, long long b, int h,
                                     int row) const {
    return ((s * (long long)batch + b) * heads + h) * n + row;
  }
  __host__ __device__ float* m() const {
    return base + (long long)splits * batch * n * channels;
  }
  __host__ __device__ float* l() const {
    return m() + (long long)splits * batch * heads * n;
  }
};

// Floats of the partials buffer (the wrapper allocates it).
inline long long partial_floats(int splits, int batch, int n, int channels,
                                int heads) {
  return (long long)splits * batch * n * (channels + 2LL * heads);
}

// Key tiles [first, last) of split s of `splits` over `tiles`.
__host__ __device__ inline int split_first(int s, int splits, int tiles) {
  return (int)((long long)s * tiles / splits);
}

constexpr int kCombineThreads = 256;
constexpr float kCombineLn2 = 0.6931471805599453f;

// out (B, N, C) in T from the partials; thread: 4 channels of one row.
// lse: null, or (B, heads, N) float32, written by the thread that holds a
// head's first four channels.
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
    attention_combine_kernel(Partials p, T* out, float* lse) {
  const int quads = p.channels / 4;
  const long long i = blockIdx.x * (long long)kCombineThreads + threadIdx.x;
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
  float l = 0.f;
  float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < p.splits; ++s) {
    const float w = exp2f(ms[p.stat(s, b, h, row)] - mx);
    const float4 x = *reinterpret_cast<const float4*>(p.o(s, b, row) + ch);
    l = fmaf(w, ls[p.stat(s, b, h, row)], l);
    o.x = fmaf(w, x.x, o.x);
    o.y = fmaf(w, x.y, o.y);
    o.z = fmaf(w, x.z, o.z);
    o.w = fmaf(w, x.w, o.w);
  }
  T* dst = out + row_all * p.channels + ch;
  dst[0] = from_f32<T>(o.x / l);
  dst[1] = from_f32<T>(o.y / l);
  dst[2] = from_f32<T>(o.z / l);
  dst[3] = from_f32<T>(o.w / l);
  if (lse != nullptr && ch % 64 == 0)
    lse[(b * p.heads + h) * p.n + row] = mx * kCombineLn2 + logf(l);
}

template <typename T>
cudaError_t launch_combine(const Partials& p, void* out, cudaStream_t stream,
                           float* lse = nullptr) {
  const long long threads = (long long)p.batch * p.n * (p.channels / 4);
  const long long blocks = (threads + kCombineThreads - 1) / kCombineThreads;
  attention_combine_kernel<T><<<(unsigned)blocks, kCombineThreads, 0,
                                stream>>>(p, static_cast<T*>(out), lse);
  return cudaGetLastError();
}

}  // namespace xsplit
}  // namespace mhada
