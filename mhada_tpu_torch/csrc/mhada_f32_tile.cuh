// The float32 MHAda tile on the CUDA cores: K4's float32 build
// (mhada_fwd.cu), K3's with the instance norm and the Q projection fused in
// (mhada_prologue.cu), and the probe P2's float32 build
// (mhada_prologue_pipe.cu: K3's block with a one-stage ring).  Per head h:
//
//   A   = softmax(q k^T)                       UNSCALED
//   M1  = A V,  E2 = A V^2                     float32
//   out = sqrt(max(E2 - M1^2, 1e-6)) * f + M1  the clamp in float32
//
// with q given and f = IN(fcs) given (K4), or q = IN(fc) Wf_h + fb_h and f
// = IN(fcs) formed from raw fc, fcs and the float32 stats
// [mean_fc, rstd_fc, mean_fcs, rstd_fcs] (K3).  Everything is float32 FMAs
// on the CUDA cores: no TF32, no tensor-core instruction.
//
// What bounds it on the card: 6 N M d flops per head (51.5 GFLOP at N = M
// = 4096, 8 heads) against (3 N + 2 M) C float32 reads and writes, so the
// float32 FMA rate.  The design keeps the FMA pipe fed:
//
// - One block owns (batch b, head h, kBQ = 128 queries) and 256 threads: a
//   16 x 16 grid (ty, tx).  A thread owns query rows 4 ty + r and 64 + 4 ty
//   + r (r < 4), score keys tx + 16 j (j < 4) of each key tile and output
//   channels 4 tx + j, so a row's 16 threads are one half-warp: the row max
//   reduces by xor shuffles inside it, and the row sum is kept per thread
//   and reduced once, in the epilogue.
// - Register tiling with 128-bit shared loads.  Q^T (d-major) stays in
//   shared memory for the whole key loop; K lies key-major as it is copied,
//   its rows padded by 16 bytes.  Four d-steps of Q K^T take 8 LDS.128 of
//   Q^T (broadcast in each half-warp) and 4 of K (conflict-free: the padded
//   rows tx + 16 j fall in distinct bank quads) for 128 FFMA; each key of
//   P [V | V^2] takes 2 LDS.128 of P^T and one each of V and V^2 for 64
//   FFMA.  V^2 is formed once a tile into its own buffer.
// - K and V tiles arrive by 16-byte cp.async (L2 only; keys past M
//   zero-filled by the copy) into a ring of kStages stages: with two
//   (kRingStages), tile t + 1 lands while tile t is computed.
// - The softmax: the exponent is one FFMA in log2 units and one
//   ex2.approx.ftz (relative error ~2^-22); only a ragged last tile is
//   masked; the accumulators are rescaled only when some row maximum of
//   the warp moved (a warp vote).
// - 147 KB of shared memory with two stages (Q^T 32 KB, P^T 33 KB, V^2
//   16 KB, 33 KB a stage) and ~170 registers a thread (the 64 accumulators,
//   32 scores and the operands; a second block an SM would need <= 128):
//   one block an SM.  At B = 1, N = 4096 and 8 heads that is 256 blocks,
//   1.94 waves of 132 SMs.  The score loop is unrolled whole and P V
//   eight keys at a time, which ptxas schedules better (3-4 % on an H100).
//
// K3's prologue reuses buffers that are free until the first key tile:
// Wf_h is staged in the V^2 buffer and IN(fc)^T in the P^T buffer; the
// projection is register-tiled like the scores.  Neither q nor IN(fcs)
// reaches device memory.  Pointers must be 16-byte aligned and channels a
// multiple of 4 (f32_aligned).  Offsets of batch and row are formed in 64
// bits; the key loop has no length cap (M = 16384 at 1024^2).
#pragma once

#include <math.h>
#include <stdint.h>

#include <initializer_list>

#include "common.cuh"
#include "flash_mma.cuh"  // mma::cp_async_16 / _commit / _wait, smem_addr

namespace mhada {
namespace f32t {

constexpr int kD = 64;        // head dim
constexpr int kBQ = 128;      // queries per block
constexpr int kBK = 64;       // keys per tile
constexpr int kThreads = 256;
constexpr int kQS = kBQ;      // row stride of Q^T [d][query]
constexpr int kKS = kD + 4;   // padded row stride of K [key][d]
constexpr int kPS = kBQ + 4;  // padded row stride of P^T [key][query]
constexpr int kStageFloats = kBK * (kKS + kD);  // K, then V [key][d]
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of a block with a ring of `stages` key tiles.
constexpr size_t smem_bytes(int stages) {
  return sizeof(float) *
         (kD * kQS + kBK * kPS + kBK * kD + stages * kStageFloats);
}

// True when every pointer is 16-byte aligned and channels is a multiple of
// 4, as the 16-byte loads and copies of the rows need.
inline bool f32_aligned(std::initializer_list<const void*> ptrs,
                        int channels) {
  uintptr_t any = 0;
  for (const void* p : ptrs) any |= reinterpret_cast<uintptr_t>(p);
  return any % 16 == 0 && channels % 4 == 0;
}

struct F32Args {
  const float* q;  // K4: q; K3: raw fc            (B, N, C)
  const float* k;  //                               (B, M, C)
  const float* v;
  const float* f;  // K4: IN(fcs); K3: raw fcs     (B, N, C)
  float* out;      //                               (B, N, C)
  const float* stats;  // K3 only: (B, 4, C)
  const float* wf;     // K3 only: (H, 64, 64) as (in, out)
  const float* fb;     // K3 only: (H, 64)
  int n, m, channels;
};

// One thread's accumulators: sum_k p V (o1) and sum_k p V^2 (o2) of its 8
// rows and 4 channels, the rows' running maxima (unscaled) and this
// thread's share of the rows' sums of p.
struct Acc {
  float o1[8][4], o2[8][4], mrow[8], lrow[8];
};

// The query row of a thread's row slot i (< 8).
__device__ __forceinline__ int row_of(int ty, int i) {
  return 4 * ty + (i & 3) + 64 * (i >> 2);
}

__device__ __forceinline__ float exp2_ftz(float x) {  // 2^-inf = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ float at(const float4& x, int i) {
  return i == 0 ? x.x : i == 1 ? x.y : i == 2 ? x.z : x.w;
}

// Issue the copies of key tile t (K and V of head h, from kv_base on)
// into `stage`; keys past a.m are zero-filled by the copies themselves.
// Thread (row c0, chunk ch) copies keys c0 + 16 r (r < 4) of the tile,
// channels ch .. ch + 3: the address steps are fixed, so each chunk costs a
// few integer instructions besides its cp.async.
__device__ __forceinline__ void issue_tile(const F32Args& a, int t,
                                           long long kv_base, float* stage) {
  const int c0 = threadIdx.x / (kD / 4), ch = 4 * (threadIdx.x % (kD / 4));
  const long long step = 16LL * a.channels;
  const long long off = kv_base + (long long)(t * kBK + c0) * a.channels + ch;
  const uint32_t ks = mma::smem_addr(stage + c0 * kKS + ch);
  const uint32_t vs = mma::smem_addr(stage + kBK * kKS + c0 * kD + ch);
#pragma unroll
  for (int r = 0; r < kBK / 16; ++r) {
    const bool valid = t * kBK + c0 + 16 * r < a.m;
    const long long o = valid ? off + r * step : kv_base + ch;
    mma::cp_async_16(ks + 4 * 16 * r * kKS, a.k + o, valid);
    mma::cp_async_16(vs + 4 * 16 * r * kD, a.v + o, valid);
  }
}

// The block's rows of token-major src (B, N, C), batch b, channels hoff ..
// hoff + 63, transposed into dst [d][query] at `stride`: op(d, x) of each
// 4 channels x from d on; rows past a.n are zero.  Lanes take consecutive
// rows, so the transposed stores do not conflict.
template <typename Op>
__device__ __forceinline__ void load_transposed(const F32Args& a,
                                                const float* src, int q0,
                                                long long b, int hoff,
                                                float* dst, int stride,
                                                Op op) {
  for (int idx = threadIdx.x; idx < kBQ * kD / 4; idx += kThreads) {
    const int r = idx % kBQ, ch = 4 * (idx / kBQ);
    const int row = q0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < a.n)
      x = op(ch, ld4(src + (b * a.n + row) * a.channels + hoff + ch));
    dst[(ch + 0) * stride + r] = x.x;
    dst[(ch + 1) * stride + r] = x.y;
    dst[(ch + 2) * stride + r] = x.z;
    dst[(ch + 3) * stride + r] = x.w;
  }
}

// (x - mean) * rstd per channel, from the stats rows at mean and mean + C.
__device__ __forceinline__ float4 normalise(float4 x, const float* mean,
                                            int channels) {
  const float4 mu = ld4(mean), rs = ld4(mean + channels);
  return make_float4((x.x - mu.x) * rs.x, (x.y - mu.y) * rs.y,
                     (x.z - mu.z) * rs.z, (x.w - mu.w) * rs.w);
}

// K3's prologue: q = IN(fc) Wf_h + fb_h of the block's rows into Q^T.
// IN(fc)^T goes through the P^T buffer and Wf_h through the V^2 buffer,
// both unused until the first key tile: the key loop's first barrier
// orders every read of them before their first writes there.
__device__ __forceinline__ void prologue_queries(const F32Args& a, int q0,
                                                 long long b, int hoff,
                                                 float* qs, float* qn_t,
                                                 float* wfs) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float* w = a.wf + (long long)blockIdx.y * kD * kD;
  for (int idx = threadIdx.x; idx < kD * kD / 4; idx += kThreads)
    st4(wfs + 4 * idx, ld4(w + 4 * idx));
  const float* mean_fc = a.stats + b * 4 * a.channels + hoff;
  load_transposed(a, a.q, q0, b, hoff, qn_t, kPS,
                  [&](int ch, float4 x) {
                    return normalise(x, mean_fc + ch, a.channels);
                  });
  __syncthreads();

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < kD; ++d) {
    const float4 xa = ld4(qn_t + d * kPS + 4 * ty);
    const float4 xb = ld4(qn_t + d * kPS + 64 + 4 * ty);
    const float4 wv = ld4(wfs + d * kD + 4 * tx);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[i][j] = fmaf(at(i < 4 ? xa : xb, i & 3), at(wv, j), acc[i][j]);
  }
  const float4 bias = ld4(a.fb + hoff + 4 * tx);
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int g = 0; g < 2; ++g)
      st4(qs + (4 * tx + j) * kQS + 64 * g + 4 * ty,
          make_float4(acc[4 * g][j] + at(bias, j),
                      acc[4 * g + 1][j] + at(bias, j),
                      acc[4 * g + 2][j] + at(bias, j),
                      acc[4 * g + 3][j] + at(bias, j)));
}

__device__ __forceinline__ void init(Acc& acc) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    acc.mrow[i] = -INFINITY;
    acc.lrow[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc.o1[i][j] = acc.o2[i][j] = 0.f;
  }
}

// This thread's scores of one key tile: s[i][j] = q(row_of(ty, i)) .
// k(tx + 16 j), summed over d in order.
__device__ __forceinline__ void scores(const float* qs, const float* ks,
                                       float (&s)[8][4]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float* qp = qs + 4 * ty;
  const float* kp = ks + tx * kKS;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll
  for (int d0 = 0; d0 < kD; d0 += 4) {
    float4 kv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) kv[j] = ld4(kp + 16 * j * kKS + d0);
#pragma unroll
    for (int dd = 0; dd < 4; ++dd) {
      const float4 qa = ld4(qp + (d0 + dd) * kQS);
      const float4 qb = ld4(qp + (d0 + dd) * kQS + 64);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s[i][j] = fmaf(at(i < 4 ? qa : qb, i & 3), at(kv[j], dd), s[i][j]);
    }
  }
}

// The online softmax of key tile t: keys past m are masked (kMask, the
// ragged last tile only), p = 2^(s log2 e - max log2 e) goes to P^T
// (key-major), the row maxima and this thread's sums move, and the
// accumulators are rescaled unless no row maximum of the warp moved.
template <bool kMask>
__device__ __forceinline__ void softmax(int t, int m, float (&s)[8][4],
                                        float* ps, Acc& acc) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  if (kMask) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (t * kBK + tx + 16 * j >= m) {
#pragma unroll
        for (int i = 0; i < 8; ++i) s[i][j] = -INFINITY;
      }
  }
  float alpha[8];
  bool moved = false;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
    for (int off = 1; off < 16; off <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    // finite: key t * kBK < m lies in every tile
    const float m_new = fmaxf(acc.mrow[i], mx);
    const bool up = m_new > acc.mrow[i];
    alpha[i] = up ? exp2_ftz((acc.mrow[i] - m_new) * kLog2e) : 1.f;
    moved |= up;
    acc.mrow[i] = m_new;
    const float mb = -m_new * kLog2e;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[i][j] = exp2_ftz(fmaf(s[i][j], kLog2e, mb));
      sum += s[i][j];
    }
    acc.lrow[i] = acc.lrow[i] * alpha[i] + sum;
  }
  if (__any_sync(0xffffffffu, moved)) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc.o1[i][j] *= alpha[i];
        acc.o2[i][j] *= alpha[i];
      }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int g = 0; g < 2; ++g)
      st4(ps + (tx + 16 * j) * kPS + 64 * g + 4 * ty,
          make_float4(s[4 * g][j], s[4 * g + 1][j], s[4 * g + 2][j],
                      s[4 * g + 3][j]));
}

// V^2 of the tile's V into v2s, once a tile.
__device__ __forceinline__ void square_v(const float* vs, float* v2s) {
#pragma unroll
  for (int r = 0; r < kBK * kD / 4 / kThreads; ++r) {
    const int idx = 4 * (threadIdx.x + r * kThreads);
    const float4 x = ld4(vs + idx);
    st4(v2s + idx, make_float4(x.x * x.x, x.y * x.y, x.z * x.z, x.w * x.w));
  }
}

// acc += P V and P V^2 over one key tile, keys in order.
__device__ __forceinline__ void pv(const float* ps, const float* vs,
                                   const float* v2s, Acc& acc) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float* pp = ps + 4 * ty;
#pragma unroll 8
  for (int c = 0; c < kBK; ++c) {
    const float4 pa = ld4(pp + c * kPS), pb = ld4(pp + c * kPS + 64);
    const float4 v = ld4(vs + c * kD + 4 * tx);
    const float4 w = ld4(v2s + c * kD + 4 * tx);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = at(i < 4 ? pa : pb, i & 3);
        acc.o1[i][j] = fmaf(p, at(v, j), acc.o1[i][j]);
        acc.o2[i][j] = fmaf(p, at(w, j), acc.o2[i][j]);
      }
  }
}

// The key loop over a ring of kStages stages.  On entry Q^T is written
// (the first barrier publishes it) and tiles 0 .. kStages - 2 are issued,
// one commit group each.
template <int kStages>
__device__ __forceinline__ void key_loop(const F32Args& a, long long kv_base,
                                         const float* qs, float* ps,
                                         float* v2s, float* ring, Acc& acc) {
  init(acc);
  const int tiles = (a.m + kBK - 1) / kBK;
  for (int t = 0; t < tiles; ++t) {
    float* stage = ring + (t % kStages) * kStageFloats;
    if (kStages == 1) {
      if (t > 0) __syncthreads();  // tile t - 1's reads are done
      issue_tile(a, t, kv_base, stage);
      mma::cp_async_commit();
    }
    // tile t has landed
    mma::cp_async_wait<(kStages > 1 ? kStages - 2 : 0)>();
    // Tile t, zero fill included, is visible; every read of tile t - 1,
    // of P^T and of V^2 is done.
    __syncthreads();
    if (kStages > 1) {
      const int next = t + kStages - 1;
      if (next < tiles)
        issue_tile(a, next, kv_base, ring + (next % kStages) * kStageFloats);
      mma::cp_async_commit();  // possibly empty: one group per iteration
    }
    const float* vs = stage + kBK * kKS;
    square_v(vs, v2s);
    float s[8][4];
    scores(qs, stage, s);
    if ((t + 1) * kBK > a.m)
      softmax<true>(t, a.m, s, ps, acc);
    else
      softmax<false>(t, a.m, s, ps, acc);
    __syncthreads();  // P^T and V^2 are visible
    pv(ps, vs, v2s, acc);
  }
}

// The output rows from the finished accumulators: f given (K4) or IN(fcs)
// from raw fcs and the stats (K3); 16-byte loads and stores.
template <bool kPrologue>
__device__ __forceinline__ void epilogue(const F32Args& a, int q0,
                                         long long b, int hoff,
                                         const Acc& acc) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int ch = hoff + 4 * tx;
  float inv[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float l = acc.lrow[i];
#pragma unroll
    for (int off = 1; off < 16; off <<= 1)
      l += __shfl_xor_sync(0xffffffffu, l, off);
    inv[i] = 1.f / l;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = q0 + row_of(ty, i);
    if (row >= a.n) continue;
    const long long o = (b * a.n + row) * a.channels + ch;
    float4 f = ld4(a.f + o);
    if (kPrologue)  // (fcs - mean_fcs) * rstd_fcs
      f = normalise(f, a.stats + (b * 4 + 2) * a.channels + ch, a.channels);
    float y[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float m1 = acc.o1[i][j] * inv[i];
      // E2 - M1^2 cancels: both stay float32 until the clamp.
      const float e2 = acc.o2[i][j] * inv[i];
      const float sd = sqrtf(fmaxf(e2 - m1 * m1, 1e-6f));
      y[j] = sd * at(f, j) + m1;
    }
    st4(a.out + o, make_float4(y[0], y[1], y[2], y[3]));
  }
}

// kPrologue = false: K4 (q and IN(fcs) given).  kPrologue = true: K3 (q
// and IN(fcs) formed from raw fc and fcs).  kStages: the ring's depth.
template <bool kPrologue, int kStages>
__global__ void __launch_bounds__(kThreads, 1) mhada_f32_kernel(F32Args a) {
  extern __shared__ float4 f32_smem[];
  float* qs = reinterpret_cast<float*>(f32_smem);  // [d][query]  Q^T
  float* ps = qs + kD * kQS;                       // [key][query] P^T
  float* v2s = ps + kBK * kPS;                     // [key][d]    V^2
  float* ring = v2s + kBK * kD;                    // stages: K, V
  const int q0 = blockIdx.x * kBQ;
  const int hoff = blockIdx.y * kD;
  const long long b = blockIdx.z;
  const long long kv_base = b * a.m * a.channels + hoff;

  // The first tiles fly while the queries are formed.
  const int tiles = (a.m + kBK - 1) / kBK;
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < tiles) issue_tile(a, t, kv_base, ring + t * kStageFloats);
    mma::cp_async_commit();
  }
  if (kPrologue)
    prologue_queries(a, q0, b, hoff, qs, ps, v2s);
  else
    load_transposed(a, a.q, q0, b, hoff, qs, kQS,
                    [](int, float4 x) { return x; });

  Acc acc;
  key_loop<kStages>(a, kv_base, qs, ps, v2s, ring, acc);
  epilogue<kPrologue>(a, q0, b, hoff, acc);
}

// The ring depth of K3 and K4.
constexpr int kRingStages = 2;

template <bool kPrologue, int kRing>
cudaError_t launch_mhada_f32(const F32Args& a, int heads, int batch,
                             cudaStream_t stream) {
  if (a.m < 1 || !f32_aligned({a.q, a.k, a.v, a.f, a.out}, a.channels) ||
      (kPrologue && !f32_aligned({a.stats, a.wf, a.fb}, a.channels)))
    return cudaErrorInvalidValue;
  const dim3 grid((a.n + kBQ - 1) / kBQ, heads, batch);
  return launch_with_smem(mhada_f32_kernel<kPrologue, kRing>, grid,
                          dim3(kThreads), smem_bytes(kRing), stream, a);
}

}  // namespace f32t
}  // namespace mhada
