// The float32 flash tile on the CUDA cores: one register-tiled,
// cp.async-pipelined block that computes two functions.
//
// The MHAda core (mhada_f32_kernel): K4's float32 build (mhada_fwd.cu),
// K3's with the instance norm and the Q projection fused in
// (mhada_prologue.cu), the probe P2's float32 build (mhada_prologue_pipe.cu:
// K3's block with a one-stage ring) and K7's training forward
// (mhada_train.cu; so also K10's forward with residuals), which also writes
// M1, E2 and the row lse.  Per head h:
//
//   A   = softmax(q k^T)                       UNSCALED
//   M1  = A V,  E2 = A V^2                     float32
//   out = sqrt(max(E2 - M1^2, 1e-6)) * f + M1  the clamp in float32
//
// with q given and f = IN(fcs) given (K4, K7), or q = IN(fc) Wf_h + fb_h
// and f = IN(fcs) formed from raw fc, fcs and the float32 stats
// [mean_fc, rstd_fc, mean_fcs, rstd_fcs] (K3).
//
// The scaled attention (attention_f32_kernel<lse, split>): K1's float32
// build (attention_fwd.cu; so K9's and K12's single pass, and K1's cross
// form, N queries against M keys of another tensor) and K6's forward
// (attention_train.cu; so K12's streaming forward), out = softmax(scale q
// k^T) V per head, self-attention from the packed (B, L, 3C) qkv, K6 also
// with the row lse of the scaled logits in natural-log units (what
// flash_bwd_f32.cuh reads).  <false, true> is K1's cross form split over
// the keys where its grid leaves SMs idle: each block walks one range of
// whole key tiles and writes float32 partials for attention_combine.cuh.
//
// Everything is float32 FMAs on the CUDA cores: no TF32, no tensor-core
// instruction.  What bounds it on the card: 6 N M d flops per head for
// MHAda and 4 N M d for attention (51.5 and 34.4 GFLOP at N = M = 4096, 8
// heads) against (3 N + 2 M) C and 4 L C float32 reads and writes, so the
// float32 FMA rate.  The design keeps the FMA pipe fed:
//
// - A block owns (batch b, head h, BQ queries); its threads form a (TY, TX)
//   grid (Geom).  The TX threads of a query row share it: a thread owns
//   R = 4 G rows 4 ty + r + 4 TY g (r < 4, g < G), the keys tx + TX j of
//   each key tile and the output channels 4 tx + 4 TX h + r (j < J, h <
//   J / 4), so the row max reduces by xor shuffles among a row's TX lanes
//   and the row sum is kept per thread and reduced once, in the epilogue.
//   MHAda: 128 queries, 256 threads, 8 x 4 a thread (MhadaGeom).
//   Attention: AttnGeom, 256 queries, 256 threads, 8 x 8 a thread.
// - Register tiling with 128-bit shared loads.  Q^T (d-major) stays in
//   shared memory for the whole key loop; K lies key-major as it is copied,
//   its rows padded by 16 bytes.  Four d-steps of Q K^T take 4 G LDS.128 of
//   Q^T (broadcast in each quarter-warp) and J of K (conflict-free: a
//   quarter-warp's padded rows fall in distinct bank quads) for 16 G J
//   FFMA; each key of P V takes G LDS.128 of P^T and J / 4 of V (MHAda: and
//   of V^2, formed once a tile into its own buffer) for 4 G J FFMA (MHAda:
//   twice that).  So MHAda runs 10.7 FFMA a load on the scores and 16 on P
//   [V | V^2]; attention, without V^2, gives each thread 8 keys and 8
//   channels instead of 4 to run 16 on both.
// - K and V tiles arrive by 16-byte cp.async (L2 only; keys past M
//   zero-filled by the copy) into a ring of kStages stages: with two
//   (kRingStages), tile t + 1 lands while tile t is computed.
// - The softmax: the exponent is one FFMA in log2 units and one
//   ex2.approx.ftz (relative error ~2^-22); only a ragged last tile is
//   masked; the accumulators are rescaled only when some row maximum of
//   the warp moved (a warp vote).  Attention's scale is folded into Q^T as
//   it is loaded (1/8 at d = 64: exact).
// - Shared memory (KB of 1024 bytes): MHAda 147 with two stages (Q^T 32,
//   P^T 33, V^2 16, 33 a stage); attention 195 (Q^T 64, P^T 65, 33 a
//   stage).  Registers: 168-187 a thread for MHAda, 254 for attention (a
//   second block an SM would need <= 128): one block an SM.  At B = 1, N =
//   4096 and 8 heads MHAda is 256 blocks (1.94 waves of 132 SMs) and
//   attention 128 (0.97).  Of the attention layouts timed on an H100
//   (probes/f32_tile_geometry.py: 256 queries with 16 x 4 a thread, 128
//   queries with 128 threads and 8 x 8, the MHAda tile's 8 x 4), this one
//   is 7-14 % faster at every shape.  The score loop is unrolled whole and
//   P V eight keys at a time, which ptxas schedules better (3-4 % on an
//   H100).
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

#include "attention_combine.cuh"
#include "common.cuh"
#include "flash_mma.cuh"  // mma::cp_async_16 / _commit / _wait, smem_addr

namespace mhada {
namespace f32t {

constexpr int kD = 64;        // head dim
constexpr int kBK = 64;       // keys per tile
constexpr int kKS = kD + 4;   // padded row stride of K [key][d]
constexpr int kStageFloats = kBK * (kKS + kD);  // K, then V [key][d]
constexpr float kLog2e = 1.4426950408889634f;
// The ring depth of K1, K3, K4, K6 and K7.
constexpr int kRingStages = 2;

// A block's thread layout: kThreads threads, TX of them to a query row;
// each owns kG groups of 4 rows and kJ keys of a tile (and kJ output
// channels).
template <int kG, int kJ, int kThreads_>
struct Geom {
  static constexpr int kThreads = kThreads_;
  static constexpr int G = kG;            // groups of 4 rows a thread
  static constexpr int R = 4 * kG;        // query rows a thread
  static constexpr int J = kJ;            // keys and channels a thread
  static constexpr int TX = kBK / kJ;     // threads of one row
  static constexpr int TY = kThreads / TX;
  static constexpr int BQ = 4 * TY * kG;  // queries a block
  static constexpr int PS = BQ + 4;       // padded row stride of P^T
  static_assert(kJ % 4 == 0 && TX * kJ == kBK && 32 % TX == 0 &&
                    kThreads % 32 == 0 && kThreads % (kD / 4) == 0,
                "a row's threads lie in one warp; whole float4 channels");
  // The query row of a thread's row slot i (< R).
  static __device__ __forceinline__ int row(int ty, int i) {
    return 4 * ty + (i & 3) + 4 * TY * (i >> 2);
  }
};
// MHAda: 128 queries, 8 x 4 scores and 8 x 4 x 2 accumulators a thread.
using MhadaGeom = Geom<2, 4, 256>;
// Attention: 256 queries, 8 x 8 scores and 8 x 8 accumulators a thread
// (probes/f32_tile_geometry.py times the other layouts).
using AttnGeom = Geom<2, 8, 256>;

// Shared memory of a block with a ring of `stages` key tiles: Q^T, P^T,
// V^2 (MHAda only) and the ring.
template <class Gm, bool kV2>
constexpr size_t smem_bytes(int stages) {
  return sizeof(float) * (kD * Gm::BQ + kBK * Gm::PS + (kV2 ? kBK * kD : 0) +
                          stages * kStageFloats);
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
  const float* q;  // K4, K7: q; K3: raw fc         (B, N, C)
  const float* k;  //                               (B, M, C)
  const float* v;
  const float* f;  // K4, K7: IN(fcs); K3: raw fcs  (B, N, C)
  float* out;      //                               (B, N, C)
  const float* stats;  // K3 only: (B, 4, C)
  const float* wf;     // K3 only: (H, 64, 64) as (in, out)
  const float* fb;     // K3 only: (H, 64)
  float* m1;           // K7 only: (B, N, C)
  float* e2;           // K7 only: (B, N, C)
  float* lse;          // K7 only: (B, H, N)
  int n, m, channels;
};

// Queries (B, n, rows of q_rs floats) and keys and values (B, m, rows of
// kv_rs floats), head h's 64 channels at h*64 from q, k and v.  The self-
// attention of K1 and K6 reads all three from one packed (B, L, 3C) qkv
// (self_attention_args); K1's cross form takes q from this rank's qkv and
// k, v from the keys and values gathered over the ranks (B, M, 2C).
struct AttnArgs {
  const float* q;
  const float* k;
  const float* v;
  float* out;        // (B, n, C)
  float* lse;        // K6 only: (B, H, n)
  int n, m, channels, q_rs, kv_rs;
  float scale;
  // K1's cross form split over the keys only (attention_f32_kernel<false,
  // true>): the partials buffer (xsplit::Partials' layout) and the splits
  float* part;
  int splits;
};

// q, k, v of head h at h*64, C + h*64 and 2C + h*64 of the (B, L, 3C)
// qkv (torch MultiheadAttention packing).
inline AttnArgs self_attention_args(const void* qkv, void* out, int seq,
                                    int channels, float scale) {
  AttnArgs a{};
  a.q = static_cast<const float*>(qkv);
  a.k = a.q + channels;
  a.v = a.q + 2 * channels;
  a.out = static_cast<float*>(out);
  a.n = a.m = seq;
  a.channels = channels;
  a.q_rs = a.kv_rs = 3 * channels;
  a.scale = scale;
  return a;
}

// One thread's accumulators: sum_k p V (o1) and, for MHAda, sum_k p V^2
// (o2) of its R rows and J channels, the rows' running maxima (of the
// logits as scored) and this thread's share of the rows' sums of p.
template <class Gm, bool kV2>
struct Acc {
  float o1[Gm::R][Gm::J];
  float o2[kV2 ? Gm::R : 1][kV2 ? Gm::J : 1];
  float mrow[Gm::R], lrow[Gm::R];
};

// The query row of a thread's row slot i (< 8) in MHAda's block (also the
// layout of flash_bwd_f32.cuh).
__device__ __forceinline__ int row_of(int ty, int i) {
  return MhadaGeom::row(ty, i);
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

// Issue the copies of key tile t (K and V rows of `rs` floats, head h's
// channels from kv_base on) into `stage`; keys past m are zero-filled by
// the copies themselves.  Thread (row c0, chunk ch) copies keys c0 + kRows
// r of the tile, channels ch .. ch + 3: the address steps are fixed, so
// each chunk costs a few integer instructions besides its cp.async.
template <int kThreads>
__device__ __forceinline__ void issue_tile(const float* k, const float* v,
                                           int rs, int m, int t,
                                           long long kv_base, float* stage) {
  constexpr int kRows = kThreads / (kD / 4);  // key rows a pass
  const int c0 = threadIdx.x / (kD / 4), ch = 4 * (threadIdx.x % (kD / 4));
  const long long step = (long long)kRows * rs;
  const long long off = kv_base + (long long)(t * kBK + c0) * rs + ch;
  const uint32_t ks = mma::smem_addr(stage + c0 * kKS + ch);
  const uint32_t vs = mma::smem_addr(stage + kBK * kKS + c0 * kD + ch);
#pragma unroll
  for (int r = 0; r < kBK / kRows; ++r) {
    const bool valid = t * kBK + c0 + kRows * r < m;
    const long long o = valid ? off + r * step : kv_base + ch;
    mma::cp_async_16(ks + 4 * kRows * r * kKS, k + o, valid);
    mma::cp_async_16(vs + 4 * kRows * r * kD, v + o, valid);
  }
}

// The block's rows of token-major src (B, n, rows of `rs` floats), batch
// b, channels hoff .. hoff + 63, transposed into dst [d][query] at
// `stride`: op(d, x) of each 4 channels x from d on; rows past n are zero.
// Lanes take consecutive rows, so the transposed stores do not conflict.
template <class Gm, typename Op>
__device__ __forceinline__ void load_transposed(const float* src, int rs,
                                                int n, int q0, long long b,
                                                int hoff, float* dst,
                                                int stride, Op op) {
  for (int idx = threadIdx.x; idx < Gm::BQ * kD / 4; idx += Gm::kThreads) {
    const int r = idx % Gm::BQ, ch = 4 * (idx / Gm::BQ);
    const int row = q0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < n) x = op(ch, ld4(src + (b * n + row) * rs + hoff + ch));
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
  using Gm = MhadaGeom;
  const int tx = threadIdx.x % Gm::TX, ty = threadIdx.x / Gm::TX;
  const float* w = a.wf + (long long)blockIdx.y * kD * kD;
  for (int idx = threadIdx.x; idx < kD * kD / 4; idx += Gm::kThreads)
    st4(wfs + 4 * idx, ld4(w + 4 * idx));
  const float* mean_fc = a.stats + b * 4 * a.channels + hoff;
  load_transposed<Gm>(a.q, a.channels, a.n, q0, b, hoff, qn_t, Gm::PS,
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
    const float4 xa = ld4(qn_t + d * Gm::PS + 4 * ty);
    const float4 xb = ld4(qn_t + d * Gm::PS + 64 + 4 * ty);
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
      st4(qs + (4 * tx + j) * Gm::BQ + 64 * g + 4 * ty,
          make_float4(acc[4 * g][j] + at(bias, j),
                      acc[4 * g + 1][j] + at(bias, j),
                      acc[4 * g + 2][j] + at(bias, j),
                      acc[4 * g + 3][j] + at(bias, j)));
}

template <class Gm, bool kV2>
__device__ __forceinline__ void init(Acc<Gm, kV2>& acc) {
#pragma unroll
  for (int i = 0; i < Gm::R; ++i) {
    acc.mrow[i] = -INFINITY;
    acc.lrow[i] = 0.f;
#pragma unroll
    for (int j = 0; j < Gm::J; ++j) {
      acc.o1[i][j] = 0.f;
      if constexpr (kV2) acc.o2[i][j] = 0.f;
    }
  }
}

// This thread's scores of one key tile: s[i][j] = q(Gm::row(ty, i)) .
// k(tx + TX j), summed over d in order.
template <class Gm>
__device__ __forceinline__ void scores(const float* qs, const float* ks,
                                       float (&s)[Gm::R][Gm::J]) {
  const int tx = threadIdx.x % Gm::TX, ty = threadIdx.x / Gm::TX;
  const float* qp = qs + 4 * ty;
  const float* kp = ks + tx * kKS;
#pragma unroll
  for (int i = 0; i < Gm::R; ++i)
#pragma unroll
    for (int j = 0; j < Gm::J; ++j) s[i][j] = 0.f;
#pragma unroll
  for (int d0 = 0; d0 < kD; d0 += 4) {
    float4 kv[Gm::J];
#pragma unroll
    for (int j = 0; j < Gm::J; ++j) kv[j] = ld4(kp + Gm::TX * j * kKS + d0);
#pragma unroll
    for (int dd = 0; dd < 4; ++dd) {
      float4 qv[Gm::G];
#pragma unroll
      for (int g = 0; g < Gm::G; ++g)
        qv[g] = ld4(qp + (d0 + dd) * Gm::BQ + 4 * Gm::TY * g);
#pragma unroll
      for (int i = 0; i < Gm::R; ++i)
#pragma unroll
        for (int j = 0; j < Gm::J; ++j)
          s[i][j] = fmaf(at(qv[i >> 2], i & 3), at(kv[j], dd), s[i][j]);
    }
  }
}

// The online softmax of key tile t: keys past m are masked (kMask, the
// ragged last tile only), p = 2^(s log2 e - max log2 e) goes to P^T
// (key-major), the row maxima and this thread's sums move, and the
// accumulators are rescaled unless no row maximum of the warp moved.
template <class Gm, bool kMask, bool kV2>
__device__ __forceinline__ void softmax(int t, int m,
                                        float (&s)[Gm::R][Gm::J], float* ps,
                                        Acc<Gm, kV2>& acc) {
  const int tx = threadIdx.x % Gm::TX, ty = threadIdx.x / Gm::TX;
  if (kMask) {
#pragma unroll
    for (int j = 0; j < Gm::J; ++j)
      if (t * kBK + tx + Gm::TX * j >= m) {
#pragma unroll
        for (int i = 0; i < Gm::R; ++i) s[i][j] = -INFINITY;
      }
  }
  float alpha[Gm::R];
  bool moved = false;
#pragma unroll
  for (int i = 0; i < Gm::R; ++i) {
    float mx = s[i][0];
#pragma unroll
    for (int j = 1; j < Gm::J; ++j) mx = fmaxf(mx, s[i][j]);
#pragma unroll
    for (int off = 1; off < Gm::TX; off <<= 1)
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
    for (int j = 0; j < Gm::J; ++j) {
      s[i][j] = exp2_ftz(fmaf(s[i][j], kLog2e, mb));
      sum += s[i][j];
    }
    acc.lrow[i] = acc.lrow[i] * alpha[i] + sum;
  }
  if (__any_sync(0xffffffffu, moved)) {
#pragma unroll
    for (int i = 0; i < Gm::R; ++i)
#pragma unroll
      for (int j = 0; j < Gm::J; ++j) {
        acc.o1[i][j] *= alpha[i];
        if constexpr (kV2) acc.o2[i][j] *= alpha[i];
      }
  }
#pragma unroll
  for (int j = 0; j < Gm::J; ++j)
#pragma unroll
    for (int g = 0; g < Gm::G; ++g)
      st4(ps + (tx + Gm::TX * j) * Gm::PS + 4 * Gm::TY * g + 4 * ty,
          make_float4(s[4 * g][j], s[4 * g + 1][j], s[4 * g + 2][j],
                      s[4 * g + 3][j]));
}

// V^2 of the tile's V into v2s, once a tile (MHAda).
template <class Gm>
__device__ __forceinline__ void square_v(const float* vs, float* v2s) {
#pragma unroll
  for (int r = 0; r < kBK * kD / 4 / Gm::kThreads; ++r) {
    const int idx = 4 * (threadIdx.x + r * Gm::kThreads);
    const float4 x = ld4(vs + idx);
    st4(v2s + idx, make_float4(x.x * x.x, x.y * x.y, x.z * x.z, x.w * x.w));
  }
}

// acc += P V (and P V^2) over one key tile, keys in order.
template <class Gm, bool kV2>
__device__ __forceinline__ void pv(const float* ps, const float* vs,
                                   const float* v2s, Acc<Gm, kV2>& acc) {
  const int tx = threadIdx.x % Gm::TX, ty = threadIdx.x / Gm::TX;
  const float* pp = ps + 4 * ty;
#pragma unroll 8
  for (int c = 0; c < kBK; ++c) {
    float4 p[Gm::G], v[Gm::J / 4], w[Gm::J / 4];
#pragma unroll
    for (int g = 0; g < Gm::G; ++g)
      p[g] = ld4(pp + c * Gm::PS + 4 * Gm::TY * g);
#pragma unroll
    for (int h = 0; h < Gm::J / 4; ++h) {
      v[h] = ld4(vs + c * kD + 4 * tx + 4 * Gm::TX * h);
      if constexpr (kV2) w[h] = ld4(v2s + c * kD + 4 * tx + 4 * Gm::TX * h);
    }
#pragma unroll
    for (int i = 0; i < Gm::R; ++i)
#pragma unroll
      for (int j = 0; j < Gm::J; ++j) {
        const float pi = at(p[i >> 2], i & 3);
        acc.o1[i][j] = fmaf(pi, at(v[j >> 2], j & 3), acc.o1[i][j]);
        if constexpr (kV2)
          acc.o2[i][j] = fmaf(pi, at(w[j >> 2], j & 3), acc.o2[i][j]);
      }
  }
}

// The key loop over a ring of kStages stages, K and V rows of `rs` floats
// from kv_base on.  On entry Q^T is written (the first barrier publishes
// it) and tiles 0 .. kStages - 2 are issued, one commit group each.
template <class Gm, int kStages, bool kV2>
__device__ __forceinline__ void key_loop(const float* k, const float* v,
                                         int rs, int m, long long kv_base,
                                         const float* qs, float* ps,
                                         float* v2s, float* ring,
                                         Acc<Gm, kV2>& acc) {
  init(acc);
  const int tiles = (m + kBK - 1) / kBK;
  for (int t = 0; t < tiles; ++t) {
    float* stage = ring + (t % kStages) * kStageFloats;
    if (kStages == 1) {
      if (t > 0) __syncthreads();  // tile t - 1's reads are done
      issue_tile<Gm::kThreads>(k, v, rs, m, t, kv_base, stage);
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
        issue_tile<Gm::kThreads>(k, v, rs, m, next, kv_base,
                                 ring + (next % kStages) * kStageFloats);
      mma::cp_async_commit();  // possibly empty: one group per iteration
    }
    const float* vs = stage + kBK * kKS;
    if constexpr (kV2) square_v<Gm>(vs, v2s);
    float s[Gm::R][Gm::J];
    scores<Gm>(qs, stage, s);
    if ((t + 1) * kBK > m)
      softmax<Gm, true>(t, m, s, ps, acc);
    else
      softmax<Gm, false>(t, m, s, ps, acc);
    __syncthreads();  // P^T (and V^2) are visible
    pv(ps, vs, v2s, acc);
  }
}

// The rows' sums of p from the threads' shares, reduced among each row's
// TX lanes.
template <class Gm, bool kV2>
__device__ __forceinline__ void row_sums(const Acc<Gm, kV2>& acc,
                                         float (&l)[Gm::R]) {
#pragma unroll
  for (int i = 0; i < Gm::R; ++i) {
    l[i] = acc.lrow[i];
#pragma unroll
    for (int off = 1; off < Gm::TX; off <<= 1)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
  }
}

// a * b rounded once, opaque to the compiler.  K7's M1 and E2 stores take
// it: a second use of out's own products would let the compiler fuse them
// differently from K4's, and K7's out must repeat K4's bit for bit.
__device__ __forceinline__ float mul_rn(float a, float b) {
  float y;
  asm("mul.rn.f32 %0, %1, %2;" : "=f"(y) : "f"(a), "f"(b));
  return y;
}

// The output rows from the finished accumulators: f given (K4, K7) or
// IN(fcs) from raw fcs and the stats (K3); 16-byte loads and stores.
// kRes (K7) also stores M1 and E2 at the output's offsets and, from the
// row's first thread, lse = max + log(sum).
template <bool kPrologue, bool kRes>
__device__ __forceinline__ void epilogue(const F32Args& a, int q0,
                                         long long b, int hoff,
                                         const Acc<MhadaGeom, true>& acc) {
  using Gm = MhadaGeom;
  const int tx = threadIdx.x % Gm::TX, ty = threadIdx.x / Gm::TX;
  const int ch = hoff + 4 * tx;
  float l[Gm::R], inv[Gm::R];
  row_sums(acc, l);
#pragma unroll
  for (int i = 0; i < Gm::R; ++i) inv[i] = 1.f / l[i];
#pragma unroll
  for (int i = 0; i < Gm::R; ++i) {
    const int row = q0 + Gm::row(ty, i);
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
    if (kRes) {
      float m1[4], e2[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        m1[j] = mul_rn(acc.o1[i][j], inv[i]);
        e2[j] = mul_rn(acc.o2[i][j], inv[i]);
      }
      st4(a.m1 + o, make_float4(m1[0], m1[1], m1[2], m1[3]));
      st4(a.e2 + o, make_float4(e2[0], e2[1], e2[2], e2[3]));
      if (tx == 0)
        a.lse[(b * gridDim.y + blockIdx.y) * a.n + row] =
            acc.mrow[i] + logf(l[i]);
    }
  }
}

// kPrologue = false: K4 and K7 (q and IN(fcs) given).  kPrologue = true:
// K3 (q and IN(fcs) formed from raw fc and fcs).  kStages: the ring's
// depth.  kRes: K7, also M1, E2 and lse.
template <bool kPrologue, int kStages, bool kRes = false>
__global__ void __launch_bounds__(MhadaGeom::kThreads, 1)
    mhada_f32_kernel(F32Args a) {
  using Gm = MhadaGeom;
  extern __shared__ float4 f32_smem[];
  float* qs = reinterpret_cast<float*>(f32_smem);  // [d][query]  Q^T
  float* ps = qs + kD * Gm::BQ;                    // [key][query] P^T
  float* v2s = ps + kBK * Gm::PS;                  // [key][d]    V^2
  float* ring = v2s + kBK * kD;                    // stages: K, V
  const int q0 = blockIdx.x * Gm::BQ;
  const int hoff = blockIdx.y * kD;
  const long long b = blockIdx.z;
  const long long kv_base = b * a.m * a.channels + hoff;

  // The first tiles fly while the queries are formed.
  const int tiles = (a.m + kBK - 1) / kBK;
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < tiles)
      issue_tile<Gm::kThreads>(a.k, a.v, a.channels, a.m, t, kv_base,
                               ring + t * kStageFloats);
    mma::cp_async_commit();
  }
  if (kPrologue)
    prologue_queries(a, q0, b, hoff, qs, ps, v2s);
  else
    load_transposed<Gm>(a.q, a.channels, a.n, q0, b, hoff, qs, Gm::BQ,
                        [](int, float4 x) { return x; });

  Acc<Gm, true> acc;
  key_loop<Gm, kStages>(a.k, a.v, a.channels, a.m, kv_base, qs, ps, v2s,
                        ring, acc);
  epilogue<kPrologue, kRes>(a, q0, b, hoff, acc);
}

template <bool kPrologue, int kRing, bool kRes = false>
cudaError_t launch_mhada_f32(const F32Args& a, int heads, int batch,
                             cudaStream_t stream) {
  if (a.m < 1 || !f32_aligned({a.q, a.k, a.v, a.f, a.out}, a.channels) ||
      (kPrologue && !f32_aligned({a.stats, a.wf, a.fb}, a.channels)) ||
      (kRes && !f32_aligned({a.m1, a.e2}, a.channels)))
    return cudaErrorInvalidValue;
  const dim3 grid((a.n + MhadaGeom::BQ - 1) / MhadaGeom::BQ, heads, batch);
  return launch_with_smem(mhada_f32_kernel<kPrologue, kRing, kRes>, grid,
                          dim3(MhadaGeom::kThreads),
                          smem_bytes<MhadaGeom, true>(kRing), stream, a);
}

// out = softmax(scale q k^T) V per head, n queries against m keys; kLse
// (K6) also writes lse, from the row's first thread.  kSplit (K1's cross
// form split over the keys, attention_combine.cuh): blockIdx.x is split s
// of a.splits times the query blocks plus the query block; the block walks
// key tiles [s T / splits, (s + 1) T / splits) and writes the float32
// partials (m_s in log2 units, l_s, the unnormalised O_s) into a.part for
// attention_combine_kernel in place of out.  Without it the code is K1's
// and K6's own: t0 = 0, m = a.m.
template <bool kLse, bool kSplit = false>
__global__ void __launch_bounds__(AttnGeom::kThreads, 1)
    attention_f32_kernel(AttnArgs a) {
  using Gm = AttnGeom;
  extern __shared__ float4 f32_smem[];
  float* qs = reinterpret_cast<float*>(f32_smem);  // [d][query]  Q^T
  float* ps = qs + kD * Gm::BQ;                    // [key][query] P^T
  float* ring = ps + kBK * Gm::PS;                 // stages: K, V
  const int qblocks = (a.n + Gm::BQ - 1) / Gm::BQ;
  const int split = kSplit ? blockIdx.x / qblocks : 0;
  const int q0 = (kSplit ? blockIdx.x % qblocks : blockIdx.x) * Gm::BQ;
  const int hoff = blockIdx.y * kD;
  const long long b = blockIdx.z;
  const int all_tiles = (a.m + kBK - 1) / kBK;
  const int t0 = kSplit ? xsplit::split_first(split, a.splits, all_tiles) : 0;
  // the keys of this block's walk, from kv_base on
  const int m = kSplit ? min(a.m - t0 * kBK,
                             (xsplit::split_first(split + 1, a.splits,
                                                  all_tiles) - t0) * kBK)
                       : a.m;
  const long long kv_base =
      b * a.m * a.kv_rs + hoff + (long long)t0 * kBK * a.kv_rs;

  const int tiles = (m + kBK - 1) / kBK;
#pragma unroll
  for (int t = 0; t < kRingStages - 1; ++t) {
    if (t < tiles)
      issue_tile<Gm::kThreads>(a.k, a.v, a.kv_rs, m, t, kv_base,
                               ring + t * kStageFloats);
    mma::cp_async_commit();
  }
  const float sc = a.scale;
  load_transposed<Gm>(a.q, a.q_rs, a.n, q0, b, hoff, qs, Gm::BQ,
                      [sc](int, float4 x) {
                        return make_float4(x.x * sc, x.y * sc, x.z * sc,
                                           x.w * sc);
                      });

  Acc<Gm, false> acc;
  key_loop<Gm, kRingStages>(a.k, a.v, a.kv_rs, m, kv_base, qs, ps, nullptr,
                            ring, acc);

  const int tx = threadIdx.x % Gm::TX, ty = threadIdx.x / Gm::TX;
  float l[Gm::R];
  row_sums(acc, l);
#pragma unroll
  for (int i = 0; i < Gm::R; ++i) {
    const int row = q0 + Gm::row(ty, i);
    if (row >= a.n) continue;
    if constexpr (kSplit) {
      const xsplit::Partials part{a.part, a.splits, (int)gridDim.z, a.n,
                                  a.channels, (int)gridDim.y};
      float* o = part.o(split, b, row) + hoff + 4 * tx;
#pragma unroll
      for (int h = 0; h < Gm::J / 4; ++h)
        st4(o + 4 * Gm::TX * h,
            make_float4(acc.o1[i][4 * h], acc.o1[i][4 * h + 1],
                        acc.o1[i][4 * h + 2], acc.o1[i][4 * h + 3]));
      if (tx == 0) {
        const long long at = part.stat(split, b, blockIdx.y, row);
        part.m()[at] = acc.mrow[i] * kLog2e;
        part.l()[at] = l[i];
      }
    } else {
      const float inv = 1.f / l[i];
      float* o = a.out + (b * a.n + row) * a.channels + hoff + 4 * tx;
#pragma unroll
      for (int h = 0; h < Gm::J / 4; ++h)
        st4(o + 4 * Gm::TX * h,
            make_float4(acc.o1[i][4 * h] * inv, acc.o1[i][4 * h + 1] * inv,
                        acc.o1[i][4 * h + 2] * inv,
                        acc.o1[i][4 * h + 3] * inv));
      if (kLse && tx == 0)
        a.lse[(b * gridDim.y + blockIdx.y) * a.n + row] =
            acc.mrow[i] + logf(l[i]);
    }
  }
}

template <bool kLse>
cudaError_t launch_attention_f32(const AttnArgs& a, int heads, int batch,
                                 cudaStream_t stream) {
  if (a.n < 1 || a.m < 1 || a.q_rs % 4 || a.kv_rs % 4 ||
      !f32_aligned({a.q, a.k, a.v, a.out}, a.channels))
    return cudaErrorInvalidValue;
  const dim3 grid((a.n + AttnGeom::BQ - 1) / AttnGeom::BQ, heads, batch);
  return launch_with_smem(attention_f32_kernel<kLse>, grid,
                          dim3(AttnGeom::kThreads),
                          smem_bytes<AttnGeom, false>(kRingStages), stream,
                          a);
}

}  // namespace f32t
}  // namespace mhada
