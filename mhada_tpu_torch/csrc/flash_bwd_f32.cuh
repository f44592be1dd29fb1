// The float32 flash backward on the CUDA cores: K6's (attention_train.cu)
// and K7's (mhada_train.cu) float32 backward, which also run K12's and
// K11's at 4096 and 16384 tokens.  Their bfloat16 backwards run on the
// tensor cores (attention_bwd_mma.cuh, mhada_bwd_wgmma.cuh).  Per head, with
// P rebuilt from the forward's row log-sum-exp:
//
//   S  = scale Q K^T,  P = exp(S - lse)            (keys >= m masked to 0)
//   dP = G1 V^T                       K6: G1 = dO
//   dP = G1 V^T + G2 (V^2)^T          K7: G1 = dM1, G2 = dE2
//   dS = P * (dP - delta) * scale     delta per row, computed by the wrapper
//   dQ = dS K,  dK = dS^T Q
//   dV = P^T G1                       K6
//   dV = P^T G1 + 2 V * (P^T G2)      K7 (mhada_pallas.py:415-421)
//
// The JAX backward rounds P to the storage type before P^T G and dS before
// dS K and dS^T Q (attention_pallas.py:256-312, mhada_pallas.py:362-421);
// in float32 those roundings are the identity.  Everything is float32 FMAs
// on the CUDA cores: no TF32, no tensor-core instruction.
//
// The TPU kernels accumulate dK and dV across a sequential query-block
// grid axis.  Hopper blocks run in no order, so this is the FlashAttention-2
// split with no atomics (the result does not depend on scheduling):
// `flash_bwd_f32_dkv_kernel` owns (128 keys, head, batch) and streams the
// query tiles; `flash_bwd_f32_dq_kernel` owns (128 queries, head, batch)
// and streams the key tiles, rebuilding S and dP.
//
// What bounds it on the card: 14 L^2 d FMA-work for K6 and 20 N M d for K7
// with the recompute (10 and 14 without it) against a few reads of each
// operand: the float32 FMA rate.  The design, after the float32 MHAda tile
// (mhada_f32_tile.cuh), keeps the FMA pipe fed:
//
// - Both kernels are one block of 256 threads, a 16 x 16 grid (ty, tx),
//   that keeps 128 rows resident, transposed ([d][row], from Q, G1, G2 in
//   the dQ kernel, K and V in the dK/dV kernel) and streams 64-row tiles of
//   the other side ([row][d], rows padded to 68 floats) through a
//   two-stage ring of 16-byte cp.async copies (L2 only; rows past the end
//   zero-filled by the copy): tile t + 1 lands while tile t is computed.
// - A thread owns resident rows 4 ty + r and 64 + 4 ty + r (r < 4) and
//   streamed rows tx + 16 j (j < 4) of each 8 x 4 product (S and dP, or
//   S^T and dP^T): four d-steps take 8 LDS.128 of the resident tile (a
//   broadcast in each half-warp) and 4 of the streamed one (conflict-free:
//   the padded rows fall in distinct bank quads) for 128 FFMA.
// - P and dS go to a padded [streamed][resident] buffer (rows of 132); the
//   accumulations dQ += dS K, dV += P^T G and dK += dS^T Q are 8 x 4 per
//   thread (resident rows by channels 4 tx + j): a streamed row takes 2
//   LDS.128 of P or dS and one of each operand for 32 FFMA each.
// - The exponent is one FFMA in log2 units, lse folded in, and one
//   ex2.approx.ftz; rows past n carry lse = +inf, so their P is 0; only the
//   dQ kernel's ragged last key tile is masked (a zero-filled key's dS
//   meets a zero row of K, but its P = 2^(-lse log2 e) overflows where lse
//   < -88; the dK/dV kernel's keys past m are zero-filled, and their rows
//   are never written).
// - K7's dQ kernel squares V once a tile into a V^2 buffer; dP is one
//   128-deep product of [G1 | G2] against [V | V^2].  K7's dK/dV block
//   squares its resident V^T in registers as the dP^T product reads it
//   (8 FMUL per 64 FFMA of that half): a resident V^2 would not fit beside
//   the three-tensor ring (below).
//
// Shared memory (a resident tile 64 x 128 floats, a streamed tile 64 x 68,
// a P / dS buffer 64 x 132; KB of 1024 bytes, of the 227 a block may use):
//   dQ    K6: Q^T, G1^T, dS, ring 2 x (K, V)             165.0 KB
//         K7: + G2^T, V^2                                 214.0 KB
//   dK/dV K6: K^T, V^T, P, dS, ring 2 x (Q, G1)           198.0 KB
//         K7: K^T, V^T, P = dS, ring 2 x (Q, G1, G2)      199.0 KB
// A resident V^2, or a second buffer, would take K7's dK/dV block to 231 or
// 232 KB, so it keeps one P / dS buffer (two more barriers a tile: dS is
// stored once the P^T G products have read P).  One block an SM (the
// registers: 168-254 a thread); at 4096 tokens, 8 heads and B = 4 each
// kernel is 1024 blocks, 7.76 waves of 132.  Pointers must be 16-byte
// aligned and every stride a multiple of 4 (f32t::f32_aligned on the
// pointers and channels; the packed (B, L, 3C) qkv of K6 qualifies at
// C % 4 == 0).  Offsets are formed in 64 bits.
#pragma once

#include <math.h>
#include <stdint.h>

#include "mhada_f32_tile.cuh"  // ld4, st4, at, exp2_ftz, row_of

namespace mhada {
namespace f32b {

using f32t::at;
using f32t::exp2_ftz;
using f32t::kLog2e;
using f32t::ld4;
using f32t::row_of;
using f32t::st4;

constexpr int kD = 64;          // head dim
constexpr int kThreads = 256;
constexpr int kRows = 128;      // resident rows of a block
constexpr int kTile = 64;       // streamed rows of a tile
constexpr int kRS = kRows;      // row stride of a resident tile [d][row]
constexpr int kSS = kD + 4;     // padded row stride of a streamed tile
constexpr int kPS = kRows + 4;  // padded row stride of P / dS
constexpr int kStages = 2;      // the ring's depth
constexpr int kResident = kD * kRS;
constexpr int kStreamed = kTile * kSS;
constexpr int kBuffer = kTile * kPS;

struct BwdArgs {
  const float* q;      // head 0 of each operand; head h at + 64 h
  const float* k;
  const float* v;
  const float* g1;     // dO (K6) or dM1 (K7), at the query rows' strides
  const float* g2;     // dE2 (K7 only)
  const float* lse;    // (B, heads, n)
  const float* delta;  // (B, heads, n)
  float* dq;
  float* dk;
  float* dv;
  int n, m;  // query rows, key rows
  long long q_bs, q_rs, kv_bs, kv_rs, g_bs, g_rs, dq_bs, dq_rs, dkv_bs,
      dkv_rs;  // strides (floats)
  float scale;
};

constexpr size_t dq_smem_bytes(bool mhada) {
  return sizeof(float) * ((mhada ? 3 : 2) * kResident + kBuffer +
                          kStages * 2 * kStreamed + (mhada ? kStreamed : 0));
}
constexpr size_t dkv_smem_bytes(bool mhada) {
  return sizeof(float) * (2 * kResident + (mhada ? 1 : 2) * kBuffer +
                          kStages * (mhada ? 3 : 2) * kStreamed);
}

// Rows r0 .. r0 + 63 of src (channels 0 .. 63, row stride rs) into dst
// [row][kSS] by 16-byte cp.async; rows at or past `rows` are zero-filled by
// the copies.  Thread (c0, ch) copies rows c0 + 16 r, channels ch .. ch + 3.
__device__ __forceinline__ void copy_rows(float* dst, const float* src,
                                          long long rs, int r0, int rows) {
  const int c0 = threadIdx.x / (kD / 4), ch = 4 * (threadIdx.x % (kD / 4));
  const uint32_t s = mma::smem_addr(dst + c0 * kSS + ch);
  const float* p = src + (long long)(r0 + c0) * rs + ch;
#pragma unroll
  for (int r = 0; r < kTile / 16; ++r) {
    const bool valid = r0 + c0 + 16 * r < rows;
    mma::cp_async_16(s + 4 * 16 * r * kSS, valid ? p + 16 * r * rs : src + ch,
                     valid);
  }
}

// Rows r0 .. r0 + 127 of src transposed into dst [d][kRS]; rows at or past
// `rows` are zero.  Lanes take consecutive rows, so the transposed stores
// do not conflict.
__device__ __forceinline__ void load_resident(float* dst, const float* src,
                                              long long rs, int r0,
                                              int rows) {
  for (int idx = threadIdx.x; idx < kRows * kD / 4; idx += kThreads) {
    const int r = idx % kRows, ch = 4 * (idx / kRows);
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < rows) x = ld4(src + (long long)(r0 + r) * rs + ch);
    dst[(ch + 0) * kRS + r] = x.x;
    dst[(ch + 1) * kRS + r] = x.y;
    dst[(ch + 2) * kRS + r] = x.z;
    dst[(ch + 3) * kRS + r] = x.w;
  }
}

__device__ __forceinline__ void zero(float (&x)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) x[i][j] = 0.f;
}

__device__ __forceinline__ float4 square(float4 x) {
  return make_float4(x.x * x.x, x.y * x.y, x.z * x.z, x.w * x.w);
}

// acc[i][j] += sum_d a(d, row_of(ty, i)) b(tx + 16 j, d), d in order: `res`
// resident [d][kRS] (squared as read when kSquare), `str` streamed
// [row][kSS].
template <bool kSquare>
__device__ __forceinline__ void product(const float* res, const float* str,
                                        float (&acc)[8][4]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float* ap = res + 4 * ty;
  const float* bp = str + tx * kSS;
#pragma unroll 4
  for (int d0 = 0; d0 < kD; d0 += 4) {
    float4 bv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = ld4(bp + 16 * j * kSS + d0);
#pragma unroll
    for (int dd = 0; dd < 4; ++dd) {
      float4 xa = ld4(ap + (d0 + dd) * kRS);
      float4 xb = ld4(ap + (d0 + dd) * kRS + 64);
      if (kSquare) {
        xa = square(xa);
        xb = square(xb);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] =
              fmaf(at(i < 4 ? xa : xb, i & 3), at(bv[j], dd), acc[i][j]);
    }
  }
}

// acc[i][j] += sum_c x(c, row_of(ty, i)) y(c, 4 tx + j) over the tile's 64
// streamed rows c in order: x a P / dS buffer [c][kPS], y streamed
// [c][kSS]; kTwo: also acc2 += x y2 (K7's P^T G1 and P^T G2).
template <bool kTwo>
__device__ __forceinline__ void accumulate(const float* x, const float* y,
                                           const float* y2,
                                           float (&acc)[8][4],
                                           float (&acc2)[8][4]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float* xp = x + 4 * ty;
#pragma unroll 8
  for (int c = 0; c < kTile; ++c) {
    const float4 xa = ld4(xp + c * kPS), xb = ld4(xp + c * kPS + 64);
    const float4 yv = ld4(y + c * kSS + 4 * tx);
    float4 y2v;
    if (kTwo) y2v = ld4(y2 + c * kSS + 4 * tx);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float xv = at(i < 4 ? xa : xb, i & 3);
        acc[i][j] = fmaf(xv, at(yv, j), acc[i][j]);
        if (kTwo) acc2[i][j] = fmaf(xv, at(y2v, j), acc2[i][j]);
      }
  }
}

// This thread's 8 x 4 values into a P / dS buffer: value (i, j) at
// [tx + 16 j][row_of(ty, i)].  Conflict-free: a quarter-warp's rows
// tx + 16 j fall in distinct bank quads.
__device__ __forceinline__ void store_buffer(float* x, const float (&v)[8][4]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int g = 0; g < 2; ++g)
      st4(x + (tx + 16 * j) * kPS + 64 * g + 4 * ty,
          make_float4(v[4 * g][j], v[4 * g + 1][j], v[4 * g + 2][j],
                      v[4 * g + 3][j]));
}

// The 8 x 4 rows of acc as token-major rows r0 + row_of(ty, i) < rows of
// dst (row stride rs), channels 4 tx .. 4 tx + 3; 16-byte stores.
__device__ __forceinline__ void store_rows(float* dst, long long rs, int r0,
                                           int rows, const float (&acc)[8][4]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = r0 + row_of(ty, i);
    if (row < rows)
      st4(dst + (long long)row * rs + 4 * tx,
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
  }
}

// dQ of 128 query rows: the key tiles stream through the ring.
template <bool kMhada>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_f32_dq_kernel(BwdArgs a) {
  extern __shared__ float4 bwd_smem[];
  float* qt = reinterpret_cast<float*>(bwd_smem);  // Q^T  [d][query]
  float* g1t = qt + kResident;                     // G1^T [d][query]
  float* dss = g1t + kResident;                    // dS   [key][query]
  float* ring = dss + kBuffer;                     // stages: K, V [key][d]
  float* g2t = ring + kStages * 2 * kStreamed;     // K7: G2^T [d][query]
  float* v2s = g2t + kResident;                    // K7: V^2 [key][d]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = blockIdx.x * kRows;
  const long long b = blockIdx.z, hoff = blockIdx.y * kD;
  const long long bh = b * gridDim.y + blockIdx.y;
  const float* kb = a.k + b * a.kv_bs + hoff;
  const float* vb = a.v + b * a.kv_bs + hoff;
  const int tiles = (a.m + kTile - 1) / kTile;

  // The first key tile flies while the resident rows load.
  copy_rows(ring, kb, a.kv_rs, 0, a.m);
  copy_rows(ring + kStreamed, vb, a.kv_rs, 0, a.m);
  mma::cp_async_commit();
  load_resident(qt, a.q + b * a.q_bs + hoff, a.q_rs, q0, a.n);
  load_resident(g1t, a.g1 + b * a.g_bs + hoff, a.g_rs, q0, a.n);
  if (kMhada) load_resident(g2t, a.g2 + b * a.g_bs + hoff, a.g_rs, q0, a.n);
  // lse and delta in registers, lse in log2 units; rows past n: lse = +inf
  float lse2[8], dlt[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = q0 + row_of(ty, i);
    const bool ok = row < a.n;
    lse2[i] = ok ? a.lse[bh * a.n + row] * kLog2e : INFINITY;
    dlt[i] = ok ? a.delta[bh * a.n + row] : 0.f;
  }
  const float c = a.scale * kLog2e;

  float dq[8][4];
  zero(dq);
  for (int t = 0; t < tiles; ++t) {
    const float* ks = ring + (t % kStages) * 2 * kStreamed;
    const float* vs = ks + kStreamed;
    mma::cp_async_wait<0>();  // tile t has landed
    // Tile t (and the resident rows) are visible; every read of tile t - 1,
    // of dS and of V^2 is done.
    __syncthreads();
    if (t + 1 < tiles) {
      float* next = ring + ((t + 1) % kStages) * 2 * kStreamed;
      copy_rows(next, kb, a.kv_rs, (t + 1) * kTile, a.m);
      copy_rows(next + kStreamed, vb, a.kv_rs, (t + 1) * kTile, a.m);
    }
    mma::cp_async_commit();  // possibly empty: one group per iteration
    if (kMhada) {  // V^2 of the tile, once
#pragma unroll
      for (int r = 0; r < kTile * kD / 4 / kThreads; ++r) {
        const int idx = threadIdx.x + r * kThreads;
        const int o = (idx / 16) * kSS + 4 * (idx % 16);
        st4(v2s + o, square(ld4(vs + o)));
      }
    }
    float s[8][4], dp[8][4];
    zero(s);
    zero(dp);
    product<false>(qt, ks, s);
    product<false>(g1t, vs, dp);
    if (kMhada) {
      __syncthreads();  // V^2 is visible
      product<false>(g2t, v2s, dp);
    }
    const bool ragged = (t + 1) * kTile > a.m;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool key_ok = !ragged || t * kTile + tx + 16 * j < a.m;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float p = key_ok ? exp2_ftz(fmaf(s[i][j], c, -lse2[i])) : 0.f;
        s[i][j] = p * (dp[i][j] - dlt[i]) * a.scale;  // dS
      }
    }
    store_buffer(dss, s);
    __syncthreads();  // dS is visible
    accumulate<false>(dss, ks, nullptr, dq, dq);
  }
  store_rows(a.dq + b * a.dq_bs + hoff, a.dq_rs, q0, a.n, dq);
}

// dK and dV of 128 key rows: the query tiles (Q, G1, G2) stream through
// the ring; lse and delta of the tile's queries are loaded to registers as
// it starts and land during the products.
template <bool kMhada>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_f32_dkv_kernel(BwdArgs a) {
  constexpr int kStage = (kMhada ? 3 : 2) * kStreamed;
  extern __shared__ float4 bwd_smem[];
  float* kt = reinterpret_cast<float*>(bwd_smem);  // K^T [d][key]
  float* vt = kt + kResident;                      // V^T [d][key]
  float* ps = vt + kResident;                      // P   [query][key]
  float* dss = kMhada ? ps : ps + kBuffer;         // dS  [query][key]
  float* ring = dss + kBuffer;                     // stages: Q, G1, (G2)
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int k0 = blockIdx.x * kRows;
  const long long b = blockIdx.z, hoff = blockIdx.y * kD;
  const long long bh = b * gridDim.y + blockIdx.y;
  const float* qb = a.q + b * a.q_bs + hoff;
  const float* g1b = a.g1 + b * a.g_bs + hoff;
  const float* g2b = kMhada ? a.g2 + b * a.g_bs + hoff : nullptr;
  const int tiles = (a.n + kTile - 1) / kTile;

  // The first query tile flies while the resident rows load.
  copy_rows(ring, qb, a.q_rs, 0, a.n);
  copy_rows(ring + kStreamed, g1b, a.g_rs, 0, a.n);
  if (kMhada) copy_rows(ring + 2 * kStreamed, g2b, a.g_rs, 0, a.n);
  mma::cp_async_commit();
  load_resident(kt, a.k + b * a.kv_bs + hoff, a.kv_rs, k0, a.m);
  load_resident(vt, a.v + b * a.kv_bs + hoff, a.kv_rs, k0, a.m);
  const float c = a.scale * kLog2e;

  float dk[8][4], dv[8][4], dv2[8][4];
  zero(dk);
  zero(dv);
  zero(dv2);
  for (int t = 0; t < tiles; ++t) {
    const float* qs = ring + (t % kStages) * kStage;
    const float* g1s = qs + kStreamed;
    const float* g2s = g1s + kStreamed;
    float lse2[4], dlt[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = t * kTile + tx + 16 * j;
      const bool ok = row < a.n;
      lse2[j] = ok ? a.lse[bh * a.n + row] * kLog2e : INFINITY;
      dlt[j] = ok ? a.delta[bh * a.n + row] : 0.f;
    }
    mma::cp_async_wait<0>();  // tile t has landed
    // Tile t (and the resident rows) are visible; every read of tile t - 1
    // and of P and dS is done.
    __syncthreads();
    if (t + 1 < tiles) {
      float* next = ring + ((t + 1) % kStages) * kStage;
      const int r0 = (t + 1) * kTile;
      copy_rows(next, qb, a.q_rs, r0, a.n);
      copy_rows(next + kStreamed, g1b, a.g_rs, r0, a.n);
      if (kMhada) copy_rows(next + 2 * kStreamed, g2b, a.g_rs, r0, a.n);
    }
    mma::cp_async_commit();  // possibly empty: one group per iteration
    float s[8][4], dp[8][4];  // S^T and dP^T: keys by queries
    zero(s);
    zero(dp);
    product<false>(kt, qs, s);
    product<false>(vt, g1s, dp);
    if (kMhada) product<true>(vt, g2s, dp);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = exp2_ftz(fmaf(s[i][j], c, -lse2[j]));
        s[i][j] = p;
        dp[i][j] = p * (dp[i][j] - dlt[j]) * a.scale;  // dS^T
      }
    store_buffer(ps, s);
    if (!kMhada) store_buffer(dss, dp);
    __syncthreads();  // P (K6: and dS) is visible
    accumulate<kMhada>(ps, g1s, g2s, dv, dv2);
    if (kMhada) {
      __syncthreads();  // every read of P is done
      store_buffer(dss, dp);
      __syncthreads();  // dS is visible
    }
    accumulate<false>(dss, qs, nullptr, dk, dk);
  }
  if (kMhada) {  // dV = P^T G1 + 2 V * (P^T G2)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dv[i][j] += 2.f * vt[(4 * tx + j) * kRS + row_of(ty, i)] * dv2[i][j];
  }
  store_rows(a.dk + b * a.dkv_bs + hoff, a.dkv_rs, k0, a.m, dk);
  store_rows(a.dv + b * a.dkv_bs + hoff, a.dkv_rs, k0, a.m, dv);
}

// Both kernels on the caller's stream: dK and dV first, then dQ.  The
// entry points refuse misaligned operands (f32t::f32_aligned: pointers and
// channels, so every stride too).
template <bool kMhada>
cudaError_t launch_flash_bwd_f32(const BwdArgs& a, int heads, int batch,
                                 cudaStream_t stream) {
  if (a.n < 1 || a.m < 1) return cudaErrorInvalidValue;
  cudaError_t err = launch_with_smem(
      flash_bwd_f32_dkv_kernel<kMhada>,
      dim3((a.m + kRows - 1) / kRows, heads, batch), dim3(kThreads),
      dkv_smem_bytes(kMhada), stream, a);
  if (err != cudaSuccess) return err;
  return launch_with_smem(flash_bwd_f32_dq_kernel<kMhada>,
                          dim3((a.n + kRows - 1) / kRows, heads, batch),
                          dim3(kThreads), dq_smem_bytes(kMhada), stream, a);
}

}  // namespace f32b
}  // namespace mhada
