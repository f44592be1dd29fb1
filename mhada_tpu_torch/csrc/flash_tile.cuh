// Single-head, 64-wide attention tile with an online softmax on the CUDA
// cores, at float32, for the MHAda training forward (mhada_train.cu, K7)
// and the ViT self-attention (attention_fwd.cu, K1; attention_train.cu,
// K6's forward): at bfloat16 those run on the tensor cores
// (attention_mma.cuh, mhada_mma.cuh).  The training forwards also write the
// backward's residuals.  K4's and K3's float32 builds (and the probe P2's)
// run the register-tiled MHAda tile of mhada_f32_tile.cuh instead.
//
// One block owns (batch b, head h, a tile of kBQ = 64 queries) and loops
// over the keys in tiles of kBK = 64 held in shared memory; nothing of the
// (N, M) score matrix reaches device memory.  Operands are read straight
// from token-major (rows, channels) tensors at channel offset h * 64, so no
// head-split copies exist.  Accumulators are float32 in registers.  The
// key loop has no length cap: L = M = 16384 (1024^2) runs through the same
// loop as 4096.  Offsets of batch and row are formed in 64 bits.
//
// The 256 threads form a 16 x 16 grid (ty, tx).  A thread owns score and
// output rows ty + 16 i (i < 4) and key / channel columns tx + 16 j
// (j < 4); the 16 threads of one row are one half-warp, so row max and row
// sum reduce with xor shuffles inside it.
#pragma once

#include <math.h>

#include "common.cuh"

namespace mhada {

constexpr int kHeadDim = 64;
constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kFlashThreads = 256;
constexpr int kTPad = 65;  // odd row stride of the transposed tiles

// Shared memory: Q^T and K^T (d-major), V (key-major), P^T (key-major).
constexpr size_t kFlashSmemBytes =
    sizeof(float) * (2 * kHeadDim * kTPad + kBK * kHeadDim + kBK * kTPad);

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* f;  // MHAda only: instance-normed fcs (K4) or raw fcs (K3)
  void* out;
  int n, m;       // query rows, key rows
  long long q_bs, q_rs, kv_bs, kv_rs, f_bs, f_rs, o_bs, o_rs;  // strides
  float scale;
  // Training forwards only (kRes): the row log-sum-exp of the scaled
  // logits, (B, heads, n) float32; MHAda also M1 and E2, float32 at the
  // output's strides.
  float* lse;
  float* m1;
  float* e2;
};

struct FlashSmem {
  float* qs;  // [d][kTPad]   query r at column r
  float* ks;  // [d][kTPad]   key c at column c
  float* vs;  // [key][d]
  float* ps;  // [key][kTPad] probability of row r
};

__device__ __forceinline__ FlashSmem flash_smem(float* smem) {
  FlashSmem s;
  s.qs = smem;
  s.ks = s.qs + kHeadDim * kTPad;
  s.vs = s.ks + kHeadDim * kTPad;
  s.ps = s.vs + kBK * kHeadDim;
  return s;
}

// One thread's accumulators: sum_k p V (o1), sum_k p V^2 (o2, MHAda only),
// the running row max and row sum of p.
struct FlashAcc {
  float o1[4][4], o2[4][4], mrow[4], lrow[4];
};

__device__ __forceinline__ void flash_init(FlashAcc& acc) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc.mrow[i] = -INFINITY;
    acc.lrow[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc.o1[i][j] = acc.o2[i][j] = 0.f;
  }
}

// This thread's scores of one key tile: sc[i][j] = q(ty + 16 i) .
// k(tx + 16 j), from Q^T in qs and key c's channel d at
// ks[c * kKeyStride + d * kDStride] (K^T in float32, or K as stored).
template <int kKeyStride, int kDStride, typename K>
__device__ __forceinline__ void flash_scores(const float* qs, const K* ks,
                                             float (&sc)[4][4]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < kHeadDim; ++d) {
    float qv[4], kv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) qv[i] = qs[d * kTPad + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      kv[j] = to_f32(ks[(tx + 16 * j) * kKeyStride + d * kDStride]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
  }
}

// The online softmax over the key tile at k0: keys past a.m are masked,
// P^T goes to ps (key-major), and the running max, sum and accumulators
// are rescaled.
template <bool kMhada>
__device__ __forceinline__ void flash_softmax(const FlashArgs& a, int k0,
                                              float (&sc)[4][4], float* ps,
                                              FlashAcc& acc) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (k0 + tx + 16 * j >= a.m) sc[i][j] = -INFINITY;
      mx = fmaxf(mx, sc[i][j]);
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_new = fmaxf(acc.mrow[i], mx);  // finite: key k0 is valid
    const float alpha = expf(acc.mrow[i] - m_new);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float p = expf(sc[i][j] - m_new);
      sum += p;
      ps[(tx + 16 * j) * kTPad + ty + 16 * i] = p;
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    acc.lrow[i] = acc.lrow[i] * alpha + sum;
    acc.mrow[i] = m_new;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc.o1[i][j] *= alpha;
      if (kMhada) acc.o2[i][j] *= alpha;
    }
  }
}

// acc += P V (and P V^2) over one key tile: P^T in ps, V key-major at
// vs[c * kHeadDim + d] (float32, or as stored).
template <bool kMhada, typename V>
__device__ __forceinline__ void flash_pv(const float* ps, const V* vs,
                                         FlashAcc& acc) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll 4
  for (int c = 0; c < kBK; ++c) {
    float pv[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) pv[i] = ps[c * kTPad + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < 4; ++j) vv[j] = to_f32(vs[c * kHeadDim + tx + 16 * j]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc.o1[i][j] = fmaf(pv[i], vv[j], acc.o1[i][j]);
        if (kMhada) acc.o2[i][j] = fmaf(pv[i], vv[j] * vv[j], acc.o2[i][j]);
      }
  }
}

// The key loop.  On entry s.qs holds the block's query tile, scale applied
// (written before this call; the loop's first __syncthreads publishes it).
// kMhada = false accumulates softmax(Q K^T) V; kMhada = true also A V^2.
// Both are left unnormalised: divide by acc.lrow.
template <typename T, bool kMhada>
__device__ __forceinline__ void flash_keys(const FlashArgs& a,
                                           const FlashSmem& s, FlashAcc& acc) {
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const int tid = threadIdx.x;
  const int hoff = blockIdx.y * kHeadDim;
  const long long b = blockIdx.z;

  flash_init(acc);
  for (int k0 = 0; k0 < a.m; k0 += kBK) {
    for (int idx = tid; idx < kBK * kHeadDim; idx += kFlashThreads) {
      const int c = idx / kHeadDim, d = idx % kHeadDim;
      const int key = k0 + c;
      float kx = 0.f, vx = 0.f;
      if (key < a.m) {
        const long long off = b * a.kv_bs + key * a.kv_rs + hoff + d;
        kx = to_f32(k[off]);
        vx = to_f32(v[off]);
      }
      s.ks[d * kTPad + c] = kx;
      s.vs[c * kHeadDim + d] = vx;
    }
    __syncthreads();
    float sc[4][4];
    flash_scores<1, kTPad>(s.qs, s.ks, sc);
    flash_softmax<kMhada>(a, k0, sc, s.ps, acc);
    __syncthreads();
    flash_pv<kMhada>(s.ps, s.vs, acc);
    __syncthreads();
  }
}

// kMhada = false: out = softmax(scale Q K^T) V.
// kMhada = true:  A = softmax(Q K^T) (scale 1), M1 = A V, E2 = A V^2,
//                 out = sqrt(max(E2 - M1^2, 1e-6)) * f + M1.
// kRes = true also writes lse (and M1, E2) for the backward.
template <typename T, bool kMhada, bool kRes = false>
__global__ void __launch_bounds__(kFlashThreads)
    flash_tile_kernel(FlashArgs a) {
  extern __shared__ float smem[];
  const FlashSmem s = flash_smem(smem);

  const T* q = static_cast<const T*>(a.q);
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * kBQ;
  const int hoff = blockIdx.y * kHeadDim;
  const long long b = blockIdx.z;

  for (int idx = tid; idx < kBQ * kHeadDim; idx += kFlashThreads) {
    const int r = idx / kHeadDim, d = idx % kHeadDim;
    const int row = q0 + r;
    float x = 0.f;
    if (row < a.n) x = to_f32(q[b * a.q_bs + row * a.q_rs + hoff + d]) * a.scale;
    s.qs[d * kTPad + r] = x;
  }

  FlashAcc acc;
  flash_keys<T, kMhada>(a, s, acc);

  const T* f = static_cast<const T*>(a.f);
  T* out = static_cast<T*>(a.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= a.n) continue;
    const float inv = 1.f / acc.lrow[i];
    if (kRes && tx == 0)
      a.lse[(b * gridDim.y + blockIdx.y) * a.n + row] =
          acc.mrow[i] + logf(acc.lrow[i]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int d = tx + 16 * j;
      const long long o = b * a.o_bs + row * a.o_rs + hoff + d;
      float y = acc.o1[i][j] * inv;
      if (kMhada) {
        // E2 - M1^2 cancels: both stay float32 until the clamp.
        const float e2 = acc.o2[i][j] * inv;
        if (kRes) {
          a.m1[o] = y;
          a.e2[o] = e2;
        }
        const float var = fmaxf(e2 - y * y, 1e-6f);
        y = sqrtf(var) * to_f32(f[b * a.f_bs + row * a.f_rs + hoff + d]) + y;
      }
      out[o] = from_f32<T>(y);
    }
  }
}

template <typename T, bool kMhada, bool kRes = false>
cudaError_t launch_flash_tile(const FlashArgs& a, int heads, int batch,
                              cudaStream_t stream) {
  const dim3 grid((a.n + kBQ - 1) / kBQ, heads, batch);
  return launch_with_smem(flash_tile_kernel<T, kMhada, kRes>, grid,
                          dim3(kFlashThreads), kFlashSmemBytes, stream, a);
}

}  // namespace mhada
