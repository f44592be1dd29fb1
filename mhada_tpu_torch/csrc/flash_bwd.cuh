// Backward of the 64-wide attention tile on the CUDA cores, shared by the
// MHAda core (mhada_train.cu, K7) at float32 and bfloat16 and the ViT
// self-attention (attention_train.cu, K6) at float32 only: K6's bfloat16
// backward runs on the tensor cores (attention_bwd_mma.cuh).
//
// Per head, with P rebuilt from the forward's row log-sum-exp:
//
//   S  = scale Q K^T,  P = exp(S - lse)            (keys >= m masked to 0)
//   dP = G1 V^T                       K6: G1 = dO
//   dP = G1 V^T + G2 (V^2)^T          K7: G1 = dM1, G2 = dE2
//   dS = P * (dP - delta) * scale     delta per row, computed by the wrapper
//   dQ = dS K,  dK = dS^T Q
//   dV = P^T G1                       K6
//   dV = P^T G1 + 2 V * (P^T G2)      K7 (mhada_pallas.py:415-421)
//
// The TPU kernels accumulate dK and dV across a sequential query-block grid
// axis in VMEM scratch.  Hopper blocks run in no order, so this is the
// FlashAttention-2 split instead, with no atomics (the result does not
// depend on scheduling): `flash_bwd_dkv_kernel` owns (64-key tile, head,
// batch) and loops over the query tiles; `flash_bwd_dq_kernel` owns
// (64-query tile, head, batch) and loops over the key tiles, rebuilding P.
// Every operand is read in place from token-major (rows, channels) tensors
// at channel offset h * 64, and every gradient is written the same way.
//
// Rounding follows the JAX backward (attention_pallas.py:256-312,
// mhada_pallas.py:362-421): P is rounded to T before P^T G, dS before dS K
// and dS^T Q; the products accumulate in float32.
//
// The 256 threads form the 16 x 16 grid of flash_tile.cuh: a thread owns
// rows ty + 16 i and columns tx + 16 j of each 64 x 64 tile.  Tiles are
// held transposed, [d][row] with the odd row stride kTPad, so that both the
// row-broadcast and the column reads are free of bank conflicts.
#pragma once

#include "flash_tile.cuh"

namespace mhada {

constexpr int kTile = kHeadDim * kTPad;  // floats in one transposed tile

struct FlashBwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* g1;      // dO (K6) or dM1 (K7), at the query rows' strides
  const void* g2;      // dE2 (K7 only)
  const float* lse;    // (B, heads, n)
  const float* delta;  // (B, heads, n)
  void* dq;
  void* dk;
  void* dv;
  int n, m;  // query rows, key rows
  long long q_bs, q_rs, kv_bs, kv_rs, g_bs, g_rs, dq_bs, dq_rs, dkv_bs,
      dkv_rs;  // strides
  float scale;
};

// Shared memory of each kernel: (5 + kMhada) transposed tiles.
template <bool kMhada>
constexpr size_t flash_bwd_smem_bytes() {
  return sizeof(float) * kTile * (kMhada ? 6 : 5);
}

// 64 rows starting at r0 of a token-major tensor (channel offset hoff) into
// dst[d * kTPad + r]; rows at or past `rows` read as 0.
template <typename T>
__device__ __forceinline__ void load_tile_t(float* dst, const void* src,
                                            long long base, long long rs,
                                            int r0, int rows, int hoff) {
  const T* p = static_cast<const T*>(src);
  for (int idx = threadIdx.x; idx < kBQ * kHeadDim; idx += kFlashThreads) {
    const int r = idx / kHeadDim, d = idx % kHeadDim;
    const int row = r0 + r;
    float x = 0.f;
    if (row < rows) x = to_f32(p[base + row * rs + hoff + d]);
    dst[d * kTPad + r] = x;
  }
}

// The row statistics of 64 query rows; rows past n get lse = +inf, so that
// their P is exactly 0.
__device__ __forceinline__ void load_rows(float* lse_s, float* delta_s,
                                          const FlashBwdArgs& a, long long bh,
                                          int r0) {
  const int t = threadIdx.x;
  if (t < kBQ) {
    const int row = r0 + t;
    lse_s[t] = row < a.n ? a.lse[bh * a.n + row] : INFINITY;
    delta_s[t] = row < a.n ? a.delta[bh * a.n + row] : 0.f;
  }
}

template <typename T, bool kMhada>
__global__ void __launch_bounds__(kFlashThreads)
    flash_bwd_dkv_kernel(FlashBwdArgs a) {
  extern __shared__ float smem[];
  __shared__ float lse_s[kBQ], delta_s[kBQ];
  float* kt = smem;          // K^T  [d][key]
  float* vt = kt + kTile;    // V^T  [d][key]
  float* qt = vt + kTile;    // Q^T  [d][query]
  float* g1t = qt + kTile;   // G1^T [d][query]
  float* ps = g1t + kTile;   // P, then dS: [query][key]
  float* g2t = ps + kTile;   // G2^T [d][query], K7 only

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int k0 = blockIdx.x * kBK;
  const int hoff = blockIdx.y * kHeadDim;
  const long long b = blockIdx.z;
  const long long bh = b * gridDim.y + blockIdx.y;

  load_tile_t<T>(kt, a.k, b * a.kv_bs, a.kv_rs, k0, a.m, hoff);
  load_tile_t<T>(vt, a.v, b * a.kv_bs, a.kv_rs, k0, a.m, hoff);

  float dk[4][4], dv1[4][4], dv2[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dk[i][j] = dv1[i][j] = dv2[i][j] = 0.f;

  for (int q0 = 0; q0 < a.n; q0 += kBQ) {
    __syncthreads();  // the previous tile's readers are done
    load_tile_t<T>(qt, a.q, b * a.q_bs, a.q_rs, q0, a.n, hoff);
    load_tile_t<T>(g1t, a.g1, b * a.g_bs, a.g_rs, q0, a.n, hoff);
    if (kMhada) load_tile_t<T>(g2t, a.g2, b * a.g_bs, a.g_rs, q0, a.n, hoff);
    load_rows(lse_s, delta_s, a, bh, q0);
    __syncthreads();

    // S^T and dP^T: key rows ty + 16 i, query columns tx + 16 j.
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < kHeadDim; ++d) {
      float kv[4], vv[4], qv[4], gv[4], g2v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kv[i] = kt[d * kTPad + ty + 16 * i];
        vv[i] = vt[d * kTPad + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qv[j] = qt[d * kTPad + tx + 16 * j];
        gv[j] = g1t[d * kTPad + tx + 16 * j];
        g2v[j] = kMhada ? g2t[d * kTPad + tx + 16 * j] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
          dp[i][j] = fmaf(vv[i], gv[j], dp[i][j]);
          if (kMhada) dp[i][j] = fmaf(vv[i] * vv[i], g2v[j], dp[i][j]);
        }
    }

    // P into shared memory; dS kept in registers.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool key_ok = k0 + ty + 16 * i < a.m;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float p = key_ok ? expf(s[i][j] * a.scale - lse_s[c]) : 0.f;
        ps[c * kTPad + ty + 16 * i] = round_to<T>(p);
        s[i][j] = round_to<T>(p * (dp[i][j] - delta_s[c]) * a.scale);
      }
    }
    __syncthreads();

    // dV += P^T G1 (and P^T G2): key rows ty + 16 i, channels tx + 16 j.
#pragma unroll 4
    for (int c = 0; c < kBQ; ++c) {
      float pv[4], gv[4], g2v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[c * kTPad + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        gv[j] = g1t[(tx + 16 * j) * kTPad + c];
        g2v[j] = kMhada ? g2t[(tx + 16 * j) * kTPad + c] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          dv1[i][j] = fmaf(pv[i], gv[j], dv1[i][j]);
          if (kMhada) dv2[i][j] = fmaf(pv[i], g2v[j], dv2[i][j]);
        }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ps[(tx + 16 * j) * kTPad + ty + 16 * i] = s[i][j];
    __syncthreads();

    // dK += dS^T Q.
#pragma unroll 4
    for (int c = 0; c < kBQ; ++c) {
      float dsv[4], qv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = ps[c * kTPad + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) qv[j] = qt[(tx + 16 * j) * kTPad + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dk[i][j] = fmaf(dsv[i], qv[j], dk[i][j]);
    }
  }

  T* dkp = static_cast<T*>(a.dk);
  T* dvp = static_cast<T*>(a.dv);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int key = k0 + r;
    if (key >= a.m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int d = tx + 16 * j;
      const long long o = b * a.dkv_bs + key * a.dkv_rs + hoff + d;
      float dv = dv1[i][j];
      if (kMhada) dv += 2.f * vt[d * kTPad + r] * dv2[i][j];
      dkp[o] = from_f32<T>(dk[i][j]);
      dvp[o] = from_f32<T>(dv);
    }
  }
}

template <typename T, bool kMhada>
__global__ void __launch_bounds__(kFlashThreads)
    flash_bwd_dq_kernel(FlashBwdArgs a) {
  extern __shared__ float smem[];
  __shared__ float lse_s[kBQ], delta_s[kBQ];
  float* qt = smem;          // Q^T  [d][query]
  float* g1t = qt + kTile;   // G1^T [d][query]
  float* kt = g1t + kTile;   // K^T  [d][key]
  float* vt = kt + kTile;    // V^T  [d][key]
  float* ps = vt + kTile;    // dS   [key][query]
  float* g2t = ps + kTile;   // G2^T [d][query], K7 only

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * kBQ;
  const int hoff = blockIdx.y * kHeadDim;
  const long long b = blockIdx.z;
  const long long bh = b * gridDim.y + blockIdx.y;

  load_tile_t<T>(qt, a.q, b * a.q_bs, a.q_rs, q0, a.n, hoff);
  load_tile_t<T>(g1t, a.g1, b * a.g_bs, a.g_rs, q0, a.n, hoff);
  if (kMhada) load_tile_t<T>(g2t, a.g2, b * a.g_bs, a.g_rs, q0, a.n, hoff);
  load_rows(lse_s, delta_s, a, bh, q0);

  float dq[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dq[i][j] = 0.f;

  for (int k0 = 0; k0 < a.m; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    load_tile_t<T>(kt, a.k, b * a.kv_bs, a.kv_rs, k0, a.m, hoff);
    load_tile_t<T>(vt, a.v, b * a.kv_bs, a.kv_rs, k0, a.m, hoff);
    __syncthreads();

    // S and dP: query rows ty + 16 i, key columns tx + 16 j.
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < kHeadDim; ++d) {
      float qv[4], gv[4], g2v[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = qt[d * kTPad + ty + 16 * i];
        gv[i] = g1t[d * kTPad + ty + 16 * i];
        g2v[i] = kMhada ? g2t[d * kTPad + ty + 16 * i] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = kt[d * kTPad + tx + 16 * j];
        vv[j] = vt[d * kTPad + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
          if (kMhada) dp[i][j] = fmaf(g2v[i], vv[j] * vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float p =
            k0 + c < a.m ? expf(s[i][j] * a.scale - lse_s[r]) : 0.f;
        ps[c * kTPad + r] =
            round_to<T>(p * (dp[i][j] - delta_s[r]) * a.scale);
      }
    }
    __syncthreads();

    // dQ += dS K: query rows ty + 16 i, channels tx + 16 j.
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float dsv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = ps[c * kTPad + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = kt[(tx + 16 * j) * kTPad + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dq[i][j] = fmaf(dsv[i], kv[j], dq[i][j]);
    }
  }

  T* dqp = static_cast<T*>(a.dq);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= a.n) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      dqp[b * a.dq_bs + row * a.dq_rs + hoff + tx + 16 * j] =
          from_f32<T>(dq[i][j]);
  }
}

// Both kernels on the caller's stream: dK and dV first, then dQ.
template <typename T, bool kMhada>
cudaError_t launch_flash_bwd(const FlashBwdArgs& a, int heads, int batch,
                             cudaStream_t stream) {
  constexpr size_t smem = flash_bwd_smem_bytes<kMhada>();
  cudaError_t err = launch_with_smem(
      flash_bwd_dkv_kernel<T, kMhada>, dim3((a.m + kBK - 1) / kBK, heads,
                                            batch),
      dim3(kFlashThreads), smem, stream, a);
  if (err != cudaSuccess) return err;
  return launch_with_smem(flash_bwd_dq_kernel<T, kMhada>,
                          dim3((a.n + kBQ - 1) / kBQ, heads, batch),
                          dim3(kFlashThreads), smem, stream, a);
}

}  // namespace mhada
