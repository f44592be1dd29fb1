// K3: one MHAda block's core on cached style K/V, with the instance norm
// and the Q projection fused into the prologue and IN(fcs) into the
// epilogue.
//
// Replaces mhada_tpu/ops/mhada_pallas.py::mhada_fused_prologue
// (_fused_kernel, pallas_call at mhada_pallas.py:239), which
// AdaAttnMultiHead runs when the style K/V are cached
// (mhada_tpu/models/adaformer.py:80-97).  Per head h, with the float32
// per-channel stats [mean_fc, rstd_fc, mean_fcs, rstd_fcs]:
//
//   qn  = (fc - mean_fc) * rstd_fc               float32, rounded to T
//   q   = qn Wf_h + fb_h                         float32, rounded to T
//   A   = softmax(q K^T)                         UNSCALED
//   M1  = A V,  E2 = A V^2                       float32
//   out = sqrt(max(E2 - M1^2, 1e-6)) * (fcs - mean_fcs) * rstd_fcs + M1
//
// fc, fcs and out are token-major (B, N, C), k and v (B, M, C), stats
// (B, 4, C) float32, wf (H, 64, 64) as (in, out) in T, fb (H, 64) float32.
//
// Design: the block is K4's tile (flash_tile.cuh).  The prologue loads the
// block's 64 raw fc rows of head h, normalises them with the stats into
// the P^T buffer (unused until the first key tile) and multiplies them by
// Wf_h, staged in shared memory (16 KB at float32 on top of the tile's
// 65 KB), into the Q^T buffer.  The key loop is K4's, unscaled.  The
// epilogue normalises raw fcs with the stats.  Neither q nor IN(fcs) ever
// reaches device memory, which is what the TPU kernel kept out of HBM.
// The TPU kernel packed two heads' Wf into 128 lanes and concatenated
// [V | V^2] to fill its MXU; neither exists here (V^2 is formed in
// registers).  The TPU kernel holds every key in VMEM, so its call site
// caps M at 4096; this one streams the keys, so every cached-K/V block
// runs here, M = 16384 (1024^2) included.
//
// What bounds it on the card: 6 N M d flops per head for the attention and
// 2 N d^2 for the projection (51.5 + 0.3 GFLOP at N = M = 4096, 8 heads)
// against (3 N + 2 M) C element reads and writes: compute-bound.  This
// first version runs float32 FMAs on the CUDA cores, not the tensor cores.

#include "flash_tile.cuh"

namespace {

using mhada::FlashAcc;
using mhada::FlashArgs;
using mhada::FlashSmem;
using mhada::kBQ;
using mhada::kFlashThreads;
using mhada::kHeadDim;
using mhada::kTPad;

constexpr size_t kSmemBytes =
    mhada::kFlashSmemBytes + sizeof(float) * kHeadDim * kHeadDim;

template <typename T>
__global__ void __launch_bounds__(kFlashThreads)
    mhada_prologue_kernel(FlashArgs a, const float* __restrict__ stats,
                          const T* __restrict__ wf,
                          const float* __restrict__ fb, int channels) {
  extern __shared__ float smem[];
  const FlashSmem s = mhada::flash_smem(smem);
  float* wfs = s.ps + mhada::kBK * kTPad;  // [d_in][d_out]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * kBQ;
  const int hoff = blockIdx.y * kHeadDim;
  const long long b = blockIdx.z;
  // Rows of this batch's stats at head h's channels.
  const float* mean_fc = stats + b * 4 * channels + hoff;
  const float* rstd_fc = mean_fc + channels;
  const float* mean_fcs = mean_fc + 2 * channels;
  const float* rstd_fcs = mean_fc + 3 * channels;

  const T* w = wf + (long long)blockIdx.y * kHeadDim * kHeadDim;
  for (int idx = tid; idx < kHeadDim * kHeadDim; idx += kFlashThreads)
    wfs[idx] = mhada::to_f32(w[idx]);

  // qn^T (d-major) into the P^T buffer.
  const T* fc = static_cast<const T*>(a.q);
  for (int idx = tid; idx < kBQ * kHeadDim; idx += kFlashThreads) {
    const int r = idx / kHeadDim, d = idx % kHeadDim;
    const int row = q0 + r;
    float x = 0.f;
    if (row < a.n) {
      const float raw = mhada::to_f32(fc[b * a.q_bs + row * a.q_rs + hoff + d]);
      x = mhada::round_to<T>((raw - mean_fc[d]) * rstd_fc[d]);
    }
    s.ps[d * kTPad + r] = x;
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
    for (int i = 0; i < 4; ++i) xv[i] = s.ps[d * kTPad + ty + 16 * i];
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
      s.qs[e * kTPad + ty + 16 * i] = mhada::round_to<T>(qa[i][j] + fbh[e]);
    }
  // No barrier here: flash_keys' first __syncthreads publishes Q^T, and it
  // writes P^T only after that barrier, when every qn read is done.

  FlashAcc acc;
  mhada::flash_keys<T, true>(a, s, acc);

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
      const float raw =
          mhada::to_f32(fcs[b * a.f_bs + row * a.f_rs + hoff + d]);
      const float fn = (raw - mean_fcs[d]) * rstd_fcs[d];
      out[b * a.o_bs + row * a.o_rs + hoff + d] =
          mhada::from_f32<T>(sd * fn + m1);
    }
  }
}

template <typename T>
cudaError_t mhada_prologue(const void* fc, const void* fcs,
                           const float* stats, const void* wf,
                           const float* fb, const void* k, const void* v,
                           void* out, int batch, int n, int m, int channels,
                           int heads, cudaStream_t stream) {
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
  const dim3 grid((n + kBQ - 1) / kBQ, heads, batch);
  return mhada::launch_with_smem(mhada_prologue_kernel<T>, grid,
                                 dim3(kFlashThreads), kSmemBytes, stream, a,
                                 stats, static_cast<const T*>(wf), fb,
                                 channels);
}

}  // namespace

// fc, fcs, out (B, N, C), k, v (B, M, C) and wf (H, 64, 64) in T; stats
// (B, 4, C) and fb (H, 64) float32.
extern "C" int mhada_mhada_prologue(const void* fc, const void* fcs,
                                    const void* stats, const void* wf,
                                    const void* fb, const void* k,
                                    const void* v, void* out, int batch,
                                    int n, int m, int channels, int heads,
                                    int dtype, void* stream) {
  MHADA_DISPATCH_DTYPE(
      dtype, T,
      return (int)mhada_prologue<T>(fc, fcs, static_cast<const float*>(stats),
                                    wf, static_cast<const float*>(fb), k, v,
                                    out, batch, n, m, channels, heads,
                                    (cudaStream_t)stream));
}
