// K2: LayerNorm fused into the following matmul, out = LN(x) W^T + b.
//
// Replaces mhada_tpu/ops/ln_matmul_pallas.py::_ln_matmul_pallas
// (_ln_matmul_kernel, pallas_call at ln_matmul_pallas.py:44): the ViT's
// ln1 -> qkv (512 -> 1536) and ln2 -> fc1 (512 -> 2048) projections.
//
// A block owns kBM = 64 rows and kBN = 64 output columns.  It takes the LN
// statistics of its rows over E in float32 (two-pass mean and biased
// variance, eps from the caller), writes the normalised, affine-applied
// rows into shared memory rounded to T (the point where the plain path
// casts the LN output), and runs the product against W (F, E) in chunks of
// 32 along E with a float32 accumulator.  The statistics are recomputed
// by each column tile; the normalised tensor never reaches device memory,
// which is the point of the TPU kernel (ln_matmul_pallas.py:1-13).
//
// What bounds it on the card: 2 N E F flops (6.4 / 8.6 GFLOP at
// N = 4096, E = 512, F = 1536 / 2048) against N (E + F) + E F element
// traffic, so it is compute-bound; this first version uses float32 FMAs on
// the CUDA cores, not the tensor cores.

#include "common.cuh"

namespace {

constexpr int kBM = 64, kBN = 64, kBK = 32, kThreads = 256;
constexpr int kHPad = 4;      // row padding of the normalised tile
constexpr int kWPad = kBN + 1;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ln_matmul_kernel(const T* __restrict__ x, const float* __restrict__ ln_w,
                     const float* __restrict__ ln_b, const T* __restrict__ w,
                     const float* __restrict__ bias, T* __restrict__ out,
                     int rows, int e, int f, float eps) {
  extern __shared__ float smem[];
  float* ws = smem;                                  // [kBK][kWPad]
  T* hs = reinterpret_cast<T*>(ws + kBK * kWPad);    // [kBM][e + kHPad]
  const int hstride = e + kHPad;

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int r0 = blockIdx.y * kBM;
  const int c0 = blockIdx.x * kBN;

  // LayerNorm prologue: warp `warp` normalises rows warp, warp + 8, ...
  for (int r = warp; r < kBM; r += kThreads / 32) {
    const int row = r0 + r;
    T* hrow = hs + r * hstride;
    if (row >= rows) {
      for (int c = lane; c < e; c += 32) hrow[c] = mhada::from_f32<T>(0.f);
      continue;
    }
    const T* xr = x + (long long)row * e;
    float sum = 0.f;
    for (int c = lane; c < e; c += 32) sum += mhada::to_f32(xr[c]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const float mean = sum / e;
    float sq = 0.f;
    for (int c = lane; c < e; c += 32) {
      const float d = mhada::to_f32(xr[c]) - mean;
      sq += d * d;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sq += __shfl_xor_sync(0xffffffffu, sq, off);
    const float rstd = rsqrtf(sq / e + eps);
    for (int c = lane; c < e; c += 32) {
      const float hn = (mhada::to_f32(xr[c]) - mean) * rstd;
      hrow[c] = mhada::from_f32<T>(hn * ln_w[c] + ln_b[c]);
    }
  }

  const int tx = tid % 16, ty = tid / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < e; k0 += kBK) {
    __syncthreads();  // hs complete (first pass) / ws free (later passes)
    for (int idx = tid; idx < kBN * kBK; idx += kThreads) {
      const int c = idx / kBK, kk = idx % kBK;
      const int col = c0 + c, k = k0 + kk;
      float wv = 0.f;
      if (col < f && k < e) wv = mhada::to_f32(w[(long long)col * e + k]);
      ws[kk * kWPad + c] = wv;
    }
    __syncthreads();
    const int kn = min(kBK, e - k0);
    for (int kk = 0; kk < kn; ++kk) {
      float hv[4], wv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        hv[i] = mhada::to_f32(hs[(ty + 16 * i) * hstride + k0 + kk]);
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[j] = ws[kk * kWPad + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(hv[i], wv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty + 16 * i;
    if (row >= rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = c0 + tx + 16 * j;
      if (col < f)
        out[(long long)row * f + col] = mhada::from_f32<T>(acc[i][j] + bias[col]);
    }
  }
}

template <typename T>
cudaError_t ln_matmul(const void* x, const float* ln_w, const float* ln_b,
                      const void* w, const float* bias, void* out, int rows,
                      int e, int f, float eps, cudaStream_t stream) {
  const size_t smem = sizeof(float) * kBK * kWPad +
                      sizeof(T) * (size_t)kBM * (e + kHPad);
  const dim3 grid((f + kBN - 1) / kBN, (rows + kBM - 1) / kBM);
  return mhada::launch_with_smem(
      ln_matmul_kernel<T>, grid, dim3(kThreads), smem, stream,
      static_cast<const T*>(x), ln_w, ln_b, static_cast<const T*>(w), bias,
      static_cast<T*>(out), rows, e, f, eps);
}

}  // namespace

// x (rows, e) and w (f, e) in T; ln_w, ln_b (e,) and bias (f,) float32;
// out (rows, f) in T.
extern "C" int mhada_ln_matmul(const void* x, const void* ln_w,
                               const void* ln_b, const void* w,
                               const void* bias, void* out, int rows, int e,
                               int f, float eps, int dtype, void* stream) {
  MHADA_DISPATCH_DTYPE(
      dtype, T,
      return (int)ln_matmul<T>(x, static_cast<const float*>(ln_w),
                               static_cast<const float*>(ln_b), w,
                               static_cast<const float*>(bias), out, rows, e,
                               f, eps, (cudaStream_t)stream));
}
