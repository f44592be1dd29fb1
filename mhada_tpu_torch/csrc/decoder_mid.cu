// K14: one reflect-padded 3x3 ConvReLU of the decoder's mid stages
// (c1 -> c2 -> c3, 256 -> 256 channels at a quarter of the frame's side),
// launched once per stage.
//
// Replaces mhada_tpu/ops/decoder_mid_pallas.py::mid3_fused (_mid3_kernel,
// pallas_call at decoder_mid_pallas.py:169).  Per stage, at the TPU
// kernel's rounding points:
//
//   y = relu(round_T(round_T(conv3x3(reflect_pad(x))) + round_T(b)))
//
// summed in float32 over inputs and weights in T.  Each stage pads its own
// input, i.e. the previous stage's output, so three launches give the
// chain exactly; the TPU kernel, which fused the three stages over one
// HBM read, had to repair the boundary rows and columns of its
// intermediates in-kernel (_row_fix / _col_fix, :56-70).  Fusing the
// stages again is work for a redesign.
//
// x and y are NHWC (B, H, W, C); w is HWIO (3, 3, C, C) in T; b float32.
//
// What bounds it on the card: operations.  2 x 9 x C^2 flops a pixel per
// stage: 19.33 GFLOP per stage at 128^2 (a 512^2 frame), 0.29 ms at the
// float32 rate (67 TFLOP/s) and 0.020 ms at the bf16 tensor-core rate,
// against 2 x 8.4 MB of activations at float32.
//
// bfloat16 runs on the tensor cores (decoder_mid_mma.cuh, an implicit
// GEMM on mma.sync).  float32 (CUDA cores, float32 FMAs): a block
// owns a 16 x 16 tile of output pixels and 64 output channels.  It loops
// over the input channels in chunks of 16: the chunk's 18 x 18 input
// window (1-pixel halo, reflected at the image edges in the index
// arithmetic) and its 9 x 16 x 64 weight slice go to shared memory
// (20.7 + 36.9 KB), then each of the 256 threads accumulates 8 pixels x 8
// channels in registers (thread (tx, ty) = (tid % 8, tid / 8): channels
// tx + 8 j, pixels ty + 32 i), 64 FMAs for every 16 shared loads.

#include "common.cuh"
#include "decoder_mid_mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 16;             // output pixels per side
constexpr int kWin = kTile + 2;       // 18: input window with the halo
constexpr int kPlane = kWin * kWin + 1;  // odd stride between channels
constexpr int kCo = 64;               // output channels per block
constexpr int kCk = 16;               // input channels per chunk

using mhada::reflect_index;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    conv3x3_relu_kernel(const T* __restrict__ x, const T* __restrict__ w,
                        const float* __restrict__ bias, T* __restrict__ y,
                        int h, int wd, int c) {
  extern __shared__ float smem[];
  float* xs = smem;                    // [ci][kPlane]
  float* ws = smem + kCk * kPlane;     // [tap][ci][co]

  const int tid = threadIdx.x;
  const int tx = tid % 8, ty = tid / 8;
  const int tiles_x = (wd + kTile - 1) / kTile;
  const int oy0 = (blockIdx.x / tiles_x) * kTile;
  const int ox0 = (blockIdx.x % tiles_x) * kTile;
  const int co0 = blockIdx.y * kCo;
  const long long b = blockIdx.z;

  float acc[8][8];
  int off[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int p = ty + 32 * i;
    off[i] = (p / kTile) * kWin + p % kTile;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  for (int c0 = 0; c0 < c; c0 += kCk) {
    for (int idx = tid; idx < kWin * kWin * kCk; idx += kThreads) {
      const int ci = idx % kCk, p = idx / kCk;
      const int gy = reflect_index(oy0 - 1 + p / kWin, h);
      const int gx = reflect_index(ox0 - 1 + p % kWin, wd);
      xs[ci * kPlane + p] =
          mhada::to_f32(x[((b * h + gy) * wd + gx) * c + c0 + ci]);
    }
    for (int idx = tid; idx < 9 * kCk * kCo; idx += kThreads) {
      const int co = idx % kCo, ci = (idx / kCo) % kCk, tap = idx / (kCo * kCk);
      ws[idx] = mhada::to_f32(w[((long long)tap * c + c0 + ci) * c + co0 + co]);
    }
    __syncthreads();
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int toff = (tap / 3) * kWin + tap % 3;
#pragma unroll 4
      for (int ci = 0; ci < kCk; ++ci) {
        float wv[8], xv[8];
        const float* wt = ws + (tap * kCk + ci) * kCo + tx;
#pragma unroll
        for (int j = 0; j < 8; ++j) wv[j] = wt[8 * j];
        const float* xc = xs + ci * kPlane + toff;
#pragma unroll
        for (int i = 0; i < 8; ++i) xv[i] = xc[off[i]];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(xv[i], wv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int p = ty + 32 * i;
    const int gy = oy0 + p / kTile, gx = ox0 + p % kTile;
    if (gy >= h || gx >= wd) continue;
    T* yp = y + ((b * h + gy) * wd + gx) * c + co0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int co = tx + 8 * j;
      const float v = mhada::round_to<T>(
          mhada::round_to<T>(acc[i][j]) + mhada::round_to<T>(bias[co0 + co]));
      yp[co] = mhada::from_f32<T>(fmaxf(v, 0.f));
    }
  }
}

template <typename T>
cudaError_t conv3x3_relu(const void* x, const void* w, const float* bias,
                         void* y, int batch, int h, int wd, int c,
                         cudaStream_t stream) {
  const size_t smem = sizeof(float) * (kCk * kPlane + 9 * kCk * kCo);
  const dim3 grid(((h + kTile - 1) / kTile) * ((wd + kTile - 1) / kTile),
                  c / kCo, batch);
  return mhada::launch_with_smem(conv3x3_relu_kernel<T>, grid,
                                 dim3(kThreads), smem, stream,
                                 static_cast<const T*>(x),
                                 static_cast<const T*>(w), bias,
                                 static_cast<T*>(y), h, wd, c);
}

}  // namespace

// One stage: x, y (B, H, W, C) NHWC in T; w HWIO (3, 3, C, C) in T; b (C,)
// float32.  C % 64 == 0 (bfloat16: C % 128 == 0, every bf16 pointer
// 16-byte aligned); H, W >= 2.
extern "C" int mhada_decoder_mid_conv(const void* x, const void* w,
                                      const void* b, void* y, int batch,
                                      int h, int wd, int c, int dtype,
                                      void* stream) {
  if (c % kCo != 0) return (int)cudaErrorInvalidValue;
  if (dtype == mhada::kF32)
    return (int)conv3x3_relu<float>(x, w, static_cast<const float*>(b), y,
                                    batch, h, wd, c, (cudaStream_t)stream);
  if (dtype != mhada::kBF16 || c % mhada::mid::kCo != 0 ||
      !mhada::mma_aligned({x, w, y}, c))
    return (int)cudaErrorInvalidValue;
  using bf16 = __nv_bfloat16;
  return (int)mhada::mid::launch_decoder_mid_mma(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const float*>(b), static_cast<bf16*>(y), batch, h, wd, c,
      (cudaStream_t)stream);
}
