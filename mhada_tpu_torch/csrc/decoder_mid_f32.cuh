// K14 at float32 on the CUDA cores: one reflect-padded 3x3 ConvReLU of the
// decoder's mid stages (c1 -> c2 -> c3, C -> C channels), launched once per
// stage, as a register-tiled direct convolution.
//
// Replaces, at float32, mhada_tpu/ops/decoder_mid_pallas.py::mid3_fused
// (_mid3_kernel, pallas_call at decoder_mid_pallas.py:169).  Per stage (the
// TPU kernel's rounding points are the identity at float32):
//
//   y = relu(conv3x3(reflect_pad(x)) + b)
//
// summed in float32, no TF32 and no tensor-core instruction.  x, y NHWC
// (B, H, W, C); w HWIO (3, 3, C, C) float32, as the wrapper hands it; b
// float32.
//
// Bound: 2 x 9 x C^2 flops a pixel, 19.33 GFLOP a stage at 128^2 and C =
// 256 (a 512^2 frame), 0.289 ms at the float32 rate (67 TFLOP/s), against
// 2 x 16.8 MB of activations: operations.
//
// Design: the decoder tail's up3 stage (decoder_tail_f32.cuh,
// tail_up3_f32_kernel) with C input channels and the output channels split
// over the grid.
// - A block of 8 warps owns 8 x 32 output pixels and 64 output channels;
//   grid (pixel tiles, C / 64, B).  128^2 at B = 1 is 64 tiles x 4
//   channel blocks = 256 blocks, one wave at two blocks an SM (264 slots);
//   B = 8 is 2048 blocks (7.8 waves), 256^2 1024 (3.9).
// - The convolution is conv_step (conv3x3_f32.cuh): warp w computes output
//   row w, lane l the run of pixels 8 (l / 8) .. + 7 and the channels 4 (l
//   % 8) .. + 3 and 32 + 4 (l % 8) .. + 3 of the block's 64; 192 FFMA for
//   9 shared loads.
// - The old kernel gathered every window element with a scalar load
//   through the reflection and waited for it between two __syncthreads.
//   Here input channels stream in steps of 8 through a two-stage cp.async
//   ring: each step copies the 10 x 34 window (reflect-mapped rows and
//   columns computed once a copy, 4-byte copies into channel planes) and
//   the step's 9 x 8 x 64 weights (16-byte copies), and lands while the
//   step before it computes.  A step is 4608 FFMA a thread against 15
//   copies.
// - <= 128 registers a thread and 60 KB of shared memory a block: two
//   blocks an SM.
// On an H100 (700 W) the three launches take 1.333 ms at 128^2, B = 1,
// 65 % of the bound (the old kernel 1.92 ms, three cuDNN ConvReLUs
// without TF32 1.56; chip_smoke.py's K14 gate, probes/redesign_ab.py).
//
// C % 64 == 0; x, w and y 16-byte aligned (the entry refuses others).
// Offsets of the batch and of a pixel are formed in 64 bits.
#pragma once

#include <stdint.h>

#include "common.cuh"
#include "conv3x3_f32.cuh"
#include "flash_mma.cuh"  // mma::cp_async_16 / _4 / _commit / _wait, smem_addr

namespace mhada {
namespace midf32 {

using conv3f32::conv_step;
using conv3f32::kCk;  // input channels a pipeline step
using conv3f32::st4;

constexpr int kThreads = 256;
constexpr int kCo = 64;                    // output channels a block
constexpr int kR = 8, kC = 32;             // output pixels a block
constexpr int kWR = kR + 2, kWC = kC + 2;  // the window: 10 x 34
constexpr int kWS = 36;                    // its row stride
constexpr int kPlane = 364;   // >= 10 x 36; 12 mod 32: the copies' banks
constexpr int kX = kCk * kPlane;           // window floats a stage
constexpr int kW = 9 * kCk * kCo;          // weight floats a stage
constexpr int kStage = kX + kW;
constexpr size_t kSmem = sizeof(float) * 2 * kStage;  // 60,160 B

static_assert(kR * kC / 8 * (kCo / 8) == kThreads && kC == 32,
              "a warp a row, 4 runs of 8 pixels to a row");
static_assert(kPlane >= kWR * kWS && kStage % 4 == 0 && kX % 4 == 0,
              "16-byte aligned stages");

// y (B, h, wd, c) from x (B, h, wd, c); grid (tiles, c / kCo, B).
__global__ void __launch_bounds__(kThreads, 2)
    decoder_mid_f32_kernel(const float* __restrict__ x,
                           const float* __restrict__ w,
                           const float* __restrict__ bias,
                           float* __restrict__ y, int h, int wd, int c) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int tiles_x = (wd + kC - 1) / kC;
  const int ty0 = (blockIdx.x / tiles_x) * kR;
  const int tx0 = (blockIdx.x % tiles_x) * kC;
  const int co0 = blockIdx.y * kCo;
  const long long b = blockIdx.z;
  const float* xb = x + b * h * wd * c;

  // The window of input channels kCk s .. + 7 (rows ty0 - 1 .., columns
  // tx0 - 1 .., reflect-mapped) and the step's weights into stage `st`.
  auto issue = [&](int s, float* st) {
    for (int q = tid; q < kWC * kCk; q += kThreads) {
      const int ci = q % kCk, col = q / kCk;
      const float* src = xb + (long long)reflect_index(tx0 - 1 + col, wd) * c +
                         s * kCk + ci;
      const uint32_t dst = mma::smem_addr(st + ci * kPlane + col);
#pragma unroll
      for (int r = 0; r < kWR; ++r)
        mma::cp_async_4(
            dst + 4 * r * kWS,
            src + (long long)reflect_index(ty0 - 1 + r, h) * wd * c, true);
    }
    float* ws = st + kX;
    for (int q = tid; q < kW / 4; q += kThreads) {
      const int row = q / (kCo / 4), o = 4 * (q % (kCo / 4));  // tap, ci
      const int tap = row / kCk, ci = row % kCk;
      mma::cp_async_16(
          mma::smem_addr(ws + row * kCo + o),
          w + ((long long)tap * c + s * kCk + ci) * c + co0 + o, true);
    }
  };

  const int g = lane % 8, k = lane / 8;
  float acc[8][8];
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[p][j] = 0.f;

  const int steps = c / kCk;
  issue(0, smem);
  mma::cp_async_commit();
  for (int s = 0; s < steps; ++s) {
    float* st = smem + (s % 2) * kStage;
    mma::cp_async_wait<0>();
    __syncthreads();  // step s landed; every thread is past step s - 1
    if (s + 1 < steps) issue(s + 1, smem + ((s + 1) % 2) * kStage);
    mma::cp_async_commit();
    conv_step<kPlane, kWS, kCk * kCo, kCo, 32>(st + warp * kWS + 8 * k,
                                               st + kX + 4 * g, acc);
  }

  const int gy = ty0 + warp;
  if (gy >= h) return;
  float bv[8];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    bv[j] = bias[co0 + 4 * g + j];
    bv[4 + j] = bias[co0 + 32 + 4 * g + j];
  }
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const int gx = tx0 + 8 * k + p;
    if (gx >= wd) continue;
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = fmaxf(acc[p][j] + bv[j], 0.f);
    float* dst = y + ((b * h + gy) * wd + gx) * c + co0;
    st4(dst + 4 * g, v[0], v[1], v[2], v[3]);
    st4(dst + 32 + 4 * g, v[4], v[5], v[6], v[7]);
  }
}

inline cudaError_t launch_decoder_mid_f32(const float* x, const float* w,
                                          const float* bias, float* y,
                                          int batch, int h, int wd, int c,
                                          cudaStream_t stream) {
  // two blocks' 120 KB need the shared-memory carveout at its maximum
  const cudaError_t err = cudaFuncSetAttribute(
      decoder_mid_f32_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid(((h + kR - 1) / kR) * ((wd + kC - 1) / kC), c / kCo,
                  batch);
  return launch_with_smem(decoder_mid_f32_kernel, grid, dim3(kThreads), kSmem,
                          stream, x, w, bias, y, h, wd, c);
}

}  // namespace midf32
}  // namespace mhada
