// K14 at bf16 on the tensor cores: one reflect-padded 3x3 ConvReLU of the
// decoder's mid stages (c1 -> c2 -> c3, C -> C channels), launched once
// per stage, as an implicit GEMM on mma.sync m16n8k16.
//
// Replaces, at bf16, mhada_tpu/ops/decoder_mid_pallas.py::mid3_fused
// (_mid3_kernel, pallas_call at decoder_mid_pallas.py:169).  Per stage, at
// the TPU kernel's rounding points (decoder_mid.cu):
//
//   y = relu(round(round(conv3x3(reflect_pad(x))) + round(b)))
//
// summed in float32 over bf16 inputs and weights.  x, y NHWC (B, H, W, C);
// w HWIO (3, 3, C, C) bf16, as the wrapper hands it; b float32 holding
// bf16 values.
//
// Bound: 2 x 9 x C^2 flops a pixel (19.3 GFLOP a stage at 128^2, C = 256:
// 0.020 ms at the bf16 tensor-core rate) against 2 x 8.4 MB of bf16
// activations: operations.
//
// Design: each conv an implicit GEMM on mma.sync m16n8k16 (M = output
// pixels, N = output channels, K = 9 taps x C, a tap a shift of the A
// rows' window positions), over chunks of 64 input channels, since a C =
// 256 window does not fit beside its weights.  A block of 8 warps owns 16
// x 16 output pixels and 128 output channels; K runs as C / 64 chunks of
// 9 taps.
// - The chunk's window, 18 x 18 positions x 64 channels with the 1-pixel
//   halo reflected in the index arithmetic (clamped past a ragged edge,
//   where no stored output reads it), lies pixel-major, 72 bf16 a position
//   (144 bytes: the eight 16-byte rows of an ldmatrix phase fall on
//   distinct banks).  Two window buffers: the next chunk's window lands by
//   cp.async while this chunk's 9 taps run.
// - The weights stream one (tap, chunk) tile at a time, 64 input x 128
//   output channels, rows padded to 136 bf16 (272 bytes), through a
//   three-stage cp.async ring, two tiles ahead.  145.5 KB in all, one block
//   an SM; 128^2 at B = 1 is 64 tiles x 2 channel halves = 128 blocks.
// - A tap is a shift of the window: the A fragment of an m16 tile (16
//   pixels of one output row) comes by ldmatrix from the window at the
//   tap's offset; B fragments come by ldmatrix.trans from the [ci][co]
//   tile.  A warp computes 64 pixels (4 output rows) x 64 channels: per
//   k-step 4 A and 4 B loads for 32 products, 128 float32 accumulators.
// - Epilogue: round the float32 sum to bf16, add the bf16 bias, round,
//   ReLU; each pixel stored only inside the image.
#pragma once

#include <stdint.h>

#include "common.cuh"
#include "flash_mma.cuh"

namespace mhada {
namespace mid {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 16;                  // output pixels a side
constexpr int kWin = kTile + 2;            // 18: the window with its halo
constexpr int kCo = 128;                   // output channels a block
constexpr int kCk = 64;                    // input channels a chunk
constexpr int kXStride = kCk + 8;          // bf16 a window position
constexpr int kWStride = kCo + 8;          // bf16 a weight row
constexpr int kWinElems = kWin * kWin * kXStride;
constexpr int kWElems = kCk * kWStride;
constexpr int kWStages = 3;
constexpr size_t kSmemBytes =
    sizeof(bf16) * (2 * kWinElems + kWStages * kWElems);

__global__ void __launch_bounds__(kThreads, 1)
    decoder_mid_mma_kernel(const bf16* __restrict__ x,
                           const bf16* __restrict__ w,
                           const float* __restrict__ bias,
                           bf16* __restrict__ y, int h, int wd, int c) {
  using namespace mma;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* win = reinterpret_cast<bf16*>(smem_raw);   // 2 x [18 x 18][72]
  bf16* ring = win + 2 * kWinElems;                 // 3 x [64][136]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tiles_x = (wd + kTile - 1) / kTile;
  const int oy0 = (blockIdx.x / tiles_x) * kTile;
  const int ox0 = (blockIdx.x % tiles_x) * kTile;
  const int co0 = blockIdx.y * kCo;
  const long long b = blockIdx.z;
  const int nsteps = 9 * (c / kCk);   // (chunk, tap) pairs, tap fastest
  const int wm = warp % 4, wn = warp / 4;   // output rows 4 wm.., channels
                                            // 64 wn.. of the block's

  // Window of chunk ch (input channels 64 ch..) into buffer ch % 2.
  auto load_window = [&](int ch) {
    bf16* dst = win + (ch % 2) * kWinElems;
    for (int i = tid; i < kWin * kWin * 8; i += kThreads) {
      const int p = i / 8, c8 = (i % 8) * 8;
      const int gy = reflect_index(oy0 - 1 + p / kWin, h);
      const int gx = reflect_index(ox0 - 1 + p % kWin, wd);
      cp_async_16(smem_addr(dst + p * kXStride + c8),
                  x + ((b * h + gy) * wd + gx) * c + ch * kCk + c8, true);
    }
  };
  // Weight tile i (tap i % 9 of chunk i / 9) into ring stage i % 3.
  auto load_weights = [&](int i) {
    bf16* dst = ring + (i % kWStages) * kWElems;
    const bf16* src =
        w + (static_cast<long long>(i % 9) * c + (i / 9) * kCk) * c + co0;
    for (int j = tid; j < kCk * (kCo / 8); j += kThreads) {
      const int r = j / (kCo / 8), c8 = (j % (kCo / 8)) * 8;
      cp_async_16(smem_addr(dst + r * kWStride + c8),
                  src + static_cast<long long>(r) * c + c8, true);
    }
  };

  // The lane's A row at tap 0 of window buffer 0: m16 tile mt is output
  // row 4 wm + mt, pixel lane % 16, k-half lane / 16.
  uint32_t abase[4];
  float acc[4][8][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
    abase[mt] = smem_addr(win + ((4 * wm + mt) * kWin + lane % 16) * kXStride +
                          (lane / 16) * 8);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;
  }
  // The lane's ldmatrix.trans row in a weight tile (bt_addr at stride 136).
  const int brow = (lane % 8) + ((lane / 8) % 2) * 8;
  const int bcol = 64 * wn + (lane / 16) * 8;

  load_window(0);
  load_weights(0);
  cp_async_commit();
  if (nsteps > 1) load_weights(1);
  cp_async_commit();
  for (int i = 0; i < nsteps; ++i) {
    cp_async_wait<1>();   // weight tile i and the chunk's window landed
    __syncthreads();      // ... for every thread; step i - 1's buffers free
    if (i + 2 < nsteps) load_weights(i + 2);
    if (i % 9 == 0 && 9 * (i / 9 + 1) < nsteps) load_window(i / 9 + 1);
    cp_async_commit();
    const int tap = i % 9, ch = i / 9;
    const bf16* wt = ring + (i % kWStages) * kWElems;
    const uint32_t toff =
        (((tap / 3) * kWin + tap % 3) * kXStride + (ch % 2) * kWinElems) * 2;
#pragma unroll
    for (int kk = 0; kk < kCk / 16; ++kk) {
      uint32_t bf[8][2];
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, smem_addr(wt + (kk * 16 + brow) * kWStride +
                                       bcol + np * 16));
        bf[2 * np][0] = r[0];
        bf[2 * np][1] = r[1];
        bf[2 * np + 1][0] = r[2];
        bf[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        uint32_t af[4];
        ldmatrix_x4(af, abase[mt] + toff + kk * 32);
#pragma unroll
        for (int n = 0; n < 8; ++n) mma_16816(acc[mt][n], af, bf[n][0],
                                              bf[n][1]);
      }
    }
  }

  // element 2 r + (0, 1) of n8 tile n of m16 tile mt: output row 4 wm + mt,
  // pixel g + 8 r, channels 64 wn + 8 n + 2 t and + 1
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int gy = oy0 + 4 * wm + mt, gx = ox0 + g + 8 * r;
      if (gy >= h || gx >= wd) continue;
      const int co = co0 + 64 * wn + 2 * t;
      bf16* yp = y + ((b * h + gy) * wd + gx) * c + co;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float b0 = __ldg(bias + co + 8 * n);
        const float b1 = __ldg(bias + co + 8 * n + 1);
        const float v0 =
            round_to<bf16>(round_to<bf16>(acc[mt][n][2 * r]) + b0);
        const float v1 =
            round_to<bf16>(round_to<bf16>(acc[mt][n][2 * r + 1]) + b1);
        *reinterpret_cast<uint32_t*>(yp + 8 * n) =
            pack_bf16(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
      }
    }
}

// x, y (B, H, W, C), w (3, 3, C, C) bf16, 16-byte aligned; C % 128 == 0.
inline cudaError_t launch_decoder_mid_mma(const bf16* x, const bf16* w,
                                          const float* bias, bf16* y,
                                          int batch, int h, int wd, int c,
                                          cudaStream_t stream) {
  const dim3 grid(((h + kTile - 1) / kTile) * ((wd + kTile - 1) / kTile),
                  c / kCo, batch);
  return launch_with_smem(decoder_mid_mma_kernel, grid, dim3(kThreads),
                          kSmemBytes, stream, x, w, bias, y, h, wd, c);
}

}  // namespace mid
}  // namespace mhada
