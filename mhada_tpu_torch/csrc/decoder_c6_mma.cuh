// K13 at bf16 on the tensor cores: c6, the decoder's last conv (64 -> 3
// channels, reflect-padded 3x3, + bias, ReLU), as an implicit GEMM on
// mma.sync m16n8k16 over strips that a block walks down.
//
// Replaces, at bf16, mhada_tpu/ops/decoder_tail_pallas.py::c6_transposed
// (_c6_kernel, pallas_call at decoder_tail_pallas.py:146), at its rounding
// points (decoder_tail_pallas.py:175-182):
//
//   out = round_bf16(relu(conv3x3(reflect_pad(c5)) + b6))
//
// the products of bf16 inputs and weights summed in float32, the float32
// bias added to the float32 sum, one rounding.  c5 NHWC (B, H, W, 64) bf16,
// out NHWC (B, H, W, 3) bf16; w6 HWIO (3, 3, 64, 3) bf16, b6 float32.
//
// Bound: bytes.  67 bf16 a pixel (35.2 MB at 512^2: 0.010 ms at 3.35 TB/s).
// On the CUDA cores the 1728 FMA a pixel alone would take 0.014 ms at 512^2
// (67 TFLOP/s), above the bound; on the tensor cores, with the 3 output
// channels padded to n = 8, they take a fraction of it.
//
// Design: the strip walk of the float32 build (decoder_c6_f32.cuh) with the
// products on the tensor cores.
// - A block of 4 warps owns 64 output columns and a strip of 16 rows, and
//   walks down it 2 output rows a step, through a ring of 6 window rows
//   (66 pixels of 64 channels with the reflected halo, 72 bf16 a pixel
//   apart: the eight 16-byte rows of an ldmatrix phase fall on distinct
//   banks; padding a bulk copy cannot give, so the rows land by 16-byte
//   cp.async).  Two steps' rows are in flight: once the step's warps are
//   past kernel rows 0 and 1 (a barrier), rows 2s and 2s + 1 are spent and
//   their slots take step s + 2's.  57 KB a block.
// - GEMM: M = pixels, K = 9 taps x 64 channels = 36 k-steps of 16, N = 8
//   (output channels 0-2, the rest zero).  Every lane holds the B fragments
//   of all 36 k-steps in registers (72 words, loaded once); a tap is a
//   shift of the window, so the A fragment of an m16 tile (16 pixels of one
//   output row) comes by ldmatrix from the window row ky at column offset
//   kx.  Warp w computes output row w / 2, pixels 32 (w % 2) .. + 31: two
//   m16 tiles, 72 ldmatrix and 72 products a step.
// - Epilogue: the float32 sum plus the float32 bias, ReLU, one rounding to
//   bf16; the lanes holding columns 0-2 store them, inside the image only.
#pragma once

#include <stdint.h>

#include "c6_ring.cuh"  // the strip walk's geometry
#include "common.cuh"
#include "flash_mma.cuh"

namespace mhada {
namespace c6mma {

using bf16 = __nv_bfloat16;

using c6::kCols;
using c6::kSlots;
using c6::kStrip;
using c6::kWinC;
constexpr int kThreads = 128;
constexpr int kXS = 72;                   // bf16 a window pixel
constexpr int kRowElems = kWinC * kXS;    // bf16 a window row
constexpr int kKSteps = 9 * 64 / 16;      // 36
constexpr size_t kSmem = sizeof(bf16) * kSlots * kRowElems;  // 57,024 B

__global__ void __launch_bounds__(kThreads, 3)
    decoder_c6_mma_kernel(const bf16* __restrict__ c5,
                          const bf16* __restrict__ w6,
                          const float* __restrict__ b6,
                          bf16* __restrict__ out, int h, int wd) {
  using namespace mma;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);  // [slot][kWinC][kXS]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int x0 = blockIdx.x * kCols, y0 = blockIdx.y * kStrip;
  const long long b = blockIdx.z;
  const bf16* src = c5 + b * h * wd * 64;
  const int steps = (min(kStrip, h - y0) + 1) / 2;
  const int in_rows = 2 * steps + 2;   // window rows the strip reads

  // Window row r (image row y0 - 1 + r; columns x0 - 1 ..; both reflected,
  // then clamped) into slot r % kSlots.
  auto issue_row = [&](int r) {
    const bf16* row = src + (long long)reflect_index(y0 - 1 + r, h) * wd * 64;
    bf16* dst = ring + (r % kSlots) * kRowElems;
    for (int i = tid; i < kWinC * 8; i += kThreads) {
      const int px = i / 8, c8 = (i % 8) * 8;
      cp_async_16(smem_addr(dst + px * kXS + c8),
                  row + (long long)reflect_index(x0 - 1 + px, wd) * 64 + c8,
                  true);
    }
  };
  // rows 0-3 (step 0's), then 4 and 5 (step 1's first two), a group each
  for (int r = 0; r < 4; ++r) issue_row(r);
  cp_async_commit();
  for (int r = 4; r < min(6, in_rows); ++r) issue_row(r);
  cp_async_commit();

  // B fragments: k-step i covers tap i / 4 and channels 16 (i % 4) ..; the
  // lane holds column g (output channel g, zero from 3 on) at rows 2t, 2t+1
  // (bw[i][0]) and 2t+8, 2t+9 (bw[i][1]).
  const int g = lane / 4, t = lane % 4;
  uint32_t bw[kKSteps][2];
  const unsigned short* wbits = reinterpret_cast<const unsigned short*>(w6);
#pragma unroll
  for (int i = 0; i < kKSteps; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int k = (i / 4) * 64 + 16 * (i % 4) + 2 * t + 8 * r;
      const uint32_t lo = g < 3 ? wbits[k * 3 + g] : 0u;
      const uint32_t hi = g < 3 ? wbits[(k + 1) * 3 + g] : 0u;
      bw[i][r] = lo | (hi << 16);
    }
  const float bias0 = b6[min(2 * t, 2)], bias1 = b6[min(2 * t + 1, 2)];

  const int o = warp / 2;                // output row of the step
  const int px0 = 32 * (warp % 2);       // first pixel of the warp's tiles
  // the lane's ldmatrix row: pixel lane % 16 of a tile, k-half lane / 16
  const uint32_t lane_off =
      ((px0 + lane % 16) * kXS + (lane / 16) * 8) * sizeof(bf16);

#pragma unroll 1
  for (int s = 0; s < steps; ++s) {
    // all groups but the newest (rows 2s + 4, 2s + 5) landed: rows .. 2s + 3
    cp_async_wait<1>();
    __syncthreads();
    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
      if (ky == 2) {  // rows 2s, 2s + 1 spent: their slots take step s + 2's
        __syncthreads();
        if (s + 2 < steps) {
          issue_row(2 * s + 6);
          issue_row(2 * s + 7);
        }
        cp_async_commit();
      }
      const uint32_t rb =
          smem_addr(ring + ((2 * s + o + ky) % kSlots) * kRowElems) +
          lane_off;
#pragma unroll
      for (int kx = 0; kx < 3; ++kx)
#pragma unroll
        for (int kc = 0; kc < 4; ++kc) {
          const int i = (ky * 3 + kx) * 4 + kc;
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            uint32_t a[4];
            ldmatrix_x4(a, rb + ((16 * mt + kx) * kXS + 16 * kc) *
                                    (int)sizeof(bf16));
            mma_16816(acc[mt], a, bw[i][0], bw[i][1]);
          }
        }
    }

    // element 2 r + e of tile mt: pixel px0 + 16 mt + g + 8 r, channel
    // 2 t + e
    const int gy = y0 + 2 * s + o;
    if (t < 2 && gy < h) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int gx = x0 + px0 + 16 * mt + g + 8 * r;
          if (gx >= wd) continue;
          bf16* op = out + ((b * h + gy) * wd + gx) * 3 + 2 * t;
          op[0] = __float2bfloat16(fmaxf(acc[mt][2 * r] + bias0, 0.f));
          if (t == 0)
            op[1] = __float2bfloat16(fmaxf(acc[mt][2 * r + 1] + bias1, 0.f));
        }
    }
  }
}

inline cudaError_t launch_decoder_c6_mma(const bf16* c5, const bf16* w6,
                                         const float* b6, bf16* out,
                                         int batch, int h, int wd,
                                         cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      decoder_c6_mma_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid((wd + kCols - 1) / kCols, (h + kStrip - 1) / kStrip, batch);
  return launch_with_smem(decoder_c6_mma_kernel, grid, dim3(kThreads), kSmem,
                          stream, c5, w6, b6, out, h, wd);
}

}  // namespace c6mma
}  // namespace mhada
