// K13 at float32 on the CUDA cores: c6, the decoder's last conv (64 -> 3
// channels, reflect-padded 3x3, + bias, ReLU), as a register-tiled direct
// convolution over strips that a block walks down.
//
// Replaces, at float32, mhada_tpu/ops/decoder_tail_pallas.py::c6_transposed
// (_c6_kernel, pallas_call at decoder_tail_pallas.py:146):
//
//   out = relu(conv3x3(reflect_pad(c5)) + b6)
//
// summed in float32, no TF32 and no tensor-core instruction.  c5 NHWC (B, H,
// W, 64), out NHWC (B, H, W, 3); w6 HWIO (3, 3, 64, 3) and b6 float32.
//
// Bound: bytes.  67 floats a pixel move (70.3 MB at 512^2: 0.021 ms at 3.35
// TB/s) against 1728 FMA a pixel (0.014 ms at 67 TFLOP/s): the FMAs are
// two thirds of the bytes' time, so the kernel must stream c5 while the
// CUDA cores run close to their rate.
//
// Design:
// - A block of 4 warps owns 64 output columns and a strip of 16 rows, and
//   walks down the strip 2 output rows a step, its c5 rows landing in a
//   ring of 6 window rows by TMA bulk copies (c6_ring.cuh).  A window row
//   is pixel-major as in device memory, 256 bytes a pixel: the 8 lanes of
//   a 16-byte phase read 8 neighbouring channel quads of one pixel, 128
//   contiguous bytes.  99 KB a block, two blocks an SM.
// - Lane l computes the quad q = l % 16 of the run of 8 pixels (of 8 in the
//   block's 64 columns) at both output rows: 48 partial sums.  Its 27
//   weight quads (3 x 3 taps x 3 output channels) stay in registers for the
//   whole strip, so the inner loop reads only c5: per input row, 10 float4
//   loads, each applied to every kernel column and output row that uses it
//   (the 3 horizontal taps share one load; 4 input rows feed 6 row
//   products).  1728 FFMA a step for 40 LDS.128.
// - The 16 lanes of a run then sum their quads: a reduce-scatter over 4
//   shuffles (xor 8, 4, 2, 1), after which lane q holds pixel q of the 16
//   (row q / 8, column q % 8), adds the bias, applies ReLU and stores it;
//   only pixels inside the image are stored.
#pragma once

#include <stdint.h>

#include "c6_ring.cuh"
#include "common.cuh"

namespace mhada {
namespace c6f32 {

using c6::kCols;
using c6::kStrip;
constexpr int kThreads = 128;
constexpr int kRun = 8;                 // pixels a lane, in one row
constexpr int kQuads = 16;              // the 64 channels as 16 quads
using Ring = c6::RowRing;

static_assert(kThreads / 32 * 2 * kRun == kCols, "two runs a warp");

// One exchange of the quads' sum: a lane keeps the upper kHalf values of
// v[0, 2 kHalf) if q & m, else the lower, and adds its partner's partial
// sums of them (lane q ^ m keeps the other half), into v[0, kHalf).
template <int kHalf>
__device__ __forceinline__ void exchange(float* v, int m, int q) {
  const bool up = (q & m) != 0;
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    const float lo = v[i], hi = v[i + kHalf];
    const float got = __shfl_xor_sync(0xffffffffu, up ? lo : hi, m);
    v[i] = (up ? hi : lo) + got;
  }
}

__global__ void __launch_bounds__(kThreads, 2)
    decoder_c6_f32_kernel(const float* __restrict__ c5,
                          const float* __restrict__ w6,
                          const float* __restrict__ b6,
                          float* __restrict__ out, int h, int wd) {
  extern __shared__ __align__(16) char smem[];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int q = lane % kQuads;                 // channels 4q .. 4q + 3
  const int run = 2 * warp + lane / kQuads;    // columns 8 run .. + 7
  const int x0 = blockIdx.x * kCols, y0 = blockIdx.y * kStrip;
  const long long b = blockIdx.z;
  const Ring ring{smem, reinterpret_cast<const char*>(c5 + b * h * wd * 64),
                  h, wd, x0, y0};
  const int steps = (min(kStrip, h - y0) + 1) / 2;
  const int in_rows = 2 * steps + 2;   // window rows the strip reads

  ring.init();
  __syncthreads();
  if (tid == 0)
    for (int r = 0; r < min(c6::kSlots, in_rows); ++r) ring.issue(r);

  // The lane's weights: [ky][kx][co], channels 4q .. 4q + 3.
  float4 wr[3][3][3];
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int co = 0; co < 3; ++co) {
      const float* p = w6 + (t * 64 + 4 * q) * 3 + co;
      wr[t / 3][t % 3][co] = make_float4(p[0], p[3], p[6], p[9]);
    }
  const float bias[3] = {b6[0], b6[1], b6[2]};

#pragma unroll 1
  for (int s = 0; s < steps; ++s) {
    float acc[2][kRun][3];
#pragma unroll
    for (int o = 0; o < 2; ++o)
#pragma unroll
      for (int p = 0; p < kRun; ++p)
#pragma unroll
        for (int co = 0; co < 3; ++co) acc[o][p][co] = 0.f;
    // Input row ri of the step feeds output row o through kernel row
    // ri - o; its float4 j feeds pixel j - kx through kernel column kx.
#pragma unroll
    for (int ri = 0; ri < 4; ++ri) {
      if (ri == 2) {  // rows 2s, 2s + 1 spent: their slots take step s + 2's
        __syncthreads();
        if (tid == 0 && s + 2 < steps) {
          ring.issue(2 * s + 6);
          ring.issue(2 * s + 7);
        }
      }
      ring.wait(2 * s + ri);
      const float4* xr = reinterpret_cast<const float4*>(ring.row(2 * s + ri)) +
                         kQuads * kRun * run + q;
#pragma unroll
      for (int j = 0; j < kRun + 2; ++j) {
        const float4 x = xr[kQuads * j];
#pragma unroll
        for (int o = 0; o < 2; ++o) {
          const int ky = ri - o;
          if (ky < 0 || ky > 2) continue;
#pragma unroll
          for (int kx = 0; kx < 3; ++kx) {
            const int p = j - kx;
            if (p < 0 || p >= kRun) continue;
#pragma unroll
            for (int co = 0; co < 3; ++co) {
              const float4 w = wr[ky][kx][co];
              float a = acc[o][p][co];
              a = fmaf(x.x, w.x, a);
              a = fmaf(x.y, w.y, a);
              a = fmaf(x.z, w.z, a);
              a = fmaf(x.w, w.w, a);
              acc[o][p][co] = a;
            }
          }
        }
      }
    }

    // Sum the 16 quads over pixels P = 8 o + p (v[3 P + co]): exchanges
    // with the lanes q ^ 8, 4, 2, 1, each halving the pixels a lane holds;
    // lane q ends with pixel q.
    float* v = &acc[0][0][0];
    exchange<24>(v, 8, q);
    exchange<12>(v, 4, q);
    exchange<6>(v, 2, q);
    exchange<3>(v, 1, q);
    const int gy = y0 + 2 * s + q / kRun;
    const int gx = x0 + kRun * run + q % kRun;
    if (gy < h && gx < wd) {
      float* op = out + ((b * h + gy) * wd + gx) * 3;
#pragma unroll
      for (int co = 0; co < 3; ++co) op[co] = fmaxf(v[co] + bias[co], 0.f);
    }
  }
}

inline cudaError_t launch_decoder_c6_f32(const float* c5, const float* w6,
                                         const float* b6, float* out,
                                         int batch, int h, int wd,
                                         cudaStream_t stream) {
  // two blocks' 198 KB need the shared-memory carveout at its maximum
  const cudaError_t err = cudaFuncSetAttribute(
      decoder_c6_f32_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid((wd + kCols - 1) / kCols, (h + kStrip - 1) / kStrip, batch);
  return launch_with_smem(decoder_c6_f32_kernel, grid, dim3(kThreads),
                          Ring::kSmem, stream, c5, w6, b6, out, h, wd);
}

}  // namespace c6f32
}  // namespace mhada
