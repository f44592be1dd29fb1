// The bf16 decoder tail on the tensor cores: K5 (kRes = false) and K8's
// forward (kRes, also writing the residuals y1 and c5).
//
// Replaces, at bf16, mhada_tpu/ops/decoder_tail_pallas.py::tail3_fused
// (_tail3_kernel, pallas_call at decoder_tail_pallas.py:546; with
// _tail3_kernel_res, :519):
//
//   y1  = relu(round(conv3x3(reflect_pad(x))) + b_up)   128 -> 64, low res
//   up  = bilinear 2x of y1 (align_corners=False, edge clamp)
//   c5  = relu(round(conv3x3(reflect_pad(up))) + b5)    64 -> 64, high res
//   out = relu(round(conv3x3(reflect_pad(c5))) + b6)    64 -> 3
//
// with the Pallas kernel's rounding points: each conv's float32 sum is
// rounded to bf16, the bf16 bias added and the sum rounded again
// (decoder_tail_pallas.py:328, 369, 563-564); `up` is blended rows first,
// 0.75 near rounded before adding 0.25 far, then columns from the rounded
// rows, where 0.75 near is rounded apart only for output columns 4j and
// 4j + 3 (the TPU's packed columns; ops/decoder_tail.py::upsample2x_tail
// is the same function in PyTorch).
//
// Bound: 2 x 9 x (H W 128 64 + 4 H W 64 64 + 4 H W 64 3) flops, 29.9
// GFLOP at 256^2 -> 512^2, against the x read and the rgb write (K8: also
// y1 and c5): compute-bound at the bf16 tensor-core rate.
//
// Design.  A block of 8 warps owns a 16 x 16 tile of output pixels and
// builds the windows the old CUDA-core kernel built (x 14^2 low-res with a
// 3-pixel halo, y1 12^2, up 20^2, c5 18^2), but pixel-major: each window
// position is a row of channels, padded to 136 (x) or 72 (the 64-channel
// windows) bf16 so that the eight 16-byte rows of an ldmatrix phase fall on
// distinct banks.  Regions are reused (x -> up, y1 -> c5): 150 KB of
// shared memory, one block an SM.
// - Each conv is an implicit GEMM on mma.sync m16n8k16 (bf16 operands,
//   float32 accumulators): M = the output window's positions (padding rows
//   of the last m16 tile read a clamped position and are never stored),
//   N = 64 output channels (c6: one n8 tile, w6 zero-padded from 3), K = 9
//   taps x C_in.  A tap is a shift of the A rows' window positions, so the
//   A fragments come by ldmatrix straight from the window; the weights are
//   HWIO [tap][ci][co], whose B fragments come by ldmatrix.trans.
// - The weights do not fit beside the windows (w_up is 147 KB): they
//   stream one tap at a time (16 or 8 KB) through a two-stage cp.async
//   ring, w_up's 9 taps then w5's, the next tap landing while the present
//   one's products run; w6 (9 KB padded) stays resident.
// - Warps split a conv into units of one m16 tile and 32 (y1) or 64 (c5)
//   output channels, at most 3 units a warp; a warp loads its B fragments
//   once per k-step for all its units.
// - The epilogue of each conv applies the rounding, bias and ReLU to the
//   accumulator fragments and writes bf16 pairs into the next window.
// - Reflect padding belongs to each stage's own output: every window
//   position is addressed by its global coordinate, `up` is evaluated at
//   its reflected coordinate, and c5 positions outside the image are
//   overwritten by their in-image mirrors before c6 reads them.
// - K8 writes the block's own y1 (8 x 8 low-res) and c5 (16 x 16) pixels,
//   16 bytes at a time, each pixel once.
#pragma once

#include <stdint.h>

#include "common.cuh"
#include "flash_mma.cuh"

namespace mhada {
namespace tail {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 16;                 // output tile, high-res pixels
constexpr int kCin = 128, kC = 64;
constexpr int kXW = kTile / 2 + 6;        // 14: x window (low res)
constexpr int kYW = kTile / 2 + 4;        // 12: y1 window (low res)
constexpr int kUW = kTile + 4;            // 20: up window (high res)
constexpr int kCW = kTile + 2;            // 18: c5 window (high res)
constexpr int kXStride = kCin + 8;        // bf16 per x position (272 B)
constexpr int kStride = kC + 8;           // per 64-channel position (144 B)
static_assert(kStride == mma::kMmaStride, "bt_addr assumes 72-wide rows");
constexpr int kN6 = 8;                    // c6's 3 channels, one n8 tile
constexpr int cmax(int a, int b) { return a > b ? a : b; }
// Region A holds x, then up; region B holds y1, then c5 (elements).
constexpr int kRegionA = cmax(kXW * kXW * kXStride, kUW * kUW * kStride);
constexpr int kRegionB = cmax(kYW * kYW * kStride, kCW * kCW * kStride);
constexpr int kRingStage = kCin * kStride;   // one tap of w_up (w5: half)
constexpr int kW6Elems = 9 * kC * kN6;
constexpr size_t kSmemBytes =
    sizeof(bf16) * (kRegionA + kRegionB + 2 * kRingStage + kW6Elems);
constexpr int kWeightTiles = 18;             // w_up's 9 taps, then w5's

struct TailArgs {
  const bf16* x;        // (B, H, W, 128)
  const bf16* w_up;     // (3, 3, 128, 64) HWIO
  const float* b_up;    // (64,), bf16 values
  const bf16* w5;       // (3, 3, 64, 64)
  const float* b5;
  const bf16* w6;       // (3, 3, 64, 3)
  const float* b6;
  bf16* out;            // (B, 2H, 2W, 3)
  bf16* y1;             // K8: (B, H, W, 64)
  bf16* c5;             // K8: (B, 2H, 2W, 64)
  int hl, wl;
};

__device__ __forceinline__ float rnd(float x) { return round_to<bf16>(x); }

// The relu(round(round(acc) + bias)) of two neighbouring channels, packed.
__device__ __forceinline__ uint32_t bias_relu(float v0, float v1,
                                              const float* bias, int co) {
  return mma::pack_bf16(fmaxf(rnd(rnd(v0) + __ldg(bias + co)), 0.f),
                        fmaxf(rnd(rnd(v1) + __ldg(bias + co + 1)), 0.f));
}

// One 3x3 valid conv as an implicit GEMM: window `in` (kInW positions a
// row, kInStride bf16 a position, kCinT channels) -> kNPos output positions
// (kOutW a row) x kN channels.  weights(tap) returns the tap's [ci][co]
// tile in shared memory (row stride kStride, or kN6 for kN = kN6) once it
// may be read; epi(p, co, v0, v1) takes the float32 sums of position p,
// channels co and co + 1.  Every thread of the block calls it.
template <int kNPos, int kOutW, int kInW, int kInStride, int kCinT, int kN,
          int kNT, typename Weights, typename Epi>
__device__ __forceinline__ void conv3x3_mma(const bf16* in, Weights weights,
                                            Epi epi) {
  using namespace mma;
  constexpr int kMTiles = (kNPos + 15) / 16;
  constexpr int kNB = kN / (8 * kNT);       // n-blocks of kNT n8 tiles
  constexpr int kMStep = kWarps / kNB;      // warps sharing an n-block
  constexpr int kUnits = (kMTiles + kMStep - 1) / kMStep;
  static_assert(kNT == 1 || kNT % 2 == 0, "n8 tiles go in pairs");
  static_assert(kN % (8 * kNT) == 0 && kWarps % kNB == 0, "bad split");
  static_assert(kNT > 1 || kCinT % 32 == 0, "k-steps go in pairs");
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nb = warp % kNB, m0 = warp / kNB, n0 = nb * kNT * 8;

  uint32_t abase[kUnits];   // the lane's A row at tap 0, channel 0
  float acc[kUnits][kNT][4];
#pragma unroll
  for (int u = 0; u < kUnits; ++u) {
    const int p = min((m0 + u * kMStep) * 16 + lane % 16, kNPos - 1);
    const int pos = (p / kOutW) * kInW + p % kOutW;
    abase[u] = smem_addr(in + pos * kInStride + (lane / 16) * 8);
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[u][j][e] = 0.f;
  }

  for (int tap = 0; tap < 9; ++tap) {
    const bf16* w = weights(tap);
    const uint32_t toff = ((tap / 3) * kInW + tap % 3) * kInStride * 2;
    uint32_t w6r[4];   // kNT == 1: the B fragments of two k-steps
#pragma unroll
    for (int kk = 0; kk < kCinT / 16; ++kk) {
      uint32_t b[kNT][2];
      if constexpr (kNT == 1) {
        // [ci][8] rows of 16 bytes: lanes 0-15 address k-step kk's rows,
        // lanes 16-31 k-step kk + 1's
        if (kk % 2 == 0)
          ldmatrix_x4_trans(w6r, smem_addr(w + (kk * 16 + lane) * kN6));
        b[0][0] = w6r[2 * (kk % 2)];
        b[0][1] = w6r[2 * (kk % 2) + 1];
      } else {
#pragma unroll
        for (int np = 0; np < kNT / 2; ++np) {
          uint32_t r[4];
          ldmatrix_x4_trans(r, bt_addr(w, kk * 16, n0 + np * 16));
          b[2 * np][0] = r[0];
          b[2 * np][1] = r[1];
          b[2 * np + 1][0] = r[2];
          b[2 * np + 1][1] = r[3];
        }
      }
#pragma unroll
      for (int u = 0; u < kUnits; ++u) {
        if (m0 + u * kMStep >= kMTiles) continue;   // warp-uniform
        uint32_t a[4];
        ldmatrix_x4(a, abase[u] + toff + kk * 32);
#pragma unroll
        for (int j = 0; j < kNT; ++j)
          mma_16816(acc[u][j], a, b[j][0], b[j][1]);
      }
    }
  }

  // element 2 r + (0, 1) of n8 tile j: row g + 8 r, channels
  // n0 + 8 j + 2 t and + 1
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int u = 0; u < kUnits; ++u) {
    const int mt = m0 + u * kMStep;
    if (mt >= kMTiles) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int p = mt * 16 + g + 8 * r;
      if (p >= kNPos) continue;
#pragma unroll
      for (int j = 0; j < kNT; ++j)
        epi(p, n0 + 8 * j + 2 * t, acc[u][j][2 * r], acc[u][j][2 * r + 1]);
    }
  }
}

// 8 channels of up at one window position from the y1 window: rows first
// (near y row ra, far rb), each 0.75 near rounded before the sum; then
// 0.75 near column (ca) + 0.25 far column (cb), 0.75 near rounded first
// when `apart`.
__device__ __forceinline__ uint4 up_chunk(const bf16* ys, int ra, int rb,
                                          int ca, int cb, bool apart,
                                          int c8) {
  auto ld = [&](int r, int c) {
    return *reinterpret_cast<const uint4*>(ys + (r * kYW + c) * kStride +
                                           c8);
  };
  const uint4 nn = ld(ra, ca), fn = ld(rb, ca), nf = ld(ra, cb),
              ff = ld(rb, cb);
  const uint32_t* pnn = &nn.x;
  const uint32_t* pfn = &fn.x;
  const uint32_t* pnf = &nf.x;
  const uint32_t* pff = &ff.x;
  uint4 out;
  uint32_t* po = &out.x;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 a = mma::unpack_bf16(pnn[e]), b = mma::unpack_bf16(pfn[e]);
    const float2 c = mma::unpack_bf16(pnf[e]), d = mma::unpack_bf16(pff[e]);
    // the rows at the near and the far column
    const float nx = rnd(rnd(0.75f * a.x) + 0.25f * b.x);
    const float ny = rnd(rnd(0.75f * a.y) + 0.25f * b.y);
    const float fx = rnd(rnd(0.75f * c.x) + 0.25f * d.x);
    const float fy = rnd(rnd(0.75f * c.y) + 0.25f * d.y);
    const float qx = apart ? rnd(0.75f * nx) : 0.75f * nx;
    const float qy = apart ? rnd(0.75f * ny) : 0.75f * ny;
    po[e] = mma::pack_bf16(qx + 0.25f * fx, qy + 0.25f * fy);
  }
  return out;
}

template <bool kRes>
__global__ void __launch_bounds__(kThreads, 1)
    decoder_tail_mma_kernel(TailArgs a) {
  using namespace mma;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* region_a = reinterpret_cast<bf16*>(smem_raw);
  bf16* region_b = region_a + kRegionA;
  bf16* ring = region_b + kRegionB;
  bf16* w6s = ring + 2 * kRingStage;   // [tap][ci][8]
  bf16* xs = region_a;                 // [14 x 14][136]
  bf16* us = region_a;                 // [20 x 20][72]
  bf16* ys = region_b;                 // [12 x 12][72]
  bf16* cs = region_b;                 // [18 x 18][72]

  const int tid = threadIdx.x;
  const int hl = a.hl, wl = a.wl, hh = 2 * hl, wh = 2 * wl;
  const long long b = blockIdx.z;
  const int oy0 = blockIdx.y * kTile, ox0 = blockIdx.x * kTile;
  const int ly0 = oy0 / 2, lx0 = ox0 / 2;

  // Weight tile i of the ring: tap i of w_up (128 rows), then tap i - 9 of
  // w5 (64 rows), each row 64 channels.
  auto load_weights = [&](int i) {
    bf16* dst = ring + (i % 2) * kRingStage;
    const bf16* src =
        i < 9 ? a.w_up + i * kCin * kC : a.w5 + (i - 9) * kC * kC;
    const int rows = i < 9 ? kCin : kC;
    for (int c = tid; c < rows * 8; c += kThreads)
      cp_async_16(smem_addr(dst + (c / 8) * kStride + (c % 8) * 8),
                  src + c * 8, true);
  };

  // x window: low-res rows / columns [l0 - 3, l0 + 11), reflect-mapped
  // (up3's own input padding), 16 chunks of 8 channels a position.
  for (int c = tid; c < kXW * kXW * 16; c += kThreads) {
    const int p = c / 16, ch = (c % 16) * 8;
    const int gy = reflect_index(ly0 - 3 + p / kXW, hl);
    const int gx = reflect_index(lx0 - 3 + p % kXW, wl);
    cp_async_16(smem_addr(xs + p * kXStride + ch),
                a.x + ((b * hl + gy) * wl + gx) * kCin + ch, true);
  }
  load_weights(0);
  cp_async_commit();
  // w6, zero-padded to 8 output channels (plain loads: rows of 3 bf16).
  for (int i = tid; i < kW6Elems; i += kThreads) {
    const int co = i % kN6, row = i / kN6;   // row = tap * 64 + ci
    w6s[i] = co < 3 ? a.w6[row * 3 + co] : __float2bfloat16(0.f);
  }

  int wt = 0;   // the ring's next weight tile
  auto ring_tap = [&](int) {
    cp_async_wait<0>();   // tile wt (and, first, the x window) landed
    __syncthreads();      // ... for every thread; stage wt + 1 is free
    if (wt + 1 < kWeightTiles) load_weights(wt + 1);
    cp_async_commit();
    return static_cast<const bf16*>(ring + (wt++ % 2) * kRingStage);
  };

  // y1 window: low-res rows / columns [l0 - 2, l0 + 10).
  conv3x3_mma<kYW * kYW, kYW, kXW, kXStride, kCin, kC, 4>(
      xs, ring_tap, [&](int p, int co, float v0, float v1) {
        *reinterpret_cast<uint32_t*>(ys + p * kStride + co) =
            bias_relu(v0, v1, a.b_up, co);
      });
  __syncthreads();

  if (kRes) {   // the block's own 8 x 8 low-res y1 pixels, window offset 2
    for (int c = tid; c < kTile * kTile / 4 * 8; c += kThreads) {
      const int p = c / 8, ch = (c % 8) * 8;
      const int r = p / (kTile / 2), col = p % (kTile / 2);
      const int gy = ly0 + r, gx = lx0 + col;
      if (gy < hl && gx < wl)
        *reinterpret_cast<uint4*>(a.y1 + ((b * hl + gy) * wl + gx) * kC +
                                  ch) =
            *reinterpret_cast<const uint4*>(
                ys + ((r + 2) * kYW + col + 2) * kStride + ch);
    }
  }

  // up window: high-res rows / columns [o0 - 2, o0 + 18), each evaluated
  // at its reflected coordinate (c5's input padding).  align_corners =
  // False at scale 2: even rows blend (i, i - 1), odd rows (i, i + 1), as
  // 0.75 near + 0.25 far, clamped at the image's edges.
  for (int c = tid; c < kUW * kUW * 8; c += kThreads) {
    const int p = c / 8, c8 = (c % 8) * 8;
    const int yr = reflect_index(oy0 - 2 + p / kUW, hh);
    const int xr = reflect_index(ox0 - 2 + p % kUW, wh);
    const int iy = yr >> 1, ix = xr >> 1;
    const int fy = (yr & 1) ? min(iy + 1, hl - 1) : max(iy - 1, 0);
    const int fx = (xr & 1) ? min(ix + 1, wl - 1) : max(ix - 1, 0);
    // the far column lies in another packed pair of the TPU kernel's
    const bool apart = fx != ix && (ix & 1) == (xr & 1);
    auto wy = [&](int r) { return min(max(r - (ly0 - 2), 0), kYW - 1); };
    auto wx = [&](int r) { return min(max(r - (lx0 - 2), 0), kYW - 1); };
    *reinterpret_cast<uint4*>(us + p * kStride + c8) =
        up_chunk(ys, wy(iy), wy(fy), wx(ix), wx(fx), apart, c8);
  }
  // (the c5 conv's first ring_tap publishes up before any read)

  // c5 window: high-res rows / columns [o0 - 1, o0 + 17).
  conv3x3_mma<kCW * kCW, kCW, kUW, kStride, kC, kC, 8>(
      us, ring_tap, [&](int p, int co, float v0, float v1) {
        *reinterpret_cast<uint32_t*>(cs + p * kStride + co) =
            bias_relu(v0, v1, a.b5, co);
      });
  __syncthreads();

  // c6's input padding: c5 positions outside the image take the value of
  // their in-image mirror (sources are in-image, destinations are not).
  for (int c = tid; c < kCW * kCW * 8; c += kThreads) {
    const int p = c / 8, c8 = (c % 8) * 8;
    const int gy = oy0 - 1 + p / kCW, gx = ox0 - 1 + p % kCW;
    if (gy >= 0 && gy < hh && gx >= 0 && gx < wh) continue;
    const int sy = min(max(reflect_index(gy, hh) - (oy0 - 1), 0), kCW - 1);
    const int sx = min(max(reflect_index(gx, wh) - (ox0 - 1), 0), kCW - 1);
    *reinterpret_cast<uint4*>(cs + p * kStride + c8) =
        *reinterpret_cast<const uint4*>(cs + (sy * kCW + sx) * kStride + c8);
  }
  __syncthreads();

  if (kRes) {   // the block's own 16 x 16 c5 pixels, window offset 1
    for (int c = tid; c < kTile * kTile * 8; c += kThreads) {
      const int p = c / 8, ch = (c % 8) * 8;
      const int gy = oy0 + p / kTile, gx = ox0 + p % kTile;
      if (gy < hh && gx < wh)
        *reinterpret_cast<uint4*>(a.c5 + ((b * hh + gy) * wh + gx) * kC +
                                  ch) =
            *reinterpret_cast<const uint4*>(
                cs + ((p / kTile + 1) * kCW + p % kTile + 1) * kStride + ch);
    }
  }

  // c6: the 16 x 16 output pixels, one n8 tile of which channels 0-2 are
  // stored.
  conv3x3_mma<kTile * kTile, kTile, kCW, kStride, kC, kN6, 1>(
      cs,
      [&](int tap) {
        return static_cast<const bf16*>(w6s + tap * kC * kN6);
      },
      [&](int p, int co, float v0, float v1) {
        const int gy = oy0 + p / kTile, gx = ox0 + p % kTile;
        if (co >= 3 || gy >= hh || gx >= wh) return;
        bf16* o = a.out + ((b * hh + gy) * wh + gx) * 3 + co;
        o[0] = __float2bfloat16(fmaxf(rnd(rnd(v0) + __ldg(a.b6 + co)), 0.f));
        if (co + 1 < 3)
          o[1] = __float2bfloat16(
              fmaxf(rnd(rnd(v1) + __ldg(a.b6 + co + 1)), 0.f));
      });
}

template <bool kRes>
cudaError_t launch_decoder_tail_mma(const TailArgs& a, int batch,
                                    cudaStream_t stream) {
  const dim3 grid((2 * a.wl + kTile - 1) / kTile,
                  (2 * a.hl + kTile - 1) / kTile, batch);
  return launch_with_smem(decoder_tail_mma_kernel<kRes>, grid,
                          dim3(kThreads), kSmemBytes, stream, a);
}

}  // namespace tail
}  // namespace mhada
