// The bf16 decoder tail on Hopper's asynchronous units: K5 (kRes = false)
// and K8's forward (kRes, also writing the residuals y1 and c5), as two
// wgmma kernels launched by one entry call, split as the float32 build is
// (decoder_tail_f32.cuh):
//
//   stage 1, tail_up3_wgmma_kernel:
//       y1 = relu(round(round(conv3x3(reflect_pad(x))) + b_up))
//       128 -> 64 at low res over the whole image, no pixel computed twice;
//       y1 (B, H, W, 64) goes to device memory once (K8: its residual; K5:
//       a scratch tensor the wrapper allocates).
//   stage 2, tail_c5c6_wgmma_kernel<kRes>:
//       up  = bilinear 2x of y1 (align_corners=False, edge clamp)
//       c5  = relu(round(round(conv3x3(reflect_pad(up))) + b5))  64 -> 64
//       out = relu(round(round(conv3x3(reflect_pad(c5))) + b6))  64 -> 3
//       at high res, recomputing only c5's 1-pixel ring; K8 also stores c5.
//
// Replaces, at bf16, mhada_tpu/ops/decoder_tail_pallas.py::tail3_fused
// (_tail3_kernel, pallas_call at decoder_tail_pallas.py:546; with
// _tail3_kernel_res, :519), with its rounding points: each conv's float32
// sum is rounded to bf16, the bf16 bias added and the sum rounded again
// (decoder_tail_pallas.py:328, 369, 563-564); `up` is blended rows first,
// 0.75 near rounded before adding 0.25 far, then columns from the rounded
// rows, where 0.75 near is rounded apart only for output columns 4j and
// 4j + 3 (the TPU's packed columns; ops/decoder_tail.py::upsample2x_tail is
// the same function in PyTorch).  Reflect padding belongs to each stage's
// own input: up3 reads x at reflected coordinates, up is evaluated at
// reflected high-res coordinates, and c5 positions outside the image are
// overwritten by their in-image mirrors before c6 reads them.
//
// Bound: 2 x 9 x (H W 128 64 + 4 H W 64 64 + 4 H W 64 3) flops, 29.9
// GFLOP from 256^2 to 512^2 (0.030 ms at the bf16 tensor-core rate),
// against the x read and the rgb write (K8: also y1 and c5): operations.
//
// Design.  Every conv is an implicit GEMM on wgmma m64n64k16: M = 64
// window positions a warpgroup (warp w supplies 16 of them), N = the 64
// output channels, K = 9 taps x C_in in units of one tap's 64 input
// channels (4 k16 products, one commit group).
// - A from registers.  A tap is a shift of the window positions, which a
//   shared-memory descriptor cannot express; each lane's ldmatrix of its
//   window position (pixel-major, 72 bf16 = 144 bytes a position, so the
//   eight rows of an ldmatrix phase fall on distinct banks) gives the
//   m16n8k16 A fragments of the warp's 16 rows, which are the register-A
//   layout of wgmma.  The next unit's fragments load into the other of two
//   register sets while this unit's products run (wait_group 1), and are
//   fenced before wgmma.fence: no register a product reads is written
//   while its group is open (ptxas would serialise the products, C7513).
// - B from shared memory: the weights stay HWIO, [tap][ci][co], so a unit's
//   box of 64 input x 64 output channels is MN-major B (the transpose bit),
//   one 128-byte row of output channels a k row, landed by TMA in the
//   128-byte swizzle and read by a sw128 descriptor, 2048 bytes a k16 step.
// - Persistent blocks, weights resident: each block loads its weights once
//   by TMA (stage 1: w_up's 18 boxes, 147 KB, one mbarrier a box, so the
//   first tile's products start as their box lands; stage 2: w5's 9 boxes,
//   74 KB) and walks tiles blockIdx.x, + gridDim.x, ...; no barrier a tap.
// - Stage 1: two consumer warpgroups a block, each walking its own tiles of
//   4 x 16 y1 pixels (64 positions) with its own x window of 6 x 18
//   positions, reflect-mapped, by cp.async in two halves of 64 channels:
//   the next tile's half 0 lands while this tile's half-1 units run, its
//   half 1 while this tile's epilogue and the next tile's half-0 units run.
//   Epilogue: relu(round(round(acc) + b)) straight from the accumulators
//   to y1, 4 bytes a channel pair.
// - Stage 2: a block of three warpgroups owns a 16 x 16 rgb tile at a
//   time: the y1 window (12 x 12 low-res, reflect-mapped, cp.async; the
//   next tile's lands while this tile's c5 products run), the up window (20
//   x 20) blended from it rows first (a 20 x 12 row blend) then columns, in
//   bf16x2 arithmetic, c5 on the 18 x 18 window around the tile (6 m64
//   tiles, two a warpgroup; padding rows of the last read a clamped
//   position and are never stored).  Two warpgroups each walking 8 x 16
//   tiles with windows of their own, so that one's blends and sums run
//   under the other's products, measured 2.5-4 % slower on an H100: the
//   smaller tile's halo costs more than the overlap gains.
// - c6 rides on c5's epilogue as one more wgmma: c5's rounded bf16 pairs
//   in the accumulator layout are, per warp, the A fragments of the next
//   product (as P is in attention_wgmma.cuh), and B is c6's weights as one
//   64 x 64 box [ci][tap x 3 + co] (27 columns, zero past them; written
//   once in the 128-byte swizzle and fenced for the async proxy), so
//   Z[q][tap x 3 + co] = sum over ci of c5[q][ci] w6[tap][ci][co] for every
//   window position q (4 k16 products a c5 tile).  Z (float32, 27 columns)
//   goes to shared memory, the Z rows of c5's out-of-image ring are copied
//   from their mirrors (Z is linear in a position's c5), and each rgb
//   value is the 9 taps' sum of Z at shifted positions, rounded, plus the
//   bias, rounded, ReLU.  c5 is read from registers once, where a direct c6
//   conv reads the c5 window 9 times (an n8 tile per m16, smem-bound on
//   mma.sync); K8 stores c5 from the same registers.
//
// Shared memory: stage 1 147 KB of w_up + 4 x 15.2 KB of x half windows
// (206 KB); stage 2 74 KB of w5 + c6's 8 KB box + up 56 KB + Z 34 KB (the
// row blend before it) + y1 20 KB (192 KB); one block an SM, no setmaxnreg
// (no producer: the loads are issued by the consumers).  Pointers 16-byte
// aligned (the entry refuses others); H, W >= 2.
#pragma once

#include <stdint.h>

#include "common.cuh"
#include "flash_mma.cuh"   // mma::ldmatrix_x4, pack_bf16, cp.async
#include "hopper_async.cuh"

namespace mhada {
namespace tailwg {

using bf16 = __nv_bfloat16;
using namespace wg;

constexpr int kC = 64;                     // y1, up and c5 channels
constexpr int kCin = 128;                  // x channels
constexpr int kConsumers = 2;              // stage 1: warpgroups a block
constexpr int kThreads = 128 * kConsumers;
constexpr int kConsumers2 = 3;             // stage 2: warpgroups a block
constexpr int kThreads2 = 128 * kConsumers2;
constexpr int kWarps2 = kThreads2 / 32;
constexpr int kStride = 72;                // bf16 a 64-channel position
constexpr int kPosBytes = 2 * kStride;     // 144
constexpr int kBoxBytes = 64 * 64 * 2;     // a unit's weight box
constexpr int kMaxSmem = 227 * 1024;       // a block's dynamic shared memory

// Stage 1: a warpgroup's tile of kUR x kUC y1 pixels, its x window.
constexpr int kUR = 4, kUC = 16;
constexpr int kXR = kUR + 2, kXC = kUC + 2;                // 6 x 18
constexpr int kXHalfBytes = kXR * kXC * kPosBytes;         // 15,552
constexpr int kUpUnits = 2 * 9;   // w_up's boxes: unit u = half (u / 9), tap
constexpr size_t kSmem1 = 1024 + kUpUnits * kBoxBytes +
                          kConsumers * 2 * kXHalfBytes + 8 * kUpUnits;

// Stage 2: a kTile x kTile rgb tile and its windows.
constexpr int kTile = 16;
constexpr int kYW = kTile / 2 + 4;         // y1 window: 12 (low res)
constexpr int kUW = kTile + 4;             // up window: 20 (high res)
constexpr int kCW = kTile + 2;             // c5 window: 18 (high res)
constexpr int kC5Pos = kCW * kCW;          // 324
constexpr int kC5Tiles = (kC5Pos + 63) / 64;   // 6 m64 tiles
constexpr int kZ = 27;                     // c6's taps x outputs
// Byte offsets from the 1024-aligned base: w5's 9 boxes, c6's box, the up
// window, the row blend or Z, the y1 window, the barrier.
constexpr int kW6Off = 9 * kBoxBytes;
constexpr int kUpOff = kW6Off + kBoxBytes;
constexpr int kZOff = kUpOff + kUW * kUW * kPosBytes;
constexpr int kZBytes = (kC5Pos * kZ * 4 + 15) / 16 * 16;
constexpr int kY1Off = kZOff + kZBytes;
constexpr int kBar2Off = kY1Off + kYW * kYW * kPosBytes;
constexpr size_t kSmem2 = 1024 + kBar2Off + 8;

static_assert(kUR * kUC == 64, "a stage-1 tile is one m64 tile");
static_assert(kUR == 4 && kUC == 16, "warp w owns row w of the tile");
static_assert(kC5Tiles % kConsumers2 == 0, "the c5 tiles split evenly");
static_assert(kUW * kYW * kPosBytes <= kZBytes, "the row blend fits Z's room");
static_assert(kZ <= 32, "Z's columns are n8 chunks 0-3 of the c6 product");
static_assert(kSmem1 <= kMaxSmem && kSmem2 <= kMaxSmem, "shared memory");
static_assert(kXHalfBytes % 16 == 0 && kY1Off % 16 == 0 && kUpOff % 1024 == 0,
              "alignment");

struct TailArgs {
  const bf16* x;        // (B, H, W, 128)
  const float* b_up;    // (64,), bf16 values
  const float* b5;
  const bf16* w6;       // (3, 3, 64, 3) HWIO
  const float* b6;
  bf16* out;            // (B, 2H, 2W, 3)
  bf16* y1;             // (B, H, W, 64): K8's residual or K5's scratch
  bf16* c5;             // K8: (B, 2H, 2W, 64)
  int batch, hl, wl;
};

__device__ __forceinline__ float rnd(float x) { return round_to<bf16>(x); }

// relu(round(round(acc) + bias)) of two neighbouring channels, packed.
__device__ __forceinline__ uint32_t bias_relu(float v0, float v1, float b0,
                                              float b1) {
  return mma::pack_bf16(fmaxf(rnd(rnd(v0) + b0), 0.f),
                        fmaxf(rnd(rnd(v1) + b1), 0.f));
}

// One unit's four k16 products on the register fragments `af` and the
// weight box at `box`, committed as one group; kFirst writes acc without
// reading it.
template <bool kFirst>
__device__ __forceinline__ void unit_products(float (&acc)[32],
                                              uint32_t (&af)[4][4],
                                              uint32_t box) {
  fence_frags(af);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t desc = sw128_desc(box + 2048 * kk, kBoxBytes, 1024);
    if (kFirst && kk == 0)
      wgmma_m64n64k16_rs_first<1>(acc, af[0], desc);
    else
      wgmma_m64n64k16_rs<1>(acc, af[kk], desc, 1);
  }
  wgmma_commit();
}

// acc = the implicit GEMM of kUnits units: frags(af, u) loads unit u's A
// fragments, box(u) returns its weight box once it may be read, before(u)
// runs before unit u's fragments load (u > 0), while unit u - 1's products
// run.  Units alternate between two fragment sets, named statically.
// Every product is done on return.  Called by a whole warpgroup.
template <int kUnits, typename Frags, typename Box, typename Before>
__device__ __forceinline__ void conv_units(float (&acc)[32], Frags frags,
                                           Box box, Before before) {
  uint32_t af0[4][4], af1[4][4];
  frags(af0, 0);
  unit_products<true>(acc, af0, box(0));
#pragma unroll
  for (int u = 1; u < kUnits; u += 2) {
    before(u);
    frags(af1, u);   // unit u - 2, their last reader, is done
    unit_products<false>(acc, af1, box(u));
    wgmma_wait<1>();   // unit u - 1 is done
    if (u + 1 < kUnits) {
      before(u + 1);
      frags(af0, u + 1);
      unit_products<false>(acc, af0, box(u + 1));
      wgmma_wait<1>();
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);
}

// Stage 1: y1 from x; grid <= the SMs, each block's warpgroups walking
// tiles blockIdx.x * kConsumers + g, + gridDim.x * kConsumers, ...
// wmap: w_up HWIO as (64, 9 x 128) in boxes of 64 x 64, 128-byte swizzle.
__global__ void __launch_bounds__(kThreads, 1)
    tail_up3_wgmma_kernel(const __grid_constant__ CUtensorMap wmap,
                          const TailArgs a) {
  extern __shared__ unsigned char smem_raw[];
  // The 128-byte swizzle repeats every 1024 bytes: align the base to it.
  unsigned char* smem =
      smem_raw + (1024 - mma::smem_addr(smem_raw) % 1024) % 1024;
  const uint32_t base = mma::smem_addr(smem);
  const uint32_t wins = base + kUpUnits * kBoxBytes;
  const uint32_t bars = wins + kConsumers * 2 * kXHalfBytes;
  auto wbar = [&](int u) { return bars + 8 * u; };

  if (threadIdx.x == 0) {
    for (int u = 0; u < kUpUnits; ++u) mbar_init(wbar(u), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    // box u: input channels 64 (u / 9) .. + 63 of tap u % 9
    for (int u = 0; u < kUpUnits; ++u) {
      mbar_expect_tx(wbar(u), kBoxBytes);
      tma_load_2d(base + u * kBoxBytes, &wmap, wbar(u), 0,
                  (u % 9) * kCin + (u / 9) * 64);
    }
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = warp / 4, w = warp % 4, tid = threadIdx.x % 128;
  const int hl = a.hl, wl = a.wl;
  const int tiles_x = (wl + kUC - 1) / kUC;
  const int per_image = tiles_x * ((hl + kUR - 1) / kUR);
  const int total = a.batch * per_image;
  const int stride = gridDim.x * kConsumers;
  const uint32_t win = wins + g * 2 * kXHalfBytes;   // half h at + h x

  // Half h of tile t's x window (rows ty0 - 1 .., columns tx0 - 1 ..,
  // reflect-mapped; clamped past a ragged edge), one commit group (empty
  // past the last tile).
  auto load_half = [&](int t, int h) {
    if (t < total) {
      const int b = t / per_image, r = t % per_image;
      const int ty0 = r / tiles_x * kUR, tx0 = r % tiles_x * kUC;
      const bf16* xb = a.x + static_cast<long long>(b) * hl * wl * kCin +
                       h * 64;
      for (int c = tid; c < kXR * kXC * 8; c += 128) {
        const int p = c / 8, c8 = (c % 8) * 8;
        const int gy = reflect_index(ty0 - 1 + p / kXC, hl);
        const int gx = reflect_index(tx0 - 1 + p % kXC, wl);
        mma::cp_async_16(win + h * kXHalfBytes + p * kPosBytes + 2 * c8,
                         xb + (static_cast<long long>(gy) * wl + gx) * kCin +
                             c8,
                         true);
      }
    }
    mma::cp_async_commit();
  };

  // the lane's A row: tile row w, column lane % 16; lanes 16-31 the upper
  // 8 channels of a k16 step
  const uint32_t arow = (w * kXC + lane % 16) * kPosBytes + (lane / 16) * 16;
  auto frags = [&](uint32_t (&af)[4][4], int u) {
    const int tap = u % 9;
    const uint32_t at = win + (u / 9) * kXHalfBytes + arow +
                        ((tap / 3) * kXC + tap % 3) * kPosBytes;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma::ldmatrix_x4(af[kk], at + 32 * kk);
  };
  auto box = [&](int u) {
    mbar_wait_or_trap(wbar(u), 0);   // landed once, for every tile
    return base + u * kBoxBytes;
  };

  // element e of n8 chunk n is acc[4 n + e]: row 16 w + lane / 4 + 8 (e /
  // 2), channel 8 n + 2 (lane % 4) + e % 2
  const int t4 = lane % 4;
  float bias[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) bias[i] = a.b_up[8 * (i / 2) + 2 * t4 + i % 2];

  int t = blockIdx.x * kConsumers + g;
  load_half(t, 0);
  load_half(t, 1);
  for (; t < total; t += stride) {
    const int next = t + stride;
    mma::cp_async_wait<1>();
    named_sync(1 + g, 128);   // half 0 of tile t, every thread's copies
    float acc[32];
    conv_units<kUpUnits>(acc, frags, box, [&](int u) {
      if (u == 9) {
        // units 0-8 hold their fragments: half 0 is free for the next tile
        named_sync(1 + g, 128);
        load_half(next, 0);
        mma::cp_async_wait<1>();
        named_sync(1 + g, 128);   // half 1 of tile t
      }
    });
    named_sync(1 + g, 128);   // no lane reads half 1 any more
    load_half(next, 1);

    const int b = t / per_image, r = t % per_image;
    const int gy = r / tiles_x * kUR + w;
    if (gy >= hl) continue;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int gx = r % tiles_x * kUC + lane / 4 + 8 * rr;
      if (gx >= wl) continue;
      bf16* dst = a.y1 +
                  ((static_cast<long long>(b) * hl + gy) * wl + gx) * kC +
                  2 * t4;
#pragma unroll
      for (int n = 0; n < 8; ++n)
        *reinterpret_cast<uint32_t*>(dst + 8 * n) =
            bias_relu(acc[4 * n + 2 * rr], acc[4 * n + 2 * rr + 1],
                      bias[2 * n], bias[2 * n + 1]);
    }
  }
}

// The 0.75 near + 0.25 far blend of 8 channels (a 16-byte chunk) of two
// lines, 0.75 near rounded first when `apart`, the sum rounded, in bf16x2
// arithmetic: each product and sum is rounded once from its exact value,
// which is what rounding the float32 result gives here (the float32 sums
// are exact unless one term is below 2^-15 of the other, and then both
// round to the larger).
__device__ __forceinline__ uint4 blend_chunk(uint4 near, uint4 far,
                                             bool apart) {
  using bf2 = __nv_bfloat162;
  const bf2 k75 = __float2bfloat162_rn(0.75f);
  const bf2 k25 = __float2bfloat162_rn(0.25f);
  const bf2* pn = reinterpret_cast<const bf2*>(&near);
  const bf2* pf = reinterpret_cast<const bf2*>(&far);
  uint4 out;
  bf2* po = reinterpret_cast<bf2*>(&out);
#pragma unroll
  for (int e = 0; e < 4; ++e)
    po[e] = apart ? __hfma2(k25, pf[e], __hmul2(k75, pn[e]))
                  : __hfma2(k75, pn[e], __hmul2(k25, pf[e]));
  return out;
}

// Stage 2: rgb (and K8's c5) from y1; grid <= the SMs, each block walking
// rgb tiles blockIdx.x, + gridDim.x, ...  w5map: w5 HWIO as (64, 9 x 64)
// in boxes of 64 x 64, 128-byte swizzle.
template <bool kRes>
__global__ void __launch_bounds__(kThreads2, 1)
    tail_c5c6_wgmma_kernel(const __grid_constant__ CUtensorMap w5map,
                           const TailArgs a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + (1024 - mma::smem_addr(smem_raw) % 1024) % 1024;
  const uint32_t base = mma::smem_addr(smem);
  bf16* us = reinterpret_cast<bf16*>(smem + kUpOff);   // [20 x 20][72]
  bf16* rs = reinterpret_cast<bf16*>(smem + kZOff);    // [20][12][72]
  float* zs = reinterpret_cast<float*>(smem + kZOff);  // [18 x 18][27]
  bf16* ys = reinterpret_cast<bf16*>(smem + kY1Off);   // [12 x 12][72]
  const uint32_t bar = base + kBar2Off;

  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar, 9 * kBoxBytes);
    for (int tap = 0; tap < 9; ++tap)
      tma_load_2d(base + tap * kBoxBytes, &w5map, bar, 0, tap * kC);
  }
  const int tid = threadIdx.x;
  // c6's box: w6 as [ci][tap x 3 + co], zero past column 26, written in the
  // 128-byte swizzle (16-byte chunk j of row ci at j ^ (ci % 8)) that the
  // descriptor reads, then fenced for the products' async proxy
  for (int i = tid; i < kC * 64; i += kThreads2) {
    const int ci = i / 64, j = i % 64;
    const bf16 v = j < kZ ? a.w6[((j / 3) * kC + ci) * 3 + j % 3]
                          : __float2bfloat16(0.f);
    *reinterpret_cast<bf16*>(smem + kW6Off + ci * 128 +
                             (((j / 8) ^ (ci % 8)) << 4) + 2 * (j % 8)) = v;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");

  const int warp = tid / 32, lane = tid % 32, g = warp / 4, w = warp % 4;
  const int hl = a.hl, wl = a.wl, hh = 2 * hl, wh = 2 * wl;
  const int tiles_x = (wh + kTile - 1) / kTile;
  const int per_image = tiles_x * ((hh + kTile - 1) / kTile);
  const int total = a.batch * per_image;

  // y1 window of tile t: low-res rows / columns [l0 - 2, l0 + 10),
  // reflect-mapped (only in-image positions are read), one commit group
  // (empty past the last tile).
  auto load_y1 = [&](int t) {
    if (t < total) {
      const int b = t / per_image, r = t % per_image;
      const int ly0 = r / tiles_x * kTile / 2, lx0 = r % tiles_x * kTile / 2;
      const bf16* yb = a.y1 + static_cast<long long>(b) * hl * wl * kC;
      for (int c = tid; c < kYW * kYW * 8; c += kThreads2) {
        const int p = c / 8, c8 = (c % 8) * 8;
        const int gy = reflect_index(ly0 - 2 + p / kYW, hl);
        const int gx = reflect_index(lx0 - 2 + p % kYW, wl);
        mma::cp_async_16(mma::smem_addr(ys + p * kStride + c8),
                         yb + (static_cast<long long>(gy) * wl + gx) * kC +
                             c8,
                         true);
      }
    }
    mma::cp_async_commit();
  };

  // c5's A rows: m64 tile i, row 16 w + lane % 16 of it, clamped
  const uint32_t ub = mma::smem_addr(us) + (lane / 16) * 16;
  const int t4 = lane % 4;
  float bias[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) bias[i] = a.b5[8 * (i / 2) + 2 * t4 + i % 2];

  load_y1(blockIdx.x);
  for (int t = blockIdx.x; t < total; t += gridDim.x) {
    const long long b = t / per_image;
    const int r = t % per_image;
    const int oy0 = r / tiles_x * kTile, ox0 = r % tiles_x * kTile;
    const int ly0 = oy0 / 2, lx0 = ox0 / 2;
    mma::cp_async_wait<0>();
    __syncthreads();   // the y1 window (and, first, c6's box) for every thread

    // up window: high-res rows / columns [o0 - 2, o0 + 18), each evaluated
    // at its reflected coordinate (c5's input padding).  align_corners =
    // False at scale 2: even lines blend (i, i - 1), odd lines (i, i + 1),
    // as 0.75 near + 0.25 far, clamped at the image's edges.  Rows first,
    // each 0.75 near rounded before the sum, into the row blend [20 up
    // rows][12 y1 window columns] (in Z's room, free until the c5
    // epilogues); then columns from the rounded rows, 0.75 near rounded
    // apart only where the far column lies in another packed pair of the
    // TPU kernel's (output columns 4j and 4j + 3).
    for (int c = tid; c < kUW * kYW * 8; c += kThreads2) {
      const int q = c / 8, c8 = (c % 8) * 8, col = q % kYW;
      const int yr = reflect_index(oy0 - 2 + q / kYW, hh), iy = yr >> 1;
      const int fy = (yr & 1) ? min(iy + 1, hl - 1) : max(iy - 1, 0);
      auto wy = [&](int v) { return min(max(v - (ly0 - 2), 0), kYW - 1); };
      auto ld = [&](int row) {
        return *reinterpret_cast<const uint4*>(
            ys + (wy(row) * kYW + col) * kStride + c8);
      };
      *reinterpret_cast<uint4*>(rs + q * kStride + c8) =
          blend_chunk(ld(iy), ld(fy), true);
    }
    __syncthreads();
    for (int c = tid; c < kUW * kUW * 8; c += kThreads2) {
      const int p = c / 8, c8 = (c % 8) * 8, row = p / kUW;
      const int xr = reflect_index(ox0 - 2 + p % kUW, wh), ix = xr >> 1;
      const int fx = (xr & 1) ? min(ix + 1, wl - 1) : max(ix - 1, 0);
      auto ld = [&](int v) {
        const int col = min(max(v - (lx0 - 2), 0), kYW - 1);
        return *reinterpret_cast<const uint4*>(
            rs + (row * kYW + col) * kStride + c8);
      };
      *reinterpret_cast<uint4*>(us + p * kStride + c8) =
          blend_chunk(ld(ix), ld(fx), fx != ix && (ix & 1) == (xr & 1));
    }
    __syncthreads();        // up is whole; the y1 window and rs are free
    load_y1(t + gridDim.x);   // lands under the c5 products
    mbar_wait_or_trap(bar, 0);

    // c5 window: high-res rows / columns [o0 - 1, o0 + 17), m64 tiles g,
    // g + kConsumers2, ...; per tile, c5 = relu(round(round(acc) + b5)) in
    // bf16 pairs, which are the A fragments of c6's product (the m64n64
    // accumulator layout is, per warp, the m16n8k16 A layout), and K8's
    // stores straight from them.
#pragma unroll 1
    for (int i = g; i < kC5Tiles; i += kConsumers2) {
      const int p = min(i * 64 + 16 * w + lane % 16, kC5Pos - 1);
      const uint32_t arow = ub + ((p / kCW) * kUW + p % kCW) * kPosBytes;
      float acc[32];
      conv_units<9>(
          acc,
          [&](uint32_t (&af)[4][4], int tap) {
            const uint32_t at =
                arow + ((tap / 3) * kUW + tap % 3) * kPosBytes;
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              mma::ldmatrix_x4(af[kk], at + 32 * kk);
          },
          [&](int tap) { return base + tap * kBoxBytes; }, [](int) {});
      // k-step kk of c5's channels: rows lane / 4 (+ 8), channels 16 kk +
      // 2 (lane % 4) (+ 8)
      uint32_t cf[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = 2 * kk + e / 2, rr = e % 2;
          cf[kk][e] = bias_relu(acc[4 * n + 2 * rr], acc[4 * n + 2 * rr + 1],
                                bias[2 * n], bias[2 * n + 1]);
        }
      // c6's partial sums: Z[q][tap x 3 + co] = sum over ci of c5[q][ci]
      // w6[tap][ci][co], one m64n64k16 product a k-step
      float z[32];
      fence_frags(cf);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t desc =
            sw128_desc(base + kW6Off + 2048 * kk, kBoxBytes, 1024);
        if (kk == 0)
          wgmma_m64n64k16_rs_first<1>(z, cf[0], desc);
        else
          wgmma_m64n64k16_rs<1>(z, cf[kk], desc, 1);
      }
      wgmma_commit();
      if (kRes) {   // the tile's own c5 pixels: window rows / columns 1-16
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int q = i * 64 + 16 * w + lane / 4 + 8 * rr;
          const int gy = oy0 - 1 + q / kCW, gx = ox0 - 1 + q % kCW;
          if (q >= kC5Pos || q / kCW < 1 || q / kCW > kTile ||
              q % kCW < 1 || q % kCW > kTile || gy >= hh || gx >= wh)
            continue;
          bf16* dst = a.c5 + ((b * hh + gy) * wh + gx) * kC + 2 * t4;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            *reinterpret_cast<uint32_t*>(dst + 16 * kk) = cf[kk][rr];
            *reinterpret_cast<uint32_t*>(dst + 16 * kk + 8) = cf[kk][2 + rr];
          }
        }
      }
      wgmma_wait<0>();
      fence_regs(z);
      fence_frags(cf);
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int q = i * 64 + 16 * w + lane / 4 + 8 * rr;
        if (q >= kC5Pos) continue;
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (8 * n + 2 * t4 + e < kZ)
              zs[q * kZ + 8 * n + 2 * t4 + e] = z[4 * n + 2 * rr + e];
      }
    }
    __syncthreads();

    // c6's input padding: the Z rows of c5 positions on global row -1 or
    // hh, or column -1 or wh, take the values of their in-image mirror's
    // (Z is linear in a position's c5; sources are in-image, destinations
    // are not).  Positions further out are read by no stored pixel.
    const int rt = oy0 == 0 ? 0 : -1, rb = hh - oy0 + 1;
    const int cl = ox0 == 0 ? 0 : -1, cr = wh - ox0 + 1;
    if (rt == 0 || rb < kCW || cl == 0 || cr < kCW) {   // block-uniform
      for (int c = tid; c < 4 * kCW * kZ; c += kThreads2) {
        const int e = c / kZ, j = c % kZ, side = e / kCW, k = e % kCW;
        const int row = side == 0 ? rt : side == 1 ? rb : k;
        const int col = side == 2 ? cl : side == 3 ? cr : k;
        if (row < 0 || row >= kCW || col < 0 || col >= kCW) continue;
        const int sy = min(max(reflect_index(oy0 - 1 + row, hh) - (oy0 - 1),
                               0), kCW - 1);
        const int sx = min(max(reflect_index(ox0 - 1 + col, wh) - (ox0 - 1),
                               0), kCW - 1);
        zs[(row * kCW + col) * kZ + j] = zs[(sy * kCW + sx) * kZ + j];
      }
      __syncthreads();
    }

    // c6: rgb = relu(round(round(sum over taps of Z) + b6)) at the tile's
    // pixels in the image
    for (int px = tid; px < kTile * kTile; px += kThreads2) {
      const int gy = oy0 + px / kTile, gx = ox0 + px % kTile;
      if (gy >= hh || gx >= wh) continue;
      float v[3] = {0.f, 0.f, 0.f};
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const float* zq =
            zs + ((px / kTile + tap / 3) * kCW + px % kTile + tap % 3) * kZ +
            3 * tap;
#pragma unroll
        for (int co = 0; co < 3; ++co) v[co] += zq[co];
      }
      bf16* o = a.out + ((b * hh + gy) * wh + gx) * 3;
#pragma unroll
      for (int co = 0; co < 3; ++co)
        o[co] =
            __float2bfloat16(fmaxf(rnd(rnd(v[co]) + __ldg(a.b6 + co)), 0.f));
    }
  }
}

// A (rows, 64) bf16 weight matrix (rows contiguous, 128 bytes) as a 2-D
// tensor map of 64 x 64 boxes in the 128-byte swizzle.
inline bool weight_map(CUtensorMap* map, const bf16* w, int rows) {
  const auto encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(kC),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(kC) * 2};
  const cuuint32_t box[2] = {64, 64}, elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<bf16*>(w), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Both stages on `stream`: w_up (3, 3, 128, 64) and w5 (3, 3, 64, 64) HWIO,
// 16-byte aligned as x, y1 and c5 are.
template <bool kRes>
cudaError_t launch_decoder_tail_wgmma(const bf16* w_up, const bf16* w5,
                                      const TailArgs& a,
                                      cudaStream_t stream) {
  if (a.y1 == nullptr || (kRes && a.c5 == nullptr) || a.batch < 1 ||
      a.hl < 2 || a.wl < 2)
    return cudaErrorInvalidValue;
  CUtensorMap wmap, w5map;
  if (!weight_map(&wmap, w_up, 9 * kCin) || !weight_map(&w5map, w5, 9 * kC))
    return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long tiles1 = static_cast<long long>(a.batch) *
                           ((a.hl + kUR - 1) / kUR) * ((a.wl + kUC - 1) / kUC);
  const long long tiles2 = static_cast<long long>(a.batch) *
                           ((2 * a.hl + kTile - 1) / kTile) *
                           ((2 * a.wl + kTile - 1) / kTile);
  if (tiles2 > (1LL << 30)) return cudaErrorInvalidValue;
  const long long blocks1 = (tiles1 + kConsumers - 1) / kConsumers;
  const int grid1 = static_cast<int>(blocks1 < sms ? blocks1 : sms);
  err = launch_with_smem(tail_up3_wgmma_kernel, dim3(grid1), dim3(kThreads),
                         kSmem1, stream, wmap, a);
  if (err != cudaSuccess) return err;
  const int grid2 = static_cast<int>(tiles2 < sms ? tiles2 : sms);
  return launch_with_smem(tail_c5c6_wgmma_kernel<kRes>, dim3(grid2),
                          dim3(kThreads2), kSmem2, stream, w5map, a);
}

}  // namespace tailwg
}  // namespace mhada
