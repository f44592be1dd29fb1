// The float32 decoder tail on the CUDA cores: K5 (mhada_decoder_tail) and
// K8 (mhada_decoder_tail_res, which also stores y1 and c5), as two
// register-tiled direct convolutions launched by one entry call.
//
//   stage 1, tail_up3_f32_kernel:  y1 = relu(conv3x3(reflect_pad(x)) + b_up)
//       128 -> 64 at low res over the whole image; y1 (B, H, W, 64) goes
//       to device memory once (K8: its residual; K5: a scratch tensor the
//       wrapper allocates).
//   stage 2, tail_c5c6_f32_kernel: up = bilinear 2x of y1, c5 = relu(conv3x3(
//       reflect_pad(up)) + b5), rgb = relu(conv3x3(reflect_pad(c5)) + b6)
//       64 -> 64 -> 3 at high res; K8 also stores c5 (B, 2H, 2W, 64).
//
// Each stage pads its own input (decoder_tail_pallas.py:189-213): up3 reads
// x at reflected coordinates, c5 reads up evaluated at reflected high-res
// coordinates (a 0.75 / 0.25 blend of y1, clamped at the edges), and c6
// reads c5 positions outside the image as copies of their mirrors.
//
// What bounds it on the card: operations.  2 x 9 x (128 x 64 + 4 x 64 x 64
// + 4 x 64 x 3) flops a low-res pixel, 29.9 GFLOP from 256^2 to 512^2,
// 0.446 ms at the float32 rate (67 TFLOP/s); the bytes (x, y1 twice, rgb)
// take a twentieth of that.  PR 1's fused tile recomputed every halo (47 GFLOP
// a 512^2 frame) with weights read from global memory at one block an SM.
// Here:
//
// - The split.  Stage 1 recomputes nothing.  Stage 2 recomputes only the
//   1-pixel ring of c5 that c6 reads: a block owns 22 x 30 rgb pixels and
//   evaluates c5 on the 24 x 32 region around them (1.16x the c5 flops,
//   1.27x with the ragged edge tiles of a 512^2 frame; 35.1 GFLOP in
//   all).  c6 is linear in c5's channels, so the block makes c5 in
//   kPasses passes of kCc output channels and keeps each pass in shared
//   memory only until c6 has added its part; c6's partial sums wait in
//   the rgb output between the passes (ReLU at the end).
// - The convolution (conv_step, conv3x3_f32.cuh, shared with K14's float32
//   build).  A thread owns a run of 8 consecutive pixels of one row and 8
//   output channels; for each input channel and kernel row it loads the
//   run and its 2-pixel overlap once and applies the three kernel columns
//   from registers: 192 FFMA for 9 shared loads.
// - The pipeline.  Input channels stream in steps of kCk = 8 through a
//   two-stage cp.async ring: stage 1 copies the x window (10 x 34 low-res
//   pixels, reflect-mapped, 4-byte copies into channel planes) and the
//   step's 9 x 8 x 64 weights (16-byte copies); stage 2 the y1 window (15
//   x 19 low-res pixels, two 16-byte copies a pixel) and the step's 9 x 8
//   x kCc slice of w5.  The next step's copies land while this step
//   computes.
// - The upsample.  Stage 2 evaluates up as c5's window is loaded: each
//   step blends the 26 x 34 window of up for its 8 channels from the y1
//   stage into shared memory (row and column tables give each window line
//   its two source lines and weights), then convolves it.
// - Occupancy.  Stage 1: <= 128 registers a thread and 59 KB of shared
//   memory a block, two blocks of 8 warps an SM.  Stage 2 holds more state
//   across a step (the up window's tables, the pass, c6's mapping) and
//   spilled at 128 registers: one block of 12 warps an SM (384 threads,
//   <= 168 registers, 144 KB).  probes/tail_f32_geometry.py times it
//   against a 16 x 32 region of 8 warps, one block an SM or two (those
//   spill).
//
// Pointers are 16-byte aligned (the entry refuses others).  Offsets of the
// batch and of a pixel are formed in 64 bits.  No TF32, no tensor-core
// instruction (chip_smoke.py phase 2 checks the SASS).
#pragma once

#include <stdint.h>

#include "common.cuh"
#include "conv3x3_f32.cuh"  // conv_step, ld4, ld2, st4
#include "flash_mma.cuh"  // mma::cp_async_16 / _4 / _commit / _wait, smem_addr

namespace mhada {
namespace tailf32 {

constexpr int kThreads = 256;
constexpr int kCin = 128, kCmid = 64, kCout = 3;
using conv3f32::conv_step;
using conv3f32::kCk;  // input channels a pipeline step
using conv3f32::ld2;
using conv3f32::ld4;
using conv3f32::st4;

// Stage 1: a block owns kAR x kAC y1 pixels and all 64 channels; warp w
// computes row w, lane l the run (l / 8) and the channel group (l % 8).
constexpr int kAR = 8, kAC = 32;
constexpr int kAWR = kAR + 2, kAWC = kAC + 2;  // x window: 10 x 34
constexpr int kAWS = 36;                       // its row stride
constexpr int kAPlane = 364;   // >= 10 x 36; 12 mod 32: the copies' banks
constexpr int kAX = kCk * kAPlane;          // x window floats a stage
constexpr int kAW = 9 * kCk * kCmid;        // weight floats a stage
constexpr int kAStage = kAX + kAW;
constexpr size_t kSmemA = sizeof(float) * 2 * kAStage;  // 60,160 B

// Stage 2: a block of kBThreads owns kOR x kOC rgb pixels; c5 over the kBR
// x kBC region (a 1-pixel ring around them) in kPasses passes of kCc
// channels; warp w computes region rows 2w and 2w + 1, lane l the run (l /
// 4) % 4 and the channel group l % 4.
constexpr int kBR = 24, kBC = 32;
constexpr int kOR = kBR - 2, kOC = kBC - 2;  // 22 x 30
constexpr int kCc = 32, kPasses = kCmid / kCc;
constexpr int kBThreads = kBR * kBC / 8 * (kCc / 8);  // 384
constexpr int kChunks = kCmid / kCk;         // steps a pass
constexpr int kUR = kBR + 2, kUC = kBC + 2;  // up window: 26 x 34
constexpr int kUS = 36;                      // its row stride
constexpr int kUPlane = kUR * kUS;
constexpr int kYR = kBR / 2 + 3, kYC = kBC / 2 + 3;  // y1 window: 15 x 19
constexpr int kC5Plane = kBR * kBC + 16;  // 16 mod 32: c6's two halves
constexpr int kBY = kYR * kYC * kCk;      // y1 window floats a stage
constexpr int kBW = 9 * kCk * kCc;        // w5 floats a stage
constexpr int kBStage = kBY + kBW;
constexpr int kW6 = 9 * kCmid * 4;        // [tap][ci][co, padded to 4]
constexpr int kUnion = (kCc * kC5Plane > kCk * kUPlane) ? kCc * kC5Plane
                                                        : kCk * kUPlane;
constexpr int kTabs = 4 * (kUR + kUC);    // int4 line tables
constexpr size_t kSmemB =
    sizeof(float) * (kW6 + kUnion + 2 * kBStage + kTabs);  // 147,200 B
// c6: thread t < kC6Threads owns rgb row t / 16, columns 4 ((t / 2) % 8) ..
// + 3, and the pass's channels of parity t % 2; it stores columns 2 (t % 2)
// and 2 (t % 2) + 1 of its four.
constexpr int kC6Threads = 2 * 8 * kOR;  // 352: warps 0-10

static_assert(kAR * kAC / 8 * (kCmid / 8) == kThreads && kAC == 32,
              "stage 1: a warp a row, 4 runs of 8 pixels to a row");
static_assert(kBC == 32 && kCc == 32 && kC6Threads % 32 == 0 &&
                  kC6Threads <= kBThreads,
              "stage 2: 4 runs to a row, 4 channel groups, whole c6 warps");
static_assert(kAPlane >= kAWR * kAWS && kBStage % 4 == 0 && kAStage % 4 == 0,
              "16-byte aligned stages");
static_assert((kW6 + kUnion + 2 * kBStage) % 4 == 0, "aligned tables");

// Stage 1: y1 (B, hl, wl, 64) from x (B, hl, wl, 128); grid (tiles, B).
__global__ void __launch_bounds__(kThreads, 2)
    tail_up3_f32_kernel(const float* __restrict__ x,
                        const float* __restrict__ w_up,
                        const float* __restrict__ b_up,
                        float* __restrict__ y1, int hl, int wl) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int tiles_x = (wl + kAC - 1) / kAC;
  const int ty0 = (blockIdx.x / tiles_x) * kAR;
  const int tx0 = (blockIdx.x % tiles_x) * kAC;
  const long long b = blockIdx.y;
  const float* xb = x + b * hl * wl * kCin;

  // The x window of input channels kCk c .. + 7 (rows ty0 - 1 .., columns
  // tx0 - 1 .., reflect-mapped) and the step's weights into stage `st`.
  auto issue = [&](int c, float* st) {
    for (int q = tid; q < kAWC * kCk; q += kThreads) {
      const int ci = q % kCk, col = q / kCk;
      const float* src = xb + (long long)reflect_index(tx0 - 1 + col, wl) *
                                  kCin + c * kCk + ci;
      const uint32_t dst = mma::smem_addr(st + ci * kAPlane + col);
#pragma unroll
      for (int r = 0; r < kAWR; ++r)
        mma::cp_async_4(
            dst + 4 * r * kAWS,
            src + (long long)reflect_index(ty0 - 1 + r, hl) * wl * kCin, true);
    }
    float* ws = st + kAX;
    for (int q = tid; q < kAW / 4; q += kThreads) {
      const int tap = q / (kCk * kCmid / 4), o = 4 * (q % (kCk * kCmid / 4));
      mma::cp_async_16(mma::smem_addr(ws + tap * kCk * kCmid + o),
                       w_up + ((long long)tap * kCin + c * kCk) * kCmid + o,
                       true);
    }
  };

  const int g = lane % 8, k = lane / 8;
  float acc[8][8];
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[p][j] = 0.f;

  constexpr int kSteps = kCin / kCk;
  issue(0, smem);
  mma::cp_async_commit();
  for (int c = 0; c < kSteps; ++c) {
    float* st = smem + (c % 2) * kAStage;
    mma::cp_async_wait<0>();
    __syncthreads();  // step c landed; every thread is past step c - 1
    if (c + 1 < kSteps) issue(c + 1, smem + ((c + 1) % 2) * kAStage);
    mma::cp_async_commit();
    conv_step<kAPlane, kAWS, kCk * kCmid, kCmid, 32>(
        st + warp * kAWS + 8 * k, st + kAX + 4 * g, acc);
  }

  const int gy = ty0 + warp;
  if (gy >= hl) return;
  float bias[8];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    bias[j] = b_up[4 * g + j];
    bias[4 + j] = b_up[32 + 4 * g + j];
  }
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const int gx = tx0 + 8 * k + p;
    if (gx >= wl) continue;
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = fmaxf(acc[p][j] + bias[j], 0.f);
    float* dst = y1 + ((b * hl + gy) * wl + gx) * kCmid;
    st4(dst + 4 * g, v[0], v[1], v[2], v[3]);
    st4(dst + 32 + 4 * g, v[4], v[5], v[6], v[7]);
  }
}

// Stage 2: rgb (B, 2hl, 2wl, 3) and, for K8, c5 (B, 2hl, 2wl, 64) from y1;
// grid (column tiles, row tiles, B).
template <bool kRes>
__global__ void __launch_bounds__(kBThreads, 1)
    tail_c5c6_f32_kernel(const float* __restrict__ y1,
                         const float* __restrict__ w5,
                         const float* __restrict__ b5,
                         const float* __restrict__ w6,
                         const float* __restrict__ b6,
                         float* __restrict__ out, float* __restrict__ c5_out,
                         int hl, int wl) {
  extern __shared__ float4 smem4[];
  float* w6s = reinterpret_cast<float*>(smem4);  // [tap][ci][4]
  float* un = w6s + kW6;  // up window [ci][kUR][kUS], then c5 [ci][kC5Plane]
  float* ring = un + kUnion;  // y1 window [pixel][ci], w5 [tap][ci][co]
  int4* tab = reinterpret_cast<int4*>(ring + 2 * kBStage);  // rows, columns

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int hh = 2 * hl, wh = 2 * wl;
  const long long b = blockIdx.z;
  const int oy0 = blockIdx.y * kOR, ox0 = blockIdx.x * kOC;
  const int ly0 = oy0 / 2, lx0 = ox0 / 2;  // tile origins are even
  const float* yb = y1 + b * hl * wl * kCmid;

  for (int i = tid; i < 9 * kCmid; i += kBThreads) {
    w6s[4 * i] = w6[3 * i];
    w6s[4 * i + 1] = w6[3 * i + 1];
    w6s[4 * i + 2] = w6[3 * i + 2];
    w6s[4 * i + 3] = 0.f;
  }
  // Line tables of the up window: up row u (u < kUR) or column u - kUR sits
  // at the reflected high-res coordinate hr; align_corners=False at scale
  // 2 blends low-res lines (hr / 2 - 1, hr / 2) as (0.25, 0.75) when hr is
  // even and (hr / 2, hr / 2 + 1) as (0.75, 0.25) when odd, clamped at the
  // edges.  Entry: the two lines' offsets in the y1 window and the first
  // one's weight.  Window indices are clamped too: only lines that no
  // in-image output reads fall outside.
  for (int i = tid; i < kUR + kUC; i += kBThreads) {
    const bool row = i < kUR;
    const int u = row ? i : i - kUR;
    const int n = row ? hh : wh, nl = row ? hl : wl;
    const int l0 = (row ? ly0 : lx0) - 2, lines = row ? kYR : kYC;
    const int hr = reflect_index((row ? oy0 : ox0) - 2 + u, n), il = hr >> 1;
    const int la = (hr & 1) ? il : max(il - 1, 0);
    const int lb = (hr & 1) ? min(il + 1, nl - 1) : il;
    const int stride = row ? kYC * kCk : kCk;
    tab[i] = make_int4(min(max(la - l0, 0), lines - 1) * stride,
                       min(max(lb - l0, 0), lines - 1) * stride,
                       __float_as_int((hr & 1) ? 0.75f : 0.25f), 0);
  }

  // Step s (pass s / kChunks, input channels kCk (s % kChunks) ..): the y1
  // window (rows ly0 - 2 .., columns lx0 - 2 .., reflect-mapped) and the
  // pass's slice of w5 into stage `st`.
  auto issue = [&](int s, float* st) {
    const int c = s % kChunks, pass = s / kChunks;
    for (int q = tid; q < kYR * kYC * kCk / 4; q += kBThreads) {
      const int px = q / (kCk / 4), h = q % (kCk / 4);
      const int gy = reflect_index(ly0 - 2 + px / kYC, hl);
      const int gx = reflect_index(lx0 - 2 + px % kYC, wl);
      mma::cp_async_16(mma::smem_addr(st + px * kCk + 4 * h),
                       yb + ((long long)gy * wl + gx) * kCmid + c * kCk +
                           4 * h,
                       true);
    }
    float* ws = st + kBY;
    for (int q = tid; q < kBW / 4; q += kBThreads) {
      const int o = 4 * (q % (kCc / 4)), row = q / (kCc / 4);  // tap, ci
      const int tap = row / kCk, ci = row % kCk;
      mma::cp_async_16(
          mma::smem_addr(ws + row * kCc + o),
          w5 + ((long long)tap * kCmid + c * kCk + ci) * kCmid +
              pass * kCc + o,
          true);
    }
  };

  // The up window of the step's channels from its y1 stage `ys`.
  auto build = [&](const float* ys) {
    for (int q = tid; q < kUR * kUC; q += kBThreads) {
      const int u = q / kUC, v = q % kUC;
      const int4 rt = tab[u], ct = tab[kUR + v];
      const float wya = __int_as_float(rt.z), wxa = __int_as_float(ct.z);
      const float wyb = 1.f - wya, wxb = 1.f - wxa;
      float* dst = un + u * kUS + v;
#pragma unroll
      for (int h = 0; h < kCk / 4; ++h) {
        const float4 aa = ld4(ys + rt.x + ct.x + 4 * h);
        const float4 ab = ld4(ys + rt.x + ct.y + 4 * h);
        const float4 ba = ld4(ys + rt.y + ct.x + 4 * h);
        const float4 bb = ld4(ys + rt.y + ct.y + 4 * h);
        const float a0[4] = {aa.x, aa.y, aa.z, aa.w};
        const float a1[4] = {ab.x, ab.y, ab.z, ab.w};
        const float b0[4] = {ba.x, ba.y, ba.z, ba.w};
        const float b1[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float top = wxa * a0[i] + wxb * a1[i];
          const float bot = wxa * b0[i] + wxb * b1[i];
          dst[(4 * h + i) * kUPlane] = wya * top + wyb * bot;
        }
      }
    }
  };

  // c5: region row cr, columns 8 ck .. + 7; channels 4 g .. + 3 and kCc / 2
  // + 4 g .. + 3 of the pass.
  const int g = lane % 4, run = warp * 8 + lane / 4;
  const int cr = run / 4, ck = run % 4;
  // c6: rgb row i6, columns 4 k6 .. + 3, channels of parity h6.
  const int h6 = tid % 2, k6 = (tid / 2) % 8, i6 = tid / 16;
  float acc[8][8];

  constexpr int kSteps = kPasses * kChunks;
  issue(0, ring);
  mma::cp_async_commit();
  for (int s = 0; s < kSteps; ++s) {
    const float* st = ring + (s % 2) * kBStage;
    if (s % kChunks == 0) {
#pragma unroll
      for (int p = 0; p < 8; ++p)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[p][j] = 0.f;
    }
    mma::cp_async_wait<0>();
    __syncthreads();  // step s landed; every thread is past step s - 1
    if (s + 1 < kSteps) issue(s + 1, ring + ((s + 1) % 2) * kBStage);
    mma::cp_async_commit();
    build(st);
    __syncthreads();
    conv_step<kUPlane, kUS, kCk * kCc, kCc, kCc / 2>(un + cr * kUS + 8 * ck,
                                                   st + kBY + 4 * g, acc);
    if (s % kChunks != kChunks - 1) continue;

    // The pass's c5 replaces the up window.
    const int pass = s / kChunks;
    float bias[8];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bias[j] = b5[pass * kCc + 4 * g + j];
      bias[4 + j] = b5[pass * kCc + kCc / 2 + 4 * g + j];
    }
#pragma unroll
    for (int p = 0; p < 8; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[p][j] = fmaxf(acc[p][j] + bias[j], 0.f);
    __syncthreads();  // every read of the up window is done
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float* dst = un + (j < 4 ? 4 * g + j : kCc / 2 + 4 * g + j - 4) *
                            kC5Plane + cr * kBC + 8 * ck;
      st4(dst, acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
      st4(dst + 4, acc[4][j], acc[5][j], acc[6][j], acc[7][j]);
    }
    __syncthreads();
    // K8: the block's own c5 pixels (in the image), 16-byte stores of 4
    // channels; the positions the loop reads are not the ring's.
    if (kRes) {
      for (int e = tid; e < kCc / 4 * kOR * kOC; e += kBThreads) {
        const int px = e % (kOR * kOC), q = e / (kOR * kOC);
        const int gy = oy0 + px / kOC, gx = ox0 + px % kOC;
        if (gy >= hh || gx >= wh) continue;
        const float* src =
            un + 4 * q * kC5Plane + (px / kOC + 1) * kBC + px % kOC + 1;
        st4(c5_out + ((b * hh + gy) * wh + gx) * kCmid + pass * kCc + 4 * q,
            src[0], src[kC5Plane], src[2 * kC5Plane], src[3 * kC5Plane]);
      }
    }
    // c6's input padding: the region's positions on global row -1 or hh, or
    // column -1 or wh, take their mirrors' values (the mirrors lie in the
    // image, the positions do not).  Positions further out are never read.
    const int rt = oy0 == 0 ? 0 : -1, rb = hh - oy0 + 1;
    const int cl = ox0 == 0 ? 0 : -1, cw = wh - ox0 + 1;
    if (rt == 0 || rb < kBR || cl == 0 || cw < kBC) {
      constexpr int kEdge = 2 * (kBR + kBC);
      for (int e = tid; e < kCc * kEdge; e += kBThreads) {
        const int q = e % kEdge;
        const bool on_row = q < 2 * kBC;
        const int r = on_row ? (q < kBC ? rt : rb) : (q - 2 * kBC) % kBR;
        const int j = on_row ? q % kBC : (q < 2 * kBC + kBR ? cl : cw);
        if (r < 0 || r >= kBR || j < 0 || j >= kBC) continue;
        if (!on_row && (r == rt || r == rb)) continue;  // done as a row
        const int gyy = oy0 - 1 + r, gxx = ox0 - 1 + j;
        if (gyy > hh || gxx > wh) continue;
        float* pl = un + (e / kEdge) * kC5Plane;
        pl[r * kBC + j] = pl[(reflect_index(gyy, hh) - (oy0 - 1)) * kBC +
                             reflect_index(gxx, wh) - (ox0 - 1)];
      }
      __syncthreads();
    }
    // c6's part from this pass's channels of parity h6; the two parities
    // of a pixel meet (lanes 2 t and 2 t + 1), and the pass's sum joins
    // the earlier passes' in `out`, where each thread stores two pixels.
    if (tid >= kC6Threads) continue;
    float acc6[4][kCout];
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int co = 0; co < kCout; ++co) acc6[p][co] = 0.f;
#pragma unroll 2
    for (int m = 0; m < kCc / 2; ++m) {
      const int ci = 2 * m + h6;
      const float* wc = w6s + (pass * kCc + ci) * 4;
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        const float* r = un + ci * kC5Plane + (i6 + ky) * kBC + 4 * k6;
        const float4 a = ld4(r);
        const float2 c = ld2(r + 4);
        const float v[6] = {a.x, a.y, a.z, a.w, c.x, c.y};
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float4 wv = ld4(wc + (ky * 3 + kx) * kCmid * 4);
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            acc6[p][0] = fmaf(v[p + kx], wv.x, acc6[p][0]);
            acc6[p][1] = fmaf(v[p + kx], wv.y, acc6[p][1]);
            acc6[p][2] = fmaf(v[p + kx], wv.z, acc6[p][2]);
          }
        }
      }
    }
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int co = 0; co < kCout; ++co)
        acc6[p][co] += __shfl_xor_sync(0xffffffffu, acc6[p][co], 1);
    const int oy = oy0 + i6;
#pragma unroll
    for (int pp = 0; pp < 2; ++pp) {
      const int j = 4 * k6 + 2 * h6 + pp, ox = ox0 + j;
      if (oy >= hh || j >= kOC || ox >= wh) continue;
      float* dst = out + ((b * hh + oy) * wh + ox) * kCout;
#pragma unroll
      for (int co = 0; co < kCout; ++co) {
        const float v = h6 ? acc6[2 + pp][co] : acc6[pp][co];
        if (pass == 0)
          dst[co] = v;
        else if (pass < kPasses - 1)
          dst[co] += v;
        else
          dst[co] = fmaxf(dst[co] + v + b6[co], 0.f);
      }
    }
  }
}

template <typename Kernel>
inline cudaError_t max_carveout(Kernel kernel) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

// Both stages on `stream`: y1 is K8's residual or K5's scratch, c5 K8's
// residual (nullptr for K5).
template <bool kRes>
cudaError_t launch_decoder_tail_f32(const float* x, const float* w_up,
                                    const float* b_up, const float* w5,
                                    const float* b5, const float* w6,
                                    const float* b6, float* out, float* y1,
                                    float* c5, int batch, int hl, int wl,
                                    cudaStream_t stream) {
  cudaError_t err = max_carveout(tail_up3_f32_kernel);
  if (err == cudaSuccess) err = max_carveout(tail_c5c6_f32_kernel<kRes>);
  if (err != cudaSuccess) return err;
  const dim3 grid_a(((hl + kAR - 1) / kAR) * ((wl + kAC - 1) / kAC), batch);
  err = launch_with_smem(tail_up3_f32_kernel, grid_a, dim3(kThreads), kSmemA,
                         stream, x, w_up, b_up, y1, hl, wl);
  if (err != cudaSuccess) return err;
  const dim3 grid_b((2 * wl + kOC - 1) / kOC, (2 * hl + kOR - 1) / kOR,
                    batch);
  return launch_with_smem(tail_c5c6_f32_kernel<kRes>, grid_b, dim3(kBThreads),
                          kSmemB, stream, y1, w5, b5, w6, b6, out, c5, hl,
                          wl);
}

}  // namespace tailf32
}  // namespace mhada
