// K5: the decoder's high-resolution tail in one kernel.
//
// Replaces mhada_tpu/ops/decoder_tail_pallas.py::tail3_fused (_tail3_kernel
// and _tail3_body, pallas_call at decoder_tail_pallas.py:546):
//
//   y1  = relu(conv3x3(reflect_pad(x)) + b_up)      128 -> 64, low res
//   up  = bilinear 2x of y1 (align_corners=False, edge clamp)
//   c5  = relu(conv3x3(reflect_pad(up)) + b5)       64 -> 64, high res
//   out = relu(conv3x3(reflect_pad(c5)) + b6)       64 -> 3
//
// x is NHWC (B, H, W, 128); out is NHWC (B, 2H, 2W, 3).  A block owns a
// 16 x 16 tile of output pixels and builds, in shared memory, the windows
// it needs: x (14 x 14 low-res, 3-pixel halo), y1 (12 x 12), up (20 x 20)
// and c5 (18 x 18), all channel-planar.  The 2H x 2W x 64 c5 input (`up`)
// never reaches device memory; the only traffic is the x window read and
// the RGB write.
//
// Reflect padding belongs to each stage's own output, not only to x
// (decoder_tail_pallas.py:189-213): every window position is addressed by
// its global coordinate; `up` is evaluated at the reflected coordinate, and
// c5 positions outside the image are overwritten by copies of their
// in-image mirrors before c6 reads them.
//
// The CUDA-core kernel below is the float32 build; bfloat16 runs
// decoder_tail_mma.cuh.
//
// K8 (`mhada_decoder_tail_res`) is the same kernel writing the residuals of
// the training backward as well, as
// decoder_tail_pallas.py::tail3_fused(with_residuals=True) does
// (pallas_call at decoder_tail_pallas.py:519): y1 (B, H, W, 64) and c5
// (B, 2H, 2W, 64), NHWC, post-ReLU, each pixel written once by the block
// that owns it (no halo duplicates).  The backward is plain PyTorch
// (ops/decoder_tail.py), as the JAX package's is XLA.
//
// What bounds it on the card: about 47 GFLOP per 512^2 frame including the
// halo recompute (up3 is evaluated on 12 x 12 low-res positions for each
// 8 x 8 it owns, c5 on 18 x 18 for 16 x 16), 29.9 GFLOP without it.
// float32 runs them as FMAs on the CUDA cores (the kernel below; shared
// memory 185 KB, one block per SM), computing in float32 with no TF32;
// bfloat16 runs them on the tensor cores (decoder_tail_mma.cuh: each conv
// an implicit GEMM on mma.sync, the windows pixel-major, the weights
// streamed a tap at a time).

#include "common.cuh"
#include "decoder_tail_mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 16;                 // output tile, high-res pixels
constexpr int kCin = 128, kCmid = 64, kCout = 3;
constexpr int kXW = kTile / 2 + 6;        // 14: x window (low res)
constexpr int kYW = kTile / 2 + 4;        // 12: y1 window (low res)
constexpr int kUW = kTile + 4;            // 20: up window (high res)
constexpr int kCW = kTile + 2;            // 18: c5 window (high res)
constexpr int kXPlane = kXW * kXW + 1;    // odd stride: conflict-free fill
constexpr int kYPlane = kYW * kYW + 4;
constexpr int kUPlane = kUW * kUW;
constexpr int kCPlane = kCW * kCW;
// Region A holds x, then up; region B holds y1, then c5.
constexpr int kRegionA = (kCin * kXPlane > kCmid * kUPlane) ? kCin * kXPlane
                                                            : kCmid * kUPlane;
constexpr int kRegionB = (kCmid * kYPlane > kCmid * kCPlane) ? kCmid * kYPlane
                                                             : kCmid * kCPlane;
constexpr int kW6 = 9 * kCmid * kCout;

using mhada::reflect_index;

// 3x3 valid conv from a planar window `in` (cin planes of kInW columns) into
// the planar window `out` (kCmid planes, positions p = r * kOutW + c, p <
// kNPos), + bias, ReLU.  Thread (tx, ty) = (tid % 8, tid / 8)
// owns output channels tx + 8 j and positions ty + 32 i.
template <int kNPos, int kInW, int kOutW>
__device__ __forceinline__ void conv3x3_relu(const float* in, int in_plane,
                                             int cin,
                                             const float* __restrict__ w,
                                             const float* __restrict__ bias,
                                             float* out, int out_plane) {
  constexpr int kNP = (kNPos + 31) / 32;
  const int tx = threadIdx.x % 8, ty = threadIdx.x / 8;
  float acc[kNP][8];
  int off[kNP];
#pragma unroll
  for (int i = 0; i < kNP; ++i) {
    const int p = min(ty + 32 * i, kNPos - 1);
    off[i] = (p / kOutW) * kInW + p % kOutW;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
  for (int tap = 0; tap < 9; ++tap) {
    const int toff = (tap / 3) * kInW + tap % 3;
    const float* wt = w + (long long)tap * cin * kCmid + tx;
    const float* it = in + toff;
    for (int ci = 0; ci < cin; ++ci) {
      float wv[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) wv[j] = wt[ci * kCmid + 8 * j];
      const float* ic = it + ci * in_plane;
#pragma unroll
      for (int i = 0; i < kNP; ++i) {
        const float xv = ic[off[i]];
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(xv, wv[j], acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kNP; ++i) {
    const int p = ty + 32 * i;
    if (p >= kNPos) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int co = tx + 8 * j;
      out[co * out_plane + p] = fmaxf(acc[i][j] + bias[co], 0.f);
    }
  }
}

template <bool kRes>
__global__ void __launch_bounds__(kThreads, 1)
    decoder_tail_kernel(const float* __restrict__ x,
                        const float* __restrict__ w_up,
                        const float* __restrict__ b_up,
                        const float* __restrict__ w5,
                        const float* __restrict__ b5,
                        const float* __restrict__ w6,
                        const float* __restrict__ b6, float* __restrict__ out,
                        float* __restrict__ y1_out,
                        float* __restrict__ c5_out, int hl, int wl) {
  extern __shared__ float smem[];
  float* w6s = smem;                                     // [tap][ci][co]
  float* region_a = w6s + kW6;
  float* region_b = region_a + kRegionA;
  float* xs = region_a;   // [kCin][kXPlane]
  float* us = region_a;   // [kCmid][kUPlane]
  float* ys = region_b;   // [kCmid][kYPlane]
  float* cs = region_b;   // [kCmid][kCPlane]

  const int tid = threadIdx.x;
  const int hh = 2 * hl, wh = 2 * wl;
  const long long b = blockIdx.z;
  const int oy0 = blockIdx.y * kTile, ox0 = blockIdx.x * kTile;
  const int ly0 = oy0 / 2, lx0 = ox0 / 2;

  for (int i = tid; i < kW6; i += kThreads) w6s[i] = w6[i];

  // x window: low-res rows/cols [l0 - 3, l0 + 11), reflect-mapped (the
  // up3 conv's own input padding).  Channels are the fastest index, so
  // the global reads are coalesced.
  for (int idx = tid; idx < kXW * kXW * kCin; idx += kThreads) {
    const int ci = idx % kCin, p = idx / kCin;
    const int gy = reflect_index(ly0 - 3 + p / kXW, hl);
    const int gx = reflect_index(lx0 - 3 + p % kXW, wl);
    xs[ci * kXPlane + p] = x[((b * hl + gy) * wl + gx) * kCin + ci];
  }
  __syncthreads();

  // y1 window: low-res rows/cols [l0 - 2, l0 + 10).
  conv3x3_relu<kYW * kYW, kXW, kYW>(xs, kXPlane, kCin, w_up, b_up, ys,
                                    kYPlane);
  __syncthreads();

  // K8: the block's own 8 x 8 low-res y1 pixels, window offset 2.
  if (kRes) {
    for (int idx = tid; idx < kTile * kTile / 4 * kCmid; idx += kThreads) {
      const int co = idx % kCmid, p = idx / kCmid;
      const int r = p / (kTile / 2), c = p % (kTile / 2);
      const int gy = ly0 + r, gx = lx0 + c;
      if (gy < hl && gx < wl)
        y1_out[((b * hl + gy) * wl + gx) * kCmid + co] =
            ys[co * kYPlane + (r + 2) * kYW + c + 2];
    }
  }

  // up window: high-res rows/cols [o0 - 2, o0 + 18), each evaluated at its
  // reflected coordinate (c5's input padding).
  for (int idx = tid; idx < kCmid * kUPlane; idx += kThreads) {
    const int ci = idx / kUPlane, p = idx % kUPlane;
    const int yr = reflect_index(oy0 - 2 + p / kUW, hh);
    const int xr = reflect_index(ox0 - 2 + p % kUW, wh);
    // align_corners=False at scale 2: even rows blend (i - 1, i) as
    // (0.25, 0.75), odd rows (i, i + 1) as (0.75, 0.25), clamped.
    const int iy = yr >> 1, ix = xr >> 1;
    const int ya = (yr & 1) ? iy : max(iy - 1, 0);
    const int yb = (yr & 1) ? min(iy + 1, hl - 1) : iy;
    const int xa = (xr & 1) ? ix : max(ix - 1, 0);
    const int xb = (xr & 1) ? min(ix + 1, wl - 1) : ix;
    const float wya = (yr & 1) ? 0.75f : 0.25f, wyb = 1.f - wya;
    const float wxa = (xr & 1) ? 0.75f : 0.25f, wxb = 1.f - wxa;
    const int ra = min(max(ya - (ly0 - 2), 0), kYW - 1);
    const int rb = min(max(yb - (ly0 - 2), 0), kYW - 1);
    const int ca = min(max(xa - (lx0 - 2), 0), kYW - 1);
    const int cb = min(max(xb - (lx0 - 2), 0), kYW - 1);
    const float* yp = ys + ci * kYPlane;
    const float top = wxa * yp[ra * kYW + ca] + wxb * yp[ra * kYW + cb];
    const float bot = wxa * yp[rb * kYW + ca] + wxb * yp[rb * kYW + cb];
    us[ci * kUPlane + p] = wya * top + wyb * bot;
  }
  __syncthreads();

  // c5 window: high-res rows/cols [o0 - 1, o0 + 17).
  conv3x3_relu<kCW * kCW, kUW, kCW>(us, kUPlane, kCmid, w5, b5, cs, kCPlane);
  __syncthreads();

  // c6's input padding: c5 positions outside the image take the value of
  // their in-image mirror (sources are in-image, destinations are not).
  for (int idx = tid; idx < kCmid * kCPlane; idx += kThreads) {
    const int ci = idx / kCPlane, p = idx % kCPlane;
    const int gy = oy0 - 1 + p / kCW, gx = ox0 - 1 + p % kCW;
    if (gy >= 0 && gy < hh && gx >= 0 && gx < wh) continue;
    const int sy = min(max(reflect_index(gy, hh) - (oy0 - 1), 0), kCW - 1);
    const int sx = min(max(reflect_index(gx, wh) - (ox0 - 1), 0), kCW - 1);
    cs[ci * kCPlane + p] = cs[ci * kCPlane + sy * kCW + sx];
  }
  __syncthreads();

  // K8: the block's own 16 x 16 c5 pixels, window offset 1.
  if (kRes) {
    for (int idx = tid; idx < kTile * kTile * kCmid; idx += kThreads) {
      const int co = idx % kCmid, p = idx / kCmid;
      const int gy = oy0 + p / kTile, gx = ox0 + p % kTile;
      if (gy < hh && gx < wh)
        c5_out[((b * hh + gy) * wh + gx) * kCmid + co] =
            cs[co * kCPlane + (p / kTile + 1) * kCW + p % kTile + 1];
    }
  }

  // c6: one output pixel per thread, three channels.
  const int r = tid / kTile, c = tid % kTile;
  const int gy = oy0 + r, gx = ox0 + c;
  float acc[kCout] = {0.f, 0.f, 0.f};
  for (int tap = 0; tap < 9; ++tap) {
    const float* cp = cs + (r + tap / 3) * kCW + c + tap % 3;
    const float* wt = w6s + tap * kCmid * kCout;
    for (int ci = 0; ci < kCmid; ++ci) {
      const float v = cp[ci * kCPlane];
#pragma unroll
      for (int co = 0; co < kCout; ++co)
        acc[co] = fmaf(v, wt[ci * kCout + co], acc[co]);
    }
  }
  if (gy < hh && gx < wh) {
    float* op = out + ((b * hh + gy) * wh + gx) * kCout;
#pragma unroll
    for (int co = 0; co < kCout; ++co) op[co] = fmaxf(acc[co] + b6[co], 0.f);
  }
}

template <bool kRes>
cudaError_t decoder_tail(const void* x, const void* w_up, const float* b_up,
                         const void* w5, const float* b5, const void* w6,
                         const float* b6, void* out, void* y1, void* c5,
                         int batch, int hl, int wl, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)kW6 + kRegionA + kRegionB);
  const dim3 grid((2 * wl + kTile - 1) / kTile, (2 * hl + kTile - 1) / kTile,
                  batch);
  return mhada::launch_with_smem(
      decoder_tail_kernel<kRes>, grid, dim3(kThreads), smem, stream,
      static_cast<const float*>(x), static_cast<const float*>(w_up), b_up,
      static_cast<const float*>(w5), b5, static_cast<const float*>(w6), b6,
      static_cast<float*>(out), static_cast<float*>(y1),
      static_cast<float*>(c5), hl, wl);
}

template <bool kRes>
int decoder_tail_entry(const void* x, const void* w_up, const void* b_up,
                       const void* w5, const void* b5, const void* w6,
                       const void* b6, void* out, void* y1, void* c5,
                       int batch, int hl, int wl, int dtype,
                       cudaStream_t stream) {
  const auto* fb_up = static_cast<const float*>(b_up);
  const auto* fb5 = static_cast<const float*>(b5);
  const auto* fb6 = static_cast<const float*>(b6);
  if (dtype == mhada::kF32)
    return (int)decoder_tail<kRes>(x, w_up, fb_up, w5, fb5, w6, fb6, out,
                                   y1, c5, batch, hl, wl, stream);
  if (dtype != mhada::kBF16 ||
      !mhada::mma_aligned({x, w_up, w5, y1, c5}, kCmid))
    return (int)cudaErrorInvalidValue;
  using bf16 = __nv_bfloat16;
  mhada::tail::TailArgs a{};
  a.x = static_cast<const bf16*>(x);
  a.w_up = static_cast<const bf16*>(w_up);
  a.b_up = fb_up;
  a.w5 = static_cast<const bf16*>(w5);
  a.b5 = fb5;
  a.w6 = static_cast<const bf16*>(w6);
  a.b6 = fb6;
  a.out = static_cast<bf16*>(out);
  a.y1 = static_cast<bf16*>(y1);
  a.c5 = static_cast<bf16*>(c5);
  a.hl = hl;
  a.wl = wl;
  return (int)mhada::tail::launch_decoder_tail_mma<kRes>(a, batch, stream);
}

}  // namespace

// x (B, H, W, 128) NHWC in T (float32 or bfloat16); weights HWIO in T:
// w_up (3, 3, 128, 64), w5 (3, 3, 64, 64), w6 (3, 3, 64, 3); biases
// float32; out (B, 2H, 2W, 3).  bfloat16: x, w_up and w5 16-byte aligned.
extern "C" int mhada_decoder_tail(const void* x, const void* w_up,
                                  const void* b_up, const void* w5,
                                  const void* b5, const void* w6,
                                  const void* b6, void* out, int batch,
                                  int hl, int wl, int dtype, void* stream) {
  return decoder_tail_entry<false>(x, w_up, b_up, w5, b5, w6, b6, out,
                                   nullptr, nullptr, batch, hl, wl, dtype,
                                   (cudaStream_t)stream);
}

// K8: as mhada_decoder_tail, plus the residuals y1 (B, H, W, 64) and c5
// (B, 2H, 2W, 64) in T (bfloat16: 16-byte aligned).
extern "C" int mhada_decoder_tail_res(const void* x, const void* w_up,
                                      const void* b_up, const void* w5,
                                      const void* b5, const void* w6,
                                      const void* b6, void* out, void* y1,
                                      void* c5, int batch, int hl, int wl,
                                      int dtype, void* stream) {
  return decoder_tail_entry<true>(x, w_up, b_up, w5, b5, w6, b6, out, y1,
                                  c5, batch, hl, wl, dtype,
                                  (cudaStream_t)stream);
}
