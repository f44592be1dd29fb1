// K13: the decoder's last conv, c6, as its own kernel.
//
// Replaces mhada_tpu/ops/decoder_tail_pallas.py::c6_transposed (_c6_kernel,
// pallas_call at decoder_tail_pallas.py:146), which Decoder(packed=
// "col_tail") runs after plain up3 and c5 convs:
//
//   out = relu(conv3x3(reflect_pad(c5)) + b6)      64 -> 3
//
// accumulated in float32, the float32 bias added to the float32 sum, then
// rounded to T (decoder_tail_pallas.py:175-182).  c5 is the plain NHWC
// (B, H, W, 64) output of the c5 ConvReLU; out is NHWC (B, H, W, 3).  The
// TPU kernel's input is c5 column-packed, reflect-padded, transposed and
// its taps stacked: a re-layout for 128-lane tiles that this kernel does
// not need.  Its 524-pixel width cap (a fixed VMEM row buffer) does not
// exist here.
//
// What bounds it on the card: bytes.  Each c5 element is read once and each
// output written once: (64 + 3) x H x W x sizeof(T) per image, 70.3 MB at
// 512^2 in float32 (35.2 MB bf16), against 2 x 9 x 64 x 3 = 3456 flops a
// pixel (0.906 GFLOP): 27 flops per 4-byte element, far under the card's
// ratio.
//
// Design: a block owns a 16 x 16 tile of output pixels.  It stages the
// tile's 18 x 18 c5 window with its 1-pixel halo in shared memory, 16 bytes
// a thread per load along C, reflecting coordinates at the image edges in
// the index arithmetic (c6 pads c5's output, so the mirror of a c5 pixel
// is read where the pad is), and the 9 x 64 x 3 weights once, as float32.
// Each thread then computes one pixel's 3 outputs from 16-byte shared loads.
// The window rows are padded by 16 bytes, so the 8 threads of each 16-byte
// load phase hit distinct bank groups.  The halo is re-read by the
// neighbouring blocks, mostly from L2.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 16;            // output tile, pixels per side
constexpr int kWin = kTile + 2;      // 18: window with the halo
constexpr int kC = 64, kCout = 3;
constexpr int kW6 = 9 * kC * kCout;  // [tap][ci][co]

using mhada::reflect_index;

// 16 bytes of T at p (16-byte aligned) as float32 values.
__device__ __forceinline__ void load16(const float* p, float* v) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* v) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    decoder_c6_kernel(const T* __restrict__ c5, const T* __restrict__ w6,
                      const float* __restrict__ b6, T* __restrict__ out,
                      int h, int w) {
  constexpr int kVec = 16 / sizeof(T);        // elements per 16 bytes
  constexpr int kChunks = kC / kVec;          // 16-byte chunks per pixel
  constexpr int kStride = kC + kVec;          // padded pixel stride
  extern __shared__ float smem[];
  float* ws = smem;                                    // [tap][ci][co]
  T* win = reinterpret_cast<T*>(smem + kW6);           // [pos][kStride]

  const int tid = threadIdx.x;
  const long long b = blockIdx.z;
  const int oy0 = blockIdx.y * kTile, ox0 = blockIdx.x * kTile;

  for (int i = tid; i < kW6; i += kThreads) ws[i] = mhada::to_f32(w6[i]);
  for (int idx = tid; idx < kWin * kWin * kChunks; idx += kThreads) {
    const int chunk = idx % kChunks, p = idx / kChunks;
    const int gy = reflect_index(oy0 - 1 + p / kWin, h);
    const int gx = reflect_index(ox0 - 1 + p % kWin, w);
    *reinterpret_cast<uint4*>(win + p * kStride + chunk * kVec) =
        *reinterpret_cast<const uint4*>(c5 + ((b * h + gy) * w + gx) * kC +
                                        chunk * kVec);
  }
  __syncthreads();

  const int r = tid / kTile, c = tid % kTile;
  const int gy = oy0 + r, gx = ox0 + c;
  float acc[kCout] = {0.f, 0.f, 0.f};
#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const T* px = win + ((r + tap / 3) * kWin + c + tap % 3) * kStride;
    const float* wt = ws + tap * kC * kCout;
#pragma unroll 2
    for (int c0 = 0; c0 < kC; c0 += kVec) {
      float v[kVec];
      load16(px + c0, v);
#pragma unroll
      for (int i = 0; i < kVec; ++i)
#pragma unroll
        for (int co = 0; co < kCout; ++co)
          acc[co] = fmaf(v[i], wt[(c0 + i) * kCout + co], acc[co]);
    }
  }
  if (gy < h && gx < w) {
    T* op = out + ((b * h + gy) * w + gx) * kCout;
#pragma unroll
    for (int co = 0; co < kCout; ++co)
      op[co] = mhada::from_f32<T>(fmaxf(acc[co] + b6[co], 0.f));
  }
}

template <typename T>
cudaError_t decoder_c6(const void* c5, const void* w6, const float* b6,
                       void* out, int batch, int h, int w,
                       cudaStream_t stream) {
  const size_t smem = sizeof(float) * kW6 +
                      sizeof(T) * kWin * kWin * (kC + 16 / sizeof(T));
  const dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile, batch);
  return mhada::launch_with_smem(decoder_c6_kernel<T>, grid, dim3(kThreads),
                                 smem, stream, static_cast<const T*>(c5),
                                 static_cast<const T*>(w6), b6,
                                 static_cast<T*>(out), h, w);
}

}  // namespace

// c5 (B, H, W, 64) NHWC in T, 16-byte aligned; w6 HWIO (3, 3, 64, 3) in T;
// b6 (3,) float32; out (B, H, W, 3) in T.  H, W >= 2.
extern "C" int mhada_decoder_c6(const void* c5, const void* w6,
                                const void* b6, void* out, int batch, int h,
                                int w, int dtype, void* stream) {
  MHADA_DISPATCH_DTYPE(
      dtype, T,
      return (int)decoder_c6<T>(c5, w6, static_cast<const float*>(b6), out,
                                batch, h, w, (cudaStream_t)stream));
}
