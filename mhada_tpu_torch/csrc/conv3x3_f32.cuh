// The register-tiled step of the float32 3x3 direct convolutions on the
// CUDA cores (the decoder tail's up3 and c5, decoder_tail_f32.cuh; K14's
// mid stages, decoder_mid_f32.cuh): a thread owns a run of 8 consecutive
// pixels of one row and 8 output channels (two groups of 4, so a
// quarter-warp's 16-byte weight loads cover 128 contiguous bytes).  For
// each input channel and kernel row it loads the run and its 2-pixel
// overlap once (two LDS.128 and one LDS.64; lanes that share a run load
// one address, a broadcast) and applies the three kernel columns from
// registers: 192 FFMA for 9 shared loads.
#pragma once

namespace mhada {
namespace conv3f32 {

constexpr int kCk = 8;  // input channels a step

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ void st4(float* p, float a, float b, float c,
                                    float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// acc[p][j] += sum over the step's kCk input channels and the 9 taps of
// win[ci][ky][p + kx] * w[ky * 3 + kx][ci][co_j]: a run of 8 pixels (from
// `win` on, a window row of kRowS floats, planes of kPlane) and 8 output
// channels (4 from `w` on and 4 from w + kHalf on; taps kTapS apart,
// input channels kCiS).
template <int kPlane, int kRowS, int kTapS, int kCiS, int kHalf>
__device__ __forceinline__ void conv_step(const float* win, const float* w,
                                          float (&acc)[8][8]) {
#pragma unroll 2
  for (int ci = 0; ci < kCk; ++ci) {
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
      const float* r = win + ci * kPlane + ky * kRowS;
      const float4 a = ld4(r), b = ld4(r + 4);
      const float2 c = ld2(r + 8);
      const float v[10] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, c.y};
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const float* wt = w + (ky * 3 + kx) * kTapS + ci * kCiS;
        const float4 w0 = ld4(wt), w1 = ld4(wt + kHalf);
        const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int p = 0; p < 8; ++p)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[p][j] = fmaf(v[p + kx], wv[j], acc[p][j]);
      }
    }
  }
}

}  // namespace conv3f32
}  // namespace mhada
