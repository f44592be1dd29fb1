// K14: one reflect-padded 3x3 ConvReLU of the decoder's mid stages
// (c1 -> c2 -> c3, 256 -> 256 channels at a quarter of the frame's side),
// launched once per stage.
//
// Replaces mhada_tpu/ops/decoder_mid_pallas.py::mid3_fused (_mid3_kernel,
// pallas_call at decoder_mid_pallas.py:169).  Per stage, at the TPU
// kernel's rounding points:
//
//   y = relu(round_T(round_T(conv3x3(reflect_pad(x))) + round_T(b)))
//
// summed in float32 over inputs and weights in T.  Each stage pads its own
// input, i.e. the previous stage's output, so three launches give the
// chain exactly; the TPU kernel, which fused the three stages over one
// HBM read, had to repair the boundary rows and columns of its
// intermediates in-kernel (_row_fix / _col_fix, :56-70).
//
// x and y are NHWC (B, H, W, C); w is HWIO (3, 3, C, C) in T; b float32.
//
// What bounds it on the card: operations.  2 x 9 x C^2 flops a pixel per
// stage: 19.33 GFLOP per stage at 128^2 (a 512^2 frame), 0.289 ms at the
// float32 rate (67 TFLOP/s) and 0.020 ms at the bf16 tensor-core rate,
// against 2 x 16.8 MB of activations at float32.
//
// bfloat16 runs on the tensor cores (decoder_mid_mma.cuh, an implicit
// GEMM on mma.sync); float32 on the CUDA cores (decoder_mid_f32.cuh, the
// decoder tail's register-tiled direct conv with a cp.async ring, the
// output channels split over the grid).  Fusing the three stages again
// would save only the intermediates' trips through memory, 4 x 16.8 MB a
// call at float32 (0.020 ms at 3.35 TB/s), and two launch gaps, while
// recomputing each stage's halo.  On an H100 the three float32 launches
// take 1.333 ms at 128^2, 0.444 a stage against its 0.289 ms bound
// (chip_smoke.py's K14 gate, the kernel alone): the time is inside the
// stage, so fusing is not worth a PR before a stage nears its bound.

#include "common.cuh"
#include "decoder_mid_f32.cuh"
#include "decoder_mid_mma.cuh"

// One stage: x, y (B, H, W, C) NHWC in T; w HWIO (3, 3, C, C) in T; b (C,)
// float32.  float32: C % 64 == 0; bfloat16: C % 128 == 0.  x, w and y
// 16-byte aligned; H, W >= 2.
extern "C" int mhada_decoder_mid_conv(const void* x, const void* w,
                                      const void* b, void* y, int batch,
                                      int h, int wd, int c, int dtype,
                                      void* stream) {
  if (!mhada::mma_aligned({x, w, y}, c)) return (int)cudaErrorInvalidValue;
  if (dtype == mhada::kF32) {
    if (c % mhada::midf32::kCo != 0) return (int)cudaErrorInvalidValue;
    return (int)mhada::midf32::launch_decoder_mid_f32(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(b), static_cast<float*>(y), batch, h, wd, c,
        (cudaStream_t)stream);
  }
  if (dtype != mhada::kBF16 || c % mhada::mid::kCo != 0)
    return (int)cudaErrorInvalidValue;
  using bf16 = __nv_bfloat16;
  return (int)mhada::mid::launch_decoder_mid_mma(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const float*>(b), static_cast<bf16*>(y), batch, h, wd, c,
      (cudaStream_t)stream);
}
