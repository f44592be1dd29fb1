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
// its taps stacked: a re-layout for 128-lane tiles that these kernels do
// not need.  Its 524-pixel width cap (a fixed VMEM row buffer) does not
// exist here.
//
// What bounds it on the card: bytes.  Each c5 element is read once and each
// output written once: (64 + 3) x H x W x sizeof(T) per image, 70.3 MB at
// 512^2 in float32 (35.2 MB bf16), against 2 x 9 x 64 x 3 = 3456 flops a
// pixel (0.906 GFLOP).
//
// float32 runs on the CUDA cores (decoder_c6_f32.cuh: a register-tiled
// direct conv, each lane one channel quad of a run of 8 pixels at two
// rows, its weights in registers, the quads summed by shuffles); bfloat16
// on the tensor cores (decoder_c6_mma.cuh: an implicit GEMM on mma.sync,
// N padded from 3 to 8).  Both walk strips of 16 rows x 64 columns down
// the image, 2 rows a step, the rows of the next two steps landing by TMA
// bulk copies while the current ones compute (c6_ring.cuh).

#include "common.cuh"
#include "decoder_c6_f32.cuh"
#include "decoder_c6_mma.cuh"

// c5 (B, H, W, 64) NHWC in T, 16-byte aligned; w6 HWIO (3, 3, 64, 3) in T;
// b6 (3,) float32; out (B, H, W, 3) in T.  H, W >= 2.
extern "C" int mhada_decoder_c6(const void* c5, const void* w6,
                                const void* b6, void* out, int batch, int h,
                                int w, int dtype, void* stream) {
  if (!mhada::mma_aligned({c5}, 64) || h < 2 || w < 2)
    return (int)cudaErrorInvalidValue;
  if (dtype == mhada::kF32)
    return (int)mhada::c6f32::launch_decoder_c6_f32(
        static_cast<const float*>(c5), static_cast<const float*>(w6),
        static_cast<const float*>(b6), static_cast<float*>(out), batch, h, w,
        (cudaStream_t)stream);
  if (dtype != mhada::kBF16) return (int)cudaErrorInvalidValue;
  using bf16 = __nv_bfloat16;
  return (int)mhada::c6mma::launch_decoder_c6_mma(
      static_cast<const bf16*>(c5), static_cast<const bf16*>(w6),
      static_cast<const float*>(b6), static_cast<bf16*>(out), batch, h, w,
      (cudaStream_t)stream);
}
