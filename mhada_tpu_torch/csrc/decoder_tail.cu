// K5: the decoder's high-resolution tail.
//
// Replaces mhada_tpu/ops/decoder_tail_pallas.py::tail3_fused (_tail3_kernel
// and _tail3_body, pallas_call at decoder_tail_pallas.py:546):
//
//   y1  = relu(conv3x3(reflect_pad(x)) + b_up)      128 -> 64, low res
//   up  = bilinear 2x of y1 (align_corners=False, edge clamp)
//   c5  = relu(conv3x3(reflect_pad(up)) + b5)       64 -> 64, high res
//   out = relu(conv3x3(reflect_pad(c5)) + b6)       64 -> 3
//
// x is NHWC (B, H, W, 128); out is NHWC (B, 2H, 2W, 3).  Reflect padding
// belongs to each stage's own output, not only to x
// (decoder_tail_pallas.py:189-213).
//
// K8 (`mhada_decoder_tail_res`) is the same function writing the residuals
// of the training backward as well, as
// decoder_tail_pallas.py::tail3_fused(with_residuals=True) does
// (pallas_call at decoder_tail_pallas.py:519): y1 (B, H, W, 64) and c5
// (B, 2H, 2W, 64), NHWC, post-ReLU.  The backward is plain PyTorch
// (ops/decoder_tail.py), as the JAX package's is XLA.
//
// What bounds it on the card: operations, 29.9 GFLOP per 512^2 frame.
// float32 runs on the CUDA cores (decoder_tail_f32.cuh: up3 over the whole
// image into y1, then the upsample, c5 and c6 in one kernel that recomputes
// only c5's 1-pixel ring; two launches, one entry call); bfloat16 splits
// the same way on the tensor cores (decoder_tail_wgmma.cuh: each conv an
// implicit GEMM on wgmma with A from registers, the weights resident in
// shared memory by TMA; two launches, one entry call).

#include "common.cuh"
#include "decoder_tail_f32.cuh"
#include "decoder_tail_wgmma.cuh"

namespace {

constexpr int kCmid = 64;

template <bool kRes>
int decoder_tail_entry(const void* x, const void* w_up, const void* b_up,
                       const void* w5, const void* b5, const void* w6,
                       const void* b6, void* out, void* y1, void* c5,
                       int batch, int hl, int wl, int dtype,
                       cudaStream_t stream) {
  const auto* fb_up = static_cast<const float*>(b_up);
  const auto* fb5 = static_cast<const float*>(b5);
  const auto* fb6 = static_cast<const float*>(b6);
  if (dtype == mhada::kF32) {
    if (y1 == nullptr || (kRes && c5 == nullptr) ||
        !mhada::mma_aligned({x, w_up, w5, w6, out, y1, c5}, kCmid))
      return (int)cudaErrorInvalidValue;
    return (int)mhada::tailf32::launch_decoder_tail_f32<kRes>(
        static_cast<const float*>(x), static_cast<const float*>(w_up), fb_up,
        static_cast<const float*>(w5), fb5, static_cast<const float*>(w6),
        fb6, static_cast<float*>(out), static_cast<float*>(y1),
        static_cast<float*>(c5), batch, hl, wl, stream);
  }
  if (dtype != mhada::kBF16 ||
      !mhada::mma_aligned({x, w_up, w5, y1, c5}, kCmid))
    return (int)cudaErrorInvalidValue;
  using bf16 = __nv_bfloat16;
  mhada::tailwg::TailArgs a{};
  a.x = static_cast<const bf16*>(x);
  a.b_up = fb_up;
  a.b5 = fb5;
  a.w6 = static_cast<const bf16*>(w6);
  a.b6 = fb6;
  a.out = static_cast<bf16*>(out);
  a.y1 = static_cast<bf16*>(y1);
  a.c5 = static_cast<bf16*>(c5);
  a.batch = batch;
  a.hl = hl;
  a.wl = wl;
  return (int)mhada::tailwg::launch_decoder_tail_wgmma<kRes>(
      static_cast<const bf16*>(w_up), static_cast<const bf16*>(w5), a,
      stream);
}

}  // namespace

// x (B, H, W, 128) NHWC in T (float32 or bfloat16); weights HWIO in T:
// w_up (3, 3, 128, 64), w5 (3, 3, 64, 64), w6 (3, 3, 64, 3); biases
// float32; out (B, 2H, 2W, 3); y1 a (B, H, W, 64) scratch in T for y1
// between the two kernels.  float32: x, the weights, out and y1 are 16-byte
// aligned; bfloat16: x, w_up, w5 and y1 are.
extern "C" int mhada_decoder_tail(const void* x, const void* w_up,
                                  const void* b_up, const void* w5,
                                  const void* b5, const void* w6,
                                  const void* b6, void* out, void* y1,
                                  int batch, int hl, int wl, int dtype,
                                  void* stream) {
  return decoder_tail_entry<false>(
      x, w_up, b_up, w5, b5, w6, b6, out, y1, nullptr, batch, hl, wl, dtype,
      (cudaStream_t)stream);
}

// K8: as mhada_decoder_tail, plus the residuals y1 (B, H, W, 64) and c5
// (B, 2H, 2W, 64) in T (16-byte aligned).
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
