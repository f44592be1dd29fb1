// K1: ViT multi-head self-attention forward from the packed qkv.
//
// Replaces mhada_tpu/ops/attention_pallas.py::attention_pallas_tm
// (_tm_kernel, pallas_call at attention_pallas.py:154).  Per head h:
// out[:, h*64:(h+1)*64] = softmax(Q_h K_h^T / sqrt(64)) V_h, with Q_h, K_h
// and V_h read in place from the (B, L, 3C) qkv at channel offsets h*64,
// C + h*64 and 2C + h*64 (torch MultiheadAttention packing), and the output
// written token-major (B, L, C).
//
// What bounds it on the card: 4 L^2 d flops per head (34 GFLOP per call at
// L = 4096, 8 heads) against 2 L (3C + C) element reads, so it is
// compute-bound.  bfloat16 runs on the tensor cores (attention_mma.cuh:
// mma.sync with bf16 operands, float32 accumulators, a cp.async K/V ring);
// float32 keeps computing in float32, as FMAs on the CUDA cores, with no
// TF32: the attention variant of the register-tiled, cp.async-pipelined
// f32 tile (mhada_f32_tile.cuh, attention_f32_kernel<false>: 256 queries a
// block, the scale folded into Q^T).  The scores never leave shared memory
// and registers.

#include "attention_mma.cuh"
#include "mhada_f32_tile.cuh"

namespace {

cudaError_t attention_fwd_f32(const void* qkv, void* out, int batch,
                              int seq, int channels, int heads, float scale,
                              cudaStream_t stream) {
  mhada::f32t::AttnArgs a{};
  a.qkv = static_cast<const float*>(qkv);
  a.out = static_cast<float*>(out);
  a.n = seq;
  a.channels = channels;
  a.scale = scale;
  return mhada::f32t::launch_attention_f32<false>(a, heads, batch, stream);
}

}  // namespace

// qkv and out 16-byte aligned; channels a multiple of 4 (float32) or 8
// (bfloat16).
extern "C" int mhada_attention_fwd(const void* qkv, void* out, int batch,
                                   int seq, int channels, int heads,
                                   float scale, int dtype, void* stream) {
  if (dtype == mhada::kF32)
    return (int)attention_fwd_f32(qkv, out, batch, seq, channels, heads,
                                  scale, (cudaStream_t)stream);
  mhada::AttnMmaArgs a{};
  if (dtype != mhada::kBF16 ||
      !mhada::make_mma_args(a, qkv, qkv, out, seq, channels, scale))
    return (int)cudaErrorInvalidValue;
  return (int)mhada::launch_attention_mma_fwd<false>(a, heads, batch,
                                                     (cudaStream_t)stream);
}

extern "C" const char* mhada_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
