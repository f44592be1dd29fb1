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
//
// K1's cross form (mhada_attention_cross_fwd): N queries against M keys and
// values of another tensor, the counterpart of the head-major
// _attention_pallas_call (pallas_call at attention_pallas.py:62) and of the
// forward of _attn_stream_fwd_impl (:488), which the JAX ViT attention
// reaches under sequence parallelism: each rank's local queries against the
// keys and values gathered over the ranks.  Q is read from rows of q_stride
// elements (this rank's packed qkv: its first C columns), K and V from one
// (B, M, 2C) tensor side by side in rows of kv_stride elements.  The same
// two kernels run it: self-attention is the case q = qkv, k = qkv + C,
// v = qkv + 2C, both strides 3C and N = M (at bf16 its own instantiation,
// attention_mma_fwd_kernel<false, false>, whose offsets follow from C).  Keys past M are masked in the
// ragged last tile and query rows past N are not stored; the key loop has
// no length cap, so M > 4096 streams through it as the TPU's streaming
// forward does.  Bound: 4 N M d flops per head against (N + 2M + N) C
// element reads and writes: compute-bound at the path's shapes.

#include "attention_mma.cuh"
#include "mhada_f32_tile.cuh"

namespace {

cudaError_t attention_fwd_f32(const void* qkv, void* out, int batch,
                              int seq, int channels, int heads, float scale,
                              cudaStream_t stream) {
  return mhada::f32t::launch_attention_f32<false>(
      mhada::f32t::self_attention_args(qkv, out, seq, channels, scale),
      heads, batch, stream);
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

// q: rows of q_stride elements, the queries in the first `channels`; kv:
// rows of kv_stride elements, K in the first `channels` and V in the next;
// out (B, n_q, C).  Pointers 16-byte aligned, strides and channels
// multiples of 4 (float32) or 8 (bfloat16).
extern "C" int mhada_attention_cross_fwd(const void* q, const void* kv,
                                         void* out, int batch, int n_q,
                                         int n_kv, int channels, int q_stride,
                                         int kv_stride, int heads,
                                         float scale, int dtype,
                                         void* stream) {
  if (dtype == mhada::kF32) {
    mhada::f32t::AttnArgs a{};
    a.q = static_cast<const float*>(q);
    a.k = static_cast<const float*>(kv);
    a.v = a.k + channels;
    a.out = static_cast<float*>(out);
    a.n = n_q;
    a.m = n_kv;
    a.channels = channels;
    a.q_rs = q_stride;
    a.kv_rs = kv_stride;
    a.scale = scale;
    return (int)mhada::f32t::launch_attention_f32<false>(
        a, heads, batch, (cudaStream_t)stream);
  }
  mhada::AttnMmaArgs a{};
  if (dtype != mhada::kBF16 ||
      !mhada::make_mma_cross_args(a, q, kv, out, n_q, n_kv, channels,
                                  q_stride, kv_stride, scale))
    return (int)cudaErrorInvalidValue;
  return (int)mhada::launch_attention_mma_fwd<false, true>(
      a, heads, batch, (cudaStream_t)stream);
}

extern "C" const char* mhada_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
