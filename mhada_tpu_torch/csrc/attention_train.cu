// K6: differentiable ViT self-attention on the packed qkv, forward and
// backward.
//
// Replaces mhada_tpu/ops/attention_pallas.py::attention_tm_train: the
// forward _attn_tm_fwd_impl (_tm_res_kernel, pallas_call at
// attention_pallas.py:236) and the backward _attn_tm_bwd_impl
// (_tm_bwd_kernel, pallas_call at attention_pallas.py:351).
//
// Forward: K1's tile that also writes the row log-sum-exp, (B, heads, L)
// float32; the TPU kernel broadcast it over 64 lanes for its tiles, which
// Hopper does not need.  Backward: two kernels (dK and dV per key tile, dQ
// per query tile), reading Q, K and V in place from the (B, L, 3C)
// qkv and writing dQ, dK and dV straight into the packed (B, L, 3C)
// gradient at channel offsets h*64, C + h*64 and 2C + h*64, so no
// head-split copy exists in either direction.  The row term
// delta = rowsum(dO * O) per head comes from the wrapper
// (attention_pallas.py:322-327).
//
// What bounds it on the card: the forward does 4 L^2 d flops per head, the
// backward 14 L^2 d (S and dP in both kernels, P^T dO, dS^T Q, dS K; 10 L^2
// d without the recompute), i.e. 17 and 60 GFLOP per call at the training
// shape (B = 8, L = 1024, 8 heads) against 2 L (3C + C) element reads:
// compute-bound.  bfloat16 runs on the tensor cores (attention_mma.cuh,
// attention_bwd_mma.cuh: mma.sync with bf16 operands and float32
// accumulators); float32 keeps computing in float32, as FMAs on the CUDA
// cores (flash_tile.cuh, flash_bwd.cuh).

#include "attention_bwd_mma.cuh"
#include "flash_bwd.cuh"

namespace {

cudaError_t attention_train_fwd_f32(const void* qkv, void* out, float* lse,
                                    int batch, int seq, int channels,
                                    int heads, float scale,
                                    cudaStream_t stream) {
  const float* base = static_cast<const float*>(qkv);
  mhada::FlashArgs a{};
  a.q = base;
  a.k = base + channels;
  a.v = base + 2 * channels;
  a.f = nullptr;
  a.out = out;
  a.n = seq;
  a.m = seq;
  a.q_bs = a.kv_bs = (long long)seq * 3 * channels;
  a.q_rs = a.kv_rs = 3LL * channels;
  a.o_bs = (long long)seq * channels;
  a.o_rs = channels;
  a.scale = scale;
  a.lse = lse;
  return mhada::launch_flash_tile<float, false, true>(a, heads, batch,
                                                      stream);
}

cudaError_t attention_train_bwd_f32(const void* qkv, const void* g,
                                    const float* lse, const float* delta,
                                    void* dqkv, int batch, int seq,
                                    int channels, int heads, float scale,
                                    cudaStream_t stream) {
  const float* base = static_cast<const float*>(qkv);
  float* dbase = static_cast<float*>(dqkv);
  mhada::FlashBwdArgs a{};
  a.q = base;
  a.k = base + channels;
  a.v = base + 2 * channels;
  a.g1 = g;
  a.g2 = nullptr;
  a.lse = lse;
  a.delta = delta;
  a.dq = dbase;
  a.dk = dbase + channels;
  a.dv = dbase + 2 * channels;
  a.n = seq;
  a.m = seq;
  a.q_bs = a.kv_bs = a.dq_bs = a.dkv_bs = (long long)seq * 3 * channels;
  a.q_rs = a.kv_rs = a.dq_rs = a.dkv_rs = 3LL * channels;
  a.g_bs = (long long)seq * channels;
  a.g_rs = channels;
  a.scale = scale;
  return mhada::launch_flash_bwd<float, false>(a, heads, batch, stream);
}

}  // namespace

// qkv (B, L, 3C) in T; out (B, L, C) in T; lse (B, heads, L) float32.
extern "C" int mhada_attention_train_fwd(const void* qkv, void* out,
                                         void* lse, int batch, int seq,
                                         int channels, int heads, float scale,
                                         int dtype, void* stream) {
  if (dtype == mhada::kF32)
    return (int)attention_train_fwd_f32(qkv, out, static_cast<float*>(lse),
                                        batch, seq, channels, heads, scale,
                                        (cudaStream_t)stream);
  mhada::AttnMmaArgs a{};
  if (dtype != mhada::kBF16 ||
      !mhada::make_mma_args(a, qkv, qkv, out, seq, channels, scale))
    return (int)cudaErrorInvalidValue;
  a.lse = static_cast<float*>(lse);
  return (int)mhada::launch_attention_mma_fwd<true>(a, heads, batch,
                                                    (cudaStream_t)stream);
}

// g = dO (B, L, C) in T; lse, delta (B, heads, L) float32; dqkv (B, L, 3C)
// in T, every element written.
extern "C" int mhada_attention_train_bwd(const void* qkv, const void* g,
                                         const void* lse, const void* delta,
                                         void* dqkv, int batch, int seq,
                                         int channels, int heads, float scale,
                                         int dtype, void* stream) {
  if (dtype == mhada::kF32)
    return (int)attention_train_bwd_f32(
        qkv, g, static_cast<const float*>(lse),
        static_cast<const float*>(delta), dqkv, batch, seq, channels, heads,
        scale, (cudaStream_t)stream);
  mhada::AttnMmaArgs a{};
  if (dtype != mhada::kBF16 ||
      !mhada::make_mma_args(a, qkv, g, dqkv, seq, channels, scale))
    return (int)cudaErrorInvalidValue;
  a.lse_in = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  return (int)mhada::launch_attention_mma_bwd(a, heads, batch,
                                              (cudaStream_t)stream);
}
