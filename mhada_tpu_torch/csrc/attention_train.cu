// K6: differentiable ViT self-attention on the packed qkv, forward and
// backward.
//
// Replaces mhada_tpu/ops/attention_pallas.py::attention_tm_train: the
// forward _attn_tm_fwd_impl (_tm_res_kernel, pallas_call at
// attention_pallas.py:236) and the backward _attn_tm_bwd_impl
// (_tm_bwd_kernel, pallas_call at attention_pallas.py:351).
//
// Forward: K1's kernel that also writes the row log-sum-exp, (B, heads, L)
// float32 in natural-log units; the TPU kernel broadcast it over 64 lanes for
// its tiles, which Hopper does not need.  Backward: two kernels (dK and dV per
// key tile, dQ per query tile), reading Q, K and V in place from the (B, L, 3C)
// qkv and writing dQ, dK and dV straight into the packed (B, L, 3C) gradient at
// channel offsets h*64, C + h*64 and 2C + h*64, so no head-split copy exists in
// either direction.  The row term delta = rowsum(dO * O) per head comes from
// the wrapper (attention_pallas.py:322-327).
//
// What bounds it on the card: the forward does 4 L^2 d flops per head, the
// backward 14 L^2 d (S and dP in both kernels, P^T dO, dS^T Q, dS K; 10 L^2
// d without the recompute), i.e. 17 and 60 GFLOP per call at the training
// shape (B = 8, L = 1024, 8 heads) against 2 L (3C + C) element reads:
// compute-bound.  bfloat16 runs on the tensor cores: the forward on the
// wgmma + TMA attention tile (attention_wgmma.cuh, split over the keys where
// the grid leaves SMs idle, the combine also forming the lse), the backward
// on a wgmma + TMA dQ and dK/dV pair (attention_bwd_wgmma.cuh); float32
// keeps computing in float32,
// as FMAs on the CUDA cores (the forward: mhada_f32_tile.cuh,
// attention_f32_kernel<true>; the backward: flash_bwd_f32.cuh; float32
// operands 16-byte aligned and channels a multiple of 4, or the entry
// point refuses).

#include "attention_bwd_wgmma.cuh"
#include "attention_wgmma.cuh"
#include "flash_bwd_f32.cuh"  // and mhada_f32_tile.cuh

namespace {

cudaError_t attention_train_fwd_f32(const void* qkv, void* out, float* lse,
                                    int batch, int seq, int channels,
                                    int heads, float scale,
                                    cudaStream_t stream) {
  mhada::f32t::AttnArgs a =
      mhada::f32t::self_attention_args(qkv, out, seq, channels, scale);
  a.lse = lse;
  return mhada::f32t::launch_attention_f32<true>(a, heads, batch, stream);
}

cudaError_t attention_train_bwd_f32(const void* qkv, const void* g,
                                    const float* lse, const float* delta,
                                    void* dqkv, int batch, int seq,
                                    int channels, int heads, float scale,
                                    cudaStream_t stream) {
  const float* base = static_cast<const float*>(qkv);
  float* dbase = static_cast<float*>(dqkv);
  if (!mhada::f32t::f32_aligned({qkv, g, dqkv}, channels))
    return cudaErrorInvalidValue;
  mhada::f32b::BwdArgs a{};
  a.q = base;
  a.k = base + channels;
  a.v = base + 2 * channels;
  a.g1 = static_cast<const float*>(g);
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
  return mhada::f32b::launch_flash_bwd_f32<false>(a, heads, batch, stream);
}

}  // namespace

// qkv (B, L, 3C) in T; out (B, L, C) in T; lse (B, heads, L) float32.
// splits and part as mhada_attention_fwd's.
extern "C" int mhada_attention_train_fwd(const void* qkv, void* out,
                                         void* lse, void* part, int batch,
                                         int seq, int channels, int heads,
                                         int splits, float scale, int dtype,
                                         void* stream) {
  if (dtype == mhada::kF32)
    return splits == 1
               ? (int)attention_train_fwd_f32(
                     qkv, out, static_cast<float*>(lse), batch, seq,
                     channels, heads, scale, (cudaStream_t)stream)
               : (int)cudaErrorInvalidValue;
  if (dtype != mhada::kBF16 || lse == nullptr)
    return (int)cudaErrorInvalidValue;
  return (int)mhada::xwg::launch_self_attention_wgmma(
      qkv, out, static_cast<float*>(lse), batch, seq, channels, heads, splits,
      static_cast<float*>(part), scale, (cudaStream_t)stream);
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
  if (dtype != mhada::kBF16) return (int)cudaErrorInvalidValue;
  mhada::xbw::AttnBwdArgs a{};
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dqkv = static_cast<__nv_bfloat16*>(dqkv);
  a.seq = seq;
  a.channels = channels;
  a.scale = scale;
  return (int)mhada::xbw::launch_attention_wgmma_bwd(a, qkv, g, batch, heads,
                                                     (cudaStream_t)stream);
}
