// K7: the differentiable MHAda core on token-major tensors, forward and
// backward.
//
// Replaces mhada_tpu/ops/mhada_pallas.py::mhada_tm_train: the forward
// _mhada_tm_fwd_impl (_tm_res_kernel, pallas_call at mhada_pallas.py:336)
// and the backward kernel of _mhada_tm_bwd_impl (_mhada_tm_bwd_kernel,
// pallas_call at mhada_pallas.py:468).  Per head (reference
// network/adaDecoder.py:134-206):
//
//   A = softmax(Q K^T)              UNSCALED
//   M1 = A V,  E2 = A V^2,  out = sqrt(max(E2 - M1^2, 1e-6)) * fcs_n + M1
//
// Forward: the MHAda tile that also writes M1 and E2 (float32, (B, N, C))
// and the row log-sum-exp ((B, heads, N) float32).  Backward: the wrapper
// runs the elementwise prologue of _mhada_tm_bwd_impl (mhada_pallas.py:
// 431-448: dfcs_n, the clamped dVar, dM1, dE2 and the row term delta); two
// kernels (dK and dV per key tile, dQ per query tile) then give dQ, dK and
// dV = P^T dM1 + 2 V * (P^T dE2).  q, fcs_n, dM1, dE2 and dQ are (B, N, C)
// and k, v, dK, dV (B, M, C), head h at channels [h*64, (h+1)*64).
//
// What bounds it on the card: the forward does 6 N M d flops per head, the
// backward 20 N M d (S and dP = dM1 V^T + dE2 (V^2)^T in both kernels, two
// P^T products, dS^T Q, dS K; 14 N M d without the recompute), i.e. 26 and
// 86 GFLOP per call at the training shape (B = 8, N = M = 1024, 8 heads):
// compute-bound.  bfloat16 runs on the tensor cores as warp-specialised
// wgmma + TMA kernels: the forward on K4's MHAda tile with its residual
// epilogue (mhada_wgmma.cuh, mhada_wgmma_kernel<false, split, kRes = true>,
// split over the keys as ops/mhada_kernel.py::mhada_splits picks, the
// float32 partials combined with the residuals by mhada_combine.cuh), so
// that its out repeats K4's bit for bit at the same split count; the
// backward as a dK / dV kernel and a dQ kernel (mhada_bwd_wgmma.cuh).
// float32 keeps computing in float32, as FMAs on the CUDA cores (the
// forward: K4's tile of mhada_f32_tile.cuh with its residual stores,
// mhada_f32_kernel<false, 2, true>, so its out repeats K4's bit for bit;
// the backward: flash_bwd_f32.cuh; float32 operands 16-byte aligned and
// channels a multiple of 4, or the entry point refuses).

#include "flash_bwd_f32.cuh"  // and mhada_f32_tile.cuh
#include "mhada_bwd_wgmma.cuh"

namespace {

cudaError_t mhada_train_fwd_f32(const void* q, const void* k, const void* v,
                                const void* fcs_n, void* out, float* m1,
                                float* e2, float* lse, int batch, int n,
                                int m, int channels, int heads,
                                cudaStream_t stream) {
  mhada::f32t::F32Args a{};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.f = static_cast<const float*>(fcs_n);
  a.out = static_cast<float*>(out);
  a.m1 = m1;
  a.e2 = e2;
  a.lse = lse;
  a.n = n;
  a.m = m;
  a.channels = channels;
  return mhada::f32t::launch_mhada_f32<false, mhada::f32t::kRingStages, true>(
      a, heads, batch, stream);
}

cudaError_t mhada_train_bwd_f32(const void* q, const void* k, const void* v,
                                const void* dm1, const void* de2,
                                const float* lse, const float* delta,
                                void* dq, void* dk, void* dv, int batch,
                                int n, int m, int channels, int heads,
                                cudaStream_t stream) {
  if (!mhada::f32t::f32_aligned({q, k, v, dm1, de2, dq, dk, dv}, channels))
    return cudaErrorInvalidValue;
  mhada::f32b::BwdArgs a{};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.g1 = static_cast<const float*>(dm1);
  a.g2 = static_cast<const float*>(de2);
  a.lse = lse;
  a.delta = delta;
  a.dq = static_cast<float*>(dq);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  a.n = n;
  a.m = m;
  a.q_bs = a.g_bs = a.dq_bs = (long long)n * channels;
  a.kv_bs = a.dkv_bs = (long long)m * channels;
  a.q_rs = a.g_rs = a.dq_rs = a.kv_rs = a.dkv_rs = channels;
  a.scale = 1.f;
  return mhada::f32b::launch_flash_bwd_f32<true>(a, heads, batch, stream);
}

}  // namespace

// q, fcs_n, out (B, N, C) and k, v (B, M, C) in T; m1, e2 (B, N, C) and lse
// (B, heads, N) float32.  float32: splits 1.  bfloat16: every pointer
// 16-byte aligned, channels = 64 heads, 1 <= splits <= ceil(m / 64), and
// with splits > 1 part holds xsplit::partial_floats(splits, batch, n, 2
// channels, heads) float32.
extern "C" int mhada_mhada_train_fwd(const void* q, const void* k,
                                     const void* v, const void* fcs_n,
                                     void* out, void* m1, void* e2, void* lse,
                                     void* part, int batch, int n, int m,
                                     int channels, int heads, int splits,
                                     int dtype, void* stream) {
  if (dtype == mhada::kF32)
    return splits != 1 ? (int)cudaErrorInvalidValue
                       : (int)mhada_train_fwd_f32(
                             q, k, v, fcs_n, out, static_cast<float*>(m1),
                             static_cast<float*>(e2),
                             static_cast<float*>(lse), batch, n, m, channels,
                             heads, (cudaStream_t)stream);
  if (dtype != mhada::kBF16) return (int)cudaErrorInvalidValue;
  using bf16 = __nv_bfloat16;
  mhada::wg::WgArgs a{};
  a.q = static_cast<const bf16*>(q);
  a.f = static_cast<const bf16*>(fcs_n);
  a.out = static_cast<bf16*>(out);
  a.m1 = static_cast<float*>(m1);
  a.e2 = static_cast<float*>(e2);
  a.lse = static_cast<float*>(lse);
  a.n = n;
  a.m = m;
  a.channels = channels;
  return (int)mhada::wg::launch_mhada_wgmma<false, true>(
      a, k, v, batch, heads, splits, static_cast<float*>(part),
      (cudaStream_t)stream);
}

// dm1, de2 (B, N, C) in T; lse, delta (B, heads, N) float32; dq (B, N, C),
// dk, dv (B, M, C) in T.  bfloat16: every bf16 pointer 16-byte aligned,
// channels = 64 heads.
extern "C" int mhada_mhada_train_bwd(const void* q, const void* k,
                                     const void* v, const void* dm1,
                                     const void* de2, const void* lse,
                                     const void* delta, void* dq, void* dk,
                                     void* dv, int batch, int n, int m,
                                     int channels, int heads, int dtype,
                                     void* stream) {
  if (dtype == mhada::kF32)
    return (int)mhada_train_bwd_f32(
        q, k, v, dm1, de2, static_cast<const float*>(lse),
        static_cast<const float*>(delta), dq, dk, dv, batch, n, m, channels,
        heads, (cudaStream_t)stream);
  if (dtype != mhada::kBF16) return (int)cudaErrorInvalidValue;
  using bf16 = __nv_bfloat16;
  mhada::wg::BwdArgs a{};
  a.v = static_cast<const bf16*>(v);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dq = static_cast<bf16*>(dq);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.n = n;
  a.m = m;
  a.channels = channels;
  return (int)mhada::wg::launch_mhada_wgmma_bwd(a, q, k, dm1, de2, batch,
                                                heads, (cudaStream_t)stream);
}
