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
// Forward: K4's tile (flash_tile.cuh) that also writes M1 and E2 (float32,
// (B, N, C)) and the row log-sum-exp ((B, heads, N) float32).  Backward:
// the wrapper runs the elementwise prologue of _mhada_tm_bwd_impl
// (mhada_pallas.py:431-448: dfcs_n, the clamped dVar, dM1, dE2 and the row
// term delta); the two kernels of flash_bwd.cuh then give dQ, dK and
// dV = P^T dM1 + 2 V * (P^T dE2).  q, fcs_n, dM1, dE2 and dQ are (B, N, C)
// and k, v, dK, dV (B, M, C), head h at channels [h*64, (h+1)*64).
//
// What bounds it on the card: the forward does 6 N M d flops per head, the
// backward 20 N M d (S and dP = dM1 V^T + dE2 (V^2)^T in both kernels, two
// P^T products, dS^T Q, dS K; 14 N M d without the recompute), i.e. 26 and
// 86 GFLOP per call at the training shape (B = 8, N = M = 1024, 8 heads):
// compute-bound.  This first version runs float32 FMAs on the CUDA cores,
// not the tensor cores.

#include "flash_bwd.cuh"

namespace {

template <typename T>
cudaError_t mhada_train_fwd(const void* q, const void* k, const void* v,
                            const void* fcs_n, void* out, float* m1,
                            float* e2, float* lse, int batch, int n, int m,
                            int channels, int heads, cudaStream_t stream) {
  mhada::FlashArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.f = fcs_n;
  a.out = out;
  a.n = n;
  a.m = m;
  a.q_bs = a.f_bs = a.o_bs = (long long)n * channels;
  a.kv_bs = (long long)m * channels;
  a.q_rs = a.kv_rs = a.f_rs = a.o_rs = channels;
  a.scale = 1.f;
  a.lse = lse;
  a.m1 = m1;
  a.e2 = e2;
  return mhada::launch_flash_tile<T, true, true>(a, heads, batch, stream);
}

template <typename T>
cudaError_t mhada_train_bwd(const void* q, const void* k, const void* v,
                            const void* dm1, const void* de2,
                            const float* lse, const float* delta, void* dq,
                            void* dk, void* dv, int batch, int n, int m,
                            int channels, int heads, cudaStream_t stream) {
  mhada::FlashBwdArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.g1 = dm1;
  a.g2 = de2;
  a.lse = lse;
  a.delta = delta;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.n = n;
  a.m = m;
  a.q_bs = a.g_bs = a.dq_bs = (long long)n * channels;
  a.kv_bs = a.dkv_bs = (long long)m * channels;
  a.q_rs = a.g_rs = a.dq_rs = a.kv_rs = a.dkv_rs = channels;
  a.scale = 1.f;
  return mhada::launch_flash_bwd<T, true>(a, heads, batch, stream);
}

}  // namespace

// q, fcs_n, out (B, N, C) and k, v (B, M, C) in T; m1, e2 (B, N, C) and lse
// (B, heads, N) float32.
extern "C" int mhada_mhada_train_fwd(const void* q, const void* k,
                                     const void* v, const void* fcs_n,
                                     void* out, void* m1, void* e2, void* lse,
                                     int batch, int n, int m, int channels,
                                     int heads, int dtype, void* stream) {
  MHADA_DISPATCH_DTYPE(
      dtype, T,
      return (int)mhada_train_fwd<T>(
          q, k, v, fcs_n, out, static_cast<float*>(m1),
          static_cast<float*>(e2), static_cast<float*>(lse), batch, n, m,
          channels, heads, (cudaStream_t)stream));
}

// dm1, de2 (B, N, C) in T; lse, delta (B, heads, N) float32; dq (B, N, C),
// dk, dv (B, M, C) in T.
extern "C" int mhada_mhada_train_bwd(const void* q, const void* k,
                                     const void* v, const void* dm1,
                                     const void* de2, const void* lse,
                                     const void* delta, void* dq, void* dk,
                                     void* dv, int batch, int n, int m,
                                     int channels, int heads, int dtype,
                                     void* stream) {
  MHADA_DISPATCH_DTYPE(
      dtype, T,
      return (int)mhada_train_bwd<T>(
          q, k, v, dm1, de2, static_cast<const float*>(lse),
          static_cast<const float*>(delta), dq, dk, dv, batch, n, m, channels,
          heads, (cudaStream_t)stream));
}
