// K4: the MHAda core, single pass over the style keys.
//
// Replaces mhada_tpu/ops/mhada_pallas.py::_mhada_pallas_fwd_impl (_kernel,
// pallas_call at mhada_pallas.py:114), reached through
// mhada_attention_pallas -> _mhada_custom.  Per head h (reference
// network/adaDecoder.py:134-206):
//
//   A = softmax(Q K^T)              UNSCALED (adaDecoder.py:11-17)
//   M1 = A V,  E2 = A V^2
//   out = sqrt(max(E2 - M1^2, 1e-6)) * fcs_n + M1
//
// q, fcs_n and out are token-major (B, N, C) and k, v (B, M, C): head h is
// the channel slice [h*64, (h+1)*64), so the JAX path's five head-split
// transposes (models/adaformer.py:133-141) do not exist.  The TPU kernel's
// [V | V^2] concat only filled its 128-wide MXU; here V^2 is formed in
// registers from the V tile.  M1 and E2 accumulate in float32 and E2 - M1^2
// is taken in float32, where it cancels.
//
// What bounds it on the card: 6 N M d flops per head (51 GFLOP per call at
// N = M = 4096, 8 heads), compute-bound; this first version runs them as
// float32 FMAs on the CUDA cores (flash_tile.cuh).

#include "flash_tile.cuh"

namespace {

template <typename T>
cudaError_t mhada_fwd(const void* q, const void* k, const void* v,
                      const void* fcs_n, void* out, int batch, int n, int m,
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
  return mhada::launch_flash_tile<T, true>(a, heads, batch, stream);
}

}  // namespace

extern "C" int mhada_mhada_fwd(const void* q, const void* k, const void* v,
                               const void* fcs_n, void* out, int batch, int n,
                               int m, int channels, int heads, int dtype,
                               void* stream) {
  MHADA_DISPATCH_DTYPE(
      dtype, T,
      return (int)mhada_fwd<T>(q, k, v, fcs_n, out, batch, n, m, channels,
                               heads, (cudaStream_t)stream));
}
