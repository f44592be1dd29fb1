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
// [V | V^2] concat only filled its 128-wide MXU; here V^2 is formed once a
// key tile.  M1 and E2 accumulate in float32 and E2 - M1^2 is taken in
// float32, where it cancels.
//
// What bounds it on the card: 6 N M d flops per head (51 GFLOP per call at
// N = M = 4096, 8 heads), compute-bound at the bf16 tensor-core rate.
// bfloat16 runs the MHAda tile of mhada_wgmma.cuh without K3's prologue
// (mhada_wgmma_kernel<false, kSplit>: q's rows by cp.async and ldmatrix
// into its A fragments, f = fcs_n): a producer warpgroup keeping 64-key TMA
// boxes of K and V in flight and squaring V into V^2, three consumer
// warpgroups of 64 queries running S = q K^T and P [V | V^2] on wgmma in
// turns, P and V^2 rounded to bf16 as the Pallas kernel rounds them
// (mhada_pallas.py:63-72).  Where one block a (b, h, 192-query block) would
// leave SMs idle (B = 1: 176 blocks on 132 SMs at 512^2; the Sintel eval's
// 3600 queries, 152), each takes `splits` blocks over the keys, whose
// float32 partials a second kernel combines in a fixed order and finishes
// with the epilogue (mhada_combine.cuh; ops/mhada_kernel.py::mhada_splits
// picks the count).  float32 keeps computing in float32, as FMAs on the
// CUDA cores, with no TF32: the register-tiled, cp.async-pipelined tile of
// mhada_f32_tile.cuh (mhada_f32_kernel<false, 2>: 128 queries a block, q
// read as given).
#include "mhada_f32_tile.cuh"
#include "mhada_wgmma.cuh"

namespace {

cudaError_t mhada_fwd_f32(const void* q, const void* k, const void* v,
                          const void* fcs_n, void* out, int batch, int n,
                          int m, int channels, int heads,
                          cudaStream_t stream) {
  mhada::f32t::F32Args a{};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.f = static_cast<const float*>(fcs_n);
  a.out = static_cast<float*>(out);
  a.n = n;
  a.m = m;
  a.channels = channels;
  return mhada::f32t::launch_mhada_f32<false, mhada::f32t::kRingStages>(
      a, heads, batch, stream);
}

}  // namespace

// q, fcs_n, out (B, N, C) and k, v (B, M, C) in T, every pointer 16-byte
// aligned.  float32: channels a multiple of 4, splits 1; bfloat16: channels
// = 64 heads, 1 <= splits <= ceil(m / 64), and with splits > 1 part holds
// xsplit::partial_floats(splits, batch, n, 2 channels, heads) float32
// (16-byte aligned).
extern "C" int mhada_mhada_fwd(const void* q, const void* k, const void* v,
                               const void* fcs_n, void* out, void* part,
                               int batch, int n, int m, int channels,
                               int heads, int splits, int dtype,
                               void* stream) {
  if (dtype == mhada::kF32)
    return splits != 1 ? (int)cudaErrorInvalidValue
                       : (int)mhada_fwd_f32(q, k, v, fcs_n, out, batch, n, m,
                                            channels, heads,
                                            (cudaStream_t)stream);
  if (dtype != mhada::kBF16) return (int)cudaErrorInvalidValue;
  using bf16 = __nv_bfloat16;
  mhada::wg::WgArgs a{};
  a.q = static_cast<const bf16*>(q);
  a.f = static_cast<const bf16*>(fcs_n);
  a.out = static_cast<bf16*>(out);
  a.n = n;
  a.m = m;
  a.channels = channels;
  return (int)mhada::wg::launch_mhada_wgmma<false>(
      a, k, v, batch, heads, splits, static_cast<float*>(part),
      (cudaStream_t)stream);
}
