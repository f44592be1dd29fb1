// K3: one MHAda block's core on cached style K/V, with the instance norm
// and the Q projection fused into the prologue and IN(fcs) into the
// epilogue.
//
// Replaces mhada_tpu/ops/mhada_pallas.py::mhada_fused_prologue
// (_fused_kernel, pallas_call at mhada_pallas.py:239), which
// AdaAttnMultiHead runs when the style K/V are cached
// (mhada_tpu/models/adaformer.py:80-97).  Per head h, with the float32
// per-channel stats [mean_fc, rstd_fc, mean_fcs, rstd_fcs]:
//
//   qn  = (fc - mean_fc) * rstd_fc               float32, rounded to T
//   q   = qn Wf_h + fb_h                         float32, rounded to T
//   A   = softmax(q K^T)                         UNSCALED
//   M1  = A V,  E2 = A V^2                       float32
//   out = sqrt(max(E2 - M1^2, 1e-6)) * (fcs - mean_fcs) * rstd_fcs + M1
//
// fc, fcs and out are token-major (B, N, C), k and v (B, M, C), stats
// (B, 4, C) float32, wf (H, 64, 64) as (in, out) in T, fb (H, 64) float32.
//
// Design at float32: the block is K4's float32 tile (mhada_f32_tile.cuh,
// mhada_f32_kernel<true, 2>) with the prologue switched on: it loads the
// block's 128 raw fc rows of head h, normalises them with the stats into
// the P^T buffer (unused until the first key tile) and multiplies them,
// register-tiled, by Wf_h, staged in the V^2 buffer, into Q^T, while the
// first key tile lands.  The key loop is K4's, unscaled.  The epilogue
// normalises raw fcs with the stats.  Neither q nor IN(fcs) ever reaches
// device memory, which is what the TPU kernel kept out of HBM.  The TPU
// kernel packed two heads' Wf into 128 lanes and concatenated [V | V^2] to
// fill its MXU; neither exists here (V^2 is formed once a key tile).  The
// TPU kernel holds every key in VMEM, so its call site caps M at 4096; this
// one streams the keys, so every cached-K/V block runs here, M = 16384
// (1024^2) included.
//
// What bounds it on the card: 6 N M d flops per head for the attention and
// 2 N d^2 for the projection (51.5 + 0.3 GFLOP at N = M = 4096, 8 heads)
// against (3 N + 2 M) C element reads and writes: compute-bound.  float32
// keeps computing in float32, as FMAs on the CUDA cores (the tile above).
// bfloat16 runs the MHAda tile of mhada_wgmma.cuh with K3's prologue
// (mhada_wgmma_kernel<true, kSplit>): a warp-specialised wgmma + TMA kernel,
// a producer warpgroup keeping 64-key TMA boxes of K and V in flight and
// squaring V into V^2, three consumer warpgroups of 64 queries each running
// the prologue on mma.sync into q's A fragments, then S = q K^T and P [V |
// V^2] on wgmma in turns.  Where one block a (b, h, 192-query block) would
// leave SMs idle (B = 1: 176 blocks on 132 SMs at 512^2), each takes
// `splits` blocks over the keys, whose float32 partials a second kernel
// combines in a fixed order and finishes with the epilogue
// (mhada_combine.cuh; ops/mhada_kernel.py::mhada_splits picks the count).
#include "mhada_f32_tile.cuh"
#include "mhada_wgmma.cuh"

namespace {

cudaError_t mhada_prologue_f32(const void* fc, const void* fcs,
                               const void* stats, const void* wf,
                               const void* fb, const void* k, const void* v,
                               void* out, int batch, int n, int m,
                               int channels, int heads, cudaStream_t stream) {
  mhada::f32t::F32Args a{};
  a.q = static_cast<const float*>(fc);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.f = static_cast<const float*>(fcs);
  a.out = static_cast<float*>(out);
  a.stats = static_cast<const float*>(stats);
  a.wf = static_cast<const float*>(wf);
  a.fb = static_cast<const float*>(fb);
  a.n = n;
  a.m = m;
  a.channels = channels;
  return mhada::f32t::launch_mhada_f32<true, mhada::f32t::kRingStages>(
      a, heads, batch, stream);
}

}  // namespace

// fc, fcs, out (B, N, C), k, v (B, M, C) and wf (H, 64, 64) in T; stats
// (B, 4, C) and fb (H, 64) float32.  float32: every pointer 16-byte aligned,
// channels a multiple of 4, splits 1; bfloat16: every bf16 pointer 16-byte
// aligned, channels = 64 heads, 1 <= splits <= ceil(m / 64), and with splits
// > 1 part holds xsplit::partial_floats(splits, batch, n, 2 channels,
// heads) float32 (16-byte aligned).
extern "C" int mhada_mhada_prologue(const void* fc, const void* fcs,
                                    const void* stats, const void* wf,
                                    const void* fb, const void* k,
                                    const void* v, void* out, void* part,
                                    int batch, int n, int m, int channels,
                                    int heads, int splits, int dtype,
                                    void* stream) {
  if (dtype == mhada::kF32)
    return splits != 1 ? (int)cudaErrorInvalidValue
                       : (int)mhada_prologue_f32(fc, fcs, stats, wf, fb, k, v,
                                                 out, batch, n, m, channels,
                                                 heads, (cudaStream_t)stream);
  if (dtype != mhada::kBF16) return (int)cudaErrorInvalidValue;
  using bf16 = __nv_bfloat16;
  mhada::wg::WgArgs a{};
  a.q = static_cast<const bf16*>(fc);
  a.f = static_cast<const bf16*>(fcs);
  a.stats = static_cast<const float*>(stats);
  a.wf = static_cast<const bf16*>(wf);
  a.fb = static_cast<const float*>(fb);
  a.out = static_cast<bf16*>(out);
  a.n = n;
  a.m = m;
  a.channels = channels;
  return (int)mhada::wg::launch_mhada_wgmma<true>(
      a, k, v, batch, heads, splits, static_cast<float*>(part),
      (cudaStream_t)stream);
}
