// P2: K3's function, the repo's probe of the MHAda tile (mhada_mhada_
// prologue_pipe).  bfloat16 launches the warp-specialised wgmma + TMA kernel
// of mhada_wgmma.cuh, never split over the keys (mhada_wgmma_kernel<true,
// false>, K3's own tile where K3 takes one split): the control that
// mhada_wgmma_ablate.py rebuilds piece by piece; float32 launches K3's
// float32 tile with a one-stage ring.
//
// Counterpart of scripts/mhada_pipe_probe.py::_pipe_kernel (pallas_call at
// mhada_pipe_probe.py:112), an A/B probe of the fused-prologue MHAda kernel
// that reordered two heads' work so that one head's vector work could hide
// under the other's matrix work (mhada_pipe_probe.py:1-11).  The function,
// the stats, the layouts and the rounding points are K3's
// (ops/mhada_prologue.py::mhada_fused_prologue_plain is the plain version
// of both).
//
// The float32 build asks the TPU probe's question on the CUDA cores: the
// latency to hide is the global load of each 64-key tile.  K3's float32
// kernel (mhada_f32_tile.cuh, mhada_f32_kernel<true, 2>) lands tile t + 1
// by cp.async while tile t is computed; P2 runs the same block with a
// one-stage ring (mhada_f32_kernel<true, 1>): it issues each tile, waits
// for it and only then computes, so the pair times what the second stage
// buys.  Both run the same step functions in the same order, so P2 repeats
// K3 bit for bit.  It needs 114 KB of shared memory against K3's 147 KB;
// at ~170 registers a thread either runs one block an SM.  What bounds it
// on the card: operations, 6 N M d flops per head plus 2 N d^2 for the
// projection, float32 FMAs on the CUDA cores.

#include "mhada_f32_tile.cuh"
#include "mhada_wgmma.cuh"

// The arguments of mhada_mhada_prologue (mhada_prologue.cu): fc, fcs, out
// (B, N, C), k, v (B, M, C) and wf (H, 64, 64) in T; stats (B, 4, C) and
// fb (H, 64) float32; splits must be 1 (part is not read).  float32: every
// pointer 16-byte aligned, C % 4 == 0; bfloat16: every bf16 pointer
// 16-byte aligned, C = 64 H.
extern "C" int mhada_mhada_prologue_pipe(const void* fc, const void* fcs,
                                         const void* stats, const void* wf,
                                         const void* fb, const void* k,
                                         const void* v, void* out,
                                         void* part, int batch, int n, int m,
                                         int channels, int heads, int splits,
                                         int dtype, void* stream) {
  (void)part;
  if (m < 1 || splits != 1) return (int)cudaErrorInvalidValue;
  if (dtype == mhada::kF32) {
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
    return (int)mhada::f32t::launch_mhada_f32<true, 1>(a, heads, batch,
                                                      (cudaStream_t)stream);
  }
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
      a, k, v, batch, heads, 1, nullptr, (cudaStream_t)stream);
}
