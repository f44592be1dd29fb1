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
// compute-bound.  bfloat16 runs the warp-specialised wgmma + TMA attention
// tile (attention_wgmma.cuh: a TMA producer warpgroup, three consumer
// warpgroups of 64 queries taking turns on the tensor cores) on the packed
// qkv, split over the keys where the grid leaves SMs idle (`splits` from
// ops/attention_kernel.py::self_splits; the float32 partials in `part`,
// combined by attention_combine.cuh in the same entry call); float32 keeps
// computing in float32, as FMAs on the CUDA cores, with no TF32: the
// attention variant of the register-tiled, cp.async-pipelined f32 tile
// (mhada_f32_tile.cuh, attention_f32_kernel<false>: 256 queries a block,
// the scale folded into Q^T), unsplit.  The scores never leave shared
// memory and registers.
//
// K1's cross form (mhada_attention_cross_fwd): N queries against M keys and
// values of another tensor, the counterpart of the head-major
// _attention_pallas_call (_kernel, pallas_call at attention_pallas.py:62)
// and of the forward of _attn_stream_fwd_impl (with_res=False, pallas_call
// at :488), which the JAX ViT attention reaches under sequence parallelism
// (mhada_tpu/models/layers.py:204-212): each rank's local queries against
// the keys and values gathered over the ranks.  Q is read from rows of
// q_stride elements (this rank's packed qkv: its first C columns), K and V
// from one (B, M, 2C) tensor side by side in rows of kv_stride elements.
// Keys past M are masked in the ragged last tile and query rows past N are
// not stored; the key loop has no length cap, so M > 4096 streams through
// it as the TPU's streaming forward does.  Bound: 4 N M d flops per head
// against (N + 2M + N) C element reads and writes: compute-bound at the
// path's shapes.
//
// Its design for the H100.  At the SP shapes (B = 1, 8 heads, 1024 or 2048
// queries against 4096 keys) one block a (b, h, query block) leaves most
// of the 132 SMs idle (f32: 32 blocks of 256 queries at 1024 queries), and
// a partial wave costs a full one.  So the entry takes `splits`: each (b,
// h, query block) takes `splits` blocks, split s walking key tiles [s T /
// splits, (s + 1) T / splits) of the T = ceil(M / 64) and writing float32
// partials (m, l, unnormalised O) into `part`, which a second kernel on the
// same stream combines in a fixed order (attention_combine.cuh;
// ops/attention_kernel.py::cross_splits picks the count).  float32 runs
// the split as attention_f32_kernel<false, true> on the CUDA cores (no
// TF32; the self case's <false> and K6's <true> are untouched); bfloat16
// runs a warp-specialised wgmma + TMA tile (attention_wgmma.cuh: three
// consumer warpgroups of 64 queries, a producer keeping 64-key TMA boxes
// of K and V in flight), split or not.
#include "attention_combine.cuh"
#include "attention_wgmma.cuh"
#include "mhada_f32_tile.cuh"

namespace {

// K1's cross form at float32 split over the keys (1 < splits <= the key
// tiles): attention_f32_kernel<false, true> into `part`, which holds
// xsplit::partial_floats floats, then the combine into a.out.
cudaError_t attention_cross_split_f32(mhada::f32t::AttnArgs a, int heads,
                                      int batch, int splits, float* part,
                                      cudaStream_t stream) {
  using mhada::f32t::AttnGeom;
  if (a.n < 1 || a.m < 1 || a.q_rs % 4 || a.kv_rs % 4 || splits < 2 ||
      splits > (a.m + mhada::f32t::kBK - 1) / mhada::f32t::kBK ||
      !mhada::f32t::f32_aligned({a.q, a.k, a.v, a.out, part}, a.channels))
    return cudaErrorInvalidValue;
  a.part = part;
  a.splits = splits;
  const dim3 grid((a.n + AttnGeom::BQ - 1) / AttnGeom::BQ * splits, heads,
                  batch);
  const cudaError_t err = mhada::launch_with_smem(
      mhada::f32t::attention_f32_kernel<false, true>, grid,
      dim3(AttnGeom::kThreads),
      mhada::f32t::smem_bytes<AttnGeom, false>(mhada::f32t::kRingStages),
      stream, a);
  if (err != cudaSuccess) return err;
  return mhada::xsplit::launch_combine<float>(
      {part, splits, batch, a.n, a.channels, heads}, a.out, stream);
}

cudaError_t attention_fwd_f32(const void* qkv, void* out, int batch,
                              int seq, int channels, int heads, float scale,
                              cudaStream_t stream) {
  return mhada::f32t::launch_attention_f32<false>(
      mhada::f32t::self_attention_args(qkv, out, seq, channels, scale),
      heads, batch, stream);
}

}  // namespace

// qkv and out 16-byte aligned; channels a multiple of 4 (float32) or 8
// (bfloat16).  bfloat16: 1 <= splits <= ceil(seq / 64), and with splits >
// 1 part holds xsplit::partial_floats(splits, batch, seq, channels, heads)
// float32 (16-byte aligned); float32 takes splits = 1 and no part.
extern "C" int mhada_attention_fwd(const void* qkv, void* out, void* part,
                                   int batch, int seq, int channels,
                                   int heads, int splits, float scale,
                                   int dtype, void* stream) {
  if (dtype == mhada::kF32)
    return splits == 1 ? (int)attention_fwd_f32(qkv, out, batch, seq,
                                                channels, heads, scale,
                                                (cudaStream_t)stream)
                       : (int)cudaErrorInvalidValue;
  if (dtype != mhada::kBF16) return (int)cudaErrorInvalidValue;
  return (int)mhada::xwg::launch_self_attention_wgmma(
      qkv, out, nullptr, batch, seq, channels, heads, splits,
      static_cast<float*>(part), scale, (cudaStream_t)stream);
}

// q: rows of q_stride elements, the queries in the first `channels`; kv:
// rows of kv_stride elements, K in the first `channels` and V in the next;
// out (B, n_q, C).  splits >= 1 and at most ceil(n_kv / 64); with splits >
// 1, part holds xsplit::partial_floats(splits, batch, n_q, channels, heads)
// float32 (16-byte aligned).  Pointers 16-byte aligned, strides and
// channels multiples of 4 (float32) or 8 (bfloat16).
extern "C" int mhada_attention_cross_fwd(const void* q, const void* kv,
                                         void* out, void* part, int batch,
                                         int n_q, int n_kv, int channels,
                                         int q_stride, int kv_stride,
                                         int heads, int splits, float scale,
                                         int dtype, void* stream) {
  float* partials = static_cast<float*>(part);
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
    if (splits == 1)
      return (int)mhada::f32t::launch_attention_f32<false>(
          a, heads, batch, (cudaStream_t)stream);
    return (int)attention_cross_split_f32(a, heads, batch, splits, partials,
                                          (cudaStream_t)stream);
  }
  if (dtype != mhada::kBF16) return (int)cudaErrorInvalidValue;
  mhada::xwg::XArgs a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.q_rs = q_stride;
  a.n = n_q;
  a.m = n_kv;
  a.channels = channels;
  a.scale = scale;
  return (int)mhada::xwg::launch_attention_wgmma(
      a, kv, kv_stride, heads, batch, splits, partials, (cudaStream_t)stream);
}

extern "C" const char* mhada_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
