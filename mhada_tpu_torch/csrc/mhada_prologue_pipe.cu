// P2: K3's function, the repo's probe of the MHAda tile (mhada_mhada_
// prologue_pipe).  bfloat16 launches the warp-specialised wgmma + TMA kernel
// of mhada_wgmma.cuh; float32 launches the kernel below.
//
// Counterpart of scripts/mhada_pipe_probe.py::_pipe_kernel (pallas_call at
// mhada_pipe_probe.py:112), an A/B probe of the fused-prologue MHAda kernel
// that reordered two heads' work so that one head's vector work could hide
// under the other's matrix work (mhada_pipe_probe.py:1-11).  The function,
// the stats, the layouts and the rounding points are K3's
// (ops/mhada_prologue.py::mhada_fused_prologue_plain is the plain version
// of both).
//
// The float32 kernel asks the TPU probe's question on the CUDA cores: the
// latency to hide is the global load of each 64-key tile, which K3's
// float32 kernel (mhada_prologue.cu) issues and waits for between two
// barriers.  It is K3's block (flash_tile.cuh: 64 queries of one head, 256
// threads, float32 accumulators, online softmax) with a different key
// loop.  The ring holds each tile as it lies in memory: K at a row stride
// padded by 16 bytes (the score loop reads it key-major, two-way bank
// conflicts where K3's transposed copy has none), V unpadded.  The 16-byte
// cp.async copies bypass registers and L1; keys past M are zero-filled by
// plain stores.  Wf, needed only by the prologue, is staged in the ring's
// second stage before the first tile lands there: 100.9 KB of shared
// memory, two blocks an SM, as K3's 81 KB.  What bounds it on the card:
// operations, 6 N M d flops per head plus 2 N d^2 for the projection,
// float32 FMAs on the CUDA cores.

#include "mhada_prologue.cuh"
#include "mhada_wgmma.cuh"

namespace {

using mhada::FlashAcc;
using mhada::FlashArgs;
using mhada::kBK;
using mhada::kFlashThreads;
using mhada::kHeadDim;
using mhada::kTPad;

template <typename T>
struct Ring {
  static constexpr int kVec = 16 / sizeof(T);        // elements per 16 bytes
  static constexpr int kKStride = kHeadDim + kVec;   // padded key row
  static constexpr int kStage = kBK * (kKStride + kHeadDim);  // K then V
  static constexpr size_t kBytes = sizeof(float) * 2 * kHeadDim * kTPad +
                                   sizeof(T) * 2 * kStage;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most one committed group is still in flight.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Issue the copies of key tile k0 (K and V, head at channel hoff) into
// `stage`; keys past a.m are zeroed.
template <typename T>
__device__ __forceinline__ void issue_tile(const FlashArgs& a, T* stage,
                                           int k0, int hoff, long long b) {
  using R = Ring<T>;
  constexpr int kChunks = kHeadDim / R::kVec;
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  T* ks = stage;
  T* vs = stage + kBK * R::kKStride;
  for (int idx = threadIdx.x; idx < kBK * kChunks; idx += kFlashThreads) {
    const int c = idx / kChunks, ch = idx % kChunks;
    const int key = k0 + c;
    T* kd = ks + c * R::kKStride + ch * R::kVec;
    T* vd = vs + c * kHeadDim + ch * R::kVec;
    if (key < a.m) {
      const long long off = b * a.kv_bs + key * a.kv_rs + hoff + ch * R::kVec;
      cp_async16(kd, k + off);
      cp_async16(vd, v + off);
    } else {
      *reinterpret_cast<uint4*>(kd) = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(vd) = make_uint4(0, 0, 0, 0);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kFlashThreads)
    mhada_prologue_pipe_kernel(FlashArgs a, const float* __restrict__ stats,
                               const T* __restrict__ wf,
                               const float* __restrict__ fb, int channels) {
  using R = Ring<T>;
  extern __shared__ float smem[];
  float* qs = smem;                        // [d][kTPad]   Q^T
  float* ps = qs + kHeadDim * kTPad;       // [key][kTPad] P^T; qn^T first
  T* ring = reinterpret_cast<T*>(ps + kBK * kTPad);
  float* wfs = reinterpret_cast<float*>(ring + R::kStage);  // stage 1
  const int hoff = blockIdx.y * kHeadDim;
  const long long b = blockIdx.z;

  // The first key tile flies while the prologue runs.
  issue_tile<T>(a, ring, 0, hoff, b);
  cp_async_commit();
  mhada::prologue_queries<T>(a, stats, wf, fb, channels, ps, wfs, qs);
  // Every read of wfs (stage 1) and of qn^T (ps) is done before tile 1 is
  // issued into stage 1 and before P^T is written; Q^T is published.
  __syncthreads();

  FlashAcc acc;
  mhada::flash_init(acc);
  const int tiles = (a.m + kBK - 1) / kBK;
  for (int t = 0; t < tiles; ++t) {
    if (t + 1 < tiles)
      issue_tile<T>(a, ring + ((t + 1) & 1) * R::kStage, (t + 1) * kBK, hoff,
                    b);
    cp_async_commit();    // possibly empty: one group per iteration
    cp_async_wait_one();  // tile t has landed
    __syncthreads();
    const T* ks = ring + (t & 1) * R::kStage;
    float sc[4][4];
    mhada::flash_scores<R::kKStride, 1>(qs, ks, sc);
    mhada::flash_softmax<true>(a, t * kBK, sc, ps, acc);
    __syncthreads();
    mhada::flash_pv<true>(ps, ks + kBK * R::kKStride, acc);
    // stage t & 1 is free for tile t + 2, P^T for the next scores
    __syncthreads();
  }
  mhada::prologue_epilogue<T>(a, stats, channels, acc);
}

template <typename T>
cudaError_t mhada_prologue_pipe(const void* fc, const void* fcs,
                                const float* stats, const void* wf,
                                const float* fb, const void* k, const void* v,
                                void* out, int batch, int n, int m,
                                int channels, int heads, cudaStream_t stream) {
  static_assert(sizeof(float) * kHeadDim * kHeadDim <=
                    sizeof(T) * Ring<T>::kStage,
                "Wf must fit in the ring's second stage");
  const FlashArgs a =
      mhada::prologue_args(fc, fcs, k, v, out, n, m, channels);
  const dim3 grid((n + mhada::kBQ - 1) / mhada::kBQ, heads, batch);
  return mhada::launch_with_smem(mhada_prologue_pipe_kernel<T>, grid,
                                 dim3(kFlashThreads), Ring<T>::kBytes, stream,
                                 a, stats, static_cast<const T*>(wf), fb,
                                 channels);
}

}  // namespace

// As mhada_mhada_prologue (mhada_prologue.cu): fc, fcs, out (B, N, C), k,
// v (B, M, C) and wf (H, 64, 64) in T; stats (B, 4, C) and fb (H, 64)
// float32.  k and v 16-byte aligned, C % 8 == 0; bfloat16: every bf16
// pointer 16-byte aligned, C = 64 H.
extern "C" int mhada_mhada_prologue_pipe(const void* fc, const void* fcs,
                                         const void* stats, const void* wf,
                                         const void* fb, const void* k,
                                         const void* v, void* out, int batch,
                                         int n, int m, int channels,
                                         int heads, int dtype, void* stream) {
  if (m < 1) return (int)cudaErrorInvalidValue;
  if (dtype == mhada::kF32)
    return (int)mhada_prologue_pipe<float>(
        fc, fcs, static_cast<const float*>(stats), wf,
        static_cast<const float*>(fb), k, v, out, batch, n, m, channels,
        heads, (cudaStream_t)stream);
  if (dtype != mhada::kBF16 || channels != 64 * heads ||
      !mhada::mma_aligned({fc, fcs, wf, k, v, out}, channels))
    return (int)cudaErrorInvalidValue;
  using bf16 = __nv_bfloat16;
  mhada::wg::WgArgs a{};
  a.fc = static_cast<const bf16*>(fc);
  a.fcs = static_cast<const bf16*>(fcs);
  a.stats = static_cast<const float*>(stats);
  a.wf = static_cast<const bf16*>(wf);
  a.fb = static_cast<const float*>(fb);
  a.out = static_cast<bf16*>(out);
  a.n = n;
  a.m = m;
  a.channels = channels;
  return (int)mhada::wg::launch_mhada_wgmma(a, k, v, batch, heads,
                                            (cudaStream_t)stream);
}
