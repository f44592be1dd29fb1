// P1: a bf16 matmul probe on the tensor cores at the attention tile shapes
// (mhada_mm_probe), launching the wgmma + TMA kernel of mm_wgmma.cuh.
//
// Counterpart of scripts/mxu_probe.py::_mm_kernel (pallas_call at
// mxu_probe.py:42): out = a b, a (m, k) and b (k, n) bf16, summed in
// float32, rounded to bf16, computed `reps` times.  The TPU probe held its
// operands in VMEM with constant index maps, so after the first grid step
// it measured the matrix unit's issue rate at each shape.  Here the grid's
// third dimension is `reps` and every rep writes the same output tile from
// the same operands, so after the first rep they come from L2 and the
// launch measures the tensor cores' rate at that shape.

#include "mm_wgmma.cuh"

// a (m, k), b (k, n), out (m, n), all bf16 row-major and 16-byte aligned;
// the block tile bm x bn is 64 or 128 x 64, 128 or 256 (the caller's
// choice, probes/mm_probe.py::tile); m % bm == n % bn == k % 64 == 0;
// 1 <= reps <= 65535.
extern "C" int mhada_mm_probe(const void* a, const void* b, void* out, int m,
                              int k, int n, int reps, int bm, int bn,
                              void* stream) {
  namespace mw = mhada::mmwg;
  if (m < 1 || n < 1 || k < 1 || (bm != 64 && bm != 128) ||
      (bn != 64 && bn != 128 && bn != 256) || m % bm || n % bn ||
      k % mw::kBK || reps < 1 || reps > 65535 ||
      !mhada::mma_aligned({a, b, out}, 8))
    return (int)cudaErrorInvalidValue;
  const auto* ap = static_cast<const __nv_bfloat16*>(a);
  const auto* bp = static_cast<const __nv_bfloat16*>(b);
  auto* op = static_cast<__nv_bfloat16*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
#define MHADA_MM_TILE(BM, BN)    \
  if (bm == BM && bn == BN)      \
    return (int)mw::launch_mm_wgmma<BM, BN>(ap, bp, op, m, k, n, reps, st);
  MHADA_MM_TILE(64, 64)
  MHADA_MM_TILE(64, 128)
  MHADA_MM_TILE(64, 256)
  MHADA_MM_TILE(128, 64)
  MHADA_MM_TILE(128, 128)
  MHADA_MM_TILE(128, 256)
#undef MHADA_MM_TILE
  return (int)cudaErrorInvalidValue;
}
