// P1: a bf16 matmul probe on the tensor cores at the attention tile shapes.
//
// Counterpart of scripts/mxu_probe.py::_mm_kernel (pallas_call at
// mxu_probe.py:42): out = a b, a (m, k) and b (k, n) bf16, summed in
// float32, rounded to bf16, computed `reps` times.  The TPU probe held its
// operands in VMEM with constant index maps, so after the first grid step
// it measured the matrix unit's issue rate at each shape.  Here the grid's
// third dimension is `reps` and every rep writes the same output tile from
// the same operands, so after the first rep they come from L2 and the
// launch measures the tensor cores' rate at that shape as a simple kernel
// reaches it.
//
// Design: nvcuda::wmma 16 x 16 x 16 fragments (mma.sync underneath; wgmma
// and TMA are later work).  A block of 4 warps owns a 64 x 64 output tile,
// each warp 32 x 32 (2 x 2 fragments).  It walks k in steps of 32: the
// 64 x 32 slice of a and the 32 x 64 slice of b are copied to shared
// memory in 16-byte loads (rows padded by 16 bytes), then each warp runs
// 2 x 2 x 2 mma.  The float32 accumulators go through shared memory to a
// bf16 store.  m and n must be multiples of 64, k of 32; all eight probe
// shapes are.
//
// Bound: 2 m k n reps flops at the bf16 tensor-core rate; the operands are
// read once and the output written once.

#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int kThreads = 128;
constexpr int kBM = 64, kBN = 64, kBK = 32;
constexpr int kAStride = kBK + 8;   // bf16 elements; 80 bytes
constexpr int kBStride = kBN + 8;   // 144 bytes
constexpr int kCStride = kBN + 4;   // floats; 272 bytes

__global__ void __launch_bounds__(kThreads)
    mm_probe_kernel(const __nv_bfloat16* __restrict__ a,
                    const __nv_bfloat16* __restrict__ b,
                    __nv_bfloat16* __restrict__ out, int m, int k, int n) {
  __shared__ __align__(32) __nv_bfloat16 as[kBM * kAStride];
  __shared__ __align__(32) __nv_bfloat16 bs[kBK * kBStride];
  __shared__ __align__(32) float cs[kBM * kCStride];

  const int tid = threadIdx.x, warp = tid / 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < k; k0 += kBK) {
    // a: 64 rows x 4 chunks of 8; b: 32 rows x 8 chunks of 8
    for (int idx = tid; idx < kBM * kBK / 8; idx += kThreads) {
      const int r = idx / (kBK / 8), ch = idx % (kBK / 8);
      *reinterpret_cast<uint4*>(as + r * kAStride + ch * 8) =
          *reinterpret_cast<const uint4*>(a + (long long)(m0 + r) * k + k0 +
                                          ch * 8);
    }
    for (int idx = tid; idx < kBK * kBN / 8; idx += kThreads) {
      const int r = idx / (kBN / 8), ch = idx % (kBN / 8);
      *reinterpret_cast<uint4*>(bs + r * kBStride + ch * 8) =
          *reinterpret_cast<const uint4*>(b + (long long)(k0 + r) * n + n0 +
                                          ch * 8);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], as + (wm + 16 * i) * kAStride + kk,
                               kAStride);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], bs + kk * kBStride + wn + 16 * j,
                               kBStride);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(cs + (wm + 16 * i) * kCStride + wn + 16 * j,
                              acc[i][j], kCStride, wmma::mem_row_major);
  __syncthreads();
  for (int idx = tid; idx < kBM * kBN / 2; idx += kThreads) {
    const int r = idx / (kBN / 2), c = 2 * (idx % (kBN / 2));
    *reinterpret_cast<__nv_bfloat162*>(out + (long long)(m0 + r) * n + n0 +
                                       c) =
        __floats2bfloat162_rn(cs[r * kCStride + c], cs[r * kCStride + c + 1]);
  }
}

}  // namespace

// a (m, k), b (k, n), out (m, n), all bf16 row-major and 16-byte aligned;
// m % 64 == n % 64 == k % 32 == 0; 1 <= reps <= 65535.
extern "C" int mhada_mm_probe(const void* a, const void* b, void* out, int m,
                              int k, int n, int reps, void* stream) {
  if (m % kBM || n % kBN || k % kBK || reps < 1 || reps > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(n / kBN, m / kBM, reps);
  mm_probe_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(a),
      static_cast<const __nv_bfloat16*>(b), static_cast<__nv_bfloat16*>(out),
      m, k, n);
  return (int)cudaGetLastError();
}
