// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel is templated on its storage type T (float or
// __nv_bfloat16) and accumulates in float32.  Each exported entry point has
// a plain C signature (pointers, ints, floats, the stream) so that the
// Python side binds it with ctypes, launches on the caller's stream,
// allocates nothing, and returns cudaGetLastError() as an int.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace mhada {

enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Round a float32 value to T and back: models the point where the plain
// PyTorch path stores a stage's output in T.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// Mirror index i into [0, n) (ReflectionPad2d for an overshoot < n), then
// clamp: positions that no in-image output reads only need to stay finite.
__device__ __forceinline__ int reflect_index(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * n - 2 - i;
  return max(0, min(n - 1, i));
}

// Opt a kernel into more than 48 KB of dynamic shared memory, then launch.
template <typename Kernel, typename... Args>
inline cudaError_t launch_with_smem(Kernel kernel, dim3 grid, dim3 block,
                                    size_t smem, cudaStream_t stream,
                                    Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, block, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace mhada

// Instantiate BODY with T bound to the storage type named by `dtype`.
#define MHADA_DISPATCH_DTYPE(dtype, T, BODY)         \
  do {                                               \
    if ((dtype) == mhada::kF32) {                    \
      using T = float;                               \
      BODY;                                          \
    } else if ((dtype) == mhada::kBF16) {            \
      using T = __nv_bfloat16;                       \
      BODY;                                          \
    }                                                \
    return (int)cudaErrorInvalidValue;               \
  } while (0)
