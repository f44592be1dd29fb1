// The pieces that the warp-specialised flash backwards on wgmma share: K7's
// (mhada_bwd_wgmma.cuh) and K6's (attention_bwd_wgmma.cuh).  Their
// consumer warpgroups issue their products in turns, and feed the bf16
// rounding of an m64nN accumulator to a register-A product.
#pragma once

#include <stdint.h>

#include "flash_mma.cuh"

namespace mhada {
namespace wg {

// Consumer `role`'s turns among `consumers`, on the named barriers first,
// first + 1, ... (one a consumer): the products of a turn are issued while
// the other consumers' elementwise work runs.
struct Turns {
  int turn, next;
  bool last;
  __device__ Turns(int role, int consumers, int first)
      : turn(first + role),
        next(first + (role + 1) % consumers),
        last(role == consumers - 1) {}
};

// An m64nN accumulator x rounded to bf16 into the A fragments of N / 16
// k-steps (k-step kk: columns 16 kk..): the m64nN accumulator is, per warp,
// the m16n8k16 accumulator layout, so its bf16 pairs are A fragments.
template <int kSteps>
__device__ __forceinline__ void pack_frags(uint32_t (&f)[kSteps][4],
                                           const float (&x)[8 * kSteps]) {
  using mma::pack_bf16;
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    f[kk][0] = pack_bf16(x[8 * kk], x[8 * kk + 1]);
    f[kk][1] = pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
    f[kk][2] = pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
    f[kk][3] = pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

}  // namespace wg
}  // namespace mhada
