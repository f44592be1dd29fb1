// The strip walk of K13's two builds (decoder_c6_f32.cuh,
// decoder_c6_mma.cuh), and the ring of c5 window rows the float32 build
// walks it with, filled by the TMA unit.
//
// A block owns kCols output columns and a strip of kStrip output rows and
// computes 2 rows a step; step s reads window rows 2s .. 2s + 3 (window row
// r is image row y0 - 1 + r, reflected, then clamped; window column c is
// image column x0 - 1 + c).  The ring holds kSlots rows, row r in slot r %
// kSlots.  Once step s is past rows 2s and 2s + 1 (a barrier mid-step),
// their slots take rows 2s + 6 and 2s + 7 for step s + 2, so two steps'
// rows are in flight while a step computes.
//
// A row lies as in device memory, pixel-major, so one thread lands it with
// one 1-D bulk copy of its columns inside the image, plus one of a pixel
// for each reflected halo column (image column 1 for column -1, W - 2 for
// W), all completing on the slot's mbarrier, which every thread waits on
// before it reads the row.  No thread waits for its own copies: a build in
// which every thread issued 16-byte cp.async copies ran its copies and its
// arithmetic one after the other, at about half the card's bandwidth, and
// one with a bulk copy a pixel was slower still (the TMA unit takes tens
// of cycles a request).  Window columns past image column W hold stale
// values: no stored pixel reads them.
#pragma once

#include <stdint.h>

#include "common.cuh"
#include "flash_mma.cuh"     // mma::smem_addr
#include "hopper_async.cuh"  // wg::mbar_*, wg::bulk_load

namespace mhada {
namespace c6 {

constexpr int kCols = 64;          // output columns a block
constexpr int kStrip = 16;         // output rows a block, 2 a step
constexpr int kWinC = kCols + 2;   // window columns, with the halo
constexpr int kSlots = 6;          // window rows held
constexpr int kBarBytes = 64;      // the slots' mbarriers, before the rows

// float32 c5 rows, 64 channels a pixel.
struct RowRing {
  static constexpr int kPixBytes = 64 * sizeof(float);
  static constexpr int kSlotBytes = kWinC * kPixBytes;
  static constexpr size_t kSmem = kBarBytes + kSlots * kSlotBytes;
  static_assert(kSlots * 8 <= kBarBytes, "a barrier a slot");

  char* smem;        // the block's dynamic shared memory
  const char* src;   // the image's c5
  int h, wd, x0, y0;

  __device__ uint32_t bar(int r) const {
    return mma::smem_addr(smem) + 8 * (r % kSlots);
  }
  // Window row r, pixel-major, as a generic pointer.
  __device__ const char* row(int r) const {
    return smem + kBarBytes + (r % kSlots) * kSlotBytes;
  }
  // Thread 0 initialises the barriers; the caller then syncs the block.
  __device__ void init() const {
    if (threadIdx.x == 0) {
      for (int i = 0; i < kSlots; ++i) wg::mbar_init(bar(i), 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
  }
  // One thread: window row r into its slot.
  __device__ void issue(int r) const {
    const char* image_row =
        src + (long long)reflect_index(y0 - 1 + r, h) * wd * kPixBytes;
    const uint32_t dst = mma::smem_addr(row(r)), b = bar(r);
    const int lo = max(x0 - 1, 0), hi = min(x0 + kCols + 1, wd);
    const bool left = x0 == 0, right = hi - (x0 - 1) < kWinC;
    wg::mbar_expect_tx(b, (hi - lo + left + right) * kPixBytes);
    wg::bulk_load(dst + (lo - (x0 - 1)) * kPixBytes,
                  image_row + (long long)lo * kPixBytes,
                  (hi - lo) * kPixBytes, b);
    if (left) wg::bulk_load(dst, image_row + kPixBytes, kPixBytes, b);
    if (right)
      wg::bulk_load(dst + (wd - (x0 - 1)) * kPixBytes,
                    image_row + (long long)(wd - 2) * kPixBytes, kPixBytes,
                    b);
  }
  // Every thread: wait until window row r has landed.
  __device__ void wait(int r) const {
    wg::mbar_wait_or_trap(bar(r), (r / kSlots) & 1);
  }
};

}  // namespace c6
}  // namespace mhada
