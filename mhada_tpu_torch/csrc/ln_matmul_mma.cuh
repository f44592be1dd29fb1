// The bf16 K2 on the tensor cores: out = round(LN(x) W^T + b), with the
// LayerNorm as the GEMM's prologue.
//
// Replaces, at bf16, mhada_tpu/ops/ln_matmul_pallas.py::_ln_matmul_pallas
// (_ln_matmul_kernel, pallas_call at ln_matmul_pallas.py:44) with its
// numerics: the row statistics in float32, two-pass (the mean, then the
// mean of (x - mean)^2, then rsqrt(var + eps)); the affine in float32; h
// rounded once to bf16 before the product (ln_matmul_pallas.py:30); the
// product accumulated in float32; the float32 bias added to the
// accumulator; one rounding of the sum to bf16.  The LN is not folded into
// the epilogue algebraically: that would drop the rounding of h and cancel
// when |mean| is large.
//
// Bound: 2 N E F flops (6.4 + 8.6 GFLOP for the 1536- and 2048-wide calls
// at N = 4096, E = 512) against N (E + F) + E F bf16 of traffic:
// compute-bound at the tensor-core rate.
//
// Design.  A block of 8 warps owns kBM = 128 rows and a group of output
// column tiles of kBN = 128: as many groups per row tile as fill the 132
// SMs once (N = 4096: 4 groups of 3 or 4 tiles, 128 blocks; N >= 16384:
// every column tile in one block), so that one LN serves every column
// tile of the group.
// - Prologue.  The block's x rows go by 16-byte cp.async straight into the
//   resident A tile (kBM x (E_k + 8) bf16, E_k = E rounded up to the
//   k-chunk; 130 KB at E = 512), all in flight at once, and the first W
//   stages of the ring after them, so that those land while the
//   statistics run.  Each warp then takes whole rows, two at a time, reads
//   its row chunks from shared memory into float32 registers for both
//   passes, and overwrites them with the affine h rounded to bf16.  The
//   16-byte row pad keeps ldmatrix free of bank conflicts.  Columns past E
//   are zero; rows past the end become the affine's bias, which is never
//   stored.  The normalised tensor never reaches device memory: the point
//   of the TPU kernel (ln_matmul_pallas.py:1-13).
// - Main loop.  W (F, E) is nn.Linear's (out, in): its rows are output
//   columns, contiguous along k, so the stage tile is n-major and
//   ldmatrix without .trans gives the B fragments, as K's do for S = Q K^T
//   in flash_mma.cuh.  Chunks of kBN x 64 go through a kStages-deep ring
//   (16-byte cp.async, zero fill past F and E).  Warps are 4 x 2 over the
//   block tile, 32 rows x 64 columns each: per k-step two A fragments from
//   the resident tile, four B ldmatrix_x4 from the stage, 16 m16n8k16
//   products with float32 accumulators.  The ring runs on from one column
//   tile into the next.
// - Epilogue, after each column tile's last chunk.  The bias (bf16,
//   widened) is added to the accumulators, the sums rounded once and
//   stored as bf16 pairs (single values where F is odd, masked past F and
//   the last row).
//
// Shared memory: the A tile plus kStages x 18 KB; at E_k = 640 that is
// 216 KB, the most one block may take, so the bf16 build takes E <= 640.
// Requires E % 8 == 0 and 16-byte-aligned x and W (mma_aligned).
#pragma once

#include <stdint.h>

#include <algorithm>

#include "common.cuh"
#include "flash_mma.cuh"

namespace mhada {
namespace lnmm {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kBM = 128, kBN = 128, kBK = 64;
constexpr int kStages = 3;
constexpr int kMaxE = 640;
// 16-byte chunks of a row per lane in the prologue (kMaxE / 8 / 32).
constexpr int kRowChunks = (kMaxE / 8 + 31) / 32;
constexpr int kRowsAtOnce = 2;   // rows a warp normalises together
constexpr int kWStageElems = kBN * mma::kMmaStride;

__host__ __device__ inline int padded_e(int e) {
  return (e + kBK - 1) / kBK * kBK;
}

inline size_t smem_bytes(int e) {
  return sizeof(bf16) * ((size_t)kBM * (padded_e(e) + 8) +
                         (size_t)kStages * kWStageElems);
}

struct LnMmArgs {
  const bf16* x;      // (rows, e)
  const bf16* ln_w;   // (e,)
  const bf16* ln_b;   // (e,)
  const bf16* w;      // (f, e)
  const bf16* bias;   // (f,)
  bf16* out;          // (rows, f)
  int rows, e, f;
  float eps;
  int tiles_per_block;   // column tiles of kBN a block runs (the launcher's)
};

// W chunk `kc` (output columns c0.., k = kc * kBK..) into a ring stage.
__device__ __forceinline__ void load_w_chunk(bf16* stage, const LnMmArgs& a,
                                             int c0, int kc) {
#pragma unroll
  for (int j = 0; j < kBN * kBK / 8 / kThreads; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int r = i / (kBK / 8), cc = (i % (kBK / 8)) * 8;
    const int col = c0 + r, k = kc * kBK + cc;
    const bool valid = col < a.f && k < a.e;
    const bf16* src = a.w + (valid ? (long long)col * a.e + k : 0);
    mma::cp_async_16(mma::smem_addr(stage + r * mma::kMmaStride + cc), src,
                     valid);
  }
}

// The x rows r0.. into the A tile with 16-byte cp.async (zero past the
// last row and past E, up to E_k).
__device__ __forceinline__ void load_x_tile(bf16* at, int as, int ek,
                                            const LnMmArgs& a, int r0) {
  const int cek = ek / 8;
  for (int i = threadIdx.x; i < kBM * cek; i += kThreads) {
    const int r = i / cek, c = (i % cek) * 8;
    const bool valid = r0 + r < a.rows && c < a.e;
    const bf16* src = a.x + (valid ? (long long)(r0 + r) * a.e + c : 0);
    mma::cp_async_16(mma::smem_addr(at + r * as + c), src, valid);
  }
}

// Eight bf16 of a 16-byte chunk, widened.
__device__ __forceinline__ void unpack8(const uint4& v, float (&f)[8]) {
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = mma::unpack_bf16(u[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

// The LN in place on the landed x tile: warp `warp` turns rows warp, warp
// + kWarps, ... into h, kRowsAtOnce rows at a time (independent shuffle
// chains); each lane reads, and overwrites, only its own 16-byte chunks.
// Rows past the end hold zeros and become the affine's bias: finite, and
// never stored.
__device__ __forceinline__ void ln_in_place(bf16* at, int as,
                                            const LnMmArgs& a) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int ce = a.e / 8;   // 16-byte chunks of a row
  const float inv_e = 1.f / a.e;
  // this lane's columns of the LN affine, packed bf16
  uint4 gw[kRowChunks], gb[kRowChunks];
#pragma unroll
  for (int j = 0; j < kRowChunks; ++j) {
    const int c = lane + 32 * j;
    gw[j] = gb[j] = make_uint4(0, 0, 0, 0);
    if (c < ce) {   // 2-byte reads: the affine need not be aligned
      const auto* pw = reinterpret_cast<const uint16_t*>(a.ln_w) + 8 * c;
      const auto* pb = reinterpret_cast<const uint16_t*>(a.ln_b) + 8 * c;
      uint32_t uw[4], ub[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uw[i] = pw[2 * i] | (uint32_t)pw[2 * i + 1] << 16;
        ub[i] = pb[2 * i] | (uint32_t)pb[2 * i + 1] << 16;
      }
      gw[j] = make_uint4(uw[0], uw[1], uw[2], uw[3]);
      gb[j] = make_uint4(ub[0], ub[1], ub[2], ub[3]);
    }
  }
  for (int r = warp; r < kBM; r += kWarps * kRowsAtOnce) {
    float xf[kRowsAtOnce][kRowChunks][8];
    float sum[kRowsAtOnce], sq[kRowsAtOnce];
#pragma unroll
    for (int q = 0; q < kRowsAtOnce; ++q) {
      sum[q] = 0.f;
#pragma unroll
      for (int j = 0; j < kRowChunks; ++j) {
        const int c = lane + 32 * j;
        const uint4 v = c < ce ? *reinterpret_cast<const uint4*>(
                                     at + (r + q * kWarps) * as + 8 * c)
                               : make_uint4(0, 0, 0, 0);
        unpack8(v, xf[q][j]);
#pragma unroll
        for (int i = 0; i < 8; ++i) sum[q] += xf[q][j][i];
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int q = 0; q < kRowsAtOnce; ++q)
        sum[q] += __shfl_xor_sync(0xffffffffu, sum[q], off);
#pragma unroll
    for (int q = 0; q < kRowsAtOnce; ++q) {
      sum[q] *= inv_e;   // the mean
      sq[q] = 0.f;
#pragma unroll
      for (int j = 0; j < kRowChunks; ++j) {
        if (lane + 32 * j >= ce) continue;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float d = xf[q][j][i] - sum[q];
          sq[q] += d * d;
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int q = 0; q < kRowsAtOnce; ++q)
        sq[q] += __shfl_xor_sync(0xffffffffu, sq[q], off);
#pragma unroll
    for (int q = 0; q < kRowsAtOnce; ++q) {
      const float mean = sum[q], rstd = rsqrtf(sq[q] * inv_e + a.eps);
#pragma unroll
      for (int j = 0; j < kRowChunks; ++j) {
        const int c = lane + 32 * j;
        if (c >= ce) continue;
        const uint32_t uw[4] = {gw[j].x, gw[j].y, gw[j].z, gw[j].w};
        const uint32_t ub[4] = {gb[j].x, gb[j].y, gb[j].z, gb[j].w};
        uint32_t u[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 g = mma::unpack_bf16(uw[i]);
          const float2 b = mma::unpack_bf16(ub[i]);
          u[i] = mma::pack_bf16(
              (xf[q][j][2 * i] - mean) * rstd * g.x + b.x,
              (xf[q][j][2 * i + 1] - mean) * rstd * g.y + b.y);
        }
        *reinterpret_cast<uint4*>(at + (r + q * kWarps) * as + 8 * c) =
            make_uint4(u[0], u[1], u[2], u[3]);
      }
    }
  }
}

// The column tiles of one block: tiles_per_block tiles of kBN columns from
// t0 (fewer in the last group), each a run of nk k-chunks.
__global__ void __launch_bounds__(kThreads, 1)
    ln_matmul_mma_kernel(const LnMmArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ek = padded_e(a.e), as = ek + 8;
  bf16* at = reinterpret_cast<bf16*>(smem_raw);   // [kBM][as]
  bf16* ws = at + kBM * as;                        // [kStages][kBN][72]
  const int r0 = blockIdx.y * kBM;
  const int nk = ek / kBK;
  const int t0 = blockIdx.x * a.tiles_per_block;
  const int nq = min(a.tiles_per_block, (a.f + kBN - 1) / kBN - t0) * nk;
  // the load cursor: chunk lq is k-chunk lk of column tile t0 + lt, into
  // ring stage ls
  int lq = 0, lk = 0, lt = 0, ls = 0;
  auto load_next = [&] {
    if (lq < nq) load_w_chunk(ws + ls * kWStageElems, a, (t0 + lt) * kBN, lk);
    mma::cp_async_commit();
    ++lq;
    ls = ls + 1 == kStages ? 0 : ls + 1;
    if (++lk == nk) {
      lk = 0;
      ++lt;
    }
  };

  // x first (the oldest group), then the ring's first stages, which land
  // while the statistics run
  load_x_tile(at, as, ek, a, r0);
  mma::cp_async_commit();
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) load_next();
  mma::cp_async_wait<kStages - 1>();
  __syncthreads();
  ln_in_place(at, as, a);

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wm = (warp % 4) * 32, wn = (warp / 4) * 64;
  const int g = lane / 4, t = lane % 4;
  float acc[2][8][4];
  // the compute cursor: k-chunk kc of column tile t0 + ct, in ring stage cs
  int kc = 0, ct = 0, cs = 0;
  for (int q = 0; q < nq; ++q) {
    if (kc == 0) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 8; ++ni)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mi][ni][i] = 0.f;
    }
    mma::cp_async_wait<kStages - 2>();
    // chunk q has landed for every thread, the A tile is complete, and
    // the stage of chunk q - 1 is free
    __syncthreads();
    load_next();
    const bf16* stage = ws + cs * kWStageElems;
    cs = cs + 1 == kStages ? 0 : cs + 1;
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        mma::ldmatrix_x4(af[mi], mma::a_addr(at, wm + 16 * mi,
                                             kc * kBK + 16 * ks, as));
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        uint32_t bf[4];
        mma::ldmatrix_x4(bf, mma::b_addr(stage, wn + 16 * nj, 16 * ks));
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma::mma_16816(acc[mi][2 * nj], af[mi], bf[0], bf[1]);
          mma::mma_16816(acc[mi][2 * nj + 1], af[mi], bf[2], bf[3]);
        }
      }
    }
    if (++kc < nk) continue;
    kc = 0;

    // the column tile's epilogue: + bias in float32, one rounding, bf16
    // pairs (single values where F is odd)
    const int c0 = (t0 + ct++) * kBN;
    const bool pairs = a.f % 2 == 0;
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      const int col = c0 + wn + 8 * ni + 2 * t;
      if (col >= a.f) continue;
      const bool two = col + 1 < a.f;
      const float b0 = __bfloat162float(a.bias[col]);
      const float b1 = two ? __bfloat162float(a.bias[col + 1]) : 0.f;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = r0 + wm + 16 * mi + g + 8 * h;
          if (row >= a.rows) continue;
          const float v0 = acc[mi][ni][2 * h] + b0;
          const float v1 = acc[mi][ni][2 * h + 1] + b1;
          bf16* o = a.out + (long long)row * a.f + col;
          if (pairs) {
            *reinterpret_cast<uint32_t*>(o) = mma::pack_bf16(v0, v1);
          } else {
            o[0] = __float2bfloat16(v0);
            if (two) o[1] = __float2bfloat16(v1);
          }
        }
      }
    }
  }
  mma::cp_async_wait<0>();
}

// One block per row tile and group of column tiles: as many groups as
// fill the SMs once (at least one, at most one per column tile), so that
// each block's LN serves every column tile of its group.
inline cudaError_t launch_ln_matmul_mma(LnMmArgs a, cudaStream_t stream) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int row_tiles = (a.rows + kBM - 1) / kBM;
  const int col_tiles = (a.f + kBN - 1) / kBN;
  const int groups = std::max(1, std::min(col_tiles, sms / row_tiles));
  a.tiles_per_block = (col_tiles + groups - 1) / groups;
  const dim3 grid((col_tiles + a.tiles_per_block - 1) / a.tiles_per_block,
                  row_tiles);
  return launch_with_smem(ln_matmul_mma_kernel, grid, dim3(kThreads),
                          smem_bytes(a.e), stream, a);
}

}  // namespace lnmm
}  // namespace mhada
