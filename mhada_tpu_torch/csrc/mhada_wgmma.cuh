// The MHAda tile at bf16 as a warp-specialised wgmma + TMA kernel, each
// consumer's softmax running under the other consumers' products: K3, K4,
// the probe P2 and K7's forward (kRes: its epilogue also stores M1, E2 and
// the row lse), optionally split over the keys (mhada_combine.cuh).
//
// Replaces, at bf16, mhada_tpu/ops/mhada_pallas.py::mhada_fused_prologue
// (K3: _fused_kernel, pallas_call at mhada_pallas.py:239), which the JAX
// AdaAttnMultiHead runs on cached style K/V (mhada_tpu/models/
// adaformer.py:80-97), and _mhada_pallas_fwd_impl (K4: _kernel,
// pallas_call at mhada_pallas.py:114; through K4 also the TPU's K10
// forward without residuals, :622); _tm_res_kernel (K7's forward,
// _mhada_tm_fwd_impl, pallas_call at :336; through K7 the TPU's K10 with
// its residuals, :622); and scripts/mhada_pipe_probe.py::
// _pipe_kernel (P2, pallas_call at mhada_pipe_probe.py:112), the TPU probe
// that ordered two heads' work so that one head's vector work could hide
// under the other's matrix-unit work, whose function is K3's.  Per (b, h),
// with every tensor token-major and head h at channels [h*64, (h+1)*64),
// and the JAX kernels' rounding points (mhada_pallas.py:63-72, 182-191):
//
//   K3, P2 (kPrologue):
//       qn  = (fc - mean_fc) * rstd_fc              float32, rounded to bf16
//       q   = qn Wf_h + fb_h                        float32, rounded to bf16
//   K4, K7: q given
//   S   = q K^T, UNSCALED; keys >= M set to -inf
//   P   = online softmax of S, rounded to bf16 before the product (the row
//         sum takes P before rounding); V^2 = each bf16 squared, rounded
//   M1  = (P V) / l,  E2 = (P V^2) / l          float32, divided after
//   out = sqrt(max(E2 - M1^2, 1e-6)) * f + M1, rounded to bf16, with
//         f = IN(fcs) (K3, P2: from raw fcs and the stats) or fcs_n (K4,
//         K7)
//   K7 (kRes) also: M1 and E2 (float32, (B, N, C)) and lse = m + log l
//         with m the unscaled row maximum ((B, heads, N) float32), from
//         the values out is made of, so that its out is K4's bit for bit
//
// ops/mhada_prologue.py::mhada_fused_prologue_plain,
// ops/mhada_kernel.py::mhada_tm_plain and
// ops/mhada_train.py::mhada_train_fwd_plain are the plain versions.
//
// Bound: 6 N M d flops per head (K3 and P2 add 2 N d^2 for the projection;
// 414.5 GFLOP at B = 8, N = M = 4096, 8 heads: 0.419 ms at the bf16
// tensor-core rate) against (3 N + 2 M) C bf16 values moved: operations.
//
// Design (Hopper's asynchronous units).  A block of four warpgroups owns
// kRows = 192 queries of one (b, h) and streams its range of keys in tiles
// of 64:
// - Producer (the last warpgroup, registers lowered to kProducerRegs by
//   setmaxnreg.dec): one thread keeps TMA loads of K and V in flight, each
//   a 64-key x 64-channel box of a 3-D tensor map (C, M, B) in the 128-byte
//   swizzle (a 64-wide bf16 row is 128 bytes).  A box past M is zero-filled
//   inside its own batch (a 2-D (B M, C) view would read the next batch's
//   keys); zero keys give S = 0, so the mask stays.  The other three warps
//   square each V tile into a V^2 tile at V's offsets (elementwise, so the
//   swizzle carries over), fence the generic writes for the async proxy
//   and arrive on the stage's full barrier.
// - Ring: kStages stages of (K, V, V^2), 24 KB each; a landed barrier (TMA
//   transaction bytes; the squarers wait on it), a full barrier (the
//   squarers; the consumers' one wait a tile) and an empty barrier (one
//   arrival per consumer warp).
// - Three consumers (registers raised to kConsumerRegs by setmaxnreg.inc)
//   own 64 queries each and share every K/V tile read from L2 (two
//   consumers are slower: probes/mhada_wgmma_ablate.py times both).  With
//   kPrologue each runs K3's prologue for its rows: fc and Wf_h by
//   cp.async into padded tiles, fc normalised in place, q = qn Wf_h + fb_h
//   on mma.sync (flash_mma.cuh), rounded straight into q's A fragments; q
//   never reaches memory.  Without it (K4) q's rows arrive by cp.async in
//   the same padded tile and its A fragments by ldmatrix.  Per tile: S = q
//   K^T by wgmma m64n64k16 (A = q from registers, B = the K tile, K-major;
//   the first k-step writes S without reading it), O = P [V | V^2] by wgmma
//   m64n128k16 (A = P from registers: the m64nN accumulator of S is, per
//   warp, the m16n8k16 accumulator layout, so its bf16 pairs are P's A
//   fragments; B = V and V^2 as one MN-major operand, the two tiles
//   kTileBytes apart as the descriptor's leading byte offset).  S (32
//   registers), O1 and O2 (64) stay float32.
// - Overlap: the consumers issue their products in turn (named barriers,
//   round robin), so that each one's softmax runs while the others'
//   products do.  Within a consumer, turn j issues tile j's S and tile
//   j - 1's P V and runs tile j's softmax after wgmma.wait_group 1; but
//   ptxas places the wait for P V at the start of the softmax, before its
//   row maximum, so the exps run after it (SASS of P2's build).  A register
//   that a product reads (P's A fragments, S, O) is written only between a
//   wait and the next wgmma.fence, and S's first k-step does not read S:
//   otherwise ptxas serialises every product (C7513).
// - Unsplit, the epilogue divides by the row sum, takes f (K3: IN(fcs)
//   from raw fcs and the stats; K4: fcs_n), clamps the variance and writes
//   bf16 pairs; f's rows (and K3's stats) land by cp.async in the
//   prologue's tiles during the key loop.
// - Split over the keys (kSplit): at B = 1 a grid of one block a (b, h,
//   query block) leaves SMs idle (512^2: 176 blocks on 132 SMs, a second
//   wave a third full; an SP rank's 1024 queries: 48 blocks), and a
//   partial wave costs a full one.  So each (b, h, query block) takes
//   `splits` blocks, each walking one contiguous range of whole 64-key
//   tiles (blockIdx.x = split x query blocks + query block) and writing
//   float32 partials for its rows (m in log2 units, l, unnormalised O1 and
//   O2); P is rounded against the split's own running maximum.
//   mhada_combine.cuh's kernel, launched by the same entry on the same
//   stream, combines them in a fixed order and applies the epilogue.
//   ops/mhada_kernel.py::mhada_splits picks the count.
//
// Registers: 3 x 128 x kConsumerRegs + 128 x kProducerRegs = 65,536, the
// block's allocation at 128 a thread (__launch_bounds__(512, 1)).  Shared
// memory: the ring, three q (fc) and three Wf_h tiles, the barriers:
// 155 KB, one block an SM: 132 block slots on an H100.
#pragma once

#include <math.h>
#include <stdint.h>

#include "attention_combine.cuh"
#include "common.cuh"
#include "flash_mma.cuh"
#include "hopper_async.cuh"
#include "mhada_combine.cuh"

namespace mhada {
namespace wg {

using bf16 = __nv_bfloat16;

constexpr int kConsumers = 3;
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kRows = 64 * kConsumers;          // queries of a block
constexpr int kStages = 4;
constexpr int kTileBytes = 64 * 64 * 2;         // one 64 x 64 bf16 box
constexpr int kStageBytes = 3 * kTileBytes;     // K, V, V^2
constexpr int kSquarers = 96;                   // producer warps 1-3
constexpr int kConsumerRegs = 160, kProducerRegs = 32;
constexpr int kSquares = (kTileBytes / 16 + kSquarers - 1) / kSquarers;
static_assert(kSquares % 2 == 0, "the squarers take two passes");
static_assert(kConsumers * 128 * kConsumerRegs + 128 * kProducerRegs <=
                  65536 / kThreads / 8 * 8 * kThreads,
              "setmaxnreg must stay within the block's allocation");
// Byte offsets from the 1024-aligned base of shared memory.
constexpr int kFcOff = kStages * kStageBytes;   // per consumer: q (fc) tile
constexpr int kWfOff = kFcOff + kConsumers * mma::kMmaTileBytes;
constexpr int kBarOff = kWfOff + kConsumers * mma::kMmaTileBytes;
constexpr size_t kSmemBytes = kBarOff + 3 * kStages * 8 + 1024;
// Named barriers (0 is __syncthreads): consumer w's own (kBarOwn + w) and
// its turn to issue products (kBarTurn + w).
constexpr int kBarOwn = 1, kBarTurn = 1 + kConsumers;

struct WgArgs {
  const bf16* q;         // K3, P2: raw fc; K4: q (B, N, C)
  const bf16* f;         // K3, P2: raw fcs; K4: fcs_n (B, N, C)
  const float* stats;    // K3, P2: (B, 4, C): mean_fc, rstd_fc, mean_fcs,
                         // rstd_fcs
  const bf16* wf;        // K3, P2: (heads, 64, 64) as (in, out)
  const float* fb;       // K3, P2: (heads, 64)
  bf16* out;             // (B, N, C)
  float* m1;             // kRes (K7): M1, E2 (B, N, C) and the row lse
  float* e2;             // (B, heads, N), float32; otherwise null
  float* lse;
  int n, m, channels;
};

// d[0..63] (+)= a b: m64n128k16, A (bf16) from registers in the
// m16n8k16 A layout of each warp's 16 rows, B from shared memory by
// descriptor; kTransB: B is MN-major.  scale_d = 0 overwrites d.
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64],
                                          const uint32_t (&a)[4],
                                          uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d),
        "n"(kTransB));
}

// The producer warpgroup of the K / V ring (the block's last warpgroup,
// its registers already lowered): warp 0's first thread keeps TMA loads of
// the key tiles [t0, t0 + ntiles) of head h, batch b in flight, K and V
// each a 64-key x 64-channel box of a 3-D tensor map (C, M, B) in the
// 128-byte swizzle, zero-filled past M; warps 1-3 square each V tile into
// the stage's V^2 tile and arrive on its full barrier.  Stage s of the ring
// sits at s * kStageBytes from the 1024-aligned `smem`; its barriers at
// `bars` (a shared address): landed, full, empty, kStages each.  The MHAda
// tile and K7's dQ kernel (mhada_bwd_wgmma.cuh) share it.
__device__ __forceinline__ void kv_producer(const CUtensorMap* kmap,
                                            const CUtensorMap* vmap,
                                            unsigned char* smem, uint32_t bars,
                                            int h, int b, int t0, int ntiles) {
  using namespace mma;
  const uint32_t base = smem_addr(smem);
  auto landed = [&](int s) { return bars + 8 * s; };
  auto full = [&](int s) { return bars + 8 * (kStages + s); };
  auto empty = [&](int s) { return bars + 8 * (2 * kStages + s); };
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  if (warp == 0) {
    if (lane == 0) {
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % kStages;
        // stage s is free once every consumer released tile j - kStages
        if (j >= kStages) mbar_wait(empty(s), ((j / kStages) & 1) ^ 1);
        const uint32_t kt = base + s * kStageBytes;
        mbar_expect_tx(landed(s), 2 * kTileBytes);
        tma_load_3d(kt, kmap, landed(s), h * 64, (t0 + j) * 64, b);
        tma_load_3d(kt + kTileBytes, vmap, landed(s), h * 64, (t0 + j) * 64,
                    b);
      }
    }
    return;
  }
  const int i0 = threadIdx.x % 128 - 32;
  for (int j = 0; j < ntiles; ++j) {
    const int s = j % kStages;
    mbar_wait(landed(s), (j / kStages) & 1);
    unsigned char* stage = smem + s * kStageBytes;
    const uint4* v = reinterpret_cast<const uint4*>(stage + kTileBytes);
    uint4* v2 = reinterpret_cast<uint4*>(stage + 2 * kTileBytes);
    // two passes of kSquares / 2 chunks, each pass's loads in flight
    // together (the producer keeps few registers)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      uint4 x[kSquares / 2];
#pragma unroll
      for (int u = 0; u < kSquares / 2; ++u) {
        const int i = i0 + (half * kSquares / 2 + u) * kSquarers;
        if (i < kTileBytes / 16) x[u] = v[i];
      }
#pragma unroll
      for (int u = 0; u < kSquares / 2; ++u) {
        const int i = i0 + (half * kSquares / 2 + u) * kSquarers;
        x[u].x = square_bf16x2(x[u].x);
        x[u].y = square_bf16x2(x[u].y);
        x[u].z = square_bf16x2(x[u].z);
        x[u].w = square_bf16x2(x[u].w);
        if (i < kTileBytes / 16) v2[i] = x[u];
      }
    }
    // the generic-proxy writes, visible to the products' async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_arrive(full(s));
  }
}

// part: kSplit's partials (attention_combine.cuh's layout with channels =
// 2 C; see mhada_combine.cuh); unsplit, part.splits = 1 and it is unused.
// kRes (K7's forward, unsplit): the epilogue also stores M1, E2 and the
// row lse (a.m1, a.e2, a.lse); split, the combine does.
template <bool kPrologue, bool kSplit, bool kRes = false>
__global__ void __launch_bounds__(kThreads, 1)
    mhada_wgmma_kernel(const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap, WgArgs a,
                       xsplit::Partials part) {
  using namespace mma;
  extern __shared__ unsigned char smem_raw[];
  // The 128-byte swizzle repeats every 1024 bytes: align the base to it.
  unsigned char* smem = smem_raw + (1024 - smem_addr(smem_raw) % 1024) % 1024;
  const uint32_t base = smem_addr(smem);
  const uint32_t bars = base + kBarOff;
  // landed: K and V arrived (TMA bytes); full: V^2 written too (the
  // squarers); empty: every consumer warp released the stage.
  auto landed = [&](int s) { return bars + 8 * s; };
  auto full = [&](int s) { return bars + 8 * (kStages + s); };
  auto empty = [&](int s) { return bars + 8 * (2 * kStages + s); };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int role = warp / 4;   // a consumer below kConsumers, or the producer
  const int h = blockIdx.y, b = blockIdx.z;
  const int N = a.n, M = a.m, C = a.channels;
  // This block's query block and its split's key tiles [t0, t0 + ntiles).
  const int qblocks = (N + kRows - 1) / kRows;
  const int split = kSplit ? blockIdx.x / qblocks : 0;
  const int qb = kSplit ? blockIdx.x % qblocks : blockIdx.x;
  const int tiles = (M + 63) / 64;
  const int t0 = kSplit ? xsplit::split_first(split, part.splits, tiles) : 0;
  const int ntiles =
      kSplit ? xsplit::split_first(split + 1, part.splits, tiles) - t0
             : tiles;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(landed(s), 1);
      mbar_init(full(s), kSquarers);
      mbar_init(empty(s), 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (role == kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    kv_producer(&kmap, &vmap, smem, bars, h, b, t0, ntiles);
  } else {
    // ---- consumer `role`: 64 queries
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int tid = threadIdx.x % 128, w = warp % 4;
    const int g = lane / 4, t = lane % 4;
    const int q0 = qb * kRows + role * 64;
    const int hoff = h * 64;
    bf16* qs = reinterpret_cast<bf16*>(smem + kFcOff) + role * kMmaTileElems;
    bf16* ws = reinterpret_cast<bf16*>(smem + kWfOff) + role * kMmaTileElems;
    const bf16* qbase = a.q + static_cast<long long>(b) * N * C + hoff;
    const float* mean = a.stats + static_cast<long long>(b) * 4 * C + hoff;
    const float* rstd = mean + C;

    // The q rows (K3: raw fc; rows past N zero) and K3's Wf_h.
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = tid + 128 * j;
      const int r = i / 8, c = (i % 8) * 8;
      const bool valid = q0 + r < N;
      cp_async_16(smem_addr(qs + r * kMmaStride + c),
                  qbase + (valid ? static_cast<long long>(q0 + r) * C + c : 0),
                  valid);
      if (kPrologue)
        cp_async_16(smem_addr(ws + r * kMmaStride + c),
                    a.wf + hoff * 64 + r * 64 + c, true);
    }
    cp_async_commit();
    cp_async_wait<0>();
    named_sync(kBarOwn + role, 128);
    uint32_t qf[4][4];
    if constexpr (kPrologue) {
      // qn = (fc - mean_fc) * rstd_fc in float32, rounded to bf16 in place
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = tid + 128 * j;
        const int r = i / 8, c = (i % 8) * 8;
        uint4* p = reinterpret_cast<uint4*>(qs + r * kMmaStride + c);
        uint4 chunk = *p;
        __nv_bfloat162* x = reinterpret_cast<__nv_bfloat162*>(&chunk);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 raw = __bfloat1622float2(x[e]);
          const int ch = c + 2 * e;
          x[e] = __floats2bfloat162_rn((raw.x - mean[ch]) * rstd[ch],
                                       (raw.y - mean[ch + 1]) * rstd[ch + 1]);
        }
        *p = chunk;
      }
      named_sync(kBarOwn + role, 128);
      // q = qn Wf_h + fb_h in float32, rounded to bf16 into q's A fragments
      uint32_t xf[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        ldmatrix_x4(xf[kk], a_addr(qs, w * 16, kk * 16));
      float acc[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          uint32_t r[4];
          ldmatrix_x4_trans(r, bt_addr(ws, kk * 16, p * 16));
          mma_16816(acc[2 * p], xf[kk], r[0], r[1]);
          mma_16816(acc[2 * p + 1], xf[kk], r[2], r[3]);
        }
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float2 bias =
            *reinterpret_cast<const float2*>(a.fb + hoff + 8 * n + 2 * t);
        acc[n][0] += bias.x;
        acc[n][1] += bias.y;
        acc[n][2] += bias.x;
        acc[n][3] += bias.y;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        acc_to_a(qf[kk], acc[2 * kk], acc[2 * kk + 1]);
    } else {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        ldmatrix_x4(qf[kk], a_addr(qs, w * 16, kk * 16));
    }
    // Unsplit, the epilogue's inputs land during the key loop: f's rows
    // (K3: raw fcs; K4: fcs_n) into the q tile and K3's mean_fcs and
    // rstd_fcs of the head into Wf_h's tile, once every warp of the
    // consumer has read both.
    float* fstat = reinterpret_cast<float*>(ws);   // [mean 64][rstd 64]
    if constexpr (!kSplit) {
      named_sync(kBarOwn + role, 128);
      const bf16* fbase = a.f + static_cast<long long>(b) * N * C + hoff;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = tid + 128 * j;
        const int r = i / 8, c = (i % 8) * 8;
        const bool valid = q0 + r < N;
        cp_async_16(
            smem_addr(qs + r * kMmaStride + c),
            fbase + (valid ? static_cast<long long>(q0 + r) * C + c : 0),
            valid);
      }
      if (kPrologue && tid < 32) {   // mean_fcs (threads 0-15), then
        const int half = tid / 16, q = 4 * (tid % 16);   // rstd_fcs
        cp_async_16(smem_addr(fstat + 64 * half + q),
                    mean + (2 + half) * C + q, true);
      }
      cp_async_commit();
    }

    // S: element e of n8 tile n is s[4 n + e], row g + 8 (e / 2) of the
    // warp's 16, key 8 n + 2 t + e % 2.  O: n8 tiles 0-7 are M1's channels
    // (P V), 8-15 E2's (P V^2).
    float s[32], o[64];
    float mrow[2] = {-INFINITY, -INFINITY}, lrow[2] = {0.f, 0.f};
    uint32_t pf[4][4];
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = 0.f;

    auto issue_s = [&](int st) {
      const uint32_t kt = base + st * kStageBytes;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {   // channels 16 kk..: 32 bytes a step
        const uint64_t desc = sw128_desc(kt + 32 * kk, 16, 1024);
        if (kk == 0)
          wgmma_m64n64k16_rs_first<0>(s, qf[0], desc);
        else
          wgmma_m64n64k16_rs<0>(s, qf[kk], desc, 1);
      }
    };
    auto issue_pv = [&](int st, const uint32_t (&p)[4][4]) {
      const uint32_t vt = base + st * kStageBytes + kTileBytes;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)   // keys 16 kk..: 16 rows of 128 bytes
        wgmma_m64n128k16_rs<1>(
            o, p[kk], sw128_desc(vt + 2048 * kk, kTileBytes, 1024), 1);
    };
    // Online softmax of walk tile j's scores: s becomes P (float32); alpha
    // is the factor by which O must be rescaled before P V is added.  The
    // row maximum is kept unscaled; exponents in log2 units, one FFMA each.
    // Only the ragged last tile of the keys can hold keys past M: the
    // others skip the mask.
    auto softmax = [&](int j, float (&alpha)[2]) {
      const int k0 = 64 * (t0 + j);
      const bool ragged = k0 + 64 > M;
      float mx[2] = {-INFINITY, -INFINITY};
      if (ragged) {
#pragma unroll
        for (int i = 0; i < 32; ++i)
          if (k0 + 8 * (i / 4) + 2 * t + (i % 2) >= M) s[i] = -INFINITY;
      }
#pragma unroll
      for (int i = 0; i < 32; ++i)
        mx[(i % 4) / 2] = fmaxf(mx[(i % 4) / 2], s[i]);
      float mb[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // finite: key k0 < M is in every tile
        const float m_new = fmaxf(mrow[r], quad_max(mx[r]));
        alpha[r] = exp2_ftz((mrow[r] - m_new) * kLog2e);
        mrow[r] = m_new;
        mb[r] = -m_new * kLog2e;
        lrow[r] *= alpha[r];
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const float e = exp2_ftz(fmaf(s[i], kLog2e, mb[(i % 4) / 2]));
        lrow[(i % 4) / 2] += e;
        s[i] = e;
      }
    };
    // P rounded to bf16 into its A fragments (k-step kk: keys 16 kk..).
    // Only while no product is in flight: a definition of an A register
    // inside an open wgmma group serialises every product (C7513).
    auto pack_p = [&]() {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        pf[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
        pf[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pf[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pf[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
    };
    auto release = [&](int st) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(st));
    };
    // consumer role's turn, and the next consumer's
    const int turn = kBarTurn + role;
    const int next = kBarTurn + (role + 1) % kConsumers;
    const bool last = role == kConsumers - 1;

    // Consumers issue in turn, 0 first; each takes ntiles + 1 turns.  In
    // turn j it issues tile j's S and tile j - 1's P V, then runs tile j's
    // softmax while the products run.  O is rescaled between the two
    // issues, so that only P's packing needs P V to have finished, and not
    // at all when no row maximum of the warp moved (a warp vote).
    float alpha[2];
    if (last) named_arrive(kBarTurn, 256);
    mbar_wait(full(0), 0);
    named_sync(turn, 256);
    fence_frags(qf);
    wgmma_fence();
    issue_s(0);
    wgmma_commit();
    named_arrive(next, 256);
    wgmma_wait<0>();
    fence_regs(s);
    softmax(0, alpha);
    pack_p();
    for (int j = 1; j < ntiles; ++j) {
      const int st = j % kStages, sp = (j - 1) % kStages;
      mbar_wait(full(st), (j / kStages) & 1);   // also tile j - 1's V^2
      named_sync(turn, 256);
      fence_frags(qf);
      wgmma_fence();
      issue_s(st);
      wgmma_commit();
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int i = 0; i < 64; ++i) o[i] *= alpha[(i % 4) / 2];
      }
      fence_regs(o);
      fence_frags(pf);
      wgmma_fence();
      issue_pv(sp, pf);
      wgmma_commit();
      named_arrive(next, 256);
      wgmma_wait<1>();   // S of tile j; P V of tile j - 1 may still run
      fence_regs(s);
      softmax(j, alpha);
      wgmma_wait<0>();
      fence_regs(o);
      fence_frags(pf);
      release(sp);
      pack_p();
    }
    const int sl = (ntiles - 1) % kStages;
    named_sync(turn, 256);
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int i = 0; i < 64; ++i) o[i] *= alpha[(i % 4) / 2];
    }
    fence_regs(o);
    fence_frags(pf);
    wgmma_fence();
    issue_pv(sl, pf);
    wgmma_commit();
    if (!last) named_arrive(next, 256);   // the next consumer's last turn
    wgmma_wait<0>();
    fence_regs(o);
    release(sl);

    // Epilogue: element 2 r + (0, 1) of n8 tile n is row g + 8 r,
    // channels 8 n + 2 t and 8 n + 2 t + 1.
    if constexpr (kSplit) {
      // the float32 partials: O1 and O2 unnormalised, m in log2 units
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = q0 + w * 16 + g + 8 * r;
        const float l = quad_sum(lrow[r]);
        if (row >= N) continue;
        float* orow = part.o(split, b, row) + hoff;   // O1; O2 C further
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          *reinterpret_cast<float2*>(orow + 8 * n + 2 * t) =
              make_float2(o[4 * n + 2 * r], o[4 * n + 2 * r + 1]);
          *reinterpret_cast<float2*>(orow + C + 8 * n + 2 * t) =
              make_float2(o[32 + 4 * n + 2 * r], o[32 + 4 * n + 2 * r + 1]);
        }
        if (t == 0) {
          const long long at = part.stat(split, b, h, row);
          part.m()[at] = mrow[r] * kLog2e;
          part.l()[at] = l;
        }
      }
    } else {
      cp_async_wait<0>();   // f (and K3's stats), for every thread
      named_sync(kBarOwn + role, 128);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = q0 + w * 16 + g + 8 * r;
        const float l = quad_sum(lrow[r]);
        if (row >= N) continue;
        const bf16* frow = qs + (w * 16 + g + 8 * r) * kMmaStride;
        bf16* orow = a.out + (static_cast<long long>(b) * N + row) * C + hoff;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const float m1x = o[4 * n + 2 * r] / l;
          const float m1y = o[4 * n + 2 * r + 1] / l;
          const float e2x = o[32 + 4 * n + 2 * r] / l;
          const float e2y = o[32 + 4 * n + 2 * r + 1] / l;
          const int ch = 8 * n + 2 * t;
          if constexpr (kRes) {
            const long long at = (static_cast<long long>(b) * N + row) * C +
                                 hoff + ch;
            *reinterpret_cast<float2*>(a.m1 + at) = make_float2(m1x, m1y);
            *reinterpret_cast<float2*>(a.e2 + at) = make_float2(e2x, e2y);
          }
          float2 f = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(frow + ch));
          if (kPrologue) {   // IN(fcs) from raw fcs and the stats
            f.x = (f.x - fstat[ch]) * fstat[64 + ch];
            f.y = (f.y - fstat[ch + 1]) * fstat[64 + ch + 1];
          }
          // E2 - M1^2 cancels: both stay float32 until the clamp.
          const float sdx = sqrtf(fmaxf(e2x - m1x * m1x, 1e-6f));
          const float sdy = sqrtf(fmaxf(e2y - m1y * m1y, 1e-6f));
          *reinterpret_cast<uint32_t*>(orow + ch) =
              pack_bf16(sdx * f.x + m1x, sdy * f.y + m1y);
        }
        // lse = m + log l: the row maximum is kept unscaled
        if (kRes && t == 0)
          a.lse[(static_cast<long long>(b) * gridDim.y + h) * N + row] =
              mrow[r] + logf(l);
      }
    }
  }
}

// k, v (B, M, C); every pointer 16-byte aligned, C = 64 heads; 1 <= splits
// <= ceil(M / 64).  splits > 1: the split tile into `part`, which holds
// xsplit::partial_floats(splits, batch, n, 2 C, heads) floats (16-byte
// aligned), then the combine into a.out on the same stream.  kRes: a.m1,
// a.e2 (16-byte aligned) and a.lse take the residuals, from the unsplit
// epilogue or the combine.
template <bool kPrologue, bool kRes = false>
inline cudaError_t launch_mhada_wgmma(const WgArgs& a, const void* k,
                                      const void* v, int batch, int heads,
                                      int splits, float* part,
                                      cudaStream_t stream) {
  const int tiles = (a.m + 63) / 64;
  if (a.n < 1 || a.m < 1 || splits < 1 || splits > tiles ||
      a.channels != 64 * heads ||
      !mma_aligned({a.q, a.f, a.out, k, v}, a.channels) ||
      (kPrologue && !mma_aligned({a.wf}, a.channels)) ||
      (kRes && (a.lse == nullptr || !mma_aligned({a.m1, a.e2}, 8))) ||
      (splits > 1 && (part == nullptr || !mma_aligned({part}, 8))))
    return cudaErrorInvalidValue;
  CUtensorMap kmap, vmap;
  if (!kv_tensor_map(&kmap, k, batch, a.m, a.channels, a.channels) ||
      !kv_tensor_map(&vmap, v, batch, a.m, a.channels, a.channels))
    return cudaErrorInvalidValue;
  const xsplit::Partials p{part, splits, batch, a.n, 2 * a.channels, heads};
  const dim3 grid((a.n + kRows - 1) / kRows * splits, heads, batch);
  auto* kernel = splits > 1 ? mhada_wgmma_kernel<kPrologue, true>
                            : mhada_wgmma_kernel<kPrologue, false, kRes>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(kmap, vmap, a, p);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  return launch_mhada_combine<kPrologue>(p, a.f, a.stats, a.out, a.m1, a.e2,
                                         a.lse, stream);
}

}  // namespace wg
}  // namespace mhada
