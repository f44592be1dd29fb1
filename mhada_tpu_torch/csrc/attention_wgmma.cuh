// The bf16 attention tile: a warp-specialised wgmma + TMA kernel of N
// queries against M keys and values, optionally split over the keys
// (attention_combine.cuh).  It serves K1 (self-attention on the packed
// qkv), K6's forward (the same, also writing the row log-sum-exp) and K1's
// cross form (a rank's queries against the keys and values gathered over
// the ranks).
//
// Replaces, at bf16, mhada_tpu/ops/attention_pallas.py::_tm_kernel
// (attention_pallas_tm, pallas_call at attention_pallas.py:154) and
// _tm_res_kernel (_attn_tm_fwd_impl, pallas_call at :236); through K1 and
// K6 the TPU's K9 (attention_stream_wide, :624) and K12's forwards
// (_attention_pallas_call, :62; _attn_stream_fwd_impl, :488), which the JAX
// ViT attention also reaches under sequence parallelism
// (mhada_tpu/models/layers.py:204-212).  Per (b, h):
//
//   S   = Q K^T in float32, times `scale` (applied to the float32 scores,
//         as _kernel does after its product); keys >= M set to -inf
//   P   = online softmax of S, rounded to bf16 before the product (the row
//         sum takes P before rounding, as the JAX denominators do,
//         attention_pallas.py:110-117, 193-200)
//   out = (P V) / l in float32, rounded once to bf16
//   lse = m ln 2 + log l, float32 in natural-log units (K6's backward reads
//         it), when the caller passes a pointer for it
//
// with Q read from rows of q_rs elements (a column slice of the packed qkv
// qualifies) and K and V from one tensor side by side in rows of kv_rs
// (the self form: q = qkv at q_rs = 3C, kv = qkv + C at kv_rs = 3C).
// ops/attention_kernel.py::attention_plain, attention_cross_plain and
// ops/attention_train.py::attention_train_fwd_plain are the plain versions.
//
// Bound: 4 N M d flops per head (34.4 GFLOP at N = M = 4096, 8 heads: 0.035
// ms at the bf16 tensor-core rate) against (2 N + 2 M) C bf16 values
// moved: operations.  The exps are as many as the products' k-steps allow:
// 4096 a 64-key tile and consumer against 2 x 64 x 64 x 64 x 2 flops, so at
// 16 MUFU.EX2 a clock an SM the softmax takes as long as the tensor cores
// (about 768 clocks a tile of three consumers each) unless it runs under
// them.
//
// Design: P2's pieces (mhada_wgmma.cuh, hopper_async.cuh) with V alone in
// place of [V | V^2] and a scale.  A block of four warpgroups owns kRows =
// 192 queries of one (b, h) and one split's range of 64-key tiles:
// - Producer (the last warpgroup, setmaxnreg.dec to kProducerRegs): one
//   thread keeps TMA loads of K and V in flight, each a 64-key x 64-channel
//   box of a 3-D tensor map (C, M, B) at row stride kv_rs in the 128-byte
//   swizzle; a box past M is zero-filled inside its own batch.  Ring of
//   kStages stages of (K, V), 16 KB each; a full barrier (TMA transaction
//   bytes) and an empty barrier (one arrival per consumer warp) a stage.
// - Three consumers (setmaxnreg.inc to kConsumerRegs) own 64 queries each:
//   Q's tile by cp.async into a padded tile, then its A fragments by
//   ldmatrix, held in registers for the whole walk.  Per tile: S = Q K^T
//   by wgmma m64n64k16 (A = Q from registers, B = the K tile K-major; the
//   first k-step writes S without reading it), O += P V by wgmma m64n64k16
//   (A = P from registers: the m64nN accumulator of S is, per warp, the
//   m16n8k16 accumulator layout, so its bf16 pairs are P's A fragments; B =
//   the V tile MN-major).  S (32 registers) and O (32) stay float32.
// - The consumers issue their products in turn (named barriers, round
//   robin), each one's softmax running while the others' products do;
//   within a consumer, turn j issues tile j's S and tile j - 1's P V.  A
//   register that a product reads (P's and Q's A fragments, S, O) is
//   written only between a wgmma.wait_group and the next wgmma.fence, and
//   S's first k-step does not read S: otherwise ptxas serialises every
//   product (C7513).
// - Epilogue: unsplit (kSplit false), O / l rounded to bf16 and, with a.lse,
//   the lse for rows < N; split, the float32 partials (m_s in log2 units,
//   l_s, O_s) for the combine, which also forms the lse.
//
// Registers: 3 x 128 x kConsumerRegs + 128 x kProducerRegs = 65,536, the
// block's allocation at 128 a thread (__launch_bounds__(512, 1)).  Shared
// memory: the ring, three Q tiles, the barriers: 93 KB; one block an SM
// (the registers), 132 block slots on an H100.
#pragma once

#include <math.h>
#include <stdint.h>

#include "attention_combine.cuh"
#include "common.cuh"
#include "flash_mma.cuh"
#include "hopper_async.cuh"

namespace mhada {
namespace xwg {

using bf16 = __nv_bfloat16;

constexpr int kConsumers = 3;
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kRows = 64 * kConsumers;          // queries of a block
constexpr int kStages = 4;
constexpr int kTileBytes = 64 * 64 * 2;         // one 64 x 64 bf16 box
constexpr int kStageBytes = 2 * kTileBytes;     // K, V
constexpr int kConsumerRegs = 152, kProducerRegs = 56;
static_assert(kConsumers * 128 * kConsumerRegs + 128 * kProducerRegs <=
                  65536 / kThreads / 8 * 8 * kThreads,
              "setmaxnreg must stay within the block's allocation");
// Byte offsets from the 1024-aligned base of shared memory.
constexpr int kQOff = kStages * kStageBytes;    // per consumer: Q tile
constexpr int kBarOff = kQOff + kConsumers * mma::kMmaTileBytes;
constexpr size_t kSmemBytes = kBarOff + 2 * kStages * 8 + 1024;
// Named barriers (0 is __syncthreads): consumer w's own (kBarOwn + w) and
// its turn to issue products (kBarTurn + w).
constexpr int kBarOwn = 1, kBarTurn = 1 + kConsumers;

struct XArgs {
  const bf16* q;     // (B, N, rows of q_rs): head h at h*64
  bf16* out;         // (B, N, C)
  float* lse;        // (B, heads, N) natural-log row lse, or null
  long long q_rs;
  int n, m, channels;
  float scale;
};

template <bool kSplit>
__global__ void __launch_bounds__(kThreads, 1)
    attention_wgmma_kernel(const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap,
                           XArgs a, xsplit::Partials part) {
  using namespace mma;
  using namespace wg;
  extern __shared__ unsigned char smem_raw[];
  // The 128-byte swizzle repeats every 1024 bytes: align the base to it.
  unsigned char* smem = smem_raw + (1024 - smem_addr(smem_raw) % 1024) % 1024;
  const uint32_t base = smem_addr(smem);
  const uint32_t bars = base + kBarOff;
  // full: K and V arrived (TMA bytes); empty: every consumer warp released
  // the stage.
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int role = warp / 4;   // a consumer below kConsumers, or the producer
  const int h = blockIdx.y, b = blockIdx.z;
  const int N = a.n, M = a.m, C = a.channels;
  const int qblocks = (N + kRows - 1) / kRows;
  const int split = blockIdx.x / qblocks, qb = blockIdx.x % qblocks;
  const int tiles = (M + 63) / 64;
  const int t0 = xsplit::split_first(split, part.splits, tiles);
  const int ntiles = xsplit::split_first(split + 1, part.splits, tiles) - t0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (role == kConsumers) {
    // ---- producer: one thread issues the TMA loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp == 4 * kConsumers && lane == 0) {
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % kStages;
        // stage s is free once every consumer released tile j - kStages
        if (j >= kStages) mbar_wait_or_trap(empty(s), ((j / kStages) & 1) ^ 1);
        const uint32_t kt = base + s * kStageBytes;
        mbar_expect_tx(full(s), 2 * kTileBytes);
        tma_load_3d(kt, &kmap, full(s), h * 64, (t0 + j) * 64, b);
        tma_load_3d(kt + kTileBytes, &vmap, full(s), h * 64, (t0 + j) * 64, b);
      }
    }
    return;
  }

  // ---- consumer `role`: 64 queries
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int tid = threadIdx.x % 128, w = warp % 4;
  const int g = lane / 4, t = lane % 4;
  const int q0 = qb * kRows + role * 64;
  const int hoff = h * 64;
  bf16* qs = reinterpret_cast<bf16*>(smem + kQOff) + role * kMmaTileElems;
  const bf16* qbase = a.q + static_cast<long long>(b) * N * a.q_rs + hoff;

  // Q's rows (rows past N zero), then its A fragments.
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int i = tid + 128 * j;
    const int r = i / 8, c = (i % 8) * 8;
    const bool valid = q0 + r < N;
    cp_async_16(smem_addr(qs + r * kMmaStride + c),
                qbase + (valid ? (q0 + r) * a.q_rs + c : 0), valid);
  }
  cp_async_commit();
  cp_async_wait<0>();
  named_sync(kBarOwn + role, 128);
  uint32_t qf[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    ldmatrix_x4(qf[kk], a_addr(qs, w * 16, kk * 16));

  // S: element e of n8 tile n is s[4 n + e], row g + 8 (e / 2) of the
  // warp's 16, key 8 n + 2 t + e % 2 of the tile.  O: the same layout over
  // the head's 64 channels.
  float s[32], o[32];
  float mrow[2] = {-INFINITY, -INFINITY}, lrow[2] = {0.f, 0.f};
  uint32_t pf[4][4];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;

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
      wgmma_m64n64k16_rs<1>(o, p[kk], sw128_desc(vt + 2048 * kk, kTileBytes,
                                                 1024), 1);
  };
  // Online softmax of walk tile j's scores: s becomes P (float32); alpha
  // is the factor by which O must be rescaled before P V is added.  The row
  // maximum m is kept in log2 units of the scaled scores: the raw maximum
  // times the scale (the same float32 value as the maximum of the scaled
  // scores, the scale being positive: the launch refuses any other), so
  // that each exponent, s sl2 - m, is one FFMA (5-8 % faster than a
  // multiply a score in probes/attention_wgmma_ablate.py on an H100).
  // Only the ragged last tile of the keys can hold keys past M.
  const float sl2 = a.scale * kLog2e;
  auto softmax = [&](int j, float (&alpha)[2]) {
    const int k0 = 64 * (t0 + j);
    const bool ragged = k0 + 64 > M;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if (ragged && k0 + 8 * (i / 4) + 2 * t + (i % 2) >= M)
        s[i] = -INFINITY;
      mx[(i % 4) / 2] = fmaxf(mx[(i % 4) / 2], s[i]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // finite: key k0 < M is in every tile
      const float m_new = fmaxf(mrow[r], quad_max(mx[r]) * sl2);
      alpha[r] = exp2_ftz(mrow[r] - m_new);
      mrow[r] = m_new;
      lrow[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float e = exp2_ftz(fmaf(s[i], sl2, -mrow[(i % 4) / 2]));
      lrow[(i % 4) / 2] += e;
      s[i] = e;
    }
  };
  // P rounded to bf16 into its A fragments (k-step kk: keys 16 kk..).
  // Only while no product is in flight (C7513).
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
  auto rescale = [&](const float (&alpha)[2]) {
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] *= alpha[(i % 4) / 2];
    }
  };
  // consumer role's turn, and the next consumer's
  const int turn = kBarTurn + role;
  const int next = kBarTurn + (role + 1) % kConsumers;
  const bool last = role == kConsumers - 1;

  // Consumers issue in turn, 0 first; each takes ntiles + 1 turns.  In
  // turn j it issues tile j's S and tile j - 1's P V, then runs tile j's
  // softmax while the products run.  O is rescaled between the two
  // issues, and not at all when no row maximum of the warp moved.
  float alpha[2];
  if (last) named_arrive(kBarTurn, 256);
  mbar_wait_or_trap(full(0), 0);
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
    mbar_wait_or_trap(full(st), (j / kStages) & 1);
    named_sync(turn, 256);
    fence_frags(qf);
    wgmma_fence();
    issue_s(st);
    wgmma_commit();
    rescale(alpha);
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
  rescale(alpha);
  fence_regs(o);
  fence_frags(pf);
  wgmma_fence();
  issue_pv(sl, pf);
  wgmma_commit();
  if (!last) named_arrive(next, 256);   // the next consumer's last turn
  wgmma_wait<0>();
  fence_regs(o);
  release(sl);

  // Epilogue: element 2 r + (0, 1) of n8 tile n is row g + 8 r, channels
  // 8 n + 2 t and 8 n + 2 t + 1.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + w * 16 + g + 8 * r;
    const float l = quad_sum(lrow[r]);
    if (row >= N) continue;
    if constexpr (kSplit) {
      float* orow = part.o(split, b, row) + hoff;
#pragma unroll
      for (int n = 0; n < 8; ++n)
        *reinterpret_cast<float2*>(orow + 8 * n + 2 * t) =
            make_float2(o[4 * n + 2 * r], o[4 * n + 2 * r + 1]);
      if (t == 0) {
        const long long at = part.stat(split, b, h, row);
        part.m()[at] = mrow[r];
        part.l()[at] = l;
      }
    } else {
      bf16* orow = a.out + (static_cast<long long>(b) * N + row) * C + hoff;
#pragma unroll
      for (int n = 0; n < 8; ++n)
        *reinterpret_cast<uint32_t*>(orow + 8 * n + 2 * t) =
            pack_bf16(o[4 * n + 2 * r] / l, o[4 * n + 2 * r + 1] / l);
      if (a.lse != nullptr && t == 0)
        a.lse[(static_cast<long long>(b) * gridDim.y + h) * N + row] =
            mrow[r] * kLn2 + logf(l);
    }
  }
}

// kv: (B, M, rows of kv_rs) with K at 0 and V at C; pointers 16-byte
// aligned, C and the row strides multiples of 8, C = 64 heads, a.scale >
// 0; a.lse null or (B, heads, N) float32.  splits > 1: the partials
// (xsplit::partial_floats floats), then the combine (and the lse).
inline cudaError_t launch_attention_wgmma(const XArgs& a, const void* kv,
                                          long long kv_rs, int heads,
                                          int batch, int splits, float* part,
                                          cudaStream_t stream) {
  const int tiles = (a.m + 63) / 64;
  if (a.n < 1 || a.m < 1 || splits < 1 || splits > tiles || !(a.scale > 0.f) ||
      a.channels != 64 * heads || a.q_rs % 8 || kv_rs % 8 ||
      !mma_aligned({a.q, kv, a.out}, a.channels) ||
      (splits > 1 && (part == nullptr || !mma_aligned({part}, 8))))
    return cudaErrorInvalidValue;
  CUtensorMap kmap, vmap;
  const bf16* k = static_cast<const bf16*>(kv);
  if (!wg::kv_tensor_map(&kmap, k, batch, a.m, a.channels, kv_rs) ||
      !wg::kv_tensor_map(&vmap, k + a.channels, batch, a.m, a.channels,
                         kv_rs))
    return cudaErrorInvalidValue;
  auto* kernel = splits > 1 ? attention_wgmma_kernel<true>
                            : attention_wgmma_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return err;
  const xsplit::Partials p{part, splits, batch, a.n, a.channels, heads};
  const dim3 grid((a.n + kRows - 1) / kRows * splits, heads, batch);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(kmap, vmap, a, p);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  return xsplit::launch_combine<bf16>(p, a.out, stream, a.lse);
}

// K1 and K6's forward: self-attention on the packed (B, L, 3C) qkv (Q, K
// and V of head h at channels h*64, C + h*64 and 2C + h*64, rows of 3C),
// out (B, L, C); lse null (K1) or (B, heads, L) float32 (K6).
inline cudaError_t launch_self_attention_wgmma(const void* qkv, void* out,
                                               float* lse, int batch, int seq,
                                               int channels, int heads,
                                               int splits, float* part,
                                               float scale,
                                               cudaStream_t stream) {
  XArgs a{};
  a.q = static_cast<const bf16*>(qkv);
  a.out = static_cast<bf16*>(out);
  a.lse = lse;
  a.q_rs = 3LL * channels;
  a.n = a.m = seq;
  a.channels = channels;
  a.scale = scale;
  return launch_attention_wgmma(a, a.q + channels, 3LL * channels, heads,
                                batch, splits, part, stream);
}

}  // namespace xwg
}  // namespace mhada
