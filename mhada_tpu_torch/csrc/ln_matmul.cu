// K2: LayerNorm fused into the following matmul, out = LN(x) W^T + b.
//
// Replaces mhada_tpu/ops/ln_matmul_pallas.py::_ln_matmul_pallas
// (_ln_matmul_kernel, pallas_call at ln_matmul_pallas.py:44): the ViT's
// ln1 -> qkv (512 -> 1536) and ln2 -> fc1 (512 -> 2048) projections.  The
// normalised tensor never reaches device memory, which is the point of the
// TPU kernel (ln_matmul_pallas.py:1-13).
//
// bfloat16 runs on the tensor cores (ln_matmul_wgmma.cuh: a warp-
// specialised wgmma + TMA GEMM whose A tile is the LN, written once into
// shared memory in the swizzled layout the products read).  The kernel
// below is the float32 build, which computes in float32 on the CUDA cores
// (no TF32): 2 N E F flops (6.4 + 8.6 GFLOP at N = 4096) at 67 TFLOP/s
// bound it.  A resident h does not fit at float32 (128 x 512 x 4 bytes is
// 256 KB), so it is a register-tiled SGEMM with the LN split off the main
// loop:
// 1. statistics first: each warp takes whole rows, mean and then the mean
//    of (x - mean)^2 in float32 (the second pass re-reads the row, which
//    the first has just brought into L1), into shared memory;
// 2. main loop over k-chunks of kBK = 8: each thread loads one float4 of x
//    and one of W, normalises and applies the affine to x as it stores the
//    chunk k-major into shared memory, W k-major beside it; both double-
//    buffered, the next chunk's loads in flight while this one's products
//    run;
// 3. each of the 256 threads takes an 8 x 8 outer product per k from
//    float4 shared reads, in a 128 x 128 block tile; registers are capped
//    at 128 so that two blocks share an SM.
// The float32 build takes any E: h is never held whole.
//
// ln_w, ln_b and the bias are read in T and widened in the kernels: the
// values the JAX kernel widens (ln_matmul_pallas.py:70-73).

#include "common.cuh"
#include "ln_matmul_wgmma.cuh"

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 8, kThreads = 256;
constexpr int kLd = kBM + 4;   // k-major rows: conflict-free transposed stores
static_assert(kBM == kBN, "one loader mapping serves x and W");

struct F32Args {
  const float* x;      // (rows, e)
  const float* ln_w;   // (e,)
  const float* ln_b;   // (e,)
  const float* w;      // (f, e)
  const float* bias;   // (f,)
  float* out;          // (rows, f)
  int rows, e, f;
  float eps;
  bool vec_in;         // e % 4 == 0, x and w 16-byte aligned
  bool vec_out;        // f % 4 == 0, out 16-byte aligned
};

// p[k..k+3], zero past e: one float4 load where the row allows it.
__device__ __forceinline__ float4 load4(const float* p, int k, int e,
                                        bool vec) {
  if (vec && k + 3 < e) return __ldg(reinterpret_cast<const float4*>(p + k));
  float4 v;
  v.x = k < e ? __ldg(p + k) : 0.f;
  v.y = k + 1 < e ? __ldg(p + k + 1) : 0.f;
  v.z = k + 2 < e ? __ldg(p + k + 2) : 0.f;
  v.w = k + 3 < e ? __ldg(p + k + 3) : 0.f;
  return v;
}

__global__ void __launch_bounds__(kThreads, 2)
    ln_matmul_f32_kernel(const F32Args a) {
  __shared__ __align__(16) float hs[2][kBK][kLd];   // h, k-major
  __shared__ __align__(16) float ws[2][kBK][kLd];   // W, k-major
  __shared__ float mean_s[kBM], rstd_s[kBM];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int r0 = blockIdx.y * kBM, c0 = blockIdx.x * kBN;
  const float inv_e = 1.f / a.e;

  // 1. the rows' statistics (rows past the end: mean 0, rstd 0)
  for (int r = warp; r < kBM; r += kThreads / 32) {
    const int row = r0 + r;
    float mean = 0.f, rstd = 0.f;
    if (row < a.rows) {
      const float* xr = a.x + (long long)row * a.e;
      float sum = 0.f;
      for (int k = 4 * lane; k < a.e; k += 128) {
        const float4 v = load4(xr, k, a.e, a.vec_in);
        sum += (v.x + v.y) + (v.z + v.w);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      mean = sum * inv_e;
      float sq = 0.f;
      for (int k = 4 * lane; k < a.e; k += 128) {
        const float4 v = load4(xr, k, a.e, a.vec_in);
        const float d0 = k < a.e ? v.x - mean : 0.f;
        const float d1 = k + 1 < a.e ? v.y - mean : 0.f;
        const float d2 = k + 2 < a.e ? v.z - mean : 0.f;
        const float d3 = k + 3 < a.e ? v.w - mean : 0.f;
        sq += (d0 * d0 + d1 * d1) + (d2 * d2 + d3 * d3);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sq += __shfl_xor_sync(0xffffffffu, sq, off);
      rstd = rsqrtf(sq * inv_e + a.eps);
    }
    if (lane == 0) {
      mean_s[r] = mean;
      rstd_s[r] = rstd;
    }
  }
  __syncthreads();

  // 2. loader: thread t brings row / column lr, k-offsets kq..kq+3
  const int lr = tid / 2, kq = (tid % 2) * 4;
  const bool xvalid = r0 + lr < a.rows, wvalid = c0 + lr < a.f;
  const float* xp = a.x + (long long)(xvalid ? r0 + lr : 0) * a.e;
  const float* wp = a.w + (long long)(wvalid ? c0 + lr : 0) * a.e;
  const float mean = mean_s[lr], rstd = rstd_s[lr];
  // the chunk's x, W and LN affine (which need not be aligned)
  float4 xv, wv, lwv, lbv;
  auto load = [&](int k0) {
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    xv = xvalid ? load4(xp, k0 + kq, a.e, a.vec_in) : z;
    wv = wvalid ? load4(wp, k0 + kq, a.e, a.vec_in) : z;
    lwv = load4(a.ln_w, k0 + kq, a.e, false);
    lbv = load4(a.ln_b, k0 + kq, a.e, false);
  };
  auto store = [&](int buf, int k0) {
    const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
    const float gs[4] = {lwv.x, lwv.y, lwv.z, lwv.w};
    const float bs[4] = {lbv.x, lbv.y, lbv.z, lbv.w};
    const float wsv[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool in = xvalid && k0 + kq + j < a.e;
      hs[buf][kq + j][lr] = in ? (xs[j] - mean) * rstd * gs[j] + bs[j] : 0.f;
      ws[buf][kq + j][lr] = wsv[j];
    }
  };

  // 3. 8 x 8 per thread: rows ty*4 + i and 64 + ty*4 + i, columns alike
  const int tx = tid % 16, ty = tid / 16;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  load(0);
  store(0, 0);
  __syncthreads();
  int buf = 0;
  for (int k0 = 0; k0 < a.e; k0 += kBK) {
    const bool more = k0 + kBK < a.e;
    if (more) load(k0 + kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&hs[buf][kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&hs[buf][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&ws[buf][kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&ws[buf][kk][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (more) store(buf ^ 1, k0 + kBK);
    __syncthreads();
    buf ^= 1;
  }

  // epilogue: + bias, float4 stores where the row allows them
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = r0 + (i / 4) * 64 + ty * 4 + i % 4;
    if (row >= a.rows) continue;
    float* orow = a.out + (long long)row * a.f;
#pragma unroll
    for (int cg = 0; cg < 2; ++cg) {
      const int col = c0 + cg * 64 + tx * 4;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = acc[i][cg * 4 + j] + (col + j < a.f ? a.bias[col + j] : 0.f);
      if (a.vec_out && col + 3 < a.f) {
        *reinterpret_cast<float4*>(orow + col) =
            make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (col + j < a.f) orow[col + j] = v[j];
      }
    }
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// x (rows, e), ln_w, ln_b (e,), w (f, e), bias (f,) and out (rows, f) with
// rows ldo elements apart, all in T.  float32: ldo == f.  bfloat16: e % 8
// == 0, e <= 640, ldo a multiple of 4, x, w and out 16-byte aligned, and
// the block's column tiles and ring stages from
// ops/ln_matmul.py::launch_plan (float32 ignores them).
extern "C" int mhada_ln_matmul(const void* x, const void* ln_w,
                               const void* ln_b, const void* w,
                               const void* bias, void* out, int rows, int e,
                               int f, float eps, int dtype, int ldo,
                               int tiles_per_block, int stages,
                               void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype == mhada::kF32) {
    if (ldo != f) return (int)cudaErrorInvalidValue;
    F32Args a{static_cast<const float*>(x), static_cast<const float*>(ln_w),
              static_cast<const float*>(ln_b), static_cast<const float*>(w),
              static_cast<const float*>(bias), static_cast<float*>(out),
              rows, e, f, eps,
              e % 4 == 0 && aligned16(x) && aligned16(w),
              f % 4 == 0 && aligned16(out)};
    const dim3 grid((f + kBN - 1) / kBN, (rows + kBM - 1) / kBM);
    ln_matmul_f32_kernel<<<grid, kThreads, 0, st>>>(a);
    return (int)cudaGetLastError();
  }
  if (dtype != mhada::kBF16 || !mhada::mma_aligned({x, w, out}, e))
    return (int)cudaErrorInvalidValue;
  using bf16 = __nv_bfloat16;
  mhada::lnwg::LnWgArgs a{
      static_cast<const bf16*>(ln_w), static_cast<const bf16*>(ln_b),
      static_cast<const bf16*>(bias), nullptr, 0, rows, e, f, eps,
      tiles_per_block, stages};
  return (int)mhada::lnwg::launch_ln_matmul_wgmma(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<bf16*>(out), ldo, a, st);
}
