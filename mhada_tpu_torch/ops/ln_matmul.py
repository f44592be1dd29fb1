"""K2: LayerNorm fused into the following matmul (csrc/ln_matmul.cu: at
bfloat16 a warp-specialised wgmma + TMA GEMM whose A tile is the LN, written
once into shared memory, csrc/ln_matmul_wgmma.cuh; at float32 a
register-tiled CUDA-core GEMM), and its VJP.

Port of mhada_tpu/ops/ln_matmul_pallas.py::ln_matmul for the ViT's
ln1 -> qkv and ln2 -> fc1 sites.  ``layer_norm`` is the LayerNorm math of
mhada_tpu/models/layers.py:117-124 (float32 statistics, eps 1e-6); the twin
is that LayerNorm followed by ``F.linear``.

The gradient is ``_ln_matmul_bwd``'s closed form
(ln_matmul_pallas.py:96-121) in plain PyTorch, as the JAX backward is plain
XLA: the LN is recomputed from x in float32 (the normalised tensor is never
saved), dW = h^T g in the compute dtype with float32 accumulation, dh = g W
kept in float32, and the LN gradients in float32, each cast to its input's
dtype.
"""

import functools

import torch
import torch.nn.functional as F

from .. import _build
from ..config import use_kernel

# The bf16 kernel's block (csrc/ln_matmul_wgmma.cuh, the constants of the
# same names): BM rows (64 a consumer warpgroup) against column tiles of BN,
# k steps of BK.  Its BM normalised rows stay resident in shared memory (E_k
# / BK boxes of BM x BK bf16, E_k the E rounded up to BK) beside a ring of W
# stages of BN x BK: E <= 640 fits four stages in the 227 KB a block may
# take.  The float32 kernel takes any E.
MAX_E = 640
BM, BN, BK = 128, 128, 64
BLOCKS_PER_SM = 1
MAX_STAGES = 8
SMEM_PER_SM = 228 * 1024   # an H100's; 1 KB of it reserved a block


def smem_bytes(e: int, stages: int) -> int:
    """The bf16 kernel's dynamic shared memory: the alignment slack, h, the
    ring, the full and empty barriers of each stage and one x barrier a
    consumer (csrc/ln_matmul_wgmma.cuh::smem_bytes)."""
    return (1024 + -(-e // BK) * BM * BK * 2 + stages * BN * BK * 2
            + 8 * (2 * stages + BM // 64))


def launch_plan(rows: int, e: int, f: int, sms: int) -> tuple[int, int]:
    """(column tiles a block, ring stages) of the bf16 kernel.  A row tile's
    column tiles are cut into as many groups as fill the SMs once (at least
    one, at most one a column tile), so that one block's LN serves every
    tile of its group; the ring takes as many stages (2 .. MAX_STAGES) as
    fit beside h."""
    row_tiles, col_tiles = -(-rows // BM), -(-f // BN)
    groups = max(1, min(col_tiles, sms * BLOCKS_PER_SM // max(row_tiles, 1)))
    limit = SMEM_PER_SM // BLOCKS_PER_SM - 1024
    stages = max((s for s in range(2, MAX_STAGES + 1)
                  if smem_bytes(e, s) <= limit), default=2)
    return -(-col_tiles // groups), stages


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _ln_stats(x: torch.Tensor, eps: float):
    """(x - mean) / std in float32, and 1 / std."""
    xf = x.float()
    xc = xf - xf.mean(dim=-1, keepdim=True)
    rsig = torch.rsqrt(xc.square().mean(dim=-1, keepdim=True) + eps)
    return xc * rsig, rsig


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis with float32 statistics, in x's dtype."""
    y = _ln_stats(x, eps)[0]
    return (y * weight.float() + bias.float()).to(x.dtype)


def ln_matmul_plain(x, ln_w, ln_b, w, b, eps: float = 1e-6) -> torch.Tensor:
    """LN(x) @ w.T + b; x (B, N, E), w (F, E) as in nn.Linear, b (F,)."""
    h = layer_norm(x, ln_w, ln_b, eps)
    return F.linear(h, w.to(h.dtype), b.to(h.dtype))


def _ln_matmul_kernel(x, ln_w, ln_b, w, b, eps):
    """The launch: all five inputs in x's dtype (the kernel widens the LN
    affine and the bias to float32 itself)."""
    e, f = x.shape[-1], w.shape[0]
    bf16 = x.dtype == torch.bfloat16
    if bf16 and (e % 8 or e > MAX_E):
        raise ValueError(f"ln_matmul: the bfloat16 kernel takes E a "
                         f"multiple of 8 and <= {MAX_E}, got {e}")
    _build.check_cuda_inputs("ln_matmul", x, ln_w, ln_b, w, b)
    rows = x.numel() // e
    # the bf16 kernel stores 4 columns at a time, 8-byte aligned: for F % 4
    # != 0 it writes a buffer 4-padded and the wrapper copies the F columns
    # out
    ldo, plan = f, (0, 0)   # the float32 kernel has no plan
    if bf16:
        _build.check_aligned("ln_matmul", x, w)
        ldo, plan = -(-f // 4) * 4, launch_plan(rows, e, f,
                                                _sm_count(x.device))
    out = torch.empty((*x.shape[:-1], ldo), device=x.device, dtype=x.dtype)
    _build.launch("mhada_ln_matmul", x.device, x, ln_w, ln_b, w, b, out,
                  rows, e, f, float(eps), _build.dtype_code(x), ldo, *plan)
    return out if ldo == f else out[..., :f].contiguous()


def ln_matmul_bwd(x, ln_w, ln_b, w, g, eps: float = 1e-6):
    """_ln_matmul_bwd (ln_matmul_pallas.py:96-121) for x (..., E), w (F, E)
    and the output cotangent g (..., F) -> (dx, d ln_w, d ln_b, dw, db),
    each in its input's dtype (db in w's)."""
    e = x.shape[-1]
    hn, rsig = _ln_stats(x, eps)
    h = (hn * ln_w.float() + ln_b.float()).to(x.dtype)
    g2 = g.to(x.dtype).reshape(-1, g.shape[-1])
    # the compute dtype's product, float32 accumulation, rounded once
    dw = (g2.transpose(0, 1) @ h.reshape(-1, e)).to(w.dtype)
    db = g2.float().sum(0).to(w.dtype)
    # preferred_element_type=f32: dh is not rounded to the compute dtype
    dh = (g2.float() @ w.float()).reshape(hn.shape)
    dims = tuple(range(hn.dim() - 1))
    d_lnw = (dh * hn).sum(dims).to(ln_w.dtype)
    d_lnb = dh.sum(dims).to(ln_b.dtype)
    dhn = dh * ln_w.float()
    dx = rsig * (dhn - dhn.mean(-1, keepdim=True)
                 - hn * (dhn * hn).mean(-1, keepdim=True))
    return dx.to(x.dtype), d_lnw, d_lnb, dw, db


class _LnMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln_w, ln_b, w, b, eps, kernel):
        fwd = _ln_matmul_kernel if kernel else ln_matmul_plain
        ctx.save_for_backward(x, ln_w, ln_b, w)
        ctx.eps = eps
        return fwd(x, ln_w, ln_b, w, b, eps)

    @staticmethod
    def backward(ctx, g):
        return (*ln_matmul_bwd(*ctx.saved_tensors, g, ctx.eps), None, None)


def ln_matmul(x: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor,
              w: torch.Tensor, b: torch.Tensor, eps: float = 1e-6,
              backend: str = "auto") -> torch.Tensor:
    """``LayerNorm(x) @ w.T + b`` with the LN in the matmul's prologue, and
    differentiable in all five inputs: the K2 kernel for CUDA tensors, the
    plain version for CPU tensors; the backward is ``ln_matmul_bwd``.

    The LN affine, ``w`` and ``b`` may be float32 for a bf16 ``x``: all four
    are cast to x's dtype here, outside the autograd Function, as the JAX
    bf16 step casts its whole parameter tree, so their gradients come back
    through the casts in their own dtypes."""
    kernel = use_kernel(backend, x)
    if x.dim() < 2 or w.dim() != 2 or w.shape[1] != x.shape[-1] \
            or b.shape != (w.shape[0],) or ln_w.shape != (x.shape[-1],) \
            or ln_b.shape != ln_w.shape:
        raise ValueError(
            f"ln_matmul: bad shapes x {tuple(x.shape)} w {tuple(w.shape)} "
            f"b {tuple(b.shape)} ln {tuple(ln_w.shape)}")
    params = [t.to(x.dtype).contiguous() for t in (ln_w, ln_b, w, b)]
    return _LnMatmul.apply(x, *params, float(eps), kernel)
