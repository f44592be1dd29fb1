"""K4: the MHAda core on token-major tensors (csrc/mhada_fwd.cu).

Port of mhada_tpu/ops/mhada_pallas.py::mhada_attention_pallas, single-pass
forward.  Inputs stay (B, N|M, C) with head h in channels
[h*64, (h+1)*64), so the head-split transposes of
mhada_tpu/models/adaformer.py:133-141 are not needed.  At bfloat16 the
kernel runs on the tensor cores (the MHAda tile of csrc/mhada_mma.cuh
without K3's prologue); at float32 it computes in float32 on the CUDA cores
(csrc/mhada_f32_tile.cuh).  Both raise on a tensor that is not 16-byte
aligned.  The softmax twin follows the Pallas kernel's rounding points
(``mhada_softmax_plain``, which K3's twin shares); the cosine activation
runs the plain core of ops/mhada.py.
"""

import torch

from .. import _build
from ..config import use_kernel
from .mhada import mhada_attention

HEAD_DIM = 64
# The dtypes whose kernel builds copy 16 bytes at a time, so that each
# operand must start on a 16-byte boundary: all of them (the float32 tile
# of csrc/mhada_f32_tile.cuh too).
ALIGNED = (torch.float32, torch.bfloat16)


def _heads(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, n, c = t.shape
    return t.reshape(b, n, num_heads, c // num_heads).transpose(1, 2)


def mhada_softmax_plain(q, k, v, f, dtype) -> torch.Tensor:
    """The softmax MHAda core of _kernel (mhada_pallas.py:42-78) step by
    step, on head-major float32 q, f (B, H, N, d) and k, v (B, H, M, d):
    P = exp(S - max) in float32, P and V^2 rounded to ``dtype`` as the
    product's operands, the product divided by the unrounded row sum, then
    the clamp and the epilogue in float32 -> (B, H, N, d) float32."""
    s = q @ k.transpose(-1, -2)                              # unscaled
    p = torch.exp(s - s.amax(-1, keepdim=True))
    del s
    denom = p.sum(-1, keepdim=True)
    p = p.to(dtype).float()
    m1 = p @ v / denom
    e2 = p @ v.square().to(dtype).float() / denom
    sd = torch.sqrt(torch.clamp(e2 - m1.square(), min=1e-6))
    return sd * f + m1


def mhada_tm_plain(q, k, v, fcs_n, num_heads: int,
                   activation: str = "softmax") -> torch.Tensor:
    """q, fcs_n (B, N, C); k, v (B, M, C) -> (B, N, C)."""
    b, n, c = q.shape
    qh, kh, vh, fh = (_heads(t, num_heads) for t in (q, k, v, fcs_n))
    if activation == "softmax":
        out = mhada_softmax_plain(qh.float(), kh.float(), vh.float(),
                                  fh.float(), v.dtype)
    else:
        out = mhada_attention(qh, kh, vh, fh, activation)
    return out.transpose(1, 2).reshape(b, n, c).to(q.dtype)


def mhada_tm(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             fcs_n: torch.Tensor, num_heads: int,
             backend: str = "auto") -> torch.Tensor:
    """Softmax MHAda core; the K4 kernel for CUDA tensors.

    Forward-only: its training counterpart is K7,
    ``ops.mhada_train.mhada_train``."""
    if not use_kernel(backend, q):
        return mhada_tm_plain(q, k, v, fcs_n, num_heads)
    if q.dim() != 3 or k.dim() != 3 or q.shape != fcs_n.shape \
            or k.shape != v.shape or q.shape[0] != k.shape[0] \
            or q.shape[2] != k.shape[2]:
        raise ValueError(
            f"mhada_tm: bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
            f"v {tuple(v.shape)} fcs_n {tuple(fcs_n.shape)}")
    b, n, c = q.shape
    m = k.shape[1]
    if c % num_heads or c // num_heads != HEAD_DIM:
        raise ValueError(f"mhada_tm: the kernel takes head dim {HEAD_DIM}, "
                         f"got C={c} over {num_heads} heads")
    _build.check_cuda_inputs("mhada_tm", q, k, v, fcs_n)
    _build.check_forward_only(
        "mhada_tm", "train through K7, ops.mhada_train.mhada_train",
        q, k, v, fcs_n)
    out = torch.empty_like(q)
    _build.check_aligned("mhada_tm", q, k, v, fcs_n, out, dtypes=ALIGNED)
    _build.launch("mhada_mhada_fwd", q.device, q, k, v, fcs_n, out, b, n, m,
                  c, num_heads, _build.dtype_code(q))
    return out
