"""K4: the MHAda core on token-major tensors (csrc/mhada_fwd.cu).

Port of mhada_tpu/ops/mhada_pallas.py::mhada_attention_pallas, single-pass
forward.  Inputs stay (B, N|M, C) with head h in channels
[h*64, (h+1)*64), so the head-split transposes of
mhada_tpu/models/adaformer.py:133-141 are not needed.  The twin runs the
plain core of ops/mhada.py.
"""

import torch

from .. import _build
from ..config import use_kernel
from .mhada import mhada_attention

HEAD_DIM = 64


def _heads(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, n, c = t.shape
    return t.reshape(b, n, num_heads, c // num_heads).transpose(1, 2)


def mhada_tm_plain(q, k, v, fcs_n, num_heads: int,
                   activation: str = "softmax") -> torch.Tensor:
    """q, fcs_n (B, N, C); k, v (B, M, C) -> (B, N, C)."""
    b, n, c = q.shape
    out = mhada_attention(_heads(q, num_heads), _heads(k, num_heads),
                          _heads(v, num_heads), _heads(fcs_n, num_heads),
                          activation)
    return out.transpose(1, 2).reshape(b, n, c)


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
    _build.launch("mhada_mhada_fwd", q.device, q, k, v, fcs_n, out, b, n, m,
                  c, num_heads, _build.dtype_code(q))
    return out
