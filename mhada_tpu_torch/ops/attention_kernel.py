"""K1: ViT self-attention from the packed qkv (csrc/attention_fwd.cu).

Port of mhada_tpu/ops/attention_pallas.py::attention_pallas_tm.  The twin
``attention_plain`` is the einsum path of mhada_tpu/models/layers.py:200-221
in float32.
"""

import math

import torch

from .. import _build
from ..config import use_kernel

HEAD_DIM = 64


def attention_plain(qkv: torch.Tensor, num_heads: int,
                    scale: float | None = None) -> torch.Tensor:
    """(B, L, 3C) packed qkv -> (B, L, C): per head softmax(Q K^T scale) V."""
    b, l, c3 = qkv.shape
    c = c3 // 3
    d = c // num_heads
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    q, k, v = (t.reshape(b, l, num_heads, d).transpose(1, 2)
               for t in qkv.float().split(c, dim=-1))
    a = torch.softmax(q @ k.transpose(-1, -2) * scale, dim=-1)
    o = (a @ v).transpose(1, 2).reshape(b, l, c)
    return o.to(qkv.dtype)


def attention_tm(qkv: torch.Tensor, num_heads: int,
                 scale: float | None = None,
                 backend: str = "auto") -> torch.Tensor:
    """Token-major self-attention; the K1 kernel for CUDA tensors.

    Forward-only: its training counterpart is K6,
    ``ops.attention_train.attention_train``."""
    if not use_kernel(backend, qkv):
        return attention_plain(qkv, num_heads, scale)
    if qkv.dim() != 3 or qkv.shape[2] % (3 * num_heads):
        raise ValueError(f"attention_tm: bad qkv shape {tuple(qkv.shape)} "
                         f"for {num_heads} heads")
    b, l, c3 = qkv.shape
    c = c3 // 3
    if c // num_heads != HEAD_DIM:
        raise ValueError(f"attention_tm: the kernel takes head dim "
                         f"{HEAD_DIM}, got {c // num_heads}")
    _build.check_cuda_inputs("attention_tm", qkv)
    _build.check_forward_only(
        "attention_tm", "train through K6, ops.attention_train."
        "attention_train", qkv)
    scale = 1.0 / math.sqrt(HEAD_DIM) if scale is None else scale
    out = torch.empty((b, l, c), device=qkv.device, dtype=qkv.dtype)
    _build.check_aligned("attention_tm", qkv, out)
    _build.launch("mhada_attention_fwd", qkv.device, qkv, out, b, l, c,
                  num_heads, float(scale), _build.dtype_code(qkv))
    return out
