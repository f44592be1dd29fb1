"""K1: ViT self-attention from the packed qkv (csrc/attention_fwd.cu).

Port of mhada_tpu/ops/attention_pallas.py::attention_pallas_tm.  The twin
``attention_plain`` is the einsum path of mhada_tpu/models/layers.py:200-221
in float32.

``attention_cross`` is K1's cross form, N queries against M keys and values
of another tensor: the port of the head-major ``_attention_pallas_call``
(attention_pallas.py:49-85) and of the streaming forward
``_attn_stream_fwd_impl`` (:463-517), which the JAX ViT attention reaches
under sequence parallelism with the keys and values gathered over the
shards (mhada_tpu/models/layers.py:204-208).  Its twin is
``attention_cross_plain``.
"""

import math

import torch

from .. import _build
from ..config import use_kernel
from .mhada_kernel import ALIGNED

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
    _build.check_aligned("attention_tm", qkv, out, dtypes=ALIGNED)
    _build.launch("mhada_attention_fwd", qkv.device, qkv, out, b, l, c,
                  num_heads, float(scale), _build.dtype_code(qkv))
    return out


def attention_cross_plain(q: torch.Tensor, kv: torch.Tensor, num_heads: int,
                          scale: float | None = None) -> torch.Tensor:
    """(B, N, C) queries against (B, M, 2C) keys and values side by side ->
    (B, N, C): per head softmax(Q K^T scale) V, in float32."""
    b, n, c = q.shape
    m, d = kv.shape[1], c // num_heads
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    qh = q.float().reshape(b, n, num_heads, d).transpose(1, 2)
    kh, vh = (t.reshape(b, m, num_heads, d).transpose(1, 2)
              for t in kv.float().split(c, dim=-1))
    a = torch.softmax(qh @ kh.transpose(-1, -2) * scale, dim=-1)
    return (a @ vh).transpose(1, 2).reshape(b, n, c).to(q.dtype)


def _check_rows(name: str, t: torch.Tensor) -> None:
    """The cross form reads each of q and kv as rows of unit-stride channels
    at one row stride (a column slice of a contiguous tensor, such as the
    packed qkv's first C columns, qualifies), 16 bytes to a row step."""
    b, n, _ = t.shape
    if t.stride(2) != 1 or (b > 1 and t.stride(0) != n * t.stride(1)):
        raise ValueError(f"{name}: {tuple(t.shape)} with strides "
                         f"{t.stride()} is not rows of unit-stride channels")
    if t.stride(1) * t.element_size() % 16:
        raise ValueError(f"{name}: row stride {t.stride(1)} is not a "
                         f"multiple of 16 bytes")


def attention_cross(q: torch.Tensor, kv: torch.Tensor, num_heads: int,
                    scale: float | None = None,
                    backend: str = "auto") -> torch.Tensor:
    """Token-major attention of (B, N, C) queries against (B, M, 2C) keys and
    values (K in the first C channels, V in the next); the K1 kernel's cross
    form for CUDA tensors.  ``q`` may be a column slice of the packed qkv.
    Forward-only, as K1."""
    if not use_kernel(backend, q):
        return attention_cross_plain(q, kv, num_heads, scale)
    if (q.dim() != 3 or kv.dim() != 3 or kv.shape[0] != q.shape[0]
            or kv.shape[2] != 2 * q.shape[2] or q.shape[2] % num_heads):
        raise ValueError(f"attention_cross: bad shapes q {tuple(q.shape)}, "
                         f"kv {tuple(kv.shape)} for {num_heads} heads")
    b, n, c = q.shape
    if c // num_heads != HEAD_DIM:
        raise ValueError(f"attention_cross: the kernel takes head dim "
                         f"{HEAD_DIM}, got {c // num_heads}")
    _build.dtype_code(q)
    if kv.device != q.device or kv.dtype != q.dtype:
        raise ValueError("attention_cross: q and kv must share a CUDA device "
                         "and a dtype")
    for name, t in (("q", q), ("kv", kv)):
        _check_rows(f"attention_cross {name}", t)
    _build.check_forward_only("attention_cross", "no training route takes "
                              "the cross form", q, kv)
    scale = 1.0 / math.sqrt(HEAD_DIM) if scale is None else scale
    out = torch.empty((b, n, c), device=q.device, dtype=q.dtype)
    _build.check_aligned("attention_cross", q, kv, out, dtypes=ALIGNED)
    _build.launch("mhada_attention_cross_fwd", q.device, q, kv, out, b, n,
                  kv.shape[1], c, q.stride(1), kv.stride(1), num_heads,
                  float(scale), _build.dtype_code(q))
    return out
