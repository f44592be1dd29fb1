"""Shared layers with PyTorch-default initialisation
(mhada_tpu/models/layers.py:19-124, 127-222).

Parameters are created empty and filled by ``reset_parameters(generator)``
(see ``init_parameters``) so that one explicit ``torch.Generator`` makes the
whole model: Conv2d/Linear weights and biases U(-1/sqrt(fan_in),
1/sqrt(fan_in)); the packed qkv projection xavier-uniform with zero biases
(torch ``nn.MultiheadAttention``); LayerNorm ones/zeros.  Weights are kept
in float32 and cast to the activations' dtype at use, as the JAX package
casts its params.
"""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention_kernel import attention_tm
from ..ops.attention_train import attention_train
from ..ops.ln_matmul import layer_norm, ln_matmul
from ..ops.pad_conv import conv2d


def uniform_(t: torch.Tensor, bound: float, generator: torch.Generator) -> None:
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=generator)


def init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Call ``reset_parameters(generator)`` on every submodule that has it,
    in registration order (deterministic for a given generator state)."""
    for m in module.modules():
        reset = getattr(m, "reset_parameters", None)
        if reset is not None:
            reset(generator)


class Linear(nn.Module):
    """``nn.Linear`` layout (weight (out, in)); applied to the last axis."""

    def __init__(self, in_features: int, out_features: int,
                 zero_bias: bool = False):
        super().__init__()
        self.zero_bias = zero_bias
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features))

    def reset_parameters(self, generator: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.weight.shape[1])
        uniform_(self.weight, bound, generator)
        if self.zero_bias:
            nn.init.zeros_(self.bias)
        else:
            uniform_(self.bias, bound, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class Conv2d(nn.Module):
    """Conv with an OIHW weight on NHWC tensors (no padding of its own)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels))

    def reset_parameters(self, generator: torch.Generator) -> None:
        w = self.weight
        bound = 1.0 / math.sqrt(w.shape[1] * w.shape[2] * w.shape[3])
        uniform_(w, bound, generator)
        uniform_(self.bias, bound, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d(x, self.weight.to(x.dtype), self.bias.to(x.dtype),
                      stride=self.stride)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis, eps 1e-6, float32 statistics."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim))

    def reset_parameters(self, generator: torch.Generator) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)


class MultiHeadSelfAttention(nn.Module):
    """``nn.MultiheadAttention``-compatible self-attention over axis 1 of a
    (B, L, E) input, on the packed qkv projection.

    ``ln``: the caller's pre-LN; ``x`` is then the un-normalised residual
    stream.  In eval mode the LN is fused into the qkv projection (K2) and
    the attention is K1 (``attention_tm``), both forward-only; in training
    mode the LN runs unfused and the attention is K6 (``attention_train``),
    as in the JAX package's training build (train_image.py:45-93).
    """

    def __init__(self, embed_dim: int, num_heads: int, backend: str = "auto"):
        super().__init__()
        self.num_heads = num_heads
        self.backend = backend
        self.qkv_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.qkv_bias = nn.Parameter(torch.empty(3 * embed_dim))
        self.out_proj = Linear(embed_dim, embed_dim, zero_bias=True)

    def reset_parameters(self, generator: torch.Generator) -> None:
        e = self.qkv_weight.shape[1]
        uniform_(self.qkv_weight, math.sqrt(6.0 / (3 * e + e)), generator)
        nn.init.zeros_(self.qkv_bias)

    def forward(self, x: torch.Tensor, ln: LayerNorm | None = None
                ) -> torch.Tensor:
        if ln is not None and not self.training:
            qkv = ln_matmul(x, ln.weight, ln.bias, self.qkv_weight,
                            self.qkv_bias, ln.eps, backend=self.backend)
        else:
            h = x if ln is None else ln(x)
            qkv = F.linear(h, self.qkv_weight.to(x.dtype),
                           self.qkv_bias.to(x.dtype))
        hd = x.shape[-1] // self.num_heads
        attend = attention_train if self.training else attention_tm
        o = attend(qkv.contiguous(), self.num_heads,
                   scale=1.0 / math.sqrt(hd), backend=self.backend)
        return self.out_proj(o)
