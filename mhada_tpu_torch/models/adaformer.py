"""AdaFormer: the multi-head adaptive-attention decoder-transformer
(mhada_tpu/models/adaformer.py:34-142, 174-227; reference
network/adaDecoder.py:134-206, 235-268).

Per layer i two MHAda blocks run (content as query, then the stylised
features as query), then the decoder.  Heads split the channels
contiguously; the per-head 1x1 convs are a (heads, d, d) kernel stack
applied with one einsum, as in the JAX package, and the instance norms run
once over the full channel axis.

The streaming path caches each block's style keys and values
(``AdaAttnMultiHead.style_kv``, mhada_tpu/infer/image.py:153-190); a block
in eval mode given them runs the fused-prologue core K3
(ops/mhada_prologue.py) for the softmax activation, at every key count (the
JAX package's M <= 4096 guard at mhada_tpu/models/adaformer.py:82 is a TPU
VMEM limit).  Otherwise the softmax core is K4 in eval mode and the
differentiable K7 (ops/mhada_train.py) in training mode; K3 and K4 are
forward-only, as the JAX training build turns the fused prologue off.
"""

import math

import torch
import torch.nn as nn

from .decoder import Decoder
from .layers import uniform_
from ..ops.instance_norm import instance_norm_stats, instance_norm_tokens
from ..ops.mhada_kernel import mhada_tm, mhada_tm_plain
from ..ops.mhada_prologue import mhada_fused_prologue
from ..ops.mhada_train import mhada_train


class AdaAttnMultiHead(nn.Module):
    """Multi-head adaptive attention on (B, N, C) tokens.

    Parameter names and layouts are the JAX tree's: ``{f,g,h}_kernel``
    (H, d, d), ``{f,g,h}_bias`` (H, d), ``out_kernel`` (C, C) as (in, out).
    """

    def __init__(self, channels: int, num_heads: int = 8,
                 activation: str = "softmax", backend: str = "auto"):
        super().__init__()
        self.num_heads = num_heads
        self.activation = activation
        self.backend = backend
        d = channels // num_heads
        for name in ("f", "g", "h"):
            self.register_parameter(
                f"{name}_kernel", nn.Parameter(torch.empty(num_heads, d, d)))
            self.register_parameter(
                f"{name}_bias", nn.Parameter(torch.empty(num_heads, d)))
        self.out_kernel = nn.Parameter(torch.empty(channels, channels))
        self.out_bias = nn.Parameter(torch.empty(channels))

    def reset_parameters(self, generator: torch.Generator) -> None:
        d = self.f_kernel.shape[-1]
        for name in ("f", "g", "h"):
            uniform_(getattr(self, f"{name}_kernel"), 1 / math.sqrt(d), generator)
            uniform_(getattr(self, f"{name}_bias"), 1 / math.sqrt(d), generator)
        c = self.out_kernel.shape[0]
        uniform_(self.out_kernel, 1 / math.sqrt(c), generator)
        uniform_(self.out_bias, 1 / math.sqrt(c), generator)

    def _project(self, x: torch.Tensor, name: str) -> torch.Tensor:
        """Per-head 1x1 conv: (B, N, C) -> (B, N, C)."""
        b, n, c = x.shape
        k = getattr(self, f"{name}_kernel").to(x.dtype)
        bias = getattr(self, f"{name}_bias").to(x.dtype)
        y = torch.einsum("bnhd,hde->bnhe",
                         x.reshape(b, n, self.num_heads, -1), k) + bias
        return y.reshape(b, n, c)

    def style_kv(self, fs: torch.Tensor):
        """Token-major keys and values (B, M, C) of style tokens fs: they
        depend on the style alone, so a stream computes them once."""
        return (self._project(instance_norm_tokens(fs), "g").contiguous(),
                self._project(fs, "h").contiguous())

    def forward(self, fc: torch.Tensor, fs: torch.Tensor | None,
                fcs: torch.Tensor, style_kv=None) -> torch.Tensor:
        """fc, fcs (B, N, C) queries / current stylised features; fs (B, M, C)
        style features, or None with ``style_kv``, this block's cached
        ``(k, v)`` from ``style_kv(fs)``."""
        k, v = self.style_kv(fs) if style_kv is None else style_kv
        dt = fc.dtype
        if (style_kv is not None and self.activation == "softmax"
                and not self.training):
            mean_fc, rstd_fc = instance_norm_stats(fc)
            mean_fcs, rstd_fcs = instance_norm_stats(fcs)
            stats = torch.stack([mean_fc, rstd_fc, mean_fcs, rstd_fcs], 1)
            out = mhada_fused_prologue(
                fc.contiguous(), fcs.contiguous(), stats, self.f_kernel,
                self.f_bias, k, v, backend=self.backend)
        else:
            q = self._project(instance_norm_tokens(fc), "f").contiguous()
            fcs_n = instance_norm_tokens(fcs).contiguous()
            if self.activation == "softmax":
                core = mhada_train if self.training else mhada_tm
                out = core(q, k, v, fcs_n, self.num_heads,
                           backend=self.backend)
            else:
                out = mhada_tm_plain(q, k, v, fcs_n, self.num_heads,
                                     self.activation)
        return out @ self.out_kernel.to(dt) + self.out_bias.to(dt)


class AdaFormer(nn.Module):
    """The trained decoder-transformer (reference AdaAttnTransformerMultiHead);
    returns (fcs_map, cs)."""

    def __init__(self, num_layers: int = 3, num_heads: int = 8,
                 hidden_dim: int = 512, activation: str = "softmax",
                 backend: str = "auto"):
        super().__init__()
        self.num_layers = num_layers
        for j in range(2 * num_layers):
            self.add_module(f"ada{j}", AdaAttnMultiHead(
                hidden_dim, num_heads, activation, backend))
        self.decoder = Decoder(hidden_dim, backend)

    def forward(self, fc: list[torch.Tensor], fs: list[torch.Tensor] | None,
                style_kv=None):
        """``style_kv``: 2 * num_layers cached (k, v) pairs, one per block,
        from ``infer.image.precompute_style_kv``; ``fs`` may then be None."""
        b, h, w, c = fc[0].shape
        fc_tok = [f.reshape(b, h * w, c) for f in fc]
        if style_kv is None:
            fs_tok = [f.reshape(f.shape[0], -1, f.shape[-1]) for f in fs]
            style_kv = [None] * (2 * self.num_layers)
        else:
            fs_tok = [None] * self.num_layers
        fcs = fc_tok[0]
        for i in range(self.num_layers):
            fcs = getattr(self, f"ada{2 * i}")(fc_tok[i], fs_tok[i], fcs,
                                               style_kv[2 * i])
            fcs = getattr(self, f"ada{2 * i + 1}")(fcs, fs_tok[i], fcs,
                                                   style_kv[2 * i + 1])
        fcs_map = fcs.reshape(b, h, w, c)
        return fcs_map, self.decoder(fcs_map)
