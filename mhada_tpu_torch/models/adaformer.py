"""AdaFormer: the multi-head adaptive-attention decoder-transformer
(mhada_tpu/models/adaformer.py:34-142, 174-227; reference
network/adaDecoder.py:134-206, 235-268).

Per layer i two MHAda blocks run (content as query, then the stylised
features as query), then the decoder.  Heads split the channels
contiguously; the per-head 1x1 convs are a (heads, d, d) kernel stack
applied with one einsum, as in the JAX package, and the instance norms run
once over the full channel axis.  The style K/V cache of the streaming path
is not part of this module yet.
"""

import math

import torch
import torch.nn as nn

from .decoder import Decoder
from .layers import uniform_
from ..ops.instance_norm import instance_norm_tokens
from ..ops.mhada_kernel import mhada_tm, mhada_tm_plain


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

    def forward(self, fc: torch.Tensor, fs: torch.Tensor,
                fcs: torch.Tensor) -> torch.Tensor:
        """fc, fcs (B, N, C) queries / current stylised features; fs (B, M, C)
        style features."""
        q = self._project(instance_norm_tokens(fc), "f").contiguous()
        k = self._project(instance_norm_tokens(fs), "g").contiguous()
        v = self._project(fs, "h").contiguous()
        fcs_n = instance_norm_tokens(fcs).contiguous()
        if self.activation == "softmax":
            out = mhada_tm(q, k, v, fcs_n, self.num_heads, backend=self.backend)
        else:
            out = mhada_tm_plain(q, k, v, fcs_n, self.num_heads,
                                 self.activation)
        dt = fc.dtype
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

    def forward(self, fc: list[torch.Tensor], fs: list[torch.Tensor]):
        b, h, w, c = fc[0].shape
        fc_tok = [f.reshape(b, h * w, c) for f in fc]
        fs_tok = [f.reshape(f.shape[0], -1, f.shape[-1]) for f in fs]
        fcs = fc_tok[0]
        for i in range(self.num_layers):
            fcs = getattr(self, f"ada{2 * i}")(fc_tok[i], fs_tok[i], fcs)
            fcs = getattr(self, f"ada{2 * i + 1}")(fcs, fs_tok[i], fcs)
        fcs_map = fcs.reshape(b, h, w, c)
        return fcs_map, self.decoder(fcs_map)
