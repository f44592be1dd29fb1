"""Affine-free instance norm over tokens (mhada_tpu/ops/instance_norm.py:19-35).

``nn.InstanceNorm2d(C, affine=False)`` semantics: each (batch, channel) is
normalised over the token axis with biased variance and eps 1e-5 (reference
network/adaDecoder.py:41-43,147-149).  Statistics are taken in float32.
"""

import torch


def instance_norm_tokens(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """x: (B, N, C) -> normalised over N per (b, c), in x's dtype."""
    xf = x.float()
    mean = xf.mean(dim=1, keepdim=True)
    var = (xf - mean).square().mean(dim=1, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)
