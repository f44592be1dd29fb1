"""Affine-free instance norm over tokens (mhada_tpu/ops/instance_norm.py:19-35).

``nn.InstanceNorm2d(C, affine=False)`` semantics: each (batch, channel) is
normalised over the token axis with biased variance and eps 1e-5 (reference
network/adaDecoder.py:41-43,147-149).  Statistics are taken in float32.
"""

import torch


def instance_norm_stats(x: torch.Tensor, eps: float = 1e-5):
    """x: (B, N, C) -> float32 (mean, rstd), each (B, C), over N."""
    xf = x.float()
    mean = xf.mean(dim=1)
    var = (xf - mean[:, None]).square().mean(dim=1)
    return mean, torch.rsqrt(var + eps)


def instance_norm_tokens(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """x: (B, N, C) -> normalised over N per (b, c), in x's dtype."""
    mean, rstd = instance_norm_stats(x, eps)
    return ((x.float() - mean[:, None]) * rstd[:, None]).to(x.dtype)
