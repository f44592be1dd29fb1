"""Affine-free instance norm over tokens (mhada_tpu/ops/instance_norm.py:19-35).

``nn.InstanceNorm2d(C, affine=False)`` semantics: each (batch, channel) is
normalised over the token axis with biased variance and eps 1e-5 (reference
network/adaDecoder.py:41-43,147-149).  Statistics are taken in float32.

``group`` (a ``parallel.collectives.Group``): the token axis is sharded over
its ranks in equal parts (sequence parallelism, parallel/sp.py).  The mean
is averaged over the ranks, then the variance about that global mean, as
the JAX package's two ``pmean``s do: the result equals the unsharded one.
"""

import torch


def instance_norm_stats(x: torch.Tensor, eps: float = 1e-5, group=None):
    """x: (B, N, C) -> float32 (mean, rstd), each (B, C), over N (over the
    whole sharded axis with ``group``)."""
    xf = x.float()
    mean = xf.mean(dim=1)
    if group is not None:
        mean = group.all_reduce_mean(mean)
    var = (xf - mean[:, None]).square().mean(dim=1)
    if group is not None:
        var = group.all_reduce_mean(var)
    return mean, torch.rsqrt(var + eps)


def instance_norm_tokens(x: torch.Tensor, eps: float = 1e-5,
                         group=None) -> torch.Tensor:
    """x: (B, N, C) -> normalised over N per (b, c), in x's dtype."""
    mean, rstd = instance_norm_stats(x, eps, group)
    return ((x.float() - mean[:, None]) * rstd[:, None]).to(x.dtype)
