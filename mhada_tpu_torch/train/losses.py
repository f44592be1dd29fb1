"""Training losses (mhada_tpu/train/losses.py:17-69; reference
lossfn.py:7-47).

Feature dicts are {"relu1_1" .. "relu5_1"} NHWC maps from
``models.VGG19Features``; images are NHWC 0-255.  MSE is mean-reduced like
``nn.MSELoss``.  The temporal losses come with video training.
"""

import torch

from ..ops.instance_norm import instance_norm_tokens
from ..ops.mhada import mhada_attention
from ..utils.features import feature_down_sample

LAYERS = ["relu1_1", "relu2_1", "relu3_1", "relu4_1", "relu5_1"]


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(a - b))


def global_style_loss(fcs: dict, fs: dict) -> torch.Tensor:
    """AdaIN statistics matching over the five layers (lossfn.py:7-23),
    with the unbiased std over the spatial extent (torch ``Tensor.std``)."""
    loss = 0.0
    for name in LAYERS:
        a, b = fcs[name], fs[name]
        loss = loss + mse(a.mean((1, 2)), b.mean((1, 2))) + mse(
            a.std((1, 2)), b.std((1, 2)))
    return loss


def adaattn_for_loss(c_x, s_x, c_1x, s_1x, activation: str = "softmax"):
    """Parameter-free AdaAttN on NHWC maps (mhada_tpu/models/
    adaformer.py:257-268, ops/mhada.py:82-100; reference adaDecoder.py
    :38-81): Q = IN(c_1x), K = IN(s_1x), V = s_x, output S * IN(c_x) + M,
    as one head over all channels with the plain core."""
    b, h, w, c = c_x.shape

    def tokens(t):
        return t.reshape(t.shape[0], -1, t.shape[-1])

    q = instance_norm_tokens(tokens(c_1x))
    k = instance_norm_tokens(tokens(s_1x))
    cn = instance_norm_tokens(tokens(c_x))
    out = mhada_attention(q[:, None], k[:, None], tokens(s_x)[:, None],
                          cn[:, None], activation)
    return out[:, 0].reshape(b, h, w, c)


def local_feature_loss(fc: dict, fs: dict, fcs: dict,
                       activation: str = "softmax") -> torch.Tensor:
    """MSE against parameter-free AdaAttN targets at relu3/4/5_1, with
    multi-scale Q/K concats (lossfn.py:26-34)."""
    loss = 0.0
    for i in (3, 4, 5):
        target = adaattn_for_loss(
            fc[f"relu{i}_1"], fs[f"relu{i}_1"], feature_down_sample(fc, i),
            feature_down_sample(fs, i), activation)
        loss = loss + mse(fcs[f"relu{i}_1"], target)
    return loss


def identity_loss_1(cc, c, ss, s) -> torch.Tensor:
    """Pixel-space reconstruction identity (lossfn.py:37-38)."""
    return mse(cc, c) + mse(ss, s)


def identity_loss_2(fcc: dict, fc: dict, fss: dict, fs: dict) -> torch.Tensor:
    """VGG-feature identity over all five layers (lossfn.py:41-47)."""
    loss = 0.0
    for name in LAYERS:
        loss = loss + mse(fcc[name], fc[name]) + mse(fss[name], fs[name])
    return loss
