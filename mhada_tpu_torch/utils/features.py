"""Multi-scale VGG feature helper (mhada_tpu/utils/features.py; reference
utilities.py:86-97)."""

import torch

from ..ops.resize import resize_bilinear


def feature_down_sample(feat: dict, last_layer: int) -> torch.Tensor:
    """relu1_1 .. relu{k-1}_1 resized (torch bilinear, no anti-aliasing) to
    relu{k}_1's size and channel-concatenated with it, NHWC."""
    size = feat[f"relu{last_layer}_1"].shape[1:3]
    parts = [resize_bilinear(feat[f"relu{i}_1"], size)
             for i in range(1, last_layer)]
    return torch.cat(parts + [feat[f"relu{last_layer}_1"]], dim=-1)
