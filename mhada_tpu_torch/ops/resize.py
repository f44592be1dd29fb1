"""Bilinear resize, torch ``align_corners=False`` semantics, NHWC at the
boundary (mhada_tpu/ops/resize.py:25-100).

The JAX package builds interpolation matrices because ``jax.image.resize``
anti-aliases on downsample; here ``F.interpolate`` without anti-aliasing is
the rule itself (reference network/conv.py:71, network/vit.py:92).
"""

import torch
import torch.nn.functional as F


def _interp_nchw(x: torch.Tensor, size=None, scale_factor=None) -> torch.Tensor:
    return F.interpolate(x, size=size, scale_factor=scale_factor,
                         mode="bilinear", align_corners=False, antialias=False)


def resize_bilinear(x: torch.Tensor, out_hw) -> torch.Tensor:
    """NHWC -> ``out_hw`` with torch bilinear sampling."""
    return _interp_nchw(x.permute(0, 3, 1, 2),
                        size=tuple(out_hw)).permute(0, 2, 3, 1)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Exact 2x bilinear upsample of an NHWC tensor (decoder path)."""
    return _interp_nchw(x.permute(0, 3, 1, 2), scale_factor=2).permute(0, 2, 3, 1)
