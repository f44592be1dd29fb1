"""Reflect padding and convolution on NHWC tensors
(mhada_tpu/ops/pad_conv.py:13-60).

Weights are torch OIHW.  The NHWC <-> NCHW permutes happen only around
``F.conv2d``; ``F.pad(mode="reflect")`` is ``nn.ReflectionPad2d``
(edge-exclusive), as ``jnp.pad(mode="reflect")`` is in the JAX package.
"""

import torch
import torch.nn.functional as F


def reflect_pad2d(x: torch.Tensor, pad: int) -> torch.Tensor:
    """NHWC reflection padding of ``pad`` pixels on each spatial side."""
    y = F.pad(x.permute(0, 3, 1, 2), (pad, pad, pad, pad), mode="reflect")
    return y.permute(0, 2, 3, 1)


def conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
           stride: int = 1) -> torch.Tensor:
    """Unpadded NHWC conv with an OIHW kernel.

    cuDNN's TF32 is off for the call (PyTorch leaves it on by default), so a
    float32 conv computes in float32, as the configuration states.
    """
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        y = F.conv2d(x.permute(0, 3, 1, 2), w, b, stride=stride)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    return y.permute(0, 2, 3, 1)


def conv2d_reflect(x: torch.Tensor, w: torch.Tensor,
                   b: torch.Tensor) -> torch.Tensor:
    """Reflection-padded conv, pad = k // 2 (reference network/conv.py:23-33)."""
    return conv2d(reflect_pad2d(x, w.shape[-1] // 2), w, b)
