"""Reflect padding, convolution and max pooling on NHWC tensors
(mhada_tpu/ops/pad_conv.py:13-72).

Weights are torch OIHW.  The NHWC <-> NCHW permutes happen only around
``F.conv2d`` / ``F.max_pool2d``; ``F.pad(mode="reflect")`` is
``nn.ReflectionPad2d`` (edge-exclusive), as ``jnp.pad(mode="reflect")`` is
in the JAX package.
"""

import contextlib

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def no_tf32():
    """Float32 convolutions and matmuls in float32, not TF32, inside the
    block (PyTorch leaves cuDNN's TF32 on by default); restored after."""
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags


def reflect_pad2d(x: torch.Tensor, pad: int) -> torch.Tensor:
    """NHWC reflection padding of ``pad`` pixels on each spatial side."""
    y = F.pad(x.permute(0, 3, 1, 2), (pad, pad, pad, pad), mode="reflect")
    return y.permute(0, 2, 3, 1)


def conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
           stride: int = 1,
           padding: int | tuple[int, int] = 0) -> torch.Tensor:
    """NHWC conv with an OIHW kernel, ``padding`` zeros on each side (an
    int, or a (rows, columns) pair); the output is contiguous NHWC.

    TF32 is off for the call, so a float32 conv computes in float32, as the
    configuration states.  The conv returns channels-last (so the permute
    back is free) when it recognises x's NCHW view as channels-last; an
    input whose batch axis of size 1 has stride 0 (``torch.from_numpy(
    a[None])``) is not, and would reach the kernels non-contiguous.
    """
    with no_tf32():
        y = F.conv2d(x.permute(0, 3, 1, 2), w, b, stride=stride,
                     padding=padding)
    return y.permute(0, 2, 3, 1).contiguous()


def conv2d_reflect(x: torch.Tensor, w: torch.Tensor,
                   b: torch.Tensor) -> torch.Tensor:
    """Reflection-padded conv, pad = k // 2 (reference network/conv.py:23-33)."""
    return conv2d(reflect_pad2d(x, w.shape[-1] // 2), w, b)


def max_pool2d(x: torch.Tensor, window: int = 2,
               stride: int = 2) -> torch.Tensor:
    """NHWC ``window`` x ``window`` max pool, no padding, floor mode (torch
    MaxPool2d default)."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), window,
                        stride).permute(0, 2, 3, 1)
