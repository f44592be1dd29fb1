"""Mirrored upsampling decoder (mhada_tpu/models/decoder.py:81-103, 171-217;
reference network/conv.py:75-100).

512 -> 256 (+2x) -> 3 x (256 -> 256) -> 256 -> 128 (+2x) -> 128 -> 128 ->
128 -> 64 (+2x) -> 64 -> 64 -> 64 -> 3, all reflection-padded 3x3 convs
with ReLU.  The last layer is conv + ReLU, not tanh (reference
conv.py:93).  ``tail`` picks how up3 -> c5 -> c6 runs:

- ``"fused"``: one call of ``ops.decoder_tail.decoder_tail`` in eval mode
  (K5 on CUDA, the same plain chain on CPU) and of the differentiable
  ``decoder_tail_train`` in training mode (K8); the JAX package's
  ``packed="mega"`` / ``"mega_train"``;
- ``"c6"``: up3 and c5 as plain ConvReLUs, then c6 as its own kernel,
  ``ops.decoder_c6.c6_conv`` (K13); the JAX package's
  ``packed="col_tail"``.  Forward-only, as there: a decoder in training
  mode raises.

The state_dict is the same for both.  The JAX package's TPU re-layouts
(column packing, 2x2 packing, ``mega_min_grid``) do not exist here: the
c6 tail runs ``col_tail``'s function on plain NHWC tensors.

``ConvDepthwiseSeparable`` and ``ConvTanh`` (mhada_tpu/models/
decoder.py:35-79) are the reference's unused components, kept for parity;
they are plain PyTorch convolutions.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Conv2d, uniform_
from ..ops.decoder_c6 import c6_conv
from ..ops.decoder_tail import decoder_tail, decoder_tail_train
from ..ops.pad_conv import no_tf32, reflect_pad2d
from ..ops.resize import upsample2x


class ConvDepthwiseSeparable(nn.Module):
    """Reflection-padded depthwise k x k + pointwise 1x1 (reference
    conv.py:8-20; the ConvFF ViT variant's).  ``dw_kernel`` keeps the JAX
    layout (k, k, 1, C), so ``interop.params_from_jax`` carries it across
    unchanged; its weight and bias are U(+-1/k) (fan-in k * k, as the JAX
    module draws them)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.dw_kernel = nn.Parameter(
            torch.empty(kernel_size, kernel_size, 1, in_channels))
        self.dw_bias = nn.Parameter(torch.empty(in_channels))
        self.pointwise = Conv2d(in_channels, out_channels, 1)

    def reset_parameters(self, generator: torch.Generator) -> None:
        bound = 1.0 / self.dw_kernel.shape[0]
        uniform_(self.dw_kernel, bound, generator)
        uniform_(self.dw_bias, bound, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.dw_kernel.shape[0]
        x = reflect_pad2d(x, k // 2)
        w = self.dw_kernel.permute(3, 2, 0, 1).to(x.dtype)   # (C, 1, k, k)
        with no_tf32():
            y = F.conv2d(x.permute(0, 3, 1, 2), w, self.dw_bias.to(x.dtype),
                         stride=self.stride, groups=x.shape[-1])
        return self.pointwise(y.permute(0, 2, 3, 1).contiguous())


class ConvTanh(nn.Module):
    """Conv + tanh rescaled to 0-255 (reference conv.py:48-58)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3):
        super().__init__()
        self.conv = Conv2d(in_channels, out_channels, kernel_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(reflect_pad2d(x, self.conv.weight.shape[-1] // 2))
        return (torch.tanh(x) + 1.0) / 2.0 * 255.0


class ConvReLU(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = Conv2d(in_channels, out_channels, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.conv(reflect_pad2d(x, 1)))


class ConvReluUp(ConvReLU):
    """Conv + ReLU + 2x bilinear upsample (reference ConvReluInterpolate)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return upsample2x(super().forward(x))


TAILS = ("fused", "c6")


class Decoder(nn.Module):
    def __init__(self, in_channels: int = 512, backend: str = "auto",
                 tail: str = "fused"):
        super().__init__()
        if tail not in TAILS:
            raise ValueError(f"unknown decoder tail {tail!r}; expected one "
                             f"of {TAILS}")
        self.backend = backend
        self.tail = tail
        self.up1 = ConvReluUp(in_channels, 256)
        self.c1 = ConvReLU(256, 256)
        self.c2 = ConvReLU(256, 256)
        self.c3 = ConvReLU(256, 256)
        self.up2 = ConvReluUp(256, 128)
        self.c4 = ConvReLU(128, 128)
        self.up3 = ConvReluUp(128, 64)
        self.c5 = ConvReLU(64, 64)
        self.c6 = ConvReLU(64, 3)

    def forward(self, fcs: torch.Tensor) -> torch.Tensor:
        """fcs (B, h, w, in_channels) NHWC -> (B, 8h, 8w, 3)."""
        x = self.up1(fcs)
        x = self.c3(self.c2(self.c1(x)))
        x = self.c4(self.up2(x))
        if self.tail == "c6":
            if self.training:
                raise RuntimeError(
                    "the c6 tail (K13) is forward-only: train with "
                    "tail='fused' (K8)")
            y = self.c5(self.up3(x)).contiguous()
            return c6_conv(y, self.c6.conv.weight, self.c6.conv.bias,
                           backend=self.backend)
        up3, c5, c6 = self.up3.conv, self.c5.conv, self.c6.conv
        tail = decoder_tail_train if self.training else decoder_tail
        return tail(x.contiguous(), up3.weight, up3.bias, c5.weight, c5.bias,
                    c6.weight, c6.bias, backend=self.backend)
