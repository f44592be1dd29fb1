"""Mirrored upsampling decoder (mhada_tpu/models/decoder.py:81-103, 171-217;
reference network/conv.py:75-100).

512 -> 256 (+2x) -> 3 x (256 -> 256) -> 256 -> 128 (+2x) -> 128 -> 128 ->
128 -> 64 (+2x) -> 64 -> 64 -> 64 -> 3, all reflection-padded 3x3 convs
with ReLU.  The last layer is conv + ReLU, not tanh (reference
conv.py:93).  The tail up3 -> c5 -> c6 runs as one call of
``ops.decoder_tail.decoder_tail`` in eval mode (K5 on CUDA, the same plain
chain on CPU) and of the differentiable ``decoder_tail_train`` in training
mode (K8); none of the JAX package's TPU re-layouts (2x2, col, col_tail,
mega_min_grid) exist here.
"""

import torch
import torch.nn as nn

from .layers import Conv2d
from ..ops.decoder_tail import decoder_tail, decoder_tail_train
from ..ops.pad_conv import reflect_pad2d
from ..ops.resize import upsample2x


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


class Decoder(nn.Module):
    def __init__(self, in_channels: int = 512, backend: str = "auto"):
        super().__init__()
        self.backend = backend
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
        up3, c5, c6 = self.up3.conv, self.c5.conv, self.c6.conv
        tail = decoder_tail_train if self.training else decoder_tail
        return tail(x.contiguous(), up3.weight, up3.bias, c5.weight, c5.bias,
                    c6.weight, c6.bias, backend=self.backend)
