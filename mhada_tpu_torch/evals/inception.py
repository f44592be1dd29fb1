"""InceptionV3 up to the four SIFID taps (mhada_tpu/evals/inception.py:
1-209; reference SIFID/inception.py).

Taps (SIFID/inception.py:14-19): 0 = 64 channels (before the first max
pool), 1 = 192 (before the second), 2 = 768 (before Mixed_7a), 3 = 2048
(Mixed_7c).  The input maps (0, 1) to (-1, 1) (inception.py:138).
BasicConv2d is a conv without bias, BatchNorm in eval mode with eps 1e-3,
then ReLU; the 3 x 3 average pools count the padding, the max pools are
3 x 3, stride 2, floor mode, no padding.

The modules are keyed as torchvision's ``inception_v3`` (``Conv2d_1a_3x3.
conv.weight``, ``.bn.running_mean``, ...), so its ``.pth`` loads strictly
once the parts past Mixed_7c (AuxLogits, fc) are left out.  NHWC; every
conv runs with TF32 off (``ops.pad_conv.conv2d``).
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import resolve_device
from ..ops.pad_conv import conv2d, max_pool2d

BLOCK_INDEX_BY_DIM = {64: 0, 192: 1, 768: 2, 2048: 3}


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


class BasicConv2d(nn.Module):
    def __init__(self, cin, cout, kernel_size, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel_size, stride, padding,
                              bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=0.001)

    def forward(self, x):
        y = conv2d(x, self.conv.weight, None, self.conv.stride[0],
                   _pair(self.conv.padding))
        bn = self.bn
        y = (y - bn.running_mean) * torch.rsqrt(bn.running_var + bn.eps) \
            * bn.weight + bn.bias
        return torch.relu(y)


def avg_pool3(x):
    """3 x 3, stride 1 average pool with 1 of zero padding, the padding
    counted (torchvision's default)."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 3, 1, 1).permute(0, 2, 3, 1)


def _cat(*xs):
    return torch.cat(xs, dim=-1)


class InceptionA(nn.Module):
    def __init__(self, cin, pool_features):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        return _cat(
            self.branch1x1(x),
            self.branch5x5_2(self.branch5x5_1(x)),
            self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x))),
            self.branch_pool(avg_pool3(x)))


class InceptionB(nn.Module):
    def __init__(self, cin):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        return _cat(
            self.branch3x3(x),
            self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x))),
            max_pool2d(x, 3, 2))


class InceptionC(nn.Module):
    def __init__(self, cin, c7):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for i in range(2, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        return _cat(self.branch1x1(x), b7, bd, self.branch_pool(avg_pool3(x)))


class InceptionD(nn.Module):
    def __init__(self, cin):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return _cat(self.branch3x3_2(self.branch3x3_1(x)), b7,
                    max_pool2d(x, 3, 2))


class InceptionE(nn.Module):
    def __init__(self, cin):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        return _cat(self.branch1x1(x),
                    self.branch3x3_2a(b3), self.branch3x3_2b(b3),
                    self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd),
                    self.branch_pool(avg_pool3(x)))


class InceptionV3Features(nn.Module):
    """(B, H, W, 3) in (0, 1) -> the SIFID taps up to ``last_block``
    (0..3), NHWC.  Only the modules up to that tap are built."""

    def __init__(self, last_block: int = 3):
        super().__init__()
        self.last_block = last_block
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        if last_block >= 1:
            self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
            self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        if last_block >= 2:
            self.Mixed_5b = InceptionA(192, 32)
            self.Mixed_5c = InceptionA(256, 64)
            self.Mixed_5d = InceptionA(288, 64)
            self.Mixed_6a = InceptionB(288)
            self.Mixed_6b = InceptionC(768, 128)
            self.Mixed_6c = InceptionC(768, 160)
            self.Mixed_6d = InceptionC(768, 160)
            self.Mixed_6e = InceptionC(768, 192)
        if last_block >= 3:
            self.Mixed_7a = InceptionD(768)
            self.Mixed_7b = InceptionE(1280)
            self.Mixed_7c = InceptionE(2048)

    @torch.inference_mode()
    def forward(self, x: torch.Tensor,
                last_block: int | None = None) -> list[torch.Tensor]:
        """The taps up to ``last_block`` (default: the model's own)."""
        last = self.last_block if last_block is None else min(
            last_block, self.last_block)
        x = 2.0 * x - 1.0
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        out = [x]
        stages = (
            ("Conv2d_3b_1x1", "Conv2d_4a_3x3"),
            ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b",
             "Mixed_6c", "Mixed_6d", "Mixed_6e"),
            ("Mixed_7a", "Mixed_7b", "Mixed_7c"))
        for block, names in enumerate(stages, start=1):
            if block > last:
                break
            if block <= 2:
                x = max_pool2d(x, 3, 2)
            for name in names:
                x = getattr(self, name)(x)
            out.append(x)
        return out


def inception_state(sd: dict, model: nn.Module) -> dict:
    """A torchvision inception_v3 state_dict -> the entries ``model`` has
    (AuxLogits, fc and, below tap 3, the later blocks left out)."""
    own = {k.split(".", 1)[0] for k in model.state_dict()}
    return {k: v for k, v in sd.items() if k.split(".", 1)[0] in own}


def load_inception(path: str, last_block: int = 3,
                   device="cuda") -> InceptionV3Features:
    """A torchvision ``inception_v3`` ``.pth`` -> InceptionV3Features on
    ``device``, eval mode, loaded strictly over the modules it has."""
    model = InceptionV3Features(last_block)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(inception_state(sd, model), strict=True)
    return model.to(resolve_device(device)).eval()
