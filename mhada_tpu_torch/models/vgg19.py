"""VGG19 feature extractor, the frozen loss network (mhada_tpu/models/
vgg19.py:14-52, 94-109; reference network/vgg19.py:15-70).

torchvision VGG19 ``features`` up to relu5_1, returning the relu1_1 ...
relu5_1 maps, with the ImageNet normalisation (x / 255 - mean) / std inside
the module.  NHWC; zero-padded 3x3 convs and 2x2 floor-mode max pools.  The
convs are named after the JAX tree (``conv1_1`` ... ``conv5_1``), so
``interop.params_from_jax`` carries JAX VGG params across unchanged;
``interop.import_vgg19`` reads a torchvision ``.pth``.  Weights stay
float32 and are cast to the input's dtype at use.

``VGG19Classifier`` (mhada_tpu/models/vgg19.py:55-91) is the reference's
dead classifier head, kept for parity, in plain PyTorch.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Conv2d, Linear
from ..ops.pad_conv import conv2d, max_pool2d

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

# (name, out_channels); "pool" entries are 2x2 max pools.
VGG19_PREFIX = [
    ("conv1_1", 64), ("conv1_2", 64), ("pool", 0),
    ("conv2_1", 128), ("conv2_2", 128), ("pool", 0),
    ("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256), ("conv3_4", 256),
    ("pool", 0),
    ("conv4_1", 512), ("conv4_2", 512), ("conv4_3", 512), ("conv4_4", 512),
    ("pool", 0),
    ("conv5_1", 512),
]
TAPS = {"conv1_1": "relu1_1", "conv2_1": "relu2_1", "conv3_1": "relu3_1",
        "conv4_1": "relu4_1", "conv5_1": "relu5_1"}


def imagenet_normalize(x: torch.Tensor) -> torch.Tensor:
    """0-255 NHWC -> ImageNet-normalised, in x's dtype."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=x.dtype, device=x.device)
    return (x / 255.0 - mean) / std


class VGG19Classifier(nn.Module):
    """VGG19's tail, features[30:37] + avgpool + classifier (reference
    vgg19.py:73-93): relu5_1 maps (B, H, W, 512) -> (B, 1000) logits.
    The 7 x 7 adaptive average pool is torch's bin rule, and the maps are
    flattened in NHWC (h, w, c) order as the JAX module flattens them, so
    its fc1 carries across unchanged."""

    def __init__(self):
        super().__init__()
        for name in ("conv5_2", "conv5_3", "conv5_4"):
            self.add_module(name, Conv2d(512, 512, 3))
        self.fc1 = Linear(7 * 7 * 512, 4096)
        self.fc2 = Linear(4096, 4096)
        self.fc3 = Linear(4096, 1000)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for name in ("conv5_2", "conv5_3", "conv5_4"):
            conv = getattr(self, name)
            x = torch.relu(conv2d(x, conv.weight.to(x.dtype),
                                  conv.bias.to(x.dtype), padding=1))
        x = max_pool2d(x)
        x = F.adaptive_avg_pool2d(x.permute(0, 3, 1, 2), (7, 7))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = torch.relu(self.fc1(x))
        return self.fc3(torch.relu(self.fc2(x)))


class VGG19Features(nn.Module):
    """(B, H, W, 3) in 0-255 -> {"relu1_1", ..., "relu5_1"} NHWC maps."""

    def __init__(self):
        super().__init__()
        cin = 3
        for name, ch in VGG19_PREFIX:
            if name != "pool":
                self.add_module(name, Conv2d(cin, ch, 3))
                cin = ch

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded random weights: each conv's U(+-1/sqrt(fan_in)), drawn in
        order (``layers.Conv2d.reset_parameters``).  For smoke runs
        without a torchvision ``.pth``; the convs are empty until then.
        ``layers.init_parameters`` would draw them twice: call this."""
        for name, _ in VGG19_PREFIX:
            if name != "pool":
                getattr(self, name).reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        x = imagenet_normalize(x)
        feats = {}
        for name, _ in VGG19_PREFIX:
            if name == "pool":
                x = max_pool2d(x)
                continue
            conv = getattr(self, name)
            x = torch.relu(conv2d(x, conv.weight.to(x.dtype),
                                  conv.bias.to(x.dtype), padding=1))
            if name in TAPS:
                feats[TAPS[name]] = x
        return feats
