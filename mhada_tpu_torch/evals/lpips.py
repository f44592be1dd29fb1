"""LPIPS perceptual distance, v0.1 with the VGG16 trunk
(mhada_tpu/evals/lpips.py:1-136; reference lpips/lpips.py:115-171).

Pipeline: RGB 0-255 -> [-1, 1] -> ScalingLayer (fixed shift and scale) ->
VGG16 features at relu1_2 / 2_2 / 3_3 / 4_3 / 5_3 -> unit-normalised over
channels (eps 1e-10 outside the square root) -> squared difference -> the
per-tap 1 x 1 heads (no bias) -> spatial mean -> sum over the taps.

Weights: a torchvision ``vgg16`` ``.pth`` (the trunk, keyed as torchvision's
``features.{i}``, so it loads strictly with no transposing) and the LPIPS
v0.1 heads ``.pth`` (``lin{k}.model.1.weight`` or ``lins.{k}...``).  Both
are user-supplied files.  NHWC; every conv in float32 runs with TF32 off.
"""

import numpy as np
import torch
import torch.nn as nn

from ..config import resolve_device
from ..ops.pad_conv import conv2d, max_pool2d

# torchvision vgg16 ``features``: "M" is a 2 x 2 max pool
VGG16_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
             512, 512, 512, "M", 512, 512, 512)
# ``features`` indices of the ReLUs after conv1_2, 2_2, 3_3, 4_3 and 5_3
TAP_RELUS = (3, 8, 15, 22, 29)
LPIPS_CHANNELS = (64, 128, 256, 512, 512)

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class VGG16Features(nn.Module):
    """vgg16 ``features`` up to relu5_3, returning the 5 LPIPS taps (NHWC);
    its state_dict keys are torchvision's ``features.{i}.weight/bias``."""

    def __init__(self):
        super().__init__()
        layers, cin = [], 3
        for v in VGG16_CFG:
            if v == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(cin, v, 3, padding=1), nn.ReLU()]
                cin = v
        self.features = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        taps = []
        for i, layer in enumerate(self.features):
            if isinstance(layer, nn.Conv2d):
                x = conv2d(x, layer.weight, layer.bias, padding=1)
            elif isinstance(layer, nn.ReLU):
                x = torch.relu(x)
                if i in TAP_RELUS:
                    taps.append(x)
            else:
                x = max_pool2d(x)
        return taps


def unit_normalize(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    norm = torch.sqrt(torch.sum(torch.square(x), dim=-1, keepdim=True))
    return x / (norm + eps)


def prep(img: torch.Tensor) -> torch.Tensor:
    """RGB 0-255 -> [-1, 1] (lpips/__init__.py:84-86) -> ScalingLayer
    (lpips.py:164-171)."""
    shift = torch.tensor(_SHIFT, device=img.device)
    scale = torch.tensor(_SCALE, device=img.device)
    return (img / (255.0 / 2.0) - 1.0 - shift) / scale


def distance_from_taps(f0, f1, lins) -> torch.Tensor:
    """Sum over taps of the head-weighted, spatially averaged squared
    difference of unit-normalised features -> (B,)."""
    val = 0.0
    for t0, t1, w in zip(f0, f1, lins):
        d = torch.square(unit_normalize(t0) - unit_normalize(t1))
        val = val + torch.mean(torch.sum(d * w, dim=-1), dim=(1, 2))
    return val


class LPIPS(nn.Module):
    """LPIPS distance on (B, H, W, 3) RGB 0-255 images -> (B,)."""

    def __init__(self):
        super().__init__()
        self.net = VGG16Features()
        self.lins = nn.ParameterList(
            nn.Parameter(torch.zeros(c)) for c in LPIPS_CHANNELS)

    @torch.inference_mode()
    def forward(self, img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
        return distance_from_taps(self.net(prep(img0)), self.net(prep(img1)),
                                  self.lins)


def vgg16_features_state(sd: dict) -> dict:
    """A torchvision vgg16 state_dict -> its ``features.*`` entries (the
    classifier is not part of the trunk)."""
    return {k: v for k, v in sd.items() if k.startswith("features.")}


def import_lin_heads(sd: dict) -> list[torch.Tensor]:
    """LPIPS v0.1 heads ``lin{k}.model.1.weight`` (1, C, 1, 1) -> (C,)
    tensors (mhada_tpu/evals/lpips.py:103-119)."""
    out = []
    for k in range(5):
        key = f"lin{k}.model.1.weight"
        if key not in sd:
            key = f"lins.{k}.model.1.weight"
        out.append(torch.as_tensor(np.asarray(sd[key]))[0, :, 0, 0].float())
    return out


def load_lpips(vgg16_path: str, heads_path: str, device="cuda") -> LPIPS:
    """Both ``.pth`` files -> an ``LPIPS`` module on ``device``, eval mode;
    the trunk loads strictly."""
    model = LPIPS()
    sd = torch.load(vgg16_path, map_location="cpu", weights_only=True)
    model.net.load_state_dict(vgg16_features_state(sd), strict=True)
    heads = torch.load(heads_path, map_location="cpu", weights_only=True)
    with torch.no_grad():
        for p, w in zip(model.lins, import_lin_heads(heads)):
            p.copy_(w)
    return model.to(resolve_device(device)).eval()


def lpips_distance(path0: str, path1: str, vgg16_path: str, heads_path: str,
                   device="cuda") -> float:
    """File-path convenience (reference eval.py:19-35: images loaded RGB at
    their own size)."""
    from .metrics import rgb_batch

    model = load_lpips(vgg16_path, heads_path, device)
    dev = resolve_device(device)
    return float(model(rgb_batch(path0, dev), rgb_batch(path1, dev))[0])
