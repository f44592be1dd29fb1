"""Seeded inputs for the port's eval tests: pictures, and random
torchvision-layout backbone ``.pth`` files made by the plain-torch
restatements in tests/torch_backbones.py."""

import os

import numpy as np
import torch
from PIL import Image

from tests import torch_backbones as tb

LPIPS_CHANNELS = (64, 128, 256, 512, 512)


def picture(rng, hw, noise=8.0):
    """A smooth RGB picture with noise, uint8."""
    yy, xx = np.mgrid[0:hw[0], 0:hw[1]] / max(hw)
    a = np.stack([127.5 + 110 * np.sin(6.3 * (xx + c) * (yy + 1) + c)
                  for c in range(3)], -1)
    return np.clip(a + rng.normal(0, noise, a.shape), 0, 255).astype(np.uint8)


def save_picture(path, rng, hw, noise=20.0):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray(picture(rng, hw, noise)).save(path)


def backbone_weights(d) -> dict[str, str]:
    """vgg16 (with a classifier, as torchvision's file has), vgg19 and
    inception_v3 state_dicts from seeds, and the LPIPS v0.1 heads as
    ``lin{k}.model.1.weight`` (``heads``) and ``lins.{k}...``
    (``heads_lins``), saved under ``d`` -> {name: path}."""
    out = {}
    for name, ref, seed in (("vgg16", tb.VGG16Ref(), 2),
                            ("vgg19", tb.VGG19Ref(), 1),
                            ("inception", tb.InceptionV3Ref(), 4)):
        tb._randomize(ref, seed)
        sd = ref.state_dict()
        if name == "vgg16":
            g = torch.Generator().manual_seed(5)
            sd = {**sd, "classifier.0.weight": torch.randn(8, 4, generator=g),
                  "classifier.0.bias": torch.zeros(8)}
        out[name] = os.path.join(d, f"{name}.pth")
        torch.save(sd, out[name])
    rng = np.random.default_rng(3)
    heads = {f"lin{k}.model.1.weight": torch.from_numpy(
        np.abs(rng.standard_normal((1, c, 1, 1))).astype(np.float32) * 0.05)
        for k, c in enumerate(LPIPS_CHANNELS)}
    out["heads"] = os.path.join(d, "heads.pth")
    torch.save(heads, out["heads"])
    out["heads_lins"] = os.path.join(d, "heads_lins.pth")
    torch.save({k.replace("lin", "lins.", 1): v for k, v in heads.items()},
               out["heads_lins"])
    return out
