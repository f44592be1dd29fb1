"""The two training recipes, looked up by their config's type: what a
caller that drives either one (``bench_steps``, the chip smoke script)
needs to know of it.

``loss_fn(models, *batch, cfg)`` and ``make_step(cfg, models, optimizers)``
take the recipe's batch: (content, style) for the image recipe, (style, c1,
c2, flow, mask) for the video recipe, whose first ``images`` entries are
0-255 images and the rest float32 data.
"""

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..config import ImageTrainConfig, VideoTrainConfig
from .train_image import image_loss_fn, make_image_train_step
from .train_video import make_video_train_step, video_loss_fn


def _image_batch(cfg, device, rng: np.random.Generator) -> list:
    return [_pixels(rng, cfg.batch_size, cfg.image_size, device)
            for _ in range(2)]


def _video_batch(cfg, device, rng: np.random.Generator) -> list:
    b, (h, w) = cfg.batch_size, cfg.content_size
    images = [_pixels(rng, b, hw, device) for hw in (
        cfg.style_size, cfg.content_size, cfg.content_size)]
    flow = rng.uniform(-5, 5, (b, h, w, 2)).astype(np.float32)
    mask = (rng.uniform(0, 1, (b, h, w)) > 0.2).astype(np.float32)
    return images + [torch.from_numpy(a).to(device) for a in (flow, mask)]


def _pixels(rng, b, hw, device):
    return torch.from_numpy(rng.uniform(0, 255, (b, *hw, 3)).astype(
        np.float32)).to(device)


@dataclass(frozen=True)
class Recipe:
    loss_fn: Callable
    make_step: Callable
    # (cfg, device, rng) -> a batch: pixels U(0, 255); the video recipe's
    # flow U(-5, 5) and mask U(0, 1) > 0.2, as the JAX bench's
    # (mhada_tpu/train/bench_steps.py:76-79)
    random_batch: Callable
    # cfg -> the batch's (height, width) sizes, by name
    shapes: Callable
    # the leading batch entries that are images
    images: int


RECIPES = {
    ImageTrainConfig: Recipe(
        image_loss_fn, make_image_train_step, _image_batch,
        lambda cfg: {"image_size": list(cfg.image_size)}, images=2),
    VideoTrainConfig: Recipe(
        video_loss_fn, make_video_train_step, _video_batch,
        lambda cfg: {"content_size": list(cfg.content_size),
                     "style_size": list(cfg.style_size)}, images=3),
}


def recipe(cfg) -> Recipe:
    return RECIPES[type(cfg)]
