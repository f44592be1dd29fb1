"""An ImageFolder and the reference's train-time transform with numpy and PIL
(mhada_tpu/data/image_folder.py; reference utilities.py:28-40,
datasets.py:17-30): Resize(512, 512) -> RandomCrop(256, 256) -> HWC float32
0-255.  Neither machine has torchvision.
"""

import os
import random

import numpy as np
from PIL import Image

_IMG_EXT = {".jpg", ".jpeg", ".png", ".bmp", ".webp", ".ppm", ".tif", ".tiff"}


def _scan_images(root: str) -> list[str]:
    files = []
    for dirpath, _dirnames, filenames in sorted(os.walk(root)):
        files += [os.path.join(dirpath, fn) for fn in sorted(filenames)
                  if os.path.splitext(fn)[1].lower() in _IMG_EXT]
    return files


def resize_crop_255(img: Image.Image, size_resize=(512, 512),
                    size_crop=(256, 256),
                    rng: random.Random | None = None) -> np.ndarray:
    """Bilinear resize to ``size_resize`` (both dims forced), then a random
    ``size_crop`` crop with a uniform top-left corner -> HWC float32 0-255.
    The reference's crop is unseeded; pass ``rng`` to reproduce one."""
    rng = rng or random
    rh, rw = size_resize
    ch, cw = size_crop
    img = img.convert("RGB").resize((rw, rh), Image.BILINEAR)
    top = rng.randint(0, rh - ch) if rh > ch else 0
    left = rng.randint(0, rw - cw) if rw > cw else 0
    return np.asarray(img.crop((left, top, left + cw, top + ch)),
                      dtype=np.float32)


class ImageFolder:
    """Every image under ``root``, recursively (class dirs or flat)."""

    def __init__(self, root: str, size_resize=(512, 512),
                 size_crop=(256, 256), rng: random.Random | None = None):
        self.root = root
        self.files = _scan_images(root)
        if not self.files:
            raise FileNotFoundError(f"no images under {root}")
        self.size_resize = size_resize
        self.size_crop = size_crop
        self.rng = rng

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, idx: int) -> np.ndarray:
        with Image.open(self.files[idx]) as img:
            return resize_crop_255(img, self.size_resize, self.size_crop,
                                   self.rng)
