"""COCO contents paired with WikiArt styles (mhada_tpu/data/coco_wikiart.py;
reference datasets.py:17-45): each content image with a uniformly random
style, unseeded unless ``seed`` is given.  ``ImageNet1k`` (coco_wikiart.py:
38-72) is the reference's dataset for its unused VGG19 classifier."""

import os
import random

import numpy as np
import torch

from .image_folder import ImageFolder


class CocoWikiArt:
    def __init__(self, image_size=(256, 256), coco_path="../datasets/coco",
                 wikiart_path="../datasets/WikiArt", seed: int | None = None):
        rng = random.Random(seed) if seed is not None else None
        self.coco = ImageFolder(coco_path, (512, 512), image_size, rng)
        self.wikiart = ImageFolder(wikiart_path, (512, 512), image_size, rng)
        # None: the module's generator, looked up at use, so that the
        # dataset pickles into the loader's spawned workers
        self._rng = rng

    def __len__(self) -> int:
        return len(self.coco)

    def __getitem__(self, idx: int):
        style_idx = (self._rng or random).randint(0, len(self.wikiart) - 1)
        return self.coco[idx], self.wikiart[style_idx]


class ImageNet1k:
    """ImageNet with one-hot float32 labels of length 1000 (reference
    datasets.py:48-69); the class is the first-level folder under
    ``path/mode``, indexed in sorted order."""

    def __init__(self, image_size=(256, 256), path="../datasets/ImageNet1K",
                 mode: str = "train", seed: int | None = None):
        root = os.path.join(path, mode)
        rng = random.Random(seed) if seed is not None else None
        if mode == "train":
            self.ds = ImageFolder(root, (300, 300), image_size, rng)
        elif mode == "val":
            self.ds = ImageFolder(root, (256, 256), (256, 256), rng)
        else:
            raise ValueError("Mode must be 'train' or 'val'.")
        classes = sorted({self._class(f, root) for f in self.ds.files})
        self._class_idx = {c: i for i, c in enumerate(classes)}
        self._root = root

    @staticmethod
    def _class(path: str, root: str) -> str:
        return os.path.relpath(path, root).split(os.sep)[0]

    def __len__(self) -> int:
        return len(self.ds)

    def __getitem__(self, idx: int):
        label = np.zeros(1000, np.float32)
        label[self._class_idx[self._class(self.ds.files[idx],
                                          self._root)]] = 1.0
        return self.ds[idx], label


def make_loader(dataset, batch_size: int, seed: int | None = None,
                collate_fn=None) -> torch.utils.data.DataLoader:
    """Shuffled full batches from 4 spawned workers, each two batches ahead
    (mhada_tpu/train/run_image.py's 4 workers, prefetch 2), collated by
    ``collate_fn`` (default: every column as uint8 pixels)."""
    gen = torch.Generator().manual_seed(seed) if seed is not None else None
    return torch.utils.data.DataLoader(
        dataset, batch_size, shuffle=True, drop_last=True, generator=gen,
        num_workers=4, prefetch_factor=2, multiprocessing_context="spawn",
        collate_fn=collate_fn or _collate)


def _collate(items):
    """[(content, style) HWC float32 0-255] -> two (B, H, W, 3) uint8
    tensors: decoded pixels are integral, so uint8 is lossless and quarters
    the host-to-device bytes (mhada_tpu/train/run_image.py:118-124)."""
    return tuple(torch.from_numpy(np.stack(col).astype(np.uint8))
                 for col in zip(*items))
