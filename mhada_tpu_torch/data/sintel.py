"""MPI-Sintel evaluation dataset (mhada_tpu/data/sintel.py:1-112;
reference datasets.py:72-126).

Walks ``training/final[/scene]`` into consecutive-frame pairs and returns
``(img1, img2, flow_into_past, mask)`` at the working resolution, frames
PIL-bilinear resized.  Flow comes from a ``flow_fn(img1_255, img2_255) ->
(H, W, 2)`` callback (a flow model, called twice per item) or from
``flow_dir``, precomputed ``{scene}_{i:04d}_{fwd|bwd}.flo`` files (made
once by ``precompute_sintel_flows``).  The consistency mask is the
reference's (utilities.py:121-151, threshold 2), ``flow_np.
flow_warp_mask_np``.
"""

import os
from typing import Callable, Optional, Tuple

import numpy as np

from . import flowlib
from .flow_np import flow_warp_mask_np
from ..utils.image_io import list_files, list_folders


class Sintel:
    def __init__(
        self,
        image_size: Tuple[int, int] = (256, 512),
        path: str = "../datasets/MPI-Sintel-complete",
        scene: str = "all",
        flow_fn: Optional[Callable] = None,
        flow_dir: Optional[str] = None,
    ):
        base = os.path.join(path, "training/final")
        root = base if scene == "all" else os.path.join(base, scene)
        if not os.path.exists(root):
            raise FileNotFoundError(f"Path {root} does not exist.")
        self.image_size = image_size
        self.resolution = (image_size[1], image_size[0])  # (W, H)
        self.flow_fn = flow_fn
        self.flow_dir = flow_dir

        self.frame = []
        self.meta = []  # (scene_name, pair_index)
        folders = list_folders(root) if scene == "all" else [root]
        for folder in folders:
            files = list_files(folder)
            name = os.path.basename(folder)
            for i in range(len(files) - 1):
                self.frame.append(files[i : i + 2])
                self.meta.append((name, i))

    def __len__(self):
        return len(self.frame)

    def load(self, path: str) -> np.ndarray:
        """A frame as RGB float32 0-255 at the working resolution."""
        from PIL import Image

        img = Image.open(path).convert("RGB").resize(self.resolution,
                                                     Image.BILINEAR)
        return np.asarray(img, dtype=np.float32)

    def _flows(self, img1, img2, idx):
        if self.flow_dir is not None:
            scene, i = self.meta[idx]
            return tuple(
                flowlib.read_flow(os.path.join(
                    self.flow_dir, f"{scene}_{i:04d}_{d}.flo"))
                for d in ("fwd", "bwd"))
        if self.flow_fn is not None:
            return self.flow_fn(img1, img2), self.flow_fn(img2, img1)
        raise RuntimeError(
            "Sintel needs flow: pass flow_fn (a flow model) or flow_dir "
            "(precomputed .flo files)"
        )

    def __getitem__(self, idx: int):
        p1, p2 = self.frame[idx]
        img1, img2 = self.load(p1), self.load(p2)
        flow_into_future, flow_into_past = self._flows(img1, img2, idx)
        mask = flow_warp_mask_np(flow_into_future, flow_into_past)
        return img1, img2, flow_into_past, mask


def precompute_sintel_flows(dataset: Sintel, flow_fn: Callable,
                            out_dir: str) -> None:
    """One-time flow precomputation so eval runs need no flow model."""
    os.makedirs(out_dir, exist_ok=True)
    for idx in range(len(dataset)):
        scene, i = dataset.meta[idx]
        img1, img2 = (dataset.load(p) for p in dataset.frame[idx])
        flowlib.write_flow(os.path.join(out_dir, f"{scene}_{i:04d}_fwd.flo"),
                           flow_fn(img1, img2))
        flowlib.write_flow(os.path.join(out_dir, f"{scene}_{i:04d}_bwd.flo"),
                           flow_fn(img2, img1))
