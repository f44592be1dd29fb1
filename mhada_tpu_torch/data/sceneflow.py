"""SceneFlow video-training datasets (mhada_tpu/data/sceneflow.py:57-193;
reference datasets.py:129-390), numpy and PIL.

FlyingThings3D and Monkaa give consecutive left-view frame pairs with their
ground-truth flows (.pfm or .flo), each flow resized to the working
resolution with its vectors rescaled, and a validity mask: the
forward-backward consistency mask times the inverted motion-boundary mask.
Items are float32 HWC tuples ``(img1, img2, flow_into_past, mask)``.  The
JAX package may read through its C library (``data/native.py``), a host
speed-up; the port reads through numpy.
"""

import os
import random

import numpy as np
import torch
from PIL import Image

from . import flowlib
from .flow_np import flow_warp_mask_np, resize_flow_np
from .image_folder import ImageFolder


def list_files(directory: str) -> list[str]:
    """The files of ``directory``, sorted by path (mhada_tpu/utils/
    image_io.py:75-76)."""
    return sorted(f.path for f in os.scandir(directory) if f.is_file())


def _load_frame(path: str, resolution_wh) -> np.ndarray:
    with Image.open(path) as img:
        img = img.convert("RGB").resize(resolution_wh, Image.BILINEAR)
        return np.asarray(img, dtype=np.float32)


def _load_motion_mask(path: str, resolution_wh) -> np.ndarray:
    """Motion boundaries -> inverted binary mask (datasets.py:224-227)."""
    with Image.open(path) as img:
        arr = np.asarray(img.resize(resolution_wh, Image.BILINEAR))
    if arr.ndim == 3:
        arr = arr[..., 0]
    return (arr == 0).astype(np.float32)


class _SceneFlowBase:
    """``__getitem__`` over per-sample frame paths, (forward, backward)
    flow paths and motion-boundary paths."""

    frame: list
    flow: list
    motion: list
    resolution: tuple[int, int]   # (W, H)
    frame_num: int

    def __len__(self) -> int:
        return len(self.frame)

    def __getitem__(self, idx: int):
        res = self.resolution
        imgs = [_load_frame(p, res) for p in self.frame[idx]]
        img1 = np.concatenate(imgs[: self.frame_num], axis=-1)
        img2 = np.concatenate(imgs[1: self.frame_num + 1], axis=-1)
        out_hw = (res[1], res[0])
        flow_fwd, flow_bwd = (resize_flow_np(flowlib.read_flow(p), out_hw)
                              for p in self.flow[idx])
        mask = (flow_warp_mask_np(flow_fwd, flow_bwd)
                * _load_motion_mask(self.motion[idx], res))
        return img1, img2, flow_bwd, mask


def _pairs(ds: _SceneFlowBase, frames, future, past, motion, count):
    """Sample i: frames i .. i + frame_num, the forward flow of the first
    frame and the backward flow of the second (datasets.py:169)."""
    n = ds.frame_num
    for i in range(count):
        ds.frame.append(frames[i: i + n + 1])
        ds.flow.append((future[i + n - 1], past[i + n]))
        ds.motion.append(motion[i + n])


class FlyingThings3D(_SceneFlowBase):
    """frames_finalpass/TRAIN/{A,B,C} scenes of 10 frames (reference
    datasets.py:129-233); a missing letter is skipped."""

    def __init__(self, path: str, resolution=(512, 256), frame_num: int = 1):
        if not 1 <= frame_num <= 9:
            raise ValueError(f"frame_num {frame_num} not in 1..9")
        self.resolution, self.frame_num = resolution, frame_num
        self.frame, self.flow, self.motion = [], [], []
        pf = os.path.join(path, "frames_finalpass/TRAIN")
        pfl = os.path.join(path, "optical_flow/TRAIN")
        pm = os.path.join(path, "motion_boundaries/TRAIN")
        for sub in ("A", "B", "C"):
            if not os.path.isdir(os.path.join(pf, sub)):
                continue
            for scene in sorted(os.listdir(os.path.join(pf, sub))):
                flows = os.path.join(pfl, sub, scene)
                _pairs(self, list_files(os.path.join(pf, sub, scene, "left")),
                       list_files(os.path.join(flows, "into_future", "left")),
                       list_files(os.path.join(flows, "into_past", "left")),
                       list_files(os.path.join(pm, sub, scene, "into_future",
                                               "left")),
                       10 - frame_num)


class Monkaa(_SceneFlowBase):
    """The Monkaa scenes (reference datasets.py:236-340)."""

    def __init__(self, path: str, resolution=(512, 256), frame_num: int = 1):
        if not 1 <= frame_num <= 9:
            raise ValueError(f"frame_num {frame_num} not in 1..9")
        self.resolution, self.frame_num = resolution, frame_num
        self.frame, self.flow, self.motion = [], [], []
        pf = os.path.join(path, "frames_finalpass")
        pfl = os.path.join(path, "optical_flow")
        pm = os.path.join(path, "motion_boundaries")
        for scene in sorted(os.listdir(pf)):
            files = list_files(os.path.join(pf, scene, "left"))
            _pairs(self, files,
                   list_files(os.path.join(pfl, scene, "into_future", "left")),
                   list_files(os.path.join(pfl, scene, "into_past", "left")),
                   list_files(os.path.join(pm, scene, "into_future", "left")),
                   len(files) - frame_num)


class FlyingThings3DMonkaa:
    """Monkaa's samples, then FlyingThings3D's (reference datasets.py:
    343-370).  ``path``: the root holding monkaa/ and flyingthings3d/, or
    a [monkaa, flyingthings3d] pair of roots."""

    def __init__(self, path, resolution=(512, 256), frame_num: int = 1):
        if isinstance(path, str):
            path = [os.path.join(path, "monkaa"),
                    os.path.join(path, "flyingthings3d")]
        self.monkaa = Monkaa(path[0], resolution, frame_num)
        self.ft3d = FlyingThings3D(path[1], resolution, frame_num)

    def __len__(self) -> int:
        return len(self.monkaa) + len(self.ft3d)

    def __getitem__(self, idx: int):
        if idx < len(self.monkaa):
            return self.monkaa[idx]
        return self.ft3d[idx - len(self.monkaa)]


class FlyingThings3DMonkaaWikiArt:
    """Video training's dataset: a uniformly random WikiArt style (resized
    to 512^2, cropped to ``image_size1``) with each SceneFlow sample at
    ``image_size2`` (H, W) (reference datasets.py:373-390); unseeded
    unless ``seed`` is given."""

    def __init__(self, image_size1=(256, 256), image_size2=(256, 512),
                 path: str = "../datasets", seed: int | None = None):
        rng = random.Random(seed) if seed is not None else None
        self.wikiart = ImageFolder(os.path.join(path, "WikiArt"), (512, 512),
                                   image_size1, rng)
        self.sceneflow = FlyingThings3DMonkaa(
            os.path.join(path, "SceneFlowDatasets"),
            resolution=(image_size2[1], image_size2[0]))
        self._rng = rng   # None: ``random``, looked up at use (picklable)

    def __len__(self) -> int:
        return len(self.sceneflow)

    def __getitem__(self, idx: int):
        rng = self._rng or random
        style = self.wikiart[rng.randint(0, len(self.wikiart) - 1)]
        return (style, *self.sceneflow[idx])


def collate_video(items):
    """[(style, c1, c2, flow, mask)] -> (style, c1, c2) as (B, H, W, 3)
    uint8 (decoded pixels are integral, so lossless) and flow (B, H, W, 2)
    and mask (B, H, W) as float32: both are fractional, and the flow signed
    (mhada_tpu/train/run_video.py:128-141)."""
    cols = [np.stack(col) for col in zip(*items)]
    return (*(torch.from_numpy(c.astype(np.uint8)) for c in cols[:3]),
            *(torch.from_numpy(c.astype(np.float32)) for c in cols[3:]))
