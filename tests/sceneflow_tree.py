"""A synthetic SceneFlow tree (Monkaa and FlyingThings3D layouts) and
WikiArt folder for the port's video-training tests."""

import os

import numpy as np
from PIL import Image

from mhada_tpu_torch.data import flowlib

FLOW_HW = (24, 36)   # the tree's frames and flows


def png(path, rng, hw, channels=3):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    shape = (*hw, channels) if channels > 1 else hw
    Image.fromarray(rng.integers(0, 256, shape, np.uint8)).save(path)


def make_sceneflow_tree(root, rng, monkaa_frames=5, ft3d=True,
                        flow_ext=".pfm"):
    """Monkaa (one scene of ``monkaa_frames`` frames) and, with ``ft3d``,
    FlyingThings3D (TRAIN/A, one scene of 10 frames) under ``root``, laid
    out as tests/test_data.py:125-160 does, with random frames, smooth
    random flows (PFM files hold 3 channels), each frame's flow into the
    past the negation of the previous frame's into the future, and motion
    boundaries that are 0 except in a band."""
    yy, xx = np.mgrid[0:FLOW_HW[0], 0:FLOW_HW[1]] / max(FLOW_HW)
    layouts = [(os.path.join(root, "monkaa"), ("frames_finalpass", "sc"),
                ("optical_flow", "sc"), ("motion_boundaries", "sc"),
                monkaa_frames)]
    if ft3d:
        layouts.append((os.path.join(root, "flyingthings3d"),
                        ("frames_finalpass/TRAIN", "A", "0000"),
                        ("optical_flow/TRAIN", "A", "0000"),
                        ("motion_boundaries/TRAIN", "A", "0000"), 10))
    for base, frames, flows, motion, n in layouts:
        past = None
        for i in range(n):
            png(os.path.join(base, *frames, "left", f"{i:04d}.png"), rng,
                FLOW_HW)
            # a smooth flow into the next frame; its negation is that
            # frame's flow into the past, so most pixels are consistent
            a, b = rng.normal(0, 3, 2)
            future = np.stack([a * np.sin(6 * yy + i) + b * xx,
                               b * np.cos(5 * xx) - a * yy,
                               np.zeros_like(xx)], -1).astype(np.float32)
            for d, flow in (("into_future", future),
                            ("into_past", -future if past is None else past)):
                path = os.path.join(base, *flows, d, "left", f"{i:04d}")
                os.makedirs(os.path.dirname(path), exist_ok=True)
                if flow_ext == ".pfm":
                    flowlib.write_pfm(path + ".pfm", flow)
                else:
                    flowlib.write_flow(path + ".flo", flow[..., :2])
            past = -future
            mb = np.zeros(FLOW_HW, np.uint8)
            mb[:, 5 + i: 8 + i] = 255
            path = os.path.join(base, *motion, "into_future", "left",
                                f"{i:04d}.png")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            Image.fromarray(mb).save(path)


def make_video_datasets(root, rng, styles=3):
    """``root``/SceneFlowDatasets (Monkaa, 5 frames: 4 samples) and
    ``root``/WikiArt (``styles`` PNGs of 40 x 30), as
    ``FlyingThings3DMonkaaWikiArt`` reads them."""
    make_sceneflow_tree(os.path.join(root, "SceneFlowDatasets"), rng,
                        ft3d=False)
    for i in range(styles):
        png(os.path.join(root, "WikiArt", "cls", f"{i}.png"), rng, (40, 30))
