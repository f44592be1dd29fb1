"""Optical-flow backends for the eval datasets (mhada_tpu/data/
flow_models.py:1-81).

The reference computes flow with torchvision RAFT-large (datasets.py:98,
exps_video.py:45); its weights are a user-supplied file.  The ``flow_fn``
plug points:

- ``farneback_flow_fn``: classical dense flow (cv2, no weights), the
  stand-in that runs everywhere.  Its numbers differ from RAFT's: record
  the backend beside any published metric.
- ``raft_flow_fn`` wraps a flow model; ``make_raft_flow_fn`` builds it
  from the port's RAFT-large (``models.raft``) on a torchvision
  ``raft_large`` ``.pth``, on the card unless the caller asks for the CPU:
  the reference protocol.

Every flow fn maps (img1_rgb_255, img2_rgb_255), HWC float32, to the
(H, W, 2) pixel flow of img1 -> img2.
"""

import os
from typing import Callable

import numpy as np
import torch


def farneback_flow_fn(pyr_scale=0.5, levels=4, winsize=21, iterations=3,
                      poly_n=7, poly_sigma=1.5) -> Callable:
    import cv2

    def fn(img1: np.ndarray, img2: np.ndarray) -> np.ndarray:
        g1 = cv2.cvtColor(img1.astype(np.uint8), cv2.COLOR_RGB2GRAY)
        g2 = cv2.cvtColor(img2.astype(np.uint8), cv2.COLOR_RGB2GRAY)
        return cv2.calcOpticalFlowFarneback(
            g1, g2, None, pyr_scale, levels, winsize, iterations,
            poly_n, poly_sigma, 0,
        ).astype(np.float32)

    return fn


def raft_flow_fn(apply_fn: Callable, device) -> Callable:
    """Wrap a flow model taking (1, H, W, 3) image pairs in [-1, 1] on
    ``device`` (the reference's raftTransforms domain, utilities.py:19-26)
    and returning (1, H, W, 2)."""

    def fn(img1: np.ndarray, img2: np.ndarray) -> np.ndarray:
        a, b = (torch.from_numpy(np.ascontiguousarray(
            img / 255.0 * 2.0 - 1.0, np.float32))[None].to(device)
            for img in (img1, img2))
        return apply_fn(a, b)[0].cpu().numpy()

    return fn


def make_raft_flow_fn(weights_path: str, num_iters: int = 12,
                      device="cuda") -> Callable:
    """Reference-protocol flow: RAFT-large on a torchvision ``raft_large``
    ``.pth`` (reference datasets.py:98-121, exps_video.py:45-46; the last
    of ``num_iters`` recurrent updates), on ``device``."""
    from ..models.raft import load_raft

    model = load_raft(weights_path, device)
    return raft_flow_fn(lambda a, b: model(a, b, num_iters),
                        next(model.parameters()).device)


def default_flow_fn(raft_weights: str | None = None,
                    device="cuda") -> Callable:
    """RAFT when weights are given (the reference protocol), else Farnebäck.
    ``raft_weights`` defaults to the ``MHADA_RAFT_WEIGHTS`` variable."""
    path = raft_weights or os.environ.get("MHADA_RAFT_WEIGHTS")
    if path:
        return make_raft_flow_fn(path, device=device)
    return farneback_flow_fn()
