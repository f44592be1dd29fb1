"""Video temporal-consistency eval (mhada_tpu/evals/exps_video.py:1-164;
reference exps_video.py).

Per consecutive frame pair of a clip: stylise both frames against one
style encoding (``make_stylize_with_fs_fn``: K1, K2, K4 and K5 on the
card), compute the content flows (forward and backward) and the stylised
pair's backward flow with a pluggable ``flow_fn`` (the reference uses
RAFT-large), then accumulate:

- Warping Error = sqrt(sum_t [ sum(mask * (cs2 - warp(cs1, flow_bwd))^2)
                               / (C*H*W) ] / T)        (exps_video.py:109-133)
- Flow MSE      = mean_t MSE(flow_bwd(content), flow_bwd(stylised))
                                                       (exps_video.py:117,135)
"""

from typing import Callable, Iterable, Tuple

import numpy as np
import torch

from ..data.flow_np import flow_warp_mask_np, warp_np


def video_frame_pairs(video_path: str, resize_wh: Tuple[int, int]) -> Iterable:
    """Yield consecutive RGB float32 frame pairs from a video file."""
    import cv2

    from ..utils.image_io import cv2_to_tensor

    cap = cv2.VideoCapture(video_path)
    try:
        prev = None
        while True:
            ret, frame = cap.read()
            if not ret:
                break
            cur = cv2_to_tensor(frame, resize=resize_wh)
            if prev is not None:
                yield prev, cur
            prev = cur
    finally:
        cap.release()


def evaluate_clip(frame_pairs: Iterable, stylize_pair: Callable,
                  flow_fn: Callable) -> dict[str, float]:
    """frame_pairs yields (c1, c2) HWC 0-255; ``stylize_pair(c1, c2)``
    returns clamped (cs1, cs2) arrays; ``flow_fn(a, b)`` returns the flow
    of a <- b in pixels."""
    warping_error = 0.0
    flow_mse = 0.0
    count = 0
    for c1, c2 in frame_pairs:
        cs1, cs2 = stylize_pair(c1, c2)
        c_flow_01 = flow_fn(c1, c2)
        c_flow_10 = flow_fn(c2, c1)
        cs_flow_10 = flow_fn(cs2, cs1)

        mask = flow_warp_mask_np(c_flow_01, c_flow_10)
        warped_cs1 = warp_np(cs1, c_flow_10)
        C = cs1.shape[-1]
        H, W = cs1.shape[0], cs1.shape[1]
        num = np.sum(mask[..., None] * (cs2 - warped_cs1) ** 2)
        warping_error += num / (C * H * W)
        flow_mse += float(np.mean((c_flow_10 - cs_flow_10) ** 2))
        count += 1
    return {
        "warping_error": float(np.sqrt(warping_error / count)),
        "flow_mse": flow_mse / count,
        "frames": count,
    }


def make_flow_fn(backend: str = "farneback", device="cuda"):
    """Flow backend factory.

    - ``"raft"`` / ``"raft:<weights.pth>"``: the port's RAFT-large on a
      torchvision ``raft_large`` .pth, on ``device`` (the reference
      protocol, exps_video.py:45); without a path, the
      ``MHADA_RAFT_WEIGHTS`` variable names it.
    - ``"farneback"``: the weight-free classical stand-in (its numbers are
      NOT comparable to the reference protocol's).
    """
    import os

    from ..data.flow_models import farneback_flow_fn, make_raft_flow_fn

    if backend == "farneback":
        return farneback_flow_fn()
    if backend.startswith("raft"):
        path = (backend.split(":", 1)[1] if ":" in backend
                else os.environ.get("MHADA_RAFT_WEIGHTS"))
        if not path:
            raise ValueError(
                "raft backend needs weights: use 'raft:<raft_large.pth>' or "
                "set MHADA_RAFT_WEIGHTS")
        return make_raft_flow_fn(path, device=device)
    raise ValueError(f"unknown flow backend: {backend}")


def make_stylize_pair_fn(models: dict, style_hwc: np.ndarray,
                         dtype: torch.dtype = torch.float32) -> Callable:
    """Shared-style two-frame stylizer: the style encoded once
    (exps_video.py:52-58, infer_video.py:58-61), each frame through
    ``make_stylize_with_fs_fn`` on the models' device -> HWC float32 numpy
    frames clamped to [0, 255]."""
    from ..infer.image import make_encode_style_fn, make_stylize_with_fs_fn

    device = next(models["vit_c"].parameters()).device

    def batch(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32))[None] \
            .to(device)

    fs = make_encode_style_fn(models, dtype)(batch(style_hwc))
    fn = make_stylize_with_fs_fn(models, dtype)

    def stylize_pair(c1, c2):
        return tuple(fn(batch(c), fs)[0].cpu().numpy() for c in (c1, c2))

    return stylize_pair


def main(argv=None):
    import argparse
    import itertools

    from ..infer.image import DTYPES, add_model_args, models_from_args
    from ..utils.image_io import load_image

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--video", required=True)
    ap.add_argument("--style", required=True)
    ap.add_argument("--size", type=int, nargs=2, default=(256, 512),
                    help="content H W")
    ap.add_argument("--style-size", type=int, nargs=2, default=(256, 256))
    ap.add_argument("--flow", default="farneback",
                    help="flow backend: 'farneback' or 'raft[:weights.pth]' "
                    "(the reference uses RAFT)")
    ap.add_argument("--max-pairs", type=int, default=0)
    add_model_args(ap)
    args = ap.parse_args(argv)

    models = models_from_args(ap, args)
    style = load_image(args.style, tuple(args.style_size))
    stylize_pair = make_stylize_pair_fn(models, style, DTYPES[args.dtype])
    pairs = video_frame_pairs(args.video, (args.size[1], args.size[0]))
    if args.max_pairs:
        pairs = itertools.islice(pairs, args.max_pairs)
    out = evaluate_clip(pairs, stylize_pair,
                        make_flow_fn(args.flow, args.device))
    print(f"Warping Error: {out['warping_error']}")
    print(f"Flow MSE: {out['flow_mse']}")


if __name__ == "__main__":
    main()
