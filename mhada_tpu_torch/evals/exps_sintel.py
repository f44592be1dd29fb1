"""MPI-Sintel per-scene temporal-consistency eval (mhada_tpu/evals/
exps_sintel.py:1-136; reference exps_sintel.py).

For each scene: stylise consecutive frame pairs against one style
encoding, scale the outputs to [0, 1] (exps_sintel.py:91-92), and
accumulate the masked MAE optical loss aggregated as sqrt(sum_t loss) / T
(exps_sintel.py:100-119; ``mode="mse"`` gives the exps_sintel_all.py
variant).  Writes ``sintel_results.csv`` in the reference's schema
(exps_sintel.py:131-135).
"""

import csv
import os
from typing import Callable, Optional

import numpy as np
import torch

from ..data.flow_np import warp_np
from ..data.sintel import Sintel

DEFAULT_SCENES = ["alley_2", "ambush_5", "bandage_2", "market_6", "temple_2"]


def evaluate_scene(dataset: Sintel, stylize_pair: Callable,
                   mode: str = "mae") -> float:
    optical_loss = 0.0
    count = 0
    for idx in range(len(dataset)):
        c1, c2, flow, mask = dataset[idx]
        cs1, cs2 = stylize_pair(c1, c2)
        cs1 = np.asarray(cs1) / 255.0
        cs2 = np.asarray(cs2) / 255.0
        warped_cs1 = warp_np(cs1.astype(np.float32), flow)
        diff = cs2 - warped_cs1
        err = np.abs(diff) if mode == "mae" else diff**2
        C, H, W = cs1.shape[2], cs1.shape[0], cs1.shape[1]
        optical_loss += float(np.sum(mask[..., None] * err)) / (C * H * W)
        count += 1
    return float(np.sqrt(optical_loss)) / count


def run(models: dict, style_hwc: np.ndarray, sintel_path: str,
        scenes: list[str] = DEFAULT_SCENES, image_size=(360, 640),
        flow_dir: Optional[str] = None, flow_fn: Optional[Callable] = None,
        results_csv: Optional[str] = "./results/sintel_results.csv",
        mode: str = "mae", dtype=torch.float32) -> dict[str, float]:
    from .exps_video import make_stylize_pair_fn

    stylize_pair = make_stylize_pair_fn(models, style_hwc, dtype)
    results = {}
    for scene in scenes:
        ds = Sintel(image_size, sintel_path, scene=scene,
                    flow_dir=flow_dir, flow_fn=flow_fn)
        results[scene] = evaluate_scene(ds, stylize_pair, mode)
        print(f"  {scene}: {results[scene]:.4f}")
    if results_csv:
        os.makedirs(os.path.dirname(results_csv) or ".", exist_ok=True)
        with open(results_csv, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["Scene", "Optical Flow Loss"])
            for scene, loss in results.items():
                w.writerow([scene, loss])
    return results


def main(argv=None):
    import argparse

    from ..infer.image import DTYPES, add_model_args, models_from_args
    from ..utils.image_io import list_folders, load_image

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--sintel", default="../datasets/MPI-Sintel-complete")
    ap.add_argument("--style", required=True)
    ap.add_argument("--style-size", type=int, nargs=2, default=(256, 256))
    ap.add_argument("--size", type=int, nargs=2, default=(360, 640))
    ap.add_argument("--scenes", nargs="*", default=DEFAULT_SCENES,
                    help="'all' for every scene (exps_sintel_all behaviour)")
    ap.add_argument("--mode", default="mae", choices=["mae", "mse"])
    ap.add_argument("--flow-dir", help="precomputed flows")
    ap.add_argument("--flow", default="farneback",
                    help="flow backend when --flow-dir is absent: "
                    "'farneback' or 'raft[:weights.pth]' (the reference "
                    "protocol)")
    ap.add_argument("--csv", default="./results/sintel_results.csv")
    add_model_args(ap)
    args = ap.parse_args(argv)

    models = models_from_args(ap, args)
    style = load_image(args.style, tuple(args.style_size))
    scenes = args.scenes
    if scenes == ["all"]:
        scenes = [os.path.basename(p) for p in
                  list_folders(os.path.join(args.sintel, "training/final"))]
    flow_fn = None
    if not args.flow_dir:
        from .exps_video import make_flow_fn

        flow_fn = make_flow_fn(args.flow, args.device)
    results = run(models, style, args.sintel, scenes=scenes,
                  image_size=tuple(args.size), flow_dir=args.flow_dir,
                  flow_fn=flow_fn, results_csv=args.csv, mode=args.mode,
                  dtype=DTYPES[args.dtype])
    print("Final Results:")
    for scene, loss in results.items():
        print(f"  {scene}: {loss:.4f}")


if __name__ == "__main__":
    main()
