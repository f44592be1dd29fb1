"""Fixed-pair image quality sweep (mhada_tpu/evals/exps_image.py:1-201;
reference exps_image.py).

Stylises the 6 canonical content/style pairs at 512^2 through the port's
full path (``infer.image.stylize_image``: K1, K2, K4 and K5 on the card),
saves each pair's content, style and stylized PNGs, computes the 12 metrics
against content and style and writes ``results.csv`` in the reference's
schema (exps_image.py:110-170) with the trailing average row.

The metrics that need backbone weights (LPIPS: torchvision vgg16 and the
LPIPS v0.1 heads; SIFID: torchvision inception_v3; gram: torchvision
vgg19) read user-supplied ``.pth`` files and give NaN when a file is not
given.  Everything runs on ``--device``, the card unless ``--device cpu``.
"""

import argparse
import csv
import math
import os

import numpy as np
import torch

from . import metrics
from ..config import resolve_device
from ..infer.image import DTYPES, add_model_args, models_from_args
from ..infer.image import stylize_image
from ..utils.image_io import load_image, mkdir, save_image

CONTENT_STYLE_PAIR = [
    ("contents/Cornell.jpg", "styles/Untitled-1964.jpg"),
    ("contents/Bird.jpg", "styles/Sketch.jpg"),
    ("contents/RiverBoat.jpg", "styles/Blue-3.jpg"),
    ("contents/Sailboat.jpg", "styles/Another-colorful-world.jpg"),
    ("contents/Streets.jpg", "styles/Composition.jpg"),
    ("contents/Tubingen.jpg", "styles/Volga-Landscape.jpg"),
]

FIELDNAMES = [
    "content", "style", "lpips_content", "ssim_content", "sifid_content",
    "kl_c", "lpips_style", "ssim_style", "sifid_style", "kl_s", "gram",
    "moment", "uniformity", "entropy",
]


class MetricSuite:
    """All 12 exps_image metrics on ``device``, with optional backbones."""

    def __init__(self, vgg19_pth: str | None = None,
                 vgg16_pth: str | None = None,
                 lpips_heads_pth: str | None = None,
                 inception_pth: str | None = None, sifid_dims: int = 2048,
                 device="cuda"):
        from .inception import BLOCK_INDEX_BY_DIM, load_inception
        from .lpips import load_lpips
        from .sifid import SIFID

        self.device = resolve_device(device)
        self.vgg = (metrics.load_vgg19_features(vgg19_pth, self.device)
                    if vgg19_pth else None)
        self.lpips_model = (load_lpips(vgg16_pth, lpips_heads_pth,
                                       self.device)
                            if vgg16_pth and lpips_heads_pth else None)
        self.sifid_ev = (SIFID(load_inception(
            inception_pth, BLOCK_INDEX_BY_DIM[sifid_dims], self.device),
            sifid_dims) if inception_pth else None)

    def lpips(self, p0: str, p1: str) -> float:
        if self.lpips_model is None:
            return math.nan
        return float(self.lpips_model(metrics.rgb_batch(p0, self.device),
                                      metrics.rgb_batch(p1, self.device))[0])

    def sifid(self, p0: str, p1: str) -> float:
        return self.sifid_ev(p0, p1) if self.sifid_ev else math.nan

    def gram(self, p0: str, p1: str) -> float:
        if self.vgg is None:
            return math.nan
        return metrics.gram_loss(p0, p1, self.vgg, self.device)

    def ssim(self, p0: str, p1: str) -> float:
        return metrics.ssim(p0, p1, self.device)

    def evaluate_pair(self, stylized: str, content: str,
                      style: str) -> dict[str, float]:
        """12 metrics for one stylised output (exps_image.py:92-146 order)."""
        return {
            "lpips_content": self.lpips(stylized, content),
            "ssim_content": self.ssim(stylized, content),
            "sifid_content": self.sifid(stylized, content),
            "kl_c": metrics.kl_divergence(stylized, content),
            "lpips_style": self.lpips(stylized, style),
            "ssim_style": self.ssim(stylized, style),
            "sifid_style": self.sifid(stylized, style),
            "kl_s": metrics.kl_divergence(stylized, style),
            "gram": self.gram(stylized, style),
            "moment": metrics.nth_order_moment(stylized),
            "uniformity": metrics.uniformity(stylized),
            "entropy": metrics.average_entropy(stylized),
        }


def write_results_csv(path: str, rows: list[dict],
                      fieldnames=FIELDNAMES) -> list[dict]:
    """Append the average row, write the reference CSV schema and return
    the rows written."""
    avg = {k: float(np.mean([r[k] for r in rows])) for k in fieldnames[2:]}
    rows = rows + [{"content": "average", "style": "average", **avg}]
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fieldnames)
        w.writeheader()
        for r in rows:
            w.writerow(r)
    return rows


def run(models: dict, suite: MetricSuite, assets_dir: str,
        results_dir: str = "./results", pairs=CONTENT_STYLE_PAIR,
        image_size=(512, 512), dtype=torch.float32) -> list[dict]:
    """Stylise each pair with ``models`` (on their device), save the PNGs
    under ``results_dir/{i}``, score them and write ``results.csv``;
    returns the per-pair rows (without the average)."""
    rows = []
    for i, (cpath, spath) in enumerate(pairs):
        c = load_image(os.path.join(assets_dir, cpath), image_size)
        s = load_image(os.path.join(assets_dir, spath), image_size)
        cs = stylize_image(models, c, s, dtype)
        save_path = os.path.join(results_dir, str(i + 1))
        mkdir(save_path, delete_existing_files=True)
        cp = os.path.join(save_path, "content.png")
        sp = os.path.join(save_path, "style.png")
        zp = os.path.join(save_path, "stylized.png")
        save_image(cp, c)
        save_image(sp, s)
        save_image(zp, cs)
        rows.append(
            {"content": cpath, "style": spath,
             **suite.evaluate_pair(zp, cp, sp)})
    write_results_csv(os.path.join(results_dir, "results.csv"), rows)
    return rows


def add_backbone_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--vgg19", help="torchvision vgg19 .pth (gram)")
    ap.add_argument("--vgg16", help="torchvision vgg16 .pth (lpips)")
    ap.add_argument("--lpips-heads", help="LPIPS v0.1 linear heads .pth")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--assets", required=True,
                    help="dir containing contents/ and styles/")
    ap.add_argument("--results", default="./results")
    add_backbone_args(ap)
    ap.add_argument("--inception",
                    help="torchvision inception_v3 .pth (sifid)")
    ap.add_argument("--size", type=int, nargs=2, default=(512, 512))
    add_model_args(ap)
    args = ap.parse_args(argv)

    models = models_from_args(ap, args)
    suite = MetricSuite(args.vgg19, args.vgg16, args.lpips_heads,
                        args.inception, device=args.device)
    rows = run(models, suite, args.assets, args.results,
               image_size=tuple(args.size), dtype=DTYPES[args.dtype])
    print(f"wrote {os.path.join(args.results, 'results.csv')} "
          f"({len(rows)} pairs + average)")


if __name__ == "__main__":
    main()
