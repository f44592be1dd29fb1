"""Full-grid quality sweep (mhada_tpu/evals/exps_image_all.py:1-121;
reference exps_image_all.py).

Every content x every style (reference: 20 x 47) at 512^2, 9 metrics per
pair (no SIFID: too slow at grid scale), ``results_all.csv`` in the
reference's schema (exps_image_all.py:101-148) plus the average row.  Each
style is encoded once (``make_encode_style_fn``) and every content
stylised against its features (``make_stylize_with_fs_fn``).
"""

import argparse
import os
import tempfile

import torch

from . import metrics
from .exps_image import (MetricSuite, add_backbone_args,
                         write_results_csv)
from ..infer.image import (DTYPES, add_model_args, make_encode_style_fn,
                           make_stylize_with_fs_fn, models_from_args)
from ..utils.image_io import list_files, load_image, mkdir, save_image

FIELDNAMES = [
    "content", "style", "lpips_content", "ssim_content", "lpips_style",
    "ssim_style", "kl", "gram", "moment", "uniformity", "entropy",
]


def evaluate_grid_pair(suite: MetricSuite, stylized: str, content: str,
                       style: str) -> dict:
    return {
        "lpips_content": suite.lpips(stylized, content),
        "ssim_content": suite.ssim(stylized, content),
        "lpips_style": suite.lpips(stylized, style),
        "ssim_style": suite.ssim(stylized, style),
        "kl": metrics.kl_divergence(stylized, style),
        "gram": suite.gram(stylized, style),
        "moment": metrics.nth_order_moment(stylized),
        "uniformity": metrics.uniformity(stylized),
        "entropy": metrics.average_entropy(stylized),
    }


def run(models: dict, suite: MetricSuite, content_paths: list[str],
        style_paths: list[str], results_dir: str = "./results",
        image_size=(512, 512), dtype=torch.float32) -> list[dict]:
    """The grid with ``models`` on their device -> the rows written to
    ``results_all.csv``, the average row last."""
    mkdir(results_dir)
    device = next(models["vit_c"].parameters()).device
    encode = make_encode_style_fn(models, dtype)
    stylize = make_stylize_with_fs_fn(models, dtype)

    def batch(a):
        return torch.from_numpy(a)[None].to(device)

    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        for j, sp in enumerate(style_paths):
            s = load_image(sp, image_size)
            fs = encode(batch(s))
            spath = os.path.join(tmp, "style.png")
            save_image(spath, s)
            for i, cp in enumerate(content_paths):
                c = load_image(cp, image_size)
                cs = stylize(batch(c), fs)[0].cpu().numpy()
                zpath = os.path.join(results_dir,
                                     f"content_{i}_style_{j}.jpg")
                save_image(zpath, cs)
                cpath = os.path.join(tmp, "content.png")
                save_image(cpath, c)
                rows.append({
                    "content": os.path.basename(cp),
                    "style": os.path.basename(sp),
                    **evaluate_grid_pair(suite, zpath, cpath, spath),
                })
    return write_results_csv(os.path.join(results_dir, "results_all.csv"),
                             rows, FIELDNAMES)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--contents", required=True)
    ap.add_argument("--styles", required=True)
    ap.add_argument("--results", default="./results")
    ap.add_argument("--size", type=int, nargs=2, default=(512, 512))
    add_backbone_args(ap)
    add_model_args(ap)
    args = ap.parse_args(argv)

    models = models_from_args(ap, args)
    suite = MetricSuite(args.vgg19, args.vgg16, args.lpips_heads,
                        device=args.device)
    rows = run(models, suite, list_files(args.contents),
               list_files(args.styles), args.results, tuple(args.size),
               DTYPES[args.dtype])
    print(f"{len(rows) - 1} pairs -> {args.results}/results_all.csv")


if __name__ == "__main__":
    main()
