"""The contents x styles grid (mhada_tpu/infer/image_all.py; reference
infer_image_all.py).

Stylizes every image in ``--contents`` with every image in ``--styles``
and writes ``content_{i}_style_{j}.jpg``.  Each style is encoded once and
its features are reused for every content; the outputs are those of the
reference's one-pair-at-a-time loop.

    python -m mhada_tpu_torch.infer.image_all --contents DIR --styles DIR \
        [--out ./results] [--device cuda]
"""

import argparse
import os

import torch

from .image import (DTYPES, add_model_args, make_encode_style_fn,
                    make_stylize_with_fs_fn, models_from_args)
from ..utils.image_io import load_image, save_image


def run_grid(models: dict, content_paths, style_paths, out_dir: str,
             image_size=(512, 512), dtype: torch.dtype = torch.float32):
    device = next(models["vit_c"].parameters()).device
    os.makedirs(out_dir, exist_ok=True)
    encode = make_encode_style_fn(models, dtype)
    stylize = make_stylize_with_fs_fn(models, dtype)

    def batch(path):
        return torch.from_numpy(load_image(path, image_size))[None].to(device)

    for j, sp in enumerate(style_paths):
        fs = encode(batch(sp))
        for i, cp in enumerate(content_paths):
            cs = stylize(batch(cp), fs)[0].cpu().numpy()
            save_image(os.path.join(out_dir, f"content_{i}_style_{j}.jpg"),
                       cs)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--contents", required=True)
    ap.add_argument("--styles", required=True)
    ap.add_argument("--out", default="./results")
    ap.add_argument("--size", type=int, nargs=2, default=(512, 512))
    add_model_args(ap)
    args = ap.parse_args(argv)
    models = models_from_args(ap, args)
    files = [sorted(f.path for f in os.scandir(d) if f.is_file())
             for d in (args.contents, args.styles)]
    run_grid(models, *files, args.out, tuple(args.size), DTYPES[args.dtype])
    print(f"grid written to {args.out}")


if __name__ == "__main__":
    main()
