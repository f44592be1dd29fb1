"""Video-training CLI (mhada_tpu/train/run_video.py; reference
train_video.py:35-223).

Epochs 21-30 over FlyingThings3D + Monkaa frame pairs with WikiArt styles
and the six-loss video step, resumed across from the image run: epoch E
starts from ``checkpoint_epoch_{E-1}_batchSize_{image_batch_size}.pth``
(the image run's batch size names it, reference train_video.py:80-89), or
else from the newest video checkpoint ``..._batchSize_{batch_size}.pth``;
weights and Adam state are restored.  Rolling 100-step weight snapshots,
per-epoch weights and a combined checkpoint under the video batch size.
Runs on the card unless ``--device cpu`` is given.

Usage:
  python -m mhada_tpu_torch.train.run_video --datasets ../datasets \\
      [--epoch-start 21] [--epochs 30] [--batch-size 2] [--vgg vgg19.pth] \\
      [--models-dir ./models] [--dtype bfloat16]
"""

import argparse
import os

import torch

from ..config import ModelConfig, VideoTrainConfig, resolve_device
from ..data.coco_wikiart import make_loader
from ..data.sceneflow import FlyingThings3DMonkaaWikiArt, collate_video
from ..interop import load_vgg19
from . import checkpoint as ckpt
from .run_image import train_epochs
from .train_image import init_params, make_optimizers
from .train_video import make_video_train_step


def resume_path(models_dir: str, cfg: VideoTrainConfig) -> str:
    """The checkpoint a run starting at ``cfg.epoch_start`` resumes from:
    the image run's epoch before it, else the newest video checkpoint."""
    path = os.path.join(models_dir, f"checkpoint_epoch_{cfg.epoch_start - 1}"
                        f"_batchSize_{cfg.image_batch_size}.pth")
    if os.path.exists(path):
        return path
    alt = ckpt.latest_checkpoint(models_dir, cfg.batch_size)
    if alt is None:
        raise FileNotFoundError(
            f"no checkpoint at {path} nor any checkpoint_epoch_*_batchSize_"
            f"{cfg.batch_size}.pth under {models_dir}")
    return alt


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--datasets", default="../datasets",
                    help="root holding WikiArt/ and SceneFlowDatasets/")
    ap.add_argument("--models-dir", default="./models")
    ap.add_argument("--epoch-start", type=int, default=21)
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--batch-size", type=int, default=2)
    ap.add_argument("--image-batch-size", type=int, default=8,
                    help="the image run's batch size, which names the "
                    "checkpoint resumed from")
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--style-size", type=int, nargs=2, default=(256, 256))
    ap.add_argument("--content-size", type=int, nargs=2, default=(256, 512))
    ap.add_argument("--vgg", help="torchvision VGG19 .pth (IMAGENET1K_V1)")
    ap.add_argument("--attn-mode", default="spatial",
                    choices=["spatial", "batch_coupled"])
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="compute dtype; float32 master weights and Adam "
                    "either way")
    ap.add_argument("--steps-per-epoch", type=int, default=0,
                    help="truncate epochs (smoke runs); 0 = full epoch")
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--metrics-jsonl", help="structured per-step metrics file")
    ap.add_argument("--device", default="cuda",
                    help="default: cuda; without a card pass --device cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = VideoTrainConfig(
        model=ModelConfig(attn_mode=args.attn_mode),
        epoch_start=args.epoch_start, epoch_end=args.epochs,
        batch_size=args.batch_size, image_batch_size=args.image_batch_size,
        lr=args.lr, style_size=tuple(args.style_size),
        content_size=tuple(args.content_size), compute_dtype=args.dtype)
    m = cfg.model
    loader = make_loader(
        FlyingThings3DMonkaaWikiArt(cfg.style_size, cfg.content_size,
                                    args.datasets, seed=args.seed),
        cfg.batch_size, seed=args.seed, collate_fn=collate_video)

    models = init_params(cfg, device,
                         torch.Generator().manual_seed(args.seed or 0))
    if args.vgg:
        models["vgg19"].load_state_dict(load_vgg19(args.vgg), strict=True)
    else:
        print("WARNING: no --vgg weights; using random VGG (smoke mode only)")
    optimizers = make_optimizers(models, cfg)
    if cfg.epoch_start > 1:
        path = resume_path(args.models_dir, cfg)
        epoch = ckpt.restore_checkpoint(path, models, optimizers,
                                        m.num_layers, m.num_heads)
        print(f"resumed from {path} (epoch {epoch})")

    train_epochs(cfg, models, optimizers,
                 make_video_train_step(cfg, models, optimizers), loader,
                 device, args)


if __name__ == "__main__":
    main()
