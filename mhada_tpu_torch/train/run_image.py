"""Image-training CLI (mhada_tpu/train/run_image.py; reference
train_image.py:31-190).

Epoch loop over CocoWikiArt with the training step, rolling 100-step weight
snapshots, per-epoch weights and a combined checkpoint, and resume from the
newest checkpoint when ``--epoch-start`` > 1 (reference semantics).  Runs
on the card unless ``--device cpu`` is given.

Data parallelism (the JAX CLI's mesh with every device on 'data',
mhada_tpu/train/run_image.py:105-121): ``--nproc N`` spawns N ranks, or
under ``torchrun --nproc-per-node N`` each process is one.  Every rank
loads the same global batches (``--batch-size``, which N must divide) and
trains on its ``shard_batch`` slice; gradients are averaged over the ranks
before Adam, so N ranks see the data and take the steps of one rank with
the same ``--seed`` (without one, rank 0 draws it for all).  Rank 0 logs
and writes the checkpoints; every rank resumes from them.

Usage:
  python -m mhada_tpu_torch.train.run_image --coco ../datasets/coco \\
      --wikiart ../datasets/WikiArt [--epochs 20] [--batch-size 8] \\
      [--vgg /path/vgg19.pth] [--models-dir ./models] [--dtype bfloat16] \\
      [--nproc N]
"""

import argparse
import time

import torch

from ..config import ImageTrainConfig, ModelConfig, resolve_device
from ..data.coco_wikiart import CocoWikiArt, make_loader
from ..interop import load_vgg19
from ..parallel.launch import run_spmd
from ..parallel.mesh import replicate, shard_batch
from ..utils.metrics import MetricsLogger
from . import checkpoint as ckpt
from .train_image import init_params, make_image_train_step, make_optimizers


def add_rank_args(ap) -> None:
    """The training CLIs' data-parallel options."""
    ap.add_argument("--nproc", type=int, default=1,
                    help="data-parallel ranks spawned here (ranks on one "
                    "card share it over gloo); under torchrun each process "
                    "is one rank")


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--coco", default="../datasets/coco")
    ap.add_argument("--wikiart", default="../datasets/WikiArt")
    ap.add_argument("--models-dir", default="./models")
    ap.add_argument("--epoch-start", type=int, default=1)
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--image-size", type=int, nargs=2, default=(256, 256))
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
    add_rank_args(ap)
    args = ap.parse_args(argv)
    run_spmd(train_rank, args.nproc, args.device, args)


def rank_setup(group, args):
    """A CLI rank's device and ``args`` with the run's seed: under data
    parallelism the global batch must divide over the ranks, and a run
    without ``--seed`` takes rank 0's draw, so every rank loads the same
    batches."""
    device = group.device if group is not None else resolve_device(
        args.device)
    if group is not None:
        if args.batch_size % group.size:
            raise ValueError(f"--batch-size {args.batch_size} does not "
                             f"divide over {group.size} ranks")
        if args.seed is None:
            seed = torch.randint(0, 2 ** 31 - 1, (), dtype=torch.int64)
            args.seed = int(group.broadcast_(seed.to(device)))
    return device, args


def train_rank(group, args) -> None:
    """One rank of ``main`` (``group`` None: the only one)."""
    device, args = rank_setup(group, args)
    lead = group is None or group.rank == 0
    cfg = ImageTrainConfig(
        model=ModelConfig(attn_mode=args.attn_mode),
        epoch_start=args.epoch_start, epoch_end=args.epochs,
        batch_size=args.batch_size, lr=args.lr,
        image_size=tuple(args.image_size), compute_dtype=args.dtype)
    m = cfg.model
    loader = make_loader(
        CocoWikiArt(cfg.image_size, args.coco, args.wikiart, seed=args.seed),
        cfg.batch_size, seed=args.seed)

    models = init_params(cfg, device,
                         torch.Generator().manual_seed(args.seed or 0))
    if args.vgg:
        models["vgg19"].load_state_dict(load_vgg19(args.vgg), strict=True)
    elif lead:
        print("WARNING: no --vgg weights; using random VGG (smoke mode only)")
    optimizers = make_optimizers(models, cfg)

    # resume (reference train_image.py:75-84)
    if cfg.epoch_start > 1:
        path = ckpt.latest_checkpoint(args.models_dir, cfg.batch_size)
        if path is None:
            raise FileNotFoundError(
                f"no checkpoint to resume under {args.models_dir}")
        epoch = ckpt.restore_checkpoint(path, models, optimizers,
                                        m.num_layers, m.num_heads)
        if lead:
            print(f"resumed from {path} (epoch {epoch})")

    train_epochs(cfg, models, optimizers,
                 make_image_train_step(cfg, models, optimizers, group),
                 loader, device, args, group)


def train_epochs(cfg, models: dict, optimizers: dict, step_fn, loader,
                 device, args, group=None) -> None:
    """The epoch loop of both training CLIs (mhada_tpu/train/run_image.py:
    113-150, run_video.py:122-160): each batch of ``loader`` through
    ``step_fn`` on ``device``; metrics every ``args.log_every`` steps (to
    ``args.metrics_jsonl`` too), the rolling weights every 100 and, at each
    epoch's end, the weights and a checkpoint named by ``cfg.batch_size``
    under ``args.models_dir``; ``args.steps_per_epoch`` truncates.
    ``group``: data parallelism, ``step_fn`` taking this rank's slice of
    each global batch; rank 0 logs and writes the files."""
    m = cfg.model
    lead = group is None or group.rank == 0
    if group is not None:
        replicate(group, models)
    logger = MetricsLogger(args.metrics_jsonl if lead else None)
    step = 0
    try:
        for epoch in range(cfg.epoch_start, cfg.epoch_end + 1):
            t0 = time.time()
            for idx, batch in enumerate(loader):
                if args.steps_per_epoch and idx >= args.steps_per_epoch:
                    break
                if group is not None:
                    batch = shard_batch(group, *batch)
                metrics = step_fn(*(t.to(device, non_blocking=True)
                                    for t in batch))
                step += 1
                if not lead:
                    continue
                if idx % args.log_every == 0:
                    row = logger.log(step, metrics, epoch=epoch)
                    rate = (idx + 1) * cfg.batch_size / (time.time() - t0)
                    print(f"epoch {epoch}/{cfg.epoch_end} step {idx} "
                          + " ".join(f"{k}={v:.4f}" for k, v in row.items()
                                     if k not in ("step", "time", "epoch"))
                          + f" ({rate:.1f} samples/s)", flush=True)
                if idx % 100 == 0:
                    ckpt.save_weights(args.models_dir, models, m.num_layers,
                                      m.num_heads, attn_mode=m.attn_mode)
            if not lead:
                continue
            ckpt.save_weights(
                args.models_dir, models, m.num_layers, m.num_heads,
                suffix=f"_epoch_{epoch}_batchSize_{cfg.batch_size}",
                attn_mode=m.attn_mode)
            ckpt.save_checkpoint(args.models_dir, epoch, cfg.batch_size,
                                 models, optimizers, m.num_layers,
                                 m.num_heads)
            print(f"epoch {epoch} done in {time.time() - t0:.1f}s; "
                  "checkpoint saved", flush=True)
    finally:
        logger.close()


if __name__ == "__main__":
    main()
