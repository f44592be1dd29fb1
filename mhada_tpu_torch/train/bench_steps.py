"""Train-step timing (mhada_tpu/train/bench_steps.py) for the image recipe:
256^2, B = 8, full-width ``ModelConfig()``, random weights and batches from
seed 0.

Variants: ``image_f32``, ``image_bf16`` and ``image_f32_remat``.  On the
card each variant is timed with CUDA events over ``--steps`` steps after
one warm-up step, and ``--backend plain`` times the plain PyTorch versions
in place of the kernels.  ``--tiny`` (a one-layer 128-wide model at 32^2,
B = 2) with ``--device cpu`` is a smoke test of this CLI, timed by the
host clock and labelled as such, not a benchmark.

Run: ``python -m mhada_tpu_torch.train.bench_steps [--steps 10]
[--variants ...] [--backend kernel|plain]``.  Prints one JSON line per
variant: ms/step, steps/s, the device, the card's name.
"""

import argparse
import json
import time
from dataclasses import replace

import numpy as np
import torch

from ..config import ImageTrainConfig, ModelConfig, resolve_device
from .train_image import init_params, make_image_train_step, make_optimizers

VARIANTS = {
    "image_f32": {},
    "image_bf16": {"compute_dtype": "bfloat16"},
    "image_f32_remat": {"remat": True},
}


def time_steps(cfg: ImageTrainConfig, steps: int, device) -> float:
    """ms per training step after one warm-up step."""
    models = init_params(cfg, device)
    step = make_image_train_step(cfg, models, make_optimizers(models, cfg))
    rng = np.random.default_rng(0)
    h, w = cfg.image_size
    content, style = (torch.from_numpy(rng.uniform(
        0, 255, (cfg.batch_size, h, w, 3)).astype(np.float32)).to(device)
        for _ in range(2))
    step(content, style)
    if device.type == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        for _ in range(steps):
            step(content, style)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / steps
    t0 = time.perf_counter()
    for _ in range(steps):
        step(content, style)
    return (time.perf_counter() - t0) * 1e3 / steps


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--variants", nargs="*", default=list(VARIANTS),
                    choices=list(VARIANTS))
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "kernel", "plain"])
    ap.add_argument("--tiny", action="store_true",
                    help="tiny shapes (a smoke test of this CLI)")
    ap.add_argument("--device", default="cuda",
                    help="default: cuda; --device cpu only with --tiny")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device.type != "cuda" and not args.tiny:
        ap.error("timing the recipe needs the card; --device cpu is for "
                 "--tiny smoke runs")
    model = ModelConfig(mhada_backend=args.backend)
    cfg = ImageTrainConfig(model=model)
    if args.tiny:
        cfg = replace(cfg, batch_size=2, image_size=(32, 32), model=replace(
            model, num_layers=1, num_heads=2, hidden_dim=128, mlp_dim=256))
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu (host clock, smoke test)")
    for variant in args.variants:
        ms = time_steps(replace(cfg, **VARIANTS[variant]), args.steps, device)
        print(json.dumps({"variant": variant, "ms_per_step": ms,
                          "steps_per_s": 1e3 / ms, "backend": args.backend,
                          "device": name, "tiny": args.tiny}), flush=True)


if __name__ == "__main__":
    main()
