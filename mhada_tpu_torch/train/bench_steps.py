"""Train-step timing (mhada_tpu/train/bench_steps.py) for the image recipe:
256^2, B = 8, full-width ``ModelConfig()``, random weights and batches from
seed 0.

Variants: ``image_f32``, ``image_bf16``, ``image_f32_remat`` and
``image_bf16_fuseln`` (the bf16 step with each ViT pre-LN fused into its
matmul, K2 and its VJP: ``ModelConfig(fuse_ln=True)``).  On the card each
variant is timed with CUDA events over ``--steps`` steps after one warm-up
step, and ``--backend plain`` times the plain PyTorch versions in place of
the kernels.  ``--tiny`` (a one-layer 128-wide model at 32^2,
B = 2) with ``--device cpu`` is a smoke test of this CLI, timed by the
host clock and labelled as such, not a benchmark.

Run: ``python -m mhada_tpu_torch.train.bench_steps [--steps 10]
[--variants ...] [--backend kernel|plain] [--image-size 512 512]
[--batch-size 4] [--profile FILE]``.  Prints one JSON line per variant:
ms/step, steps/s, the device, the card's name.  ``--profile`` also traces
one more step of each variant with ``torch.profiler`` and writes, per
variant, the step's wall time, the device's busy time and idle share, and
the kernels with the most device time to FILE (JSON).
"""

import argparse
import json
import time
from dataclasses import replace

import numpy as np
import torch

from ..config import ImageTrainConfig, ModelConfig, resolve_device
from .train_image import init_params, make_image_train_step, make_optimizers

# variant -> ImageTrainConfig fields; "fuse_ln" is the model's
VARIANTS = {
    "image_f32": {},
    "image_bf16": {"compute_dtype": "bfloat16"},
    "image_f32_remat": {"remat": True},
    "image_bf16_fuseln": {"compute_dtype": "bfloat16", "fuse_ln": True},
}


def variant_config(cfg: ImageTrainConfig, variant: str) -> ImageTrainConfig:
    fields = dict(VARIANTS[variant])
    if "fuse_ln" in fields:
        fields["model"] = replace(cfg.model, fuse_ln=fields.pop("fuse_ln"))
    return replace(cfg, **fields)


def time_steps(cfg: ImageTrainConfig, steps: int, device,
               profile: bool = False):
    """(ms per training step after one warm-up step, the profile of one
    more step or None)."""
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
        ms = start.elapsed_time(end) / steps
    else:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(content, style)
        ms = (time.perf_counter() - t0) * 1e3 / steps
    return ms, profile_step(step, content, style, device) if profile else None


def profile_step(step, content, style, device, top: int = 30) -> dict:
    """One step under ``torch.profiler``: its wall time, the device's busy
    time (the union of the kernels' intervals: some library kernels run
    side by side) and idle share, the kernels' summed device time, the
    ``top`` kernels by device time and the ``top`` operators (with their
    input shapes) by the device time of the kernels they launched."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with profile(activities=acts, record_shapes=True) as prof:
        t0 = time.perf_counter()
        step(content, style)
        if device.type == "cuda":
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type.name == "CUDA")
    busy_us, end = 0.0, float("-inf")
    for lo, hi in spans:
        busy_us += max(0.0, hi - max(lo, end))
        end = max(end, hi)

    def rows(events, cpu):
        keep = [e for e in events if (e.device_type.name == "CPU") == cpu
                and e.self_device_time_total > 0]
        keep.sort(key=lambda e: e.self_device_time_total, reverse=True)
        return [{"name": e.key[:120], "count": e.count,
                 "device_ms": e.self_device_time_total / 1e3,
                 **({"shapes": str(e.input_shapes)[:200]} if cpu else {})}
                for e in keep[:top]]

    kernels = rows(prof.key_averages(), cpu=False)
    return {"wall_ms": wall_ms, "device_busy_ms": busy_us / 1e3,
            "idle_share": 1 - busy_us / 1e3 / wall_ms,
            "kernel_ms_summed": sum(
                e.self_device_time_total for e in prof.key_averages()
                if e.device_type.name == "CUDA") / 1e3,
            "top": kernels,
            "top_ops": rows(prof.key_averages(group_by_input_shape=True),
                            cpu=True)}


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
    ap.add_argument("--image-size", type=int, nargs=2,
                    help="default: the recipe's 256 256")
    ap.add_argument("--batch-size", type=int, help="default: the recipe's 8")
    ap.add_argument("--profile", help="write one profiled step of each "
                    "variant to this JSON file")
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
    if args.image_size:
        cfg = replace(cfg, image_size=tuple(args.image_size))
    if args.batch_size:
        cfg = replace(cfg, batch_size=args.batch_size)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu (host clock, smoke test)")
    profiles = {}
    for variant in args.variants:
        ms, profiles[variant] = time_steps(variant_config(cfg, variant),
                                           args.steps, device,
                                           bool(args.profile))
        print(json.dumps({"variant": variant, "ms_per_step": ms,
                          "steps_per_s": 1e3 / ms, "backend": args.backend,
                          "image_size": list(cfg.image_size),
                          "batch_size": cfg.batch_size, "device": name,
                          "tiny": args.tiny}), flush=True)
    if args.profile:
        with open(args.profile, "w") as f:
            json.dump({"device": name, "variants": profiles}, f, indent=1)


if __name__ == "__main__":
    main()
