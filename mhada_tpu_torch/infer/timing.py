"""Latency of the stylization paths (mhada_tpu/infer/timing.py; reference
infer_time.py:64-87, fixed).

The reference times un-warmed runs and re-encodes the style on every run.
``measure`` reports both protocols after a warm-up:

- ``reference_protocol_ms``: the full path, style re-encoded per run, the
  mean over ``iters`` runs (comparable to infer_time.py's number);
- ``steady_state_ms`` / ``steady_state_p50_ms`` / ``fps``: the streaming
  path, all style-only work cached (features and MHAda K/V), as the mean
  and median of windows of up to 10 frames.

On the card every window is timed with CUDA events (device time, no host
sync inside a window); a CPU run, which the caller must ask for, times
with the host clock and says so in ``clock``.  ``--profile`` also traces
one full and one streaming frame (``train.bench_steps.profile_step``:
the device's busy time, the union of its kernels' intervals, against the
frame's wall time under the profiler, and the top kernels): a busy time
well under the frame time above means the host sets the frame's pace.

    python -m mhada_tpu_torch.infer.timing [--size 512 512] [--iters 100] \
        [--dtype bfloat16] [--device cuda] [--profile]

prints one JSON object.
"""

import argparse
import json
import time

import numpy as np
import torch

from .image import (DTYPES, add_model_args, make_encode_style_fn,
                    make_stylize_fn, make_stylize_with_kv_fn,
                    models_from_args, precompute_style_kv)

WINDOW = 10


def _elapsed_ms(device: torch.device, fn) -> float:
    """Milliseconds that ``fn()`` takes on ``device``."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end)
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1000


def measure(models: dict, image_size=(512, 512),
            dtype: torch.dtype = torch.float32, iters: int = 100,
            warmup: int = 5, profile: bool = False) -> dict:
    device = next(models["vit_c"].parameters()).device
    rng = np.random.default_rng(0)
    h, w = image_size

    def image():
        a = rng.uniform(0, 255, (1, h, w, 3)).astype(np.float32)
        return torch.from_numpy(a).to(device)

    contents = [image() for _ in range(4)]
    style = image()
    full = make_stylize_fn(models, dtype)
    with_kv = make_stylize_with_kv_fn(models, dtype)
    kv = precompute_style_kv(models, make_encode_style_fn(models, dtype)(style))

    def run_full(start, stop):
        for i in range(start, stop):
            full(contents[i % 4], style)

    def run_kv(start, stop):
        for i in range(start, stop):
            with_kv(contents[i % 4], kv)

    run_full(0, warmup)
    ref_ms = _elapsed_ms(device, lambda: run_full(0, iters)) / iters

    run_kv(0, warmup)
    window = min(WINDOW, iters)
    lat = np.asarray([
        _elapsed_ms(device, lambda s=s: run_kv(s, s + window)) / window
        for s in range(0, iters, window)])
    traces = {}
    if profile:
        from ..train.bench_steps import profile_step

        traces = {"profile_full": profile_step(full, (contents[0], style),
                                               device, top=8),
                  "profile_streaming": profile_step(
                      lambda c, _: with_kv(c, kv), (contents[0], style),
                      device, top=8)}
    return {
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "clock": "cuda_events" if device.type == "cuda" else "host",
        "image_size": list(image_size),
        "dtype": str(dtype).removeprefix("torch."),
        "iters": iters,
        "reference_protocol_ms": ref_ms,
        "steady_state_ms": float(lat.mean()),
        "steady_state_p50_ms": float(np.median(lat)),
        "fps": 1000.0 / float(lat.mean()),
        **traces,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--size", type=int, nargs=2, default=(512, 512))
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--profile", action="store_true",
                    help="also trace one full and one streaming frame")
    add_model_args(ap)
    args = ap.parse_args(argv)
    models = models_from_args(ap, args)
    print(json.dumps(measure(models, tuple(args.size), DTYPES[args.dtype],
                             args.iters, profile=args.profile)))


if __name__ == "__main__":
    main()
