"""Parameter and FLOP counts (mhada_tpu/analysis/counts.py:1-75; reference
count_param.py:12-31, count_flops_ptflops.py, count_flops_fvcore.py).

Parameters are counted from the module (or state_dict); FLOPs come from
``torch.utils.flop_counter.FlopCounterMode``, which counts the aten
operations a call dispatches: convolutions, matmuls and einsums, not the
elementwise work that XLA's cost analysis also counts (the JAX package's
count), so the port's count is 0.97-1.0 of it at the reference's shapes.
A hand-written kernel launched through ``_build`` dispatches no aten
operation and would go uncounted, so ``count_flops`` raises if one
launches; ``report`` counts the plain build.

    python -m mhada_tpu_torch.analysis.counts [--device cpu]
"""

import torch
from torch.utils.flop_counter import FlopCounterMode

from .. import _build


def count_params(params) -> int:
    """Parameters of a module, or elements of a state_dict's tensors."""
    tensors = (params.parameters() if isinstance(params, torch.nn.Module)
               else params.values())
    return sum(int(t.numel()) for t in tensors)


def count_params_mb(params, bytes_per_param: int = 4) -> float:
    """MB at fp32, matching count_param.py's 4 B/param convention."""
    return count_params(params) * bytes_per_param / (1024 ** 2)


def count_flops(fn, *example_args) -> dict[str, float]:
    """FLOPs of ``fn(*example_args)`` as FlopCounterMode counts them, with
    grad mode on (the counter's module tracker fails under no_grad when a
    parameter requires grad) -> {'flops', 'gflops', 'bytes_accessed'}, the
    JAX dict's keys.  ``bytes_accessed`` is NaN: the counter has none.

    Raises if a kernel of ``_build`` launched during the call: its
    products would be missing from the count."""
    before = dict(_build.LAUNCHES)
    with torch.enable_grad(), FlopCounterMode(display=False) as counter:
        fn(*example_args)
    moved = {k: v - before[k] for k, v in _build.LAUNCHES.items()
             if v != before[k]}
    if moved:
        raise RuntimeError(
            f"count_flops: kernels launched during the count ({moved}); "
            "FlopCounterMode does not see them, so count the plain build "
            "(ModelConfig(mhada_backend='plain'))")
    flops = float(counter.get_total_flops())
    return {"flops": flops, "gflops": flops / 1e9,
            "bytes_accessed": float("nan")}


def report(image_size=(256, 256), device="cuda") -> dict[str, dict]:
    """Per-network params (MB) and GFLOPs of the plain build at the
    reference's count shapes: the ViTs on (1, H, W, 3), AdaFormer on three
    (1, H/8, W/8, 512) lists (count_flops_fvcore.py:29-54)."""
    from ..config import ModelConfig, resolve_device
    from ..models import build_models

    dev = resolve_device(device)
    models = build_models(ModelConfig(mhada_backend="plain"), dev)
    h, w = image_size
    x = torch.zeros(1, h, w, 3, device=dev)
    feats = [torch.zeros(1, h // 8, w // 8, 512, device=dev)] * 3
    out = {}
    for name, inp in (("vit_c", (x,)), ("vit_s", (x,)),
                      ("adaFormer", (feats, feats))):
        model = models[name].requires_grad_(False)
        fl = count_flops(model, *inp)
        out[name] = {
            "params": count_params(model),
            "params_mb": round(count_params_mb(model), 3),
            "gflops": round(fl["gflops"], 3),
        }
    return out


def main(argv=None):
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--size", type=int, nargs=2, default=(256, 256))
    ap.add_argument("--device", default="cuda",
                    help="default: cuda; without a card pass --device cpu")
    args = ap.parse_args(argv)
    print(json.dumps(report(tuple(args.size), args.device), indent=2))


if __name__ == "__main__":
    main()
