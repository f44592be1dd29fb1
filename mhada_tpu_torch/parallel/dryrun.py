"""Dry run of the multi-rank serving paths (the counterpart of
``__graft_entry__.py::dryrun_multichip``'s phases 2 and 3, plus data-parallel
inference), each held against the single-rank path on rank 0:

1. sequence parallelism: one (1, 16 n, 64) frame row-sharded over the n
   ranks against a 64^2 style (``sp.make_sp_stylize_fn``);
2. pipeline parallelism: 3 frames of 64^2 through the MHAda blocks staged
   over n ranks, or over 2 where n does not divide them
   (``pp.make_pp_stylize_fn``);
3. data parallelism: a batch of 2 n pairs at 32^2, 2 a rank, around
   ``infer.image.make_stylize_fn`` (``mesh.replicate``, ``shard_batch``).

    python -m mhada_tpu_torch.parallel.dryrun --nproc N [--device cpu]
        [--backend nccl|gloo] [--tiny]

spawns its N ranks itself; under ``torchrun`` (RANK, WORLD_SIZE,
MASTER_ADDR and MASTER_PORT set) each process is one rank.  The model is
``ModelConfig()`` (``--tiny``: TINY, a quick check) with random weights
from seed 0, c6 scaled by C6_GAIN
and its bias raised by C6_OFFSET (0-255 units) so that no output channel
sits at the ReLU's 0 and a fault cannot hide there.  Prints one JSON line per rank and exits non-zero
if any rank fails or a path leaves the single-rank frames by more than
``BOUND``.  On the card the kernels are built before the ranks start.
"""

import argparse
import json
import os
import sys

import numpy as np
import torch

# max |pixel| (0-255) of a parallel path against the single-rank path,
# float32 (the repo's reference gate, scripts/reference_gate.py:63)
BOUND = 0.1
C6_GAIN, C6_OFFSET = 3000.0, 50.0
# a narrow trunk for quick checks (heads of 64, as the kernels take)
TINY = dict(num_layers=3, hidden_dim=128, num_heads=2, mlp_dim=256)


def _models(device, seed: int = 0, tiny: bool = False):
    from ..config import ModelConfig
    from ..models import build_models

    models = build_models(ModelConfig(**(TINY if tiny else {})), device,
                          torch.Generator().manual_seed(seed))
    c6 = models["adaFormer"].decoder.c6.conv
    with torch.no_grad():
        c6.weight.mul_(C6_GAIN)
        c6.bias.mul_(C6_GAIN).add_(C6_OFFSET)
    return models


def _frames(shape, seed: int, device) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(0, 255, shape).astype(np.float32)
                            ).to(device)


def dryrun_rank(group, tiny: bool = False) -> dict:
    """The three paths on this rank -> {path: max |pixel| against the
    single-rank path (rank 0's; None elsewhere), ...}."""
    import torch.distributed as dist

    from ..infer.image import (make_encode_style_fn, make_stylize_fn,
                               make_stylize_with_kv_fn, precompute_style_kv)
    from .collectives import Group
    from .mesh import gather_batch, replicate, shard_batch
    from .pp import make_pp_stylize_fn
    from .sp import make_sp_stylize_fn

    dev, n = group.device, group.size
    # a seed per rank: replicate must make the weights rank 0's
    models = _models(dev, seed=group.rank, tiny=tiny)
    replicate(group, models)
    style = _frames((1, 64, 64, 3), 3, dev)
    kv = precompute_style_kv(models, make_encode_style_fn(models)(style))
    single = make_stylize_with_kv_fn(models)
    out = {"rank": group.rank, "backend": group.backend,
           "device": str(dev)}

    def err(got, ref):
        return float((got - ref).abs().max()) if group.rank == 0 else None

    content = _frames((1, 16 * n, 64, 3), 2, dev)
    cs = make_sp_stylize_fn(models, group)(content, kv)
    out["sp"] = err(cs, single(content, kv))
    out["sp_shape"] = list(cs.shape)
    out["sp_mean"] = float(cs.mean())

    n_pp = n if (2 * models["adaFormer"].num_layers) % n == 0 else 2
    pp_group = group
    if n_pp != n:   # every rank takes part in making the sub-group
        pg = dist.new_group(list(range(n_pp)))
        pp_group = Group(pg, dev) if group.rank < n_pp else None
    frames = _frames((3, 1, 64, 64, 3), 4, dev)
    if pp_group is not None:
        cs = make_pp_stylize_fn(models, pp_group)(frames, kv)
        if cs is not None:   # the last stage
            ref = torch.stack([single(f, kv) for f in frames])
            out["pp"] = float((cs - ref).abs().max())
            out["pp_shape"] = list(cs.shape)
    out["pp_stages"] = n_pp

    contents = _frames((2 * n, 32, 32, 3), 5, dev)
    styles = _frames((2 * n, 32, 32, 3), 6, dev)
    fn = make_stylize_fn(models)
    cs = gather_batch(group, fn(*shard_batch(group, contents, styles)))
    out["dp"] = err(cs, fn(contents, styles))
    out["dp_shape"] = list(cs.shape)
    return out


def _check(results) -> bool:
    errs = [r[k] for r in results for k in ("sp", "pp", "dp")
            if r.get(k) is not None]
    return len(errs) == 3 and all(e <= BOUND for e in errs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nproc", type=int, default=2)
    ap.add_argument("--device", default="cuda",
                    help="default: cuda; without a card pass --device cpu")
    ap.add_argument("--backend", choices=["nccl", "gloo"], default=None,
                    help="default: NCCL when each rank has a card of its "
                    "own, else gloo")
    ap.add_argument("--tiny", action="store_true",
                    help="a narrow trunk (TINY) in place of ModelConfig()")
    args = ap.parse_args(argv)

    from ..config import resolve_device
    from .launch import run_ranks
    from .mesh import init_group

    device = resolve_device(args.device)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:   # torchrun
        import torch.distributed as dist

        group = init_group(int(os.environ["RANK"]),
                           int(os.environ["WORLD_SIZE"]), "env://", device,
                           args.backend)
        try:
            result = dryrun_rank(group, args.tiny)
        finally:
            dist.destroy_process_group()
        print(json.dumps(result), flush=True)
        return 0 if group.rank != 0 or _check_rank0(result) else 1
    if device.type == "cuda":   # build once, before the ranks race to it
        from .. import _build

        _build.build()
    results = run_ranks(dryrun_rank, args.nproc, (args.tiny,),
                        device=str(device), backend=args.backend)
    for r in results:
        print(json.dumps(r), flush=True)
    ok = _check(results)
    print(f"dryrun {'OK' if ok else 'FAILED'}: {args.nproc} ranks, "
          f"{results[0]['backend']}, bound {BOUND}", flush=True)
    return 0 if ok else 1


def _check_rank0(result) -> bool:
    """Under torchrun rank 0 holds SP's and DP's errors; the last stage
    PP's, which it prints."""
    return all(result[k] is not None and result[k] <= BOUND
               for k in ("sp", "dp"))


if __name__ == "__main__":
    sys.exit(main())
