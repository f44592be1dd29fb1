"""Dry run of the multi-rank paths (the counterpart of
``__graft_entry__.py::dryrun_multichip``'s four phases, plus data-parallel
inference), each held against the single-rank path on rank 0:

1. DP x TP training: one image step (B = 2 a data rank, 64^2) on the
   (n / n_model, n_model) mesh, n_model = 2 where n is even and >= 4,
   else 1 (``mesh.make_mesh``, ``shard_params``, the step's ``data`` and
   ``model`` groups), against one rank's step from the same weights on
   the global batch: the loss within TRAIN_LOSS_REL, every weight
   (``gather_params``) within Adam's first-step bound of 2 lr;
2. sequence parallelism: one (1, 16 n, 64) frame row-sharded over the n
   ranks against a 64^2 style (``sp.make_sp_stylize_fn``);
3. pipeline parallelism: 3 frames of 64^2 through the MHAda blocks staged
   over n ranks, or over 2 where n does not divide them
   (``pp.make_pp_stylize_fn``);
4. the video step on the same mesh (32 x 64 frames against 32^2 styles,
   sample 0 fully occluded), held as phase 1;
5. data-parallel inference: a batch of 2 n pairs at 32^2, 2 a rank,
   around ``infer.image.make_stylize_fn`` (``mesh.replicate``,
   ``shard_batch``).

    python -m mhada_tpu_torch.parallel.dryrun --nproc N [--device cpu]
        [--backend nccl|gloo] [--tiny]

spawns its N ranks itself; under ``torchrun`` (RANK, WORLD_SIZE,
MASTER_ADDR and MASTER_PORT set) each process is one rank.  The model is
``ModelConfig()`` (``--tiny``: TINY, a quick check) with random weights
from seed 0, c6 scaled by C6_GAIN
and its bias raised by C6_OFFSET (0-255 units) so that no output channel
sits at the ReLU's 0 and a fault cannot hide there.  Prints one JSON line per rank and exits non-zero
if any rank fails, a path leaves the single-rank frames by more than
``BOUND`` or a step leaves the single-rank step's bounds.  On the card
the kernels are built before the ranks start.
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
# a training step on the mesh against one rank's: the loss, relative (the
# chip's float32 step bound, chip_smoke.py's STEP_LOSS_REL), and each
# weight after Adam's first step, which moves it by about +-lr: 2 lr where
# a gradient that is rounding noise flips its sign, plus the weight's
# float32 rounding
TRAIN_LOSS_REL = 1e-4


def _treat(models) -> None:
    c6 = models["adaFormer"].decoder.c6.conv
    with torch.no_grad():
        c6.weight.mul_(C6_GAIN)
        c6.bias.mul_(C6_GAIN).add_(C6_OFFSET)


def _models(device, seed: int = 0, tiny: bool = False):
    from ..config import ModelConfig
    from ..models import build_models

    models = build_models(ModelConfig(**(TINY if tiny else {})), device,
                          torch.Generator().manual_seed(seed))
    _treat(models)
    return models


def _train_batches(n_data: int, device) -> dict:
    """{recipe: (config kwargs, global batch)} of phases 1 and 4, as the
    JAX dry run's: B = 2 a data rank, images 64^2; video frames 32 x 64
    against 32^2 styles, flow 2 N(0, 1), mask U > 0.5 with sample 0 fully
    occluded."""
    b = 2 * n_data
    rng = np.random.default_rng(5)
    mask = (rng.uniform(size=(b, 32, 64)) > 0.5).astype(np.float32)
    mask[0] = 0.0
    video = [rng.uniform(0, 255, (b, 32, 32, 3)),
             rng.uniform(0, 255, (b, 32, 64, 3)),
             rng.uniform(0, 255, (b, 32, 64, 3)),
             rng.standard_normal((b, 32, 64, 2)) * 2, mask]
    image = [np.random.default_rng(i).uniform(0, 255, (b, 64, 64, 3))
             for i in (0, 1)]
    return {kind: (kw, [torch.from_numpy(a.astype(np.float32)).to(device)
                        for a in batch])
            for kind, kw, batch in (
                ("image", dict(batch_size=b, image_size=(64, 64)), image),
                ("video", dict(batch_size=b, style_size=(32, 32),
                               content_size=(32, 64)), video))}


def train_rank(group, kind: str, tiny: bool = False) -> dict:
    """Phase 1 (``kind`` "image") or 4 ("video") on this rank: one step on
    the (n / n_model, n_model) mesh -> {mesh, loss, and on rank 0 its
    error against one rank's step: loss_rel, max |weight| difference
    over the bound (<= 0 within)}."""
    from ..config import ImageTrainConfig, ModelConfig, VideoTrainConfig
    from ..train.recipes import recipe
    from ..train.train_image import TRAINABLE, init_params, make_optimizers
    from .mesh import gather_params, make_mesh, shard_batch, shard_params

    dev, n = group.device, group.size
    n_model = 2 if n % 2 == 0 and n >= 4 else 1
    mesh = make_mesh(n // n_model, n_model, dev)
    kw, batch = _train_batches(n // n_model, dev)[kind]
    cls = ImageTrainConfig if kind == "image" else VideoTrainConfig
    cfg = cls(model=ModelConfig(**(TINY if tiny else {})), **kw)

    def build():
        models = init_params(cfg, dev, torch.Generator().manual_seed(0))
        _treat(models)
        return models

    local = shard_params(build(), mesh.model)
    step = recipe(cfg).make_step(cfg, local, make_optimizers(local, cfg),
                                 mesh.data, mesh.model)
    loss = float(step(*shard_batch(mesh.data, *batch))["loss"])
    new = gather_params({k: local[k] for k in TRAINABLE}, mesh.model)
    out = {f"{kind}_mesh": [n // n_model, n_model], f"{kind}_loss": loss}
    if group.rank == 0:
        ref = build()
        ref_loss = float(recipe(cfg).make_step(
            cfg, ref, make_optimizers(ref, cfg))(*batch)["loss"])
        eps = torch.finfo(torch.float32).eps
        out[f"{kind}_loss_rel"] = abs(loss - ref_loss) / abs(ref_loss)
        out[f"{kind}_over"] = max(
            float(((new[k][name] - t).abs() - 2 * cfg.lr
                   - eps * t.abs()).max())
            for k in TRAINABLE for name, t in ref[k].state_dict().items())
    return out


def _frames(shape, seed: int, device) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(0, 255, shape).astype(np.float32)
                            ).to(device)


def dryrun_rank(group, tiny: bool = False) -> dict:
    """The five phases on this rank -> {path: max |pixel| against the
    single-rank path (rank 0's; None elsewhere), ...; the steps' errors
    (``train_rank``)}."""
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
           "device": str(dev), **train_rank(group, "image", tiny)}

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
    out.update(train_rank(group, "video", tiny))

    contents = _frames((2 * n, 32, 32, 3), 5, dev)
    styles = _frames((2 * n, 32, 32, 3), 6, dev)
    fn = make_stylize_fn(models)
    cs = gather_batch(group, fn(*shard_batch(group, contents, styles)))
    out["dp"] = err(cs, fn(contents, styles))
    out["dp_shape"] = list(cs.shape)
    return out


def _steps_ok(result) -> bool:
    """Rank 0's steps within their bounds."""
    return all(result[f"{k}_loss_rel"] <= TRAIN_LOSS_REL
               and result[f"{k}_over"] <= 0 for k in ("image", "video"))


def _check(results) -> bool:
    errs = [r[k] for r in results for k in ("sp", "pp", "dp")
            if r.get(k) is not None]
    return (len(errs) == 3 and all(e <= BOUND for e in errs)
            and _steps_ok(results[0]))


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
          f"{results[0]['backend']}, bound {BOUND}; steps on mesh "
          f"{results[0]['image_mesh']}", flush=True)
    return 0 if ok else 1


def _check_rank0(result) -> bool:
    """Under torchrun rank 0 holds SP's, DP's and the steps' errors; the
    last stage PP's, which it prints."""
    return all(result[k] is not None and result[k] <= BOUND
               for k in ("sp", "dp")) and _steps_ok(result)


if __name__ == "__main__":
    sys.exit(main())
