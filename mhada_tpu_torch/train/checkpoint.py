"""Checkpoints with the reference's files and tree
(mhada_tpu/train/checkpoint.py; reference train_image.py:160-186).

- per-network weights ``{AdaFormer,ViT_C,ViT_S}{suffix}.pth``: reference
  state_dicts, so the reference and ``interop.load_pth_params`` read them;
  the suffix is ``_epoch_{E}_batchSize_{B}`` at an epoch's end and empty for
  the rolling snapshots.  Beside the AdaFormer file a sidecar
  ``AdaFormer{suffix}.pth.json`` names the attention mode the weights were
  trained with (``read_attn_mode``), since a reference state_dict cannot
  carry it and reference weights need the batch-coupled mode;
- ``checkpoint_epoch_{E}_batchSize_{B}.pth`` holding {epoch, batch_size,
  model_state {adaFormer, vit_c, vit_s}, optim_state}: the filename is
  load-bearing, as video training resumes from the image run's epoch-20
  file (reference train_video.py:81).

A checkpoint this package wrote carries its Adam state in ``optim_state``
and ``"writer": WRITER``; resuming from one restores Adam.  A reference
checkpoint's Adam state belongs to other modules, so resuming from one
restarts Adam, as the JAX package does (checkpoint.py:61-83).
"""

import json
import os
import re

import torch

from ..interop import export_state_dicts, jax_params_to_state_dicts
from ..interop import import_adaformer, import_vit

WRITER = "mhada_tpu_torch"
FILE_NAMES = {"adaFormer": "AdaFormer", "vit_c": "ViT_C", "vit_s": "ViT_S"}


def save_weights(directory: str, models: dict, num_layers: int = 3,
                 num_heads: int = 8, suffix: str = "",
                 attn_mode: str = "spatial") -> None:
    """The three networks as reference ``.pth`` state_dicts, and the
    AdaFormer file's sidecar naming ``attn_mode``."""
    os.makedirs(directory, exist_ok=True)
    sds = export_state_dicts(models, num_layers, num_heads)
    for key, fname in FILE_NAMES.items():
        torch.save(sds[key], os.path.join(directory, f"{fname}{suffix}.pth"))
    ada = os.path.join(directory, f"{FILE_NAMES['adaFormer']}{suffix}.pth")
    with open(ada + ".json", "w") as f:
        json.dump({"attn_mode": attn_mode, "writer": WRITER}, f)


def read_attn_mode(ada_path: str) -> str | None:
    """The attention mode in the sidecar of an AdaFormer ``.pth`` this
    package wrote, or None (a reference file has no sidecar)."""
    try:
        with open(f"{ada_path}.json") as f:
            return json.load(f)["attn_mode"]
    except FileNotFoundError:
        return None


def save_checkpoint(directory: str, epoch: int, batch_size: int,
                    models: dict, optimizers: dict, num_layers: int = 3,
                    num_heads: int = 8) -> str:
    """The combined checkpoint -> its path."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory,
                        f"checkpoint_epoch_{epoch}_batchSize_{batch_size}.pth")
    torch.save({
        "epoch": epoch, "batch_size": batch_size, "writer": WRITER,
        "model_state": export_state_dicts(models, num_layers, num_heads),
        "optim_state": {k: opt.state_dict() for k, opt in optimizers.items()},
    }, path)
    return path


def restore_checkpoint(path: str, models: dict, optimizers: dict,
                       num_layers: int = 3, num_heads: int = 8) -> int:
    """Load a combined checkpoint into ``models`` (strict) and, when this
    package wrote it, ``optimizers`` -> its epoch."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    ms = {k: {n: t.float().numpy() for n, t in sd.items()}
          for k, sd in ckpt["model_state"].items()}
    sds = jax_params_to_state_dicts({
        "vit_c": import_vit(ms["vit_c"], num_layers),
        "vit_s": import_vit(ms["vit_s"], num_layers),
        "adaFormer": import_adaformer(ms["adaFormer"], num_layers, num_heads),
    })
    for name, sd in sds.items():
        models[name].load_state_dict(sd, strict=True)
    if ckpt.get("writer") == WRITER:
        for name, opt in optimizers.items():
            opt.load_state_dict(ckpt["optim_state"][name])
    return int(ckpt["epoch"])


def latest_checkpoint(directory: str, batch_size: int) -> str | None:
    """The newest ``checkpoint_epoch_{E}_batchSize_{B}.pth`` in
    ``directory``, or None."""
    if not os.path.isdir(directory):
        return None
    pat = re.compile(rf"checkpoint_epoch_(\d+)_batchSize_{batch_size}\.pth$")
    found = [(int(m.group(1)), name) for name in os.listdir(directory)
             if (m := pat.match(name))]
    return os.path.join(directory, max(found)[1]) if found else None
