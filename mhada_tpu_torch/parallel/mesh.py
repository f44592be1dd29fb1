"""Process groups and data parallelism (mhada_tpu/parallel/mesh.py:23-52).

The JAX package lays a ('data', 'model') ``Mesh`` over the chips and lets
XLA place the collectives; here every rank is a process that holds its own
modules, and the 'data' axis is a ``torch.distributed`` process group
(``collectives.Group``).

- ``pick_backend``: NCCL when each rank has a card of its own; gloo when
  ranks share a card or run on the CPU (NCCL puts no two ranks of one
  communicator on one card).
- ``init_group``: initialise the default process group for this rank and
  return it as a ``Group``; ``Group()`` takes one already initialised.
- ``shard_batch``: this rank's slice of dim 0; ``replicate``: every
  parameter and buffer broadcast from rank 0.

Data-parallel inference is ``replicate`` and ``shard_batch`` around
``infer.image.make_stylize_fn`` or ``make_stylize_with_kv_fn``, and
``gather_batch`` to assemble the outputs.  ``param_sharding_rules`` and
``shard_params`` (mesh.py:55-89, tensor parallelism for training) are not
ported here.
"""

from datetime import timedelta

import torch
import torch.distributed as dist

from ..config import resolve_device
from .collectives import Group

BACKENDS = ("nccl", "gloo")


def pick_backend(device: torch.device | str, world_size: int) -> str:
    """NCCL when ``device`` is CUDA and every rank has a card of its own,
    else gloo."""
    device = torch.device(device)
    if device.type == "cuda" and torch.cuda.device_count() >= world_size:
        return "nccl"
    return "gloo"


def rank_device(device: torch.device | str, rank: int) -> torch.device:
    """Rank ``rank``'s device: card ``rank`` modulo the cards visible (the
    ranks share them when there are fewer), or the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    return torch.device("cuda", rank % torch.cuda.device_count())


def init_group(rank: int, world_size: int, init_method: str,
               device: torch.device | str = "cuda",
               backend: str | None = None,
               timeout_s: float = 300.0) -> Group:
    """Initialise the default process group for ``rank`` and return it.

    ``device``: "cuda" (the default; raises without a card) or "cpu";
    ``backend``: "nccl", "gloo" or None for ``pick_backend``.  NCCL needs a
    card for each rank.  ``init_method``: e.g. ``tcp://localhost:PORT`` or
    ``file:///path``; "env://" under torchrun."""
    device = resolve_device(device)
    backend = backend or pick_backend(device, world_size)
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{BACKENDS}")
    if backend == "nccl" and pick_backend(device, world_size) != "nccl":
        raise ValueError(f"NCCL needs a card for each of {world_size} ranks "
                         f"({torch.cuda.device_count()} visible on "
                         f"{device.type}); use gloo")
    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=timedelta(seconds=timeout_s))
    return Group(device=dev)


def shard_batch(group: Group, *tensors: torch.Tensor):
    """This rank's contiguous slice of dim 0 of each tensor (one tensor
    returns one); dim 0 must divide by the group's size."""
    out = []
    for t in tensors:
        if t.shape[0] % group.size:
            raise ValueError(f"batch {t.shape[0]} does not divide over "
                             f"{group.size} ranks")
        n = t.shape[0] // group.size
        out.append(t[group.rank * n:(group.rank + 1) * n].contiguous())
    return out[0] if len(out) == 1 else tuple(out)


def gather_batch(group: Group, x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` concatenated along dim 0 in rank order: the inverse
    of ``shard_batch``."""
    return group.gather_rows(x, dim=0)


@torch.no_grad()
def replicate(group: Group, models) -> None:
    """Broadcast every parameter and buffer of ``models`` (a module or a dict
    of modules) from rank 0, in place."""
    mods = models.values() if isinstance(models, dict) else [models]
    for m in mods:
        for t in [*m.parameters(), *m.buffers()]:
            group.broadcast_(t.data)
