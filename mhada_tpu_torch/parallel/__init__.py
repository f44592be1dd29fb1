"""Multi-rank serving paths over ``torch.distributed``
(mhada_tpu/parallel/): sequence parallelism (``sp``), pipeline parallelism
(``pp``) and data-parallel inference (``mesh.shard_batch`` and
``mesh.replicate``), with their collectives (``collectives.Group``) and a
dry run of all three (``python -m mhada_tpu_torch.parallel.dryrun``)."""

from .collectives import Group
from .mesh import (gather_batch, init_group, pick_backend, replicate,
                   shard_batch)
from .pp import make_pp_stylize_fn
from .sp import make_sp_stylize_fn, required_decode_margin

__all__ = ["Group", "gather_batch", "init_group", "make_pp_stylize_fn",
           "make_sp_stylize_fn", "pick_backend", "replicate",
           "required_decode_margin", "shard_batch"]
