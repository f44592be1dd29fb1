"""Multi-rank paths over ``torch.distributed`` (mhada_tpu/parallel/):
sequence parallelism (``sp``), pipeline parallelism (``pp``),
data-parallel inference (``mesh.shard_batch`` and ``mesh.replicate``),
data-parallel and DP x TP training on a (data, model) mesh
(``mesh.make_mesh``, ``shard_params``, ``gather_params``, the collectives
of ``tp``), with the collectives of every path (``collectives.Group``) and
a dry run of them all (``python -m mhada_tpu_torch.parallel.dryrun``)."""

from .collectives import Group
from .mesh import (Mesh, average_gradients, gather_batch, gather_params,
                   init_group, make_mesh, param_sharding_rules, pick_backend,
                   replicas_equal, replicate, shard_batch, shard_params)
from .pp import make_pp_stylize_fn
from .sp import make_sp_stylize_fn, required_decode_margin

__all__ = ["Group", "Mesh", "average_gradients", "gather_batch",
           "gather_params", "init_group", "make_mesh", "make_pp_stylize_fn",
           "make_sp_stylize_fn", "param_sharding_rules", "pick_backend",
           "replicas_equal", "replicate", "required_decode_margin",
           "shard_batch", "shard_params"]
