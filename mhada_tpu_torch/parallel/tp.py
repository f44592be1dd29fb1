"""Tensor parallelism over the 'model' axis of the mesh: the collectives
that the JAX package's GSPMD inserts around its TP rules
(mhada_tpu/parallel/mesh.py:51-89), written here where a column- and
row-parallel split needs them, as autograd Functions over a
``collectives.Group``:

- ``copy_to_model``: identity forward, the sum over the group backward.  It
  goes on every replicated input of a column-parallel op (the ViT's qkv and
  fc1 projections, the MHAda heads' channel slices): each rank's gradient
  of that input comes from its own columns only;
- ``reduce_from_model``: the sum over the group forward, identity backward.
  It goes on the output of every row-parallel op (``row_parallel_linear``:
  the ViT's out_proj and fc2);
- ``gather_channels``: the ranks' channel slices concatenated in rank order
  forward, this rank's slice of the gradient backward (the MHAda heads'
  outputs).

Sums run in float32 and round once to the tensor's dtype, where the
single-rank matmul rounds.  They are built on ``Group.all_reduce_sum`` and
``Group.gather_rows``, so NCCL and both gloo paths work.
"""

import torch
import torch.nn.functional as F

from .collectives import Group


def _sum(group: Group, x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over ``group`` in float32, rounded once to x's
    dtype."""
    return group.all_reduce_sum(x.float()).to(x.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _copy_grad(ctx.group, g), None


def _copy_grad(group: Group, g: torch.Tensor) -> torch.Tensor:
    """``copy_to_model``'s backward: each rank's gradient summed."""
    return _sum(group, g)


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum(group, x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherChannels(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.c = group, x.shape[-1]
        return group.gather_rows(x, dim=x.dim() - 1)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(-1, ctx.group.rank * ctx.c, ctx.c).contiguous(), None


def copy_to_model(x: torch.Tensor, group: Group) -> torch.Tensor:
    """``x`` as it is; its gradient summed over ``group``."""
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The sum of every rank's ``x`` (float32, rounded once to x's dtype);
    the gradient passes through."""
    return _ReduceFromModel.apply(x, group)


def gather_channels(x: torch.Tensor, group: Group) -> torch.Tensor:
    """(..., c) on each rank -> (..., c x ranks), the ranks' slices in rank
    order; each rank's gradient is its own slice."""
    return _GatherChannels.apply(x, group)


def ln_affine_to_model(group: Group, *params: torch.Tensor):
    """The LayerNorm affine of a fused column-parallel projection (K2), its
    gradient summed over ``group``: K2's VJP returns each rank's share of it,
    from that rank's output columns alone."""
    return tuple(copy_to_model(p, group) for p in params)


def row_parallel_linear(x: torch.Tensor, weight: torch.Tensor,
                        bias: torch.Tensor, group: Group) -> torch.Tensor:
    """``x @ weight.T + bias`` where x (..., k) and weight (out, k) hold this
    rank's slice of the input axis: the partial products in float32 from
    the compute-dtype operands, summed over ``group``, the bias added once,
    rounded once to x's dtype (the single-rank matmul's rounding point)."""
    dt = x.dtype
    y = F.linear(x.float(), weight.to(dt).float())
    return (reduce_from_model(y, group) + bias.to(dt).float()).to(dt)
