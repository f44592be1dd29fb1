"""Process groups, the (data, model) mesh, data parallelism and the
tensor-parallel split of the parameters (mhada_tpu/parallel/mesh.py).

The JAX package lays a ('data', 'model') ``Mesh`` over the chips and lets
XLA place the collectives; here every rank is a process that holds its own
modules, and each axis of the mesh is a ``torch.distributed`` process group
(``collectives.Group``).

- ``pick_backend``: NCCL when each rank has a card of its own; gloo when
  ranks share a card or run on the CPU (NCCL puts no two ranks of one
  communicator on one card).
- ``init_group``: initialise the default process group for this rank and
  return it as a ``Group``; ``Group()`` takes one already initialised.
- ``make_mesh(n_data, n_model, device)``: this rank's 'data' and 'model'
  groups, rank r = d n_model + m as JAX's ``reshape(n_data, n_model)``.
- ``shard_batch``: this rank's slice of dim 0; ``replicate``: every
  parameter and buffer broadcast from rank 0.
- ``param_sharding_rules``: the JAX ``_TP_RULES`` (mesh.py:51-73) against
  the port's parameter names; ``shard_params``: this rank's local modules,
  the ViT attention and MLP and the MHAda heads split over 'model';
  ``gather_params``: their inverse, the whole state_dict (or gradients);
  ``replicas_equal``: whether the replicated ones agree bitwise;
  ``average_gradients``: the data-parallel mean before Adam.

Data-parallel inference is ``replicate`` and ``shard_batch`` around
``infer.image.make_stylize_fn`` or ``make_stylize_with_kv_fn``, and
``gather_batch`` to assemble the outputs.  Data-parallel and DP x TP
training is ``shard_params`` and the training steps' ``data`` and ``model``
groups (``train.train_image.make_image_train_step``).
"""

import copy
import re
from datetime import timedelta
from typing import NamedTuple

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


class Mesh(NamedTuple):
    """This rank's groups of the ('data', 'model') mesh."""
    data: Group
    model: Group


def make_mesh(n_data: int, n_model: int,
              device: torch.device | str) -> Mesh:
    """Split the default group's ranks into the (n_data, n_model) mesh:
    rank r = d n_model + m, as JAX's ``np.array(devices).reshape(n_data,
    n_model)``.  The 'data' group of rank r holds the ranks with its m,
    its 'model' group the ranks with its d.  Every rank must call this,
    in the same order as any other ``new_group``."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_data * n_model != world:
        raise ValueError(f"mesh {n_data} x {n_model} != {world} ranks")
    groups = {}
    for m in range(n_model):
        pg = dist.new_group([d * n_model + m for d in range(n_data)])
        if rank % n_model == m:
            groups["data"] = Group(pg, device)
    for d in range(n_data):
        pg = dist.new_group([d * n_model + m for m in range(n_model)])
        if rank // n_model == d:
            groups["model"] = Group(pg, device)
    return Mesh(**groups)


class Shard(NamedTuple):
    """A parameter split over 'model': axis ``dim``, taken as ``parts``
    equal parts (the packed q, k and v) each split in rank order."""
    dim: int
    parts: int = 1


# (name regex, split): the JAX rules (mhada_tpu/parallel/mesh.py:51-73) on
# the port's names and layouts.  Linear weights are (out, in) here, the
# transpose of the JAX kernels, so JAX's P(None, 'model') is dim 0 and
# P('model', None) dim 1.  The packed qkv (3E, E) splits by heads: this
# rank's rows of q, of k and of v, so K6 takes it as its packed qkv (the
# JAX rule cuts the 3E axis in one piece, which GSPMD re-lays out).
_TP_RULES = [
    (re.compile(r".*attention\.qkv_weight$"), Shard(0, 3)),
    (re.compile(r".*attention\.qkv_bias$"), Shard(0, 3)),
    (re.compile(r".*attention\.out_proj\.weight$"), Shard(1)),
    (re.compile(r".*mlp_fc1\.weight$"), Shard(0)),
    (re.compile(r".*mlp_fc1\.bias$"), Shard(0)),
    (re.compile(r".*mlp_fc2\.weight$"), Shard(1)),
    # the MHAda (heads, d, d) stacks and their (heads, d) biases
    (re.compile(r".*\.(f|g|h)_kernel$"), Shard(0)),
    (re.compile(r".*\.(f|g|h)_bias$"), Shard(0)),
]


def param_sharding_rules(name: str) -> Shard | None:
    """The split of the parameter ``name`` (a module's ``named_parameters``
    name), or None: replicated.  First match wins."""
    for rx, spec in _TP_RULES:
        if rx.match(name):
            return spec
    return None


def shard_tensor(t: torch.Tensor, spec: Shard, rank: int,
                 ranks: int) -> torch.Tensor:
    """Rank ``rank``'s share of the whole tensor ``t``."""
    return torch.cat([part.chunk(ranks, spec.dim)[rank]
                      for part in t.chunk(spec.parts, spec.dim)],
                     spec.dim).contiguous()


def unshard_tensor(shares, spec: Shard) -> torch.Tensor:
    """The whole tensor from every rank's share, in rank order."""
    split = [s.chunk(spec.parts, spec.dim) for s in shares]
    return torch.cat([torch.cat([s[i] for s in split], spec.dim)
                      for i in range(spec.parts)], spec.dim)


def shard_params(models: dict, group: Group) -> dict:
    """This rank's modules for tensor parallelism over ``group`` (the
    'model' group): a copy of each module holding a split parameter, with
    this rank's share of every parameter that ``param_sharding_rules``
    splits, its heads' count divided and ``group`` set on the modules that
    run TP (the ViT attention and block, the MHAda blocks).  Modules
    without a split parameter (VGG) are shared, not copied.  With one rank
    in ``group`` every module is replicated and returned as it is (the JAX
    function's degenerate axis, mesh.py:85-87)."""
    from ..models.adaformer import AdaAttnMultiHead
    from ..models.layers import MultiHeadSelfAttention
    from ..models.vit import EncoderBlock

    if group.size == 1:
        return dict(models)
    out = {}
    for key, module in models.items():
        if not any(param_sharding_rules(k) for k, _ in
                   module.named_parameters()):
            out[key] = module
            continue
        local = copy.deepcopy(module)
        names = {p: k for k, p in local.named_parameters()}
        for mod in local.modules():
            if isinstance(mod, (MultiHeadSelfAttention, AdaAttnMultiHead)):
                if mod.num_heads % group.size:
                    raise ValueError(f"{mod.num_heads} heads do not divide "
                                     f"over {group.size} ranks")
                mod.num_heads //= group.size
            if isinstance(mod, (MultiHeadSelfAttention, EncoderBlock,
                                AdaAttnMultiHead)):
                mod.model_group = group
            for name, p in list(mod.named_parameters(recurse=False)):
                spec = param_sharding_rules(names[p])
                if spec is not None:
                    setattr(mod, name, torch.nn.Parameter(
                        shard_tensor(p.detach(), spec, group.rank,
                                     group.size),
                        requires_grad=p.requires_grad))
        out[key] = local
    return out


def _all_gather_flat(group: Group, tensors: list) -> list:
    """Every rank's copy of each tensor, (ranks, *shape), by one all-gather
    of their concatenation (the tensors share a dtype)."""
    stacked = group.all_gather(torch.cat([t.reshape(-1) for t in tensors]))
    return [g.view(group.size, *t.shape) for t, g in zip(
        tensors, stacked.split([t.numel() for t in tensors], dim=1))]


@torch.no_grad()
def gather_params(models: dict, group: Group, grads: bool = False) -> dict:
    """{name: the whole state_dict} of ``shard_params``' modules, each split
    parameter gathered over ``group`` (the 'model' group); with ``grads``
    their gradients instead, by parameter name (zeros where a parameter has
    none).  Every rank of ``group`` must call it; every rank gets the
    whole."""
    items = {}
    for key, module in models.items():
        if grads:
            items[key] = [(k, torch.zeros_like(p) if p.grad is None
                           else p.grad) for k, p in module.named_parameters()]
        else:
            items[key] = list(module.state_dict().items())
    split = [(key, k, t) for key, kts in items.items() for k, t in kts
             if group.size > 1 and param_sharding_rules(k) is not None]
    whole = {}
    if split:
        shares = _all_gather_flat(group, [t for _, _, t in split])
        whole = {(key, k): unshard_tensor(g.unbind(0),
                                          param_sharding_rules(k))
                 for (key, k, _), g in zip(split, shares)}
    return {key: {k: whole.get((key, k), t).detach().clone()
                  for k, t in kts} for key, kts in items.items()}


@torch.no_grad()
def replicas_equal(models: dict, group: Group) -> bool:
    """Whether every parameter of ``models`` that ``param_sharding_rules``
    leaves whole (every parameter, with one rank) is bitwise the same on
    each rank of ``group``.  Every rank of ``group`` must call it."""
    ts = [p.detach() for m in models.values()
          for k, p in m.named_parameters()
          if group.size == 1 or param_sharding_rules(k) is None]
    return all(torch.equal(g[0], x) for g in _all_gather_flat(group, ts)
               for x in g[1:])


@torch.no_grad()
def average_gradients(params, data: Group, model: Group | None = None
                      ) -> None:
    """Replace each gradient of ``params`` ((name, parameter) pairs of
    ``shard_params``' modules) by its data-parallel mean, in float32.

    A split parameter's gradient is this rank's share: its mean over
    ``data``.  A replicated parameter's gradient is the same on every rank
    of ``model``, up to the order of a kernel's atomic adds, so its mean
    over every rank of the mesh is the mean over ``data``, and it leaves the
    replicas bitwise equal.  One all-reduce of a flat buffer per kind."""
    tp = model is not None and model.size > 1
    split, rest = [], []
    for name, p in params:
        if p.grad is not None:
            (split if tp and param_sharding_rules(name) else rest).append(p)
    world = Group(device=data.device) if tp else data
    if tp and world.size != data.size * model.size:
        raise ValueError(f"the mesh {data.size} x {model.size} is not the "
                         f"{world.size} ranks of the default group")
    for group, ps in ((data, split), (world, rest)):
        if not ps or group.size == 1:
            continue
        flat = torch.cat([p.grad.float().reshape(-1) for p in ps])
        flat = group.all_reduce_sum(flat) / group.size
        for p, g in zip(ps, flat.split([p.numel() for p in ps])):
            p.grad.copy_(g.view_as(p.grad))
