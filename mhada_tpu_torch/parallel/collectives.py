"""The collectives of the parallel paths, over one ``torch.distributed``
process group (the counterparts of ``lax.all_gather``, ``lax.pmean`` and
``lax.ppermute`` inside the JAX package's ``shard_map``s).

Under NCCL (each rank on a card of its own) and under gloo with CPU tensors
every collective is the native one.  gloo takes CUDA tensors only in
``broadcast`` and ``all_reduce``, so with gloo holding CUDA tensors (ranks
that share one card) the gather and the ring shift are built from one
``all_reduce``: each rank writes its tensor's bytes into its own slot of a
zero-filled uint8 buffer and the sum over the ranks is the gathered bytes,
since x + 0 = x exactly for every byte.  The results are bitwise those of
the native ops (NaN payloads and signed zeros included).  The path is
chosen by the group's backend and the tensor's device, never by catching
an error; ``Group(via_all_reduce=True)`` forces the all-reduce path, which
is how the CPU tests hold it to the native ops.
"""

import torch
import torch.distributed as dist


class Group:
    """The ranks of one parallel axis and its collectives.

    ``pg``: a process group, or None for the default (world) group, which
    must be initialised (``mesh.init_group``).  ``device``: this rank's
    device.  ``via_all_reduce``: None chooses the gather's and the shift's
    path by the backend (see the module docstring); True or False forces
    it."""

    def __init__(self, pg=None, device: torch.device | str = "cpu",
                 via_all_reduce: bool | None = None):
        self.pg = pg
        self.device = torch.device(device)
        self.rank = dist.get_rank(pg)
        self.size = dist.get_world_size(pg)
        self.backend = str(dist.get_backend(pg))
        self.via_all_reduce = via_all_reduce

    def __repr__(self) -> str:
        return (f"Group(rank {self.rank} of {self.size}, {self.backend}, "
                f"{self.device})")

    def global_rank(self, rank: int) -> int:
        """The default group's rank of this group's ``rank``."""
        return rank if self.pg is None else dist.get_global_rank(self.pg,
                                                                 rank)

    def _reduced(self, x: torch.Tensor) -> bool:
        if self.via_all_reduce is not None:
            return self.via_all_reduce
        return self.backend == "gloo" and x.is_cuda

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the ranks (a new tensor)."""
        y = x.contiguous().clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=self.pg)
        return y

    def all_reduce_mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean of ``x`` over the ranks: ``lax.pmean``."""
        return self.all_reduce_sum(x) / self.size

    def broadcast_(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Overwrite ``x`` (contiguous) with rank ``src``'s, in place."""
        dist.broadcast(x, src=self.global_rank(src), group=self.pg)
        return x

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` stacked in rank order: (size, *x.shape)."""
        x = x.contiguous()
        if self._reduced(x):
            return self._all_gather_by_reduce(x)
        out = torch.empty((self.size, *x.shape), dtype=x.dtype,
                          device=x.device)
        dist.all_gather(list(out.unbind(0)), x, group=self.pg)
        return out

    def _all_gather_by_reduce(self, x: torch.Tensor) -> torch.Tensor:
        flat = x.reshape(-1).view(torch.uint8)
        buf = torch.zeros((self.size, flat.numel()), dtype=torch.uint8,
                          device=x.device)
        buf[self.rank] = flat
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=self.pg)
        return buf.view(x.dtype).view(self.size, *x.shape)

    def gather_rows(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """Every rank's ``x`` concatenated along ``dim`` in rank order: the
        tiled ``lax.all_gather`` of a row-sharded tensor."""
        return torch.cat(self.all_gather(x).unbind(0), dim=dim)

    def ring_shift(self, x: torch.Tensor) -> torch.Tensor:
        """Send ``x`` to the next rank and return the previous rank's
        (rank 0 receives the last rank's): ``lax.ppermute`` over the ring
        i -> i + 1."""
        x = x.contiguous()
        if self.size == 1:
            return x.clone()
        prev = (self.rank - 1) % self.size
        if self._reduced(x):
            return self._all_gather_by_reduce(x)[prev].clone()
        out = torch.empty_like(x)
        nxt = (self.rank + 1) % self.size
        ops = [dist.P2POp(dist.isend, x, self.global_rank(nxt), self.pg),
               dist.P2POp(dist.irecv, out, self.global_rank(prev), self.pg)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out
