"""Run a function on several ranks, each a process of its own.

``run_ranks(fn, nprocs, args)`` spawns ``nprocs`` processes (the ``spawn``
start method: CUDA does not survive ``fork``), initialises the default
process group in each (``mesh.init_group``), calls ``fn(group, *args)``
there and returns the ranks' results in rank order.  A rank that raises, a
rank that dies and ranks that do not finish within ``timeout_s`` raise
``RuntimeError`` here; every child is ended before it returns or raises.
``fn`` must be importable by name (a module-level function), and its
result picklable; tensors in it come back as numpy arrays.  A rank may
start processes of its own (a data loader's workers).

``run_spmd(fn, nproc, device, *args)``: a CLI's ranks, ``fn(group,
*args)`` on each: under ``torchrun`` (RANK and WORLD_SIZE set) this
process is one rank; else ``nproc`` ranks spawned by ``run_ranks``, or
``fn(None, *args)`` here for one.
"""

import os
import queue
import shutil
import tempfile
import time
import traceback

import numpy as np
import torch

# a collective's time limit where the run itself has none
COLLECTIVE_TIMEOUT_S = 300.0


def to_host(obj):
    """Tensors -> numpy arrays inside dicts, lists and tuples."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().float().cpu().numpy() \
            if obj.dtype == torch.bfloat16 else obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_host(v) for v in obj)
    return obj


def _rank_main(fn, rank, nprocs, init_method, device, backend, timeout_s,
               args, results):
    import torch.distributed as dist

    from .mesh import init_group

    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    try:
        group = init_group(rank, nprocs, init_method, device, backend,
                           timeout_s or COLLECTIVE_TIMEOUT_S)
        out = ("ok", to_host(fn(group, *args)))
    except Exception:   # reported to the parent, which fails the run
        out = ("error", traceback.format_exc())
    results.put((rank, *out))
    if dist.is_initialized():
        dist.destroy_process_group()


def _stop(procs, grace_s: float = 5.0) -> None:
    """Join every process, ending those still alive (SIGTERM, then
    SIGKILL)."""
    deadline = time.monotonic() + grace_s
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.terminate()
            p.join(grace_s)
        if p.is_alive():
            p.kill()
            p.join(grace_s)


def run_ranks(fn, nprocs: int, args: tuple = (), device: str = "cuda",
              backend: str | None = None, timeout_s: float | None = 600.0,
              init_method: str | None = None) -> list:
    """``[fn(group, *args) of rank 0, ..., of rank nprocs - 1]``.

    ``device``/``backend`` as ``mesh.init_group``'s.  ``init_method``: a
    rendezvous URL; by default a file store in a temporary directory,
    removed afterwards.  CPU ranks run one torch thread each.
    ``timeout_s``: None waits for the ranks as long as they run (a
    training run), each collective then timing out after
    ``COLLECTIVE_TIMEOUT_S``."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    tmp = None
    if init_method is None:
        tmp = tempfile.mkdtemp(prefix="mhada_ranks_")
        init_method = f"file://{os.path.join(tmp, 'store')}"
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, nprocs, init_method, str(device),
                               backend, timeout_s, args, results))
             for r in range(nprocs)]
    got, errors = {}, []
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + (timeout_s or float("inf"))
        while len(got) + len(errors) < nprocs and not errors:
            try:
                rank, status, value = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if not p.is_alive() and r not in got]
                if dead and results.empty():
                    errors.append(f"rank(s) {dead} exited without a "
                                  f"result (exit codes "
                                  f"{[procs[r].exitcode for r in dead]})")
                elif time.monotonic() > deadline:
                    errors.append(f"ranks {sorted(set(range(nprocs)) - set(got))}"
                                  f" did not finish within {timeout_s} s")
                continue
            if status == "ok":
                got[rank] = value
            else:
                errors.append(f"rank {rank} raised:\n{value}")
    finally:
        _stop(procs, grace_s=5.0 if not errors else 1.0)
        results.close()
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    if errors:
        raise RuntimeError("; ".join(errors))
    return [got[r] for r in range(nprocs)]


def run_spmd(fn, nproc: int, device, *args):
    """``fn(group, *args)`` on each rank of a CLI run -> rank 0's result
    (this process's under ``torchrun``).  Under ``torchrun`` (RANK and
    WORLD_SIZE set) this process is one rank, rendezvousing by the
    environment; else ``nproc`` > 1 ranks are spawned here (the kernels
    built first, on a card), or ``fn(None, *args)`` runs here for one."""
    import torch.distributed as dist

    from ..config import resolve_device
    from .mesh import init_group

    device = resolve_device(device)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        group = init_group(int(os.environ["RANK"]),
                           int(os.environ["WORLD_SIZE"]), "env://", device)
        try:
            return fn(group, *args)
        finally:
            dist.destroy_process_group()
    if nproc == 1:
        return fn(None, *args)
    if device.type == "cuda":   # build once, before the ranks race to it
        from .. import _build

        _build.build()
    return run_ranks(fn, nproc, args, device=str(device), timeout_s=None)[0]
