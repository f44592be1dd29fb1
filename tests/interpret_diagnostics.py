"""What a failed comparison against a Pallas kernel in interpret mode
prints: the largest error, the non-finite values on each side, the xdist
worker, its peak RSS and whether the TPU interpreter held state from an
earlier kernel of the process."""

import os
import resource

import numpy as np


def worker_state(stale):
    """Where a failure happened: the xdist worker, its peak RSS, and whether
    the Pallas TPU interpreter held state from an earlier kernel of this
    process when the comparison started (it is left behind when a kernel
    raises while being interpreted, and is shared by every kernel of the
    process)."""
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20
    return (f"worker {os.environ.get('PYTEST_XDIST_WORKER', 'main')}, peak "
            f"RSS {peak:.2f} GiB, interpreter state left over: {stale}")


def interpreter_busy():
    """Whether the TPU interpreter's process-wide simulated memory exists
    (None where this JAX keeps it elsewhere)."""
    try:
        from jax._src.pallas.mosaic.interpret import interpret_pallas_call
    except ImportError:
        return None
    return getattr(interpret_pallas_call, "_shared_memory", None) is not None


def explain(got, ref, state):
    """The diagnostic of a failed comparison: the largest error, the count
    of non-finite values on each side, and the worker's state."""
    finite = np.isfinite(got) & np.isfinite(ref)
    err = np.abs(got - ref)[finite]
    return (f"max|d| {err.max() if err.size else float('nan'):.3e} over "
            f"{err.size} finite pairs; non-finite: got "
            f"{int((~np.isfinite(got)).sum())}, ref "
            f"{int((~np.isfinite(ref)).sum())}; {state}")
