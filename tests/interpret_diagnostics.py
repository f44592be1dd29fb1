"""What a failed comparison against a Pallas kernel in interpret mode
prints: the largest error, the non-finite values on each side, each
side's error against a float64 evaluation of the same function, the xdist
worker, its peak RSS, the floating-point environment of the main thread
and of torch's intra-op threads and whether the TPU interpreter held state
from an earlier kernel of the process; and the harness that keeps K3's
plain version and the interpreted kernel clear of such state
(``nearest_on_this_thread``, ``fresh_interpreter``)."""

import contextlib
import ctypes
import os
import resource

import numpy as np
import torch

# fegetround / fesetround's modes on x86-64 (glibc's fenv.h)
_ROUNDING = {0: "nearest", 0x400: "downward", 0x800: "upward",
             0xc00: "toward zero"}


def worker_state(stale):
    """Where a failure happened: the xdist worker, its peak RSS, and whether
    the Pallas TPU interpreter held state from an earlier kernel of this
    process when the comparison started (it is left behind when a kernel
    raises while being interpreted, and is shared by every kernel of the
    process)."""
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20
    return (f"worker {os.environ.get('PYTEST_XDIST_WORKER', 'main')}, peak "
            f"RSS {peak:.2f} GiB, {fp_env()}, interpreter state left over: "
            f"{stale}")


def _libm():
    try:
        return ctypes.CDLL("libm.so.6")
    except OSError:
        return None


def fp_env():
    """The main thread's rounding mode and whether it flushes float32
    subnormals, and whether torch's intra-op threads round to nearest: a
    library that changes either moves every float sum, and a thread keeps
    the floating-point environment of the thread that started it."""
    libm = _libm()
    mode = libm.fegetround() if libm is not None else None
    tiny = np.float32(1e-39)
    flushes = bool(np.array([tiny], np.float32)[0] * np.float32(1) == 0)
    pool = "not read"
    if mode == 0:   # divisions spread over the intra-op threads: 1/3 and
        # -1/3 round away from zero to nearest, so a directed mode moves one
        third = np.float32(1) / np.float32(3)
        off = sum(int((torch.full((1 << 22,), sign) / 3.0
                       != float(sign * third)).sum()) for sign in (1.0, -1.0))
        pool = "nearest" if off == 0 else f"not nearest on {off} values"
    return (f"rounding {_ROUNDING.get(mode, mode)}, subnormals "
            f"{'flushed' if flushes else 'kept'}, intra-op threads {pool}")


def fresh_interpreter():
    """Drop the TPU interpreter's process-wide state (simulated memory,
    buffer and DMA counters) before a kernel is interpreted: a kernel that
    raised leaves it behind, and JAX asks for this reset before the next
    one (jax._src.pallas.mosaic.interpret's
    reset_tpu_interpret_mode_state)."""
    try:
        from jax._src.pallas.mosaic.interpret.interpret_pallas_call import \
            reset_tpu_interpret_mode_state
    except ImportError:
        return
    reset_tpu_interpret_mode_state()


@contextlib.contextmanager
def nearest_on_this_thread():
    """Run the enclosed torch ops on the calling thread, rounding to
    nearest.  torch's intra-op threads keep the floating-point environment
    of the thread that started them: started under a directed rounding
    mode, they move K3's plain version by up to 8.9e-5 on the P2 probe
    test's inputs (float64 distance 8.7e-5 against 4.7e-6, measured on
    the CPU), past its 5e-5 bound, while XLA's threads keep rounding to
    nearest.  The calling thread's mode and torch's thread count are
    restored on exit."""
    libm, threads = _libm(), torch.get_num_threads()
    mode = libm.fegetround() if libm is not None else None
    torch.set_num_threads(1)
    if libm is not None:
        libm.fesetround(0)
    try:
        yield
    finally:
        if libm is not None:
            libm.fesetround(mode)
        torch.set_num_threads(threads)


def mhada_prologue_f64(fc, fcs, stats, wf, fb, k, v):
    """K3's function (mhada_tpu/ops/mhada_pallas.py::_fused_kernel) in
    float64 on numpy arrays: fc, fcs (B, N, C); stats (B, 4, C); wf
    (H, d, d) as (in, out); fb (H, d); k, v (B, M, C)."""
    f = [np.asarray(a, np.float64) for a in (fc, fcs, stats, wf, fb, k, v)]
    fc, fcs, st, wf, fb, k, v = f
    d = wf.shape[1]
    out = np.empty_like(fc)
    for h in range(wf.shape[0]):
        s = slice(h * d, (h + 1) * d)
        q = ((fc[..., s] - st[:, None, 0, s]) * st[:, None, 1, s]) @ wf[h] \
            + fb[h]
        logits = q @ k[..., s].transpose(0, 2, 1)
        p = np.exp(logits - logits.max(-1, keepdims=True))
        p /= p.sum(-1, keepdims=True)
        m1 = p @ v[..., s]
        e2 = p @ np.square(v[..., s])
        sd = np.sqrt(np.clip(e2 - np.square(m1), 1e-6, None))
        out[..., s] = sd * ((fcs[..., s] - st[:, None, 2, s])
                            * st[:, None, 3, s]) + m1
    return out


def interpreter_busy():
    """Whether the TPU interpreter's process-wide simulated memory exists
    (None where this JAX keeps it elsewhere)."""
    try:
        from jax._src.pallas.mosaic.interpret import interpret_pallas_call
    except ImportError:
        return None
    return getattr(interpret_pallas_call, "_shared_memory", None) is not None


def explain(got, ref, state, exact=None, atol=5e-5):
    """The diagnostic of a failed comparison: the largest error, the count
    of non-finite values on each side, with ``exact`` (a float64 evaluation
    of the same function) each side's largest error against it, so the
    side that drifted is named, and the worker's state."""
    finite = np.isfinite(got) & np.isfinite(ref)
    err = np.abs(got - ref)[finite]
    sides = ""
    if exact is not None:
        sides = "; against float64: " + ", ".join(
            f"{name} {np.nanmax(np.abs(x - exact)):.3e}"
            for name, x in (("got", got), ("ref", ref)))
    return (f"max|d| {err.max() if err.size else float('nan'):.3e} over "
            f"{err.size} finite pairs ({int((err > atol).sum())} above "
            f"{atol:g}); non-finite: got {int((~np.isfinite(got)).sum())}, "
            f"ref {int((~np.isfinite(ref)).sum())}{sides}; {state}")
