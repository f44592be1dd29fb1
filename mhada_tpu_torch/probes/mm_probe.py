"""P1: a bf16 matmul probe on the tensor cores (csrc/mm_probe.cu).

Counterpart of scripts/mxu_probe.py: the TPU probe timed a bare Pallas
matmul (``_mm_kernel``) at the attention tile shapes with its operands
resident in VMEM, to map which dimensions quantize on the matrix unit.
Here ``mm(a, b, reps)`` launches a hand-written ``wgmma`` + TMA kernel
(csrc/mm_wgmma.cuh) whose grid repeats the whole product ``reps`` times on
the same operands, so after the first rep they come from L2;
``torch.matmul`` (cuBLAS) at the same shape, ``reps`` calls replayed from
a CUDA graph, is the yardstick.  It measures what the card's GEMM design
reaches at the flash kernels' shapes.

    python -m mhada_tpu_torch.probes.mm_probe [--reps 400] [--iters 8]
    python -m mhada_tpu_torch.probes.mm_probe --sweep   # card only

prints one line per shape: us per product, useful TFLOP/s, cuBLAS's
TFLOP/s and the max error against ``mm_plain``.  ``--sweep`` times every
block tile the kernel is built with at each shape instead (one JSON line
each, two rounds), the measurement behind ``TILES``.
"""

import argparse
import json

import numpy as np
import torch

from .. import _build
from ..config import resolve_device, use_kernel
from ..infer.timing import _elapsed_ms

# (m, k, n) of scripts/mxu_probe.py:75-88
SHAPES = [
    (512, 2048, 512),    # baseline: every dimension >= 128
    (512, 2048, 64),     # P V head-major: output width d = 64
    (512, 2048, 128),
    (64, 2048, 512),     # P V transposed: 64 streamed rows
    (128, 2048, 512),
    (256, 2048, 512),
    (512, 64, 2048),     # Q K^T: contraction depth d = 64
    (512, 128, 2048),
]
# m, n and k are multiples of these: the smallest block tile (BM x BN) and
# the k of a pipeline stage (BK).
BM, BN, BK = 64, 64, 64
# The block tiles (BM, BN) the kernel is built with, and the one each shape
# takes (timed with --sweep).
BLOCK_TILES = [(bm, bn) for bm in (64, 128) for bn in (64, 128, 256)]
TILES = {
    (512, 2048, 512): (128, 256),
    (512, 2048, 64): (128, 64),
    (512, 2048, 128): (128, 128),
    (64, 2048, 512): (64, 128),
    (128, 2048, 512): (128, 128),
    (256, 2048, 512): (128, 256),
    (512, 64, 2048): (128, 64),
    (512, 128, 2048): (128, 64),
}


def mm_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The float32 product of bf16 a (m, k) and b (k, n), rounded to bf16,
    as ``_mm_kernel`` computes it."""
    return (a.float() @ b.float()).to(torch.bfloat16)


def tile(m: int, k: int, n: int) -> tuple[int, int]:
    """The block tile (BM, BN) of the kernel for a (m, k) times (k, n):
    ``TILES``' for the probe's shapes, else BM = 128 where m allows it and
    BN = 128 where n does (else 64).  Raises ValueError on a shape the
    kernel does not take."""
    if min(m, k, n) < 1 or m % BM or n % BN or k % BK:
        raise ValueError(f"mm: the kernel takes m, n and k multiples of "
                         f"{BM}, {BN} and {BK}; got ({m}, {k}, {n})")
    if (m, k, n) in TILES:
        return TILES[(m, k, n)]
    return (128 if m % 128 == 0 else 64, 128 if n % 128 == 0 else 64)


def mm(a: torch.Tensor, b: torch.Tensor, reps: int = 1,
       backend: str = "auto") -> torch.Tensor:
    """a b; the P1 kernel for CUDA tensors, the product computed ``reps``
    times (1 <= reps <= 65535) into the same output."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"mm: bad shapes a {tuple(a.shape)} b "
                         f"{tuple(b.shape)}")
    if not use_kernel(backend, a):
        return mm_plain(a, b)
    (m, k), n = a.shape, b.shape[1]
    if a.dtype != torch.bfloat16:
        raise TypeError(f"mm: the kernel takes bfloat16, got {a.dtype}")
    if not 1 <= reps <= 65535:
        raise ValueError(f"mm: the kernel takes 1 <= reps <= 65535, got "
                         f"{reps}")
    return _launch(a, b, reps, tile(m, k, n))


def _launch(a, b, reps, block_tile) -> torch.Tensor:
    """One launch of the kernel at ``block_tile`` (BM, BN)."""
    _build.check_cuda_inputs("mm", a, b)
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("mm: a and b must be 16-byte aligned")
    (m, k), n = a.shape, b.shape[1]
    out = a.new_empty((m, n))
    _build.launch("mhada_mm_probe", a.device, a, b, out, m, k, n, reps,
                  *block_tile)
    return out


def operands(m, k, n, device, seed=0):
    """The probe's seeded bf16 operands (scale 0.1, as mxu_probe.py)."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s) * 0.1).to(
        device, torch.bfloat16) for s in ((m, k), (k, n))]


def cublas_loop(a: torch.Tensor, b: torch.Tensor, reps: int):
    """A call that runs ``reps`` ``torch.matmul`` (cuBLAS) products of a and
    b.  On the card they are replayed from a CUDA graph, so that their time
    is the device's and not the host's rate of launches."""
    if a.device.type != "cuda":
        def loop():
            for _ in range(reps):
                torch.matmul(a, b)
        return loop
    out = a.new_empty((a.shape[0], b.shape[1]))
    side = torch.cuda.Stream(a.device)
    side.wait_stream(torch.cuda.current_stream(a.device))
    with torch.cuda.stream(side):   # cuBLAS's workspace, outside the graph
        torch.matmul(a, b, out=out)
    torch.cuda.current_stream(a.device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            torch.matmul(a, b, out=out)
    return graph.replay


def bench_shape(m, k, n, reps, iters, device) -> dict:
    """Time P1 and cuBLAS at one shape on ``device`` -> us per product,
    useful TFLOP/s of both, the max error against ``mm_plain``."""
    a, b = operands(m, k, n, device)
    err = (mm(a, b).float() - mm_plain(a, b).float()).abs().max().item()
    mm(a, b, reps)   # warm-up

    def kernel():
        for _ in range(iters):
            mm(a, b, reps)

    cublas = cublas_loop(a, b, reps)
    cublas()   # warm-up

    def library():
        for _ in range(iters):
            cublas()

    us = _elapsed_ms(device, kernel) * 1e3 / (iters * reps)
    lib_us = _elapsed_ms(device, library) * 1e3 / (iters * reps)
    flops = 2 * m * k * n
    return dict(m=m, k=k, n=n, us=us, tflops=flops / us / 1e6,
                library_us=lib_us, library_tflops=flops / lib_us / 1e6,
                max_abs_err=err)


def sweep(reps, iters, device) -> None:
    """Every block tile of BLOCK_TILES that divides each shape, timed in
    two rounds (in order, then reversed), one JSON line each."""
    for m, k, n in SHAPES:
        a, b = operands(m, k, n, device)
        ref = mm_plain(a, b).float()
        fits = [t for t in BLOCK_TILES if m % t[0] == 0 and n % t[1] == 0]
        rows = {}
        for t in fits:
            err = (_launch(a, b, 1, t).float() - ref).abs().max().item()
            rows[t] = dict(m=m, k=k, n=n, tile=list(t), taken=t == tile(
                m, k, n), max_abs_err=err, us=[])
        for order in (fits, fits[::-1]):
            for t in order:
                _launch(a, b, reps, t)   # warm-up

                def loop(t=t):
                    for _ in range(iters):
                        _launch(a, b, reps, t)
                rows[t]["us"].append(
                    _elapsed_ms(device, loop) * 1e3 / (iters * reps))
        for t in fits:
            print(json.dumps(rows[t]), flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=400)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--sweep", action="store_true",
                    help="time every block tile at each shape (card only)")
    ap.add_argument("--device", default="cuda",
                    help="the card unless 'cpu' (the plain product, host "
                         "clock)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if args.sweep:
        if device.type != "cuda":
            raise RuntimeError("mm_probe --sweep times the kernel: it needs "
                               "the card")
        print(f"# {torch.cuda.get_device_name(device)}", flush=True)
        sweep(args.reps, args.iters, device)
        return
    name = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu (plain product, host clock)"
    print(f"# {name}", flush=True)
    for m, k, n in SHAPES:
        r = bench_shape(m, k, n, args.reps, args.iters, device)
        print(f"({m:5d},{k:5d}) @ ({k:5d},{n:5d}) bfloat16 "
              f"{r['us']:8.2f} us/mm {r['tflops']:7.1f} TF/s  cuBLAS "
              f"{r['library_tflops']:7.1f} TF/s  max|err| "
              f"{r['max_abs_err']:.2e}", flush=True)


if __name__ == "__main__":
    main()
