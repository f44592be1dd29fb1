"""P2: K3's function as the repo's probe of the MHAda tile
(csrc/mhada_prologue_pipe.cu), timed against K3.

Counterpart of scripts/mhada_pipe_probe.py, which A/B-tested a
software-pipelined variant of the fused-prologue MHAda kernel
(``_pipe_kernel``) against the one in use.  The function is K3's, so its
plain version is ``ops.mhada_prologue.mhada_fused_prologue_plain``.  At
bfloat16 P2 is the warp-specialised wgmma + TMA tile (csrc/mhada_wgmma.cuh)
never split over the keys, which K3 also runs (split where its grid leaves
SMs idle; at this shape K3 takes one split, so the two are one kernel); at
float32 it is K3's float32 tile (csrc/mhada_f32_tile.cuh) with a one-stage
ring, each key tile waited for before it is computed, so the pair times
what K3's second stage buys.

    python -m mhada_tpu_torch.probes.mhada_pipe_probe [--iters 30]

runs the JAX probe's shape (B = 8, N = M = 4096, C = 512, 8 heads of 64,
bfloat16) with the inputs of K3's gate (keys at scale 0.35, so the
unscaled logits stay near std 1.6 and elementwise errors mean something)
and prints K3's and P2's ms per dispatch and per frame, interleaved (K3,
pipe, pipe, K3), each with its share of the card's bound (the published
H100 SXM peaks of ``BOUND_PEAKS``), its TFLOP/s and its max error against
the plain version.
"""

import argparse

import torch

from .. import _build
from ..config import resolve_device, use_kernel
from ..infer.image import DTYPES
from ..infer.timing import _elapsed_ms
from ..ops.instance_norm import instance_norm_stats
from ..ops.mhada_prologue import (launch_prologue, mhada_fused_prologue,
                                  mhada_fused_prologue_plain)

SHAPE = dict(b=8, n=4096, m=4096, c=512, heads=8)   # mhada_pipe_probe.py:146
# Published dense peaks of one H100 SXM at 700 W: FLOP/s by dtype (bf16 on
# the tensor cores, float32 on the CUDA cores) and HBM bytes/s.
BOUND_PEAKS = {"bfloat16": 989e12, "float32": 67e12, "bytes": 3.35e12}


def work(b, n, m, c, heads, dtype):
    """(flops, bytes) of one call: the products 6 N M d per head and the
    projection 2 N d^2; fc, fcs, k, v and out once, the stats, Wf and fb."""
    es = torch.tensor([], dtype=dtype).element_size()
    d = c // heads
    flops = b * (6 * n * m * c + 2 * n * c * d)
    nbytes = b * (3 * n + 2 * m) * c * es + b * 4 * c * 4 + heads * d * (
        d * es + 4)
    return flops, nbytes


def bound_ms(flops, nbytes, dtype_name):
    """The least ms the card could take for this work."""
    return 1e3 * max(flops / BOUND_PEAKS[dtype_name],
                     nbytes / BOUND_PEAKS["bytes"])


def mhada_fused_prologue_pipe(fc, fcs, stats, wf, fb, k, v,
                              backend: str = "auto") -> torch.Tensor:
    """K3's function; the P2 kernel for CUDA tensors (arguments as
    ``ops.mhada_prologue.mhada_fused_prologue``)."""
    if not use_kernel(backend, fc):
        return mhada_fused_prologue_plain(fc, fcs, stats, wf, fb, k, v)
    _build.check_forward_only("mhada_fused_prologue_pipe", "it is a probe",
                              fc, fcs, stats, wf, fb, k, v)
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("mhada_fused_prologue_pipe: k and v must be 16-byte "
                         "aligned")
    return launch_prologue("mhada_mhada_prologue_pipe", fc, fcs, stats, wf,
                           fb, k, v, splits=1)[0]


def probe_inputs(b, n, m, c, heads, dtype, device, seed=0):
    """Seeded inputs of K3's gate: fc, fcs (B, N, C) raw tokens, their
    float32 stats, wf and fb from the block's init U(-1/8, 1/8), k at
    scale 0.35 and v (B, M, C)."""
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, scale=1.0, shift=0.0):
        return (torch.randn(*shape, generator=g) * scale + shift).to(
            device, dtype)

    fc, fcs = rnd(b, n, c, scale=2.0, shift=1.0), rnd(b, n, c, scale=3.0,
                                                      shift=-1.0)
    stats = torch.stack([*instance_norm_stats(fc), *instance_norm_stats(fcs)],
                        1)
    d = c // heads
    wf = ((torch.rand(heads, d, d, generator=g) * 2 - 1) / 8).to(device)
    fb = ((torch.rand(heads, d, generator=g) * 2 - 1) / 8).to(device)
    return fc, fcs, stats, wf, fb, rnd(b, m, c, scale=0.35), rnd(b, m, c)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--dtype", default="bfloat16", choices=sorted(DTYPES))
    ap.add_argument("--device", default="cuda",
                    help="the card unless 'cpu' (the plain version only, "
                         "host clock)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    inputs = probe_inputs(**SHAPE, dtype=DTYPES[args.dtype], device=device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu (plain version, host clock)"
    b, n, c = SHAPE["b"], SHAPE["n"], SHAPE["c"]
    flops, nbytes = work(**SHAPE, dtype=DTYPES[args.dtype])
    bound = bound_ms(flops, nbytes, args.dtype)
    print(f"# {name}; B={b} N=M={n} C={c} {args.dtype}; bound {bound:.3f} "
          f"ms ({flops / 1e9:.1f} GFLOP)", flush=True)
    with torch.inference_mode():
        ref = mhada_fused_prologue_plain(*inputs).float()
        runs = {"K3": lambda: mhada_fused_prologue(*inputs),
                "pipe": lambda: mhada_fused_prologue_pipe(*inputs)}
        for label in ("K3", "pipe", "pipe", "K3"):
            fn = runs[label]
            err = (fn().float() - ref).abs().max().item()

            def loop():
                for _ in range(args.iters):
                    fn()

            ms = _elapsed_ms(device, loop) / args.iters
            print(f"{label:5s}: {ms:8.3f} ms/dispatch ({ms / b:7.4f} "
                  f"ms/frame) {100 * bound / ms:5.1f} % of the bound "
                  f"{flops / ms / 1e9:7.1f} TF/s  max|err| against plain "
                  f"{err:.2e}", flush=True)


if __name__ == "__main__":
    main()
