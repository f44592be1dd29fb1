"""K3 and K4 at bfloat16 at every split count, measured: the MHAda tile
(csrc/mhada_wgmma.cuh) launched at each count of 1 .. MAX_SPLITS at
chip_smoke.py's gate shapes of K3 and K4, beside ``mhada_splits``' pick.

    python -m mhada_tpu_torch.probes.mhada_split_sweep [--iters 20]

K3's inputs are P2's probe inputs (``mhada_pipe_probe.probe_inputs``: raw
fc and fcs, their float32 stats, Wf and fb from the block's init, keys at
scale 0.35); K4's q and k at scale 0.35, v and fcs_n N(0, 1); 8 heads of 64.
Each count is timed two ways in two rounds (counts in order, then
reversed): wall ms with CUDA events over ``--iters`` back-to-back calls
(the wrapper's host work included, which paces K3's calls below ~0.11 ms
and K4's below ~0.05), and device ms, the sum of the call's MHAda kernels
(the tile, the combine; not K3's per-call casts of fb) from
``torch.profiler``, from a window that recorded every launch
(``redesign_ab.device_ms``).  Prints the card's name and power
limit, then one JSON line per kernel and shape: both times of each count
in each round, the count fastest on the device, the chooser's pick and its
device ms, and the pick's max |kernel - plain| / max |plain|.  Card only.
"""

import argparse
import json

import torch

from ..config import resolve_device
from ..infer.timing import _elapsed_ms
from ..ops.key_split import KEY_TILE, MAX_SPLITS
from ..ops.mhada_kernel import _mhada_launch, mhada_splits, mhada_tm_plain
from ..ops.mhada_prologue import launch_prologue, mhada_fused_prologue_plain
from .mhada_pipe_probe import probe_inputs
from .redesign_ab import card, device_ms

# (kernel, batch, queries, keys): chip_smoke.py's K3 and K4 gates (512^2
# and 1024^2 frames, an SP rank's 1024 queries, the video CLI's frame at B
# = 1 and 8, the Sintel eval's 3600 queries, P2's B = 8)
SHAPES = [("K3", 1, 4096, 4096), ("K4", 1, 4096, 4096),
          ("K3", 1, 16384, 16384), ("K4", 1, 16384, 16384),
          ("K3", 1, 1024, 4096), ("K3", 1, 2048, 1024),
          ("K3", 8, 2048, 1024), ("K4", 1, 3600, 1024),
          ("K4", 1, 2048, 1024), ("K3", 8, 4096, 4096)]
C, HEADS = 512, 8


def inputs(kind, b, n, m, device, seed=0):
    """(call(splits or None), plain call) on seeded inputs."""
    if kind == "K3":
        x = probe_inputs(b, n, m, C, HEADS, torch.bfloat16, device, seed)
        return (lambda s: launch_prologue("mhada_mhada_prologue", *x, s)[0],
                lambda: mhada_fused_prologue_plain(*x))
    g = torch.Generator().manual_seed(seed)
    q, k = (0.35 * torch.randn(b, t, C, generator=g) for t in (n, m))
    v, f = torch.randn(b, m, C, generator=g), torch.randn(b, n, C,
                                                          generator=g)
    q, k, v, f = (t.to(device, torch.bfloat16) for t in (q, k, v, f))
    return (lambda s: _mhada_launch(q, k, v, f, HEADS, s)[0],
            lambda: mhada_tm_plain(q, k, v, f, HEADS))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    device = resolve_device("cuda")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    print(f"# {card()}; {sms} SMs; C={C}, {HEADS} heads, bfloat16",
          flush=True)
    with torch.inference_mode():
        for kind, b, n, m in SHAPES:
            call, plain = inputs(kind, b, n, m, device)
            counts = range(1, min(MAX_SPLITS, -(-m // KEY_TILE)) + 1)

            def wall(s):
                call(s)

                def loop():
                    for _ in range(args.iters):
                        call(s)
                return _elapsed_ms(device, loop) / args.iters

            order = [list(counts), list(reversed(counts))]
            walls = [{s: wall(s) for s in o} for o in order]
            devs = [{s: device_ms(lambda s=s: call(s), args.iters,
                                  only="mhada") for s in o} for o in order]
            best = {s: min((r[s] for r in devs if r[s] == r[s]),
                           default=float("inf")) for s in counts}
            pick = mhada_splits(b, HEADS, n, m, sms)
            ref = plain().float()
            rel = ((call(None).float() - ref).abs().max()
                   / ref.abs().max()).item()
            print(json.dumps({
                "kernel": kind, "shape": [b, n, m], "counts": list(counts),
                "wall_ms": [[r[s] for s in counts] for r in walls],
                "device_ms": [[r[s] for s in counts] for r in devs],
                "fastest": min(best, key=best.get), "pick": pick,
                "pick_device_ms": best[pick], "pick_rel_err": rel}),
                flush=True)
            del call, plain, ref
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
