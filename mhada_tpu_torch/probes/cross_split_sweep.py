"""The attention tile at every split count, measured: K1's cross form
(``attention_cross`` with each forced ``splits`` of 1 .. MAX_SPLITS) at the
sequence-parallel gate shapes (B = 1, 8 heads of 64: 1024 and 2048 queries
against 4096 keys, 4096 against 16384) and at the self shape 4096 x 4096,
float32 and bfloat16, beside ``cross_splits``' pick; and the self form of
K1 and K6's forward (K1's launch with each forced count, the same bf16
tile on the packed qkv) at their gate shapes (``SELF_SHAPES``), bfloat16,
beside ``self_splits``' pick at the shape's batch (K6's forward) and at
one sequence (K1's, at every batch).

    python -m mhada_tpu_torch.probes.cross_split_sweep [--iters 20]
        [--forms cross self]

The queries are the first C columns of a packed (B, N, 3C) qkv and the keys
and values a (B, M, 2C) tensor, as under SP.  Each count is timed two ways
in two rounds (counts in order, then reversed): wall ms with CUDA events
over ``--iters`` back-to-back calls (the wrapper's host work included,
which paces the calls below ~0.06 ms), and device ms, the sum of the
call's kernels (the tile, the combine) from ``torch.profiler``, from a
window that recorded every launch (``redesign_ab.device_ms``).  Prints
the card's name and power limit, then one JSON line per shape and dtype:
both times of each count in each round, the count fastest on the device,
the chooser's pick and its device ms, and the pick's max |kernel - plain| /
max |plain|.  Card only.
"""

import argparse
import json

import torch

from ..config import resolve_device
from ..infer.timing import _elapsed_ms
from ..ops.attention_kernel import (KEY_TILE, MAX_SPLITS, _tm_launch,
                                    attention_cross, attention_cross_plain,
                                    attention_plain, cross_splits,
                                    self_splits)
from .redesign_ab import card, device_ms

SHAPES = [(1024, 4096), (2048, 4096), (4096, 16384), (4096, 4096)]
C, HEADS = 512, 8
# (batch, tokens, heads) of K1's and K6's forward's gates: K1 at B = 1, L =
# 4096, 16384 and 3600 (the Sintel frame), and at B = 8, 4096 (the 512^2
# streaming batch) and 8, 1024 (the video CLI's --chunk 8 at 256^2), where
# it takes one sequence's count; K6 at the training steps' B = 8, 1024, B
# = 4, 4096, B = 2, 2048, at B = 1, 1024 (the inversion), and at one
# rank's share of the 2-way tensor-parallel split (4 heads)
SELF_SHAPES = [(1, 4096, 8), (1, 16384, 8), (1, 3600, 8), (8, 4096, 8),
               (8, 1024, 8), (4, 4096, 8), (2, 2048, 8), (1, 1024, 8),
               (4, 1024, 4), (1, 2048, 4)]


def sweep(device, counts, call, iters):
    """Wall and device ms of ``call(s)`` at each count, in two rounds
    (in order, then reversed) -> (walls, devs, the count fastest on the
    device)."""
    def wall(s):
        call(s)()

        def loop():
            for _ in range(iters):
                call(s)()
        return _elapsed_ms(device, loop) / iters

    order = [list(counts), list(reversed(counts))]
    walls = [{s: wall(s) for s in o} for o in order]
    devs = [{s: device_ms(call(s), iters) for s in o} for o in order]
    best = {s: min((r[s] for r in devs if r[s] == r[s]),
                   default=float("inf")) for s in counts}
    return walls, devs, best


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--forms", nargs="+", default=["cross", "self"],
                    choices=["cross", "self"])
    args = ap.parse_args(argv)
    device = resolve_device("cuda")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    print(f"# {card()}; {sms} SMs; C={C}, {HEADS} heads, B=1", flush=True)
    g = torch.Generator().manual_seed(0)
    with torch.inference_mode():
        for n, m in SHAPES if "cross" in args.forms else ():
            for dtype in (torch.float32, torch.bfloat16):
                qkv = torch.randn(1, n, 3 * C, generator=g).to(device, dtype)
                kv = torch.randn(1, m, 2 * C, generator=g).to(device, dtype)
                q = qkv[..., :C]
                counts = range(1, min(MAX_SPLITS, -(-m // KEY_TILE)) + 1)

                def call(s):
                    return lambda: attention_cross(q, kv, HEADS, splits=s)

                walls, devs, best = sweep(device, counts, call, args.iters)
                pick = cross_splits(1, HEADS, n, m, dtype, sms)
                ref = attention_cross_plain(q, kv, HEADS).float()
                got = attention_cross(q, kv, HEADS).float()
                rel = ((got - ref).abs().max() / ref.abs().max()).item()
                print(json.dumps({
                    "shape": [n, m], "dtype": str(dtype)[6:],
                    "counts": list(counts),
                    "wall_ms": [[r[s] for s in counts] for r in walls],
                    "device_ms": [[r[s] for s in counts] for r in devs],
                    "fastest": min(best, key=best.get), "pick": pick,
                    "pick_device_ms": best[pick], "pick_rel_err": rel}),
                    flush=True)
                del qkv, kv, q, ref, got
                torch.cuda.empty_cache()
        for b, l, heads in SELF_SHAPES if "self" in args.forms else ():
            qkv = torch.randn(b, l, 3 * C // 8 * heads, generator=g).to(
                device, torch.bfloat16)
            counts = range(1, min(MAX_SPLITS, -(-l // KEY_TILE)) + 1)

            def call(s):
                return lambda: _tm_launch(qkv, heads, splits=s)

            walls, devs, best = sweep(device, counts, call, args.iters)
            pick = self_splits(b, heads, l, torch.bfloat16, sms)
            k1_pick = self_splits(1, heads, l, torch.bfloat16, sms)
            ref = attention_plain(qkv, heads).float()
            got = _tm_launch(qkv, heads, splits=pick).float()
            rel = ((got - ref).abs().max() / ref.abs().max()).item()
            print(json.dumps({
                "self": [b, l, heads], "dtype": "bfloat16",
                "counts": list(counts),
                "wall_ms": [[r[s] for s in counts] for r in walls],
                "device_ms": [[r[s] for s in counts] for r in devs],
                "fastest": min(best, key=best.get), "pick": pick,
                "pick_device_ms": best[pick], "pick_rel_err": rel,
                "k1_pick": k1_pick, "k1_pick_device_ms": best[k1_pick]}),
                flush=True)
            del qkv, ref, got
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
