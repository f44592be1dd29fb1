"""P1, K14, K13 and the float32 tail against another checkout's builds of
them, on one card, in turns: the time a redesign saves, measured in one
call.

    python -m mhada_tpu_torch.probes.redesign_ab --other DIR [--rounds 2]

DIR is the root of another checkout of the repository (for example the
parent commit, unpacked with ``git archive``).  Each side runs in a process
of its own with its own checkout first on ``sys.path``, so each builds and
launches its own kernels from its own ``csrc/``, and times, with CUDA
events:

- P1 (``probes.mm_probe.mm``, 100 products a launch, as ``chip_smoke.py``'s
  P1 gates) at the probe's 8 shapes, bfloat16;
- K14's three launches on weights already in the kernel's layout
  (``ops.decoder_mid._kernel``, ``chip_smoke.py``'s "kernel alone") at its
  gate shapes (128^2 with B = 1 and 8, 256^2; C = 256), float32 and
  bfloat16;
- K13's launch on weights already in the kernel's layout (the C entry
  ``mhada_decoder_c6``, whose arguments no redesign changed) at its gate
  shapes (512^2 with B = 1 and 8, 1024^2, 256 x 512 with B = 8, 264 x
  488), float32 and bfloat16;
- the float32 decoder tail, whose direct conv K14's float32 build shares:
  K5 from 256^2 to 512^2 (B = 1) and K8's forward from 128^2 to 256^2 (B =
  8), ``chip_smoke.py``'s K5 and K8 gate shapes.

The sides run as other, this, this, other, repeated ``--rounds`` / 2
times.  Prints the card's name and power limit, then one JSON line per
measurement with each side's ms in the order run.  Card only.

This file imports nothing of the package at its top, so that a worker can
put the other checkout's package first on ``sys.path``.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
MM_REPS = 100
# (side, batch) of K14's gates in chip_smoke.py
MID_SHAPES = [(128, 1), (128, 8), (256, 1)]
MID_C = 256
# (height, width, batch) of K13's gates in chip_smoke.py
C6_SHAPES = [(512, 512, 1), (512, 512, 8), (1024, 1024, 1), (256, 512, 8),
             (264, 488, 1)]


def _cuda_ms(fn, warmup=3, iters=10):
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def worker(root: str) -> dict:
    """Times of the checkout at ``root``: key -> ms."""
    sys.path.insert(0, root)
    import torch

    from mhada_tpu_torch import _build
    from mhada_tpu_torch.ops import decoder_mid, decoder_tail
    from mhada_tpu_torch.probes import mm_probe

    if not Path(mm_probe.__file__).resolve().is_relative_to(Path(root)):
        raise RuntimeError(f"imported {mm_probe.__file__}, not {root}'s")
    if not torch.cuda.is_available():
        raise RuntimeError("redesign_ab times the kernels: it needs the card")
    out = {}
    with torch.inference_mode():
        for m, k, n in mm_probe.SHAPES:
            a, b = mm_probe.operands(m, k, n, "cuda")
            out[f"P1 {m}x{k}x{n}"] = _cuda_ms(
                lambda: mm_probe.mm(a, b, MM_REPS))
        g = torch.Generator().manual_seed(0)
        for dtype in (torch.float32, torch.bfloat16):
            bound = 1 / (MID_C * 9) ** 0.5
            ws = [(torch.rand(MID_C, MID_C, 3, 3, generator=g) * 2 - 1)
                  * bound for _ in range(3)]
            bs = [(torch.rand(MID_C, generator=g) * 2 - 1) * bound
                  for _ in range(3)]
            hwio, bias = decoder_mid.kernel_params(
                [w.cuda() for w in ws], [b.cuda() for b in bs], dtype)
            for side, batch in MID_SHAPES:
                x = torch.rand(batch, side, side, MID_C, generator=g).to(
                    "cuda", dtype)
                out[f"K14 {side}^2 B={batch} {str(dtype)[6:]}"] = _cuda_ms(
                    lambda: decoder_mid._kernel(x, hwio, bias))
                del x
            torch.cuda.empty_cache()
        for dtype in (torch.float32, torch.bfloat16):
            w6 = ((torch.rand(3, 64, 3, 3, generator=g) * 2 - 1) / 24).cuda()
            hwio = w6.to(dtype).permute(2, 3, 1, 0).contiguous()
            bias = ((torch.rand(3, generator=g) * 2 - 1) / 24).cuda()
            code = _build.dtype_code(hwio)
            for h, w, batch in C6_SHAPES:
                y = torch.rand(batch, h, w, 64, generator=g).to("cuda", dtype)
                o = y.new_empty((batch, h, w, 3))
                out[f"K13 {h}x{w} B={batch} {str(dtype)[6:]}"] = _cuda_ms(
                    lambda: _build.launch("mhada_decoder_c6", y.device, y,
                                          hwio, bias, o, batch, h, w, code))
                del y, o
            torch.cuda.empty_cache()
        for name, fn, batch, side in (
                ("K5", decoder_tail.decoder_tail, 1, 256),
                ("K8", decoder_tail.decoder_tail_train, 8, 128)):
            x = torch.rand(batch, side, side, 128, generator=g).cuda()
            tail_w = [((torch.rand(shape, generator=g) * 2 - 1) / 24).cuda()
                      for shape in ((64, 128, 3, 3), (64,), (64, 64, 3, 3),
                                    (64,), (3, 64, 3, 3), (3,))]
            out[f"{name} {side}^2 B={batch} float32"] = _cuda_ms(
                lambda: fn(x, *tail_w))
    return out


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", help="root of the other checkout")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        print(json.dumps(worker(args.worker)), flush=True)
        return
    if not args.other:
        ap.error("--other DIR is required")
    sides = {"other": str(Path(args.other).resolve()), "this": str(ROOT)}
    order = ["other", "this", "this", "other"] * max(1, args.rounds // 2)
    print(f"# {card()}; other = {sides['other']}, this = {sides['this']}",
          flush=True)
    runs = {"other": [], "this": []}
    for side in order:
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--worker",
             sides[side]], capture_output=True, text=True, cwd=sides[side])
        if proc.returncode:
            raise RuntimeError(f"{side} worker failed:\n{proc.stderr[-3000:]}")
        runs[side].append(json.loads(proc.stdout.strip().splitlines()[-1]))
    for key in runs["this"][0]:
        print(json.dumps({"gate": key,
                          "other_ms": [r[key] for r in runs["other"]],
                          "this_ms": [r[key] for r in runs["this"]]}),
              flush=True)


if __name__ == "__main__":
    main()
