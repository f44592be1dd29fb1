"""The bf16 decoder tail one piece at a time: builds of
csrc/decoder_tail_wgmma.cuh with one piece cut out or one choice changed,
timed beside the tail as built at K5's and K8's shapes.

    python -m mhada_tpu_torch.probes.tail_wgmma_ablate [--iters 20]
        [--variants ...]

Each variant is the header with the text edits of ``VARIANTS``, compiled
with the library's flags into a scratch library of decoder_tail.cu (in a
temporary directory, all variants at once) and launched through the same C
entry points (K5: mhada_decoder_tail, K8: mhada_decoder_tail_res) on
weights already in the kernels' layout.  The cuts skip their piece behind
a condition the compiler cannot fold (the batch is never negative), so
that what feeds it stays live:

- ``stage 1 alone`` / ``stage 2 alone``: one of the two launches;
- ``no c6 sums``: stage 2 without summing c6's taps from Z and the rgb
  stores (Z's products and stores stay);
- ``no stores``: no y1 or c5 store (stage 2 reads whatever y1 holds);
- ``no up build``: stage 2 without blending the up window (its products
  read whatever shared memory holds);
- ``no c5 products``: stage 2 without c5's products (its epilogue stores
  whatever the accumulators hold);
- ``no mirror``: stage 2 without copying the Z rows of c5's out-of-image
  ring from their mirrors;
- ``stage 2 of two warpgroups``: the block of stage 2 with two consumer
  warpgroups (three c5 tiles each) in place of three (two each);
- ``stage 1 of one warpgroup``: stage 1's block with one warpgroup and its
  x window in place of two;
- ``no y1 prefetch``: stage 2 loading a tile's y1 window when the tile
  starts, not under the previous tile's c5 products.

Prints the card's name and power limit, then one JSON line per variant:
ptxas' registers, spilled bytes and serialisation notes (C75xx) of the two
kernels, and per shape the ms of one entry call in two rounds (variants in
order, then reversed; CUDA events over ``--iters`` back-to-back calls), the
device ms of each stage (torch.profiler), the bound's share at the faster
round and max |variant - as built| / max |as built| of rgb.  The bound is
the tail's flops at the published bf16 peak.  Card only.
"""

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from .. import _build
from ..config import resolve_device
from ..infer.timing import _elapsed_ms
from .redesign_ab import card, device_ms

HEADER = "decoder_tail_wgmma.cuh"
SOURCE = "decoder_tail.cu"
K5, K8 = "mhada_decoder_tail", "mhada_decoder_tail_res"
STAGES = ("tail_up3_wgmma_kernel", "tail_c5c6_wgmma_kernel")
# (entry, batch, low-res height, width): K5 at the 512^2 and 1024^2
# frames, K8 at the 256^2 step (B = 8), the 512^2 step (B = 4) and the
# video step's frames (B = 2, 128 x 256) at the video CLI's batch (B = 8)
SHAPES = [(K5, 1, 256, 256), (K5, 1, 512, 512), (K8, 8, 128, 128),
          (K8, 4, 256, 256), (K5, 8, 128, 256)]
PEAK_BF16 = 989e12
_NEVER = "a.batch < 0"
# variant -> [(text in the header, its replacement)]
VARIANTS = {
    "as built": [],
    "stage 1 alone": [
        ("  if (err != cudaSuccess) return err;\n"
         "  const int grid2",
         "  if (err != cudaSuccess || a.batch > 0) return err;\n"
         "  const int grid2")],
    "stage 2 alone": [
        ("  err = launch_with_smem(tail_up3_wgmma_kernel,",
         "  if (a.batch < 0) err = launch_with_smem(tail_up3_wgmma_kernel,")],
    "no c6 sums": [
        ("    for (int px = tid; px < kTile * kTile; px += kThreads2) {",
         f"    for (int px = tid; {_NEVER} && px < kTile * kTile; "
         "px += kThreads2) {")],
    "no stores": [
        ("    if (gy >= hl) continue;",
         "    if (gy >= hl || a.batch > 0) continue;"),
        ("              q % kCW < 1 || q % kCW > kTile || gy >= hh || gx >= wh)",
         "              q % kCW < 1 || q % kCW > kTile || gy >= hh || gx >= wh"
         " ||\n              a.batch > 0)")],
    "no up build": [
        ("    for (int c = tid; c < kUW * kYW * 8; c += kThreads2) {",
         f"    for (int c = tid; {_NEVER} && c < kUW * kYW * 8; "
         "c += kThreads2) {"),
        ("    for (int c = tid; c < kUW * kUW * 8; c += kThreads2) {",
         f"    for (int c = tid; {_NEVER} && c < kUW * kUW * 8; "
         "c += kThreads2) {")],
    "no c5 products": [
        ("      float acc[32];\n      conv_units<9>(",
         f"      float acc[32];\n      if ({_NEVER}) conv_units<9>(")],
    "no mirror": [
        ("    if (rt == 0 || rb < kCW || cl == 0 || cr < kCW) {",
         f"    if ({_NEVER} && (rt == 0 || rb < kCW || cl == 0 || "
         "cr < kCW)) {")],
    # stage 2 with two warpgroups (three c5 tiles each) in place of three
    "stage 2 of two warpgroups": [
        ("constexpr int kConsumers2 = 3;", "constexpr int kConsumers2 = 2;")],
    # stage 1 with one warpgroup a block (one x window) in place of two
    "stage 1 of one warpgroup": [
        ("constexpr int kConsumers = 2; ", "constexpr int kConsumers = 1; ")],
    # stage 2 loading a tile's y1 window when the tile starts, not under
    # the previous tile's c5 products
    "no y1 prefetch": [
        ("    load_y1(t + gridDim.x);   // lands under the c5 products\n", ""),
        ("    mma::cp_async_wait<0>();\n    __syncthreads();   // the y1 window",
         "    if (t != static_cast<int>(blockIdx.x)) load_y1(t);\n"
         "    mma::cp_async_wait<0>();\n    __syncthreads();   // the y1 window")],
}


def patched(text: str, edits) -> str:
    """The header's text with ``edits`` applied; raises unless each old
    text is found exactly once."""
    for old, new in edits:
        if text.count(old) != 1:
            raise ValueError(f"variant edit not found once in {HEADER}: "
                             f"{old!r}")
        text = text.replace(old, new)
    return text


def ptxas_notes(log: str) -> dict:
    """Registers and spilled bytes of each tail wgmma kernel, and the codes
    of ptxas' performance notes, from the ``-Xptxas -v`` log."""
    notes = {"ptxas": sorted(set(re.findall(r"\((C75\d\d)\)", log)))}
    kernel = None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            m = re.search(r"(tail_\w+_wgmma_kernel(ILb[01]E)?)", ln)
            kernel = m[1] if m else None
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if kernel and m:
            notes.setdefault(kernel, {})["spill_bytes"] = int(m[1]) + int(m[2])
        m = re.search(r"Used (\d+) registers", ln)
        if kernel and m:
            notes.setdefault(kernel, {})["regs"] = int(m[1])
    return notes


def build_variants(names, workdir: Path) -> dict:
    """name -> ({entry: the variant's C entry point}, its ptxas notes)."""
    procs = {}
    for i, name in enumerate(names):
        src = workdir / f"v{i}"
        shutil.copytree(_build.CSRC, src)
        (src / HEADER).write_text(
            patched((src / HEADER).read_text(), VARIANTS[name]))
        lib = src / "variant.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib),
               str(src / SOURCE)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       lib)
    built = {}
    for name, (proc, lib) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log[-3000:]}")
        so = ctypes.CDLL(str(lib))
        entries = {}
        for entry in (K5, K8):
            fn = getattr(so, entry)
            fn.argtypes = _build.SIGNATURES[entry]
            fn.restype = ctypes.c_int
            entries[entry] = fn
        built[name] = (entries, ptxas_notes(log))
    return built


def tail_inputs(b, h, w, g, device):
    """x and the tail's weights at their init scale, in the kernels' layout
    (bf16 HWIO weights, float32 biases holding bf16 values), and the
    outputs -> (args before the sizes, rgb)."""
    bf = torch.bfloat16

    def conv(co, ci):
        bound = 1 / (ci * 9) ** 0.5
        wt = (torch.rand(co, ci, 3, 3, generator=g) * 2 - 1) * bound
        bias = (torch.rand(co, generator=g) * 2 - 1) * bound
        return (wt.to(device, bf).permute(2, 3, 1, 0).contiguous(),
                bias.to(device, bf).float())

    x = torch.rand(b, h, w, 128, generator=g).to(device, bf)
    (wu, bu), (w5, b5), (w6, b6) = conv(64, 128), conv(64, 64), conv(3, 64)
    rgb = torch.empty(b, 2 * h, 2 * w, 3, device=device, dtype=bf)
    y1 = torch.empty(b, h, w, 64, device=device, dtype=bf)
    c5 = torch.empty(b, 2 * h, 2 * w, 64, device=device, dtype=bf)
    return [x, wu, bu, w5, b5, w6, b6, rgb, y1, c5], rgb


def flops(b, h, w) -> int:
    lo, hi = b * h * w, 4 * b * h * w
    return 2 * 9 * (lo * 128 * 64 + hi * 64 * 64 + hi * 64 * 3)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--variants", nargs="*", default=list(VARIANTS),
                    choices=list(VARIANTS))
    args = ap.parse_args(argv)
    device = resolve_device("cuda")
    print(f"# {card()}; bfloat16", flush=True)
    g = torch.Generator().manual_seed(0)
    data = [(entry, b, h, w, *tail_inputs(b, h, w, g, device))
            for entry, b, h, w in SHAPES]
    code = _build.DTYPE_CODES[torch.bfloat16]
    with tempfile.TemporaryDirectory() as tmp, torch.inference_mode():
        built = build_variants(args.variants, Path(tmp))

        def run(fn, entry, b, h, w, tensors):
            stream = torch.cuda.current_stream(device).cuda_stream
            ptrs = [t.data_ptr() for t in tensors]
            if entry == K5:
                ptrs = ptrs[:9]   # y1 is K5's scratch; no c5
            err = fn(*ptrs, b, h, w, code, stream)
            if err:
                raise RuntimeError(f"{entry} failed: CUDA error {err}")

        def ms(call):
            call()

            def loop():
                for _ in range(args.iters):
                    call()
            return _elapsed_ms(device, loop) / args.iters

        rows = {name: {"variant": name, **notes, "shapes": {}}
                for name, (_, notes) in built.items()}
        first = next(iter(built))
        for entry, b, h, w, tensors, rgb in data:
            key = f"{'K5' if entry == K5 else 'K8'} {h}x{w} B={b}"
            fns = {name: fns[entry] for name, (fns, _) in built.items()}
            run(fns[first], entry, b, h, w, tensors)
            ref = rgb.float().clone()
            for name, fn in fns.items():
                run(fn, entry, b, h, w, tensors)
                call = lambda fn=fn: run(fn, entry, b, h, w, tensors)
                rows[name]["shapes"][key] = {
                    "rel_err_vs_first": ((rgb.float() - ref).abs().max()
                                         / ref.abs().max()).item(),
                    "stage_ms": {s: device_ms(call, only=s) for s in STAGES},
                    "ms": []}
            for order in (list(fns), list(fns)[::-1]):
                for name in order:
                    rows[name]["shapes"][key]["ms"].append(ms(
                        lambda: run(fns[name], entry, b, h, w, tensors)))
            bound = flops(b, h, w) / PEAK_BF16 * 1e3
            for name in fns:
                rec = rows[name]["shapes"][key]
                rec["bound_ms"] = bound
                rec["bound_share"] = bound / min(rec["ms"])
    for row in rows.values():
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
