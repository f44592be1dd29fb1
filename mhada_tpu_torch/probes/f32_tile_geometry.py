"""The f32 attention forward's block layout, measured: builds of K1's
float32 kernel (csrc/mhada_f32_tile.cuh, ``attention_f32_kernel``) with
each candidate ``AttnGeom``, timed against each other at the paths' shapes
(K1 at B = 1, L = 4096; K6's forward at B = 8, L = 1024; K9 at L = 16384),
C = 512, 8 heads, float32.

    python -m mhada_tpu_torch.probes.f32_tile_geometry [--iters 20]

Each variant is the header with its ``AttnGeom`` line replaced, compiled
with the library's flags into a scratch library of attention_fwd.cu alone
(in a temporary directory, all variants at once) and launched through the
same C entry point.  Without V^2 the P V product of the MHAda tile's 8 x 4
layout takes 3 LDS.128 per 32 FFMA, so each candidate gives a thread more
outputs per load: 256 queries with 16 x 4 a thread, 128 queries with 128
threads and 8 x 8, 256 queries with 256 threads and 8 x 8.  Prints the
card's name, then one JSON line per variant: queries a block, threads,
shared bytes, blocks and waves of 132 SMs at each shape, ptxas's registers
and spilled bytes, max |variant - plain| / max |plain| at the first shape,
and ms at each shape in two rounds (in order, then reversed).  Card only.
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
from ..ops.attention_kernel import attention_plain

HEADER = "mhada_f32_tile.cuh"
SOURCE = "attention_fwd.cu"
ENTRY = "mhada_attention_fwd"
AS_BUILT = "using AttnGeom = Geom<2, 8, 256>;"
# variant -> Geom<groups of 4 rows, keys a thread, threads>
VARIANTS = {
    "256 queries, 8 x 8 (as built)": "Geom<2, 8, 256>",
    "256 queries, 16 x 4": "Geom<4, 4, 256>",
    "128 queries, 128 threads, 8 x 8": "Geom<2, 8, 128>",
    "128 queries, 8 x 4 (the MHAda tile's)": "Geom<2, 4, 256>",
}
# (batch, tokens) of K1, K6's forward and K9
SHAPES = [(1, 4096), (8, 1024), (1, 16384)]
C, HEADS, SMS = 512, 8, 132


def patched(text: str, geom: str) -> str:
    """The header's text with AttnGeom set to ``geom``; raises if the line
    is missing."""
    if AS_BUILT not in text:
        raise ValueError(f"AttnGeom line not found in {HEADER}: {AS_BUILT!r}")
    return text.replace(AS_BUILT, f"using AttnGeom = {geom};")


def layout(geom: str) -> dict:
    """Queries a block, threads and shared bytes of ``geom``, as the header
    computes them (two ring stages)."""
    g, j, threads = map(int, re.findall(r"\d+", geom))
    bq = 4 * (threads // (64 // j)) * g
    smem = 4 * (64 * bq + 64 * (bq + 4) + 2 * 64 * (68 + 64))
    return {"queries": bq, "threads": threads, "smem_bytes": smem,
            "blocks": [-(-n // bq) * HEADS * b for b, n in SHAPES],
            "waves": [round(-(-n // bq) * HEADS * b / SMS, 2)
                      for b, n in SHAPES]}


def ptxas_notes(log: str) -> dict:
    """The attention kernel's registers and spilled bytes from an
    ``-Xptxas -v`` log."""
    notes, kernel = {}, False
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            kernel = "attention_f32_kernel" in ln
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if kernel and m:
            notes["spill_bytes"] = int(m[1]) + int(m[2])
        m = re.search(r"Used (\d+) registers", ln)
        if kernel and m:
            notes["regs"] = int(m[1])
    return notes


def build_variants(names, workdir: Path) -> dict:
    """name -> (the variant's C entry point, its ptxas notes)."""
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
        fn = getattr(ctypes.CDLL(str(lib)), ENTRY)
        fn.argtypes = _build.SIGNATURES[ENTRY]
        fn.restype = ctypes.c_int
        built[name] = (fn, ptxas_notes(log))
    return built


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--variants", nargs="*", default=list(VARIANTS),
                    choices=list(VARIANTS))
    args = ap.parse_args(argv)
    device = resolve_device("cuda")
    g = torch.Generator().manual_seed(0)
    inputs = [torch.randn(b, n, 3 * C, generator=g).to(device)
              for b, n in SHAPES]
    outs = [torch.empty(b, n, C, device=device) for b, n in SHAPES]
    print(f"# {torch.cuda.get_device_name(device)}; C={C}, {HEADS} heads, "
          f"float32; shapes (B, L) {SHAPES}", flush=True)
    with tempfile.TemporaryDirectory() as tmp, torch.inference_mode():
        built = build_variants(args.variants, Path(tmp))

        def run(fn, s):
            (b, n), qkv, out = SHAPES[s], inputs[s], outs[s]
            stream = torch.cuda.current_stream(device).cuda_stream
            err = fn(qkv.data_ptr(), out.data_ptr(), None, b, n, C, HEADS, 1,
                     0.125, _build.DTYPE_CODES[torch.float32], stream)
            if err:
                raise RuntimeError(f"{ENTRY} failed: CUDA error {err}")

        def ms(fn, s):
            run(fn, s)
            iters = max(2, args.iters * SHAPES[0][1] ** 2
                        // (SHAPES[s][0] * SHAPES[s][1] ** 2))

            def loop():
                for _ in range(iters):
                    run(fn, s)
            return _elapsed_ms(device, loop) / iters

        ref = attention_plain(inputs[0], HEADS, 0.125)
        rows = {}
        for name, (fn, notes) in built.items():
            run(fn, 0)
            rows[name] = {"variant": name, **layout(VARIANTS[name]), **notes,
                          "rel_err_vs_plain": ((outs[0] - ref).abs().max()
                                               / ref.abs().max()).item(),
                          "shapes": SHAPES, "ms": []}
        for order in (list(built), list(built)[::-1]):
            for name in order:
                rows[name]["ms"].append(
                    [ms(built[name][0], s) for s in range(len(SHAPES))])
    for row in rows.values():
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
