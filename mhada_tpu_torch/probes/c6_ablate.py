"""K13's design one piece at a time: builds of csrc/decoder_c6.cu with one
piece of its float32 or bf16 kernel cut out or changed, timed beside the
kernels as built at chip_smoke.py's K13 gate shapes, float32 and bf16.

    python -m mhada_tpu_torch.probes.c6_ablate [--iters 20]

Each variant is the sources with the text edits of ``VARIANTS`` (file ->
[(text, replacement)]), compiled with the library's flags into a scratch
library of decoder_c6.cu alone (in a temporary directory, all variants at
once) and launched through the same C entry point on weights already in
the kernel's layout.  "copies only" keeps every copy and barrier and cuts
the arithmetic; "arithmetic only" keeps the arithmetic and the barriers
and cuts the copies (the rows hold whatever the ring held): they split a
build's time between its memory pipeline and its compute.  A cut variant
computes something else, so outputs are not checked.  Prints the card's
name, then one JSON line per variant, dtype and shape: ms in two rounds (in
order, then reversed), the share of the bytes bound, and ptxas's registers
and spilled bytes.  Card only.
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

SOURCE = "decoder_c6.cu"
ENTRY = "mhada_decoder_c6"
RING, F32, MMA = "c6_ring.cuh", "decoder_c6_f32.cuh", "decoder_c6_mma.cuh"
# (height, width, batch) of chip_smoke.py's K13 gates
SHAPES = [(512, 512, 1), (512, 512, 8), (1024, 1024, 1), (256, 512, 8),
          (264, 488, 1)]
KERNELS = ("decoder_c6_f32_kernel", "decoder_c6_mma_kernel")
# variant -> {file: [(text, its replacement)]}
VARIANTS = {
    "as built": {},
    "copies only": {
        F32: [("for (int j = 0; j < kRun + 2; ++j) {",
               "for (int j = 0; j < 0; ++j) {")],
        MMA: [("for (int kx = 0; kx < 3; ++kx)",
               "for (int kx = 0; kx < 0; ++kx)")]},
    "arithmetic only": {
        # the slot's barrier completes on the issuing thread's arrival alone
        RING: [("    wg::mbar_expect_tx(b, (hi - lo + left + right) * "
                "kPixBytes);\n",
                "    wg::mbar_arrive(b);\n    return;\n")],
        MMA: [("for (int i = tid; i < kWinC * 8; i += kThreads) {",
               "for (int i = tid; i < 0; i += kThreads) {")]},
    # strips of 32 rows: half the halo rows and the prologues, half the
    # blocks
    "strip 32": {
        RING: [("constexpr int kStrip = 16;", "constexpr int kStrip = 32;")]},
}


def patched(text: str, edits, name: str) -> str:
    """``text`` with ``edits`` applied; raises if one is missing."""
    for old, new in edits:
        if old not in text:
            raise ValueError(f"variant edit not found in {name}: {old!r}")
        text = text.replace(old, new)
    return text


def ptxas_notes(log: str) -> dict:
    """Each kernel's registers and spilled bytes from an ``-Xptxas -v``
    log."""
    notes, kernel = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            kernel = next((k for k in KERNELS if k in ln), None)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if kernel and m:
            notes[f"{kernel}_spill_bytes"] = int(m[1]) + int(m[2])
        m = re.search(r"Used (\d+) registers", ln)
        if kernel and m:
            notes[f"{kernel}_regs"] = int(m[1])
    return notes


def build_variants(names, workdir: Path) -> dict:
    """name -> (the variant's C entry point, its ptxas notes)."""
    procs = {}
    for i, name in enumerate(names):
        src = workdir / f"v{i}"
        shutil.copytree(_build.CSRC, src)
        for fname, edits in VARIANTS[name].items():
            (src / fname).write_text(
                patched((src / fname).read_text(), edits, fname))
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
    print(f"# {torch.cuda.get_device_name(device)}; K13 at its gate shapes, "
          f"64 -> 3 channels", flush=True)
    g = torch.Generator().manual_seed(0)
    rows = []
    with tempfile.TemporaryDirectory() as tmp, torch.inference_mode():
        built = build_variants(args.variants, Path(tmp))
        for dtype in (torch.float32, torch.bfloat16):
            w6 = ((torch.rand(3, 64, 3, 3, generator=g) * 2 - 1) / 24).to(
                device)
            hwio = w6.to(dtype).permute(2, 3, 1, 0).contiguous()
            bias = ((torch.rand(3, generator=g) * 2 - 1) / 24).to(device)
            es = hwio.element_size()
            for h, w, b in SHAPES:
                y = torch.rand(b, h, w, 64, generator=g).to(device, dtype)
                out = y.new_empty((b, h, w, 3))

                def run(fn):
                    err = fn(y.data_ptr(), hwio.data_ptr(), bias.data_ptr(),
                             out.data_ptr(), b, h, w,
                             _build.DTYPE_CODES[dtype],
                             torch.cuda.current_stream(device).cuda_stream)
                    if err:
                        raise RuntimeError(f"{ENTRY} failed: CUDA error "
                                           f"{err}")

                def ms(fn):
                    run(fn)

                    def loop():
                        for _ in range(args.iters):
                            run(fn)
                    return _elapsed_ms(device, loop) / args.iters

                bound = b * h * w * 67 * es / 3.35e9   # ms at 3.35 TB/s
                times = {name: [] for name in built}
                for order in (list(built), list(built)[::-1]):
                    for name in order:
                        times[name].append(ms(built[name][0]))
                for name, (_, notes) in built.items():
                    rows.append(dict(variant=name, dtype=str(dtype)[6:],
                                     shape=[b, h, w], ms=times[name],
                                     bound_ms=bound,
                                     bound_share=bound / min(times[name]),
                                     **notes))
                del y, out
    for row in rows:
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
