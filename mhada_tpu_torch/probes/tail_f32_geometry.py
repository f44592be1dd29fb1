"""The f32 decoder tail's stage-2 block, measured: builds of K5's and K8's
float32 kernels (csrc/decoder_tail_f32.cuh) with each candidate block of
the upsample + c5 + c6 kernel, timed against each other at the paths'
shapes (K5 from 256^2 to 512^2 at B = 1; K8 from 128^2 to 256^2 at B = 8
and from 256^2 to 512^2 at B = 4), float32.

    python -m mhada_tpu_torch.probes.tail_f32_geometry [--iters 10]

Each variant is the header with its region rows and blocks an SM replaced,
compiled with the library's flags into a scratch library of
decoder_tail.cu alone (in a temporary directory, all variants at once) and
launched through the same C entry points.  A thread owns 8 pixels and 8
channels in every variant, so the region's rows set the threads: 24 x 32
with 384 threads (as built: one block an SM, <= 168 registers), 16 x 32
with 256 (one block an SM, or two at <= 128 registers, where the kernel
spills).  A larger region recomputes less of c5's ring and gives fewer,
larger blocks.  Prints the card's name, then one JSON line per variant:
region, threads, shared bytes, blocks and waves at each shape, ptxas's
registers and spilled bytes of the K5 and K8 instantiations, max |variant
- plain| / max |plain| of K5's rgb, and ms at each shape in two rounds (in
order, then reversed).  Card only.
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
from ..ops.decoder_tail import C_MID, decoder_tail_plain
from ..ops.pad_conv import no_tf32

HEADER = "decoder_tail_f32.cuh"
SOURCE = "decoder_tail.cu"
ROWS = "constexpr int kBR = 24, kBC = 32;"
BOUNDS = "__global__ void __launch_bounds__(kBThreads, 1)"
# variant -> (region rows, blocks an SM)
VARIANTS = {
    "24 x 32 region, 384 threads, one block an SM (as built)": (24, 1),
    "16 x 32 region, 256 threads, one block an SM": (16, 1),
    "16 x 32 region, 256 threads, two blocks an SM": (16, 2),
}
# (entry, batch, low-res side) of K5 and K8 on the paths
SHAPES = [("mhada_decoder_tail", 1, 256), ("mhada_decoder_tail_res", 8, 128),
          ("mhada_decoder_tail_res", 4, 256)]
SMS = 132


def patched(text: str, variant) -> str:
    """The header's text with stage 2's region rows and blocks an SM set to
    ``variant``; raises if a line is missing."""
    rows, blocks = variant
    for line in (ROWS, BOUNDS):
        if line not in text:
            raise ValueError(f"line not found in {HEADER}: {line!r}")
    return text.replace(ROWS, f"constexpr int kBR = {rows}, kBC = 32;") \
        .replace(BOUNDS, f"__global__ void __launch_bounds__(kBThreads, "
                         f"{blocks})")


def layout(variant) -> dict:
    """Threads, shared bytes, blocks and waves of stage 2 at SHAPES, as
    the header computes them."""
    rows, blocks = variant
    out_rows, out_cols = rows - 2, 30
    union = max(32 * (rows * 32 + 16), 8 * (rows + 2) * 36)  # c5 | up
    ring = 2 * ((rows // 2 + 3) * 19 * 8 + 9 * 8 * 32)     # y1, w5
    smem = 4 * (9 * 64 * 4 + union + ring + 4 * (rows + 2 + 34))
    counts = [b * -(-2 * n // out_rows) * -(-2 * n // out_cols)
              for _, b, n in SHAPES]
    return {"region": [rows, 32], "threads": rows * 32 // 8 * 4,
            "blocks_per_sm": blocks, "smem_bytes": smem, "blocks": counts,
            "waves": [round(c / (SMS * blocks), 2) for c in counts]}


def ptxas_notes(log: str) -> dict:
    """Registers and spilled bytes of the stage-2 instantiations (K5
    <false>, K8 <true>) from an ``-Xptxas -v`` log."""
    notes, kernel = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '\w*tail_c5c6_f32_kernelILb"
                      r"(\d)E", ln)
        if "Compiling entry function" in ln:
            kernel = ("K8" if m[1] == "1" else "K5") if m else None
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if kernel and m:
            notes[f"{kernel}_spill_bytes"] = int(m[1]) + int(m[2])
        m = re.search(r"Used (\d+) registers", ln)
        if kernel and m:
            notes[f"{kernel}_regs"] = int(m[1])
    return notes


def build_variants(names, workdir: Path) -> dict:
    """name -> (entry name -> the variant's C entry point, ptxas notes)."""
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
        cdll, fns = ctypes.CDLL(str(lib)), {}
        for entry in {e for e, _, _ in SHAPES}:
            fn = getattr(cdll, entry)
            fn.argtypes = _build.SIGNATURES[entry]
            fn.restype = ctypes.c_int
            fns[entry] = fn
        built[name] = (fns, ptxas_notes(log))
    return built


def _weights(g, device):
    """OIHW conv weights at their init scale U(-1/sqrt(fan_in),
    1/sqrt(fan_in)) and biases in [0, 2/sqrt(fan_in)), float32."""
    out = []
    for co, ci in ((C_MID, 128), (C_MID, C_MID), (3, C_MID)):
        bound = 1 / (ci * 9) ** 0.5
        w = (torch.rand(co, ci, 3, 3, generator=g) * 2 - 1) * bound
        b = torch.rand(co, generator=g) * 2 * bound
        out += [w.to(device), b.to(device)]
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--variants", nargs="*", default=list(VARIANTS),
                    choices=list(VARIANTS))
    args = ap.parse_args(argv)
    device = resolve_device("cuda")
    g = torch.Generator().manual_seed(0)
    ws = _weights(g, device)
    hwio = [w.permute(2, 3, 1, 0).contiguous() for w in ws[::2]]
    xs = [torch.randn(b, n, n, 128, generator=g).abs().to(device)
          for _, b, n in SHAPES]
    outs = []
    for (entry, b, n), x in zip(SHAPES, xs):
        bufs = [torch.empty(b, 2 * n, 2 * n, 3, device=device),
                torch.empty(b, n, n, C_MID, device=device)]   # rgb, y1
        if entry == "mhada_decoder_tail_res":
            bufs.append(torch.empty(b, 2 * n, 2 * n, C_MID, device=device))
        outs.append(bufs)
    print(f"# {torch.cuda.get_device_name(device)}; float32; shapes "
          f"(entry, B, low-res side) {SHAPES}", flush=True)
    with tempfile.TemporaryDirectory() as tmp, torch.inference_mode():
        built = build_variants(args.variants, Path(tmp))

        def run(fns, s):
            (entry, b, n), x = SHAPES[s], xs[s]
            stream = torch.cuda.current_stream(device).cuda_stream
            err = fns[entry](x.data_ptr(), hwio[0].data_ptr(),
                             ws[1].data_ptr(), hwio[1].data_ptr(),
                             ws[3].data_ptr(), hwio[2].data_ptr(),
                             ws[5].data_ptr(),
                             *(t.data_ptr() for t in outs[s]), b, n, n,
                             _build.DTYPE_CODES[torch.float32], stream)
            if err:
                raise RuntimeError(f"{entry} failed: CUDA error {err}")

        def ms(fns, s):
            run(fns, s)
            iters = max(2, args.iters * SHAPES[0][1] * SHAPES[0][2] ** 2
                        // (SHAPES[s][1] * SHAPES[s][2] ** 2))

            def loop():
                for _ in range(iters):
                    run(fns, s)
            return _elapsed_ms(device, loop) / iters

        with no_tf32():
            ref = decoder_tail_plain(xs[0], *ws)
        rows = {}
        for name, (fns, notes) in built.items():
            run(fns, 0)
            rgb = outs[0][0]
            rows[name] = {"variant": name, **layout(VARIANTS[name]), **notes,
                          "rel_err_vs_plain": ((rgb - ref).abs().max()
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
