"""P2's bf16 design one piece at a time: builds of csrc/mhada_wgmma.cuh
with one piece changed or cut out, timed beside the kernel as built and
K3 on the probe's inputs (B = 8, N = M = 4096, C = 512, 8 heads, bf16).

    python -m mhada_tpu_torch.probes.mhada_wgmma_ablate [--iters 20]

Each variant is the header with the text edits of ``VARIANTS``, compiled
with the library's flags into a scratch library of mhada_prologue_pipe.cu
alone (in a temporary directory, all variants at once) and launched
through the same C entry point.  A cut variant ("no exps", "no softmax")
computes something else: it times the rest of the pipeline, and its error
against K3 is printed, not checked.  Prints the card's name, then one JSON
line per variant and one for K3: ms in two rounds (in order, then
reversed), max |variant - K3| / max |K3|, and ptxas's registers, spilled
bytes and serialisation notes (C75xx) for the kernel.  Card only.
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
from ..ops.mhada_prologue import mhada_fused_prologue
from .mhada_pipe_probe import SHAPE, probe_inputs

HEADER = "mhada_wgmma.cuh"
ENTRY = "mhada_mhada_prologue_pipe"
_SOFTMAX_HEAD = ("      const bool ragged = k0 + 64 > M;\n"
                 "      float mx[2]")
# variant -> [(text in the header, its replacement)]
VARIANTS = {
    "as built": [],
    # two consumers share a K/V tile (128 queries), with the registers a
    # block of three warpgroups allows
    "two consumers": [
        ("constexpr int kConsumers = 3;", "constexpr int kConsumers = 2;"),
        ("kConsumerRegs = 160, kProducerRegs = 32;",
         "kConsumerRegs = 232, kProducerRegs = 40;")],
    "two stages": [("constexpr int kStages = 4;",
                    "constexpr int kStages = 2;")],
    # the consumers issue their products whenever they are ready
    "no turns": [("    named_sync(turn, 256);\n", ""),
                 ("named_arrive(next, 256);", ""),
                 ("if (last) named_arrive(kBarTurn, 256);", "")],
    # the key mask on every tile, not only on the ragged last one
    "mask every tile": [("      if (ragged) {\n#pragma unroll\n"
                         "        for (int i = 0; i < 32; ++i)\n"
                         "          if (k0",
                         "      {\n#pragma unroll\n"
                         "        for (int i = 0; i < 32; ++i)\n"
                         "          if (ragged && k0")],
    # O rescaled every tile, also when no row maximum of the warp moved
    "always rescale": [("__any_sync(0xffffffffu, alpha[0] != 1.f || "
                        "alpha[1] != 1.f)", "true")],
    "no exps": [("exp2_ftz(fmaf(s[i], kLog2e, mb[(i % 4) / 2]))",
                 "fmaf(s[i], kLog2e, mb[(i % 4) / 2])")],
    "no softmax": [(_SOFTMAX_HEAD, "      alpha[0] = alpha[1] = 1.f;\n"
                                   "      return;\n" + _SOFTMAX_HEAD)],
}


def patched(text: str, edits) -> str:
    """The header's text with ``edits`` applied; raises if one is missing."""
    for old, new in edits:
        if old not in text:
            raise ValueError(f"variant edit not found in {HEADER}: {old!r}")
        text = text.replace(old, new)
    return text


def ptxas_notes(log: str) -> dict:
    """The wgmma kernel's registers and spilled bytes, and the codes of
    ptxas' performance notes, from an ``-Xptxas -v`` log."""
    notes = {"ptxas": sorted(set(re.findall(r"\((C75\d\d)\)", log)))}
    kernel = False
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            kernel = "mhada_wgmma_kernelILb1ELb0E" in ln   # P2's
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
               str(src / "mhada_prologue_pipe.cu")]
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
    b, n, c, heads = SHAPE["b"], SHAPE["n"], SHAPE["c"], SHAPE["heads"]
    inputs = probe_inputs(**SHAPE, dtype=torch.bfloat16, device=device)
    fc, fcs, stats, wf, fb, k, v = inputs
    # the arguments launch_prologue hands the entry point
    wt, fbf = wf.to(torch.bfloat16).contiguous(), fb.to(
        torch.bfloat16).float().contiguous()
    out = torch.empty_like(fc)
    print(f"# {torch.cuda.get_device_name(device)}; B={b} N=M={n} C={c} "
          f"bfloat16", flush=True)
    with tempfile.TemporaryDirectory() as tmp, torch.inference_mode():
        built = build_variants(args.variants, Path(tmp))

        def run(fn):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = fn(fc.data_ptr(), fcs.data_ptr(), stats.data_ptr(),
                     wt.data_ptr(), fbf.data_ptr(), k.data_ptr(),
                     v.data_ptr(), out.data_ptr(), None, b, n, n, c, heads,
                     1, _build.DTYPE_CODES[torch.bfloat16], stream)
            if err:
                raise RuntimeError(f"{ENTRY} failed: CUDA error {err}")

        def ms(fn):
            fn()

            def loop():
                for _ in range(args.iters):
                    fn()
            return _elapsed_ms(device, loop) / args.iters

        k3 = mhada_fused_prologue(*inputs).float()
        rows = {name: {"variant": name} for name in built}
        for name, (fn, notes) in built.items():
            run(fn)
            rows[name]["rel_err_vs_k3"] = ((out.float() - k3).abs().max()
                                           / k3.abs().max()).item()
            rows[name].update(notes)
        rows["K3"] = {"variant": "K3 (the same tile, split as "
                                 "mhada_splits picks)", "ms": []}
        for order in (list(built), list(built)[::-1]):
            for name in order:
                rows[name].setdefault("ms", []).append(
                    ms(lambda: run(built[name][0])))
            rows["K3"]["ms"].append(ms(lambda: mhada_fused_prologue(*inputs)))
    for row in rows.values():
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
