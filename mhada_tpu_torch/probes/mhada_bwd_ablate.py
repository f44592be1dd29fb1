"""K7's bf16 backward one piece at a time: builds of
csrc/mhada_bwd_wgmma.cuh with one piece of its design changed, timed beside
the kernels as built at K7's training gates' shapes (C = 512, 8 heads): B
= 8, N = M = 1024 (the 256^2 step), B = 4, N = M = 4096 (512^2) and B = 2,
2048 queries against 1024 keys (the video step).

    python -m mhada_tpu_torch.probes.mhada_bwd_ablate [--iters 10]
        [--variants ...]

Each variant is the header with the text edits of ``VARIANTS`` (a loop
edit replaces a consumer's loop, from its first comment line through its
closing brace), compiled with the library's flags into a scratch library
of mhada_train.cu (in a temporary directory, all variants at once) and
launched through the same C entry point (mhada_mhada_train_bwd).  The
variants: the dK/dV kernel on whole 64-query tiles (kDkvPart = 64), and
either kernel's consumers keeping two product groups in flight (the next
tile's S and dP issued under this tile's dQ, or dV and dK).  Prints the
card's name and power limit, then one JSON line per variant: ptxas's
registers, spilled bytes and serialisation notes (C75xx) of the dQ and
dK/dV kernels, and per shape the device ms of the call (both kernels) in
two rounds (variants in order, then reversed; CUDA events over ``--iters``
back-to-back launches), the bound's share at the faster round and max
|variant - as built| / max |as built| of dq, dk and dv.  The bound is 20 B
N M C flops (S and dP recomputed in both kernels) at the published bf16
peak.  Card only.
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
from ..ops.mhada_train import mhada_train_fwd_plain, mhada_train_prologue
from .redesign_ab import card

HEADER = "mhada_bwd_wgmma.cuh"
SOURCE = "mhada_train.cu"
ENTRY = "mhada_mhada_train_bwd"
KERNELS = ("mhada_wgmma_dq_kernel", "mhada_wgmma_dkv_kernel")
C, HEADS = 512, 8
SHAPES = [(8, 1024, 1024), (4, 4096, 4096), (2, 2048, 1024)]
PEAK_BF16 = 989e12

# The dQ consumers with two groups in flight: turn j issues tile j's S and
# dP and tile j - 1's dQ, and runs tile j's P and dS while they run.
_DQ_TWO = """  // two groups in flight
  if (turns.last) named_arrive(kBarTurn, 256);
  mbar_wait_or_trap(qbar, 0);
  mbar_wait_or_trap(full(0), 0);
  named_sync(turns.turn, 256);
  wgmma_fence();
  issue_sdp(0);
  wgmma_commit();
  named_arrive(turns.next, 256);
  wgmma_wait<0>();
  fence_regs(s);
  fence_regs(dp);
  ds(0);
  pack_frags(df, dp);
  for (int j = 1; j < ntiles; ++j) {
    const int st = j % kStages, sp = (j - 1) % kStages;
    mbar_wait_or_trap(full(st), (j / kStages) & 1);
    named_sync(turns.turn, 256);
    fence_regs(dq);
    fence_frags(df);
    wgmma_fence();
    issue_sdp(st);
    wgmma_commit();
    issue_dq(sp);
    wgmma_commit();
    named_arrive(turns.next, 256);
    wgmma_wait<1>();
    fence_regs(s);
    fence_regs(dp);
    ds(j);
    wgmma_wait<0>();
    fence_regs(dq);
    fence_frags(df);
    release(sp);
    pack_frags(df, dp);
  }
  {
    const int sl = (ntiles - 1) % kStages;
    named_sync(turns.turn, 256);
    fence_regs(dq);
    fence_frags(df);
    wgmma_fence();
    issue_dq(sl);
    wgmma_commit();
    if (!turns.last) named_arrive(turns.next, 256);
    wgmma_wait<0>();
    fence_regs(dq);
    release(sl);
  }
"""
_FENCE_DKV = """    fence_regs(dk);
    fence_regs(dv);
    fence_frags(pf);
    fence_frags(dsf);
"""
# The dK/dV consumers with two groups in flight: turn u issues step u's
# S^T and dP^T and step u - 1's dV and dK.
_DKV_TWO = ("""  // two groups in flight
  if (turns.last) named_arrive(kBarTurn, 256);
  mbar_wait_or_trap(full(0), 0);
  named_sync(turns.turn, 256);
  wgmma_fence();
  issue_sdp(0);
  wgmma_commit();
  named_arrive(turns.next, 256);
  wgmma_wait<0>();
  fence_regs(sT);
  fence_regs(dpT);
  ds(0);
  pack();
  for (int u = 1; u < steps; ++u) {
    if (u % kDkvParts == 0)
      mbar_wait_or_trap(full(stage(u)), u / kDkvParts / kStages & 1);
    named_sync(turns.turn, 256);
""" + _FENCE_DKV + """    wgmma_fence();
    issue_sdp(u);
    wgmma_commit();
    issue_dkv(u - 1);
    wgmma_commit();
    named_arrive(turns.next, 256);
    wgmma_wait<1>();
    fence_regs(sT);
    fence_regs(dpT);
    ds(u);
    wgmma_wait<0>();
""" + _FENCE_DKV + """    if ((u - 1) % kDkvParts == kDkvParts - 1)
      release(u - 1);
    pack();
  }
  {
    named_sync(turns.turn, 256);
""" + _FENCE_DKV + """    wgmma_fence();
    issue_dkv(steps - 1);
    wgmma_commit();
    if (!turns.last) named_arrive(turns.next, 256);
    wgmma_wait<0>();
    fence_regs(dk);
    fence_regs(dv);
    release(steps - 1);
  }
""")
# The first lines of the two consumer loops as built.
DQ_LOOP = ("  // Consumers issue S and dP in turn, 0 first, one turn a key "
           "tile;")
DKV_LOOP = "  // One product group in flight: each turn issues step u's S^T"
# variant -> edits: (old text, new) or (the first line of a loop, new loop)
VARIANTS = {
    "as built": [],
    "dK/dV whole query tiles": [("constexpr int kDkvPart = 32,",
                                 "constexpr int kDkvPart = 64,")],
    "dK/dV two groups in flight": [(DKV_LOOP, _DKV_TWO)],
    "dQ two groups in flight": [(DQ_LOOP, _DQ_TWO)],
}


def patched(text: str, edits, loops=(DQ_LOOP, DKV_LOOP),
            header=HEADER) -> str:
    """The header's text with ``edits`` applied; an edit whose old text is
    one of ``loops`` replaces a consumer's loop: a loop's first line, from
    it through the loop's closing brace, or a pair (first line, last
    text), from the first line through the last text.  Raises if one is
    missing."""
    ends = dict(loop if isinstance(loop, tuple) else (loop, "\n  }\n")
                for loop in loops)
    for old, new in edits:
        if old not in text:
            raise ValueError(f"variant edit not found in {header}: {old!r}")
        if old in ends:
            start = text.index(old)
            end = text.index(ends[old], start) + len(ends[old])
            text = text[:start] + new + text[end:]
        else:
            text = text.replace(old, new)
    return text


def ptxas_notes(log: str, kernels=KERNELS) -> dict:
    """Each backward kernel's registers and spilled bytes, and the codes of
    ptxas' performance notes that name it, from the ``-Xptxas -v`` log."""
    notes, kernel = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            kernel = next((k for k in kernels if k in ln), None)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if kernel and m:
            notes.setdefault(kernel, {})["spill_bytes"] = int(m[1]) + int(m[2])
        m = re.search(r"Used (\d+) registers", ln)
        if kernel and m:
            notes.setdefault(kernel, {})["regs"] = int(m[1])
            kernel = None
        m = re.search(r"\((C75\d\d)\).*'(\w+)'", ln)
        for k in kernels:
            if m and k in m[2]:
                codes = notes.setdefault(k, {}).setdefault("ptxas", [])
                codes += [m[1]] if m[1] not in codes else []
    return notes


def build_variants(names, workdir: Path, variants=VARIANTS, header=HEADER,
                   source=SOURCE, entry=ENTRY, loops=(DQ_LOOP, DKV_LOOP),
                   kernels=KERNELS) -> dict:
    """name -> (the variant's C entry point, its ptxas notes): each variant
    of ``variants`` is ``header`` with its edits, compiled with ``source``
    into a library of its own whose C entry ``entry`` is returned."""
    procs = {}
    for i, name in enumerate(names):
        src = workdir / f"v{i}"
        shutil.copytree(_build.CSRC, src)
        (src / header).write_text(patched((src / header).read_text(),
                                          variants[name], loops, header))
        lib = src / "variant.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib),
               str(src / source)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       lib)
    built = {}
    for name, (proc, lib) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log[-3000:]}")
        fn = getattr(ctypes.CDLL(str(lib)), entry)
        fn.argtypes = _build.SIGNATURES[entry]
        fn.restype = ctypes.c_int
        built[name] = (fn, ptxas_notes(log, kernels))
    return built


def measure(built, cases, launch, device, iters) -> list:
    """One record a variant of ``built``: its ptxas notes and per case of
    ``cases`` ((key, inputs, outputs, bound ms)) the device ms of
    ``launch(fn, inputs, outputs)`` in two rounds (the variants in order,
    then reversed; CUDA events over ``iters`` back-to-back launches), the
    bound's share at the faster round and max |variant - first| / max
    |first| over the outputs."""
    def ms(call):
        call()

        def loop():
            for _ in range(iters):
                call()
        return _elapsed_ms(device, loop) / iters

    rows = {name: {"variant": name, **notes, "shapes": {}}
            for name, (_, notes) in built.items()}
    first = next(iter(built))
    for key, ins, outs, bound in cases:
        launch(built[first][0], ins, outs)
        ref = [t.float().clone() for t in outs]
        for name, (fn, _) in built.items():
            launch(fn, ins, outs)
            rows[name]["shapes"][key] = {
                "rel_err_vs_first": max(
                    ((o.float() - r).abs().max() / r.abs().max()).item()
                    for o, r in zip(outs, ref)), "ms": []}
        for order in (list(built), list(built)[::-1]):
            for name in order:
                rows[name]["shapes"][key]["ms"].append(ms(
                    lambda: launch(built[name][0], ins, outs)))
        for name in built:
            rec = rows[name]["shapes"][key]
            rec["bound_ms"] = bound
            rec["bound_share"] = bound / min(rec["ms"])
    return list(rows.values())


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--variants", nargs="*", default=list(VARIANTS),
                    choices=list(VARIANTS))
    args = ap.parse_args(argv)
    device = resolve_device("cuda")
    print(f"# {card()}; C={C}, {HEADS} heads, bfloat16", flush=True)
    bf = torch.bfloat16
    g = torch.Generator().manual_seed(0)
    cases = []
    with torch.inference_mode():
        for b, n, m in SHAPES:
            q, k = (0.35 * torch.randn(b, t, C, generator=g).to(device, bf)
                    for t in (n, m))
            v = torch.randn(b, m, C, generator=g).to(device, bf)
            f, cot = (torch.randn(b, n, C, generator=g).to(device, bf)
                      for _ in range(2))
            _, m1, e2, lse = mhada_train_fwd_plain(q, k, v, f, HEADS)
            dm1, de2, delta, _ = mhada_train_prologue(cot, f, m1, e2, HEADS,
                                                      bf)
            grads = (torch.empty_like(q), torch.empty_like(k),
                     torch.empty_like(v))
            cases.append((f"B={b} N={n} M={m}",
                          (b, n, m, (q, k, v, dm1, de2, lse, delta)), grads,
                          20 * b * n * m * C / PEAK_BF16 * 1e3))
            del m1, e2, f, cot
    with tempfile.TemporaryDirectory() as tmp, torch.inference_mode():
        built = build_variants(args.variants, Path(tmp))

        def launch(fn, shape_ins, outs):
            b, n, m, ins = shape_ins
            stream = torch.cuda.current_stream(device).cuda_stream
            err = fn(*(t.data_ptr() for t in (*ins, *outs)), b, n, m, C,
                     HEADS, _build.DTYPE_CODES[bf], stream)
            if err:
                raise RuntimeError(f"{ENTRY} failed: CUDA error {err}")

        rows = measure(built, cases, launch, device, args.iters)
    for row in rows:
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
