"""The bf16 attention tile one piece at a time: builds of
csrc/attention_wgmma.cuh with one piece of its design changed, timed beside
the tile as built at K1's and K6's forward's shapes (C = 512, 8 heads):
K1 at B = 1, L = 4096 and 16384; K6's forward at B = 8, L = 1024 and B =
4, L = 4096.

    python -m mhada_tpu_torch.probes.attention_wgmma_ablate [--iters 20]
        [--variants ...] [--sweep]

Each variant is the header with the text edits of ``VARIANTS``, compiled
with the library's flags into a scratch library of attention_fwd.cu and
attention_train.cu (in a temporary directory, all variants at once) and
launched through the same C entry points (K1: mhada_attention_fwd, K6:
mhada_attention_train_fwd).  Each variant runs each shape unsplit and at
``self_splits``' count (``--sweep``: every count 1 .. MAX_SPLITS that its
key tiles allow).  Prints the card's name and power limit, then one JSON
line per variant: ptxas's registers, spilled bytes and serialisation notes
(C75xx) for the unsplit and split kernels, and per shape and count the
device ms in two rounds (variants in order, then reversed; CUDA events over
``--iters`` back-to-back launches), the bound's share at the faster round
and max |variant - as built| / max |as built| (unsplit, against the tile as
built unsplit).  The bound is 4 B L^2 C flops at the published bf16 peak.
Card only.
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
from ..ops.attention_kernel import MAX_SPLITS, KEY_TILE, self_splits
from .redesign_ab import card

HEADER = "attention_wgmma.cuh"
SOURCES = ("attention_fwd.cu", "attention_train.cu")
K1, K6 = "mhada_attention_fwd", "mhada_attention_train_fwd"
C, HEADS, SCALE = 512, 8, 0.125
# (entry, batch, tokens)
SHAPES = [(K1, 1, 4096), (K1, 1, 16384), (K6, 8, 1024), (K6, 4, 4096)]
PEAK_BF16 = 989e12


def _s128(name: str, first: bool) -> str:
    """C++ of one k-step of S at 128 keys, m64n128k16 with A (Q) from
    registers and B (the K tile) K-major; ``first`` writes S without
    reading it (hopper_async.cuh's m64n64k16 pair at twice the width)."""
    regs = ", ".join(f"%{i}" for i in range(64))
    acc = ", ".join(f'"{"=" if first else "+"}f"(d[{i}])' for i in range(64))
    return (f"__device__ __forceinline__ void {name}(float (&d)[64], "
            f"const uint32_t (&a)[4], uint64_t desc) {{\n"
            f'  asm volatile("{{\\n.reg .pred p;\\nsetp.ne.b32 p, %69, 0;'
            f'\\n"\n'
            f'      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 '
            f'{{{regs}}}, {{%64, %65, %66, %67}}, %68, p, 1, 1, 0;\\n}}\\n"'
            f"\n      : {acc}\n"
            f'      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), '
            f'"r"({0 if first else 1}));\n}}\n')


_FENCE_P = """__device__ __forceinline__ void fence_p(uint32_t (&a)[8][4]) {
#pragma unroll
  for (int i = 0; i < 32; ++i)
    asm volatile("" : "+r"(a[i / 4][i % 4])::"memory");
}
"""
# 128-key tiles: each stage two TMA boxes of 64 keys for K and for V, S on
# m64n128k16 (64 registers), P V over 8 k-steps of 16 keys (P 32
# registers)
_KEYS = [
    ("constexpr int kTileBytes = 64 * 64 * 2;         // one 64 x 64 bf16 box",
     "constexpr int kBoxBytes = 64 * 64 * 2;\n"
     "constexpr int kTileBytes = 128 * 64 * 2;   // two boxes of 64 keys"),
    ("template <bool kSplit>\n__global__",
     _s128("s128_first", True) + _s128("s128", False) + _FENCE_P
     + "\ntemplate <bool kSplit>\n__global__"),
    ("+ 63) / 64;", "+ 127) / 128;"),
    ("        tma_load_3d(kt, &kmap, full(s), h * 64, (t0 + j) * 64, b);\n"
     "        tma_load_3d(kt + kTileBytes, &vmap, full(s), h * 64, (t0 + j) * "
     "64, b);",
     "        for (int x = 0; x < 2; ++x) {\n"
     "          const int key = (t0 + j) * 128 + 64 * x;\n"
     "          tma_load_3d(kt + x * kBoxBytes, &kmap, full(s), h * 64, key, "
     "b);\n"
     "          tma_load_3d(kt + kTileBytes + x * kBoxBytes, &vmap, full(s), "
     "h * 64,\n                      key, b);\n        }"),
    ("float s[32], o[32];", "float s[64], o[32];"),
    ("uint32_t pf[4][4];", "uint32_t pf[8][4];"),
    ("wgmma_m64n64k16_rs_first<0>(s, qf[0], desc);",
     "s128_first(s, qf[0], desc);"),
    ("wgmma_m64n64k16_rs<0>(s, qf[kk], desc, 1);", "s128(s, qf[kk], desc);"),
    ("const uint32_t (&p)[4][4]) {", "const uint32_t (&p)[8][4]) {"),
    ("    for (int kk = 0; kk < 4; ++kk)   // keys 16 kk..",
     "    for (int kk = 0; kk < 8; ++kk)   // keys 16 kk.."),
    ("sw128_desc(vt + 2048 * kk, kTileBytes,",
     "sw128_desc(vt + 2048 * kk, kBoxBytes,"),
    ("    const int k0 = 64 * (t0 + j);\n"
     "    const bool ragged = k0 + 64 > M;",
     "    const int k0 = 128 * (t0 + j);\n"
     "    const bool ragged = k0 + 128 > M;"),
    ("    for (int i = 0; i < 32; ++i) {\n      if (ragged",
     "    for (int i = 0; i < 64; ++i) {\n      if (ragged"),
    ("    for (int i = 0; i < 32; ++i) {\n      const float e",
     "    for (int i = 0; i < 64; ++i) {\n      const float e"),
    ("    for (int kk = 0; kk < 4; ++kk) {\n      pf[kk][0]",
     "    for (int kk = 0; kk < 8; ++kk) {\n      pf[kk][0]"),
    ("fence_frags(pf);", "fence_p(pf);"),
]
_TWO = ("constexpr int kConsumers = 3;", "constexpr int kConsumers = 2;")
_REGS = "kConsumerRegs = 152, kProducerRegs = 56;"
# The scale applied as a multiply a score before the row maximum and the
# exp, as the tile did before it folded the scale into the exp's FFMA.
_MULTIPLY = [
    ("      if (ragged && k0 + 8 * (i / 4) + 2 * t + (i % 2) >= M)\n"
     "        s[i] = -INFINITY;\n"
     "      mx[(i % 4) / 2] = fmaxf(mx[(i % 4) / 2], s[i]);",
     "      float x = s[i] * sl2;\n"
     "      if (ragged && k0 + 8 * (i / 4) + 2 * t + (i % 2) >= M) "
     "x = -INFINITY;\n"
     "      s[i] = x;\n"
     "      mx[(i % 4) / 2] = fmaxf(mx[(i % 4) / 2], x);"),
    ("const float m_new = fmaxf(mrow[r], quad_max(mx[r]) * sl2);",
     "const float m_new = fmaxf(mrow[r], quad_max(mx[r]));"),
    ("const float e = exp2_ftz(fmaf(s[i], sl2, -mrow[(i % 4) / 2]));",
     "const float e = exp2_ftz(s[i] - mrow[(i % 4) / 2]);"),
]
# variant -> [(text in the header, its replacement)]
VARIANTS = {
    "as built": [],
    "scale as a multiply": _MULTIPLY,
    # S on m64n128k16 and P V over 8 k-steps: half the per-tile barriers,
    # waits, votes and shuffles; S 64 registers, P 32, O 32, Q 16 within
    # the consumers' 160 (three consumers) or 232 (two)
    "128-key tiles": [*_KEYS, (_REGS, "kConsumerRegs = 160, "
                                      "kProducerRegs = 32;")],
    # two consumers share a K/V tile (128 queries), with the registers a
    # block of three warpgroups allows
    "two consumers": [_TWO, (_REGS, "kConsumerRegs = 232, "
                                    "kProducerRegs = 40;")],
    "128-key tiles, two consumers": [*_KEYS, _TWO, (
        _REGS, "kConsumerRegs = 232, kProducerRegs = 40;")],
}


def patched(text: str, edits) -> str:
    """The header's text with ``edits`` applied; raises if one is missing."""
    for old, new in edits:
        if old not in text:
            raise ValueError(f"variant edit not found in {HEADER}: {old!r}")
        text = text.replace(old, new)
    return text


def ptxas_notes(log: str) -> dict:
    """The tile's registers and spilled bytes (unsplit and split
    instantiations, from attention_fwd.cu's compile), and the codes of
    ptxas' performance notes, from the ``-Xptxas -v`` logs."""
    notes = {"ptxas": sorted(set(re.findall(r"\((C75\d\d)\)", log)))}
    kernel = None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            m = re.search(r"attention_wgmma_kernelILb([01])E", ln)
            kernel = (f"split {m[1]}" if m and f"split {m[1]}" not in notes
                      else None)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if kernel and m:
            notes.setdefault(kernel, {})["spill_bytes"] = int(m[1]) + int(m[2])
        m = re.search(r"Used (\d+) registers", ln)
        if kernel and m:
            notes.setdefault(kernel, {})["regs"] = int(m[1])
            kernel = None
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
               *(str(src / s) for s in SOURCES)]
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
        for entry in (K1, K6):
            fn = getattr(so, entry)
            fn.argtypes = _build.SIGNATURES[entry]
            fn.restype = ctypes.c_int
            entries[entry] = fn
        built[name] = (entries, ptxas_notes(log))
    return built


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--variants", nargs="*", default=list(VARIANTS),
                    choices=list(VARIANTS))
    ap.add_argument("--sweep", action="store_true",
                    help="every split count, not just 1 and the pick")
    args = ap.parse_args(argv)
    device = resolve_device("cuda")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    print(f"# {card()}; C={C}, {HEADS} heads, bfloat16", flush=True)
    g = torch.Generator().manual_seed(0)
    data = []
    for entry, b, l in SHAPES:
        qkv = torch.randn(b, l, 3 * C, generator=g).to(device, torch.bfloat16)
        out = torch.empty(b, l, C, device=device, dtype=torch.bfloat16)
        lse = torch.empty(b, HEADS, l, device=device)
        pick = self_splits(b, HEADS, l, torch.bfloat16, sms)
        tiles = -(-l // KEY_TILE)
        counts = (range(1, min(tiles, MAX_SPLITS) + 1) if args.sweep
                  else sorted({1, pick}))
        part = torch.empty(max(counts) * b * l * (C + 2 * HEADS),
                           device=device)
        data.append((entry, b, l, qkv, out, lse, part, list(counts), pick))
    with tempfile.TemporaryDirectory() as tmp, torch.inference_mode():
        built = build_variants(args.variants, Path(tmp))

        def run(fn, entry, b, l, qkv, out, lse, part, splits):
            stream = torch.cuda.current_stream(device).cuda_stream
            ptrs = [qkv.data_ptr(), out.data_ptr()]
            ptrs += [lse.data_ptr()] if entry == K6 else []
            err = fn(*ptrs, part.data_ptr(), b, l, C, HEADS, splits, SCALE,
                     _build.DTYPE_CODES[torch.bfloat16], stream)
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
        for entry, b, l, qkv, out, lse, part, counts, pick in data:
            key = f"{'K1' if entry == K1 else 'K6'} B={b} L={l}"
            fns = {name: fns[entry] for name, (fns, _) in built.items()}
            run(fns[first], entry, b, l, qkv, out, lse, part, 1)
            ref = out.float().clone()
            for name, fn in fns.items():
                run(fn, entry, b, l, qkv, out, lse, part, 1)
                rows[name]["shapes"][key] = {
                    "rel_err_vs_first": ((out.float() - ref).abs().max()
                                         / ref.abs().max()).item(),
                    "pick": pick, "ms": {s: [] for s in counts}}
            for order in (list(fns), list(fns)[::-1]):
                for name in order:
                    for s in counts:
                        rows[name]["shapes"][key]["ms"][s].append(ms(
                            lambda: run(fns[name], entry, b, l, qkv, out,
                                        lse, part, s)))
            bound = 4 * b * l * l * C / PEAK_BF16 * 1e3
            for name in fns:
                rec = rows[name]["shapes"][key]
                rec["bound_ms"] = bound
                rec["bound_share"] = {s: bound / min(t)
                                      for s, t in rec["ms"].items()}
    for row in rows.values():
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
