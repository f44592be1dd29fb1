"""K2's bf16 kernel taken apart on the card (csrc/ln_matmul_wgmma.cuh).

Builds scratch copies of ``csrc/`` in a temporary directory, each with one
part of the bf16 K2 kernel cut out or one design choice changed (a text
patch of the header, and where the block or ring changes, the launch
plan's constants in ``ops.ln_matmul`` to match), and times every build on
the 1536- and 2048-wide pair at E = 512 (the ViT's ln1 -> qkv and ln2 ->
fc1), replayed from a CUDA graph (device time, no host overhead):

- ``whole``: the kernel as ``csrc/`` builds it;
- ``no_product``: no column tile runs, so no W load, product or epilogue:
  the x rows' TMA load and the LN alone;
- ``no_prologue``: no x load and no LN (the products read whatever shared
  memory holds): the W ring, the products and the epilogues;
- ``no_w_loads``: the ring loads its first round of stages only and then
  releases stale ones, so the products run without the W traffic;
- ``no_store``: the epilogue as built up to its stores, which a condition
  the compiler cannot fold skips (the products stay live);
- ``rows_4``: the LN four rows a warp at a time in place of two;
- ``ln_by_all``: the LN by all three warpgroups (one row a warp at a time)
  before the roles split, while the ring's first round lands;
- ``one_tile_per_block``: one column tile a block, each block running its
  own LN (the grid (F / 128, N / 128));
- ``stages_3``: a ring of 3 W stages in place of the 6 that fit at E = 512;
- ``bn_256``: column tiles of 256 (128 accumulators a consumer thread; 3
  stages fit);
- ``bm_64``: blocks of 64 rows with one consumer, two blocks an SM, so that
  one block's LN can run under the other's products (2 stages fit).

Variants combine with ``+`` (``bn_256+no_store``).  Each build's
registers, spills and ptxas' wgmma notes are recorded, and each build's
largest error against the plain version at the first row count (the cuts
compute garbage by design).

Not built: A from registers (the wgmma RS form).  h for a consumer's 64
rows at E = 512 is 128 registers a thread beside its 64 accumulators, and
the consumer holds 232.

Beside them: the library chain (``F.layer_norm`` + ``F.linear`` per width,
cuBLAS) from a graph, and the host's time per call of the wrapper
(``ops.ln_matmul.ln_matmul`` with float32 weights, as the bf16 paths call
it) and of the kernel alone on bf16 inputs, with no synchronisation.

    python -m mhada_tpu_torch.probes.ln_matmul_split [--rows 4096 16384]
        [--variants whole bn_256 ...]

prints the card's name and power limit, then one JSON line per row count.
It needs the card and nvcc.
"""

import argparse
import contextlib
import json
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch
import torch.nn.functional as F

from .. import _build
from ..ops import ln_matmul as lm

E, WIDTHS = 512, (1536, 2048)
HEADER = "ln_matmul_wgmma.cuh"
# the producer's x loads, which no_prologue takes out
X_LOADS = ("    for (int g = 0; g < kConsumers; ++g) {\n      mbar_expect_tx",
           "    for (int g = 0; g < 0; ++g) {\n      mbar_expect_tx")
# the consumers' LN, which no_prologue and ln_by_all take out
CONSUMER_LN = ("  mbar_wait_or_trap(xbar(g), 0);\n"
               "  ln_rows(smem, a, 64 * g, 64, w, 4);\n", "")
# the end of the loads issued before the roles split
FIRST_ROUND = "    for (int q = 0; q < min(stages, nq); ++q) load_w(q);\n  }\n"
# build -> (old, new) replacements in csrc/ln_matmul_wgmma.cuh
CUTS = {
    "no_product": [("const int ntiles = min(", "const int ntiles = 0 * min(")],
    "no_prologue": [X_LOADS, CONSUMER_LN],
    "no_w_loads": [("(q / stages - 1) & 1);\n        load_w(q);\n",
                    "(q / stages - 1) & 1);\n"
                    "        mbar_arrive(full(q % stages));\n")],
    "no_store": [("        if (row < a.rows && col < a.f)",
                  "        if (row < a.rows - (1 << 30) && col < a.f)")],
    "rows_4": [("constexpr int kRowsAtOnce = 2;",
                "constexpr int kRowsAtOnce = 4;")],
    "ln_by_all": [
        CONSUMER_LN,
        ("constexpr int kRowsAtOnce = 2;", "constexpr int kRowsAtOnce = 1;"),
        (FIRST_ROUND,
         FIRST_ROUND
         + "  for (int g = 0; g < kConsumers; ++g) "
         "mbar_wait_or_trap(xbar(g), 0);\n"
         "  ln_rows(smem, a, 0, kBM, warp, kThreads / 32);\n"
         "  asm volatile(\"fence.proxy.async.shared::cta;\\n\" ::: "
         "\"memory\");\n"
         "  __syncthreads();\n")],
    "one_tile_per_block": [],
    "stages_3": [],
    "bn_256": [("constexpr int kBN = 128;", "constexpr int kBN = 256;")],
    "bm_64": [("constexpr int kBM = 128;", "constexpr int kBM = 64;"),
              ("constexpr int kBlocksPerSm = 1;",
               "constexpr int kBlocksPerSm = 2;")],
}
# build -> ops.ln_matmul attributes the launch plan reads, set for it
PLANS = {
    "one_tile_per_block": {"launch_plan": lambda rows, e, f, sms: (
        1, ORIGINAL_PLAN(rows, e, f, sms)[1])},
    "stages_3": {"MAX_STAGES": 3},
    "bn_256": {"BN": 256},
    "bm_64": {"BM": 64, "BLOCKS_PER_SM": 2},
}
VARIANTS = ["whole", *CUTS]
ORIGINAL, ORIGINAL_BUILD = _build.CSRC, _build.BUILD_DIR
ORIGINAL_PLAN = lm.launch_plan


def patched(text: str, edits) -> str:
    """``text`` with each (old, new) edit applied once; raises where an old
    text is not in it exactly once."""
    for old, new in edits:
        if text.count(old) != 1:
            raise ValueError(f"{old!r} is not found once in {HEADER}")
        text = text.replace(old, new)
    return text


def graph_ms(fn, reps: int = 20, rounds: int = 5) -> float:
    """Device ms of one ``fn()``, from a CUDA graph of ``reps`` calls."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(rounds):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (rounds * reps)


def host_us(fn, calls: int = 200) -> float:
    """Host microseconds per ``fn()`` call, issued without a sync."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / calls
    torch.cuda.synchronize()
    return us


def parts(variant: str) -> list[str]:
    """The variants a ``+`` combination names (``whole`` names none)."""
    names = [v for v in variant.split("+") if v != "whole"]
    bad = [v for v in names if v not in CUTS]
    if bad:
        raise ValueError(f"unknown variants {bad}; choose from {VARIANTS}")
    return names


def ptxas_note(log: str) -> str:
    """The K2 kernel's registers, spills and ptxas' wgmma notes (C75xx)
    from a build's log."""
    out, name = [], None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln
        elif name and "ln_matmul_wgmma" in name and (
                "Used" in ln or "spill" in ln):
            out.append(ln.split(":", 1)[-1].strip())
        if "(C75" in ln and "ln_matmul_wgmma" in ln:
            out.append(ln.split("info    :")[-1].strip()[:80])
    return "; ".join(out)


@contextlib.contextmanager
def use_build(variant: str, tmp: Path):
    """Point ``_build`` at csrc with ``variant``'s edits applied, and the
    launch plan at its constants, for the duration."""
    names = parts(variant)
    edits = [e for v in names for e in CUTS[v]]
    plan = {k: x for v in names for k, x in PLANS.get(v, {}).items()}
    src = ORIGINAL
    if edits:
        src = tmp / variant / "csrc"
        shutil.copytree(ORIGINAL, src)
        path = src / HEADER
        path.write_text(patched(path.read_text(), edits))
    old = {k: getattr(lm, k) for k in plan}
    for k, v in plan.items():
        setattr(lm, k, v)
    _build.CSRC, _build.BUILD_DIR, _build._lib = (
        src, ORIGINAL_BUILD if src == ORIGINAL else tmp / variant / "build",
        None)
    try:
        _build.library()
        yield
    finally:
        for k, v in old.items():
            setattr(lm, k, v)
        _build.CSRC, _build.BUILD_DIR, _build._lib = (ORIGINAL,
                                                      ORIGINAL_BUILD, None)


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--rows", type=int, nargs="+", default=[4096, 16384])
    ap.add_argument("--variants", nargs="+", default=VARIANTS)
    args = ap.parse_args(argv)
    for v in args.variants:
        parts(v)
    if not torch.cuda.is_available():
        raise RuntimeError("ln_matmul_split times kernels on a CUDA card")
    print(f"# {card()}", flush=True)
    gen = torch.Generator().manual_seed(0)
    dev, bf = "cuda", torch.bfloat16
    lw = (1 + 0.1 * torch.randn(E, generator=gen)).to(dev)
    lb = (0.1 * torch.randn(E, generator=gen)).to(dev)
    ws = [(torch.randn(f, E, generator=gen) / E ** 0.5).to(dev)
          for f in WIDTHS]
    bs = [(0.1 * torch.randn(f, generator=gen)).to(dev) for f in WIDTHS]
    lwt, lbt = lw.to(bf), lb.to(bf)
    pairs = [(w.to(bf), b.to(bf)) for w, b in zip(ws, bs)]
    xs = {n: torch.randn(1, n, E, generator=gen).to(dev, bf)
          for n in args.rows}

    def alone(x):
        return lambda: [lm._ln_matmul_kernel(x, lwt, lbt, w, b, 1e-6)
                        for w, b in pairs]

    recs = {n: {"rows": n, "card": torch.cuda.get_device_name(0)}
            for n in args.rows}
    with torch.inference_mode(), tempfile.TemporaryDirectory() as tmp:
        for variant in args.variants:
            with use_build(variant, Path(tmp)):
                log = _build.library_path().with_suffix(".log").read_text()
                x = xs[args.rows[0]]
                err = max((a.float() - b.float()).abs().max().item()
                          for a, b in zip(alone(x)(), [
                              lm.ln_matmul_plain(x, lwt, lbt, w, b)
                              for w, b in pairs]))
                for n, x in xs.items():
                    recs[n][f"{variant}_ms"] = graph_ms(alone(x))
                recs[args.rows[0]][f"{variant}_build"] = ptxas_note(log)
                recs[args.rows[0]][f"{variant}_max_abs_err"] = err
        for n, x in xs.items():
            recs[n]["chain_ms"] = graph_ms(
                lambda x=x: [F.linear(F.layer_norm(x, (E,), lwt, lbt, 1e-6),
                                      w, b) for w, b in pairs])
            recs[n]["host_us_wrapper"] = host_us(
                lambda x=x: [lm.ln_matmul(x, lw, lb, w, b)
                             for w, b in zip(ws, bs)])
            recs[n]["host_us_kernel_alone"] = host_us(alone(x))
            print(json.dumps(recs[n]), flush=True)


if __name__ == "__main__":
    main()
