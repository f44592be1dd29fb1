"""K2's bf16 kernel taken apart on the card (csrc/ln_matmul_mma.cuh).

Builds scratch copies of ``csrc/`` in a temporary directory, each with one
part of the bf16 K2 kernel cut out or one design choice undone, and times
every build on the 1536- and 2048-wide pair at E = 512 (the ViT's ln1 ->
qkv and ln2 -> fc1), replayed from a CUDA graph (device time, no host
overhead):

- ``whole``: the kernel as ``csrc/`` builds it;
- ``no_product``: no k-chunk runs, so neither do the epilogues: the x
  tile's load and the LN alone;
- ``no_prologue``: no x load and no LN: the W ring, the products and the
  epilogue;
- ``no_w_loads``: the ring loads its first stages only, so the products
  run on stale W: the products and the epilogue without the W traffic;
- ``one_tile_per_block``: one column tile per block, each block running
  its own LN (the grid (F / 128, N / 128));
- ``two_stages``: a ring of two W stages in place of three.

Beside them: the library chain (``F.layer_norm`` + ``F.linear`` per width,
cuBLAS) from a graph, and the host's time per call of the wrapper
(``ops.ln_matmul.ln_matmul`` with float32 weights, as the bf16 paths call
it) and of the kernel alone on bf16 inputs, with no synchronisation.

    python -m mhada_tpu_torch.probes.ln_matmul_split [--rows 4096 16384]

prints one JSON line per row count.  It needs the card and nvcc.
"""

import argparse
import json
import shutil
import tempfile
import time
from pathlib import Path

import torch
import torch.nn.functional as F

from .. import _build
from ..ops import ln_matmul as lm

E, WIDTHS = 512, (1536, 2048)
# build -> (old, new) replacements in csrc/ln_matmul_mma.cuh
CUTS = {
    "no_product": [("const int nk = ek / kBK;", "const int nk = 0 * ek;")],
    "no_prologue": [("  load_x_tile(at, as, ek, a, r0);\n", ""),
                    ("  ln_in_place(at, as, a);\n", "")],
    "no_w_loads": [("if (lq < nq) load_w_chunk", "if (lq < 2) load_w_chunk")],
    "one_tile_per_block": [("std::min(col_tiles, sms / row_tiles)",
                            "col_tiles")],
    "two_stages": [("constexpr int kStages = 3;",
                    "constexpr int kStages = 2;")],
}
ORIGINAL, ORIGINAL_BUILD = _build.CSRC, _build.BUILD_DIR


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


def use_build(cut, tmp: Path) -> None:
    """Point ``_build`` at csrc with ``cut`` applied (None: csrc as it is)."""
    src = ORIGINAL if cut is None else tmp / cut / "csrc"
    if cut is not None:
        shutil.copytree(ORIGINAL, src)
        path = src / "ln_matmul_mma.cuh"
        text = path.read_text()
        for old, new in CUTS[cut]:
            if old not in text:
                raise ValueError(f"{cut}: {old!r} is not in {path.name}")
            text = text.replace(old, new)
        path.write_text(text)
    _build.CSRC, _build.BUILD_DIR, _build._lib = (
        src, ORIGINAL_BUILD if cut is None else tmp / cut / "build", None)
    _build.library()


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--rows", type=int, nargs="+", default=[4096, 16384])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("ln_matmul_split times kernels on a CUDA card")
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
        for cut in [None, *CUTS]:
            use_build(cut, Path(tmp))
            for n, x in xs.items():
                recs[n][f"{cut or 'whole'}_ms"] = graph_ms(alone(x))
        use_build(None, Path(tmp))
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
