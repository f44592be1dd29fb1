#!/usr/bin/env python3
"""Drive the PyTorch port (mhada_tpu_torch) on one CUDA card, in phases.

    python3 chip_smoke.py        # from the root of the repository

1. environment: torch / CUDA versions, the card's name and power limit;
2. build: compile mhada_tpu_torch/csrc/*.cu with nvcc;
3. gates: each hand-written kernel against its plain PyTorch twin on the
   card, at the 512^2 path's shapes, in float32 and bfloat16;
4. main path: ``infer.image.stylize_image`` at 512^2 with the full-width
   model (random weights from a seed), checking the output, the kernel
   launch counts, and agreement with the same weights on the plain path;
5. times: ms per frame of the kernel and plain paths, per dtype.

Each phase prints one line; any failure exits non-zero without the final
result line.  The last line is ``{"ok": true, "device": {...}}``.
"""

import json
import os
import re
import subprocess
import sys
import time

import numpy as np

SIZE = 512
SEED = 0
# The random decoder's output is ~0.03 in 0-255 units; c6 is conv + ReLU,
# so scaling its weight and bias by this gain scales the picture exactly and
# makes the pixel checks meaningful (same weights on both paths).
C6_GAIN = 3000.0

KERNELS = [
    # name, C entry point, source, TPU kernel it replaces, launches/forward
    ("K1 attention_tm", "mhada_attention_fwd",
     "mhada_tpu_torch/csrc/attention_fwd.cu",
     "mhada_tpu/ops/attention_pallas.py:154", 6),
    ("K2 ln_matmul", "mhada_ln_matmul",
     "mhada_tpu_torch/csrc/ln_matmul.cu",
     "mhada_tpu/ops/ln_matmul_pallas.py:44", 12),
    ("K4 mhada_tm", "mhada_mhada_fwd",
     "mhada_tpu_torch/csrc/mhada_fwd.cu",
     "mhada_tpu/ops/mhada_pallas.py:114", 6),
    ("K5 decoder_tail", "mhada_decoder_tail",
     "mhada_tpu_torch/csrc/decoder_tail.cu",
     "mhada_tpu/ops/decoder_tail_pallas.py:546", 1),
]
# Gate bounds on max |kernel - twin| / max |twin|.  float32: the two differ
# only in summation order (TF32 is off), ~1e-6 expected.  bfloat16: both
# round intermediates to bf16 (2^-8 relative) at slightly different points.
REL_BOUND = {"float32": 1e-4, "bfloat16": 3e-2}
# Main-path bound on max |pixel difference| (0-255) against the plain path.
# float32: the repo's reference gate (scripts/reference_gate.py:63); 0.0016
# measured on an H100.  bfloat16: pixels of 128-255 are stored with a
# spacing of 1.0, and 1.19 was measured on an H100, i.e. about two steps.
PIXEL_BOUND = {"float32": 0.1, "bfloat16": 4.0}


def phase(name, ok, detail):
    print(f"[{'PASS' if ok else 'FAIL'}] {name}: {detail}", flush=True)
    return ok


def ptxas_summary(log: str) -> str:
    """'kernel: N regs, S B spill' for each kernel in nvcc's -Xptxas -v log."""
    out, name = [], "?"
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = re.sub(r"^_Z\d+", "", m.group(1))[:40]
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out.append(f"{name}: {m.group(1)} regs")
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m and m.group(1) != "0":
            out.append(f"{name}: {m.group(1)} B spilled")
    return "; ".join(out)


def cuda_ms(fn, warmup=2, iters=5):
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


def gate_inputs(entry, dtype, g):
    """Seeded inputs of one kernel at the 512^2 path's shapes -> (kernel
    call, twin call)."""
    import torch

    from mhada_tpu_torch.ops import (attention_kernel, decoder_tail,
                                     ln_matmul, mhada_kernel)

    dev = "cuda"

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dev, dtype)

    if entry == "mhada_attention_fwd":
        qkv = rnd(1, 4096, 1536)
        return (lambda b: attention_kernel.attention_tm(qkv, 8, backend=b))
    if entry == "mhada_ln_matmul":
        x = rnd(1, 4096, 512)
        lw = (1 + 0.1 * torch.randn(512, generator=g)).to(dev)
        lb = (0.1 * torch.randn(512, generator=g)).to(dev)
        ws = [(torch.randn(f, 512, generator=g) / 512 ** 0.5).to(dev)
              for f in (1536, 2048)]
        bs = [(0.1 * torch.randn(f, generator=g)).to(dev) for f in (1536, 2048)]

        def run(b):
            return torch.cat([ln_matmul.ln_matmul(x, lw, lb, w, bb, backend=b)
                              for w, bb in zip(ws, bs)], dim=-1)
        return run
    if entry == "mhada_mhada_fwd":
        q, k = rnd(1, 4096, 512, scale=0.35), rnd(1, 4096, 512, scale=0.35)
        v, f = rnd(1, 4096, 512), rnd(1, 4096, 512)
        return (lambda b: mhada_kernel.mhada_tm(q, k, v, f, 8, backend=b))
    if entry == "mhada_decoder_tail":
        x = rnd(1, 256, 256, 128).abs()

        def conv(co, ci):
            bound = 1 / (ci * 9) ** 0.5
            w = (torch.rand(co, ci, 3, 3, generator=g) * 2 - 1) * bound
            b = (torch.rand(co, generator=g) * 2 - 1) * bound
            return w.to(dev), b.to(dev)

        (wu, bu), (w5, b5), (w6, b6) = conv(64, 128), conv(64, 64), conv(3, 64)
        return (lambda b: decoder_tail.decoder_tail(
            x, wu, bu, w5, b5, w6, b6, backend=b))
    raise KeyError(entry)


def main() -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import torch

    # ---- 1. environment
    if not torch.cuda.is_available():
        phase("environment", False, "torch.cuda.is_available() is False")
        return 1
    try:
        from mhada_tpu_torch import _build
    except ImportError as e:
        phase("environment", False, f"mhada_tpu_torch not importable: {e}")
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "?"
    phase("environment", True,
          f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 2. build
    t0 = time.perf_counter()
    try:
        lib = _build.build()
    except RuntimeError as e:
        phase("build", False, str(e)[-2000:])
        return 1
    phase("build", True, f"{time.perf_counter() - t0:.1f} s -> {lib.name}; "
          f"ptxas: {ptxas_summary(lib.with_suffix('.log').read_text())}")

    ok = True
    results = {name: {} for name, *_ in KERNELS}

    # ---- 3. per-kernel gates, kernel against twin on the card
    for dname, dtype in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
        for name, entry, *_ in KERNELS:
            g = torch.Generator().manual_seed(SEED)
            try:
                run = gate_inputs(entry, dtype, g)
                with torch.inference_mode():
                    got = run("kernel").float()
                    ref = run("plain").float()
                    torch.cuda.synchronize()
                    err = (got - ref).abs()
                    scale = ref.abs().max().item()
                    mx, mean = err.max().item(), err.mean().item()
                    rel = mx / max(scale, 1e-30)
                    good = bool(torch.isfinite(got).all()) and \
                        rel <= REL_BOUND[dname]
                    ms = cuda_ms(lambda: run("kernel"), 3, 10)
                    plain_ms = cuda_ms(lambda: run("plain"), 3, 10)
            except Exception as e:  # report every kernel, then fail
                ok = phase(f"gate {name} {dname}", False,
                           f"{type(e).__name__}: {e}")
                continue
            results[name][dname] = dict(max_abs_err=mx, mean_abs_err=mean,
                                        ms=ms, plain_ms=plain_ms)
            ok = phase(f"gate {name} {dname}", good,
                       f"max|d| {mx:.3e} mean|d| {mean:.3e} max|ref| "
                       f"{scale:.3e} rel {rel:.3e} (bound "
                       f"{REL_BOUND[dname]:.0e}); kernel {ms:.3f} ms, twin "
                       f"{plain_ms:.3f} ms") and ok

    # ---- 4. the main path at 512^2, full width
    from mhada_tpu_torch.config import ModelConfig
    from mhada_tpu_torch.infer.image import stylize_image
    from mhada_tpu_torch.models import build_models

    def models_for(backend):
        cfg = ModelConfig(mhada_backend=backend)
        m = build_models(cfg, "cuda", torch.Generator().manual_seed(SEED))
        c6 = m["adaFormer"].decoder.c6.conv
        with torch.no_grad():
            c6.weight.mul_(C6_GAIN)
            c6.bias.mul_(C6_GAIN)
        return m

    rng = np.random.default_rng(SEED)
    yy, xx = np.mgrid[0:SIZE, 0:SIZE] / SIZE
    content = np.stack([127.5 + 120 * np.sin(6.3 * (xx + c) * (yy + 1))
                        for c in range(3)], -1)
    content = np.clip(content + rng.normal(0, 8, content.shape), 0, 255)
    style = rng.uniform(0, 255, (SIZE, SIZE, 3))
    content, style = content.astype(np.float32), style.astype(np.float32)

    kmodels, pmodels = models_for("auto"), models_for("plain")
    launches = {}
    for dname, dtype in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
        try:
            _build.reset_launches()
            out = stylize_image(kmodels, content, style, dtype)
            torch.cuda.synchronize()
            counts = dict(_build.LAUNCHES)
            ref = stylize_image(pmodels, content, style, dtype)
        except Exception as e:
            ok = phase(f"main path {dname}", False,
                       f"{type(e).__name__}: {e}")
            continue
        if dname == "float32":
            launches = counts
        want = {entry: n for _, entry, _, _, n in KERNELS}
        dpix = float(np.abs(out - ref).max())
        good = (out.shape == (SIZE, SIZE, 3) and np.isfinite(out).all()
                and out.min() >= 0 and out.max() <= 255
                and counts == want and dpix <= PIXEL_BOUND[dname])
        ok = phase(f"main path {dname}", good,
                   f"out {out.shape} range [{out.min():.2f}, {out.max():.2f}]"
                   f" mean {out.mean():.2f}; plain range [{ref.min():.2f}, "
                   f"{ref.max():.2f}]; max|dpixel| {dpix:.4f} (bound "
                   f"{PIXEL_BOUND[dname]}), mean|dpixel| "
                   f"{float(np.abs(out - ref).mean()):.5f}; launches "
                   f"{counts} (want {want})") and ok

    # ---- 5. times per frame, kernel and plain paths interleaved
    from mhada_tpu_torch.infer.image import make_stylize_fn

    c_t = torch.from_numpy(content)[None].cuda()
    s_t = torch.from_numpy(style)[None].cuda()
    frame_ms = {}
    for dname, dtype in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
        fk = make_stylize_fn(kmodels, dtype)
        fp = make_stylize_fn(pmodels, dtype)
        t = {"kernel": [], "plain": []}
        for path, fn in (("plain", fp), ("kernel", fk), ("kernel", fk),
                         ("plain", fp)):
            t[path].append(cuda_ms(lambda: fn(c_t, s_t), 1, 5))
        frame_ms[dname] = {p: sum(v) / len(v) for p, v in t.items()}
        per_kernel = ", ".join(
            f"{name} {r[dname]['ms']:.3f} vs {r[dname]['plain_ms']:.3f}"
            for name, r in results.items() if dname in r)
        phase(f"times {dname}", True,
              f"ms/frame kernel path {t['kernel']} plain path {t['plain']}; "
              f"ms kernel vs twin: {per_kernel} ({card})")

    summary = []
    for name, entry, source, replaces, _ in KERNELS:
        r32 = results[name].get("float32", {})
        r16 = results[name].get("bfloat16", {})
        summary.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches.get(entry, 0),
            max_abs_err=r32.get("max_abs_err"), ms=r32.get("ms"),
            plain_ms=r32.get("plain_ms"),
            max_abs_err_bf16=r16.get("max_abs_err"), ms_bf16=r16.get("ms"),
            plain_ms_bf16=r16.get("plain_ms")))
    print(json.dumps({"kernels": summary, "frame_ms": frame_ms,
                      "card": card}), flush=True)
    if not ok:
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
