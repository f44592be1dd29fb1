#!/usr/bin/env python3
"""Drive the PyTorch port (mhada_tpu_torch) on one CUDA card, in phases.

    python3 chip_smoke.py        # from the root of the repository

1. environment: torch / CUDA versions, the card's name and power limit;
2. build: compile mhada_tpu_torch/csrc/*.cu with nvcc (one per source, in
   parallel);
3. gates: each hand-written kernel against its plain PyTorch version on the
   card, in float32 and bfloat16, at the 512^2 path's shapes and at the
   1024^2 shapes (K2 at N = 16384; K3 at M = 16384; K5 from 512^2 to
   1024^2; K1 at L = 16384 for the TPU's K9; K4 at N = M = 16384 for the
   TPU's K10), each with its time, the plain
   version's, one PyTorch library call's where one computes the same
   function, and the least time the card could take (its bound);
4. main paths, each driven with the launch counts set to 0 just before it
   and read just after, and held against the plain path on the same
   weights:
   a. the full path ``infer.image.stylize_image`` at 512^2;
   b. the streaming path at 512^2, B = 1: ``precompute_style_kv`` once,
      then one ``make_stylize_with_kv_fn`` frame, also held against (a);
   c. 1024^2: one streaming frame in float32 and bfloat16, one full-path
      frame in float32;
5. times: ms per frame of the kernel and plain paths, interleaved: the full
   path at 512^2; the streaming path at 512^2 with B = 1 and 8 (one B = 8
   batch held against the plain path first); the streaming path at
   1024^2, B = 1, bfloat16.

Each phase prints one line; any failure exits non-zero without the final
result line.  The model is the full-width ``ModelConfig()`` with random
weights from a seed.  The line before the last is the kernels' JSON
summary; the last line is ``{"ok": true, "device": {...}}``.
"""

import json
import os
import re
import subprocess
import sys
import time

import numpy as np

SEED = 0
# The random decoder's output is ~0.03 in 0-255 units; c6 is conv + ReLU,
# so scaling its weight and bias by this gain scales the picture exactly and
# makes the pixel checks meaningful (same weights on both paths).
C6_GAIN = 3000.0

ATTN, LN, K3, K4, TAIL = ("mhada_attention_fwd", "mhada_ln_matmul",
                          "mhada_mhada_prologue", "mhada_mhada_fwd",
                          "mhada_decoder_tail")
SRC = "mhada_tpu_torch/csrc/"
ROWS = [
    # row, C entry point, source, TPU kernel it replaces (pallas_call line)
    ("K1 attention_tm", ATTN, SRC + "attention_fwd.cu",
     "mhada_tpu/ops/attention_pallas.py:154"),
    ("K2 ln_matmul", LN, SRC + "ln_matmul.cu",
     "mhada_tpu/ops/ln_matmul_pallas.py:44"),
    ("K3 mhada_fused_prologue", K3, SRC + "mhada_prologue.cu",
     "mhada_tpu/ops/mhada_pallas.py:239"),
    ("K4 mhada_tm", K4, SRC + "mhada_fwd.cu",
     "mhada_tpu/ops/mhada_pallas.py:114"),
    ("K5 decoder_tail", TAIL, SRC + "decoder_tail.cu",
     "mhada_tpu/ops/decoder_tail_pallas.py:546"),
    ("K9 attention_stream_wide, by K1's kernel", ATTN,
     SRC + "attention_fwd.cu", "mhada_tpu/ops/attention_pallas.py:624"),
    ("K10 mhada streaming forward, by K4's kernel", K4,
     SRC + "mhada_fwd.cu", "mhada_tpu/ops/mhada_pallas.py:622"),
]
# gate -> (its row, kind of inputs, token count); the first gate of a row
# fills the row.
GATES = [
    ("K1 L=4096", "K1 attention_tm", "attention", 4096),
    ("K2 N=4096", "K2 ln_matmul", "ln_matmul", 4096),
    ("K3 N=M=4096", "K3 mhada_fused_prologue", "prologue", 4096),
    ("K4 N=M=4096", "K4 mhada_tm", "mhada", 4096),
    ("K5 256^2->512^2", "K5 decoder_tail", "tail", 256),
    ("K2 N=16384", "K2 ln_matmul", "ln_matmul", 16384),
    ("K3 N=M=16384", "K3 mhada_fused_prologue", "prologue", 16384),
    ("K5 512^2->1024^2", "K5 decoder_tail", "tail", 512),
    ("K1 L=16384", "K9 attention_stream_wide, by K1's kernel", "attention",
     16384),
    ("K4 N=M=16384", "K10 mhada streaming forward, by K4's kernel", "mhada",
     16384),
]
# Launches of each path (C entry point -> count).
FULL = {ATTN: 6, LN: 12, K3: 0, K4: 6, TAIL: 1}
STYLE = {ATTN: 3, LN: 6, K3: 0, K4: 0, TAIL: 0}   # encode + precompute K/V
FRAME = {ATTN: 3, LN: 6, K3: 6, K4: 0, TAIL: 1}   # one streaming frame
# Gate bounds on max |kernel - plain| / max |plain|.  float32: the two
# differ only in summation order (TF32 is off), ~1e-6 expected.  bfloat16:
# both round intermediates to bf16 (2^-8 relative) at different points.
REL_BOUND = {"float32": 1e-4, "bfloat16": 3e-2}
# Main-path bound on max |pixel difference| (0-255) against the plain path.
# float32: the repo's reference gate (scripts/reference_gate.py:63); 0.0016
# measured on an H100.  bfloat16: pixels of 128-255 are stored with a
# spacing of 1.0, and 1.19 was measured on an H100, i.e. about two steps.
PIXEL_BOUND = {"float32": 0.1, "bfloat16": 4.0}
# Published peaks of one H100 SXM (dense): float32 on the CUDA cores, bf16
# on the tensor cores, HBM3 bandwidth.  They assume a 700 W power limit.
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12
DTYPE_NAMES = ("float32", "bfloat16")


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


def bound(flops, nbytes, dname):
    """(least ms the card could take, the resource that sets it)."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dname], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def gate_inputs(kind, n, dtype, g):
    """Seeded inputs of one kernel at ``n`` tokens (K5: an n x n input) ->
    (call(backend), flops, bytes moved, one library call or None).

    Bytes count each input read once and each output written once; flops
    count the products (and the projection of K3)."""
    import torch
    import torch.nn.functional as F

    from mhada_tpu_torch.ops import (attention_kernel, decoder_tail,
                                     ln_matmul, mhada_kernel, mhada_prologue)
    from mhada_tpu_torch.ops.instance_norm import instance_norm_stats

    dev, c, heads = "cuda", 512, 8
    es = torch.tensor([], dtype=dtype).element_size()

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dev, dtype)

    if kind == "attention":
        qkv = rnd(1, n, 3 * c)

        def sdpa():
            q, k, v = (t.unflatten(-1, (heads, 64)).transpose(1, 2)
                       for t in qkv.split(c, dim=-1))
            return F.scaled_dot_product_attention(q, k, v)

        return (lambda b: attention_kernel.attention_tm(qkv, heads, backend=b),
                4 * n * n * c, 4 * n * c * es, sdpa)
    if kind == "ln_matmul":
        x = rnd(1, n, c)
        lw = (1 + 0.1 * torch.randn(c, generator=g)).to(dev)
        lb = (0.1 * torch.randn(c, generator=g)).to(dev)
        fs = (1536, 2048)
        ws = [(torch.randn(f, c, generator=g) / c ** 0.5).to(dev) for f in fs]
        bs = [(0.1 * torch.randn(f, generator=g)).to(dev) for f in fs]

        def run(b):
            return torch.cat([ln_matmul.ln_matmul(x, lw, lb, w, bb, backend=b)
                              for w, bb in zip(ws, bs)], dim=-1)
        return (run, sum(2 * n * c * f for f in fs),
                sum((n * c + f * c + n * f) * es + (2 * c + f) * 4
                    for f in fs), None)
    if kind == "prologue":
        fc, fcs = rnd(1, n, c, scale=2.0) + 1, rnd(1, n, c, scale=3.0) - 1
        mc, rc = instance_norm_stats(fc)
        ms, rs = instance_norm_stats(fcs)
        stats = torch.stack([mc, rc, ms, rs], 1)
        # the block's init U(-1/8, 1/8); k at scale 0.35: logit std ~1.6
        wf = ((torch.rand(heads, 64, 64, generator=g) * 2 - 1) / 8).to(dev)
        fb = ((torch.rand(heads, 64, generator=g) * 2 - 1) / 8).to(dev)
        k, v = rnd(1, n, c, scale=0.35), rnd(1, n, c)
        return (lambda b: mhada_prologue.mhada_fused_prologue(
            fc, fcs, stats, wf, fb, k, v, backend=b),
            6 * n * n * c + 2 * n * c * 64,
            5 * n * c * es + 4 * c * 4 + heads * 64 * (64 * es + 4), None)
    if kind == "mhada":
        q, k = rnd(1, n, c, scale=0.35), rnd(1, n, c, scale=0.35)
        v, f = rnd(1, n, c), rnd(1, n, c)
        return (lambda b: mhada_kernel.mhada_tm(q, k, v, f, heads, backend=b),
                6 * n * n * c, 5 * n * c * es, None)
    if kind == "tail":
        x = rnd(1, n, n, 128).abs()

        def conv(co, ci):
            bound = 1 / (ci * 9) ** 0.5
            w = (torch.rand(co, ci, 3, 3, generator=g) * 2 - 1) * bound
            b = (torch.rand(co, generator=g) * 2 - 1) * bound
            return w.to(dev), b.to(dev)

        (wu, bu), (w5, b5), (w6, b6) = conv(64, 128), conv(64, 64), conv(3, 64)
        hi = (2 * n) ** 2
        flops = 2 * 9 * (n * n * 128 * 64 + hi * 64 * 64 + hi * 64 * 3)
        nbytes = (n * n * 128 + hi * 3) * es + 9 * 64 * (128 + 64 + 3) * es
        return (lambda b: decoder_tail.decoder_tail(
            x, wu, bu, w5, b5, w6, b6, backend=b), flops, nbytes, None)
    raise KeyError(kind)


def run_gate(gate, kind, n, dname, card):
    """Kernel against plain on the same seeded inputs -> (ok, record)."""
    import torch

    dtype = getattr(torch, dname)
    g = torch.Generator().manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats()
    run, flops, nbytes, lib = gate_inputs(kind, n, dtype, g)
    reps = (3, 10) if n <= 4096 else (1, 3)
    with torch.inference_mode():
        got = run("kernel").float()
        ref = run("plain").float()
        torch.cuda.synchronize()
        err = (got - ref).abs()
        scale = ref.abs().max().item()
        mx, mean = err.max().item(), err.mean().item()
        rel = mx / max(scale, 1e-30)
        good = bool(torch.isfinite(got).all()) and rel <= REL_BOUND[dname]
        del got, ref, err
        ms = cuda_ms(lambda: run("kernel"), *reps)
        plain_ms = cuda_ms(lambda: run("plain"), *reps)
        library_ms = cuda_ms(lib, *reps) if lib else None
    bound_ms, bound_by = bound(flops, nbytes, dname)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.empty_cache()
    rec = dict(max_abs_err=mx, mean_abs_err=mean, ms=ms, plain_ms=plain_ms,
               bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
               gflop=flops / 1e9, mbytes=nbytes / 1e6)
    lib_txt = f"{library_ms:.3f} ms" if lib else "none (no single call)"
    return phase(
        f"gate {gate} {dname}", good,
        f"max|d| {mx:.3e} mean|d| {mean:.3e} max|ref| {scale:.3e} rel "
        f"{rel:.3e} (bound {REL_BOUND[dname]:.0e}); kernel {ms:.3f} ms, "
        f"plain {plain_ms:.3f} ms, library {lib_txt}, card bound "
        f"{bound_ms:.3f} ms ({bound_by}; {flops / 1e9:.1f} GFLOP, "
        f"{nbytes / 1e6:.1f} MB at the published 700 W peaks; this card: "
        f"{card}); peak memory {peak_gb:.2f} GB"), rec


def test_images(size, rng):
    """A smooth content picture with noise and a noise style, HWC 0-255."""
    yy, xx = np.mgrid[0:size, 0:size] / size
    content = np.stack([127.5 + 120 * np.sin(6.3 * (xx + c) * (yy + 1))
                        for c in range(3)], -1)
    content = np.clip(content + rng.normal(0, 8, content.shape), 0, 255)
    style = rng.uniform(0, 255, (size, size, 3))
    return content.astype(np.float32), style.astype(np.float32)


def main() -> int:
    t_start = time.perf_counter()
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
    gates = {}   # gate -> dtype name -> record

    # ---- 3. per-kernel gates, kernel against plain on the card
    for gate, _, kind, n in GATES:
        for dname in DTYPE_NAMES:
            try:
                good, rec = run_gate(gate, kind, n, dname, card)
            except Exception as e:  # report every kernel, then fail
                ok = phase(f"gate {gate} {dname}", False,
                           f"{type(e).__name__}: {e}")
                continue
            gates.setdefault(gate, {})[dname] = rec
            ok = good and ok

    # ---- 4. the main paths, full width
    from mhada_tpu_torch.config import ModelConfig
    from mhada_tpu_torch.infer.image import (make_encode_style_fn,
                                             make_stylize_fn,
                                             make_stylize_with_kv_fn,
                                             precompute_style_kv,
                                             stylize_image)
    from mhada_tpu_torch.models import build_models

    def models_for(backend):
        cfg = ModelConfig(mhada_backend=backend)
        m = build_models(cfg, "cuda", torch.Generator().manual_seed(SEED))
        c6 = m["adaFormer"].decoder.c6.conv
        with torch.no_grad():
            c6.weight.mul_(C6_GAIN)
            c6.bias.mul_(C6_GAIN)
        return m

    def counted(fn):
        """(fn(), the launches it made): counts set to 0 just before."""
        _build.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        return out, dict(_build.LAUNCHES)

    def to_dev(a):
        return torch.from_numpy(a)[None].cuda()

    def to_np(x):
        """A batch of frames as BHWC numpy (stylize_image gives one HWC)."""
        return x.cpu().numpy() if isinstance(x, torch.Tensor) else x[None]

    def style_kv(models, style, dtype):
        return precompute_style_kv(models,
                                   make_encode_style_fn(models, dtype)(style))

    def check_image(out, ref, shape, dname, counts, want):
        dpix = float(np.abs(out - ref).max())
        good = (out.shape == shape and np.isfinite(out).all()
                and out.min() >= 0 and out.max() <= 255
                and counts == want and dpix <= PIXEL_BOUND[dname])
        return good, (f"out {out.shape} range [{out.min():.2f}, "
                      f"{out.max():.2f}] mean {out.mean():.2f}; ref range "
                      f"[{ref.min():.2f}, {ref.max():.2f}]; max|dpixel| "
                      f"{dpix:.4f} (bound {PIXEL_BOUND[dname]}), mean|dpixel|"
                      f" {float(np.abs(out - ref).mean()):.5f}; launches "
                      f"{counts} (want {want})")

    def drive(label, shape, dname, want, kernel_fn, plain_fn):
        """One main-path run on the kernels, counted, against the plain
        path -> (ok, kernel output as BHWC numpy, launch counts)."""
        try:
            out, counts = counted(kernel_fn)
            out, ref = to_np(out), to_np(plain_fn())
        except Exception as e:
            return phase(label, False, f"{type(e).__name__}: {e}"), None, {}
        good, detail = check_image(out, ref, shape, dname, counts, want)
        return phase(label, good, detail), out, counts

    rng = np.random.default_rng(SEED)
    content, style = test_images(512, rng)
    c_t, s_t = to_dev(content), to_dev(style)
    kmodels, pmodels = models_for("auto"), models_for("plain")
    launches = {}   # path -> launch counts of its float32 run
    for dname in DTYPE_NAMES:
        dtype = getattr(torch, dname)
        # a. the full path at 512^2 (style re-encoded)
        good, full_out, counts = drive(
            f"main path {dname}", (1, 512, 512, 3), dname, FULL,
            lambda: stylize_image(kmodels, content, style, dtype),
            lambda: stylize_image(pmodels, content, style, dtype))
        ok = good and ok
        launches.setdefault("full512", counts)
        # b. the streaming path at 512^2, B = 1: the style work once (its
        #    launches counted apart), then one frame
        try:
            kv, setup = counted(lambda: style_kv(kmodels, s_t, dtype))
        except Exception as e:
            ok = phase(f"style setup {dname}", False,
                       f"{type(e).__name__}: {e}")
            continue
        ok = phase(f"style setup {dname}", setup == STYLE,
                   f"launches {setup} (want {STYLE})") and ok
        good, out, counts = drive(
            f"streaming path {dname}", (1, 512, 512, 3), dname, FRAME,
            lambda: make_stylize_with_kv_fn(kmodels, dtype)(c_t, kv),
            lambda: make_stylize_with_kv_fn(pmodels, dtype)(
                c_t, style_kv(pmodels, s_t, dtype)))
        ok = good and ok
        launches.setdefault("stream512", counts)
        if out is not None and full_out is not None:
            good, detail = check_image(out, full_out, (1, 512, 512, 3),
                                       dname, counts, FRAME)
            ok = phase(f"streaming vs full path {dname}", good,
                       detail) and ok
        del kv

    # c. 1024^2: one streaming frame per dtype, one full-path frame (f32)
    f32 = torch.float32
    content1k, style1k = test_images(1024, rng)
    c1k, s1k = to_dev(content1k), to_dev(style1k)
    for dname in DTYPE_NAMES:
        dtype = getattr(torch, dname)
        kv1k = style_kv(kmodels, s1k, dtype)
        good, _, counts = drive(
            f"streaming path 1024^2 {dname}", (1, 1024, 1024, 3), dname,
            FRAME, lambda: make_stylize_with_kv_fn(kmodels, dtype)(c1k, kv1k),
            lambda: make_stylize_with_kv_fn(pmodels, dtype)(
                c1k, style_kv(pmodels, s1k, dtype)))
        ok = good and ok
        launches.setdefault("stream1024", counts)
        del kv1k
    good, _, launches["full1024"] = drive(
        "full path 1024^2 float32", (1, 1024, 1024, 3), "float32", FULL,
        lambda: make_stylize_fn(kmodels, f32)(c1k, s1k),
        lambda: make_stylize_fn(pmodels, f32)(c1k, s1k))
    ok = good and ok
    torch.cuda.empty_cache()

    # ---- 5. times per frame, kernel and plain paths interleaved
    frame_ms = {}

    def interleaved(key, dname, fk, fp, batch, reps=(1, 5)):
        t = {"kernel": [], "plain": []}
        for path, fn in (("plain", fp), ("kernel", fk), ("kernel", fk),
                         ("plain", fp)):
            t[path].append(cuda_ms(fn, *reps) / batch)
        frame_ms.setdefault(key, {})[dname] = {
            p: sum(v) / len(v) for p, v in t.items()}
        phase(f"times {key} {dname}", True,
              f"ms/frame kernel path {t['kernel']} plain path {t['plain']} "
              f"({card})")

    frames8 = torch.from_numpy(
        rng.uniform(0, 255, (8, 512, 512, 3)).astype(np.float32)).cuda()
    for dname in DTYPE_NAMES:
        dtype = getattr(torch, dname)
        fk, fp = make_stylize_fn(kmodels, dtype), make_stylize_fn(pmodels,
                                                                   dtype)
        interleaved("full512_b1", dname, lambda: fk(c_t, s_t),
                    lambda: fp(c_t, s_t), 1)
        # the style K/V tiled for a batch of frames (bench.py:664-668)
        kv_k, kv_p = (style_kv(m, s_t, dtype) for m in (kmodels, pmodels))
        kv8_k, kv8_p = ([(k.repeat(8, 1, 1), v.repeat(8, 1, 1))
                         for k, v in kv] for kv in (kv_k, kv_p))
        sk, sp = (make_stylize_with_kv_fn(m, dtype)
                  for m in (kmodels, pmodels))
        interleaved("stream512_b1", dname, lambda: sk(c_t, kv_k),
                    lambda: sp(c_t, kv_p), 1)
        good, _, launches[f"stream512_b8_{dname}"] = drive(
            f"streaming path B=8 {dname}", (8, 512, 512, 3), dname, FRAME,
            lambda: sk(frames8, kv8_k), lambda: sp(frames8, kv8_p))
        ok = good and ok
        interleaved("stream512_b8", dname, lambda: sk(frames8, kv8_k),
                    lambda: sp(frames8, kv8_p), 8)
        del kv_k, kv_p, kv8_k, kv8_p
    bf = torch.bfloat16
    kv_k, kv_p = (style_kv(m, s1k, bf) for m in (kmodels, pmodels))
    sk, sp = (make_stylize_with_kv_fn(m, bf) for m in (kmodels, pmodels))
    interleaved("stream1024_b1", "bfloat16", lambda: sk(c1k, kv_k),
                lambda: sp(c1k, kv_p), 1, reps=(1, 3))

    # ---- the kernels' summary: one row per TPU kernel the path replaces
    path_of = {"K1": "full512", "K2": "full512", "K3": "stream512",
               "K4": "full512", "K5": "full512", "K9": "stream1024",
               "K10": "full1024"}
    first_gate = {}
    for gate, row, *_ in GATES:
        first_gate.setdefault(row, gate)
    summary = []
    for name, entry, source, replaces in ROWS:
        first = first_gate[name]
        rec = gates.get(first, {})
        r32, r16 = rec.get("float32", {}), rec.get("bfloat16", {})
        row = dict(name=name, route="cuda", source=source,
                   replaces=replaces, gate=first,
                   launches=launches.get(path_of[name.split()[0]], {})
                   .get(entry, 0))
        for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms"):
            row[key] = r32.get(key)
            row[key + "_bf16"] = r16.get(key)
        if row["library_ms"] is None:
            row["library"] = "no single PyTorch call computes this function"
        else:
            row["library"] = "torch.nn.functional.scaled_dot_product_attention"
        summary.append(row)
    extra = {g: gates.get(g) for g, *_ in GATES
             if g not in first_gate.values()}
    seconds = time.perf_counter() - t_start
    phase("run time", True, f"{seconds:.1f} s from start to summary")
    print(json.dumps({"kernels": summary, "extra_gates": extra,
                      "launches": launches, "frame_ms": frame_ms,
                      "card": card, "seconds": seconds}), flush=True)
    if not ok:
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
