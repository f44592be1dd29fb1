"""P1, K14, K13, the float32 tail, K1, K6's forward, K1's cross form, K3,
K4, K7, K6's backward, K2 and the bf16 frames against another checkout's
builds of them, on one card, in turns: the time a redesign saves (or a
change of a kernel's arguments costs), measured in one call.

    python -m mhada_tpu_torch.probes.redesign_ab --other DIR [--rounds 2]
        [--groups P1 K14 K13 tail K1 K1x mhada K7 K6b K2 frames]

DIR is the root of another checkout of the repository (for example the
parent commit, unpacked with ``git archive``).  Each side runs in a process
of its own with its own checkout first on ``sys.path``, so each builds and
launches its own kernels from its own ``csrc/``, and times, with CUDA
events:

- P1 (``probes.mm_probe.mm``, 100 products a launch, as ``chip_smoke.py``'s
  P1 gates) at the probe's 8 shapes, bfloat16;
- K14's three launches on weights already in the kernel's layout
  (``ops.decoder_mid._kernel``, ``chip_smoke.py``'s "kernel alone") at its
  gate shapes (128^2 with B = 1 and 8, 256^2; C = 256), float32 and
  bfloat16;
- K13's launch on weights already in the kernel's layout (the C entry
  ``mhada_decoder_c6``, whose arguments no redesign changed) at its gate
  shapes (512^2 with B = 1 and 8, 1024^2, 256 x 512 with B = 8, 264 x
  488), float32 and bfloat16;
- the decoder tail (K5, ``ops.decoder_tail.decoder_tail``, and K8's
  forward, ``decoder_tail_train``, weights cast per call as the paths
  call them): float32, whose direct conv K14's float32 build shares, at K5
  from 256^2 to 512^2 (B = 1) and K8 from 128^2 to 256^2 (B = 8),
  ``chip_smoke.py``'s K5 and K8 gate shapes; bfloat16 at those and at K5
  from 512^2 to 1024^2, K8 from 256^2 to 512^2 (B = 4) and K5 at the video
  CLI's 128 x 256 (B = 8), as wall ms and as device ms of the tail's
  kernels, beside a library chain that the port never calls (reflect pad
  and F.conv2d three times with F.interpolate's 2x bilinear after the
  first, channels-last bf16 on cuDNN: no single call computes the tail),
  wall and device ms of every kernel it launches;
- K1 (``ops.attention_kernel.attention_tm``) and K6's forward
  (``ops.attention_train.fwd_launch``; ``_fwd_kernel`` in a checkout that
  predates it), which share the attention tiles
  with K1's cross form (float32 attention_f32_kernel, bfloat16 the wgmma +
  TMA tile), at their gate shapes: K1 at B = 1, L = 4096 (the 512^2 frame)
  and 16384 (1024^2), K6's forward at B = 1, L = 4096, B = 8, L = 1024
  (the 256^2 step), B = 4, L = 4096 (512^2) and B = 1, L = 16384, float32
  and bfloat16, each at its wrapper's default split, as wall ms and as
  device ms (the tile and the combine);
- K1's cross form (``ops.attention_kernel.attention_cross``, q the first C
  columns of a packed qkv) at its sequence-parallel gate shapes (B = 1, 8
  heads: 1024 and 2048 queries against 4096 keys, 4096 against 16384),
  float32 and bfloat16, as wall ms of back-to-back calls and as device ms
  (the call's kernels, torch.profiler, from a window that recorded every
  launch; the wrapper's host work paces the calls below ~0.06 ms);
- K3 (``ops.mhada_prologue.mhada_fused_prologue`` on P2's probe inputs)
  and K4 (``ops.mhada_kernel.mhada_tm``) at bfloat16, B = 1, N = M = 4096
  (the 512^2 frame) and 16384 (1024^2), and K3 at B = 8, 4096 (P2's
  shape), each at its wrapper's default split, as wall ms and as device ms
  of the MHAda kernels (names holding "mhada"; K3's wrapper also casts fb
  per call, which is left out);
- K7 at bfloat16, its forward (``ops.mhada_train.fwd_launch``, or
  ``_fwd_kernel`` in a checkout that predates it, at its default split)
  and its backward (``_bwd_kernel`` on the plain forward's residuals and
  the elementwise prologue's dM1, dE2 and delta) at its
  training gates' shapes (B = 8, N = M = 1024; B = 4, 4096; B = 1, 16384;
  B = 2, 2048 x 1024; 8 heads), as wall ms and as device ms of the MHAda
  kernels (the tile and the combine; the dK/dV and dQ kernels), beside
  SDPA on [V | V^2] with scale 1 (its forward, and the backward of that
  call, the square and the concatenation through torch.autograd.grad from
  [dM1 | dE2]: chip_smoke.py's K7 yardsticks), device ms of every kernel
  the call launches;
- K6's backward at bfloat16 (``ops.attention_train._bwd_kernel`` on the
  plain forward's lse and the wrapper's delta, scale 1/8) at its training
  gates' shapes (B = 8, L = 1024; B = 4, 4096; B = 1, 16384; B = 2, 2048;
  8 heads), at inversion's B = 1, 1024 and at the TP share (4 heads: B =
  4, 1024 and B = 1, 2048), as wall ms and as device ms, whole and of its
  dK/dV and dQ kernels apart, beside SDPA's backward on the same packed
  qkv (torch.autograd.grad of that call into the packed qkv), its forward
  on the flash backend and on the backend PyTorch picks (chip_smoke.py's K6
  yardstick), wall ms and device ms of every kernel the call launches;
- K2 at bfloat16, the kernel alone (``ops.ln_matmul._ln_matmul_kernel`` on
  inputs already in bf16, chip_smoke.py's "kernel alone") on the ViT's
  pair of widths at its gate shapes (1536 + 2048 at 4096 and 16384 rows
  and at the fused-LN step's 8192; the TP share's 768 + 1024 at 4096), as
  wall ms and as device ms (the kernels named ln_matmul), beside the
  library chain (``F.layer_norm`` + ``F.linear`` per width), wall and
  device ms of every kernel it launches;
- the bf16 frames of ``chip_smoke.py``'s phase 5 on full-width models from
  seed 0: the full path at 512^2, B = 1, the streaming path at 512^2, B =
  1 and 8 (ms a frame), and at 1024^2, B = 1.

``--groups`` runs only the named groups (all by default).

The sides run as other, this, this, other, repeated ``--rounds`` / 2
times.  Prints the card's name and power limit, then one JSON line per
measurement with each side's ms in the order run.  Card only.

This file imports nothing of the package at its top, so that a worker can
put the other checkout's package first on ``sys.path``.
"""

import argparse
import functools
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
MM_REPS = 100
# (side, batch) of K14's gates in chip_smoke.py
MID_SHAPES = [(128, 1), (128, 8), (256, 1)]
MID_C = 256
# (kernel, batch, low-res side or (height, width)) of the tail: K5's and
# K8's gates in chip_smoke.py, bfloat16 also the 1024^2 frame, the 512^2
# step and the video CLI's 256 x 512 frame at --chunk 8
TAIL_SHAPES = {"float32": [("K5", 1, 256), ("K8", 8, 128)],
               "bfloat16": [("K5", 1, 256), ("K8", 8, 128), ("K5", 1, 512),
                            ("K8", 4, 256), ("K5", 8, (128, 256))]}
# (kernel, batch, tokens) of K1's and K6's forward's gates in chip_smoke.py
SELF_SHAPES = [("K1", 1, 4096), ("K1", 1, 16384), ("K6 forward", 1, 4096),
               ("K6 forward", 8, 1024), ("K6 forward", 4, 4096),
               ("K6 forward", 1, 16384)]
# (queries, keys) of K1's cross form's gates in chip_smoke.py
CROSS_SHAPES = [(1024, 4096), (2048, 4096), (4096, 16384)]
# (height, width, batch) of K13's gates in chip_smoke.py
C6_SHAPES = [(512, 512, 1), (512, 512, 8), (1024, 1024, 1), (256, 512, 8),
             (264, 488, 1)]
# (kernel, batch, tokens) of K3's and K4's gates in chip_smoke.py
MHADA_SHAPES = [("K3", 1, 4096), ("K4", 1, 4096), ("K3", 1, 16384),
                ("K4", 1, 16384), ("K3", 8, 4096)]
# (batch, queries, keys) of K7's training gates in chip_smoke.py
K7_SHAPES = [(8, 1024, 1024), (4, 4096, 4096), (1, 16384, 16384),
             (2, 2048, 1024)]
# (batch, tokens, heads) of K6's backward: its training gates' shapes in
# chip_smoke.py, inversion's B = 1 at 1024 tokens and the TP share
K6B_SHAPES = [(8, 1024, 8), (4, 4096, 8), (1, 16384, 8), (2, 2048, 8),
              (1, 1024, 8), (4, 1024, 4), (1, 2048, 4)]
# (rows, output widths) of K2's gates in chip_smoke.py
K2_SHAPES = [(4096, (1536, 2048)), (16384, (1536, 2048)),
             (8192, (1536, 2048)), (4096, (768, 1024))]
GROUPS = ("P1", "K14", "K13", "tail", "K1", "K1x", "mhada", "K7", "K6b",
          "K2", "frames")


def _cuda_ms(fn, warmup=3, iters=10):
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


def device_ms(fn, iters=10, windows=6, only=None):
    """Device ms per call of ``fn``, which launches each of its kernels a
    fixed number of times: their time from torch.profiler (only the kernels
    whose names hold ``only``, if given).  A window in which some kernel's
    count is not a multiple of ``iters`` (CUPTI has dropped events on an
    H100) is profiled again, up to ``windows`` windows -> NaN if none was
    whole."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.self_device_time_total > 0
                   and (only is None or only in e.key)]
        if kernels and all(e.count % iters == 0 for e in kernels):
            return sum(e.self_device_time_total for e in kernels) \
                / 1e3 / iters
    return float("nan")


def worker(root: str, groups=GROUPS) -> dict:
    """Times of the checkout at ``root`` in ``groups``: key -> ms."""
    sys.path.insert(0, root)
    import torch

    from mhada_tpu_torch import _build
    from mhada_tpu_torch.ops import (attention_kernel, attention_train,
                                     decoder_mid)
    from mhada_tpu_torch.probes import mm_probe

    if not Path(mm_probe.__file__).resolve().is_relative_to(Path(root)):
        raise RuntimeError(f"imported {mm_probe.__file__}, not {root}'s")
    if not torch.cuda.is_available():
        raise RuntimeError("redesign_ab times the kernels: it needs the card")
    out = {}
    with torch.inference_mode():
        for m, k, n in mm_probe.SHAPES if "P1" in groups else ():
            a, b = mm_probe.operands(m, k, n, "cuda")
            out[f"P1 {m}x{k}x{n}"] = _cuda_ms(
                lambda: mm_probe.mm(a, b, MM_REPS))
        g = torch.Generator().manual_seed(0)
        for dtype in (torch.float32, torch.bfloat16) if "K14" in groups \
                else ():
            bound = 1 / (MID_C * 9) ** 0.5
            ws = [(torch.rand(MID_C, MID_C, 3, 3, generator=g) * 2 - 1)
                  * bound for _ in range(3)]
            bs = [(torch.rand(MID_C, generator=g) * 2 - 1) * bound
                  for _ in range(3)]
            hwio, bias = decoder_mid.kernel_params(
                [w.cuda() for w in ws], [b.cuda() for b in bs], dtype)
            for side, batch in MID_SHAPES:
                x = torch.rand(batch, side, side, MID_C, generator=g).to(
                    "cuda", dtype)
                out[f"K14 {side}^2 B={batch} {str(dtype)[6:]}"] = _cuda_ms(
                    lambda: decoder_mid._kernel(x, hwio, bias))
                del x
            torch.cuda.empty_cache()
        for dtype in (torch.float32, torch.bfloat16) if "K13" in groups \
                else ():
            w6 = ((torch.rand(3, 64, 3, 3, generator=g) * 2 - 1) / 24).cuda()
            hwio = w6.to(dtype).permute(2, 3, 1, 0).contiguous()
            bias = ((torch.rand(3, generator=g) * 2 - 1) / 24).cuda()
            code = _build.dtype_code(hwio)
            for h, w, batch in C6_SHAPES:
                y = torch.rand(batch, h, w, 64, generator=g).to("cuda", dtype)
                o = y.new_empty((batch, h, w, 3))
                out[f"K13 {h}x{w} B={batch} {str(dtype)[6:]}"] = _cuda_ms(
                    lambda: _build.launch("mhada_decoder_c6", y.device, y,
                                          hwio, bias, o, batch, h, w, code))
                del y, o
            torch.cuda.empty_cache()
        for dname, shapes in TAIL_SHAPES.items() if "tail" in groups \
                else ():
            for name, batch, side in shapes:
                out.update(_tail_times(name, batch, side, dname, g))
            torch.cuda.empty_cache()
        for dtype in (torch.float32, torch.bfloat16) \
                if {"K1", "K1x"} & set(groups) else ():
            k6_fwd = getattr(attention_train, "fwd_launch", None) \
                or attention_train._fwd_kernel
            for kind, batch, n in SELF_SHAPES if "K1" in groups else ():
                qkv = torch.randn(batch, n, 1536, generator=g).to("cuda",
                                                                  dtype)

                def self_call(kind=kind, qkv=qkv):
                    if kind == "K1":
                        return attention_kernel.attention_tm(qkv, 8)
                    return k6_fwd(qkv, 8, 0.125)

                key = f"{kind} L={n} B={batch} {str(dtype)[6:]}"
                out[key] = _cuda_ms(self_call)
                out[key + " device"] = device_ms(self_call)
                del qkv
                torch.cuda.empty_cache()
            for n, m in CROSS_SHAPES if "K1x" in groups else ():
                qkv = torch.randn(1, n, 1536, generator=g).to("cuda", dtype)
                kv = torch.randn(1, m, 1024, generator=g).to("cuda", dtype)

                def cross():
                    return attention_kernel.attention_cross(
                        qkv[..., :512], kv, 8)

                key = f"K1x {n}x{m} B=1 {str(dtype)[6:]}"
                out[key] = _cuda_ms(cross)
                out[key + " device"] = device_ms(cross)
                del qkv, kv
        for kind, batch, n in MHADA_SHAPES if "mhada" in groups else ():
            call = _mhada_call(kind, batch, n)
            key = f"{kind} N=M={n} B={batch} bfloat16"
            out[key] = _cuda_ms(call)
            out[key + " device"] = device_ms(call, only="mhada")
            del call
            torch.cuda.empty_cache()
        for rows, widths in K2_SHAPES if "K2" in groups else ():
            kernel, chain = _k2_calls(rows, widths)
            key = f"K2 N={rows} F={'+'.join(map(str, widths))} bfloat16"
            out[key] = _cuda_ms(kernel)
            out[key + " device"] = device_ms(kernel, only="ln_matmul")
            out[key + " chain"] = _cuda_ms(chain)
            out[key + " chain device"] = device_ms(chain)
            del kernel, chain
            torch.cuda.empty_cache()
    # outside inference mode: SDPA's backward needs a graph
    for batch, n, m in K7_SHAPES if "K7" in groups else ():
        for part, (call, only) in _k7_calls(batch, n, m).items():
            key = f"K7 {part} N={n} M={m} B={batch} bfloat16"
            out[key] = _cuda_ms(call)
            out[key + " device"] = device_ms(call, only=only)
        torch.cuda.empty_cache()
    for batch, n, heads in K6B_SHAPES if "K6b" in groups else ():
        kernel, sdpa = _k6b_calls(batch, n, heads)
        key = f"K6b backward L={n} B={batch} heads={heads} bfloat16"
        out[key] = _cuda_ms(kernel)
        out[key + " device"] = device_ms(kernel)
        for part in ("dkv_kernel", "dq_kernel"):
            out[f"{key} {part} device"] = device_ms(kernel, only=part)
        for name, call in sdpa.items():
            out[f"{key} {name}"] = _cuda_ms(call)
            out[f"{key} {name} device"] = device_ms(call)
        del kernel, sdpa
        torch.cuda.empty_cache()
    if "frames" in groups:
        out.update(_frames())
    return out


def _tail_times(name, batch, side, dname, g) -> dict:
    """K5 or K8's forward on seeded inputs at the conv init scale -> {key:
    ms}: wall ms of the wrapper; at bfloat16 also its kernels' device ms
    and the library chain's wall and device ms."""
    import torch
    import torch.nn.functional as F

    from mhada_tpu_torch.ops import decoder_tail

    dtype = getattr(torch, dname)
    h, w = (side, side) if isinstance(side, int) else side
    x = torch.rand(batch, h, w, 128, generator=g).to("cuda", dtype)
    ws = [((torch.rand(shape, generator=g) * 2 - 1) / 24).cuda()
          for shape in ((64, 128, 3, 3), (64,), (64, 64, 3, 3), (64,),
                        (3, 64, 3, 3), (3,))]
    fn = decoder_tail.decoder_tail if name == "K5" \
        else decoder_tail.decoder_tail_train
    size = f"{side}^2" if isinstance(side, int) else f"{h}x{w}"
    key = f"{name} {size} B={batch} {dname}"
    out = {key: _cuda_ms(lambda: fn(x, *ws))}
    if dname == "float32":
        return out
    out[key + " device"] = device_ms(lambda: fn(x, *ws), only="tail")
    # the chain, channels-last (x is NHWC: its NCHW view is channels-last)
    xc = x.permute(0, 3, 1, 2)
    wc = [t.to(dtype).contiguous(memory_format=torch.channels_last)
          if t.dim() == 4 else t.to(dtype) for t in ws]

    def conv(t, i):
        return F.relu(F.conv2d(F.pad(t, (1, 1, 1, 1), mode="reflect"),
                               wc[2 * i], wc[2 * i + 1]))

    def chain():
        up = F.interpolate(conv(xc, 0), scale_factor=2, mode="bilinear",
                           align_corners=False)
        return conv(conv(up, 1), 2)

    out[key + " chain"] = _cuda_ms(chain)
    out[key + " chain device"] = device_ms(chain)
    return out


def _mhada_call(kind, batch, n):
    """K3, K4 or K7's forward at bf16 on seeded inputs, 8 heads of 64 ->
    call()."""
    import torch

    from mhada_tpu_torch.ops import mhada_kernel, mhada_prologue, mhada_train
    from mhada_tpu_torch.probes.mhada_pipe_probe import probe_inputs

    if kind == "K3":
        x = probe_inputs(batch, n, n, 512, 8, torch.bfloat16, "cuda")
        return lambda: mhada_prologue.mhada_fused_prologue(*x)
    g = torch.Generator().manual_seed(0)
    q, k = (0.35 * torch.randn(batch, n, 512, generator=g) for _ in "qk")
    v, f = (torch.randn(batch, n, 512, generator=g) for _ in "vf")
    q, k, v, f = (t.to("cuda", torch.bfloat16) for t in (q, k, v, f))
    return lambda: mhada_kernel.mhada_tm(q, k, v, f, 8)


def _k2_calls(rows, widths):
    """K2's kernel alone at bf16 on seeded inputs (E = 512, one LN affine
    in front of each width) and the library chain -> (kernel call, chain
    call)."""
    import torch
    import torch.nn.functional as F

    from mhada_tpu_torch.ops import ln_matmul

    g = torch.Generator().manual_seed(0)
    e = 512
    x = torch.randn(1, rows, e, generator=g)
    lw = 1 + 0.1 * torch.randn(e, generator=g)
    lb = 0.1 * torch.randn(e, generator=g)
    pairs = [(torch.randn(f, e, generator=g) / e ** 0.5,
              0.1 * torch.randn(f, generator=g)) for f in widths]
    x, lw, lb = (t.to("cuda", torch.bfloat16) for t in (x, lw, lb))
    pairs = [(w.to("cuda", torch.bfloat16), b.to("cuda", torch.bfloat16))
             for w, b in pairs]
    return (lambda: [ln_matmul._ln_matmul_kernel(x, lw, lb, w, b, 1e-6)
                     for w, b in pairs],
            lambda: [F.linear(F.layer_norm(x, (e,), lw, lb, 1e-6), w, b)
                     for w, b in pairs])


def _k7_calls(batch, n, m):
    """K7's forward and backward at bf16 on seeded inputs, 8 heads of 64,
    and SDPA on [V | V^2] (forward, and the backward of that call) ->
    {part: (call(), the name part of the kernels device_ms counts, or
    None for every kernel)}."""
    import torch
    import torch.nn.functional as F

    from mhada_tpu_torch.ops import mhada_train as mt

    g = torch.Generator().manual_seed(0)
    q, k = (0.35 * torch.randn(batch, length, 512, generator=g)
            for length in (n, m))
    v = torch.randn(batch, m, 512, generator=g)
    f, cot = (torch.randn(batch, n, 512, generator=g) for _ in "fc")
    q, k, v, f, cot = (t.to("cuda", torch.bfloat16)
                       for t in (q, k, v, f, cot))
    _, m1, e2, lse = mt.mhada_train_fwd_plain(q, k, v, f, 8)
    dm1, de2, delta, _ = mt.mhada_train_prologue(cot, f, m1, e2, 8,
                                                 torch.bfloat16)
    del m1, e2
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    qh, kh, vh = (t.unflatten(-1, (8, 64)).transpose(1, 2) for t in leaves)
    vv = torch.cat([vh, vh * vh], dim=-1)
    lib_out = F.scaled_dot_product_attention(qh, kh, vv, scale=1.0)
    lib_cot = torch.cat([t.unflatten(-1, (8, 64)).transpose(1, 2)
                         for t in (dm1, de2)], dim=-1)
    qd, kd, vvd = qh.detach(), kh.detach(), vv.detach()
    # fwd_launch, or _fwd_kernel in a checkout that predates it
    fwd = getattr(mt, "fwd_launch", None) or mt._fwd_kernel
    return {
        "forward": (lambda: fwd(q, k, v, f, 8), "mhada"),
        "backward": (lambda: mt._bwd_kernel(q, k, v, dm1, de2, lse, delta,
                                             8), "mhada"),
        "forward SDPA": (lambda: F.scaled_dot_product_attention(
            qd, kd, vvd, scale=1.0), None),
        "backward SDPA": (lambda: torch.autograd.grad(
            lib_out, leaves, lib_cot, retain_graph=True), None)}


def _k6b_calls(batch, n, heads):
    """K6's backward at bf16 on seeded inputs, ``heads`` heads of 64, scale
    1/8, and SDPA's backward on the same packed qkv, its forward on the
    flash backend and on the backend PyTorch picks (chip_smoke.py's K6
    yardstick) -> (kernel call, {name: SDPA call})."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from mhada_tpu_torch.ops import attention_train as at

    g = torch.Generator().manual_seed(0)
    c = 64 * heads
    qkv, cot = (torch.randn(batch, n, width, generator=g).to(
        "cuda", torch.bfloat16) for width in (3 * c, c))
    out, lse = at.attention_train_fwd_plain(qkv, heads, 0.125)
    delta = at.row_delta(cot, out, heads)
    del out
    leaf = qkv.detach().requires_grad_()
    q, k, v = (t.unflatten(-1, (heads, 64)).transpose(1, 2)
               for t in leaf.split(c, dim=-1))
    lib_cot = cot.unflatten(-1, (heads, 64)).transpose(1, 2)
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        flash = F.scaled_dot_product_attention(q, k, v, scale=0.125)
    default = F.scaled_dot_product_attention(q, k, v, scale=0.125)
    return (lambda: at._bwd_kernel(qkv, lse, delta, cot, heads, 0.125),
            {name: functools.partial(torch.autograd.grad, out, leaf, lib_cot,
                                     retain_graph=True)
             for name, out in (("SDPA", flash),
                               ("SDPA default backend", default))})


def _frames() -> dict:
    """ms a frame of the bf16 paths of chip_smoke.py's phase 5 on
    full-width models from seed 0 (random pictures on 0-255)."""
    import torch

    from mhada_tpu_torch.config import ModelConfig
    from mhada_tpu_torch.infer.image import (make_encode_style_fn,
                                             make_stylize_fn,
                                             make_stylize_with_kv_fn,
                                             precompute_style_kv)
    from mhada_tpu_torch.models import build_models

    bf = torch.bfloat16
    g = torch.Generator().manual_seed(0)
    models = build_models(ModelConfig(), "cuda", g)

    def pictures(b, side):
        return (torch.rand(b, side, side, 3, generator=g) * 255).cuda()

    def style_kv(style, batch):
        kv = precompute_style_kv(models,
                                 make_encode_style_fn(models, bf)(style))
        return [(k.repeat(batch, 1, 1), v.repeat(batch, 1, 1))
                for k, v in kv]

    out = {}
    c, s = pictures(1, 512), pictures(1, 512)
    full = make_stylize_fn(models, bf)
    out["frame full 512^2 B=1 bfloat16"] = _cuda_ms(lambda: full(c, s), 2, 5)
    stream = make_stylize_with_kv_fn(models, bf)
    kv1 = style_kv(s, 1)
    out["frame streaming 512^2 B=1 bfloat16"] = _cuda_ms(
        lambda: stream(c, kv1), 5, 20)
    c8, kv8 = pictures(8, 512), style_kv(s, 8)
    out["frame streaming 512^2 B=8 bfloat16 (a frame)"] = _cuda_ms(
        lambda: stream(c8, kv8), 2, 5) / 8
    c1k, kv1k = pictures(1, 1024), style_kv(pictures(1, 1024), 1)
    out["frame streaming 1024^2 B=1 bfloat16"] = _cuda_ms(
        lambda: stream(c1k, kv1k), 1, 3)
    return out


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", help="root of the other checkout")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--groups", nargs="+", default=list(GROUPS),
                    choices=GROUPS)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        print(json.dumps(worker(args.worker, args.groups)), flush=True)
        return
    if not args.other:
        ap.error("--other DIR is required")
    sides = {"other": str(Path(args.other).resolve()), "this": str(ROOT)}
    order = ["other", "this", "this", "other"] * max(1, args.rounds // 2)
    print(f"# {card()}; other = {sides['other']}, this = {sides['this']}",
          flush=True)
    runs = {"other": [], "this": []}
    for side in order:
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--worker",
             sides[side], "--groups", *args.groups], capture_output=True,
            text=True, cwd=sides[side])
        if proc.returncode:
            raise RuntimeError(f"{side} worker failed:\n{proc.stderr[-3000:]}")
        runs[side].append(json.loads(proc.stdout.strip().splitlines()[-1]))
    for key in runs["this"][0]:
        print(json.dumps({"gate": key,
                          "other_ms": [r[key] for r in runs["other"]],
                          "this_ms": [r[key] for r in runs["this"]]}),
              flush=True)


if __name__ == "__main__":
    main()
