"""K6's bf16 backward one piece at a time: builds of
csrc/attention_bwd_wgmma.cuh with one piece of its design changed, timed
beside the kernels as built at K6's training gates' shapes (C = 512, 8
heads, scale 1/8): B = 8, L = 1024 (the 256^2 step), B = 4, L = 4096
(512^2) and B = 2, L = 2048 (the video step's frames).

    python -m mhada_tpu_torch.probes.attention_bwd_ablate [--iters 10]
        [--variants ...]

The twin of ``probes.mhada_bwd_ablate`` (K7's pair), whose machinery it
uses: each variant is the header with the text edits of ``VARIANTS`` (a
loop edit replaces a consumer's loop, from its first comment line through
its closing brace, the dQ kernel's through its last turn), compiled into a
scratch library of attention_train.cu (all variants at once) and launched
through the same C entry point (mhada_attention_train_bwd).  As built, the
dQ kernel's two consumers (232 registers) keep two product groups in
flight (the next tile's S and dP issued under this tile's dQ) and the
dK/dV kernel's two (232) one.  The variants: the dK/dV kernel with three
consumer warpgroups of 64 keys (registers 152 / 56, as the forward
tile's), or with two groups in flight (K7's pair could afford neither:
C7512, spills); the dQ kernel with one group in flight, with two or with
three consumers (160 / 32, K7's dQ kernel's shape), and with three
consumers keeping two groups.  Prints the card's name and power
limit, then one JSON line per variant: ptxas's registers, spilled bytes
and serialisation notes (C75xx) of the dQ and dK/dV kernels, and per shape
the device ms of the call (both kernels) in two rounds, the bound's share
at the faster round and max |variant - as built| / max |as built| of the
packed gradient.  The bound is 14 B L^2 C flops (S and dP recomputed in
both kernels) at the published bf16 peak.  Card only.
"""

import argparse
import json
import tempfile
from pathlib import Path

import torch

from .. import _build
from ..config import resolve_device
from ..ops.attention_train import attention_train_fwd_plain, row_delta
from .mhada_bwd_ablate import PEAK_BF16, build_variants, measure
from .redesign_ab import card

HEADER = "attention_bwd_wgmma.cuh"
SOURCE = "attention_train.cu"
ENTRY = "mhada_attention_train_bwd"
KERNELS = ("attention_wgmma_dq_kernel", "attention_wgmma_dkv_kernel")
C, HEADS, SCALE = 512, 8, 0.125
SHAPES = [(8, 1024), (4, 4096), (2, 2048)]

# The dQ consumers with one group in flight (K7's dQ kernel's pattern):
# each turn issues tile j's S and dP; dQ += dS K follows outside the turns.
_DQ_ONE = """  // one group in flight
  if (turns.last) named_arrive(kBarTurn, 256);
  mbar_wait_or_trap(qbar, 0);
  for (int j = 0; j < ntiles; ++j) {
    const int st = j % kStages;
    const uint32_t kt = base + st * kDqStageBytes;
    mbar_wait_or_trap(full(st), (j / kStages) & 1);
    named_sync(turns.turn, 256);
    wgmma_fence();
    issue_s_dp(s, dp, qt, kt, gt, kt + kTileBytes);
    wgmma_commit();
    if (j + 1 < ntiles || !turns.last) named_arrive(turns.next, 256);
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    ds(j);
    pack_frags(df, dp);
    fence_regs(dq);
    fence_frags(df);
    wgmma_fence();
    issue_rs(dq, df, kt);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    fence_frags(df);
    release(st);
  }
"""
_FENCE_DKV = """    fence_regs(dk);
    fence_regs(dv);
    fence_frags(pf);
    fence_frags(dsf);
"""
# The dK/dV consumers with two groups in flight: turn i issues tile i's
# S^T and dP^T and tile i - 1's dV and dK.
_DKV_TWO = ("""  // two groups in flight
  if (turns.last) named_arrive(kBarTurn, 256);
  mbar_wait_or_trap(kvbar, 0);
  mbar_wait_or_trap(full(0), 0);
  named_sync(turns.turn, 256);
  wgmma_fence();
  issue_s_dp(sT, dpT, kt, base, vt, base + kTileBytes);
  wgmma_commit();
  named_arrive(turns.next, 256);
  wgmma_wait<0>();
  fence_regs(sT);
  fence_regs(dpT);
  ds(0);
  pack_frags(pf, sT);
  pack_frags(dsf, dpT);
  for (int i = 1; i < ntiles; ++i) {
    const int st = i % kStages, sp = (i - 1) % kStages;
    const uint32_t qt = base + st * kDkvStageBytes;
    const uint32_t qp = base + sp * kDkvStageBytes;
    mbar_wait_or_trap(full(st), (i / kStages) & 1);
    named_sync(turns.turn, 256);
""" + _FENCE_DKV + """    wgmma_fence();
    issue_s_dp(sT, dpT, kt, qt, vt, qt + kTileBytes);
    wgmma_commit();
    issue_rs(dv, pf, qp + kTileBytes);
    issue_rs(dk, dsf, qp);
    wgmma_commit();
    named_arrive(turns.next, 256);
    wgmma_wait<1>();
    fence_regs(sT);
    fence_regs(dpT);
    ds(st);
    wgmma_wait<0>();
""" + _FENCE_DKV + """    release(sp);
    pack_frags(pf, sT);
    pack_frags(dsf, dpT);
  }
  {
    const int sl = (ntiles - 1) % kStages;
    const uint32_t ql = base + sl * kDkvStageBytes;
    named_sync(turns.turn, 256);
""" + _FENCE_DKV + """    wgmma_fence();
    issue_rs(dv, pf, ql + kTileBytes);
    issue_rs(dk, dsf, ql);
    wgmma_commit();
    if (!turns.last) named_arrive(turns.next, 256);
    wgmma_wait<0>();
    fence_regs(dk);
    fence_regs(dv);
    release(sl);
  }
""")
# The first lines of the two consumer loops as built (the dQ kernel's runs
# through its last turn's block).
DQ_LOOP = ("  // Consumers issue in turn, 0 first; each takes ntiles + 1 "
           "turns.")
DQ_END = "    release(sl);\n  }\n"
DKV_LOOP = ("  // One product group in flight: each turn issues tile i's S^T "
            "and dP^T;")
LOOPS = ((DQ_LOOP, DQ_END), DKV_LOOP)
_DKV_THREE = [("constexpr int kDkvConsumers = 2;",
               "constexpr int kDkvConsumers = 3;"),
              ("kDkvConsumerRegs = 232, kDkvProducerRegs = 40;",
               "kDkvConsumerRegs = 152, kDkvProducerRegs = 56;")]
_DQ_THREE = [("constexpr int kDqConsumers = 2;",
              "constexpr int kDqConsumers = 3;"),
             ("kDqConsumerRegs = 232, kDqProducerRegs = 40;",
              "kDqConsumerRegs = 160, kDqProducerRegs = 32;")]
# variant -> edits: (old text, new) or (the first line of a loop, new loop)
VARIANTS = {
    "as built": [],
    "dK/dV three consumers": _DKV_THREE,
    "dK/dV two groups in flight": [(DKV_LOOP, _DKV_TWO)],
    "dQ one group in flight": [(DQ_LOOP, _DQ_ONE)],
    "dQ three consumers, one group in flight": _DQ_THREE + [
        (DQ_LOOP, _DQ_ONE)],
    "dQ three consumers, two groups in flight": _DQ_THREE,
}


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
        for b, n in SHAPES:
            qkv = torch.randn(b, n, 3 * C, generator=g).to(device, bf)
            cot = torch.randn(b, n, C, generator=g).to(device, bf)
            out, lse = attention_train_fwd_plain(qkv, HEADS, SCALE)
            delta = row_delta(cot, out, HEADS)
            cases.append((f"B={b} L={n}", (b, n, (qkv, cot, lse, delta)),
                          [torch.empty_like(qkv)],
                          14 * b * n * n * C / PEAK_BF16 * 1e3))
            del out
    with tempfile.TemporaryDirectory() as tmp, torch.inference_mode():
        built = build_variants(args.variants, Path(tmp), VARIANTS, HEADER,
                               SOURCE, ENTRY, LOOPS, KERNELS)

        def launch(fn, shape_ins, outs):
            b, n, ins = shape_ins
            stream = torch.cuda.current_stream(device).cuda_stream
            err = fn(*(t.data_ptr() for t in (*ins, *outs)), b, n, C, HEADS,
                     SCALE, _build.DTYPE_CODES[bf], stream)
            if err:
                raise RuntimeError(f"{ENTRY} failed: CUDA error {err}")

        rows = measure(built, cases, launch, device, args.iters)
    for row in rows:
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
