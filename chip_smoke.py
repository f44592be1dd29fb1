#!/usr/bin/env python3
"""Drive the PyTorch port (mhada_tpu_torch) on one CUDA card, in phases.

    python3 chip_smoke.py        # from the root of the repository

1. environment: torch / CUDA versions, the card's name and power limit,
   whether cv2 imports (reported, never failed);
2. build: compile mhada_tpu_torch/csrc/*.cu with nvcc (one per source, in
   parallel); the bf16 tensor-core kernels of K1, K6, K3, K4 and K7
   (forward, dQ and dK/dV), of the decoder tail (K5, K8), of K2, of K14
   and of K13 must each hold HMMA.16816.F32.BF16 in their SASS (cuobjdump) and
   spill nothing (ptxas); the wgmma + TMA kernels, P2's bf16 kernel and
   every block tile of P1's, must hold HGMMA (wgmma) and UTMALDG (TMA
   loads) and spill nothing; every instantiation that a bf16 path
   launches must exist (K4's MHAda tile without prologue or
   residuals, the tail with and without residuals, K2's, K14's, K13's), no bf16
   instantiation of the CUDA-core kernels they replaced may exist (those
   of K1, K4, K5, K6, K7, K8 and K2), nor any instantiation of K14's old
   conv (conv3x3_relu_kernel, either dtype) or of P1's old wmma kernel
   (mm_probe_kernel), nor any instantiation of the old flash tile
   (flash_tile_kernel, the f32 forwards of K1, K4, K6 and K7 before the
   float32 tile) or of K13's first kernel (decoder_c6_kernel, either
   dtype), nor a float32 instantiation of the old
   flash backward (flash_bwd_dkv_kernel, flash_bwd_dq_kernel) or of the
   old fused tail (decoder_tail_kernel<bool>, K5's and K8's before the
   two-stage float32 tail); K2's float32 kernel, the float32 flash tile
   (csrc/mhada_f32_tile.cuh: the MHAda kernel <prologue, stages,
   residuals> of K4 <false, 2, false>, K3 <true, 2, false>, P2 <true, 1,
   false> and K7's forward <false, 2, true>; the attention kernel <lse> of
   K1 <false> and K6's forward <true>), the float32 flash backward
   (csrc/flash_bwd_f32.cuh: the dK/dV and dQ kernels of K6 <false> and K7
   <true>) and the float32 tail (csrc/decoder_tail_f32.cuh: the up3
   kernel of K5 and K8, the upsample + c5 + c6 kernel <residuals> of K5
   <false> and K8 <true>), K14's float32 conv
   (csrc/decoder_mid_f32.cuh) and K13's (csrc/decoder_c6_f32.cuh), each
   instantiation present, must exist,
   spill nothing and hold no HMMA or HGMMA of any kind (they compute in
   float32, no TF32);
3. gates: each hand-written kernel against its plain PyTorch version on the
   card, in float32 and bfloat16, at the 512^2 path's shapes and at the
   1024^2 shapes (K2 at N = 16384; K3 at M = 16384; K5 from 512^2 to
   1024^2; K1 at L = 16384 for the TPU's K9; K4 at N = M = 16384 for the
   TPU's K10); K13 (c6) at 512^2 with B = 1 and 8, at 1024^2, at the
   video CLI's 256 x 512 with B = 8 and at 264 x 488 (sides that are not
   multiples of its 16 x 64 strip), also as the kernel alone; K14 (c1
   -> c3) at 128^2 with B = 1 and 8 and at 256^2; P2 at B = 8, N = M =
   4096, also against K3 (float32 and bfloat16); P1 at its 8 shapes
   (bfloat16, each with its block tile), each with its time, the plain
   version's, the PyTorch library call's where one computes the same
   function or, for K3, K4, K7
   and P2, their products (SDPA on [V | V^2] with scale 1; named in the
   record with its backend), and the least time the card could take (its
   bound); K2 three ways: its
   wrapper (float32 weights cast per call, the 1536- and 2048-wide outputs
   concatenated), the kernel alone and the library chain (F.layer_norm +
   F.linear per width, cuBLAS; two calls, so it stands in the library
   column only as a named chain, as the plain cuDNN chain is K5's
   yardstick), both on the inputs cast once to the compute dtype; K14 also
   as the kernel alone (its weights converted once); K5 at float32 also as
   its two kernels' device times apart (``torch.profiler``); then the
   probes' CLIs, their launches counted;
4. main paths, each driven with the launch counts set to 0 just before it
   and read just after, and held against the plain path on the same
   weights:
   a. the full path ``infer.image.stylize_image`` at 512^2;
   b. the streaming path at 512^2, B = 1: ``precompute_style_kv`` once,
      then one ``make_stylize_with_kv_fn`` frame, also held against (a);
   c. 1024^2: one streaming frame in float32 and bfloat16, one full-path
      frame in float32;
   d. the c6 tail (``build_models(..., decoder_tail="c6")``, K13 in place
      of K5) at 512^2: one full-path and one streaming frame, also held
      against the fused-tail kernel path's;
   e. K14 on the 512^2 decoder's own activations (B = 1 and 8): up1's
      output through ``mid3_fused``, then up2, c4 and K5, the c3
      activation and the pixels against the plain decoder;
   f. the video CLI's frame: 256 x 512 content against a 256^2 style
      (``infer.video``'s defaults; K3 at N = 2048 against M = 1024), the
      streaming path at B = 1 and 8, the style set-up counted apart;
   g. the video CLI, ``infer.video.main`` at bf16 over a synthetic
      16-frame 540 x 960 mp4v clip with these weights as a .pth triple,
      --chunk 1 and 8: the frames, their JPEGs, a readable video.mp4, the
      whole run's launches, the chunked frames within 1 uint8 level of
      the unchunked, and the CLI's wall ms/frame (not gated);
5. times: ms per frame of the kernel and plain paths, interleaved: the full
   path at 512^2; the streaming path at 512^2 with B = 1 and 8 (one B = 8
   batch of each tail held against the plain path first), the c6-tail
   path timed in the same turns; the video CLI's 256 x 512 frame at B = 1
   and 8; the streaming path at 1024^2, B = 1, bfloat16;
6. training gates: the training kernels K6 (attention, forward and
   backward), K7 (MHAda, forward and backward) and K8 (the decoder tail
   writing its residuals) against their plain versions at the image
   training step's shapes (B = 8, 256^2: L = N = M = 1024 tokens, the tail
   from 128^2 to 256^2); K6 and K7 also beyond the TPU's token-major
   training windows, as the ports of K12, K10's residuals and K11 (B = 4 at
   4096 tokens, the 512^2 step's shapes, and B = 1 at 16384), K8 from 256^2
   to 512^2 (B = 4), and K2 under its VJP at the fused-LN step's shapes
   (B = 8, 1024 tokens, 512 -> 1536 and 2048) against autograd of the
   unfused LayerNorm and linear (its forward timed as the kernel alone,
   through the wrapper and as the library chain of phase 3); float32 and
   bfloat16: each output, residual and input gradient against its own
   scale, with times, bounds and the library yardstick, and K6's and K7's
   backward also as its dK/dV and dQ kernels' device times apart
   (``torch.profiler``), K8's float32 forward as its two kernels' (up3;
   the upsample, c5 and c6); and at the video step's shapes (B = 2; 256 x
   512 frames are 2048 tokens, 256^2 styles 1024): K6 at L = 2048, K7 at
   N = 2048 against M = 1024, K8 from 128 x 256 to 256 x 512, the first
   non-square tail at full width;
7. the training paths: one step (``train.train_image``) on the kernel build
   and one on the plain build from the same weights and batch, losses and
   every gradient held together (each tensor against its own scale, to a
   bound widened only where a rounding-level change of the inputs moves
   the plain build as far), launch counts exact; controls that the
   gradient gate must report (a planted fault in K7's dq; the plain build
   in bfloat16 against the float32 bounds); at 256^2, B = 8: that step, 5
   steps on a fixed batch with a falling loss, ``train.run_image`` for 2
   steps over 16 synthetic PNGs and one resumed step, ms/step of both
   builds interleaved; the fused-LN build (``ModelConfig(fuse_ln=True)``,
   K2 and its VJP) at 256^2, B = 8: that step and ms/step interleaved with
   the unfused kernel build; 512^2 (4096 tokens), B = 4: that step with
   each build's peak memory and ms/step interleaved; ``train.run_image
   --image-size 512 512 --batch-size 8`` for 2 steps; the video recipe
   (``train.train_video``: B = 2 pairs of 256 x 512 frames, 256^2 styles,
   flow U(-5, 5), mask U(0, 1) > 0.2): that step, with K6 18 + 18, K7 30 +
   30 and K8 5 launches, its key biases' gradients held to their own
   ceiling and a planted fault in K7's dK that must cross it, 5 steps on
   a fixed batch with a falling loss, ``train.run_video`` for 2 steps
   over a synthetic SceneFlow tree and WikiArt PNGs, resumed across from
   the checkpoint that the 256^2 ``train.run_image`` run wrote, and
   ms/step of both builds interleaved with each build's peak memory;
   float32 and bfloat16 throughout;
8. the evals (``mhada_tpu_torch.evals``), on random full-width weights from
   the seed written as the .pth files each CLI loads (the stylization
   triple; torchvision-layout vgg16, vgg19, inception_v3 and raft_large;
   the LPIPS heads):
   a. K1 (L = 3600), K2 (3600 rows), K4 (N = 3600 against M = 1024) and K5
      (180 x 320 -> 360 x 640), the Sintel eval's 360 x 640 frame against
      a 256^2 style, and K4 at N = 2048 against M = 1024, the video eval's
      frame, each against its plain version, float32 and bfloat16: tiles
      that these sides leave ragged;
   b. ``evals.exps_image.main`` at 512^2, float32, over the six reference
      file names (seeded JPEGs), every backbone but Inception: the CSV's
      14 columns and 7 rows (SIFID NaN, the rest finite, the average row
      the column mean), exactly 6 x the full path's launches, each
      stylized.png within 1 uint8 level of the plain path's, and its wall
      per pair split into stylization, LPIPS, gram, SSIM and histograms;
   c. SSIM, gram, LPIPS, the four Inception taps and SIFID at 64, 192 and
      768 dims on the card against the same functions on the CPU (each
      against its own scale; SIFID's host seconds), and ``evals.cli -m
      sifid`` at 2048 dims with its wall seconds;
   d. ``evals.exps_image_all.main`` on a 2 x 2 grid (exact launches);
   e. ``evals.exps_sintel.main`` at 360 x 640 over two scenes of three
      436 x 1024 frames, ``--flow raft:<pth>`` and ``--flow farneback``
      (the CSV, finite losses, exact launches, wall per flow and per
      pair), and RAFT's device ms per flow at 360 x 640 and 256 x 512;
   f. ``evals.exps_video.main`` on an 8-frame 540 x 960 mp4v clip at
      256 x 512, RAFT, 4 pairs, float32 and bfloat16 (finite errors, exact
      launches, wall per pair).

Each phase prints one line; any failure exits non-zero without the final
result line.  The model is the full-width ``ModelConfig()`` with random
weights from a seed.  The line before the last is the kernels' JSON
summary; the last line is ``{"ok": true, "device": {...}}``.  ``--dump
FILE`` also writes phase 7's per-tensor gradient errors and bounds.
"""

import argparse
import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
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
K6F, K6B, K7F, K7B, K8 = ("mhada_attention_train_fwd",
                          "mhada_attention_train_bwd", "mhada_mhada_train_fwd",
                          "mhada_mhada_train_bwd", "mhada_decoder_tail_res")
C6, MID, MM, PIPE = ("mhada_decoder_c6", "mhada_decoder_mid_conv",
                     "mhada_mm_probe", "mhada_mhada_prologue_pipe")
SRC = "mhada_tpu_torch/csrc/"
K12_SINGLE = "K12 single-pass forward, by K1's kernel"
K12_FWD = "K12 streaming forward with lse, by K6's forward"
K12_BWD = "K12 flash backward, by K6's backward"
K10_RES = "K10 streaming forward with M1/E2/lse, by K7's forward"
K11_BWD = "K11 flash backward, by K7's backward"
K2_VJP = "K2 ln_matmul under its VJP (fused-LN training)"
ROWS = [
    # row, C entry point, source, TPU kernel it replaces (pallas_call line),
    # the path whose launches the row reports
    ("K1 attention_tm", ATTN, SRC + "attention_fwd.cu",
     "mhada_tpu/ops/attention_pallas.py:154", "full512"),
    ("K2 ln_matmul", LN, SRC + "ln_matmul.cu",
     "mhada_tpu/ops/ln_matmul_pallas.py:44", "full512"),
    ("K3 mhada_fused_prologue", K3, SRC + "mhada_prologue.cu",
     "mhada_tpu/ops/mhada_pallas.py:239", "stream512"),
    ("K4 mhada_tm", K4, SRC + "mhada_fwd.cu",
     "mhada_tpu/ops/mhada_pallas.py:114", "full512"),
    ("K5 decoder_tail", TAIL, SRC + "decoder_tail.cu",
     "mhada_tpu/ops/decoder_tail_pallas.py:546", "full512"),
    ("K9 attention_stream_wide, by K1's kernel", ATTN,
     SRC + "attention_fwd.cu", "mhada_tpu/ops/attention_pallas.py:624",
     "stream1024"),
    ("K10 mhada streaming forward, by K4's kernel", K4,
     SRC + "mhada_fwd.cu", "mhada_tpu/ops/mhada_pallas.py:622", "full1024"),
    ("K6 attention_train forward", K6F, SRC + "attention_train.cu",
     "mhada_tpu/ops/attention_pallas.py:236", "train"),
    ("K6 attention_train backward", K6B, SRC + "attention_train.cu",
     "mhada_tpu/ops/attention_pallas.py:351", "train"),
    ("K7 mhada_train forward", K7F, SRC + "mhada_train.cu",
     "mhada_tpu/ops/mhada_pallas.py:336", "train"),
    ("K7 mhada_train backward", K7B, SRC + "mhada_train.cu",
     "mhada_tpu/ops/mhada_pallas.py:468", "train"),
    ("K8 decoder_tail_train forward", K8, SRC + "decoder_tail.cu",
     "mhada_tpu/ops/decoder_tail_pallas.py:519", "train"),
    # K12 (head-major attention): its single-pass forward at L = 4096 is
    # K1's gate; training above 2048 tokens takes K6 (the 512^2 step)
    (K12_SINGLE, ATTN, SRC + "attention_fwd.cu",
     "mhada_tpu/ops/attention_pallas.py:62", "full512"),
    (K12_FWD, K6F, SRC + "attention_train.cu",
     "mhada_tpu/ops/attention_pallas.py:488", "train512"),
    (K12_BWD, K6B, SRC + "attention_train.cu",
     "mhada_tpu/ops/attention_pallas.py:868", "train512"),
    # K10 under grad (its residuals) and K11 take K7 (the 512^2 step)
    (K10_RES, K7F, SRC + "mhada_train.cu",
     "mhada_tpu/ops/mhada_pallas.py:622", "train512"),
    (K11_BWD, K7B, SRC + "mhada_train.cu",
     "mhada_tpu/ops/mhada_pallas.py:903", "train512"),
    # K2's forward kernel inside its autograd Function (the fused-LN step)
    (K2_VJP, LN, SRC + "ln_matmul.cu",
     "mhada_tpu/ops/ln_matmul_pallas.py:44", "train_fuseln"),
    # the c6-tail path (4d); K14 has no path (4e drives it); the probes
    ("K13 c6_transposed", C6, SRC + "decoder_c6.cu",
     "mhada_tpu/ops/decoder_tail_pallas.py:146", "c6full512"),
    ("K14 mid3_fused", MID, SRC + "decoder_mid.cu",
     "mhada_tpu/ops/decoder_mid_pallas.py:169", "mid512"),
    ("P1 mm_probe", MM, SRC + "mm_probe.cu", "scripts/mxu_probe.py:42",
     "probe_mm"),
    ("P2 mhada_prologue_pipe", PIPE, SRC + "mhada_prologue_pipe.cu",
     "scripts/mhada_pipe_probe.py:112", "probe_pipe"),
]
# Rows whose launches come from a run that no inference or training entry
# point makes: launches key -> (the row's path, why).
PATH_NOTES = {
    "mid512": (None, "nothing calls mid3_fused in either package; the "
               "launches are phase 4e's: the 512^2 decoder's own up1 output "
               "through K14, 3 per call"),
    "probe_mm": ("probe", "python -m mhada_tpu_torch.probes.mm_probe"),
    "probe_pipe": ("probe",
                   "python -m mhada_tpu_torch.probes.mhada_pipe_probe"),
}
# The library call each gate times beside its kernel, by name.
SDPA = "torch.nn.functional.scaled_dot_product_attention"
MM_REPS = 100   # P1's products per launch in its gate (and cuBLAS calls)
NO_LIB = "no single PyTorch call computes this function"
# The MHAda core's yardstick: SDPA on [V | V^2] with scale 1 gives M1 | E2.
MHADA_SDPA = f"{SDPA} on [V | V^2], scale 1"
# K2's yardstick: no single call computes LN + matmul; the chain of two
# library calls per width on the compute-dtype inputs, named as such.
LN_CHAIN = ("chain of torch.nn.functional.layer_norm + "
            "torch.nn.functional.linear (cuBLAS) per width, 2 calls each, "
            "on the compute-dtype inputs; no single call computes K2")


def ln_chain(x, lw, lb, pairs):
    """K2's library chain on ``pairs`` of (w, b), every input already in
    the compute dtype."""
    import torch.nn.functional as F

    c = x.shape[-1]
    return lambda: [F.linear(F.layer_norm(x, (c,), lw, lb, 1e-6), w, b)
                    for w, b in pairs]
# gate -> (its row, kind of inputs, token count, batch); the first gate of
# a row fills the row.  K13: the c5 side or (height, width) (256 x 512 is
# the video CLI's frame, B = 8 its --chunk 8 batch; 264 x 488 sides the
# model can produce that are not multiples of the kernel's 16 x 64 strip);
# K14: the up1 output's side; P1: the index of the probe's shape (bfloat16
# only); P2: tokens.
GATES = [
    ("K1 L=4096", "K1 attention_tm", "attention", 4096, 1),
    ("K2 N=4096", "K2 ln_matmul", "ln_matmul", 4096, 1),
    ("K3 N=M=4096", "K3 mhada_fused_prologue", "prologue", 4096, 1),
    ("K4 N=M=4096", "K4 mhada_tm", "mhada", 4096, 1),
    ("K5 256^2->512^2", "K5 decoder_tail", "tail", 256, 1),
    ("K2 N=16384", "K2 ln_matmul", "ln_matmul", 16384, 1),
    ("K3 N=M=16384", "K3 mhada_fused_prologue", "prologue", 16384, 1),
    ("K5 512^2->1024^2", "K5 decoder_tail", "tail", 512, 1),
    ("K1 L=16384", "K9 attention_stream_wide, by K1's kernel", "attention",
     16384, 1),
    ("K4 N=M=16384", "K10 mhada streaming forward, by K4's kernel", "mhada",
     16384, 1),
    ("K13 512^2", "K13 c6_transposed", "c6", 512, 1),
    ("K13 512^2 B=8", "K13 c6_transposed", "c6", 512, 8),
    ("K13 1024^2", "K13 c6_transposed", "c6", 1024, 1),
    ("K13 256x512 B=8", "K13 c6_transposed", "c6", (256, 512), 8),
    ("K13 264x488", "K13 c6_transposed", "c6", (264, 488), 1),
    ("K14 128^2", "K14 mid3_fused", "mid", 128, 1),
    ("K14 128^2 B=8", "K14 mid3_fused", "mid", 128, 8),
    ("K14 256^2", "K14 mid3_fused", "mid", 256, 1),
    ("P2 B=8 N=M=4096", "P2 mhada_prologue_pipe", "pipe", 4096, 8),
]
BF16_ONLY = {"mm"}

# Launches of each path (C entry point -> count).
# The inference paths launch none of the training kernels, and no path
# launches K14 or the probes.
NO_TRAIN = {K6F: 0, K6B: 0, K7F: 0, K7B: 0, K8: 0, C6: 0, MID: 0, MM: 0,
            PIPE: 0}
FULL = {ATTN: 6, LN: 12, K3: 0, K4: 6, TAIL: 1, **NO_TRAIN}
STYLE = {ATTN: 3, LN: 6, K3: 0, K4: 0, TAIL: 0, **NO_TRAIN}  # style set-up
FRAME = {ATTN: 3, LN: 6, K3: 6, K4: 0, TAIL: 1, **NO_TRAIN}  # one frame
# One frame against style features encoded once (make_stylize_with_fs_fn,
# the evals' path): vit_c, the MHAda blocks on K4 and the tail.
FS_FRAME = {k: FULL[k] - STYLE[k] for k in FULL}
# The c6 tail (4d): K13 in place of K5.
FULL_C6, FRAME_C6 = ({**p, TAIL: 0, C6: 1} for p in (FULL, FRAME))
# 4e: the decoder with K14 for c1 -> c3 and K5 for the tail.
MID_DECODER = {**{k: 0 for k in FULL}, MID: 3, TAIL: 1}
# One image training step (4 ViT applies x 3 blocks, 3 AdaFormer applies x
# 6 MHAda blocks, 3 decoder tails); K1-K5 launch nothing.
# The counts count sites, so 512^2 launches as 256^2 does.  The fused-LN
# build adds K2 at both pre-LN sites of every block (4 x 3 x 2).
TRAIN = {ATTN: 0, LN: 0, K3: 0, K4: 0, TAIL: 0, K6F: 12, K6B: 12, K7F: 18,
         K7B: 18, K8: 3, C6: 0, MID: 0, MM: 0, PIPE: 0}
TRAIN_FUSED = {**TRAIN, LN: 24}
# One video training step (6 ViT applies x 3 blocks, 5 AdaFormer applies x
# 6 MHAda blocks, 5 decoder tails; the VGG sweeps launch none).
TRAIN_VIDEO = {**TRAIN, K6F: 18, K6B: 18, K7F: 30, K7B: 30, K8: 5}
# The training gates: (gate, row of its forward or None, row of its backward
# or None, kind, batch, tokens; K7: tokens or (queries, keys); K8: the
# input's side or (height, width)).  A gate without a row is recorded under
# its own name.  The first three are the 256^2 step's shapes; K6 and K7 at
# 4096 tokens are the 512^2 step's, and there they stand for the TPU's
# head-major K12, K10 and K11; the last three are the video step's.
TRAIN_GATES = [
    ("K6 L=1024", "K6 attention_train forward", "K6 attention_train backward",
     "attention", 8, 1024),
    ("K7 N=M=1024", "K7 mhada_train forward", "K7 mhada_train backward",
     "mhada", 8, 1024),
    ("K8 128^2->256^2", "K8 decoder_tail_train forward", None, "tail", 8,
     128),
    ("K6 B=4 L=4096", K12_FWD, K12_BWD, "attention", 4, 4096),
    ("K6 B=1 L=16384", None, None, "attention", 1, 16384),
    ("K7 B=4 N=M=4096", K10_RES, K11_BWD, "mhada", 4, 4096),
    ("K7 B=1 N=M=16384", None, None, "mhada", 1, 16384),
    ("K8 256^2->512^2 B=4", None, None, "tail", 4, 256),
    ("K2 VJP B=8 L=1024", K2_VJP, None, "ln_matmul", 8, 1024),
    ("K6 B=2 L=2048", None, None, "attention", 2, 2048),
    ("K7 B=2 N=2048 M=1024", None, None, "mhada", 2, (2048, 1024)),
    ("K8 128x256->256x512 B=2", None, None, "tail", 2, (128, 256)),
]
VIDEO_GATES = TRAIN_GATES[-3:]
TRAIN_B, TRAIN_SIZE = 8, 256
# The 512^2 step (4096 tokens at every attention and MHAda site).
BIG_B, BIG_SIZE = 4, 512
# The synthetic SceneFlow frames of phase 7's run_video: SceneFlow's own
# 960 x 540, resized by the dataset to the recipe's 512 x 256.
SCENEFLOW_HW = (540, 960)
# Training bounds on max |kernel - plain| / max |plain| of each output,
# residual and input gradient, each against its own largest value: forward
# as the forward gates; gradients sum over 1024 rows in another order
# (float32) or round P and dS to bf16 at the same points but after sums in
# another order (bfloat16).
TRAIN_REL = {"float32": (1e-4, 1e-3), "bfloat16": (3e-2, 5e-2)}
# K8: the share of rgb, y1 and c5 positions whose ReLU masks may differ
# between the kernel and plain forwards (pre-activations within rounding of
# 0; see tail_aligned_grads); at most 2.4e-7 (float32) and 2.7e-6
# (bfloat16; 8.1e-4 before the plain version rounded where the Pallas
# kernel rounds) on an H100.
TAIL_FLIPS = {"float32": 1e-4, "bfloat16": 1e-2}
# One step, kernel build against plain build in the same dtype: relative
# loss bound.  Many gradients are zero in exact arithmetic (the key biases:
# softmax is shift-invariant; the value and output biases and the last
# vit_c block's output biases: the next instance norm removes a per-channel
# constant); the plain float32 build gives them 1e-13 to 1e-9 of the
# network's largest gradient in the image steps (3e-7 in the video step's
# key biases) and every other tensor at least 1e-5.  Tensors below
# LIVE_FLOOR there are rounding noise, held to NOISE_BOUND x the
# network's largest gradient.
STEP_LOSS_REL = {"float32": 1e-4, "bfloat16": 3e-2}
LIVE_FLOOR = 1e-6
NOISE_BOUND = {"float32": 1e-5, "bfloat16": 1e-3}
# The video step's six MHAda key biases (adaFormer.ada*.g_bias), whose
# gradients sum B x M = 4096 or 2048 rows of dK that cancel in exact
# arithmetic, have a ceiling of their own in place of NOISE_BOUND.  On an
# H100 (four runs) the bfloat16 kernel build put them 1.43e-3 to 2.31e-3
# of adaFormer's largest gradient from the plain build, and the plain
# build's own rounding controls moved them 1.58e-3 to 1.96e-3 (below 1e-6
# in the image steps); float32 gives 2.3e-7.  The bfloat16 ceiling is 2.2 x
# the worst of those seven readings.
KEY_BIAS_BOUND = {"float32": 1e-5, "bfloat16": 5e-3}
# Every live tensor's gradient is held against its own largest value, to
# the larger of TRAIN_REL's gradient bound and ROUNDING_FACTOR x the error
# that a rounding-level change gives the plain build (the same step on
# inputs moved by one unit in the last place; the larger of two such
# controls): a gradient that sums nearly cancelling terms, or crosses ReLU
# masks flipped at pre-activations within rounding of 0, moves that far
# under any correct kernel.  On an H100 the kernel build's float32 errors
# reached 3.3x the controls' larger error (adaFormer.ada3.f_kernel, a
# projection next to K7, whose rounding differs from the plain version's
# by ~1e-6; two runs), so the factor 6 leaves room of 1.8x.
ROUNDING_FACTOR = 6.0
# Controls the step gate must report as not correct: the kernel build with
# K7's dq scaled by 1 + PLANTED_DQ, and the plain build in bfloat16 held to
# the float32 bounds.  A fault of 1 + BELOW_DQ is also planted and its
# count printed, not gated: it shows the gate's resolution, since faults
# that small sit inside the step's rounding spread (phase 6 holds K7's dq
# to 1e-3 / 5e-2 of its own scale on the same inputs).
PLANTED_DQ = {"float32": 1e-2, "bfloat16": 1.0}
BELOW_DQ = {"float32": 1e-3, "bfloat16": 1e-1}
# Where the key biases have their ceiling, a control the gate must report
# there: K7's dK with every element moved by PLANTED_DK x its largest
# |value|.  The keys are instance-normalised style tokens, so the shift
# cancels in the key projection's weight gradient and in the gradient that
# reaches the style tokens: only the key biases' gradients see it.  A shift
# of one bfloat16 rounding step (2^-8; float32: 2^-16) is the gated
# control; one of 2^-12 (float32: 2^-20) is counted, not gated.
PLANTED_DK = {"float32": 2.0 ** -16, "bfloat16": 2.0 ** -8}
BELOW_DK = {"float32": 2.0 ** -20, "bfloat16": 2.0 ** -12}
# Gate bounds on max |kernel - plain| / max |plain|.  float32: the two
# differ only in summation order (TF32 is off), ~1e-6 expected.  bfloat16:
# both round intermediates to bf16 (2^-8 relative) at different points.
REL_BOUND = {"float32": 1e-4, "bfloat16": 3e-2}
# P2 against K3 on the same inputs, max |P2 - K3| / max |K3|.  float32:
# K3's tile with a one-stage ring, the same arithmetic in the same order
# (bit for bit expected).  bfloat16:
# the same rounding points, sums in another order (wgmma against mma.sync)
# and P's exponent as one FFMA; 2.6e-3 measured on an H100, K3 against
# the plain version 5.1e-3.
PIPE_K3_REL = {"float32": 1e-6, "bfloat16": 1e-2}
# Phase 4g: the video CLI on a synthetic clip of SceneFlow's frame size,
# at its default 256 x 512 content and 256^2 style, --chunk 1 and 8.
CLI_FRAMES, CLI_CLIP_HW, CLI_HW = 16, (540, 960), (256, 512)
# Phase 8, the evals.  The Sintel eval stylises 360 x 640 frames (a 45 x
# 80 patch grid: 3600 content tokens) against a 256^2 style (1024 tokens):
# 3600 is not a multiple of the attention kernels' 64-key tiles or of
# their 128- and 256-query blocks, and the tail's 180 x 320 input is not a
# multiple of its 8 x 32 up3 tile in height.  The video eval's 256 x 512
# frame runs K4 at N = 2048 against M = 1024 (make_stylize_with_fs_fn, the
# path without cached style K/V).  (gate, kind, tokens or shape.)
EVAL_GATES = [
    ("K1 L=3600", "attention", 3600),
    ("K2 N=3600", "ln_matmul", 3600),
    ("K4 N=3600 M=1024", "mhada", (3600, 1024)),
    ("K5 180x320->360x640", "tail", (180, 320)),
    ("K4 N=2048 M=1024", "mhada", (2048, 1024)),
]
# Sintel's frames (1024 x 436) and the eval's default working size; the
# video eval's clip (phase 4g's frame size), its frames and pairs.
SINTEL_FRAME_HW, SINTEL_HW = (436, 1024), (360, 640)
EVAL_CLIP_FRAMES, EVAL_PAIRS = 8, 4
# The metrics on the card against the same functions on the CPU, each
# quantity against its own scale.  Both compute in float32 (TF32 off) and
# differ in summation order only; a TF32 conv or matmul gives ~1e-3.
# SIFID: a Fréchet distance through sqrtm of near-singular covariances.
METRIC_REL, SIFID_REL = 1e-4, 1e-3
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
# The bf16 mma.sync kernels of K1 and K6 (csrc/attention_mma.cuh,
# csrc/attention_bwd_mma.cuh), K3, K4 and K7 (csrc/mhada_mma.cuh: K3, K4
# and K7's forward; csrc/mhada_bwd_mma.cuh), K5 and K8
# (csrc/decoder_tail_mma.cuh), K2 (csrc/ln_matmul_mma.cuh), K14
# (csrc/decoder_mid_mma.cuh) and K13 (csrc/decoder_c6_mma.cuh) and the
# instruction each must contain.
MMA_KERNELS = ("attention_mma_fwd_kernel", "attention_mma_dkv_kernel",
               "attention_mma_dq_kernel", "mhada_mma_fwd_kernel",
               "mhada_mma_dkv_kernel", "mhada_mma_dq_kernel",
               "decoder_tail_mma_kernel", "ln_matmul_mma_kernel",
               "decoder_mid_mma_kernel", "decoder_c6_mma_kernel")
HMMA = "HMMA.16816.F32.BF16"
# The float32 tail's two kernels (csrc/decoder_tail_f32.cuh), timed apart
# by name in the K5 and K8 gates.
TAIL_STAGES = ("tail_up3_f32_kernel", "tail_c5c6_f32_kernel")
# The bf16 wgmma + TMA kernels (P2: csrc/mhada_wgmma.cuh; P1, each block
# tile: csrc/mm_wgmma.cuh) and the instructions each must contain: HGMMA
# (wgmma) and UTMALDG (TMA loads).
WGMMA_KERNELS = ("mhada_wgmma_kernel", "mm_wgmma_kernel")
WGMMA_SASS = ("HGMMA", "UTMALDG")
# Instantiations (mangled-name parts) that the bf16 paths launch: K4's
# MHAda tile (neither prologue nor residuals), K5's and K8's tail, K2,
# K14, K13.
MMA_REQUIRED = ("mhada_mma_fwd_kernelILb0ELb0E",
                "decoder_tail_mma_kernelILb0E", "decoder_tail_mma_kernelILb1E",
                "ln_matmul_mma_kernel", "decoder_mid_mma_kernel",
                "decoder_c6_mma_kernel")
# bf16 instantiations of the CUDA-core kernels that no path may reach any
# more (mangled names): the attention and MHAda tile (K1, K4, K6's and
# K7's forwards) and backward (K6, K7), the decoder tail (K5, K8), K2's
# first kernel and K14's conv.  Also the float32 instantiations that a
# float32 redesign replaced: K14's old conv at either dtype
# (conv3x3_relu_kernel<T>), P1's wmma kernel (mm_probe_kernel, before
# csrc/mm_wgmma.cuh), every instantiation of the old flash tile
# (flash_tile_kernel: K1's, K4's, K6's and K7's float32 forwards before the
# float32 flash tile), the old float32 flash backward's two kernels (K6's
# and K7's), the old fused float32 tail (decoder_tail_kernel<bool>: K5's
# and K8's before csrc/decoder_tail_f32.cuh) and K13's first kernel at
# either dtype (decoder_c6_kernel<T>, before csrc/decoder_c6_f32.cuh and
# csrc/decoder_c6_mma.cuh).
OLD_BF16 = (r"flash_tile_kernel"
            r"|flash_bwd_(dkv|dq)_kernelI13__nv_bfloat16"
            r"|decoder_tail_kernelI13__nv_bfloat16"
            r"|ln_matmul_kernelI13__nv_bfloat16"
            r"|conv3x3_relu_kernelI"
            r"|mm_probe_kernel"
            r"|flash_bwd_(dkv|dq)_kernelIf"
            r"|decoder_tail_kernelILb"
            r"|decoder_c6_kernel")
# float32 kernels that compute in float32: they must exist, spill nothing
# and hold no tensor-core instruction of any kind (HMMA, HGMMA: no TF32).
# K2's float32 build, the float32 flash tile (csrc/mhada_f32_tile.cuh: the
# MHAda kernel of K4, K3, P2 and K7's forward, the attention kernel of K1
# and K6's forward), the float32 flash backward (csrc/flash_bwd_f32.cuh:
# K6's and K7's dK/dV and dQ kernels) and the float32 tail
# (csrc/decoder_tail_f32.cuh: K5's and K8's up3 kernel and upsample + c5 +
# c6 kernel), K14's conv (csrc/decoder_mid_f32.cuh) and K13's
# (csrc/decoder_c6_f32.cuh).
F32_KERNELS = ("ln_matmul_f32_kernel", "mhada_f32_kernel",
               "attention_f32_kernel", "flash_bwd_f32_dkv_kernel",
               "flash_bwd_f32_dq_kernel", "tail_up3_f32_kernel",
               "tail_c5c6_f32_kernel", "decoder_mid_f32_kernel",
               "decoder_c6_f32_kernel")
# The float32 instantiations that the paths and P2 launch (mangled): the
# MHAda kernel's <prologue, ring stages, residuals>, K4 <false, 2, false>,
# K3 <true, 2, false>, P2 <true, 1, false>, K7's forward <false, 2, true>;
# the attention kernel's <lse>, K1 <false>, K6's forward <true>; the
# backward's <mhada>, K6 <false>, K7 <true>; the tail's up3 kernel (K5 and
# K8) and its c5 + c6 kernel <residuals>, K5 <false>, K8 <true>; K14's;
# K13's.
F32_REQUIRED = ("mhada_f32_kernelILb0ELi2ELb0E",
                "mhada_f32_kernelILb1ELi2ELb0E",
                "mhada_f32_kernelILb1ELi1ELb0E",
                "mhada_f32_kernelILb0ELi2ELb1E",
                "attention_f32_kernelILb0E", "attention_f32_kernelILb1E",
                "flash_bwd_f32_dkv_kernelILb0E",
                "flash_bwd_f32_dkv_kernelILb1E",
                "flash_bwd_f32_dq_kernelILb0E",
                "flash_bwd_f32_dq_kernelILb1E", "tail_up3_f32_kernel",
                "tail_c5c6_f32_kernelILb0E", "tail_c5c6_f32_kernelILb1E",
                "decoder_mid_f32_kernel", "decoder_c6_f32_kernel")


def all_gates():
    """GATES and one P1 gate per shape of the probe (bfloat16 only)."""
    from mhada_tpu_torch.probes.mm_probe import SHAPES

    return GATES + [(f"P1 {m}x{k}x{n}", "P1 mm_probe", "mm", i, 1)
                    for i, (m, k, n) in enumerate(SHAPES)]


def phase(name, ok, detail):
    print(f"[{'PASS' if ok else 'FAIL'}] {name}: {detail}", flush=True)
    return ok


def _children() -> dict:
    """{pid: command line} of this process's running children (/proc)."""
    kids = {}
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat") as f:
                state, ppid = f.read().rsplit(")", 1)[1].split()[:2]
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
        except OSError:   # it ended meanwhile
            continue
        if int(ppid) == os.getpid() and state != "Z":
            kids[int(pid)] = cmd.strip()[:160]
    return kids


def stop_children() -> list[str]:
    """Stop every process this script started that still runs, and say
    which.  The training CLIs' loaders spawn workers and, through their
    queues' semaphores, multiprocessing's resource tracker, which lives
    until its owner exits: shut the tracker down, then end any other
    child (SIGTERM, then SIGKILL after 5 s) and reap it."""
    import gc
    import signal
    from multiprocessing import active_children, resource_tracker

    gc.collect()   # a loader iterator still referenced shuts its workers
    found = [f"{pid} {cmd}" for pid, cmd in sorted(_children().items())]
    for p in active_children():
        p.terminate()
        p.join(5)
    tracker = resource_tracker._resource_tracker
    if getattr(tracker, "_pid", None) is not None:
        tracker._stop()
    deadline = time.monotonic() + 5
    for sig in (signal.SIGTERM, signal.SIGKILL):
        for pid in _children():
            with contextlib.suppress(ProcessLookupError):
                os.kill(pid, sig)
        while _children() and time.monotonic() < deadline:
            time.sleep(0.05)
        deadline = time.monotonic() + 5
    with contextlib.suppress(ChildProcessError):   # reap what was killed
        while os.waitpid(-1, os.WNOHANG)[0]:
            pass
    return found


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


def mma_report(lib):
    """The bf16 tensor-core kernels in the built library -> (ok, text): each
    kernel's registers and spilled bytes (ptxas), its count of HMMA in the
    SASS (cuobjdump; the wgmma kernels: HGMMA and UTMALDG), any
    instantiation of MMA_REQUIRED or F32_REQUIRED that is missing, and any
    instantiation of a CUDA-core kernel that a redesign replaced
    (OLD_BF16), which no path may reach; the float32 kernels (F32_KERNELS)
    with their registers and spills (none allowed) and no tensor-core
    instruction."""
    from mhada_tpu_torch import _build

    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300).stdout
    funcs = {c.split(None, 1)[0]: c for c in sass.split("Function : ")[1:]}
    ptxas, name = {}, None
    for ln in lib.with_suffix(".log").read_text().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and name:
            ptxas.setdefault(name, {})["spill"] = int(m[1]) + int(m[2])
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            ptxas.setdefault(name, {})["regs"] = int(m[1])
    ok, out = True, []
    for kernel in MMA_KERNELS:
        found = [f for f in funcs if kernel in f]
        ok = ok and bool(found)
        for f in found:
            hmma = funcs[f].count(HMMA)
            info = ptxas.get(f, {})
            ok = ok and hmma > 0 and info.get("spill") == 0
            out.append(f"{f}: {info.get('regs')} regs, {info.get('spill')} "
                       f"B spilled, {hmma} x {HMMA}")
    for kernel in WGMMA_KERNELS:
        found = [f for f in funcs if kernel in f]
        ok = ok and bool(found)
        for f in found:
            counts = {ins: funcs[f].count(ins) for ins in WGMMA_SASS}
            info = ptxas.get(f, {})
            ok = ok and all(counts.values()) and info.get("spill") == 0
            out.append(f"{f}: {info.get('regs')} regs (the launch bound; "
                       f"setmaxnreg moves them between warpgroups), "
                       f"{info.get('spill')} B spilled, " + ", ".join(
                           f"{n} x {ins}" for ins, n in counts.items())
                       + f", {funcs[f].count(HMMA)} x {HMMA}")
    missing = [m for m in MMA_REQUIRED + F32_REQUIRED
               if not any(m in f for f in funcs)]
    out.append(f"missing instantiations: {missing or 'none'}")
    old = [f for f in funcs if re.search(OLD_BF16, f)]
    out.append(f"replaced CUDA-core instantiations: {old or 'none'}")
    for kernel in F32_KERNELS:
        found = [f for f in funcs if kernel in f]
        tc = sum(funcs[f].count(ins) for f in found
                 for ins in ("HMMA", "HGMMA"))
        spills = [ptxas.get(f, {}).get("spill") for f in found]
        ok = ok and bool(found) and tc == 0 and all(n == 0 for n in spills)
        out.append(f"{kernel} (float32): {len(found)} found, "
                   f"{[ptxas.get(f, {}).get('regs') for f in found]} regs, "
                   f"{spills} B spilled, {tc} x HMMA or HGMMA of any kind")
    return ok and not missing and not old, "; ".join(out)


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


def split_ms(fn, parts, iters=3, windows=3):
    """{part: device ms per call of the kernels whose names hold ``part``}
    from ``torch.profiler`` over ``iters`` calls of ``fn`` after one.  A
    window in which the profiler recorded no kernel of some part (CUPTI
    has returned a window without device events on an H100) is profiled
    again, up to ``windows`` windows; the last one's reading is returned,
    and the callers fail on a part still at 0."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        out = dict.fromkeys(parts, 0.0)
        for e in prof.key_averages():
            for part in parts:
                if part in e.key:
                    out[part] += e.self_device_time_total / 1e3 / iters
        if all(out.values()):
            break
    return out


def tail_stage_ms(split):
    """The float32 tail's stage times from ``split_ms`` over TAIL_STAGES."""
    return {"up3_ms": split[TAIL_STAGES[0]], "c5c6_ms": split[TAIL_STAGES[1]]}


def tail_stage_txt(split):
    up3, c5c6 = (split[p] for p in TAIL_STAGES)
    return f" (profiler: up3 {up3:.3f} + upsample, c5 and c6 {c5c6:.3f} ms)"


def bound(flops, nbytes, dname):
    """(least ms the card could take, the resource that sets it)."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dname], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def mhada_sdpa(q, k, v, heads):
    """The MHAda core's products as one library call, from token-major q
    (B, N, C) and k, v (B, M, C): a call of SDPA on (B, H, L, 64) views and
    the (B, H, M, 128) [V | V^2] (V^2 squared in v's dtype, made here), with
    scale 1 -> (B, H, N, 128), M1 | E2.  It leaves out the MHAda epilogue
    (and K3's instance norm and projection)."""
    import torch
    import torch.nn.functional as F

    qh, kh, vh = (t.unflatten(-1, (heads, -1)).transpose(1, 2)
                  for t in (q, k, v))
    vv = torch.cat([vh, vh * vh], dim=-1)
    return lambda: F.scaled_dot_product_attention(qh, kh, vv, scale=1.0)


def sdpa_backend(run):
    """The first SDPA backend (flash, cuDNN, memory-efficient, math) under
    which ``run()`` completes -> (its name, ``run`` under it): flash may
    refuse a value head dim unlike the query's, and float32."""
    import warnings

    from torch.nn.attention import SDPBackend, sdpa_kernel

    names = ("FLASH_ATTENTION", "CUDNN_ATTENTION", "EFFICIENT_ATTENTION",
             "MATH")
    for be in (getattr(SDPBackend, n) for n in names if hasattr(SDPBackend,
                                                                 n)):
        try:
            with warnings.catch_warnings(), sdpa_kernel(be):
                warnings.simplefilter("ignore")
                run()
        except RuntimeError:
            continue

        def forced(be=be):
            with sdpa_kernel(be):
                return run()
        return be.name.lower(), forced
    raise RuntimeError("no SDPA backend takes the MHAda yardstick")


def mhada_library(q, k, v, heads, what):
    """(name, call) of the MHAda yardstick on the gate's inputs."""
    backend, call = sdpa_backend(mhada_sdpa(q, k, v, heads))
    return (f"{MHADA_SDPA} ({backend} backend); leaves out {what}", call)


def prologue_library(fc, stats, wf, fb, k, v, heads):
    """(name, call) of the MHAda yardstick for K3 and P2: its q is the
    prologue's (IN(fc) Wf_h + fb_h, rounded as the plain version rounds),
    made outside the timing."""
    import torch

    dtype = fc.dtype
    qn = ((fc.float() - stats[:, None, 0]) * stats[:, None, 1]).to(dtype)
    q = (torch.einsum("bnhd,hde->bnhe", qn.float().unflatten(-1, (heads, 64)),
                      wf.to(dtype).float())
         + fb.to(dtype).float()).flatten(2).to(dtype)
    return mhada_library(q, k, v, heads, "K3's instance norm and projection "
                         "and the MHAda epilogue")


def gate_inputs(kind, n, dtype, g, b=1):
    """Seeded inputs of one kernel at ``n`` tokens (K4: n or (queries,
    keys); K5, K13: an n x n input or (height, width); K14: an n x n
    input; P1: the probe's shape number n) and batch ``b`` -> (call(backend),
    flops, bytes moved, (name, call) of one library call or None).

    Bytes count each input read once and each output written once; flops
    count the products (and the projection of K3)."""
    import torch
    import torch.nn.functional as F

    from mhada_tpu_torch.ops import (attention_kernel, decoder_c6,
                                     decoder_mid, decoder_tail, ln_matmul,
                                     mhada_kernel, mhada_prologue)
    from mhada_tpu_torch.ops.instance_norm import instance_norm_stats
    from mhada_tpu_torch.ops.pad_conv import conv2d_reflect
    from mhada_tpu_torch.probes import mhada_pipe_probe, mm_probe

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

        return (lambda be: attention_kernel.attention_tm(qkv, heads,
                                                         backend=be),
                4 * n * n * c, 4 * n * c * es, (SDPA, sdpa))
    if kind == "ln_matmul":
        x = rnd(1, n, c)
        lw = (1 + 0.1 * torch.randn(c, generator=g)).to(dev)
        lb = (0.1 * torch.randn(c, generator=g)).to(dev)
        fs = (1536, 2048)
        ws = [(torch.randn(f, c, generator=g) / c ** 0.5).to(dev) for f in fs]
        bs = [(0.1 * torch.randn(f, generator=g)).to(dev) for f in fs]

        def run(be):
            return torch.cat([ln_matmul.ln_matmul(x, lw, lb, w, bb,
                                                  backend=be)
                              for w, bb in zip(ws, bs)], dim=-1)

        # timed beside the wrapper (float32 weights cast per call, the two
        # outputs concatenated): the kernel alone and the library chain,
        # both on the same inputs cast once to the compute dtype
        lwt, lbt = lw.to(dtype), lb.to(dtype)
        pairs = [(w.to(dtype), bb.to(dtype)) for w, bb in zip(ws, bs)]
        run.kernel_alone = lambda: [
            ln_matmul._ln_matmul_kernel(x, lwt, lbt, w, bb, 1e-6)
            for w, bb in pairs]
        return (run, sum(2 * n * c * f for f in fs),
                sum((n * c + f * c + n * f + 2 * c + f) * es for f in fs),
                (LN_CHAIN, ln_chain(x, lwt, lbt, pairs)))
    if kind == "prologue":
        fc, fcs = rnd(1, n, c, scale=2.0) + 1, rnd(1, n, c, scale=3.0) - 1
        mc, rc = instance_norm_stats(fc)
        ms, rs = instance_norm_stats(fcs)
        stats = torch.stack([mc, rc, ms, rs], 1)
        # the block's init U(-1/8, 1/8); k at scale 0.35: logit std ~1.6
        wf = ((torch.rand(heads, 64, 64, generator=g) * 2 - 1) / 8).to(dev)
        fb = ((torch.rand(heads, 64, generator=g) * 2 - 1) / 8).to(dev)
        k, v = rnd(1, n, c, scale=0.35), rnd(1, n, c)
        return (lambda be: mhada_prologue.mhada_fused_prologue(
            fc, fcs, stats, wf, fb, k, v, backend=be),
            6 * n * n * c + 2 * n * c * 64,
            5 * n * c * es + 4 * c * 4 + heads * 64 * (64 * es + 4),
            prologue_library(fc, stats, wf, fb, k, v, heads))
    if kind == "mhada":   # n queries against n keys, or (N, M)
        nq, nk = (n, n) if isinstance(n, int) else n
        q, k = rnd(1, nq, c, scale=0.35), rnd(1, nk, c, scale=0.35)
        v, f = rnd(1, nk, c), rnd(1, nq, c)
        return (lambda be: mhada_kernel.mhada_tm(q, k, v, f, heads,
                                                 backend=be),
                6 * nq * nk * c, (3 * nq + 2 * nk) * c * es,
                mhada_library(q, k, v, heads, "the MHAda epilogue"))
    def conv(co, ci):
        """A conv's init U(-1/sqrt(fan_in), 1/sqrt(fan_in)), float32."""
        bound_ = 1 / (ci * 9) ** 0.5
        w = (torch.rand(co, ci, 3, 3, generator=g) * 2 - 1) * bound_
        bias = (torch.rand(co, generator=g) * 2 - 1) * bound_
        return w.to(dev), bias.to(dev)

    if kind == "tail":   # an n x n input, or (height, width)
        hh, ww = (n, n) if isinstance(n, int) else n
        x = rnd(1, hh, ww, 128).abs()

        (wu, bu), (w5, b5), (w6, b6) = conv(64, 128), conv(64, 64), conv(3, 64)
        lo, hi = hh * ww, 4 * hh * ww
        flops = 2 * 9 * (lo * 128 * 64 + hi * 64 * 64 + hi * 64 * 3)
        nbytes = (lo * 128 + hi * 3) * es + 9 * 64 * (128 + 64 + 3) * es

        def run(be):
            return decoder_tail.decoder_tail(x, wu, bu, w5, b5, w6, b6,
                                             backend=be)

        run.stages = TAIL_STAGES   # timed apart at float32
        return run, flops, nbytes, None
    if kind == "c6":
        hh, ww = (n, n) if isinstance(n, int) else n
        y = rnd(b, hh, ww, 64).abs()   # c5 is post-ReLU
        w6, b6 = conv(3, 64)
        # the yardstick: one cuDNN conv on the reflect-padded c5 (padded
        # outside the timing), NCHW view of the NHWC tensor, TF32 off
        yp = F.pad(y.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
        w6t, b6t = w6.to(dtype), b6.to(dtype)

        def run(be):
            return decoder_c6.c6_conv(y, w6, b6, backend=be)

        # timed beside the wrapper (weights converted per call): the launch
        # on weights converted once
        kparams = decoder_c6.kernel_params(w6, b6, dtype)
        run.kernel_alone = lambda: decoder_c6._kernel(y, *kparams)
        return (run, 2 * 9 * 64 * 3 * b * hh * ww,
                b * hh * ww * (64 + 3) * es + 9 * 64 * 3 * es + 3 * 4,
                ("torch.nn.functional.conv2d on the reflect-padded c5, TF32 "
                 "off", lambda: F.conv2d(yp, w6t, b6t)))
    if kind == "mid":
        c = 256
        x = rnd(b, n, n, c).abs()   # up1's output is post-ReLU
        params = [t for _ in range(3) for t in conv(c, c)]

        def convrelu3():
            h = x
            for w, bias in zip(params[::2], params[1::2]):
                h = torch.relu(conv2d_reflect(h, w.to(dtype), bias.to(dtype)))
            return h

        def run(be):
            return decoder_mid.mid3_fused(x, *params, backend=be)

        # timed beside the wrapper (weights converted per call): the three
        # launches on weights converted once
        kparams = decoder_mid.kernel_params(params[::2], params[1::2], dtype)
        run.kernel_alone = lambda: decoder_mid._kernel(x, *kparams)
        return (run, 3 * 2 * 9 * c * c * b * n * n,
                (2 * b * n * n * c + 3 * 9 * c * c + 3 * c) * es,
                ("three cuDNN ConvReLUs (ops.pad_conv.conv2d_reflect + relu, "
                 "TF32 off)", convrelu3))
    if kind == "pipe":
        inputs = mhada_pipe_probe.probe_inputs(b, n, n, c, heads, dtype, dev)
        fc, _, stats, wf, fb, k, v = inputs
        return (lambda be: mhada_pipe_probe.mhada_fused_prologue_pipe(
            *inputs, backend=be),
            *mhada_pipe_probe.work(b, n, n, c, heads, dtype),
            prologue_library(fc, stats, wf, fb, k, v, heads))
    if kind == "mm":
        m, k, nn = mm_probe.SHAPES[n]
        a, bm = mm_probe.operands(m, k, nn, dev)

        def plain():
            for _ in range(MM_REPS):
                out = mm_probe.mm_plain(a, bm)
            return out

        def run(be):
            return mm_probe.mm(a, bm, MM_REPS) if be == "kernel" else plain()

        run.tile = mm_probe.tile(m, k, nn)
        return (run,
                2 * m * k * nn * MM_REPS, (m * k + k * nn + m * nn) * es,
                (f"torch.matmul (cuBLAS), {MM_REPS} calls replayed from a "
                 "CUDA graph", mm_probe.cublas_loop(a, bm, MM_REPS)))
    raise KeyError(kind)


def run_gate(gate, kind, n, b, dname, card):
    """Kernel against plain on the same seeded inputs -> (ok, record)."""
    import torch

    dtype = getattr(torch, dname)
    g = torch.Generator().manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats()
    run, flops, nbytes, lib = gate_inputs(kind, n, dtype, g, b)
    lib_name, lib = lib or (NO_LIB, None)
    reps = (3, 10) if (n if isinstance(n, int) else max(n)) <= 4096 \
        else (1, 3)
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
        alone = getattr(run, "kernel_alone", None)   # K2, K13, K14: no casts
        kernel_ms = cuda_ms(alone, *reps) if alone else None
        stages = getattr(run, "stages", None) if dname == "float32" else None
        split = split_ms(lambda: run("kernel"), stages) if stages else None
    bound_ms, bound_by = bound(flops, nbytes, dname)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.empty_cache()
    rec = dict(max_abs_err=mx, mean_abs_err=mean, ms=ms, plain_ms=plain_ms,
               bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
               library=lib_name, gflop=flops / 1e9, mbytes=nbytes / 1e6)
    lib_txt = (f"{library_ms:.3f} ms ({lib_name})" if lib
               else "none (no single call)")
    if kernel_ms is not None:
        rec["kernel_ms"] = kernel_ms
        lib_txt += f", the kernel alone {kernel_ms:.3f} ms"
    tile = getattr(run, "tile", None)   # P1: the kernel's block tile
    if tile:
        rec["tile"] = list(tile)
        lib_txt += f", block tile {tile[0]} x {tile[1]}"
    if split:
        rec.update(tail_stage_ms(split))
        good = good and all(t > 0 for t in split.values())
        lib_txt += tail_stage_txt(split)
    return phase(
        f"gate {gate} {dname}", good,
        f"max|d| {mx:.3e} mean|d| {mean:.3e} max|ref| {scale:.3e} rel "
        f"{rel:.3e} (bound {REL_BOUND[dname]:.0e}); kernel {ms:.3f} ms "
        f"({100 * bound_ms / ms:.0f} % of the bound), plain {plain_ms:.3f} "
        f"ms, library {lib_txt}, card bound "
        f"{bound_ms:.3f} ms ({bound_by}; {flops / 1e9:.1f} GFLOP, "
        f"{nbytes / 1e6:.1f} MB at the published 700 W peaks; this card: "
        f"{card}); peak memory {peak_gb:.2f} GB"), rec


def pipe_against_k3(dname):
    """P2 against K3 on the same inputs at the probe's shape (B = 8, N = M =
    4096) in ``dname`` -> ok."""
    import torch

    from mhada_tpu_torch.ops.mhada_prologue import mhada_fused_prologue
    from mhada_tpu_torch.probes import mhada_pipe_probe as pp

    label = f"P2 against K3 {dname}"
    try:
        inputs = pp.probe_inputs(**pp.SHAPE, dtype=getattr(torch, dname),
                                 device="cuda")
        with torch.inference_mode():
            pipe = pp.mhada_fused_prologue_pipe(*inputs).float()
            k3 = mhada_fused_prologue(*inputs).float()
            rel = (pipe - k3).abs().max().item() / k3.abs().max().item()
    except Exception as e:
        return phase(label, False, f"{type(e).__name__}: {e}")
    return phase(label, rel <= PIPE_K3_REL[dname],
                 f"max|P2 - K3| / max|K3| {rel:.3e} (bound "
                 f"{PIPE_K3_REL[dname]:.1e})")


def run_probes(launches):
    """The probes' CLIs at their shapes (P1 with fewer repetitions), each
    with the launch counts set to 0 just before and read just after into
    ``launches`` -> ok."""
    import torch

    from mhada_tpu_torch import _build
    from mhada_tpu_torch.probes import mhada_pipe_probe, mm_probe

    ok = True
    for key, entry, main, argv in (
            ("probe_mm", MM, mm_probe.main, ["--reps", "40", "--iters", "2"]),
            ("probe_pipe", PIPE, mhada_pipe_probe.main, ["--iters", "3"]),
            ("probe_pipe_f32", PIPE, mhada_pipe_probe.main,
             ["--iters", "3", "--dtype", "float32"])):
        try:
            _build.reset_launches()
            main(argv)
            torch.cuda.synchronize()
            launches[key] = dict(_build.LAUNCHES)
        except Exception as e:
            ok = phase(f"probe {key}", False, f"{type(e).__name__}: {e}")
            continue
        ok = phase(f"probe {key}", launches[key][entry] > 0,
                   f"{entry} launched {launches[key][entry]} times") and ok
    return ok


def train_gate_inputs(kind, dtype, g, b, n):
    """Seeded inputs of one training kernel at batch ``b`` and ``n`` tokens
    (K7: n or (queries, keys); K8: an n x n or (height, width) input) ->
    dict: ``run(backend, *inputs)`` through the
    autograd Function (K2: against autograd of the unfused plain LayerNorm
    and linear), the ``inputs`` and output cotangent ``cot``; ``fwd`` /
    ``bwd``: backend -> call of the forward (outputs and residuals) and of
    the backward alone on the plain forward's residuals (None where the
    backward has no kernel); ``bwd_plain``: None, or a call that prepares
    the plain PyTorch backward of a kernel that has none and returns it;
    ``names``: part -> the name of each output of ``fwd``, ``bwd`` and of
    the input gradients (``grad``; K6's packed d qkv is split into dq, dk,
    dv); flops and bytes of each; the library yardsticks or None."""
    import torch
    import torch.nn.functional as F

    from mhada_tpu_torch.ops import attention_train as at
    from mhada_tpu_torch.ops import decoder_tail as dtl
    from mhada_tpu_torch.ops import ln_matmul as lm
    from mhada_tpu_torch.ops import mhada_train as mt

    dev, c, heads = "cuda", 512, 8
    es = torch.tensor([], dtype=dtype).element_size()
    n, m = (n, n) if isinstance(n, int) else n

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dev, dtype)

    if kind == "attention":
        scale = 0.125
        qkv, cot = rnd(b, n, 3 * c), rnd(b, n, c)
        out, lse = at.attention_train_fwd_plain(qkv, heads, scale)
        delta = at.row_delta(cot, out, heads)
        lib_in = qkv.detach().requires_grad_()
        q, k, v = (t.unflatten(-1, (heads, 64)).transpose(1, 2)
                   for t in lib_in.split(c, dim=-1))
        lib_out = F.scaled_dot_product_attention(q, k, v)
        lib_cot = cot.unflatten(-1, (heads, 64)).transpose(1, 2)
        return dict(
            run=lambda be, x: at.attention_train(x, heads, scale, be),
            inputs=[qkv], cot=cot,
            fwd={"kernel": lambda: at._fwd_kernel(qkv, heads, scale),
                 "plain": lambda: at.attention_train_fwd_plain(
                     qkv, heads, scale)},
            bwd={"kernel": lambda: at._bwd_kernel(
                qkv, lse, delta, cot, heads, scale).chunk(3, dim=-1),
                 "plain": lambda: at.attention_train_bwd_plain(
                     qkv, lse, delta, cot, heads, scale).chunk(3, dim=-1)},
            bwd_plain=None,
            names={"fwd": ["out", "lse"], "bwd": ["dq", "dk", "dv"],
                   "grad": ["dq", "dk", "dv"]},
            flops=(4 * b * n * n * c, 10 * b * n * n * c),
            bytes=(4 * b * n * c * es + 4 * b * heads * n,
                   7 * b * n * c * es + 8 * b * heads * n),
            lib=((SDPA, lambda: F.scaled_dot_product_attention(q, k, v)),
                 (f"backward of {SDPA} (torch.autograd.grad)",
                  lambda: torch.autograd.grad(lib_out, lib_in, lib_cot,
                                              retain_graph=True))))
    if kind == "mhada":
        q, k = rnd(b, n, c, scale=0.35), rnd(b, m, c, scale=0.35)
        v, f, cot = rnd(b, m, c), rnd(b, n, c), rnd(b, n, c)
        _, m1, e2, lse = mt.mhada_train_fwd_plain(q, k, v, f, heads)
        dm1, de2, delta, _ = mt.mhada_train_prologue(cot, f, m1, e2, heads,
                                                     dtype)
        # the yardstick's backward: autograd of SDPA on [V | V^2] (and of
        # the square and concatenation) from [dM1 | dE2], the graph built
        # once under the first backend whose backward runs
        lib_in = [t.detach().requires_grad_() for t in (q, k, v)]
        lib_cot = torch.cat([t.unflatten(-1, (heads, 64)).transpose(1, 2)
                             for t in (dm1, de2)], dim=-1)

        def lib_graph():
            out = mhada_sdpa(*lib_in, heads)()
            torch.autograd.grad(out, lib_in, lib_cot, retain_graph=True)
            return out

        lib_backend, lib_graph = sdpa_backend(lib_graph)
        lib_out = lib_graph()
        return dict(
            run=lambda be, *a: mt.mhada_train(*a, heads, be),
            inputs=[q, k, v, f], cot=cot,
            fwd={"kernel": lambda: mt._fwd_kernel(q, k, v, f, heads),
                 "plain": lambda: mt.mhada_train_fwd_plain(q, k, v, f,
                                                           heads)},
            bwd={"kernel": lambda: mt._bwd_kernel(q, k, v, dm1, de2, lse,
                                                  delta, heads),
                 "plain": lambda: mt.mhada_train_bwd_plain(
                     q, k, v, dm1, de2, lse, delta, heads)},
            bwd_plain=None,
            names={"fwd": ["out", "M1", "E2", "lse"],
                   "bwd": ["dq", "dk", "dv"],
                   "grad": ["dq", "dk", "dv", "dfcs_n"]},
            flops=(6 * b * n * m * c, 14 * b * n * m * c),
            bytes=((3 * n + 2 * m) * b * c * es + 8 * b * n * c
                   + 4 * b * heads * n,
                   (4 * n + 4 * m) * b * c * es + 8 * b * heads * n),
            lib=(mhada_library(q, k, v, heads, "the MHAda epilogue"),
                 (f"backward of {MHADA_SDPA} ({lib_backend} backend; "
                  "torch.autograd.grad); leaves out the MHAda prologue",
                  lambda: torch.autograd.grad(lib_out, lib_in, lib_cot,
                                              retain_graph=True))))
    if kind == "tail":
        h, w = n, m
        x = rnd(b, h, w, 128).abs()

        def conv(co, ci):
            # biases shifted positive, as in tests/test_torch_cuda.py: few
            # pre-activations sit at 0, where the ReLU masks of any two
            # roundings disagree and the gradients with them
            bound_ = 1 / (ci * 9) ** 0.5
            w = (torch.rand(co, ci, 3, 3, generator=g) * 2 - 1) * bound_
            bb = torch.rand(co, generator=g) * 2 * bound_
            return w.to(dev, dtype), bb.to(dev, dtype)

        ws = [*conv(64, 128), *conv(64, 64), *conv(3, 64)]
        cot = rnd(b, 2 * h, 2 * w, 3)
        hi = b * 4 * h * w

        def tail_bwd():
            # K8's backward is plain PyTorch on the kernel's residuals
            res = dtl._launch_tail("mhada_decoder_tail_res", x, *ws)
            return lambda: dtl.decoder_tail_bwd(cot, x, ws[0], ws[2], ws[4],
                                                *res)

        return dict(
            run=lambda be, *a: dtl.decoder_tail_train(*a, backend=be),
            inputs=[x, *ws], cot=cot,
            fwd={"kernel": lambda: dtl._launch_tail(
                "mhada_decoder_tail_res", x, *ws),
                 "plain": lambda: dtl.decoder_tail_res_plain(x, *ws)},
            bwd=None, bwd_plain=tail_bwd,
            names={"fwd": ["rgb", "y1", "c5"],
                   "grad": ["dx", "dw_up", "db_up", "dw5", "db5", "dw6",
                            "db6"]},
            flops=(2 * 9 * (b * h * w * 128 * 64 + hi * 64 * 64
                            + hi * 64 * 3), None),
            bytes=((b * h * w * (128 + 64) + hi * (3 + 64)) * es
                   + 9 * 64 * (128 + 64 + 3) * es, None),
            lib=(None, None))
    if kind == "ln_matmul":
        # one LN affine in front of both of a block's widths (ln1 -> qkv,
        # ln2 -> fc1), every input in the compute dtype as the fused step
        # casts them
        fs = (3 * c, 2048)
        x = rnd(b, n, c)
        lw, lb = 1 + rnd(c, scale=0.1), rnd(c, scale=0.1)
        wbs = [t for f in fs for t in (rnd(f, c, scale=c ** -0.5),
                                       rnd(f, scale=0.1))]
        cot = rnd(b, n, sum(fs))
        pairs = list(zip(wbs[::2], wbs[1::2]))

        def run(be, x, lw, lb, *wb):
            wb = list(zip(wb[::2], wb[1::2]))
            if be == "kernel":
                outs = [lm.ln_matmul(x, lw, lb, w, bb, backend=be)
                        for w, bb in wb]
            else:
                h = lm.layer_norm(x, lw, lb)
                outs = [F.linear(h, w, bb) for w, bb in wb]
            return torch.cat(outs, dim=-1)

        def ln_bwd():
            gs = cot.split(fs, dim=-1)
            return lambda: [lm.ln_matmul_bwd(x, lw, lb, w, gi)
                            for (w, _), gi in zip(pairs, gs)]

        return dict(
            run=run, inputs=[x, lw, lb, *wbs], cot=cot,
            fwd={"kernel": lambda: [lm._ln_matmul_kernel(x, lw, lb, w, bb,
                                                         1e-6)
                                    for w, bb in pairs],
                 "plain": lambda: [lm.ln_matmul_plain(x, lw, lb, w, bb)
                                   for w, bb in pairs]},
            # the forward through the public wrapper, timed beside the
            # kernel alone
            wrapper=lambda: [lm.ln_matmul(x, lw, lb, w, bb)
                             for w, bb in pairs],
            bwd=None, bwd_plain=ln_bwd,
            names={"fwd": ["qkv", "fc1"],
                   "grad": ["dx", "d_ln_w", "d_ln_b", "dw_qkv", "db_qkv",
                            "dw_fc1", "db_fc1"]},
            flops=(sum(2 * b * n * c * f for f in fs), None),
            bytes=(sum((b * n * c + f * c + b * n * f + 2 * c + f) * es
                       for f in fs), None),
            lib=((LN_CHAIN, ln_chain(x, lw, lb, pairs)), None))
    raise KeyError(kind)


def _errs(names, got, ref):
    """{output name: (max |got - ref|, that over max |ref|)}: each output is
    held against its own scale (an attention output of ~0.05 is not
    measured against an lse of ~8)."""
    errs = {}
    for name, a, r in zip(names, got, ref):
        mx = (a.float() - r.float()).abs().max().item()
        errs[name] = (mx, mx / max(r.float().abs().max().item(), 1e-30))
    return errs


def _worst(errs):
    """(largest max |d|, largest relative error) of an ``_errs`` dict."""
    return (max(e[0] for e in errs.values()),
            max(e[1] for e in errs.values()))


def _errs_txt(errs):
    return " ".join(f"{n} {rel:.2e}" for n, (_, rel) in errs.items())


def tail_aligned_grads(d):
    """K8's plain backward on the plain forward's residuals with the kernel
    forward's ReLU masks -> (input gradients, share of the rgb, y1 and c5
    positions where the two forwards' masks differ).

    A mask flips where a pre-activation lies within rounding of 0, and each
    flip moves the gradients by one whole term (87 % of the 1e-3 bound at
    float32 on an H100).  Aligning the masks leaves the flips out of the
    gradient comparison; their share is bounded apart."""
    import torch

    from mhada_tpu_torch.ops import decoder_tail as dtl

    got, ref = d["fwd"]["kernel"](), d["fwd"]["plain"]()
    tiny = torch.finfo(ref[0].dtype).tiny
    flips = sum(int(((a > 0) != (r > 0)).sum()) for a, r in zip(got, ref))
    aligned = [torch.where(a > 0, r.clamp_min(tiny), 0)
               for a, r in zip(got, ref)]
    x, wu, _, w5, _, w6, _ = d["inputs"]
    return (list(dtl.decoder_tail_bwd(d["cot"], x, wu, w5, w6, *aligned)),
            flips / sum(r.numel() for r in ref))


def run_train_gate(gate, kind, dname, card, b, n):
    """A training kernel against its plain versions on the same seeded
    inputs, each output against its own scale: the forward's outputs and
    residuals, the backward alone, and the input gradients through the
    autograd Function -> (ok, {"fwd": rec, "bwd": rec or None, ...})."""
    import torch

    dtype = getattr(torch, dname)
    g = torch.Generator().manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats()
    d = train_gate_inputs(kind, dtype, g, b, n)
    rel_fwd, rel_grad = TRAIN_REL[dname]

    def grads(backend):
        leaves = [t.detach().requires_grad_() for t in d["inputs"]]
        d["run"](backend, *leaves).backward(d["cot"])
        got = [t.grad for t in leaves]
        return list(got[0].chunk(3, dim=-1)) if kind == "attention" else got

    good, recs, lines = True, {}, []
    for part in ("fwd", "bwd"):
        calls = d[part]
        if calls is None:
            recs[part] = None
            continue
        got, ref = calls["kernel"](), calls["plain"]()
        torch.cuda.synchronize()
        errs = _errs(d["names"][part], got, ref)
        mx, rel = _worst(errs)
        finite = all(bool(torch.isfinite(t).all()) for t in got)
        limit = rel_fwd if part == "fwd" else rel_grad
        del got, ref
        ms = cuda_ms(calls["kernel"], 2, 5)
        plain_ms = cuda_ms(calls["plain"], 1, 3)
        lib = d["lib"][0 if part == "fwd" else 1]
        library_ms = cuda_ms(lib[1], 2, 5) if lib else None
        i = 0 if part == "fwd" else 1
        bound_ms, bound_by = bound(d["flops"][i], d["bytes"][i], dname)
        recs[part] = dict(max_abs_err=mx, rel_err=rel,
                          rel_each={k: e[1] for k, e in errs.items()}, ms=ms,
                          plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by, library_ms=library_ms,
                          library=lib[0] if lib else NO_LIB,
                          gflop=d["flops"][i] / 1e9,
                          mbytes=d["bytes"][i] / 1e6)
        good = good and finite and rel <= limit
        split_txt = ""
        if part == "bwd":   # which of the backward's two kernels holds it
            split = split_ms(calls["kernel"], ("dkv_kernel", "dq_kernel"))
            recs[part]["dkv_ms"] = split["dkv_kernel"]
            recs[part]["dq_ms"] = split["dq_kernel"]
            good = good and all(t > 0 for t in split.values())
            split_txt = (f" (profiler: dK/dV kernel {split['dkv_kernel']:.3f}"
                         f" + dQ kernel {split['dq_kernel']:.3f} ms)")
        elif kind == "tail" and dname == "float32":   # K8's two stages
            split = split_ms(calls["kernel"], TAIL_STAGES)
            recs[part].update(tail_stage_ms(split))
            good = good and all(t > 0 for t in split.values())
            split_txt = tail_stage_txt(split)
        lib_txt = f"{library_ms:.3f} ms" if lib else "none"
        if part == "fwd" and "wrapper" in d:   # K2
            recs[part]["wrapper_ms"] = cuda_ms(d["wrapper"], 2, 5)
            lib_txt += f", the wrapper {recs[part]['wrapper_ms']:.3f} ms"
        lines.append(f"{part}: rel {_errs_txt(errs)} (bound {limit:.0e} "
                     f"each; max|d| {mx:.3e}); kernel {ms:.3f} ms{split_txt}"
                     f", plain "
                     f"{plain_ms:.3f} ms, library {lib_txt}, bound "
                     f"{bound_ms:.3f} ms ({bound_by}; the kernel at "
                     f"{100 * bound_ms / ms:.1f} % of it)")
    got, ref = grads("kernel"), grads("plain")
    finite = all(bool(torch.isfinite(t).all()) for t in got)
    names = d["names"]["grad"]
    if kind == "tail":
        flip_txt = f"plain masks: {_errs_txt(_errs(names, got, ref))}; "
        ref, flips = tail_aligned_grads(d)
        good = good and flips <= TAIL_FLIPS[dname]
        flip_txt += (f"masks differ at {flips:.2e} of the positions (bound "
                     f"{TAIL_FLIPS[dname]:.0e}); ")
        recs["mask_flip_share"] = flips
    errs = _errs(names, got, ref)
    mx, rel = _worst(errs)
    good = good and finite and rel <= rel_grad
    torch.cuda.synchronize()
    recs["grad_rel_each"] = {k: e[1] for k, e in errs.items()}
    del got, ref
    if d["bwd_plain"] is not None:   # a backward in plain PyTorch (K2, K8)
        recs["bwd_plain_ms"] = cuda_ms(d["bwd_plain"](), 1, 3)
        lines.append(f"bwd (plain PyTorch) {recs['bwd_plain_ms']:.3f} ms")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del d
    torch.cuda.empty_cache()
    aligned = ("with the kernel's masks " if kind == "tail" else "")
    return phase(
        f"train gate {gate} {dname}", good,
        "; ".join(lines) + f"; input gradients through autograd: "
        f"{flip_txt if kind == 'tail' else ''}against the plain build "
        f"{aligned}rel {_errs_txt(errs)} (bound {rel_grad:.0e} each; max|d| "
        f"{mx:.3e}); peak memory {peak_gb:.2f} GB ({card})"), recs


def step_grads(models, cfg, batch):
    """One forward and backward of the recipe's loss, on ``batch`` =
    (content, style) for the image recipe or (style, c1, c2, flow, mask)
    for the video recipe -> (metrics as floats, {network: {parameter:
    grad}})."""
    from mhada_tpu_torch.ops.pad_conv import no_tf32
    from mhada_tpu_torch.train.recipes import recipe
    from mhada_tpu_torch.train.train_image import TRAINABLE

    for net in TRAINABLE:
        models[net].zero_grad(set_to_none=True)
    with no_tf32():
        loss, metrics = recipe(cfg).loss_fn(models, *batch, cfg)
        loss.backward()
    return ({k: float(v.detach()) for k, v in metrics.items()},
            {net: {k: p.grad for k, p in models[net].named_parameters()}
             for net in TRAINABLE})


def live_tensors(grads):
    """{(network, parameter)} whose gradient exceeds LIVE_FLOOR x its
    network's largest one."""
    live = set()
    for net, want in grads.items():
        top = max(r.abs().max().item() for r in want.values())
        live |= {(net, k) for k, r in want.items()
                 if r.abs().max().item() > LIVE_FLOOR * top}
    return live


def grad_errors(got, ref, live):
    """({(network, parameter): max |got - ref| / max |ref|} over the live
    tensors, {(network, parameter): max |got - ref| / its network's largest
    gradient} over the others)."""
    errs, noise = {}, {}
    for net, want in ref.items():
        top = max(r.abs().max().item() for r in want.values())
        for key, r in want.items():
            err = (got[net][key].float() - r.float()).abs().max().item()
            if (net, key) in live:
                errs[net, key] = err / r.abs().max().item()
            else:
                noise[net, key] = err / top
    return errs, noise


def over_bound(errs, bounds):
    """The tensors whose error exceeds their bound."""
    return [t for t in errs if errs[t] > bounds[t]]


def worst_txt(errs, bounds, n=3):
    """The n tensors nearest their bounds, as 'name error of bound'."""
    top = sorted(errs, key=lambda t: errs[t] / bounds[t], reverse=True)[:n]
    return ", ".join(f"{net}.{key} {errs[net, key]:.2e} of "
                     f"{bounds[net, key]:.1e}" for net, key in top)


def nudged(x, dtype, gen):
    """x rounded to ``dtype``, each element then moved by one unit in its
    last place, up or down at random (in float64, where 1 + 2^-24 exists)."""
    import torch

    sign = torch.randint(0, 2, x.shape, generator=gen) * 2 - 1
    half_ulp = torch.finfo(dtype).eps / 2
    return (x.to(dtype).double() * (1 + half_ulp * sign.to(x.device))).to(
        dtype).float()


@contextlib.contextmanager
def planted_fault(dq_scale=1.0, dk_shift=0.0):
    """K7's backward kernel with its dq scaled by ``dq_scale`` and every
    element of its dk moved by ``dk_shift`` x its largest |value|: faults
    that the step gate must report."""
    from mhada_tpu_torch.ops import mhada_train as mt

    real = mt._bwd_kernel

    def faulty(*args):
        dq, dk, dv = real(*args)
        return dq * dq_scale, dk + dk_shift * dk.abs().amax(), dv

    mt._bwd_kernel = faulty
    try:
        yield
    finally:
        mt._bwd_kernel = real


def train_step_gates(label, want, kcfg, ktrain, pcfg, ptrain, batch,
                     key_bias=False):
    """Phase 7's gate, per dtype: one step on the kernel build (its launches
    counted, to equal ``want``) and one on the plain build from the same
    weights and batch, each build's peak device memory; losses and every
    gradient held together, each live tensor against its own largest value;
    the rounding control that sets the bounds (the batch's images nudged;
    the video recipe's flow and mask stay float32 data); the controls the
    gate must report.  ``key_bias``: the key biases held to KEY_BIAS_BOUND,
    with the planted dK controls.  -> (ok, {dtype: record with the
    launches}, {dtype: {tensor: errors and bound}})."""
    from dataclasses import replace

    import torch

    from mhada_tpu_torch import _build
    from mhada_tpu_torch.train.recipes import recipe

    ok, records, grad_tables = True, {}, {}
    # the plain float32 build's gradients, its live tensors and the float32
    # gate's bounds (float32 runs first)
    pg32 = live = bounds32 = None
    nudge_gen = torch.Generator().manual_seed(SEED)
    images = recipe(kcfg).images
    faults = [("dq", PLANTED_DQ), ("dq", BELOW_DQ)] + (
        [("dk", PLANTED_DK), ("dk", BELOW_DK)] if key_bias else [])
    for dname in DTYPE_NAMES:
        dtype = getattr(torch, dname)
        kc, pc = (replace(c, compute_dtype=dname) for c in (kcfg, pcfg))
        rel_grad = TRAIN_REL[dname][1]
        try:
            peaks = {}
            torch.cuda.reset_peak_memory_stats()
            _build.reset_launches()
            km, kg = step_grads(ktrain, kc, batch)
            torch.cuda.synchronize()
            counts = dict(_build.LAUNCHES)
            peaks["kernel"] = torch.cuda.max_memory_allocated() / 1e9
            torch.cuda.reset_peak_memory_stats()
            pm, pg = step_grads(ptrain, pc, batch)
            torch.cuda.synchronize()
            peaks["plain"] = torch.cuda.max_memory_allocated() / 1e9
            rgs = [step_grads(ptrain, pc, [
                nudged(x, dtype, nudge_gen) for x in batch[:images]]
                + batch[images:])[1] for _ in range(2)]
            fgs = []
            for kind, size in faults:
                with planted_fault(**({"dq_scale": 1 + size[dname]}
                                      if kind == "dq" else
                                      {"dk_shift": size[dname]})):
                    fgs.append(step_grads(ktrain, kc, batch)[1])
            torch.cuda.synchronize()
        except Exception as e:
            ok = phase(f"train step {label} {dname}", False,
                       f"{type(e).__name__}: {e}")
            continue
        if pg32 is None:
            pg32, live = pg, live_tensors(pg)
        loss_rel = abs(km["loss"] - pm["loss"]) / abs(pm["loss"])
        errs, noise = grad_errors(kg, pg, live)
        controls = [grad_errors(rg, pg, live) for rg in rgs]
        rounding = {t: max(c[0][t] for c in controls) for t in live}
        bounds = {t: max(rel_grad, ROUNDING_FACTOR * rounding[t])
                  for t in live}
        noise_bounds = {t: (KEY_BIAS_BOUND[dname] if key_bias
                            and t[1].endswith("g_bias")
                            else NOISE_BOUND[dname]) for t in noise}
        noise_rounding = max((c[1][t] for c in controls for t in noise),
                             default=0.0)
        over, noise_over = over_bound(errs, bounds), over_bound(
            noise, noise_bounds)
        widened = [bounds[t] for t in live if bounds[t] > rel_grad]
        # each planted fault's errors over every tensor, live or not, and
        # the tensors it puts over their bounds
        every_bound = {**bounds, **noise_bounds}
        planted = []
        for fg in fgs:
            e, n = grad_errors(fg, pg, live)
            planted.append(({**e, **n}, over_bound({**e, **n}, every_bound)))
        (fault, caught), (below, below_over) = planted[:2]
        grad_tables[dname] = {
            f"{net}.{key}": dict(kernel=errs[net, key],
                                 rounding=rounding[net, key],
                                 bound=bounds[net, key],
                                 fault=fault[net, key],
                                 below=below[net, key])
            for net, key in sorted(live)}
        control_txt, controls_ok = "", bool(caught)
        if key_bias:
            (dk, dk_caught), (dk_below, dk_below_over) = planted[2:]
            controls_ok = controls_ok and bool(dk_caught)
            control_txt = (
                f"; K7's dK + {PLANTED_DK[dname]:.3g} x max|dK|: "
                f"{len(dk_caught)} tensors over their bounds (nearest: "
                f"{worst_txt(dk, every_bound)}); a smaller one, counted, not"
                f" gated: + {BELOW_DK[dname]:.3g} x max|dK|: "
                f"{len(dk_below_over)} tensors over (nearest: "
                f"{worst_txt(dk_below, every_bound)})")
        if bounds32 is None:
            bounds32 = bounds
        else:   # the plain bfloat16 build held to the float32 gate
            lower = grad_errors(pg, pg32, live)[0]
            lower_caught = over_bound(lower, bounds32)
            controls_ok = controls_ok and bool(lower_caught)
            control_txt += (f"; the plain bfloat16 build against the "
                            f"float32 gate: {len(lower_caught)} tensors over"
                            f" their bounds (nearest: "
                            f"{worst_txt(lower, bounds32)})")
        good = (all(np.isfinite(v) for v in km.values()) and counts == want
                and loss_rel <= STEP_LOSS_REL[dname] and not over
                and not noise_over)
        records[dname] = dict(
            loss_kernel=km, loss_plain=pm, loss_rel=loss_rel,
            grad_rel_worst=max(errs.values()),
            grad_rounding_worst=max(rounding.values()),
            grad_bounds_widened=len(widened), grad_tensors_live=len(errs),
            grad_noise_worst=max(noise.values(), default=0.0),
            noise_rounding_worst=noise_rounding,
            fault_tensors_over=len(caught),
            below_fault_tensors_over=len(below_over),
            launches=counts, peak_gb=peaks)
        if key_bias:
            records[dname].update(
                key_bias_worst=max(v for t, v in noise.items()
                                   if t[1].endswith("g_bias")),
                dk_fault_tensors_over=len(dk_caught),
                below_dk_fault_tensors_over=len(dk_below_over))
        bound_txt = (f"{NOISE_BOUND[dname]:.0e}, the key biases "
                     f"{KEY_BIAS_BOUND[dname]:.0e}" if key_bias
                     else f"{NOISE_BOUND[dname]:.0e}")
        ok = phase(f"train step {label} {dname}", good,
                   f"kernel build {km}; plain build {pm}; loss rel "
                   f"{loss_rel:.3e} (bound {STEP_LOSS_REL[dname]:.0e}); "
                   f"gradients of {len(errs)} live tensors, each against its"
                   f" own largest value: {len(over)} over max({rel_grad:.0e},"
                   f" {ROUNDING_FACTOR:g} x the rounding controls' larger "
                   f"error) (nearest: {worst_txt(errs, bounds)}); the "
                   f"controls' worst {max(rounding.values()):.3e}, widening"
                   f" {len(widened)} bounds up to "
                   f"{max(widened, default=0):.2e}"
                   f"; the {len(noise)} others (zero in exact arithmetic), "
                   f"each against its network's largest gradient: "
                   f"{len(noise_over)} over their bounds ({bound_txt}) "
                   f"(nearest: {worst_txt(noise, noise_bounds)}); their "
                   f"controls' worst {noise_rounding:.3e}; launches {counts} "
                   f"(want {want}); peak memory kernel build "
                   f"{peaks['kernel']:.2f} GB, plain build "
                   f"{peaks['plain']:.2f} GB") and ok
        ok = phase(f"train step gate controls {label} {dname}", controls_ok,
                   f"K7's dq x (1 + {PLANTED_DQ[dname]:g}): "
                   f"{len(caught)} tensors over their "
                   f"bounds (nearest: {worst_txt(fault, every_bound)})"
                   f"; a smaller fault, counted, not gated: K7's "
                   f"dq x (1 + {BELOW_DQ[dname]:g}): "
                   f"{len(below_over)} tensors over (nearest:"
                   f" {worst_txt(below, every_bound)}){control_txt}") and ok
        del kg, pg, rgs, fgs, planted
    return ok, records, grad_tables


def synthetic_folders(root, n, rng):
    """``n`` random 300 x 340 PNGs in each of root/coco and root/wikiart."""
    from PIL import Image

    for d in ("coco", "wikiart"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
        for i in range(n):
            pixels = rng.integers(0, 256, (300, 340, 3), np.uint8)
            Image.fromarray(pixels).save(os.path.join(root, d, f"{i}.png"))


def synthetic_sceneflow(root, rng, frames=5, styles=4):
    """A Monkaa scene of ``frames`` frames at SceneFlow's size (4 samples at
    the default), its flows into the future and the past as PFM files and
    its motion boundaries under root/SceneFlowDatasets/monkaa, and
    ``styles`` random PNGs under root/WikiArt: what
    ``data.sceneflow.FlyingThings3DMonkaaWikiArt`` reads."""
    from PIL import Image

    from mhada_tpu_torch.data import flowlib

    h, w = SCENEFLOW_HW
    base = os.path.join(root, "SceneFlowDatasets", "monkaa")
    yy, xx = np.mgrid[0:h, 0:w] / w

    def path(*parts):
        os.makedirs(os.path.join(base, *parts[:-1]), exist_ok=True)
        return os.path.join(base, *parts)

    past = None
    for i in range(frames):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8)).save(
            path("frames_finalpass", "sc", "left", f"{i:04d}.png"))
        # a smooth flow into the next frame, and its negation as that
        # frame's flow into the past: mostly consistent, so the masks keep
        # most pixels
        a, b = rng.normal(0, 8, 2)
        future = np.stack([a * np.sin(6 * yy + i) + b * xx,
                           b * np.cos(5 * xx) - a * yy,
                           np.zeros_like(xx)], -1).astype(np.float32)
        for d, flow in (("into_future", future),
                        ("into_past", -future if past is None else past)):
            flowlib.write_pfm(path("optical_flow", "sc", d, "left",
                                   f"{i:04d}.pfm"), flow)
        past = -future
        edges = np.zeros((h, w), np.uint8)
        edges[:, 100 + 20 * i: 110 + 20 * i] = 255
        Image.fromarray(edges).save(path("motion_boundaries", "sc",
                                         "into_future", "left",
                                         f"{i:04d}.png"))
    os.makedirs(os.path.join(root, "WikiArt"), exist_ok=True)
    for i in range(styles):
        pixels = rng.integers(0, 256, (300, 340, 3), np.uint8)
        Image.fromarray(pixels).save(os.path.join(root, "WikiArt",
                                                  f"{i}.png"))


def video_cli_phase(models, card) -> tuple[bool, dict]:
    """Phase 4g: ``infer.video.main`` at bf16 over a synthetic CLI_FRAMES
    clip (mp4v, CLI_CLIP_HW) with ``models``' weights written as a .pth
    triple, at --chunk 1 and --chunk 8 -> (ok, per chunk: wall ms/frame and
    launches).  Each run must write every frame as a JPEG and a readable
    video.mp4, launch exactly the style set-up plus one frame's kernels per
    dispatch, and give frames that are not all 0; the chunked frames must
    lie within 1 uint8 level of the unchunked ones (cuDNN may choose other
    algorithms at B = 8).  The frames are read where the CLI writes them,
    by wrapping its ``_flush``."""
    import cv2
    import torch

    from mhada_tpu_torch import _build
    from mhada_tpu_torch.infer import video
    from mhada_tpu_torch.train.checkpoint import save_weights

    tmp = tempfile.mkdtemp(prefix="chip_smoke_video_")
    ok, rec, frames = True, {}, {}
    try:
        rng = np.random.default_rng(SEED + 2)
        clip = os.path.join(tmp, "clip.mp4")
        h, w = CLI_CLIP_HW
        yy, xx = np.mgrid[0:h, 0:w]
        vw = cv2.VideoWriter(clip, cv2.VideoWriter_fourcc(*"mp4v"), 30,
                             (w, h))
        for i in range(CLI_FRAMES):   # bands drifting 12 pixels a frame
            f = np.stack([127 + 100 * np.sin((xx + 12 * i) / (40 + 9 * c)
                                             + yy / 57) for c in range(3)],
                         -1) + rng.normal(0, 12, (h, w, 3))
            vw.write(np.clip(f, 0, 255).astype(np.uint8))
        vw.release()
        style = os.path.join(tmp, "style.png")
        cv2.imwrite(style, rng.integers(0, 256, (256, 256, 3), np.uint8))
        wdir = os.path.join(tmp, "weights")
        save_weights(wdir, models)
        flush = video._flush
        for chunk in (1, 8):
            out = os.path.join(tmp, f"out{chunk}")
            got, log = [], io.StringIO()
            video._flush = lambda p, *a, **k: (
                got.append((p[0], np.array(p[1]))), flush(p, *a, **k))[1]
            try:
                _build.reset_launches()
                with contextlib.redirect_stdout(log):
                    video.main([
                        "--video", clip, "--style", style, "--out", out,
                        "--dtype", "bfloat16", "--chunk", str(chunk),
                        *(f for n in ("ada", "vitc", "vits") for f in (
                            f"--{n}", os.path.join(wdir, {
                                "ada": "AdaFormer", "vitc": "ViT_C",
                                "vits": "ViT_S"}[n] + ".pth")))])
                torch.cuda.synchronize()
                counts = dict(_build.LAUNCHES)
            except Exception as e:
                ok = phase(f"video CLI --chunk {chunk}", False,
                           f"{type(e).__name__}: {e}") and ok
                continue
            finally:
                video._flush = flush
            calls = CLI_FRAMES // chunk
            want = {k: STYLE[k] + calls * FRAME[k] for k in FRAME}
            got.sort(key=lambda t: t[0])
            frames[chunk] = np.stack([f for _, f in got])
            files = sorted(os.listdir(out))
            jpegs = [f"frame_{i:05d}.jpg" for i in range(CLI_FRAMES)]
            cap = cv2.VideoCapture(os.path.join(out, "video.mp4"))
            n_mp4, shape = 0, None
            while True:
                more, fr = cap.read()
                if not more:
                    break
                n_mp4, shape = n_mp4 + 1, fr.shape
            cap.release()
            m = re.search(r"processed (\d+) frames .* in ([\d.]+) s",
                          log.getvalue())
            ms = 1e3 * float(m[2]) / CLI_FRAMES if m else None
            a = frames[chunk]
            good = (m is not None and int(m[1]) == CLI_FRAMES
                    and [i for i, _ in got] == list(range(CLI_FRAMES))
                    and a.shape == (CLI_FRAMES, *CLI_HW, 3)
                    and files == jpegs + ["video.mp4"]
                    and n_mp4 == CLI_FRAMES and shape == (*CLI_HW, 3)
                    and counts == want and a.max() > 0)
            rec[f"chunk{chunk}"] = dict(ms_per_frame=ms, launches=counts)
            ok = phase(f"video CLI --chunk {chunk}", good,
                       f"{m[0] if m else 'no summary line'}; {len(got)} "
                       f"frames {a.shape}, pixels [{a.min()}, {a.max()}] "
                       f"mean {a.mean():.2f}; files {len(files)} (want "
                       f"{CLI_FRAMES} JPEGs and video.mp4); video.mp4 "
                       f"{n_mp4} frames of {shape}; launches {counts} (want "
                       f"{want})") and ok
        if len(frames) == 2:
            d = np.abs(frames[8].astype(int) - frames[1].astype(int))
            ok = phase("video CLI --chunk 8 vs --chunk 1", d.max() <= 1,
                       f"max |d| {d.max()} uint8 levels (bound 1), "
                       f"{100 * (d > 0).mean():.3f} % of values differ"
                       ) and ok
        phase("video CLI times", True, "wall ms/frame of the stream "
              "(style set-up, decode, stylization, JPEG writes; not gated): "
              + ", ".join(f"{k} {r['ms_per_frame']}" for k, r in
                          rec.items()) + f" ({card})")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return ok, rec


def randomize(module, seed):
    """Seeded random weights that keep a deep backbone's activations O(1):
    He-normal conv and linear weights, biases N(0, 0.05^2), BatchNorm
    scales U(0.8, 1.2), shifts and means N(0, 0.05^2), variances U(0.5,
    1.5) (torch's default init fades through 40 layers) -> the module."""
    import torch

    g = torch.Generator().manual_seed(seed)

    def rand(t, lo, width):
        t.copy_(lo + width * torch.rand(t.shape, generator=g))

    def randn(t, scale):
        t.copy_(scale * torch.randn(t.shape, generator=g))

    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                rand(m.weight, 0.8, 0.4)
                randn(m.bias, 0.05)
                randn(m.running_mean, 0.05)
                rand(m.running_var, 0.5, 1.0)
            elif (getattr(m, "weight", None) is not None
                  and m.weight.dim() in (2, 4)):
                randn(m.weight, (2.0 / m.weight[0].numel()) ** 0.5)
                if m.bias is not None:
                    randn(m.bias, 0.05)
    return module


def eval_weights(d, models) -> dict:
    """Random full-width weights from the seed as the .pth files the eval
    CLIs read -> {name: path}: the stylization triple (``models``, the
    kernel build's weights), torchvision-layout vgg16, vgg19,
    inception_v3 and raft_large, and the LPIPS v0.1 heads."""
    import torch

    from mhada_tpu_torch.evals.inception import InceptionV3Features
    from mhada_tpu_torch.evals.lpips import LPIPS_CHANNELS, VGG16Features
    from mhada_tpu_torch.interop import _VGG19_IDX
    from mhada_tpu_torch.models.raft import RAFT
    from mhada_tpu_torch.models.vgg19 import VGG19Features
    from mhada_tpu_torch.train.checkpoint import save_weights

    wdir = os.path.join(d, "weights")
    save_weights(wdir, models)
    paths = {k: os.path.join(wdir, f"{f}.pth") for k, f in (
        ("ada", "AdaFormer"), ("vitc", "ViT_C"), ("vits", "ViT_S"))}
    vgg19 = randomize(VGG19Features(), SEED + 11)
    sds = {
        "vgg16": randomize(VGG16Features(), SEED + 12).state_dict(),
        "vgg19": {f"features.{i}.{p}": getattr(getattr(vgg19, name),
                                               p).detach()
                  for name, i in _VGG19_IDX.items()
                  for p in ("weight", "bias")},
        "inception": randomize(InceptionV3Features(), SEED + 13).state_dict(),
        "raft": randomize(RAFT(), SEED + 14).state_dict(),
    }
    g = torch.Generator().manual_seed(SEED + 15)
    sds["heads"] = {f"lin{k}.model.1.weight": 0.05 * torch.randn(
        1, c, 1, 1, generator=g).abs() for k, c in enumerate(LPIPS_CHANNELS)}
    for name, sd in sds.items():
        paths[name] = os.path.join(d, f"{name}.pth")
        torch.save(sd, paths[name])
    return paths


def eval_picture(hw, rng, phase_=0.0):
    """A smooth picture with noise, bands drifting with ``phase_``, uint8."""
    yy, xx = np.mgrid[0:hw[0], 0:hw[1]] / max(hw)
    a = np.stack([127.5 + 110 * np.sin(6.3 * (xx + c + phase_) * (yy + 1))
                  for c in range(3)], -1)
    return np.clip(a + rng.normal(0, 10, a.shape), 0, 255).astype(np.uint8)


@contextlib.contextmanager
def timed_calls(targets, spans):
    """Wrap each (owner, attribute, span) so its calls' wall seconds add up
    in ``spans[span]``; restored on exit.  The wrapped calls return host
    values, so their work is done when they return."""
    saved = [(owner, attr, getattr(owner, attr)) for owner, attr, _ in targets]
    for (owner, attr, fn), (_, _, span) in zip(saved, targets):
        def wrap(*a, fn=fn, span=span, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                spans[span] = spans.get(span, 0.0) + time.perf_counter() - t0
        setattr(owner, attr, wrap)
    try:
        yield spans
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)


def run_cli(main_fn, argv):
    """One CLI ``main`` on the card, its stdout captured -> (the launches it
    made, counts set to 0 just before; wall seconds; its output)."""
    import torch

    from mhada_tpu_torch import _build

    log = io.StringIO()
    _build.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        main_fn(argv)
    torch.cuda.synchronize()
    return dict(_build.LAUNCHES), time.perf_counter() - t0, log.getvalue()


def times_want(*parts):
    """The launches of ``(count, path counts)`` parts added up."""
    return {k: sum(n * p[k] for n, p in parts) for k in FULL}


def read_rows(path):
    import csv

    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


def evals_phase(kmodels, pmodels, card, gates) -> tuple[bool, dict]:
    """Phase 8 -> (ok, record): (a) K1, K2, K4 and K5 against their plain
    versions at the Sintel frame's shapes and K4 at the video eval's, both
    dtypes; (b) ``evals.exps_image.main`` at 512^2 over the six reference
    file names with every backbone but Inception (exact launches, the CSV,
    each stylized.png within 1 uint8 level of the plain path's), its wall
    per pair split into stylization and metrics; (c) SSIM, gram, LPIPS,
    the four Inception taps and SIFID at 64 / 192 / 768 dims on the card
    against the CPU, and ``evals.cli -m sifid`` at 2048; (d)
    ``evals.exps_image_all.main`` on a 2 x 2 grid; (e)
    ``evals.exps_sintel.main`` at 360 x 640 over two scenes of three
    436 x 1024 frames, with RAFT and with Farnebäck, and RAFT's device ms
    per flow at 360 x 640 and 256 x 512; (f) ``evals.exps_video.main`` on
    an 8-frame clip with RAFT, 4 pairs, float32 and bfloat16.
    ``kmodels`` hold the weights the CLIs load; ``pmodels`` the same
    weights on the plain build."""
    import cv2
    import torch
    from PIL import Image

    from mhada_tpu_torch.config import resolve_device
    from mhada_tpu_torch.evals import (cli, exps_image, exps_image_all,
                                       exps_sintel, exps_video, metrics)
    from mhada_tpu_torch.evals.exps_image import MetricSuite
    from mhada_tpu_torch.evals.inception import load_inception
    from mhada_tpu_torch.evals.lpips import load_lpips
    from mhada_tpu_torch.evals.sifid import SIFID, load_01
    from mhada_tpu_torch.infer.image import stylize_image
    from mhada_tpu_torch.models.raft import load_raft
    from mhada_tpu_torch.utils.image_io import load_image

    ok, rec, secs = True, {}, {}
    # a. the kernels at the eval shapes
    t0 = time.perf_counter()
    for gate, kind, n in EVAL_GATES:
        for dname in DTYPE_NAMES:
            try:
                good, r = run_gate(gate, kind, n, 1, dname, card)
            except Exception as e:
                ok = phase(f"gate {gate} {dname}", False,
                           f"{type(e).__name__}: {e}")
                continue
            gates.setdefault(gate, {})[dname] = r
            ok = good and ok
    secs["a_gates"] = time.perf_counter() - t0
    tmp = tempfile.mkdtemp(prefix="chip_smoke_evals_")
    try:
        rng = np.random.default_rng(SEED + 8)
        w = eval_weights(tmp, kmodels)
        model_args = [f for n in ("ada", "vitc", "vits")
                      for f in (f"--{n}", w[n])]
        backbones = ["--vgg19", w["vgg19"], "--vgg16", w["vgg16"],
                     "--lpips-heads", w["heads"]]

        # b. exps_image.main at 512^2, float32, the six pairs
        t0 = time.perf_counter()
        assets = os.path.join(tmp, "assets")
        for k, rel_path in enumerate(sorted(
                {p for pair in exps_image.CONTENT_STYLE_PAIR for p in pair})):
            path = os.path.join(assets, rel_path)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            hw = (480 + 16 * k, 640 - 16 * k)
            pic = (eval_picture(hw, rng, 0.1 * k) if "contents" in rel_path
                   else rng.integers(0, 256, (*hw, 3), np.uint8))
            Image.fromarray(pic).save(path, quality=95)
        res = os.path.join(tmp, "results")
        spans = {}
        targets = [(exps_image, "stylize_image", "stylise"),
                   (MetricSuite, "lpips", "lpips"),
                   (MetricSuite, "gram", "gram"),
                   (MetricSuite, "ssim", "ssim"),
                   *((metrics, f, "histograms") for f in (
                       "kl_divergence", "nth_order_moment", "uniformity",
                       "average_entropy"))]
        try:
            with timed_calls(targets, spans):
                counts, wall, _ = run_cli(exps_image.main, [
                    "--assets", assets, "--results", res, *backbones,
                    *model_args])
            head, rows = read_rows(os.path.join(res, "results.csv"))
            vals = np.array([[float(v) for v in r[2:]] for r in rows])
            sifid_cols = [i for i, k in enumerate(head[2:])
                          if k.startswith("sifid")]
            other = [i for i in range(len(head) - 2) if i not in sifid_cols]
            npairs = len(exps_image.CONTENT_STYLE_PAIR)
            want = times_want((npairs, FULL))
            dpix = []
            for i, (cp, sp) in enumerate(exps_image.CONTENT_STYLE_PAIR):
                c, s_ = (load_image(os.path.join(assets, p), (512, 512))
                         for p in (cp, sp))
                ref = stylize_image(pmodels, c, s_, torch.float32)
                got = np.asarray(Image.open(os.path.join(
                    res, str(i + 1), "stylized.png")), np.int64)
                dpix.append(int(np.abs(got - ref.astype(np.uint8)).max()))
                if i == 0:
                    pic_max = int(got.max())
            good = (head == exps_image.FIELDNAMES and len(rows) == npairs + 1
                    and rows[-1][:2] == ["average", "average"]
                    and np.isnan(vals[:, sifid_cols]).all()
                    and np.isfinite(vals[:, other]).all()
                    and np.allclose(vals[-1, other],
                                    vals[:-1, other].mean(0), rtol=1e-9)
                    and counts == want and max(dpix) <= 1 and pic_max > 0)
            per_pair = {k: v / npairs for k, v in spans.items()}
            per_pair["wall"] = wall / npairs
            rec["exps_image"] = dict(launches=counts, s_per_pair=per_pair,
                                     stylized_dpix=dpix)
            ok = phase("evals exps_image.main 512^2 float32", good,
                       f"{len(head)} columns x {len(rows)} rows, SIFID NaN, "
                       f"the rest finite, average = column mean; launches "
                       f"{counts} (want 6 x the full path: {want}); "
                       f"stylized.png against the plain path's max |d| "
                       f"{dpix} uint8 levels (bound 1); wall s/pair "
                       + ", ".join(f"{k} {v:.4f}" for k, v in
                                   per_pair.items()) + f" ({card})") and ok
        except Exception as e:
            ok = phase("evals exps_image.main 512^2 float32", False,
                       f"{type(e).__name__}: {e}")
        secs["b_exps_image"] = time.perf_counter() - t0

        # c. the metrics on the card against the CPU, on pair 1's files
        t0 = time.perf_counter()
        p0, p1 = (os.path.join(res, "1", f) for f in ("stylized.png",
                                                      "content.png"))
        try:
            vals, mrec = {}, {}
            x01 = torch.from_numpy(load_01(p0))[None]
            for dev in ("cuda", "cpu"):
                dev_t = resolve_device(dev)
                vgg = metrics.load_vgg19_features(w["vgg19"], dev)
                lp = load_lpips(w["vgg16"], w["heads"], dev)
                inc = load_inception(w["inception"], 3, dev)

                v = {"ssim": metrics.ssim(p0, p1, dev),
                     "gram": metrics.gram_loss(p0, p1, vgg, dev),
                     "lpips": float(lp(metrics.rgb_batch(p0, dev_t),
                                       metrics.rgb_batch(p1, dev_t))[0]),
                     "taps": [t.cpu() for t in inc(x01.to(dev_t))]}
                for dims in (64, 192, 768):
                    ts = time.perf_counter()
                    v[f"sifid{dims}"] = SIFID(inc, dims)(p0, p1)
                    mrec[f"sifid{dims}_s_{dev}"] = time.perf_counter() - ts
                vals[dev] = v
            errs = {}
            for k in ("ssim", "gram", "lpips", "sifid64", "sifid192",
                      "sifid768"):
                a, b = vals["cuda"][k], vals["cpu"][k]
                errs[k] = abs(a - b) / max(abs(b), 1e-30)
            for i, (a, b) in enumerate(zip(vals["cuda"]["taps"],
                                           vals["cpu"]["taps"])):
                errs[f"tap{i}"] = float((a - b).abs().max()
                                        / b.abs().max().clamp_min(1e-30))
            bound = {k: SIFID_REL if k.startswith("sifid") else METRIC_REL
                     for k in errs}
            good = all(np.isfinite(vals[d][k]) for d in vals
                       for k in errs if not k.startswith("tap")) and all(
                errs[k] <= bound[k] for k in errs)
            mrec.update(values={k: [vals["cuda"][k], vals["cpu"][k]]
                                for k in errs if not k.startswith("tap")},
                        rel=errs)
            ok = phase("evals metrics card vs CPU", good,
                       "rel " + ", ".join(f"{k} {e:.2e}" for k, e in
                                          errs.items())
                       + f" (bounds {METRIC_REL:.0e}, SIFID "
                       f"{SIFID_REL:.0e}); card/CPU values " + ", ".join(
                           f"{k} {a:.6g}/{b:.6g}" for k, (a, b) in
                           mrec["values"].items())
                       + "; SIFID host s/call " + ", ".join(
                           f"{k} {v:.2f}" for k, v in mrec.items()
                           if k.endswith(("_cuda", "_cpu")))) and ok
            counts, wall, out = run_cli(cli.main, [
                "-m", "sifid", "-p0", p0, "-p1", p1, "--inception",
                w["inception"]])
            m = re.search(r"SIFID: (\S+)", out)
            good = m is not None and np.isfinite(float(m[1]))
            mrec["sifid2048_cli_s"] = wall
            rec["metrics"] = mrec
            ok = phase("evals cli -m sifid (2048 dims)", good,
                       f"{out.strip()!r} in {wall:.2f} s wall (the sqrtm "
                       f"of a 2048^2 covariance product on the host; "
                       f"{os.cpu_count()} cores)") and ok
        except Exception as e:
            ok = phase("evals metrics card vs CPU", False,
                       f"{type(e).__name__}: {e}")
        secs["c_metrics"] = time.perf_counter() - t0

        # d. exps_image_all.main on a 2 x 2 grid
        t0 = time.perf_counter()
        try:
            for sub, n in (("contents", 2), ("styles", 2)):
                os.makedirs(os.path.join(tmp, "grid", sub))
                for i in range(n):
                    pic = (eval_picture((500, 600), rng, 0.3 * i)
                           if sub == "contents" else
                           rng.integers(0, 256, (400, 420, 3), np.uint8))
                    Image.fromarray(pic).save(os.path.join(
                        tmp, "grid", sub, f"{i}.jpg"))
            res2 = os.path.join(tmp, "results_all")
            counts, wall, _ = run_cli(exps_image_all.main, [
                "--contents", os.path.join(tmp, "grid", "contents"),
                "--styles", os.path.join(tmp, "grid", "styles"),
                "--results", res2, *backbones, *model_args])
            head, rows = read_rows(os.path.join(res2, "results_all.csv"))
            vals = np.array([[float(v) for v in r[2:]] for r in rows])
            want = times_want((2, STYLE), (4, FS_FRAME))
            good = (head == exps_image_all.FIELDNAMES and len(rows) == 5
                    and np.isfinite(vals).all() and counts == want)
            rec["exps_image_all"] = dict(launches=counts, wall_s=wall)
            ok = phase("evals exps_image_all.main 2 x 2", good,
                       f"{len(head)} columns x {len(rows)} rows, finite; "
                       f"launches {counts} (want 2 style encodings + 4 "
                       f"frames: {want}); {wall:.2f} s wall") and ok
        except Exception as e:
            ok = phase("evals exps_image_all.main 2 x 2", False,
                       f"{type(e).__name__}: {e}")
        secs["d_exps_image_all"] = time.perf_counter() - t0

        # e. exps_sintel.main at 360 x 640: RAFT, then Farnebäck
        t0 = time.perf_counter()
        scenes = ["alley_2", "ambush_5"]
        for k, scene in enumerate(scenes):
            d = os.path.join(tmp, "sintel", "training", "final", scene)
            os.makedirs(d)
            for i in range(3):
                Image.fromarray(eval_picture(SINTEL_FRAME_HW, rng,
                                             0.5 * k + 0.02 * i)).save(
                    os.path.join(d, f"frame_{i + 1:04d}.png"))
        style = os.path.join(tmp, "style.png")
        Image.fromarray(rng.integers(0, 256, (300, 300, 3), np.uint8)).save(
            style)
        make_flow = exps_video.make_flow_fn
        for flow in (f"raft:{w['raft']}", "farneback"):
            name = flow.split(":")[0]
            flow_s = []

            def timed_flow(*a, **k):
                fn = make_flow(*a, **k)

                def f(x, y):
                    ts = time.perf_counter()
                    out = fn(x, y)
                    flow_s.append(time.perf_counter() - ts)
                    return out
                return f

            exps_video.make_flow_fn = timed_flow
            out_csv = os.path.join(tmp, f"sintel_{name}.csv")
            try:
                counts, wall, _ = run_cli(exps_sintel.main, [
                    "--sintel", os.path.join(tmp, "sintel"), "--style",
                    style, "--flow", flow, "--scenes", *scenes, "--csv",
                    out_csv, *model_args])
                head, rows = read_rows(out_csv)
                losses = [float(r[1]) for r in rows]
                want = times_want((1, STYLE), (8, FS_FRAME))
                good = (head == ["Scene", "Optical Flow Loss"]
                        and [r[0] for r in rows] == scenes
                        and np.isfinite(losses).all() and counts == want
                        and len(flow_s) == 8)
                rec[f"sintel_{name}"] = dict(
                    launches=counts, losses=losses, s_per_pair=wall / 4,
                    flow_s=sum(flow_s) / len(flow_s))
                ok = phase(f"evals exps_sintel.main 360x640 --flow {name}",
                           good, f"losses {losses}; launches {counts} (want "
                           f"1 style encoding + 8 frames: {want}); "
                           f"{len(flow_s)} flows, {1e3 * sum(flow_s) / max(len(flow_s), 1):.1f} "
                           f"ms wall each (host I/O included); "
                           f"{wall / 4:.3f} s wall/pair ({card})") and ok
            except Exception as e:
                ok = phase(f"evals exps_sintel.main 360x640 --flow {name}",
                           False, f"{type(e).__name__}: {e}")
            finally:
                exps_video.make_flow_fn = make_flow
        try:   # RAFT's device time a flow, CUDA events
            model = load_raft(w["raft"], "cuda")
            g = torch.Generator().manual_seed(SEED)
            raft_ms = {}
            for hw in (SINTEL_HW, CLI_HW):
                a, b = (torch.rand(1, *hw, 3, generator=g).to(
                    resolve_device("cuda")) * 2 - 1 for _ in range(2))
                raft_ms["x".join(map(str, hw))] = cuda_ms(
                    lambda: model(a, b), 1, 5)
            rec["raft_ms"] = raft_ms
            phase("evals RAFT times", True, "device ms per flow (12 "
                  "updates, CUDA events) " + ", ".join(
                      f"{k} {v:.2f}" for k, v in raft_ms.items())
                  + f" ({card})")
            del model
        except Exception as e:
            ok = phase("evals RAFT times", False, f"{type(e).__name__}: {e}")
        secs["e_sintel"] = time.perf_counter() - t0

        # f. exps_video.main, RAFT, 4 pairs of 256 x 512, both dtypes
        t0 = time.perf_counter()
        clip = os.path.join(tmp, "clip.mp4")
        h, w_ = CLI_CLIP_HW
        vw = cv2.VideoWriter(clip, cv2.VideoWriter_fourcc(*"mp4v"), 30,
                             (w_, h))
        for i in range(EVAL_CLIP_FRAMES):
            vw.write(eval_picture(CLI_CLIP_HW, rng, 0.01 * i))
        vw.release()
        for dname in DTYPE_NAMES:
            label = f"evals exps_video.main 256x512 RAFT {dname}"
            try:
                counts, wall, out = run_cli(exps_video.main, [
                    "--video", clip, "--style", style, "--flow",
                    f"raft:{w['raft']}", "--max-pairs", str(EVAL_PAIRS),
                    "--dtype", dname, *model_args])
                vals = {k: float(m[1]) for k in ("Warping Error", "Flow MSE")
                        for m in [re.search(rf"{k}: (\S+)", out)] if m}
                want = times_want((1, STYLE), (2 * EVAL_PAIRS, FS_FRAME))
                good = (len(vals) == 2 and np.isfinite(list(vals.values())).all()
                        and counts == want)
                rec[f"video_{dname}"] = dict(launches=counts, **vals,
                                             s_per_pair=wall / EVAL_PAIRS)
                ok = phase(label, good, f"{vals}; launches {counts} (want 1 "
                           f"style encoding + {2 * EVAL_PAIRS} frames: "
                           f"{want}); {wall / EVAL_PAIRS:.3f} s wall/pair, "
                           f"3 RAFT flows a pair ({card})") and ok
            except Exception as e:
                ok = phase(label, False, f"{type(e).__name__}: {e}")
        secs["f_video"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec["seconds"] = secs
    phase("evals seconds", True, ", ".join(f"{k} {v:.1f}"
                                           for k, v in secs.items()))
    return ok, rec


def test_images(size, rng):
    """A smooth content picture with noise and a noise style, HWC 0-255."""
    yy, xx = np.mgrid[0:size, 0:size] / size
    content = np.stack([127.5 + 120 * np.sin(6.3 * (xx + c) * (yy + 1))
                        for c in range(3)], -1)
    content = np.clip(content + rng.normal(0, 8, content.shape), 0, 255)
    style = rng.uniform(0, 255, (size, size, 3))
    return content.astype(np.float32), style.astype(np.float32)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dump", help="write the step gate's per-tensor "
                    "gradient errors and bounds to this JSON file")
    args = ap.parse_args()
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
    try:   # reported for the video CLI's sake; never fails the run
        import cv2
        cv2_txt = f"cv2 {cv2.__version__} imports"
    except ImportError as e:
        cv2_txt = f"cv2 does not import ({e})"
    phase("opencv", True, cv2_txt)
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

    ok = phase("tensor cores", *mma_report(lib))
    gates = {}   # gate (training kernels: row) -> dtype name -> record
    train_extra, step_ms = {}, {}

    # ---- 3. per-kernel gates, kernel against plain on the card
    gate_list = all_gates()
    for gate, _, kind, n, b in gate_list:
        for dname in DTYPE_NAMES:
            if kind in BF16_ONLY and dname != "bfloat16":
                continue
            try:
                good, rec = run_gate(gate, kind, n, b, dname, card)
            except Exception as e:  # report every kernel, then fail
                ok = phase(f"gate {gate} {dname}", False,
                           f"{type(e).__name__}: {e}")
                continue
            gates.setdefault(gate, {})[dname] = rec
            ok = good and ok
    for dname in DTYPE_NAMES:
        ok = pipe_against_k3(dname) and ok
    launches = {}   # path -> launch counts of its float32 run
    ok = run_probes(launches) and ok

    # ---- 4. the main paths, full width
    from mhada_tpu_torch.config import ModelConfig
    from mhada_tpu_torch.infer.image import (make_encode_style_fn,
                                             make_stylize_fn,
                                             make_stylize_with_kv_fn,
                                             precompute_style_kv,
                                             stylize_image)
    from mhada_tpu_torch.models import build_models
    from mhada_tpu_torch.ops.decoder_mid import mid3_fused
    from mhada_tpu_torch.ops.decoder_tail import decoder_tail

    def models_for(backend, tail="fused"):
        cfg = ModelConfig(mhada_backend=backend)
        m = build_models(cfg, "cuda", torch.Generator().manual_seed(SEED),
                         decoder_tail=tail)
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
    full_outs, stream_outs = {}, {}   # the kernel paths' frames, per dtype
    for dname in DTYPE_NAMES:
        dtype = getattr(torch, dname)
        # a. the full path at 512^2 (style re-encoded)
        good, full_out, counts = drive(
            f"main path {dname}", (1, 512, 512, 3), dname, FULL,
            lambda: stylize_image(kmodels, content, style, dtype),
            lambda: stylize_image(pmodels, content, style, dtype))
        ok = good and ok
        full_outs[dname] = full_out
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
        stream_outs[dname] = out
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

    def mid_on_decoder(frames, dtype, dname):
        """Phase 4e at one batch and dtype: the kernel decoder with K14 for
        c1 -> c3 against the plain decoder, on one AdaFormer output -> ok."""
        b = frames.shape[0]
        label = f"K14 on the decoder's activations B={b} {dname}"
        dec, pdec = (m["adaFormer"].decoder for m in (kmodels, pmodels))
        mids = [t for i in (1, 2, 3)
                for t in (getattr(dec, f"c{i}").conv.weight,
                          getattr(dec, f"c{i}").conv.bias)]
        tail = [t for cv in (dec.up3.conv, dec.c5.conv, dec.c6.conv)
                for t in (cv.weight, cv.bias)]

        def kernel_decoder():
            c3 = mid3_fused(x, *mids)
            return c3, decoder_tail(dec.c4(dec.up2(c3)).contiguous(), *tail)

        try:
            with torch.inference_mode():
                fc = kmodels["vit_c"](frames.to(dtype))
                fs = kmodels["vit_s"](s_t.repeat(b, 1, 1, 1).to(dtype))
                fcs_map, _ = kmodels["adaFormer"](fc, fs)
                x = dec.up1(fcs_map).contiguous()
                (c3, rgb), counts = counted(kernel_decoder)
                ref_c3 = pdec.c3(pdec.c2(pdec.c1(x))).float()
                ref = pdec(fcs_map)
                rel = ((c3.float() - ref_c3).abs().max().item()
                       / ref_c3.abs().max().item())
                finite = bool(torch.isfinite(c3).all())
        except Exception as e:
            return phase(label, False, f"{type(e).__name__}: {e}")
        if b == 1 and dname == "float32":
            launches["mid512"] = counts
        good, detail = check_image(to_np(rgb.float().clamp(0, 255)),
                                   to_np(ref.float().clamp(0, 255)),
                                   (b, 512, 512, 3), dname, counts,
                                   MID_DECODER)
        return phase(label, good and finite and rel <= REL_BOUND[dname],
                     f"c3 {tuple(c3.shape)} max|K14 - plain| / max|plain| "
                     f"{rel:.3e} (bound {REL_BOUND[dname]:.0e}); pixels: "
                     f"{detail}")

    # d. the c6 tail (K13 in place of K5) at 512^2 on the same weights:
    #    one full-path and one streaming frame per dtype, each against the
    #    plain path and against the fused-tail kernel path's frame
    cmodels = models_for("auto", "c6")
    for dname in DTYPE_NAMES:
        dtype = getattr(torch, dname)
        good, out, counts = drive(
            f"c6-tail full path {dname}", (1, 512, 512, 3), dname, FULL_C6,
            lambda: stylize_image(cmodels, content, style, dtype),
            lambda: stylize_image(pmodels, content, style, dtype))
        ok = good and ok
        launches.setdefault("c6full512", counts)
        if out is not None and full_outs.get(dname) is not None:
            good, detail = check_image(out, full_outs[dname],
                                       (1, 512, 512, 3), dname, counts,
                                       FULL_C6)
            ok = phase(f"c6-tail vs fused-tail full path {dname}", good,
                       detail) and ok
        try:
            kv, setup = counted(lambda: style_kv(cmodels, s_t, dtype))
        except Exception as e:
            ok = phase(f"c6-tail style setup {dname}", False,
                       f"{type(e).__name__}: {e}")
            continue
        ok = phase(f"c6-tail style setup {dname}", setup == STYLE,
                   f"launches {setup} (want {STYLE})") and ok
        good, out, counts = drive(
            f"c6-tail streaming path {dname}", (1, 512, 512, 3), dname,
            FRAME_C6, lambda: make_stylize_with_kv_fn(cmodels, dtype)(c_t, kv),
            lambda: make_stylize_with_kv_fn(pmodels, dtype)(
                c_t, style_kv(pmodels, s_t, dtype)))
        ok = good and ok
        launches.setdefault("c6stream512", counts)
        if out is not None and stream_outs.get(dname) is not None:
            good, detail = check_image(out, stream_outs[dname],
                                       (1, 512, 512, 3), dname, counts,
                                       FRAME_C6)
            ok = phase(f"c6-tail vs fused-tail streaming path {dname}", good,
                       detail) and ok
        del kv

    # e. K14 on the 512^2 decoder's own activations: up1's output through
    #    mid3_fused with c1-c3's weights, then up2, c4 and the fused tail
    #    (K5), against the plain decoder on the same AdaFormer output
    frames8 = torch.from_numpy(
        rng.uniform(0, 255, (8, 512, 512, 3)).astype(np.float32)).cuda()
    for dname in DTYPE_NAMES:
        dtype = getattr(torch, dname)
        for frames in (c_t, frames8):
            ok = mid_on_decoder(frames, dtype, dname) and ok
    torch.cuda.empty_cache()

    # f. the video CLI's frame (infer/video.py's defaults): 256 x 512 crops
    #    of the 512^2 content, 32 rows apart, against a 256^2 style, B = 1
    #    and 8 (--chunk 8), the style set-up counted apart; each against
    #    the plain path
    frames_cli = torch.stack([c_t[0, 32 * i:32 * i + CLI_HW[0]]
                              for i in range(8)]).contiguous()
    style_cli = to_dev(test_images(256, rng)[1])
    for dname in DTYPE_NAMES:
        dtype = getattr(torch, dname)
        try:
            kv, setup = counted(lambda: style_kv(kmodels, style_cli, dtype))
        except Exception as e:
            ok = phase(f"256x512 style setup {dname}", False,
                       f"{type(e).__name__}: {e}")
            continue
        ok = phase(f"256x512 style setup {dname}", setup == STYLE,
                   f"launches {setup} (want {STYLE})") and ok
        pkv = style_kv(pmodels, style_cli, dtype)
        for b in (1, 8):
            kvb, pkvb = ([(k.repeat(b, 1, 1), v.repeat(b, 1, 1))
                          for k, v in x] for x in (kv, pkv))
            good, _, counts = drive(
                f"streaming path 256x512 B={b} {dname}",
                (b, *CLI_HW, 3), dname, FRAME,
                lambda: make_stylize_with_kv_fn(kmodels, dtype)(
                    frames_cli[:b], kvb),
                lambda: make_stylize_with_kv_fn(pmodels, dtype)(
                    frames_cli[:b], pkvb))
            ok = good and ok
            launches.setdefault(f"stream256x512_b{b}", counts)
        del kv, pkv, kvb, pkvb

    # g. the video CLI end to end at bf16, --chunk 1 and 8
    good, video_cli = video_cli_phase(kmodels, card)
    ok = good and ok
    torch.cuda.empty_cache()

    # ---- 5. times per frame, the paths interleaved
    frame_ms = {}

    def interleaved(key, dname, fns, batch, reps=(1, 5)):
        """ms/frame of each path {name: fn}, timed in the order of ``fns``
        and then back (plain, kernel, kernel, plain)."""
        t = {name: [] for name in fns}
        for name in [*fns, *reversed(fns)]:
            t[name].append(cuda_ms(fns[name], *reps) / batch)
        frame_ms.setdefault(key, {})[dname] = {
            p: sum(v) / len(v) for p, v in t.items()}
        phase(f"times {key} {dname}", True,
              "ms/frame " + ", ".join(f"{name} path {v}"
                                      for name, v in t.items())
              + f" ({card})")

    paths = {"plain": pmodels, "kernel": kmodels, "c6": cmodels}
    for dname in DTYPE_NAMES:
        dtype = getattr(torch, dname)
        fk, fp = make_stylize_fn(kmodels, dtype), make_stylize_fn(pmodels,
                                                                   dtype)
        interleaved("full512_b1", dname, {"plain": lambda: fp(c_t, s_t),
                                          "kernel": lambda: fk(c_t, s_t)}, 1)
        # the style K/V tiled for a batch of frames (bench.py:664-668); the
        # c6-tail path (K13) timed beside the fused-tail kernel path
        kv = {p: style_kv(m, s_t, dtype) for p, m in paths.items()}
        kv8 = {p: [(k.repeat(8, 1, 1), v.repeat(8, 1, 1)) for k, v in pkv]
               for p, pkv in kv.items()}
        fns = {p: make_stylize_with_kv_fn(m, dtype) for p, m in paths.items()}
        interleaved("stream512_b1", dname,
                    {p: (lambda p=p: fns[p](c_t, kv[p])) for p in paths}, 1)
        for p, want in (("kernel", FRAME), ("c6", FRAME_C6)):
            key = ("c6" if p == "c6" else "") + f"stream512_b8_{dname}"
            good, _, launches[key] = drive(
                f"{'c6-tail ' if p == 'c6' else ''}streaming path B=8 "
                f"{dname}", (8, 512, 512, 3), dname, want,
                lambda: fns[p](frames8, kv8[p]),
                lambda: fns["plain"](frames8, kv8["plain"]))
            ok = good and ok
        interleaved("stream512_b8", dname,
                    {p: (lambda p=p: fns[p](frames8, kv8[p])) for p in paths},
                    8)
        # the video CLI's frame (4f), kernel and plain paths
        kvc = {p: style_kv(paths[p], style_cli, dtype)
               for p in ("plain", "kernel")}
        for b in (1, 8):
            kvb = {p: [(k.repeat(b, 1, 1), v.repeat(b, 1, 1)) for k, v in x]
                   for p, x in kvc.items()}
            interleaved(f"stream256x512_b{b}", dname,
                        {p: (lambda p=p: fns[p](frames_cli[:b], kvb[p]))
                         for p in kvc}, b)
        del kv, kv8, fns, kvc, kvb
    bf = torch.bfloat16
    kv_k, kv_p = (style_kv(m, s1k, bf) for m in (kmodels, pmodels))
    sk, sp = (make_stylize_with_kv_fn(m, bf) for m in (kmodels, pmodels))
    interleaved("stream1024_b1", "bfloat16",
                {"plain": lambda: sp(c1k, kv_p),
                 "kernel": lambda: sk(c1k, kv_k)}, 1, reps=(1, 3))
    del kmodels, pmodels, cmodels, paths, kv_k, kv_p, sk, sp, frames8, \
        frames_cli
    torch.cuda.empty_cache()

    # ---- 6. training gates at the training steps' shapes
    video_s = 0.0   # the video gates' and phase 7e's seconds
    for gate, row_f, row_b, kind, b, n in TRAIN_GATES:
        t0 = time.perf_counter()
        for dname in DTYPE_NAMES:
            try:
                good, recs = run_train_gate(gate, kind, dname, card, b, n)
            except Exception as e:  # report every kernel, then fail
                ok = phase(f"train gate {gate} {dname}", False,
                           f"{type(e).__name__}: {e}")
                continue
            if row_f is None:   # recorded whole under the gate's name
                train_extra.setdefault(gate, {})[dname] = recs
            else:
                gates.setdefault(row_f, {})[dname] = recs["fwd"]
                if row_b is not None:
                    gates.setdefault(row_b, {})[dname] = recs["bwd"]
                train_extra.setdefault(gate, {})[dname] = {
                    k: v for k, v in recs.items() if k not in ("fwd", "bwd")}
            ok = good and ok
        if (gate, row_f, row_b, kind, b, n) in VIDEO_GATES:
            video_s += time.perf_counter() - t0

    # ---- 7. the training paths: ModelConfig() at full width
    from dataclasses import replace

    from mhada_tpu_torch.config import ImageTrainConfig, VideoTrainConfig
    from mhada_tpu_torch.train import run_image, run_video
    from mhada_tpu_torch.train.recipes import recipe
    from mhada_tpu_torch.train.train_image import init_params, make_optimizers

    def train_models(backend, size=TRAIN_SIZE, batch=TRAIN_B,
                     fuse_ln="auto"):
        cfg = ImageTrainConfig(
            model=ModelConfig(mhada_backend=backend, fuse_ln=fuse_ln),
            batch_size=batch, image_size=(size, size))
        return cfg, init_params(cfg, "cuda",
                                torch.Generator().manual_seed(SEED))

    def batch(cfg):
        return recipe(cfg).random_batch(cfg, "cuda", rng)

    def interleaved_steps(key, builds, data, reps, note):
        """ms/step of two builds {name: (cfg, models)} in turns (a, b, b,
        a) on the batch ``data``, float32 and bfloat16, with the caching
        allocator's retries (frees and re-allocations after a failed
        cudaMalloc) and the peak device memory in each round -> ok."""
        a, b = builds

        def retries():
            return torch.cuda.memory_stats().get("num_alloc_retries", 0)

        for dname in DTYPE_NAMES:
            try:
                steps = {k: recipe(c).make_step(
                    replace(c, compute_dtype=dname), m, make_optimizers(m, c))
                    for k, (c, m) in builds.items()}
                t, tries, peaks = {a: [], b: []}, [], {a: [], b: []}
                for k in (a, b, b, a):
                    r0 = retries()
                    torch.cuda.reset_peak_memory_stats()
                    t[k].append(cuda_ms(lambda: steps[k](*data), *reps))
                    tries.append(retries() - r0)
                    peaks[k].append(torch.cuda.max_memory_allocated() / 1e9)
            except Exception as e:
                return phase(f"times {key} {dname}", False,
                             f"{type(e).__name__}: {e}")
            step_ms.setdefault(key, {})[dname] = {
                k: sum(v) / len(v) for k, v in t.items()}
            step_peak_gb.setdefault(key, {})[dname] = {
                k: max(v) for k, v in peaks.items()}
            phase(f"times {key} {dname}", True,
                  f"ms/step {a} build {t[a]} {b} build {t[b]} ({note}; "
                  f"allocator retries per round {tries}; peak memory "
                  f"{a} build {max(peaks[a]):.2f} GB, {b} build "
                  f"{max(peaks[b]):.2f} GB; {card})")
        return True

    def step_gate(label, want, kernel, plain, data, path, key_bias=False):
        good, records, tables = train_step_gates(label, want, *kernel,
                                                 *plain, data, key_bias)
        train_extra[f"step {label}"] = records
        grad_tables[label] = tables
        if "float32" in records:
            launches[path] = records["float32"]["launches"]
        return good

    grad_tables, step_peak_gb = {}, {}
    # the 256^2 run_image run's last checkpoint, which phase 7e's
    # run_video resumes across from
    xover = tempfile.TemporaryDirectory()
    # a. the recipe: 256^2, B = 8
    kernel, plain = train_models("auto"), train_models("plain")
    (kcfg, ktrain), (pcfg, ptrain) = kernel, plain
    tc, ts = batch(kcfg)
    ok = step_gate("256^2", TRAIN, kernel, plain, [tc, ts], "train") and ok

    try:
        step = recipe(kcfg).make_step(kcfg, ktrain,
                                      make_optimizers(ktrain, kcfg))
        losses = [float(step(tc, ts)["loss"]) for _ in range(5)]
        good = all(np.isfinite(losses)) and losses[-1] < losses[0]
    except Exception as e:
        good, losses = False, f"{type(e).__name__}: {e}"
    train_extra["five_steps_float32"] = losses
    ok = phase("train 5 steps float32", good, f"losses {losses}") and ok

    def run_image_main(tmp, size, b, *extra):
        run_image.main(["--coco", f"{tmp}/coco", "--wikiart",
                        f"{tmp}/wikiart", "--models-dir", f"{tmp}/models",
                        "--image-size", str(size), str(size),
                        "--batch-size", str(b), "--seed", str(SEED),
                        "--log-every", "1", "--metrics-jsonl",
                        f"{tmp}/m.jsonl", *extra])
        return ([json.loads(ln) for ln in open(f"{tmp}/m.jsonl")],
                sorted(os.listdir(f"{tmp}/models")))

    try:
        with tempfile.TemporaryDirectory() as tmp:
            synthetic_folders(tmp, 16, rng)
            run_image_main(tmp, TRAIN_SIZE, TRAIN_B, "--epochs", "1",
                           "--steps-per-epoch", "2")
            rows, files = run_image_main(
                tmp, TRAIN_SIZE, TRAIN_B, "--epoch-start", "2", "--epochs",
                "2", "--steps-per-epoch", "1")
            shutil.copy(f"{tmp}/models/checkpoint_epoch_2_batchSize_8.pth",
                        xover.name)
        good = ([r["epoch"] for r in rows] == [1, 1, 2]
                and all(np.isfinite(r["loss"]) for r in rows)
                and "checkpoint_epoch_2_batchSize_8.pth" in files)
        detail = (f"losses {[r['loss'] for r in rows]} epochs "
                  f"{[r['epoch'] for r in rows]}; files {files}")
    except Exception as e:
        good, detail = False, f"{type(e).__name__}: {e}"
    ok = phase("train run_image 2 steps + 1 resumed", good, detail) and ok

    ok = interleaved_steps("train256", {"plain": plain, "kernel": kernel},
                           [tc, ts], (1, 3), "256^2, B = 8") and ok

    # b. the fused-LN build (K2 and its VJP at every pre-LN), 256^2, B = 8
    fused = train_models("auto", fuse_ln=True)
    ok = step_gate("fused-LN 256^2", TRAIN_FUSED, fused,
                   train_models("plain", fuse_ln=True), [tc, ts],
                   "train_fuseln") and ok
    ok = interleaved_steps("fuseln256", {"unfused": kernel, "fused": fused},
                           [tc, ts], (1, 3), "kernel builds, 256^2, B = 8") \
        and ok
    del kernel, plain, fused, ktrain, ptrain, tc, ts
    torch.cuda.empty_cache()

    # c. 512^2, B = 4: 4096 tokens at every attention and MHAda site
    kernel = train_models("auto", BIG_SIZE, BIG_B)
    plain = train_models("plain", BIG_SIZE, BIG_B)
    tc, ts = batch(kernel[0])
    ok = step_gate("512^2", TRAIN, kernel, plain, [tc, ts], "train512") \
        and ok
    ok = interleaved_steps("train512", {"plain": plain, "kernel": kernel},
                           [tc, ts], (1, 2), f"512^2, B = {BIG_B}") and ok
    del kernel, plain, tc, ts
    torch.cuda.empty_cache()
    if args.dump:
        with open(args.dump, "w") as f:
            json.dump(grad_tables, f, indent=0)

    # d. the CLI at 512^2, B = 8
    try:
        with tempfile.TemporaryDirectory() as tmp:
            synthetic_folders(tmp, 16, rng)
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            rows, files = run_image_main(tmp, BIG_SIZE, 8, "--epochs", "1",
                                         "--steps-per-epoch", "2")
            seconds = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() / 1e9
        good = ([r["epoch"] for r in rows] == [1, 1]
                and all(np.isfinite(r["loss"]) for r in rows)
                and "checkpoint_epoch_1_batchSize_8.pth" in files)
        train_extra["run_image_512_b8"] = dict(
            losses=[r["loss"] for r in rows], peak_gb=peak, seconds=seconds)
        detail = (f"losses {[r['loss'] for r in rows]}; files {files}; "
                  f"peak memory {peak:.2f} GB; {seconds:.1f} s with set-up")
    except Exception as e:
        good, detail = False, f"{type(e).__name__}: {e}"
    ok = phase("train run_image 512^2 B=8 2 steps", good, detail) and ok

    # e. the video recipe: B = 2 pairs of 256 x 512 frames (2048 tokens),
    #    256^2 styles (1024); flow U(-5, 5), mask U(0, 1) > 0.2 as the
    #    JAX bench's (mhada_tpu/train/bench_steps.py:76-79)
    t0 = time.perf_counter()

    def video_models(backend):
        cfg = VideoTrainConfig(model=ModelConfig(mhada_backend=backend))
        return cfg, init_params(cfg, "cuda",
                                torch.Generator().manual_seed(SEED))

    vkernel, vplain = video_models("auto"), video_models("plain")
    vcfg, vtrain = vkernel
    vbatch = batch(vcfg)
    ok = step_gate("video", TRAIN_VIDEO, vkernel, vplain, vbatch,
                   "train_video", key_bias=True) and ok
    try:
        step = recipe(vcfg).make_step(vcfg, vtrain,
                                      make_optimizers(vtrain, vcfg))
        losses = [float(step(*vbatch)["loss"]) for _ in range(5)]
        good = all(np.isfinite(losses)) and losses[-1] < losses[0]
    except Exception as e:
        good, losses = False, f"{type(e).__name__}: {e}"
    train_extra["video_five_steps_float32"] = losses
    ok = phase("train video 5 steps float32", good, f"losses {losses}") \
        and ok
    try:
        with tempfile.TemporaryDirectory() as tmp:
            synthetic_sceneflow(tmp, rng)
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                run_video.main([
                    "--datasets", tmp, "--models-dir", xover.name,
                    "--epoch-start", "3", "--epochs", "3",
                    "--image-batch-size", str(TRAIN_B), "--steps-per-epoch",
                    "2", "--seed", str(SEED), "--log-every", "1",
                    "--metrics-jsonl", f"{tmp}/v.jsonl"])
            print(out.getvalue(), end="", flush=True)
            rows = [json.loads(ln) for ln in open(f"{tmp}/v.jsonl")]
        files = sorted(os.listdir(xover.name))
        source = os.path.join(xover.name, "checkpoint_epoch_2_batchSize_8.pth")
        good = (f"resumed from {source} (epoch 2)" in out.getvalue()
                and [r["epoch"] for r in rows] == [3, 3]
                and all(np.isfinite(r["loss"]) for r in rows)
                and "checkpoint_epoch_3_batchSize_2.pth" in files)
        train_extra["run_video"] = [r["loss"] for r in rows]
        detail = (f"resumed across from run_image's "
                  f"checkpoint_epoch_2_batchSize_8.pth: "
                  f"{f'resumed from {source}' in out.getvalue()}; losses "
                  f"{[r['loss'] for r in rows]} epochs "
                  f"{[r['epoch'] for r in rows]}; files {files}")
    except Exception as e:
        good, detail = False, f"{type(e).__name__}: {e}"
    xover.cleanup()
    ok = phase("train run_video 2 steps, resumed from run_image", good,
               detail) and ok
    ok = interleaved_steps("video", {"plain": vplain, "kernel": vkernel},
                           vbatch, (1, 3), "the video recipe, B = {}, {} x {}"
                           " frames, {}^2 styles".format(
                               vcfg.batch_size, *vcfg.content_size,
                               vcfg.style_size[0])) and ok
    del vkernel, vplain, vtrain, vbatch
    torch.cuda.empty_cache()
    video_s += time.perf_counter() - t0

    # ---- 8. the evals, on the kernel build's weights from the seed
    t0 = time.perf_counter()
    emodels, epmodels = models_for("auto"), models_for("plain")
    good, evals = evals_phase(emodels, epmodels, card, gates)
    ok = good and ok
    del emodels, epmodels
    torch.cuda.empty_cache()
    evals_s = time.perf_counter() - t0

    # ---- the kernels' summary: one row per TPU kernel the path replaces
    first_gate = {}
    for gate, row, *_ in gate_list:
        first_gate.setdefault(row, gate)
    first_gate[K12_SINGLE] = first_gate["K1 attention_tm"]
    for _, row_f, row_b, *_ in TRAIN_GATES:   # recorded under the row
        for row in (row_f, row_b):
            if row is not None:
                first_gate[row] = row
    summary = []
    for name, entry, source, replaces, path in ROWS:
        first = first_gate[name]
        rec = gates.get(first, {})
        r32, r16 = rec.get("float32", {}), rec.get("bfloat16", {})
        row_path, note = PATH_NOTES.get(path, (path, None))
        row = dict(name=name, route="cuda", source=source,
                   replaces=replaces, gate=first, path=row_path,
                   launches=launches.get(path, {}).get(entry, 0))
        if path == "train":   # K6, K7, K8: the video step's launches too
            row["launches_video"] = launches.get("train_video", {}).get(
                entry, 0)
        if note:
            row["path_note"] = note
        if not r32:   # a bfloat16-only kernel (P1): its numbers stand first
            r32, row["dtype"] = r16, "bfloat16 only"
        for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms"):
            row[key] = r32.get(key)
            row[key + "_bf16"] = r16.get(key)
        # the share of the bound each build reaches
        for suffix, r in (("", r32), ("_bf16", r16)):
            if r.get("ms"):
                row["bound_share" + suffix] = r["bound_ms"] / r["ms"]
        # K2's other timings; the backward's dK/dV and dQ kernels and the
        # float32 tail's two stages apart
        for key in ("kernel_ms", "wrapper_ms", "dkv_ms", "dq_ms", "up3_ms",
                    "c5c6_ms", "tile"):
            if key in r32 or key in r16:
                row[key] = r32.get(key)
                row[key + "_bf16"] = r16.get(key)
        # the call that was timed, as the gate recorded it
        row["library"] = r32.get("library") or r16.get("library") or NO_LIB
        summary.append(row)
    extra = {g: gates.get(g) for g, *_ in gate_list + EVAL_GATES
             if g not in first_gate.values()}
    stopped = stop_children()
    left = _children()
    ok = phase("processes", not left,
               f"still running at the end, stopped: {stopped or 'none'}; "
               f"left: {left or 'none'}") and ok
    seconds = time.perf_counter() - t_start
    phase("run time", True, f"{seconds:.1f} s from start to summary, "
          f"{video_s:.1f} s of it the video gates and step (phases 6, 7e), "
          f"{evals_s:.1f} s the evals (phase 8)")
    print(json.dumps({"kernels": summary, "extra_gates": extra,
                      "launches": launches, "frame_ms": frame_ms,
                      "video_cli": video_cli, "evals": evals,
                      "train": train_extra, "step_ms": step_ms,
                      "step_peak_gb": step_peak_gb,
                      "card": card, "seconds": seconds}), flush=True)
    if not ok:
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    finally:   # a failed run, too, leaves nothing running
        if stop_children():
            print("chip_smoke: stopped processes left running",
                  file=sys.stderr)
    sys.exit(rc)
