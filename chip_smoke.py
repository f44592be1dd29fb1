#!/usr/bin/env python3
"""Drive the PyTorch port (mhada_tpu_torch) on one CUDA card, in phases.

    python3 chip_smoke.py        # from the root of the repository

1. environment: torch / CUDA versions, the card's name and power limit,
   whether cv2 imports (reported, never failed);
2. build: compile mhada_tpu_torch/csrc/*.cu with nvcc (one per source, in
   parallel); the bf16 mma.sync kernels of K14 and of K13 must each hold
   HMMA.16816.F32.BF16 in their SASS (cuobjdump) and spill nothing
   (ptxas); the wgmma + TMA kernels, the decoder tail of K5 and K8
   (tail_up3_wgmma_kernel, tail_c5c6_wgmma_kernel <residuals>, both
   instantiations present), the MHAda tile of K3, K4, P2 and K7's forward
   (mhada_wgmma_kernel
   <prologue, split, residuals>, all five instantiations present), K7's
   backward (mhada_wgmma_dq_kernel, mhada_wgmma_dkv_kernel), the attention
   tile of K1, K6's forward and K1's cross form (attention_wgmma_kernel
   <split>, both instantiations present), K6's backward
   (attention_wgmma_dq_kernel, attention_wgmma_dkv_kernel), K2's
   (ln_matmul_wgmma_kernel) and every block tile of P1's, must hold HGMMA
   (wgmma) and
   UTMALDG (TMA loads), spill nothing and draw no note from ptxas that it
   serialised their products (C75xx); every instantiation that a bf16
   path launches must exist (the tail with and without residuals, K2's,
   K14's, K13's), no bf16 instantiation of the CUDA-core kernels they
   replaced may exist (those of K1, K4, K5, K6, K7, K8 and K2), nor any
   of the mma.sync MHAda tile (mhada_mma_fwd_kernel: K3 and K4 before the
   wgmma tile, K7's forward before its residual epilogue) or of K7's and
   K6's mma.sync backwards (mhada_mma_dq_kernel, mhada_mma_dkv_kernel,
   attention_mma_dq_kernel, attention_mma_dkv_kernel) or K2's mma.sync
   kernel (ln_matmul_mma_kernel) or the mma.sync tail of K5 and K8
   (decoder_tail_mma_kernel), nor any instantiation of K14's old
   conv (conv3x3_relu_kernel, either dtype) or of P1's old wmma kernel
   (mm_probe_kernel), nor any instantiation of the old flash tile
   (flash_tile_kernel, the f32 forwards of K1, K4, K6 and K7 before the
   float32 tile) or of K13's first kernel (decoder_c6_kernel, either
   dtype), nor a float32 instantiation of the old
   flash backward (flash_bwd_dkv_kernel, flash_bwd_dq_kernel) or of the
   old fused tail (decoder_tail_kernel<bool>, K5's and K8's before the
   two-stage float32 tail), nor any instantiation of the mma.sync
   attention forward (attention_mma_fwd_kernel: K1, K6's forward and K1's
   cross form before the attention wgmma tile); K2's float32 kernel, the
   float32 flash tile
   (csrc/mhada_f32_tile.cuh: the MHAda kernel <prologue, stages,
   residuals> of K4 <false, 2, false>, K3 <true, 2, false>, P2 <true, 1,
   false> and K7's forward <false, 2, true>; the attention kernel <lse,
   split> of K1 <false, false>, K6's forward <true, false> and K1's cross
   form split over the keys <false, true>; the split's combine,
   csrc/attention_combine.cuh; the combine of K3 and K4 split over the
   keys, csrc/mhada_combine.cuh, <prologue>), the float32 flash backward
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
   4096, also against K3 (float32 and bfloat16); K3 also at an SP rank's
   1024 queries against 4096 keys (B = 1) and at the video CLI's 2048
   against 1024 (B = 8), each K1, K3 and K4 gate (phase 8's K1 too) with
   its split over the keys (``self_splits``, ``mhada_splits``) and the
   device time of the tile and of the combine apart; at bfloat16 every
   split count of K3 and K4 forced once (512 against 1000 keys) against
   the plain version and repeated bit for bit,
   and a planted control (the kernel's partials at 1024 against 4096
   combined in PyTorch without the last split) that must fail the gate
   while the kernel passes it, the seconds all this adds printed; P1 at
   its 8 shapes
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
   yardstick), both on the inputs cast once to the compute dtype, and the
   kernel alone run twice, bit for bit (K2's gates at phases 6, 8 and 10d
   too: the kernel alone, the wrapper, the chain, the share of the bound
   and the repeat); K14 also
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
   backward), K7 (MHAda, forward and backward; also at a ragged shape, B
   = 2, 1000 queries against 3000 keys, and at a rank's share of the TP
   split, 4 heads of 64, B = 1, 3600 queries against 1024 keys) and K8
   (the decoder tail writing its residuals) against their plain versions
   at the image
   training step's shapes (B = 8, 256^2: L = N = M = 1024 tokens, the tail
   from 128^2 to 256^2); K6 and K7 also beyond the TPU's token-major
   training windows, as the ports of K12, K10's residuals and K11 (B = 4 at
   4096 tokens, the 512^2 step's shapes, and B = 1 at 16384), K8 from 256^2
   to 512^2 (B = 4), and K2 under its VJP at the fused-LN step's shapes
   (B = 8, 1024 tokens, 512 -> 1536 and 2048) against autograd of the
   unfused LayerNorm and linear (its forward timed as the kernel alone,
   through the wrapper and as the library chain of phase 3); float32 and
   bfloat16: each output, residual and input gradient against its own
   scale, with times, bounds and the library yardstick, K6's forward also
   with its split over the keys (``self_splits``), its device time
   (tile and combine apart) and its lse against the plain lse (LSE_REL),
   and K6's and K7's
   backward also as its dK/dV and dQ kernels' device times apart
   (``torch.profiler``), K8's float32 forward as its two kernels' (up3;
   the upsample, c5 and c6); and at the video step's shapes (B = 2; 256 x
   512 frames are 2048 tokens, 256^2 styles 1024): K6 at L = 2048, K7 at
   N = 2048 against M = 1024, K8 from 128 x 256 to 256 x 512, the first
   non-square tail at full width; and a planted control of K6's forward
   split over the keys (B = 2, L = 2048, bfloat16: the kernel's partials
   combined in PyTorch without the last split must fail the gate's out
   and lse bounds while the kernel and the whole combine pass them); K7's
   checks at bfloat16 (K7_CHECK, B = 1, 1024 queries against 4096 keys):
   its forward's out bit for bit K4's at every forced split count 1..3, a
   planted control of its forward split over the keys (its partials
   combined in PyTorch without the last split must fail the gate's out,
   M1, E2 and lse bounds while the kernel and the whole combine pass
   them), and two launches of its backward bitwise equal; K6 and K7 also
   at a ragged shape (K6: B = 2, 1000 tokens) and at a rank's share of the
   TP split (K6: 4 heads of 64, B = 1, 2048 tokens) at both dtypes; K6's
   checks at bfloat16 (K6_CHECK, B = 4, 4096 tokens, the 512^2 step's):
   two launches of its backward bitwise equal, and a planted fault, its
   dQ times 1.25, that must fail the gate's backward bound while the
   kernel passes it;
7. the training paths: one step (``train.train_image``) on the kernel build
   and one on the plain build from the same weights and batch, losses and
   every gradient held together (each tensor against its own scale, to a
   bound widened only where a rounding-level change of the inputs moves
   the plain build as far), launch counts exact; controls that the
   gradient gate must report (a planted fault in K7's dq; the plain build
   in bfloat16 against the float32 bounds), and in bfloat16 what faults
   of x 1.1 and x 1.25 in K7's dq move (printed, not gated); at 256^2, B
   = 8: that step, 5
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
   ceiling (each one's reading printed beside its rounding controls) and
   a planted fault in K7's dK that must cross it, 5 steps on
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
      launches, wall per pair);
9. the analysis tools (``mhada_tpu_torch.analysis``) and the reference's
   unused variants:
   a. K6 at B = 1, L = 1024 and K7 at B = 1, N = M = 1024 (feature
      inversion's shapes at 256^2) against their plain versions, forward,
      backward and input gradients, float32 and bfloat16;
   b, c. ``analysis.visualize.main --mode vit`` and ``--mode mhada`` at
      256^2, 20 Adam steps, on random full-width weights written as the
      .pth triple: the PNG, finite falling losses, exact launches (K6
      3 (iters + 1) + 3 iters; mhada: K6 3 (iters + 2) + 3 iters, K7
      6 (iters + 1) + 6 iters, K8 none);
   d. the same 20-step inversions on the kernel and the plain training
      builds from one image (every step's loss within 1e-3, the images
      within 0.5 on 0-255), and device ms per Adam step of both builds in
      turns, with the seconds the recipe's 3000 steps would take;
   e. ``--mode vgg --last-layer 3`` and ``--mode vgg_progressive`` at
      224^2 on random VGG weights: finite falling losses, five
      reconstructions, no launches;
   f. ``analysis.counts.report()`` on the card equal to the CPU's, and
      ``count_flops`` refusing a kernel-build forward;
   g. whether matplotlib imports, and the histogram plot if it does;
   h. VisionTransformerMultiScale (256^2), AdaAttnTransformer (three
      (1, 32, 32, 512) lists) and VGG19Classifier ((1, 14, 14, 512)) at
      full width on the card against the CPU, float32, no launches;
10. the multi-rank serving paths (``mhada_tpu_torch.parallel``):
   a. K1's cross form (``ops.attention_kernel.attention_cross``: N
      queries against M keys, the TPU's K12 forwards at N != M) against
      its plain version at the sequence-parallel shapes, B = 1, 8 heads:
      1024 and 2048 queries against 4096 keys (512^2 over 4 and 2 ranks),
      4096 against 16384 (1024^2 over 4), and at a ragged 1000 against 3000
      at B = 2, float32 and bfloat16, with time, bound, SDPA's time on the
      same q, k, v, the chooser's split over the keys (``cross_splits``)
      and the device time of the split tile and of the combine apart, and
      phase 3's K1 time beside; every split count the chooser can give
      forced once (512 against 1000 keys) against the plain version and
      repeated bit for bit; a planted control (the kernel's partials at the
      first shape combined in PyTorch without the last split) that must
      fail the gate while all of them pass it; ungated readings through
      the cross entry: the self shape 4096^2 at bfloat16 (K1's own tile)
      beside SDPA, 1024^2 at float32 beside K6's forward;
   b. PAR_RANKS ranks sharing the card over gloo (``parallel_rank``), the
      full-width model from the seed with c6's gain and a raised bias:
      SP at 512^2 over all of them and over 2 (f32, bf16), with the
      planted control (no decoder halo must leave the frame by more than
      0.1) and margin 4 printed; SP at 1024^2 against a 1024^2 style over
      all (bf16); PP over 3 stages, 6 frames at 512^2 (f32); DP at 512^2,
      B = 2 a rank against one rank's B = 8 (f32); each frame against the
      single-rank frame within the main paths' pixel bounds, the
      reference more than 60 % mid-range, launches exact on every rank
      (an SP frame: K1's cross form 3, K2 6, K3 6, K5 1; PP: rank 0 K1 3
      and K2 6 a frame, every stage K3 2 a frame, the last K5 1), the
      wall ms a frame printed, not gated; rank 0 also runs SP and DP over
      a group of its own on NCCL (world size 1);
   c. NCCL across cards, the same checks (and d's steps in float32 where
      four cards are visible), where two or more cards are visible; else
      one line says it did not run;
   d. data-parallel and DP x TP training (``parallel.mesh``,
      ``parallel.tp``): K6, K7 and K2 at one rank's share of the
      tensor-parallel split (4 heads of 64, K6's packed qkv 768 wide, K7
      on 256 channels, at the image step's 4 a rank and 1024 tokens and
      the video step's 1 a rank at 2048 against 1024 tokens; K2's outputs
      768 and 1024 wide), each against its plain version with time,
      bound and library time, float32 and bfloat16; then, in the same
      ranks as b, one step on the (data, model) mesh from the full-width
      weights on each rank's shard of the global batch: the image step
      (256^2, B = 8) on (4 x 1) and (2 x 2), the fused-LN step on
      (2 x 2), the video step (B = 2, the second sample fully occluded)
      on (2 x 2), float32 and bfloat16, each held on rank 0 against the
      single-rank kernel build's step from the same weights on the global
      batch with phase 7's bounds and rounding controls (the gradients
      and the weights after Adam gathered over the model group), the
      replicated weights bitwise equal over each model group, launches
      exact on every rank (image: K6 12 + 12, K7 18 + 18, K8 3; fused-LN:
      K2 24 more; video: K6 18 + 18, K7 30 + 30, K8 5), each rank's wall
      ms and peak memory printed, not gated; two planted faults that the
      gate must report (no sum in ``copy_to_model``'s backward; each
      rank's temporal losses over its own mask); beside those ranks,
      ``python -m mhada_tpu_torch.train.run_image --nproc 2`` for 2 steps
      at 256^2, global B = 4, in a session of its own (exit 0, finite
      losses, one checkpoint, nothing of its session left).

Each phase prints one line; any failure exits non-zero without the final
result line.  The model is the full-width ``ModelConfig()`` with random
weights from a seed.  The line before the last is the kernels' JSON
summary; the last line is ``{"ok": true, "device": {...}}``.  ``--dump
FILE`` also writes phase 7's per-tensor gradient errors and bounds.
"""

import argparse
import contextlib
import copy
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
XATTN = "mhada_attention_cross_fwd"   # K1's cross form (N queries, M keys)
SRC = "mhada_tpu_torch/csrc/"
K12_SINGLE = "K12 single-pass forward, by K1's kernel"
K12_FWD = "K12 streaming forward with lse, by K6's forward"
K12_BWD = "K12 flash backward, by K6's backward"
K10_RES = "K10 streaming forward with M1/E2/lse, by K7's forward"
K11_BWD = "K11 flash backward, by K7's backward"
K2_VJP = "K2 ln_matmul under its VJP (fused-LN training)"
K12_CROSS = "K12 single-pass forward at N != M, by K1's cross form"
K12_CROSS_STREAM = "K12 streaming forward at N != M, by K1's cross form"
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
    # K12 at N != M: the sequence-parallel ViT attention, each rank's
    # queries against the keys gathered over the ranks (phase 10)
    (K12_CROSS, XATTN, SRC + "attention_fwd.cu",
     "mhada_tpu/ops/attention_pallas.py:62", "sp512"),
    (K12_CROSS_STREAM, XATTN, SRC + "attention_fwd.cu",
     "mhada_tpu/ops/attention_pallas.py:488", "sp1024"),
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
    # K3 where the split over the keys matters: an SP rank's 1024 queries
    # (512^2 over 4 ranks) against the whole style, and the video CLI's
    # 256 x 512 frame against a 256^2 style at its --chunk 8 batch
    ("K3 B=1 N=1024 M=4096", "K3 mhada_fused_prologue", "prologue",
     (1024, 4096), 1),
    ("K3 B=8 N=2048 M=1024", "K3 mhada_fused_prologue", "prologue",
     (2048, 1024), 8),
]
SPLIT_K3_GATES = ("K3 B=1 N=1024 M=4096", "K3 B=8 N=2048 M=1024")
BF16_ONLY = {"mm"}

# Launches of each path (C entry point -> count).
# The inference paths launch none of the training kernels, and no path
# launches K14 or the probes.
NO_TRAIN = {K6F: 0, K6B: 0, K7F: 0, K7B: 0, K8: 0, C6: 0, MID: 0, MM: 0,
            PIPE: 0, XATTN: 0}
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
         K7B: 18, K8: 3, C6: 0, MID: 0, MM: 0, PIPE: 0, XATTN: 0}
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
# K6 and K7 beyond the steps' shapes, at both dtypes: a ragged shape (no
# 192-query block, 64-key tile or 128-key block divides 1000 or 3000) and
# a rank's share of the TP split (4 heads of 64): K6 at the video step's
# frames, K7 at the Sintel eval's 3600 queries against a 256^2 style.
# (gate, kind, batch, tokens, tp.)
K6_EXTRA_GATES = [
    ("K6 B=2 L=1000", "attention", 2, 1000, 1),
    ("K6 TP/2 B=1 L=2048", "attention", 1, 2048, 2),
]
K7_EXTRA_GATES = [
    ("K7 B=2 N=1000 M=3000", "mhada", 2, (1000, 3000), 1),
    ("K7 TP/2 B=1 N=3600 M=1024", "mhada", 1, (3600, 1024), 2),
]
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
# K6's lse against the plain lse, relative to its scale, at both dtypes:
# it is float32 on every side (P rounds to bf16 only inside P V), and a
# split dropped from the combine moves it by log of the kept share.
LSE_REL = 1e-5
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
# A fault in K7's dq between BELOW_DQ and PLANTED_DQ, bfloat16 only: what x
# 1.25 moves in the step gate, printed beside x 1.1 (BELOW_DQ), not gated.
MID_DQ = {"bfloat16": 0.25}
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
# Phase 9, the analysis tools.  Feature inversion differentiates the
# training build at B = 1: at the recipe's 256^2 that is 1024 tokens, K6
# with 8 heads of 64 and K7 at N = M = 1024, a batch the step gates (B = 8)
# do not take at that length.  Rows as TRAIN_GATES', recorded under their
# own names.
INVERSION_GATES = [
    ("K6 B=1 L=1024", None, None, "attention", 1, 1024),
    ("K7 B=1 N=M=1024", None, None, "mhada", 1, 1024),
]
# The inversions: Adam steps of the CLI and of the build comparison, the
# side (the recipe's), the reference recipe's steps (visual_vit.py:88-120)
# and the VGG modes' side (visual_cnn.py's 224^2).
INVERT_ITERS, INVERT_SIZE, RECIPE_ITERS, VGG_SIZE = 20, 256, 3000, 224
# Kernel build against plain build, the same float32 Adam steps from one
# image: every step's loss, relative; the image's largest difference on
# 0-255 (Adam moves a pixel by about lr = 0.5 a step).
INVERT_LOSS_REL, INVERT_PIXEL = 1e-3, 0.5
# The f32 kernels of K6 and K7 that an inversion step launches (names), to
# take their device time apart from the step's.
INVERSION_KERNELS = ("attention_f32_kernel", "mhada_f32_kernel",
                     "flash_bwd_f32")
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
# The bf16 mma.sync kernels of K14 (csrc/decoder_mid_mma.cuh) and K13
# (csrc/decoder_c6_mma.cuh) and the instruction each must contain.
MMA_KERNELS = ("decoder_mid_mma_kernel", "decoder_c6_mma_kernel")
HMMA = "HMMA.16816.F32.BF16"
# The tail's two kernels at each dtype (csrc/decoder_tail_f32.cuh,
# csrc/decoder_tail_wgmma.cuh): up3, then the upsample, c5 and c6; timed
# apart by name in the K5 and K8 gates.
# The K5 gates run the kernel this many times on the same inputs and fail
# unless every output is bitwise the first's.
TAIL_REPEATS = 8
TAIL_STAGES = {"float32": ("tail_up3_f32_kernel", "tail_c5c6_f32_kernel"),
               "bfloat16": ("tail_up3_wgmma_kernel",
                            "tail_c5c6_wgmma_kernel")}
# The bf16 wgmma + TMA kernels (the MHAda tile of K3, K4, P2 and K7's
# forward, split or not: csrc/mhada_wgmma.cuh; K7's backward, its dQ and
# dK/dV kernels: csrc/mhada_bwd_wgmma.cuh; the attention tile of K1, K6's
# forward and K1's cross form, split or not: csrc/attention_wgmma.cuh;
# K6's backward, its dQ and dK/dV kernels: csrc/attention_bwd_wgmma.cuh;
# K2: csrc/ln_matmul_wgmma.cuh; P1, each block tile: csrc/mm_wgmma.cuh;
# K5's and K8's tail, its up3 kernel and its upsample + c5 + c6 kernel:
# csrc/decoder_tail_wgmma.cuh) and the instructions each must contain:
# HGMMA (wgmma) and UTMALDG (TMA loads).
WGMMA_KERNELS = ("mhada_wgmma_kernel", "mhada_wgmma_dq_kernel",
                 "mhada_wgmma_dkv_kernel", "attention_wgmma_kernel",
                 "attention_wgmma_dq_kernel", "attention_wgmma_dkv_kernel",
                 "ln_matmul_wgmma_kernel", "mm_wgmma_kernel",
                 "tail_up3_wgmma_kernel", "tail_c5c6_wgmma_kernel")
WGMMA_SASS = ("HGMMA", "UTMALDG")
# Instantiations (mangled-name parts) that the bf16 paths launch: K14,
# K13; the MHAda wgmma tile's <prologue, split,
# residuals>: K3 (and P2) <true, false, false>, K3 split <true, true,
# false>, K4 <false, false, false>, K4 and K7's forward split <false, true,
# false>, K7's forward unsplit <false, false, true>; K7's dQ and dK/dV
# kernels; the attention wgmma tile's <split>: K1, K6's forward and K1's
# cross form, <false> unsplit and <true> split over the keys; K6's dQ and
# dK/dV kernels; K2's; the tail's up3 kernel (K5 and K8) and its upsample
# + c5 + c6 kernel <residuals>, K5 <false>, K8 <true>.
MMA_REQUIRED = ("decoder_mid_mma_kernel", "decoder_c6_mma_kernel")
WGMMA_REQUIRED = ("mhada_wgmma_kernelILb1ELb0ELb0E",
                  "mhada_wgmma_kernelILb1ELb1ELb0E",
                  "mhada_wgmma_kernelILb0ELb0ELb0E",
                  "mhada_wgmma_kernelILb0ELb1ELb0E",
                  "mhada_wgmma_kernelILb0ELb0ELb1E",
                  "mhada_wgmma_dq_kernel", "mhada_wgmma_dkv_kernel",
                  "attention_wgmma_kernelILb0E", "attention_wgmma_kernelILb1E",
                  "attention_wgmma_dq_kernel", "attention_wgmma_dkv_kernel",
                  "ln_matmul_wgmma_kernel", "tail_up3_wgmma_kernel",
                  "tail_c5c6_wgmma_kernelILb0E",
                  "tail_c5c6_wgmma_kernelILb1E")
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
# csrc/decoder_c6_mma.cuh), every instantiation of the mma.sync attention
# forward (attention_mma_fwd_kernel: K1's cross form <false, true> before
# csrc/attention_wgmma.cuh, K1 <false> and K6's forward <true> before the
# attention wgmma tile took them), and every instantiation of the mma.sync
# MHAda tile (mhada_mma_fwd_kernel: K3 and K4 before the wgmma tile of
# csrc/mhada_wgmma.cuh, K7's forward <true> before its residual epilogue
# there) and of K7's mma.sync backward (mhada_mma_dq_kernel,
# mhada_mma_dkv_kernel, before csrc/mhada_bwd_wgmma.cuh), K6's
# (attention_mma_dq_kernel, attention_mma_dkv_kernel, before
# csrc/attention_bwd_wgmma.cuh), K2's mma.sync kernel
# (ln_matmul_mma_kernel, before csrc/ln_matmul_wgmma.cuh) and the
# mma.sync tail of K5 and K8 (decoder_tail_mma_kernel<bool>, before
# csrc/decoder_tail_wgmma.cuh).
OLD_BF16 = (r"flash_tile_kernel"
            r"|flash_bwd_(dkv|dq)_kernelI13__nv_bfloat16"
            r"|decoder_tail_kernelI13__nv_bfloat16"
            r"|ln_matmul_kernelI13__nv_bfloat16"
            r"|conv3x3_relu_kernelI"
            r"|mm_probe_kernel"
            r"|flash_bwd_(dkv|dq)_kernelIf"
            r"|decoder_tail_kernelILb"
            r"|decoder_c6_kernel"
            r"|attention_mma_fwd_kernel"
            r"|mhada_mma_(fwd|dq|dkv)_kernel"
            r"|attention_mma_(dq|dkv)_kernel"
            r"|ln_matmul_mma_kernel"
            r"|decoder_tail_mma_kernel")
# float32 kernels that compute in float32: they must exist, spill nothing
# and hold no tensor-core instruction of any kind (HMMA, HGMMA: no TF32).
# K2's float32 build, the float32 flash tile (csrc/mhada_f32_tile.cuh: the
# MHAda kernel of K4, K3, P2 and K7's forward, the attention kernel of K1
# and K6's forward), the float32 flash backward (csrc/flash_bwd_f32.cuh:
# K6's and K7's dK/dV and dQ kernels) and the float32 tail
# (csrc/decoder_tail_f32.cuh: K5's and K8's up3 kernel and upsample + c5 +
# c6 kernel), K14's conv (csrc/decoder_mid_f32.cuh) and K13's
# (csrc/decoder_c6_f32.cuh); the combines of K1's cross form and of K3 and
# K4 split over the keys (csrc/attention_combine.cuh, both output dtypes;
# csrc/mhada_combine.cuh: float32 sums).
F32_KERNELS = ("ln_matmul_f32_kernel", "mhada_f32_kernel",
               "attention_f32_kernel", "attention_combine_kernel",
               "mhada_combine_kernel",
               "flash_bwd_f32_dkv_kernel",
               "flash_bwd_f32_dq_kernel", "tail_up3_f32_kernel",
               "tail_c5c6_f32_kernel", "decoder_mid_f32_kernel",
               "decoder_c6_f32_kernel")
# The float32 instantiations that the paths and P2 launch (mangled): the
# MHAda kernel's <prologue, ring stages, residuals>, K4 <false, 2, false>,
# K3 <true, 2, false>, P2 <true, 1, false>, K7's forward <false, 2, true>;
# the attention kernel's <lse, split>, K1 <false, false>, K6's forward
# <true, false>, K1's cross form split over the keys <false, true>, and the
# split's combine into float32 and bf16; the MHAda split's combine
# <prologue>, K3 <true>, K4 <false>; the backward's <mhada>, K6
# <false>, K7 <true>; the tail's up3 kernel (K5 and K8) and its c5 + c6
# kernel <residuals>, K5 <false>, K8 <true>; K14's; K13's.
F32_REQUIRED = ("mhada_f32_kernelILb0ELi2ELb0E",
                "mhada_f32_kernelILb1ELi2ELb0E",
                "mhada_f32_kernelILb1ELi1ELb0E",
                "mhada_f32_kernelILb0ELi2ELb1E",
                "attention_f32_kernelILb0ELb0E",
                "attention_f32_kernelILb1ELb0E",
                "attention_f32_kernelILb0ELb1E",
                "attention_combine_kernelIfE",
                "attention_combine_kernelI13__nv_bfloat16E",
                "mhada_combine_kernelILb1E", "mhada_combine_kernelILb0E",
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


# The phases that failed, named again on standard error at the end, where a
# reader who sees only its last lines finds them.
FAILED = []


def phase(name, ok, detail):
    print(f"[{'PASS' if ok else 'FAIL'}] {name}: {detail}", flush=True)
    if not ok:
        FAILED.append(f"{name}: {detail}"[:600])
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
    SASS (cuobjdump; the wgmma kernels: HGMMA and UTMALDG, and no note of
    ptxas that it serialised their products, C7510-C7515), any
    instantiation of MMA_REQUIRED, WGMMA_REQUIRED or F32_REQUIRED that is
    missing, and any instantiation of a CUDA-core kernel that a redesign
    replaced
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
        # ptxas' notes that it serialised a kernel's wgmma (C7510-C7515),
        # which name the kernel
        m = re.search(r"\((C75\d\d)\).*'(\w+)'", ln)
        if m:
            ptxas.setdefault(m[2], {}).setdefault("notes", set()).add(m[1])
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
            ok = (ok and all(counts.values()) and info.get("spill") == 0
                  and not info.get("notes"))
            out.append(f"{f}: {info.get('regs')} regs (the launch bound; "
                       f"setmaxnreg moves them between warpgroups), "
                       f"{info.get('spill')} B spilled, " + ", ".join(
                           f"{n} x {ins}" for ins, n in counts.items())
                       + f", {funcs[f].count(HMMA)} x {HMMA}, ptxas' "
                       f"serialisation notes: "
                       f"{sorted(info.get('notes', ())) or 'none'}")
    missing = [m for m in MMA_REQUIRED + WGMMA_REQUIRED + F32_REQUIRED
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


def split_ms(fn, parts, iters=3, windows=6):
    """{part: device ms per call of the kernels whose names hold ``part``}
    from ``torch.profiler`` over ``iters`` calls of ``fn`` after one.  A
    window in which the profiler recorded no kernel of some part, or some
    such kernel a number of times that is not a multiple of ``iters``
    (CUPTI has returned a window without device events on an H100, three
    in a row once, and windows that held a third of a backward's
    launches), is profiled again, up to ``windows`` windows; the last
    one's reading is returned, and the callers fail on a part still at
    0."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        out, whole = dict.fromkeys(parts, 0.0), True
        for e in prof.key_averages():
            for part in parts:
                if part in e.key:
                    out[part] += e.self_device_time_total / 1e3 / iters
                    whole = whole and e.count % iters == 0
        if all(out.values()) and whole:
            break
    return out


def busy_ms(fn, parts=(), iters=3):
    """(device ms per call of ``fn`` summed over every kernel that
    ``torch.profiler`` records: the device's busy time, its idle gaps left
    out; {part: that of the kernels whose names hold ``part``})."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total, out = 0.0, dict.fromkeys(parts, 0.0)
    for e in prof.key_averages():
        t = e.self_device_time_total / 1e3 / iters
        total += t
        for part in parts:
            if part in e.key:
                out[part] += t
    return total, out


def tail_stage_ms(split):
    """The tail's stage times from ``split_ms`` over one dtype's
    TAIL_STAGES."""
    up3, c5c6 = split.values()
    return {"up3_ms": up3, "c5c6_ms": c5c6}


def tail_stage_txt(split):
    up3, c5c6 = split.values()
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
    """Seeded inputs of one kernel at ``n`` tokens (K3, K4: n or (queries,
    keys); K5, K13: an n x n input or (height, width); K14: an n x n
    input; P1: the probe's shape number n) and batch ``b`` -> (call(backend),
    flops, bytes moved, (name, call) of one library call or None).  K1's
    cross form, K3 and K4 give the call a ``splits`` attribute: the
    chooser's split over the keys.

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
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dev, dtype)

    if kind == "attention":
        qkv = rnd(1, n, 3 * c)

        def sdpa():
            q, k, v = (t.unflatten(-1, (heads, 64)).transpose(1, 2)
                       for t in qkv.split(c, dim=-1))
            return F.scaled_dot_product_attention(q, k, v)

        def run(be):
            return attention_kernel.attention_tm(qkv, heads, backend=be)

        run.splits = attention_kernel.self_splits(1, heads, n, dtype, sms)
        return run, 4 * n * n * c, 4 * n * c * es, (SDPA, sdpa)
    if kind == "cross":   # K1's cross form: (queries, keys)
        nq, nk = n
        qkv, kv = rnd(b, nq, 3 * c), rnd(b, nk, 2 * c)
        q = qkv[..., :c]

        def sdpa():
            qh, kh, vh = (t.unflatten(-1, (heads, 64)).transpose(1, 2)
                          for t in (q, *kv.split(c, dim=-1)))
            return F.scaled_dot_product_attention(qh, kh, vh)

        def run(be):
            return attention_kernel.attention_cross(q, kv, heads, backend=be)

        run.splits = attention_kernel.cross_splits(b, heads, nq, nk, dtype,
                                                   sms)
        return (run, 4 * b * nq * nk * c, b * (2 * nq + 2 * nk) * c * es,
                (SDPA, sdpa))
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
    if kind == "prologue":   # n queries against n keys, or (N, M)
        nq, nk = (n, n) if isinstance(n, int) else n
        fc = rnd(b, nq, c, scale=2.0) + 1
        fcs = rnd(b, nq, c, scale=3.0) - 1
        mc, rc = instance_norm_stats(fc)
        ms, rs = instance_norm_stats(fcs)
        stats = torch.stack([mc, rc, ms, rs], 1)
        # the block's init U(-1/8, 1/8); k at scale 0.35: logit std ~1.6
        wf = ((torch.rand(heads, 64, 64, generator=g) * 2 - 1) / 8).to(dev)
        fb = ((torch.rand(heads, 64, generator=g) * 2 - 1) / 8).to(dev)
        k, v = rnd(b, nk, c, scale=0.35), rnd(b, nk, c)

        def run(be):
            return mhada_prologue.mhada_fused_prologue(fc, fcs, stats, wf, fb,
                                                       k, v, backend=be)

        run.splits = mhada_kernel.mhada_splits(b, heads, nq, nk, sms) \
            if dtype == torch.bfloat16 else 1
        # K3 at a forced split -> (out, the partials or None); -> out; the
        # epilogue's factor IN(fcs)
        run.launch = lambda s: mhada_prologue.launch_prologue(
            "mhada_mhada_prologue", fc, fcs, stats, wf, fb, k, v, s)
        run.forced = lambda s: run.launch(s)[0]
        run.f = (fcs.float() - ms[:, None]) * rs[:, None]
        return (run, b * (6 * nq * nk * c + 2 * nq * c * 64),
                b * (3 * nq + 2 * nk) * c * es + b * 4 * c * 4
                + heads * 64 * (64 * es + 4),
                prologue_library(fc, stats, wf, fb, k, v, heads))
    if kind == "mhada":   # n queries against n keys, or (N, M)
        nq, nk = (n, n) if isinstance(n, int) else n
        q, k = rnd(b, nq, c, scale=0.35), rnd(b, nk, c, scale=0.35)
        v, f = rnd(b, nk, c), rnd(b, nq, c)

        def run(be):
            return mhada_kernel.mhada_tm(q, k, v, f, heads, backend=be)

        run.splits = mhada_kernel.mhada_splits(b, heads, nq, nk, sms) \
            if dtype == torch.bfloat16 else 1
        run.launch = lambda s: mhada_kernel._mhada_launch(q, k, v, f, heads,
                                                          s)
        run.forced = lambda s: run.launch(s)[0]
        run.f = f.float()
        return (run, b * 6 * nq * nk * c, b * (3 * nq + 2 * nk) * c * es,
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

        run.stages = TAIL_STAGES[str(dtype)[6:]]   # timed apart
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
        # K2: the kernel run twice on the same inputs, bit for bit; the
        # tail (K5), which has no atomics either, TAIL_REPEATS times
        same = None
        if kind == "ln_matmul":
            same = all(torch.equal(u, v) for u, v in zip(alone(), alone()))
        elif kind == "tail":
            first = run("kernel")
            same = all(torch.equal(first, run("kernel"))
                       for _ in range(TAIL_REPEATS - 1))
            del first
        stages = getattr(run, "stages", None)
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
        lib_txt += (f", the kernel alone {kernel_ms:.3f} ms "
                    f"({100 * bound_ms / kernel_ms:.1f} % of the bound)")
    if same is not None:
        times = TAIL_REPEATS if kind == "tail" else 2
        rec["twice_bitwise" if times == 2 else "repeats_bitwise"] = same
        good = good and same
        lib_txt += (f", the kernel twice bitwise equal: {same}" if times == 2
                    else f", the kernel {times} times bitwise equal: {same}")
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


# K3 and K4 at bfloat16 split over the keys beyond their gates: every split
# count the chooser can give forced at one shape, B = 1, 8 heads: 512
# queries against 1000 keys (16 tiles, the last of 40 keys); the planted
# control at an SP rank's 1024 queries against 4096 keys.
MHADA_FORCED = (512, 1000)
MHADA_CONTROL = (1024, 4096)


def mhada_split_checks() -> tuple[bool, dict]:
    """K3 and K4 at bfloat16: every split count the chooser can give (1 ..
    MAX_SPLITS) forced at MHADA_FORCED against the plain version and
    repeated bit for bit; the planted control, the kernel's partials at
    MHADA_CONTROL (the chooser's split) combined in plain PyTorch
    (``mhada_combine_partials``) without the last split, must fail the gate
    while the kernel and the whole combine pass it -> (ok, record)."""
    import torch

    from mhada_tpu_torch.ops.key_split import MAX_SPLITS, split_partials
    from mhada_tpu_torch.ops.mhada_kernel import mhada_combine_partials

    dname, dtype, c, heads = "bfloat16", torch.bfloat16, 512, 8
    bound_, ok, rec = REL_BOUND["bfloat16"], True, {}
    with torch.inference_mode():
        for kind, label in (("prologue", "K3"), ("mhada", "K4")):
            g = torch.Generator().manual_seed(SEED)
            run = gate_inputs(kind, MHADA_FORCED, dtype, g)[0]
            ref = run("plain").float()
            rels, good = [], True
            for s in range(1, min(MAX_SPLITS, -(-MHADA_FORCED[1] // 64)) + 1):
                got, again = run.forced(s), run.forced(s)
                rel = ((got.float() - ref).abs().max()
                       / ref.abs().max()).item()
                rels.append(rel)
                good = good and rel <= bound_ and torch.equal(got, again)
            rec[f"{label} forced"] = rels
            ok = phase(f"{label} forced splits {dname}", good,
                       f"{MHADA_FORCED[0]} x {MHADA_FORCED[1]}, splits "
                       f"1..{len(rels)}: rel "
                       + ", ".join(f"{r:.2e}" for r in rels)
                       + f" (bound {bound_:.0e}); each repeated bit for "
                       "bit") and ok

            nq, nk = MHADA_CONTROL
            run = gate_inputs(kind, MHADA_CONTROL, dtype, g)[0]
            out, part = run.launch(run.splits)
            ref = run("plain").float()

            def rel_to(x):
                return ((x.float() - ref).abs().max()
                        / ref.abs().max()).item()

            kernel, whole, dropped = rel_to(out), None, None
            if part is not None:
                views = split_partials(part, run.splits, 1, nq, 2 * c, heads)
                whole = rel_to(mhada_combine_partials(*views, run.f, dtype))
                dropped = rel_to(mhada_combine_partials(
                    *views, run.f, dtype, keep=run.splits - 1))
            good = (part is not None and kernel <= bound_
                    and whole <= bound_ and dropped > bound_)
            rec[f"{label} control"] = dict(splits=run.splits, kernel=kernel,
                                           combined=whole, dropped=dropped)
            ok = phase(f"{label} split control {dname}", good,
                       f"{nq} x {nk}, {run.splits} splits: the kernel rel "
                       f"{kernel:.2e}, its partials combined in PyTorch "
                       f"{whole}, without the last split {dropped} (must "
                       f"exceed {bound_:.0e}: the gate sees a dropped "
                       "split)") and ok
            del run, out, part, ref
    torch.cuda.empty_cache()
    return ok, rec


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


def train_gate_inputs(kind, dtype, g, b, n, tp=1):
    """Seeded inputs of one training kernel at batch ``b`` and ``n`` tokens
    (K7: n or (queries, keys); K8: an n x n or (height, width) input), at
    one rank's share of a ``tp``-way tensor-parallel split (K6, K7: 8 / tp
    heads of 64; K2: the qkv and fc1 output widths over tp) ->
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
    from mhada_tpu_torch.ops.attention_kernel import self_splits
    from mhada_tpu_torch.ops.mhada_kernel import mhada_splits

    dev, c, heads = "cuda", 512, 8
    if kind in ("attention", "mhada"):
        heads //= tp
        c = 64 * heads
    es = torch.tensor([], dtype=dtype).element_size()
    n, m = (n, n) if isinstance(n, int) else n

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dev, dtype)

    if kind == "attention":
        scale = 0.125
        qkv, cot = rnd(b, n, 3 * c), rnd(b, n, c)
        sms = torch.cuda.get_device_properties(0).multi_processor_count
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
            fwd={"kernel": lambda: at.fwd_launch(qkv, heads, scale)[:2],
                 "plain": lambda: at.attention_train_fwd_plain(
                     qkv, heads, scale)},
            bwd={"kernel": lambda: at._bwd_kernel(
                qkv, lse, delta, cot, heads, scale).chunk(3, dim=-1),
                 "plain": lambda: at.attention_train_bwd_plain(
                     qkv, lse, delta, cot, heads, scale).chunk(3, dim=-1)},
            bwd_plain=None,
            names={"fwd": ["out", "lse"], "bwd": ["dq", "dk", "dv"],
                   "grad": ["dq", "dk", "dv"]},
            splits=self_splits(b, heads, n, dtype, sms),
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
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        return dict(
            run=lambda be, *a: mt.mhada_train(*a, heads, be),
            inputs=[q, k, v, f], cot=cot,
            fwd={"kernel": lambda: mt.fwd_launch(q, k, v, f, heads)[:4],
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
            splits=(mhada_splits(b, heads, n, m, sms)
                    if dtype == torch.bfloat16 else 1),
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
        fs = (3 * c // tp, 2048 // tp)
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


def run_train_gate(gate, kind, dname, card, b, n, tp=1):
    """A training kernel against its plain versions on the same seeded
    inputs, each output against its own scale: the forward's outputs and
    residuals, the backward alone, and the input gradients through the
    autograd Function -> (ok, {"fwd": rec, "bwd": rec or None, ...});
    ``tp``: at one rank's share of a tensor-parallel split."""
    import torch

    dtype = getattr(torch, dname)
    g = torch.Generator().manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats()
    d = train_gate_inputs(kind, dtype, g, b, n, tp)
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
        elif kind == "mhada":   # K7's forward: its split, its device time
            parts = SPLIT_KERNELS[kind][dname][:1 if d["splits"] == 1
                                               else 2]
            dev = split_ms(calls["kernel"], parts)
            recs[part]["splits"] = d["splits"]
            dev_txt = "device time not measured (the profiler recorded no " \
                "launch)"
            if all(dev.values()):
                recs[part].update(device_ms=sum(dev.values()),
                                  tile_ms=dev[parts[0]],
                                  combine_ms=dev[parts[1]]
                                  if len(parts) > 1 else 0.0)
                dev_txt = (f"device {dev[parts[0]]:.3f}"
                           + (f" + combine {dev[parts[1]]:.3f}"
                              if len(parts) > 1 else "") + " ms")
            keys = n if isinstance(n, int) else n[1]
            split_txt = (f" ({d['splits']} split(s) of {-(-keys // 64)} key"
                         f" tiles; {dev_txt})")
        elif kind == "attention":   # K6's forward: its split, its lse
            parts = SPLIT_KERNELS[kind][dname][:1 if d["splits"] == 1
                                               else 2]
            dev = split_ms(calls["kernel"], parts)
            lse_rel = errs["lse"][1]
            recs[part].update(splits=d["splits"], lse_rel=lse_rel)
            good = good and lse_rel <= LSE_REL
            dev_txt = "device time not measured (the profiler recorded no " \
                "launch)"
            if all(dev.values()):
                recs[part].update(device_ms=sum(dev.values()),
                                  tile_ms=dev[parts[0]],
                                  combine_ms=dev[parts[1]]
                                  if len(parts) > 1 else 0.0)
                dev_txt = (f"device {dev[parts[0]]:.3f}"
                           + (f" + combine {dev[parts[1]]:.3f}"
                              if len(parts) > 1 else "") + " ms")
            split_txt = (f" ({d['splits']} split(s) of {-(-n // 64)} key "
                         f"tiles; {dev_txt}; lse rel {lse_rel:.2e}, bound "
                         f"{LSE_REL:.0e})")
        elif kind == "tail":   # K8's two stages
            split = split_ms(calls["kernel"], TAIL_STAGES[dname])
            recs[part].update(tail_stage_ms(split))
            good = good and all(t > 0 for t in split.values())
            split_txt = tail_stage_txt(split)
        lib_txt = f"{library_ms:.3f} ms" if lib else "none"
        if part == "fwd" and "wrapper" in d:   # K2: also twice bit for bit
            recs[part]["wrapper_ms"] = cuda_ms(d["wrapper"], 2, 5)
            same = all(torch.equal(u, v) for u, v in zip(calls["kernel"](),
                                                         calls["kernel"]()))
            recs[part]["twice_bitwise"] = same
            good = good and same
            lib_txt += (f", the wrapper {recs[part]['wrapper_ms']:.3f} ms, "
                        f"the kernel twice bitwise equal: {same}")
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


# K6's forward split over the keys: the planted control's shape, the video
# step's frames (B = 2, L = 2048, 8 heads; self_splits gives it 2).
K6_CONTROL = (2, 2048)


def k6_split_control() -> tuple[bool, dict]:
    """K6's forward at bfloat16, split as ``self_splits`` picks at
    K6_CONTROL: its partials combined in plain PyTorch
    (``combine_partials``) without the last split must fail the K6 gate
    (out over TRAIN_REL's forward bound, lse over LSE_REL) while the kernel
    and the whole combine pass it -> (ok, record)."""
    import torch

    from mhada_tpu_torch.ops import attention_kernel as ak
    from mhada_tpu_torch.ops import attention_train as at

    b, n = K6_CONTROL
    c, heads, dtype = 512, 8, torch.bfloat16
    g = torch.Generator().manual_seed(SEED)
    qkv = torch.randn(b, n, 3 * c, generator=g).to("cuda", dtype)
    with torch.inference_mode():
        out, lse, part = at.fwd_launch(qkv, heads, 0.125)
        splits = 1 if part is None else part.numel() // (b * n * (c + 2
                                                                  * heads))
        ref, ref_lse = at.attention_train_fwd_plain(qkv, heads, 0.125)
        ref = ref.float()

        def rels(o, l):
            return (((o.float() - ref).abs().max() / ref.abs().max()).item(),
                    ((l - ref_lse).abs().max() / ref_lse.abs().max()).item())

        kernel = rels(out, lse)
        rec = dict(splits=splits, kernel=kernel)
        if splits > 1:
            views = ak.split_partials(part, splits, b, n, c, heads)
            rec["combined"] = rels(*ak.combine_partials(*views, dtype))
            rec["dropped"] = rels(*ak.combine_partials(*views, dtype,
                                                       keep=splits - 1))
    bound = TRAIN_REL["bfloat16"][0]
    good = (splits > 1 and kernel[0] <= bound and kernel[1] <= LSE_REL
            and rec["combined"][0] <= bound and rec["combined"][1] <= LSE_REL
            and rec["dropped"][0] > bound and rec["dropped"][1] > LSE_REL)
    del qkv, out, lse, part
    torch.cuda.empty_cache()
    txt = ", ".join(f"{k} out rel {v[0]:.2e}, lse rel {v[1]:.2e}"
                    for k, v in rec.items() if k != "splits")
    return phase("train gate K6 split control", good,
                 f"B = {b}, L = {n}, bfloat16, {splits} splits: {txt} (the "
                 f"kernel and the whole combine within {bound:.0e} and "
                 f"{LSE_REL:.0e}; without the last split both must exceed "
                 "them: the gate sees a dropped split)"), rec


# K7's checks at bfloat16: B = 1, 1024 queries against 4096 keys, 8 heads
# (an SP rank's share of the 512^2 frame against the whole style, where
# mhada_splits gives 2); the forced split counts of the bitwise check.
K7_CHECK = (1, 1024, 4096)
K7_FORCED_SPLITS = (1, 2, 3)


def k7_checks() -> tuple[bool, dict]:
    """K7 at bfloat16 on the wgmma tiles (K7_CHECK): its forward's out bit
    for bit K4's at each of K7_FORCED_SPLITS (one tile, K7 also storing M1,
    E2 and the lse); its forward split as ``mhada_splits`` picks, the
    partials combined in plain PyTorch (``mhada_combine_partials``) without
    the last split must fail the K7 gate (out, M1 or E2 over TRAIN_REL's
    forward bound, the lse over LSE_REL) while the kernel and the whole
    combine pass it; two launches of its backward bitwise equal -> (ok,
    record)."""
    import torch

    from mhada_tpu_torch.ops import mhada_kernel as mk
    from mhada_tpu_torch.ops import mhada_train as mt
    from mhada_tpu_torch.ops.key_split import split_partials

    b, n, m = K7_CHECK
    c, heads, dtype = 512, 8, torch.bfloat16
    g = torch.Generator().manual_seed(SEED)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to("cuda", dtype)

    q, k = rnd(b, n, c, scale=0.35), rnd(b, m, c, scale=0.35)
    v, f, cot = rnd(b, m, c), rnd(b, n, c), rnd(b, n, c)
    bound = TRAIN_REL["bfloat16"][0]
    rec = {}
    with torch.inference_mode():
        rec["equal_k4"] = {
            s: torch.equal(mt.fwd_launch(q, k, v, f, heads, splits=s)[0],
                           mk._mhada_launch(q, k, v, f, heads, splits=s)[0])
            for s in K7_FORCED_SPLITS}
        *got, part = mt.fwd_launch(q, k, v, f, heads)
        ref = mt.mhada_train_fwd_plain(q, k, v, f, heads)
        splits = 1 if part is None else part.numel() // (
            b * n * (2 * c + 2 * heads))

        def rels(outs):
            return [((o.float() - r.float()).abs().max()
                     / r.float().abs().max()).item()
                    for o, r in zip(outs, ref)]

        def fails(r):   # the K7 gate's verdict on (out, M1, E2, lse)
            return max(r[:3]) > bound or r[3] > LSE_REL

        rec.update(splits=splits, kernel=rels(got))
        if splits > 1:
            views = split_partials(part, splits, b, n, 2 * c, heads)
            rec["combined"] = rels(mk.mhada_combine_partials(
                *views, f, dtype, residuals=True))
            rec["dropped"] = rels(mk.mhada_combine_partials(
                *views, f, dtype, keep=splits - 1, residuals=True))
        _, m1, e2, lse = ref
        dm1, de2, delta, _ = mt.mhada_train_prologue(cot, f, m1, e2, heads,
                                                     dtype)
        grads = [mt._bwd_kernel(q, k, v, dm1, de2, lse, delta, heads)
                 for _ in range(2)]
        rec["bwd_repeat"] = all(torch.equal(x, y) for x, y in zip(*grads))
    good = (all(rec["equal_k4"].values()) and splits > 1
            and not fails(rec["kernel"]) and not fails(rec["combined"])
            and fails(rec["dropped"]) and rec["bwd_repeat"])
    del q, k, v, f, cot, got, part, ref, grads
    torch.cuda.empty_cache()
    txt = "; ".join(f"{key} out, M1, E2, lse rel "
                    + ", ".join(f"{x:.2e}" for x in rec[key])
                    for key in ("kernel", "combined", "dropped") if key in rec)
    return phase("train gate K7 checks", good,
                 f"B = {b}, N = {n}, M = {m}, bfloat16: out bit for bit K4's"
                 f" at forced splits {rec['equal_k4']}; {splits} splits: "
                 f"{txt} (the kernel and the whole combine within {bound:.0e}"
                 f" and {LSE_REL:.0e}; without the last split the gate must "
                 f"fail); the backward twice, bitwise equal: "
                 f"{rec['bwd_repeat']}"), rec


# K6's checks at bfloat16: the 512^2 step's shape (B, tokens; 8 heads) and
# the planted fault's factor on the kernel's dQ.
K6_CHECK = (4, 4096)
K6_DQ_FAULT = 1.25


def k6_checks() -> tuple[bool, dict]:
    """K6's backward at bfloat16 on the wgmma pair (K6_CHECK): two launches
    bitwise equal; its dq, dk and dv against the plain backward within the
    gate's bound (TRAIN_REL), and a planted fault, the kernel's dq times
    K6_DQ_FAULT, that must exceed it -> (ok, record)."""
    import torch

    from mhada_tpu_torch.ops import attention_train as at

    b, n = K6_CHECK
    c, heads, dtype, scale = 512, 8, torch.bfloat16, 0.125
    g = torch.Generator().manual_seed(SEED)
    qkv = torch.randn(b, n, 3 * c, generator=g).to("cuda", dtype)
    cot = torch.randn(b, n, c, generator=g).to("cuda", dtype)
    names = ["dq", "dk", "dv"]
    with torch.inference_mode():
        out, lse = at.attention_train_fwd_plain(qkv, heads, scale)
        delta = at.row_delta(cot, out, heads)
        grads = [at._bwd_kernel(qkv, lse, delta, cot, heads, scale)
                 for _ in range(2)]
        ref = at.attention_train_bwd_plain(qkv, lse, delta, cot, heads,
                                           scale).chunk(3, dim=-1)
        got = grads[0].chunk(3, dim=-1)
        kernel = _errs(names, got, ref)
        planted = _errs(names, (got[0] * K6_DQ_FAULT, *got[1:]), ref)
        rec = dict(bwd_repeat=torch.equal(*grads),
                   kernel={k: e[1] for k, e in kernel.items()},
                   planted={k: e[1] for k, e in planted.items()})
    bound = TRAIN_REL["bfloat16"][1]
    good = (rec["bwd_repeat"] and _worst(kernel)[1] <= bound
            and _worst(planted)[1] > bound)
    del qkv, cot, out, lse, delta, grads, ref, got
    torch.cuda.empty_cache()
    return phase("train gate K6 checks", good,
                 f"B = {b}, L = {n}, bfloat16: the backward twice, bitwise "
                 f"equal: {rec['bwd_repeat']}; against the plain backward "
                 f"rel {_errs_txt(kernel)}, with its dq x {K6_DQ_FAULT} "
                 f"(planted) {_errs_txt(planted)} (the kernel within "
                 f"{bound:.0e} each, the planted fault must exceed it)"), rec


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
        faults_d = faults + ([("dq", MID_DQ)] if dname in MID_DQ else [])
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
            for kind, size in faults_d:
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
        if dname in MID_DQ:   # x 1.25, counted, not gated
            mid, mid_over = planted.pop()
            records_mid = dict(mid_fault_tensors_over=len(mid_over))
            control_txt += (f"; K7's dq x (1 + {MID_DQ[dname]:g}), counted,"
                            f" not gated: {len(mid_over)} tensors over "
                            f"(nearest: {worst_txt(mid, every_bound)})")
        else:
            records_mid = {}
        if key_bias:
            (dk, dk_caught), (dk_below, dk_below_over) = planted[2:]
            controls_ok = controls_ok and bool(dk_caught)
            control_txt += (
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
            launches=counts, peak_gb=peaks, **records_mid)
        if key_bias:
            # each key bias's reading beside its two rounding controls
            biases = {f"{net}.{key}": (noise[net, key],
                                       [c[1][net, key] for c in controls])
                      for net, key in sorted(noise) if key.endswith("g_bias")}
            records[dname].update(
                key_bias_worst=max(v for v, _ in biases.values()),
                key_bias_each=biases,
                dk_fault_tensors_over=len(dk_caught),
                below_dk_fault_tensors_over=len(dk_below_over))
            phase(f"train step key biases {label} {dname}", True,
                  "each against its network's largest gradient, kernel "
                  "build (the plain build's two rounding controls): "
                  + "; ".join(f"{t} {v:.3e} ({c[0]:.3e}, {c[1]:.3e})"
                              for t, (v, c) in biases.items())
                  + f" (bound {KEY_BIAS_BOUND[dname]:.0e}, not raised)")
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
                good, r = (run_split_gate if kind in SPLIT_KERNELS
                           else run_gate)(gate, kind, n, 1, dname, card)
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


def inversion_want(mode, iters):
    """The launches of ``analysis.visualize.main`` in ``mode``: the target
    (and in mhada mode the style) encoded once, then per Adam step vit_c
    (and the six MHAda blocks) forward and backward; the decoder (K8)
    never runs."""
    want = dict.fromkeys(FULL, 0)
    if mode == "vit":
        want.update({K6F: 3 * (iters + 1), K6B: 3 * iters})
    elif mode == "mhada":
        want.update({K6F: 3 * (iters + 2), K6B: 3 * iters,
                     K7F: 6 * (iters + 1), K7B: 6 * iters})
    return want


def log_losses(log):
    """The losses that ``visualize.main --log-every 1`` prints."""
    return [float(ln.split("loss")[1]) for ln in log.splitlines()
            if ln.strip().startswith("iter ")]


def analysis_phase(card, train_extra) -> tuple[bool, dict]:
    """Phase 9 -> (ok, record): (a) K6 at B = 1, L = 1024 and K7 at B = 1,
    N = M = 1024 against their plain versions, forward, backward and input
    gradients, both dtypes (recorded in ``train_extra``); (b, c)
    ``analysis.visualize.main`` in vit and mhada modes at 256^2 on random
    full-width weights written as the .pth triple, 20 Adam steps: the PNG,
    finite falling losses, exact launches; (d) the same 20-step inversions
    on the kernel and the plain training builds from one image, each
    step's loss and the images held together, and device ms per Adam step
    of both builds in turns; (e) the vgg and vgg_progressive modes at
    224^2 with random VGG weights (no launches); (f) ``counts.report`` on
    the card against the CPU's, and ``count_flops`` refusing a
    kernel-build forward; (g) whether matplotlib imports, and the
    histogram plot if it does; (h) VisionTransformerMultiScale,
    AdaAttnTransformer and VGG19Classifier at full width on the card
    against the CPU."""
    import torch
    from PIL import Image

    from mhada_tpu_torch import _build
    from mhada_tpu_torch.analysis import counts, hist, visualize
    from mhada_tpu_torch.config import ModelConfig
    from mhada_tpu_torch.models import build_models
    from mhada_tpu_torch.models.adaformer import AdaAttnTransformer
    from mhada_tpu_torch.models.layers import init_parameters
    from mhada_tpu_torch.models.vgg19 import VGG19Classifier
    from mhada_tpu_torch.models.vit import VisionTransformerMultiScale
    from mhada_tpu_torch.ops.pad_conv import no_tf32
    from mhada_tpu_torch.train.checkpoint import FILE_NAMES, save_weights
    from mhada_tpu_torch.utils.image_io import load_image

    ok, rec, secs = True, {}, {}
    t0 = time.perf_counter()
    for gate, _, _, kind, b, n in INVERSION_GATES:
        for dname in DTYPE_NAMES:
            try:
                good, recs = run_train_gate(gate, kind, dname, card, b, n)
            except Exception as e:  # report every kernel, then fail
                ok = phase(f"train gate {gate} {dname}", False,
                           f"{type(e).__name__}: {e}")
                continue
            train_extra.setdefault(gate, {})[dname] = recs
            ok = good and ok
    secs["a_gates"] = time.perf_counter() - t0
    tmp = tempfile.mkdtemp(prefix="chip_smoke_analysis_")
    hw = (INVERT_SIZE, INVERT_SIZE)
    try:
        rng = np.random.default_rng(SEED + 9)

        def training_build(backend):
            m = build_models(ModelConfig(mhada_backend=backend), "cuda",
                             torch.Generator().manual_seed(SEED),
                             for_training=True)
            for net in m.values():
                net.requires_grad_(False)
            return m

        kmodels, pmodels = training_build("auto"), training_build("plain")
        wdir = os.path.join(tmp, "weights")
        save_weights(wdir, kmodels)
        model_args = [a for n, key in (("ada", "adaFormer"), ("vitc", "vit_c"),
                                       ("vits", "vit_s"))
                      for a in (f"--{n}", os.path.join(
                          wdir, f"{FILE_NAMES[key]}.pth"))]
        paths = {name: os.path.join(tmp, f"{name}.png")
                 for name in ("target", "style", "vgg_target")}
        Image.fromarray(eval_picture(hw, rng)).save(paths["target"])
        Image.fromarray(rng.integers(0, 256, (*hw, 3), np.uint8)).save(
            paths["style"])
        Image.fromarray(eval_picture((VGG_SIZE, VGG_SIZE), rng, 0.3)).save(
            paths["vgg_target"])

        # b, c. the CLI in vit and mhada modes, exact launches
        t0 = time.perf_counter()
        for mode in ("vit", "mhada"):
            label = f"analysis visualize.main --mode {mode} {INVERT_SIZE}^2"
            out = os.path.join(tmp, f"{mode}.png")
            argv = ["--mode", mode, "--target", paths["target"], "--out", out,
                    "--size", *map(str, hw), "--iters", str(INVERT_ITERS),
                    "--log-every", "1", *model_args]
            if mode == "mhada":
                argv += ["--style", paths["style"]]
            try:
                got, wall, log = run_cli(visualize.main, argv)
                losses = log_losses(log)
                want = inversion_want(mode, INVERT_ITERS)
                shape = (np.asarray(Image.open(out)).shape
                         if os.path.exists(out) else None)
                good = (shape == (*hw, 3) and len(losses) == INVERT_ITERS
                        and np.isfinite(losses).all()
                        and losses[-1] < losses[0] and got == want)
                rec[f"cli_{mode}"] = dict(losses=losses, launches=got,
                                          wall_s=wall)
                ok = phase(label, good,
                           f"{out.split('/')[-1]} {shape}; losses "
                           f"{losses[0]:.6g} -> {losses[-1]:.6g} over "
                           f"{len(losses)} steps; launches {got} (want "
                           f"{want}); {wall:.1f} s wall with set-up") and ok
            except Exception as e:
                ok = phase(label, False, f"{type(e).__name__}: {e}")
        secs["bc_cli"] = time.perf_counter() - t0

        # d. kernel build against plain build, then ms per Adam step
        t0 = time.perf_counter()
        target, style = (torch.from_numpy(load_image(paths[k], hw))[None]
                         .cuda() for k in ("target", "style"))
        img0 = torch.rand((1, *hw, 3),
                          generator=torch.Generator().manual_seed(SEED)) * 255

        def features(models):
            """mode -> (feature function of the image, its targets)."""
            with torch.no_grad(), no_tf32():
                fs = models["vit_s"](style)

            def fcs(x):
                return [models["adaFormer"].transform(models["vit_c"](x), fs)]

            return {mode: (fn, visualize._targets(fn, target))
                    for mode, fn in (("vit", models["vit_c"]),
                                     ("mhada", fcs))}

        builds = {"plain": features(pmodels), "kernel": features(kmodels)}
        rec["ms_per_step"] = {}
        for mode in ("vit", "mhada"):
            label = (f"analysis inversion {mode} kernel vs plain build "
                     f"{INVERT_ITERS} steps")
            try:
                runs = {b: visualize._invert(
                    *builds[b][mode], (1, *hw, 3), 0.5, INVERT_ITERS,
                    log_every=0, img0=img0, return_losses=True)
                    for b in builds}
                (ip, lp), (ik, lk) = runs["plain"], runs["kernel"]
                rel = float(np.max(np.abs(lk - lp) / np.abs(lp)))
                dpix = float(np.abs(ik - ip).max())
                good = (np.isfinite(lk).all() and rel <= INVERT_LOSS_REL
                        and dpix <= INVERT_PIXEL)

                def adam_step(b):
                    fn, tg = builds[b][mode]
                    img = img0.to("cuda", copy=True).requires_grad_()
                    loss_fn = visualize.feature_loss(fn, tg)
                    opt = torch.optim.Adam([img], lr=0.5)

                    def step():
                        opt.zero_grad(set_to_none=True)
                        loss_fn(img).backward()
                        opt.step()
                    return step

                steps = {b: adam_step(b) for b in builds}
                t = {b: [] for b in builds}
                with no_tf32():
                    for b in ("plain", "kernel", "kernel", "plain"):
                        t[b].append(cuda_ms(steps[b], 2, 10))
                    # the device's busy ms a step, and K6's and K7's
                    busy = {b: busy_ms(steps[b], INVERSION_KERNELS)
                            for b in builds}
                ms = {b: sum(v) / len(v) for b, v in t.items()}
                kern = sum(busy["kernel"][1].values())
                rec["ms_per_step"][mode] = dict(
                    ms, loss_rel=rel, dpix=dpix,
                    busy_ms={b: v[0] for b, v in busy.items()},
                    k6_k7_ms=kern,
                    recipe_s={b: v * RECIPE_ITERS / 1e3
                              for b, v in ms.items()})
                ok = phase(label, good,
                           f"losses {lk[0]:.6g} -> {lk[-1]:.6g}, max rel "
                           f"{rel:.2e} (bound {INVERT_LOSS_REL:.0e}); image "
                           f"max|d| {dpix:.4f} (bound {INVERT_PIXEL}); ms "
                           f"per Adam step plain {t['plain']} kernel "
                           f"{t['kernel']}, so {RECIPE_ITERS} steps "
                           f"{ms['kernel'] * RECIPE_ITERS / 1e3:.1f} s on "
                           f"the kernel build, "
                           f"{ms['plain'] * RECIPE_ITERS / 1e3:.1f} s on "
                           f"the plain; device busy ms a step (profiler) "
                           f"plain {busy['plain'][0]:.3f} kernel "
                           f"{busy['kernel'][0]:.3f}, K6 and K7 "
                           f"{kern:.3f} of it ({card})") and ok
            except Exception as e:
                ok = phase(label, False, f"{type(e).__name__}: {e}")
        del builds, kmodels, pmodels
        torch.cuda.empty_cache()
        secs["d_builds"] = time.perf_counter() - t0

        # e. the VGG modes at 224^2 on random VGG weights
        t0 = time.perf_counter()
        none = dict.fromkeys(FULL, 0)
        for mode, extra in (("vgg", ["--last-layer", "3", "--iters", "5",
                                     "--log-every", "1"]),
                            ("vgg_progressive", ["--iters", "4"])):
            label = f"analysis visualize.main --mode {mode} {VGG_SIZE}^2"
            out = os.path.join(tmp, mode, "inversion.png")
            try:
                got, wall, log = run_cli(visualize.main, [
                    "--mode", mode, "--target", paths["vgg_target"], "--out",
                    out, "--size", str(VGG_SIZE), str(VGG_SIZE), *extra])
                if mode == "vgg":
                    traces = [log_losses(log)]
                    files = [os.path.basename(out)] * os.path.exists(out)
                else:   # "saved <file> (loss a -> b)" per prefix
                    traces = [[float(v) for v in ln.split("(loss ")[1]
                               .rstrip(")").split(" -> ")]
                              for ln in log.splitlines() if "(loss " in ln]
                    files = sorted(os.listdir(os.path.dirname(out)))
                good = (len(traces) == (1 if mode == "vgg" else 5)
                        and len(files) == len(traces)
                        and all(np.isfinite(tr).all() and tr[-1] < tr[0]
                                for tr in traces)
                        and got == none and "WARNING: random VGG" in log)
                rec[f"cli_{mode}"] = dict(losses=traces, files=files,
                                          wall_s=wall)
                ok = phase(label, good,
                           f"{len(files)} images; losses (first -> last) "
                           + ", ".join(f"{tr[0]:.4g} -> {tr[-1]:.4g}"
                                       for tr in traces)
                           + f"; launches {'none' if got == none else got};"
                           f" {wall:.1f} s wall") and ok
            except Exception as e:
                ok = phase(label, False, f"{type(e).__name__}: {e}")
        secs["e_vgg"] = time.perf_counter() - t0

        # f. the counts on the card against the CPU; a kernel build refused
        t0 = time.perf_counter()
        try:
            reports = {d: counts.report(device=d) for d in ("cuda", "cpu")}
            inference = build_models(ModelConfig(), "cuda")["vit_c"]
            x = torch.zeros(1, *hw, 3, device="cuda")
            try:
                counts.count_flops(inference.requires_grad_(False), x)
                refused = "no"
            except RuntimeError as e:
                refused = str(e)
            good = (reports["cuda"] == reports["cpu"]
                    and "launched during the count" in refused)
            rec["counts"] = reports["cuda"]
            ok = phase("analysis counts.report card vs CPU", good,
                       f"card {reports['cuda']}; the CPU's equal: "
                       f"{reports['cuda'] == reports['cpu']}; count_flops "
                       f"over the kernel build's vit_c raised: "
                       f"{refused[:160]}") and ok
        except Exception as e:
            ok = phase("analysis counts.report card vs CPU", False,
                       f"{type(e).__name__}: {e}")
        secs["f_counts"] = time.perf_counter() - t0

        # g. the histograms, where matplotlib imports
        try:
            import matplotlib
            out = hist.plot_bgr_histograms(
                [paths["target"], paths["style"]],
                os.path.join(tmp, "hist.png"))
            good = os.path.getsize(out) > 0
            txt = f"matplotlib {matplotlib.__version__} imports; plot drawn"
        except ImportError as e:   # reported, never failed
            good, txt = True, f"matplotlib does not import ({e}); no plot"
        except Exception as e:
            good, txt = False, f"{type(e).__name__}: {e}"
        rec["histograms"] = txt
        ok = phase("analysis histograms", good, txt) and ok

        # h. the variants at full width, card against CPU, float32
        t0 = time.perf_counter()

        def randn(*shape, scale=1.0):
            return torch.from_numpy((rng.standard_normal(shape) * scale)
                                    .astype(np.float32))

        variants = [
            ("VisionTransformerMultiScale 256^2", VisionTransformerMultiScale,
             [torch.from_numpy(rng.uniform(0, 255, (1, *hw, 3))
                               .astype(np.float32))]),
            ("AdaAttnTransformer 3 x (1, 32, 32, 512)", AdaAttnTransformer,
             [[randn(1, 32, 32, 512) for _ in range(3)] for _ in range(2)]),
            ("VGG19Classifier (1, 14, 14, 512)", VGG19Classifier,
             [randn(1, 14, 14, 512).abs()]),
        ]
        for name, make, inputs in variants:
            label = f"analysis variant {name} card vs CPU"
            try:
                mod = make()
                init_parameters(mod, torch.Generator().manual_seed(SEED))
                mod.requires_grad_(False).eval()

                def run(dev):
                    args = [[t.to(dev) for t in a] if isinstance(a, list)
                            else a.to(dev) for a in inputs]
                    with torch.no_grad(), no_tf32():
                        out = mod.to(dev)(*args)
                    return [o.cpu() for o in (out if isinstance(out, list)
                                              else [out])]

                ref = run("cpu")
                _build.reset_launches()
                got = run("cuda")
                launched = sum(_build.LAUNCHES.values())
                rels = [float((g - r).abs().max() / r.abs().max())
                        for g, r in zip(got, ref)]
                good = (launched == 0 and max(rels) <= METRIC_REL
                        and all(torch.isfinite(g).all() for g in got))
                rec.setdefault("variants", {})[name] = rels
                ok = phase(label, good,
                           f"outputs {[tuple(g.shape) for g in got]}, max|d|"
                           f" / max|CPU| {[f'{r:.2e}' for r in rels]} (bound "
                           f"{METRIC_REL:.0e}); kernel launches {launched}"
                           ) and ok
                del mod
            except Exception as e:
                ok = phase(label, False, f"{type(e).__name__}: {e}")
        torch.cuda.empty_cache()
        secs["h_variants"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec["seconds"] = secs
    phase("analysis seconds", True, ", ".join(f"{k} {v:.1f}"
                                              for k, v in secs.items()))
    return ok, rec


# Phase 10, the parallel serving paths (mhada_tpu_torch.parallel).  K1's
# cross form at the sequence-parallel shapes, B = 1, 8 heads of 64: 512^2
# over 4 and over 2 ranks, 1024^2 over 4; and at a ragged shape, B = 2
# (no query block, no 64-key tile divides it) (gate, its row, (queries,
# keys), batch).
CROSS_GATES = [
    ("K1x Nq=1024 M=4096", K12_CROSS, (1024, 4096), 1),
    ("K1x Nq=2048 M=4096", K12_CROSS, (2048, 4096), 1),
    ("K1x Nq=4096 M=16384", K12_CROSS_STREAM, (4096, 16384), 1),
    ("K1x B=2 Nq=1000 M=3000", K12_CROSS, (1000, 3000), 2),
]
# The kernels of K1 (and K6's forward), K1's cross form, K3 and K4 by name,
# each dtype's unsplit or split tile and the split's combine, timed apart on
# the device (torch.profiler).  K1's, K6's, K3's and K4's float32 tiles take
# no split.
SPLIT_KERNELS = {
    **dict.fromkeys(("cross", "attention"), {
        "float32": ("attention_f32_kernel", "attention_combine_kernel"),
        "bfloat16": ("attention_wgmma_kernel", "attention_combine_kernel")}),
    **dict.fromkeys(("prologue", "mhada"), {
        "float32": ("mhada_f32_kernel",),
        "bfloat16": ("mhada_wgmma_kernel", "mhada_combine_kernel")})}
# Every split count the chooser can give (1 .. MAX_SPLITS), forced at one
# shape: B = 1, 8 heads, 512 queries against 1000 keys (16 tiles, the last
# of 40 keys).
CROSS_FORCED = (512, 1000)
# Ungated readings through the cross entry, B = 1: the self shape at bf16
# (q = qkv[..., :C], kv = qkv[..., C:]; K1's own tile, read against SDPA
# alone), and 1024 queries against 1024 keys at f32, split, beside K6's
# forward.
CROSS_READINGS = [("self 4096^2", 4096, 4096, "bfloat16"),
                  ("1024^2", 1024, 1024, "float32")]
# Ranks sharing the one card over gloo; SP over all of them and over 2; PP
# over 3 stages (the model's 2 x 3 MHAda blocks divide over 1, 2, 3 or 6);
# DP at B = 2 a rank against one rank at B = 2 x ranks.
PAR_RANKS, PP_STAGES, PP_FRAMES, DP_B = 4, 3, 6, 2
# c6's weights: phase 4's gain, and its bias raised by this much (0-255):
# with the gain alone one of seed 0's three channels sits at the ReLU's 0
# and another half of it (48 % of pixels mid-range at 128^2, CPU), where a
# slab fault would hide; raised, every channel is mid-range.
PAR_C6_OFFSET = 50.0
# The share of a reference frame's pixels that must lie in (0, 255)
# (tests/test_sp.py:100).
PAR_MID_SHARE = 0.6
# The planted control: SP with no decoder halo (decode_margin = 0) must
# leave the single-rank frame by more than the f32 pixel bound.
SP_MARGINS = (0, 4)
SHORT = {"float32": "f32", "bfloat16": "bf16"}
PAR_TIMEOUT_S = 450


def sp_want():
    """One SP rank's launches for a frame at B = 1: its queries against the
    gathered keys (K1's cross form) in 3 ViT blocks, K2 at their 6 pre-LN
    sites, K3 in the 6 MHAda blocks, K5 on its slab."""
    return {**dict.fromkeys(FULL, 0), XATTN: 3, LN: 6, K3: 6, TAIL: 1}


def pp_want(rank, stages, frames):
    """A PP rank's launches over ``frames`` frames: rank 0 encodes (K1 3, K2
    6 a frame), every stage runs its 6 / stages MHAda blocks on K3, the
    last decodes (K5 1 a frame)."""
    want = dict.fromkeys(FULL, 0)
    want[K3] = 6 // stages * frames
    if rank == 0:
        want.update({ATTN: 3 * frames, LN: 6 * frames})
    if rank == stages - 1:
        want[TAIL] = frames
    return want


def parallel_rank(group, nccl_one: bool) -> dict:
    """One rank of phase 10: every check of the multi-rank paths on this
    rank -> {check: {err, mid, launches, want, ms, ...}}.

    Each rank builds the full-width model from its own seed and takes rank
    0's weights by ``replicate``.  SP at 512^2 (f32 and bf16) over every
    rank and over 2, with the margin controls; SP at 1024^2 against a
    1024^2 style (bf16); PP over 3 stages, PP_FRAMES frames at 512^2 (f32);
    DP at 512^2 (f32), DP_B a rank; with ``nccl_one``, rank 0 also runs SP
    and DP over a group of its own on NCCL.  Each frame is held against
    this rank's single-rank frame (``make_stylize_with_kv_fn``, the
    streaming path; DP: ``make_stylize_fn``); ms are wall ms a frame of
    this rank, the ranks sharing the card."""
    import torch
    import torch.distributed as dist

    from mhada_tpu_torch import _build
    from mhada_tpu_torch.config import ModelConfig
    from mhada_tpu_torch.infer.image import (make_encode_style_fn,
                                             make_stylize_fn,
                                             make_stylize_with_kv_fn,
                                             precompute_style_kv)
    from mhada_tpu_torch.models import build_models
    from mhada_tpu_torch.parallel import (Group, gather_batch,
                                          make_pp_stylize_fn,
                                          make_sp_stylize_fn, replicate,
                                          shard_batch)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev, rank, size = group.device, group.rank, group.size
    models = build_models(ModelConfig(), dev,
                          torch.Generator().manual_seed(SEED + rank))
    c6 = models["adaFormer"].decoder.c6.conv
    with torch.no_grad():
        c6.weight.mul_(C6_GAIN)
        c6.bias.mul_(C6_GAIN).add_(PAR_C6_OFFSET)
    replicate(group, models)   # rank 0's (seed 0) weights on every rank

    def sub(n, backend=None):   # every rank takes part in making it
        if n == size and backend is None:
            return group
        pg = dist.new_group(list(range(n)), backend=backend)
        return Group(pg, dev) if rank < n else None

    g2 = sub(2) if size > 2 else None
    stages = PP_STAGES if size >= PP_STAGES else 2
    g_pp = sub(stages)
    g_nccl = sub(1, "nccl") if nccl_one else None

    rng = np.random.default_rng(SEED)
    c512, s512 = (torch.from_numpy(a)[None].to(dev)
                  for a in test_images(512, rng))
    c1k, s1k = (torch.from_numpy(a)[None].to(dev)
                for a in test_images(1024, rng))
    kvs, refs, res = {}, {}, {}

    def kv_of(style, dname):
        key = (style.shape[1], dname)
        if key not in kvs:
            dtype = getattr(torch, dname)
            kvs[key] = precompute_style_kv(
                models, make_encode_style_fn(models, dtype)(style))
        return kvs[key]

    def ref_of(content, style, dname):
        key = (content.shape[1], style.shape[1], dname)
        if key not in refs:
            refs[key] = make_stylize_with_kv_fn(
                models, getattr(torch, dname))(content, kv_of(style, dname))
        return refs[key]

    def sync():   # the ranks also run on the CPU (a rehearsal)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def run(fn):
        """(fn(), its launches, wall ms), counts set to 0 just before."""
        sync()
        _build.reset_launches()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, dict(_build.LAUNCHES), (time.perf_counter() - t0) * 1e3

    def record(label, out, ref, counts, want, ms=None, **extra):
        """ref None: this rank holds no reference (DP off rank 0)."""
        res[label] = dict(
            err=None if ref is None else float((out - ref).abs().max()),
            mid=None if ref is None
            else float(((ref > 0) & (ref < 255)).float().mean()),
            shape=list(out.shape), finite=bool(torch.isfinite(out).all()),
            launches=counts, want=want, ms=ms, **extra)

    def sp(label, grp, content, style, dname, margin=None, timed=False):
        if grp is None:
            return
        ref = ref_of(content, style, dname)
        kv = kv_of(style, dname)
        fn = make_sp_stylize_fn(models, grp, getattr(torch, dname),
                                decode_margin=margin)
        out, counts, _ = run(lambda: fn(content, kv))
        ms = (float(np.median([run(lambda: fn(content, kv))[2]
                               for _ in range(3)])) if timed else None)
        record(label, out, ref, counts, sp_want(), ms, ranks=grp.size,
               backend=grp.backend, margin=margin)

    sp(f"sp512 f32 x{size}", group, c512, s512, "float32", timed=True)
    for m in SP_MARGINS:
        sp(f"sp512 f32 x{size} margin {m}", group, c512, s512, "float32",
           margin=m)
    sp(f"sp512 bf16 x{size}", group, c512, s512, "bfloat16", timed=True)
    for dname in DTYPE_NAMES:
        sp(f"sp512 {SHORT[dname]} x2", g2, c512, s512, dname, timed=True)
    sp(f"sp1024 bf16 x{size}", group, c1k, s1k, "bfloat16", timed=True)

    # PP: PP_FRAMES frames (the content rolled by 8 pixels a frame)
    frames = torch.stack([torch.roll(c512, 8 * i, dims=1)
                          for i in range(PP_FRAMES)])
    if g_pp is not None:
        kv = kv_of(s512, "float32")
        fn = make_pp_stylize_fn(models, g_pp, torch.float32)
        out, counts, ms = run(lambda: fn(frames, kv))
        want = pp_want(rank, stages, PP_FRAMES)
        if out is None:
            res[f"pp512 f32 x{stages}"] = dict(launches=counts, want=want,
                                                 ms=ms / PP_FRAMES)
        else:
            single = make_stylize_with_kv_fn(models, torch.float32)
            ref = torch.stack([single(f, kv) for f in frames])
            record(f"pp512 f32 x{stages}", out, ref, counts, want,
                   ms / PP_FRAMES, stages=stages)

    # DP: B = DP_B a rank, the full path (style re-encoded per pair)
    dp_b = DP_B * size
    contents = torch.stack([torch.roll(c512[0], 16 * i, dims=0)
                            for i in range(dp_b)])
    styles = torch.stack([torch.roll(s512[0], 16 * i, dims=1)
                          for i in range(dp_b)])
    full = make_stylize_fn(models, torch.float32)
    local = shard_batch(group, contents, styles)
    out, counts, ms = run(lambda: full(*local))
    out = gather_batch(group, out)
    record(f"dp512 f32 x{size}", out,
           full(contents, styles) if rank == 0 else None, counts,
           dict(FULL), ms / DP_B, batch=dp_b)

    if g_nccl is not None:   # NCCL at world size 1: its collectives run
        sp("nccl1 sp512 f32", g_nccl, c512, s512, "float32")
        fn = make_stylize_fn(models, torch.float32)
        replicate(g_nccl, models)
        out, counts, ms = run(lambda: gather_batch(g_nccl, fn(
            *shard_batch(g_nccl, contents[:DP_B], styles[:DP_B]))))
        record("nccl1 dp512 f32", out, fn(contents[:DP_B], styles[:DP_B]),
               counts, dict(FULL), ms / DP_B, backend=g_nccl.backend)
    return res


def parallel_checks(results, tag) -> bool:
    """Print one phase line per check of ``parallel_rank``'s results (all
    ranks): launches exact on every rank that ran it; every error that a
    rank holds within PIXEL_BOUND (the margin-0 control: above the f32
    bound; margin 4: printed, not gated), frames finite and their
    references more than PAR_MID_SHARE mid-range."""
    ok = True
    for label in dict.fromkeys(k for r in results for k in r):
        recs = [(i, r[label]) for i, r in enumerate(results) if label in r]
        dname = "bfloat16" if "bf16" in label else "float32"
        bound = PIXEL_BOUND[dname]
        margin = next((e.get("margin") for _, e in recs), None)
        launches_ok = all(e.get("launches") == e.get("want")
                          for _, e in recs if "want" in e)
        errs = [e["err"] for _, e in recs if e.get("err") is not None]
        mids = [e["mid"] for _, e in recs if e.get("mid") is not None]
        finite = all(e.get("finite", True) for _, e in recs)
        if margin == 0:   # the planted control must be seen
            good = bool(errs) and max(errs) > PIXEL_BOUND["float32"]
            what = (f"control: no decoder halo, max|dpixel| per rank "
                    f"{[round(x, 4) for x in errs]} (must exceed "
                    f"{PIXEL_BOUND['float32']})")
        elif margin is not None:
            good = True
            what = (f"margin {margin} (printed, not gated): max|dpixel| per "
                    f"rank {[f'{x:.4g}' for x in errs]}")
        else:
            good = (bool(errs) and max(errs) <= bound and launches_ok
                    and finite and all(m > PAR_MID_SHARE for m in mids))
            what = (f"max|dpixel| against the single-rank frame "
                    f"{max(errs) if errs else None} (bound {bound}), per rank "
                    f"{[f'{x:.4g}' for x in errs]}; mid-range share of the "
                    f"reference {[round(m, 3) for m in mids]} (> "
                    f"{PAR_MID_SHARE})")
        ms = [e.get("ms") for _, e in recs]
        first = recs[0][1]
        shape = next((e["shape"] for _, e in recs if e.get("shape")), None)
        ok = phase(f"parallel {label} ({tag})", good and finite,
                   f"{what}; output {shape}, finite {finite}; "
                   f"launches exact on every rank {launches_ok} (rank 0: "
                   f"{ {k: v for k, v in first.get('launches', {}).items() if v} }"
                   f"); wall ms a frame per rank (ranks share the card; "
                   f"not gated) {[None if m is None else round(m, 2) for m in ms]}"
                   ) and ok
    return ok


# Phase 10d: data-parallel and DP x TP training.  TP_GATES: the training
# kernels at one rank's share of the (2 x 2) mesh's split (heads of the
# ViT attention and the MHAda blocks over 2 ranks: 4 heads, K6's packed
# qkv 768 wide, K7 on 256 channels; K2's qkv and fc1 outputs 768 and
# 1024 wide) at the per-rank batch: the image step's global B = 8 over 2
# data ranks, 4 a rank, at 1024 tokens; the video step's B = 2, 1 a rank,
# at 2048 content against 1024 style tokens.  (gate, kind, batch, tokens.)
TP_GATES = [
    ("K6 TP/2 B=4 L=1024", "attention", 4, 1024),
    ("K7 TP/2 B=4 N=M=1024", "mhada", 4, 1024),
    ("K2 TP/2 B=4 L=1024", "ln_matmul", 4, 1024),
    ("K6 TP/2 B=1 L=2048", "attention", 1, 2048),
    ("K7 TP/2 B=1 N=2048 M=1024", "mhada", 1, (2048, 1024)),
]
TP = 2
# The steps on the mesh, at the recipes' shapes (the image step 256^2 at a
# global B = 8, the video step at a global B = 2 with the second sample
# fully occluded): (label, recipe, (n_data, n_model), fuse_ln, launches
# each rank must make).  Each is held on rank 0 against the single-rank
# kernel build's step from the same weights on the global batch, with
# phase 7's bounds and rounding controls.
MESH_RUNS = [
    ("image 4x1", "image", (4, 1), False, TRAIN),
    ("image 2x2", "image", (2, 2), False, TRAIN),
    ("fused 2x2", "image", (2, 2), True, TRAIN_FUSED),
    ("video 2x2", "video", (2, 2), False, TRAIN_VIDEO),
]
# Planted faults the gate must report (float32): copy_to_model's backward
# without its sum over the model group, and each rank's temporal losses
# normalised by its own mask (the single-rank masked mean on its shard).
MESH_CONTROLS = [
    ("control: no sum in copy_to_model's backward, image 2x2", "image",
     (2, 2), False, "copy"),
    ("control: each rank's own nnz, video 2x2", "video", (2, 2), False,
     "nnz"),
]
VIDEO_B = 2


@contextlib.contextmanager
def mesh_fault(kind):
    """Plant one of MESH_CONTROLS' faults in this process (None: none)."""
    from mhada_tpu_torch.parallel import tp
    from mhada_tpu_torch.train import losses

    if kind is None:
        yield
        return
    real_copy, real_mean = tp._copy_grad, losses._masked_mean
    if kind == "copy":
        tp._copy_grad = lambda group, g: g
    else:
        losses._masked_mean = (lambda per_elem, nnz, group=None:
                               real_mean(per_elem, nnz))
    try:
        yield
    finally:
        tp._copy_grad, losses._masked_mean = real_copy, real_mean


def mesh_config(kind, fuse_ln, dname):
    from mhada_tpu_torch.config import (ImageTrainConfig, ModelConfig,
                                        VideoTrainConfig)

    model = ModelConfig(fuse_ln=fuse_ln)
    if kind == "image":
        return ImageTrainConfig(model=model, batch_size=TRAIN_B,
                                image_size=(TRAIN_SIZE, TRAIN_SIZE),
                                compute_dtype=dname)
    return VideoTrainConfig(model=model, batch_size=VIDEO_B,
                            compute_dtype=dname)


def mesh_batch(cfg, dev):
    """The global batch from the seed (the recipe's random batch; the video
    recipe's second sample fully occluded)."""
    from mhada_tpu_torch.train.recipes import recipe

    batch = recipe(cfg).random_batch(cfg, dev, np.random.default_rng(SEED))
    if len(batch) == 5:
        batch[4][1] = 0.0
    return batch


def mesh_reference(cfg, models, batch) -> dict:
    """The single-rank kernel build's step on the global batch from the
    weights ``models`` (a copy is trained): its metrics, gradients and
    weights after Adam, and the gradients of two rounding controls (the
    step on the images nudged by one unit in the last place)."""
    import torch

    from mhada_tpu_torch.train.recipes import recipe
    from mhada_tpu_torch.train.train_image import TRAINABLE, make_optimizers

    ref = dict(models, **{k: copy.deepcopy(models[k]) for k in TRAINABLE})
    images = recipe(cfg).images
    dtype = getattr(torch, cfg.compute_dtype)
    gen = torch.Generator().manual_seed(SEED)
    controls = [step_grads(ref, cfg, [nudged(x, dtype, gen) for x in
                                      batch[:images]] + batch[images:])[1]
                for _ in range(2)]
    metrics = recipe(cfg).make_step(cfg, ref, make_optimizers(ref, cfg))(
        *batch)
    return dict(metrics={k: float(v) for k, v in metrics.items()},
                grads={net: {k: p.grad for k, p in
                             ref[net].named_parameters()}
                       for net in TRAINABLE},
                new={net: ref[net].state_dict() for net in TRAINABLE},
                controls=controls)


def mesh_gate(ref, cfg, metrics, grads, new, key_bias) -> dict:
    """Rank 0's gate of one step on the mesh against ``mesh_reference``'s
    step: the loss; every gradient, each live tensor against its own
    largest value to max(TRAIN_REL, ROUNDING_FACTOR x the larger error of
    the two rounding controls), the others to NOISE_BOUND or, with
    ``key_bias``, the key biases to KEY_BIAS_BOUND, as phase 7; every
    weight after Adam within 2 lr plus its float32 rounding -> a record of
    errors and bounds."""
    import torch

    dname = cfg.compute_dtype
    rg = ref["grads"]
    live = live_tensors(rg)
    errs, noise = grad_errors(grads, rg, live)
    controls = [grad_errors(g, rg, live) for g in ref["controls"]]
    rounding = {t: max(c[0][t] for c in controls) for t in live}
    rel_grad = TRAIN_REL[dname][1]
    bounds = {t: max(rel_grad, ROUNDING_FACTOR * rounding[t]) for t in live}
    noise_bounds = {t: (KEY_BIAS_BOUND[dname] if key_bias
                        and t[1].endswith("g_bias") else NOISE_BOUND[dname])
                    for t in noise}
    over, noise_over = over_bound(errs, bounds), over_bound(noise,
                                                            noise_bounds)
    eps = torch.finfo(torch.float32).eps
    adam_over, within, total = 0, 0, 0
    for net, sd in ref["new"].items():
        for k, t in sd.items():
            d = (new[net][k] - t).abs()
            adam_over += int((d > 2 * cfg.lr + eps * t.abs()).sum())
            within += int((d <= 1e-6).sum())
            total += d.numel()
    rm = ref["metrics"]
    loss_rel = abs(metrics["loss"] - rm["loss"]) / abs(rm["loss"])
    return dict(
        ref_metrics=rm, loss_rel=loss_rel, loss_bound=STEP_LOSS_REL[dname],
        grad_tensors_live=len(errs), grad_over=len(over),
        grad_rel_worst=max(errs.values()),
        grad_nearest=worst_txt(errs, bounds),
        grad_rounding_worst=max(rounding.values()),
        noise_over=len(noise_over),
        noise_nearest=worst_txt(noise, noise_bounds),
        adam_over=adam_over, adam_share_1e6=within / total,
        good=(loss_rel <= STEP_LOSS_REL[dname] and not over
              and not noise_over and adam_over == 0))


def mesh_train_rank(group, shapes, runs) -> dict:
    """One rank of phase 10d: each of ``runs`` ((label, recipe, mesh shape,
    fuse_ln, want, fault, dtype names)) as one step on the mesh from the
    seeded full-width weights (``shard_params``) on this rank's shard of
    the global batch, its launches counted -> {label dtype: launches, wall
    ms, peak GB, whether the replicated weights stayed bitwise equal over
    the model group, the loss; on rank 0 the gate (``mesh_gate``) against
    the single-rank step of the recipe and dtype, computed once (the
    fused-LN build's too: the function is the unfused build's)}."""
    import torch

    from mhada_tpu_torch import _build
    from mhada_tpu_torch.parallel.mesh import (gather_params, make_mesh,
                                               replicas_equal, shard_batch,
                                               shard_params)
    from mhada_tpu_torch.train.recipes import recipe
    from mhada_tpu_torch.train.train_image import (TRAINABLE, init_params,
                                                   make_optimizers)

    dev, rank = group.device, group.rank
    meshes = {s: make_mesh(*s, dev) for s in shapes}
    # the seeded weights of each build, copied for each step
    builds = {fuse: init_params(mesh_config("image", fuse, "float32"), dev,
                                torch.Generator().manual_seed(SEED))
              for fuse in {run[3] for run in runs}}
    refs, res = {}, {}
    for label, kind, shape, fuse_ln, want, fault, dnames in runs:
        mesh = meshes[shape]
        for dname in dnames:
            cfg = mesh_config(kind, fuse_ln, dname)
            batch = mesh_batch(cfg, dev)
            local = shard_params({k: copy.deepcopy(m) if k in TRAINABLE
                                  else m
                                  for k, m in builds[fuse_ln].items()},
                                 mesh.model)
            step = recipe(cfg).make_step(cfg, local,
                                         make_optimizers(local, cfg),
                                         mesh.data, mesh.model)
            part = shard_batch(mesh.data, *batch)
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            _build.reset_launches()
            t0 = time.perf_counter()
            with mesh_fault(fault):
                metrics = step(*part)
            torch.cuda.synchronize(dev)
            ms = (time.perf_counter() - t0) * 1e3
            counts = dict(_build.LAUNCHES)
            trained = {k: local[k] for k in TRAINABLE}
            grads = gather_params(trained, mesh.model, grads=True)
            new = gather_params(trained, mesh.model)
            rec = dict(launches=counts, want=want, ms=ms,
                       peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
                       replicas_equal=replicas_equal(trained, mesh.model),
                       mesh=list(shape),
                       loss=float(metrics["loss"]),
                       finite=all(bool(torch.isfinite(v))
                                  for v in metrics.values()))
            del local, step, part, trained
            torch.cuda.empty_cache()
            if rank == 0:
                if (kind, dname) not in refs:
                    refs[kind, dname] = mesh_reference(
                        cfg, builds[False], batch)
                rec.update(mesh_gate(
                    refs[kind, dname], cfg,
                    {k: float(v) for k, v in metrics.items()}, grads, new,
                    kind == "video"))
                torch.cuda.empty_cache()
            res[f"{label} {SHORT[dname]}"] = rec
            del grads, new, batch
    return res


def mesh_checks(results, tag) -> bool:
    """One phase line per step of ``mesh_train_rank``'s results: a step
    passes when rank 0's gate holds, its launches are exact on every rank,
    the replicated weights bitwise equal and the losses finite; a control
    passes when the gate fails it."""
    ok = True
    for label in results[0]:
        recs = [r[label] for r in results]
        gate = recs[0]
        launches_ok = all(r["launches"] == r["want"] for r in recs)
        sound = (all(r["replicas_equal"] for r in recs)
                 and all(r["finite"] for r in recs))
        control = label.startswith("control")
        good = (not gate["good"] and sound) if control else (
            gate["good"] and launches_ok and sound)
        ok = phase(f"parallel train {label} ({tag})", good,
                   f"{'(must fail the gate) ' if control else ''}mesh "
                   f"{gate['mesh']}; loss {gate['loss']:.6g} against one "
                   f"rank's {gate['ref_metrics']['loss']:.6g}: rel "
                   f"{gate['loss_rel']:.3e} (bound {gate['loss_bound']:.0e});"
                   f" gradients gathered over the model group: "
                   f"{gate['grad_over']} of {gate['grad_tensors_live']} live "
                   f"tensors over their bounds (nearest: "
                   f"{gate['grad_nearest']}; the rounding controls' worst "
                   f"{gate['grad_rounding_worst']:.3e}), {gate['noise_over']}"
                   f" of the others (nearest: {gate['noise_nearest']}); "
                   f"weights after Adam over 2 lr: {gate['adam_over']}, "
                   f"within 1e-6: {100 * gate['adam_share_1e6']:.3f} %; "
                   f"replicas bitwise equal on every rank {sound}; launches "
                   f"exact on every rank {launches_ok} (rank 0: "
                   f"{ {k: v for k, v in gate['launches'].items() if v} }); "
                   f"wall ms of the step per rank (ranks share the card; "
                   f"not gated) {[round(r['ms'], 1) for r in recs]}, peak "
                   f"GB per rank {[round(r['peak_gb'], 2) for r in recs]}"
                   ) and ok
    return ok


def mesh_runs(dnames=DTYPE_NAMES):
    """MESH_RUNS at ``dnames``, then MESH_CONTROLS at float32, as
    ``mesh_train_rank`` takes them."""
    return ([(label, kind, shape, fuse, want, None, dnames)
             for label, kind, shape, fuse, want in MESH_RUNS]
            + [(label, kind, shape, fuse,
                TRAIN_VIDEO if kind == "video" else TRAIN, fault,
                ("float32",))
               for label, kind, shape, fuse, fault in MESH_CONTROLS])


# phase 10d's run_image --nproc 2: its global batch (2 a rank), run beside
# the mesh steps (neither is timed), so their memory must fit together
CLI_RANKS_B = 4


def _session(sid) -> dict:
    """{pid: command line} of the running processes of session ``sid``."""
    found = {}
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
            if int(fields[3]) != sid or fields[0] == "Z":
                continue
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                found[int(pid)] = f.read().replace(b"\0", b" ").decode(
                    errors="replace")
        except (OSError, IndexError, ValueError):   # it ended meanwhile
            continue
    return found


def start_run_image_ranks(tmp):
    """``python -m mhada_tpu_torch.train.run_image --nproc 2`` (two ranks
    sharing the card over gloo) for 2 steps at 256^2 over 16 synthetic
    PNGs under ``tmp``, its output to ``tmp``/out.txt, in a session of its
    own, so that what it leaves running can be found -> the process."""
    synthetic_folders(tmp, 16, np.random.default_rng(SEED))
    with open(f"{tmp}/out.txt", "w") as log:
        return subprocess.Popen(
            [sys.executable, "-m", "mhada_tpu_torch.train.run_image",
             "--coco", f"{tmp}/coco", "--wikiart", f"{tmp}/wikiart",
             "--models-dir", f"{tmp}/models", "--image-size",
             str(TRAIN_SIZE), str(TRAIN_SIZE), "--batch-size",
             str(CLI_RANKS_B), "--seed", str(SEED), "--log-every", "1",
             "--metrics-jsonl", f"{tmp}/m.jsonl", "--epochs", "1",
             "--steps-per-epoch", "2", "--nproc", "2"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            start_new_session=True, stdout=log, stderr=subprocess.STDOUT)


def finish_run_image_ranks(proc, tmp, t0, card) -> tuple[bool, dict]:
    """Wait for ``start_run_image_ranks``' run: exit 0, finite losses
    logged once a step, one checkpoint written, nothing of its session
    left running."""
    try:
        proc.wait(timeout=PAR_TIMEOUT_S)
        left = _session(proc.pid)
        rows = [json.loads(ln) for ln in open(f"{tmp}/m.jsonl")]
        files = sorted(os.listdir(f"{tmp}/models"))
        losses = [r["loss"] for r in rows]
        good = (proc.returncode == 0 and len(rows) == 2
                and all(np.isfinite(losses)) and files.count(
                    f"checkpoint_epoch_1_batchSize_{CLI_RANKS_B}.pth") == 1
                and not left)
        rec = dict(rc=proc.returncode, losses=losses, files=files,
                   left=left, seconds=time.perf_counter() - t0)
        detail = (f"exit {proc.returncode}; losses {losses}; files {files};"
                  f" processes of its session left {left or 'none'}; "
                  f"{rec['seconds']:.1f} s wall beside the mesh steps, the "
                  f"ranks' start included ({card})")
    except Exception as e:
        proc.kill()
        proc.wait()
        good, rec, detail = False, {}, f"{type(e).__name__}: {e}"
    if not good:
        with open(f"{tmp}/out.txt") as f:
            detail += "; its output: " + f.read()[-2000:]
    return phase(f"parallel train run_image --nproc 2, B = {CLI_RANKS_B}, "
                 "2 steps 256^2", good, detail), rec


def phase10_rank(group, nccl_one: bool, shapes, runs) -> dict:
    """One rank of phase 10: the serving paths (``parallel_rank``), then
    the training steps on the mesh (``mesh_train_rank``)."""
    import torch

    serve = parallel_rank(group, nccl_one)
    torch.cuda.empty_cache()
    return {"serve": serve,
            "train": mesh_train_rank(group, shapes, runs) if runs else {}}


def run_split_gate(gate, kind, n, b, dname, card):
    """run_gate of K1's cross form, K3 or K4, and its split count and the
    device ms of its kernels apart (the tile, and the combine when split;
    ``split_ms``, printed as not measured when a part read 0) -> (ok,
    record)."""
    import torch

    good, r = run_gate(gate, kind, n, b, dname, card)
    g = torch.Generator().manual_seed(SEED)
    run = gate_inputs(kind, n, getattr(torch, dname), g, b)[0]
    parts = SPLIT_KERNELS[kind][dname][:1 if run.splits == 1 else 2]
    t0 = time.perf_counter()
    with torch.inference_mode():
        dev = split_ms(lambda: run("kernel"), parts)
    r["splits"], r["split_s"] = run.splits, time.perf_counter() - t0
    dev_txt = "device time not measured (the profiler recorded no launch)"
    if all(dev.values()):
        tile_ms = dev[parts[0]]
        combine_ms = dev[parts[1]] if run.splits > 1 else 0.0
        r.update(device_ms=tile_ms + combine_ms, tile_ms=tile_ms,
                 combine_ms=combine_ms)
        dev_txt = (f"device {tile_ms:.3f} + combine {combine_ms:.3f} ms "
                   f"({100 * r['bound_ms'] / r['device_ms']:.1f} %)")
    keys = n if isinstance(n, int) else n[1]
    phase(f"gate {gate} {dname} split", good,
          f"{run.splits} split(s) of {-(-keys // 64)} key tiles; wrapper "
          f"{r['ms']:.3f} ms ({100 * r['bound_ms'] / r['ms']:.1f} % of the "
          f"bound); {dev_txt}; plain {r['plain_ms']:.3f} ms; SDPA "
          f"{r['library_ms']:.3f} ms")
    return good, r


def cross_split_checks() -> tuple[bool, dict]:
    """K1's cross form beyond its gates: every split count the chooser can
    give forced at CROSS_FORCED against the plain version and repeated bit
    for bit; the planted control (the partials of the chooser's split at
    the first gate shape combined in plain PyTorch without the last split)
    must fail the gate, and with every split it must pass; the ungated
    readings (CROSS_READINGS) -> (ok, record)."""
    import torch
    import torch.nn.functional as F

    from mhada_tpu_torch.ops import attention_kernel as ak
    from mhada_tpu_torch.ops.attention_train import fwd_launch

    c, heads, ok, rec = 512, 8, True, {}
    g = torch.Generator().manual_seed(SEED)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    with torch.inference_mode():
        for dname in DTYPE_NAMES:
            dtype = getattr(torch, dname)
            nq, nk = CROSS_FORCED
            qkv = torch.randn(1, nq, 3 * c, generator=g).to("cuda", dtype)
            kv = torch.randn(1, nk, 2 * c, generator=g).to("cuda", dtype)
            q = qkv[..., :c]
            ref = ak.attention_cross_plain(q, kv, heads).float()
            rels, good = [], True
            for s in range(1, ak.MAX_SPLITS + 1):
                got = ak.attention_cross(q, kv, heads, splits=s)
                again = ak.attention_cross(q, kv, heads, splits=s)
                rel = ((got.float() - ref).abs().max()
                       / ref.abs().max()).item()
                rels.append(rel)
                good = (good and rel <= REL_BOUND[dname]
                        and torch.equal(got, again))
            rec[f"forced {dname}"] = rels
            ok = phase(f"parallel K1 cross form forced splits {dname}",
                       good, f"{nq} x {nk}, splits 1..{ak.MAX_SPLITS}: rel "
                       + ", ".join(f"{r:.2e}" for r in rels)
                       + f" (bound {REL_BOUND[dname]:.0e}); each repeated "
                       "bit for bit") and ok

            # the planted control at the first gate shape
            nq, nk = CROSS_GATES[0][2]
            qkv = torch.randn(1, nq, 3 * c, generator=g).to("cuda", dtype)
            kv = torch.randn(1, nk, 2 * c, generator=g).to("cuda", dtype)
            q = qkv[..., :c]
            splits = ak.cross_splits(1, heads, nq, nk, dtype, sms)
            out, part = ak._cross_launch(q, kv, heads, splits=splits)
            views = ak.split_partials(part, splits, 1, nq, c, heads)
            ref = ak.attention_cross_plain(q, kv, heads).float()

            def rel_to(x):
                return ((x.float() - ref).abs().max()
                        / ref.abs().max()).item()

            kernel, whole = rel_to(out), rel_to(ak.combine_partials(
                *views, dtype)[0])
            dropped = rel_to(ak.combine_partials(*views, dtype,
                                                 keep=splits - 1)[0])
            good = (splits > 1 and kernel <= REL_BOUND[dname]
                    and whole <= REL_BOUND[dname]
                    and dropped > REL_BOUND[dname])
            rec[f"control {dname}"] = dict(splits=splits, kernel=kernel,
                                           combined=whole, dropped=dropped)
            ok = phase(f"parallel K1 cross form control {dname}", good,
                       f"{nq} x {nk}, {splits} splits: the kernel rel "
                       f"{kernel:.2e}, its partials combined in PyTorch "
                       f"{whole:.2e}, without the last split {dropped:.2e} "
                       f"(must exceed {REL_BOUND[dname]:.0e}: the gate "
                       "sees a dropped split)") and ok
            del qkv, kv, q, out, part, views, ref

        for label, nq, nk, dname in CROSS_READINGS:
            dtype = getattr(torch, dname)
            qkv = torch.randn(1, nq, 3 * c, generator=g).to("cuda", dtype)
            kv = (qkv[..., c:] if nq == nk and label.startswith("self")
                  else torch.randn(1, nk, 2 * c, generator=g).to("cuda",
                                                                  dtype))
            q = qkv[..., :c]
            splits = ak.cross_splits(1, heads, nq, nk, dtype, sms)
            ms = cuda_ms(lambda: ak.attention_cross(q, kv, heads), 3, 10)
            dev = split_ms(lambda: ak.attention_cross(q, kv, heads),
                           SPLIT_KERNELS["cross"][dname][:1 if splits == 1
                                                         else 2])
            dev = sum(dev.values()) if all(dev.values()) else None
            qh, kh, vh = (t.unflatten(-1, (heads, 64)).transpose(1, 2)
                          for t in (q, *kv.split(c, dim=-1)))
            sdpa = cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh),
                           3, 10)
            if label.startswith("self"):   # K1's own tile
                other, other_txt = None, "the tile against SDPA alone"
            else:
                k6 = cuda_ms(lambda: fwd_launch(qkv, heads, 0.125), 3, 10)
                other, other_txt = k6, f"K6's forward kernel {k6:.3f} ms"
            bound_ms = bound(4 * nq * nk * c, (2 * nq + 2 * nk) * c
                             * qkv.element_size(), dname)[0]
            rec[f"reading {label} {dname}"] = dict(
                splits=splits, ms=ms, device_ms=dev, sdpa_ms=sdpa,
                other_ms=other, bound_ms=bound_ms)
            dev_txt = (f"device {dev:.3f} ms ({100 * bound_ms / dev:.1f} % of "
                       "the bound)" if dev else "device time not measured")
            phase(f"parallel K1 cross form reading {label} {dname}", True,
                  f"not gated: {splits} split(s), wrapper {ms:.3f} ms, "
                  f"{dev_txt}; {other_txt}; SDPA {sdpa:.3f} ms")
            del qkv, kv, q
    torch.cuda.empty_cache()
    return ok, rec


def parallel_phase(card, gates, launches) -> tuple[bool, dict]:
    """Phase 10: K1's cross form gated at the SP shapes, beside phase 3's
    K1 self-attention time; K6, K7 and K2 at one rank's share of the TP
    split (TP_GATES); then PAR_RANKS ranks sharing the card over gloo
    (``phase10_rank``: the serving paths, with NCCL at world size 1 inside
    them, and the training steps on the mesh); ``run_image --nproc 2``;
    then NCCL across cards where there are two or more."""
    import torch

    from mhada_tpu_torch.parallel.launch import run_ranks

    ok, rec, secs = True, {}, {}
    t0 = time.perf_counter()
    for gate, _, n, b in CROSS_GATES:
        for dname in DTYPE_NAMES:
            try:
                good, r = run_split_gate(gate, "cross", n, b, dname, card)
            except Exception as e:
                ok = phase(f"gate {gate} {dname}", False,
                           f"{type(e).__name__}: {e}")
                continue
            gates.setdefault(gate, {})[dname] = r
            ok = good and ok
    secs["cross_gates"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    try:
        good, rec["cross_split_checks"] = cross_split_checks()
    except Exception as e:
        good = phase("parallel K1 cross form splits", False,
                     f"{type(e).__name__}: {e}")
    ok = good and ok
    secs["cross_split_checks"] = time.perf_counter() - t1
    k1 = gates.get("K1 L=4096", {})
    rec["k1_self_ms"] = {d: k1.get(d, {}).get("ms") for d in DTYPE_NAMES}
    phase("parallel K1 self-attention 512^2", True,
          "phase 3's K1 L=4096 in this run: " + ", ".join(
              f"{d} {ms:.3f} ms" for d, ms in rec["k1_self_ms"].items()
              if ms is not None))

    t0 = time.perf_counter()
    for gate, kind, b, n in TP_GATES:
        for dname in DTYPE_NAMES:
            try:
                good, r = run_train_gate(gate, kind, dname, card, b, n, TP)
            except Exception as e:
                ok = phase(f"train gate {gate} {dname}", False,
                           f"{type(e).__name__}: {e}")
                continue
            rec.setdefault("tp_gates", {}).setdefault(gate, {})[dname] = r
            ok = good and ok
    secs["tp_gates"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    shapes = sorted({run[2] for run in MESH_RUNS})
    cli_tmp = tempfile.TemporaryDirectory()
    cli = start_run_image_ranks(cli_tmp.name)
    try:
        results = run_ranks(phase10_rank, PAR_RANKS,
                            (True, shapes, mesh_runs()), device="cuda",
                            backend="gloo", timeout_s=PAR_TIMEOUT_S)
    except RuntimeError as e:
        ok = phase(f"parallel {PAR_RANKS} ranks over gloo", False,
                   str(e)[-3000:])
    else:
        serve = [r["serve"] for r in results]
        train = [r["train"] for r in results]
        rec["gloo"], rec["gloo_train"] = serve, train
        tag = f"gloo, {PAR_RANKS} ranks share the card"
        ok = parallel_checks(serve, tag) and ok
        ok = mesh_checks(train, tag) and ok
        launches["sp512"] = serve[0][f"sp512 f32 x{PAR_RANKS}"]["launches"]
        launches["sp1024"] = serve[0][f"sp1024 bf16 x{PAR_RANKS}"]["launches"]
        for key, label in (("mesh_image", "image 2x2 f32"),
                           ("mesh_fuseln", "fused 2x2 f32"),
                           ("mesh_video", "video 2x2 f32")):
            launches[key] = train[0][label]["launches"]
    secs["gloo_ranks"] = time.perf_counter() - t0
    good, rec["run_image_nproc2"] = finish_run_image_ranks(cli, cli_tmp.name,
                                                           t0, card)
    cli_tmp.cleanup()
    ok = good and ok
    secs["gloo_ranks_and_cli"] = time.perf_counter() - t0

    cards = torch.cuda.device_count()
    if cards >= 2:
        t0 = time.perf_counter()
        n = min(cards, PAR_RANKS)
        # the training steps need the 4 ranks of MESH_RUNS' meshes
        runs = mesh_runs(("float32",))[:len(MESH_RUNS)] if n == 4 else []
        try:
            results = run_ranks(phase10_rank, n, (False, shapes, runs),
                                device="cuda", backend="nccl",
                                timeout_s=PAR_TIMEOUT_S)
        except RuntimeError as e:
            ok = phase(f"parallel {n} ranks over NCCL", False, str(e)[-3000:])
        else:
            rec["nccl"] = [r["serve"] for r in results]
            rec["nccl_train"] = [r["train"] for r in results]
            ok = parallel_checks(rec["nccl"], f"NCCL, {n} cards") and ok
            if runs:
                ok = mesh_checks(rec["nccl_train"], f"NCCL, {n} cards") \
                    and ok
        secs["nccl_ranks"] = time.perf_counter() - t0
    else:
        phase("parallel NCCL across cards", True,
              f"not run: {cards} card visible, and NCCL puts no two ranks "
              "of one communicator on one card; SP, PP and DP inference "
              "and DP and DP x TP training over NCCL across cards stay "
              "unverified (NCCL at world size 1 ran above)")
    rec["seconds"] = secs
    phase("parallel seconds", True, ", ".join(f"{k} {v:.1f}"
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
    # seconds of what the split of K3 and K4 over the keys added: the two K3
    # gates at its shapes, the split lines' profiler windows, the checks
    split_s = dict.fromkeys(("K3 gates", "split lines", "checks"), 0.0)
    for gate, _, kind, n, b in gate_list:
        for dname in DTYPE_NAMES:
            if kind in BF16_ONLY and dname != "bfloat16":
                continue
            t_gate = time.perf_counter()
            try:
                good, rec = (run_split_gate if kind in SPLIT_KERNELS
                             else run_gate)(gate, kind, n, b, dname, card)
            except Exception as e:  # report every kernel, then fail
                ok = phase(f"gate {gate} {dname}", False,
                           f"{type(e).__name__}: {e}")
                continue
            gates.setdefault(gate, {})[dname] = rec
            ok = good and ok
            if gate in SPLIT_K3_GATES:
                split_s["K3 gates"] += time.perf_counter() - t_gate
            elif kind in ("prologue", "mhada"):
                split_s["split lines"] += rec.get("split_s", 0.0)
    for dname in DTYPE_NAMES:
        ok = pipe_against_k3(dname) and ok
    t0 = time.perf_counter()
    try:
        good, mhada_split = mhada_split_checks()
    except Exception as e:
        good, mhada_split = phase("K3 and K4 split checks", False,
                                  f"{type(e).__name__}: {e}"), {}
    ok = good and ok
    split_s["checks"] = time.perf_counter() - t0
    mhada_split["seconds"] = split_s
    phase("K3 and K4 split seconds", True,
          f"{sum(split_s.values()):.1f} s added: " + ", ".join(
              f"{k} {v:.1f}" for k, v in split_s.items()))
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
    try:
        good, train_extra["K6 split control"] = k6_split_control()
    except Exception as e:
        good = phase("train gate K6 split control", False,
                     f"{type(e).__name__}: {e}")
    ok = good and ok
    for gate, kind, b, n, tp in K6_EXTRA_GATES + K7_EXTRA_GATES:
        for dname in DTYPE_NAMES:
            try:
                good, recs = run_train_gate(gate, kind, dname, card, b, n, tp)
            except Exception as e:
                good = phase(f"train gate {gate} {dname}", False,
                             f"{type(e).__name__}: {e}")
            else:
                train_extra.setdefault(gate, {})[dname] = recs
            ok = good and ok
    try:
        good, train_extra["K7 checks"] = k7_checks()
    except Exception as e:
        good = phase("train gate K7 checks", False,
                     f"{type(e).__name__}: {e}")
    ok = good and ok
    try:
        good, train_extra["K6 checks"] = k6_checks()
    except Exception as e:
        good = phase("train gate K6 checks", False,
                     f"{type(e).__name__}: {e}")
    ok = good and ok

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
                           [tc, ts], (1, 2), "256^2, B = 8") and ok

    # b. the fused-LN build (K2 and its VJP at every pre-LN), 256^2, B = 8
    fused = train_models("auto", fuse_ln=True)
    ok = step_gate("fused-LN 256^2", TRAIN_FUSED, fused,
                   train_models("plain", fuse_ln=True), [tc, ts],
                   "train_fuseln") and ok
    ok = interleaved_steps("fuseln256", {"unfused": kernel, "fused": fused},
                           [tc, ts], (1, 2), "kernel builds, 256^2, B = 8") \
        and ok
    del kernel, plain, fused, ktrain, ptrain, tc, ts
    torch.cuda.empty_cache()

    # c. 512^2, B = 4: 4096 tokens at every attention and MHAda site
    kernel = train_models("auto", BIG_SIZE, BIG_B)
    plain = train_models("plain", BIG_SIZE, BIG_B)
    tc, ts = batch(kernel[0])
    ok = step_gate("512^2", TRAIN, kernel, plain, [tc, ts], "train512") \
        and ok
    # one timed step a round here and two at 256^2 and in the video step,
    # four rounds a build and dtype: the room phase 10d needs (~25 s on an
    # H100)
    ok = interleaved_steps("train512", {"plain": plain, "kernel": kernel},
                           [tc, ts], (1, 1), f"512^2, B = {BIG_B}") and ok
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
                           vbatch, (1, 2), "the video recipe, B = {}, {} x {}"
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

    # ---- 9. the analysis tools: feature inversion through K6 and K7
    t0 = time.perf_counter()
    good, analysis = analysis_phase(card, train_extra)
    ok = good and ok
    for mode in ("vit", "mhada"):
        launches[f"inversion_{mode}"] = analysis.get(
            f"cli_{mode}", {}).get("launches", {})
    analysis_s = time.perf_counter() - t0

    # ---- 10. the parallel serving paths: K1's cross form, SP, PP and DP
    t0 = time.perf_counter()
    good, parallel = parallel_phase(card, gates, launches)
    ok = good and ok
    parallel_s = time.perf_counter() - t0

    # ---- the kernels' summary: one row per TPU kernel the path replaces
    first_gate = {}
    for gate, row, *_ in gate_list:
        first_gate.setdefault(row, gate)
    first_gate[K12_SINGLE] = first_gate["K1 attention_tm"]
    for gate, row, *_ in CROSS_GATES:
        first_gate.setdefault(row, gate)
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
        if path == "train":   # K6, K7, K8: the video step's, the feature
            # inversions' and one rank's of the (2 x 2) mesh's steps too
            for key in ("train_video", "inversion_vit", "inversion_mhada",
                        "mesh_image", "mesh_video"):
                row["launches_" + key.replace("train_", "")] = launches.get(
                    key, {}).get(entry, 0)
        if path == "train_fuseln":   # K2: one rank's of the mesh's step
            row["launches_mesh_fuseln"] = launches.get(
                "mesh_fuseln", {}).get(entry, 0)
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
                    "c5c6_ms", "tile", "splits", "device_ms", "combine_ms"):
            if key in r32 or key in r16:
                row[key] = r32.get(key)
                row[key + "_bf16"] = r16.get(key)
        # the call that was timed, as the gate recorded it
        row["library"] = r32.get("library") or r16.get("library") or NO_LIB
        summary.append(row)
    extra = {g: gates.get(g) for g, *_ in gate_list + EVAL_GATES
             + CROSS_GATES if g not in first_gate.values()}
    stopped = stop_children()
    left = _children()
    ok = phase("processes", not left,
               f"still running at the end, stopped: {stopped or 'none'}; "
               f"left: {left or 'none'}") and ok
    seconds = time.perf_counter() - t_start
    phase("run time", True, f"{seconds:.1f} s from start to summary, "
          f"{video_s:.1f} s of it the video gates and step (phases 6, 7e), "
          f"{evals_s:.1f} s the evals (phase 8), {analysis_s:.1f} s the "
          f"analysis tools (phase 9), {parallel_s:.1f} s the parallel "
          f"paths (phase 10)")
    print(json.dumps({"kernels": summary, "extra_gates": extra,
                      "launches": launches, "frame_ms": frame_ms,
                      "video_cli": video_cli, "evals": evals,
                      "analysis": analysis, "parallel": parallel,
                      "mhada_split": mhada_split,
                      "train": train_extra, "step_ms": step_ms,
                      "step_peak_gb": step_peak_gb,
                      "card": card, "seconds": seconds}), flush=True)
    if not ok:
        for line in FAILED:
            print(f"chip_smoke: failed phase {line}", file=sys.stderr)
        print(f"chip_smoke: FAILED ({len(FAILED)} phase(s))", file=sys.stderr)
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
