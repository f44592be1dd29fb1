"""The training CLI on several ranks, CPU: ``train.run_image --device cpu
--nproc 2`` (two gloo ranks, each loading the global batch and training on
its half) against the same run on one rank, over a folder of PNGs, each
run a process in a session of its own."""

import json
import os
import subprocess
import sys

import numpy as np
import psutil
import pytest
import torch
from PIL import Image


# Six test workers share the CPU: cap torch's intra-op threads.
torch.set_num_threads(2)

LR, STEPS = 1e-4, 2


def _session(sid: int) -> list:
    """The live processes of session ``sid``."""
    return [p for p in psutil.process_iter(["status"])
            if p.info["status"] != psutil.STATUS_ZOMBIE
            and _sid(p) == sid]


def _sid(p) -> int | None:
    try:
        return os.getsid(p.pid)
    except OSError:   # it ended meanwhile
        return None


def test_run_image_two_ranks_match_one(tmp_path):
    """``python -m mhada_tpu_torch.train.run_image --nproc 2``, 2 steps at a
    global batch of 2, exits 0, writes one checkpoint (rank 0's) and logs
    each step once, and nothing of its session outlives it; every logged
    metric is the 1-rank run's within 5e-5 relative (the step tests'
    bound: step 2's loss shows that step 1 moved the weights alike), every
    weight within the Adam bound of 2 lr a step.

    Not held here: the step tests' share of weights within 1e-6.  At the
    CLI's full width on random weights and 32^2 images, 0.09 % of the
    weights after one step (up to 0.34 lr, no sign flipped) have gradients
    near Adam's eps, where a rounding-level change of the gradient moves
    the update; test_torch_parallel_train.py holds the share on its
    model."""
    rng = np.random.default_rng(3)
    for d in ("coco", "wikiart"):
        (tmp_path / d).mkdir()
        for i in range(4):
            Image.fromarray(rng.integers(0, 256, (40, 48, 3), np.uint8)).save(
                tmp_path / d / f"{i}.png")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ckpts, logs = {}, {}
    for n in (1, 2):
        out = tmp_path / f"models{n}"
        log = tmp_path / f"m{n}.jsonl"
        proc = subprocess.Popen(
            [sys.executable, "-m", "mhada_tpu_torch.train.run_image",
             "--coco", str(tmp_path / "coco"), "--wikiart",
             str(tmp_path / "wikiart"), "--models-dir", str(out),
             "--batch-size", "2", "--image-size", "32", "32", "--device",
             "cpu", "--seed", "0", "--epochs", "1", "--steps-per-epoch",
             str(STEPS), "--log-every", "1", "--metrics-jsonl", str(log),
             "--nproc", str(n)], cwd=root, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, start_new_session=True)
        output, _ = proc.communicate(timeout=240)
        assert proc.returncode == 0, output
        assert _session(proc.pid) == []
        assert os.listdir(out).count("checkpoint_epoch_1_batchSize_2.pth") == 1
        ckpts[n] = torch.load(out / "checkpoint_epoch_1_batchSize_2.pth",
                              weights_only=True)
        logs[n] = [json.loads(ln) for ln in open(log)]
    assert [r["step"] for r in logs[2]] == [1, 2]
    for got, want in zip(logs[2], logs[1]):
        for k in ("loss", "loss_gs", "loss_lf", "loss_id1", "loss_id2"):
            assert got[k] == pytest.approx(want[k], rel=5e-5), k
    for net, sd in ckpts[1]["model_state"].items():
        for k, want in sd.items():
            d = (ckpts[2]["model_state"][net][k] - want).abs().max().item()
            assert d <= 2 * LR * STEPS, (net, k, d)
