"""The port's training CLIs on the CPU: checkpoints in the reference's
format, resume, the run_image CLI over a folder of PNGs, bench_steps
--tiny, and the card-by-default rule."""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from mhada_tpu_torch.config import ImageTrainConfig, ModelConfig
from mhada_tpu_torch.interop import load_pth_params
from mhada_tpu_torch.train import bench_steps, checkpoint, run_image
from mhada_tpu_torch.train.train_image import (TRAINABLE, init_params,
                                               make_image_train_step,
                                               make_optimizers)

SMALL = dict(num_layers=2, hidden_dim=128, num_heads=2, mlp_dim=256)
CFG = ImageTrainConfig(model=ModelConfig(**SMALL), batch_size=2,
                       image_size=(32, 32))


def _models():
    """Seeded small models; c6's bias is raised so the random decoder's
    output is positive and every network gets a gradient."""
    models = init_params(CFG, "cpu")
    with torch.no_grad():
        models["adaFormer"].decoder.c6.conv.bias.add_(1.0)
    return models


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.uniform(0, 255, (2, 32, 32, 3)).astype(
        np.float32)) for _ in range(2))


def test_weights_round_trip_through_reference_pth(tmp_path):
    """save_weights writes reference state_dicts; load_pth_params reads them
    back to exactly the models' weights."""
    models = _models()
    checkpoint.save_weights(str(tmp_path), models, 2, 2, suffix="_epoch_1")
    got = load_pth_params(*(str(tmp_path / f"{n}_epoch_1.pth")
                            for n in ("AdaFormer", "ViT_C", "ViT_S")),
                          num_layers=2, num_heads=2)
    for net in TRAINABLE:
        want = models[net].state_dict()
        assert got[net].keys() == want.keys()
        for k in want:
            torch.testing.assert_close(got[net][k], want[k], rtol=0, atol=0)


def test_resume_equals_uninterrupted(tmp_path):
    """Two steps in one run == one step, a checkpoint, and one step in a
    fresh process state restored from it (weights and Adam)."""
    c, s = _batch()
    ref = _models()
    step = make_image_train_step(CFG, ref, make_optimizers(ref, CFG))
    for _ in range(2):
        step(c, s)

    first = _models()
    opts = make_optimizers(first, CFG)
    make_image_train_step(CFG, first, opts)(c, s)
    path = checkpoint.save_checkpoint(str(tmp_path), 1, 2, first, opts, 2, 2)
    assert checkpoint.latest_checkpoint(str(tmp_path), 2) == path
    assert checkpoint.latest_checkpoint(str(tmp_path), 8) is None

    resumed = init_params(CFG, "cpu", torch.Generator().manual_seed(5))
    resumed["vgg19"].load_state_dict(first["vgg19"].state_dict())
    opts = make_optimizers(resumed, CFG)
    assert checkpoint.restore_checkpoint(path, resumed, opts, 2, 2) == 1
    make_image_train_step(CFG, resumed, opts)(c, s)
    for net in TRAINABLE:
        want = ref[net].state_dict()
        for k, v in resumed[net].state_dict().items():
            torch.testing.assert_close(v, want[k], rtol=0, atol=0)


def test_run_image_cli_and_resume(tmp_path):
    """run_image --device cpu: two steps over a folder of PNGs, then one
    resumed step from its checkpoint, with metrics as JSON lines."""
    rng = np.random.default_rng(3)
    for d in ("coco", "wikiart"):
        (tmp_path / d).mkdir()
        for i in range(4):
            Image.fromarray(rng.integers(0, 256, (40, 48, 3), np.uint8)).save(
                tmp_path / d / f"{i}.png")
    common = ["--coco", str(tmp_path / "coco"), "--wikiart",
              str(tmp_path / "wikiart"), "--models-dir",
              str(tmp_path / "models"), "--batch-size", "2", "--image-size",
              "32", "32", "--device", "cpu", "--seed", "0", "--log-every",
              "1", "--metrics-jsonl", str(tmp_path / "m.jsonl")]
    run_image.main(common + ["--epochs", "1", "--steps-per-epoch", "2"])
    names = set(os.listdir(tmp_path / "models"))
    assert {"checkpoint_epoch_1_batchSize_2.pth", "AdaFormer.pth",
            "ViT_C_epoch_1_batchSize_2.pth"} <= names
    run_image.main(common + ["--epoch-start", "2", "--epochs", "2",
                             "--steps-per-epoch", "1"])
    assert "checkpoint_epoch_2_batchSize_2.pth" in set(
        os.listdir(tmp_path / "models"))
    rows = [json.loads(ln) for ln in open(tmp_path / "m.jsonl")]
    assert [r["epoch"] for r in rows] == [1, 1, 2]
    assert all(np.isfinite(r["loss"]) for r in rows)


def test_bench_steps_tiny_on_cpu(capsys):
    bench_steps.main(["--tiny", "--device", "cpu", "--steps", "1"])
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [r["variant"] for r in rows] == list(bench_steps.VARIANTS)
    assert all(r["ms_per_step"] > 0 and r["tiny"] for r in rows)


def test_training_clis_need_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        run_image.main(["--coco", "nowhere"])
    with pytest.raises(RuntimeError, match="--device cpu"):
        bench_steps.main(["--tiny"])
    with pytest.raises(SystemExit):   # the recipe itself needs the card
        bench_steps.main(["--device", "cpu"])
