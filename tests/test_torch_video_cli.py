"""The port's video-training CLIs on the CPU: ``run_video --device cpu`` for
2 steps over a synthetic SceneFlow tree and WikiArt PNGs, resumed across
from a ``run_image`` checkpoint (the image batch size names it) and then
from its own newest checkpoint; the resume rule itself; ``bench_steps
--tiny`` with the video variants; and the card-by-default rule."""

import json
import os
from dataclasses import replace

import numpy as np
import pytest
import torch

from mhada_tpu_torch.config import ImageTrainConfig, VideoTrainConfig
from mhada_tpu_torch.train import bench_steps, checkpoint, run_image
from mhada_tpu_torch.train import run_video
from mhada_tpu_torch.train.train_image import init_params, make_optimizers
from sceneflow_tree import make_video_datasets, png

# Six test workers share the CPU: cap torch's intra-op threads.
torch.set_num_threads(2)


def test_run_video_resumes_across_from_run_image(tmp_path, capsys):
    """run_image (B = 4, 32^2) writes checkpoint_epoch_1_batchSize_4; a
    video run from epoch 2 with --image-batch-size 4 resumes from it, takes
    2 steps of B = 2 and writes its own files under batchSize_2; a second
    video run from epoch 3 finds no image checkpoint of epoch 2 and resumes
    from the video run's."""
    rng = np.random.default_rng(0)
    make_video_datasets(str(tmp_path / "data"), rng)
    (tmp_path / "coco").mkdir()
    for i in range(4):
        png(str(tmp_path / "coco" / f"{i}.png"), rng, (40, 48))
    models = str(tmp_path / "models")
    run_image.main(["--coco", str(tmp_path / "coco"), "--wikiart",
                    str(tmp_path / "data" / "WikiArt"), "--models-dir",
                    models, "--batch-size", "4", "--image-size", "32", "32",
                    "--epochs", "1", "--steps-per-epoch", "1", "--device",
                    "cpu", "--seed", "0"])
    assert "checkpoint_epoch_1_batchSize_4.pth" in os.listdir(models)
    common = ["--datasets", str(tmp_path / "data"), "--models-dir", models,
              "--batch-size", "2", "--image-batch-size", "4",
              "--content-size", "32", "64", "--style-size", "32", "32",
              "--steps-per-epoch", "2", "--device", "cpu", "--seed", "0",
              "--log-every", "1", "--metrics-jsonl",
              str(tmp_path / "m.jsonl")]
    capsys.readouterr()
    run_video.main(common + ["--epoch-start", "2", "--epochs", "2"])
    out = capsys.readouterr().out
    assert "resumed from " + os.path.join(
        models, "checkpoint_epoch_1_batchSize_4.pth") + " (epoch 1)" in out
    names = set(os.listdir(models))
    assert {"checkpoint_epoch_2_batchSize_2.pth", "AdaFormer.pth",
            "ViT_C_epoch_2_batchSize_2.pth", "ViT_S_epoch_2_batchSize_2.pth",
            "AdaFormer_epoch_2_batchSize_2.pth.json"} <= names
    run_video.main(common + ["--epoch-start", "3", "--epochs", "3",
                             "--steps-per-epoch", "1"])
    assert "checkpoint_epoch_2_batchSize_2.pth (epoch 2)" in (
        capsys.readouterr().out)
    rows = [json.loads(ln) for ln in open(tmp_path / "m.jsonl")]
    assert [r["epoch"] for r in rows] == [2, 2, 3]
    assert set(rows[0]) >= {"loss", "l_gs", "l_lf", "l_ot", "l_ft", "l_id1",
                            "l_id2"}
    assert all(np.isfinite(r["loss"]) for r in rows)


def test_resume_path_and_adam_state(tmp_path):
    """The image checkpoint wins, else the newest video one; neither raises
    FileNotFoundError.  Resuming restores Adam's state as well as the
    weights."""
    cfg = VideoTrainConfig(epoch_start=5, batch_size=2, image_batch_size=8)
    with pytest.raises(FileNotFoundError):
        run_video.resume_path(str(tmp_path), cfg)
    small = ImageTrainConfig(model=replace(cfg.model, num_layers=1,
                                           hidden_dim=64, mlp_dim=128,
                                           num_heads=2))
    models = init_params(small, "cpu")
    opts = make_optimizers(models, small)
    for p in models["vit_c"].parameters():
        p.grad = torch.ones_like(p)
    opts["vit_c"].step()
    for epoch, b in ((2, 2), (3, 2), (4, 8)):
        checkpoint.save_checkpoint(str(tmp_path), epoch, b, models, opts, 1,
                                   2)
    assert run_video.resume_path(str(tmp_path), cfg).endswith(
        "checkpoint_epoch_4_batchSize_8.pth")
    assert run_video.resume_path(str(tmp_path), replace(
        cfg, epoch_start=4)).endswith("checkpoint_epoch_3_batchSize_2.pth")
    fresh = init_params(small, "cpu", torch.Generator().manual_seed(7))
    fresh_opts = make_optimizers(fresh, small)
    assert checkpoint.restore_checkpoint(
        run_video.resume_path(str(tmp_path), cfg), fresh, fresh_opts, 1,
        2) == 4
    want, got = opts["vit_c"].state_dict(), fresh_opts["vit_c"].state_dict()
    assert got["state"].keys() == want["state"].keys() and want["state"]
    for k, s in want["state"].items():
        for name, v in s.items():
            torch.testing.assert_close(got["state"][k][name], v, rtol=0,
                                       atol=0)


def test_bench_steps_video_variants_tiny_on_cpu(capsys):
    bench_steps.main(["--tiny", "--device", "cpu", "--steps", "1",
                      "--variants", "video_f32", "video_bf16"])
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [r["variant"] for r in rows] == ["video_f32", "video_bf16"]
    for r in rows:
        assert r["ms_per_step"] > 0 and r["tiny"] and r["batch_size"] == 2
        assert r["content_size"] == [32, 64] and r["style_size"] == [32, 32]


def test_video_clis_need_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        run_video.main(["--datasets", "nowhere"])
    with pytest.raises(RuntimeError, match="--device cpu"):
        bench_steps.main(["--tiny", "--variants", "video_f32"])
    with pytest.raises(SystemExit):   # the recipe itself needs the card
        bench_steps.main(["--device", "cpu", "--variants", "video_bf16"])
