"""The port's video CLIs on the CPU.

Training: ``run_video --device cpu`` for 2 steps over a synthetic SceneFlow
tree and WikiArt PNGs, resumed across from a ``run_image`` checkpoint (the
image batch size names it) and then from its own newest checkpoint; the
resume rule itself; ``bench_steps --tiny`` with the video variants; and the
card-by-default rule.

Inference (``infer.video``, and the image CLI's ``--heatmaps``) against the
JAX package at ModelConfig(hidden_dim=64, mlp_dim=128, num_heads=4) with
one set of weights, c6 scaled so the pictures are not black: the streaming
CLI's frames on a 4-frame 64 x 96 clip written with cv2, chunked against
unchunked, ``--mode Original``, the files written, ``main --device cpu``
with random weights, and ``make_diagnostic_fn``'s outputs and the
heatmaps' file names."""

import json
import os
from dataclasses import replace

import numpy as np
import pytest
import jax
import torch

from mhada_tpu.config import ModelConfig as JaxModelConfig
from mhada_tpu.infer import image as jax_image
from mhada_tpu.infer import video as jax_video
from mhada_tpu.train.train_image import build_models as jax_build_models
from mhada_tpu_torch.config import (ImageTrainConfig, ModelConfig,
                                    VideoTrainConfig)
from mhada_tpu_torch.infer import image, video
from mhada_tpu_torch.interop import jax_params_to_state_dicts, load_params
from mhada_tpu_torch.models import build_models
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


TINY = dict(hidden_dim=64, mlp_dim=128, num_heads=4)
# c6 is conv + ReLU: this gain scales the random decoder's ~0.04 output into
# a picture on both sides (as in test_torch_streaming.py).
C6_GAIN = 3000.0
CLIP_HW, FRAMES = (64, 96), 4


@pytest.fixture(scope="module")
def pair():
    """JAX models and params (TINY, spatial, seed 0, c6 scaled) and the
    port's models holding the same weights, on the CPU."""
    jmodels = jax_build_models(JaxModelConfig(**TINY))
    params = jax.tree_util.tree_map(
        np.array, jax_image.init_inference_params(jmodels,
                                                  jax.random.PRNGKey(0)))
    c6 = params["adaFormer"]["decoder"]["c6"]["conv"]
    c6["kernel"] *= C6_GAIN
    c6["bias"] *= C6_GAIN
    models = build_models(ModelConfig(**TINY), device="cpu")
    load_params(models, jax_params_to_state_dicts(params))
    return jmodels, params, models


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """A 4-frame 64 x 96 mp4v clip (smooth moving bands plus noise, as
    tests/test_drivers.py:64-75 writes one) and a 64^2 style."""
    import cv2

    d = tmp_path_factory.mktemp("clip")
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[0:CLIP_HW[0], 0:CLIP_HW[1]]
    path = str(d / "in.mp4")
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 5,
                         CLIP_HW[::-1])
    for i in range(FRAMES):
        f = np.stack([127 + 100 * np.sin((xx + 4 * i) / (7 + c) + yy / 11)
                      for c in range(3)], -1) + rng.normal(0, 10, (*CLIP_HW,
                                                                     3))
        vw.write(np.clip(f, 0, 255).astype(np.uint8))
    vw.release()
    style = rng.uniform(0, 255, (64, 64, 3)).astype(np.float32)
    return path, style


def _run(module, call, out_dir):
    """Run a ``stream_stylize`` (the JAX or the port's) with its ``_flush``
    recording every frame -> (frame count, uint8 frames in order, the
    files written)."""
    got = []
    flush = module._flush
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(module, "_flush",
                   lambda p, *a, **k: (got.append((p[0], np.array(p[1]))),
                                       flush(p, *a, **k)))
        n = call(str(out_dir))
    frames = [f for _, f in sorted(got, key=lambda t: t[0])]
    assert [i for i, _ in got] == list(range(len(got)))
    return n, np.stack(frames), sorted(os.listdir(out_dir))


@pytest.fixture(scope="module")
def streams(pair, clip, tmp_path_factory):
    """The clip through the JAX CLI's stream_stylize and the port's, at B =
    1 and (the port) at chunk = 3, and in Original mode on both."""
    jmodels, params, models = pair
    path, style = clip
    d = tmp_path_factory.mktemp("streams")
    out = {
        "jax": _run(jax_video, lambda o: jax_video.stream_stylize(
            params, jmodels, path, style, o, CLIP_HW), d / "jax"),
        "jax_orig": _run(jax_video, lambda o: jax_video.stream_stylize(
            params, jmodels, path, style, o, CLIP_HW, mode="Original"),
            d / "jax_orig"),
    }
    session = {}
    for key, kw in (("port", dict(session=session)),
                    ("port_chunk3", dict(chunk=3, session=session)),
                    ("port_orig", dict(mode="Original"))):
        out[key] = _run(video, lambda o, kw=kw: video.stream_stylize(
            models, path, style, o, CLIP_HW, **kw), d / key)
    out["session"] = session
    return out


def test_stream_stylize_matches_jax(streams):
    """uint8 frames: the float pictures agree to ~1e-4, so truncation to
    uint8 may split them by one level where a value sits on an integer;
    at most 1 level, on at most 0.5 % of the values."""
    n, got, _ = streams["port"]
    nj, ref, _ = streams["jax"]
    assert n == nj == FRAMES and got.shape == ref.shape == (FRAMES, *CLIP_HW,
                                                            3)
    assert got.dtype == np.uint8 and got.max() > 0
    d = np.abs(got.astype(int) - ref.astype(int))
    assert d.max() <= 1 and (d > 0).mean() <= 0.005, (d.max(),
                                                      (d > 0).mean())


def test_chunked_frames_match_unchunked(streams):
    """chunk = 3 over 4 frames: one batch of 3 against the tiled K/V, then
    one tail frame at B = 1; within 1 level of the B = 1 frames."""
    n, got, _ = streams["port_chunk3"]
    _, ref, _ = streams["port"]
    assert n == FRAMES
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1


def test_session_holds_the_style_kv(streams, pair):
    """The session kept the style K/V at B = 1 and tiled to the chunk; the
    second call took them from it."""
    session = streams["session"]
    models = pair[2]
    assert set(session) == {"kv", "kv_chunk"} and set(
        session["kv_chunk"]) == {3}
    assert len(session["kv"]) == 2 * models["adaFormer"].num_layers
    for (k, v), (kt, vt) in zip(session["kv"], session["kv_chunk"][3]):
        assert k.shape[0] == 1 and kt.shape[0] == 3
        assert torch.equal(kt[2], k[0]) and torch.equal(vt[1], v[0])


def test_original_mode_passes_frames_through(streams):
    """--mode Original writes the decoded, INTER_AREA-resized frames, the
    JAX CLI's frames exactly."""
    n, got, _ = streams["port_orig"]
    nj, ref, _ = streams["jax_orig"]
    assert n == nj == FRAMES and np.array_equal(got, ref)


def test_stream_stylize_writes_the_jax_files(streams):
    want = [f"frame_{i:05d}.jpg" for i in range(FRAMES)] + ["video.mp4"]
    for key in ("jax", "port", "port_chunk3", "port_orig"):
        assert streams[key][2] == want, key


def test_frames_reach_the_kernels_contiguous(pair, clip, tmp_path,
                                             monkeypatch):
    """Every K2 input of the CLI's stream is contiguous, at B = 1 and in a
    chunk: the kernels raise on anything else.  (A frame batch made with
    numpy's ``a[None]`` has a batch stride of 0, for which the patch conv
    came back in NCHW order and its tokens non-contiguous: on the card the
    CLI raised in K2 at --chunk 1.)"""
    from mhada_tpu_torch.models import layers, vit
    from mhada_tpu_torch.ops.pad_conv import conv2d

    seen = []

    def recording(x, *args, **kwargs):
        seen.append(x.is_contiguous())
        return ln_matmul(x, *args, **kwargs)

    from mhada_tpu_torch.ops.ln_matmul import ln_matmul
    for mod in (layers, vit):
        monkeypatch.setattr(mod, "ln_matmul", recording)
    path, style = clip
    models = pair[2]
    for chunk in (1, 3):
        video.stream_stylize(models, path, style, str(tmp_path / str(chunk)),
                             CLIP_HW, chunk=chunk, write_mp4=False)
    assert seen and all(seen)
    a = torch.from_numpy(np.zeros((16, 16, 3), np.float32)[None])
    assert a.stride()[0] == 0
    assert conv2d(a, torch.zeros(4, 3, 8, 8), torch.zeros(4),
                  stride=8).is_contiguous()


def test_video_main_runs_on_cpu_with_random_weights(clip, tmp_path, capsys):
    import cv2

    path, style = clip
    cv2.imwrite(str(tmp_path / "s.png"), style.astype(np.uint8))
    out = tmp_path / "out"
    video.main(["--video", path, "--style", str(tmp_path / "s.png"),
                "--out", str(out), "--size", "32", "64", "--style-size",
                "32", "32", "--max-frames", "2", "--chunk", "2",
                "--device", "cpu"])
    assert "processed 2 frames" in capsys.readouterr().out
    assert sorted(os.listdir(out)) == ["frame_00000.jpg", "frame_00001.jpg",
                                       "video.mp4"]
    cap = cv2.VideoCapture(str(out / "video.mp4"))
    ok, frame = cap.read()
    cap.release()
    assert ok and frame.shape == (32, 64, 3)


def test_video_cli_needs_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        video.main(["--video", "v.mp4", "--style", "s.png"])


def test_diagnostic_fn_matches_jax(pair):
    """(fc, fs, fcs, cs) of one 64^2 pair: every feature map within 1e-4 of
    its largest value, the picture within 0.1 of 0-255 (the pixel bound of
    tests/test_torch_slice.py)."""
    jmodels, params, models = pair
    rng = np.random.default_rng(9)
    c, s = (rng.uniform(0, 255, (1, 64, 64, 3)).astype(np.float32)
            for _ in range(2))
    ref = jax_image.make_diagnostic_fn(jmodels)(params, c, s)
    got = image.make_diagnostic_fn(models)(torch.from_numpy(c),
                                           torch.from_numpy(s))
    feats = [*zip(got[0], ref[0]), *zip(got[1], ref[1]), (got[2], ref[2])]
    assert len(feats) == 2 * len(ref[0]) + 1
    for g, r in feats:
        r = np.asarray(r)
        assert g.shape == r.shape
        rel = np.abs(g.numpy() - r).max() / np.abs(r).max()
        assert rel <= 1e-4, rel
    np.testing.assert_allclose(got[3].numpy(), np.asarray(ref[3]), atol=0.1)


def test_heatmaps_write_the_jax_file_names(pair, tmp_path, capsys):
    """save_feature_heatmaps on the same features writes the JAX function's
    files; the image CLI's --heatmaps writes them for the full model (3
    layers, 8 heads) beside its picture."""
    jmodels, params, models = pair
    rng = np.random.default_rng(10)
    c, s = (rng.uniform(0, 255, (1, 32, 32, 3)).astype(np.float32)
            for _ in range(2))
    fc, fs, fcs, _ = image.make_diagnostic_fn(models)(torch.from_numpy(c),
                                                      torch.from_numpy(s))
    image.save_feature_heatmaps(fc, fs, fcs, str(tmp_path / "port"),
                                num_heads=TINY["num_heads"])
    jax_image.save_feature_heatmaps(
        [f.numpy() for f in fc], [f.numpy() for f in fs], fcs.numpy(),
        str(tmp_path / "jax"), num_heads=TINY["num_heads"])
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax")) and len(names) == 18

    from PIL import Image

    for name in ("c.png", "s.png"):
        Image.fromarray(rng.integers(0, 255, (40, 40, 3), np.uint8)).save(
            tmp_path / name)
    image.main(["--content", str(tmp_path / "c.png"), "--style",
                str(tmp_path / "s.png"), "--out", str(tmp_path / "o.png"),
                "--size", "32", "32", "--heatmaps", str(tmp_path / "hm"),
                "--device", "cpu"])
    assert "heatmaps -> " in capsys.readouterr().out
    want = {f"attention_{t}_{i}.png" for t in "cs" for i in range(3)} | {
        f"{t}_head_{h}.png" for t in ("fcs", "fc", "fs")
        for h in range(1, 9)}
    assert set(os.listdir(tmp_path / "hm")) == want
    assert (tmp_path / "o.png").exists()
