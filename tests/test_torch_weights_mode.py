"""The port's own trained weights are read back with the attention mode
they were trained with: ``run_image`` writes a sidecar beside the AdaFormer
``.pth`` and the inference CLIs' ``models_from_args`` takes the mode from
it, while a reference ``.pth`` triple (no sidecar) keeps the batch-coupled
mode its weights need, and ``--attn-mode`` still wins."""

import argparse
import json

import numpy as np
import torch
from PIL import Image

from mhada_tpu_torch.config import ModelConfig
from mhada_tpu_torch.infer import image
from mhada_tpu_torch.interop import load_params, load_pth_params
from mhada_tpu_torch.models import build_models
from mhada_tpu_torch.train import run_image

SIZE = 32


def _pngs(folder, n, rng):
    folder.mkdir()
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (40, 48, 3), np.uint8)).save(
            folder / f"{i}.png")


def _args(triple, *extra):
    ap = argparse.ArgumentParser()
    image.add_model_args(ap)
    args = ap.parse_args(["--ada", triple[0], "--vitc", triple[1], "--vits",
                          triple[2], "--device", "cpu", *extra])
    return ap, args


def _modes(models):
    return {blk.attn_mode for net in ("vit_c", "vit_s")
            for blk in models[net].children() if hasattr(blk, "attn_mode")}


def test_own_weights_infer_with_their_attention_mode(tmp_path):
    rng = np.random.default_rng(0)
    for d in ("coco", "wikiart"):
        _pngs(tmp_path / d, 2, rng)
    run_image.main(["--coco", str(tmp_path / "coco"), "--wikiart",
                    str(tmp_path / "wikiart"), "--models-dir",
                    str(tmp_path / "models"), "--batch-size", "2",
                    "--image-size", str(SIZE), str(SIZE), "--device", "cpu",
                    "--seed", "0", "--epochs", "1", "--steps-per-epoch", "1"])
    triple = [str(tmp_path / "models" / f"{n}.pth")
              for n in ("AdaFormer", "ViT_C", "ViT_S")]
    with open(triple[0] + ".json") as f:
        assert json.load(f) == {"attn_mode": "spatial",
                                "writer": "mhada_tpu_torch"}

    ap, args = _args(triple)
    models = image.models_from_args(ap, args)
    assert _modes(models) == {"spatial"}
    content, style = (rng.uniform(0, 255, (SIZE, SIZE, 3)).astype(np.float32)
                      for _ in range(2))
    got = image.stylize_image(models, content, style)
    weights = load_pth_params(*triple)
    for mode, same in (("spatial", True), ("batch_coupled", False)):
        ref = build_models(ModelConfig(attn_mode=mode), "cpu")
        load_params(ref, weights)
        want = image.stylize_image(ref, content, style)
        assert np.array_equal(got, want) == same, mode

    # the CLI itself on these weights, with no --attn-mode
    for name, a in (("c.png", content), ("s.png", style)):
        Image.fromarray(a.astype(np.uint8)).save(tmp_path / name)
    image.main(["--content", str(tmp_path / "c.png"), "--style",
                str(tmp_path / "s.png"), "--out", str(tmp_path / "out.png"),
                "--size", str(SIZE), str(SIZE), "--ada", triple[0], "--vitc",
                triple[1], "--vits", triple[2], "--device", "cpu"])
    assert Image.open(tmp_path / "out.png").size == (SIZE, SIZE)

    # a reference-style triple: the same files without the sidecar
    (tmp_path / "models" / "AdaFormer.pth.json").unlink()
    assert image.default_attn_mode(triple[0]) == "batch_coupled"
    assert _modes(image.models_from_args(*_args(triple))) == {
        "batch_coupled"}
    assert _modes(image.models_from_args(
        *_args(triple, "--attn-mode", "spatial"))) == {"spatial"}
    assert image.default_attn_mode(None) == "spatial"
