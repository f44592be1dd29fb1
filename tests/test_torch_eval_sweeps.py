"""The port's image sweeps (mhada_tpu_torch/evals/exps_image.py and
exps_image_all.py) against the JAX package's on the CPU, at
ModelConfig(hidden_dim=64, mlp_dim=128, num_heads=4) with one set of
weights (c6 scaled so the pictures are not black), 64^2, 2 pairs, every
backbone on seeded random ``.pth`` files (tests/eval_assets.py): the same
CSV schema and average row, PNGs within 1 uint8 level (the float pictures
agree to ~1e-4, so truncation may split a value on an integer), and the
port's metrics on the JAX run's files within rel 1e-4 of the JAX CSV.
Also ``exps_image.main --device cpu`` at the full ModelConfig."""

import csv
import math
import os

import numpy as np
import pytest
import torch
from PIL import Image

from mhada_tpu.config import ModelConfig as JaxModelConfig
from mhada_tpu.evals import exps_image as jax_exps_image
from mhada_tpu.evals import exps_image_all as jax_exps_image_all
from mhada_tpu.train.train_image import build_models as jax_build_models
from mhada_tpu_torch.config import ModelConfig
from mhada_tpu_torch.evals import exps_image, exps_image_all
from mhada_tpu_torch.interop import state_dict_to_jax
from mhada_tpu_torch.models import build_models
from mhada_tpu_torch.utils.image_io import load_image, save_image
from tests.eval_assets import backbone_weights, save_picture

# Six test workers share the CPU: cap torch's intra-op threads.
torch.set_num_threads(2)

TINY = dict(hidden_dim=64, mlp_dim=128, num_heads=4)
C6_GAIN = 3000.0   # scales the random decoder's output into a picture


def rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    return backbone_weights(str(tmp_path_factory.mktemp("weights")))


@pytest.fixture(scope="module")
def stylizers():
    """The port's models (TINY, spatial, seed 1, c6 scaled) on the CPU and
    the JAX models holding the same weights: the port's state_dicts in the
    JAX layout (the JAX package's own init takes ~25 s here).  Seed 0's
    decoder puts every c6 pre-activation below 0 at this width: a black
    picture."""
    models = build_models(ModelConfig(**TINY), device="cpu",
                          generator=torch.Generator().manual_seed(1))
    c6 = models["adaFormer"].decoder.c6.conv
    with torch.no_grad():
        c6.weight.mul_(C6_GAIN)
        c6.bias.mul_(C6_GAIN)
    params = {k: state_dict_to_jax(m.state_dict()) for k, m in models.items()}
    jmodels = jax_build_models(JaxModelConfig(**TINY))
    return jmodels, params, models


def make_assets(root, pairs, rng):
    """Seeded JPEGs at the pairs' paths (contents/ and styles/)."""
    for path in sorted({p for pair in pairs for p in pair}):
        save_picture(os.path.join(root, path), rng, (72, 88))


def read_csv(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


def assert_pngs_close(a, b):
    x, y = (np.asarray(Image.open(p), np.int64) for p in (a, b))
    assert x.shape == y.shape and np.abs(x - y).max() <= 1 and x.max() > 0


def assert_rows_close(got, ref, bound=1e-4):
    for g, r in zip(got, ref):
        if math.isnan(r):
            assert math.isnan(g)
        else:
            assert rel(g, r) <= bound or abs(g - r) <= 1e-9, (g, r)


def test_exps_image_run_matches_jax(stylizers, weights, tmp_path):
    """Two pairs at 64^2 with every backbone (SIFID at 64 dims)."""
    jmodels, params, models = stylizers
    pairs = exps_image.CONTENT_STYLE_PAIR[:2]
    assert pairs == jax_exps_image.CONTENT_STYLE_PAIR[:2]
    assert exps_image.FIELDNAMES == jax_exps_image.FIELDNAMES
    make_assets(str(tmp_path / "assets"), pairs, np.random.default_rng(1))
    w = weights
    jsuite = jax_exps_image.MetricSuite(w["vgg19"], w["vgg16"], w["heads"],
                                        w["inception"], sifid_dims=64)
    suite = exps_image.MetricSuite(w["vgg19"], w["vgg16"], w["heads"],
                                   w["inception"], sifid_dims=64,
                                   device="cpu")
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_exps_image.run(params, jmodels, jsuite, str(tmp_path / "assets"),
                       jdir, pairs=pairs, image_size=(64, 64))
    rows = exps_image.run(models, suite, str(tmp_path / "assets"), pdir,
                          pairs=pairs, image_size=(64, 64))
    jhead, jrows = read_csv(os.path.join(jdir, "results.csv"))
    head, prows = read_csv(os.path.join(pdir, "results.csv"))
    assert head == jhead == exps_image.FIELDNAMES and len(prows) == 3
    assert [r[:2] for r in prows] == [r[:2] for r in jrows]
    avg = np.mean([[float(v) for v in r[2:]] for r in prows[:2]], axis=0)
    assert np.allclose([float(v) for v in prows[2][2:]], avg, rtol=1e-12)
    for i, row in enumerate(rows):
        d = (jdir, pdir)
        for name in ("content.png", "style.png", "stylized.png"):
            assert_pngs_close(*(os.path.join(x, str(i + 1), name)
                                for x in d))
        # the port's metrics on the JAX run's files against the JAX CSV
        files = [os.path.join(jdir, str(i + 1), n) for n in (
            "stylized.png", "content.png", "style.png")]
        got = suite.evaluate_pair(*files)
        assert list(got) == exps_image.FIELDNAMES[2:]
        assert all(np.isfinite(v) for v in row.values()
                   if not isinstance(v, str))
        assert_rows_close(list(got.values()),
                          [float(v) for v in jrows[i][2:]])


def test_exps_image_all_run_matches_jax(stylizers, weights, tmp_path):
    """A 2 x 1 grid at 64^2: the style encoded once, 9 metrics a pair."""
    jmodels, params, models = stylizers
    rng = np.random.default_rng(2)
    paths = []
    for name in ("c0.png", "c1.png", "s0.png"):
        paths.append(str(tmp_path / name))
        save_picture(paths[-1], rng, (70, 90))
    w = weights
    jsuite = jax_exps_image.MetricSuite(w["vgg19"], w["vgg16"], w["heads"])
    suite = exps_image.MetricSuite(w["vgg19"], w["vgg16"], w["heads"],
                                   device="cpu")
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_exps_image_all.run(params, jmodels, jsuite, paths[:2], paths[2:],
                           jdir, image_size=(64, 64))
    exps_image_all.run(models, suite, paths[:2], paths[2:], pdir,
                       image_size=(64, 64))
    jhead, jrows = read_csv(os.path.join(jdir, "results_all.csv"))
    head, prows = read_csv(os.path.join(pdir, "results_all.csv"))
    assert head == jhead == exps_image_all.FIELDNAMES and len(prows) == 3
    assert [r[:2] for r in prows] == [r[:2] for r in jrows]
    for i in range(2):
        name = f"content_{i}_style_0.jpg"
        assert_pngs_close(os.path.join(jdir, name), os.path.join(pdir, name))
        assert all(np.isfinite(float(v)) for v in prows[i][2:])
    # the port's grid metrics against the JAX ones on the same files
    zp = os.path.join(jdir, "content_0_style_0.jpg")
    c = tmp_path / "c.png"
    s = tmp_path / "s.png"
    save_image(str(c), load_image(paths[0], (64, 64)))
    save_image(str(s), load_image(paths[2], (64, 64)))
    got = exps_image_all.evaluate_grid_pair(suite, zp, str(c), str(s))
    ref = jax_exps_image_all.evaluate_grid_pair(jsuite, zp, str(c), str(s))
    assert list(got) == list(ref)
    assert_rows_close(list(got.values()), list(ref.values()))


def test_exps_image_main_on_cpu(tmp_path, capsys):
    """main at the full ModelConfig with random weights over the six
    reference file names at 64^2, no backbones: 7 rows, the backbone
    columns NaN, the others finite."""
    make_assets(str(tmp_path / "assets"), exps_image.CONTENT_STYLE_PAIR,
                np.random.default_rng(6))
    out = tmp_path / "results"
    exps_image.main(["--assets", str(tmp_path / "assets"), "--results",
                     str(out), "--size", "64", "64", "--device", "cpu"])
    assert "(6 pairs + average)" in capsys.readouterr().out
    head, rows = read_csv(str(out / "results.csv"))
    assert head == exps_image.FIELDNAMES and len(rows) == 7
    nan_cols = {"lpips_content", "sifid_content", "lpips_style",
                "sifid_style", "gram"}
    for row in rows:
        for k, v in zip(head[2:], row[2:]):
            assert math.isnan(float(v)) == (k in nan_cols), (k, v)
    assert sorted(os.listdir(out / "1")) == ["content.png", "style.png",
                                             "stylized.png"]
