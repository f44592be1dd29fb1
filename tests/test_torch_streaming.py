"""The port's streaming path (style K/V cached) against the JAX package, CPU:
K3's plain version against the Pallas kernel in interpret mode, the cached
K/V, the with-K/V and with-features forwards, the latency harness, the
contents x styles grid, and the CLIs' device rule."""

import json

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from mhada_tpu.config import ModelConfig as JaxModelConfig
from mhada_tpu.infer import image as jax_image
from mhada_tpu.ops.mhada_pallas import \
    mhada_fused_prologue as jax_fused_prologue
from mhada_tpu.train.train_image import build_models as jax_build_models
from mhada_tpu_torch.config import ModelConfig
from mhada_tpu_torch.infer import image, image_all, timing
from mhada_tpu_torch.interop import jax_params_to_state_dicts, load_params
from mhada_tpu_torch.models import build_models
from mhada_tpu_torch.ops.instance_norm import instance_norm_stats
from mhada_tpu_torch.ops.mhada_prologue import (mhada_fused_prologue,
                                                mhada_fused_prologue_plain)

SMALL = dict(num_layers=2, hidden_dim=128, num_heads=2, mlp_dim=256)
# c6 is conv + ReLU, so this gain scales the random decoder's ~0.04 output
# into a real picture on both sides (as in test_torch_slice.py).
C6_GAIN = 3000.0


@pytest.fixture(scope="module")
def pair():
    """JAX models and params (SMALL, spatial, seed 0) and the port's models
    holding the same weights, on the CPU."""
    jmodels = jax_build_models(JaxModelConfig(**SMALL))
    params = jax.tree_util.tree_map(
        np.array, jax_image.init_inference_params(jmodels,
                                                  jax.random.PRNGKey(0)))
    c6 = params["adaFormer"]["decoder"]["c6"]["conv"]
    c6["kernel"] *= C6_GAIN
    c6["bias"] *= C6_GAIN
    models = build_models(ModelConfig(**SMALL), device="cpu")
    load_params(models, jax_params_to_state_dicts(params))
    return jmodels, params, models


def _images(b=2, size=64, seed=62):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 255, (b, size, size, 3)).astype(np.float32),
            rng.uniform(0, 255, (b, size, size, 3)).astype(np.float32))


def test_prologue_plain_matches_pallas():
    """K3's plain version against mhada_fused_prologue (interpret mode) at
    ragged N = 200, M = 130; k at input scale 0.35 keeps the unscaled
    logits' std near 1.6, where elementwise parity is meaningful (at std
    above ~2 single-ulp rounding flips the softmax's argmax)."""
    rng = np.random.default_rng(43)
    b, n, m, c, h = 2, 200, 130, 128, 2
    fc = (rng.standard_normal((b, n, c)) * 2 + 1).astype(np.float32)
    fcs = (rng.standard_normal((b, n, c)) * 3 - 1).astype(np.float32)
    # the block's own init, U(-1/8, 1/8): q's std is about 0.6
    wf = rng.uniform(-1 / 8, 1 / 8, (h, 64, 64)).astype(np.float32)
    fb = rng.uniform(-1 / 8, 1 / 8, (h, 64)).astype(np.float32)
    k = (rng.standard_normal((b, m, c)) * 0.35).astype(np.float32)
    v = rng.standard_normal((b, m, c)).astype(np.float32)
    t = [torch.from_numpy(a) for a in (fc, fcs, wf, fb, k, v)]
    mc, rc = instance_norm_stats(t[0])
    ms, rs = instance_norm_stats(t[1])
    stats = torch.stack([mc, rc, ms, rs], 1)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jax_fused_prologue(
            *map(jnp.asarray, (fc, fcs, stats.numpy(), wf, fb, k, v))))
    got = mhada_fused_prologue_plain(t[0], t[1], stats, *t[2:]).numpy()
    assert got.shape == ref.shape == (b, n, c)
    np.testing.assert_allclose(got, ref, atol=5e-5, rtol=0)
    # the wrapper takes the plain version for CPU tensors
    np.testing.assert_array_equal(
        mhada_fused_prologue(t[0], t[1], stats, *t[2:]).numpy(), got)


def test_precompute_style_kv_matches_jax(pair):
    jmodels, params, models = pair
    _, s = _images()
    fs_ref = jax_image.make_encode_style_fn(jmodels)(params, jnp.asarray(s))
    ref = jax_image.precompute_style_kv(jmodels, params, fs_ref)
    fs = image.make_encode_style_fn(models)(torch.from_numpy(s))
    got = image.precompute_style_kv(models, fs)
    assert len(got) == len(ref) == 2 * SMALL["num_layers"]
    for (k, v), (rk, rv) in zip(got, ref):
        assert k.shape == rk.shape == (2, 64, 128)
        np.testing.assert_allclose(k.numpy(), np.asarray(rk), atol=2e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(v.numpy(), np.asarray(rv), atol=2e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("cached", ["kv", "fs"])
def test_streaming_matches_jax(pair, cached):
    """Two 64^2 pairs through the with-K/V (K3) and with-features forwards,
    held to the repo's pixel gate (scripts/reference_gate.py:63)."""
    jmodels, params, models = pair
    c, s = _images()
    fs_ref = jax_image.make_encode_style_fn(jmodels)(params, jnp.asarray(s))
    fs = image.make_encode_style_fn(models)(torch.from_numpy(s))
    if cached == "kv":
        kv_ref = jax_image.precompute_style_kv(jmodels, params, fs_ref)
        ref = jax_image.make_stylize_with_kv_fn(jmodels)(
            params, jnp.asarray(c), kv_ref)
        got = image.make_stylize_with_kv_fn(models)(
            torch.from_numpy(c), image.precompute_style_kv(models, fs))
    else:
        ref = jax_image.make_stylize_with_fs_fn(jmodels)(
            params, jnp.asarray(c), fs_ref)
        got = image.make_stylize_with_fs_fn(models)(torch.from_numpy(c), fs)
    ref, got = np.asarray(ref), got.numpy()
    assert got.shape == ref.shape == (2, 64, 64, 3)
    assert ref.max() > 50  # the gain makes a real picture
    assert np.abs(got - ref).max() <= 0.1


def test_timing_measure_cpu(pair):
    out = timing.measure(pair[2], (32, 32), torch.float32, iters=2,
                         warmup=1)
    assert out["device"] == "cpu" and out["clock"] == "host"
    assert out["image_size"] == [32, 32] and out["iters"] == 2
    for key in ("reference_protocol_ms", "steady_state_ms",
                "steady_state_p50_ms", "fps"):
        assert np.isfinite(out[key]) and out[key] > 0, key


def _write_images(folder, n, seed):
    from PIL import Image

    folder.mkdir()
    rng = np.random.default_rng(seed)
    for i in range(n):
        a = rng.uniform(0, 255, (40, 48, 3)).astype(np.uint8)
        Image.fromarray(a).save(folder / f"img{i}.png")
    return sorted(str(p) for p in folder.iterdir())


def test_run_grid_cpu(pair, tmp_path):
    """2 contents x 1 style at 32^2: one output per pair, each the same
    picture as the one-pair path gives (up to JPEG's loss)."""
    from PIL import Image

    models = pair[2]
    contents = _write_images(tmp_path / "c", 2, 1)
    styles = _write_images(tmp_path / "s", 1, 2)
    out = tmp_path / "out"
    image_all.run_grid(models, contents, styles, str(out), (32, 32))
    assert sorted(p.name for p in out.iterdir()) == [
        "content_0_style_0.jpg", "content_1_style_0.jpg"]
    got = np.asarray(Image.open(out / "content_1_style_0.jpg"), np.float32)
    load = image.load_image
    want = image.stylize_image(models, load(contents[1], (32, 32)),
                               load(styles[0], (32, 32)))
    assert got.shape == want.shape == (32, 32, 3)
    assert np.abs(got - want).mean() < 8  # JPEG quality 75


def test_timing_cli_cpu(capsys):
    timing.main(["--size", "32", "32", "--iters", "2", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["clock"] == "host" and out["fps"] > 0


@pytest.mark.parametrize("cli", ["image", "timing", "image_all"])
def test_cli_needs_card_or_device_cpu(cli, monkeypatch, tmp_path):
    """Without --device the CLIs run on the card; with none they raise and
    name the way to the CPU, and never fall back to it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = {"image": (image.main, ["--content", "c.png", "--style", "s.png",
                                   "--out", str(tmp_path / "o.png")]),
            "timing": (timing.main, ["--iters", "1"]),
            "image_all": (image_all.main, ["--contents", str(tmp_path),
                                           "--styles", str(tmp_path),
                                           "--out", str(tmp_path)])}
    main, args = argv[cli]
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(args)


def test_image_all_cli_cpu(tmp_path, capsys):
    """The grid CLI lists both folders' files and writes one output per
    content and style pair."""
    _write_images(tmp_path / "c", 2, 1)
    _write_images(tmp_path / "s", 1, 2)
    out = tmp_path / "out"
    image_all.main(["--contents", str(tmp_path / "c"), "--styles",
                    str(tmp_path / "s"), "--out", str(out), "--size", "32",
                    "32", "--device", "cpu"])
    assert sorted(p.name for p in out.iterdir()) == [
        "content_0_style_0.jpg", "content_1_style_0.jpg"]


def test_conv2d_turns_tf32_off(monkeypatch):
    """A float32 conv computes in float32: cuDNN's TF32 (on by PyTorch's
    default) is off inside the port's conv and restored after it."""
    from mhada_tpu_torch.ops import pad_conv

    seen, conv = [], pad_conv.F.conv2d

    def spy(*args, **kwargs):
        seen.append(torch.backends.cudnn.allow_tf32)
        return conv(*args, **kwargs)

    monkeypatch.setattr(pad_conv.F, "conv2d", spy)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    x, w, b = torch.ones(1, 6, 6, 4), torch.ones(2, 4, 3, 3), torch.zeros(2)
    y = pad_conv.conv2d_reflect(x, w, b)
    assert seen == [False] and torch.backends.cudnn.allow_tf32
    assert y.shape == (1, 6, 6, 2) and torch.all(y == 36)
