"""The port's analysis tools against the JAX package's, CPU, at
ModelConfig(hidden_dim=64, mlp_dim=128, num_heads=4) and 32^2 images:
parameter counts equal, FLOPs within [0.95, 1.0] of XLA's cost analysis
(FlopCounterMode counts convolutions and products, not the elementwise
work XLA also counts), a counted kernel launch refused; the Adam
inversions (ViT, MHAda, VGG) from JAX's own initial draw, the feature
loss and its image gradient; the progressive LBFGS reconstruction held to
the JAX test's contract; ``normalize_per_channel``, the histogram plot,
the CLI in every mode with random weights, and ``AdaFormer.transform``."""

import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from PIL import Image

from mhada_tpu.analysis import counts as jax_counts
from mhada_tpu.analysis import visualize as jax_vis
from mhada_tpu.config import ModelConfig as JaxModelConfig
from mhada_tpu.models import VGG19Features as JaxVGG19Features
from mhada_tpu.train.train_image import build_models as jax_build_models
from mhada_tpu_torch import _build
from mhada_tpu_torch.analysis import (count_flops, count_params,
                                      count_params_mb, hist, visualize)
from mhada_tpu_torch.analysis.counts import report
from mhada_tpu_torch.config import ModelConfig
from mhada_tpu_torch.interop import (jax_params_to_state_dicts,
                                     params_from_jax, state_dict_to_jax)
from mhada_tpu_torch.models import VGG19Features, build_models

# Six test workers share the CPU: cap torch's intra-op threads.
torch.set_num_threads(2)

TINY = dict(hidden_dim=64, mlp_dim=128, num_heads=4)
SIZE = 32
# Five Adam steps from the same image on the same weights, 0-255 scale
# (2.9e-4 measured for the ViT).
INVERT_ATOL = 1e-2
NAMES = ["relu1_1", "relu1_1_relu2_1", "relu1_1_relu2_1_relu3_1",
         "relu1_1_relu2_1_relu3_1_relu4_1",
         "relu1_1_relu2_1_relu3_1_relu4_1_relu5_1"]


@pytest.fixture(scope="module")
def nets():
    """(JAX models, JAX params, the port's training build on those params,
    frozen), the VGG pair, and two images.  The weights are the port's
    seeded init carried to JAX trees (a JAX init runs the forward eagerly
    and takes ~30 s here); ``params_from_jax`` carrying them back must
    give the same state_dicts."""
    jmodels = jax_build_models(JaxModelConfig(**TINY))
    models = build_models(ModelConfig(**TINY), "cpu", for_training=True)
    params = {k: state_dict_to_jax(m.state_dict()) for k, m in models.items()}
    vgg = VGG19Features()
    vgg.reset_parameters(torch.Generator().manual_seed(1))
    vgg_params = state_dict_to_jax(vgg.state_dict())
    for name, sd in jax_params_to_state_dicts(params).items():
        for k, v in models[name].state_dict().items():
            assert torch.equal(sd[k], v), k
    for k, v in params_from_jax(vgg_params).items():
        assert torch.equal(vgg.state_dict()[k], v), k
    for m in (*models.values(), vgg):
        m.requires_grad_(False)
    rng = np.random.default_rng(5)
    imgs = [rng.uniform(0, 255, (1, SIZE, SIZE, 3)).astype(np.float32)
            for _ in range(2)]
    return jmodels, params, models, vgg_params, vgg, imgs


@pytest.fixture(scope="module")
def jax_fns(nets):
    """The JAX feature functions of each mode on (1, H, W, 3) images,
    jitted (eager flax applies dispatch op by op and take seconds here)."""
    jmodels, params, _, vgg_params, _, (_, style) = nets
    vit_c = jax.jit(
        lambda x: jmodels["vit_c"].apply({"params": params["vit_c"]}, x))
    fs = jmodels["vit_s"].apply({"params": params["vit_s"]},
                                jnp.asarray(style))

    @jax.jit
    def fcs(x):
        return jmodels["adaFormer"].apply({"params": params["adaFormer"]},
                                          vit_c(x), fs)[0]

    @jax.jit
    def vgg3(x):
        d = JaxVGG19Features().apply({"params": vgg_params}, x)
        return [d[f"relu{i}_1"] for i in (1, 2, 3)]

    return {"vit": vit_c, "mhada": lambda x: [fcs(x)], "fcs": fcs,
            "vgg": vgg3}


def _port_fns(models, vgg, style):
    with torch.no_grad():
        fs = models["vit_s"](style)

    def fcs(x):
        return models["adaFormer"].transform(models["vit_c"](x), fs)

    def vgg3(x):
        d = vgg(x)
        return [d[f"relu{i}_1"] for i in (1, 2, 3)]

    return {"vit": models["vit_c"], "mhada": lambda x: [fcs(x)],
            "vgg": vgg3}


@pytest.mark.parametrize("name", ["vit_c", "vit_s", "adaFormer"])
def test_counts_match_jax(nets, name):
    """Parameters equal; FLOPs 0.95-1.0 of XLA's (0.969-0.998 measured);
    the MB at 4 bytes a parameter."""
    jmodels, params, models, *_ = nets
    x = np.zeros((1, SIZE, SIZE, 3), np.float32)
    f = np.zeros((1, SIZE // 8, SIZE // 8, TINY["hidden_dim"]), np.float32)
    inp = (x,) if name != "adaFormer" else ([f] * 3, [f] * 3)
    jfl = jax_counts.count_flops(
        lambda *a: jmodels[name].apply({"params": params[name]}, *a),
        *jax.tree_util.tree_map(jnp.asarray, inp))
    fl = count_flops(models[name], *jax.tree_util.tree_map(
        torch.from_numpy, inp))
    assert count_params(models[name]) == jax_counts.count_params(params[name])
    assert count_params(models[name].state_dict()) == count_params(
        models[name])
    assert count_params_mb(models[name]) == pytest.approx(
        jax_counts.count_params_mb(params[name]), rel=1e-12)
    ratio = fl["flops"] / jfl["flops"]
    assert 0.95 <= ratio <= 1.0, (fl, jfl)
    assert fl["gflops"] == fl["flops"] / 1e9 and np.isnan(fl["bytes_accessed"])


def test_count_flops_refuses_a_kernel_launch(nets):
    """A launch counted during the count raises: the kernel's products
    would be missing.  Under no_grad with trainable parameters the count
    still works (it turns grad mode on)."""
    models = build_models(ModelConfig(**TINY), "cpu")
    x = torch.zeros(1, SIZE, SIZE, 3)
    with torch.no_grad():
        assert count_flops(models["vit_c"], x)["flops"] > 0

    def launches(x):
        _build.LAUNCHES["mhada_attention_fwd"] += 1
        return models["vit_c"](x)

    try:
        with pytest.raises(RuntimeError, match="plain build"):
            count_flops(launches, x)
    finally:
        _build.LAUNCHES["mhada_attention_fwd"] -= 1


def test_report_counts_the_full_width_plain_build():
    """``report`` at a small image: every network's parameters equal the
    JAX tree's at full width (its shapes from jax.eval_shape)."""
    jmodels = jax_build_models(JaxModelConfig())
    x = jnp.zeros((1, 64, 64, 3))
    f = [jnp.zeros((1, 8, 8, 512))] * 3
    shapes = {
        "vit_c": jax.eval_shape(jmodels["vit_c"].init,
                                jax.random.PRNGKey(0), x),
        "vit_s": jax.eval_shape(jmodels["vit_s"].init,
                                jax.random.PRNGKey(0), x),
        "adaFormer": jax.eval_shape(jmodels["adaFormer"].init,
                                    jax.random.PRNGKey(0), f, f)}
    out = report((16, 16), device="cpu")
    assert sorted(out) == sorted(shapes)
    for name, rec in out.items():
        assert rec["params"] == jax_counts.count_params(
            shapes[name]["params"]), name
        assert rec["params_mb"] == round(rec["params"] * 4 / 2 ** 20, 3)
        assert rec["gflops"] > 0


@pytest.mark.parametrize("mode", ["vit", "mhada", "vgg"])
def test_inversion_matches_jax(nets, jax_fns, mode):
    """Five Adam steps from JAX's own draw, jax.random.uniform(PRNGKey(0),
    0, 255), passed to the port as img0: within 1e-2 on 0-255."""
    _, _, models, vgg_params, vgg, (target, style) = nets
    jt, js = jnp.asarray(target), jnp.asarray(style)
    tt, ts = torch.from_numpy(target), torch.from_numpy(style)
    img0 = np.asarray(jax.random.uniform(jax.random.PRNGKey(0), target.shape,
                                         jnp.float32, 0.0, 255.0))
    jf = jax_fns[mode]
    pf = _port_fns(models, vgg, ts)[mode]
    if mode == "vit":
        ref = jax_vis.invert_vit_features(jf, jt, lr=0.5, iters=5)
        got, losses = visualize.invert_vit_features(
            pf, tt, lr=0.5, iters=5, img0=img0, log_every=0,
            return_losses=True)
    elif mode == "mhada":
        ref = jax_vis.invert_mhada_features(jax_fns["fcs"], jt, js,
                                            lr=0.5, iters=5)
        got, losses = visualize.invert_mhada_features(
            lambda x: pf(x)[0], tt, ts, lr=0.5, iters=5, img0=img0,
            log_every=0, return_losses=True)
    else:
        ref = jax_vis.invert_vgg_features(
            lambda x: JaxVGG19Features().apply({"params": vgg_params}, x),
            jt, 3, iters=5)
        got, losses = visualize.invert_vgg_features(
            vgg, tt, 3, iters=5, img0=img0, log_every=0, return_losses=True)
    assert got.shape == target.shape and len(losses) == 5
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    err = np.abs(got - np.asarray(ref)).max()
    assert err <= INVERT_ATOL, err


@pytest.mark.parametrize("mode", ["vit", "mhada", "vgg"])
def test_feature_loss_and_grad_match_jax(nets, jax_fns, mode):
    """The inversion's loss and its gradient with respect to the image, at
    one fixed image, against jax.value_and_grad: 1e-5 relative (the
    gradient elementwise, against its own largest value)."""
    _, _, models, _, vgg, (target, style) = nets
    img = np.random.default_rng(6).uniform(
        0, 255, target.shape).astype(np.float32)
    jf = jax_fns[mode]
    pf = _port_fns(models, vgg, torch.from_numpy(style))[mode]
    jt = [jax.lax.stop_gradient(f) for f in jf(jnp.asarray(target))]

    def jloss(x):
        return sum(jnp.mean(jnp.square(f - t)) for f, t in zip(jf(x), jt))

    ref_l, ref_g = jax.jit(jax.value_and_grad(jloss))(jnp.asarray(img))
    with torch.no_grad():
        pt = [f.detach() for f in pf(torch.from_numpy(target))]
    x = torch.from_numpy(img).requires_grad_()
    loss = visualize.feature_loss(pf, pt)(x)
    loss.backward()
    assert loss.item() == pytest.approx(float(ref_l), rel=1e-5)
    ref_g = np.asarray(ref_g)
    np.testing.assert_allclose(x.grad.numpy(), ref_g, rtol=1e-5,
                               atol=1e-5 * np.abs(ref_g).max())


def test_progressive_lbfgs_reconstruction(nets):
    """The JAX test's contract (tests/test_drivers.py:220-240): five
    prefixes in order, images in [0, 1], the loss halved within 12 steps;
    and one loss a step.  torch's LBFGS (strong-Wolfe line search) takes
    other steps than optax's zoom search, so the images are not compared
    with JAX's."""
    *_, vgg, _ = nets
    target = torch.from_numpy(np.random.default_rng(7).uniform(
        0, 1, (1, 16, 16, 3)).astype(np.float32))
    results = list(visualize.progressive_vgg_reconstruction(
        lambda x: vgg(x * 255.0), target, iters=12))
    assert [name for name, _, _ in results] == NAMES
    for name, img, losses in results:
        assert img.shape == target.shape
        assert img.min() >= 0.0 and img.max() <= 1.0
        assert len(losses) == 12 and np.isfinite(losses).all()
        assert losses[-1] < losses[0] * 0.5, (name, losses[0], losses[-1])


def test_normalize_per_channel_matches_jax():
    x = np.random.default_rng(8).normal(3, 40, (24, 20, 3)).astype(np.float32)
    got = visualize.normalize_per_channel(torch.from_numpy(x))
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, jax_vis.normalize_per_channel(x))
    np.testing.assert_array_equal(visualize.normalize_per_channel(x), got)


def _png(path, seed, hw=(40, 48)):
    a = np.random.default_rng(seed).integers(0, 256, (*hw, 3), np.uint8)
    Image.fromarray(a).save(path)
    return str(path)


def test_hist_plot(tmp_path):
    paths = [_png(tmp_path / f"h{i}.png", i) for i in range(2)]
    out = hist.plot_bgr_histograms(paths, str(tmp_path / "hist.png"))
    assert os.path.getsize(out) > 0


@pytest.mark.parametrize("mode", ["vit", "mhada", "vgg", "vgg_progressive"])
def test_visualize_cli_cpu(tmp_path, capsys, mode):
    """``visualize.main --device cpu`` with random weights, a few steps."""
    target = _png(tmp_path / "t.png", 9)
    out = str(tmp_path / "out" / "inv.png")
    argv = ["--mode", mode, "--target", target, "--out", out, "--size",
            "32", "32", "--iters", "3", "--log-every", "1", "--device", "cpu"]
    if mode == "mhada":
        argv += ["--style", _png(tmp_path / "s.png", 10)]
    visualize.main(argv)
    text = capsys.readouterr().out
    assert "WARNING: random" in text
    if mode == "vgg_progressive":
        files = sorted(os.listdir(tmp_path / "out"))
        assert files == sorted(f"reconstructed_{n}.jpg" for n in NAMES)
        return
    losses = [float(ln.split("loss")[1]) for ln in text.splitlines()
              if ln.strip().startswith("iter")]
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert np.asarray(Image.open(out)).shape == (32, 32, 3)


def test_transform_is_forwards_first_result(nets):
    models = nets[2]
    rng = np.random.default_rng(11)
    fc, fs = ([torch.from_numpy(rng.standard_normal(
        (1, 4, 4, TINY["hidden_dim"])).astype(np.float32)) for _ in range(3)]
        for _ in range(2))
    with torch.no_grad():
        fcs, _ = models["adaFormer"](fc, fs)
        got = models["adaFormer"].transform(fc, fs)
    assert torch.equal(got, fcs)
