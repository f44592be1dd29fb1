"""The port's image metrics (mhada_tpu_torch/evals) against the JAX
package's on the CPU.

One random state_dict per backbone, made from a seed by the plain-torch
restatements of torchvision's VGG16, VGG19 and Inception-v3
(tests/torch_backbones.py via tests/eval_assets.py), is saved as a
``.pth`` and read by both packages: the JAX one through ``load_pth`` and
its importers, the port through its strict loads.  Images are seeded: a
smooth picture with noise and its noisy neighbour, so SSIM and LPIPS sit
well away from 0.

Bounds: histogram metrics equal; SSIM and the gram loss rel 1e-5; LPIPS
rel 1e-4; the four Inception taps 1e-4 of each tap's largest value; SIFID
at 64 and 192 dims rel 1e-3; the LPIPS trainer as its test states; the
CLI's nine modes print the JAX CLI's labels and values (rel 1e-4).  The
sweeps are in tests/test_torch_eval_sweeps.py.
"""


import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from PIL import Image

from mhada_tpu.evals import metrics as jax_metrics
from mhada_tpu.evals import sifid as jax_sifid
from mhada_tpu.evals.inception import InceptionV3Features as JaxInception
from mhada_tpu.evals.inception import import_inception
from mhada_tpu.evals.lpips import (import_lin_heads, import_vgg16,
                                   make_lpips_fn)
from mhada_tpu.evals.lpips_trainer import make_lpips_trainer
from mhada_tpu.interop import load_pth
from mhada_tpu_torch.evals import cli, exps_image, metrics
from mhada_tpu_torch.evals import sifid
from mhada_tpu_torch.evals.inception import load_inception
from mhada_tpu_torch.evals.lpips import LPIPS, VGG16Features, load_lpips
from mhada_tpu_torch.evals.lpips_trainer import LPIPSTrainer
from tests.eval_assets import backbone_weights, picture

# Six test workers share the CPU: cap torch's intra-op threads.
torch.set_num_threads(2)

HW = (80, 96)   # inception_v3 needs >= 75 pixels a side


def rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """Two PNGs: a picture and the same picture with more noise."""
    d = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(0)
    a = picture(rng, HW)
    b = np.clip(a + rng.normal(0, 30, a.shape), 0, 255).astype(np.uint8)
    pa, pb = str(d / "a.png"), str(d / "b.png")
    Image.fromarray(a).save(pa)
    Image.fromarray(b).save(pb)
    return pa, pb, a, b


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    return backbone_weights(str(tmp_path_factory.mktemp("weights")))


@pytest.mark.parametrize("name", ["kl_divergence", "nth_order_moment",
                                  "uniformity", "average_entropy"])
def test_histogram_metrics_equal_jax(images, name):
    pa, pb, a, _ = images
    args = (pa, pb) if name == "kl_divergence" else (pa,)
    assert getattr(metrics, name)(*args) == getattr(jax_metrics, name)(*args)
    assert np.array_equal(metrics.compute_histogram(a, 1),
                          jax_metrics.compute_histogram(a, 1))


def test_ssim_matches_jax(images):
    pa, pb, _, _ = images
    got, ref = metrics.ssim(pa, pb, "cpu"), jax_metrics.ssim(pa, pb)
    assert 0.05 < ref < 0.99 and rel(got, ref) <= 1e-5, (got, ref)
    assert rel(metrics.ssim(pa, pa, "cpu"), 1.0) <= 1e-5


def test_gram_loss_matches_jax(images, weights):
    from mhada_tpu.interop import import_vgg19
    from mhada_tpu.models import VGG19Features as JaxVGG19

    pa, pb, _, _ = images
    params = import_vgg19(load_pth(weights["vgg19"]))
    jvgg = JaxVGG19()
    ref = jax_metrics.gram_loss(
        pa, pb, jax.jit(lambda x: jvgg.apply({"params": params}, x)))
    vgg = metrics.load_vgg19_features(weights["vgg19"], "cpu")
    got = metrics.gram_loss(pa, pb, vgg, "cpu")
    assert ref > 0 and rel(got, ref) <= 1e-5, (got, ref)
    assert metrics.gram_loss(pa, pa, vgg, "cpu") == 0.0


@pytest.mark.parametrize("heads", ["heads", "heads_lins"])
def test_lpips_matches_jax(images, weights, heads):
    """Both head key layouts import_lin_heads accepts; the trunk from a
    torchvision-layout file with its classifier."""
    _, _, a, b = images
    fn = make_lpips_fn(import_vgg16(load_pth(weights["vgg16"])),
                       import_lin_heads(load_pth(weights[heads])))
    x = np.stack([a, b]).astype(np.float32)
    y = np.stack([b, a[::-1]]).astype(np.float32)
    ref = np.asarray(fn(jnp.asarray(x), jnp.asarray(y)))
    model = load_lpips(weights["vgg16"], weights[heads], "cpu")
    got = model(torch.from_numpy(x), torch.from_numpy(np.ascontiguousarray(
        y))).numpy()
    assert ref.min() > 0 and np.abs(got - ref).max() <= 1e-4 * ref.max(), (
        got, ref)


def test_vgg16_trunk_loads_strictly(weights):
    """The torchvision file loads with strict=True over the trunk; a file
    that lacks a trunk weight is refused."""
    sd = torch.load(weights["vgg16"], weights_only=True)
    model = VGG16Features()
    from mhada_tpu_torch.evals.lpips import vgg16_features_state
    model.load_state_dict(vgg16_features_state(sd), strict=True)
    assert set(model.state_dict()) == {k for k in sd
                                       if k.startswith("features.")}
    del sd["features.28.bias"]
    with pytest.raises(RuntimeError, match="features.28.bias"):
        model.load_state_dict(vgg16_features_state(sd), strict=True)
    assert isinstance(LPIPS().net, VGG16Features)


@pytest.fixture(scope="module")
def inception_taps(weights):
    """The four taps of both packages on one seeded 96 x 128 input."""
    x = np.random.default_rng(9).uniform(0, 1, (1, 96, 128, 3)).astype(
        np.float32)
    params = import_inception(load_pth(weights["inception"]))
    ref = JaxInception(last_block=3).apply({"params": params},
                                           jnp.asarray(x))
    model = load_inception(weights["inception"], 3, "cpu")
    got = model(torch.from_numpy(x))
    return [np.asarray(t) for t in ref], [t.numpy() for t in got]


@pytest.mark.parametrize("tap,channels", [(0, 64), (1, 192), (2, 768),
                                          (3, 2048)])
def test_inception_taps_match_jax(inception_taps, tap, channels):
    ref, got = (t[tap] for t in inception_taps)
    assert got.shape == ref.shape and ref.shape[-1] == channels
    scale = np.abs(ref).max()
    assert scale > 0 and np.abs(got - ref).max() <= 1e-4 * scale


@pytest.mark.parametrize("dims", [64, 192])
def test_sifid_matches_jax(images, weights, dims):
    pa, pb, _, _ = images
    params = import_inception(load_pth(weights["inception"]))
    ref = jax_sifid.SIFID(params, dims)(pa, pb)
    got = sifid.SIFID(load_inception(weights["inception"],
                                     sifid.BLOCK_INDEX_BY_DIM[dims], "cpu"),
                      dims)(pa, pb)
    assert ref > 0 and rel(got, ref) <= 1e-3, (got, ref)
    with pytest.raises(ValueError, match="tap"):
        sifid.SIFID(load_inception(weights["inception"], 0, "cpu"), 2048)


def test_frechet_distance_matches_jax():
    """Rank-deficient covariances (the eps retry and the real part), zero
    covariances and the diagonal closed form, as the JAX test pins them."""
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=(2, 8)), rng.normal(size=(2, 8))
    cases = [(a.mean(0), np.cov(a, rowvar=False), b.mean(0),
              np.cov(b, rowvar=False)),
             (np.arange(4.0), np.zeros((4, 4)), np.zeros(4), np.zeros((4, 4))),
             (np.array([1.0, -1.0, 0.5]), np.diag([1.0, 2.0, 3.0]),
              np.zeros(3), np.diag([0.5, 2.0, 4.0]))]
    for case in cases:
        got = sifid.calculate_frechet_distance(*case)
        ref = jax_sifid.calculate_frechet_distance(*case)
        assert np.isfinite(got) and got == pytest.approx(ref, rel=1e-9,
                                                         abs=1e-12)


def test_lpips_trainer_matches_jax(weights):
    """Three steps from the JAX trainer's initial heads and 2AFC weights.
    Each step's loss rel 1e-4 and its 2AFC accuracy equal; the first
    step's gradients rel 1e-4 of each tensor's largest; after the steps the
    distances rel 1e-4 and the weights 1e-3 of each tensor's largest: Adam
    divides by sqrt(v) + 1e-8, so a head whose gradient is near 1e-8 (a
    channel of the 4 x 4 or 2 x 2 taps that barely differs between the
    images) moves by lr * g / (|g| + 1e-8), where float32 rounding of g
    shows (3.6e-7 of 2.3e-3 measured on the CPU, the heads' steps 1e-4)."""
    from mhada_tpu.evals.lpips_trainer import dist2logit

    vgg_params = import_vgg16(load_pth(weights["vgg16"]))
    init_state, train_step, distance = make_lpips_trainer(vgg_params)
    state = init_state(jax.random.PRNGKey(1))
    trunk = VGG16Features()
    from mhada_tpu_torch.evals.lpips import vgg16_features_state
    trunk.load_state_dict(vgg16_features_state(
        torch.load(weights["vgg16"], weights_only=True)), strict=True)
    trainer = LPIPSTrainer(trunk)
    logits = [getattr(trainer.logit, f"l{i}") for i in (1, 2, 3)]
    with torch.no_grad():
        for lin, name in zip(logits, ("l1", "l2", "l3")):
            lin.weight.copy_(torch.tensor(np.array(
                state.logit_params[name]["w"]).T))
            lin.bias.copy_(torch.tensor(np.array(
                state.logit_params[name]["b"])))
    rng = np.random.default_rng(4)
    ref = rng.uniform(0, 255, (2, 32, 32, 3)).astype(np.float32)
    p0 = np.clip(ref + 80 * rng.standard_normal(ref.shape), 0, 255).astype(
        np.float32)
    p1 = np.clip(ref + 5 * rng.standard_normal(ref.shape), 0, 255).astype(
        np.float32)
    judge = np.array([1.0, 0.3], np.float32)
    jargs = [jnp.asarray(t) for t in (ref, p0, p1, judge)]
    targs = [torch.from_numpy(t) for t in (ref, p0, p1, judge)]

    def jax_loss(trainable, r, a, b, t):   # the JAX step's loss (:96)
        lins, logit = trainable
        prob = dist2logit(logit, distance(lins, r, a), distance(lins, r, b))
        return jnp.mean(-(t * jnp.log(prob + 1e-12)
                          + (1 - t) * jnp.log(1 - prob + 1e-12)))

    jgrads = jax.jit(jax.grad(jax_loss))(
        (state.lin_weights, state.logit_params), *jargs)

    def close(got, want, bound):
        want = np.asarray(want)
        got = got.detach().numpy()
        assert got.shape == want.shape and np.abs(got - want).max() <= (
            bound * np.abs(want).max()), (np.abs(got - want).max(),
                                          np.abs(want).max())

    for step in range(3):
        state, m = train_step(state, *jargs)
        got = trainer.step(*targs)
        assert rel(got["loss"], float(m["loss"])) <= 1e-4
        assert got["acc"] == float(m["acc"])
        if step == 0:
            for w, g in zip(trainer.lins, jgrads[0]):
                close(w.grad, g, 1e-4)
            for lin, name in zip(logits, ("l1", "l2", "l3")):
                close(lin.weight.grad, np.asarray(jgrads[1][name]["w"]).T,
                      1e-4)
                close(lin.bias.grad, jgrads[1][name]["b"], 1e-4)
    for w, jw in zip(trainer.lins, state.lin_weights):
        assert w.min() >= 0
        close(w, jw, 1e-3)
    for lin, name in zip(logits, ("l1", "l2", "l3")):
        close(lin.weight, np.asarray(state.logit_params[name]["w"]).T, 1e-3)
    d = trainer.distance(targs[0], targs[2])
    jd = np.asarray(jax.jit(distance)(state.lin_weights, jargs[0], jargs[2]))
    assert d.shape == (2,) and np.abs(d.numpy() - jd).max() <= 1e-4 * jd.max()


CLI_MODES = [("lpips", "Distance:"), ("ssim", "SSIM:"), ("kl", "KL:"),
             ("gram", "Gram Loss:"), ("moment", "Nth Order Moment:"),
             ("uni", "Uniformity:"), ("entropy", "Average Entropy:"),
             ("sifid", "SIFID:"), ("debug_sifid", "SIFID with 64D:")]


@pytest.mark.parametrize("mode,label", CLI_MODES)
def test_cli_modes_match_jax(images, weights, mode, label, capsys,
                             monkeypatch, tmp_path):
    """Each of the nine modes prints the JAX CLI's label and value.  The
    SIFID modes run on a 160^2 pair (a 3 x 3 grid of 2048-d activations);
    a 2048^2 sqrtm takes tens of seconds here, so their Fréchet distance is
    replaced by one that records the covariances' sizes, and the labels
    are held to the JAX CLI's (its values are held above, at 64 and 192
    dims)."""
    from mhada_tpu.evals import cli as jax_cli

    pa, pb, _, _ = images
    argv = ["--vgg16", weights["vgg16"], "--lpips-heads", weights["heads"],
            "--vgg19", weights["vgg19"], "--inception", weights["inception"],
            "--device", "cpu"]
    if "sifid" in mode:
        rng = np.random.default_rng(8)
        pa, pb = str(tmp_path / "a.png"), str(tmp_path / "b.png")
        for p in (pa, pb):
            Image.fromarray(picture(rng, (160, 160), 20)).save(p)
        sizes = []
        monkeypatch.setattr(sifid, "calculate_frechet_distance",
                            lambda m1, s1, m2, s2: sizes.append(
                                s1.shape[0]) or 0.0)
        cli.main(["-m", mode, "-p0", pa, "-p1", pb, *argv])
        lines = capsys.readouterr().out.splitlines()
        dims = [64, 192, 768, 2048] if mode == "debug_sifid" else [2048]
        assert sizes == dims
        assert lines == ([f"SIFID with {d}D: 0.000000" for d in dims]
                         if mode == "debug_sifid" else ["SIFID: 0.000000"])
        return
    jax_cli.main(["-m", mode, "-p0", pa, "-p1", pb, *argv[:-2]])
    ref = capsys.readouterr().out
    cli.main(["-m", mode, "-p0", pa, "-p1", pb, *argv])
    got = capsys.readouterr().out
    assert label in got and len(got.splitlines()) == 1
    (g,), (r,) = got.splitlines(), ref.splitlines()
    assert g.split(":")[0] == r.split(":")[0]
    gv, rv = float(g.split(":")[1]), float(r.split(":")[1])
    assert abs(gv - rv) <= 1e-4 * max(abs(rv), 1e-2), (g, r)


def test_evals_need_a_card_unless_told(images, monkeypatch, tmp_path):
    pa, pb, _, _ = images
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        metrics.ssim(pa, pb)
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["-m", "ssim", "-p0", pa, "-p1", pb])
    with pytest.raises(RuntimeError, match="--device cpu"):
        exps_image.main(["--assets", str(tmp_path)])
    with pytest.raises(SystemExit):   # a missing weight flag
        cli.main(["-m", "gram", "-p0", pa, "-p1", pb, "--device", "cpu"])
