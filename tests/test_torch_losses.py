"""The port's VGG19 features, feature down-sampling and training losses
against the JAX package, CPU, on the same weights and feature dicts; the
torchvision VGG19 importer."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from mhada_tpu.models.vgg19 import VGG19Features as JaxVGG19Features
from mhada_tpu.train import losses as JL
from mhada_tpu.utils.features import feature_down_sample as jax_fds
from mhada_tpu_torch.interop import import_vgg19, params_from_jax
from mhada_tpu_torch.models.vgg19 import VGG19Features
from mhada_tpu_torch.train import losses as L
from mhada_tpu_torch.utils.features import feature_down_sample

# Six test workers share the CPU: cap torch's intra-op threads.
torch.set_num_threads(2)

LAYERS = L.LAYERS


@pytest.fixture(scope="module")
def vgg():
    """JAX VGG params and the port's module with them bridged across."""
    x = np.zeros((1, 32, 32, 3), np.float32)
    params = JaxVGG19Features().init(jax.random.PRNGKey(3), x)["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    mod = VGG19Features()
    mod.load_state_dict(params_from_jax(params), strict=True)
    return params, mod


def _feats(rng, b=2, size=32, scale=1.0):
    """A random feature dict at the VGG pyramid's shapes, NHWC float32."""
    chans = (64, 128, 256, 512, 512)
    return {name: (np.abs(rng.standard_normal(
        (b, size >> i, size >> i, c))) * scale).astype(np.float32)
        for i, (name, c) in enumerate(zip(LAYERS, chans))}


def _t(d):
    return {k: torch.from_numpy(v) for k, v in d.items()}


def test_vgg19_features_match_jax(vgg):
    params, mod = vgg
    x = np.random.default_rng(1).uniform(0, 255, (2, 40, 36, 3)).astype(
        np.float32)   # odd pooled sizes: floor-mode pools
    ref = JaxVGG19Features().apply({"params": params}, x)
    with torch.no_grad():
        got = mod(torch.from_numpy(x))
    assert list(got) == LAYERS
    for k in LAYERS:
        r = np.asarray(ref[k])
        assert got[k].shape == r.shape
        np.testing.assert_allclose(got[k].numpy(), r, atol=1e-5 * np.abs(
            r).max(), rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("last", [3, 4, 5])
def test_feature_down_sample_matches_jax(last):
    f = _feats(np.random.default_rng(last))
    ref = np.asarray(jax_fds({k: jnp.asarray(v) for k, v in f.items()}, last))
    got = feature_down_sample(_t(f), last).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


def test_losses_match_jax():
    rng = np.random.default_rng(9)
    fc, fs, fcs, fcc, fss = (_feats(rng) for _ in range(5))
    imgs = [rng.uniform(0, 255, (2, 32, 32, 3)).astype(np.float32)
            for _ in range(4)]
    j = lambda d: {k: jnp.asarray(v) for k, v in d.items()}  # noqa: E731
    pairs = [
        (JL.global_style_loss(j(fcs), j(fs)), L.global_style_loss(
            _t(fcs), _t(fs))),
        (JL.local_feature_loss(j(fc), j(fs), j(fcs)), L.local_feature_loss(
            _t(fc), _t(fs), _t(fcs))),
        (JL.identity_loss_1(*map(jnp.asarray, imgs)), L.identity_loss_1(
            *map(torch.from_numpy, imgs))),
        (JL.identity_loss_2(j(fcc), j(fc), j(fss), j(fs)), L.identity_loss_2(
            _t(fcc), _t(fc), _t(fss), _t(fs))),
    ]
    for ref, got in pairs:
        assert float(got) == pytest.approx(float(ref), rel=2e-5)


def test_import_vgg19_torchvision_keys(vgg):
    """A torchvision-keyed ``features.*`` state_dict (and the reference's
    ``sliceN.*`` naming) -> the same module weights as the JAX bridge."""
    params, mod = vgg
    idx = {"conv1_1": 0, "conv1_2": 2, "conv2_1": 5, "conv2_2": 7,
           "conv3_1": 10, "conv3_2": 12, "conv3_3": 14, "conv3_4": 16,
           "conv4_1": 19, "conv4_2": 21, "conv4_3": 23, "conv4_4": 25,
           "conv5_1": 28}
    tv = {}
    for name, i in idx.items():
        tv[f"features.{i}.weight"] = params[name]["kernel"].transpose(
            3, 2, 0, 1)
        tv[f"features.{i}.bias"] = params[name]["bias"]
    tv["classifier.0.weight"] = np.zeros((4, 4), np.float32)  # ignored
    want = mod.state_dict()
    for sd in (tv, {f"slice1.{k.split('.', 1)[1]}": v
                    for k, v in tv.items() if k.startswith("features")}):
        got = params_from_jax(import_vgg19(sd))
        assert got.keys() == want.keys()
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
