"""The reference's unused model variants in the port against the JAX
package's modules on the same parameters (carried by
``interop.params_from_jax`` into a strict ``load_state_dict``), CPU:
ConvDepthwiseSeparable, ConvTanh, ConvFF, EncoderBlockConvFF,
VisionTransformerMultiScale, AdaAttnSingle and AdaAttnTransformer at small
widths; VGG19Classifier at its fixed full width on numpy weights; the two
importers on reference-format state_dicts against the JAX importers (and
against the reference torch modules where tests/refnet.py finds them);
ImageNet1k over a synthetic tree against the JAX dataset.  The variants
take the plain routes by name, so no kernel wrapper is reached."""

import functools
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from PIL import Image

import refnet
from mhada_tpu.data.coco_wikiart import ImageNet1k as JaxImageNet1k
from mhada_tpu.interop import torch_import as jax_import
from mhada_tpu.models import adaformer as jax_ada
from mhada_tpu.models import decoder as jax_dec
from mhada_tpu.models import vgg19 as jax_vgg
from mhada_tpu.models import vit as jax_vit
from mhada_tpu_torch import interop
from mhada_tpu_torch.data.coco_wikiart import ImageNet1k
from mhada_tpu_torch.models import VisionTransformerMultiScale, adaformer
from mhada_tpu_torch.models import decoder, vgg19, vit

# Six test workers share the CPU: cap torch's intra-op threads.
torch.set_num_threads(2)

# max |port - JAX| <= ATOL x max |JAX| + RTOL x |JAX|, elementwise.
ATOL, RTOL = 1e-5, 1e-4


def _rng(seed):
    return np.random.default_rng(seed)


def _close(got, ref, atol=ATOL, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=atol * np.abs(ref).max())


@functools.lru_cache
def _jitted(module, hw):
    """(init, apply) of a JAX module, jitted once per module and token grid
    (``hw``: ConvFF's static grid, or None)."""
    extra = () if hw is None else (hw,)
    return (jax.jit(lambda *a: module.init(jax.random.PRNGKey(0), *a,
                                           *extra)),
            jax.jit(lambda p, *a: module.apply({"params": p}, *a, *extra)))


def _jax_init(module, *args, hw=None):
    return _jitted(module, hw)[0](*args)["params"]


def _jax_apply(module, p, *args, hw=None):
    return _jitted(module, hw)[1](p, *args)


def _load(module, params):
    """``module`` holding the JAX tree ``params`` (strict), frozen."""
    module.load_state_dict(interop.params_from_jax(params), strict=True)
    return module.requires_grad_(False)


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("c_in,c_out,stride", [(8, 12, 1), (16, 16, 2)])
def test_conv_depthwise_separable(c_in, c_out, stride):
    x = _rng(0).standard_normal((2, 9, 11, c_in)).astype(np.float32)
    jm = jax_dec.ConvDepthwiseSeparable(c_out, stride=stride)
    p = _jax_init(jm, x)
    assert p["dw_kernel"].shape == (3, 3, 1, c_in)
    port = _load(decoder.ConvDepthwiseSeparable(c_in, c_out, stride=stride),
                 p)
    _close(port(*_t(x)), _jax_apply(jm, p, x))


def test_conv_depthwise_separable_init():
    """The depthwise weight and bias are U(+-1/3): fan-in k * k."""
    m = decoder.ConvDepthwiseSeparable(64, 8)
    m.reset_parameters(torch.Generator().manual_seed(0))
    for t in (m.dw_kernel, m.dw_bias):
        assert t.abs().max() <= 1 / 3 and t.abs().max() > 0.3


def test_conv_tanh():
    x = _rng(1).standard_normal((1, 7, 6, 16)).astype(np.float32)
    jm = jax_dec.ConvTanh(5)
    p = _jax_init(jm, x)
    got = _load(decoder.ConvTanh(16, 5), p)(*_t(x))
    assert 0 <= got.min() and got.max() <= 255
    _close(got, _jax_apply(jm, p, x))


def test_conv_ff():
    x = _rng(2).standard_normal((2, 6 * 8, 32)).astype(np.float32)
    jm = jax_vit.ConvFF(64)
    p = _jax_init(jm, x, hw=(6, 8))
    _close(_load(vit.ConvFF(32, 64), p)(_t(x)[0], (6, 8)),
           _jax_apply(jm, p, x, hw=(6, 8)))


@pytest.mark.parametrize("attn_mode", ["spatial", "batch_coupled"])
def test_encoder_block_convff(attn_mode):
    x = _rng(3).standard_normal((2, 6 * 8, 32)).astype(np.float32)
    jm = jax_vit.EncoderBlockConvFF(4, 64, attn_mode=attn_mode)
    p = _jax_init(jm, x, hw=(6, 8))
    port = _load(vit.EncoderBlockConvFF(32, 4, 64, attn_mode), p)
    assert port.attention.backend == "plain"
    _close(port(_t(x)[0], (6, 8)), _jax_apply(jm, p, x, hw=(6, 8)))


@pytest.mark.parametrize("attn_mode", ["spatial", "batch_coupled"])
def test_vit_multiscale(attn_mode):
    """Default widths (heads of 32 in the first stage), B = 2 at 64^2, as
    tests/test_model_parity.py shapes it; every attention plain."""
    x = _rng(4).uniform(0, 255, (2, 64, 64, 3)).astype(np.float32)
    jm = jax_vit.VisionTransformerMultiScale(attn_mode=attn_mode)
    p = _jax_init(jm, x)
    port = _load(VisionTransformerMultiScale(attn_mode=attn_mode), p)
    assert {m.backend for m in port.modules() if hasattr(m, "backend")} \
        == {"plain"}
    feats, ref = port(*_t(x)), _jax_apply(jm, p, x)
    assert [f.shape[1:] for f in feats] == [(16, 16, 256), (8, 8, 512),
                                            (4, 4, 512)]
    for got, r in zip(feats, ref):
        _close(got, r)


@pytest.mark.parametrize("activation", ["softmax", "cosine"])
def test_adaattn_single(activation):
    rng = _rng(5)
    fc, fcs = (rng.standard_normal((2, 20, 32)).astype(np.float32)
               for _ in range(2))
    fs = rng.standard_normal((2, 12, 32)).astype(np.float32)
    jm = jax_ada.AdaAttnSingle(activation)
    p = _jax_init(jm, fc, fs, fcs)
    port = _load(adaformer.AdaAttnSingle(32, activation), p)
    _close(port(*_t(fc, fs, fcs)), _jax_apply(jm, p, fc, fs, fcs))


def test_adaattn_transformer():
    rng = _rng(6)
    fc = [rng.standard_normal((1, 4, 4, 64)).astype(np.float32)
          for _ in range(3)]
    fs = [rng.standard_normal((1, 4, 4, 64)).astype(np.float32)
          for _ in range(3)]
    jm = jax_ada.AdaAttnTransformer()
    p = _jax_init(jm, fc, fs)
    port = _load(adaformer.AdaAttnTransformer(hidden_dim=64), p)
    assert port.decoder.backend == "plain"
    got = port(_t(*fc), _t(*fs))
    assert got.shape == (1, 32, 32, 3)
    _close(got, _jax_apply(jm, p, fc, fs))


@pytest.fixture(scope="module")
def classifier():
    """VGG19Classifier's JAX-layout tree drawn with numpy (He-scaled; a JAX
    init would hold a second copy of fc1's 411 MB), and the port's module
    holding it."""
    rng = _rng(7)

    def draw(*shape, fan_in):
        w = rng.standard_normal(shape, dtype=np.float32)
        w *= np.float32((2.0 / fan_in) ** 0.5)
        return w

    p = {n: {"kernel": draw(3, 3, 512, 512, fan_in=9 * 512),
             "bias": draw(512, fan_in=50.0)}
         for n in ("conv5_2", "conv5_3", "conv5_4")}
    for n, (i, o) in {"fc1": (25088, 4096), "fc2": (4096, 4096),
                      "fc3": (4096, 1000)}.items():
        p[n] = {"kernel": draw(i, o, fan_in=i), "bias": draw(o, fan_in=50.0)}
    port = vgg19.VGG19Classifier()
    return p, _load(port, p)


@pytest.mark.parametrize("hw", [(14, 14), (20, 26)])
def test_vgg19_classifier(classifier, hw):
    """(1, 14, 14, 512) pools to 7 x 7; (1, 20, 26, 512) pools to 10 x 13,
    which the adaptive pool's bins cut unevenly.  Logits to 1e-4 of their
    scale."""
    p, port = classifier
    x = np.abs(_rng(8).standard_normal((1, *hw, 512))).astype(np.float32)
    ref = np.asarray(jax_vgg.VGG19Classifier().apply({"params": p}, x))
    got = port(*_t(x)).numpy()
    assert got.shape == ref.shape == (1, 1000)
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()


def _ref_vit_multiscale_sd(p, num_layers=3):
    """A VisionTransformerMultiScale JAX tree as the reference state_dict."""
    sd = interop.export_vit(p, num_layers)
    for i in range(num_layers - 1):
        sd[f"repatch.{i}.conv_proj.weight"] = np.ascontiguousarray(
            p[f"repatch{i}"]["proj"]["kernel"].transpose(3, 2, 0, 1))
        sd[f"repatch.{i}.conv_proj.bias"] = p[f"repatch{i}"]["proj"]["bias"]
    return {k: np.asarray(v, np.float32) for k, v in sd.items()}


def _ref_adaattn_transformer_sd(p, num_layers=3):
    """An AdaAttnTransformer JAX tree as the reference state_dict."""
    sd = {}
    for j in range(num_layers):
        for name in ("f", "g", "h"):
            sd[f"adaAttNs.{j}.{name}.weight"] = np.ascontiguousarray(
                p[f"ada{j}"][f"{name}_kernel"].T[:, :, None, None])
            sd[f"adaAttNs.{j}.{name}.bias"] = p[f"ada{j}"][f"{name}_bias"]
    for ours, theirs in interop._DECODER_MAP.items():
        conv = p["decoder"][ours]["conv"]
        sd[f"decoder.{theirs}.conv.conv.weight"] = np.ascontiguousarray(
            conv["kernel"].transpose(3, 2, 0, 1))
        sd[f"decoder.{theirs}.conv.conv.bias"] = conv["bias"]
    return {k: np.asarray(v, np.float32) for k, v in sd.items()}


def _same_tree(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _same_tree(a[k], b[k])
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


def test_import_vit_multiscale():
    """A reference-format state_dict: the port's importer gives the JAX
    importer's tree, and the port's module on it the JAX module's
    features; against the reference module too where it is available."""
    x = _rng(9).uniform(0, 255, (2, 32, 32, 3)).astype(np.float32)
    jm = jax_vit.VisionTransformerMultiScale(
        num_heads=4, hidden_dims=(32, 64, 64), mlp_dims=(64, 128, 128),
        attn_mode="batch_coupled")
    sd = _ref_vit_multiscale_sd(jax.tree_util.tree_map(
        np.asarray, _jax_init(jm, x)))
    p = interop.import_vit_multiscale(sd)
    _same_tree(p, jax_import.import_vit_multiscale(sd))
    port = _load(VisionTransformerMultiScale(
        num_heads=4, hidden_dims=(32, 64, 64), mlp_dims=(64, 128, 128),
        attn_mode="batch_coupled"), p)
    feats = port(*_t(x))
    for got, ref in zip(feats, _jax_apply(jm, p, x)):
        _close(got, ref)
    if refnet.available():
        refvit, _, _ = refnet.load()
        torch.manual_seed(8)
        tm = refvit.VisionTransformerMultiScale(pos_embedding=True).eval()
        tsd = {k: v.numpy() for k, v in tm.state_dict().items()}
        port = _load(VisionTransformerMultiScale(attn_mode="batch_coupled"),
                     interop.import_vit_multiscale(tsd))
        x = _rng(10).uniform(0, 255, (2, 64, 64, 3)).astype(np.float32)
        with torch.no_grad():
            ref = tm(torch.from_numpy(x.transpose(0, 3, 1, 2)))
        for got, r in zip(port(*_t(x)), ref):
            _close(got.permute(0, 3, 1, 2), r.numpy(), 5e-4, 1e-3)


def test_import_adaattn_transformer():
    rng = _rng(11)
    fc = [rng.standard_normal((1, 4, 4, 64)).astype(np.float32)
          for _ in range(3)]
    jm = jax_ada.AdaAttnTransformer()
    sd = _ref_adaattn_transformer_sd(jax.tree_util.tree_map(
        np.asarray, _jax_init(jm, fc, fc)))
    p = interop.import_adaattn_transformer(sd)
    _same_tree(p, jax_import.import_adaattn_transformer(sd))
    port = _load(adaformer.AdaAttnTransformer(hidden_dim=64), p)
    _close(port(_t(*fc), _t(*fc)), _jax_apply(jm, p, fc, fc))
    if refnet.available():
        _, refada, _ = refnet.load()
        torch.manual_seed(3)
        tm = refada.AdaAttnTransformer().eval()
        tsd = {k: v.numpy() for k, v in tm.state_dict().items()}
        port = _load(adaformer.AdaAttnTransformer(),
                     interop.import_adaattn_transformer(tsd))
        f = [rng.standard_normal((1, 512, 8, 8)).astype(np.float32)
             for _ in range(3)]
        with torch.no_grad():
            ref = tm(_t(*f), _t(*f)).numpy()
        got = port(*[[t.permute(0, 2, 3, 1) for t in _t(*f)]] * 2)
        _close(got.permute(0, 3, 1, 2), ref, 5e-4, 1e-3)


def _imagenet_tree(root):
    """Two classes of PNGs of assorted sizes under train/ and val/."""
    rng = _rng(12)
    for mode in ("train", "val"):
        for cls, n in (("n02", 2), ("n01", 3)):
            d = os.path.join(root, mode, cls)
            os.makedirs(d)
            for i in range(n):
                hw = tuple(rng.integers(40, 90, 2))
                Image.fromarray(rng.integers(0, 256, (*hw, 3), np.uint8)).save(
                    os.path.join(d, f"{i}.png"))


@pytest.mark.parametrize("mode", ["train", "val"])
def test_imagenet1k(tmp_path, mode):
    """Images bit-equal and one-hot labels equal to the JAX dataset's, with
    the same crops from the same seed."""
    _imagenet_tree(str(tmp_path))
    kw = dict(image_size=(48, 40), path=str(tmp_path), mode=mode, seed=3)
    port, ref = ImageNet1k(**kw), JaxImageNet1k(**kw)
    assert len(port) == len(ref) == 5
    for i in range(len(ref)):
        (img, label), (rimg, rlabel) = port[i], ref[i]
        assert label.dtype == np.float32 and label.shape == (1000,)
        np.testing.assert_array_equal(img, rimg)
        np.testing.assert_array_equal(label, rlabel)
    assert {int(np.argmax(port[i][1])) for i in range(5)} == {0, 1}
    with pytest.raises(ValueError, match="Mode"):
        ImageNet1k(path=str(tmp_path), mode="test")
