"""The port's whole stylization path against the JAX package's, CPU: weights
from JAX params and from reference-format .pth files, the backend switch,
the CLI, and the package's independence from jax."""

import os
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from mhada_tpu.config import ModelConfig as JaxModelConfig
from mhada_tpu.infer.image import init_inference_params
from mhada_tpu.infer.image import make_stylize_fn as jax_make_stylize_fn
from mhada_tpu.interop import export_adaformer, export_vit, save_pth
from mhada_tpu.train.train_image import build_models as jax_build_models
from mhada_tpu_torch.config import ModelConfig, use_kernel
from mhada_tpu_torch.infer.image import main, make_stylize_fn, stylize_image
from mhada_tpu_torch.interop import (jax_params_to_state_dicts, load_params,
                                     load_pth_params)
from mhada_tpu_torch.models import build_models

# Six test workers share the CPU: cap torch's intra-op threads.
torch.set_num_threads(2)

SMALL = dict(num_layers=2, hidden_dim=128, num_heads=2, mlp_dim=256)
# Random decoders output ~0.04 in 0-255 units; c6 is conv + ReLU, so
# scaling its weight and bias scales the picture exactly and makes the
# pixel bound meaningful (the same weights go to both packages).
C6_GAIN = 3000.0


def _jax_params(attn_mode):
    models = jax_build_models(JaxModelConfig(attn_mode=attn_mode, **SMALL))
    params = jax.tree_util.tree_map(
        np.array, init_inference_params(models, jax.random.PRNGKey(0)))
    c6 = params["adaFormer"]["decoder"]["c6"]["conv"]
    c6["kernel"] *= C6_GAIN
    c6["bias"] *= C6_GAIN
    return models, params


def _images(b=2, size=64):
    rng = np.random.default_rng(61)
    return (rng.uniform(0, 255, (b, size, size, 3)).astype(np.float32),
            rng.uniform(0, 255, (b, size, size, 3)).astype(np.float32))


@pytest.mark.parametrize("attn_mode", ["spatial", "batch_coupled"])
def test_stylize_matches_jax(attn_mode):
    """Two 64^2 pairs (B=2, so batch_coupled really couples the batch)."""
    jmodels, params = _jax_params(attn_mode)
    c, s = _images()
    ref = np.asarray(jax_make_stylize_fn(jmodels)(params, jnp.asarray(c),
                                                  jnp.asarray(s)))
    models = build_models(ModelConfig(attn_mode=attn_mode, **SMALL), "cpu")
    load_params(models, jax_params_to_state_dicts(params))
    got = make_stylize_fn(models)(torch.from_numpy(c),
                                  torch.from_numpy(s)).numpy()
    assert got.shape == ref.shape == (2, 64, 64, 3)
    assert ref.max() > 50  # the gain makes a real picture
    # the repo's own pixel gate (scripts/reference_gate.py:63)
    assert np.abs(got - ref).max() <= 0.1


def test_pth_round_trip(tmp_path):
    """JAX params -> reference-format .pth triple -> load_pth_params gives
    the same state_dicts as the direct bridge, and they load strictly."""
    _, params = _jax_params("batch_coupled")
    paths = {name: str(tmp_path / f"{name}.pth")
             for name in ("ada", "vitc", "vits")}
    layers, heads = SMALL["num_layers"], SMALL["num_heads"]
    save_pth(paths["ada"], export_adaformer(params["adaFormer"], layers, heads))
    save_pth(paths["vitc"], export_vit(params["vit_c"], layers))
    save_pth(paths["vits"], export_vit(params["vit_s"], layers))
    got = load_pth_params(paths["ada"], paths["vitc"], paths["vits"],
                          num_layers=layers, num_heads=heads)
    want = jax_params_to_state_dicts(params)
    for net in want:
        assert got[net].keys() == want[net].keys()
        for key in want[net]:
            torch.testing.assert_close(got[net][key], want[net][key],
                                       rtol=0, atol=0)
    load_params(build_models(ModelConfig(attn_mode="batch_coupled", **SMALL),
                             "cpu"), got)


def test_kernel_backend_on_cpu_raises():
    models = build_models(ModelConfig(mhada_backend="kernel", **SMALL), "cpu")
    c, s = _images(b=1)
    with pytest.raises(RuntimeError, match="needs a CUDA tensor"):
        stylize_image(models, c[0], s[0])


def test_backend_switch():
    x = torch.zeros(2)
    assert not use_kernel("auto", x)
    assert not use_kernel("plain", x)
    with pytest.raises(RuntimeError):
        use_kernel("kernel", x)
    with pytest.raises(ValueError):
        use_kernel("pallas", x)
    with pytest.raises(ValueError):
        ModelConfig(mhada_backend="naive")


def test_cli_random_weights(tmp_path):
    """The CLI end to end at 64^2 with the full-width default model."""
    from PIL import Image

    c, s = _images(b=1)
    for name, img in (("c.png", c[0]), ("s.png", s[0])):
        Image.fromarray(img.astype(np.uint8)).save(tmp_path / name)
    out = tmp_path / "out" / "cs.png"
    main(["--content", str(tmp_path / "c.png"), "--style",
          str(tmp_path / "s.png"), "--out", str(out), "--size", "64", "64",
          "--device", "cpu"])
    assert np.asarray(Image.open(out)).shape == (64, 64, 3)


def test_port_never_imports_jax(tmp_path):
    """In a fresh interpreter: import every module of the port, drive the
    path and the video CLI's stream on a 2-frame clip, read a
    reference-format .pth triple written by the JAX package's exporters,
    and find no module of jax, jaxlib, flax or mhada_tpu loaded."""
    _, params = _jax_params("spatial")
    layers, heads = SMALL["num_layers"], SMALL["num_heads"]
    save_pth(str(tmp_path / "ada.pth"),
             export_adaformer(params["adaFormer"], layers, heads))
    save_pth(str(tmp_path / "vitc.pth"), export_vit(params["vit_c"], layers))
    save_pth(str(tmp_path / "vits.pth"), export_vit(params["vit_s"], layers))
    code = (
        "import importlib, pkgutil, sys, numpy as np\n"
        "import mhada_tpu_torch as pkg\n"
        "for mod in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(mod.name)\n"
        "import mhada_tpu_torch.infer.image as ii\n"
        "from mhada_tpu_torch.config import ModelConfig\n"
        "from mhada_tpu_torch.interop import load_params, load_pth_params\n"
        "from mhada_tpu_torch.models import build_models\n"
        f"d = {str(tmp_path)!r}\n"
        "sd = load_pth_params(d + '/ada.pth', d + '/vitc.pth', d + '/vits.pth',"
        f" num_layers={layers}, num_heads={heads})\n"
        "m = build_models(ModelConfig(num_layers=2, hidden_dim=128,"
        " num_heads=2, mlp_dim=256), 'cpu')\n"
        "load_params(m, sd)\n"
        "x = np.zeros((32, 32, 3), np.float32)\n"
        "assert ii.stylize_image(m, x, x).shape == (32, 32, 3)\n"
        "import cv2\n"
        "import mhada_tpu_torch.infer.video as iv\n"
        "vw = cv2.VideoWriter(d + '/c.mp4', cv2.VideoWriter_fourcc(*'mp4v'),"
        " 5, (32, 32))\n"
        "for _ in range(2):\n"
        "    vw.write(np.zeros((32, 32, 3), np.uint8))\n"
        "vw.release()\n"
        "assert iv.stream_stylize(m, d + '/c.mp4', x, d + '/v', (32, 32)) == 2\n"
        "print(sorted(k for k in sys.modules if k.split('.')[0] in"
        " ('jax', 'jaxlib', 'flax', 'mhada_tpu')))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"
