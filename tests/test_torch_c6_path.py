"""The c6-tail stylization path against the JAX package, CPU: the full and
streaming paths with ``build_models(..., decoder_tail="c6")`` against the
JAX build cloned to ``packed_decoder="col_tail"`` (its c6 kernel in
interpret mode), on one set of weights."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from mhada_tpu.config import ModelConfig as JaxModelConfig
from mhada_tpu.infer import image as jax_image
from mhada_tpu.train.train_image import build_models as jax_build_models
from mhada_tpu_torch.config import ModelConfig
from mhada_tpu_torch.infer import image
from mhada_tpu_torch.interop import jax_params_to_state_dicts, load_params
from mhada_tpu_torch.models import build_models

# Six test workers share the CPU: cap torch's intra-op threads.
torch.set_num_threads(2)

SMALL = dict(num_layers=2, hidden_dim=128, num_heads=2, mlp_dim=256)
# c6 is conv + ReLU, so this gain scales the random decoder's ~0.04 output
# into a real picture on both sides (as in test_torch_slice.py).
C6_GAIN = 3000.0


@pytest.fixture(scope="module")
def pair():
    """JAX models cloned to the col_tail decoder and params (SMALL,
    spatial, seed 0); the port's c6-tail models holding the same weights."""
    jmodels = jax_build_models(JaxModelConfig(**SMALL))
    params = jax.tree_util.tree_map(
        np.array, jax_image.init_inference_params(jmodels,
                                                  jax.random.PRNGKey(0)))
    c6 = params["adaFormer"]["decoder"]["c6"]["conv"]
    c6["kernel"] *= C6_GAIN
    c6["bias"] *= C6_GAIN
    # on the CPU the JAX build has packed_decoder=False, so after the
    # clone c6_transposed is its only Pallas call
    jmodels = dict(jmodels, adaFormer=jmodels["adaFormer"].clone(
        packed_decoder="col_tail"))
    models = build_models(ModelConfig(**SMALL), "cpu", decoder_tail="c6")
    load_params(models, jax_params_to_state_dicts(params))
    return jmodels, params, models


@pytest.mark.parametrize("path", ["full", "stream"])
def test_c6_tail_path_matches_jax(pair, path):
    """Two 64^2 pairs through the full path and through the streaming path
    on cached K/V (the JAX ``ada_tail`` of scripts/tpu_probe.py:79-81), held
    to the repo's pixel gate (scripts/reference_gate.py:63)."""
    jmodels, params, models = pair
    rng = np.random.default_rng(63)
    c, s = (rng.uniform(0, 255, (2, 64, 64, 3)).astype(np.float32)
            for _ in range(2))
    with pltpu.force_tpu_interpret_mode():
        if path == "full":
            ref = jax_image.make_stylize_fn(jmodels)(
                params, jnp.asarray(c), jnp.asarray(s))
        else:
            fs = jax_image.make_encode_style_fn(jmodels)(params,
                                                         jnp.asarray(s))
            kv = jax_image.precompute_style_kv(jmodels, params, fs)
            ref = jax_image.make_stylize_with_kv_fn(jmodels)(
                params, jnp.asarray(c), kv)
        ref = np.asarray(ref)
    ct, st = torch.from_numpy(c), torch.from_numpy(s)
    if path == "full":
        got = image.make_stylize_fn(models)(ct, st)
    else:
        kv = image.precompute_style_kv(models,
                                       image.make_encode_style_fn(models)(st))
        got = image.make_stylize_with_kv_fn(models)(ct, kv)
    got = got.numpy()
    assert got.shape == ref.shape == (2, 64, 64, 3)
    assert ref.max() > 50  # the gain makes a real picture
    assert np.abs(got - ref).max() <= 0.1
