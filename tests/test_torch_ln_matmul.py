"""K2's plain twin (mhada_tpu_torch/ops/ln_matmul.py) against the JAX fused
LN + matmul Pallas kernel in interpret mode, CPU."""

import numpy as np
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from mhada_tpu.models.layers import layer_norm_fn
from mhada_tpu.ops.ln_matmul_pallas import ln_matmul as jax_ln_matmul
from mhada_tpu_torch.ops.ln_matmul import layer_norm, ln_matmul


def _inputs(e, f):
    rng = np.random.default_rng((31, e, f))
    x = rng.standard_normal((1, 512, e)).astype(np.float32)
    s = (rng.standard_normal(e) * 0.1 + 1.0).astype(np.float32)
    sb = (rng.standard_normal(e) * 0.1).astype(np.float32)
    w = (rng.standard_normal((e, f)) / np.sqrt(e)).astype(np.float32)
    b = rng.standard_normal(f).astype(np.float32)
    return x, s, sb, w, b


def test_layer_norm_matches_jax():
    x, s, sb, _, _ = _inputs(128, 8)
    ref = np.asarray(layer_norm_fn(jnp.asarray(x), jnp.asarray(s),
                                   jnp.asarray(sb)))
    got = layer_norm(*map(torch.from_numpy, (x, s, sb))).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


def test_ln_matmul_twin_matches_pallas():
    x, s, sb, w, b = _inputs(128, 384)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jax_ln_matmul(*map(jnp.asarray, (x, s, sb, w, b))))
    # the port keeps nn.Linear's (out, in) weight layout
    got = ln_matmul(torch.from_numpy(x), torch.from_numpy(s),
                    torch.from_numpy(sb), torch.from_numpy(w.T.copy()),
                    torch.from_numpy(b)).numpy()
    assert got.shape == (1, 512, 384)
    # 128-term float32 dot products, as tests/test_ln_matmul.py bounds them
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-5)
