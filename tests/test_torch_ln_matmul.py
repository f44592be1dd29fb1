"""K2's plain twin (mhada_tpu_torch/ops/ln_matmul.py) against the JAX fused
LN + matmul Pallas kernel in interpret mode, CPU, in float32 and bfloat16
at the ViT's widths."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mhada_tpu.models.layers import layer_norm_fn
from mhada_tpu.ops.ln_matmul_pallas import ln_matmul as jax_ln_matmul
from mhada_tpu_torch.ops.ln_matmul import layer_norm, ln_matmul

# Six test workers share the CPU: cap torch's intra-op threads.
torch.set_num_threads(2)


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("e,f", [(128, 384), (512, 1536), (512, 2048)])
def test_ln_matmul_twin_matches_pallas(dtype, e, f):
    """The twin against the Pallas kernel, also at the ViT's widths (ln1 ->
    qkv, ln2 -> fc1).  bfloat16: all five inputs bf16-valued, as the bf16
    step casts its parameter tree."""
    arrays = _inputs(e, f)
    if dtype == "bfloat16":
        arrays = [torch.from_numpy(a).bfloat16().float().numpy()
                  for a in arrays]
    x, s, sb, w, b = arrays
    jdt = getattr(jnp, dtype)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jax_ln_matmul(*(jnp.asarray(a).astype(jdt)
                                         for a in (x, s, sb, w, b)))
                         .astype(jnp.float32))
    # the port keeps nn.Linear's (out, in) weight layout
    tdt = getattr(torch, dtype)
    got = ln_matmul(*(torch.from_numpy(a).to(tdt)
                      for a in (x, s, sb, w.T.copy(), b))).float().numpy()
    assert got.shape == (1, 512, f)
    if dtype == "float32":
        # E-term float32 dot products, as tests/test_ln_matmul.py bounds them
        np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-5)
    else:
        # h and the output each rounded once to bf16 on both sides, the sums
        # in another order: one bf16 step of the largest output
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=2.0 ** -8 * np.abs(ref).max())
