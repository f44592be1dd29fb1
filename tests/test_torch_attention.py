"""K1's plain twin (mhada_tpu_torch/ops/attention_kernel.py) against the JAX
token-major Pallas kernel in interpret mode, CPU."""

import numpy as np
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from mhada_tpu.ops.attention_pallas import attention_pallas_tm
from mhada_tpu_torch.ops.attention_kernel import attention_plain, attention_tm

# Six test workers share the CPU: cap torch's intra-op threads.
torch.set_num_threads(2)


def test_attention_twin_matches_pallas_tm():
    qkv = np.random.default_rng(21).standard_normal((1, 512, 384)) \
        .astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(attention_pallas_tm(jnp.asarray(qkv), scale=0.125,
                                             num_heads=2))
    t = torch.from_numpy(qkv)
    got = attention_tm(t, 2, scale=0.125).numpy()  # CPU tensor -> the twin
    np.testing.assert_array_equal(got, attention_plain(t, 2, 0.125).numpy())
    assert got.shape == (1, 512, 128)
    # softmax over 512 float32 logits of std 1: summation order only
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-4)
