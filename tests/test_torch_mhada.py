"""K4's plain twin and the MHAda core (mhada_tpu_torch/ops/mhada*.py,
models/adaformer.py) against the JAX package, CPU."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from mhada_tpu.models.adaformer import AdaAttnMultiHead as JaxAdaAttn
from mhada_tpu.ops.mhada import mhada_attention as jax_mhada
from mhada_tpu.ops.mhada_pallas import mhada_attention_pallas
from mhada_tpu_torch.interop import params_from_jax
from mhada_tpu_torch.models.adaformer import AdaAttnMultiHead
from mhada_tpu_torch.ops.mhada import mhada_attention
from mhada_tpu_torch.ops.mhada_kernel import mhada_tm

# Six test workers share the CPU: cap torch's intra-op threads.
torch.set_num_threads(2)


def _inputs(b, h, n, m, d, scale):
    rng = np.random.default_rng((41, b, h, n, m, d))
    q = (rng.standard_normal((b, h, n, d)) * scale).astype(np.float32)
    k = (rng.standard_normal((b, h, m, d)) * scale).astype(np.float32)
    v = rng.standard_normal((b, h, m, d)).astype(np.float32)
    f = rng.standard_normal((b, h, n, d)).astype(np.float32)
    return q, k, v, f


def _token_major(a):
    b, h, n, d = a.shape
    return torch.from_numpy(a.transpose(0, 2, 1, 3).reshape(b, n, h * d).copy())


def test_mhada_twin_matches_pallas():
    """Token-major K4 twin vs the single-pass Pallas kernel; input scale
    0.35 keeps the unscaled logits' std near 1 (CLAUDE.md:28-30)."""
    q, k, v, f = _inputs(1, 2, 256, 256, 64, 0.35)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(mhada_attention_pallas(*map(jnp.asarray, (q, k, v, f))))
    got = mhada_tm(*map(_token_major, (q, k, v, f)), num_heads=2).numpy()
    ref_tm = ref.transpose(0, 2, 1, 3).reshape(1, 256, 128)
    # same bound as tests/test_mhada_pallas.py
    np.testing.assert_allclose(got, ref_tm, atol=5e-4, rtol=1e-3)


@pytest.mark.parametrize("activation", ["softmax", "cosine"])
def test_mhada_core_matches_jax(activation):
    q, k, v, f = _inputs(2, 2, 48, 40, 16, 0.35)
    ref = np.asarray(jax_mhada(*map(jnp.asarray, (q, k, v, f)), activation))
    got = mhada_attention(*map(torch.from_numpy, (q, k, v, f)),
                          activation).numpy()
    # float32 on both sides; sqrt(E2 - M1^2) amplifies rounding where the
    # variance is small
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)


def test_ada_attn_block_matches_jax():
    """One AdaAttnMultiHead block (IN, per-head projections, core, output
    projection) with the JAX block's weights through params_from_jax."""
    rng = np.random.default_rng(42)
    fc, fcs = (rng.standard_normal((1, 96, 128)).astype(np.float32)
               for _ in range(2))
    fs = rng.standard_normal((1, 80, 128)).astype(np.float32)
    jmod = JaxAdaAttn(num_heads=2)
    params = jmod.init(jax.random.PRNGKey(3), fc, fs, fcs)["params"]
    ref = np.asarray(jmod.apply({"params": params}, fc, fs, fcs))
    mod = AdaAttnMultiHead(128, num_heads=2)
    mod.load_state_dict(params_from_jax(params), strict=True)
    with torch.no_grad():
        got = mod(*map(torch.from_numpy, (fc, fs, fcs))).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=1e-4)
