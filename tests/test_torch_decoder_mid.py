"""K14's plain version against the JAX package's ``mid3_fused`` (interpret
mode), CPU, at the cases of tests/test_decoder_mid.py, and the wrapper's
guards."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from mhada_tpu.ops.decoder_mid_pallas import mid3_fused as jax_mid3_fused
from mhada_tpu_torch.ops.decoder_mid import mid3_fused, mid3_fused_plain

# Six test workers share the CPU: cap torch's intra-op threads.
torch.set_num_threads(2)


def _params(rng, c):
    """Three stages' HWIO weights and biases at test_decoder_mid.py's
    scales (weights 0.5 / sqrt(C), biases 0.1)."""
    ws = [(rng.standard_normal((3, 3, c, c)) * (0.5 / np.sqrt(c))).astype(
        np.float32) for _ in range(3)]
    bs = [(rng.standard_normal(c) * 0.1).astype(np.float32) for _ in range(3)]
    return ws, bs


def _oihw(w):
    return torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))


@pytest.mark.parametrize("c,b,h,w,th,dtype", [
    (128, 1, 8, 8, 8, "float32"),      # the TPU kernel's single row tile
    (128, 1, 16, 8, 8, "float32"),     # two tiles
    (256, 2, 12, 8, 4, "float32"),     # three tiles, full channel width
    (128, 1, 16, 8, 8, "bfloat16"),
])
def test_mid3_plain_matches_pallas(c, b, h, w, th, dtype):
    """test_decoder_mid.py's bounds: float32 atol 3e-5, rtol 1e-4 (sums in
    another order); bfloat16 atol 0.12, rtol 0.05 (the same rounding points,
    but a value on either side of a bf16 rounding boundary moves the next
    stages by whole bf16 steps)."""
    rng = np.random.default_rng(71)
    ws, bs = _params(rng, c)
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    jdt = getattr(jnp, dtype)
    pairs = [jnp.asarray(t, jdt) for wb in zip(ws, bs) for t in wb]
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jax_mid3_fused(jnp.asarray(x, jdt), *pairs,
                                        row_tile=th), np.float32)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    args = [t for wb in zip(ws, bs) for t in (_oihw(wb[0]),
                                              torch.from_numpy(wb[1]))]
    got = mid3_fused_plain(xt, *args)
    assert got.dtype == xt.dtype and got.shape == (b, h, w, c)
    tol = (dict(atol=3e-5, rtol=1e-4) if dtype == "float32"
           else dict(atol=0.12, rtol=0.05))
    np.testing.assert_allclose(got.float().numpy(), ref, **tol)
    # the wrapper takes the plain version for CPU tensors
    assert torch.equal(mid3_fused(xt, *args), got)


def test_mid3_guards():
    x = torch.zeros(1, 4, 4, 128)
    w, b = torch.zeros(128, 128, 3, 3), torch.zeros(128)
    with pytest.raises(RuntimeError, match="needs a CUDA tensor"):
        mid3_fused(x, w, b, w, b, w, b, backend="kernel")
    with pytest.raises(ValueError, match="multiple of 128"):
        mid3_fused(torch.zeros(1, 4, 4, 64), *[torch.zeros(64, 64, 3, 3),
                                               torch.zeros(64)] * 3)
    with pytest.raises(ValueError, match="bad shapes"):
        mid3_fused(x, w, b, w[:, :64], b, w, b)
