"""K5's plain twin and the port's Decoder against the JAX package, CPU."""

import numpy as np
import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from mhada_tpu.models.decoder import Decoder as JaxDecoder
from mhada_tpu.ops.decoder_tail_pallas import tail3_fused
from mhada_tpu_torch.interop import params_from_jax
from mhada_tpu_torch.models.decoder import Decoder
from mhada_tpu_torch.ops.decoder_tail import decoder_tail


def _oihw(w):
    return torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))


def test_decoder_tail_twin_matches_tail3_fused():
    """up3 -> 2x bilinear -> c5 -> c6 at (1, 8, 12, 128), one row tile: the
    reflect pads of every stage's output meet the image edges."""
    rng = np.random.default_rng(51)

    def rnd(*shape, scale=0.1):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    wu, bu = rnd(3, 3, 128, 64), rnd(64)
    w5, b5 = rnd(3, 3, 64, 64), rnd(64)
    w6, b6 = rnd(3, 3, 64, 3), rnd(3)
    x = rnd(1, 8, 12, 128, scale=1.0)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(tail3_fused(*map(jnp.asarray,
                                          (x, wu, bu, w5, b5, w6, b6)),
                                     row_tile=8))
    got = decoder_tail(torch.from_numpy(x), _oihw(wu), torch.from_numpy(bu),
                       _oihw(w5), torch.from_numpy(b5), _oihw(w6),
                       torch.from_numpy(b6)).numpy()
    assert got.shape == (1, 16, 24, 3)
    # same bound as tests/test_decoder_tail.py::test_tail3_fused_exact
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=1e-4)


def test_decoder_matches_jax_plain():
    x = np.random.default_rng(52).standard_normal((1, 4, 6, 512)) \
        .astype(np.float32)
    jdec = JaxDecoder(packed=False)
    params = jdec.init(jax.random.PRNGKey(0), x)["params"]
    ref = np.asarray(jdec.apply({"params": params}, x))
    dec = Decoder(512)
    dec.load_state_dict(params_from_jax(params), strict=True)
    with torch.no_grad():
        got = dec(torch.from_numpy(x)).numpy()
    assert got.shape == (1, 32, 48, 3)
    # nine float32 conv layers; outputs are ~1e-2, so bound relative to that
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=1e-4)
