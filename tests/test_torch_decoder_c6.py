"""K13 against the JAX package, CPU: c6's plain version against
``c6_transposed`` (interpret mode), the port's ``Decoder(tail="c6")``
against ``Decoder(packed="col_tail")``, and the guards.  The whole c6-tail
path is in test_torch_c6_path.py."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from mhada_tpu.models.decoder import Decoder as JaxDecoder
from mhada_tpu.ops.colpacked import space_to_col
from mhada_tpu.ops.decoder_tail_pallas import c6_transposed
from mhada_tpu_torch.config import ModelConfig
from mhada_tpu_torch.interop import params_from_jax
from mhada_tpu_torch.models import build_models
from mhada_tpu_torch.models.decoder import Decoder
from mhada_tpu_torch.ops.decoder_c6 import c6_conv, c6_conv_plain

# Six test workers share the CPU: cap torch's intra-op threads.
torch.set_num_threads(2)

SMALL = dict(num_layers=2, hidden_dim=128, num_heads=2, mlp_dim=256)


def _oihw(w):
    return torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))


@pytest.mark.parametrize("b,h,w,dtype", [(1, 32, 24, "float32"),
                                         (2, 48, 16, "float32"),
                                         (1, 32, 24, "bfloat16")])
def test_c6_plain_matches_c6_transposed(b, h, w, dtype):
    """The inputs of tests/test_decoder_tail.py::test_c6_transposed_exact.
    float32: its bound (atol 2e-4, rtol 1e-4).  bfloat16: both sum bf16
    products in float32 in another order and round once at the end, so
    they may differ by one bf16 step of the output (2^-8 relative, outputs
    up to ~4): atol 1e-2, rtol 8e-3."""
    rng = np.random.default_rng(7)
    y = np.abs(rng.standard_normal((b, h, w, 64))).astype(np.float32)
    w6 = (rng.standard_normal((3, 3, 64, 3)) * 0.1).astype(np.float32)
    b6 = rng.standard_normal(3).astype(np.float32)
    jdt = getattr(jnp, dtype)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(c6_transposed(space_to_col(jnp.asarray(y, jdt)),
                                       jnp.asarray(w6), jnp.asarray(b6)),
                         np.float32)
    yt = torch.from_numpy(y).to(getattr(torch, dtype))
    got = c6_conv_plain(yt, _oihw(w6), torch.from_numpy(b6))
    assert got.dtype == yt.dtype and got.shape == (b, h, w, 3)
    tol = (dict(atol=2e-4, rtol=1e-4) if dtype == "float32"
           else dict(atol=1e-2, rtol=8e-3))
    np.testing.assert_allclose(got.float().numpy(), ref, **tol)
    # the wrapper takes the plain version for CPU tensors
    assert torch.equal(c6_conv(yt, _oihw(w6), torch.from_numpy(b6)), got)


def test_decoder_c6_matches_jax_col_tail():
    """Decoder(tail="c6") == JAX Decoder(packed="col_tail") with shared
    params (the bound of tests/test_decoder_tail.py:29-41); one state_dict
    loads strictly into both tails."""
    x = np.random.default_rng(53).standard_normal((1, 4, 6, 512)) \
        .astype(np.float32)
    params = JaxDecoder(packed=False).init(jax.random.PRNGKey(0),
                                           x)["params"]
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(JaxDecoder(packed="col_tail").apply(
            {"params": params}, x))
    sd = params_from_jax(params)
    decs = {}
    for tail in ("fused", "c6"):
        decs[tail] = Decoder(512, tail=tail).eval()
        decs[tail].load_state_dict(sd, strict=True)
    assert decs["fused"].state_dict().keys() == decs["c6"].state_dict().keys()
    with torch.no_grad():
        got = decs["c6"](torch.from_numpy(x)).numpy()
        fused = decs["fused"](torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (1, 32, 48, 3)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got, fused, atol=1e-6, rtol=1e-5)


def test_c6_tail_guards():
    with pytest.raises(ValueError, match="K8"):
        build_models(ModelConfig(**SMALL), "cpu", for_training=True,
                     decoder_tail="c6")
    with pytest.raises(ValueError, match="unknown decoder tail"):
        build_models(ModelConfig(**SMALL), "cpu", decoder_tail="col_tail")
    with pytest.raises(ValueError, match="unknown decoder tail"):
        Decoder(512, tail="mega")
    dec = Decoder(128, tail="c6")   # modules start in training mode
    with pytest.raises(RuntimeError, match="forward-only"):
        dec(torch.zeros(1, 2, 2, 128))
    y = torch.zeros(1, 4, 4, 64)
    w6, b6 = torch.zeros(3, 64, 3, 3), torch.zeros(3)
    with pytest.raises(RuntimeError, match="needs a CUDA tensor"):
        c6_conv(y, w6, b6, backend="kernel")
    with pytest.raises(ValueError, match="bad shapes"):
        c6_conv(torch.zeros(1, 4, 4, 32), w6, b6)
