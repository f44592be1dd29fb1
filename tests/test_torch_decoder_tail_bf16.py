"""The bfloat16 plain version of K5 and K8, which the card holds their
tensor-core kernel to, against the JAX package's tail3_fused in interpret
mode, CPU: rgb, and the residuals y1 and c5 of ``with_residuals=True``
(lane-packed there, unpacked with col_to_space).  The twin rounds where
the Pallas kernel rounds: each conv's float32 sum to bf16 before the bf16
bias (decoder_tail_pallas.py:328, 369, 563-564), and the upsample as the
kernel's row and packed-column blends (``upsample2x_tail``)."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from mhada_tpu.ops.colpacked import col_to_space
from mhada_tpu.ops.decoder_tail_pallas import tail3_fused
from mhada_tpu_torch.ops.decoder_tail import decoder_tail_res_plain

# Six test workers share the CPU: cap torch's intra-op threads.
torch.set_num_threads(2)

# Share of elements of a tensor that may differ at all: the two sum each
# conv's 9 x C_in products in another float32 order, which moves a rounding
# by one step now and then (1 of 30720 c5 values at (2, 6, 10, 128), none
# at (1, 8, 12, 128)).
DIFFER_SHARE = 1e-3


def _step(x: float) -> float:
    """One bf16 step (the spacing of bf16 values) at magnitude x."""
    return 2.0 ** (np.floor(np.log2(x)) - 7)


@pytest.mark.parametrize("shape,seed", [((1, 8, 12, 128), 51),
                                        ((2, 6, 10, 128), 3)])
def test_decoder_tail_bf16_twin_matches_pallas(shape, seed):
    """rgb, y1 and c5 of the twin within half a bf16 step of each tensor's
    largest value, and at most DIFFER_SHARE of each tensor's elements
    differing at all; the convs' U(+-1/sqrt(fan_in)) init.  The twin
    before the repair (the bias added inside the conv's float32 sum,
    torch's single-rounding upsample) was 2, 1 and 1 steps off at
    (1, 8, 12, 128) and 3.75, 1 and 1 at (2, 6, 10, 128) (rgb, y1, c5),
    differing at 12-33 % of each tensor's elements; the repaired one is
    exact but for one c5 value at the second shape, a quarter step of the
    largest off."""
    rng = np.random.default_rng(seed)

    def conv(co, ci):
        bound = 1 / np.sqrt(ci * 9)
        return (rng.uniform(-bound, bound, (3, 3, ci, co)).astype(np.float32),
                rng.uniform(-bound, bound, (co,)).astype(np.float32))

    x = np.abs(rng.standard_normal(shape)).astype(np.float32)
    params = [t for co, ci in ((64, 128), (64, 64), (3, 64))
              for t in conv(co, ci)]
    with pltpu.force_tpu_interpret_mode():
        rgb, y1p, c5o = tail3_fused(
            *(jnp.asarray(a, jnp.bfloat16) for a in (x, *params)),
            with_residuals=True)
    refs = [np.asarray(t.astype(jnp.float32))
            for t in (rgb, col_to_space(y1p), col_to_space(c5o))]

    def torch_param(a):
        if a.ndim == 4:   # HWIO -> OIHW
            a = np.ascontiguousarray(a.transpose(3, 2, 0, 1))
        return torch.from_numpy(a)

    got = decoder_tail_res_plain(torch.from_numpy(x).to(torch.bfloat16),
                                 *map(torch_param, params))
    for name, g, r in zip(("rgb", "y1", "c5"), got, refs):
        assert g.dtype == torch.bfloat16 and g.shape == r.shape, name
        d = np.abs(g.float().numpy() - r)
        assert d.max() <= _step(np.abs(r).max()) / 2, (name, d.max())
        assert (d > 0).mean() <= DIFFER_SHARE, (name, (d > 0).mean())
