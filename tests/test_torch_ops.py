"""Port primitives (mhada_tpu_torch/ops) against the JAX package's, CPU."""

import numpy as np
import jax.numpy as jnp
import torch

from mhada_tpu.ops.instance_norm import instance_norm_tokens as jax_in
import mhada_tpu.ops.pad_conv as jpc
import mhada_tpu.ops.resize as jrs
from mhada_tpu_torch.ops import instance_norm, pad_conv, resize

# Six test workers share the CPU: cap torch's intra-op threads.
torch.set_num_threads(2)


def _rng(*key):
    return np.random.default_rng(key)


def test_instance_norm_tokens_matches_jax():
    x = (_rng(1).standard_normal((2, 37, 24)) * 3 + 1).astype(np.float32)
    ref = np.asarray(jax_in(jnp.asarray(x)))
    got = instance_norm.instance_norm_tokens(torch.from_numpy(x)).numpy()
    # float32 statistics over 37 tokens on both sides
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


def test_resize_regrid_32_to_8_matches_resize_matrix():
    """The position-grid regrid (downsample, no anti-aliasing) against the
    JAX package's interpolation matrices and its resize_bilinear."""
    x = _rng(2).standard_normal((1, 32, 32, 16)).astype(np.float32)
    got = resize.resize_bilinear(torch.from_numpy(x), (8, 8)).numpy()
    m = jrs._resize_matrix_np(32, 8)
    ref = np.einsum("oh,pw,bhwc->bopc", m, m, x)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
    ref_jax = np.asarray(jrs.resize_bilinear(jnp.asarray(x), (8, 8)))
    np.testing.assert_allclose(got, ref_jax, atol=1e-5, rtol=1e-5)


def test_upsample2x_matches_jax():
    x = _rng(3).standard_normal((2, 5, 7, 3)).astype(np.float32)
    got = resize.upsample2x(torch.from_numpy(x)).numpy()
    ref = np.asarray(jrs.upsample2x(jnp.asarray(x)))
    assert got.shape == (2, 10, 14, 3)
    # fixed 2-tap blends: equal up to float32 rounding
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=1e-6)


def test_reflect_conv_matches_jax():
    rng = _rng(4)
    x = rng.standard_normal((2, 9, 11, 8)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 8, 5)) * 0.2).astype(np.float32)  # HWIO
    b = rng.standard_normal(5).astype(np.float32)
    ref = np.asarray(jpc.conv2d_reflect(jnp.asarray(x), jnp.asarray(w),
                                        jnp.asarray(b)))
    got = pad_conv.conv2d_reflect(
        torch.from_numpy(x), torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
        torch.from_numpy(b)).numpy()
    assert got.shape == (2, 9, 11, 5)
    # 72-term float32 sums in different orders
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
