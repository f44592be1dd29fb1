"""The plain versions of K6, K7 and K8 (forward with residuals and backward,
which the wrappers run for CPU tensors and the card holds the kernels to)
against the JAX package's training kernels in interpret mode, CPU."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from mhada_tpu.ops.attention_pallas import attention_tm_train
from mhada_tpu.ops.colpacked import col_to_space
from mhada_tpu.ops.decoder_tail_pallas import tail3_fused, tail3_train
from mhada_tpu.ops.mhada_pallas import mhada_tm_train
from mhada_tpu_torch.ops.attention_train import (attention_train,
                                                 attention_train_fwd_plain)
from mhada_tpu_torch.ops.decoder_tail import (decoder_tail_res_plain,
                                              decoder_tail_train)
from mhada_tpu_torch.ops.mhada_train import (mhada_train,
                                             mhada_train_fwd_plain)


def _grad(fn, *args):
    """d sum(sin(fn(*args))) / d args, through torch autograd."""
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    out = fn(*leaves)
    torch.sin(out).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in leaves]


@pytest.mark.parametrize("b,n,heads", [(2, 300, 2), (1, 520, 4)])
def test_attention_train_matches_pallas(b, n, heads):
    """K6: forward, lse and jax.grad of sum(sin(out)); tolerances as
    tests/test_mhada_pallas.py:537-545."""
    rng = np.random.default_rng((b, n, heads))
    qkv = (rng.standard_normal((b, n, 3 * 64 * heads)) * 0.5).astype(
        np.float32)
    scale = 0.125
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(attention_tm_train(jnp.asarray(qkv), scale, heads))
        g_ref = np.asarray(jax.grad(lambda x: jnp.sum(jnp.sin(
            attention_tm_train(x, scale, heads))))(jnp.asarray(qkv)))
    got, (g_got,) = _grad(lambda x: attention_train(x, heads, scale), qkv)
    np.testing.assert_allclose(got, ref, atol=5e-5, rtol=1e-3)
    np.testing.assert_allclose(g_got, g_ref, atol=1e-3, rtol=1e-2)
    # the row log-sum-exp against the softmax it normalises
    out, lse = attention_train_fwd_plain(torch.from_numpy(qkv), heads, scale)
    q, k = (torch.from_numpy(qkv[..., i * 64 * heads:(i + 1) * 64 * heads])
            .reshape(b, n, heads, 64).transpose(1, 2) for i in (0, 1))
    torch.testing.assert_close(
        lse, torch.logsumexp(q @ k.transpose(-1, -2) * scale, -1))


@pytest.mark.parametrize("b,n,m,heads", [(2, 300, 260, 2), (1, 200, 330, 4)])
def test_mhada_train_matches_pallas(b, n, m, heads):
    """K7: forward, M1 / E2 residuals and jax.grad of sum(sin(out)) at input
    scale 0.5 (tests/test_mhada_pallas.py:466-508)."""
    rng = np.random.default_rng((b, n, m, heads))
    c = 64 * heads
    q, f = (rng.standard_normal((b, n, c)).astype(np.float32) * 0.5
            for _ in range(2))
    k, v = (rng.standard_normal((b, m, c)).astype(np.float32) * 0.5
            for _ in range(2))
    args = tuple(map(jnp.asarray, (q, k, v, f)))
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(mhada_tm_train(*args, heads))
        g_ref = jax.grad(lambda a: jnp.sum(jnp.sin(
            mhada_tm_train(*a, heads))))(args)
    got, g_got = _grad(lambda *a: mhada_train(*a, heads), q, k, v, f)
    np.testing.assert_allclose(got, ref, atol=5e-5, rtol=1e-3)
    for a, r in zip(g_got, g_ref):
        np.testing.assert_allclose(a, np.asarray(r), atol=3e-3, rtol=1e-2)
    _, m1, e2, _ = mhada_train_fwd_plain(*map(torch.from_numpy, (q, k, v, f)),
                                         heads)
    assert (e2 - m1.square()).min() > -1e-5


def test_mhada_train_var_clamp_gradient_is_zero():
    """Where Var = E2 - M1^2 < 1e-6 (here every key has the same value, so
    Var = 0 up to rounding, which the values' 0.01 scale keeps far below
    1e-6) the clamp passes no gradient to M1 and E2, as in the JAX
    kernel."""
    rng = np.random.default_rng(5)
    q, f = (rng.standard_normal((1, 70, 128)).astype(np.float32) * 0.35
            for _ in range(2))
    k = rng.standard_normal((1, 90, 128)).astype(np.float32) * 0.35
    v = np.broadcast_to(rng.standard_normal((1, 1, 128)) * 0.01,
                        (1, 90, 128)).astype(np.float32)
    args = tuple(map(jnp.asarray, (q, k, v, f)))
    with pltpu.force_tpu_interpret_mode():
        out = np.asarray(mhada_tm_train(*args, 2))
        g_ref = jax.grad(lambda a: jnp.sum(jnp.sin(
            mhada_tm_train(*a, 2))))(args)
    _, g_got = _grad(lambda *a: mhada_train(*a, 2), q, k, v, f)
    for a, r in zip(g_got, g_ref):
        np.testing.assert_allclose(a, np.asarray(r), atol=3e-3, rtol=1e-2)
    # Var = 0 everywhere: d fcs_n = g * sqrt(1e-6), and no gradient reaches
    # the logits (dP = dM1 . V is the same for every key)
    out = torch.from_numpy(out.copy())
    torch.testing.assert_close(
        torch.from_numpy(g_got[3]), torch.cos(out) * 1e-3, rtol=1e-4,
        atol=1e-7)
    assert np.abs(g_got[0]).max() < 1e-5


def _tail_params(rng):
    def conv(co, ci):
        return (rng.standard_normal((3, 3, ci, co)) * 0.1).astype(np.float32), \
            (rng.standard_normal((co,)) * 0.1).astype(np.float32)
    (wu, bu), (w5, b5), (w6, b6) = conv(64, 128), conv(64, 64), conv(3, 64)
    return wu, bu, w5, b5, w6, b6


def test_decoder_tail_train_matches_pallas():
    """K8 at tests/test_decoder_tail.py:143-170's shape: the forward with its
    residuals against tail3_fused(with_residuals=True), and the plain
    backward against jax.grad through tail3_train, all seven inputs."""
    rng = np.random.default_rng(7)
    params = _tail_params(rng)
    x = rng.standard_normal((2, 16, 8, 128)).astype(np.float32)
    cot = rng.standard_normal((2, 32, 16, 3)).astype(np.float32)
    jargs = tuple(map(jnp.asarray, (x, *params)))
    with pltpu.force_tpu_interpret_mode():
        rgb, y1p, c5o = tail3_fused(*jargs, with_residuals=True)
        g_ref = jax.grad(lambda *a: jnp.sum(tail3_train(*a) * cot),
                         argnums=tuple(range(7)))(*jargs)

    def oihw(w):
        return np.ascontiguousarray(w.transpose(3, 2, 0, 1))

    targs = [x, oihw(params[0]), params[1], oihw(params[2]), params[3],
             oihw(params[4]), params[5]]
    got = decoder_tail_res_plain(*map(torch.from_numpy, targs))
    for a, r in zip(got, (rgb, col_to_space(y1p), col_to_space(c5o))):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=2e-4,
                                   rtol=1e-4)

    leaves = [torch.from_numpy(a).requires_grad_() for a in targs]
    (decoder_tail_train(*leaves) * torch.from_numpy(cot)).sum().backward()
    names = ("dx", "dwu", "dbu", "dw5", "db5", "dw6", "db6")
    for name, t, r in zip(names, leaves, g_ref):
        r = np.asarray(r)
        if r.ndim == 4 and name != "dx":
            r = r.transpose(3, 2, 0, 1)
        np.testing.assert_allclose(t.grad.numpy(), r, atol=5e-4, rtol=5e-4,
                                   err_msg=name)
