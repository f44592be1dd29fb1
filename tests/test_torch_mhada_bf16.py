"""The bfloat16 plain versions of K3, K4 and K7, which the card holds
their tensor-core kernels to, against the JAX package's Pallas kernels in
interpret mode, CPU, with V = 3 + 0.3 N(0, 1) and K at scale 0.35.  With
V offset, E2 - M1^2 cancels, so every place where the two round
differently shows; the twins round P and V^2 to bf16 as the JAX kernels
do (mhada_pallas.py:63-72, 182-191, 295-301, 397-401).  Also the library
yardstick that chip_smoke.py times beside K3, K4 and K7 (one
scaled_dot_product_attention on [V | V^2] with scale 1) against the
float32 twin's M1 and E2."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from mhada_tpu.ops.mhada_pallas import \
    mhada_fused_prologue as jax_fused_prologue
from mhada_tpu.ops.mhada_pallas import mhada_attention_pallas, mhada_tm_train
from mhada_tpu_torch.ops.instance_norm import instance_norm_stats
from mhada_tpu_torch.ops.mhada_kernel import mhada_tm_plain
from mhada_tpu_torch.ops.mhada_prologue import mhada_fused_prologue_plain
from mhada_tpu_torch.ops.mhada_train import mhada_train, mhada_train_fwd_plain

# Six test workers share the CPU: cap torch's intra-op threads.
torch.set_num_threads(2)

BF16 = torch.bfloat16
# Gradients through autograd against jax.vjp, as the norm of the difference
# over the norm of the JAX gradient.  dq and dk: 0.1.  The cancellation
# amplifies float32 summation noise in M1 and E2 (1e-5 of Var) before dM1
# is rounded to bf16, so some rows' dM1 rounds one step apart on the two
# sides, and dS of those rows moves; 0.019-0.048 over four seeds and two
# shapes.  dv and dfcs_n: 1e-2 (at most 3.6e-3 and 3.2e-4 there).  The
# twins before P and V^2 were rounded gave 0.22-0.35 (dq, dk) and
# 0.025-0.033 (dv, dfcs_n) on the same inputs.
GRAD_REL = {"dq": 0.1, "dk": 0.1, "dv": 1e-2, "dfcs_n": 1e-2}


def _step(x: float) -> float:
    """One bf16 step (the spacing of bf16 values) at magnitude x."""
    return 2.0 ** (np.floor(np.log2(x)) - 7)


def _bf16(rng, shape, scale=1.0, shift=0.0):
    """Seeded values rounded to bf16 -> (numpy float32, torch bf16)."""
    x = torch.from_numpy((rng.standard_normal(shape) * scale + shift)
                         .astype(np.float32)).to(BF16)
    return x.float().numpy(), x


def _jnp(a):
    return jnp.asarray(a, jnp.bfloat16)


@pytest.mark.parametrize("b,n,m", [(2, 200, 130), (1, 128, 256)])
def test_prologue_bf16_twin_matches_pallas(b, n, m):
    """K3's plain version at bf16 against mhada_fused_prologue: within one
    bf16 step of the output's largest value (half a step here).  The twin
    before the repair (softmax normalised before rounding, V^2 in float32)
    was 5 and 2 steps off."""
    rng = np.random.default_rng((b, n, m))
    c, h = 128, 2
    fc, fc_t = _bf16(rng, (b, n, c), 2.0, 1.0)
    fcs, fcs_t = _bf16(rng, (b, n, c), 3.0, -1.0)
    wf, wf_t = _bf16(rng, (h, 64, 64), 1 / 16)
    fb, fb_t = _bf16(rng, (h, 64), 1 / 16)
    k, k_t = _bf16(rng, (b, m, c), 0.35)
    v, v_t = _bf16(rng, (b, m, c), 0.3, 3.0)
    stats = torch.stack([*instance_norm_stats(fc_t.float()),
                         *instance_norm_stats(fcs_t.float())], 1)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jax_fused_prologue(
            _jnp(fc), _jnp(fcs), jnp.asarray(stats.numpy()), _jnp(wf),
            _jnp(fb), _jnp(k), _jnp(v)).astype(jnp.float32))
    got = mhada_fused_prologue_plain(fc_t, fcs_t, stats, wf_t, fb_t, k_t,
                                     v_t)
    assert got.dtype == BF16 and got.shape == ref.shape == (b, n, c)
    err = np.abs(got.float().numpy() - ref).max()
    assert err <= _step(np.abs(ref).max()), err


@pytest.mark.parametrize("b,n,m", [(1, 128, 256), (2, 96, 160)])
def test_mhada_tm_bf16_twin_matches_pallas(b, n, m):
    """K4's plain version at bf16 against mhada_attention_pallas (the
    single-pass _kernel): within one bf16 step of the output's largest
    value (a step is 0.03125 at max |out| 4.2-4.4 here).  The twin before
    the repair (softmax normalised in float32 before the product, P and V^2
    kept in float32) was 0.0469 and 0.0625 off (1.5 and 2 steps); the
    repaired twin is 0.0156 off at both shapes (half a step)."""
    rng = np.random.default_rng((b, n, m, 4))
    c, heads = 128, 2
    q, q_t = _bf16(rng, (b, n, c), 0.35)
    k, k_t = _bf16(rng, (b, m, c), 0.35)
    v, v_t = _bf16(rng, (b, m, c), 0.3, 3.0)
    f, f_t = _bf16(rng, (b, n, c))

    def head_major(a):
        return _jnp(a.reshape(a.shape[0], a.shape[1], heads, -1)
                    .transpose(0, 2, 1, 3))

    with pltpu.force_tpu_interpret_mode():
        ref = mhada_attention_pallas(*map(head_major, (q, k, v, f)))
    ref = np.asarray(ref.astype(jnp.float32)).transpose(0, 2, 1, 3)
    ref = ref.reshape(b, n, c)
    got = mhada_tm_plain(q_t, k_t, v_t, f_t, heads)
    assert got.dtype == BF16 and got.shape == (b, n, c)
    err = np.abs(got.float().numpy() - ref).max()
    assert err <= _step(np.abs(ref).max()), err


@pytest.mark.parametrize("b,n,m", [(1, 128, 128), (2, 96, 160)])
def test_mhada_train_bf16_twin_matches_pallas(b, n, m):
    """K7's plain forward and backward at bf16 against mhada_tm_train and
    its VJP: the output within one bf16 step of its largest value, the
    gradients within GRAD_REL.  The twin before the repair (neither P nor
    V^2 rounded) was 3 and 2 steps off in the output (half a step now)."""
    rng = np.random.default_rng((b, n, m, 7))
    c, heads = 128, 2
    q, q_t = _bf16(rng, (b, n, c), 0.35)
    k, k_t = _bf16(rng, (b, m, c), 0.35)
    v, v_t = _bf16(rng, (b, m, c), 0.3, 3.0)
    f, f_t = _bf16(rng, (b, n, c))
    cot, cot_t = _bf16(rng, (b, n, c))
    with pltpu.force_tpu_interpret_mode():
        ref, vjp = jax.vjp(lambda *a: mhada_tm_train(*a, heads),
                           *map(_jnp, (q, k, v, f)))
        g_ref = [np.asarray(g.astype(jnp.float32)) for g in vjp(_jnp(cot))]
    ref = np.asarray(ref.astype(jnp.float32))
    leaves = [t.requires_grad_() for t in (q_t, k_t, v_t, f_t)]
    out = mhada_train(*leaves, heads)
    out.backward(cot_t)
    assert out.dtype == BF16
    err = np.abs(out.detach().float().numpy() - ref).max()
    assert err <= _step(np.abs(ref).max()), err
    for (name, bound), t, g in zip(GRAD_REL.items(), leaves, g_ref):
        rel = np.linalg.norm(t.grad.float().numpy() - g) / np.linalg.norm(g)
        assert rel <= bound, (name, rel)


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_mhada_library_yardstick_is_m1_and_e2():
    """chip_smoke.py's library call for K3, K4 and K7 (SDPA on [V | V^2],
    scale 1), split into its two halves, is the float32 twin's M1 and E2."""
    rng = np.random.default_rng(5)
    b, n, m, heads = 2, 70, 130, 2
    q, k = (torch.from_numpy(rng.standard_normal((b, t, 128)).astype(
        np.float32) * 0.35) for t in (n, m))
    v, f = (torch.from_numpy(rng.standard_normal((b, t, 128)).astype(
        np.float32)) for t in (m, n))
    both = _chip_smoke().mhada_sdpa(q, k, v, heads)()
    assert both.shape == (b, heads, n, 128)
    _, m1, e2, _ = mhada_train_fwd_plain(q, k, v, f, heads)
    for half, want in zip(both.split(64, dim=-1), (m1, e2)):
        torch.testing.assert_close(
            half.transpose(1, 2).reshape(b, n, 128), want, rtol=1e-5,
            atol=1e-5)
