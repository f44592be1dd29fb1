"""A CPU model of the float32 flash backward (csrc/flash_bwd_f32.cuh), which
K6's and K7's float32 backward launch (and K12's and K11's at 4096 and 16384
tokens), against the Pallas backwards in interpret mode (K6: the VJP of
``attention_tm_train``, ``_attn_tm_bwd_impl``, attention_pallas.py:351; K7:
the VJP of ``mhada_tm_train``, ``_mhada_tm_bwd_impl``, mhada_pallas.py:468),
against the plain float32 versions and against float64 gradients.

The model replays the two kernels' schedule in torch, on the plain forward's
lse and the wrapper's delta (as the kernels are given them): the dQ kernel's
blocks of 128 query rows (rows past n zero, lse = +inf) stream key tiles of
64 (keys past m zero-filled, masked in the ragged last tile only); the dK/dV
kernel's blocks of 128 keys (keys past m zero-filled, never masked: their
rows are not written) stream query tiles of 64 (rows past n zero, lse =
+inf).  P is 2^(S scale log2 e - lse log2 e); dP = G1 V^T (+ G2 (V^2)^T);
dS = P (dP - delta) scale; each block sums its tiles in order, one tile's
product at a time; K7's dV = P^T G1 + 2 V (P^T G2).  Shapes: ragged L = 300
and 1 (K6, B = 2 and 1; N(0, 1) inputs at scale 1/8), N x M = 300 x 260
and 1 x 63 (K7, B = 2 and 1), q and k at input scale 0.35 (the MHAda
softmax is unscaled), and for K7 also V = 3 + 0.3 N(0, 1), where E2 - M1^2
cancels.

Both tests run as the P2 probe test does (tests/interpret_diagnostics.py):
the TPU interpreter starts from fresh state (a kernel that raised in an
earlier file of the worker leaves its memory behind), the torch side (the
model, the plain versions, the float64 gradients) runs on the calling
thread rounding to nearest (torch's intra-op threads keep the rounding
mode of the thread that started them: under a directed mode the model
moves 3.1e-6 to 3.3e-6 from float64 in the K6 test at L = 300, past its
1.7e-6 bound, while the interpreted kernel stays 5e-7 off; measured on the
CPU), and a failure names the assertion, the gradient, each side's
distance from float64, the worker and its floating-point state."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F
from jax.experimental.pallas import tpu as pltpu

from interpret_diagnostics import (explain, fresh_interpreter,
                                   interpreter_busy, nearest_on_this_thread,
                                   worker_state)
from mhada_tpu.ops.attention_pallas import attention_tm_train
from mhada_tpu.ops.mhada_pallas import mhada_tm_train
from mhada_tpu_torch.ops.attention_train import (attention_train_bwd_plain,
                                                 attention_train_fwd_plain,
                                                 row_delta)
from mhada_tpu_torch.ops.mhada_train import (mhada_train_bwd_plain,
                                             mhada_train_fwd_plain,
                                             mhada_train_prologue)

# Six test workers share the CPU: cap torch's intra-op threads.
torch.set_num_threads(2)

ROWS, TILE, LOG2E = 128, 64, 1.4426950408889634
HEADS = 2
# Against the Pallas backward and the plain versions: as
# tests/test_torch_train_kernels.py:49 holds the gradients.
ATOL, RTOL = 1e-3, 1e-2


def _pad(x, rows, dim=2):
    """x padded with zero rows along ``dim`` to ``rows``."""
    pad = [0, 0] * (x.dim() - 1 - dim) + [0, rows - x.shape[dim]]
    return F.pad(x, pad)


def _blocks(n, size):
    return [(r0, min(size, n - r0)) for r0 in range(0, n, size)]


def flash_bwd_model(q, k, v, g1, g2, lse, delta, scale):
    """The two kernels on head-major float32 q, g1, g2 (B, H, N, 64), k, v
    (B, H, M, 64), lse, delta (B, H, N); g2 None for K6 -> dq, dk, dv."""
    n, m = q.shape[2], k.shape[2]
    c = torch.tensor(scale * LOG2E, dtype=torch.float32)
    # rows past n: lse = +inf, so P = 0
    lse2 = lse * LOG2E

    def tile_rows(x, r0, rows, size, fill=0.0):
        out = x[:, :, r0:r0 + rows]
        if fill:
            return F.pad(out, (0, size - rows), value=fill)
        return _pad(out, size)

    # the dQ kernel: 128 query rows a block, key tiles of 64
    dq = torch.empty_like(q)
    for q0, rows in _blocks(n, ROWS):
        qb, g1b = (tile_rows(x, q0, rows, ROWS) for x in (q, g1))
        g2b = None if g2 is None else tile_rows(g2, q0, rows, ROWS)
        lb = tile_rows(lse2, q0, rows, ROWS, fill=torch.inf)[..., None]
        db = tile_rows(delta, q0, rows, ROWS)[..., None]
        acc = torch.zeros_like(qb)
        for t0, keys in _blocks(m, TILE):
            ks, vs = (tile_rows(x, t0, keys, TILE) for x in (k, v))
            s = qb @ ks.transpose(-1, -2)
            dp = g1b @ vs.transpose(-1, -2)
            if g2b is not None:   # one 128-deep product of [G1 | G2]
                dp = dp + g2b @ (vs * vs).transpose(-1, -2)
            p = torch.exp2(s * c - lb)
            if keys < TILE:       # the ragged last tile only
                p[..., keys:] = 0
            ds = p * (dp - db) * scale
            acc = acc + ds @ ks
        dq[:, :, q0:q0 + rows] = acc[:, :, :rows]

    # the dK/dV kernel: 128 keys a block, query tiles of 64; keys past m
    # are zero-filled and never masked
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    for k0, keys in _blocks(m, ROWS):
        kb, vb = (tile_rows(x, k0, keys, ROWS) for x in (k, v))
        dkb, dv1, dv2 = (torch.zeros_like(kb) for _ in range(3))
        for t0, rows in _blocks(n, TILE):
            qs, g1s = (tile_rows(x, t0, rows, TILE) for x in (q, g1))
            ls = tile_rows(lse2, t0, rows, TILE, fill=torch.inf)[..., None, :]
            ds_ = tile_rows(delta, t0, rows, TILE)[..., None, :]
            st = kb @ qs.transpose(-1, -2)             # S^T: keys by queries
            dpt = vb @ g1s.transpose(-1, -2)
            if g2 is not None:   # V^2 squared as the product reads it
                g2s = tile_rows(g2, t0, rows, TILE)
                dpt = dpt + (vb * vb) @ g2s.transpose(-1, -2)
            pt = torch.exp2(st * c - ls)
            dst = pt * (dpt - ds_) * scale
            dv1 = dv1 + pt @ g1s
            if g2 is not None:
                dv2 = dv2 + pt @ g2s
            dkb = dkb + dst @ qs
        dvb = dv1 if g2 is None else dv1 + 2 * vb * dv2
        dk[:, :, k0:k0 + keys] = dkb[:, :, :keys]
        dv[:, :, k0:k0 + keys] = dvb[:, :, :keys]
    return dq, dk, dv


def _heads(x):
    b, n, c = x.shape
    return x.reshape(b, n, HEADS, c // HEADS).transpose(1, 2)


def _token_major(x):
    b, h, n, d = x.shape
    return x.transpose(1, 2).reshape(b, n, h * d)


def _pallas(fn, stale):
    """fn() in TPU interpret mode -> its result; a kernel that raises is
    reported with the worker's state."""
    try:
        with pltpu.force_tpu_interpret_mode():
            return fn()
    except Exception as e:
        raise AssertionError(f"the Pallas kernel raised in interpret mode: "
                             f"{e!r}; {worker_state(stale)}") from e


def _check(got, ref, plain, exact, stale):
    """got, ref, plain, exact: lists of (B, L, C) gradients (dq, dk, dv);
    stale: whether the interpreter held state when the test started.
    The model may be at most twice as far from float64 as the Pallas
    backward, plus a floor of 2^-20 (four float32 units in the last place)
    of the largest exact gradient: with one token, dq and dk are zero in
    exact arithmetic and the Pallas backward gives exactly 0; with one
    query row, the exponent in log2 units rounds lse log2 e (about 6 at M =
    63) to 2^-24 of itself, which moves P, and dk with it, by some 1e-6 of
    dk's scale, where the Pallas backward's exp(S - lse) comes to 2e-7."""
    floor = 2.0 ** -20 * max(np.abs(e).max() for e in exact)
    state = worker_state(stale)
    for name, g, r, p, e in zip(("dq", "dk", "dv"), got, ref, plain, exact):
        assert g.shape == r.shape == p.shape == e.shape, (name, state)
        assert np.isfinite(g).all(), (name, state)
        np.testing.assert_allclose(g, r, atol=ATOL, rtol=RTOL, err_msg=(
            f"{name}, model against the Pallas backward: "
            + explain(g, r, state, e, ATOL)))
        np.testing.assert_allclose(g, p, atol=ATOL, rtol=RTOL, err_msg=(
            f"{name}, model against the plain backward: "
            + explain(g, p, state, e, ATOL)))
        err, err_ref = np.abs(g - e).max(), np.abs(r - e).max()
        assert err <= 2 * err_ref + floor, (
            f"{name}: the model {err:.3e} from float64, past 2 x the Pallas "
            f"backward's {err_ref:.3e} + {floor:.3e}; the plain backward "
            f"{np.abs(p - e).max():.3e}; {state}")


@pytest.mark.parametrize("b,n", [(2, 300), (1, 1)])
def test_k6_flash_bwd_model_matches_pallas(b, n):
    rng = np.random.default_rng((121, b, n))
    c, scale = 64 * HEADS, 0.125
    # N(0, 1): the scaled logits' std near 1
    qkv = rng.standard_normal((b, n, 3 * c)).astype(np.float32)
    cot = rng.standard_normal((b, n, c)).astype(np.float32)
    stale = interpreter_busy()
    fresh_interpreter()

    def pallas():
        _, vjp = jax.vjp(lambda x: attention_tm_train(x, scale, HEADS),
                         jnp.asarray(qkv))
        return vjp(jnp.asarray(cot))[0]

    ref = np.split(np.asarray(_pallas(pallas, stale)), 3, axis=-1)

    x, g = torch.from_numpy(qkv), torch.from_numpy(cot)
    with nearest_on_this_thread():
        out, lse = attention_train_fwd_plain(x, HEADS, scale)
        delta = row_delta(g, out, HEADS)
        q, k, v = (_heads(t) for t in x.chunk(3, dim=-1))
        got = flash_bwd_model(q, k, v, _heads(g), None, lse, delta, scale)
        got = [_token_major(t).numpy() for t in got]
        plain = [t.numpy() for t in attention_train_bwd_plain(
            x, lse, delta, g, HEADS, scale).chunk(3, dim=-1)]

        x64 = x.double().requires_grad_()
        q, k, v = (_heads(t) for t in x64.chunk(3, dim=-1))
        o = torch.softmax(q @ k.transpose(-1, -2) * scale, -1) @ v
        _token_major(o).backward(g.double())
        exact = np.split(x64.grad.numpy(), 3, axis=-1)
    _check(got, ref, plain, exact, stale)


@pytest.mark.parametrize("b,n,m,shift", [(2, 300, 260, 0.0), (1, 1, 63, 0.0),
                                         (2, 300, 260, 3.0),
                                         (1, 1, 63, 3.0)])
def test_k7_flash_bwd_model_matches_pallas(b, n, m, shift):
    rng = np.random.default_rng((127, b, n, m, int(shift)))
    c = 64 * HEADS
    q = (rng.standard_normal((b, n, c)) * 0.35).astype(np.float32)
    k = (rng.standard_normal((b, m, c)) * 0.35).astype(np.float32)
    v = (rng.standard_normal((b, m, c)) * (0.3 if shift else 1.0)
         + shift).astype(np.float32)
    f, cot = (rng.standard_normal((b, n, c)).astype(np.float32)
              for _ in range(2))
    fj = jnp.asarray(f)
    stale = interpreter_busy()
    fresh_interpreter()

    def pallas():
        _, vjp = jax.vjp(lambda *a: mhada_tm_train(*a, fj, HEADS),
                         *map(jnp.asarray, (q, k, v)))
        return vjp(jnp.asarray(cot))

    ref = [np.asarray(t) for t in _pallas(pallas, stale)]

    t = {key: torch.from_numpy(a) for key, a in
         dict(q=q, k=k, v=v, f=f, cot=cot).items()}
    with nearest_on_this_thread():
        _, m1, e2, lse = mhada_train_fwd_plain(t["q"], t["k"], t["v"],
                                               t["f"], HEADS)
        dm1, de2, delta, _ = mhada_train_prologue(t["cot"], t["f"], m1, e2,
                                                  HEADS, torch.float32)
        got = flash_bwd_model(*(_heads(t[key]) for key in "qkv"),
                              _heads(dm1), _heads(de2), lse, delta, 1.0)
        got = [_token_major(x).numpy() for x in got]
        plain = [x.numpy() for x in mhada_train_bwd_plain(
            t["q"], t["k"], t["v"], dm1, de2, lse, delta, HEADS)]

        leaves = [t[key].double().requires_grad_() for key in "qkv"]
        qh, kh, vh = (_heads(x) for x in leaves)
        a = torch.softmax(qh @ kh.transpose(-1, -2), -1)
        m1_, e2_ = a @ vh, a @ (vh * vh)
        o = (torch.sqrt(torch.clamp(e2_ - m1_ * m1_, min=1e-6))
             * _heads(t["f"].double()) + m1_)
        _token_major(o).backward(t["cot"].double())
        exact = [x.grad.numpy() for x in leaves]
    _check(got, ref, plain, exact, stale)
