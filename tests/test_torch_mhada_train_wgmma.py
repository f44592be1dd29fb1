"""K7 at bfloat16 on the wgmma + TMA kernels (csrc/mhada_wgmma.cuh with its
residual epilogue, csrc/mhada_combine.cuh, csrc/mhada_bwd_wgmma.cuh), CPU.

Torch models of the kernels' schedules replay what they compute:

- the forward: K4's split schedule (tests/test_torch_mhada_split.py's
  ``split_model``: 192-query blocks, split s walking key tiles [s T / S,
  (s + 1) T / S), P rounded to bf16 against the split's running maximum, V^2
  each bf16 squared and rounded, float32 partials), then the combine in a
  fixed order with the residuals: M1 = sum_s w_s O1_s / L, E2 likewise and
  the row lse = ln 2 max_s m_s + log L (one split: the unsplit epilogue's M1
  = O1 / l, E2 = O2 / l, lse = m + log l);
- the backward: the dQ kernel's walk over 64-key tiles (S = Q K^T, P =
  exp(S - lse) with the keys past M masked, dP = [G1 | G2] [V | V^2]^T, dS =
  P (dP - delta), dQ += bf16(dS) K, float32 sums) and the dK / dV kernel's
  walk over 64-query tiles, rows past N zero with lse and delta 0 (S^T, P^T,
  dP^T, dS^T as above, [dV1 | dV2] += bf16(P^T) [G1 | G2], dK += bf16(dS^T)
  Q; dV = dV1 + 2 V dV2 in float32), each rounded once to bf16.

They are held against the TPU kernels in interpret mode: the forward
against ``_mhada_tm_fwd_impl(with_res=True)`` (_tm_res_kernel,
mhada_pallas.py:336) up to 2048 keys and the head-major K10 with residuals
(``_mhada_stream_fwd_impl(with_res=True)``, :622) above, the backward
against ``_mhada_tm_bwd_impl`` (_mhada_tm_bwd_kernel, :468) and above 2048
keys K11 (``_mhada_stream_bwd_impl``, :903 and :925), each fed the same
forward residuals; and against the port's plain versions
(``mhada_train_fwd_plain``, ``mhada_train_bwd_plain``).  Ragged N and M
(200 against 300 keys, 1000 against 3000), 1 to 3 splits, 2 and 4 heads.
Also ``mhada_combine_partials(residuals=True)`` against the model's combine
(and, without the last split, far off: chip_smoke.py's planted control),
``mhada_splits`` pinned at K7's gate shapes, the schedules unrounded in
float64 against autograd of the exact core, and the wrapper's refusals.

Inputs as tests/test_torch_mhada_bf16.py's: Q and K at scale 0.35 (the
softmax is unscaled), V = 3 + 0.3 N(0, 1), so that E2 - M1^2 cancels and
every place where two computations round differently shows.  Bounds, each
against the output's own largest value, in bf16 steps (the spacing of bf16
values there): the forward's out within 2 steps of every reference (K4's
bound: the tile rounds P against its split's running maximum, the
single-pass kernel and the plain version against the row's), M1 and E2
within 2 steps (float32 values of bf16-rounded P sums), the lse within 1e-5
relative (float32 everywhere); the backward's dQ, dK and dV within 2 steps
of the plain version (0.5 measured) and within 3 steps of the TPU kernels,
their mean error within 0.01 steps: the same rounding points, sums in
another order, and K11 takes exp where the model takes exp2, so a float32 dS
a unit apart rounds to bf16 the other way now and then: in one of the 1000
rows at 3000 keys, whose P sits on a few keys, that moves dQ by 2.68 steps
(0.5 at most elsewhere, 0.002 steps on average; the model with its bf16
operand points left out is 20 steps and 1.2 on average off); the float64
schedules within 1e-9 of the exact values.
"""

import functools
import math

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from mhada_tpu.ops.mhada_pallas import (_mhada_stream_bwd_impl,
                                        _mhada_stream_fwd_impl,
                                        _mhada_tm_bwd_impl,
                                        _mhada_tm_fwd_impl)
from mhada_tpu_torch.ops.key_split import KEY_TILE, split_partials
from mhada_tpu_torch.ops.mhada_kernel import (mhada_combine_partials,
                                              mhada_splits)
from mhada_tpu_torch.ops.mhada_train import (fwd_launch, mhada_train,
                                             mhada_train_bwd_plain,
                                             mhada_train_fwd_plain,
                                             mhada_train_prologue)
from test_torch_mhada_split import _step, split_model

# Six test workers share the CPU: cap torch's intra-op threads.
torch.set_num_threads(2)

BF16 = torch.bfloat16
D = 64
LOG2E = 1.4426950408889634
# queries of a dQ block and keys of a dK / dV block (mhada_bwd_wgmma.cuh)
DQ_ROWS, DKV_ROWS = 192, 128


def _bf16(rng, shape, scale=1.0, shift=0.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale + shift)
                            .astype(np.float32)).to(BF16)


@functools.cache
def _inputs(b, n, m, heads):
    """Seeded bf16 (q, k, v, fcs_n, g), token-major; g the cotangent."""
    rng = np.random.default_rng((b, n, m, heads, 25))
    c = heads * D
    return (_bf16(rng, (b, n, c), 0.35), _bf16(rng, (b, m, c), 0.35),
            _bf16(rng, (b, m, c), 0.3, 3.0), _bf16(rng, (b, n, c)),
            _bf16(rng, (b, n, c)))


def _hm(t, heads):
    """Token-major (B, L, H 64) -> head-major float32 (B, H, L, 64)."""
    b, n, _ = t.shape
    return t.float().reshape(b, n, heads, D).transpose(1, 2)


def _tm(t):
    """Head-major (B, H, L, 64) -> token-major (B, L, H 64)."""
    b, h, n, d = t.shape
    return t.transpose(1, 2).reshape(b, n, h * d)


def fwd_model(q, k, v, f, splits):
    """The forward's schedule on head-major float32 q, f (B, H, N, 64) and
    k, v (B, H, M, 64) holding bf16 values -> (out rounded to bf16, M1, E2
    token-major float32, lse (B, H, N)), and the partials (O (S, B, N, 2 C)
    = [O1 | O2], m_s, l_s) that a split writes."""
    _, o1, o2, m_s, l_s = split_model(q, k, v, f, splits)
    w = torch.exp2(m_s - m_s.amax(0))
    den = sum(w[s] * l_s[s] for s in range(splits))   # the fixed order
    m1 = sum(w[s][..., None] * o1[s] for s in range(splits)) / den[..., None]
    e2 = sum(w[s][..., None] * o2[s] for s in range(splits)) / den[..., None]
    lse = m_s.amax(0) * math.log(2.0) + torch.log(den)
    out = torch.sqrt(torch.clamp(e2 - m1.square(), min=1e-6)) * f + m1
    part = torch.cat([_tm(o1.flatten(0, 1)).unflatten(0, o1.shape[:2]),
                      _tm(o2.flatten(0, 1)).unflatten(0, o2.shape[:2])], -1)
    return (_tm(out).to(BF16).float(), _tm(m1), _tm(e2), lse), (part, m_s,
                                                                l_s)


def bwd_model(q, k, v, g1, g2, lse, delta, rounded=True):
    """The backward's two schedules on head-major float32 q, g1, g2 (B, H,
    N, 64), k, v (B, H, M, 64) holding bf16 values, lse, delta (B, H, N) ->
    token-major (dq, dk, dv) in float32 before their one rounding.
    ``rounded=False``: no bf16 operand points (the schedule alone)."""
    def rnd(x):
        return x.to(BF16).float() if rounded else x

    b, h, n, d = q.shape
    m = k.shape[2]
    v2 = rnd(v.square())
    # dQ: 64-key tiles in order; K and V zero past M, P masked there
    kt = -(-m // KEY_TILE)
    kp, vp, v2p = (torch.nn.functional.pad(t, (0, 0, 0, kt * KEY_TILE - m))
                   for t in (k, v, v2))
    dq = torch.zeros_like(q)
    for j in range(kt):
        ks, vs, v2s = (t[:, :, j * KEY_TILE:(j + 1) * KEY_TILE]
                       for t in (kp, vp, v2p))
        p = torch.exp2(q @ ks.transpose(-1, -2) * LOG2E
                       - (lse * LOG2E)[..., None])
        p[..., max(0, m - j * KEY_TILE):] = 0.0
        dp = g1 @ vs.transpose(-1, -2) + g2 @ v2s.transpose(-1, -2)
        dq = dq + rnd(p * (dp - delta[..., None])) @ ks
    # dK / dV: 64-query tiles in order; Q, G1, G2 zero past N, lse and
    # delta 0 there (P^T = 1, dS^T = 0: nothing added)
    qt = -(-n // KEY_TILE)
    pad = qt * KEY_TILE - n
    qp, g1p, g2p = (torch.nn.functional.pad(t, (0, 0, 0, pad))
                    for t in (q, g1, g2))
    lp, dlp = (torch.nn.functional.pad(t, (0, pad)) for t in (lse, delta))
    dk, dv1, dv2 = (torch.zeros_like(k) for _ in range(3))
    for i in range(qt):
        rows = slice(i * KEY_TILE, (i + 1) * KEY_TILE)
        qs, g1s, g2s = qp[:, :, rows], g1p[:, :, rows], g2p[:, :, rows]
        pt = torch.exp2(k @ qs.transpose(-1, -2) * LOG2E
                        - (lp[:, :, rows] * LOG2E)[:, :, None])
        dpt = v @ g1s.transpose(-1, -2) + v2 @ g2s.transpose(-1, -2)
        dst = pt * (dpt - dlp[:, :, rows][:, :, None])
        dv1 = dv1 + rnd(pt) @ g1s
        dv2 = dv2 + rnd(pt) @ g2s
        dk = dk + rnd(dst) @ qs
    return _tm(dq), _tm(dk), _tm(dv1 + 2.0 * v * dv2)


@functools.cache
def _fwd_model(b, n, m, heads, splits):
    q, k, v, f, _ = _inputs(b, n, m, heads)
    return fwd_model(*(_hm(t, heads) for t in (q, k, v, f)), splits)


@functools.cache
def _jax_fwd(b, n, m, heads):
    """The TPU forward with residuals in interpret mode -> token-major
    (out, M1, E2) float32 and lse (B, H, N): _tm_res_kernel up to 2048
    keys, the head-major K10 with residuals (64-key blocks) above."""
    q, k, v, f, _ = _inputs(b, n, m, heads)
    with pltpu.force_tpu_interpret_mode():
        if m <= 2048:
            x = [jnp.asarray(t.float().numpy(), jnp.bfloat16)
                 for t in (q, k, v, f)]
            out, m1, e2, lse = _mhada_tm_fwd_impl(*x, heads, 256,
                                                  with_res=True)
            lse = np.asarray(lse)[:, :, ::D].transpose(0, 2, 1)
            res = out, m1, e2
        else:
            x = [jnp.asarray(_hm(t, heads).numpy(), jnp.bfloat16)
                 for t in (q, k, v)] + [jnp.asarray(_hm(f, heads).numpy())]
            out, m1e2, lse = _mhada_stream_fwd_impl(*x, 512, 256,
                                                    with_res=True)
            m1e2 = torch.from_numpy(np.array(m1e2))
            res = (_tm(torch.from_numpy(np.array(out.astype(jnp.float32)))),
                   _tm(m1e2[..., :D]), _tm(m1e2[..., D:]))
    return (*(torch.from_numpy(np.array(jnp.asarray(t, jnp.float32)))
              if not isinstance(t, torch.Tensor) else t for t in res),
            torch.from_numpy(np.array(lse)))


@functools.cache
def _bwd_operands(b, n, m, heads):
    """The backward's inputs from the TPU forward's residuals: (q, k, v,
    fcs_n, g, M1, E2, lse) as given and dM1, dE2 (bf16), delta from the
    port's prologue."""
    q, k, v, f, g = _inputs(b, n, m, heads)
    _, m1, e2, lse = _jax_fwd(b, n, m, heads)
    dm1, de2, delta, _ = mhada_train_prologue(g, f, m1, e2, heads, BF16)
    return q, k, v, f, g, m1, e2, lse, dm1, de2, delta


def _round(t):
    return t.to(BF16).float()


@functools.cache
def _bwd_model(b, n, m, heads):
    q, k, v, _, _, _, _, lse, dm1, de2, delta = _bwd_operands(b, n, m, heads)
    return tuple(_round(t) for t in bwd_model(
        *(_hm(t, heads) for t in (q, k, v, dm1, de2)), lse, delta))


@functools.cache
def _jax_bwd(b, n, m, heads):
    """The TPU backward in interpret mode on the same residuals -> token-
    major (dq, dk, dv) float32: _mhada_tm_bwd_kernel up to 2048 keys, K11
    above (512-query and 512-key blocks)."""
    q, k, v, f, g, m1, e2, lse, *_ = _bwd_operands(b, n, m, heads)
    with pltpu.force_tpu_interpret_mode():
        if m <= 2048:
            x = [jnp.asarray(t.float().numpy(), jnp.bfloat16)
                 for t in (q, k, v, f)]
            lse_tm = jnp.asarray(np.repeat(lse.transpose(1, 2).numpy(), D,
                                           axis=-1))
            grads = _mhada_tm_bwd_impl(
                *x, jnp.asarray(m1.numpy()), jnp.asarray(e2.numpy()),
                lse_tm, jnp.asarray(g.float().numpy(), jnp.bfloat16),
                heads)[:3]
            return tuple(torch.from_numpy(np.array(t.astype(jnp.float32)))
                         for t in grads)
        x = [jnp.asarray(_hm(t, heads).numpy(), jnp.bfloat16)
             for t in (q, k, v, f, g)]
        m1e2 = jnp.asarray(torch.cat([_hm(m1, heads), _hm(e2, heads)],
                                     -1).numpy())
        grads = _mhada_stream_bwd_impl(*x[:4], m1e2, jnp.asarray(lse.numpy()),
                                       x[4], 512, 512)[:3]
        return tuple(_tm(torch.from_numpy(np.array(t.astype(jnp.float32))))
                     for t in grads)


def _within(got, ref, steps, what, mean=None):
    """got within ``steps`` bf16 steps of ref's largest value (and its mean
    error within ``mean`` steps, if given)."""
    step = _step(ref.abs().max().item())
    err = (got.float() - ref.float()).abs()
    assert bool(torch.isfinite(got).all()) and got.shape == ref.shape, what
    assert err.max().item() <= steps * step, (what, err.max().item() / step)
    if mean is not None:
        assert err.mean().item() <= mean * step, (what, err.mean() / step)


# (splits, batch, queries, keys, heads): 300 keys are 5 tiles (the last of
# 44 keys) and 200 queries no whole 192-query block; 129 keys put one key
# in the last split of 3; 3000 keys (47 tiles, the last of 56) run above
# 2048, where the TPU's training route is K10 with residuals and K11.
FWD_CASES = [(1, 2, 200, 300, 2), (2, 2, 200, 300, 2), (3, 2, 200, 300, 4),
             (3, 1, 64, 129, 4), (1, 1, 1000, 3000, 2), (3, 1, 1000, 3000, 2)]


@pytest.mark.parametrize("splits,b,n,m,heads", FWD_CASES)
def test_fwd_model_matches_tpu_forward_and_plain(splits, b, n, m, heads):
    """The forward's schedule (split or not, the combine with the
    residuals) against the TPU forward with residuals in interpret mode and
    the plain version: out, M1 and E2 within two bf16 steps, the lse within
    1e-5 relative; every split's maximum finite and its sum at least 1."""
    (out, m1, e2, lse), (_, m_s, l_s) = _fwd_model(b, n, m, heads, splits)
    assert torch.isfinite(m_s).all() and bool((l_s >= 1).all())
    x = _inputs(b, n, m, heads)[:4]
    plain = mhada_train_fwd_plain(*x, heads)
    for ref in (_jax_fwd(b, n, m, heads), plain):
        for name, got, want in zip(("out", "M1", "E2"), (out, m1, e2), ref):
            _within(got, want, 2, name)
        rel = ((lse - ref[3]).abs().max() / ref[3].abs().max()).item()
        assert rel <= 1e-5, rel


# (batch, queries, keys, heads) of the backward: ragged N and M, 2 and 4
# heads, below and above 2048 keys.
BWD_CASES = [(2, 200, 300, 2), (1, 64, 129, 4), (1, 300, 1000, 4),
             (1, 1000, 3000, 2)]


@pytest.mark.parametrize("b,n,m,heads", BWD_CASES)
def test_bwd_model_matches_tpu_backward(b, n, m, heads):
    """The backward's two schedules against the TPU backward in interpret
    mode (_mhada_tm_bwd_kernel to 2048 keys, K11 above) on the same
    forward residuals: dq, dk and dv within three bf16 steps each, their
    mean error within 0.01 steps."""
    got = _bwd_model(b, n, m, heads)
    for name, g, r in zip(("dq", "dk", "dv"), got, _jax_bwd(b, n, m, heads)):
        _within(g, r, 3, name, mean=0.01)


@pytest.mark.parametrize("b,n,m,heads", BWD_CASES[:3])
def test_bwd_model_matches_plain(b, n, m, heads):
    """The backward's schedules against the port's plain backward on the
    same operands, within two bf16 steps; on the CPU the autograd Function
    takes the plain versions (its gradients are the plain backward's)."""
    q, k, v, f, g, _, _, _, dm1, de2, delta = _bwd_operands(b, n, m, heads)
    lse = _bwd_operands(b, n, m, heads)[7]
    plain = mhada_train_bwd_plain(q, k, v, dm1, de2, lse, delta, heads)
    for name, got, ref in zip(("dq", "dk", "dv"), _bwd_model(b, n, m, heads),
                              plain):
        _within(got, ref, 2, name)
    leaves = [t.clone().requires_grad_() for t in (q, k, v, f)]
    mhada_train(*leaves, heads).backward(g)
    _, m1, e2, lse = mhada_train_fwd_plain(q, k, v, f, heads)
    dm1, de2, delta, _ = mhada_train_prologue(g, f, m1, e2, heads, BF16)
    want = mhada_train_bwd_plain(q, k, v, dm1, de2, lse, delta, heads)
    for leaf, w in zip(leaves, want):
        assert torch.equal(leaf.grad, w)


def test_schedules_are_exact():
    """Both schedules without their roundings, in float64: the forward's
    split walk and combine give softmax(Q K^T) V, its square's and the row
    lse, and the backward's two walks give autograd's dq, dk and dv of the
    exact core from dM1, dE2 (delta = the row sum of dM1 M1 + dE2 E2), each
    within 1e-9 of its largest value."""
    b, n, m, heads = 1, 200, 300, 2
    q, k, v, f, g = (_hm(t, heads).double() for t in _inputs(b, n, m, heads))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    _, o1, o2, m_s, l_s = split_model(q.detach(), k.detach(), v.detach(), f,
                                      3, rounded=False)
    w = torch.exp2(m_s - m_s.amax(0))
    den = (w * l_s).sum(0)
    a = torch.softmax(q @ k.transpose(-1, -2), -1)
    m1, e2 = a @ v, a @ v.square()
    lse = torch.logsumexp(q @ k.transpose(-1, -2), -1)
    for got, want in (((w[..., None] * o1).sum(0) / den[..., None], m1),
                      ((w[..., None] * o2).sum(0) / den[..., None], e2),
                      (m_s.amax(0) * math.log(2.0) + torch.log(den), lse)):
        assert (got - want).abs().max() <= 1e-9 * want.abs().max()
    g1, g2 = g, 0.5 * g.flip(-1)
    delta = (g1 * m1 + g2 * e2).sum(-1).detach()
    want = torch.autograd.grad((m1 * g1 + e2 * g2).sum(), (q, k, v))
    got = bwd_model(q.detach(), k.detach(), v.detach(), g1, g2, lse.detach(),
                    delta, rounded=False)
    for gt, wt in zip(got, want):
        wt = _tm(wt)
        assert (gt - wt).abs().max() <= 1e-9 * wt.abs().max()


@pytest.mark.parametrize("splits", [2, 3])
def test_combine_partials_with_residuals(splits):
    """``mhada_combine_partials(residuals=True)`` on the model's partials,
    through the buffer's layout (``split_partials``, [O1 | O2] a row),
    repeats the model's combine: out within one bf16 step, M1 and E2 within
    1e-6 relative, the lse within 1e-6; without the last split out, M1, E2
    and the lse are far off (the planted control of chip_smoke.py)."""
    b, n, m, heads = 2, 200, 300, 2
    (out, m1, e2, lse), (o, m_s, l_s) = _fwd_model(b, n, m, heads, splits)
    f = _inputs(b, n, m, heads)[3]
    part = torch.cat([o.reshape(-1), m_s.reshape(-1), l_s.reshape(-1)])
    views = split_partials(part, splits, b, n, 2 * heads * D, heads)
    got = mhada_combine_partials(*views, f, BF16, residuals=True)
    assert got[0].dtype == BF16 and got[3].shape == (b, heads, n)
    _within(got[0], out, 1, "out")
    for g, want in zip(got[1:], (m1, e2, lse)):
        assert ((g - want).abs().max() / want.abs().max()) <= 1e-6
    dropped = mhada_combine_partials(*views, f, BF16, keep=splits - 1,
                                     residuals=True)
    for g, want in zip(dropped, (out, m1, e2, lse)):
        assert (g.float() - want).abs().max() > 1e-3 * want.abs().max()
    assert torch.equal(mhada_combine_partials(*views, f, BF16), got[0])


def test_k7_splits_pinned():
    """The counts K7's forward takes at its gate shapes (8 heads; the TP
    share: 4) on an H100's 132 SMs: (B, heads, N, M) -> splits.  The
    steps' shapes run unsplit; B = 1 at 16384 and at inversion's 1024
    tokens, and the video TP share, split."""
    shapes = {(8, 8, 1024, 1024): 1, (4, 8, 4096, 4096): 1,
              (1, 8, 16384, 16384): 2, (2, 8, 2048, 1024): 1,
              (1, 8, 1024, 1024): 2, (2, 8, 1000, 3000): 1,
              (4, 4, 1024, 1024): 1, (1, 4, 2048, 1024): 3,
              (1, 4, 3600, 1024): 1}
    assert {s: mhada_splits(*s, 132) for s in shapes} == shapes


@pytest.mark.parametrize("case", ["splits", "shapes", "cpu"])
def test_fwd_launch_refusals(case):
    """K7's launch refuses a forced count that leaves a split without a key
    tile before it asks for the card, and tensors off the card; the public
    wrapper refuses mismatched shapes on every device, and takes the plain
    versions on the CPU whatever the head dim (the kernels' 64 is checked
    on the card)."""
    q, k, v, f, _ = _inputs(1, 64, 129, 2)
    if case == "splits":
        for bad in (0, 4):
            with pytest.raises(ValueError, match="without a 64-key tile"):
                fwd_launch(q, k, v, f, 2, splits=bad)
    elif case == "shapes":
        with pytest.raises(ValueError, match="bad shapes"):
            mhada_train(q, k, v[:, :-1], f, 2)
        with pytest.raises(ValueError, match="bad shapes"):
            mhada_train(q, k, v, f[:, :-1], 2)
    else:
        with pytest.raises(ValueError, match="CUDA"):
            fwd_launch(q, k, v, f, 2)
        out = mhada_train(q, k, v, f, 4)   # head dim 32: plain on the CPU
        assert torch.equal(out, mhada_train_fwd_plain(q, k, v, f, 4)[0])
