"""K6's backward at bfloat16 on the wgmma + TMA pair
(csrc/attention_bwd_wgmma.cuh), CPU.

A torch model of the two kernels' walks replays what they compute, per
(b, h), on the packed qkv with the forward's lse and the wrapper's delta:

- the dQ kernel (blocks of 128 queries, 64 a consumer): key tiles of 64 in
  order, K and V zero past L; S = Q K^T, P = 2^(S scale log2 e - lse log2
  e) with the keys past L masked in the ragged last tile, dP = dO V^T, dS =
  P (dP - delta) scale, dQ += bf16(dS) K, float32 sums;
- the dK / dV kernel (blocks of 128 keys, 64 a consumer, keys past L zero
  and never masked: their rows are not stored): query tiles of 64 in
  order, Q and dO zero past L with lse and delta 0 there (P^T = 1, dS^T =
  0: nothing added); S^T = K Q^T, P^T, dP^T = V dO^T, dS^T as above, dV +=
  bf16(P^T) dO, dK += bf16(dS^T) Q;

each gradient rounded once to bf16.  It is held against the TPU backward
in interpret mode, fed the same lse and dO (and the forward's out, from
which it forms delta as the port does): ``_attn_tm_bwd_impl``
(_tm_bwd_kernel, attention_pallas.py:351), which the VJP of
``attention_tm_train`` runs up to 2048 tokens, and above them K12's flash
backward (``_attn_stream_bwd_impl``: dQ at :868, dK / dV at :888); and
against the port's plain backward (``attention_train_bwd_plain``).  Ragged
L (300, 1000 and 2200 tokens: no 64-row tile or 128-row block divides
them), 2 and 4 heads, B = 1 and 2.  Also the
walks unrounded in float64 against autograd of exact attention, and the
wrapper's refusals.

Inputs: qkv and dO N(0, 1) in bf16, scale 1/8 (the ViT's).  Bounds, each
against the output's own largest value, in bf16 steps (the spacing of bf16
values there): dq, dk and dv within 2 steps of the plain version and of
the TPU kernels (0.5 measured), their mean error within 0.01 steps (3e-4
measured): the same rounding points, sums in another order, and the TPU
kernels take exp where the model takes exp2, so a float32 P or dS a unit
apart rounds to bf16 the other way now and then; the float64 walks within
1e-9 of the exact gradients.

Every comparison with a Pallas kernel runs as the P2 probe test's does
(tests/interpret_diagnostics.py): the interpreter starts from fresh state,
the torch side runs on the calling thread rounding to nearest, and a
failure names the largest error in steps, each side's distance from a
float64 evaluation, the worker and its floating-point state.
"""

import functools

import numpy as np
import pytest
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from interpret_diagnostics import (fresh_interpreter, interpreter_busy,
                                   nearest_on_this_thread, worker_state)
from mhada_tpu.ops.attention_pallas import (_attn_stream_bwd_impl,
                                            _attn_tm_bwd_impl)
from mhada_tpu_torch.ops.attention_train import (_bwd_kernel,
                                                 attention_train,
                                                 attention_train_bwd_plain,
                                                 attention_train_fwd_plain,
                                                 row_delta)
from test_torch_mhada_split import _step

# Six test workers share the CPU: cap torch's intra-op threads.
torch.set_num_threads(2)

BF16 = torch.bfloat16
D, TILE = 64, 64
LOG2E = 1.4426950408889634
SCALE = 0.125
# keys of a dK / dV block (attention_bwd_wgmma.cuh)
DKV_ROWS = 128

# (batch, tokens, heads): 300 tokens are 4 tiles and 44 (three 128-row
# blocks, the last of 44); 1000 are 15 tiles and 40; 2200 run above 2048,
# where the TPU's training route is K12's head-major flash backward.
CASES = [(2, 300, 2), (1, 1000, 4), (1, 2200, 2)]


def _hm(t, heads, dtype=torch.float32):
    """Token-major (B, L, H 64) -> head-major (B, H, L, 64) in ``dtype``."""
    b, n, _ = t.shape
    return t.to(dtype).reshape(b, n, heads, D).transpose(1, 2)


def _tm(t):
    """Head-major (B, H, L, 64) -> token-major (B, L, H 64)."""
    b, h, n, d = t.shape
    return t.transpose(1, 2).reshape(b, n, h * d)


def _pad(t, rows, dim=2):
    """t with zero rows appended along ``dim`` up to ``rows``."""
    pad = [0, 0] * (t.dim() - 1 - dim) + [0, rows - t.shape[dim]]
    return torch.nn.functional.pad(t, pad)


def bwd_model(q, k, v, g, lse, delta, scale, rounded=True):
    """The two kernels' walks on head-major float32 q, k, v, g = dO (B, H,
    L, 64) holding bf16 values, lse, delta (B, H, L) -> token-major (dq,
    dk, dv) in float32 before their one rounding.  ``rounded=False``: no
    bf16 operand points (the walks alone)."""
    def rnd(x):
        return x.to(BF16).float() if rounded else x

    n = q.shape[2]
    tiles = -(-n // TILE)
    c = torch.tensor(scale * LOG2E, dtype=q.dtype)
    lse2 = lse * torch.tensor(LOG2E, dtype=q.dtype)
    # the dQ kernel: every query row walks the key tiles in order; K and V
    # zero past L, P masked there (the ragged last tile); rows past L are
    # not stored, so the query blocks need not be padded
    kp, vp = (_pad(t, tiles * TILE) for t in (k, v))
    dq = torch.zeros_like(q)
    for j in range(tiles):
        ks, vs = (t[:, :, j * TILE:(j + 1) * TILE] for t in (kp, vp))
        p = torch.exp2(q @ ks.transpose(-1, -2) * c - lse2[..., None])
        p[..., max(0, n - j * TILE):] = 0.0
        dp = g @ vs.transpose(-1, -2)
        dq = dq + rnd(p * (dp - delta[..., None]) * scale) @ ks
    # the dK / dV kernel: every key row (keys past L computed, not stored)
    # walks the query tiles in order; Q and dO zero past L, lse and delta
    # 0 there
    blocks = -(-n // DKV_ROWS) * DKV_ROWS
    kb, vb = (_pad(t, blocks) for t in (k, v))
    qp, gp = (_pad(t, tiles * TILE) for t in (q, g))
    lp, dlp = (_pad(t, tiles * TILE, dim=2) for t in (lse2, delta))
    dk, dv = torch.zeros_like(kb), torch.zeros_like(vb)
    for i in range(tiles):
        rows = slice(i * TILE, (i + 1) * TILE)
        qs, gs = qp[:, :, rows], gp[:, :, rows]
        pt = torch.exp2(kb @ qs.transpose(-1, -2) * c
                        - lp[:, :, None, rows])
        dpt = vb @ gs.transpose(-1, -2)
        dst = pt * (dpt - dlp[:, :, None, rows]) * scale
        dv = dv + rnd(pt) @ gs
        dk = dk + rnd(dst) @ qs
    return _tm(dq), _tm(dk[:, :, :n]), _tm(dv[:, :, :n])


@functools.cache
def _inputs(b, n, heads):
    """Seeded bf16 (qkv, g), token-major, and the plain forward's (out,
    lse) and the wrapper's delta."""
    rng = np.random.default_rng((b, n, heads, 26))
    c = heads * D
    qkv, g = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(BF16) for shape in ((b, n, 3 * c), (b, n, c)))
    with nearest_on_this_thread():
        out, lse = attention_train_fwd_plain(qkv, heads, SCALE)
        delta = row_delta(g, out, heads)
    return qkv, g, out, lse, delta


@functools.cache
def _model(b, n, heads):
    qkv, g, _, lse, delta = _inputs(b, n, heads)
    q, k, v = (_hm(t, heads) for t in qkv.chunk(3, dim=-1))
    with nearest_on_this_thread():
        got = bwd_model(q, k, v, _hm(g, heads), lse, delta, SCALE)
    return tuple(t.to(BF16).float() for t in got)


@functools.cache
def _f64(b, n, heads):
    """The gradients of exact attention in float64 on the same bf16 qkv
    and dO, token-major (dq, dk, dv)."""
    qkv, g, *_ = _inputs(b, n, heads)
    with nearest_on_this_thread():
        x = qkv.double().requires_grad_()
        q, k, v = (_hm(t, heads, x.dtype) for t in x.chunk(3, dim=-1))
        o = torch.softmax(q @ k.transpose(-1, -2) * SCALE, -1) @ v
        _tm(o).backward(g.double())
    return tuple(x.grad.chunk(3, dim=-1))


@functools.cache
def _tpu(b, n, heads):
    """The TPU backward in interpret mode on the same qkv, out, lse and dO
    -> (token-major (dq, dk, dv) float32, the worker's state when it
    started): _tm_bwd_kernel up to 2048 tokens, K12's flash backward
    (512-query and 1024-key blocks) above."""
    qkv, g, out, lse, _ = _inputs(b, n, heads)
    stale = interpreter_busy()
    fresh_interpreter()

    def jx(t):
        return jnp.asarray(t.float().numpy(), jnp.bfloat16)

    try:
        with pltpu.force_tpu_interpret_mode():
            if n <= 2048:
                lse_tm = jnp.asarray(np.repeat(lse.transpose(1, 2).numpy(),
                                               D, axis=-1))
                grads = _attn_tm_bwd_impl(jx(qkv), jx(out), lse_tm, jx(g),
                                          SCALE, heads, 256)
                got = torch.from_numpy(np.array(grads.astype(jnp.float32)))
                return tuple(got.chunk(3, dim=-1)), worker_state(stale)
            q, k, v = (jx(_hm(t, heads)) for t in qkv.chunk(3, dim=-1))
            grads = _attn_stream_bwd_impl(q, k, v, jx(_hm(out, heads)),
                                          jnp.asarray(lse.numpy()),
                                          jx(_hm(g, heads)), SCALE, 512, 1024)
    except Exception as e:
        raise AssertionError(f"the Pallas kernel raised in interpret mode: "
                             f"{e!r}; {worker_state(stale)}") from e
    return (tuple(_tm(torch.from_numpy(np.array(t.astype(jnp.float32))))
                  for t in grads), worker_state(stale))


def _within(got, ref, steps, what, exact, state="", mean=None):
    """got within ``steps`` bf16 steps of ref's largest value (and its mean
    error within ``mean`` steps, if given); a failure names both sides'
    distance from the float64 gradient ``exact`` in steps."""
    step = _step(ref.abs().max().item())
    err = (got.float() - ref.float()).abs()
    sides = ", ".join(
        f"{name} {(x.double() - exact).abs().max().item() / step:.3f}"
        for name, x in (("got", got), ("ref", ref)))
    why = (f"{what}: max {err.max().item() / step:.3f} steps, mean "
           f"{err.mean().item() / step:.4f}; from float64: {sides} steps; "
           f"{state}")
    assert bool(torch.isfinite(got).all()) and got.shape == ref.shape, why
    assert err.max().item() <= steps * step, why
    if mean is not None:
        assert err.mean().item() <= mean * step, why


@pytest.mark.parametrize("b,n,heads", CASES)
def test_bwd_model_matches_tpu_backward(b, n, heads):
    """The two walks against the TPU backward in interpret mode
    (_tm_bwd_kernel up to 2048 tokens, K12's flash backward above) on the
    same lse and dO: dq, dk and dv within two bf16 steps each, their mean
    error within 0.01 steps."""
    ref, state = _tpu(b, n, heads)
    for name, got, r, e in zip(("dq", "dk", "dv"), _model(b, n, heads), ref,
                               _f64(b, n, heads)):
        _within(got, r, 2, name, e, state, mean=0.01)


@pytest.mark.parametrize("b,n,heads", CASES)
def test_bwd_model_matches_plain(b, n, heads):
    """The two walks against the port's plain backward on the same lse and
    delta, within two bf16 steps, their mean error within 0.01 steps; on
    the CPU the autograd Function takes the plain versions (its gradient is
    the plain backward's on the plain forward's residuals)."""
    qkv, g, _, lse, delta = _inputs(b, n, heads)
    with nearest_on_this_thread():
        plain = attention_train_bwd_plain(qkv, lse, delta, g, heads, SCALE)
    for name, got, ref, e in zip(("dq", "dk", "dv"), _model(b, n, heads),
                                 plain.chunk(3, dim=-1), _f64(b, n, heads)):
        _within(got, ref, 2, name, e, worker_state(None), mean=0.01)
    if n <= 1000:
        leaf = qkv.clone().requires_grad_()
        with nearest_on_this_thread():
            attention_train(leaf, heads, SCALE).backward(g)
        assert torch.equal(leaf.grad, plain)


@pytest.mark.parametrize("b,n,heads", [(2, 300, 2), (1, 130, 4)])
def test_walks_are_exact(b, n, heads):
    """Both walks without their roundings, in float64, on the exact lse and
    delta: autograd's dq, dk and dv of exact attention, each within 1e-9
    of its largest value (the ragged tile's mask, the zero rows past L and
    the unstored keys past L change nothing)."""
    qkv, g, *_ = _inputs(b, n, heads)
    x = qkv.double().requires_grad_()
    q, k, v = (_hm(t, heads, x.dtype) for t in x.chunk(3, dim=-1))
    s = q @ k.transpose(-1, -2) * SCALE
    o = torch.softmax(s, -1) @ v
    _tm(o).backward(g.double())
    gh = _hm(g, heads, x.dtype)
    lse = torch.logsumexp(s, -1).detach()
    delta = (gh * o).sum(-1).detach()
    got = bwd_model(q.detach(), k.detach(), v.detach(), gh, lse, delta,
                    SCALE, rounded=False)
    for gt, wt in zip(got, x.grad.chunk(3, dim=-1)):
        assert (gt - wt).abs().max() <= 1e-9 * wt.abs().max()


@pytest.mark.parametrize("case", ["cpu", "shape", "head_dim"])
def test_bwd_refusals(case):
    """The backward's launch refuses tensors off the card before it asks
    for one; the public wrapper refuses a qkv whose width does not split
    into the heads on every device, and takes the plain versions on the CPU
    whatever the head dim (the kernels' 64 is checked on the card)."""
    qkv, g, _, lse, delta = _inputs(2, 300, 2)
    if case == "cpu":
        with pytest.raises(ValueError, match="CUDA"):
            _bwd_kernel(qkv, lse, delta, g, 2, SCALE)
    elif case == "shape":
        with pytest.raises(ValueError, match="bad qkv shape"):
            attention_train(qkv[..., :-3], 2)
    else:
        leaf = qkv.clone().requires_grad_()
        attention_train(leaf, 4, SCALE).backward(g)   # head dim 32
        out, lse4 = attention_train_fwd_plain(qkv, 4, SCALE)
        want = attention_train_bwd_plain(qkv, lse4, row_delta(g, out, 4), g,
                                         4, SCALE)
        assert torch.equal(leaf.grad, want)
