"""A CPU model of the float32 flash forwards (csrc/mhada_f32_tile.cuh):
the attention kernel of K1 and K6's forward (so K9's, and K12's single pass
and streaming forward) and the MHAda kernel with residuals of K7's forward
(so K10's with residuals), against the Pallas kernels in interpret mode
(K1: ``attention_pallas_tm``, attention_pallas.py:154; K6: the forward of
``attention_tm_train``'s VJP, ``_attn_tm_fwd_impl(with_res=True)``, :236;
K7: the forward of ``mhada_tm_train``'s VJP,
``_mhada_tm_fwd_impl(with_res=True)``, mhada_pallas.py:336), against the
port's plain versions and against a float64 core.

The model replays the kernels' schedule in torch: query blocks of 256 rows
(attention, 8 x 8 a thread: 8 threads to a row) or 128 (MHAda, 8 x 4: 16
threads to a row), rows past N zero; key tiles of 64 (keys past M
zero-filled and masked in the ragged last tile only); attention's scale
folded into q as it is loaded; the softmax in log2 units with exp2; the row
sums kept as one partial sum per thread of the row (keys tx + TX j) and
added once at the end; the accumulators' rescale skipped for a warp when
no row maximum of the warp moved; lse = max + log(sum) in natural-log
units.  Shapes: self-attention at L = 300 (B = 2) and L = 1 (B = 1); MHAda
at N = M = 300 (B = 2) and N = 1 against M = 63 (B = 1), V = N(0, 1) or 3 +
0.3 N(0, 1) (E2 - M1^2 cancels), q and k at input scale 0.35 (the MHAda
softmax is unscaled); 2 heads."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch
import torch.nn.functional as F
from jax.experimental.pallas import tpu as pltpu

from mhada_tpu.ops.attention_pallas import (_attn_tm_fwd_impl,
                                            attention_pallas_tm)
from mhada_tpu.ops.mhada_pallas import _mhada_tm_fwd_impl
from mhada_tpu_torch.ops.attention_kernel import attention_plain
from mhada_tpu_torch.ops.attention_train import attention_train_fwd_plain
from mhada_tpu_torch.ops.mhada_kernel import _heads
from mhada_tpu_torch.ops.mhada_train import mhada_train_fwd_plain

# Six test workers share the CPU: cap torch's intra-op threads.
torch.set_num_threads(2)

BK, LOG2E, THREADS = 64, 1.4426950408889634, 256
HEADS = 2
# (queries a block, threads to a row) of the two kernels
ATTN, MHADA = (256, 8), (128, 16)
# Bounds against the Pallas kernels and the plain versions, as
# tests/test_torch_mhada_f32_tile.py holds the MHAda tile: 5e-5 absolute;
# where E2 - M1^2 cancels (V = 3 + 0.3 N(0, 1)) 1e-4 of max |ref|, as
# chip_smoke.py's float32 gate.  lse: 1e-5 of max |ref|.  The model may be
# at most twice as far from the float64 core as the Pallas kernel is.
ATOL, REL_SHIFTED, REL_LSE = 5e-5, 1e-4, 1e-5


def tile_model(q, k, v, scale, block, v2):
    """The kernels' arithmetic on head-major float32 q (B, H, N, 64) and k,
    v (B, H, M, 64); ``block`` = (queries a block, threads to a row); v2:
    MHAda's P V^2 too -> (M1 = P V / l, E2 = P V^2 / l or None, lse
    (B, H, N), warp rescales skipped, warp rescales done)."""
    bq, tx = block
    b, h, n, d = q.shape
    m = k.shape[2]
    tiles = -(-m // BK)
    kp, vp = (F.pad(t, (0, 0, 0, tiles * BK - m)) for t in (k, v))
    q = q * scale
    # a row group holds 4 TY rows, a warp 4 x 32 / TX of them
    groups, warp_rows = bq * tx // (4 * THREADS), 128 // tx
    m1s, e2s, lses = [], [], []
    skipped = done = 0
    for q0 in range(0, n, bq):
        rows = min(bq, n - q0)
        qb = F.pad(q[:, :, q0:q0 + rows], (0, 0, 0, bq - rows))
        mrow = torch.full((b, h, bq), -torch.inf)
        lpart = torch.zeros(b, h, bq, tx)     # one partial sum per thread
        o1 = torch.zeros(b, h, bq, d)
        o2 = torch.zeros(b, h, bq, d)
        for t in range(tiles):
            ks, vs = (x[:, :, t * BK:(t + 1) * BK] for x in (kp, vp))
            s = qb @ ks.transpose(-1, -2)
            if (t + 1) * BK > m:          # the ragged last tile only
                s[..., m - t * BK:] = -torch.inf
            m_new = torch.maximum(mrow, s.amax(-1))
            up = m_new > mrow
            alpha = torch.where(up, torch.exp2((mrow - m_new) * LOG2E),
                                torch.ones(()))
            mrow = m_new
            p = torch.exp2(s * LOG2E - (m_new * LOG2E)[..., None])
            # keys tx + TX j of thread tx: key index j * TX + tx
            lpart = (lpart * alpha[..., None]
                     + p.reshape(b, h, bq, BK // tx, tx).sum(-2))
            vote = up.reshape(b, h, groups, 8, warp_rows).any(-1).any(-2)
            vote_rows = vote[:, :, None, :, None].expand(
                b, h, groups, 8, warp_rows).reshape(b, h, bq)
            # a skipped rescale is exact: no row of the warp moved
            assert bool((alpha[~vote_rows] == 1).all())
            skipped += int((~vote).sum())
            done += int(vote.sum())
            keep = torch.where(vote_rows, alpha, torch.ones(()))[..., None]
            o1 = o1 * keep + p @ vs
            if v2:
                o2 = o2 * keep + p @ (vs * vs)
        lsum = lpart.sum(-1)
        m1s.append((o1 / lsum[..., None])[:, :, :rows])
        e2s.append((o2 / lsum[..., None])[:, :, :rows])
        lses.append((mrow + torch.log(lsum))[:, :, :rows])
    e2 = torch.cat(e2s, 2) if v2 else None
    return torch.cat(m1s, 2), e2, torch.cat(lses, 2), skipped, done


def _token_major(x):
    b, h, n, d = x.shape
    return x.transpose(1, 2).reshape(b, n, h * d)


def _head_lse(lse):
    """The Pallas kernels' lse, (B, N, C) with each head's broadcast over
    its 64 lanes -> (B, H, N)."""
    return np.ascontiguousarray(lse[:, :, ::64].transpose(0, 2, 1))


def _close(got, ref, rel):
    """max |got - ref| within ATOL, or within ``rel`` of max |ref|."""
    err = np.abs(got - ref).max()
    if rel:
        return err <= rel * np.abs(ref).max(), err
    return err <= ATOL, err


def _check(got, refs, rel, exact, pallas):
    assert np.isfinite(got).all()
    for ref in refs:
        assert got.shape == ref.shape
        ok, err = _close(got, ref, rel)
        assert ok, err
    assert (np.abs(got - exact).max()
            <= 2 * np.abs(pallas - exact).max() + 1e-7)


def _vote_ran(skipped, done, m):
    # the first tile rescales every warp; past it, some keep their maxima
    assert done > 0 and (skipped > 0 or m <= BK)


@pytest.mark.parametrize("b,l", [(2, 300), (1, 1)])
def test_attention_model_matches_pallas(b, l):
    """K1 (out) and K6's forward (out, lse) against the Pallas kernels, the
    plain versions and the float64 core; the model is one schedule for
    both (K1 leaves lse unwritten)."""
    rng = np.random.default_rng((113, b, l))
    c, scale = 64 * HEADS, 0.125
    qkv = rng.standard_normal((b, l, 3 * c)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        k1 = np.asarray(attention_pallas_tm(jnp.asarray(qkv), scale, HEADS))
        k6, k6_lse = (np.asarray(x) for x in _attn_tm_fwd_impl(
            jnp.asarray(qkv), scale, HEADS, 256, with_res=True))
    t = torch.from_numpy(qkv)
    q, k, v = (_heads(x, HEADS) for x in t.split(c, dim=-1))
    m1, _, lse, skipped, done = tile_model(q, k, v, scale, ATTN, v2=False)
    plain = attention_plain(t, HEADS, scale).numpy()
    plain_out, plain_lse = (x.numpy() for x in attention_train_fwd_plain(
        t, HEADS, scale))
    s64 = q.double() @ k.double().transpose(-1, -2) * scale
    out64 = _token_major(torch.softmax(s64, -1) @ v.double()).numpy()
    lse64 = torch.logsumexp(s64, -1).numpy()
    _check(_token_major(m1).numpy(), [k1, k6, plain, plain_out], 0, out64,
           k6)
    _check(lse.numpy(), [_head_lse(k6_lse), plain_lse], REL_LSE, lse64,
           _head_lse(k6_lse))
    _vote_ran(skipped, done, l)


@pytest.mark.parametrize("b,n,m,shift", [(2, 300, 300, 0.0),
                                         (1, 1, 63, 0.0),
                                         (2, 300, 300, 3.0),
                                         (1, 1, 63, 3.0)])
def test_mhada_res_model_matches_pallas(b, n, m, shift):
    """K7's forward (out, M1, E2, lse) against the Pallas kernel, the plain
    version and the float64 core."""
    rng = np.random.default_rng((114, b, n, m, int(shift)))
    c = 64 * HEADS
    x = {"q": (rng.standard_normal((b, n, c)) * 0.35).astype(np.float32),
         "k": (rng.standard_normal((b, m, c)) * 0.35).astype(np.float32),
         "v": (rng.standard_normal((b, m, c)) * (0.3 if shift else 1.0)
               + shift).astype(np.float32),
         "f": rng.standard_normal((b, n, c)).astype(np.float32)}
    with pltpu.force_tpu_interpret_mode():
        pallas = [np.asarray(a) for a in _mhada_tm_fwd_impl(
            *(jnp.asarray(x[key]) for key in "qkvf"), HEADS, 256,
            with_res=True)]
    pallas[3] = _head_lse(pallas[3])
    t = {key: torch.from_numpy(a) for key, a in x.items()}
    q, k, v, f = (_heads(t[key], HEADS) for key in "qkvf")
    m1, e2, lse, skipped, done = tile_model(q, k, v, 1.0, MHADA, v2=True)
    out = torch.sqrt(torch.clamp(e2 - m1 * m1, min=1e-6)) * f + m1
    got = [_token_major(out), _token_major(m1), _token_major(e2), lse]
    plain = mhada_train_fwd_plain(t["q"], t["k"], t["v"], t["f"], HEADS)
    q64, k64, v64, f64 = (a.double() for a in (q, k, v, f))
    s64 = q64 @ k64.transpose(-1, -2)
    a64 = torch.softmax(s64, -1)
    m1_64, e2_64 = a64 @ v64, a64 @ (v64 * v64)
    out64 = torch.sqrt(torch.clamp(e2_64 - m1_64 * m1_64, min=1e-6)) * f64 \
        + m1_64
    exact = [_token_major(out64), _token_major(m1_64), _token_major(e2_64),
             torch.logsumexp(s64, -1)]
    for i, (g, ref, p, ex) in enumerate(zip(got, pallas, plain, exact)):
        rel = REL_LSE if i == 3 else (REL_SHIFTED if shift else 0)
        _check(g.numpy(), [ref, p.numpy()], rel, ex.numpy(), ref)
    _vote_ran(skipped, done, m)
