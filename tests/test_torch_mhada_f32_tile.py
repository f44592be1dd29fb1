"""A CPU model of the float32 MHAda tile (csrc/mhada_f32_tile.cuh), which
K4's and K3's float32 builds (and the probe P2's) launch, against the
Pallas kernels in interpret mode (K4: mhada_tpu/ops/mhada_pallas.py:114,
through ``mhada_attention_pallas``; K3: ``mhada_fused_prologue``,
mhada_pallas.py:239) and against the plain float32 versions.

The model replays the kernel's schedule in torch: query blocks of 128 rows
(rows past N zero), key tiles of 64 (keys past M zero-filled and masked in
the ragged last tile only), the softmax in log2 units with exp2, the row
sums kept as 16 partial sums per row (one per thread of the row's
half-warp: keys tx + 16 j) and added once at the end, and the rescale of
the accumulators skipped for a warp (its 16 rows) when no row maximum of
the warp moved; K3's prologue (IN(fc) Wf_h + fb_h) and epilogue (IN(fcs)
from the stats).  Shapes: ragged N and M (200 x 130, 1 x 63), B = 2 and 1,
V = N(0, 1) or 3 + 0.3 N(0, 1) (E2 - M1^2 cancels), k at input scale 0.35
(the unscaled logits' std near 1.6); each also against the float64 core."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch
import torch.nn.functional as F
from jax.experimental.pallas import tpu as pltpu

from mhada_tpu.ops.mhada_pallas import (mhada_attention_pallas,
                                        mhada_fused_prologue)
from mhada_tpu_torch.ops.instance_norm import instance_norm_stats
from mhada_tpu_torch.ops.mhada_kernel import _heads, mhada_tm_plain
from mhada_tpu_torch.ops.mhada_prologue import mhada_fused_prologue_plain

# Six test workers share the CPU: cap torch's intra-op threads.
torch.set_num_threads(2)

BQ, BK, LOG2E = 128, 64, 1.4426950408889634
HEADS = 2
# Bounds against the Pallas kernels and the plain versions.  V = N(0, 1):
# 5e-5 absolute, as the repo's other float32 MHAda tests
# (tests/test_torch_streaming.py).  V = 3 + 0.3 N(0, 1): E2 - M1^2 cancels
# (E2 ~ 9.1, the variance ~ 0.09), so every float32 order is tens of 1e-6
# off: at 200 x 130 the Pallas kernel is 6.9e-5 and the plain version
# 6.3e-5 from the float64 core (the model 3.4e-5).  There the bound is
# chip_smoke.py's float32 gate, max |d| / max |ref| <= 1e-4.  In every case
# the model may be at most twice as far from the float64 core as the Pallas
# kernel is.
ATOL = 5e-5
REL_SHIFTED = 1e-4


def tile_core(q, k, v, f):
    """The tile's arithmetic on head-major float32 q, f (B, H, N, 64) and k,
    v (B, H, M, 64) -> (out (B, H, N, 64), count of warp rescales skipped,
    count of warp rescales done)."""
    b, h, n, d = q.shape
    m = k.shape[2]
    tiles = -(-m // BK)
    kp, vp = (F.pad(t, (0, 0, 0, tiles * BK - m)) for t in (k, v))
    out = torch.empty_like(q)
    skipped = done = 0
    for q0 in range(0, n, BQ):
        rows = min(BQ, n - q0)
        qb = F.pad(q[:, :, q0:q0 + rows], (0, 0, 0, BQ - rows))
        mrow = torch.full((b, h, BQ), -torch.inf)
        lpart = torch.zeros(b, h, BQ, 16)     # one partial sum per thread
        o1 = torch.zeros(b, h, BQ, d)
        o2 = torch.zeros(b, h, BQ, d)
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
            # keys tx + 16 j of thread tx: key index j * 16 + tx
            lpart = lpart * alpha[..., None] + p.reshape(b, h, BQ, 4,
                                                         16).sum(-2)
            # row 64 g + 8 w + e belongs to warp w: the vote over its rows
            vote = up.reshape(b, h, 2, 8, 8).any(-1).any(-2)       # (b, h, 8)
            vote_rows = vote[:, :, None, :, None].expand(
                b, h, 2, 8, 8).reshape(b, h, BQ)
            # a skipped rescale is exact: no row of the warp moved
            assert bool((alpha[~vote_rows] == 1).all())
            skipped += int((~vote).sum())
            done += int(vote.sum())
            scale = torch.where(vote_rows, alpha, torch.ones(()))[..., None]
            o1 = o1 * scale + p @ vs
            o2 = o2 * scale + p @ (vs * vs)
        inv = 1 / lpart.sum(-1, keepdim=True)
        m1, e2 = o1 * inv, o2 * inv
        sd = torch.sqrt(torch.clamp(e2 - m1 * m1, min=1e-6))
        out[:, :, q0:q0 + rows] = (sd[:, :, :rows] * f[:, :, q0:q0 + rows]
                                   + m1[:, :, :rows])
    return out, skipped, done


def _token_major(x):
    b, h, n, d = x.shape
    return x.transpose(1, 2).reshape(b, n, h * d)


def k4_model(q, k, v, f):
    """K4's float32 build on token-major (B, N|M, C) tensors."""
    out, skipped, done = tile_core(*(_heads(t, HEADS) for t in (q, k, v, f)))
    return _token_major(out), skipped, done


def k3_model(fc, fcs, stats, wf, fb, k, v):
    """K3's float32 build: the prologue q = IN(fc) Wf_h + fb_h (per query
    block in the kernel, row by row the same), the tile, IN(fcs) in the
    epilogue."""
    qn = (fc - stats[:, None, 0]) * stats[:, None, 1]
    q = torch.einsum("bhnd,hde->bhne", _heads(qn, HEADS), wf) + fb[:, None]
    f = (fcs - stats[:, None, 2]) * stats[:, None, 3]
    out, skipped, done = tile_core(q, *(_heads(t, HEADS)
                                        for t in (k, v, f)))
    return _token_major(out), skipped, done


CASES = [(2, 200, 130, 0.0), (1, 1, 63, 0.0), (2, 200, 130, 3.0),
         (1, 1, 63, 3.0)]


def _inputs(b, n, m, shift, seed):
    rng = np.random.default_rng((seed, b, n, m, int(shift)))
    c = 64 * HEADS
    return {
        "q": (rng.standard_normal((b, n, c)) * 0.35).astype(np.float32),
        "fc": (rng.standard_normal((b, n, c)) * 2 + 1).astype(np.float32),
        "fcs": (rng.standard_normal((b, n, c)) * 3 - 1).astype(np.float32),
        "f": rng.standard_normal((b, n, c)).astype(np.float32),
        # the block's init U(-1/8, 1/8)
        "wf": rng.uniform(-1 / 8, 1 / 8, (HEADS, 64, 64)).astype(np.float32),
        "fb": rng.uniform(-1 / 8, 1 / 8, (HEADS, 64)).astype(np.float32),
        "k": (rng.standard_normal((b, m, c)) * 0.35).astype(np.float32),
        "v": (rng.standard_normal((b, m, c)) * (0.3 if shift else 1.0)
              + shift).astype(np.float32),
    }


def _head_major(a):
    b, n, c = a.shape
    return a.reshape(b, n, HEADS, c // HEADS).transpose(0, 2, 1, 3)


def core64(q, k, v, f):
    """The MHAda core in float64 on head-major tensors: the yardstick of
    how far each float32 order is from the exact function."""
    q, k, v, f = (t.double() for t in (q, k, v, f))
    a = torch.softmax(q @ k.transpose(-1, -2), -1)
    m1, e2 = a @ v, a @ (v * v)
    return torch.sqrt(torch.clamp(e2 - m1 * m1, min=1e-6)) * f + m1


def _check(got, ref, plain, exact, shift, skipped, done, m):
    assert got.shape == ref.shape == plain.shape == exact.shape
    assert np.isfinite(got).all()
    for other in (ref, plain):
        err = np.abs(got - other).max()
        if shift:
            assert err / np.abs(other).max() <= REL_SHIFTED, err
        else:
            assert err <= ATOL, err
    assert np.abs(got - exact).max() <= 2 * np.abs(ref - exact).max() + 1e-7
    # the vote is exercised: the first tile rescales every warp; past it,
    # some warps keep their maxima
    assert done > 0 and (skipped > 0 or m <= BK)


@pytest.mark.parametrize("b,n,m,shift", CASES)
def test_k4_tile_model_matches_pallas(b, n, m, shift):
    x = _inputs(b, n, m, shift, 111)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(mhada_attention_pallas(
            *(jnp.asarray(_head_major(x[key])) for key in "qkvf")))
    ref = ref.transpose(0, 2, 1, 3).reshape(b, n, -1)
    t = {key: torch.from_numpy(x[key]) for key in "qkvf"}
    got, skipped, done = k4_model(t["q"], t["k"], t["v"], t["f"])
    plain = mhada_tm_plain(t["q"], t["k"], t["v"], t["f"], HEADS)
    exact = _token_major(core64(*(_heads(t[key], HEADS) for key in "qkvf")))
    _check(got.numpy(), ref, plain.numpy(), exact.numpy(), shift, skipped,
           done, m)


@pytest.mark.parametrize("b,n,m,shift", CASES)
def test_k3_tile_model_matches_pallas(b, n, m, shift):
    x = _inputs(b, n, m, shift, 112)
    t = {key: torch.from_numpy(a) for key, a in x.items()}
    stats = torch.stack([*instance_norm_stats(t["fc"]),
                         *instance_norm_stats(t["fcs"])], 1)
    args = (t["fc"], t["fcs"], stats, t["wf"], t["fb"], t["k"], t["v"])
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(mhada_fused_prologue(
            *(jnp.asarray(a.numpy()) for a in args)))
    got, skipped, done = k3_model(*args)
    plain = mhada_fused_prologue_plain(*args)
    x64 = {key: a.double() for key, a in t.items()}
    st = stats.double()
    q = torch.einsum("bhnd,hde->bhne", _heads(
        (x64["fc"] - st[:, None, 0]) * st[:, None, 1], HEADS),
        x64["wf"]) + x64["fb"][:, None]
    f = (x64["fcs"] - st[:, None, 2]) * st[:, None, 3]
    exact = _token_major(core64(q, *(_heads(a, HEADS)
                                     for a in (x64["k"], x64["v"], f))))
    _check(got.numpy(), ref, plain.numpy(), exact.numpy(), shift, skipped,
           done, m)
