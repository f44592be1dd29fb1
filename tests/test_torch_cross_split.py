"""K1's cross form split over the keys (csrc/attention_fwd.cu::
mhada_attention_cross_fwd, csrc/attention_combine.cuh), CPU.

A torch model of the split schedule replays what the kernels do at both
dtypes: query blocks (256 rows at float32, 192 at bfloat16; rows past N
zero and not stored), split s of S walking the whole 64-key tiles [s T / S,
(s + 1) T / S) of the T = ceil(M / 64), keys past M masked in the ragged
last tile of the last split only; an online softmax in log2 units within
each split (float32: the scale folded into q; bfloat16: the scale applied
to the float32 scores and P rounded to bfloat16 against the split's own
running maximum before P V, the row sum taking P before rounding); float32
partials (m_s in log2 units, l_s, the unnormalised O_s) and their combine
in a fixed order, in float32 (the kernel rounds that once).  It is held
against the TPU kernels in interpret mode (``_attention_pallas_call``,
attention_pallas.py:62; above 4096 keys
``_attn_stream_fwd_impl(with_res=False)``, :488) and against
``attention_cross_plain``, at ragged N and M with 1, 2, 3 and 5 splits,
including a last split of one key; ``combine_partials`` (the combine in
plain PyTorch) and ``split_partials`` (the buffer's layout) against the
model; ``cross_splits`` pinned at the sequence-parallel gate shapes and its
invariants over a grid of shapes; a count that would leave a split without
a key tile refused.

Bounds, K1's CPU bounds: float32 2e-5 absolute and 1e-4 relative;
bfloat16 2^-8 of the output's scale (P is rounded against each split's
maximum here, against the row's in the TPU kernel).  At bfloat16 the
model's combine is compared before its one rounding: two roundings of
neighbouring float32 values can differ by a whole bf16 step, which is more
than 2^-8 of the scale in the top binade."""

import functools

import numpy as np
import pytest
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from mhada_tpu.ops.attention_pallas import (_attention_pallas_call,
                                            _attn_stream_fwd_impl)
from mhada_tpu_torch.ops.attention_kernel import (
    CROSS_BLOCKS, KEY_TILE, MAX_SPLITS, attention_cross,
    attention_cross_plain, combine_partials, cross_splits, split_partials)

# Six test workers share the CPU: cap torch's intra-op threads.
torch.set_num_threads(2)

HEADS, D, SCALE = 2, 64, 0.125
LOG2E = 1.4426950408889634
ATOL, RTOL, BF16_REL = 2e-5, 1e-4, 2.0 ** -8


def split_ranges(tiles, splits):
    """[first, last) key tiles of each split, as split_first computes."""
    if not 1 <= splits <= tiles:
        raise ValueError(f"{splits} splits of {tiles} tiles")
    return [(s * tiles // splits, (s + 1) * tiles // splits)
            for s in range(splits)]


def split_model(q, k, v, scale, splits, dtype):
    """The split kernels' arithmetic on head-major float32 q (B, H, N, 64)
    and k, v (B, H, M, 64), the values of ``dtype`` -> (out (B, H, N, 64),
    the combine in float32 before the kernel rounds it to ``dtype``; O_s
    (S, B, H, N, 64), m_s and l_s (S, B, H, N))."""
    bq = CROSS_BLOCKS[dtype][0]
    b, h, n, d = q.shape
    m = k.shape[2]
    tiles = -(-m // KEY_TILE)
    kp, vp = (torch.nn.functional.pad(t, (0, 0, 0, tiles * KEY_TILE - m))
              for t in (k, v))
    bf16 = dtype == torch.bfloat16
    qs = q if bf16 else q * scale
    factor = scale * LOG2E if bf16 else LOG2E
    o_all = torch.zeros(splits, b, h, n, d)
    m_all = torch.zeros(splits, b, h, n)
    l_all = torch.zeros(splits, b, h, n)
    for q0 in range(0, n, bq):
        rows = min(bq, n - q0)
        qb = torch.nn.functional.pad(qs[:, :, q0:q0 + rows],
                                     (0, 0, 0, bq - rows))
        for s, (t0, t1) in enumerate(split_ranges(tiles, splits)):
            mrow = torch.full((b, h, bq), -torch.inf)
            lrow = torch.zeros(b, h, bq)
            o = torch.zeros(b, h, bq, d)
            for t in range(t0, t1):
                ks, vs = (x[:, :, t * KEY_TILE:(t + 1) * KEY_TILE]
                          for x in (kp, vp))
                x = (qb @ ks.transpose(-1, -2)) * factor
                if (t + 1) * KEY_TILE > m:   # the ragged last tile only
                    assert t == tiles - 1 and s == splits - 1
                    x[..., m - t * KEY_TILE:] = -torch.inf
                m_new = torch.maximum(mrow, x.amax(-1))
                alpha = torch.exp2(mrow - m_new)
                p = torch.exp2(x - m_new[..., None])
                lrow = lrow * alpha + p.sum(-1)
                if bf16:
                    p = p.to(torch.bfloat16).float()
                o = o * alpha[..., None] + p @ vs
                mrow = m_new
            o_all[s, :, :, q0:q0 + rows] = o[:, :, :rows]
            m_all[s, :, :, q0:q0 + rows] = mrow[:, :, :rows]
            l_all[s, :, :, q0:q0 + rows] = lrow[:, :, :rows]
    mx = m_all.amax(0)
    w = torch.exp2(m_all - mx)
    den = torch.zeros(b, h, n)
    num = torch.zeros(b, h, n, d)
    for s in range(splits):   # the combine's fixed order
        den = den + w[s] * l_all[s]
        num = num + w[s][..., None] * o_all[s]
    out = num / den[..., None]
    return out, o_all, m_all, l_all


def _inputs(b, n, m, seed):
    """A packed qkv's query columns and a (B, M, 2C) kv, float32 numpy."""
    rng = np.random.default_rng(seed)
    c = HEADS * D
    qkv = rng.standard_normal((b, n, 3 * c)).astype(np.float32)
    kv = rng.standard_normal((b, m, 2 * c)).astype(np.float32)
    return qkv, kv


def _heads(a, off, length, b):
    c = HEADS * D
    return a[..., off:off + c].reshape(b, length, HEADS, D).transpose(
        0, 2, 1, 3)


@functools.cache
def _pallas(b, n, m, seed, dname):
    """The TPU kernel in interpret mode on _inputs -> (B, N, C) float32."""
    qkv, kv = _inputs(b, n, m, seed)
    jdt = jnp.dtype(dname)
    q, k, v = (jnp.asarray(_heads(a, off, length, b)).astype(jdt)
               for a, off, length in ((qkv, 0, n), (kv, 0, m),
                                      (kv, HEADS * D, m)))
    with pltpu.force_tpu_interpret_mode():
        if m > 4096:
            ref = _attn_stream_fwd_impl(q, k, v, SCALE, 128, 1024, False)
        else:
            ref = _attention_pallas_call(q, k, v, scale=SCALE)
    return np.asarray(ref.astype(jnp.float32)).transpose(0, 2, 1, 3) \
        .reshape(b, n, HEADS * D)


def _model(b, n, m, seed, splits, dtype):
    qkv, kv = _inputs(b, n, m, seed)
    t = [torch.from_numpy(np.ascontiguousarray(_heads(a, off, length, b)))
         .to(dtype).float()
         for a, off, length in ((qkv, 0, n), (kv, 0, m), (kv, HEADS * D, m))]
    out, o_s, m_s, l_s = split_model(*t, SCALE, splits, dtype)
    return out.transpose(1, 2).reshape(b, n, HEADS * D), o_s, m_s, l_s


def _close(got, ref, dtype):
    assert np.isfinite(got).all() and got.shape == ref.shape
    if dtype == torch.float32:
        np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)
    else:
        err = np.abs(got - ref).max()
        assert err <= BF16_REL * np.abs(ref).max(), err


# (splits, batch, queries, keys): 700 keys are 11 tiles (the last of 60
# keys), split 1, 2 (5 + 6), 3 (3 + 4 + 4) and 5 (2, 2, 2, 2, 3) ways at 200
# queries (no block divides them); 129 keys are 3 tiles, the last split of
# 3 holding one key.
CASES = [(1, 2, 200, 700), (2, 2, 200, 700), (3, 2, 200, 700),
         (5, 2, 200, 700), (2, 1, 64, 129), (3, 1, 64, 129)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("splits,b,n,m", CASES)
def test_split_model_matches_pallas_and_plain(dtype, splits, b, n, m):
    """The split schedule against the TPU kernel (interpret mode) and the
    port's plain version on the same inputs; every split's maximum finite
    and its sum at least 1 (it holds a key below M)."""
    got, _, m_s, l_s = _model(b, n, m, 7, splits, dtype)
    assert torch.isfinite(m_s).all() and bool((l_s >= 1).all())
    qkv, kv = _inputs(b, n, m, 7)
    qkv_t, kv_t = (torch.from_numpy(a).to(dtype) for a in (qkv, kv))
    c = HEADS * D
    plain = attention_cross_plain(qkv_t[..., :c], kv_t, HEADS, SCALE)
    # on the CPU the wrapper takes the plain version, whatever the split
    forced = attention_cross(qkv_t[..., :c], kv_t, HEADS, SCALE,
                             splits=splits)
    assert torch.equal(forced, plain)
    for ref in (_pallas(b, n, m, 7, str(dtype)[6:]), plain.float().numpy()):
        _close(got.numpy(), ref, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_model_matches_streaming_forward(dtype):
    """Past 4096 keys the TPU takes its streaming forward: 4200 keys (66
    tiles, the last of 40 keys) over 3 splits against it."""
    b, n, m = 1, 64, 4200
    got = _model(b, n, m, 11, 3, dtype)[0]
    _close(got.numpy(), _pallas(b, n, m, 11, str(dtype)[6:]), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_combine_partials_and_layout(dtype):
    """``combine_partials`` on the model's partials repeats the model's
    combine (float32, summed in another order; its lse is held in
    tests/test_torch_attention_wgmma.py), and without the last split
    it is far off (the planted control
    of chip_smoke.py's phase 10); ``split_partials`` reads O, m and l at
    csrc/attention_combine.cuh's offsets."""
    b, n, m, splits = 2, 200, 700, 3
    want, o_s, m_s, l_s = _model(b, n, m, 7, splits, dtype)
    o_tm = o_s.permute(0, 1, 3, 2, 4).reshape(splits, b, n, HEADS * D)
    got = combine_partials(o_tm, m_s, l_s, torch.float32)[0]
    _close(got.numpy(), want.numpy(), torch.float32)
    assert combine_partials(o_tm, m_s, l_s, dtype)[0].dtype == dtype
    dropped = combine_partials(o_tm, m_s, l_s, dtype, keep=splits - 1)[0]
    assert (dropped.float() - want).abs().max() > 0.05 * want.abs().max()
    c = HEADS * D
    part = torch.cat([o_tm.reshape(-1), m_s.reshape(-1), l_s.reshape(-1)])
    assert part.numel() == splits * b * n * (c + 2 * HEADS)
    views = split_partials(part, splits, b, n, c, HEADS)
    for view, ref in zip(views, (o_tm, m_s, l_s)):
        assert torch.equal(view, ref)
    # Partials::o, ::stat of (split 2, batch 1, head 1, row 5)
    s, bb, hh, row = 2, 1, 1, 5
    flat = ((s * b + bb) * n + row) * c + hh * D
    assert part[flat] == o_tm[s, bb, row, hh * D]
    stat = ((s * b + bb) * HEADS + hh) * n + row
    assert part[splits * b * n * c + stat] == m_s[s, bb, hh, row]
    assert part[splits * b * n * c + splits * b * HEADS * n + stat] \
        == l_s[s, bb, hh, row]


def test_cross_splits_pinned():
    """The counts at the sequence-parallel gate shapes (B = 1, 8 heads) on
    an H100's 132 SMs, as the chooser's docstring gives them."""
    shapes = [(1024, 4096), (2048, 4096), (4096, 16384)]
    assert [cross_splits(1, 8, n, m, torch.float32, 132)
            for n, m in shapes] == [4, 2, 1]
    assert [cross_splits(1, 8, n, m, torch.bfloat16, 132)
            for n, m in shapes] == [5, 3, 3]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cross_splits_invariants(dtype):
    """Over a grid of shapes: 1 <= splits <= MAX_SPLITS, no split without a
    key tile, and 1 where the grid is whole waves of the card's block
    slots; a count past the tiles is refused before any work."""
    rows, per_sm = CROSS_BLOCKS[dtype][:2]
    for sms in (132, 114, 16):
        for b in (1, 2, 8):
            for heads in (1, 2, 8):
                for n in (1, 63, 200, 1024, 2048, 4096):
                    for m in (1, 64, 65, 129, 700, 4096, 16384):
                        s = cross_splits(b, heads, n, m, dtype, sms)
                        tiles = -(-m // KEY_TILE)
                        assert 1 <= s <= min(tiles, MAX_SPLITS)
                        assert all(t1 > t0 for t0, t1
                                   in split_ranges(tiles, s))
                        blocks = b * heads * -(-n // rows)
                        if blocks % (sms * per_sm) == 0:
                            assert s == 1, (b, heads, n, m, sms)
    q = torch.zeros(1, 10, HEADS * D, dtype=dtype)
    kv = torch.zeros(1, 129, 2 * HEADS * D, dtype=dtype)
    for bad in (0, 4):
        with pytest.raises(ValueError, match="without a 64-key tile"):
            attention_cross(q, kv, HEADS, splits=bad)
    with pytest.raises(ValueError):
        split_ranges(3, 4)
