"""K3 and K4 at bfloat16 on the MHAda tile split over the keys
(csrc/mhada_wgmma.cuh, csrc/mhada_combine.cuh), CPU.

A torch model of the split schedule replays what the kernels do: query
blocks of 192 rows (rows past N zero, finite, not stored); with K3's
prologue, qn = IN(fc) rounded to bf16 and q = qn Wf_h + fb_h rounded to
bf16; split s of S walking the whole 64-key tiles [s T / S, (s + 1) T / S)
of the T = ceil(M / 64), keys past M masked in the ragged last tile of the
last split only; an online softmax of the unscaled scores with the row
maximum kept unscaled and the exponents in log2 units, P rounded to
bfloat16 against the split's own running maximum before [V | V^2] (the row
sum taking P before rounding), V^2 each bf16 squared and rounded; float32
partials (m_s in log2 units, l_s, the unnormalised O1_s and O2_s) and their
combine in a fixed order, then the MHAda epilogue sqrt(max(E2 - M1^2,
1e-6)) f + M1 (K3: f = IN(fcs) from the stats; K4: f = fcs_n), rounded
once to bfloat16.  It is held against the TPU kernels in interpret mode
(``mhada_fused_prologue``, mhada_pallas.py:239, and
``mhada_attention_pallas``, the single-pass _kernel, :114) and against the
port's plain versions, with 1, 2, 3 and 5 splits at 200 queries against
300 keys (5 tiles, the last of 44 keys) and 2 and 3 at 64 against 129
(the last split of 3 holding one key); ``mhada_combine_partials`` (the
combine in plain PyTorch) and ``split_partials`` (the buffer's layout,
[O1 | O2] a row) against the model; ``mhada_splits`` pinned at the gate
shapes and its invariants over a grid of shapes; a count that would leave a
split without a key tile refused.

Inputs as tests/test_torch_mhada_bf16.py's: V = 3 + 0.3 N(0, 1) and K at
scale 0.35, so that E2 - M1^2 cancels and every place where two
computations round differently shows.  Bounds: the schedule without its
roundings, in float64, within 1e-9 of the exact core; the model within one
bf16 step of the output's largest value (the bound of
test_torch_mhada_bf16.py) of the JAX streaming kernel
(_mhada_stream_fwd_impl, mhada_pallas.py:622, interpret mode, 64-key
blocks), which rounds P against a running maximum too, run on each split's
keys and combined from its residuals (M1, E2, the row log-sum-exp) in
float32: half a step here, where a twin that keeps P and V^2 in float32
and normalises before the product is 2 to 2.5 steps off and fails; the
combine in plain PyTorch within one step of the model; the model against
the single-pass TPU kernels and the plain versions within two steps.  The
single-pass kernels round P against the row's maximum over all its keys,
the tile against the running maximum of its own split, and with the
cancellation the two roundings of P leave the output up to 1.48 steps apart
here (K3 with 3 and 5 splits; 1.06 with one split); the plain versions are
within half a step of the TPU kernels."""

import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from mhada_tpu.ops.mhada_pallas import \
    mhada_fused_prologue as jax_fused_prologue
from mhada_tpu.ops.mhada_pallas import (_mhada_stream_fwd_impl,
                                        mhada_attention_pallas)
from mhada_tpu_torch.ops.instance_norm import instance_norm_stats
from mhada_tpu_torch.ops.key_split import (KEY_TILE, MAX_SPLITS,
                                           split_partials)
from mhada_tpu_torch.ops.mhada_kernel import (MHADA_BLOCK,
                                              mhada_combine_partials,
                                              mhada_partials, mhada_splits,
                                              mhada_tm, mhada_tm_plain)
from mhada_tpu_torch.ops.mhada_prologue import (mhada_fused_prologue,
                                                mhada_fused_prologue_plain)

# Six test workers share the CPU: cap torch's intra-op threads.
torch.set_num_threads(2)

BF16 = torch.bfloat16
HEADS, D = 2, 64
C = HEADS * D
LOG2E = 1.4426950408889634


def _step(x: float) -> float:
    """One bf16 step (the spacing of bf16 values) at magnitude x."""
    return 2.0 ** (np.floor(np.log2(x)) - 7)


def split_ranges(tiles, splits):
    """[first, last) key tiles of each split, as split_first computes."""
    if not 1 <= splits <= tiles:
        raise ValueError(f"{splits} splits of {tiles} tiles")
    return [(s * tiles // splits, (s + 1) * tiles // splits)
            for s in range(splits)]


def split_model(q, k, v, f, splits, rounded=True):
    """The split MHAda tile's arithmetic on head-major float32 q, f (B, H,
    N, 64) (q and k, v (B, H, M, 64) hold bf16 values) -> (out (B, H, N,
    64) in float32 before its one rounding; O1_s, O2_s (S, B, H, N, 64),
    m_s and l_s (S, B, H, N)).  ``rounded=False``: P and V^2 unrounded, in
    the inputs' dtype (the schedule alone, float64)."""
    rows = MHADA_BLOCK[0]
    b, h, n, d = q.shape
    m = k.shape[2]
    tiles = -(-m // KEY_TILE)
    kp, vp = (torch.nn.functional.pad(t, (0, 0, 0, tiles * KEY_TILE - m))
              for t in (k, v))
    v2p = vp.square().to(BF16).float() if rounded else vp.square()
    o1_all, o2_all = q.new_zeros(splits, b, h, n, d), q.new_zeros(
        splits, b, h, n, d)
    m_all, l_all = q.new_zeros(splits, b, h, n), q.new_zeros(splits, b, h, n)
    for q0 in range(0, n, rows):
        nr = min(rows, n - q0)
        qb = torch.nn.functional.pad(q[:, :, q0:q0 + nr], (0, 0, 0, rows - nr))
        for s, (t0, t1) in enumerate(split_ranges(tiles, splits)):
            mrow = q.new_full((b, h, rows), -torch.inf)   # unscaled
            lrow = q.new_zeros(b, h, rows)
            o1, o2 = q.new_zeros(b, h, rows, d), q.new_zeros(b, h, rows, d)
            for t in range(t0, t1):
                ks, vs, v2s = (x[:, :, t * KEY_TILE:(t + 1) * KEY_TILE]
                               for x in (kp, vp, v2p))
                sc = qb @ ks.transpose(-1, -2)
                if (t + 1) * KEY_TILE > m:   # the ragged last tile only
                    assert t == tiles - 1 and s == splits - 1
                    sc[..., m - t * KEY_TILE:] = -torch.inf
                m_new = torch.maximum(mrow, sc.amax(-1))
                alpha = torch.exp2((mrow - m_new) * LOG2E)
                p = torch.exp2(sc * LOG2E - (m_new * LOG2E)[..., None])
                lrow = lrow * alpha + p.sum(-1)
                if rounded:
                    p = p.to(BF16).float()
                o1 = o1 * alpha[..., None] + p @ vs
                o2 = o2 * alpha[..., None] + p @ v2s
                mrow = m_new
            o1_all[s, :, :, q0:q0 + nr] = o1[:, :, :nr]
            o2_all[s, :, :, q0:q0 + nr] = o2[:, :, :nr]
            m_all[s, :, :, q0:q0 + nr] = mrow[:, :, :nr] * LOG2E
            l_all[s, :, :, q0:q0 + nr] = lrow[:, :, :nr]
    w = torch.exp2(m_all - m_all.amax(0))
    den, num1, num2 = (q.new_zeros(b, h, n), q.new_zeros(b, h, n, d),
                       q.new_zeros(b, h, n, d))
    for s in range(splits):   # the combine's fixed order
        den = den + w[s] * l_all[s]
        num1 = num1 + w[s][..., None] * o1_all[s]
        num2 = num2 + w[s][..., None] * o2_all[s]
    m1, e2 = num1 / den[..., None], num2 / den[..., None]
    out = torch.sqrt(torch.clamp(e2 - m1.square(), min=1e-6)) * f + m1
    return out, o1_all, o2_all, m_all, l_all


def _bf16(rng, shape, scale=1.0, shift=0.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale + shift)
                            .astype(np.float32)).to(BF16)


@functools.cache
def _inputs(kind, b, n, m):
    """Seeded bf16 inputs: K3 (fc, fcs, stats, wf, fb, k, v), K4 (q, k, v,
    fcs_n), token-major."""
    rng = np.random.default_rng((b, n, m, 23))
    k, v = _bf16(rng, (b, m, C), 0.35), _bf16(rng, (b, m, C), 0.3, 3.0)
    if kind == "K4":
        return _bf16(rng, (b, n, C), 0.35), k, v, _bf16(rng, (b, n, C))
    fc, fcs = _bf16(rng, (b, n, C), 2.0, 1.0), _bf16(rng, (b, n, C), 3.0, -1.0)
    stats = torch.stack([*instance_norm_stats(fc.float()),
                         *instance_norm_stats(fcs.float())], 1)
    wf = _bf16(rng, (HEADS, 64, 64), 1 / 16)
    fb = _bf16(rng, (HEADS, 64), 1 / 16)
    return fc, fcs, stats, wf, fb, k, v


def _heads(t):
    b, n, _ = t.shape
    return t.float().reshape(b, n, HEADS, D).transpose(1, 2)


def _core(kind, b, n, m):
    """The core's head-major float32 (q, k, v, f) on _inputs: K3's q = qn
    Wf_h + fb_h from qn = IN(fc), each rounded to bf16, and f = IN(fcs)
    from the stats."""
    x = _inputs(kind, b, n, m)
    if kind == "K4":
        return tuple(_heads(t) for t in x)
    fc, fcs, st, wf, fb, k, v = x
    qn = ((fc.float() - st[:, None, 0]) * st[:, None, 1]).to(BF16)
    q = (torch.einsum("bhnd,hde->bhne", _heads(qn), wf.float())
         + fb.float()[None, :, None]).to(BF16).float()
    f = _heads((fcs.float() - st[:, None, 2]) * st[:, None, 3])
    return q, _heads(k), _heads(v), f


def _epilogue(m1, e2, f):
    """sqrt(max(E2 - M1^2, 1e-6)) f + M1, rounded once to bf16, head-major
    -> token-major (B, N, C) float32."""
    out = torch.sqrt(torch.clamp(e2 - m1.square(), min=1e-6)) * f + m1
    b, h, n, d = out.shape
    return out.transpose(1, 2).reshape(b, n, h * d).to(BF16).float()


def _model(kind, b, n, m, splits):
    """The model on _inputs -> (out rounded to bf16 as (B, N, C) float32,
    O (S, B, N, 2 C) = [O1 | O2], m_s, l_s, f (B, N, C) float32)."""
    q, k, v, f = _core(kind, b, n, m)
    out, o1, o2, m_s, l_s = split_model(q, k, v, f, splits)

    def token_major(t):
        return t.transpose(-3, -2).reshape(*t.shape[:-3], n, C)

    o = torch.cat([token_major(o1), token_major(o2)], -1)
    return (token_major(out).to(BF16).float(), o, m_s, l_s,
            token_major(f))


@functools.cache
def _pallas(kind, b, n, m):
    """The TPU kernel in interpret mode on _inputs -> (B, N, C) float32."""
    x = [jnp.asarray(t.float().numpy(),
                     jnp.float32 if t.dtype == torch.float32 else jnp.bfloat16)
         for t in _inputs(kind, b, n, m)]   # K3's stats stay float32
    with pltpu.force_tpu_interpret_mode():
        if kind == "K3":
            ref = jax_fused_prologue(*x)
        else:
            def head_major(a):
                return a.reshape(b, a.shape[1], HEADS, D).transpose(0, 2, 1, 3)
            ref = mhada_attention_pallas(*map(head_major, x))
            ref = ref.transpose(0, 2, 1, 3).reshape(b, n, C)
    return np.asarray(ref.astype(jnp.float32))


def _plain(kind, b, n, m):
    x = _inputs(kind, b, n, m)
    if kind == "K3":
        return mhada_fused_prologue_plain(*x)
    return mhada_tm_plain(*x, HEADS)


# The streaming kernel with its residuals, 64-key blocks; jitted, so that
# the cases that share a split's shape trace it once.
_stream_res = jax.jit(functools.partial(
    _mhada_stream_fwd_impl, block_n=256, block_m=KEY_TILE, with_res=True))


@functools.cache
def _stream(kind, b, n, m, splits):
    """The JAX streaming kernel in interpret mode with 64-key blocks on the
    core's inputs, run on each split's keys, its residuals M1, E2 and lse
    combined in float32 with weights exp(lse_s - max lse), then the
    epilogue -> (B, N, C) float32."""
    q, k, v, f = _core(kind, b, n, m)
    jq, jk, jv = (jnp.asarray(t.numpy(), jnp.bfloat16) for t in (q, k, v))
    parts = []
    for t0, t1 in split_ranges(-(-m // KEY_TILE), splits):
        keys = slice(t0 * KEY_TILE, t1 * KEY_TILE)
        with pltpu.force_tpu_interpret_mode():
            _, m1e2, lse = _stream_res(jq, jk[:, :, keys], jv[:, :, keys],
                                       jnp.asarray(f.numpy()))
        parts.append((torch.from_numpy(np.array(m1e2)),
                      torch.from_numpy(np.array(lse))))
    top = torch.stack([lse for _, lse in parts]).amax(0)
    w = [torch.exp(lse - top)[..., None] for _, lse in parts]
    both = sum(ws * m1e2 for ws, (m1e2, _) in zip(w, parts)) / sum(w)
    return _epilogue(both[..., :D], both[..., D:], f)


def _unrounded_twin(kind, b, n, m):
    """The known-wrong twin of test_torch_mhada_bf16.py: P and V^2 kept in
    float32 and the softmax normalised before the product."""
    q, k, v, f = _core(kind, b, n, m)
    a = torch.softmax(q @ k.transpose(-1, -2), -1)
    return _epilogue(a @ v, a @ v.square(), f)


# (splits, batch, queries, keys): 300 keys are 5 tiles (the last of 44
# keys), split 1, 2 (2 + 3), 3 (1 + 2 + 2) and 5 ways at 200 queries (no
# 192-row block divides them); 129 keys are 3 tiles, the last split of 3
# holding one key.
CASES = [(1, 2, 200, 300), (2, 2, 200, 300), (3, 2, 200, 300),
         (5, 2, 200, 300), (2, 1, 64, 129), (3, 1, 64, 129)]


@pytest.mark.parametrize("kind", ["K3", "K4"])
@pytest.mark.parametrize("splits,b,n,m", CASES)
def test_split_model_matches_stream_kernel(kind, splits, b, n, m):
    """The split schedule against the JAX streaming kernel run on each
    split's keys and combined (``_stream``), within one bf16 step of the
    output's largest value; the unrounded twin is more than a step off the
    same reference, so the bound tells the rounding points apart."""
    got = _model(kind, b, n, m, splits)[0]
    ref = _stream(kind, b, n, m, splits)
    assert np.isfinite(got.numpy()).all() and got.shape == ref.shape
    step = _step(ref.abs().max().item())
    assert (got - ref).abs().max() <= step
    assert (_unrounded_twin(kind, b, n, m) - ref).abs().max() > step


@pytest.mark.parametrize("kind", ["K3", "K4"])
@pytest.mark.parametrize("splits,b,n,m", CASES)
def test_split_model_matches_pallas_and_plain(kind, splits, b, n, m):
    """The split schedule against the single-pass TPU kernel (interpret
    mode) and the port's plain version on the same inputs, within two bf16
    steps of the output's largest value (the module docstring says why
    two); every split's maximum finite and its sum at least 1 (it holds a
    key below M); on the CPU the wrapper takes the plain version."""
    got, _, m_s, l_s, _ = _model(kind, b, n, m, splits)
    assert torch.isfinite(m_s).all() and bool((l_s >= 1).all())
    plain = _plain(kind, b, n, m)
    x = _inputs(kind, b, n, m)
    wrapped = (mhada_fused_prologue(*x) if kind == "K3"
               else mhada_tm(*x, HEADS))
    assert torch.equal(wrapped, plain)
    for ref in (_pallas(kind, b, n, m), plain.float().numpy()):
        assert np.isfinite(got.numpy()).all() and got.shape == ref.shape
        err = np.abs(got.numpy() - ref).max()
        assert err <= 2 * _step(np.abs(ref).max()), err


@pytest.mark.parametrize("splits,b,n,m", CASES)
def test_split_schedule_is_exact(splits, b, n, m):
    """The split schedule without its roundings, in float64 on K4's inputs:
    the ranges, the mask, the online softmax within each split and the
    combine give the exact MHAda core (softmax over all keys, M1, E2, the
    epilogue) within 1e-9 of its largest value."""
    q, k, v, f = (_heads(t).double() for t in _inputs("K4", b, n, m))
    got = split_model(q, k, v, f, splits, rounded=False)[0]
    a = torch.softmax(q @ k.transpose(-1, -2), -1)
    m1, e2 = a @ v, a @ v.square()
    want = torch.sqrt(torch.clamp(e2 - m1.square(), min=1e-6)) * f + m1
    assert (got - want).abs().max() <= 1e-9 * want.abs().max()


@pytest.mark.parametrize("kind", ["K3", "K4"])
def test_combine_partials_and_layout(kind):
    """``mhada_combine_partials`` on the model's partials and f repeats the
    model (its float32 combine, summed in another order, rounded once), and
    without the last split it is far off (the planted control of
    chip_smoke.py); ``split_partials`` with channels = 2 C reads [O1 | O2],
    m and l at csrc/attention_combine.cuh's offsets."""
    b, n, m, splits = 2, 200, 300, 3
    want, o, m_s, l_s, f = _model(kind, b, n, m, splits)
    got = mhada_combine_partials(o, m_s, l_s, f, BF16)
    assert got.dtype == BF16 and got.shape == (b, n, C)
    assert (got.float() - want).abs().max() <= _step(want.abs().max())
    dropped = mhada_combine_partials(o, m_s, l_s, f, BF16, keep=splits - 1)
    assert (dropped.float() - want).abs().max() > 0.05 * want.abs().max()
    part = torch.cat([o.reshape(-1), m_s.reshape(-1), l_s.reshape(-1)])
    assert part.numel() == splits * b * n * (2 * C + 2 * HEADS)
    views = split_partials(part, splits, b, n, 2 * C, HEADS)
    for view, ref in zip(views, (o, m_s, l_s)):
        assert torch.equal(view, ref)
    # Partials::o of (split 2, batch 1, row 5): head 1's O1 at C + 64 ...
    s, bb, hh, row = 2, 1, 1, 5
    flat = ((s * b + bb) * n + row) * 2 * C
    assert part[flat + hh * D] == o[s, bb, row, hh * D]
    assert part[flat + C + hh * D] == o[s, bb, row, C + hh * D]
    stat = ((s * b + bb) * HEADS + hh) * n + row
    assert part[splits * b * n * 2 * C + stat] == m_s[s, bb, hh, row]
    # ... and the wrapper's buffer holds as many floats
    ref = torch.zeros(b, n, C, dtype=BF16)
    count, buf = mhada_partials("mhada_tm", splits, ref, m, HEADS)
    assert count == splits and buf.numel() == part.numel()
    assert buf.dtype == torch.float32
    assert mhada_partials("mhada_tm", 1, ref, m, HEADS) == (1, None)


def test_mhada_splits_pinned():
    """The counts at the gate shapes (8 heads) on an H100's 132 SMs, as the
    chooser's docstring gives them: (B, N, M)."""
    shapes = {(1, 4096, 4096): 2, (8, 4096, 4096): 1, (1, 1024, 4096): 2,
              (1, 2048, 4096): 1, (1, 16384, 16384): 2, (1, 3600, 1024): 1,
              (1, 2048, 1024): 1, (8, 2048, 1024): 1}
    assert {s: mhada_splits(*s[:1], 8, *s[1:], 132) for s in shapes} \
        == shapes


def test_mhada_splits_invariants():
    """Over a grid of shapes: 1 <= splits <= MAX_SPLITS, no split without a
    key tile, and 1 where the grid is whole waves of the card's block
    slots; a forced count past the tiles, a float32 split, are refused
    before any buffer is made."""
    rows, per_sm = MHADA_BLOCK[:2]
    for sms in (132, 114, 16):
        for b in (1, 2, 8):
            for heads in (1, 2, 8):
                for n in (1, 63, 200, 1024, 3600, 4096):
                    for m in (1, 64, 65, 129, 1024, 4096, 16384):
                        s = mhada_splits(b, heads, n, m, sms)
                        tiles = -(-m // KEY_TILE)
                        assert 1 <= s <= min(tiles, MAX_SPLITS)
                        assert all(t1 > t0 for t0, t1
                                   in split_ranges(tiles, s))
                        if (b * heads * -(-n // rows)) % (sms * per_sm) == 0:
                            assert s == 1, (b, heads, n, m, sms)
    ref = torch.zeros(1, 64, C, dtype=BF16)
    for bad in (0, 4):
        with pytest.raises(ValueError, match="without a 64-key tile"):
            mhada_partials("mhada_tm", bad, ref, 129, HEADS)
    with pytest.raises(ValueError, match="float32 tile takes no split"):
        mhada_partials("mhada_tm", 2, torch.zeros(1, 64, C), 129, HEADS)
