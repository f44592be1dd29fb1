"""K1 and K6's forward on the attention tile (csrc/attention_wgmma.cuh, the
self form: q = qkv at row stride 3C, kv = qkv + C), split over the keys
(csrc/attention_combine.cuh), with the row log-sum-exp, CPU.

The split schedule's torch model (``split_model`` of
tests/test_torch_cross_split.py: 192-query blocks at bfloat16, 256 at
float32; split s of S walking the whole 64-key tiles [s T / S, (s + 1) T /
S); an online softmax in log2 units; float32 partials and their combine in
a fixed order) is read here from one packed qkv, and gives the lse the
kernel writes: m ln 2 + log l unsplit, ln 2 max_s m_s + log sum_s 2^(m_s -
max m) l_s split.  It is held against the TPU kernels that K1 and K6's
forward replace, in interpret mode: ``_attn_tm_fwd_impl(with_res=True)``
(``_tm_res_kernel``, pallas_call at attention_pallas.py:236) and, for the
head-major K12 that training takes above 2048 tokens,
``_attn_stream_fwd_impl(with_res=True)`` (:488); and against the port's
plain versions (``attention_plain``, ``attention_train_fwd_plain``).
Ragged L (200, 1000; no block or key tile divides them), B = 2, 2 heads,
1, 2 and 3 splits at bfloat16, and L = 129 over 3 splits, whose last split
is one key tile of one key; float32 takes no split (its tile is
``attention_f32_kernel<true, false>``, one block a query block).
``combine_partials``' lse against the model's; ``self_splits`` pinned at
K1's and K6's gate shapes and at the tensor-parallel shares (4 heads).

Bounds: out as tests/test_torch_cross_split.py's (float32 2e-5 absolute
and 1e-4 relative; bfloat16 2^-8 of the output's scale, the model's
combine taken before its one rounding); lse 1e-5 relative (P is rounded to
bfloat16 only inside P V, so the row sums are float32 on every side)."""

import functools
import math

import numpy as np
import pytest
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from mhada_tpu.ops.attention_pallas import (_attn_stream_fwd_impl,
                                            _attn_tm_fwd_impl)
from mhada_tpu_torch.ops import attention_kernel
from mhada_tpu_torch.ops.attention_kernel import (_cross_launch,
                                                  _tm_launch,
                                                  attention_plain,
                                                  attention_tm,
                                                  combine_partials,
                                                  self_split_args,
                                                  self_splits)
from mhada_tpu_torch.ops.attention_train import (attention_train_fwd_plain,
                                                 fwd_launch)
from test_torch_cross_split import BF16_REL, split_model

# Six test workers share the CPU: cap torch's intra-op threads.
torch.set_num_threads(2)

HEADS, D, SCALE = 2, 64, 0.125
C = HEADS * D
LSE_REL = 1e-5


def _qkv(b, l, seed):
    """A packed (B, L, 3C) qkv, float32 numpy."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, l, 3 * C)).astype(np.float32)


def _heads(qkv, i):
    """Q (i = 0), K (1) or V (2) of a packed numpy or torch qkv, head-major
    (B, H, L, D)."""
    b, l, _ = qkv.shape
    x = qkv[..., i * C:(i + 1) * C].reshape(b, l, HEADS, D)
    return (x.permute(0, 2, 1, 3) if isinstance(x, torch.Tensor)
            else x.transpose(0, 2, 1, 3))


def model(b, l, seed, splits, dtype):
    """The tile's schedule on the packed qkv's values of ``dtype`` -> (out
    (B, L, C) float32 before the one rounding, lse (B, H, L), the partials
    O_s (S, B, L, C) token-major, m_s, l_s (S, B, H, L))."""
    qkv = torch.from_numpy(_qkv(b, l, seed)).to(dtype).float()
    q, k, v = (_heads(qkv, i) for i in range(3))
    out, o_s, m_s, l_s = split_model(q, k, v, SCALE, splits, dtype)
    mx = m_s.amax(0)
    den = torch.zeros(b, HEADS, l)
    for s in range(splits):   # the combine's fixed order
        den = den + torch.exp2(m_s[s] - mx) * l_s[s]
    lse = mx * math.log(2.0) + torch.log(den)
    return (out.transpose(1, 2).reshape(b, l, C), lse,
            o_s.permute(0, 1, 3, 2, 4).reshape(splits, b, l, C), m_s, l_s)


@functools.cache
def _tm_res(b, l, seed, dname):
    """_attn_tm_fwd_impl(with_res=True) in interpret mode -> (out (B, L, C),
    lse (B, H, L)) float32: its lse row is broadcast over each head's 64
    lanes."""
    qkv = jnp.asarray(_qkv(b, l, seed)).astype(jnp.dtype(dname))
    with pltpu.force_tpu_interpret_mode():
        out, lse = _attn_tm_fwd_impl(qkv, SCALE, HEADS, 256, with_res=True)
    lse = np.asarray(lse)
    assert (lse.reshape(b, l, HEADS, D) == lse[..., ::D, None]).all()
    return (np.asarray(out.astype(jnp.float32)),
            lse[..., ::D].transpose(0, 2, 1))


@functools.cache
def _stream_res(b, l, seed, dname):
    """_attn_stream_fwd_impl(with_res=True), the head-major K12, in
    interpret mode -> (out (B, L, C), lse (B, H, L)) float32."""
    qkv = _qkv(b, l, seed)
    q, k, v = (jnp.asarray(np.ascontiguousarray(_heads(qkv, i)))
               .astype(jnp.dtype(dname)) for i in range(3))
    with pltpu.force_tpu_interpret_mode():
        out, lse = _attn_stream_fwd_impl(q, k, v, SCALE, 128, 512, True)
    out = np.asarray(out.astype(jnp.float32)).transpose(0, 2, 1, 3)
    return out.reshape(b, l, C), np.asarray(lse)


def _close(got, ref, dtype):
    assert np.isfinite(got).all() and got.shape == ref.shape
    if dtype == torch.float32:
        np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-4)
    else:
        err = np.abs(got - ref).max()
        assert err <= BF16_REL * np.abs(ref).max(), err


def _lse_close(got, ref):
    assert np.isfinite(got).all() and got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= LSE_REL * np.abs(ref).max(), err


# (dtype, splits, batch, tokens): 200 tokens are 4 key tiles (the last of 8
# keys; 3 splits: 1 + 1 + 2), 1000 are 16 (the last of 40; 3 splits: 5 + 5
# + 6), 129 are 3 (3 splits of one tile, the last of one key).
CASES = ([(torch.float32, 1, 2, l) for l in (200, 1000)]
         + [(torch.bfloat16, s, 2, l) for l in (200, 1000) for s in (1, 2, 3)]
         + [(torch.bfloat16, 3, 2, 129)])


@pytest.mark.parametrize("dtype,splits,b,l", CASES)
def test_self_model_matches_tm_res_and_plain(dtype, splits, b, l):
    """The self form's schedule against _tm_res_kernel in interpret mode
    and the plain versions: out and lse; every split's maximum finite and
    its sum at least 1."""
    got, lse, _, m_s, l_s = model(b, l, 5, splits, dtype)
    assert torch.isfinite(m_s).all() and bool((l_s >= 1).all())
    ref, ref_lse = _tm_res(b, l, 5, str(dtype)[6:])
    _close(got.numpy(), ref, dtype)
    _lse_close(lse.numpy(), ref_lse)
    qkv = torch.from_numpy(_qkv(b, l, 5)).to(dtype)
    plain = attention_plain(qkv, HEADS, SCALE)
    out6, lse6 = attention_train_fwd_plain(qkv, HEADS, SCALE)
    _close(got.numpy(), plain.float().numpy(), dtype)
    _close(got.numpy(), out6.float().numpy(), dtype)
    _lse_close(lse.numpy(), lse6.numpy())
    # on the CPU the wrapper takes the plain version
    assert torch.equal(attention_tm(qkv, HEADS, SCALE), plain)


@pytest.mark.parametrize("dtype,splits", [(torch.float32, 1),
                                          (torch.bfloat16, 3)])
def test_self_model_matches_streaming_forward(dtype, splits):
    """Above 2048 tokens K6's forward stands for the head-major K12's
    streaming forward with lse: 1000 tokens over ``splits`` against it in
    interpret mode (its 128-query and 512-key blocks, ragged)."""
    b, l = 2, 1000
    got, lse = model(b, l, 9, splits, dtype)[:2]
    ref, ref_lse = _stream_res(b, l, 9, str(dtype)[6:])
    _close(got.numpy(), ref, dtype)
    _lse_close(lse.numpy(), ref_lse)


@pytest.mark.parametrize("splits", [1, 2, 3])
def test_combine_lse_matches_model(splits):
    """``combine_partials`` on the model's partials gives the model's out
    and lse; without the last split the lse is off by far more than its
    bound (the planted control of chip_smoke.py's K6 gate)."""
    b, l = 2, 200
    want, want_lse, o_s, m_s, l_s = model(b, l, 5, splits, torch.bfloat16)
    out, lse = combine_partials(o_s, m_s, l_s, torch.float32)
    _close(out.numpy(), want.numpy(), torch.float32)
    _lse_close(lse.numpy(), want_lse.numpy())
    assert lse.dtype == torch.float32 and lse.shape == (b, HEADS, l)
    if splits > 1:
        dropped = combine_partials(o_s, m_s, l_s, torch.float32,
                                   keep=splits - 1)[1]
        assert (dropped - want_lse).abs().max() > 100 * LSE_REL * \
            want_lse.abs().max()


def test_self_splits_pinned():
    """The counts at K1's and K6's gate shapes on an H100's 132 SMs (each
    within 1.4 % of the fastest count in probes/cross_split_sweep.py's
    sweep on an H100 80GB HBM3 at 700 W), 8 heads: K1 at L = 4096, 16384
    and the Sintel frame's 3600 (B = 1); K6 at B = 8, L = 1024 (the 256^2
    step), B = 4, L = 4096 (512^2), B = 1, L = 16384, B = 2, L = 2048 (the
    video step) and B = 1, L = 1024 (the inversion); the tensor-parallel
    shares, 4 heads: B = 4, L = 1024 and B = 1, L = 2048.  float32 takes
    none."""
    shapes = [(1, 4096, 8), (1, 16384, 8), (1, 3600, 8), (8, 1024, 8),
              (4, 4096, 8), (2, 2048, 8), (1, 1024, 8), (4, 1024, 4),
              (1, 2048, 4)]
    assert [self_splits(b, h, l, torch.bfloat16, 132)
            for b, l, h in shapes] == [3, 4, 3, 1, 1, 2, 2, 1, 3]
    assert {self_splits(b, h, l, torch.float32, 132)
            for b, l, h in shapes} == {1}


def test_k1_count_is_one_sequences(monkeypatch):
    """K1 takes one sequence's count at every batch, so that a frame's
    output does not depend on the batch it is stylized in; K6's forward
    takes its batch's.  At 8 heads and 1024 tokens on 132 SMs one sequence
    takes 2 splits and a batch of 8 none; the partials buffer follows the
    count."""
    monkeypatch.setattr(attention_kernel, "sm_count", lambda index: 132)
    qkv = torch.zeros(8, 1024, 3 * 512, dtype=torch.bfloat16)
    splits, part = self_split_args("attention_tm", qkv, 8, None,
                                   count_batch=1)
    assert splits == self_splits(1, 8, 1024, torch.bfloat16) == 2
    assert part.numel() == 2 * 8 * 1024 * (512 + 2 * 8)
    assert part.dtype == torch.float32
    assert self_split_args("attention_train", qkv, 8, None) == (1, None)


def test_self_split_refusals():
    """The launch helpers refuse a split of float32, a count past the key
    tiles and, at bfloat16, a scale that is not positive (K1's cross form
    too) (the tile takes
    the row maximum of the raw scores) before they allocate anything or
    look for a card."""
    qkv = torch.zeros(1, 129, 3 * C)
    with pytest.raises(ValueError, match="without a 64-key tile"):
        _tm_launch(qkv.bfloat16(), HEADS, SCALE, 4)
    for scale in (-SCALE, 0.0):
        with pytest.raises(ValueError, match="positive scale"):
            _tm_launch(qkv.bfloat16(), HEADS, scale)
        with pytest.raises(ValueError, match="positive scale"):
            fwd_launch(qkv.bfloat16(), HEADS, scale)
        with pytest.raises(ValueError, match="positive scale"):
            _cross_launch(qkv.bfloat16()[..., :C], qkv.bfloat16()[..., C:],
                          HEADS, scale)
    with pytest.raises(ValueError, match="takes no split"):
        fwd_launch(qkv, HEADS, SCALE, 2)
    with pytest.raises(ValueError, match="without a 64-key tile"):
        fwd_launch(qkv.bfloat16(), HEADS, SCALE, 4)
