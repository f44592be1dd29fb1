"""K2 at bfloat16 on the wgmma + TMA GEMM (csrc/ln_matmul_wgmma.cuh), CPU.

A torch model of the kernel's walk replays what it computes, block by
block of ``ops.ln_matmul.launch_plan``'s grid:

- the block's 128 rows of x, zero past the last row and past E up to E_k
  (E rounded up to 64), as TMA lands them;
- the LN of each row in float32, two-pass over its E columns (the mean as
  the sum times 1 / E, then the mean of (x - mean)^2, rsqrt(var + eps)),
  the affine in float32, h rounded once to bf16; columns past E keep their
  zeros, rows past the end become the affine's bias;
- h written through the kernel's swizzle (16-byte chunk c of row r at c ^
  (r % 8) of the row's 128-byte line in its box of 64 columns), then read
  back as each consumer's wgmma descriptors read it: 64 rows from the
  consumer's offset in box ks, k16 slices 32 bytes apart, every byte
  address through the 128-byte swizzle of the hardware;
- for each column tile of the block's group, k steps of 64 with float32
  sums of the bf16 products, W zero past E and F;
- the bf16 bias widened and added in float32, one rounding, stored where
  the row and column exist (each output once).

It is held against ``_ln_matmul_pallas`` (ops/ln_matmul_pallas.py:44) in
interpret mode, fed the same bf16 inputs (its rows padded with zeros to a
multiple of its 8-row tile, the padding dropped), and against the port's
``ln_matmul_plain``: ragged rows (300 and 1000: no 128-row tile divides
them), E = 64, 128 and 520 (520 is not a multiple of 64: the zero fill)
and small F (96, 384, 768), each at an SM count that gives the grid one
or several column tiles a block.

Bound: one bf16 step of the largest output (its spacing there), the mean
error within 0.002 steps: every side rounds h and the output once to bf16
at the same points, the sums run in another order, and a float32 sum a
unit apart rounds to bf16 the other way now and then (0.5 step and 4e-5
steps of mean measured).

Also: the swizzle is a bijection on a box and is the 128-byte TMA pattern;
the launch plan covers every column tile once, fills the SMs at most once
and keeps shared memory within 227 KB at every E <= MAX_E, with the
header's constants; the wrapper's refusals.

Every comparison with the Pallas kernel runs under
tests/interpret_diagnostics.py's harness: the interpreter starts from
fresh state and the torch side runs on the calling thread, rounding to
nearest.
"""

import functools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from interpret_diagnostics import (fresh_interpreter, interpreter_busy,
                                   nearest_on_this_thread, worker_state)
from mhada_tpu.ops.ln_matmul_pallas import _ln_matmul_pallas
from mhada_tpu_torch import _build
from mhada_tpu_torch.ops import ln_matmul as lm
from test_torch_mhada_split import _step

# Six test workers share the CPU: cap torch's intra-op threads.
torch.set_num_threads(2)

BF16 = torch.bfloat16
EPS = 1e-6
LINE = 128   # bytes of a box's row: 64 bf16
HEADER = Path(__file__).resolve().parents[1] / "mhada_tpu_torch" / "csrc" \
    / "ln_matmul_wgmma.cuh"

# (rows, E, F, SMs): 300 rows are 3 row tiles, the last of 44 rows; 1000
# are 8, the last of 104.  The SM count sets the grid's groups: one column
# tile a block at 132, several at 2, 4 and 16.
CASES = [(300, 64, 96, 132), (300, 128, 384, 4), (1000, 520, 768, 16),
         (1000, 64, 384, 132), (300, 520, 96, 2)]


def swizzle(r, c):
    """The kernel's byte offset of 16-byte chunk c (0..7) of row r (an int
    or a tensor of rows) in a box: ln_rows' ``chunk``, and the epilogue's
    output boxes."""
    return r * LINE + ((c ^ (r % 8)) << 4)


def sw128(addr):
    """The 128-byte swizzle of TMA and of a wgmma descriptor: byte address
    bits 4-6 XOR bits 7-9, in a tile aligned to 1024 bytes."""
    return addr ^ (((addr >> 7) & 7) << 4)


@functools.cache
def _inputs(rows, e, f):
    """Seeded bf16 x (rows, E) with rows' means spread over +-4, the LN
    affine, W (F, E) and the bias."""
    rng = np.random.default_rng((rows, e, f, 27))
    x = rng.standard_normal((rows, e)) + rng.uniform(-4, 4, (rows, 1))
    lw = 1 + 0.1 * rng.standard_normal(e)
    lb = 0.1 * rng.standard_normal(e)
    w = rng.standard_normal((f, e)) / np.sqrt(e)
    b = 0.1 * rng.standard_normal(f)
    return tuple(torch.from_numpy(a.astype(np.float32)).to(BF16)
                 for a in (x, lw, lb, w, b))


def h_tile(xt, lw, lb, e):
    """The LN of a block's (BM, E_k) float32 x tile as the consumers
    compute it: h in bf16, zero past E."""
    xe = xt[:, :e]
    mean = xe.sum(1, keepdim=True) * (1.0 / e)
    var = (xe - mean).square().sum(1, keepdim=True) * (1.0 / e)
    rstd = torch.rsqrt(var + EPS)
    h = torch.zeros_like(xt)
    h[:, :e] = (xe - mean) * rstd * lw.float() + lb.float()
    return h.to(BF16)


def through_swizzle(h):
    """h (BM, E_k) bf16 written box by box through the kernel's swizzle,
    then read back in the order of each consumer's wgmma descriptors ->
    the A tile the products see, (BM, E_k)."""
    bm, ek = h.shape
    nkb = ek // lm.BK
    box = bm * LINE
    smem = torch.full((nkb * box // 16, 8), float("nan"), dtype=BF16)
    r = torch.arange(bm)[:, None]
    for b in range(nkb):
        for c in range(8):
            slot = (b * box + swizzle(r, c)) // 16
            smem[slot[:, 0]] = h[:, b * lm.BK + 8 * c:b * lm.BK + 8 * c + 8]
    a = torch.empty_like(h)
    i = torch.arange(64)
    for g in range(bm // 64):
        for ks in range(nkb):
            for kk in range(lm.BK // 16):
                start = ks * box + g * 64 * LINE + 32 * kk
                for j in range(2):   # the two 16-byte chunks of a k16 slice
                    addr = sw128(start + i * LINE + 16 * j)
                    col = ks * lm.BK + 16 * kk + 8 * j
                    a[g * 64 + i, col:col + 8] = smem[addr // 16]
    return a


def model(x, lw, lb, w, b, sms):
    """The kernel's walk over launch_plan's grid -> (out (rows, F) bf16,
    the number of times each output was stored)."""
    rows, e = x.shape
    f = w.shape[0]
    tiles, _ = lm.launch_plan(rows, e, f, sms)
    nkb = -(-e // lm.BK)
    ek = nkb * lm.BK
    row_tiles, col_tiles = -(-rows // lm.BM), -(-f // lm.BN)
    wt = torch.zeros(col_tiles * lm.BN, ek)
    wt[:f, :e] = w.float()
    bias = torch.zeros(col_tiles * lm.BN)
    bias[:f] = b.float()
    out = torch.zeros(rows, f, dtype=BF16)
    stores = torch.zeros(rows, f, dtype=torch.int32)
    for by in range(row_tiles):
        r0 = by * lm.BM
        n = min(lm.BM, rows - r0)
        xt = torch.zeros(lm.BM, ek)
        xt[:n, :e] = x[r0:r0 + n].float()
        a = through_swizzle(h_tile(xt, lw, lb, e)).float()
        for bx in range(-(-col_tiles // tiles)):
            for t in range(bx * tiles, min((bx + 1) * tiles, col_tiles)):
                cols = slice(t * lm.BN, (t + 1) * lm.BN)
                acc = torch.zeros(lm.BM, lm.BN)
                for ks in range(nkb):
                    k = slice(ks * lm.BK, (ks + 1) * lm.BK)
                    acc += a[:, k] @ wt[cols, k].T
                o = (acc + bias[cols]).to(BF16)
                c1 = min((t + 1) * lm.BN, f)
                out[r0:r0 + n, t * lm.BN:c1] = o[:n, :c1 - t * lm.BN]
                stores[r0:r0 + n, t * lm.BN:c1] += 1
    return out, stores


@functools.cache
def _model(rows, e, f, sms):
    with nearest_on_this_thread():
        return model(*_inputs(rows, e, f), sms)


@functools.cache
def _tpu(rows, e, f):
    """_ln_matmul_pallas in interpret mode on the same bf16 inputs (W as
    (E, F)), its rows padded to a multiple of 8 -> ((rows, F) float32, the
    worker's state when it started)."""
    x, lw, lb, w, b = _inputs(rows, e, f)
    pad = -rows % 8
    xp = torch.cat([x, torch.zeros(pad, e, dtype=BF16)])

    def jx(t):
        return jnp.asarray(t.float().numpy(), jnp.bfloat16)

    stale = interpreter_busy()
    fresh_interpreter()
    try:
        with pltpu.force_tpu_interpret_mode():
            got = _ln_matmul_pallas(jx(xp)[None], jx(lw), jx(lb), jx(w.T),
                                    jx(b), EPS)
            got = np.array(got.astype(jnp.float32))[0, :rows]
    except Exception as e_:
        raise AssertionError(f"the Pallas kernel raised in interpret mode: "
                             f"{e_!r}; {worker_state(stale)}") from e_
    return torch.from_numpy(got), worker_state(stale)


def _within(got, ref, what, state):
    """got within one bf16 step of ref's largest value, its mean error
    within 0.002 steps."""
    step = _step(ref.abs().max().item())
    err = (got.float() - ref.float()).abs()
    why = (f"{what}: max {err.max().item() / step:.3f} steps, mean "
           f"{err.mean().item() / step:.4f} steps; {state}")
    assert bool(torch.isfinite(got.float()).all()), why
    assert got.shape == ref.shape, why
    assert err.max().item() <= step, why
    assert err.mean().item() <= 0.002 * step, why


@pytest.mark.parametrize("rows,e,f,sms", CASES)
def test_walk_matches_pallas(rows, e, f, sms):
    """The model against the TPU kernel in interpret mode; every output
    stored once."""
    got, stores = _model(rows, e, f, sms)
    assert bool((stores == 1).all())
    ref, state = _tpu(rows, e, f)
    _within(got, ref, f"rows {rows} E {e} F {f}", state)


@pytest.mark.parametrize("rows,e,f,sms", CASES)
def test_walk_matches_plain(rows, e, f, sms):
    """The model against the port's plain version, which the wrapper runs
    on CPU tensors (ln_matmul with all five inputs bf16)."""
    got, _ = _model(rows, e, f, sms)
    x, lw, lb, w, b = _inputs(rows, e, f)
    with nearest_on_this_thread():
        ref = lm.ln_matmul_plain(x, lw, lb, w, b, EPS)
        assert torch.equal(lm.ln_matmul(x, lw, lb, w, b, EPS), ref)
    _within(got, ref, f"rows {rows} E {e} F {f}", worker_state(None))


def test_swizzle_is_the_tma_pattern():
    """The kernel's chunk address is a bijection on a box of 128 rows x 8
    chunks, and is the 128-byte swizzle of the unswizzled address, so the
    generic stores of h land where the descriptors read; the epilogue's
    4-byte words (lane t of a quad at 4 t in its chunk) fill an output box
    of 64 x 64 once, where its TMA store reads them."""
    slots = {swizzle(r, c) for r in range(lm.BM) for c in range(8)}
    assert slots == set(range(0, lm.BM * LINE, 16))
    for r in range(lm.BM):
        for c in range(8):
            assert swizzle(r, c) == sw128(r * LINE + 16 * c)
    words = [swizzle(r, c) + 4 * t for r in range(64) for c in range(8)
             for t in range(4)]
    assert sorted(words) == list(range(0, 64 * LINE, 4))
    assert all(swizzle(r, c) + 4 * t == sw128(r * LINE + 16 * c + 4 * t)
               for r in range(64) for c in range(8) for t in range(4))


def test_header_constants_match():
    """The plan's constants are the kernel's."""
    code = "\n".join(ln.split("//")[0] for ln in HEADER.read_text()
                     .splitlines())

    def const(name):
        return eval(re.search(rf"\b{name} = ([\d *]+);", code)[1])

    assert (const("kBM"), const("kBN"), const("kBK")) == (lm.BM, lm.BN,
                                                         lm.BK)
    assert const("kBlocksPerSm") == lm.BLOCKS_PER_SM
    assert const("kMaxE") == lm.MAX_E
    assert const("kMaxStages") == lm.MAX_STAGES
    assert const("kSmemPerSm") == lm.SMEM_PER_SM


@pytest.mark.parametrize("rows,f", [(4096, 1536), (4096, 2048), (16384, 2048),
                                    (3600, 1536), (8192, 768), (32768, 1024),
                                    (300, 96), (1000, 7)])
def test_launch_plan_covers_every_tile_once(rows, f):
    """At the H100's 132 SMs and at fewer: the grid's groups take every
    column tile of a row tile once, each block at least one; the grid fills
    the SMs at most once wherever the row tiles alone do not exceed them."""
    for sms in (132, 100, 16, 3):
        tiles, stages = lm.launch_plan(rows, 512, f, sms)
        row_tiles, col_tiles = -(-rows // lm.BM), -(-f // lm.BN)
        groups = -(-col_tiles // tiles)
        firsts = [g * tiles for g in range(groups)]
        owned = [t for t0 in firsts
                 for t in range(t0, min(t0 + tiles, col_tiles))]
        assert owned == list(range(col_tiles)), (sms, tiles)
        assert all(t0 < col_tiles for t0 in firsts)
        if row_tiles <= sms * lm.BLOCKS_PER_SM:
            assert groups * row_tiles <= sms * lm.BLOCKS_PER_SM, (sms, tiles)
        else:
            assert groups == 1
        assert 2 <= stages <= lm.MAX_STAGES


def test_launch_plan_fits_shared_memory():
    """At every E the bf16 kernel takes, the plan's stages fit the 227 KB a
    block may take beside h, as many as fit (at least 4; 6 at E = 512)."""
    limit = lm.SMEM_PER_SM // lm.BLOCKS_PER_SM - 1024
    assert limit == 227 * 1024
    for e in range(8, lm.MAX_E + 1, 8):
        _, stages = lm.launch_plan(4096, e, 1536, 132)
        assert lm.smem_bytes(e, stages) <= limit, e
        assert lm.smem_bytes(e, stages + 1) > limit \
            or stages == lm.MAX_STAGES, e
        assert stages >= 4, e
    assert lm.launch_plan(4096, 512, 1536, 132)[1] == 6


def _k2_args(e, f=16):
    x = torch.zeros(1, 4, e, dtype=BF16)
    return x, x[0, 0], x[0, 0], torch.zeros(f, e, dtype=BF16), \
        torch.zeros(f, dtype=BF16)


@pytest.mark.parametrize("e,match", [(512, "CUDA device"),
                                     (36, "multiple of 8"),
                                     (lm.MAX_E + 8, f"<= {lm.MAX_E}")])
def test_wrapper_refusals(e, match):
    """The kernel's launch refuses CPU tensors, E % 8 and E > MAX_E at bf16
    before anything launches; the wrapper on CPU tensors takes the plain
    version and refuses the kernel backend."""
    before = dict(_build.LAUNCHES)
    args = _k2_args(e)
    with pytest.raises(ValueError, match=match):
        lm._ln_matmul_kernel(*args, EPS)
    with pytest.raises(RuntimeError, match="needs a CUDA tensor"):
        lm.ln_matmul(*args, backend="kernel")
    assert _build.LAUNCHES == before
