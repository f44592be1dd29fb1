"""K13 against the JAX package, CPU: c6's plain version against
``c6_transposed`` (interpret mode), the port's ``Decoder(tail="c6")``
against ``Decoder(packed="col_tail")``, and the guards; torch models of
the two kernels' schedules against the plain version: the float32 direct
conv (``csrc/decoder_c6_f32.cuh``: 16-row strips of 64 columns walked 2
rows a step through a ring of 6 window rows whose spent slots are refilled
mid-step, runs of 8 pixels, one load
a window pixel for the 3 horizontal taps, the 16 channel quads summed by
a butterfly) and the bf16 implicit GEMM (``csrc/decoder_c6_mma.cuh``:
the same walk, k = 9 taps x 64 channels, N padded to 8, one rounding
after the float32 bias).  The whole c6-tail path is in
test_torch_c6_path.py."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from mhada_tpu.models.decoder import Decoder as JaxDecoder
from mhada_tpu.ops.colpacked import space_to_col
from mhada_tpu.ops.decoder_tail_pallas import c6_transposed
from mhada_tpu_torch.config import ModelConfig
from mhada_tpu_torch.interop import params_from_jax
from mhada_tpu_torch.models import build_models
from mhada_tpu_torch.models.decoder import Decoder
from mhada_tpu_torch.ops.decoder_c6 import (c6_conv, c6_conv_plain,
                                            kernel_params)

# Six test workers share the CPU: cap torch's intra-op threads.
torch.set_num_threads(2)

SMALL = dict(num_layers=2, hidden_dim=128, num_heads=2, mlp_dim=256)


def _oihw(w):
    return torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))


@pytest.mark.parametrize("b,h,w,dtype", [(1, 32, 24, "float32"),
                                         (2, 48, 16, "float32"),
                                         (1, 32, 24, "bfloat16")])
def test_c6_plain_matches_c6_transposed(b, h, w, dtype):
    """The inputs of tests/test_decoder_tail.py::test_c6_transposed_exact.
    float32: its bound (atol 2e-4, rtol 1e-4).  bfloat16: both sum bf16
    products in float32 in another order and round once at the end, so
    they may differ by one bf16 step of the output (2^-8 relative, outputs
    up to ~4): atol 1e-2, rtol 8e-3."""
    rng = np.random.default_rng(7)
    y = np.abs(rng.standard_normal((b, h, w, 64))).astype(np.float32)
    w6 = (rng.standard_normal((3, 3, 64, 3)) * 0.1).astype(np.float32)
    b6 = rng.standard_normal(3).astype(np.float32)
    jdt = getattr(jnp, dtype)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(c6_transposed(space_to_col(jnp.asarray(y, jdt)),
                                       jnp.asarray(w6), jnp.asarray(b6)),
                         np.float32)
    yt = torch.from_numpy(y).to(getattr(torch, dtype))
    got = c6_conv_plain(yt, _oihw(w6), torch.from_numpy(b6))
    assert got.dtype == yt.dtype and got.shape == (b, h, w, 3)
    tol = (dict(atol=2e-4, rtol=1e-4) if dtype == "float32"
           else dict(atol=1e-2, rtol=8e-3))
    np.testing.assert_allclose(got.float().numpy(), ref, **tol)
    # the wrapper takes the plain version for CPU tensors
    assert torch.equal(c6_conv(yt, _oihw(w6), torch.from_numpy(b6)), got)


def test_decoder_c6_matches_jax_col_tail():
    """Decoder(tail="c6") == JAX Decoder(packed="col_tail") with shared
    params (the bound of tests/test_decoder_tail.py:29-41); one state_dict
    loads strictly into both tails."""
    x = np.random.default_rng(53).standard_normal((1, 4, 6, 512)) \
        .astype(np.float32)
    params = JaxDecoder(packed=False).init(jax.random.PRNGKey(0),
                                           x)["params"]
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(JaxDecoder(packed="col_tail").apply(
            {"params": params}, x))
    sd = params_from_jax(params)
    decs = {}
    for tail in ("fused", "c6"):
        decs[tail] = Decoder(512, tail=tail).eval()
        decs[tail].load_state_dict(sd, strict=True)
    assert decs["fused"].state_dict().keys() == decs["c6"].state_dict().keys()
    with torch.no_grad():
        got = decs["c6"](torch.from_numpy(x)).numpy()
        fused = decs["fused"](torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (1, 32, 48, 3)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got, fused, atol=1e-6, rtol=1e-5)


def test_c6_tail_guards():
    with pytest.raises(ValueError, match="K8"):
        build_models(ModelConfig(**SMALL), "cpu", for_training=True,
                     decoder_tail="c6")
    with pytest.raises(ValueError, match="unknown decoder tail"):
        build_models(ModelConfig(**SMALL), "cpu", decoder_tail="col_tail")
    with pytest.raises(ValueError, match="unknown decoder tail"):
        Decoder(512, tail="mega")
    dec = Decoder(128, tail="c6")   # modules start in training mode
    with pytest.raises(RuntimeError, match="forward-only"):
        dec(torch.zeros(1, 2, 2, 128))
    y = torch.zeros(1, 4, 4, 64)
    w6, b6 = torch.zeros(3, 64, 3, 3), torch.zeros(3)
    with pytest.raises(RuntimeError, match="needs a CUDA tensor"):
        c6_conv(y, w6, b6, backend="kernel")
    with pytest.raises(ValueError, match="bad shapes"):
        c6_conv(torch.zeros(1, 4, 4, 32), w6, b6)


# The kernels' geometry (csrc/decoder_c6_f32.cuh, decoder_c6_mma.cuh).
COLS, STRIP, RUN, SLOTS = 64, 16, 8, 6


def _reflect(i, n):
    """csrc/common.cuh::reflect_index: mirror, then clamp."""
    if i < 0:
        i = -i
    if i >= n:
        i = 2 * n - 2 - i
    return max(0, min(n - 1, i))


def _walk(y, step_fn, stale_past_edge=False):
    """The blocks' walk: per 64-column block and 16-row strip, window rows
    y0 - 1 .. (reflected, then clamped) land in a ring of 6 slots, rows 0-5
    first; step s reads rows 2s and 2s + 1 from their slots, then those
    slots take rows 2s + 6 and 2s + 7 (for step s + 2), then it reads rows
    2s + 2 and 2s + 3.  ``step_fn(rows)`` maps the step's 4 window rows (B,
    4, 66, 64) to its 2 output rows (B, 2, 64, 3).  Only in-image pixels
    are stored.  ``stale_past_edge``: window columns past image column W
    hold NaN (the float32 build's bulk copies leave them stale)."""
    bsz, h, w, _ = y.shape
    out = torch.full((bsz, h, w, 3), float("nan"), dtype=y.dtype)
    for y0 in range(0, h, STRIP):
        steps = (min(STRIP, h - y0) + 1) // 2
        for x0 in range(0, w, COLS):
            cols = [_reflect(x0 - 1 + c, w) for c in range(COLS + 2)]
            ring = [None] * SLOTS

            def issue(r):
                ring[r % SLOTS] = y[:, _reflect(y0 - 1 + r, h)][:, cols]
                if stale_past_edge and x0 + COLS > w:
                    ring[r % SLOTS][:, w - x0 + 2:] = float("nan")

            for r in range(min(6, 2 * steps + 2)):
                issue(r)
            for s in range(steps):
                spent = [ring[(2 * s + ri) % SLOTS] for ri in range(2)]
                if s + 2 < steps:
                    issue(2 * s + 6)
                    issue(2 * s + 7)
                rows = torch.stack(spent + [ring[(2 * s + ri) % SLOTS]
                                            for ri in range(2, 4)], 1)
                res = step_fn(rows)
                vh = min(2, h - y0 - 2 * s)
                vw = min(COLS, w - x0)
                out[:, y0 + 2 * s:y0 + 2 * s + vh, x0:x0 + vw] = \
                    res[:, :vh, :vw]
    return out


def _direct_conv_step(hwio, bias):
    """One step of decoder_c6_f32.cuh: lane (quad q, run) loads float4 j of
    each input row once and applies it to output row o through kernel row
    ri - o and to pixel j - kx through every kernel column kx; then the 16
    quads' partial sums meet in a butterfly (xor 8, 4, 2, 1); bias, ReLU."""
    wq = hwio.reshape(3, 3, 16, 4, 3)   # [ky][kx][quad][channel][co]
    runs = torch.arange(COLS // RUN) * RUN

    def step(rows):
        bsz = rows.shape[0]
        xq = rows.reshape(bsz, 4, COLS + 2, 16, 4)
        acc = torch.zeros(bsz, 2, COLS // RUN, RUN, 16, 3)
        for ri in range(4):
            for j in range(RUN + 2):
                x = xq[:, ri, runs + j]           # (B, runs, quads, 4)
                for o in range(2):
                    ky = ri - o
                    if not 0 <= ky <= 2:
                        continue
                    for kx in range(3):
                        p = j - kx
                        if 0 <= p < RUN:
                            acc[:, o, :, p] += torch.einsum(
                                "brqi,qic->brqc", x, wq[ky, kx])
        lanes = torch.arange(16)
        for m in (8, 4, 2, 1):
            acc = acc + acc[..., lanes ^ m, :]
        return torch.relu(acc[..., 0, :].reshape(bsz, 2, COLS, 3) + bias)

    return step


def _implicit_gemm_step(hwio, bias):
    """One step of decoder_c6_mma.cuh: per output row o, A (64 pixels x
    576) gathered from window row o + ky at column offset kx for tap (ky,
    kx), B the HWIO weights as (576, 3) padded with zeros to N = 8; the
    product summed in float32, the float32 bias added, ReLU, one rounding
    to bf16."""
    bmat = torch.zeros(9 * 64, 8)
    bmat[:, :3] = hwio.float().reshape(9 * 64, 3)

    def step(rows):
        outs = []
        for o in range(2):
            a = torch.cat([rows[:, o + t // 3, t % 3:t % 3 + COLS]
                           for t in range(9)], -1)   # (B, 64, 576)
            acc = a.float() @ bmat
            outs.append(torch.relu(acc[..., :3] + bias).to(rows.dtype))
        return torch.stack(outs, 1)

    return step


SCHEDULE_SHAPES = [(2, 19, 70), (3, 17, 33), (1, 5, 2), (1, 2, 2)]


def _c6_inputs(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    y = torch.from_numpy(np.abs(rng.standard_normal((*shape, 64))).astype(
        np.float32)).to(dtype)
    w6 = torch.from_numpy((rng.standard_normal((3, 64, 3, 3)) * 0.1).astype(
        np.float32))
    b6 = torch.from_numpy(rng.standard_normal(3).astype(np.float32))
    return y, w6, b6


@pytest.mark.parametrize("shape", SCHEDULE_SHAPES)
def test_c6_direct_conv_schedule_matches_plain(shape):
    """The float32 kernel's indexing (the strip walk and its ring of window
    rows, ragged strips and column blocks, a 2-wide and a 2-high image,
    reflected edges, stale columns past the image that no stored pixel
    reads, the wrapper's HWIO layout) and its sum
    (channel quads, then the quads' butterfly) against c6_conv_plain: max
    |d| / max |plain| within 1e-5 (sums in another order)."""
    y, w6, b6 = _c6_inputs(shape, torch.float32, 17)
    ref = c6_conv_plain(y, w6, b6)
    hwio, bias = kernel_params(w6, b6, y.dtype)
    assert hwio.shape == (3, 3, 64, 3) and bias.dtype == torch.float32
    got = _walk(y, _direct_conv_step(hwio, bias), stale_past_edge=True)
    assert torch.isfinite(got).all()
    rel = ((got - ref).abs().max() / ref.abs().max()).item()
    assert rel <= 1e-5, rel


@pytest.mark.parametrize("shape", SCHEDULE_SHAPES)
def test_c6_implicit_gemm_schedule_matches_plain(shape):
    """The bf16 kernel's GEMM (taps as shifts of the window rows, N padded
    to 8) and rounding points against c6_conv_plain at bf16: both sum exact
    bf16 products in float32, in another order, and round once after the
    float32 bias, so they may differ by one bf16 step of the output (the
    bound of test_c6_plain_matches_c6_transposed, atol 1e-2, rtol 8e-3)."""
    y, w6, b6 = _c6_inputs(shape, torch.bfloat16, 18)
    ref = c6_conv_plain(y, w6, b6)
    hwio, bias = kernel_params(w6, b6, y.dtype)
    assert hwio.dtype == torch.bfloat16 and bias.dtype == torch.float32
    got = _walk(y, _implicit_gemm_step(hwio, bias))
    assert got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()
    np.testing.assert_allclose(got.float().numpy(), ref.float().numpy(),
                               atol=1e-2, rtol=8e-3)
