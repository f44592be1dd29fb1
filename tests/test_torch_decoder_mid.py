"""K14's plain version against the JAX package's ``mid3_fused`` (interpret
mode), CPU, at the cases of tests/test_decoder_mid.py; models of the bf16
kernel's implicit GEMM (csrc/decoder_mid_mma.cuh) and of the float32
kernel's direct conv (csrc/decoder_mid_f32.cuh) on the weights as the
wrapper hands them, against the plain version; and the wrapper's
guards."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from mhada_tpu.ops.decoder_mid_pallas import mid3_fused as jax_mid3_fused
from mhada_tpu_torch.ops.decoder_mid import (kernel_params, mid3_fused,
                                             mid3_fused_plain)

# Six test workers share the CPU: cap torch's intra-op threads.
torch.set_num_threads(2)


def _params(rng, c):
    """Three stages' HWIO weights and biases at test_decoder_mid.py's
    scales (weights 0.5 / sqrt(C), biases 0.1)."""
    ws = [(rng.standard_normal((3, 3, c, c)) * (0.5 / np.sqrt(c))).astype(
        np.float32) for _ in range(3)]
    bs = [(rng.standard_normal(c) * 0.1).astype(np.float32) for _ in range(3)]
    return ws, bs


def _oihw(w):
    return torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))


@pytest.mark.parametrize("c,b,h,w,th,dtype", [
    (128, 1, 8, 8, 8, "float32"),      # the TPU kernel's single row tile
    (128, 1, 16, 8, 8, "float32"),     # two tiles
    (256, 2, 12, 8, 4, "float32"),     # three tiles, full channel width
    (128, 1, 16, 8, 8, "bfloat16"),
])
def test_mid3_plain_matches_pallas(c, b, h, w, th, dtype):
    """test_decoder_mid.py's bounds: float32 atol 3e-5, rtol 1e-4 (sums in
    another order); bfloat16 atol 0.12, rtol 0.05 (the same rounding points,
    but a value on either side of a bf16 rounding boundary moves the next
    stages by whole bf16 steps)."""
    rng = np.random.default_rng(71)
    ws, bs = _params(rng, c)
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    jdt = getattr(jnp, dtype)
    pairs = [jnp.asarray(t, jdt) for wb in zip(ws, bs) for t in wb]
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jax_mid3_fused(jnp.asarray(x, jdt), *pairs,
                                        row_tile=th), np.float32)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    args = [t for wb in zip(ws, bs) for t in (_oihw(wb[0]),
                                              torch.from_numpy(wb[1]))]
    got = mid3_fused_plain(xt, *args)
    assert got.dtype == xt.dtype and got.shape == (b, h, w, c)
    tol = (dict(atol=3e-5, rtol=1e-4) if dtype == "float32"
           else dict(atol=0.12, rtol=0.05))
    np.testing.assert_allclose(got.float().numpy(), ref, **tol)
    # the wrapper takes the plain version for CPU tensors
    assert torch.equal(mid3_fused(xt, *args), got)


def test_mid3_guards():
    x = torch.zeros(1, 4, 4, 128)
    w, b = torch.zeros(128, 128, 3, 3), torch.zeros(128)
    with pytest.raises(RuntimeError, match="needs a CUDA tensor"):
        mid3_fused(x, w, b, w, b, w, b, backend="kernel")
    with pytest.raises(ValueError, match="multiple of 128"):
        mid3_fused(torch.zeros(1, 4, 4, 64), *[torch.zeros(64, 64, 3, 3),
                                               torch.zeros(64)] * 3)
    with pytest.raises(ValueError, match="bad shapes"):
        mid3_fused(x, w, b, w[:, :64], b, w, b)


def _reflect(i, n):
    """csrc/common.cuh::reflect_index: mirror into [0, n), then clamp."""
    i = -i if i < 0 else i
    i = 2 * n - 2 - i if i >= n else i
    return max(0, min(n - 1, i))


def _implicit_gemm_stage(x, w, bias, tile=16, co_block=128, chunk=64):
    """One stage as decoder_mid_mma.cuh computes it: per 16 x 16 output
    tile, the 18 x 18 window gathered by reflected indices; per block of
    128 output channels, the sum over 64-channel chunks and the 9 taps of
    the tap-shifted window times the HWIO weight tile [tap][ci][co] in
    float32; the sum rounded to the dtype, the bias added and rounded,
    ReLU; only in-image pixels stored."""
    bsz, h, wd, c = x.shape
    xf, wf = x.float(), w.float()
    y = torch.empty_like(x)
    for oy0 in range(0, h, tile):
        rows = [_reflect(oy0 - 1 + p, h) for p in range(tile + 2)]
        for ox0 in range(0, wd, tile):
            cols = [_reflect(ox0 - 1 + p, wd) for p in range(tile + 2)]
            win = xf[:, rows][:, :, cols]
            acc = torch.zeros(bsz, tile, tile, c)
            for co0 in range(0, c, co_block):
                cs = slice(co0, co0 + co_block)
                for ci0 in range(0, c, chunk):
                    ks = slice(ci0, ci0 + chunk)
                    for tap in range(9):
                        dy, dx = tap // 3, tap % 3
                        acc[..., cs] += (win[:, dy:dy + tile, dx:dx + tile, ks]
                                         @ wf[dy, dx, ks, cs])
            out = torch.relu((acc.to(x.dtype).float() + bias).to(x.dtype))
            vh, vw = min(tile, h - oy0), min(tile, wd - ox0)
            y[:, oy0:oy0 + vh, ox0:ox0 + vw] = out[:, :vh, :vw]
    return y


@pytest.mark.parametrize("c,shape,dtype", [
    (128, (2, 19, 37), "float32"),     # ragged tiles on both sides
    (256, (2, 19, 37), "float32"),     # two channel blocks, four chunks
    (128, (2, 19, 37), "bfloat16"),
    (256, (2, 19, 37), "bfloat16"),
    (256, (1, 16, 2), "bfloat16"),     # one tile row, a 2-wide image
])
def test_mid3_implicit_gemm_matches_plain(c, shape, dtype):
    """The kernel's indexing (reflected halo, tap shifts, channel chunks
    and blocks, ragged tiles, the wrapper's HWIO layout) and rounding
    points against mid3_fused_plain, three stages.  Bounds on max |d| /
    max |plain|: float32 1e-5 (sums in another order); bfloat16 1e-2 (the
    same rounding points, but a sum on either side of a bf16 rounding
    boundary moves the next stages by whole bf16 steps; chip_smoke.py
    holds the kernel to 3e-2)."""
    rng = np.random.default_rng(72)
    ws, bs = _params(rng, c)
    x = torch.from_numpy(rng.standard_normal((*shape, c)).astype(
        np.float32)).to(getattr(torch, dtype))
    args = [t for wb in zip(ws, bs) for t in (_oihw(wb[0]),
                                              torch.from_numpy(wb[1]))]
    ref = mid3_fused_plain(x, *args).float()
    hwio, bias = kernel_params(args[::2], args[1::2], x.dtype)
    assert hwio[0].shape == (3, 3, c, c) and hwio[0].is_contiguous()
    assert all(b.dtype == torch.float32 for b in bias)
    got = x
    for w, b in zip(hwio, bias):
        got = _implicit_gemm_stage(got, w, b)
    rel = ((got.float() - ref).abs().max() / ref.abs().max()).item()
    assert rel <= (1e-5 if dtype == "float32" else 1e-2), rel


def _direct_conv_stage(x, w, bias, rows=8, cols=32, co_block=64, step=8):
    """One stage as decoder_mid_f32.cuh computes it: per 8 x 32 output tile
    and block of 64 output channels, the 10 x 34 window gathered by
    reflected (then clamped) indices; input channels in steps of 8, each
    step's 9 taps applied to the window's rows and 8-pixel runs shifted by
    the tap, summed in float32; bias, ReLU; only in-image pixels
    stored."""
    bsz, h, wd, c = x.shape
    y = torch.empty_like(x)
    for oy0 in range(0, h, rows):
        rr = [_reflect(oy0 - 1 + p, h) for p in range(rows + 2)]
        for ox0 in range(0, wd, cols):
            cc = [_reflect(ox0 - 1 + p, wd) for p in range(cols + 2)]
            win = x[:, rr][:, :, cc]
            vh, vw = min(rows, h - oy0), min(cols, wd - ox0)
            for co0 in range(0, c, co_block):
                cs = slice(co0, co0 + co_block)
                acc = torch.zeros(bsz, rows, cols, co_block)
                for ci0 in range(0, c, step):
                    ks = slice(ci0, ci0 + step)
                    for tap in range(9):
                        dy, dx = tap // 3, tap % 3
                        acc += (win[:, dy:dy + rows, dx:dx + cols, ks]
                                @ w[dy, dx, ks, cs])
                out = torch.relu(acc + bias[cs])
                y[:, oy0:oy0 + vh, ox0:ox0 + vw, cs] = out[:, :vh, :vw]
    return y


@pytest.mark.parametrize("c,shape", [
    (128, (2, 19, 37)),     # ragged tiles on both sides, two channel blocks
    (256, (2, 19, 37)),     # four channel blocks, 32 steps
    (256, (1, 16, 2)),      # two tile rows, a 2-wide image
])
def test_mid3_direct_conv_matches_plain(c, shape):
    """The float32 kernel's indexing (reflected halo, 8-pixel runs and
    their overlap, channel steps and blocks, ragged tiles, the wrapper's
    HWIO layout) against mid3_fused_plain, three stages: max |d| / max
    |plain| within 1e-5 (sums in another order)."""
    rng = np.random.default_rng(73)
    ws, bs = _params(rng, c)
    x = torch.from_numpy(rng.standard_normal((*shape, c)).astype(np.float32))
    args = [t for wb in zip(ws, bs) for t in (_oihw(wb[0]),
                                              torch.from_numpy(wb[1]))]
    ref = mid3_fused_plain(x, *args)
    hwio, bias = kernel_params(args[::2], args[1::2], x.dtype)
    got = x
    for w, b in zip(hwio, bias):
        got = _direct_conv_stage(got, w, b)
    rel = ((got - ref).abs().max() / ref.abs().max()).item()
    assert rel <= 1e-5, rel
