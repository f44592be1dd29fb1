"""A CPU model of the float32 decoder tail (csrc/decoder_tail_f32.cuh), K5
and K8's two-stage schedule, against the Pallas kernel in interpret mode
(``tail3_fused``, decoder_tail_pallas.py:546, and with its residuals,
:519), against the port's plain version and against a float64 chain.

The model replays the kernels' data flow in torch: stage 1 (up3) over 8 x
32 low-res tiles, each from its reflect-mapped 10 x 34 window of x, input
channels in steps of 8; stage 2 over 22 x 30 rgb tiles, each evaluating c5
on the 24 x 32 region around its tile (c6's 1-pixel ring) from a 26 x 34
up window that is blended from the reflect-mapped 15 x 19 y1 window with
the kernel's line tables (the reflected high-res line, its two low-res
source lines and weight, window indices clamped); c5 in two passes of 32
output channels, each stored (K8: the tile's own pixels only), its ring
positions on global row or column -1 or the far edge replaced by their
mirrors, and c6's part of each pass summed by channel parity, the two
parities met and added to the earlier passes' sum.  The y1 window lines
outside the image and the c5 positions beyond the ring are NaN in the
model: the kernel loads or leaves finite values there that no in-image
output may read, and a NaN reaching an output would show it.  Shapes from
2 x 4 low-res pixels (the smallest frame) to 27 x 36 (3 x 3 tiles of
stage 2 and 4 x 2 of stage 1, the last ones ragged in both directions),
odd sizes too."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch
import torch.nn.functional as F
from jax.experimental.pallas import tpu as pltpu

from mhada_tpu.ops.colpacked import col_to_space
from mhada_tpu.ops.decoder_tail_pallas import tail3_fused
from mhada_tpu_torch.ops.decoder_tail import decoder_tail_res_plain

# Six test workers share the CPU: cap torch's intra-op threads.
torch.set_num_threads(2)

CIN, CMID, COUT, CK = 128, 64, 3, 8
# stage 1: y1 tile (rows, cols); stage 2: c5 region, rgb tile, pass width
AR, AC = 8, 32
BR, BC = 24, 32
OR, OC = BR - 2, BC - 2
CC = 32
YR, YC = BR // 2 + 3, BC // 2 + 3
# tests/test_torch_decoder.py's bound (tests/test_decoder_tail.py's)
ATOL, RTOL = 2e-4, 1e-4
# tail3_fused takes H >= 4 (it pads x by 3 rows) and an even W; the port
# takes every H, W >= 2, so the plain comparisons add the smallest frame
# and odd sizes.
SHAPES = [(1, 4, 4), (1, 8, 12), (2, 6, 10), (1, 27, 36)]
PLAIN_SHAPES = SHAPES + [(1, 2, 4), (1, 3, 5), (1, 17, 33)]


def reflect(i, n):
    """csrc/common.cuh reflect_index: mirror, then clamp into [0, n)."""
    i = torch.as_tensor(i)
    i = torch.where(i < 0, -i, i)
    i = torch.where(i >= n, 2 * n - 2 - i, i)
    return i.clamp(0, n - 1)


def conv_valid(win, w):
    """Unpadded 3x3 conv of an NHWC window with HWIO weights -> NHWC."""
    out = F.conv2d(win.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1))
    return out.permute(0, 2, 3, 1)


def up3_model(x, wu, bu):
    """Stage 1: y1 (B, hl, wl, 64), tile by tile."""
    bsz, hl, wl, _ = x.shape
    y1 = torch.full((bsz, hl, wl, CMID), torch.nan)
    for ty0 in range(0, hl, AR):
        for tx0 in range(0, wl, AC):
            rows = reflect(ty0 - 1 + torch.arange(AR + 2), hl)
            cols = reflect(tx0 - 1 + torch.arange(AC + 2), wl)
            win = x[:, rows][:, :, cols]
            acc = torch.zeros(bsz, AR, AC, CMID)
            for c in range(0, CIN, CK):
                acc = acc + conv_valid(win[..., c:c + CK], wu[:, :, c:c + CK])
            r, q = min(AR, hl - ty0), min(AC, wl - tx0)
            y1[:, ty0:ty0 + r, tx0:tx0 + q] = torch.relu(acc + bu)[:, :r, :q]
    return y1


def line_table(o0, count, n, nl):
    """The kernel's table of ``count`` up window lines from high-res line
    o0 - 2 on (an axis of n high-res, nl low-res lines): each line's two
    y1 lines and the first one's weight."""
    hr = reflect(o0 - 2 + torch.arange(count), n)
    il = hr // 2
    odd = hr % 2 == 1
    la = torch.where(odd, il, (il - 1).clamp(min=0))
    lb = torch.where(odd, (il + 1).clamp(max=nl - 1), il)
    return la, lb, torch.where(odd, 0.75, 0.25)


def c5c6_model(y1, w5, b5, w6, b6, res):
    """Stage 2: rgb (B, 2hl, 2wl, 3) and, with ``res``, c5, tile by tile."""
    bsz, hl, wl, _ = y1.shape
    hh, wh = 2 * hl, 2 * wl
    rgb = torch.full((bsz, hh, wh, COUT), torch.nan)
    c5 = torch.full((bsz, hh, wh, CMID), torch.nan) if res else None
    for oy0 in range(0, hh, OR):
        for ox0 in range(0, wh, OC):
            ly0, lx0 = oy0 // 2, ox0 // 2
            # the y1 window, NaN on lines outside the image
            wr, wc = ly0 - 2 + torch.arange(YR), lx0 - 2 + torch.arange(YC)
            ywin = y1[:, reflect(wr, hl)][:, :, reflect(wc, wl)].clone()
            ywin[:, (wr < 0) | (wr >= hl)] = torch.nan
            ywin[:, :, (wc < 0) | (wc >= wl)] = torch.nan
            # the up window: each line's two sources, window-clamped
            ra, rb, wya = line_table(oy0, BR + 2, hh, hl)
            ca, cb, wxa = line_table(ox0, BC + 2, wh, wl)
            ra, rb = ((t - (ly0 - 2)).clamp(0, YR - 1) for t in (ra, rb))
            ca, cb = ((t - (lx0 - 2)).clamp(0, YC - 1) for t in (ca, cb))
            wya, wxa = wya.view(1, -1, 1, 1), wxa.view(1, 1, -1, 1)

            def cols(t):
                return wxa * t[:, :, ca] + (1 - wxa) * t[:, :, cb]

            up = wya * cols(ywin[:, ra]) + (1 - wya) * cols(ywin[:, rb])
            gy = oy0 - 1 + torch.arange(BR)
            gx = ox0 - 1 + torch.arange(BC)
            rgb_sum = torch.zeros(bsz, OR, OC, COUT)
            for p in range(CMID // CC):
                acc = torch.zeros(bsz, BR, BC, CC)
                w5p = w5[..., p * CC:(p + 1) * CC]
                for c in range(0, CMID, CK):
                    acc = acc + conv_valid(up[..., c:c + CK],
                                           w5p[:, :, c:c + CK])
                c5p = torch.relu(acc + b5[p * CC:(p + 1) * CC])
                if res:   # the tile's own pixels
                    r, q = min(OR, hh - oy0), min(OC, wh - ox0)
                    c5[:, oy0:oy0 + r, ox0:ox0 + q, p * CC:(p + 1) * CC] = \
                        c5p[:, 1:1 + r, 1:1 + q]
                # beyond the ring: never read; the ring: mirrored
                c5p[:, gy > hh] = torch.nan
                c5p[:, :, gx > wh] = torch.nan
                sr = (reflect(gy, hh) - (oy0 - 1)).clamp(0, BR - 1)
                sc = (reflect(gx, wh) - (ox0 - 1)).clamp(0, BC - 1)
                ring_r = (gy == -1) | (gy == hh)
                ring_c = (gx == -1) | (gx == wh)
                mirror = c5p[:, sr][:, :, sc]
                ring = (ring_r[:, None] | ring_c[None, :]) & \
                    (gy <= hh)[:, None] & (gx <= wh)[None, :]
                c5p = torch.where(ring[None, :, :, None], mirror, c5p)
                # the pass's channels of each parity, met, then added to
                # the earlier passes' sum
                rgb_sum = rgb_sum + sum(
                    conv_valid(c5p[..., h::2],
                               w6[:, :, p * CC + h:(p + 1) * CC:2])
                    for h in range(2))
            out = torch.relu(rgb_sum + b6)
            r, q = min(OR, hh - oy0), min(OC, wh - ox0)
            rgb[:, oy0:oy0 + r, ox0:ox0 + q] = out[:, :r, :q]
    return rgb, c5


def tail_model(x, wu, bu, w5, b5, w6, b6, res=True):
    """Both stages -> (rgb, y1, c5 or None)."""
    y1 = up3_model(x, wu, bu)
    rgb, c5 = c5c6_model(y1, w5, b5, w6, b6, res)
    return rgb, y1, c5


def chain64(x, wu, bu, w5, b5, w6, b6):
    """The tail in float64: reflect-padded convs, ReLU after each, torch's
    2x bilinear upsample after up3 -> (rgb, y1, c5)."""
    def conv_relu(t, w, bias):
        tp = F.pad(t.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
        return torch.relu(F.conv2d(tp, w.permute(3, 2, 0, 1), bias)) \
            .permute(0, 2, 3, 1)

    a = [t.double() for t in (x, wu, bu, w5, b5, w6, b6)]
    y1 = conv_relu(a[0], a[1], a[2])
    up = F.interpolate(y1.permute(0, 3, 1, 2), scale_factor=2,
                       mode="bilinear", align_corners=False)
    c5 = conv_relu(up.permute(0, 2, 3, 1), a[3], a[4])
    return conv_relu(c5, a[5], a[6]), y1, c5


def _inputs(shape):
    """Seeded x (B, H, W, 128) >= 0 and HWIO weights at the conv init scale,
    biases shifted positive (few pre-activations at 0)."""
    rng = np.random.default_rng((151, *shape))

    def conv(ci, co):
        bound = 1 / (9 * ci) ** 0.5
        w = rng.uniform(-bound, bound, (3, 3, ci, co))
        return w.astype(np.float32), \
            rng.uniform(0, 2 * bound, co).astype(np.float32)

    x = np.abs(rng.standard_normal((*shape, CIN))).astype(np.float32)
    return [x, *conv(CIN, CMID), *conv(CMID, CMID), *conv(CMID, COUT)]


def _oihw(args):
    return [torch.from_numpy(np.ascontiguousarray(a.transpose(3, 2, 0, 1)))
            if a.ndim == 4 and i else torch.from_numpy(a)
            for i, a in enumerate(args)]


def _close(got, ref, name):
    got = np.asarray(got, np.float64)
    assert got.shape == ref.shape, name
    assert np.isfinite(got).all(), name
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL, err_msg=name)


@pytest.mark.parametrize("res", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_model_matches_pallas(shape, res):
    """The schedule against tail3_fused in interpret mode: rgb, and with
    residuals y1 and c5 (unpacked from the kernel's column packing)."""
    args = _inputs(shape)
    with pltpu.force_tpu_interpret_mode():
        ref = tail3_fused(*map(jnp.asarray, args), with_residuals=res)
    ref = [np.asarray(ref[0]), np.asarray(col_to_space(ref[1])),
           np.asarray(col_to_space(ref[2]))] if res else [np.asarray(ref)]
    got = tail_model(*map(torch.from_numpy, args), res=res)
    for name, g, r in zip(("rgb", "y1", "c5"), got, ref):
        _close(g.numpy(), r, name)
    if not res:
        assert got[2] is None


@pytest.mark.parametrize("shape", PLAIN_SHAPES)
def test_model_matches_plain_and_float64(shape):
    """The schedule against decoder_tail_res_plain (the wrapper's CPU
    path) and the float64 chain: rgb, y1 and c5."""
    args = _inputs(shape)
    got = tail_model(*map(torch.from_numpy, args))
    plain = decoder_tail_res_plain(*_oihw(args))
    exact = chain64(*map(torch.from_numpy, args))
    for name, g, p, e in zip(("rgb", "y1", "c5"), got, plain, exact):
        _close(g.numpy(), p.numpy().astype(np.float64), name)
        _close(g.numpy(), e.numpy(), name)


def test_schedule_recomputes_only_c5_ring():
    """The schedule's flops at the paths' shapes: stage 1 recomputes
    nothing; stage 2 evaluates c5 on the 24 x 32 region of each 22 x 30
    tile and c6 on the tile; with the ragged edge tiles, 1.13-1.18x the
    function's 2 x 9 x MACs (chip_smoke.py's bound) where PR 1's fused
    tile (up3 on 12 x 12 per 8 x 8, c5 on 18 x 18 per 16 x 16) took
    1.58x."""
    for b, hl in ((1, 256), (1, 512), (8, 128), (4, 256)):
        hh = 2 * hl
        fn = 2 * 9 * b * (hl * hl * CIN * CMID
                          + hh * hh * CMID * (CMID + COUT))
        tiles_a = -(-hl // AR) * -(-hl // AC)
        tiles_b = -(-hh // OR) * -(-hh // OC)
        sched = 2 * 9 * b * (tiles_a * AR * AC * CIN * CMID
                             + tiles_b * (BR * BC * CMID * CMID
                                          + OR * OC * CMID * COUT))
        fused = 2 * 9 * b * (hl * hl / 64 * 144 * CIN * CMID
                             + hh * hh / 256 * (324 * CMID * CMID
                                                + 256 * CMID * COUT))
        assert 1.12 <= sched / fn <= 1.18, (b, hl, sched / fn)
        assert 1.55 <= fused / fn <= 1.6, (b, hl, fused / fn)
