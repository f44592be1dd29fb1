"""K5 and K8's forward at bfloat16 on the wgmma + TMA kernels
(csrc/decoder_tail_wgmma.cuh), CPU.

A torch model of the two kernels' walk replays what they compute, tile by
tile of their persistent grids:

- stage 1 (up3) over 4 x 16 tiles of y1 pixels, each from its 6 x 18 x
  window at reflect-mapped coordinates (clamped past a ragged edge), the
  products in units of one tap's 64 input channels (half 0's nine taps,
  then half 1's) summed in float32, y1 = relu(round(round(acc) + b_up))
  stored where the pixel lies in the image, each pixel once;
- stage 2 over 16 x 16 rgb tiles: the 12 x 12 y1 window, the row blend
  (20 up rows x 12 window columns, 0.75 near rounded first) and the 20 x 20
  up window blended from it (0.75 near rounded apart only for output
  columns 4j and 4j + 3), at their global coordinates; c5 over the 18 x 18
  window as six m64 tiles, the padding rows of the last reading a clamped
  position and never stored; c5 = relu(round(round(acc) + b5)); c6's
  partial sums Z = c5 W6', W6' the 64 x 64 box of w6 as [ci][tap x 3 + co]
  with columns 27-63 zero (Z's there exactly 0, never read); the Z rows of
  out-of-image ring positions copied from their mirrors; rgb =
  relu(round(round(the 9 taps' sum of Z) + b6)); K8's c5 the tile's own
  pixels.  Every y1, c5 and rgb pixel is stored once.

The model is held against ``tail3_fused(..., with_residuals=True)``
(decoder_tail_pallas.py:519, :546) in interpret mode, its y1 and c5
unpacked with ``col_to_space``, and against the port's
``decoder_tail_res_plain``, at (1, 8, 12), (2, 6, 10) and (1, 9, 14) (no
tile divides H or W; tail3_fused takes an even W) and, against the plain
version, (1, 9, 13), (1, 2, 3) and (1, 17, 33).  Bound, as
test_torch_decoder_tail_bf16.py's: half a bf16 step of each tensor's
largest value, and at most DIFFER_SHARE of its elements differing at all
(the sides sum in other float32 orders, which moves a rounding by one step
now and then).

Also: the w6 box's swizzled writes and a weight box's reads through the
wgmma descriptor; the header's constants against the wrapper's; shared
memory within 227 KB; the persistent grids take every tile once, and each
block's first warpgroup (whose thread 0 issues the TMA loads it waits
for) at least one; the wrapper hands the kernels a y1 scratch at bf16 too
and refuses what they do not take.

Every comparison with the Pallas kernel runs under
tests/interpret_diagnostics.py's harness.
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
from mhada_tpu.ops.colpacked import col_to_space
from mhada_tpu.ops.decoder_tail_pallas import tail3_fused
from mhada_tpu_torch import _build
from mhada_tpu_torch.ops import decoder_tail as dtl
from mhada_tpu_torch.probes import tail_wgmma_ablate
from test_torch_decoder_tail_bf16 import DIFFER_SHARE, _step

# Six test workers share the CPU: cap torch's intra-op threads.
torch.set_num_threads(2)

BF = torch.bfloat16
C = dtl.C_MID
UR, UC = dtl.UP3_TILE
TR, TC = dtl.RGB_TILE
YR, YC = TR // 2 + 4, TC // 2 + 4     # y1 window
UPR, UPC = TR + 4, TC + 4             # up window
CR, CC = TR + 2, TC + 2               # c5 window
NZ = 27            # c6's taps x outputs: Z's columns
LINE = 128         # bytes of a weight box's row: 64 bf16
HEADER = Path(__file__).resolve().parents[1] / "mhada_tpu_torch" / "csrc" \
    / "decoder_tail_wgmma.cuh"
PALLAS_SHAPES = [(1, 8, 12), (2, 6, 10), (1, 9, 14)]
PLAIN_SHAPES = PALLAS_SHAPES + [(1, 9, 13), (1, 2, 3), (1, 17, 33)]
# rgb against the plain version: c6 sums 576 products of either sign, and
# another float32 order moves their rounding more often than c5's.  The
# plain version and the Pallas kernel themselves differ at 3 of 1440 rgb
# values at (2, 6, 10) and 3 of 1512 at (1, 9, 14) on these inputs, where
# the model equals the Pallas kernel.
PLAIN_RGB_SHARE = 5e-3


def reflect(i, n):
    """csrc/common.cuh reflect_index: mirror, then clamp into [0, n)."""
    i = torch.as_tensor(i)
    i = torch.where(i < 0, -i, i)
    i = torch.where(i >= n, 2 * n - 2 - i, i)
    return i.clamp(0, n - 1)


def rnd(t):
    return t.to(BF).float()


def bias_relu(acc, b):
    """relu(round(round(acc) + b)) in bf16, b holding bf16 values."""
    return torch.relu(rnd(rnd(acc) + b)).to(BF)


def up3_model(x, wu, bu):
    """Stage 1: y1 (B, hl, wl, 64) bf16 (NaN where never stored) and the
    number of stores of each pixel.  wu HWIO bf16, bu float32."""
    b, hl, wl, _ = x.shape
    y1 = torch.full((b, hl, wl, C), float("nan"), dtype=BF)
    stores = torch.zeros(b, hl, wl, dtype=torch.int32)
    tiles_x, tiles_y = -(-wl // UC), -(-hl // UR)
    for t in range(b * tiles_y * tiles_x):
        bi, rem = divmod(t, tiles_y * tiles_x)
        ty0, tx0 = rem // tiles_x * UR, rem % tiles_x * UC
        gy = reflect(ty0 - 1 + torch.arange(UR + 2), hl)
        gx = reflect(tx0 - 1 + torch.arange(UC + 2), wl)
        win = x[bi][gy][:, gx].float()
        acc = torch.zeros(UR * UC, C)
        for u in range(18):   # unit u: half u // 9, tap u % 9
            half, (ky, kx) = u // 9, divmod(u % 9, 3)
            ch = slice(64 * half, 64 * half + 64)
            acc += win[ky:ky + UR, kx:kx + UC, ch].reshape(-1, 64) \
                @ wu[ky, kx, ch].float()
        y = bias_relu(acc, bu).reshape(UR, UC, C)
        nr, nc = min(UR, hl - ty0), min(UC, wl - tx0)
        y1[bi, ty0:ty0 + nr, tx0:tx0 + nc] = y[:nr, :nc]
        stores[bi, ty0:ty0 + nr, tx0:tx0 + nc] += 1
    return y1, stores


def w6_box(w6):
    """c6's weight box W6' (64 x 64 float32): [ci][tap x 3 + co] from HWIO
    w6 (3, 3, 64, 3), zero past column 26."""
    box = torch.zeros(C, 64)
    box[:, :NZ] = w6.float().permute(2, 0, 1, 3).reshape(C, NZ)
    return box


def c5c6_model(y1, w5, b5, w6, b6):
    """Stage 2: (rgb, c5, stores of each rgb pixel, of each c5 pixel)."""
    b, hl, wl, _ = y1.shape
    hh, wh = 2 * hl, 2 * wl
    rgb = torch.full((b, hh, wh, 3), float("nan"), dtype=BF)
    c5 = torch.full((b, hh, wh, C), float("nan"), dtype=BF)
    n_rgb = torch.zeros(b, hh, wh, dtype=torch.int32)
    n_c5 = torch.zeros(b, hh, wh, dtype=torch.int32)
    box = w6_box(w6)
    tiles_x, tiles_y = -(-wh // TC), -(-hh // TR)
    # c5's M rows: m64 tiles, padding rows clamped to the last position
    p = torch.arange(-(-CR * CC // 64) * 64).clamp(max=CR * CC - 1)
    pr, pc = p // CC, p % CC
    for t in range(b * tiles_y * tiles_x):
        bi, rem = divmod(t, tiles_y * tiles_x)
        oy0, ox0 = rem // tiles_x * TR, rem % tiles_x * TC
        ly0, lx0 = oy0 // 2, ox0 // 2
        yw = y1[bi][reflect(ly0 - 2 + torch.arange(YR), hl)][
            :, reflect(lx0 - 2 + torch.arange(YC), wl)].float()
        # rows first, at the reflected high-res coordinate
        yr = reflect(oy0 - 2 + torch.arange(UPR), hh)
        iy = yr // 2
        fy = torch.where(yr % 2 == 1, (iy + 1).clamp(max=hl - 1),
                         (iy - 1).clamp(min=0))
        wy = (iy - (ly0 - 2)).clamp(0, YR - 1), \
            (fy - (ly0 - 2)).clamp(0, YR - 1)
        rows = rnd(rnd(0.75 * yw[wy[0]]) + 0.25 * yw[wy[1]])   # (UPR, YC, C)
        xr = reflect(ox0 - 2 + torch.arange(UPC), wh)
        ix = xr // 2
        fx = torch.where(xr % 2 == 1, (ix + 1).clamp(max=wl - 1),
                         (ix - 1).clamp(min=0))
        near = rows[:, (ix - (lx0 - 2)).clamp(0, YC - 1)]
        far = rows[:, (fx - (lx0 - 2)).clamp(0, YC - 1)]
        apart = ((fx != ix) & (ix % 2 == xr % 2))[None, :, None]
        up = rnd(torch.where(apart, rnd(0.75 * near), 0.75 * near)
                 + 0.25 * far)                                # (UPR, UPC, C)
        acc = torch.zeros(len(p), C)
        for tap in range(9):
            ky, kx = divmod(tap, 3)
            acc += up[pr + ky, pc + kx] @ w5[ky, kx].float()
        c5t = bias_relu(acc, b5)
        z = c5t.float() @ box
        assert bool((z[:, NZ:] == 0).all())   # the padded columns
        zg = z[:CR * CC, :NZ].reshape(CR, CC, NZ)   # padding rows dropped
        nr, nc = min(TR, hh - oy0), min(TC, wh - ox0)
        c5[bi, oy0:oy0 + nr, ox0:ox0 + nc] = \
            c5t[:CR * CC].reshape(CR, CC, C)[1:1 + nr, 1:1 + nc]
        n_c5[bi, oy0:oy0 + nr, ox0:ox0 + nc] += 1
        # the ring's Z rows from their in-image mirrors
        gy = oy0 - 1 + torch.arange(CR)
        gx = ox0 - 1 + torch.arange(CC)
        inside = ((gy >= 0) & (gy < hh))[:, None] & ((gx >= 0) & (gx < wh))
        sy = (reflect(gy, hh) - (oy0 - 1)).clamp(0, CR - 1)
        sx = (reflect(gx, wh) - (ox0 - 1)).clamp(0, CC - 1)
        zg = torch.where(inside[..., None], zg, zg[sy][:, sx])
        s = sum(zg[ky:ky + TR, kx:kx + TC, 3 * (3 * ky + kx):3 * (3 * ky + kx)
                   + 3] for ky in range(3) for kx in range(3))
        o = bias_relu(s, b6)
        rgb[bi, oy0:oy0 + nr, ox0:ox0 + nc] = o[:nr, :nc]
        n_rgb[bi, oy0:oy0 + nr, ox0:ox0 + nc] += 1
    return rgb, c5, n_rgb, n_c5


@functools.cache
def _inputs(shape):
    """Seeded bf16 x >= 0 and HWIO weights at the conv init scale, biases
    float32 holding bf16 values (test_torch_decoder_tail_bf16.py's)."""
    rng = np.random.default_rng((28, *shape))

    def conv(ci, co):
        bound = 1 / np.sqrt(ci * 9)
        return (rng.uniform(-bound, bound, (3, 3, ci, co)),
                rng.uniform(-bound, bound, (co,)))

    x = np.abs(rng.standard_normal((*shape, dtl.C_IN)))
    params = [t for ci, co in ((128, 64), (64, 64), (64, 3))
              for t in conv(ci, co)]
    return tuple(torch.from_numpy(a.astype(np.float32)).to(BF)
                 for a in (x, *params))


@functools.cache
def _model(shape):
    """The walk on _inputs(shape) -> (rgb, y1, c5, y1's, rgb's and c5's
    store counts)."""
    x, wu, bu, w5, b5, w6, b6 = _inputs(shape)
    with nearest_on_this_thread():
        y1, n_y1 = up3_model(x, wu, bu.float())
        rgb, c5, n_rgb, n_c5 = c5c6_model(y1, w5, b5.float(), w6, b6.float())
    return rgb, y1, c5, n_y1, n_rgb, n_c5


@functools.cache
def _tpu(shape):
    """tail3_fused(with_residuals=True) in interpret mode on the same bf16
    inputs -> ((rgb, y1, c5) float32, the worker's state)."""
    stale = interpreter_busy()
    fresh_interpreter()
    try:
        with pltpu.force_tpu_interpret_mode():
            rgb, y1p, c5o = tail3_fused(
                *(jnp.asarray(t.float().numpy(), jnp.bfloat16)
                  for t in _inputs(shape)), with_residuals=True)
        out = [torch.from_numpy(np.array(t.astype(jnp.float32)))
               for t in (rgb, col_to_space(y1p), col_to_space(c5o))]
    except Exception as e:
        raise AssertionError(f"tail3_fused raised in interpret mode: {e!r}; "
                             f"{worker_state(stale)}") from e
    return out, worker_state(stale)


def _oihw(t):
    return t.permute(3, 2, 0, 1).contiguous() if t.dim() == 4 else t


def _torch_args(shape):
    """_inputs(shape) as the wrappers take them: x NHWC, weights OIHW."""
    x, *params = _inputs(shape)
    return [x, *map(_oihw, params)]


def _within(got, ref, name, state, share=DIFFER_SHARE):
    """got within half a bf16 step of ref's largest value, at most
    ``share`` of its elements differing."""
    d = (got.float() - ref.float()).abs()
    why = (f"{name}: max {d.max().item():.3e}, differing "
           f"{(d > 0).float().mean().item():.2e}; {state}")
    assert got.shape == ref.shape, why
    assert bool(torch.isfinite(got.float()).all()), why
    assert d.max().item() <= _step(ref.float().abs().max().item()) / 2, why
    assert (d > 0).float().mean().item() <= share, why


@pytest.mark.parametrize("shape", PALLAS_SHAPES)
def test_walk_matches_pallas(shape):
    """The model against tail3_fused in interpret mode: rgb, y1 and c5;
    every pixel of each stored once."""
    rgb, y1, c5, *stores = _model(shape)
    for n in stores:
        assert bool((n == 1).all())
    refs, state = _tpu(shape)
    for name, got, ref in zip(("rgb", "y1", "c5"), (rgb, y1, c5), refs):
        _within(got, ref, name, state)


@pytest.mark.parametrize("shape", PLAIN_SHAPES)
def test_walk_matches_plain(shape):
    """The model against decoder_tail_res_plain, which the wrappers run on
    CPU tensors (decoder_tail's rgb is its first output); rgb within
    PLAIN_RGB_SHARE."""
    rgb, y1, c5, *stores = _model(shape)
    for n in stores:
        assert bool((n == 1).all())
    args = _torch_args(shape)
    with nearest_on_this_thread():
        refs = dtl.decoder_tail_res_plain(*args)
        assert torch.equal(dtl.decoder_tail(*args), refs[0])
    for name, got, ref in zip(("rgb", "y1", "c5"), (rgb, y1, c5), refs):
        _within(got, ref, name, worker_state(None),
                PLAIN_RGB_SHARE if name == "rgb" else DIFFER_SHARE)


def sw128(addr):
    """The 128-byte swizzle of TMA and of a wgmma descriptor: byte address
    bits 4-6 XOR bits 7-9, in a tile aligned to 1024 bytes."""
    return addr ^ (((addr >> 7) & 7) << 4)


def descriptor_read(smem, box, kk):
    """The 16 x 64 B operand that wgmma reads at k-step kk of the box at
    byte ``box`` (1024-aligned) through sw128_desc(box + 2048 kk, lbo,
    1024) with the transpose bit (MN-major): k row r of a group of 8 at 128
    bytes, groups 1024 apart, n column j at 2 j, swizzled."""
    out = torch.empty(16, 64, dtype=smem.dtype)
    for r in range(16):
        for j in range(64):
            addr = box + 2048 * kk + (r % 8) * LINE + (r // 8) * 1024 + 2 * j
            out[r, j] = smem[sw128(addr) // 2]
    return out


def test_weight_boxes_through_the_descriptor():
    """A w5 or w_up box as TMA lands it (element (ci, co) at sw128(128 ci +
    2 co)) and c6's box as stage 2 writes it (chunk j // 8 of row ci at (j
    // 8) ^ (ci % 8)) read back through the descriptors as the weights'
    k-steps; the kernel's write address is the TMA pattern and a
    bijection on the 8 KB box."""
    g = torch.Generator().manual_seed(5)
    w = torch.randn(C, 64, generator=g)
    tma = torch.full((4096,), float("nan"))
    for ci in range(C):
        for co in range(64):
            tma[sw128(ci * LINE + 2 * co) // 2] = w[ci, co]
    for kk in range(4):
        assert torch.equal(descriptor_read(tma, 0, kk), w[16 * kk:16 * kk + 16])
    w6 = torch.randn(3, 3, C, 3, generator=g)
    box = w6_box(w6)
    written = torch.full((4096,), float("nan"))
    addrs = set()
    for ci in range(C):
        for j in range(64):
            addr = ci * LINE + (((j // 8) ^ (ci % 8)) << 4) + 2 * (j % 8)
            assert addr == sw128(ci * LINE + 2 * j)
            addrs.add(addr)
            written[addr // 2] = box[ci, j]
    assert addrs == set(range(0, C * LINE, 2))
    for kk in range(4):
        assert torch.equal(descriptor_read(written, 0, kk),
                           box[16 * kk:16 * kk + 16])


def _header_constants() -> dict:
    """The header's ``constexpr`` integers, evaluated in order."""
    code = "\n".join(ln.split("//")[0] for ln in HEADER.read_text()
                     .splitlines())
    env = {}
    for decl in re.findall(r"constexpr (?:int|size_t) ([^;]+);", code):
        for part in decl.split(","):
            name, expr = (" ".join(v.split()) for v in part.split("=", 1))
            if re.fullmatch(r"[\w\s+\-*/()]+", expr):
                env[name] = eval(expr.replace("/", "//"), {}, dict(env))
    return env


def test_header_constants_match():
    """The wrapper's geometry is the kernels'."""
    k = _header_constants()
    assert (k["kUR"], k["kUC"]) == dtl.UP3_TILE
    assert k["kConsumers"] == dtl.UP3_CONSUMERS
    assert (k["kTile"], k["kTile"]) == dtl.RGB_TILE
    assert k["kConsumers2"] == dtl.C5C6_CONSUMERS
    assert (k["kC"], k["kCin"], k["kZ"]) == (C, dtl.C_IN, NZ)
    assert (k["kYW"], k["kYW"], k["kUW"], k["kUW"], k["kCW"], k["kCW"]) \
        == (YR, YC, UPR, UPC, CR, CC)


def test_shared_memory_fits():
    """Both kernels' dynamic shared memory, the 1 KB alignment slack
    included, within the 227 KB a block may take; the row blend fits Z's
    room, which it shares."""
    k = _header_constants()
    assert k["kMaxSmem"] == 227 * 1024
    for name in ("kSmem1", "kSmem2"):
        assert 100 * 1024 < k[name] <= 227 * 1024, (name, k[name])
    assert UPR * YC * k["kPosBytes"] <= k["kZBytes"] >= CR * CC * NZ * 4
    assert k["kW6Off"] % 1024 == 0 and k["kY1Off"] % 16 == 0


def wgmma_grids(batch, hl, wl, sms):
    """launch_decoder_tail_wgmma's persistent grids on a card of ``sms``
    SMs: as many blocks as the tiles need (stage 1: a tile a warpgroup;
    stage 2: a tile a block), at most one an SM."""
    tiles1 = batch * -(-hl // UR) * -(-wl // UC)
    tiles2 = batch * -(-2 * hl // TR) * -(-2 * wl // TC)
    return min(sms, -(-tiles1 // dtl.UP3_CONSUMERS)), min(sms, tiles2)


def _stage_tiles(grid, consumers, tiles):
    """The tiles each (block, walker) takes: walker g of block x from x
    consumers + g, a grid's worth of walkers apart."""
    return {(x, g): list(range(x * consumers + g, tiles, grid * consumers))
            for x in range(grid) for g in range(consumers)}


@pytest.mark.parametrize("b,hl,wl", [(1, 256, 256), (8, 128, 128),
                                     (1, 180, 320), (8, 128, 256),
                                     (1, 2, 3), (2, 9, 13)])
@pytest.mark.parametrize("sms", [132, 16, 3])
def test_grids_take_every_tile_once(b, hl, wl, sms):
    """Every tile of both stages walked once; every block's warpgroup 0,
    whose thread 0 issues the weights' TMA loads, walks at least one (its
    first tile waits for them); and the tiles cover every y1 and rgb pixel
    once."""
    grid1, grid2 = wgmma_grids(b, hl, wl, sms)
    tiles1 = b * -(-hl // UR) * -(-wl // UC)
    tiles2 = b * -(-2 * hl // TR) * -(-2 * wl // TC)
    # stage 2's warpgroups share their block's tile
    for grid, consumers, tiles in ((grid1, dtl.UP3_CONSUMERS, tiles1),
                                   (grid2, 1, tiles2)):
        walks = _stage_tiles(grid, consumers, tiles)
        assert sorted(t for w in walks.values() for t in w) == \
            list(range(tiles))
        assert all(walks[(x, 0)] for x in range(grid))
        assert grid <= sms
    for (rows, cols), (h, w) in (((UR, UC), (hl, wl)),
                                 ((TR, TC), (2 * hl, 2 * wl))):
        cover = torch.zeros(h, w, dtype=torch.int32)
        for ty in range(-(-h // rows)):
            for tx in range(-(-w // cols)):
                cover[ty * rows:(ty + 1) * rows, tx * cols:(tx + 1) * cols] \
                    += 1
        assert bool((cover == 1).all())


@pytest.mark.parametrize("entry", ["mhada_decoder_tail",
                                   "mhada_decoder_tail_res"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrapper_hands_over_y1(monkeypatch, entry, dtype):
    """The launch hands the C entry a (B, H, W, 64) y1 in x's dtype at both
    dtypes (K5's scratch, K8's residual): the bf16 kernels need it too."""
    seen = []
    monkeypatch.setattr(_build, "check_cuda_inputs", lambda *a: None)
    monkeypatch.setattr(_build, "check_aligned", lambda *a, **k: None)
    monkeypatch.setattr(_build, "launch", lambda *a: seen.append(a))
    x, wu, bu, w5, b5, w6, b6 = (t.to(dtype) for t in _inputs((1, 8, 12)))
    outs = dtl._launch_tail(entry, x, *map(_oihw, (wu, bu, w5, b5, w6, b6)))
    (name, _, *args), = seen
    assert name == entry
    y1 = args[8]
    assert isinstance(y1, torch.Tensor) and y1.shape == (1, 8, 12, C)
    assert y1.dtype == dtype
    assert args[-4:] == [1, 8, 12, _build.DTYPE_CODES[dtype]]
    assert len(outs) == (3 if entry.endswith("_res") else 1)


@pytest.mark.parametrize("bad", ["channels", "height", "w5"])
def test_wrapper_refusals(bad):
    """The launch refuses shapes the kernels do not take before anything
    launches; CPU tensors take the plain version and refuse the kernel
    backend."""
    before = dict(_build.LAUNCHES)
    x, wu, bu, w5, b5, w6, b6 = _torch_args((1, 8, 12))
    if bad == "channels":
        x = x[..., :64]
    elif bad == "height":
        x = x[:, :1]
    else:
        w5 = w5[:, :32]
    with pytest.raises(ValueError, match="bad shapes"):
        dtl._launch_tail("mhada_decoder_tail", x, wu, bu, w5, b5, w6, b6)
    x, *ws = _torch_args((1, 8, 12))
    with pytest.raises(RuntimeError, match="needs a CUDA tensor"):
        dtl.decoder_tail(x, *ws, backend="kernel")
    assert _build.LAUNCHES == before


@pytest.mark.parametrize("variant", list(tail_wgmma_ablate.VARIANTS))
def test_ablate_edits_apply(variant):
    """Each variant of probes/tail_wgmma_ablate.py still finds its text
    once in the header (the probe raises otherwise) and changes it."""
    src = HEADER.read_text()
    edits = tail_wgmma_ablate.VARIANTS[variant]
    out = tail_wgmma_ablate.patched(src, edits)
    assert (out != src) == bool(edits)
    with pytest.raises(ValueError, match="not found"):
        tail_wgmma_ablate.patched(src, [("no such text", "")])
