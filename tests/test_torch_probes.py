"""The probes' plain versions against the JAX package's TPU probe kernels
(interpret mode), CPU: P1's ``mm_plain`` against ``_mm_kernel`` through
``pl.pallas_call``, P2's plain version against ``_pipe_kernel`` through the
probe's ``call_variant``; a model of P1's wgmma + TMA schedule against
``mm_plain`` and P1's tile contract; the probes' CLIs on the CPU and their
guards;
the cuts of K2's split probe, and the edits of P2's and K13's ablation
probes, of the f32 attention geometry probe and of the f32 tail geometry
probe, against the kernels' sources.
The probe scripts are not a package, so they are imported by path."""

import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from mhada_tpu_torch.ops.instance_norm import instance_norm_stats
from mhada_tpu_torch import _build
from mhada_tpu_torch.probes import (c6_ablate, f32_tile_geometry,
                                    ln_matmul_split, mhada_pipe_probe,
                                    mhada_wgmma_ablate, mm_probe, redesign_ab,
                                    tail_f32_geometry)

# Six test workers share the CPU: cap torch's intra-op threads.
torch.set_num_threads(2)

SCRIPTS = Path(__file__).resolve().parents[1] / "scripts"


def _script(name):
    spec = importlib.util.spec_from_file_location(name, SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("m,k,n", [(64, 128, 64), (128, 64, 256)])
def test_mm_plain_matches_mm_kernel(m, k, n):
    """One grid step of mxu_probe.py's call (its block specs, whole
    operands).  Both sum bf16 products in float32 and round once to bf16:
    equal up to one bf16 step (2^-8 relative) where the order of the sums
    moves a value across a rounding boundary."""
    probe = _script("mxu_probe")
    rng = np.random.default_rng(81)
    a = (rng.standard_normal((m, k)) * 0.1).astype(np.float32)
    b = (rng.standard_normal((k, n)) * 0.1).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        call = pl.pallas_call(
            probe._mm_kernel, grid=(1,),
            in_specs=[pl.BlockSpec((m, k), lambda i: (0, 0),
                                   memory_space=pltpu.VMEM),
                      pl.BlockSpec((k, n), lambda i: (0, 0),
                                   memory_space=pltpu.VMEM)],
            out_specs=pl.BlockSpec((m, n), lambda i: (0, 0),
                                   memory_space=pltpu.VMEM),
            out_shape=jax.ShapeDtypeStruct((m, n), jnp.bfloat16))
        ref = np.asarray(call(jnp.asarray(a, jnp.bfloat16),
                              jnp.asarray(b, jnp.bfloat16)), np.float32)
    at, bt = (torch.from_numpy(t).to(torch.bfloat16) for t in (a, b))
    got = mm_probe.mm_plain(at, bt)
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    np.testing.assert_allclose(got.float().numpy(), ref, atol=1e-3,
                               rtol=2 ** -8)
    assert torch.equal(mm_probe.mm(at, bt, reps=3), got)


def _mm_schedule(a, b, block_tile):
    """P1 as csrc/mm_wgmma.cuh computes it: per BM x BN block, k in stages
    of 64, each four k16 products summed into float32 accumulators held in
    the wgmma m64nN layout (element e of n8 chunk c of a thread: row 16
    warp + lane / 4 + 8 (e / 2) of its warpgroup's 64, column 8 c + 2
    (lane % 4) + e % 2), rounded once to bf16 and stored by the epilogue's
    lane-pair exchange: 8 bytes a lane, the quad's 32 contiguous bytes.
    Returns the output and how often each element was stored."""
    (m, k), n = a.shape, b.shape[1]
    bm, bn = block_tile
    out = torch.zeros(m, n, dtype=torch.bfloat16)
    stores = torch.zeros(m, n, dtype=torch.int32)
    lane = torch.arange(32)
    g, t = lane // 4, lane % 4
    odd = (t % 2).bool()
    for m0 in range(0, m, bm):
        for n0 in range(0, n, bn):
            acc = torch.zeros(bm, bn)
            for k0 in range(0, k, mm_probe.BK):
                for kk in range(k0, k0 + mm_probe.BK, 16):
                    acc += a[m0:m0 + bm, kk:kk + 16].float() \
                        @ b[kk:kk + 16, n0:n0 + bn].float()
            acc = acc.to(torch.bfloat16)
            for group in range(bm // 64):
                for warp in range(4):
                    row0 = 64 * group + 16 * warp + g
                    for r in range(2):
                        rows = row0 + 8 * r
                        for c in range(0, bn // 8, 2):
                            # each lane's pair (two bf16) of chunks c, c + 1
                            lo = acc[rows[:, None], (8 * c + 2 * t)[:, None]
                                     + torch.arange(2)]
                            hi = acc[rows[:, None],
                                     (8 * c + 8 + 2 * t)[:, None]
                                     + torch.arange(2)]
                            got = torch.where(odd[:, None], lo, hi)[lane ^ 1]
                            col = torch.where(odd, 8 * c + 8 + 2 * (t - 1),
                                              8 * c + 2 * t)
                            val = torch.where(odd[:, None],
                                              torch.cat([got, hi], 1),
                                              torch.cat([lo, got], 1))
                            for i in range(4):
                                out[m0 + rows, n0 + col + i] = val[:, i]
                                stores[m0 + rows, n0 + col + i] += 1
    return out, stores


@pytest.mark.parametrize("shape", mm_probe.SHAPES)
def test_mm_schedule_matches_plain(shape):
    """P1's schedule at each probe shape with the tile it takes, against
    mm_plain: every element stored once, and equal up to one bf16 step
    (both round one float32 sum, taken in another order, to bf16)."""
    m, k, n = shape
    a, b = mm_probe.operands(m, k, n, "cpu", seed=83)
    got, stores = _mm_schedule(a, b, mm_probe.tile(m, k, n))
    assert (stores == 1).all()
    ref = mm_probe.mm_plain(a, b).float()
    assert ((got.float() - ref).abs() <= ref.abs() * 2 ** -7
            + 1e-3 * ref.abs().max()).all()


def test_mm_tile_contract():
    """Each probe shape takes a tile the kernel is built with (the C entry
    point dispatches exactly BLOCK_TILES) that divides it; other shapes
    take the rule's; shapes off the 64-multiples raise ValueError."""
    built = re.findall(r"MHADA_MM_TILE\((\d+), (\d+)\)\n",
                       (_build.CSRC / "mm_probe.cu").read_text())
    assert sorted((int(x), int(y)) for x, y in built) == sorted(
        mm_probe.BLOCK_TILES)
    assert set(mm_probe.TILES) == set(mm_probe.SHAPES)
    for (m, k, n), (bm, bn) in mm_probe.TILES.items():
        assert (bm, bn) in mm_probe.BLOCK_TILES
        assert m % bm == 0 and n % bn == 0 and k % mm_probe.BK == 0
    assert mm_probe.tile(192, 64, 320) == (64, 64)
    assert mm_probe.tile(256, 128, 384) == (128, 128)
    for shape in [(64, 32, 64), (96, 64, 64), (64, 64, 96), (0, 64, 64)]:
        with pytest.raises(ValueError, match="multiples"):
            mm_probe.tile(*shape)


def test_redesign_ab_needs_card(monkeypatch, capsys):
    """The A/B probe's worker imports the checkout it is given (here this
    one) and raises without a card; main needs --other."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs the card"):
        redesign_ab.worker(str(redesign_ab.ROOT))
    with pytest.raises(SystemExit):
        redesign_ab.main([])
    assert "--other" in capsys.readouterr().err


def test_pipe_plain_matches_pipe_kernel():
    """K3's plain version against mhada_pipe_probe.py::_pipe_kernel at B = 1,
    N = M = 256, C = 128, 2 heads, tn = 128, float32; k at scale 0.35 keeps
    the unscaled logits' std near 1.6 (tests/test_torch_streaming.py:56-83),
    with that test's bound."""
    probe = _script("mhada_pipe_probe")
    rng = np.random.default_rng(82)
    b, n, c, h = 1, 256, 128, 2
    fc = (rng.standard_normal((b, n, c)) * 2 + 1).astype(np.float32)
    fcs = (rng.standard_normal((b, n, c)) * 3 - 1).astype(np.float32)
    wf = rng.uniform(-1 / 8, 1 / 8, (h, 64, 64)).astype(np.float32)
    fb = rng.uniform(-1 / 8, 1 / 8, (h, 64)).astype(np.float32)
    k = (rng.standard_normal((b, n, c)) * 0.35).astype(np.float32)
    v = rng.standard_normal((b, n, c)).astype(np.float32)
    t = [torch.from_numpy(x) for x in (fc, fcs, wf, fb, k, v)]
    stats = torch.stack([*instance_norm_stats(t[0]),
                         *instance_norm_stats(t[1])], 1)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(probe.call_variant(
            probe._pipe_kernel, *map(jnp.asarray, (fc, fcs, stats.numpy(),
                                                   wf, fb, k, v)), 128))
    got = mhada_pipe_probe.mhada_fused_prologue_pipe(t[0], t[1], stats,
                                                     *t[2:]).numpy()
    assert got.shape == ref.shape == (b, n, c)
    np.testing.assert_allclose(got, ref, atol=5e-5, rtol=0)


def test_probe_clis_cpu(capsys, monkeypatch):
    """Both CLIs run the plain versions on the CPU when asked, and say so
    (P2 at 64 tokens: its B = 8, 4096-token shape needs 8 GB of scores)."""
    mm_probe.main(["--reps", "1", "--iters", "1", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert "cpu" in lines[0] and len(lines) == 1 + len(mm_probe.SHAPES)
    assert all("max|err| 0.00e+00" in ln for ln in lines[1:])
    monkeypatch.setattr(mhada_pipe_probe, "SHAPE",
                        dict(mhada_pipe_probe.SHAPE, n=64, m=64))
    mhada_pipe_probe.main(["--iters", "1", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert "cpu" in lines[0] and [ln.split(":")[0].strip()
                                  for ln in lines[1:]] == ["K3", "pipe",
                                                           "pipe", "K3"]


def test_probe_guards(monkeypatch):
    a = torch.zeros(64, 32, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="needs a CUDA tensor"):
        mm_probe.mm(a, a.T.contiguous(), backend="kernel")
    with pytest.raises(ValueError, match="bad shapes"):
        mm_probe.mm(a, a)
    x = torch.zeros(1, 8, 128)
    with pytest.raises(RuntimeError, match="needs a CUDA tensor"):
        mhada_pipe_probe.mhada_fused_prologue_pipe(
            x, x, torch.zeros(1, 4, 128), torch.zeros(2, 64, 64),
            torch.zeros(2, 64), x, x, backend="kernel")
    # the tile sweep times the kernel: not on the CPU
    with pytest.raises(RuntimeError, match="needs the card"):
        mm_probe.main(["--sweep", "--device", "cpu"])
    # without a card the CLIs raise and name the way to the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (mm_probe.main, mhada_pipe_probe.main):
        with pytest.raises(RuntimeError, match="--device cpu"):
            main([])


def test_ln_matmul_split_cuts(monkeypatch):
    """K2's split probe: every cut it makes names text that is in the bf16
    kernel's source (so each scratch build is the kernel less one part),
    and without a card it raises."""
    src = (_build.CSRC / "ln_matmul_mma.cuh").read_text()
    for cut, edits in ln_matmul_split.CUTS.items():
        for old, _ in edits:
            assert src.count(old) == 1, (cut, old)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        ln_matmul_split.main([])


@pytest.mark.parametrize("variant", list(mhada_wgmma_ablate.VARIANTS))
def test_wgmma_ablate_edits_apply(variant):
    """Each variant of P2's ablation probe still finds its text in
    csrc/mhada_wgmma.cuh (the probe raises otherwise) and changes it."""
    src = (_build.CSRC / mhada_wgmma_ablate.HEADER).read_text()
    edits = mhada_wgmma_ablate.VARIANTS[variant]
    out = mhada_wgmma_ablate.patched(src, edits)
    assert (out != src) == bool(edits)
    with pytest.raises(ValueError, match="not found"):
        mhada_wgmma_ablate.patched(src, [("no such text", "")])


@pytest.mark.parametrize("variant", list(c6_ablate.VARIANTS))
def test_c6_ablate_edits_apply(variant):
    """Each variant of K13's ablation probe still finds its text in the
    sources it edits (the probe raises otherwise) and changes each file;
    the cut variants touch both builds' copies or arithmetic."""
    edits = c6_ablate.VARIANTS[variant]
    for fname, file_edits in edits.items():
        src = (_build.CSRC / fname).read_text()
        assert c6_ablate.patched(src, file_edits, fname) != src
    if variant in ("copies only", "arithmetic only"):   # both builds cut
        assert c6_ablate.MMA in edits and ({c6_ablate.F32, c6_ablate.RING}
                                           & set(edits))
    with pytest.raises(ValueError, match="not found"):
        c6_ablate.patched("", [("no such text", "")], c6_ablate.SOURCE)


def test_c6_ablate_needs_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        c6_ablate.main(["--variants", "as built"])


@pytest.mark.parametrize("variant", list(f32_tile_geometry.VARIANTS))
def test_f32_geometry_variants_apply(variant, monkeypatch):
    """Each layout of the f32 attention geometry probe replaces the AttnGeom
    line of csrc/mhada_f32_tile.cuh (the probe raises where it is missing;
    the as-built layout is the header's own), fits a block's 227 KB of
    shared memory, and gives whole 64-key tiles; without a card the probe
    raises."""
    src = (_build.CSRC / f32_tile_geometry.HEADER).read_text()
    geom = f32_tile_geometry.VARIANTS[variant]
    out = f32_tile_geometry.patched(src, geom)
    assert f"using AttnGeom = {geom};" in out
    assert (out == src) == ("as built" in variant)
    lay = f32_tile_geometry.layout(geom)
    assert lay["smem_bytes"] <= 232448 and lay["queries"] in (128, 256)
    with pytest.raises(ValueError, match="not found"):
        f32_tile_geometry.patched("", geom)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        f32_tile_geometry.main([])


@pytest.mark.parametrize("variant", list(tail_f32_geometry.VARIANTS))
def test_tail_geometry_variants_apply(variant, monkeypatch):
    """Each block of the f32 tail geometry probe replaces stage 2's region
    rows and blocks an SM in csrc/decoder_tail_f32.cuh (the probe raises
    where a line is missing; the as-built block is the header's own), its
    shared memory fits the blocks an SM (227 KB each, 228 KB an SM with 1
    KB reserved a block) and the as-built one matches the header's
    kSmemB; without a card the probe raises."""
    src = (_build.CSRC / tail_f32_geometry.HEADER).read_text()
    rows, blocks = tail_f32_geometry.VARIANTS[variant]
    out = tail_f32_geometry.patched(src, (rows, blocks))
    assert f"constexpr int kBR = {rows}, kBC = 32;" in out
    assert f"__launch_bounds__(kBThreads, {blocks})" in out
    assert (out == src) == ("as built" in variant)
    lay = tail_f32_geometry.layout((rows, blocks))
    assert blocks * (lay["smem_bytes"] + 1024) <= 228 * 1024
    assert lay["threads"] * blocks <= 2048
    if "as built" in variant:
        assert f"// {lay['smem_bytes']:,} B" in src
    with pytest.raises(ValueError, match="not found"):
        tail_f32_geometry.patched("", (rows, blocks))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        tail_f32_geometry.main([])


def test_pipe_probe_work():
    """P2's flops and bytes at the probe's shape, and its bound: the
    numbers chip_smoke.py's P2 gate counts (414.5 GFLOP; 0.419 ms at bf16,
    6.186 ms at float32, operations)."""
    flops, nbytes = mhada_pipe_probe.work(**mhada_pipe_probe.SHAPE,
                                          dtype=torch.bfloat16)
    assert flops == 8 * (6 * 4096 * 4096 * 512 + 2 * 4096 * 512 * 64)
    assert nbytes == 8 * 5 * 4096 * 512 * 2 + 8 * 4 * 512 * 4 + 8 * 64 * (
        64 * 2 + 4)
    assert abs(mhada_pipe_probe.bound_ms(flops, nbytes, "bfloat16")
               - 0.4191) < 1e-3
    f32 = mhada_pipe_probe.work(**mhada_pipe_probe.SHAPE, dtype=torch.float32)
    assert abs(mhada_pipe_probe.bound_ms(*f32, "float32") - 6.186) < 1e-3
