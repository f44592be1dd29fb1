"""The port's flow warping and temporal losses against the JAX package, CPU:
``warp``, ``grid_sample`` and ``flow_warp_mask`` (mhada_tpu/ops/warp.py)
with flows that push taps off every border and onto the half-pixel edges
of the reference's grid arithmetic, at float32 and bfloat16, and the
gradient with respect to the warped tensor; the output- and feature-level
temporal losses (mhada_tpu/train/losses.py:72-120) at a 4 x 8 feature grid
under a 32 x 64 flow, and an empty mask giving 0 on both sides."""

import importlib

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from mhada_tpu.train import losses as JL
from mhada_tpu_torch.ops import warp as tw
from mhada_tpu_torch.train import losses as L

# mhada_tpu.ops exports a function named warp over the module's name
jw = importlib.import_module("mhada_tpu.ops.warp")

# Six test workers share the CPU: cap torch's intra-op threads.
torch.set_num_threads(2)

B, H, W, C = 2, 9, 13, 3


def _edge_flows(rng):
    """(B, H, W, 2) flows, one per case: zero flow (each sample lands half
    a pixel before its own pixel: the x = 0 and y = 0 taps sit on the -0.5
    edge), flows that put the last column and row exactly on the far
    half-pixel edge and one pixel past it, whole-image shifts off every
    border, and large random flows."""
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    # pixel v samples at v * n / (n - 1) - 0.5 (warp.py:78-79 then the
    # align_corners=False unnormalisation): these move the samples of
    # pixel v to exactly a, in the sampler's own units
    def to(a, v, n):
        return (a + 0.5) * (n - 1) / n - v

    cases = [
        np.zeros((H, W, 2), np.float32),
        np.stack([to(W - 0.5, xx, W), to(H - 0.5, yy, H)], -1),
        np.stack([to(W, xx, W), to(-1.0, yy, H)], -1),
        np.stack([to(-1.0, xx, W), to(H, yy, H)], -1),
        np.stack([np.full_like(xx, W / 2), np.full_like(yy, -H / 2)], -1),
        np.stack([np.full_like(xx, -W + 0.5), np.full_like(yy, H - 0.5)],
                 -1),
        rng.normal(0, 6, (H, W, 2)),
        rng.uniform(-1.5 * W, 1.5 * W, (H, W, 2)),
    ]
    flows = np.stack(cases).astype(np.float32)
    return flows.reshape(-1, B, H, W, 2)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 255, (B, H, W, C)).astype(np.float32)
    return x, _edge_flows(rng), rng.standard_normal((B, H, W, C)).astype(
        np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_warp_matches_jax_at_every_edge(data):
    """1e-4 absolute on 0-255 data, every case; each case moves some taps
    outside the image."""
    x, flows, _ = data
    for i, flow in enumerate(flows):
        ref = np.asarray(jw.warp(jnp.asarray(x), jnp.asarray(flow)))
        got = tw.warp(_t(x), _t(flow)).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4,
                                   err_msg=str(i))
    # the half-pixel shift is the reference's: zero flow does not return x
    assert np.abs(tw.warp(_t(x), _t(flows[0])).numpy() - x).max() > 1.0


def test_grid_sample_matches_jax(data):
    x, _, _ = data
    rng = np.random.default_rng(1)
    grid = rng.uniform(-1.3, 1.3, (B, 5, 7, 2)).astype(np.float32)
    grid[0, 0, :, 0] = [-1.0, 1.0, -1 - 1 / W, 1 + 1 / W, 0.0, -1.2, 1.2]
    ref = np.asarray(jw.grid_sample(jnp.asarray(x), jnp.asarray(grid)))
    got = tw.grid_sample(_t(x), _t(grid)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def test_warp_bf16_within_one_step(data):
    """bf16 x, float32 flow: both sample in float32 and round at the end,
    so they agree within one bf16 step of the larger value."""
    x, flows, _ = data
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    for i, flow in enumerate(flows):
        ref = np.asarray(jw.warp(xb, jnp.asarray(flow)).astype(jnp.float32))
        got = tw.warp(_t(x).bfloat16(), _t(flow))
        assert got.dtype == torch.bfloat16
        got = got.float().numpy()
        top = np.maximum(np.abs(got), np.abs(ref))
        step = np.where(top > 0, 2.0 ** (np.floor(np.log2(np.maximum(
            top, 1e-30))) - 7), 0.0)
        assert (np.abs(got - ref) <= step).all(), i


def test_warp_grad_matches_jax_vjp(data):
    """d(sum(warp(x) * cot)) / dx against jax.vjp, 1e-5 relative."""
    x, flows, cot = data
    for i, flow in enumerate(flows):
        _, vjp = jax.vjp(lambda a: jw.warp(a, jnp.asarray(flow)),
                         jnp.asarray(x))
        ref = np.asarray(vjp(jnp.asarray(cot))[0])
        xt = _t(x).requires_grad_()
        tw.warp(xt, _t(flow)).backward(_t(cot))
        got = xt.grad.numpy()
        scale = max(np.abs(ref).max(), 1e-30)
        assert np.abs(got - ref).max() <= 1e-5 * scale, i


def test_flow_warp_mask_matches_jax():
    """Masks equal, on consistent, inconsistent and off-image flows."""
    rng = np.random.default_rng(2)
    f01 = rng.normal(0, 3, (H, W, 2)).astype(np.float32)
    cases = [-f01, -f01 + rng.normal(0, 1.5, (H, W, 2)), f01,
             np.full((H, W, 2), 2 * W, np.float32)]
    seen = set()
    for i, f10 in enumerate(cases):
        f10 = f10.astype(np.float32)
        ref = np.asarray(jw.flow_warp_mask(jnp.asarray(f01),
                                           jnp.asarray(f10)))
        got = tw.flow_warp_mask(_t(f01), _t(f10)).numpy()
        assert got.dtype == np.float32 and got.shape == (H, W)
        np.testing.assert_array_equal(got, ref, err_msg=str(i))
        seen |= set(np.unique(got))
    assert seen == {0.0, 1.0}


@pytest.fixture(scope="module")
def temporal():
    """Images (2, 32, 64, 3), features (2, 4, 8, 16), flow 2 N(0, 1) and a
    U > 0.2 mask at 32 x 64, as numpy."""
    rng = np.random.default_rng(3)
    imgs = [rng.uniform(0, 255, (2, 32, 64, 3)).astype(np.float32)
            for _ in range(4)]
    feats = [rng.standard_normal((2, 4, 8, 16)).astype(np.float32)
             for _ in range(2)]
    flow = (2 * rng.standard_normal((2, 32, 64, 2))).astype(np.float32)
    mask = (rng.uniform(size=(2, 32, 64)) > 0.2).astype(np.float32)
    return imgs, feats, flow, mask


def _losses(imgs, feats, flow, mask):
    j = [jnp.asarray(a) for a in (*imgs, *feats, flow, mask)]
    t = [_t(a) for a in (*imgs, *feats, flow, mask)]
    ref = (JL.output_level_temporal_loss(*j[:4], j[6], j[7]),
           JL.feature_level_temporal_loss(j[4], j[5], j[6], j[7]))
    got = (L.output_level_temporal_loss(*t[:4], t[6], t[7]),
           L.feature_level_temporal_loss(t[4], t[5], t[6], t[7]))
    return [float(r) for r in ref], [float(g) for g in got]


def test_temporal_losses_match_jax(temporal):
    ref, got = _losses(*temporal)
    assert all(r > 0 for r in ref)
    for r, g in zip(ref, got):
        assert g == pytest.approx(r, rel=5e-5)


def test_temporal_losses_empty_mask_give_zero(temporal):
    imgs, feats, flow, mask = temporal
    ref, got = _losses(imgs, feats, flow, np.zeros_like(mask))
    assert ref == [0.0, 0.0] and got == [0.0, 0.0]


def test_temporal_losses_bf16_promote_as_jax(temporal):
    """bf16 images and features with a float32 flow and mask: the
    output-level loss comes out float32 and the feature-level one bf16 on
    both sides, within a bf16 tolerance of each other."""
    imgs, feats, flow, mask = temporal
    jb = [jnp.asarray(a).astype(jnp.bfloat16) for a in (*imgs, *feats)]
    tb = [_t(a).bfloat16() for a in (*imgs, *feats)]
    jf, tf = (jnp.asarray(flow), jnp.asarray(mask)), (_t(flow), _t(mask))
    ref = (JL.output_level_temporal_loss(*jb[:4], *jf),
           JL.feature_level_temporal_loss(jb[4], jb[5], *jf))
    got = (L.output_level_temporal_loss(*tb[:4], *tf),
           L.feature_level_temporal_loss(tb[4], tb[5], *tf))
    assert [r.dtype for r in ref] == [jnp.float32, jnp.bfloat16]
    assert [g.dtype for g in got] == [torch.float32, torch.bfloat16]
    for r, g in zip(ref, got):
        assert float(g) == pytest.approx(float(r), rel=2e-2)
