"""The port's flow evals against the JAX package's on the CPU: RAFT-large
(mhada_tpu_torch/models/raft.py), the flow backends, the Sintel dataset,
the Sintel and video temporal evals.

RAFT's weights are one seeded random ``raft_large`` state_dict of the
plain-torch restatement (tests/torch_raft.py), saved as a ``.pth``: the JAX
package reads it through ``load_pth`` + ``import_raft``, the port through
its strict load.  Bounds as tests/test_raft.py: the encoders atol 2e-4,
the correlation lookup atol 1e-4, the last of 12 updates 1e-3 of the
flow's largest value and the first update atol 1e-3.  The full forward
runs at 136 x 152: at 64 x 64 the coarsest correlation level is 1 x 1,
where grid_sample's align_corners normalisation divides by zero
(torchvision's RAFT gives NaN there; the port refuses below 128).

The evals at ModelConfig(hidden_dim=64, mlp_dim=128, num_heads=4) with one
set of weights (c6 scaled): ``exps_sintel.run`` (MAE and MSE) and
``exps_video.evaluate_clip`` with a deterministic ``flow_fn``, rel 1e-4;
Farnebäck, ``Sintel`` items and ``video_frame_pairs`` equal.
"""

import csv
import os

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from mhada_tpu.config import ModelConfig as JaxModelConfig
from mhada_tpu.data import flow_models as jax_flow_models
from mhada_tpu.data import sintel as jax_sintel
from mhada_tpu.evals import exps_sintel as jax_exps_sintel
from mhada_tpu.evals import exps_video as jax_exps_video
from mhada_tpu.interop import load_pth
from mhada_tpu.models import raft as jax_raft
from mhada_tpu.train.train_image import build_models as jax_build_models
from mhada_tpu_torch.config import ModelConfig
from mhada_tpu_torch.data import flow_models, sintel
from mhada_tpu_torch.evals import exps_sintel, exps_video
from mhada_tpu_torch.interop import state_dict_to_jax
from mhada_tpu_torch.models import build_models, raft
from tests import torch_backbones as tb
from tests import torch_raft as tr
from tests.eval_assets import save_picture

# Six test workers share the CPU: cap torch's intra-op threads.
torch.set_num_threads(2)

TINY = dict(hidden_dim=64, mlp_dim=128, num_heads=4)
C6_GAIN = 3000.0   # scales the random decoder's output into a picture
RAFT_HW = (136, 152)   # feature grid 17 x 19: odd sides at levels 0 and 1


def rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


@pytest.fixture(scope="module")
def raft_pth(tmp_path_factory):
    m = tr.RAFTRef()
    tb._randomize(m, seed=11)
    path = str(tmp_path_factory.mktemp("raft") / "raft_large.pth")
    torch.save(m.state_dict(), path)
    return path


@pytest.fixture(scope="module")
def raft_pair(raft_pth):
    """The JAX params and the port's model on the same .pth."""
    return (jax_raft.import_raft(load_pth(raft_pth)),
            raft.load_raft(raft_pth, "cpu"))


def nhwc_pair(seed, hw):
    g = torch.Generator().manual_seed(seed)
    return [(torch.rand(1, *hw, 3, generator=g) * 2 - 1) for _ in range(2)]


def test_raft_loads_strictly(raft_pth):
    """The raft_large state_dict is the port's, key for key; a missing or
    an extra key is refused."""
    sd = torch.load(raft_pth, weights_only=True)
    model = raft.RAFT()
    assert set(model.state_dict()) == set(sd)
    model.load_state_dict(sd, strict=True)
    for bad in ({k: v for k, v in sd.items() if k != "mask_predictor.conv.bias"},
                {**sd, "corr_block.scale": torch.ones(1)}):
        with pytest.raises(RuntimeError):
            model.load_state_dict(bad, strict=True)


@pytest.mark.parametrize("name,norm", [("feature_encoder", "instance"),
                                       ("context_encoder", "batch")])
def test_raft_encoders_match_jax(raft_pair, name, norm):
    params, model = raft_pair
    x, _ = nhwc_pair(1, (64, 64))
    ref = jax_raft.RAFTEncoder(norm=norm).apply({"params": params[name]},
                                                jnp.asarray(x.numpy()))
    with torch.inference_mode():
        got = getattr(model, name)(x)
    assert got.shape == (1, 8, 8, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4)


@pytest.mark.parametrize("hw", [(16, 24), (17, 21)])
def test_corr_lookup_matches_jax(hw):
    """The pyramid and its 4-level, 81-point lookup at off-grid points
    (taps off every border); 17 x 21 pools odd sides in floor mode."""
    g = torch.Generator().manual_seed(3)
    f1, f2 = (torch.randn(1, *hw, 32, generator=g) for _ in range(2))
    coords = raft.coords_grid(1, *hw, "cpu") + torch.randn(1, *hw, 2,
                                                           generator=g) * 2
    pyr = raft.build_corr_pyramid(f1, f2)
    assert [tuple(p.shape[-2:]) for p in pyr] == [
        (hw[0] >> i, hw[1] >> i) for i in range(4)]
    got = raft.lookup_corr(pyr, coords)
    jpyr = jax_raft.build_corr_pyramid(jnp.asarray(f1.numpy()),
                                       jnp.asarray(f2.numpy()))
    ref = jax_raft.lookup_corr(jpyr, jnp.asarray(coords.numpy()))
    assert got.shape == (1, *hw, 324)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)


@pytest.fixture(scope="module")
def raft_flows(raft_pair):
    params, _ = raft_pair
    i1, i2 = nhwc_pair(7, RAFT_HW)
    flows = jax_raft.RAFT(num_iters=12).apply(
        {"params": params}, jnp.asarray(i1.numpy()), jnp.asarray(i2.numpy()))
    return i1, i2, np.asarray(flows)


@pytest.mark.parametrize("iters", [1, 12])
def test_raft_forward_matches_jax(raft_pair, raft_flows, iters):
    """The first update (drift hidden by convergence shows there) and the
    last of 12."""
    _, model = raft_pair
    i1, i2, flows = raft_flows
    got = model(i1, i2, iters).numpy()
    ref = flows[iters - 1]
    assert got.shape == ref.shape == (1, *RAFT_HW, 2)
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(got - ref).max())
    assert err <= (1e-3 * scale if iters == 12 else 1e-3), (err, scale)


def test_raft_flow_fn_from_pth(raft_pth, raft_flows):
    """make_raft_flow_fn on the .pth with the reference's 0-255 -> [-1, 1]
    mapping gives the JAX RAFT's last flow."""
    i1, i2, flows = raft_flows
    fn = flow_models.make_raft_flow_fn(raft_pth, device="cpu")
    imgs = [(x[0].numpy() + 1) * 127.5 for x in (i1, i2)]
    got = fn(*imgs)
    ref = flows[-1][0]
    assert got.shape == ref.shape and got.dtype == np.float32
    assert np.abs(got - ref).max() <= 1e-3 * max(1.0, np.abs(ref).max())


@pytest.mark.parametrize("hw", [(64, 64), (128, 132)])
def test_raft_refuses_small_or_ragged_inputs(raft_pair, hw):
    _, model = raft_pair
    x = torch.zeros(1, *hw, 3)
    with pytest.raises(ValueError, match="multiples of 8"):
        model(x, x)


def test_farneback_equals_jax():
    rng = np.random.default_rng(0)
    img1 = rng.uniform(0, 255, (48, 64, 3)).astype(np.float32)
    img2 = np.roll(img1, 3, axis=1)
    got = flow_models.farneback_flow_fn()(img1, img2)
    assert np.array_equal(got, jax_flow_models.farneback_flow_fn()(img1,
                                                                   img2))
    assert abs(float(np.median(got[16:-16, 16:-16, 0])) - 3.0) < 1.5


def sintel_tree(root, rng, scenes=("alley_2", "ambush_5"), frames=3,
                hw=(44, 60)):
    for scene in scenes:
        for i in range(frames):
            save_picture(os.path.join(root, "training", "final", scene,
                                      f"frame_{i + 1:04d}.png"), rng, hw)


def shifted_flow(img1, img2):
    """A deterministic flow of the frames (their mean difference as a
    smooth field), for the evals' comparisons."""
    h, w = img1.shape[:2]
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    d = float(img1.mean() - img2.mean()) / 8.0
    return np.stack([d + 1.5 * np.sin(4 * yy), -d + np.cos(3 * xx)],
                    -1).astype(np.float32)


def test_sintel_items_equal_jax(tmp_path):
    """Two scenes of three frames: the pairs, flows (from flow_fn and from
    precomputed .flo files) and masks of both packages; the precomputed
    files too."""
    rng = np.random.default_rng(2)
    sintel_tree(str(tmp_path), rng)
    size = (32, 48)
    ds = sintel.Sintel(size, str(tmp_path), flow_fn=shifted_flow)
    jds = jax_sintel.Sintel(size, str(tmp_path), flow_fn=shifted_flow)
    assert len(ds) == len(jds) == 4 and ds.meta == jds.meta
    sintel.precompute_sintel_flows(ds, shifted_flow, str(tmp_path / "port"))
    jax_sintel.precompute_sintel_flows(jds, shifted_flow,
                                       str(tmp_path / "jax"))
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == 8
    for n in names:
        assert (tmp_path / "jax" / n).read_bytes() == (
            tmp_path / "port" / n).read_bytes()
    one = sintel.Sintel(size, str(tmp_path), scene="ambush_5",
                        flow_dir=str(tmp_path / "port"))
    assert len(one) == 2
    for i in range(len(ds)):
        got, ref = ds[i], jds[i]
        for g, r in zip(got, ref):
            assert g.dtype == r.dtype and np.array_equal(g, r)
    for g, r in zip(one[1], ds[3]):
        assert np.array_equal(g, r)
    assert ds[0][0].shape == (32, 48, 3) and 0 < ds[0][3].mean() <= 1
    with pytest.raises(RuntimeError, match="needs flow"):
        sintel.Sintel(size, str(tmp_path))[0]
    with pytest.raises(FileNotFoundError):
        sintel.Sintel(size, str(tmp_path), scene="market_6")


@pytest.fixture(scope="module")
def stylizers():
    """The port's models (TINY, spatial, seed 1, c6 scaled) on the CPU and
    the JAX models holding the same weights: the port's state_dicts in the
    JAX layout (the JAX package's own init takes ~25 s here).  Seed 0's
    decoder puts every c6 pre-activation below 0 at this width: a black
    picture."""
    models = build_models(ModelConfig(**TINY), device="cpu",
                          generator=torch.Generator().manual_seed(1))
    c6 = models["adaFormer"].decoder.c6.conv
    with torch.no_grad():
        c6.weight.mul_(C6_GAIN)
        c6.bias.mul_(C6_GAIN)
    params = {k: state_dict_to_jax(m.state_dict()) for k, m in models.items()}
    jmodels = jax_build_models(JaxModelConfig(**TINY))
    style = np.random.default_rng(5).uniform(0, 255, (32, 32, 3)).astype(
        np.float32)
    return jmodels, params, models, style


@pytest.mark.parametrize("mode", ["mae", "mse"])
def test_exps_sintel_run_matches_jax(stylizers, tmp_path, mode):
    jmodels, params, models, style = stylizers
    sintel_tree(str(tmp_path), np.random.default_rng(3))
    scenes = ["alley_2", "ambush_5"]
    kw = dict(scenes=scenes, image_size=(32, 48), flow_fn=shifted_flow,
              mode=mode)
    ref = jax_exps_sintel.run(params, jmodels, style, str(tmp_path),
                              results_csv=str(tmp_path / "jax.csv"), **kw)
    got = exps_sintel.run(models, style, str(tmp_path),
                          results_csv=str(tmp_path / "out" / "port.csv"),
                          **kw)
    assert list(got) == list(ref) == scenes
    for s in scenes:
        assert ref[s] > 0 and rel(got[s], ref[s]) <= 1e-4, (got, ref)
    with open(tmp_path / "out" / "port.csv", newline="") as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["Scene", "Optical Flow Loss"]
    assert [r[0] for r in rows[1:]] == scenes


def test_evaluate_clip_matches_jax(stylizers):
    """Three frame pairs of 32 x 48, the pair stylizers of both packages
    (the style encoded once), a deterministic flow_fn."""
    jmodels, params, models, style = stylizers
    rng = np.random.default_rng(4)
    frames = [rng.uniform(0, 255, (32, 48, 3)).astype(np.float32)
              for _ in range(4)]
    pairs = list(zip(frames, frames[1:]))
    ref = jax_exps_video.evaluate_clip(
        pairs, jax_exps_video.make_stylize_pair_fn(params, jmodels, style),
        shifted_flow)
    pair_fn = exps_video.make_stylize_pair_fn(models, style)
    got = exps_video.evaluate_clip(pairs, pair_fn, shifted_flow)
    assert got["frames"] == ref["frames"] == 3
    for k in ("warping_error", "flow_mse"):
        assert ref[k] > 0 and rel(got[k], ref[k]) <= 1e-4, (k, got, ref)
    cs1, cs2 = pair_fn(*pairs[0])
    assert cs1.shape == (32, 48, 3) and cs1.dtype == np.float32
    assert 0 <= cs1.min() and cs2.max() <= 255 and cs2.max() > 0


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """A 5-frame 48 x 64 mp4v clip of moving bands and noise."""
    import cv2

    path = str(tmp_path_factory.mktemp("clip") / "in.mp4")
    rng = np.random.default_rng(6)
    yy, xx = np.mgrid[0:48, 0:64]
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 5, (64, 48))
    for i in range(5):
        f = np.stack([127 + 100 * np.sin((xx + 3 * i) / (6 + c) + yy / 9)
                      for c in range(3)], -1) + rng.normal(0, 8, (48, 64, 3))
        vw.write(np.clip(f, 0, 255).astype(np.uint8))
    vw.release()
    return path


def test_video_frame_pairs_equal_jax(clip):
    got = list(exps_video.video_frame_pairs(clip, (32, 24)))
    ref = list(jax_exps_video.video_frame_pairs(clip, (32, 24)))
    assert len(got) == len(ref) == 4
    for (a, b), (c, d) in zip(got, ref):
        assert a.shape == (24, 32, 3) and a.dtype == np.float32
        assert np.array_equal(a, c) and np.array_equal(b, d)
    assert np.array_equal(got[0][1], got[1][0])


@pytest.mark.parametrize("backend,error", [
    ("raft", ValueError), ("bogus", ValueError),
    ("raft:no/such/raft_large.pth", FileNotFoundError)])
def test_make_flow_fn_errors(backend, error, monkeypatch):
    monkeypatch.delenv("MHADA_RAFT_WEIGHTS", raising=False)
    with pytest.raises(error):
        exps_video.make_flow_fn(backend, "cpu")


def test_flow_backends_from_names(raft_pth, monkeypatch):
    """farneback by name and by default; RAFT by a path or the variable."""
    monkeypatch.delenv("MHADA_RAFT_WEIGHTS", raising=False)
    img = np.random.default_rng(1).uniform(0, 255, (128, 128, 3)).astype(
        np.float32)
    far = flow_models.farneback_flow_fn()(img, img)
    for fn in (exps_video.make_flow_fn("farneback"),
               flow_models.default_flow_fn(device="cpu")):
        assert np.array_equal(fn(img, img), far)
    want = exps_video.make_flow_fn(f"raft:{raft_pth}", "cpu")(img, img)
    monkeypatch.setenv("MHADA_RAFT_WEIGHTS", raft_pth)
    for fn in (exps_video.make_flow_fn("raft", "cpu"),
               flow_models.default_flow_fn(device="cpu")):
        assert np.array_equal(fn(img, img), want)


def test_exps_video_main_on_cpu(clip, tmp_path, capsys):
    import cv2

    style = str(tmp_path / "s.png")
    cv2.imwrite(style, np.random.default_rng(2).integers(
        0, 256, (40, 40, 3), np.uint8))
    exps_video.main(["--video", clip, "--style", style, "--size", "32", "48",
                     "--style-size", "32", "32", "--max-pairs", "2",
                     "--device", "cpu"])
    out = capsys.readouterr().out
    vals = [float(ln.split(":")[1]) for ln in out.splitlines()
            if ln.startswith(("Warping Error:", "Flow MSE:"))]
    assert len(vals) == 2 and all(np.isfinite(vals))


def test_exps_sintel_main_on_cpu(tmp_path, capsys):
    rng = np.random.default_rng(7)
    sintel_tree(str(tmp_path / "sintel"), rng)
    save_picture(str(tmp_path / "s.png"), rng, (40, 40))
    out = tmp_path / "res" / "sintel_results.csv"
    exps_sintel.main(["--sintel", str(tmp_path / "sintel"), "--style",
                      str(tmp_path / "s.png"), "--size", "32", "48",
                      "--style-size", "32", "32", "--scenes", "all",
                      "--csv", str(out), "--device", "cpu"])
    assert "Final Results:" in capsys.readouterr().out
    with open(out, newline="") as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["Scene", "Optical Flow Loss"]
    assert [r[0] for r in rows[1:]] == ["alley_2", "ambush_5"]
    assert all(np.isfinite(float(r[1])) for r in rows[1:])
