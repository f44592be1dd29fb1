"""The port's video-training data against the JAX package's, CPU: the flow
file formats written by one package and read by the other bit for bit;
the numpy flow utilities (mhada_tpu/data/flow_np.py); Monkaa and
FlyingThings3D over a synthetic SceneFlow tree giving the same items (the
JAX datasets read through data/native.py's C library where it loads, the
port through numpy); the WikiArt pairing; the video collate's dtypes."""

import pickle

import numpy as np
import pytest
import torch

from mhada_tpu.data import flow_np as jax_flow_np
from mhada_tpu.data import flowlib as jax_flowlib
from mhada_tpu.data import sceneflow as jax_sceneflow
from mhada_tpu_torch.data import flow_np, flowlib, sceneflow
from mhada_tpu_torch.data.coco_wikiart import CocoWikiArt
from sceneflow_tree import make_sceneflow_tree, make_video_datasets

# Six test workers share the CPU: cap torch's intra-op threads.
torch.set_num_threads(2)


@pytest.mark.parametrize("ext", [".flo", ".pfm", ".float3"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_flow_files_cross_read_bit_for_bit(tmp_path, ext, writer):
    """Each package reads what the other writes, bit for bit (PFM: 1- and
    3-channel, stored bottom-up; .float3: 2-D and 3-D)."""
    rng = np.random.default_rng(0)
    w_mod, r_mod = ((flowlib, jax_flowlib) if writer == "port"
                    else (jax_flowlib, flowlib))
    shapes = {".flo": [(7, 11, 2)], ".pfm": [(7, 11, 3), (7, 11)],
              ".float3": [(7, 11), (7, 11, 4)]}[ext]
    for i, shape in enumerate(shapes):
        data = rng.normal(0, 10, shape).astype(np.float32)
        path = str(tmp_path / f"f{i}{ext}")
        w_mod.write(path, data)
        got = r_mod.read(path)
        assert got.dtype == np.float32 and got.shape == shape
        np.testing.assert_array_equal(got, data)
        assert open(path, "rb").read() == _bytes_of(
            flowlib if w_mod is jax_flowlib else jax_flowlib, data,
            tmp_path / f"again{i}{ext}")


def _bytes_of(mod, data, path):
    mod.write(str(path), data)
    return open(path, "rb").read()


def test_pfm_endianness_from_the_scale_sign(tmp_path):
    """A big-endian PFM (positive scale) reads as the little-endian one."""
    data = np.arange(12, dtype=np.float32).reshape(3, 4)
    path = tmp_path / "be.pfm"
    with open(path, "wb") as f:
        f.write(b"Pf\n4 3\n2.0\n")
        np.flipud(data).astype(">f4").tofile(f)
    for mod in (flowlib, jax_flowlib):
        got, scale = mod.read_pfm(str(path))
        np.testing.assert_array_equal(got, data)
        assert scale == 2.0


def test_flow_np_matches_jax():
    """1e-6 absolute on every function, up- and downsampling."""
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 255, (13, 17, 3)).astype(np.float32)
    f01, f10 = (rng.normal(0, 2, (13, 17, 2)).astype(np.float32)
                for _ in range(2))
    px, py = (rng.uniform(-2, 19, (5, 6)).astype(np.float32)
              for _ in range(2))
    for out_hw in ((26, 9), (5, 40), (13, 17)):
        np.testing.assert_allclose(flow_np.resize_bilinear_np(x, out_hw),
                                   jax_flow_np.resize_bilinear_np(x, out_hw),
                                   rtol=0, atol=1e-6 * 255)
        np.testing.assert_allclose(flow_np.resize_bilinear_np(x[..., 0],
                                                              out_hw),
                                   jax_flow_np.resize_bilinear_np(
                                       x[..., 0], out_hw), rtol=0,
                                   atol=1e-6 * 255)
        np.testing.assert_allclose(flow_np.resize_flow_np(f01, out_hw),
                                   jax_flow_np.resize_flow_np(f01, out_hw),
                                   rtol=0, atol=1e-6)
    pairs = [(flow_np.grid_sample_np(x, px, py),
              jax_flow_np.grid_sample_np(x, px, py)),
             (flow_np.warp_np(x, f01), jax_flow_np.warp_np(x, f01)),
             (flow_np.flow_warp_mask_np(f01, f10),
              jax_flow_np.flow_warp_mask_np(f01, f10))]
    for got, ref in pairs:
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * 255)


def _same_items(got_ds, ref_ds):
    assert len(got_ds) == len(ref_ds) > 0
    for i in range(len(ref_ds)):
        got, ref = got_ds[i], ref_ds[i]
        img1, img2, flow, mask = got
        assert img1.dtype == np.float32 and flow.dtype == np.float32
        np.testing.assert_array_equal(img1, ref[0])
        np.testing.assert_array_equal(img2, ref[1])
        np.testing.assert_allclose(flow, ref[2], rtol=0, atol=1e-5)
        np.testing.assert_array_equal(mask, ref[3])


@pytest.mark.parametrize("ext", [".pfm", ".flo"])
def test_sceneflow_datasets_match_jax(tmp_path, ext):
    """Monkaa, FlyingThings3D and their concatenation at 64 x 32 (the flow
    rescaled from 36 x 24): frames equal, flows within 1e-5, masks equal;
    both kinds of mask values occur."""
    make_sceneflow_tree(str(tmp_path), np.random.default_rng(2),
                        flow_ext=ext)
    res = (64, 32)
    monkaa = sceneflow.Monkaa(str(tmp_path / "monkaa"), res)
    ft3d = sceneflow.FlyingThings3D(str(tmp_path / "flyingthings3d"), res)
    _same_items(monkaa, jax_sceneflow.Monkaa(str(tmp_path / "monkaa"), res))
    _same_items(ft3d, jax_sceneflow.FlyingThings3D(
        str(tmp_path / "flyingthings3d"), res))
    both = sceneflow.FlyingThings3DMonkaa(str(tmp_path), res)
    assert len(both) == len(monkaa) + len(ft3d) == 4 + 9
    _same_items(both, jax_sceneflow.FlyingThings3DMonkaa(str(tmp_path), res))
    img1, _, flow, mask = monkaa[0]
    assert img1.shape == (32, 64, 3) and flow.shape == (32, 64, 2)
    assert set(np.unique(mask)) == {0.0, 1.0}


def test_frame_num_above_one_matches_jax(tmp_path):
    make_sceneflow_tree(str(tmp_path), np.random.default_rng(3), ft3d=False)
    got = sceneflow.Monkaa(str(tmp_path / "monkaa"), (64, 32), frame_num=2)
    _same_items(got, jax_sceneflow.Monkaa(str(tmp_path / "monkaa"),
                                          (64, 32), frame_num=2))
    assert got[0][0].shape == (32, 64, 6)
    with pytest.raises(ValueError):
        sceneflow.Monkaa(str(tmp_path / "monkaa"), frame_num=10)


def test_wikiart_pairing_and_video_collate(tmp_path):
    """FlyingThings3DMonkaaWikiArt gives (style, c1, c2, flow, mask) with
    the JAX dataset's SceneFlow items and a style from WikiArt; the video
    collate ships the images as uint8 and the signed, fractional flow and
    the mask as float32, losslessly."""
    make_video_datasets(str(tmp_path), np.random.default_rng(4))
    ds = sceneflow.FlyingThings3DMonkaaWikiArt((16, 16), (32, 64),
                                               str(tmp_path), seed=0)
    ref = jax_sceneflow.FlyingThings3DMonkaaWikiArt((16, 16), (32, 64),
                                                    str(tmp_path), seed=0)
    assert len(ds) == len(ref) == 4
    items = [ds[i] for i in range(2)]
    for i, item in enumerate(items):
        assert item[0].shape == (16, 16, 3)
        _same_items([item[1:]], [ref[i][1:]])
    style, c1, c2, flow, mask = sceneflow.collate_video(items)
    assert [t.dtype for t in (style, c1, c2, flow, mask)] == [
        torch.uint8] * 3 + [torch.float32] * 2
    assert tuple(c1.shape) == (2, 32, 64, 3) and tuple(flow.shape) == (
        2, 32, 64, 2) and tuple(mask.shape) == (2, 32, 64)
    np.testing.assert_array_equal(c1.numpy(), np.stack([
        it[1] for it in items]))
    np.testing.assert_array_equal(flow.numpy(), np.stack([
        it[3] for it in items]))
    assert (flow < 0).any() and (flow != flow.round()).any()
    np.testing.assert_array_equal(mask.numpy(), np.stack([
        it[4] for it in items]))


def test_unseeded_datasets_pickle_for_spawned_workers(tmp_path):
    """The training loaders spawn their workers, which receive the dataset
    pickled; without a seed both training datasets must still pickle (a
    dataset holding the ``random`` module does not) and draw styles."""
    make_video_datasets(str(tmp_path), np.random.default_rng(5))
    video = sceneflow.FlyingThings3DMonkaaWikiArt((16, 16), (32, 64),
                                                  str(tmp_path))
    image = CocoWikiArt((16, 16), str(tmp_path / "WikiArt"),
                        str(tmp_path / "WikiArt"))
    for ds in (video, image):
        again = pickle.loads(pickle.dumps(ds))
        assert again[0][0].shape == (16, 16, 3)
