"""Pipeline parallelism and data-parallel inference in the port
(mhada_tpu_torch/parallel/), CPU: ranks are gloo processes with a file store
under tmp_path, one torch thread each (one spawn of 4 ranks serves PP and
DP).

PP over 2 and 3 ranks against the JAX package's ``make_pp_stylize_fn`` at
the same stage count (weights from the port's seeded state_dicts), with
the ViT and the decoder each running on one rank only (forward hooks); DP
over 4 ranks at B = 2 against one rank at B = 8, the full and the
streaming path; the dry run's CLI at 4 ranks, its training steps on the
(2 x 2) mesh too.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import parallel_ranks as pr
from mhada_tpu.config import ModelConfig as JaxModelConfig
from mhada_tpu.infer import image as jax_image
from mhada_tpu.parallel import make_mesh
from mhada_tpu.parallel.pp import make_pp_stylize_fn as jax_pp_fn
from mhada_tpu.train.train_image import build_models as jax_build_models
from mhada_tpu_torch.interop import state_dict_to_jax
from mhada_tpu_torch.parallel.launch import run_ranks
from mhada_tpu_torch.parallel.pp import stage_blocks

# Six test workers share the CPU: cap torch's intra-op threads.
torch.set_num_threads(2)

# three layers: six MHAda blocks, which 2 and 3 stages divide
CFG = dict(num_layers=3, hidden_dim=128, num_heads=2, mlp_dim=256)
RANKS = 4
DATA = pr.pp_inputs()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    store = tmp_path_factory.mktemp("pp_store") / "store"
    return run_ranks(pr.pp_ranks, RANKS, (CFG,), device="cpu",
                     timeout_s=240, init_method=f"file://{store}")


@pytest.fixture(scope="module")
def jax_pair():
    from mhada_tpu_torch.config import ModelConfig
    from mhada_tpu_torch.models import build_models

    models = build_models(ModelConfig(**CFG), "cpu")
    pr.treat_decoder(models)
    params = {k: state_dict_to_jax(m.state_dict()) for k, m in models.items()}
    jmodels = jax_build_models(JaxModelConfig(**CFG))
    fs = jax_image.make_encode_style_fn(jmodels)(params,
                                                 jnp.asarray(DATA["style"]))
    return jmodels, params, jax_image.precompute_style_kv(jmodels, params, fs)


@pytest.mark.parametrize("n", [2, 3])
def test_pp_matches_jax(ranks, jax_pair, n):
    """3 frames through the port's pipeline over n ranks (the last one
    returns them, in order) against the JAX package's make_pp_stylize_fn
    over n virtual devices and against the port's single-rank frames: 0.1
    on 0-255."""
    if len(jax.devices()) < n:
        pytest.skip("needs the virtual device mesh")
    jmodels, params, kv = jax_pair
    mesh = make_mesh(n, 1, devices=jax.devices()[:n])
    ref = np.asarray(jax_pp_fn(jmodels, mesh)(
        params, jnp.asarray(DATA["contents"]), kv))
    assert ((ref > 0) & (ref < 255)).mean() > 0.6
    got = ranks[n - 1][f"pp{n}"]
    assert got.shape == ref.shape == (3, 1, 64, 64, 3)
    np.testing.assert_allclose(got, ref, atol=0.1, rtol=0)
    np.testing.assert_allclose(got, ranks[0]["pp_single"], atol=0.1, rtol=0)
    assert all(f"pp{n}" not in out for out in ranks[:n - 1])


@pytest.mark.parametrize("n", [2, 3])
def test_pp_encodes_and_decodes_on_one_rank(ranks, n):
    """The structural gate (tests/test_pp.py's): over the whole pipelined
    run vit_c runs on rank 0 alone, once a frame, and the decoder on the
    last rank alone, once a frame; ranks outside the group run neither."""
    frames = DATA["contents"].shape[0]
    for r, out in enumerate(ranks):
        calls = out.get(f"pp{n}_calls")
        if r >= n:
            assert calls is None
            continue
        assert calls == {"vit_c": frames if r == 0 else 0,
                         "decoder": frames if r == n - 1 else 0}, (r, calls)


def test_stage_blocks():
    """Rank s of S holds blocks [s 6/S, (s + 1) 6/S); 4 stages do not divide
    six blocks."""
    assert [list(stage_blocks(6, 3, s)) for s in range(3)] == [
        [0, 1], [2, 3], [4, 5]]
    assert list(stage_blocks(6, 1, 0)) == list(range(6))
    with pytest.raises(ValueError, match="divide"):
        stage_blocks(6, 4, 0)


@pytest.mark.parametrize("path", ["full", "stream"])
def test_dp_matches_one_rank(ranks, path):
    """4 ranks of B = 2, their models from seeds 0-3 and replicated from
    rank 0, gathered in rank order, against rank 0's B = 8 call: the full
    path (style re-encoded) and the streaming path (the K/V tiled): 1e-4."""
    ref = ranks[0][f"dp_{path}_ref"]
    assert ref.shape == (8, 32, 32, 3)
    assert ((ref > 0) & (ref < 255)).mean() > 0.6
    for out in ranks:
        np.testing.assert_allclose(out[f"dp_{path}"], ref, atol=1e-4,
                                   rtol=0)


def test_dryrun_cli_cpu():
    """python -m mhada_tpu_torch.parallel.dryrun --device cpu --nproc 4
    --tiny: the image and video training steps on the (2 x 2) mesh, each
    within the single-rank step's bounds (the loss within 1e-4, every
    weight within Adam's 2 lr), and SP, PP and DP at the dry run's sizes,
    each within 0.1 of the single-rank path; every rank reports."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-m", "mhada_tpu_torch.parallel.dryrun", "--device",
         "cpu", "--nproc", "4", "--tiny"], cwd=root, capture_output=True,
        text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert lines[-1].startswith("dryrun OK: 4 ranks, gloo"), lines
    ranks = [json.loads(ln) for ln in lines if ln.startswith('{"rank"')]
    assert len(ranks) == 4
    for kind in ("image", "video"):
        assert all(r[f"{kind}_mesh"] == [2, 2] for r in ranks)
        assert ranks[0][f"{kind}_loss_rel"] <= 1e-4
        assert ranks[0][f"{kind}_over"] <= 0
