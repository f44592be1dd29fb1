"""Sequence parallelism in the port (mhada_tpu_torch/parallel/), CPU: ranks
are gloo processes with a file store under tmp_path, one torch thread each
(one spawn of 4 ranks serves the whole file).

The collectives on the native path and on the all-reduce path that gloo
takes for CUDA tensors (bitwise equal); the group instance norm against the
unsharded one; the port's SP frame at 2 and 4 ranks against the JAX
package's ``make_sp_stylize_fn`` at the same shard count (weights from the
port's seeded state_dicts); the narrow 512 x 64 frame of tests/test_sp.py
over 4 ranks against the single-rank frame, with the margin-minus-one
control; the position embedding regridded at the global grid; K1's cross
form's plain version against ``_attention_pallas_call`` in interpret mode.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

import parallel_ranks as pr
from mhada_tpu.config import ModelConfig as JaxModelConfig
from mhada_tpu.infer import image as jax_image
from mhada_tpu.models.vit import PosEmbedding as JaxPosEmbedding
from mhada_tpu.ops.attention_pallas import _attention_pallas_call
from mhada_tpu.parallel import make_mesh
from mhada_tpu.parallel import make_sp_stylize_fn as jax_sp_fn
from mhada_tpu.train.train_image import build_models as jax_build_models
from mhada_tpu_torch.interop import state_dict_to_jax
from mhada_tpu_torch.models.vit import PosEmbedding
from mhada_tpu_torch.ops.attention_kernel import (attention_cross,
                                                  attention_cross_plain)
from mhada_tpu_torch.ops.instance_norm import (instance_norm_stats,
                                               instance_norm_tokens)
from mhada_tpu_torch.parallel.launch import run_ranks
from mhada_tpu_torch.parallel.sp import required_decode_margin

# Six test workers share the CPU: cap torch's intra-op threads.
torch.set_num_threads(2)

SMALL = dict(num_layers=2, hidden_dim=128, num_heads=2, mlp_dim=256)
# tests/test_sp.py's narrow trunk: the decode halo is a spatial property
NARROW = dict(hidden_dim=64, mlp_dim=128, num_heads=4)
RANKS = 4
MARGIN = required_decode_margin()
DATA = pr.sp_inputs()
CONTENT, STYLE, STATS_X = DATA["content"], DATA["style"], DATA["stats_x"]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    store = tmp_path_factory.mktemp("sp_store") / "store"
    return run_ranks(pr.sp_ranks, RANKS, (SMALL, NARROW, (MARGIN, MARGIN - 1)),
                     device="cpu", timeout_s=240,
                     init_method=f"file://{store}")


def _bytes(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().reshape(-1).view(torch.uint8).numpy()


@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_collectives_both_paths_bitwise(ranks, name):
    """all_gather (rank order), gather_rows and ring_shift on the native
    gloo ops and on the all-reduce path (uint8 slots summed), forced on
    CPU tensors: every byte equal, signed zeros, NaN and infinities
    included, and equal to the inputs gathered or shifted by hand."""
    xs = [pr.collective_values(r)[name] for r in range(RANKS)]
    for r, out in enumerate(ranks):
        for op in ("gather", "rows", "shift"):
            native = out[f"{op}_{name}_native"]
            np.testing.assert_array_equal(
                native, out[f"{op}_{name}_all_reduce"], err_msg=f"{op} {r}")
        np.testing.assert_array_equal(out[f"gather_{name}_native"],
                                      _bytes(torch.stack(xs)))
        np.testing.assert_array_equal(out[f"rows_{name}_native"],
                                      _bytes(torch.cat(xs, dim=1)))
        np.testing.assert_array_equal(out[f"shift_{name}_native"],
                                      _bytes(xs[(r - 1) % RANKS]))
        np.testing.assert_array_equal(out["sum"], np.full(3, 6.0))


def test_group_instance_norm_matches_unsharded(ranks):
    """Tokens sharded over 4 ranks: the mean over the ranks, then the
    variance about that global mean, equal the unsharded statistics."""
    x = torch.from_numpy(STATS_X)
    mean, rstd = instance_norm_stats(x)
    full = instance_norm_tokens(x).numpy()
    n = x.shape[1] // RANKS
    for r, out in enumerate(ranks):
        got_mean, got_rstd = out["in_stats"]
        np.testing.assert_allclose(got_mean, mean.numpy(), atol=1e-6)
        np.testing.assert_allclose(got_rstd, rstd.numpy(), atol=1e-6)
        np.testing.assert_allclose(out["in_tokens"],
                                   full[:, r * n:(r + 1) * n], atol=1e-6)


@pytest.fixture(scope="module")
def jax_pair():
    from mhada_tpu_torch.config import ModelConfig
    from mhada_tpu_torch.models import build_models

    models = build_models(ModelConfig(**SMALL), "cpu")
    pr.treat_decoder(models)
    params = {k: state_dict_to_jax(m.state_dict()) for k, m in models.items()}
    jmodels = jax_build_models(JaxModelConfig(**SMALL))
    fs = jax_image.make_encode_style_fn(jmodels)(params, jnp.asarray(STYLE))
    return jmodels, params, jax_image.precompute_style_kv(jmodels, params, fs)


@pytest.mark.parametrize("n", [2, 4])
def test_sp_matches_jax(ranks, jax_pair, n):
    """The port's SP frame over n ranks (every rank holds the whole frame)
    against the JAX package's make_sp_stylize_fn over n of the 8 virtual
    devices, on the same weights: 0.1 on 0-255 (the reference gate)."""
    if len(jax.devices()) < n:
        pytest.skip("needs the virtual device mesh")
    jmodels, params, kv = jax_pair
    mesh = make_mesh(n, 1, devices=jax.devices()[:n])
    ref = np.asarray(jax_sp_fn(jmodels, mesh)(params, jnp.asarray(CONTENT),
                                              kv))
    assert ((ref > 0) & (ref < 255)).mean() > 0.6
    for out in ranks[:n]:
        got = out[f"sp{n}"]
        assert got.shape == CONTENT.shape
        np.testing.assert_allclose(got, ref, atol=0.1, rtol=0)
    np.testing.assert_allclose(ranks[0]["single"], ref, atol=0.1, rtol=0)


def test_sp_margin_exact_and_tight(ranks):
    """The narrow 512 x 64 frame over 4 ranks with tests/test_sp.py's mixing
    decoder: at the analytic margin (5 fcs rows) every rank's frame is the
    single-rank frame up to summation order (1e-3), and margin - 1 shows
    slab-boundary error above max(4 x that, 5e-4): the margin is tight."""
    assert MARGIN == 5
    ref = ranks[0]["narrow_single"]
    assert ((ref > 0) & (ref < 255)).mean() > 0.6
    errs = [np.abs(out[f"narrow_m{MARGIN}"] - ref).max() for out in ranks]
    err_full = max(errs)
    assert err_full < 1e-3, errs
    err_short = np.abs(ranks[0][f"narrow_m{MARGIN - 1}"] - ref).max()
    assert err_short > max(4 * err_full, 5e-4), (err_short, err_full)


class _Rank:
    """The rank and size a position embedding reads from its group."""

    def __init__(self, rank, size):
        self.rank, self.size = rank, size


def test_pos_embedding_regrids_at_the_global_grid():
    """A rank's rows of the position grid: regridded at the global (h n, w)
    grid and sliced, as the JAX sp_axis branch (vit.py:186-197) does; at
    h = 3 rows a rank the local regrid differs, so the test can fail."""
    rng = np.random.default_rng(5)
    grid = rng.standard_normal((1, 32, 32, 16)).astype(np.float32)
    pos = PosEmbedding(16)
    with torch.no_grad():
        pos.pos_embed.copy_(torch.from_numpy(grid))
    h, w, n = 3, 5, 4
    jpos = np.asarray(JaxPosEmbedding(16).apply(
        {"params": {"pos_embed": jnp.asarray(grid)}}, (h * n, w))
    ).reshape(h * n, w, 16)
    whole = pos((h * n, w)).detach().numpy().reshape(h * n, w, 16)
    for r in range(n):
        got = pos((h, w), _Rank(r, n)).detach().numpy().reshape(h, w, 16)
        np.testing.assert_array_equal(got, whole[r * h:(r + 1) * h])
        # the regrid against JAX's (test_torch_ops.py's bound)
        np.testing.assert_allclose(got, jpos[r * h:(r + 1) * h], atol=1e-5,
                                   rtol=1e-5)
    local = pos((h, w)).detach().numpy().reshape(h, w, 16)
    assert np.abs(local - jpos[:h]).max() > 1e-2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,m", [(256, 1024), (200, 700)])
def test_attention_cross_plain_matches_pallas_call(dtype, n, m):
    """K1's cross form: attention_cross_plain (the twin the card holds the
    kernel to) against _attention_pallas_call (the TPU kernel, interpret
    mode) at N != M, ragged (200 queries, 700 keys: no block divides them)
    and whole; q a column slice of a packed qkv, as under SP.  float32:
    summation order only (K1's CPU bounds); bfloat16: the Pallas kernel
    rounds P to bf16 before P V, the twin computes in float32 from the same
    bf16 inputs, so half a bf16 step of the output's scale."""
    rng = np.random.default_rng(n + m)
    b, h, d = 2, 2, 64
    c = h * d
    qkv = rng.standard_normal((b, n, 3 * c)).astype(np.float32)
    kv = rng.standard_normal((b, m, 2 * c)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    qkv_t, kv_t = (torch.from_numpy(a).to(tdt) for a in (qkv, kv))
    got = attention_cross(qkv_t[..., :c], kv_t, h, scale=0.125)
    np.testing.assert_array_equal(
        got.float().numpy(),
        attention_cross_plain(qkv_t[..., :c], kv_t, h, 0.125).float().numpy())

    def heads(a, off, length):
        return jnp.asarray(a[..., off:off + c].reshape(b, length, h, d)
                           .transpose(0, 2, 1, 3)).astype(jdt)

    with pltpu.force_tpu_interpret_mode():
        ref = _attention_pallas_call(heads(qkv, 0, n), heads(kv, 0, m),
                                     heads(kv, c, m), scale=0.125)
    ref = np.asarray(ref.astype(jnp.float32)).transpose(0, 2, 1, 3) \
        .reshape(b, n, c)
    assert got.shape == (b, n, c) and got.dtype == tdt
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=1e-4)
    else:
        scale = np.abs(ref).max()
        assert np.abs(got.float().numpy() - ref).max() <= 2 ** -8 * scale
