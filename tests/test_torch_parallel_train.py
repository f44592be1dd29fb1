"""Data-parallel and DP x TP training in the port (mhada_tpu_torch/parallel/
mesh.py, parallel/tp.py, the train steps' ``data`` and ``model`` groups),
CPU: 4 gloo ranks, one torch thread each, at tests/test_torch_train_step.py's
model (hidden 64, MLP 128, 4 heads; a head split over 2 ranks is 2 heads).

One spawn of 4 ranks (``parallel_ranks.train_ranks``) runs each case from
the seeded weights on its shard of the global batch: the image step (B = 4,
32^2) on (4 x 1) and (2 x 2), the fused-LN image step on (2 x 2), the video
step (B = 2, 32 x 64 frames against 32^2 styles, sample 1 fully occluded:
the second data rank's whole shard) on (2 x 2), and three planted faults
that must fail the same checks.  Each case is held against one jitted JAX
single-device step from the same weights (the port's seeded state_dicts
through ``state_dict_to_jax``) with test_torch_train_step.py's bounds: loss
and metrics 5e-5 relative, each live gradient 1e-3 of its own largest
value, the Adam update within 2 lr everywhere and within 1e-6 in 99.9 % of
the elements.  Then the sharding rules against the JAX rules, and the
split and its inverse.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

import parallel_ranks as pr
from mhada_tpu.config import ImageTrainConfig as JaxImageTrainConfig
from mhada_tpu.config import ModelConfig as JaxModelConfig
from mhada_tpu.config import VideoTrainConfig as JaxVideoTrainConfig
from mhada_tpu.parallel.mesh import param_sharding_rules as jax_rules
from mhada_tpu.train.train_image import build_models as jax_build_models
from mhada_tpu.train.train_image import image_loss_fn as jax_image_loss_fn
from mhada_tpu.train.train_image import make_optimizer
from mhada_tpu.train.train_video import video_loss_fn as jax_video_loss_fn
from mhada_tpu_torch.interop import params_from_jax, state_dict_to_jax
from mhada_tpu_torch.parallel import mesh
from mhada_tpu_torch.parallel.launch import run_ranks
from mhada_tpu_torch.train.train_image import TRAINABLE

# Six test workers share the CPU: cap torch's intra-op threads.
torch.set_num_threads(2)

LR = 1e-4
CASES = [c[0] for c in pr.TRAIN_CASES if c[4] is None]
CONTROLS = [c[0] for c in pr.TRAIN_CASES if c[4] is not None]
KIND = {c[0]: c[1] for c in pr.TRAIN_CASES}


def _jax_step(kind: str) -> dict:
    """One JAX single-device step of ``kind`` from the port's seeded
    weights on the global batch: metrics, grads and new params, by the
    port's parameter names."""
    cfg = pr.train_configs()[kind]
    models = pr.train_models(cfg)
    params = {k: state_dict_to_jax(m.state_dict()) for k, m in
              models.items()}
    trainable = {k: params[k] for k in TRAINABLE}
    jmodel = JaxModelConfig(**pr.TRAIN_TINY)
    if kind == "image":
        jcfg = JaxImageTrainConfig(model=jmodel, batch_size=4,
                                   image_size=(32, 32))
        loss_fn = jax_image_loss_fn
    else:
        jcfg = JaxVideoTrainConfig(model=jmodel, batch_size=2,
                                   style_size=(32, 32), content_size=(32, 64))
        loss_fn = jax_video_loss_fn
    jmodels = jax_build_models(jcfg, for_training=True)

    def loss_and_grads(p, vgg, *batch):
        return jax.value_and_grad(loss_fn, has_aux=True)(
            p, vgg, *batch, jmodels, jcfg)

    batch = [jnp.asarray(a) for a in pr.train_inputs()[kind]]
    (_, metrics), grads = jax.jit(loss_and_grads)(trainable,
                                                  params["vgg19"], *batch)
    tx = make_optimizer(jcfg)
    updates, _ = tx.update(grads, tx.init(trainable), trainable)
    new = optax.apply_updates(trainable, updates)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return dict(metrics={k: float(v) for k, v in metrics.items()},
                grads={k: params_from_jax(v) for k, v in to_np(grads).items()},
                new={k: params_from_jax(v) for k, v in to_np(new).items()})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the ranks' results, {recipe: the JAX step}): the JAX steps compile
    here while the ranks, processes of their own, run."""
    store = tmp_path_factory.mktemp("train_store") / "store"
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_ranks, pr.train_ranks, 4, (), device="cpu",
                            timeout_s=300, init_method=f"file://{store}")
        reference = {kind: _jax_step(kind) for kind in ("image", "video")}
        return ranks.result(), reference


@pytest.fixture(scope="module")
def ranks(runs):
    return runs[0]


@pytest.fixture(scope="module")
def reference(runs):
    return runs[1]


def metric_faults(metrics, ref) -> list:
    """The metrics off the JAX step's by more than 5e-5 relative."""
    assert metrics.keys() == ref.keys()
    assert all(v > 0 for v in ref.values())   # every loss is live
    return [k for k, want in ref.items()
            if abs(metrics[k] - want) > 5e-5 * abs(want)]


def grad_faults(grads, ref) -> list:
    """The gradient tensors off the JAX step's: a live one (above 1e-6 of
    its network's largest gradient) by more than 1e-3 of its own largest
    value, the others (zero in exact arithmetic: key biases, biases an
    instance norm removes) by more than 10 x that floor."""
    faults, live, total = [], 0, 0
    for net in TRAINABLE:
        want = ref[net]
        assert grads[net].keys() == want.keys()
        floor = 1e-6 * max(r.abs().max().item() for r in want.values())
        for key, r in want.items():
            total += 1
            scale = r.abs().max().item()
            err = (torch.as_tensor(grads[net][key]) - r).abs().max().item()
            if scale > floor:
                live += 1
                if err > 1e-3 * scale:
                    faults.append((net, key, err / scale))
            elif err > 10 * floor:
                faults.append((net, key, err / floor))
    assert live > 0.8 * total
    return faults


def adam_faults(new, ref) -> list:
    """The first Adam step moves each weight by about +-lr sign(g): the
    tensors more than 2 lr off the JAX step's (a sign flipped where the
    gradient is rounding noise; plus the weight's own float32 rounding, as
    the JAX DP x TP test allows, tests/test_train_step.py:172-174), and a
    note where fewer than 99.9 % of all elements are within 1e-6."""
    faults, diffs = [], []
    eps = torch.finfo(torch.float32).eps
    for net in TRAINABLE:
        for key, r in ref[net].items():
            d = (torch.as_tensor(new[net][key]) - r).abs().flatten()
            over = d - (2 * LR + eps * r.abs().flatten())
            if over.max().item() > 0:
                faults.append((net, key, d.max().item()))
            diffs.append(d)
    share = (torch.cat(diffs) <= 1e-6).float().mean().item()
    return faults + ([("share within 1e-6", share)] if share < 0.999 else [])


# check -> (the rank result's entry, its checker, the reference's entry)
CHECKS = {"metrics": (0, metric_faults, "metrics"),
          "grads": (1, grad_faults, "grads"), "adam": (2, adam_faults, "new")}


@pytest.mark.parametrize("check", CHECKS)
@pytest.mark.parametrize("case", CASES)
def test_parallel_step_matches_jax(ranks, reference, case, check):
    """The (4 x 1) and (2 x 2) image steps, the fused-LN step on (2 x 2) and
    the video step on (2 x 2), gathered over the model group, against the
    JAX single-device step on the global batch (the JAX step is the fused
    one's too: it computes the same function unfused)."""
    i, faults, key = CHECKS[check]
    assert faults(ranks[0][case][i], reference[KIND[case]][key]) == []


@pytest.mark.parametrize("case", CONTROLS)
def test_planted_faults_fail(ranks, reference, case):
    """copy_to_model's backward without its sum, the fused LN affine's
    gradient without its sum, and each rank's temporal losses over its own
    mask each put gradients off the JAX step's bounds."""
    _, grads, _ = ranks[0][case]
    assert grad_faults(grads, reference[KIND[case]]["grads"])


def test_replicas_stay_bitwise_equal(ranks):
    """After each step every replicated parameter is bitwise the same on
    every rank of its model group (the controls' too)."""
    flags = {k: v for r in ranks for k, v in r.items()
             if k.endswith("replicas")}
    assert len(flags) == len(pr.TRAIN_CASES)
    assert all(r[f"{c[0]} replicas"] for r in ranks for c in pr.TRAIN_CASES)


def test_round_trip_bitwise(ranks):
    """shard_params then gather_params gives every whole tensor back
    bitwise, on every rank of (2 x 2)."""
    assert [r["round trip"] for r in ranks] == [True] * 4


def _jax_path(net: str, name: str, ndim: int) -> str:
    """The JAX tree's path of a port parameter (interop.state_dict_to_jax's
    renaming)."""
    *path, leaf = name.split(".")
    if leaf == "qkv_weight":
        leaf = "qkv_kernel"
    elif leaf == "weight" and ndim in (2, 4):
        leaf = "kernel"
    elif leaf == "weight" and path[-1].startswith("ln"):
        leaf = "scale"
    return "/".join([net, *path, leaf])


def test_sharding_rules_match_jax():
    """Every parameter of the training build is split exactly where the
    JAX rule shards it, on the same axis (a port weight (out, in) is the
    transpose of a JAX kernel), the packed qkv in 3 parts; every JAX rule
    matches some parameter (no vacuous pass)."""
    cfg = pr.train_configs()["image"]
    models = pr.train_models(cfg)
    split, rules_hit = 0, set()
    for net in TRAINABLE:
        for name, p in models[net].named_parameters():
            spec = mesh.param_sharding_rules(name)
            jspec = tuple(jax_rules(_jax_path(net, name, p.dim())))
            if not any(s is not None for s in jspec):
                assert spec is None, name
                continue
            split += 1
            rules_hit.add(next(i for i, (rx, _) in enumerate(mesh._TP_RULES)
                               if rx.match(name)))
            jdim = jspec.index("model")
            # a Linear weight (out, in) is the JAX kernel transposed
            linear = name.endswith("weight") and p.dim() == 2
            assert spec.dim == (1 - jdim if linear else jdim), name
            assert spec.parts == (3 if "qkv" in name else 1), name
    assert split > 0 and rules_hit == set(range(len(mesh._TP_RULES)))


def test_qkv_splits_by_heads():
    """Rank r's packed qkv is [q_r | k_r | v_r], its heads' rows of each,
    so K6 takes it as a packed qkv of num_heads / ranks heads; and the
    inverse puts every row back."""
    e, ranks = 8, 2
    w = torch.arange(3 * e * 2.0).reshape(3 * e, 2)
    spec = mesh.param_sharding_rules("block0.attention.qkv_weight")
    shares = [mesh.shard_tensor(w, spec, r, ranks) for r in range(ranks)]
    for r, s in enumerate(shares):
        want = torch.cat([w[p * e + r * e // 2:p * e + (r + 1) * e // 2]
                          for p in range(3)])
        assert torch.equal(s, want)
    assert torch.equal(mesh.unshard_tensor(shares, spec), w)
