"""The port's image training step against the JAX package's, CPU: one step
from the same params, VGG params and batch at ModelConfig(hidden_dim=64,
mlp_dim=128, num_heads=4), B = 2, 32^2 (tests/test_train_step.py:21-36);
then the port alone: the loss falls, bfloat16 runs, remat keeps the
gradients; and the fused-LN training build (ModelConfig(fuse_ln=True), K2's
VJP) against the same JAX step, which computes the same function unfused
(JAX resolves fuse_ln to off on the CPU)."""

from dataclasses import replace

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

from mhada_tpu.config import ImageTrainConfig as JaxImageTrainConfig
from mhada_tpu.config import ModelConfig as JaxModelConfig
from mhada_tpu.train.train_image import build_models as jax_build_models
from mhada_tpu.train.train_image import image_loss_fn as jax_image_loss_fn
from mhada_tpu.train.train_image import init_params as jax_init_params
from mhada_tpu.train.train_image import make_optimizer
from mhada_tpu_torch.config import ImageTrainConfig, ModelConfig
from mhada_tpu_torch.interop import (jax_params_to_state_dicts, load_params,
                                     params_from_jax)
from mhada_tpu_torch.train.train_image import (TRAINABLE, init_params,
                                               make_image_train_step,
                                               make_optimizers)

# Six test workers share the CPU: cap torch's intra-op threads.
torch.set_num_threads(2)

TINY = dict(hidden_dim=64, mlp_dim=128, num_heads=4)
CFG = ImageTrainConfig(model=ModelConfig(**TINY), batch_size=2,
                       image_size=(32, 32))
FUSED_CFG = replace(CFG, model=ModelConfig(fuse_ln=True, **TINY))
LR = CFG.lr


@pytest.fixture(scope="module")
def reference():
    """One JAX step: (params, batch, loss and metrics, grads, new params),
    all as numpy."""
    jcfg = JaxImageTrainConfig(model=JaxModelConfig(**TINY), batch_size=2,
                               image_size=(32, 32))
    jmodels = jax_build_models(jcfg, for_training=True)
    params = jax_init_params(jax.random.PRNGKey(0), jcfg, jmodels)
    rng = np.random.default_rng(0)
    c, s = (rng.uniform(0, 255, (2, 32, 32, 3)).astype(np.float32)
            for _ in range(2))

    def loss_and_grads(p, vgg, c, s):
        return jax.value_and_grad(jax_image_loss_fn, has_aux=True)(
            p, vgg, c, s, jmodels, jcfg)

    (_, metrics), grads = jax.jit(loss_and_grads)(
        params["trainable"], params["vgg19"], jnp.asarray(c), jnp.asarray(s))
    tx = make_optimizer(jcfg)
    updates, _ = tx.update(grads, tx.init(params["trainable"]),
                           params["trainable"])
    new = optax.apply_updates(params["trainable"], updates)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return dict(params=to_np(params), c=c, s=s,
                metrics={k: float(v) for k, v in metrics.items()},
                grads=to_np(grads), new=to_np(new))


def _port_models(ref, cfg=CFG):
    models = init_params(cfg, "cpu")
    load_params(models, jax_params_to_state_dicts(ref["params"]["trainable"]))
    models["vgg19"].load_state_dict(params_from_jax(ref["params"]["vgg19"]),
                                    strict=True)
    return models


def _run_port_step(ref, cfg):
    """One port step from the JAX weights: (metrics, grads, new weights)."""
    models = _port_models(ref, cfg)
    step = make_image_train_step(cfg, models, make_optimizers(models, cfg))
    metrics = step(torch.from_numpy(ref["c"]), torch.from_numpy(ref["s"]))
    grads = {net: {k: p.grad.clone() for k, p in
                   models[net].named_parameters()} for net in TRAINABLE}
    new = {net: models[net].state_dict() for net in TRAINABLE}
    return {k: float(v) for k, v in metrics.items()}, grads, new


@pytest.fixture(scope="module")
def port_step(reference):
    """One port step from the same weights: (metrics, grads, new weights)."""
    return _run_port_step(reference, CFG)


@pytest.fixture(scope="module")
def fused_port_step(reference):
    """The same step with each ViT pre-LN fused into its matmul."""
    return _run_port_step(reference, FUSED_CFG)


def _check_metrics(metrics, ref):
    assert metrics.keys() == ref["metrics"].keys()
    assert ref["metrics"]["loss_lf"] > 0   # every loss is live
    for k, want in ref["metrics"].items():
        assert metrics[k] == pytest.approx(want, rel=5e-5), k


def _check_grads(grads, ref):
    live = 0
    for net in TRAINABLE:
        want = params_from_jax(ref["grads"][net])
        assert grads[net].keys() == want.keys()
        floor = 1e-6 * max(r.abs().max().item() for r in want.values())
        for key, r in want.items():
            scale = r.abs().max().item()
            err = (grads[net][key] - r).abs().max().item()
            if scale > floor:
                live += 1
                assert err <= 1e-3 * scale, (net, key, err, scale)
            else:
                assert err <= 10 * floor, (net, key, err, floor)
    assert live > 0.8 * sum(len(g) for g in grads.values())


def _check_adam_update(new, ref):
    diffs = []
    for net in TRAINABLE:
        want = params_from_jax(ref["new"][net])
        for key, r in want.items():
            d = (new[net][key] - r).abs().flatten()
            assert d.max().item() <= 2 * LR, (net, key)
            diffs.append(d)
    d = torch.cat(diffs)
    assert (d <= 1e-6).float().mean().item() >= 0.999


def test_step_loss_and_metrics_match_jax(reference, port_step):
    """rel 5e-5: XLA's float32 mean over the 131072 elements of relu1_1
    itself differs from torch's by 1.4e-5 relative on identical features
    (torch sums pairwise), which is what loss_id2 shows; the others agree
    within 1e-5."""
    metrics, _, _ = port_step
    _check_metrics(metrics, reference)


def test_step_grads_match_jax(reference, port_step):
    """max |d| / max |ref| <= 1e-3 for every parameter tensor whose
    gradient is live.  Some are zero in exact arithmetic: the key biases
    (softmax is shift-invariant along a row) and the vit_c last block's
    output biases (the next instance norm removes a per-channel constant).
    Below 1e-6 of the network's largest gradient a tensor counts as such
    rounding noise, and both sides must stay at that level."""
    _, grads, _ = port_step
    _check_grads(grads, reference)


def test_step_adam_update_matches_jax(reference, port_step):
    """The first Adam step moves each weight by about +-lr * sign(g): within
    2 lr everywhere, within 1e-6 in at least 99.9 % of the elements."""
    _, _, new = port_step
    _check_adam_update(new, reference)


def test_fused_ln_step_loss_and_metrics_match_jax(reference, fused_port_step):
    """The fused-LN build's step (K2's plain forward, its closed-form
    backward) holds the unfused step's bound on every metric."""
    metrics, _, _ = fused_port_step
    _check_metrics(metrics, reference)


def test_fused_ln_step_grads_match_jax(reference, fused_port_step):
    """The unfused step's gradient bounds, every tensor."""
    _, grads, _ = fused_port_step
    _check_grads(grads, reference)


def test_fused_ln_step_adam_update_matches_jax(reference, fused_port_step):
    _, _, new = fused_port_step
    _check_adam_update(new, reference)


def test_loss_falls_and_uint8_batches(reference):
    """Four steps on a fixed uint8 batch: finite, falling loss."""
    models = _port_models(reference)
    step = make_image_train_step(CFG, models, make_optimizers(models, CFG))
    c8, s8 = (torch.from_numpy(reference[k].astype(np.uint8))
              for k in ("c", "s"))
    losses = [float(step(c8, s8)["loss"]) for _ in range(4)]
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]


def test_bf16_step_runs_finite(reference):
    cfg = replace(CFG, compute_dtype="bfloat16")
    models = _port_models(reference)
    step = make_image_train_step(cfg, models, make_optimizers(models, cfg))
    metrics = step(torch.from_numpy(reference["c"]),
                   torch.from_numpy(reference["s"]))
    assert all(np.isfinite(float(v)) for v in metrics.values())
    for net in TRAINABLE:
        for p in models[net].parameters():
            assert p.dtype == torch.float32 and p.grad.dtype == torch.float32
            assert torch.isfinite(p).all()
    assert float(metrics["loss"]) == pytest.approx(
        reference["metrics"]["loss"], rel=2e-2)


def test_remat_gives_the_same_grads(reference, port_step):
    cfg = replace(CFG, remat=True)
    models = _port_models(reference)
    step = make_image_train_step(cfg, models, make_optimizers(models, cfg))
    step(torch.from_numpy(reference["c"]), torch.from_numpy(reference["s"]))
    _, grads, _ = port_step
    for net in TRAINABLE:
        for key, p in models[net].named_parameters():
            torch.testing.assert_close(p.grad, grads[net][key], rtol=1e-5,
                                       atol=1e-7)
