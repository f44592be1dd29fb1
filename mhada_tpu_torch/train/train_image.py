"""Image training (mhada_tpu/train/train_image.py:96-275; reference
train_image.py:31-186).

Per step: stylise cs = AdaFormer(vit_c(c), vit_s(s)) and the identity
images cc, ss; five VGG sweeps (style, content, cs, cc, ss; the last three
backpropagated); four losses (global style, local feature, identity 1 and
2); one backward; Adam on each of the three networks.  The reference has
three Adam optimizers with one learning rate, so this is exactly the JAX
package's single ``optax.adam`` over the combined tree (Adam is per leaf).

The training build routes the ViT attention through K6, the MHAda cores
through K7 and the decoder tail through K8 (``models.build_models``) at
every image size (K6 and K7 stream keys, so 512^2, 4096 tokens, takes the
same kernels as 256^2); ``ModelConfig(fuse_ln=True)`` also fuses the ViT's
pre-LNs into their matmuls (K2 and its VJP).
bfloat16 is the JAX package's: the inputs are cast and each module casts
its float32 weights at use, so gradients and Adam state stay float32.
Data and tensor parallelism: ``make_image_train_step``'s ``data`` and
``model`` groups (``parallel.mesh.make_mesh``), on the modules of
``parallel.mesh.shard_params``.  ``remat`` recomputes the encoder,
AdaFormer and VGG forwards in the backward (``torch.utils.checkpoint``,
non-reentrant).  Float32 runs with TF32 off for every conv and matmul.
"""

import torch
from torch.utils.checkpoint import checkpoint

from ..config import ImageTrainConfig, resolve_device
from ..infer.image import DTYPES
from ..models import VGG19Features, build_models
from ..ops.pad_conv import no_tf32
from ..parallel.mesh import average_gradients
from . import losses as L

TRAINABLE = ("vit_c", "vit_s", "adaFormer")


def init_params(cfg: ImageTrainConfig, device="cuda",
                generator: torch.Generator | None = None) -> dict:
    """The training build {vit_c, vit_s, adaFormer} in training mode plus a
    frozen, random ``vgg19`` (load torchvision weights with
    ``interop.load_vgg19``), drawn from ``generator`` (seed 0 if None)."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    models = build_models(cfg, device, generator, for_training=True)
    vgg = VGG19Features()
    vgg.reset_parameters(generator)
    models["vgg19"] = vgg.requires_grad_(False).to(
        resolve_device(device)).eval()
    return models


def make_optimizers(models: dict, cfg: ImageTrainConfig) -> dict:
    """One Adam per trainable network, torch defaults as the reference
    (train_image.py:70-72)."""
    return {name: torch.optim.Adam(models[name].parameters(), lr=cfg.lr,
                                   betas=(0.9, 0.999), eps=1e-8)
            for name in TRAINABLE}


def _maybe_remat(fn, enable: bool):
    if not enable:
        return fn
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


def image_loss_fn(models: dict, content: torch.Tensor, style: torch.Tensor,
                  cfg: ImageTrainConfig):
    """The full image objective (reference train_image.py:103-136) on
    (B, H, W, 3) float 0-255 batches -> (loss, metrics)."""
    dt = DTYPES[cfg.compute_dtype]
    content, style = content.to(dt), style.to(dt)
    vit_c, vit_s, ada, vgg = (_maybe_remat(models[k], cfg.remat) for k in (
        "vit_c", "vit_s", "adaFormer", "vgg19"))

    fc_vc = vit_c(content)
    fs_vs = vit_s(style)
    _, cs = ada(fc_vc, fs_vs)
    fc_vs = vit_s(content)
    fs_vc = vit_c(style)
    _, cc = ada(fc_vc, fc_vs)
    _, ss = ada(fs_vc, fs_vs)

    vgg_fs, vgg_fc, vgg_fcs, vgg_fcc, vgg_fss = (
        vgg(x) for x in (style, content, cs, cc, ss))

    loss_gs = L.global_style_loss(vgg_fcs, vgg_fs) * cfg.lambda_gs
    loss_lf = L.local_feature_loss(vgg_fc, vgg_fs, vgg_fcs,
                                   cfg.model.activation) * cfg.lambda_lf
    loss_id1 = L.identity_loss_1(cc, content, ss, style) * cfg.lambda_id1
    loss_id2 = L.identity_loss_2(vgg_fcc, vgg_fc, vgg_fss,
                                 vgg_fs) * cfg.lambda_id2
    loss = loss_gs + loss_lf + loss_id1 + loss_id2
    return loss, {"loss": loss, "loss_gs": loss_gs, "loss_lf": loss_lf,
                  "loss_id1": loss_id1, "loss_id2": loss_id2}


def make_train_step(loss_fn, cfg, models: dict, optimizers: dict,
                    data=None, model=None):
    """``step(*batch) -> metrics`` of a recipe's ``loss_fn(models, *batch,
    cfg, data)``: one forward, backward and Adam update of ``models`` in
    place, the images cast to float32 first.

    ``data`` (a ``parallel.collectives.Group``): the batch is this rank's
    shard of the global batch (``parallel.mesh.shard_batch``); every
    gradient is averaged over the data ranks in float32 before Adam
    (``parallel.mesh.average_gradients``), as the JAX step's mean loss over
    the global batch makes it, and the metrics are the global batch's, the
    data ranks' mean.  ``model``: ``models`` are this rank's tensor-parallel
    share (``parallel.mesh.shard_params``); a split parameter keeps its
    share of Adam's state, which equals the whole Adam since Adam is per
    element."""
    if model is not None and data is None:
        raise ValueError("a tensor-parallel step needs its mesh's data group "
                         "too (parallel.mesh.make_mesh)")
    if cfg.model.attn_mode != "spatial" and data is not None \
            and data.size * (1 if model is None else model.size) > 1:
        raise ValueError("the batch-coupled attention attends over the "
                         "whole batch: it runs on one rank")
    params = [(k, p) for net in TRAINABLE
              for k, p in models[net].named_parameters()]

    def step(*batch) -> dict:
        for opt in optimizers.values():
            opt.zero_grad(set_to_none=True)
        with no_tf32():
            loss, metrics = loss_fn(models, *batch, cfg, data)
            loss.backward()
        if data is not None:
            average_gradients(params, data, model)
        for opt in optimizers.values():
            opt.step()
        metrics = {k: v.detach().float() for k, v in metrics.items()}
        if data is not None and data.size > 1:
            means = data.all_reduce_mean(torch.stack(list(metrics.values())))
            metrics = dict(zip(metrics, means.unbind(0)))
        return metrics

    return step


def make_image_train_step(cfg: ImageTrainConfig, models: dict,
                          optimizers: dict, data=None, model=None):
    """``step(content, style) -> metrics``: one forward, backward and Adam
    update of ``models`` in place.  Batches are (B, H, W, 3) 0-255, float or
    uint8 (cast to float32 first, train_image.py:260-264).  The metrics are
    0-d float32 tensors on the device (no host sync); the gradients stay in
    the parameters' ``.grad`` until the next step.  ``data``, ``model``:
    the mesh's groups (``make_train_step``)."""

    def loss_fn(models, content, style, cfg, data):
        return image_loss_fn(models, content.float(), style.float(), cfg)

    return make_train_step(loss_fn, cfg, models, optimizers, data, model)
