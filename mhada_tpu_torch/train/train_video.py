"""Video training (mhada_tpu/train/train_video.py:20-117; reference
train_video.py:35-219), the second stage after image training.

Per step: both content frames stylised against one style encoding, the
identity images of both frames and of the style, eight VGG sweeps (the
frames' and the style's under ``torch.no_grad()``: constants, as
``stop_gradient`` makes them in the JAX package) and six losses: global
style and local feature on both frames, the output- and feature-level
temporal losses through the flow, and the two identity losses.  That is 6
ViT applies (K6), 5 AdaFormer applies (K7, and K8 for each decoder tail).
Adam, bfloat16, ``remat`` and float32 without TF32 as in
``train.train_image``.
"""

import torch

from ..config import VideoTrainConfig
from ..infer.image import DTYPES
from ..ops.pad_conv import no_tf32
from . import losses as L
from .train_image import _maybe_remat


def video_loss_fn(models: dict, style, c1, c2, flow, mask,
                  cfg: VideoTrainConfig):
    """The video objective (reference train_video.py:110-167) -> (loss,
    metrics).  style: (B, Hs, Ws, 3); c1, c2: (B, H, W, 3), float 0-255;
    flow: (B, H, W, 2), pixel flow from frame 2 into frame 1; mask: (B, H,
    W).  bfloat16 casts the images only: flow and mask stay float32."""
    dt = DTYPES[cfg.compute_dtype]
    style, c1, c2 = (x.to(dt) for x in (style, c1, c2))
    vit_c, vit_s, ada, vgg_grad = (
        _maybe_remat(models[k], cfg.remat)
        for k in ("vit_c", "vit_s", "adaFormer", "vgg19"))

    vitc_fc1, vitc_fc2 = vit_c(c1), vit_c(c2)
    vits_fs = vit_s(style)
    ada_fcs1, cs1 = ada(vitc_fc1, vits_fs)
    ada_fcs2, cs2 = ada(vitc_fc2, vits_fs)
    vits_fc1, vits_fc2 = vit_s(c1), vit_s(c2)
    vitc_fs = vit_c(style)
    _, cc1 = ada(vitc_fc1, vits_fc1)
    _, cc2 = ada(vitc_fc2, vits_fc2)
    _, ss = ada(vitc_fs, vits_fs)

    with torch.no_grad():
        vgg_fc1, vgg_fc2, vgg_fs = (models["vgg19"](x) for x in (c1, c2,
                                                                 style))
    vgg_fcs1, vgg_fcs2, vgg_fcc1, vgg_fcc2, vgg_fss = (
        vgg_grad(x) for x in (cs1, cs2, cc1, cc2, ss))

    act = cfg.model.activation
    loss_gs = (L.global_style_loss(vgg_fcs1, vgg_fs)
               + L.global_style_loss(vgg_fcs2, vgg_fs)) * cfg.lambda_gs
    loss_lf = (L.local_feature_loss(vgg_fc1, vgg_fs, vgg_fcs1, act)
               + L.local_feature_loss(vgg_fc2, vgg_fs, vgg_fcs2, act)
               ) * cfg.lambda_lf
    loss_ot = L.output_level_temporal_loss(c1, c2, cs1, cs2, flow,
                                           mask) * cfg.lambda_ot
    loss_ft = L.feature_level_temporal_loss(ada_fcs1, ada_fcs2, flow,
                                            mask) * cfg.lambda_ft
    loss_id1 = (L.mse(cc1, c1) + L.mse(cc2, c2)
                + L.mse(ss, style)) * cfg.lambda_id1
    loss_id2 = 0.0
    for name in L.LAYERS:
        loss_id2 = (loss_id2 + L.mse(vgg_fcc1[name], vgg_fc1[name])
                    + L.mse(vgg_fcc2[name], vgg_fc2[name])
                    + L.mse(vgg_fss[name], vgg_fs[name]))
    loss_id2 = loss_id2 * cfg.lambda_id2

    loss = loss_gs + loss_lf + loss_ot + loss_ft + loss_id1 + loss_id2
    return loss, {"loss": loss, "l_gs": loss_gs, "l_lf": loss_lf,
                  "l_ot": loss_ot, "l_ft": loss_ft, "l_id1": loss_id1,
                  "l_id2": loss_id2}


def make_video_train_step(cfg: VideoTrainConfig, models: dict,
                          optimizers: dict):
    """``step(style, c1, c2, flow, mask) -> metrics``: one forward,
    backward and Adam update of ``models`` in place.  Images are 0-255,
    float or uint8 (cast to float32 first, train_video.py:102-106); flow
    and mask are float32.  The metrics are 0-d float32 tensors on the
    device (no host sync)."""

    def step(style, c1, c2, flow, mask) -> dict:
        for opt in optimizers.values():
            opt.zero_grad(set_to_none=True)
        with no_tf32():
            loss, metrics = video_loss_fn(
                models, style.float(), c1.float(), c2.float(), flow, mask,
                cfg)
            loss.backward()
        for opt in optimizers.values():
            opt.step()
        return {k: v.detach().float() for k, v in metrics.items()}

    return step
