"""Training losses (mhada_tpu/train/losses.py:17-120; reference
lossfn.py:7-86).

Feature dicts are {"relu1_1" .. "relu5_1"} NHWC maps from
``models.VGG19Features``; images are NHWC 0-255.  MSE is mean-reduced like
``nn.MSELoss``.  The two temporal losses are video training's.
"""

import torch

from ..ops.instance_norm import instance_norm_tokens
from ..ops.mhada import mhada_attention
from ..ops.resize import resize_bilinear
from ..ops.warp import warp
from ..utils.features import feature_down_sample

LAYERS = ["relu1_1", "relu2_1", "relu3_1", "relu4_1", "relu5_1"]


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(a - b))


def global_style_loss(fcs: dict, fs: dict) -> torch.Tensor:
    """AdaIN statistics matching over the five layers (lossfn.py:7-23),
    with the std's Bessel factor n / (n - 1) taken, as the JAX package
    takes it (mhada_tpu/train/losses.py:34-38), from the stylised map's
    pixel count n for both maps.  The reference (torch ``Tensor.std``)
    gives each map its own; the two agree while the maps have one size, as
    in image training, and differ by 1e-4 relative in video training,
    where 256 x 512 outputs meet 256^2 styles."""
    loss = 0.0
    for name in LAYERS:
        a, b = fcs[name], fs[name]
        n = a.shape[1] * a.shape[2]
        a_std, b_std = (torch.sqrt(t.var((1, 2), correction=0) * (n / (n - 1)))
                        for t in (a, b))
        loss = loss + mse(a.mean((1, 2)), b.mean((1, 2))) + mse(a_std, b_std)
    return loss


def adaattn_for_loss(c_x, s_x, c_1x, s_1x, activation: str = "softmax"):
    """Parameter-free AdaAttN on NHWC maps (mhada_tpu/models/
    adaformer.py:257-268, ops/mhada.py:82-100; reference adaDecoder.py
    :38-81): Q = IN(c_1x), K = IN(s_1x), V = s_x, output S * IN(c_x) + M,
    as one head over all channels with the plain core."""
    b, h, w, c = c_x.shape

    def tokens(t):
        return t.reshape(t.shape[0], -1, t.shape[-1])

    q = instance_norm_tokens(tokens(c_1x))
    k = instance_norm_tokens(tokens(s_1x))
    cn = instance_norm_tokens(tokens(c_x))
    out = mhada_attention(q[:, None], k[:, None], tokens(s_x)[:, None],
                          cn[:, None], activation)
    return out[:, 0].reshape(b, h, w, c)


def local_feature_loss(fc: dict, fs: dict, fcs: dict,
                       activation: str = "softmax") -> torch.Tensor:
    """MSE against parameter-free AdaAttN targets at relu3/4/5_1, with
    multi-scale Q/K concats (lossfn.py:26-34)."""
    loss = 0.0
    for i in (3, 4, 5):
        target = adaattn_for_loss(
            fc[f"relu{i}_1"], fs[f"relu{i}_1"], feature_down_sample(fc, i),
            feature_down_sample(fs, i), activation)
        loss = loss + mse(fcs[f"relu{i}_1"], target)
    return loss


def identity_loss_1(cc, c, ss, s) -> torch.Tensor:
    """Pixel-space reconstruction identity (lossfn.py:37-38)."""
    return mse(cc, c) + mse(ss, s)


def identity_loss_2(fcc: dict, fc: dict, fss: dict, fs: dict) -> torch.Tensor:
    """VGG-feature identity over all five layers (lossfn.py:41-47)."""
    loss = 0.0
    for name in LAYERS:
        loss = loss + mse(fcc[name], fc[name]) + mse(fss[name], fs[name])
    return loss


def output_level_temporal_loss(c1, c2, cs1, cs2, flow, mask) -> torch.Tensor:
    """Flow-warped output change against the luma change of the input
    (lossfn.py:50-66).  c*, cs*: (B, H, W, 3); flow: (B, H, W, 2); mask:
    (B, H, W), float32 whatever the images' dtype."""
    diff = c2 - warp(c1, flow)
    luma = 0.2126 * diff[..., 0] + 0.7152 * diff[..., 1] + 0.0722 * diff[
        ..., 2]
    m = mask[..., None]
    per_elem = torch.square(cs2 - warp(cs1, flow) - luma[..., None]) * m
    return _masked_mean(per_elem, m.sum() * c2.shape[-1])


def feature_level_temporal_loss(f1, f2, flow, mask) -> torch.Tensor:
    """Flow-warped consistency of the pre-decoder fcs maps (lossfn.py:
    69-86).  f1, f2: (B, h, w, C); flow: (B, H, W, 2) at image resolution,
    resized to the feature grid with its vectors scaled by (w / W, h / H);
    mask: (B, H, W), resized and kept where > 0."""
    fh, fw = f1.shape[1:3]
    flow_r = resize_bilinear(flow, (fh, fw))
    # scaled by Python floats: a device tensor made from a list would be a
    # pageable copy that synchronises the stream
    flow_r = torch.stack([flow_r[..., 0] * (fw / flow.shape[2]),
                          flow_r[..., 1] * (fh / flow.shape[1])], dim=-1)
    warped_f1 = warp(f1, flow_r)
    fmask = (resize_bilinear(mask[..., None], (fh, fw)) > 0).to(f1.dtype)
    per_elem = torch.square(f2 - warped_f1) * fmask
    return _masked_mean(per_elem, fmask.sum() * f1.shape[-1])


def _masked_mean(per_elem, nnz) -> torch.Tensor:
    """sum(per_elem) / nnz, and 0 where the mask is empty (the JAX
    package's deliberate deviation from the reference's NaN: one fully
    occluded sample must not poison a run's gradients)."""
    return torch.where(nnz > 0, per_elem.sum() / nnz.clamp_min(1),
                       per_elem.new_zeros(()))
