"""Model modules and the inference and training builds
(mhada_tpu/train/train_image.py:45-93)."""

import torch

from ..config import ModelConfig, resolve_device
from .adaformer import AdaAttnMultiHead, AdaFormer
from .decoder import Decoder
from .layers import init_parameters
from .raft import RAFT
from .vgg19 import VGG19Features, imagenet_normalize
from .vit import VisionTransformer, VisionTransformerMultiScale
from ..train.losses import adaattn_for_loss

__all__ = ["AdaAttnMultiHead", "AdaFormer", "Decoder", "RAFT",
           "VGG19Features", "VisionTransformer",
           "VisionTransformerMultiScale", "adaattn_for_loss", "build_models",
           "imagenet_normalize"]


def build_models(cfg=None, device="cuda",
                 generator: torch.Generator | None = None,
                 for_training: bool = False,
                 decoder_tail: str = "fused") -> dict:
    """The networks {vit_c, vit_s, adaFormer} on ``device``: the card by
    default; raises without one unless ``device`` is the CPU.

    The inference build is in eval mode and runs the kernels K1-K5.
    ``for_training`` gives the training build in training mode, as the JAX
    package's does: attention through K6, the MHAda cores through K7 and
    the decoder tail through K8, every one differentiable.  Each build
    fuses the ViT's pre-LNs into their matmuls (K2) where
    ``ModelConfig.fuse_ln`` resolves to True for it: by default the
    inference build only.

    ``decoder_tail``: "fused" runs the decoder's up3 -> c5 -> c6 as K5 (K8
    in training); "c6" runs up3 and c5 as plain convs and c6 as K13, the
    JAX package's ``packed_decoder="col_tail"`` (scripts/tpu_probe.py:79-81).
    Both have the same weights.  "c6" is forward-only: with
    ``for_training`` it raises.

    ``cfg``: a ModelConfig, or anything with a ``.model`` ModelConfig.
    Weights are drawn on the CPU from ``generator`` (seed 0 if None), so a
    seed gives the same weights on every device; load trained weights with
    ``interop.load_params``.
    """
    if for_training and decoder_tail == "c6":
        raise ValueError(
            f"decoder_tail={decoder_tail!r} is forward-only (K13, as the JAX "
            "package's col_tail); the training build runs the fused tail K8")
    device = resolve_device(device)
    m = getattr(cfg, "model", cfg) or ModelConfig()
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    vit = dict(patch_size=m.patch_size, num_layers=m.num_layers,
               num_heads=m.num_heads, hidden_dim=m.hidden_dim,
               mlp_dim=m.mlp_dim, attn_mode=m.attn_mode,
               backend=m.mhada_backend,
               fuse_ln=m.resolve_fuse_ln(for_training))
    models = {
        "vit_c": VisionTransformer(pos_embedding=True, **vit),
        "vit_s": VisionTransformer(pos_embedding=False, **vit),
        "adaFormer": AdaFormer(m.num_layers, m.num_heads, m.hidden_dim,
                               m.activation, m.mhada_backend, decoder_tail),
    }
    for net in models.values():
        init_parameters(net, generator)
        net.to(device).train(for_training)
    return models
