"""Model modules and the inference and training builds
(mhada_tpu/train/train_image.py:45-93)."""

import torch

from ..config import ModelConfig, resolve_device
from .adaformer import AdaAttnMultiHead, AdaFormer
from .decoder import Decoder
from .layers import init_parameters
from .vgg19 import VGG19Features
from .vit import VisionTransformer

__all__ = ["AdaAttnMultiHead", "AdaFormer", "Decoder", "VGG19Features",
           "VisionTransformer", "build_models"]


def build_models(cfg=None, device="cuda",
                 generator: torch.Generator | None = None,
                 for_training: bool = False) -> dict:
    """The networks {vit_c, vit_s, adaFormer} on ``device``: the card by
    default; raises without one unless ``device`` is the CPU.

    The inference build is in eval mode and runs the forward-only kernels
    K1-K5.  ``for_training`` gives the training build in training mode, as
    the JAX package's does: LayerNorms unfused, attention through K6, the
    MHAda cores through K7 and the decoder tail through K8, every one
    differentiable.

    ``cfg``: a ModelConfig, or anything with a ``.model`` ModelConfig.
    Weights are drawn on the CPU from ``generator`` (seed 0 if None), so a
    seed gives the same weights on every device; load trained weights with
    ``interop.load_params``.
    """
    device = resolve_device(device)
    m = getattr(cfg, "model", cfg) or ModelConfig()
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    vit = dict(patch_size=m.patch_size, num_layers=m.num_layers,
               num_heads=m.num_heads, hidden_dim=m.hidden_dim,
               mlp_dim=m.mlp_dim, attn_mode=m.attn_mode,
               backend=m.mhada_backend)
    models = {
        "vit_c": VisionTransformer(pos_embedding=True, **vit),
        "vit_s": VisionTransformer(pos_embedding=False, **vit),
        "adaFormer": AdaFormer(m.num_layers, m.num_heads, m.hidden_dim,
                               m.activation, m.mhada_backend),
    }
    for net in models.values():
        init_parameters(net, generator)
        net.to(device).train(for_training)
    return models
