"""Analysis tools (mhada_tpu/analysis): parameter and FLOP counts, feature
inversion, BGR histograms."""

from .counts import count_params, count_params_mb, count_flops
from .visualize import (
    invert_vit_features,
    invert_mhada_features,
    invert_vgg_features,
    progressive_vgg_reconstruction,
    normalize_per_channel,
)
from .hist import plot_bgr_histograms

__all__ = [
    "count_params",
    "count_params_mb",
    "count_flops",
    "invert_vit_features",
    "invert_mhada_features",
    "invert_vgg_features",
    "progressive_vgg_reconstruction",
    "normalize_per_channel",
    "plot_bgr_histograms",
]
