"""The evaluation path (mhada_tpu/evals/): image metrics, LPIPS, SIFID on
InceptionV3, the image sweeps, the Sintel and video temporal evals and the
metric CLI.  Everything that runs a network runs on the card unless the
caller asks for the CPU."""

from .metrics import (
    average_entropy,
    compute_histogram,
    gram_loss,
    kl_divergence,
    nth_order_moment,
    ssim,
    uniformity,
)

__all__ = [
    "compute_histogram",
    "kl_divergence",
    "nth_order_moment",
    "uniformity",
    "average_entropy",
    "ssim",
    "gram_loss",
]
