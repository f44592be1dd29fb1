"""Model, image- and video-training configuration (mhada_tpu/config.py:
12-83), the kernel switch and the device rule."""

from dataclasses import dataclass, field

import torch

BACKENDS = ("auto", "plain", "kernel")
FUSE_LN = ("auto", True, False)


@dataclass(frozen=True)
class ModelConfig:
    num_layers: int = 3
    num_heads: int = 8
    hidden_dim: int = 512
    mlp_dim: int = 2048
    patch_size: int = 8
    activation: str = "softmax"
    # "spatial" = idiomatic token attention; "batch_coupled" = the
    # reference's batch-axis attention quirk, needed by reference .pth
    # weights (mhada_tpu/models/vit.py:7-13).
    attn_mode: str = "spatial"
    # "auto": hand-written kernels for CUDA tensors, plain PyTorch twins for
    # CPU tensors; "plain": the twins everywhere; "kernel": the kernels
    # only (a CPU tensor raises).
    mhada_backend: str = "auto"
    # each ViT pre-LN fused into the matmul after it (K2, differentiable;
    # mhada_tpu/config.py:24-29): "auto" = the inference build only;
    # True / False = both builds / neither.
    fuse_ln: str | bool = "auto"

    def __post_init__(self):
        if self.mhada_backend not in BACKENDS:
            raise ValueError(f"unknown mhada_backend {self.mhada_backend!r}; "
                             f"expected one of {BACKENDS}")
        if self.fuse_ln not in FUSE_LN:
            raise ValueError(f"unknown fuse_ln {self.fuse_ln!r}; expected "
                             f"one of {FUSE_LN}")

    def resolve_fuse_ln(self, for_training: bool) -> bool:
        """Whether the build fuses each pre-LN into its matmul
        (mhada_tpu/train/train_image.py:51-53)."""
        if self.fuse_ln == "auto":
            return not for_training
        return bool(self.fuse_ln)


@dataclass(frozen=True)
class ImageTrainConfig:
    """The reference image recipe (reference train_image.py:14-28): 256^2,
    B = 8, Adam 1e-4 over the three networks, 20 epochs."""
    model: ModelConfig = field(default_factory=ModelConfig)
    epoch_start: int = 1
    epoch_end: int = 20
    batch_size: int = 8
    lr: float = 1e-4
    lambda_gs: float = 70.0
    lambda_lf: float = 15.0
    lambda_id1: float = 5e-2
    lambda_id2: float = 1e-1
    image_size: tuple[int, int] = (256, 256)
    # recompute the encoder, AdaFormer and VGG forwards in the backward
    # (torch.utils.checkpoint): activation memory for FLOPs
    remat: bool = False
    # forward and backward in this dtype ("float32" | "bfloat16"); master
    # weights, gradients and Adam state stay float32
    compute_dtype: str = "float32"


@dataclass(frozen=True)
class VideoTrainConfig:
    """The reference video recipe (reference train_video.py:14-32): epochs
    21-30 resumed from the image run, B = 2 pairs of 256 x 512 frames
    against 256^2 styles, six losses."""
    model: ModelConfig = field(default_factory=ModelConfig)
    epoch_start: int = 21
    epoch_end: int = 30
    batch_size: int = 2
    # the image run's batch size: it names the checkpoint resumed from
    image_batch_size: int = 8
    lr: float = 1e-4
    lambda_gs: float = 100.0
    lambda_lf: float = 15.0
    lambda_ot: float = 2.0
    lambda_ft: float = 2.0
    lambda_id1: float = 5e-2
    lambda_id2: float = 1e-1
    style_size: tuple[int, int] = (256, 256)
    content_size: tuple[int, int] = (256, 512)
    remat: bool = False
    compute_dtype: str = "float32"


def use_kernel(backend: str, x: torch.Tensor) -> bool:
    """Whether a kernel wrapper launches its CUDA kernel for tensor ``x``.

    The plain twin runs only for a CPU tensor or under ``"plain"``; a CUDA
    tensor never falls back to it.
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown mhada_backend {backend!r}; "
                         f"expected one of {BACKENDS}")
    if backend == "plain":
        return False
    if x.is_cuda:
        return True
    if backend == "kernel":
        raise RuntimeError(
            f"mhada_backend='kernel' needs a CUDA tensor, got one on {x.device}")
    return False


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for the CPU.  Raises, and never falls back, when CUDA is asked for and
    no card is visible."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card is visible; to run on the CPU pass --device cpu "
            "(device='cpu' from Python)")
    return dev
