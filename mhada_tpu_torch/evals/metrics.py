"""Image-quality metrics (mhada_tpu/evals/metrics.py:1-161; reference
eval.py:38-243).

The histogram metrics run in numpy on uint8 images; SSIM and the VGG gram
loss run on ``device``, the card unless the caller asks for the CPU.
Quirks of the reference kept deliberately, as the JAX package keeps them:

- histograms use +1 smoothing on raw bincounts (eval.py:45);
- ``nth_order_moment`` normalises bin *counts* by 255 (eval.py:119);
- the SSIM constants C1/C2 assume [0, 1] inputs but images arrive 0-255
  (eval.py:189,229-238);
- metric functions take file paths and reload from disk (the round trip
  through the codec is part of the defined behaviour).
"""

from functools import lru_cache
from typing import Callable, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..config import resolve_device
from ..ops.pad_conv import no_tf32

ImageLike = Union[str, np.ndarray]


def _load_bgr(img: ImageLike) -> np.ndarray:
    if isinstance(img, str):
        import cv2

        out = cv2.imread(img)
        if out is None:
            raise FileNotFoundError(img)
        return out
    return img


def _load_rgb(img: ImageLike) -> np.ndarray:
    if isinstance(img, str):
        import cv2

        return cv2.cvtColor(_load_bgr(img), cv2.COLOR_BGR2RGB)
    return img


def _load_gray(img: ImageLike) -> np.ndarray:
    import cv2

    return cv2.cvtColor(_load_bgr(img), cv2.COLOR_BGR2GRAY)


def compute_histogram(img: np.ndarray, channel=None) -> np.ndarray:
    """256-bin histogram with +1 smoothing (eval.py:38-46)."""
    data = img.flatten() if channel is None else img[:, :, channel].flatten()
    return np.bincount(data, minlength=256) + 1


def kl_divergence(path0: ImageLike, path1: ImageLike) -> float:
    """Mean per-channel histogram KL divergence (eval.py:49-67)."""
    import scipy.stats

    img = _load_bgr(path0)
    s = _load_bgr(path1)
    kl = sum(
        scipy.stats.entropy(compute_histogram(img, ch),
                            compute_histogram(s, ch))
        for ch in range(3)
    )
    return float(kl) / 3.0


def nth_order_moment(path0: ImageLike) -> float:
    """2nd-order moment of the gray histogram (eval.py:111-129)."""
    hist = compute_histogram(_load_gray(path0)).astype(np.float64)
    hist_p = hist / hist.sum()
    hist_n = hist / 255.0
    return float(np.sum((hist_n - hist_n.mean()) ** 2 * hist_p))


def uniformity(path0: ImageLike) -> float:
    """Histogram uniformity sum(p^2) (eval.py:132-146)."""
    hist = compute_histogram(_load_gray(path0)).astype(np.float64)
    p = hist / hist.sum()
    return float(np.sum(p**2))


def average_entropy(path0: ImageLike) -> float:
    """Shannon entropy of the gray histogram (eval.py:149-164)."""
    hist = compute_histogram(_load_gray(path0)).astype(np.float64)
    p = hist / hist.sum()
    p = p[p > 0]
    return float(-np.sum(p * np.log2(p)))


@lru_cache(maxsize=4)
def _gaussian_kernel(window_size: int, sigma: float) -> np.ndarray:
    x = np.linspace(-(window_size // 2), window_size // 2, window_size)
    g = np.exp(-(x**2) / (2 * sigma**2))
    g = g / g.sum()
    return np.outer(g, g).astype(np.float32)


def ssim_tensor(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Mean SSIM of two (B, H, W, C) float32 batches in 0-255 (the
    constants assume [0, 1]; kept): an 11 x 11, sigma 1.5 Gaussian as a
    depthwise conv with 5 zeros of padding, in float32 (TF32 off)."""
    window_size, sigma = 11, 1.5
    c = img1.shape[-1]
    k2d = torch.from_numpy(_gaussian_kernel(window_size, sigma))
    kernel = k2d.to(img1.device).expand(c, 1, window_size,
                                        window_size).contiguous()
    x1, x2 = (t.permute(0, 3, 1, 2) for t in (img1, img2))

    def blur(x):
        return F.conv2d(x, kernel, padding=window_size // 2, groups=c)

    with no_tf32():
        mu1, mu2 = blur(x1), blur(x2)
        mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
        s1 = blur(x1 * x1) - mu1_sq
        s2 = blur(x2 * x2) - mu2_sq
        s12 = blur(x1 * x2) - mu1_mu2
    C1, C2 = 0.01**2, 0.03**2
    num = (2 * mu1_mu2 + C1) * (2 * s12 + C2)
    den = (mu1_sq + mu2_sq + C1) * (s1 + s2 + C2)
    return torch.mean(num / den)


def rgb_batch(path: ImageLike, device: torch.device) -> torch.Tensor:
    """An image as a (1, H, W, 3) float32 RGB 0-255 tensor on ``device``
    (cv2's BGR reversed, as the reference's ``imread(p)[:, :, ::-1]``)."""
    a = np.ascontiguousarray(_load_rgb(path), dtype=np.float32)
    return torch.from_numpy(a)[None].to(device)


def ssim(path0: ImageLike, path1: ImageLike, device="cuda") -> float:
    """Gaussian-window SSIM (eval.py:167-243) on ``device``."""
    dev = resolve_device(device)
    return float(ssim_tensor(rgb_batch(path0, dev), rgb_batch(path1, dev)))


def _gram(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, C, C) / (H*W) (eval.py:70-75)."""
    b, h, w, c = x.shape
    f = x.reshape(b, h * w, c)
    with no_tf32():
        return torch.einsum("bnc,bnd->bcd", f, f) / (h * w)


@torch.inference_mode()
def gram_loss(path0: ImageLike, path1: ImageLike, vgg: Callable,
              device="cuda") -> float:
    """Mean MSE of VGG19 gram matrices over the 5 tap layers
    (eval.py:78-108).

    ``vgg``: (B, H, W, 3) 0-255 -> {"relu1_1", ...} features, e.g. the
    port's ``models.vgg19.VGG19Features`` on ``device``.
    """
    dev = resolve_device(device)
    fa = vgg(rgb_batch(path0, dev))
    fb = vgg(rgb_batch(path1, dev))
    loss = 0.0
    for i in (1, 2, 3, 4, 5):
        ga = _gram(fa[f"relu{i}_1"])
        gb = _gram(fb[f"relu{i}_1"])
        loss += float(torch.mean(torch.square(ga - gb)))
    return loss / 5.0


def load_vgg19_features(path: str, device="cuda"):
    """``models.vgg19.VGG19Features`` on ``device`` holding a torchvision
    VGG19 ``.pth`` (``interop.load_vgg19``), in eval mode."""
    from ..interop import load_vgg19
    from ..models.vgg19 import VGG19Features

    vgg = VGG19Features()
    vgg.load_state_dict(load_vgg19(path), strict=True)
    return vgg.to(resolve_device(device)).eval()
