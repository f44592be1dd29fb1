"""Single-Image FID (mhada_tpu/evals/sifid.py:1-89; reference
SIFID/sifid_score.py).

Activations are taken per spatial location (sifid_score.py:119: (B, C, H,
W) -> (B*H*W, C)) on ``device`` and moved to the host as float64; mean and
covariance there, then the Fréchet distance with the sqrtm stabilisation
(sifid_score.py:128-205).  Images load with PIL as RGB in (0, 1).
"""

import numpy as np
import torch

from ..config import resolve_device
from .inception import BLOCK_INDEX_BY_DIM, InceptionV3Features, load_inception


def calculate_frechet_distance(mu1, sigma1, mu2, sigma2, eps=1e-6) -> float:
    """Fréchet distance between two Gaussians (sifid_score.py:128-182).

    ``scipy.linalg.sqrtm`` is called without ``disp``, which SciPy 1.17
    deprecates; it returns the same matrix."""
    from scipy import linalg

    mu1 = np.atleast_1d(mu1)
    mu2 = np.atleast_1d(mu2)
    sigma1 = np.atleast_2d(sigma1)
    sigma2 = np.atleast_2d(sigma2)
    diff = mu1 - mu2
    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            m = np.max(np.abs(covmean.imag))
            raise ValueError(f"Imaginary component {m}")
        covmean = covmean.real
    tr_covmean = np.trace(covmean)
    return float(
        diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) - 2 * tr_covmean
    )


def load_01(path: str) -> np.ndarray:
    from PIL import Image

    img = Image.open(path).convert("RGB")
    return np.asarray(img, dtype=np.float32) / 255.0


class SIFID:
    """Reusable SIFID evaluator: ``model`` is an InceptionV3Features that
    reaches the tap of ``dims`` (64 / 192 / 768 / 2048), on its device."""

    def __init__(self, model: InceptionV3Features, dims: int = 2048):
        self.block = BLOCK_INDEX_BY_DIM[dims]
        if model.last_block < self.block:
            raise ValueError(f"the model stops at tap {model.last_block}; "
                             f"{dims} dims need tap {self.block}")
        self.model = model
        self.device = next(model.parameters()).device

    def activations(self, img01: np.ndarray) -> np.ndarray:
        """(H, W, 3) in (0, 1) -> (H'*W', C) per-location activations."""
        x = torch.from_numpy(np.ascontiguousarray(img01, np.float32))
        feats = self.model(x[None].to(self.device), self.block)[self.block]
        f = feats[0].cpu().numpy().astype(np.float64)
        return f.reshape(-1, f.shape[-1])

    def statistics(self, img01: np.ndarray):
        act = self.activations(img01)
        return act.mean(axis=0), np.cov(act, rowvar=False)

    def __call__(self, path0: str, path1: str) -> float:
        m1, s1 = self.statistics(load_01(path0))
        m2, s2 = self.statistics(load_01(path1))
        return calculate_frechet_distance(m1, s1, m2, s2)


def sifid_from_paths(path0: str, path1: str, inception_pth: str,
                     dims: int = 2048, device="cuda") -> float:
    """Convenience wrapper (reference eval.py:246-276)."""
    model = load_inception(inception_pth, BLOCK_INDEX_BY_DIM[dims],
                           resolve_device(device))
    return SIFID(model, dims)(path0, path1)
