"""Host-side (numpy) flow utilities for the dataset workers (the port's own
copy of mhada_tpu/data/flow_np.py): the math of ``ops.warp`` and
``ops.resize`` in the loader's worker processes, where the reference
computes its masks too (datasets.py:201-231).
"""

from functools import lru_cache

import numpy as np


@lru_cache(maxsize=256)
def _resize_matrix_np(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) bilinear interpolation matrix, torch's
    half-pixel rule without anti-aliasing (a copy of
    mhada_tpu/ops/resize.py:24-46, a module that imports jax).

    src = max(0, (i + 0.5) * (in / out) - 0.5); taps floor(src) and
    floor(src) + 1, clamped to the valid range.  Read-only: every caller
    gets the same array.
    """
    if in_size == out_size:
        return np.eye(in_size, dtype=np.float32)
    scale = in_size / out_size
    i = np.arange(out_size, dtype=np.float64)
    src = np.maximum((i + 0.5) * scale - 0.5, 0.0)
    i0 = np.minimum(np.floor(src).astype(np.int64), in_size - 1)
    i1 = np.minimum(i0 + 1, in_size - 1)
    w1 = src - i0
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    mat[np.arange(out_size), i0] += 1.0 - w1
    mat[np.arange(out_size), i1] += w1
    return mat.astype(np.float32)


def resize_bilinear_np(x: np.ndarray, out_hw) -> np.ndarray:
    """(H, W[, C]) torch-semantics bilinear resize via cached matrices."""
    h, w = x.shape[:2]
    oh, ow = out_hw
    rh = _resize_matrix_np(h, oh)
    rw = _resize_matrix_np(w, ow)
    y = np.tensordot(rh, x, axes=(1, 0))  # (oh, W, C)
    y = np.tensordot(y, rw, axes=(1, 1))  # (oh[, C], ow)
    if x.ndim == 3:
        return np.ascontiguousarray(np.transpose(y, (0, 2, 1)))
    return y


def resize_flow_np(flow: np.ndarray, out_hw) -> np.ndarray:
    """Resize (H, W, 2) flow and rescale vectors by the size ratio
    (reference datasets.py:205-221)."""
    h, w = flow.shape[:2]
    oh, ow = out_hw
    out = resize_bilinear_np(flow.astype(np.float32), (oh, ow))
    out[..., 0] *= ow / w
    out[..., 1] *= oh / h
    return out


def grid_sample_np(x: np.ndarray, px: np.ndarray,
                   py: np.ndarray) -> np.ndarray:
    """Bilinear zero-padding sample of (H, W, C) at pixel coords (px, py)."""
    H, W = x.shape[:2]
    x0 = np.floor(px)
    y0 = np.floor(py)
    wx1 = px - x0
    wy1 = py - y0

    out = np.zeros(px.shape + (x.shape[2],), np.float32)
    for dy, wy in ((0, 1.0 - wy1), (1, wy1)):
        for dx, wx in ((0, 1.0 - wx1), (1, wx1)):
            xi = x0 + dx
            yi = y0 + dy
            valid = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
            xc = np.clip(xi, 0, W - 1).astype(np.int64)
            yc = np.clip(yi, 0, H - 1).astype(np.int64)
            out += x[yc, xc] * (wx * wy * valid)[..., None]
    return out


def warp_np(x: np.ndarray, flow: np.ndarray) -> np.ndarray:
    """Backward-warp (H, W, C) by (H, W, 2) pixel flow, torch grid_sample
    align_corners=False semantics (reference utilities.py:100-118)."""
    H, W = x.shape[:2]
    gx, gy = np.meshgrid(np.arange(W, dtype=np.float32),
                         np.arange(H, dtype=np.float32))
    vx = gx + flow[..., 0]
    vy = gy + flow[..., 1]
    # normalise then unnormalise reproduces grid_sample's exact coordinate
    # arithmetic (matters only at the ±0.5px boundary).
    nx = 2.0 * vx / max(W - 1, 1) - 1.0
    ny = 2.0 * vy / max(H - 1, 1) - 1.0
    px = ((nx + 1.0) * W - 1.0) * 0.5
    py = ((ny + 1.0) * H - 1.0) * 0.5
    return grid_sample_np(x, px, py)


def flow_warp_mask_np(
    flow01: np.ndarray, flow10: np.ndarray, threshold: float = 2.0
) -> np.ndarray:
    """Forward-backward consistency mask (reference utilities.py:121-151)."""
    H, W = flow01.shape[:2]
    gx, gy = np.meshgrid(np.arange(W, dtype=np.float32),
                         np.arange(H, dtype=np.float32))
    grid = np.stack([gx, gy], axis=-1)
    target = grid + flow01
    vx = gx + flow10[..., 0]
    vy = gy + flow10[..., 1]
    nx = 2.0 * vx / max(W - 1, 1) - 1.0
    ny = 2.0 * vy / max(H - 1, 1) - 1.0
    px = ((nx + 1.0) * W - 1.0) * 0.5
    py = ((ny + 1.0) * H - 1.0) * 0.5
    warped = grid_sample_np(target, px, py)
    err = np.abs(warped - grid).sum(axis=-1)
    return (err < threshold).astype(np.float32)
