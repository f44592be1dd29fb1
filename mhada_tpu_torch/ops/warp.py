"""Dense backward warping by optical flow (mhada_tpu/ops/warp.py:14-101;
reference utilities.py:100-151).

NHWC at the boundary, NCHW inside ``F.grid_sample(mode="bilinear",
padding_mode="zeros", align_corners=False)``, the reference's own op: each
of the four taps is masked on its own when it falls outside the image.

The grid is normalised by ``W - 1`` / ``H - 1`` and then sampled with
``align_corners=False``, as the reference does, so a sample lands half a
pixel away from an exact backward warp.  That is the reference's behaviour
and is kept.  The tap weights come from the float32 flow; a bfloat16 ``x``
is sampled in float32 and the result rounded to bfloat16, as the JAX
package computes its float32 weights against bfloat16 taps.
"""

import torch
import torch.nn.functional as F


def grid_sample(x: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Bilinear, zero-padded, ``align_corners=False`` sample.

    x: (B, H, W, C); grid: (B, Ho, Wo, 2) normalised coordinates, last dim
    (x, y).  -> (B, Ho, Wo, C) in x's dtype.
    """
    out = F.grid_sample(x.permute(0, 3, 1, 2).float(), grid.float(),
                        mode="bilinear", padding_mode="zeros",
                        align_corners=False)
    return out.permute(0, 2, 3, 1).to(x.dtype)


def _base_grid(b: int, h: int, w: int, like: torch.Tensor) -> torch.Tensor:
    """Pixel-index mesh (B, H, W, 2), last dim (x, y), in ``like``'s dtype
    and device."""
    yy, xx = torch.meshgrid(
        torch.arange(h, dtype=like.dtype, device=like.device),
        torch.arange(w, dtype=like.dtype, device=like.device), indexing="ij")
    return torch.stack([xx, yy], dim=-1).expand(b, h, w, 2)


def _normalise(vgrid: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Pixel coordinates -> grid_sample's [-1, 1], by W - 1 and H - 1."""
    gx = 2.0 * vgrid[..., 0] / max(w - 1, 1) - 1.0
    gy = 2.0 * vgrid[..., 1] / max(h - 1, 1) - 1.0
    return torch.stack([gx, gy], dim=-1)


def warp(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Backward-warp ``x`` (B, H, W, C) by the pixel flow (B, H, W, 2), last
    dim (dx, dy)."""
    b, h, w, _ = x.shape
    vgrid = _base_grid(b, h, w, flow) + flow
    return grid_sample(x, _normalise(vgrid, h, w))


def flow_warp_mask(flow01: torch.Tensor, flow10: torch.Tensor,
                   threshold: float = 2.0) -> torch.Tensor:
    """Forward-backward consistency mask: warp (grid + flow01) by flow10
    and keep the pixels whose L1 round-trip error is below ``threshold``.

    flow01, flow10: (H, W, 2) pixel flows.  -> (H, W) mask in the flows'
    dtype."""
    h, w, _ = flow01.shape
    grid = _base_grid(1, h, w, flow01)
    target = grid + flow01[None]
    warped = grid_sample(target, _normalise(grid + flow10[None], h, w))
    err = (warped[0] - grid[0]).abs().sum(dim=-1)
    return (err < threshold).to(flow01.dtype)
