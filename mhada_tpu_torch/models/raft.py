"""RAFT-large optical flow, torchvision's ``raft_large`` architecture
(mhada_tpu/models/raft.py:1-451).

The reference computes flow with torchvision ``raft_large`` inside the
Sintel dataset (reference datasets.py:98-121) and the Videvo temporal eval
(reference exps_video.py:45-46), taking the last of 12 recurrent updates.

- The modules are keyed as torchvision's, so a ``raft_large`` state_dict
  loads with ``strict=True`` (``load_raft``); the layout is NHWC, every conv
  through ``ops.pad_conv.conv2d`` (TF32 off).
- The all-pairs correlation is one float32 ``torch.matmul`` of the two
  feature maps over sqrt(C), average-pooled 2 x 2 on the *second* image's
  axes (floor mode) into 4 levels (raft.py:130-151).  The lookup is
  ``F.grid_sample(align_corners=True, padding_mode="zeros")`` around each
  point, radius 4, as torchvision's; the JAX package's gather matches those
  semantics (raft.py:154-211).
- The 12 updates run as a plain loop; the convex 8x upsampling runs on the
  last one, whose flow is returned.

Inputs are (B, H, W, 3) in [-1, 1] (the reference's raftTransforms domain,
utilities.py:19-26), H and W multiples of 8; the output is pixel flow
(B, H, W, 2), last axis (dx, dy).  The flow runs one pair at a time in the
evals: the level-0 volume holds (HW / 64)^2 floats.
"""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import resolve_device
from ..ops.instance_norm import instance_norm_tokens
from ..ops.pad_conv import conv2d, no_tf32

HIDDEN_DIM = 128
NUM_LEVELS = 4
RADIUS = 4
UPSAMPLE = 8
# H / 8 halved three times must stay >= 2: grid_sample's align_corners
# normalisation divides by (size - 1), so a 1-pixel level is degenerate
# (NaN) in torchvision as well.
MIN_SIDE = 128


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def conv(x: torch.Tensor, m: nn.Conv2d) -> torch.Tensor:
    """An ``nn.Conv2d``'s weights applied to an NHWC tensor."""
    return conv2d(x, m.weight, m.bias, m.stride[0], m.padding)


class ConvNormAct(nn.Sequential):
    """torchvision Conv2dNormActivation as RAFT builds it: conv (with bias)
    -> BatchNorm2d (eval mode) | InstanceNorm2d (affine-free, stat-free) |
    nothing -> ReLU; eps 1e-5.  Keys ``0.*`` (conv) and ``1.*`` (norm)."""

    def __init__(self, cin, cout, kernel, stride=1, norm=None, act=True):
        k = _pair(kernel)
        layers = [nn.Conv2d(cin, cout, k, stride,
                            tuple((n - 1) // 2 for n in k))]
        if norm == "batch":
            layers.append(nn.BatchNorm2d(cout))
        elif norm == "instance":
            layers.append(nn.InstanceNorm2d(cout))
        if act:
            layers.append(nn.ReLU())
        super().__init__(*layers)

    def forward(self, x):
        for m in self:
            if isinstance(m, nn.Conv2d):
                x = conv(x, m)
            elif isinstance(m, nn.BatchNorm2d):
                x = (x - m.running_mean) * torch.rsqrt(m.running_var + m.eps) \
                    * m.weight + m.bias
            elif isinstance(m, nn.InstanceNorm2d):
                b, h, w, c = x.shape
                x = instance_norm_tokens(x.reshape(b, h * w, c),
                                         m.eps).reshape(b, h, w, c)
            else:
                x = torch.relu(x)
        return x


class ResidualBlock(nn.Module):
    """Two 3 x 3 ConvNormActs and the residual, projected when strided."""

    def __init__(self, cin, cout, norm, stride=1):
        super().__init__()
        self.convnormrelu1 = ConvNormAct(cin, cout, 3, stride, norm)
        self.convnormrelu2 = ConvNormAct(cout, cout, 3, 1, norm)
        self.downsample = (ConvNormAct(cin, cout, 1, stride, norm, act=False)
                           if stride != 1 else None)

    def forward(self, x):
        y = self.convnormrelu2(self.convnormrelu1(x))
        if self.downsample is not None:
            x = self.downsample(x)
        return torch.relu(x + y)


class FeatureEncoder(nn.Module):
    """The feature (instance norm) or context (batch norm) encoder, stride
    8, layers (64, 64, 96, 128, 256)."""

    def __init__(self, norm):
        super().__init__()
        self.convnormrelu = ConvNormAct(3, 64, 7, 2, norm)
        self.layer1 = nn.Sequential(ResidualBlock(64, 64, norm),
                                    ResidualBlock(64, 64, norm))
        self.layer2 = nn.Sequential(ResidualBlock(64, 96, norm, 2),
                                    ResidualBlock(96, 96, norm))
        self.layer3 = nn.Sequential(ResidualBlock(96, 128, norm, 2),
                                    ResidualBlock(128, 128, norm))
        self.conv = nn.Conv2d(128, 256, 1)

    def forward(self, x):
        x = self.layer3(self.layer2(self.layer1(self.convnormrelu(x))))
        return conv(x, self.conv)


def build_corr_pyramid(fmap1: torch.Tensor, fmap2: torch.Tensor,
                       num_levels: int = NUM_LEVELS) -> list[torch.Tensor]:
    """(B, h, w, C) feature maps -> the levels of the all-pairs correlation
    as (B*h*w, 1, h_l, w_l), level 0 at (h, w)."""
    b, h, w, c = fmap1.shape
    with no_tf32():
        corr = torch.matmul(fmap1.reshape(b, h * w, c),
                            fmap2.reshape(b, h * w, c).transpose(1, 2))
    corr = (corr / math.sqrt(c)).reshape(b * h * w, 1, h, w)
    pyramid = [corr]
    for _ in range(num_levels - 1):
        corr = F.avg_pool2d(corr, 2, stride=2)
        pyramid.append(corr)
    return pyramid


def lookup_corr(pyramid: list[torch.Tensor], coords: torch.Tensor,
                radius: int = RADIUS) -> torch.Tensor:
    """The pyramid sampled around ``coords`` (B, h, w, 2), absolute (x, y)
    -> (B, h, w, levels * (2r + 1)^2): level-major, then the x offset
    (outer) by the y offset (inner), as torchvision's index_pyramid."""
    b, h, w, _ = coords.shape
    side = 2 * radius + 1
    d = torch.linspace(-radius, radius, side, device=coords.device)
    delta = torch.stack(torch.meshgrid(d, d, indexing="ij"), dim=-1)
    centroids = coords.reshape(b * h * w, 1, 1, 2)
    out = []
    for corr in pyramid:
        hl, wl = corr.shape[-2:]
        grid = centroids + delta
        xg, yg = grid.split([1, 1], dim=-1)
        grid = torch.cat([2 * xg / (wl - 1) - 1, 2 * yg / (hl - 1) - 1],
                         dim=-1)
        out.append(F.grid_sample(corr, grid, mode="bilinear",
                                 padding_mode="zeros",
                                 align_corners=True).reshape(b, h, w, -1))
        centroids = centroids / 2
    return torch.cat(out, dim=-1)


class MotionEncoder(nn.Module):
    """corr layers (256, 192), flow layers (128, 64), out 126 + the flow."""

    def __init__(self, in_corr=NUM_LEVELS * (2 * RADIUS + 1) ** 2):
        super().__init__()
        self.convcorr1 = ConvNormAct(in_corr, 256, 1)
        self.convcorr2 = ConvNormAct(256, 192, 3)
        self.convflow1 = ConvNormAct(2, 128, 7)
        self.convflow2 = ConvNormAct(128, 64, 3)
        self.conv = ConvNormAct(192 + 64, 128 - 2, 3)

    def forward(self, flow, corr):
        c = self.convcorr2(self.convcorr1(corr))
        f = self.convflow2(self.convflow1(flow))
        return torch.cat([self.conv(torch.cat([c, f], dim=-1)), flow],
                         dim=-1)


class ConvGRU(nn.Module):
    """Separable-kernel conv GRU cell."""

    def __init__(self, input_size, hidden_size, kernel, padding):
        super().__init__()
        n = hidden_size + input_size
        self.convz = nn.Conv2d(n, hidden_size, kernel, padding=padding)
        self.convr = nn.Conv2d(n, hidden_size, kernel, padding=padding)
        self.convq = nn.Conv2d(n, hidden_size, kernel, padding=padding)

    def forward(self, h, x):
        hx = torch.cat([h, x], dim=-1)
        z = torch.sigmoid(conv(hx, self.convz))
        r = torch.sigmoid(conv(hx, self.convr))
        q = torch.tanh(conv(torch.cat([r * h, x], dim=-1), self.convq))
        return (1 - z) * h + z * q


class RecurrentBlock(nn.Module):
    def __init__(self, input_size=256, hidden_size=HIDDEN_DIM):
        super().__init__()
        self.convgru1 = ConvGRU(input_size, hidden_size, (1, 5), (0, 2))
        self.convgru2 = ConvGRU(input_size, hidden_size, (5, 1), (2, 0))

    def forward(self, h, x):
        return self.convgru2(self.convgru1(h, x), x)


class FlowHead(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(HIDDEN_DIM, 256, 3, padding=1)
        self.conv2 = nn.Conv2d(256, 2, 3, padding=1)

    def forward(self, h):
        return conv(torch.relu(conv(h, self.conv1)), self.conv2)


class UpdateBlock(nn.Module):
    def __init__(self):
        super().__init__()
        self.motion_encoder = MotionEncoder()
        self.recurrent_block = RecurrentBlock()
        self.flow_head = FlowHead()

    def forward(self, hidden, context, corr, flow):
        x = torch.cat([context, self.motion_encoder(flow, corr)], dim=-1)
        hidden = self.recurrent_block(hidden, x)
        return hidden, self.flow_head(hidden)


class MaskPredictor(nn.Module):
    def __init__(self):
        super().__init__()
        self.convrelu = ConvNormAct(HIDDEN_DIM, 256, 3)
        self.conv = nn.Conv2d(256, 9 * UPSAMPLE * UPSAMPLE, 1)

    def forward(self, h):
        return 0.25 * conv(self.convrelu(h), self.conv)


def upsample_flow(flow: torch.Tensor, up_mask: torch.Tensor) -> torch.Tensor:
    """Convex 8x upsampling: (B, h, w, 2) flow and (B, h, w, 9*64) mask ->
    (B, 8h, 8w, 2).  The mask's channels are (neighbour, u, v) row-major,
    torch's (B, 9*64, h, w) channel order; the neighbours are the 3 x 3
    zero-padded window in (dy, dx) row-major order (F.unfold's)."""
    b, h, w, _ = flow.shape
    f = UPSAMPLE
    mask = torch.softmax(up_mask.reshape(b, h, w, 9, f, f), dim=3)
    fl = F.pad(flow * f, (0, 0, 1, 1, 1, 1))
    patches = torch.stack([fl[:, dy:dy + h, dx:dx + w] for dy in range(3)
                           for dx in range(3)], dim=3)   # (B, h, w, 9, 2)
    up = torch.einsum("bhwnuv,bhwnc->bhwuvc", mask, patches)
    return up.permute(0, 1, 3, 2, 4, 5).reshape(b, h * f, w * f, 2)


def coords_grid(b, h, w, device) -> torch.Tensor:
    """(B, h, w, 2) pixel coordinates (x, y)."""
    gy, gx = torch.meshgrid(torch.arange(h, device=device, dtype=torch.float32),
                            torch.arange(w, device=device, dtype=torch.float32),
                            indexing="ij")
    return torch.stack([gx, gy], dim=-1).expand(b, h, w, 2)


class RAFT(nn.Module):
    """raft_large: ``forward(img1, img2, num_iters=12)`` on (B, H, W, 3) in
    [-1, 1] -> the last update's (B, H, W, 2) pixel flow."""

    def __init__(self):
        super().__init__()
        self.feature_encoder = FeatureEncoder("instance")
        self.context_encoder = FeatureEncoder("batch")
        self.update_block = UpdateBlock()
        self.mask_predictor = MaskPredictor()

    @torch.inference_mode()
    def forward(self, img1: torch.Tensor, img2: torch.Tensor,
                num_iters: int = 12) -> torch.Tensor:
        b, h, w, _ = img1.shape
        if h % UPSAMPLE or w % UPSAMPLE or min(h, w) < MIN_SIDE:
            raise ValueError(f"RAFT: H and W must be multiples of {UPSAMPLE} "
                             f"and at least {MIN_SIDE}, got {(h, w)}")
        fmap1, fmap2 = self.feature_encoder(
            torch.cat([img1, img2], dim=0)).chunk(2, dim=0)
        pyramid = build_corr_pyramid(fmap1, fmap2)
        ctx = self.context_encoder(img1)
        hidden = torch.tanh(ctx[..., :HIDDEN_DIM])
        context = torch.relu(ctx[..., HIDDEN_DIM:])
        coords0 = coords_grid(b, h // UPSAMPLE, w // UPSAMPLE, img1.device)
        coords1 = coords0
        for _ in range(num_iters):
            corr = lookup_corr(pyramid, coords1)
            hidden, delta = self.update_block(hidden, context, corr,
                                              coords1 - coords0)
            coords1 = coords1 + delta
        return upsample_flow(coords1 - coords0, self.mask_predictor(hidden))


def load_raft(path: str, device="cuda") -> RAFT:
    """A torchvision ``raft_large`` ``.pth`` -> RAFT on ``device``, loaded
    strictly, in eval mode."""
    model = RAFT()
    sd = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(sd, strict=True)
    return model.to(resolve_device(device)).eval()
