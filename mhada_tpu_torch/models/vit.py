"""ViT feature-pyramid encoders (mhada_tpu/models/vit.py:28-61, 106-211).

Patch embedding, learned 32 x 32 position grid regridded bilinearly to the
token grid (content encoder only), pre-LN encoder blocks, and the output of
every block as an NHWC feature map at H/8 x W/8 (reference
network/vit.py:45-169).

``attn_mode`` (mhada_tpu/models/vit.py:7-13): ``"spatial"`` attends over
tokens through the kernels; ``"batch_coupled"`` reproduces the reference's
attention over the image batch, through the plain path as in the JAX
package (vit.py:127,138-141).

The reference's unused variants (mhada_tpu/models/vit.py:64-104, 214-246):
``ConvFF``, ``EncoderBlockConvFF`` and ``VisionTransformerMultiScale``.
None of them sets ``use_pallas`` in the JAX package, so here they take the
plain attention by name (``backend="plain"``): the multi-scale encoder's
first stage has heads of 256 / 8 = 32, which the kernels do not take.
"""

import torch
import torch.nn as nn

from .decoder import ConvDepthwiseSeparable
from .layers import Conv2d, LayerNorm, Linear, MultiHeadSelfAttention
from ..ops.ln_matmul import ln_matmul
from ..ops.resize import resize_bilinear
from ..parallel import tp

ATTN_MODES = ("spatial", "batch_coupled")


class PatchEmbedding(nn.Module):
    """Conv with kernel = stride = patch, flattened to (B, h*w, C) tokens."""

    def __init__(self, patch_size: int, hidden_dim: int,
                 in_channels: int = 3):
        super().__init__()
        self.proj = Conv2d(in_channels, hidden_dim, patch_size,
                           stride=patch_size)

    def forward(self, x: torch.Tensor):
        y = self.proj(x)
        b, h, w, c = y.shape
        return y.reshape(b, h * w, c), (h, w)


class PosEmbedding(nn.Module):
    """Learned (1, 32, 32, C) grid (NHWC, as in the JAX tree), regridded to
    the token grid with torch bilinear sampling.

    ``group``: the grid's rows are sharded over its ranks in equal blocks
    (sequence parallelism): regrid at the global grid (h * ranks, w) and
    keep this rank's rows, as the JAX ``sp_axis`` branch does
    (mhada_tpu/models/vit.py:186-197)."""

    def __init__(self, embed_dim: int):
        super().__init__()
        self.pos_embed = nn.Parameter(torch.empty(1, 32, 32, embed_dim))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.pos_embed.normal_(0.0, 0.02, generator=generator)

    def forward(self, grid_hw, group=None) -> torch.Tensor:
        pos = self.pos_embed
        h, w = grid_hw
        n = 1 if group is None else group.size
        if (h * n, w) != tuple(pos.shape[1:3]):
            pos = resize_bilinear(pos, (h * n, w))
        if group is not None:
            pos = pos[:, group.rank * h:(group.rank + 1) * h]
        return pos.reshape(1, h * w, pos.shape[-1])


class ConvFF(nn.Module):
    """Conv feed-forward on the re-rasterised token grid: 1x1 ->
    depthwise-separable 3x3 -> 1x1 (reference vit.py:10-24)."""

    def __init__(self, hidden_dim: int, mlp_dim: int):
        super().__init__()
        self.conv_in = Conv2d(hidden_dim, mlp_dim, 1)
        self.conv_dw = ConvDepthwiseSeparable(mlp_dim, mlp_dim)
        self.conv_out = Conv2d(mlp_dim, hidden_dim, 1)

    def forward(self, x: torch.Tensor, hw) -> torch.Tensor:
        b, n, c = x.shape
        y = self.conv_in(x.reshape(b, *hw, c))
        y = self.conv_out(self.conv_dw(y))
        return y.reshape(b, n, c)


class EncoderBlockConvFF(nn.Module):
    """Encoder block whose MLP is a ConvFF (reference vit.py:27-42); plain
    attention in either ``attn_mode``."""

    def __init__(self, hidden_dim: int, num_heads: int, mlp_dim: int,
                 attn_mode: str = "spatial"):
        super().__init__()
        if attn_mode not in ATTN_MODES:
            raise ValueError(f"unknown attn_mode: {attn_mode}")
        self.attn_mode = attn_mode
        self.ln1 = LayerNorm(hidden_dim)
        self.attention = MultiHeadSelfAttention(hidden_dim, num_heads,
                                                backend="plain")
        self.ln2 = LayerNorm(hidden_dim)
        self.mlp = ConvFF(hidden_dim, mlp_dim)

    def forward(self, x: torch.Tensor, hw) -> torch.Tensor:
        h = self.ln1(x)
        if self.attn_mode == "spatial":
            h = self.attention(h)
        else:
            h = self.attention(h.transpose(0, 1)).transpose(0, 1)
        x = x + h
        return x + self.mlp(self.ln2(x), hw)


class EncoderBlock(nn.Module):
    """Pre-LN transformer block (reference vit.py:45-64).

    With ``fuse_ln`` (the build's resolved ``ModelConfig.fuse_ln``) ln1 ->
    qkv and ln2 -> fc1 go through the fused, differentiable LN + matmul
    (K2); without it the LNs run unfused.  The attention is K1 in eval mode
    and K6 in training mode.  ``batch_coupled`` takes the plain ln1 and
    attention either way, as the JAX package does (vit.py:132-140).
    ``group``: sequence parallelism, passed to the spatial attention (the
    batch-coupled one attends over the image batch, which stays whole).
    ``model_group`` (set by ``parallel.mesh.shard_params``): tensor
    parallelism, the attention split by heads and the MLP by hidden units
    (mlp_fc1 column-parallel, mlp_fc2 row-parallel with its bias added
    once); spatial attention only.
    """

    def __init__(self, hidden_dim: int, num_heads: int, mlp_dim: int,
                 attn_mode: str = "spatial", backend: str = "auto",
                 fuse_ln: bool = False):
        super().__init__()
        if attn_mode not in ATTN_MODES:
            raise ValueError(f"unknown attn_mode: {attn_mode}")
        self.attn_mode = attn_mode
        self.backend = backend
        self.fuse_ln = fuse_ln
        self.ln1 = LayerNorm(hidden_dim)
        self.attention = MultiHeadSelfAttention(
            hidden_dim, num_heads,
            backend=backend if attn_mode == "spatial" else "plain")
        self.ln2 = LayerNorm(hidden_dim)
        self.mlp_fc1 = Linear(hidden_dim, mlp_dim)
        self.mlp_fc2 = Linear(mlp_dim, hidden_dim)
        self.model_group = None

    def forward(self, x: torch.Tensor, group=None) -> torch.Tensor:
        model = self.model_group
        if self.attn_mode == "batch_coupled":
            if model is not None:
                raise ValueError("tensor parallelism takes the spatial "
                                 "attention only")
            # sequence axis = image batch, batch axis = tokens
            h = self.attention(self.ln1(x).transpose(0, 1)).transpose(0, 1)
        elif self.fuse_ln:
            h = self.attention(x, ln=self.ln1, group=group)
        else:
            h = self.attention(self.ln1(x), group=group)
        x = x + h
        if self.fuse_ln:
            xin, ln_w, ln_b = x, self.ln2.weight, self.ln2.bias
            if model is not None:
                xin = tp.copy_to_model(x, model)
                ln_w, ln_b = tp.ln_affine_to_model(model, ln_w, ln_b)
            y = ln_matmul(xin, ln_w, ln_b, self.mlp_fc1.weight,
                          self.mlp_fc1.bias, self.ln2.eps,
                          backend=self.backend)
        else:
            h = self.ln2(x)
            y = self.mlp_fc1(h if model is None
                             else tp.copy_to_model(h, model))
        if model is not None:
            return x + tp.row_parallel_linear(
                torch.relu(y), self.mlp_fc2.weight, self.mlp_fc2.bias, model)
        y = self.mlp_fc2(torch.relu(y))
        return x + y


class VisionTransformer(nn.Module):
    """The trained encoder (reference vit.py:120-169); returns every block's
    output as (B, H/p, W/p, C).  ``forward(x, group)``: x is this rank's
    block of rows of the frame (sequence parallelism, parallel/sp.py)."""

    def __init__(self, patch_size: int = 8, num_layers: int = 3,
                 num_heads: int = 8, hidden_dim: int = 512,
                 mlp_dim: int = 2048, pos_embedding: bool = True,
                 attn_mode: str = "spatial", backend: str = "auto",
                 fuse_ln: bool = False):
        super().__init__()
        self.num_layers = num_layers
        self.hidden_dim = hidden_dim
        self.patch_embedding = PatchEmbedding(patch_size, hidden_dim)
        self.pos_embedding = PosEmbedding(hidden_dim) if pos_embedding else None
        for i in range(num_layers):
            self.add_module(f"block{i}", EncoderBlock(
                hidden_dim, num_heads, mlp_dim, attn_mode, backend, fuse_ln))

    def forward(self, x: torch.Tensor, group=None) -> list[torch.Tensor]:
        tokens, (h, w) = self.patch_embedding(x)
        if self.pos_embedding is not None:
            tokens = tokens + self.pos_embedding((h, w), group).to(
                tokens.dtype)
        feats = []
        for i in range(self.num_layers):
            tokens = getattr(self, f"block{i}")(tokens, group)
            feats.append(tokens.reshape(-1, h, w, self.hidden_dim))
        return feats


class VisionTransformerMultiScale(nn.Module):
    """Pyramid variant with stride-2 re-patching between stages (reference
    vit.py:172-236); every stage on the plain attention."""

    def __init__(self, patch_size: int = 4, num_layers: int = 3,
                 num_heads: int = 8, hidden_dims=(256, 512, 512),
                 mlp_dims=(1024, 2048, 2048), pos_embedding: bool = True,
                 attn_mode: str = "spatial"):
        super().__init__()
        self.num_layers = num_layers
        self.hidden_dims = tuple(hidden_dims)
        self.patch_embedding = PatchEmbedding(patch_size, hidden_dims[0])
        self.pos_embedding = (PosEmbedding(hidden_dims[0]) if pos_embedding
                              else None)
        for i in range(num_layers):
            self.add_module(f"block{i}", EncoderBlock(
                hidden_dims[i], num_heads, mlp_dims[i], attn_mode,
                backend="plain"))
            if i < num_layers - 1:
                self.add_module(f"repatch{i}", PatchEmbedding(
                    2, hidden_dims[i + 1], hidden_dims[i]))

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        tokens, (h, w) = self.patch_embedding(x)
        if self.pos_embedding is not None:
            tokens = tokens + self.pos_embedding((h, w)).to(tokens.dtype)
        feats = []
        for i in range(self.num_layers):
            tokens = getattr(self, f"block{i}")(tokens)
            y = tokens.reshape(-1, h, w, self.hidden_dims[i])
            feats.append(y)
            if i < self.num_layers - 1:
                tokens, (h, w) = getattr(self, f"repatch{i}")(y)
        return feats
