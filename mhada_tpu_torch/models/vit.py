"""ViT feature-pyramid encoders (mhada_tpu/models/vit.py:28-61, 106-211).

Patch embedding, learned 32 x 32 position grid regridded bilinearly to the
token grid (content encoder only), pre-LN encoder blocks, and the output of
every block as an NHWC feature map at H/8 x W/8 (reference
network/vit.py:45-169).

``attn_mode`` (mhada_tpu/models/vit.py:7-13): ``"spatial"`` attends over
tokens through the kernels; ``"batch_coupled"`` reproduces the reference's
attention over the image batch, through the plain path as in the JAX
package (vit.py:127,138-141).
"""

import torch
import torch.nn as nn

from .layers import Conv2d, LayerNorm, Linear, MultiHeadSelfAttention
from ..ops.ln_matmul import ln_matmul
from ..ops.resize import resize_bilinear

ATTN_MODES = ("spatial", "batch_coupled")


class PatchEmbedding(nn.Module):
    """Conv with kernel = stride = patch, flattened to (B, h*w, C) tokens."""

    def __init__(self, patch_size: int, hidden_dim: int):
        super().__init__()
        self.proj = Conv2d(3, hidden_dim, patch_size, stride=patch_size)

    def forward(self, x: torch.Tensor):
        y = self.proj(x)
        b, h, w, c = y.shape
        return y.reshape(b, h * w, c), (h, w)


class PosEmbedding(nn.Module):
    """Learned (1, 32, 32, C) grid (NHWC, as in the JAX tree), regridded to
    the token grid with torch bilinear sampling."""

    def __init__(self, embed_dim: int):
        super().__init__()
        self.pos_embed = nn.Parameter(torch.empty(1, 32, 32, embed_dim))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.pos_embed.normal_(0.0, 0.02, generator=generator)

    def forward(self, grid_hw) -> torch.Tensor:
        pos = self.pos_embed
        h, w = grid_hw
        if (h, w) != tuple(pos.shape[1:3]):
            pos = resize_bilinear(pos, (h, w))
        return pos.reshape(1, h * w, pos.shape[-1])


class EncoderBlock(nn.Module):
    """Pre-LN transformer block (reference vit.py:45-64).

    In eval mode ln1 -> qkv and ln2 -> fc1 go through the fused LN +
    matmul (K2) and the attention through K1; in training mode the LNs run
    unfused and the attention through K6.  ``batch_coupled`` takes the
    plain ln1 and attention either way, as the JAX package does.
    """

    def __init__(self, hidden_dim: int, num_heads: int, mlp_dim: int,
                 attn_mode: str = "spatial", backend: str = "auto"):
        super().__init__()
        if attn_mode not in ATTN_MODES:
            raise ValueError(f"unknown attn_mode: {attn_mode}")
        self.attn_mode = attn_mode
        self.backend = backend
        self.ln1 = LayerNorm(hidden_dim)
        self.attention = MultiHeadSelfAttention(
            hidden_dim, num_heads,
            backend=backend if attn_mode == "spatial" else "plain")
        self.ln2 = LayerNorm(hidden_dim)
        self.mlp_fc1 = Linear(hidden_dim, mlp_dim)
        self.mlp_fc2 = Linear(mlp_dim, hidden_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.attn_mode == "spatial":
            h = self.attention(x, ln=self.ln1)
        else:
            # sequence axis = image batch, batch axis = tokens
            h = self.attention(self.ln1(x).transpose(0, 1)).transpose(0, 1)
        x = x + h
        if self.training:
            y = self.mlp_fc1(self.ln2(x))
        else:
            y = ln_matmul(x, self.ln2.weight, self.ln2.bias,
                          self.mlp_fc1.weight, self.mlp_fc1.bias,
                          self.ln2.eps, backend=self.backend)
        y = self.mlp_fc2(torch.relu(y))
        return x + y


class VisionTransformer(nn.Module):
    """The trained encoder (reference vit.py:120-169); returns every block's
    output as (B, H/p, W/p, C)."""

    def __init__(self, patch_size: int = 8, num_layers: int = 3,
                 num_heads: int = 8, hidden_dim: int = 512,
                 mlp_dim: int = 2048, pos_embedding: bool = True,
                 attn_mode: str = "spatial", backend: str = "auto"):
        super().__init__()
        self.num_layers = num_layers
        self.hidden_dim = hidden_dim
        self.patch_embedding = PatchEmbedding(patch_size, hidden_dim)
        self.pos_embedding = PosEmbedding(hidden_dim) if pos_embedding else None
        for i in range(num_layers):
            self.add_module(f"block{i}", EncoderBlock(
                hidden_dim, num_heads, mlp_dim, attn_mode, backend))

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        tokens, (h, w) = self.patch_embedding(x)
        if self.pos_embedding is not None:
            tokens = tokens + self.pos_embedding((h, w)).to(tokens.dtype)
        feats = []
        for i in range(self.num_layers):
            tokens = getattr(self, f"block{i}")(tokens)
            feats.append(tokens.reshape(-1, h, w, self.hidden_dim))
        return feats

