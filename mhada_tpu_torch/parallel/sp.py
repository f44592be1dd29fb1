"""Sequence (spatial) parallelism: one frame row-sharded over the ranks
(mhada_tpu/parallel/sp.py:37-150).

Each rank holds the whole model and the frame's rows [r H/n, (r + 1) H/n):

- patch embedding, LayerNorms, MLPs and projections are token-local (the
  patch conv's kernel equals its stride, so a block of 8-pixel rows never
  straddles a patch); K2 stays on this path;
- the position embedding is regridded at the global grid and sliced
  (``models.vit.PosEmbedding``);
- the ViT attention gathers keys and values over the ranks and runs this
  rank's queries against them through K1's cross form
  (``models.layers.MultiHeadSelfAttention``);
- the MHAda blocks run on the replicated style K/V; only their instance
  norm statistics are reduced over the ranks, and K3 takes them as they are
  (``models.adaformer.AdaAttnMultiHead``);
- the decoder: the small pre-decoder map is gathered, and each rank decodes
  a slab of its rows plus ``required_decode_margin()`` rows each side
  (clamped at the frame's edges), then keeps its own 8 h_loc output rows:
  the convolutional halo is recomputed instead of exchanged.

The result equals the single-rank frame up to summation order.
"""

import torch

from .collectives import Group

# The decoder's stages (models/decoder.py), each the ops it applies in
# forward order: "conv" is a reflect-padded 3x3, "up" a 2x bilinear
# upsample (align_corners=False).
_DECODER_CHAIN = (
    ("conv", "up"),   # up1   1x -> 2x
    ("conv",),        # c1    2x
    ("conv",),        # c2    2x
    ("conv",),        # c3    2x
    ("conv", "up"),   # up2   2x -> 4x
    ("conv",),        # c4    4x
    ("conv", "up"),   # up3   4x -> 8x
    ("conv",),        # c5    8x
    ("conv",),        # c6    8x
)


def required_decode_margin() -> int:
    """The decoder's halo in input (fcs) rows, walked back from the kept
    output rows: a 3x3 conv loses one valid row a side (its reflect padding
    at a slab's border reflects interior rows); a 2x bilinear upsample maps
    output row y to source rows floor(y/2 - 1/4) and the next, so H extra
    fine rows need floor(H/2) + 1 coarse ones.  -> 5."""
    h = 0
    for stage in reversed(_DECODER_CHAIN):
        for op in reversed(stage):
            h = (h // 2 + 1) if op == "up" else h + 1
    return h


def shard_rows(group: Group, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` (equal blocks, in rank
    order)."""
    if x.shape[dim] % group.size:
        raise ValueError(f"{x.shape[dim]} rows do not divide over "
                         f"{group.size} ranks")
    n = x.shape[dim] // group.size
    return x.narrow(dim, group.rank * n, n).contiguous()


def make_sp_stylize_fn(models: dict, group: Group,
                       dtype: torch.dtype = torch.float32,
                       decode_margin: int | None = None):
    """``fn(content, style_kv) -> cs``: the streaming forward of one frame
    batch with its rows sharded over ``group``.

    ``content`` (B, H, W, 3) in [0, 255] is the whole frame on every rank
    (each keeps its H / n rows); ``style_kv`` from
    ``infer.image.precompute_style_kv``, the same on every rank.  H / 8
    must divide by the number of ranks.  Returns the whole frame, float32
    clamped to [0, 255], on every rank.  ``decode_margin`` overrides
    ``required_decode_margin()``: a test hook, smaller margins give
    slab-boundary errors."""
    margin = required_decode_margin() if decode_margin is None \
        else decode_margin
    vit_c, ada = models["vit_c"], models["adaFormer"]
    patch = vit_c.patch_embedding.proj.weight.shape[-1]

    @torch.inference_mode()
    def fn(content: torch.Tensor, style_kv: list) -> torch.Tensor:
        if content.shape[1] % (patch * group.size):
            raise ValueError(f"H = {content.shape[1]}: H / {patch} must "
                             f"divide by {group.size} ranks")
        fc = vit_c(shard_rows(group, content).to(dtype), group)
        fcs = ada.transform(fc, None, style_kv, group)
        h_loc = fcs.shape[1]
        fcs_all = group.gather_rows(fcs, dim=1)
        h_glob = fcs_all.shape[1]
        rows = min(h_loc + 2 * margin, h_glob)
        start = min(max(group.rank * h_loc - margin, 0), h_glob - rows)
        cs = ada.decoder(fcs_all[:, start:start + rows].contiguous())
        off = (group.rank * h_loc - start) * 8   # the decoder upsamples 8x
        cs = cs[:, off:off + 8 * h_loc].float().clamp(0, 255)
        return group.gather_rows(cs, dim=1)

    return fn
