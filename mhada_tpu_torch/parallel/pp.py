"""Pipeline parallelism over the stylization chain, GPipe order
(mhada_tpu/parallel/pp.py:66-183).

The AdaFormer's 2 num_layers MHAda blocks all map (B, N, C) tokens to
(B, N, C) tokens, so they pipeline: rank s runs blocks [s P, (s + 1) P),
P = 2 num_layers / S.  Rank 0 also encodes each microbatch (vit_c) and the
last rank also decodes it; nothing else of the ViT or the decoder runs on
any rank.  A microbatch travels as the bundle (num_layers + 1, B, N, C) =
[fc_0 .. fc_{L-1}, fcs], which moves one hop a step by the ring shift: M
microbatches take M + S - 1 steps.  Block j queries fc[j // 2] when j is
even and the running fcs when it is odd (reference adaDecoder.py:262-265).

The JAX package runs this as one SPMD program (stage weights stacked on an
(S,) axis, ``lax.cond`` stage guards, ``lax.scan`` over the steps); here
each rank simply runs its own part, and holds only the modules of that
part.
"""

import torch

from .collectives import Group


def stage_blocks(n_blocks: int, n_stages: int, stage: int) -> range:
    """The MHAda blocks of ``stage``; ``n_blocks`` must divide by
    ``n_stages``."""
    if n_blocks % n_stages:
        raise ValueError(f"{n_blocks} MHAda blocks do not divide over "
                         f"{n_stages} stages")
    per = n_blocks // n_stages
    return range(stage * per, (stage + 1) * per)


def make_pp_stylize_fn(models: dict, group: Group,
                       dtype: torch.dtype = torch.float32):
    """``fn(contents, style_kv) -> cs``: M frames (M, B, H, W, 3) through the
    pipeline over ``group``'s ranks as stages.

    Every rank passes the same ``contents`` (only rank 0 reads its values)
    and ``style_kv`` (each rank uses its blocks' pairs).  The last rank
    returns the frames (M, B, H', W', 3), float32 clamped to [0, 255], in
    microbatch order; the other ranks return None."""
    ada = models["adaFormer"]
    n_layers, s, n_stages = ada.num_layers, group.rank, group.size
    blocks = {j: getattr(ada, f"ada{j}")
              for j in stage_blocks(2 * n_layers, n_stages, s)}
    vit_c = models["vit_c"] if s == 0 else None
    decoder = ada.decoder if s == n_stages - 1 else None
    patch = models["vit_c"].patch_embedding.proj.weight.shape[-1]
    channels = models["vit_c"].hidden_dim

    def stage(act: torch.Tensor, style_kv: list) -> torch.Tensor:
        fcs = act[n_layers]
        for j, blk in blocks.items():
            q = act[j // 2] if j % 2 == 0 else fcs
            fcs = blk(q, None, fcs, style_kv[j])
        act[n_layers] = fcs   # act is this step's own tensor
        return act

    @torch.inference_mode()
    def fn(contents: torch.Tensor, style_kv: list):
        m, b, h, w, _ = contents.shape
        hh, ww = h // patch, w // patch
        act = torch.zeros((n_layers + 1, b, hh * ww, channels), dtype=dtype,
                          device=contents.device)
        out = []
        for t in range(m + n_stages - 1):
            if s == 0 and t < m:   # encode microbatch t
                fc = vit_c(contents[t].to(dtype))
                act = torch.stack([f.reshape(b, hh * ww, channels)
                                   for f in fc + fc[:1]])
            if 0 <= t - s < m:     # microbatch t - s is here
                act = stage(act, style_kv)
                if decoder is not None:
                    cs = decoder(act[n_layers].reshape(b, hh, ww, channels))
                    out.append(cs.float().clamp(0, 255))
            if t < m + n_stages - 2:
                act = group.ring_shift(act)
        return torch.stack(out) if decoder is not None else None

    return fn
