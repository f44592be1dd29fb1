"""K3: the MHAda block core on cached style K/V with the instance norm and
the Q projection fused in (csrc/mhada_prologue.cu).

Port of mhada_tpu/ops/mhada_pallas.py::mhada_fused_prologue.  At bfloat16
the kernel runs on the tensor cores (the warp-specialised wgmma + TMA MHAda
tile of csrc/mhada_wgmma.cuh with the prologue, split over the keys by
``mhada_kernel.mhada_splits`` where the grid leaves block slots idle); at
float32 it computes in float32 on the CUDA cores (csrc/mhada_f32_tile.cuh).
Both raise on a tensor that is not 16-byte aligned.  The plain version
follows its ``_fused_kernel`` (mhada_pallas.py:143-198) step by step, with
its rounding points, for all heads at once.  Everything stays token-major:
head h is the channel slice [h*64, (h+1)*64) of fc, fcs, k, v and the
output.
"""

import torch

from .. import _build
from ..config import use_kernel
from .mhada_kernel import (ALIGNED, HEAD_DIM, _heads, mhada_partials,
                           mhada_softmax_plain)


def mhada_fused_prologue_plain(fc, fcs, stats, wf, fb, k, v) -> torch.Tensor:
    """fc, fcs (B, N, C) raw tokens; stats (B, 4, C) float32 rows
    [mean_fc, rstd_fc, mean_fcs, rstd_fcs] from
    ``instance_norm.instance_norm_stats`` (mhada_tpu/models/
    adaformer.py:85-93); wf (H, d, d) as (in, out); fb (H, d); k, v
    (B, M, C) -> (B, N, C) in fc's dtype."""
    b, n, c = fc.shape
    h = wf.shape[0]
    st = stats.float()
    qn = ((fc.float() - st[:, None, 0]) * st[:, None, 1]).to(k.dtype)
    q = torch.einsum("bnhd,hde->bnhe", qn.float().reshape(b, n, h, -1),
                     wf.to(k.dtype).float()) + fb.to(k.dtype).float()
    q = q.to(k.dtype).float().transpose(1, 2)                 # (B, H, N, d)
    kh, vh = (_heads(t, h).float() for t in (k, v))          # (B, H, M, d)
    fcs_n = _heads((fcs.float() - st[:, None, 2]) * st[:, None, 3], h)
    # the core as _fused_kernel rounds it (mhada_pallas.py:182-191)
    out = mhada_softmax_plain(q, kh, vh, fcs_n, v.dtype)
    return out.transpose(1, 2).reshape(b, n, c).to(fc.dtype)


def mhada_fused_prologue(fc: torch.Tensor, fcs: torch.Tensor,
                         stats: torch.Tensor, wf: torch.Tensor,
                         fb: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         backend: str = "auto") -> torch.Tensor:
    """The fused MHAda block core; the K3 kernel for CUDA tensors.  ``wf``
    and ``fb`` may be float32 for a bf16 ``fc``: they are cast to k's dtype
    as the plain version casts them.

    Forward-only, and no training route exists yet: a block in training
    mode runs the unfused projections and K7 on the same K/V instead."""
    if not use_kernel(backend, fc):
        return mhada_fused_prologue_plain(fc, fcs, stats, wf, fb, k, v)
    _build.check_forward_only(
        "mhada_fused_prologue", "no training route exists yet: run the "
        "block in training mode (unfused projections and K7)",
        fc, fcs, stats, wf, fb, k, v)
    return launch_prologue("mhada_mhada_prologue", fc, fcs, stats, wf, fb, k,
                           v)[0]


def launch_prologue(entry: str, fc, fcs, stats, wf, fb, k, v,
                    splits: int | None = None):
    """Check the inputs and launch C entry point ``entry``, K3
    (``mhada_mhada_prologue``) or the probe P2 of the same function and
    arguments (``mhada_mhada_prologue_pipe``, which takes 1 split only),
    split over the keys as ``mhada_partials`` says (``splits`` forces the
    count, 1 .. ceil(M / 64)) -> (out, the float32 partials buffer or None
    when unsplit)."""
    if fc.dim() != 3 or fcs.shape != fc.shape or k.dim() != 3 \
            or v.shape != k.shape or k.shape[0] != fc.shape[0] \
            or k.shape[2] != fc.shape[2] \
            or stats.shape != (fc.shape[0], 4, fc.shape[2]) \
            or wf.dim() != 3 or fb.shape != wf.shape[:2]:
        raise ValueError(
            f"mhada_fused_prologue: bad shapes fc {tuple(fc.shape)} fcs "
            f"{tuple(fcs.shape)} stats {tuple(stats.shape)} wf "
            f"{tuple(wf.shape)} fb {tuple(fb.shape)} k {tuple(k.shape)} "
            f"v {tuple(v.shape)}")
    b, n, c = fc.shape
    m = k.shape[1]
    heads = wf.shape[0]
    if wf.shape[1:] != (HEAD_DIM, HEAD_DIM) or heads * HEAD_DIM != c:
        raise ValueError(f"mhada_fused_prologue: the kernel takes {c // 64} "
                         f"heads of {HEAD_DIM}, got wf {tuple(wf.shape)}")
    wt = wf.to(k.dtype).contiguous()
    _build.check_cuda_inputs("mhada_fused_prologue", fc, fcs, k, v, wt)
    f32 = [stats.float().contiguous(), fb.to(k.dtype).float().contiguous()]
    _build.check_cuda_inputs("mhada_fused_prologue", *f32)
    if f32[0].device != fc.device:
        raise ValueError("mhada_fused_prologue: all tensors must be on one "
                         "CUDA device")
    splits, part = mhada_partials("mhada_fused_prologue", splits, fc, m,
                                  heads)
    out = torch.empty_like(fc)
    # at float32 the float32 operands are copied 16 bytes at a time too
    _build.check_aligned("mhada_fused_prologue", fc, fcs, k, v, wt, out, part,
                         *(f32 if fc.dtype == torch.float32 else ()),
                         dtypes=ALIGNED)
    _build.launch(entry, fc.device, fc, fcs, f32[0], wt, f32[1], k, v, out,
                  part, b, n, m, c, heads, splits, _build.dtype_code(fc))
    return out, part
