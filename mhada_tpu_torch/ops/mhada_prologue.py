"""K3: the MHAda block core on cached style K/V with the instance norm and
the Q projection fused in (csrc/mhada_prologue.cu).

Port of mhada_tpu/ops/mhada_pallas.py::mhada_fused_prologue.  The plain
version follows its ``_fused_kernel`` (mhada_pallas.py:143-198) step by
step, for all heads at once.  Everything stays token-major: head h is the
channel slice [h*64, (h+1)*64) of fc, fcs, k, v and the output.
"""

import torch

from .. import _build
from ..config import use_kernel
from .mhada_kernel import HEAD_DIM, _heads


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
    p = torch.softmax(q @ kh.transpose(-1, -2), dim=-1)      # unscaled
    p = p.to(v.dtype).float()
    m1 = p @ vh
    e2 = p @ vh.square()
    sd = torch.sqrt(torch.clamp(e2 - m1.square(), min=1e-6))
    fcs_n = _heads((fcs.float() - st[:, None, 2]) * st[:, None, 3], h)
    return (sd * fcs_n + m1).transpose(1, 2).reshape(b, n, c).to(fc.dtype)


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
    _build.check_forward_only(
        "mhada_fused_prologue", "no training route exists yet: run the "
        "block in training mode (unfused projections and K7)",
        fc, fcs, stats, wf, fb, k, v)
    out = torch.empty_like(fc)
    _build.launch("mhada_mhada_prologue", fc.device, fc, fcs, f32[0], wt,
                  f32[1], k, v, out, b, n, k.shape[1], c, heads,
                  _build.dtype_code(fc))
    return out
