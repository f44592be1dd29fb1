"""K2: LayerNorm fused into the following matmul (csrc/ln_matmul.cu).

Port of mhada_tpu/ops/ln_matmul_pallas.py::ln_matmul for the ViT's
ln1 -> qkv and ln2 -> fc1 sites.  ``layer_norm`` is the LayerNorm math of
mhada_tpu/models/layers.py:117-124 (float32 statistics, eps 1e-6); the twin
is that LayerNorm followed by ``F.linear``.
"""

import torch
import torch.nn.functional as F

from .. import _build
from ..config import use_kernel

# The normalised row tile (64 rows x E in T) lives in shared memory.
MAX_E = 768


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis with float32 statistics, in x's dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


def ln_matmul_plain(x, ln_w, ln_b, w, b, eps: float = 1e-6) -> torch.Tensor:
    """LN(x) @ w.T + b; x (B, N, E), w (F, E) as in nn.Linear, b (F,)."""
    h = layer_norm(x, ln_w, ln_b, eps)
    return F.linear(h, w.to(h.dtype), b.to(h.dtype))


def ln_matmul(x: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor,
              w: torch.Tensor, b: torch.Tensor, eps: float = 1e-6,
              backend: str = "auto") -> torch.Tensor:
    """``LayerNorm(x) @ w.T + b`` with the LN in the matmul's prologue; the
    K2 kernel for CUDA tensors.  Weights may be float32 for a bf16 ``x``:
    ``w`` and ``b`` are cast to x's dtype as the twin casts them.

    Forward-only, and no training route exists yet (K2's VJP): the
    training build runs ``layer_norm`` and ``F.linear`` instead."""
    if not use_kernel(backend, x):
        return ln_matmul_plain(x, ln_w, ln_b, w, b, eps)
    if x.dim() < 2 or w.dim() != 2 or w.shape[1] != x.shape[-1] \
            or b.shape != (w.shape[0],) or ln_w.shape != (x.shape[-1],) \
            or ln_b.shape != ln_w.shape:
        raise ValueError(
            f"ln_matmul: bad shapes x {tuple(x.shape)} w {tuple(w.shape)} "
            f"b {tuple(b.shape)} ln {tuple(ln_w.shape)}")
    e, f = x.shape[-1], w.shape[0]
    if e > MAX_E:
        raise ValueError(f"ln_matmul: the kernel takes E <= {MAX_E}, got {e}")
    wt = w.to(x.dtype).contiguous()
    _build.check_cuda_inputs("ln_matmul", x, wt)
    f32 = [t.float().contiguous() for t in (ln_w, ln_b, b.to(x.dtype))]
    _build.check_cuda_inputs("ln_matmul", *f32)
    _build.check_forward_only(
        "ln_matmul", "no training route exists yet: use layer_norm and "
        "F.linear, as build_models(for_training=True) does",
        x, ln_w, ln_b, w, b)
    rows = x.numel() // e
    out = torch.empty((*x.shape[:-1], f), device=x.device, dtype=x.dtype)
    _build.launch("mhada_ln_matmul", x.device, x, f32[0], f32[1], wt, f32[2],
                  out, rows, e, f, float(eps), _build.dtype_code(x))
    return out
