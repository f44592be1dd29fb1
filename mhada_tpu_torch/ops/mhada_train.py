"""K7: the differentiable MHAda core on token-major tensors
(csrc/mhada_train.cu).

Port of mhada_tpu/ops/mhada_pallas.py::mhada_tm_train.  Forward: K4's tile
also writing M1 and E2 (float32, (B, N, C)) and the row log-sum-exp
((B, heads, N) float32).  Backward: the elementwise prologue of
``_mhada_tm_bwd_impl`` (mhada_pallas.py:431-448) in plain torch, then the
K7 backward kernels for dQ, dK and dV = P^T dM1 + 2 V * (P^T dE2).  The
softmax is unscaled (reference network/adaDecoder.py:11-17); the Var
clamp's gradient is zero below 1e-6.  The plain versions follow the JAX
math step by step, with the same rounding points.
"""

import torch

from .. import _build
from ..config import use_kernel
from .attention_train import _heads, _tokens
from .mhada_kernel import HEAD_DIM


def mhada_train_fwd_plain(q, k, v, fcs_n, num_heads: int):
    """q, fcs_n (B, N, C); k, v (B, M, C) -> (out in q's dtype, M1, E2
    (B, N, C) float32, lse (B, H, N) float32)."""
    qh, kh, vh = (_heads(t, num_heads) for t in (q, k, v))
    s = qh @ kh.transpose(-1, -2)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    m1, e2 = _tokens(p @ vh), _tokens(p @ vh.square())
    sd = torch.sqrt(torch.clamp(e2 - m1.square(), min=1e-6))
    return (sd * fcs_n.float() + m1).to(q.dtype), m1, e2, lse


def mhada_train_prologue(g, fcs_n, m1, e2, num_heads: int, dtype):
    """The elementwise prologue of _mhada_tm_bwd_impl: (dM1, dE2 in
    ``dtype``, delta (B, H, N) float32, d fcs_n in fcs_n's dtype)."""
    gf = g.float()
    var = e2 - m1.square()
    sd = torch.sqrt(torch.clamp(var, min=1e-6))
    d_f = gf * sd
    # the clamp's gradient: zero where Var < 1e-6 (torch semantics,
    # reference adaDecoder.py:191)
    d_var = torch.where(var >= 1e-6, gf * fcs_n.float() * 0.5 / sd, 0.0)
    d_m1 = gf - 2.0 * m1 * d_var
    delta = (_heads(d_m1 * m1 + d_var * e2, num_heads)).sum(-1).contiguous()
    return (d_m1.to(dtype).contiguous(), d_var.to(dtype).contiguous(), delta,
            d_f.to(fcs_n.dtype))


def mhada_train_bwd_plain(q, k, v, dm1, de2, lse, delta, num_heads: int):
    """_mhada_tm_bwd_kernel's math (mhada_pallas.py:362-421) for all heads
    -> (dq, dk, dv) in q's dtype."""
    dt = q.dtype
    qh, kh, vh, g1, g2 = (_heads(t, num_heads) for t in (q, k, v, dm1, de2))
    p = torch.exp(qh @ kh.transpose(-1, -2) - lse[..., None])
    pt = p.to(dt).float().transpose(-1, -2)
    dv = pt @ g1 + 2.0 * vh * (pt @ g2)
    da = g1 @ vh.transpose(-1, -2) + g2 @ vh.square().transpose(-1, -2)
    ds = (p * (da - delta[..., None])).to(dt).float()
    dq, dk = ds @ kh, ds.transpose(-1, -2) @ qh
    return tuple(_tokens(t).to(dt) for t in (dq, dk, dv))


def _fwd_kernel(q, k, v, fcs_n, num_heads):
    b, n, c = q.shape
    out = torch.empty_like(q)
    m1, e2 = (torch.empty((b, n, c), device=q.device, dtype=torch.float32)
              for _ in range(2))
    lse = torch.empty((b, num_heads, n), device=q.device, dtype=torch.float32)
    _build.launch("mhada_mhada_train_fwd", q.device, q, k, v, fcs_n, out, m1,
                  e2, lse, b, n, k.shape[1], c, num_heads,
                  _build.dtype_code(q))
    return out, m1, e2, lse


def _bwd_kernel(q, k, v, dm1, de2, lse, delta, num_heads):
    b, n, c = q.shape
    _build.check_cuda_inputs("mhada_train", q, k, v, dm1, de2)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    _build.launch("mhada_mhada_train_bwd", q.device, q, k, v, dm1, de2, lse,
                  delta, dq, dk, dv, b, n, k.shape[1], c, num_heads,
                  _build.dtype_code(q))
    return dq, dk, dv


class _MhadaTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, fcs_n, num_heads, kernel):
        fwd = _fwd_kernel if kernel else mhada_train_fwd_plain
        out, m1, e2, lse = fwd(q, k, v, fcs_n, num_heads)
        ctx.save_for_backward(q, k, v, fcs_n, m1, e2, lse)
        ctx.num_heads, ctx.kernel = num_heads, kernel
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, fcs_n, m1, e2, lse = ctx.saved_tensors
        dm1, de2, delta, dfcs_n = mhada_train_prologue(
            g, fcs_n, m1, e2, ctx.num_heads, q.dtype)
        bwd = _bwd_kernel if ctx.kernel else mhada_train_bwd_plain
        dq, dk, dv = bwd(q, k, v, dm1, de2, lse, delta, ctx.num_heads)
        return dq, dk, dv, dfcs_n, None, None


def mhada_train(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                fcs_n: torch.Tensor, num_heads: int,
                backend: str = "auto") -> torch.Tensor:
    """Differentiable softmax MHAda core, q, fcs_n (B, N, C), k, v (B, M, C)
    -> (B, N, C): the K7 kernels, forward and backward, for CUDA tensors;
    the plain versions for CPU tensors."""
    if q.dim() != 3 or k.dim() != 3 or q.shape != fcs_n.shape \
            or k.shape != v.shape or q.shape[0] != k.shape[0] \
            or q.shape[2] != k.shape[2] or q.shape[2] % num_heads:
        raise ValueError(
            f"mhada_train: bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
            f"v {tuple(v.shape)} fcs_n {tuple(fcs_n.shape)}")
    kernel = use_kernel(backend, q)
    q, k, v, fcs_n = (t.contiguous() for t in (q, k, v, fcs_n))
    if kernel:
        if q.shape[2] // num_heads != HEAD_DIM:
            raise ValueError(f"mhada_train: the kernel takes head dim "
                             f"{HEAD_DIM}, got {q.shape[2] // num_heads}")
        _build.check_cuda_inputs("mhada_train", q, k, v, fcs_n)
    return _MhadaTrain.apply(q, k, v, fcs_n, num_heads, kernel)
