"""K7: the differentiable MHAda core on token-major tensors
(csrc/mhada_train.cu).

Port of mhada_tpu/ops/mhada_pallas.py::mhada_tm_train (M <= 2048) and,
above 2048 keys, of the head-major kernels the JAX package routes training
to there (mhada_tpu/models/adaformer.py:133): K10's streaming forward with
its M1/E2/lse residuals (``_mhada_stream_fwd_impl(with_res=True)``,
pallas_call at mhada_pallas.py:622) and K11, the flash backward
``_mhada_stream_bwd_impl`` (dQ at :903, dK/dV at :925).  Both compute the
same function in another layout; the kernels stream 64-key tiles, so one
pair serves every length.  Forward: the MHAda tile also writing M1 and E2
(float32, (B, N, C)) and the row log-sum-exp ((B, heads, N) float32).
Backward: the elementwise prologue of ``_mhada_tm_bwd_impl``
(mhada_pallas.py:431-448, the same as :821-834) in plain torch, then the K7
backward kernels for dQ, dK and dV = P^T dM1 + 2 V * (P^T dE2).  At
bfloat16 the kernels are wgmma + TMA kernels on the tensor cores (the
forward K4's MHAda tile with a residual epilogue, split over the keys as
K4 is, ``fwd_launch``; its partials combined with the residuals by the
same C entry, ``mhada_kernel.mhada_combine_partials(residuals=True)`` in
plain PyTorch) and raise on a tensor that is not 16-byte aligned; at
float32 they compute in float32.  The softmax is
unscaled (reference network/adaDecoder.py:11-17); the Var clamp's gradient
is zero below 1e-6.  The plain versions follow the JAX math step by step,
with the same rounding points (P and V^2 rounded to the storage dtype as
the products' operands), one head at a time, so that at 16384 tokens only
one head's (N, M) float32 scores are live.
"""

import torch

from .. import _build
from ..config import use_kernel
from .attention_train import _head, _heads
from .key_split import check_splits
from .mhada_kernel import ALIGNED, HEAD_DIM, mhada_partials


def mhada_train_fwd_plain(q, k, v, fcs_n, num_heads: int):
    """q, fcs_n (B, N, C); k, v (B, M, C) -> (out in q's dtype, M1, E2
    (B, N, C) float32, lse (B, H, N) float32).  In the order of
    _tm_res_kernel (mhada_pallas.py:281-301): P = exp(S - max) and V^2 are
    rounded to q's dtype as the product's operands, and the product is
    divided by the unrounded row sum."""
    dt = q.dtype
    d = q.shape[-1] // num_heads
    m1s, e2s, lses = [], [], []
    for h in range(num_heads):
        s = _head(q, h, d) @ _head(k, h, d).transpose(-1, -2)
        mx = s.amax(-1, keepdim=True)
        p = torch.exp(s - mx)
        del s
        denom = p.sum(-1, keepdim=True)
        p = p.to(dt).float()
        vh = _head(v, h, d)
        m1s.append(p @ vh / denom)
        e2s.append(p @ vh.square().to(dt).float() / denom)
        lses.append((mx + torch.log(denom))[..., 0])
        del p
    m1, e2 = torch.cat(m1s, dim=-1), torch.cat(e2s, dim=-1)
    sd = torch.sqrt(torch.clamp(e2 - m1.square(), min=1e-6))
    return (sd * fcs_n.float() + m1).to(dt), m1, e2, torch.stack(lses, 1)


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
    """_mhada_tm_bwd_kernel's math (mhada_pallas.py:362-421), one head at a
    time, V^2 rounded to q's dtype as in its [V | V^2] -> (dq, dk, dv) in
    q's dtype."""
    dt = q.dtype
    d = q.shape[-1] // num_heads
    grads = [[], [], []]
    for h in range(num_heads):
        qh, kh, vh, g1, g2 = (_head(t, h, d) for t in (q, k, v, dm1, de2))
        p = torch.exp(qh @ kh.transpose(-1, -2) - lse[:, h, :, None])
        pt = p.to(dt).float().transpose(-1, -2)
        grads[2].append(pt @ g1 + 2.0 * vh * (pt @ g2))
        del pt
        da = (g1 @ vh.transpose(-1, -2)
              + g2 @ vh.square().to(dt).float().transpose(-1, -2))
        ds = (p * (da - delta[:, h, :, None])).to(dt).float()
        del p, da
        grads[0].append(ds @ kh)
        grads[1].append(ds.transpose(-1, -2) @ qh)
        del ds
    return tuple(torch.cat(gs, dim=-1).to(dt) for gs in grads)


def fwd_launch(q, k, v, fcs_n, num_heads, splits: int | None = None):
    """Check the CUDA inputs and launch K7's forward, split over the keys
    as ``mhada_kernel.mhada_partials`` says for K4 (``splits`` forces the
    count, 1 .. ceil(M / 64); float32 takes none) -> (out, M1, E2, lse, the
    float32 partials buffer or None when unsplit)."""
    b, n, c = q.shape
    m = k.shape[1]
    check_splits("mhada_train", splits, m)
    _build.check_cuda_inputs("mhada_train", q, k, v, fcs_n)
    splits, part = mhada_partials("mhada_train", splits, q, m, num_heads)
    out = torch.empty_like(q)
    m1, e2 = (torch.empty((b, n, c), device=q.device, dtype=torch.float32)
              for _ in range(2))
    lse = torch.empty((b, num_heads, n), device=q.device, dtype=torch.float32)
    _build.check_aligned("mhada_train", q, k, v, fcs_n, out, m1, e2, part,
                         dtypes=ALIGNED)
    _build.launch("mhada_mhada_train_fwd", q.device, q, k, v, fcs_n, out, m1,
                  e2, lse, part, b, n, m, c, num_heads, splits,
                  _build.dtype_code(q))
    return out, m1, e2, lse, part


def _bwd_kernel(q, k, v, dm1, de2, lse, delta, num_heads):
    b, n, c = q.shape
    _build.check_cuda_inputs("mhada_train", q, k, v, dm1, de2)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    _build.check_aligned("mhada_train", q, k, v, dm1, de2, dq, dk, dv)
    _build.launch("mhada_mhada_train_bwd", q.device, q, k, v, dm1, de2, lse,
                  delta, dq, dk, dv, b, n, k.shape[1], c, num_heads,
                  _build.dtype_code(q))
    return dq, dk, dv


class _MhadaTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, fcs_n, num_heads, kernel):
        fwd = fwd_launch if kernel else mhada_train_fwd_plain
        out, m1, e2, lse = fwd(q, k, v, fcs_n, num_heads)[:4]
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
