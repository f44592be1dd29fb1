"""K6: differentiable ViT self-attention from the packed qkv
(csrc/attention_train.cu).

Port of mhada_tpu/ops/attention_pallas.py::attention_tm_train (L <= 2048)
and, above 2048 tokens, of the head-major K12 that the JAX package routes
training to there (mhada_tpu/models/layers.py:209-214): its streaming
forward with lse, ``_attn_stream_fwd_impl`` (pallas_call at
attention_pallas.py:488), and its flash backward,
``_attn_stream_bwd_impl`` (dQ at :868, dK/dV at :888).  Both compute the
same function in another layout; the kernels stream 64-key tiles, so one
pair serves every length.  Forward: K1's tile also writing the row
log-sum-exp, (B, heads, L) float32.  Backward: dQ, dK and dV written
straight into the packed (B, L, 3C) gradient, P rebuilt from lse, dO in
the storage dtype, float32 accumulation; the row term delta = rowsum(dO *
O) per head is computed here, as attention_pallas.py:322-327 and :807 do in
XLA.  The plain versions follow the JAX forward and backward math step by
step, with the same rounding points, one head at a time, so that at 16384
tokens only one head's (L, L) float32 scores are live.
"""

import math

import torch

from .. import _build
from ..config import use_kernel
from .attention_kernel import HEAD_DIM


def _heads(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, L, C) -> (B, H, L, C / H) float32."""
    b, l, c = t.shape
    return t.float().reshape(b, l, num_heads, c // num_heads).transpose(1, 2)


def row_delta(g: torch.Tensor, out: torch.Tensor,
              num_heads: int) -> torch.Tensor:
    """delta = rowsum(dO * O) per head: (B, L, C) -> (B, H, L) float32."""
    return (_heads(g, num_heads) * _heads(out, num_heads)).sum(-1).contiguous()


def _head(t: torch.Tensor, h: int, d: int) -> torch.Tensor:
    """Head h of a (B, L, C) token-major tensor -> (B, L, d) float32."""
    return t[..., h * d:(h + 1) * d].float()


def attention_train_fwd_plain(qkv: torch.Tensor, num_heads: int,
                              scale: float):
    """(B, L, 3C) -> (out (B, L, C) in qkv's dtype, lse (B, H, L) float32)."""
    q, k, v = qkv.chunk(3, dim=-1)
    d = q.shape[-1] // num_heads
    outs, lses = [], []
    for h in range(num_heads):
        s = _head(q, h, d) @ _head(k, h, d).transpose(-1, -2) * scale
        lse = torch.logsumexp(s, dim=-1)
        outs.append(torch.exp(s - lse[..., None]) @ _head(v, h, d))
        lses.append(lse)
        del s
    return torch.cat(outs, dim=-1).to(qkv.dtype), torch.stack(lses, 1)


def attention_train_bwd_plain(qkv: torch.Tensor, lse: torch.Tensor,
                              delta: torch.Tensor, g: torch.Tensor,
                              num_heads: int, scale: float) -> torch.Tensor:
    """_tm_bwd_kernel's math (attention_pallas.py:256-312), one head at a
    time: g = dO in qkv's dtype -> d qkv (B, L, 3C) in qkv's dtype."""
    dt = qkv.dtype
    q, k, v = qkv.chunk(3, dim=-1)
    d = q.shape[-1] // num_heads
    grads = [[], [], []]
    for h in range(num_heads):
        qh, kh, vh, gh = (_head(t, h, d) for t in (q, k, v, g))
        p = torch.exp(qh @ kh.transpose(-1, -2) * scale - lse[:, h, :, None])
        grads[2].append(p.to(dt).float().transpose(-1, -2) @ gh)
        ds = p * (gh @ vh.transpose(-1, -2) - delta[:, h, :, None]) * scale
        del p
        ds = ds.to(dt).float()
        grads[0].append(ds @ kh)
        grads[1].append(ds.transpose(-1, -2) @ qh)
        del ds
    return torch.cat([torch.cat(gs, dim=-1) for gs in grads], dim=-1).to(dt)


def _fwd_kernel(qkv, num_heads, scale):
    b, l, c3 = qkv.shape
    out = qkv.new_empty((b, l, c3 // 3))
    lse = torch.empty((b, num_heads, l), device=qkv.device,
                      dtype=torch.float32)
    _build.check_aligned("attention_train", qkv, out)
    _build.launch("mhada_attention_train_fwd", qkv.device, qkv, out, lse, b,
                  l, c3 // 3, num_heads, float(scale), _build.dtype_code(qkv))
    return out, lse


def _bwd_kernel(qkv, lse, delta, g, num_heads, scale):
    b, l, c3 = qkv.shape
    _build.check_cuda_inputs("attention_train", qkv, g)
    dqkv = torch.empty_like(qkv)
    _build.check_aligned("attention_train", qkv, g, dqkv)
    _build.launch("mhada_attention_train_bwd", qkv.device, qkv, g, lse,
                  delta, dqkv, b, l, c3 // 3, num_heads, float(scale),
                  _build.dtype_code(qkv))
    return dqkv


class _AttentionTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, num_heads, scale, kernel):
        fwd = _fwd_kernel if kernel else attention_train_fwd_plain
        out, lse = fwd(qkv, num_heads, scale)
        ctx.save_for_backward(qkv, out, lse)
        ctx.num_heads, ctx.scale, ctx.kernel = num_heads, scale, kernel
        return out

    @staticmethod
    def backward(ctx, g):
        qkv, out, lse = ctx.saved_tensors
        g = g.to(qkv.dtype).contiguous()    # dO in the storage dtype
        delta = row_delta(g, out, ctx.num_heads)
        bwd = _bwd_kernel if ctx.kernel else attention_train_bwd_plain
        return bwd(qkv, lse, delta, g, ctx.num_heads, ctx.scale), None, None, \
            None


def attention_train(qkv: torch.Tensor, num_heads: int,
                    scale: float | None = None,
                    backend: str = "auto") -> torch.Tensor:
    """Differentiable token-major self-attention, (B, L, 3C) -> (B, L, C):
    the K6 kernels, forward and backward, for CUDA tensors; the plain
    versions for CPU tensors."""
    b, l, c3 = qkv.shape
    if c3 % (3 * num_heads):
        raise ValueError(f"attention_train: bad qkv shape {tuple(qkv.shape)} "
                         f"for {num_heads} heads")
    d = c3 // 3 // num_heads
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    kernel = use_kernel(backend, qkv)
    qkv = qkv.contiguous()
    if kernel:
        if d != HEAD_DIM:
            raise ValueError(f"attention_train: the kernel takes head dim "
                             f"{HEAD_DIM}, got {d}")
        _build.check_cuda_inputs("attention_train", qkv)
    return _AttentionTrain.apply(qkv, num_heads, scale, kernel)
