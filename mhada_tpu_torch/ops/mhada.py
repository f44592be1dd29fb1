"""The plain MHAda core (mhada_tpu/ops/mhada.py:26-79).

Reference semantics (network/adaDecoder.py:134-206): per head the attention
A = softmax(Q K^T) is UNSCALED (no 1/sqrt(d), adaDecoder.py:11-17), then

    M1 = A V,   E2 = A V^2,   S = sqrt(max(E2 - M1^2, 1e-6))
    out = S * IN(fcs) + M1

The cosine activation and the local feature loss's parameter-free AdaAttN
(train/losses.py) run it; the kernels' softmax twins
(ops/mhada_kernel.py::mhada_softmax_plain) round where the Pallas kernels
round instead.
"""

import torch


def _cosine_attention(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Reference CosineSimilarity activation: (cos(q, k) + 1), row-normalised."""
    qn = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    kn = torch.linalg.vector_norm(k, dim=-1, keepdim=True)
    s = q @ k.transpose(-1, -2) / (qn * kn.transpose(-1, -2)) + 1.0
    return s / s.sum(dim=-1, keepdim=True)


def mhada_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    fcs_n: torch.Tensor, activation: str = "softmax"
                    ) -> torch.Tensor:
    """Head-major core: q, fcs_n (B, H, N, D); k, v (B, H, M, D) -> (B, H, N, D).

    Computed in float32 and returned in q's dtype.
    """
    qf, kf, vf = q.float(), k.float(), v.float()
    if activation == "softmax":
        a = torch.softmax(qf @ kf.transpose(-1, -2), dim=-1)
    elif activation == "cosine":
        a = _cosine_attention(qf, kf)
    else:
        raise ValueError(f"Unknown activation function: {activation}")
    m1 = a @ vf
    e2 = a @ vf.square()
    s = torch.sqrt(torch.clamp(e2 - m1.square(), min=1e-6))
    return (s * fcs_n.float() + m1).to(q.dtype)
