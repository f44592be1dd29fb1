"""K5: the decoder tail up3 -> 2x bilinear -> c5 -> c6 in one kernel
(csrc/decoder_tail.cu).

Port of mhada_tpu/ops/decoder_tail_pallas.py::tail3_fused.  The twin is the
plain chain of mhada_tpu/models/decoder.py:215-217 (reflect-padded convs,
ReLU after each, ``upsample2x`` after up3).  Weights are torch OIHW.
"""

import torch

from .. import _build
from ..config import use_kernel
from .pad_conv import conv2d_reflect
from .resize import upsample2x

C_IN, C_MID, C_OUT = 128, 64, 3


def decoder_tail_plain(x, w_up, b_up, w5, b5, w6, b6) -> torch.Tensor:
    """x (B, H, W, 128) NHWC -> (B, 2H, 2W, 3)."""
    dt = x.dtype
    y = torch.relu(conv2d_reflect(x, w_up.to(dt), b_up.to(dt)))
    y = upsample2x(y)
    y = torch.relu(conv2d_reflect(y, w5.to(dt), b5.to(dt)))
    return torch.relu(conv2d_reflect(y, w6.to(dt), b6.to(dt)))


def decoder_tail(x: torch.Tensor, w_up: torch.Tensor, b_up: torch.Tensor,
                 w5: torch.Tensor, b5: torch.Tensor, w6: torch.Tensor,
                 b6: torch.Tensor, backend: str = "auto") -> torch.Tensor:
    """The fused tail; the K5 kernel for CUDA tensors.  Weights and biases
    are cast to x's dtype as the twin casts them."""
    if not use_kernel(backend, x):
        return decoder_tail_plain(x, w_up, b_up, w5, b5, w6, b6)
    if x.dim() != 4 or x.shape[3] != C_IN or x.shape[1] < 2 or x.shape[2] < 2 \
            or w_up.shape != (C_MID, C_IN, 3, 3) \
            or w5.shape != (C_MID, C_MID, 3, 3) \
            or w6.shape != (C_OUT, C_MID, 3, 3):
        raise ValueError(
            f"decoder_tail: bad shapes x {tuple(x.shape)} w_up "
            f"{tuple(w_up.shape)} w5 {tuple(w5.shape)} w6 {tuple(w6.shape)}")
    dt = x.dtype
    # OIHW -> HWIO: output channels contiguous for the kernel's weight reads
    hwio = [w.to(dt).permute(2, 3, 1, 0).contiguous() for w in (w_up, w5, w6)]
    _build.check_cuda_inputs("decoder_tail", x, *hwio)
    bias = [bb.to(dt).float().contiguous() for bb in (b_up, b5, b6)]
    _build.check_cuda_inputs("decoder_tail", *bias)
    b, h, w, _ = x.shape
    out = torch.empty((b, 2 * h, 2 * w, C_OUT), device=x.device, dtype=dt)
    _build.launch("mhada_decoder_tail", x.device, x, hwio[0], bias[0],
                  hwio[1], bias[1], hwio[2], bias[2], out, b, h, w,
                  _build.dtype_code(x))
    return out
