"""K14: the decoder's mid stages c1 -> c2 -> c3 (csrc/decoder_mid.cu).

Port of mhada_tpu/ops/decoder_mid_pallas.py::mid3_fused: three
reflect-padded 3x3 ConvReLUs of C -> C channels (C = 256 in the decoder,
at a quarter of the frame's side), each padding its own input.  Nothing in
either package calls it on the inference path: the JAX package measured
the fused kernel slower than XLA's convs (the module's docstring), and the
port's decoder runs c1-c3 as plain ConvReLUs.  It is held against the
decoder's own activations by ``chip_smoke.py``.

The kernel is one reflect-padded 3x3 ConvReLU launched once per stage,
three launches per call: at bfloat16 an implicit GEMM on the tensor cores,
at float32 a register-tiled direct conv on the CUDA cores with a cp.async
ring (csrc/decoder_mid_f32.cuh).  Every stage keeps the TPU kernel's rounding
points: the conv summed in float32, rounded to the dtype, plus the bias
rounded to the dtype, ReLU.  Weights are torch OIHW; ``kernel_params``
gives them in the kernel's layout.
"""

import torch

from .. import _build
from ..config import use_kernel
from .pad_conv import conv2d_reflect

# The JAX function's contract (decoder_mid_pallas.py:137).
CHANNEL_MULTIPLE = 128


def _stage_plain(x, w, b):
    dt = x.dtype
    acc = conv2d_reflect(x.float(), w.to(dt).float(), None)
    return torch.relu(acc.to(dt) + b.to(dt))


def mid3_fused_plain(x, w1, b1, w2, b2, w3, b3) -> torch.Tensor:
    """x (B, H, W, C) NHWC; w* (C, C, 3, 3) OIHW; b* (C,) -> (B, H, W, C)."""
    for w, b in ((w1, b1), (w2, b2), (w3, b3)):
        x = _stage_plain(x, w, b)
    return x


def kernel_params(ws, bs, dtype):
    """The weights and biases as the kernel takes them: HWIO (3, 3, C, C)
    in ``dtype``, output channels contiguous, and float32 biases holding
    ``dtype`` values."""
    return ([w.to(dtype).permute(2, 3, 1, 0).contiguous() for w in ws],
            [b.to(dtype).float().contiguous() for b in bs])


def _check_shapes(x, ws, bs):
    c = x.shape[-1] if x.dim() == 4 else -1
    if x.dim() != 4 or c % CHANNEL_MULTIPLE or x.shape[1] < 2 \
            or x.shape[2] < 2 or any(w.shape != (c, c, 3, 3) for w in ws) \
            or any(b.shape != (c,) for b in bs):
        raise ValueError(
            f"mid3_fused: bad shapes x {tuple(x.shape)} (C a multiple of "
            f"{CHANNEL_MULTIPLE}, H, W >= 2) w {[tuple(w.shape) for w in ws]}"
            f" b {[tuple(b.shape) for b in bs]}")


def mid3_fused(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
               w2: torch.Tensor, b2: torch.Tensor, w3: torch.Tensor,
               b3: torch.Tensor, backend: str = "auto") -> torch.Tensor:
    """c1 -> c2 -> c3; the K14 kernel, three launches, for CUDA tensors.
    Weights and biases are cast to x's dtype.  Forward-only, as the TPU
    kernel is: training runs the plain ConvReLUs."""
    ws, bs = (w1, w2, w3), (b1, b2, b3)
    _check_shapes(x, ws, bs)
    if not use_kernel(backend, x):
        return mid3_fused_plain(x, w1, b1, w2, b2, w3, b3)
    _build.check_forward_only(
        "mid3_fused", "train through the plain ConvReLUs (models.decoder)",
        x, *ws, *bs)
    return _kernel(x, *kernel_params(ws, bs, x.dtype))


def _kernel(x, hwio, bias) -> torch.Tensor:
    """The three launches, on weights and biases in the kernel's layout
    (``kernel_params``)."""
    _build.check_cuda_inputs("mid3_fused", x, *hwio)
    _build.check_cuda_inputs("mid3_fused", *bias)
    if bias[0].device != x.device:
        raise ValueError("mid3_fused: all tensors must be on one CUDA device")
    bsz, h, w, c = x.shape
    for wt, bb in zip(hwio, bias):
        y = torch.empty_like(x)
        _build.check_aligned("mid3_fused", x, wt, y,
                             dtypes=(torch.bfloat16, torch.float32))
        _build.launch("mhada_decoder_mid_conv", x.device, x, wt, bb, y, bsz,
                      h, w, c, _build.dtype_code(x))
        x = y
    return x
