"""K13: the decoder's last conv c6 on its own (csrc/decoder_c6.cu: a
register-tiled direct conv at float32, an implicit GEMM on the tensor cores
at bf16).

Port of mhada_tpu/ops/decoder_tail_pallas.py::c6_transposed, the kernel
``Decoder(packed="col_tail")`` runs after plain up3 and c5 convs.  The
TPU kernel reads c5 column-packed and writes channel-planar tiles; both
are TPU re-layouts, so here c5 is the plain NHWC output of the c5
ConvReLU.  The plain version keeps the TPU kernel's rounding points
(decoder_tail_pallas.py:175-182): the conv summed in float32 over inputs
and weights in c5's dtype, plus the float32 bias, ReLU, then one rounding
to the dtype.  So at bf16 it matches ``c6_transposed``, not the bf16
ConvReLU chain, which rounds the conv before adding a bf16 bias.
"""

import torch

from .. import _build
from ..config import use_kernel
from .pad_conv import conv2d_reflect

C_IN, C_OUT = 64, 3


def c6_conv_plain(y: torch.Tensor, w6: torch.Tensor,
                  b6: torch.Tensor) -> torch.Tensor:
    """y (B, H, W, 64) NHWC c5 output; w6 (3, 64, 3, 3) OIHW; b6 (3,)
    -> relu(reflect-padded conv + b6) (B, H, W, 3) in y's dtype."""
    dt = y.dtype
    acc = conv2d_reflect(y.float(), w6.to(dt).float(), b6.float())
    return torch.relu(acc).to(dt)


def c6_conv(y: torch.Tensor, w6: torch.Tensor, b6: torch.Tensor,
            backend: str = "auto") -> torch.Tensor:
    """c6; the K13 kernel for CUDA tensors.  Weights are cast to y's dtype,
    the bias stays float32, as the TPU kernel has them.

    Forward-only, as the TPU kernel is: training runs the fused tail, K8
    (``ops.decoder_tail.decoder_tail_train``)."""
    if y.dim() != 4 or y.shape[3] != C_IN or y.shape[1] < 2 \
            or y.shape[2] < 2 or w6.shape != (C_OUT, C_IN, 3, 3) \
            or b6.shape != (C_OUT,):
        raise ValueError(
            f"c6_conv: bad shapes y {tuple(y.shape)} w6 {tuple(w6.shape)} "
            f"b6 {tuple(b6.shape)}")
    if not use_kernel(backend, y):
        return c6_conv_plain(y, w6, b6)
    _build.check_forward_only(
        "c6_conv", "train with the fused tail, K8 (ops.decoder_tail."
        "decoder_tail_train)", y, w6, b6)
    return _kernel(y, *kernel_params(w6, b6, y.dtype))


def kernel_params(w6: torch.Tensor, b6: torch.Tensor, dtype: torch.dtype):
    """The weights and bias as the kernel takes them: HWIO (3, 3, 64, 3) in
    ``dtype`` (the 3 output channels of one tap and input channel
    together) and a float32 bias."""
    return (w6.to(dtype).permute(2, 3, 1, 0).contiguous(),
            b6.float().contiguous())


def _kernel(y: torch.Tensor, hwio: torch.Tensor,
            bias: torch.Tensor) -> torch.Tensor:
    """One launch on weights in the kernel's layout (``kernel_params``)."""
    _build.check_cuda_inputs("c6_conv", y, hwio)
    _build.check_cuda_inputs("c6_conv", bias)
    if bias.device != y.device:
        raise ValueError("c6_conv: all tensors must be on one CUDA device")
    if y.data_ptr() % 16:
        raise ValueError("c6_conv: y must be 16-byte aligned")
    b, h, w, _ = y.shape
    out = y.new_empty((b, h, w, C_OUT))
    _build.launch("mhada_decoder_c6", y.device, y, hwio, bias, out, b, h, w,
                  _build.dtype_code(y))
    return out
