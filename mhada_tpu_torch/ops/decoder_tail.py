"""K5 and K8: the decoder tail up3 -> 2x bilinear -> c5 -> c6 in one kernel
(csrc/decoder_tail.cu).

K5 ports mhada_tpu/ops/decoder_tail_pallas.py::tail3_fused, K8 its training
form ``tail3_train``: the same kernel also writing the post-ReLU residuals
y1 = relu(up3 conv) (B, H, W, 64) and c5 (B, 2H, 2W, 64), with a plain
PyTorch backward written from ``_tail3_train_bwd``
(decoder_tail_pallas.py:622-653), as the JAX package's is XLA.  The plain
forward is the chain of mhada_tpu/models/decoder.py:215-217
(reflect-padded convs, ReLU after each, ``upsample2x`` after up3).  Weights
are torch OIHW.
"""

import torch
from torch.nn.grad import conv2d_input, conv2d_weight

from .. import _build
from ..config import use_kernel
from .pad_conv import conv2d_reflect, no_tf32, reflect_pad2d
from .resize import upsample2x

C_IN, C_MID, C_OUT = 128, 64, 3


def decoder_tail_res_plain(x, w_up, b_up, w5, b5, w6, b6):
    """x (B, H, W, 128) NHWC -> (rgb (B, 2H, 2W, 3), y1, c5)."""
    dt = x.dtype
    y1 = torch.relu(conv2d_reflect(x, w_up.to(dt), b_up.to(dt)))
    c5 = torch.relu(conv2d_reflect(upsample2x(y1), w5.to(dt), b5.to(dt)))
    return torch.relu(conv2d_reflect(c5, w6.to(dt), b6.to(dt))), y1, c5


def decoder_tail_plain(x, w_up, b_up, w5, b5, w6, b6) -> torch.Tensor:
    """x (B, H, W, 128) NHWC -> (B, 2H, 2W, 3)."""
    return decoder_tail_res_plain(x, w_up, b_up, w5, b5, w6, b6)[0]


def _launch_tail(entry, x, w_up, b_up, w5, b5, w6, b6):
    """Launch K5 (``mhada_decoder_tail``) or K8 (``mhada_decoder_tail_res``)
    -> [rgb] or [rgb, y1, c5]."""
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
    outs = [torch.empty((b, 2 * h, 2 * w, C_OUT), device=x.device, dtype=dt)]
    if entry == "mhada_decoder_tail_res":
        outs += [x.new_empty((b, h, w, C_MID)),
                 x.new_empty((b, 2 * h, 2 * w, C_MID))]
    _build.launch(entry, x.device, x, hwio[0], bias[0], hwio[1], bias[1],
                  hwio[2], bias[2], *outs, b, h, w, _build.dtype_code(x))
    return outs


def decoder_tail(x: torch.Tensor, w_up: torch.Tensor, b_up: torch.Tensor,
                 w5: torch.Tensor, b5: torch.Tensor, w6: torch.Tensor,
                 b6: torch.Tensor, backend: str = "auto") -> torch.Tensor:
    """The fused tail; the K5 kernel for CUDA tensors.  Weights and biases
    are cast to x's dtype as the twin casts them.

    Forward-only: its training counterpart is K8, ``decoder_tail_train``."""
    if not use_kernel(backend, x):
        return decoder_tail_plain(x, w_up, b_up, w5, b5, w6, b6)
    _build.check_forward_only(
        "decoder_tail", "train through K8, ops.decoder_tail."
        "decoder_tail_train", x, w_up, b_up, w5, b5, w6, b6)
    return _launch_tail("mhada_decoder_tail", x, w_up, b_up, w5, b5, w6,
                        b6)[0]


def _conv_adjoint(g, inp, w):
    """(d input, d weight) of an unpadded NHWC conv with OIHW weight ``w``
    at input ``inp``, for the NHWC output gradient ``g``."""
    gn, xn = g.permute(0, 3, 1, 2), inp.permute(0, 3, 1, 2)
    dx = conv2d_input(xn.shape, w, gn)
    return dx.permute(0, 2, 3, 1), conv2d_weight(xn, w.shape, gn)


def _reflect_pad_adjoint(g, x):
    """The adjoint of ``reflect_pad2d(x, 1)``: g (B, H+2, W+2, C) NHWC."""
    d = torch.ops.aten.reflection_pad2d_backward(
        g.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), [1, 1, 1, 1])
    return d.permute(0, 2, 3, 1)


def _upsample2x_adjoint(g, y):
    """The adjoint of the exact 2x bilinear ``upsample2x(y)`` (linear)."""
    b, h, w, c = y.shape
    d = torch.ops.aten.upsample_bilinear2d_backward(
        g.permute(0, 3, 1, 2), [2 * h, 2 * w], [b, c, h, w], False, 2.0, 2.0)
    return d.permute(0, 2, 3, 1)


def decoder_tail_bwd(g, x, w_up, w5, w6, rgb, y1, c5):
    """The backward of the tail at the saved forward (decoder_tail_pallas.py
    :622-653): ReLU masks from the post-ReLU outputs (post > 0 <=> pre > 0),
    each conv's input and weight gradient at its reflect-padded input, then
    the adjoints of the reflect pad and of the 2x upsample; no conv forward
    is recomputed, only the bilinear upsample of y1.  Weights are OIHW in
    x's dtype -> (dx, dw_up, db_up, dw5, db5, dw6, db6) in x's dtype."""
    f32 = torch.float32
    g = g.to(rgb.dtype)
    with no_tf32():
        dz6 = torch.where(rgb > 0, g, 0)
        db6 = dz6.sum((0, 1, 2), dtype=f32)
        c5p = reflect_pad2d(c5, 1)
        dc5p, dw6 = _conv_adjoint(dz6, c5p, w6)
        dz5 = torch.where(c5 > 0, _reflect_pad_adjoint(dc5p, c5), 0)
        db5 = dz5.sum((0, 1, 2), dtype=f32)
        up = upsample2x(y1)
        dupp, dw5 = _conv_adjoint(dz5, reflect_pad2d(up, 1), w5)
        dy1 = _upsample2x_adjoint(_reflect_pad_adjoint(dupp, up), y1)
        dz1 = torch.where(y1 > 0, dy1, 0)
        dbu = dz1.sum((0, 1, 2), dtype=f32)
        dxp, dwu = _conv_adjoint(dz1, reflect_pad2d(x, 1), w_up)
        dx = _reflect_pad_adjoint(dxp, x)
    dt = x.dtype
    return (dx, dwu, dbu.to(dt), dw5, db5.to(dt), dw6, db6.to(dt))


class _DecoderTailTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w_up, b_up, w5, b5, w6, b6, kernel):
        if kernel:
            rgb, y1, c5 = _launch_tail("mhada_decoder_tail_res", x, w_up,
                                       b_up, w5, b5, w6, b6)
        else:
            rgb, y1, c5 = decoder_tail_res_plain(x, w_up, b_up, w5, b5, w6,
                                                 b6)
        ctx.save_for_backward(x, w_up, w5, w6, rgb, y1, c5)
        return rgb

    @staticmethod
    def backward(ctx, g):
        return (*decoder_tail_bwd(g, *ctx.saved_tensors), None)


def decoder_tail_train(x: torch.Tensor, w_up: torch.Tensor,
                       b_up: torch.Tensor, w5: torch.Tensor,
                       b5: torch.Tensor, w6: torch.Tensor, b6: torch.Tensor,
                       backend: str = "auto") -> torch.Tensor:
    """The differentiable tail: K8's kernel forward (K5 writing y1 and c5)
    for CUDA tensors, the plain chain on the CPU; the plain PyTorch backward
    on both.  Weights and biases are cast to x's dtype first, so their
    gradients reach float32 master weights through the cast."""
    kernel = use_kernel(backend, x)
    dt = x.dtype
    return _DecoderTailTrain.apply(x.contiguous(), *(
        t.to(dt) for t in (w_up, b_up, w5, b5, w6, b6)), kernel)
