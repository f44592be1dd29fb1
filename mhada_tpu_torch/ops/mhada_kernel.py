"""K4: the MHAda core on token-major tensors (csrc/mhada_fwd.cu).

Port of mhada_tpu/ops/mhada_pallas.py::mhada_attention_pallas, single-pass
forward.  Inputs stay (B, N|M, C) with head h in channels
[h*64, (h+1)*64), so the head-split transposes of
mhada_tpu/models/adaformer.py:133-141 are not needed.  At bfloat16 the
kernel runs on the tensor cores (the warp-specialised wgmma + TMA MHAda
tile of csrc/mhada_wgmma.cuh, which K3 shares); at float32 it computes in
float32 on the CUDA cores (csrc/mhada_f32_tile.cuh).  Both raise on a
tensor that is not 16-byte aligned.  Where one block a (batch, head,
192-query block) would leave block slots of the card idle, the bf16 tile
splits the keys over ``mhada_splits`` blocks, each writing float32
partials (row max, row sum, unnormalised P V and P V^2) that a second
kernel of the same C entry combines in a fixed order before the MHAda
epilogue (csrc/mhada_combine.cuh; ``mhada_combine_partials`` is that
combine in plain PyTorch).  The softmax twin follows the Pallas kernel's
rounding points (``mhada_softmax_plain``, which K3's twin shares); the
cosine activation runs the plain core of ops/mhada.py.
"""

import functools
import math

import torch

from .. import _build
from ..config import use_kernel
from .key_split import (KEY_TILE, TILE_BYTES, check_splits, pick_splits,
                        sm_count)
from .mhada import mhada_attention

HEAD_DIM = 64
# The dtypes whose kernel builds copy 16 bytes at a time, so that each
# operand must start on a 16-byte boundary: all of them (the float32 tile
# of csrc/mhada_f32_tile.cuh too).
ALIGNED = (torch.float32, torch.bfloat16)


# The MHAda tile at bf16 (csrc/mhada_wgmma.cuh, K3 and K4) for
# ``key_split.pick_splits``: queries a block (3 consumer warpgroups of 64),
# blocks an SM (512 threads at 128 registers, 155 KB of shared memory), and
# in key tiles of its own walk (~1 us a 64-key tile on an H100) what a block
# costs besides its walk and what a split block's store of its float32
# partials (192 rows of 2 x 64 + 2 floats) adds; fitted to
# probes/mhada_split_sweep.py's device times.  The combine reads each
# split's [O1 | O2] rows, 8 C bytes a row, at the card's memory rate
# (key_split.TILE_BYTES in the time of one key tile).
MHADA_BLOCK = (192, 1, 4.0, 4.0)


@functools.cache
def mhada_splits(batch: int, heads: int, n: int, m: int,
                 sms: int = 132) -> int:
    """How many blocks the bf16 MHAda tile gives each (batch, head, query
    block) of K3 and K4: ``key_split.pick_splits`` at its geometry
    (MHADA_BLOCK), the combine's read of a split's partials, B N 8 C
    bytes, counted in key tiles.  Unlike K1's cross form, whose partials
    are half as wide and whose combine is flat, the MHAda split pays for
    its partials: on an H100 (132 SMs), 8 heads, it gives 2 at B = 1, N =
    M = 4096 (176 blocks, 2 waves), at an SP rank's 1024 x 4096 (48
    blocks) and at N = M = 16384, and 1 at the Sintel eval's 3600 x 1024
    (152 blocks: 2 splits take 3 waves), at the video frame's 2048 x 1024
    (B = 1 and 8) and at B = 8, N = M = 4096 (1408 blocks): at each of
    probes/mhada_split_sweep.py's ten shapes the count fastest on the
    device (an H100 80GB HBM3 at 700 W; K4 unsplit and at 2 splits: 4096
    0.135 and 0.131 ms, 16384 1.442 and 1.419, 3600 x 1024 0.044 and
    0.058, 2048 x 1024 0.023 and 0.035; K3 at 1024 x 4096 0.071 and
    0.044)."""
    rows, per_sm, overhead, split_overhead = MHADA_BLOCK
    combine = batch * n * 8 * 64 * heads / TILE_BYTES
    return pick_splits(batch * heads * -(-n // rows), -(-m // KEY_TILE),
                       sms * per_sm, overhead, split_overhead, combine)


def mhada_partials(name: str, splits: int | None, ref: torch.Tensor,
                   m: int, num_heads: int):
    """The split of K3's or K4's launch on ``ref`` ((B, N, C) on the card)
    against ``m`` keys -> (splits, the float32 partials buffer or None):
    ``splits`` if given, else ``mhada_splits``' count at bfloat16; float32
    takes no split."""
    b, n, c = ref.shape
    check_splits(name, splits, m)
    if ref.dtype == torch.float32:
        if splits not in (None, 1):
            raise ValueError(f"{name}: the float32 tile takes no split over "
                             f"the keys, got {splits}")
        return 1, None
    if splits is None:
        splits = mhada_splits(b, num_heads, n, m,
                              sm_count(ref.device.index or 0))
    if splits == 1:
        return 1, None
    return splits, torch.empty(splits * b * n * (2 * c + 2 * num_heads),
                               device=ref.device, dtype=torch.float32)


def mhada_combine_partials(o: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                           f: torch.Tensor, dtype: torch.dtype,
                           keep: int | None = None, residuals: bool = False):
    """The MHAda combine kernel's function in plain PyTorch, on the split
    tile's partials (``key_split.split_partials`` with channels = 2 C: O
    (S, B, N, 2 C) = [O1 | O2], m and l (S, B, H, N)) and f (B, N, C), the
    epilogue's factor (K3: IN(fcs); K4, K7: fcs_n), over the first ``keep``
    splits (all by default): M1 = sum_s w_s O1_s / L, E2 likewise, with w_s
    = 2^(m_s - max m) and L = sum_s w_s l_s, then sqrt(max(E2 - M1^2,
    1e-6)) f + M1 in float32, rounded once to ``dtype`` -> (B, N, C);
    ``residuals`` (K7's forward): (that, M1 and E2 (B, N, C) float32, the
    row lse = ln 2 max m + log L (B, H, N) float32)."""
    keep = o.shape[0] if keep is None else keep
    o, m, l = o[:keep], m[:keep], l[:keep]
    s, b, n, c2 = o.shape
    top = m.amax(0)                                         # (B, H, N)
    w = torch.exp2(m - top).permute(0, 1, 3, 2)[..., None]
    den = (w * l.permute(0, 1, 3, 2)[..., None]).sum(0)     # (B, N, H, 1)
    num = (o.view(s, b, n, 2, -1, HEAD_DIM) * w[:, :, :, None]).sum(0)
    m1, e2 = (num[:, :, i] / den for i in (0, 1))           # (B, N, H, 64)
    sd = torch.sqrt(torch.clamp(e2 - m1.square(), min=1e-6))
    out = sd * f.float().view(b, n, -1, HEAD_DIM) + m1
    out = out.reshape(b, n, c2 // 2).to(dtype)
    if not residuals:
        return out
    lse = top * math.log(2.0) + torch.log(den[..., 0]).transpose(1, 2)
    return (out, m1.reshape(b, n, c2 // 2), e2.reshape(b, n, c2 // 2),
            lse)


def _heads(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, n, c = t.shape
    return t.reshape(b, n, num_heads, c // num_heads).transpose(1, 2)


def mhada_softmax_plain(q, k, v, f, dtype) -> torch.Tensor:
    """The softmax MHAda core of _kernel (mhada_pallas.py:42-78) step by
    step, on head-major float32 q, f (B, H, N, d) and k, v (B, H, M, d):
    P = exp(S - max) in float32, P and V^2 rounded to ``dtype`` as the
    product's operands, the product divided by the unrounded row sum, then
    the clamp and the epilogue in float32 -> (B, H, N, d) float32."""
    s = q @ k.transpose(-1, -2)                              # unscaled
    p = torch.exp(s - s.amax(-1, keepdim=True))
    del s
    denom = p.sum(-1, keepdim=True)
    p = p.to(dtype).float()
    m1 = p @ v / denom
    e2 = p @ v.square().to(dtype).float() / denom
    sd = torch.sqrt(torch.clamp(e2 - m1.square(), min=1e-6))
    return sd * f + m1


def mhada_tm_plain(q, k, v, fcs_n, num_heads: int,
                   activation: str = "softmax") -> torch.Tensor:
    """q, fcs_n (B, N, C); k, v (B, M, C) -> (B, N, C)."""
    b, n, c = q.shape
    qh, kh, vh, fh = (_heads(t, num_heads) for t in (q, k, v, fcs_n))
    if activation == "softmax":
        out = mhada_softmax_plain(qh.float(), kh.float(), vh.float(),
                                  fh.float(), v.dtype)
    else:
        out = mhada_attention(qh, kh, vh, fh, activation)
    return out.transpose(1, 2).reshape(b, n, c).to(q.dtype)


def mhada_tm(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             fcs_n: torch.Tensor, num_heads: int,
             backend: str = "auto") -> torch.Tensor:
    """Softmax MHAda core; the K4 kernel for CUDA tensors.

    Forward-only: its training counterpart is K7,
    ``ops.mhada_train.mhada_train``."""
    if not use_kernel(backend, q):
        return mhada_tm_plain(q, k, v, fcs_n, num_heads)
    return _mhada_launch(q, k, v, fcs_n, num_heads)[0]


def _mhada_launch(q, k, v, fcs_n, num_heads: int, splits: int | None = None):
    """Check the CUDA inputs and launch K4, split over the keys as
    ``mhada_partials`` says (``splits`` forces the count, 1 ..
    ceil(M / 64)) -> (out, the float32 partials buffer or None when
    unsplit)."""
    if q.dim() != 3 or k.dim() != 3 or q.shape != fcs_n.shape \
            or k.shape != v.shape or q.shape[0] != k.shape[0] \
            or q.shape[2] != k.shape[2]:
        raise ValueError(
            f"mhada_tm: bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
            f"v {tuple(v.shape)} fcs_n {tuple(fcs_n.shape)}")
    b, n, c = q.shape
    m = k.shape[1]
    if c % num_heads or c // num_heads != HEAD_DIM:
        raise ValueError(f"mhada_tm: the kernel takes head dim {HEAD_DIM}, "
                         f"got C={c} over {num_heads} heads")
    _build.check_cuda_inputs("mhada_tm", q, k, v, fcs_n)
    _build.check_forward_only(
        "mhada_tm", "train through K7, ops.mhada_train.mhada_train",
        q, k, v, fcs_n)
    splits, part = mhada_partials("mhada_tm", splits, q, m, num_heads)
    out = torch.empty_like(q)
    _build.check_aligned("mhada_tm", q, k, v, fcs_n, out, part,
                         dtypes=ALIGNED)
    _build.launch("mhada_mhada_fwd", q.device, q, k, v, fcs_n, out, part, b,
                  n, m, c, num_heads, splits, _build.dtype_code(q))
    return out, part
