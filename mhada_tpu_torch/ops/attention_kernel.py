"""K1: ViT self-attention from the packed qkv (csrc/attention_fwd.cu).

Port of mhada_tpu/ops/attention_pallas.py::attention_pallas_tm.  The twin
``attention_plain`` is the einsum path of mhada_tpu/models/layers.py:200-221
in float32.  At bfloat16 the kernel is the wgmma + TMA attention tile
(csrc/attention_wgmma.cuh), split over the keys as ``self_splits`` picks;
K6's forward (ops/attention_train.py) is the same tile writing the lse.

``attention_cross`` is K1's cross form, N queries against M keys and values
of another tensor: the port of the head-major ``_attention_pallas_call``
(attention_pallas.py:49-85) and of the streaming forward
``_attn_stream_fwd_impl`` (:463-517), which the JAX ViT attention reaches
under sequence parallelism with the keys and values gathered over the
shards (mhada_tpu/models/layers.py:204-208).  Its twin is
``attention_cross_plain``.  Where one block per (batch, head, query block)
would leave block slots of the card idle, the kernel splits the keys over
``cross_splits`` blocks, each writing float32 partials (row max, row sum,
unnormalised output) that a second kernel of the same C entry combines in a
fixed order (csrc/attention_combine.cuh; ``combine_partials`` is that
combine in plain PyTorch; the count's cost model is ops/key_split.py's,
shared with the MHAda tile).
"""

import functools
import math

import torch

from .. import _build
from ..config import use_kernel
# MAX_SPLITS and split_partials are the cross form's too (its callers and
# tests import them from here)
from .key_split import (KEY_TILE, MAX_SPLITS, TILE_BYTES,  # noqa: F401
                        check_splits, pick_splits, sm_count, split_partials)
from .mhada_kernel import ALIGNED

HEAD_DIM = 64


def attention_plain(qkv: torch.Tensor, num_heads: int,
                    scale: float | None = None) -> torch.Tensor:
    """(B, L, 3C) packed qkv -> (B, L, C): per head softmax(Q K^T scale) V."""
    b, l, c3 = qkv.shape
    c = c3 // 3
    d = c // num_heads
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    q, k, v = (t.reshape(b, l, num_heads, d).transpose(1, 2)
               for t in qkv.float().split(c, dim=-1))
    a = torch.softmax(q @ k.transpose(-1, -2) * scale, dim=-1)
    o = (a @ v).transpose(1, 2).reshape(b, l, c)
    return o.to(qkv.dtype)


def attention_tm(qkv: torch.Tensor, num_heads: int,
                 scale: float | None = None,
                 backend: str = "auto") -> torch.Tensor:
    """Token-major self-attention; the K1 kernel for CUDA tensors.

    Forward-only: its training counterpart is K6,
    ``ops.attention_train.attention_train``."""
    if not use_kernel(backend, qkv):
        return attention_plain(qkv, num_heads, scale)
    return _tm_launch(qkv, num_heads, scale)


def _tm_launch(qkv: torch.Tensor, num_heads: int,
               scale: float | None = None,
               splits: int | None = None) -> torch.Tensor:
    """Check a CUDA qkv and launch K1, at bfloat16 split over the keys
    ``splits`` ways (1 .. ceil(L / 64); by default ``self_splits`` picks
    one sequence's count, at every batch) -> out."""
    if qkv.dim() != 3 or qkv.shape[2] % (3 * num_heads):
        raise ValueError(f"attention_tm: bad qkv shape {tuple(qkv.shape)} "
                         f"for {num_heads} heads")
    b, l, c3 = qkv.shape
    c = c3 // 3
    if c // num_heads != HEAD_DIM:
        raise ValueError(f"attention_tm: the kernel takes head dim "
                         f"{HEAD_DIM}, got {c // num_heads}")
    scale = 1.0 / math.sqrt(HEAD_DIM) if scale is None else scale
    check_splits("attention_tm", splits, l)
    check_scale("attention_tm", qkv.dtype, scale)
    _build.check_cuda_inputs("attention_tm", qkv)
    _build.check_forward_only(
        "attention_tm", "train through K6, ops.attention_train."
        "attention_train", qkv)
    out = torch.empty((b, l, c), device=qkv.device, dtype=qkv.dtype)
    # one sequence's count at every batch (self_splits)
    splits, part = self_split_args("attention_tm", qkv, num_heads, splits,
                                   count_batch=1)
    _build.check_aligned("attention_tm", qkv, out, part, dtypes=ALIGNED)
    _build.launch("mhada_attention_fwd", qkv.device, qkv, out, part, b, l, c,
                  num_heads, splits, float(scale), _build.dtype_code(qkv))
    return out


def check_scale(name: str, dtype: torch.dtype, scale: float) -> None:
    """The bfloat16 attention tile takes the row maximum of the raw scores
    times the scale, which is the maximum of the scaled scores only for a
    positive scale (csrc/attention_wgmma.cuh): raise for any other."""
    if dtype == torch.bfloat16 and not scale > 0:
        raise ValueError(f"{name}: the bfloat16 tile takes a positive "
                         f"scale, got {scale}")


def self_splits(batch: int, heads: int, seq: int, dtype: torch.dtype,
                sms: int = 132) -> int:
    """How many blocks K1 and K6's forward give each (batch, head, query
    block) of a self-attention call: at bfloat16 ``cross_splits`` at N = M
    = seq (the same tile); float32 takes none (attention_f32_kernel<lse,
    false>, one block a query block).

    K1 asks for one sequence's count (``batch`` = 1) at every batch: P is
    rounded to bf16 against each split's running maximum, so another count
    rounds a frame otherwise, and a frame stylized in a batch of 8 would
    then differ from the same frame alone (the video CLI's --chunk 8
    against --chunk 1).  K6's forward takes its batch's count."""
    if dtype != torch.bfloat16:
        return 1
    return cross_splits(batch, heads, seq, seq, dtype, sms)


def self_split_args(name: str, qkv: torch.Tensor, num_heads: int,
                    splits: int | None, count_batch: int | None = None):
    """K1's or K6's forward on a CUDA qkv: the split count (``splits``, or
    ``self_splits``' pick at ``count_batch``, qkv's batch by default) and
    the float32 partials buffer it needs (None unsplit) -> (splits,
    part)."""
    b, l, c3 = qkv.shape
    check_splits(name, splits, l)
    if qkv.dtype != torch.bfloat16 and splits not in (None, 1):
        raise ValueError(f"{name}: {qkv.dtype} takes no split over the keys")
    if splits is None:
        splits = self_splits(b if count_batch is None else count_batch,
                             num_heads, l, qkv.dtype,
                             sm_count(qkv.device.index or 0))
    part = None
    if splits > 1:
        part = torch.empty(splits * b * l * (c3 // 3 + 2 * num_heads),
                           device=qkv.device, dtype=torch.float32)
    return splits, part


def attention_cross_plain(q: torch.Tensor, kv: torch.Tensor, num_heads: int,
                          scale: float | None = None) -> torch.Tensor:
    """(B, N, C) queries against (B, M, 2C) keys and values side by side ->
    (B, N, C): per head softmax(Q K^T scale) V, in float32."""
    b, n, c = q.shape
    m, d = kv.shape[1], c // num_heads
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    qh = q.float().reshape(b, n, num_heads, d).transpose(1, 2)
    kh, vh = (t.reshape(b, m, num_heads, d).transpose(1, 2)
              for t in kv.float().split(c, dim=-1))
    a = torch.softmax(qh @ kh.transpose(-1, -2) * scale, dim=-1)
    return (a @ vh).transpose(1, 2).reshape(b, n, c).to(q.dtype)


# The attention tiles at each dtype for ``key_split.pick_splits``: queries
# a block, blocks an SM, what a block costs besides its key walk (set-up,
# pipeline fill, partial store) and what a split block adds, in key tiles
# of its own walk, and the combine's read of a split's float32 O rows (4 C
# bytes a row at the card's memory rate, key_split.TILE_BYTES a key tile)
# times a factor -- float32 attention_f32_kernel (256 queries, 254
# registers, ~12 us a tile on an H100; K1's cross form only: the self
# form's float32 tile takes no split), bf16 attention_wgmma_kernel (3
# consumer warpgroups of 64 queries, 512 threads at 128 registers, ~1 us a
# tile; K1, K6's forward and K1's cross form), each fitted to
# probes/cross_split_sweep.py's device times (bf16: its sweep of both
# forms on the tile with the scale in the exponent's FFMA).
CROSS_BLOCKS = {torch.float32: (256, 1, 1.0, 0.0, 0.0),
                torch.bfloat16: (192, 1, 3.0, 1.0, 1.0)}


@functools.cache
def cross_splits(batch: int, heads: int, n: int, m: int,
                 dtype: torch.dtype, sms: int = 132) -> int:
    """How many blocks the attention tile gives each (batch, head, query
    block) of N queries against M keys: each walks one contiguous range of
    whole 64-key tiles.

    ``key_split.pick_splits`` at the tile's geometry (CROSS_BLOCKS) on a
    grid of B x heads x query blocks and ``sms`` x (blocks an SM) slots: a
    grid that leaves slots idle (B = 1, 8 heads, 1024 queries: 32 f32
    blocks of 132 slots) costs a whole key walk in one partial wave, and a
    split pays for its float32 partials.  On an H100 (132 SMs), B = 1, 8
    heads, it gives float32 4 at 1024 x 4096, 2 at 2048 x 4096, 1 at 4096
    x 16384, and bfloat16 5, 3 and 3: at each the count fastest on the
    device in probes/cross_split_sweep.py's sweep of 1 .. 8 (an H100
    80GB HBM3 at 700 W; at every shape of that sweep, both forms, the
    pick is within 1.4 % of the fastest count)."""
    rows, per_sm, overhead, split_overhead, factor = CROSS_BLOCKS[dtype]
    combine = factor * batch * n * 4 * HEAD_DIM * heads / TILE_BYTES
    return pick_splits(batch * heads * -(-n // rows), -(-m // KEY_TILE),
                       sms * per_sm, overhead, split_overhead, combine)


def combine_partials(o: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                     dtype: torch.dtype, keep: int | None = None):
    """The combine kernel's function in plain PyTorch over the first
    ``keep`` splits (all by default): out = sum_s 2^(m_s - max m) O_s /
    sum_s 2^(m_s - max m) l_s rounded once to ``dtype``, and the row lse =
    max m ln 2 + log sum_s 2^(m_s - max m) l_s in float32 -> (out (B, N,
    C), lse (B, heads, N))."""
    keep = o.shape[0] if keep is None else keep
    o, m, l = o[:keep], m[:keep], l[:keep]
    s, b, n, c = o.shape
    mx = m.amax(0)                                          # (B, H, N)
    w = torch.exp2(m - mx)                                  # (s, B, H, N)
    den = (w * l).sum(0)                                    # (B, H, N)
    num = (o.view(s, b, n, -1, HEAD_DIM)
           * w.permute(0, 1, 3, 2)[..., None]).sum(0)       # (B, N, H, 64)
    out = (num / den.transpose(1, 2)[..., None]).reshape(b, n, c).to(dtype)
    return out, mx * math.log(2.0) + torch.log(den)


def _check_rows(name: str, t: torch.Tensor) -> None:
    """The cross form reads each of q and kv as rows of unit-stride channels
    at one row stride (a column slice of a contiguous tensor, such as the
    packed qkv's first C columns, qualifies), 16 bytes to a row step."""
    b, n, _ = t.shape
    if t.stride(2) != 1 or (b > 1 and t.stride(0) != n * t.stride(1)):
        raise ValueError(f"{name}: {tuple(t.shape)} with strides "
                         f"{t.stride()} is not rows of unit-stride channels")
    if t.stride(1) * t.element_size() % 16:
        raise ValueError(f"{name}: row stride {t.stride(1)} is not a "
                         f"multiple of 16 bytes")


def attention_cross(q: torch.Tensor, kv: torch.Tensor, num_heads: int,
                    scale: float | None = None, backend: str = "auto",
                    splits: int | None = None) -> torch.Tensor:
    """Token-major attention of (B, N, C) queries against (B, M, 2C) keys and
    values (K in the first C channels, V in the next); the K1 kernel's cross
    form for CUDA tensors.  ``q`` may be a column slice of the packed qkv.
    ``splits`` forces the kernel's split over the keys (1 .. ceil(M / 64));
    by default ``cross_splits`` picks it.  Forward-only, as K1."""
    check_splits("attention_cross", splits, kv.shape[1])
    if not use_kernel(backend, q):
        return attention_cross_plain(q, kv, num_heads, scale)
    return _cross_launch(q, kv, num_heads, scale, splits)[0]


def _cross_launch(q: torch.Tensor, kv: torch.Tensor, num_heads: int,
                  scale: float | None = None, splits: int | None = None):
    """Check the CUDA inputs and launch the cross form -> (out, the float32
    partials buffer or None when unsplit)."""
    if (q.dim() != 3 or kv.dim() != 3 or kv.shape[0] != q.shape[0]
            or kv.shape[2] != 2 * q.shape[2] or q.shape[2] % num_heads):
        raise ValueError(f"attention_cross: bad shapes q {tuple(q.shape)}, "
                         f"kv {tuple(kv.shape)} for {num_heads} heads")
    b, n, c = q.shape
    m = kv.shape[1]
    if c // num_heads != HEAD_DIM:
        raise ValueError(f"attention_cross: the kernel takes head dim "
                         f"{HEAD_DIM}, got {c // num_heads}")
    _build.dtype_code(q)
    if kv.device != q.device or kv.dtype != q.dtype:
        raise ValueError("attention_cross: q and kv must share a CUDA device "
                         "and a dtype")
    for name, t in (("q", q), ("kv", kv)):
        _check_rows(f"attention_cross {name}", t)
    _build.check_forward_only("attention_cross", "no training route takes "
                              "the cross form", q, kv)
    scale = 1.0 / math.sqrt(HEAD_DIM) if scale is None else scale
    check_scale("attention_cross", q.dtype, scale)
    if splits is None:
        splits = cross_splits(b, num_heads, n, m, q.dtype,
                              sm_count(q.device.index or 0))
    out = torch.empty((b, n, c), device=q.device, dtype=q.dtype)
    part = None
    if splits > 1:
        part = torch.empty(splits * b * n * (c + 2 * num_heads),
                           device=q.device, dtype=torch.float32)
    _build.check_aligned("attention_cross", q, kv, out, part, dtypes=ALIGNED)
    _build.launch("mhada_attention_cross_fwd", q.device, q, kv, out, part, b,
                  n, m, c, q.stride(1), kv.stride(1), num_heads, splits,
                  float(scale), _build.dtype_code(q))
    return out, part
