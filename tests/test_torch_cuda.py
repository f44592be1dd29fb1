"""The port's CUDA kernels against their plain twins on the card, at small
and ragged shapes (partial query/key tiles, partial decoder tiles, tiny
images) that the 512^2 path never produces, and K1 / K4 just past the TPU
kernels' single-pass limit of 4096 keys.  K1 and K6 (at bf16 on the tensor
cores) also at lengths that are no multiple of 16, with 1, 2 and 8 heads;
a second call must repeat the first bit for bit, and a bfloat16 tensor
that is not 16-byte aligned must raise.  The training kernels K6, K7 and
K8 are held forward and backward (outputs and input gradients), K6 and K7
also at ragged lengths past the TPU training kernels' 2048-key window,
K2's VJP against autograd of the unfused LayerNorm and linear, and the
forward-only wrappers must refuse tensors that require grad.  K3, K4 and
K7 (at bf16 on the tensor cores) also with V = 3 + 0.3 N(0, 1), where E2 -
M1^2 cancels, K4 repeating its output and K7 its gradients bit for bit, K7
at the video-training shape (N = 2048, M = 1024); the video step's shapes
at full width: K6 at B = 2, L = 2048 and 1024, K7 at B = 2, 8 heads, N =
2048 against M = 1024, N = M = 2048 and N = M = 1024, K8 from 128 x 256
and 128^2 at B = 2; the decoder tail (K5,
K8; at bf16 on the tensor cores) also from 256^2 to 512^2, repeating its
outputs bit for bit, K8's gradients against the plain backward on the
kernel forward's ReLU masks with the share of flipped masks bounded
apart; a misaligned bf16 input of K3, K4, K7, the tail or K2 raises too,
as does a bf16 K2 input whose E is no multiple of 8, and a misaligned
float32 input of K3, K4, P2, K1, K6's forward or K7's forward (the
float32 flash tile), whose C entry points also refuse channels that are no
multiple of 4, and of K6's or K7's float32 backward, which the C entry
points refuse; the float32 tail (K5, K8) also refuses a misaligned x in
its wrappers and a misaligned x, weight, output, y1 or c5 in its C entry
points, and K8's float32 y1 and c5 are held at every pixel, its rgb
bit-equal to K5's.  K1, K6's forward and K7's forward also at float32 and C =
512 with ragged lengths, K1's out bit-equal to K6's forward out and K7's
forward out bit-equal to K4's.  K3, K4 and P2 also
at N = 4160, one partial 128-query block of the float32 tile.  K2 (at bf16 on the
tensor cores) also at the ViT's widths, 4096 rows by 512 -> 1536 and 2048,
and at 999 ragged rows.  K13 (c6) and K14 (c1 -> c3; at bf16 an implicit
GEMM on the tensor cores, also at ragged sizes with C = 128 and 256) are
held at small and path shapes, the probes P1 (a tensor-core matmul) and P2
(K3's function; at bf16 a wgmma + TMA kernel, also at the full width with M
no multiple of 64 and N no multiple of its 192-query block), each also
against K3 (float32 1e-6, bf16 1e-2); a misaligned, wrongly typed or
grad-requiring input of P2 or K14 raises.  K6 and K7 also at feature
inversion's B = 1 and 1024 tokens, and one inversion step of the ViT on
the card against the CPU.

K1's cross form (N queries, a column slice of a packed qkv, against M
keys and values) at the sequence-parallel shapes and ragged ones, at
every split count over the keys, the self case (unsplit at float32 bit for
bit K1's, else against the twin), and its wrapper's refusals.  K3 and K4
at bf16 (the wgmma + TMA MHAda tile) at every split count over the keys.

Marked ``cuda``: each test skips without a card.  On a machine with one (the
repo conftest imports jax, which that machine need not have):
``python -m pytest tests/test_torch_cuda.py --noconftest -q``.
"""

import pytest
import torch
import torch.nn.functional as F

from mhada_tpu_torch import _build
from mhada_tpu_torch.ops import attention_train as attention_train_ops
from mhada_tpu_torch.ops.attention_kernel import (MAX_SPLITS, _tm_launch,
                                                  attention_cross,
                                                  attention_cross_plain,
                                                  attention_tm,
                                                  combine_partials,
                                                  split_partials)
from mhada_tpu_torch.ops.attention_train import (attention_train,
                                                 attention_train_fwd_plain)
from mhada_tpu_torch.ops.decoder_c6 import c6_conv
from mhada_tpu_torch.ops.decoder_mid import mid3_fused
from mhada_tpu_torch.ops import decoder_tail as decoder_tail_ops
from mhada_tpu_torch.ops.decoder_tail import decoder_tail, decoder_tail_train
from mhada_tpu_torch.ops.ln_matmul import layer_norm, ln_matmul
from mhada_tpu_torch.ops.mhada_kernel import _mhada_launch, mhada_tm
from mhada_tpu_torch.ops import mhada_train as mhada_train_ops
from mhada_tpu_torch.ops.mhada_train import mhada_train
from mhada_tpu_torch.ops.instance_norm import instance_norm_stats
from mhada_tpu_torch.ops.mhada_prologue import (launch_prologue,
                                                mhada_fused_prologue)
from mhada_tpu_torch.probes.mhada_pipe_probe import mhada_fused_prologue_pipe
from mhada_tpu_torch.probes import mm_probe
from mhada_tpu_torch.probes.mm_probe import mm, mm_plain

# Six test workers share the CPU: cap torch's intra-op threads.
torch.set_num_threads(2)

pytestmark = pytest.mark.cuda

DTYPES = [torch.float32, torch.bfloat16]
# float32: max |kernel - twin| / max |twin| <= 1e-4, the two differ in
# summation order only (TF32 off).  bfloat16: both paths round intermediates
# to bf16 at slightly different points, so the kernel is held against the
# float32 twin on the same (bf16-valued) inputs and may be at most twice as
# far from it as the bf16 twin is.
REL_F32 = 1e-4
# Gradients sum over every row in another order than the twin's: 1e-3.
REL_F32_GRAD = 1e-3
# The decoder tail: the share of ReLU masks (rgb, y1, c5) that may differ
# between the kernel and plain forwards, as chip_smoke.py's TAIL_FLIPS.
TAIL_FLIPS = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator().manual_seed(0)


def _rnd(g, dtype, *shape, scale=1.0):
    """bf16-representable values when dtype is bf16, held in float32."""
    return (torch.randn(*shape, generator=g) * scale).to("cuda", dtype).float()


def _check(entry, run, dtype, launches=1):
    """run(backend, dtype) -> output; the inputs it closes over are float32.
    The kernel call launches ``entry`` ``launches`` times."""
    before = _build.LAUNCHES[entry]
    got = run("kernel", dtype).float()
    assert _build.LAUNCHES[entry] == before + launches
    ref = run("plain", dtype).float()
    ref32 = run("plain", torch.float32)
    assert _build.LAUNCHES[entry] == before + launches  # the twin: none
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    if dtype == torch.float32:
        rel = (got - ref).abs().max().item() / ref.abs().max().item()
        assert rel <= REL_F32, rel
    else:
        err = (got - ref32).abs().max().item()
        err_plain = (ref - ref32).abs().max().item()
        assert err <= 2 * err_plain, (err, err_plain)


# (batch, tokens, heads) of the attention kernels: ragged lengths (not a
# multiple of 16 or 64), 1, 2 and 8 heads, and past 4096 keys.
ATTN_SHAPES = [(2, 100, 2), (1, 64, 2), (1, 7, 2), (1, 80, 1), (2, 1000, 8),
               (1, 2049, 8)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,l,heads", ATTN_SHAPES + [(1, 4160, 2)])
def test_attention_kernel(gen, dtype, b, l, heads):
    """K1 against its twin; a second call repeats the first bit for bit."""
    qkv = _rnd(gen, dtype, b, l, 3 * 64 * heads)
    _check("mhada_attention_fwd",
           lambda be, dt: attention_tm(qkv.to(dt), heads, backend=be), dtype)
    first, again = (attention_tm(qkv.to(dtype), heads) for _ in range(2))
    assert torch.equal(first, again)


# K1's cross form (batch, queries, keys, heads): the sequence-parallel
# gate shapes at the full width (512^2 over 4 and 2 ranks, 1024^2 over 4)
# and ragged lengths (no 64-key tile, 64- or 256-query block divides them).
CROSS_SHAPES = [(1, 1024, 4096, 8), (1, 2048, 4096, 8), (1, 4096, 16384, 8),
                (2, 200, 700, 2), (1, 1, 63, 2)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,n,m,heads", CROSS_SHAPES)
def test_attention_cross_kernel(gen, dtype, b, n, m, heads):
    """K1's cross form, q a column slice of a packed qkv (row stride 3C)
    against a (B, M, 2C) kv, against attention_cross_plain; one launch a
    call; a second call repeats the first bit for bit."""
    c = 64 * heads
    qkv = _rnd(gen, dtype, b, n, 3 * c)
    kv = _rnd(gen, dtype, b, m, 2 * c)

    def run(be, dt):
        return attention_cross(qkv.to(dt)[..., :c], kv.to(dt), heads,
                               backend=be)

    _check("mhada_attention_cross_fwd", run, dtype)
    assert torch.equal(run("kernel", dtype), run("kernel", dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,l,heads", [(2, 100, 2), (1, 4096, 8)])
def test_attention_cross_self_case(gen, dtype, b, l, heads):
    """Self-attention is the cross form's case q = qkv[..., :C], kv =
    qkv[..., C:].  Unsplit, the cross form runs K1's own kernel on the same
    data at both dtypes (float32 attention_f32_kernel, bfloat16 the wgmma
    tile): bit for bit.  Split, it is held against the twin as the cross
    gates are.  K1's own launch count moves only on attention_tm."""
    c = 64 * heads
    qkv = _rnd(gen, dtype, b, l, 3 * c).to(dtype)
    before = dict(_build.LAUNCHES)
    own = _tm_launch(qkv, heads, splits=1)
    assert torch.equal(own, attention_cross(qkv[..., :c], qkv[..., c:],
                                            heads, splits=1))
    assert _build.LAUNCHES["mhada_attention_fwd"] == \
        before["mhada_attention_fwd"] + 1
    _check("mhada_attention_cross_fwd",
           lambda be, dt: attention_cross(qkv.to(dt)[..., :c],
                                          qkv.to(dt)[..., c:], heads,
                                          backend=be), dtype)
    assert _build.LAUNCHES["mhada_attention_fwd"] == \
        before["mhada_attention_fwd"] + 1


@pytest.mark.parametrize("dtype", DTYPES)
def test_attention_cross_forced_splits(gen, dtype):
    """Every split count the chooser can give (1 .. MAX_SPLITS), forced at
    (2, 200, 700, 2): 11 key tiles, the last of 60 keys; one launch a call
    (the combine included), each against the twin and repeated bit for
    bit; a count that leaves a split without a key tile raises before any
    launch."""
    b, n, m, heads = 2, 200, 700, 2
    c = 64 * heads
    qkv = _rnd(gen, dtype, b, n, 3 * c)
    kv = _rnd(gen, dtype, b, m, 2 * c)
    for splits in range(1, MAX_SPLITS + 1):
        def run(be, dt, splits=splits):
            return attention_cross(qkv.to(dt)[..., :c], kv.to(dt), heads,
                                   backend=be, splits=splits)

        _check("mhada_attention_cross_fwd", run, dtype)
        assert torch.equal(run("kernel", dtype), run("kernel", dtype))
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match="without a 64-key tile"):
        attention_cross(qkv.to(dtype)[..., :c], kv.to(dtype), heads,
                        splits=12)
    assert _build.LAUNCHES == before


@pytest.mark.parametrize("b,l,heads", [(2, 200, 2), (2, 700, 2),
                                       (1, 1000, 8)])
def test_attention_self_forced_splits(gen, b, l, heads):
    """K1 and K6's forward at bfloat16 on the wgmma tile at every split
    count over the keys (1 .. MAX_SPLITS, as far as the key tiles allow) at
    ragged L and B = 2: one launch a call (the combine included), out
    against the twins and repeated bit for bit, K6's lse against the plain
    lse (float32, 1e-5 of its scale: P rounds to bf16 only inside P V);
    float32 takes no split, and a count past the key tiles or a scale
    that is not positive raises before any launch; the C entries refuse
    that scale too."""
    dtype = torch.bfloat16
    c = 64 * heads
    qkv = _rnd(gen, dtype, b, l, 3 * c, scale=0.5)
    tiles = -(-l // 64)
    _, lse_ref = attention_train_fwd_plain(qkv, heads, 0.125)
    for splits in range(1, min(tiles, MAX_SPLITS) + 1):
        def k1(be, dt, splits=splits):
            if be == "plain":
                return attention_tm(qkv.to(dt), heads, backend=be)
            return _tm_launch(qkv.to(dt), heads, splits=splits)

        def k6(be, dt, splits=splits):
            if be == "plain":
                return attention_train_fwd_plain(qkv.to(dt), heads, 0.125)[0]
            return attention_train_ops.fwd_launch(qkv.to(dt), heads, 0.125,
                                                  splits)[0]

        _check("mhada_attention_fwd", k1, dtype)
        _check("mhada_attention_train_fwd", k6, dtype)
        assert torch.equal(k1("kernel", dtype), k1("kernel", dtype))
        out, lse, _ = attention_train_ops.fwd_launch(qkv.to(dtype), heads,
                                                     0.125, splits)
        again = attention_train_ops.fwd_launch(qkv.to(dtype), heads, 0.125,
                                               splits)
        assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
        assert torch.equal(out, k1("kernel", dtype))   # one tile, one split
        err = (lse - lse_ref).abs().max().item()
        assert err <= 1e-5 * lse_ref.abs().max().item(), (splits, err)
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match="without a 64-key tile"):
        _tm_launch(qkv.to(dtype), heads, splits=tiles + 1)
    with pytest.raises(ValueError, match="takes no split"):
        _tm_launch(qkv, heads, splits=2)
    with pytest.raises(ValueError, match="takes no split"):
        attention_train_ops.fwd_launch(qkv, heads, 0.125, 2)
    with pytest.raises(ValueError, match="positive scale"):
        _tm_launch(qkv.to(dtype), heads, -0.125)
    with pytest.raises(ValueError, match="positive scale"):
        attention_train_ops.fwd_launch(qkv.to(dtype), heads, 0.0)
    with pytest.raises(ValueError, match="positive scale"):
        attention_cross(qkv.to(dtype)[..., :c], qkv.to(dtype)[..., c:],
                        heads, -0.125)
    out = torch.empty(b, l, c, device="cuda", dtype=dtype)
    lse = torch.empty(b, heads, l, device="cuda")
    for entry, args in (("mhada_attention_fwd", (out,)),
                        ("mhada_attention_train_fwd", (out, lse))):
        with pytest.raises(RuntimeError, match="CUDA error"):
            _build.launch(entry, qkv.device, qkv.to(dtype), *args, None, b,
                          l, c, heads, 1, -0.125, _build.dtype_code(out))
    assert _build.LAUNCHES == before


@pytest.mark.parametrize("b,l,heads", [(2, 700, 2), (1, 4096, 8)])
def test_attention_self_split_control(gen, b, l, heads):
    """K6's forward split over the keys: its partials combined in plain
    PyTorch (``combine_partials``) give the kernel's out within one bf16
    step and its lse within 1e-5 of its scale; without the last split both
    are far off (the planted control of chip_smoke.py's K6 gate)."""
    c = 64 * heads
    qkv = _rnd(gen, torch.bfloat16, b, l, 3 * c, scale=0.5).to(torch.bfloat16)
    splits = 3
    out, lse, part = attention_train_ops.fwd_launch(qkv, heads, 0.125, splits)
    views = split_partials(part, splits, b, l, c, heads)
    whole, whole_lse = combine_partials(*views, torch.float32)
    scale = out.float().abs().max().item()
    assert (whole - out.float()).abs().max().item() <= 2 ** -8 * scale
    assert (whole_lse - lse).abs().max().item() <= \
        1e-5 * lse.abs().max().item()
    dropped, dropped_lse = combine_partials(*views, torch.float32,
                                            keep=splits - 1)
    assert (dropped - out.float()).abs().max().item() > 0.05 * scale
    assert (dropped_lse - lse).abs().max().item() > 1e-3


@pytest.mark.parametrize("entry", ["mhada_mhada_prologue",
                                   "mhada_mhada_fwd"])
def test_mhada_forced_splits(gen, entry):
    """K3 and K4 at bf16 on the MHAda tile at every split count over the
    keys (1 .. MAX_SPLITS), forced through ``_mhada_launch`` and
    ``launch_prologue`` at (2, 200, 700) with V = 3 + 0.3 N(0, 1): 11 key
    tiles, the last of 60 keys; one launch a call (the combine
    included), each against the twin and repeated bit for bit; a count
    that leaves a split without a key tile, and a split of the float32
    tile, raise before any launch."""
    b, n, m, heads = 2, 200, 700, 2
    c = 64 * heads
    fc = _rnd(gen, torch.bfloat16, b, n, c, scale=2.0) + 1
    fcs = _rnd(gen, torch.bfloat16, b, n, c, scale=3.0) - 1
    stats = torch.stack([*instance_norm_stats(fc), *instance_norm_stats(fcs)],
                        1)
    wf = _rnd(gen, torch.bfloat16, heads, 64, 64, scale=1 / 8)
    fb = _rnd(gen, torch.bfloat16, heads, 64, scale=1 / 8)
    k = _rnd(gen, torch.bfloat16, b, m, c, scale=0.35)
    v = _v(gen, torch.bfloat16, b, m, 3.0)

    def call(be, dt, splits):
        if entry == "mhada_mhada_fwd":
            x = fc.to(dt), k.to(dt), v.to(dt), fcs.to(dt)
            return (mhada_tm(*x, heads, backend=be) if be == "plain"
                    else _mhada_launch(*x, heads, splits)[0])
        x = fc.to(dt), fcs.to(dt), stats, wf, fb, k.to(dt), v.to(dt)
        return (mhada_fused_prologue(*x, backend=be) if be == "plain"
                else launch_prologue(entry, *x, splits)[0])

    for splits in range(1, MAX_SPLITS + 1):
        def run(be, dt, splits=splits):
            return call(be, dt, splits)

        _check(entry, run, torch.bfloat16)
        assert torch.equal(run("kernel", torch.bfloat16),
                           run("kernel", torch.bfloat16))
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match="without a 64-key tile"):
        call("kernel", torch.bfloat16, 12)
    with pytest.raises(ValueError, match="float32 tile takes no split"):
        call("kernel", torch.float32, 2)
    assert _build.LAUNCHES == before


def test_attention_cross_refusals(gen):
    """The cross form's wrapper raises before any launch on: a float32 or
    bf16 operand one element into its buffer, a row stride that is no
    multiple of 16 bytes, channels that are not unit-stride, mismatched
    widths, a head dim other than 64, and a CUDA input that requires grad
    while grad mode is on (forward-only, as K1)."""
    b, n, m, heads = 1, 70, 90, 2
    c = 64 * heads
    before = dict(_build.LAUNCHES)
    for dt in DTYPES:
        def off(*shape):
            buf = torch.zeros(torch.Size(shape).numel() + 1, device="cuda",
                              dtype=dt)
            return buf[1:].view(shape)

        q = torch.zeros(b, n, c, device="cuda", dtype=dt)
        kv = torch.zeros(b, m, 2 * c, device="cuda", dtype=dt)
        for args in ((off(b, n, c), kv), (q, off(b, m, 2 * c))):
            with pytest.raises(ValueError, match="16-byte aligned"):
                attention_cross(*args, heads)
        wide = torch.zeros(b, n, c + 1, device="cuda", dtype=dt)
        with pytest.raises(ValueError, match="16 bytes"):
            attention_cross(wide[..., :c], kv, heads)
        with pytest.raises(ValueError, match="unit-stride"):
            attention_cross(q.transpose(1, 2).contiguous().transpose(1, 2),
                            kv, heads)
        with pytest.raises(ValueError, match="bad shapes"):
            attention_cross(q, kv[..., :c], heads)
        with pytest.raises(ValueError, match="head dim"):
            attention_cross(q, kv, 4)
        with pytest.raises(RuntimeError, match="forward-only"):
            attention_cross(q.requires_grad_(), kv, heads)
    assert _build.LAUNCHES == before
    with torch.no_grad():   # grad mode off: the same input launches
        attention_cross(q, kv, heads)
    assert _build.LAUNCHES["mhada_attention_cross_fwd"] == \
        before["mhada_attention_cross_fwd"] + 1


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,n,m", [(2, 70, 130), (1, 64, 64), (1, 1, 200),
                                   (1, 4160, 4160)])
def test_mhada_kernel(gen, dtype, b, n, m):
    q = _rnd(gen, dtype, b, n, 128, scale=0.35)
    k = _rnd(gen, dtype, b, m, 128, scale=0.35)
    v, f = _rnd(gen, dtype, b, m, 128), _rnd(gen, dtype, b, n, 128)
    _check("mhada_mhada_fwd",
           lambda be, dt: mhada_tm(q.to(dt), k.to(dt), v.to(dt), f.to(dt), 2,
                                   backend=be), dtype)


# (batch, queries, keys, V's offset) of the MHAda kernels: ragged lengths,
# N = 1, past 4096 keys; V = 3 + 0.3 N(0, 1) where V's offset is 3.
# N = 4160: 32 full 128-query blocks of the float32 tile and a partial one.
MHADA_SHAPES = [(2, 70, 130, 0.0), (1, 1, 200, 0.0), (1, 64, 64, 0.0),
                (1, 300, 4100, 0.0), (2, 70, 130, 3.0), (1, 300, 4100, 3.0),
                (1, 4160, 300, 0.0)]


def _v(gen, dtype, b, m, shift):
    """V: N(0, 1), or 3 + 0.3 N(0, 1) when shifted."""
    return _rnd(gen, dtype, b, m, 128, scale=0.3 if shift else 1.0) + shift


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,n,m,shift", MHADA_SHAPES)
def test_mhada_kernel_v_offset(gen, dtype, b, n, m, shift):
    """K4 against its twin over MHADA_SHAPES, V offset included (keys past
    M masked, N = 1, N != M); a second call repeats the first bit for
    bit."""
    q = _rnd(gen, dtype, b, n, 128, scale=0.35)
    k = _rnd(gen, dtype, b, m, 128, scale=0.35)
    v, f = _v(gen, dtype, b, m, shift), _rnd(gen, dtype, b, n, 128)

    def run(be, dt):
        return mhada_tm(q.to(dt), k.to(dt), v.to(dt), f.to(dt), 2,
                        backend=be)

    _check("mhada_mhada_fwd", run, dtype)
    assert torch.equal(run("kernel", dtype), run("kernel", dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,n,m,shift", MHADA_SHAPES)
@pytest.mark.parametrize("entry", ["mhada_mhada_prologue",
                                   "mhada_mhada_prologue_pipe"])
def test_mhada_prologue_kernel(gen, dtype, b, n, m, shift, entry):
    """K3, and the probe P2 of the same function, against the plain
    version; P2 also against K3 (PIPE_K3_REL): at float32 the same
    arithmetic in the same order, at bf16 the same tile (P2 never split,
    K3 split as its chooser picks: P rounded against each split's own
    maximum)."""
    fn = {"mhada_mhada_prologue": mhada_fused_prologue,
          "mhada_mhada_prologue_pipe": mhada_fused_prologue_pipe}[entry]
    fc = _rnd(gen, dtype, b, n, 128, scale=2.0) + 1
    fcs = _rnd(gen, dtype, b, n, 128, scale=3.0) - 1
    mc, rc = instance_norm_stats(fc)
    ms, rs = instance_norm_stats(fcs)
    stats = torch.stack([mc, rc, ms, rs], 1)
    wf = _rnd(gen, dtype, 2, 64, 64, scale=1 / 8)
    fb = _rnd(gen, dtype, 2, 64, scale=1 / 8)
    k = _rnd(gen, dtype, b, m, 128, scale=0.35)
    v = _v(gen, dtype, b, m, shift)

    def args(dt):
        return fc.to(dt), fcs.to(dt), stats, wf, fb, k.to(dt), v.to(dt)

    _check(entry, lambda be, dt: fn(*args(dt), backend=be), dtype)
    if entry == "mhada_mhada_prologue_pipe":
        _check_pipe_against_k3(args(dtype))


# max |P2 - K3| / max |K3|, as chip_smoke.py's PIPE_K3_REL.
PIPE_K3_REL = {torch.float32: 1e-6, torch.bfloat16: 1e-2}


def _check_pipe_against_k3(inputs):
    pipe = mhada_fused_prologue_pipe(*inputs).float()
    k3 = mhada_fused_prologue(*inputs).float()
    torch.cuda.synchronize()
    rel = (pipe - k3).abs().max().item() / k3.abs().max().item()
    assert rel <= PIPE_K3_REL[inputs[0].dtype], rel


@pytest.mark.parametrize("b,n,m,heads", [(2, 200, 130, 8), (2, 385, 1000, 2),
                                         (1, 1, 63, 8)])
def test_pipe_wgmma_kernel(gen, b, n, m, heads):
    """P2 at bf16 (csrc/mhada_wgmma.cuh) against the plain version and K3:
    M no multiple of 64 (the 3-D tensor map zero-fills the last key tile
    inside its own batch, the mask does the rest), N no multiple of the
    192-query block, B = 2; the full width (8 heads) and 2 heads."""
    c = 64 * heads
    fc = _rnd(gen, torch.bfloat16, b, n, c, scale=2.0) + 1
    fcs = _rnd(gen, torch.bfloat16, b, n, c, scale=3.0) - 1
    stats = torch.stack([*instance_norm_stats(fc),
                         *instance_norm_stats(fcs)], 1)
    wf = _rnd(gen, torch.bfloat16, heads, 64, 64, scale=1 / 8)
    fb = _rnd(gen, torch.bfloat16, heads, 64, scale=1 / 8)
    k = _rnd(gen, torch.bfloat16, b, m, c, scale=0.35)
    v = _rnd(gen, torch.bfloat16, b, m, c)

    def args(dt):
        return fc.to(dt), fcs.to(dt), stats, wf, fb, k.to(dt), v.to(dt)

    _check("mhada_mhada_prologue_pipe",
           lambda be, dt: mhada_fused_prologue_pipe(*args(dt), backend=be),
           torch.bfloat16)
    _check_pipe_against_k3(args(torch.bfloat16))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,f", [((2, 100, 128), 200), ((1, 64, 96), 64),
                                     ((3, 5, 40), 7), ((1, 4096, 512), 1536),
                                     ((1, 4096, 512), 2048),
                                     ((3, 333, 512), 2048)])
def test_ln_matmul_kernel(gen, dtype, shape, f):
    """K2 against its twin at ragged shapes (rows, F and E off the block
    tile and the k-chunk) and at the ViT's qkv and fc1 widths."""
    e = shape[-1]
    x = _rnd(gen, dtype, *shape)
    lw = (1 + 0.1 * torch.randn(e, generator=gen)).cuda()
    lb = (0.1 * torch.randn(e, generator=gen)).cuda()
    w = _rnd(gen, dtype, f, e, scale=e ** -0.5)
    bias = _rnd(gen, dtype, f, scale=0.1)
    _check("mhada_ln_matmul",
           lambda be, dt: ln_matmul(x.to(dt), lw, lb, w, bias, backend=be),
           dtype)


def _tail_weights(gen, dtype, shift=0.0):
    """The tail's conv weights at their init scale U(-1/sqrt(fan_in),
    1/sqrt(fan_in)), biases shifted by ``shift`` bounds; bf16-valued when
    dtype is bf16, held in float32."""
    def conv(co, ci):
        bound = 1 / (ci * 9) ** 0.5
        w = (torch.rand(co, ci, 3, 3, generator=gen) * 2 - 1) * bound
        b = (torch.rand(co, generator=gen) * 2 - 1 + shift) * bound
        return w.to("cuda", dtype).float(), b.to("cuda", dtype).float()

    return [t for co, ci in ((64, 128), (64, 64), (3, 64))
            for t in conv(co, ci)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(1, 8, 12, 128), (2, 6, 10, 128),
                                   (1, 2, 3, 128), (1, 16, 16, 128),
                                   (1, 17, 33, 128), (3, 40, 24, 128),
                                   (1, 256, 256, 128)])
def test_decoder_tail_kernel(gen, dtype, shape):
    """K5 against its twin, from 2 x 3 to 256^2 low-res (partial output
    tiles, reflected windows; the float32 kernels' 8 x 32 up3 tiles and 14
    x 30 rgb tiles ragged in both directions at 17 x 33 and 40 x 24); a
    second call repeats the first bit for bit."""
    x = _rnd(gen, dtype, *shape).abs()
    ws = _tail_weights(gen, dtype)

    def run(be, dt):
        return decoder_tail(x.to(dt), *ws, backend=be)

    _check("mhada_decoder_tail", run, dtype)
    assert torch.equal(run("kernel", dtype), run("kernel", dtype))


@pytest.mark.parametrize("shape", [(1, 2, 3, 128), (2, 6, 10, 128),
                                   (1, 17, 33, 128), (3, 40, 24, 128),
                                   (2, 128, 128, 128)])
def test_decoder_tail_f32_residuals(gen, shape):
    """K8 at float32: rgb, y1 and c5 against the plain version at every
    pixel, each within REL_F32 of its own largest value (biases shifted
    positive: few pre-activations at 0); K8's rgb equals K5's bit for bit
    on the same inputs (one upsample + c5 + c6 kernel, with and without the
    residual stores)."""
    x = _rnd(gen, torch.float32, *shape).abs()
    ws = _tail_weights(gen, torch.float32, shift=1.0)
    before = dict(_build.LAUNCHES)
    got = decoder_tail_ops._launch_tail("mhada_decoder_tail_res", x, *ws)
    k5 = decoder_tail(x, *ws)
    assert _build.LAUNCHES["mhada_decoder_tail_res"] == \
        before["mhada_decoder_tail_res"] + 1
    assert _build.LAUNCHES["mhada_decoder_tail"] == \
        before["mhada_decoder_tail"] + 1
    ref = decoder_tail_ops.decoder_tail_res_plain(x, *ws)
    torch.cuda.synchronize()
    for name, g, r in zip(("rgb", "y1", "c5"), got, ref):
        assert g.shape == r.shape, name
        assert torch.isfinite(g).all(), name
        rel = (g - r).abs().max().item() / r.abs().max().item()
        assert rel <= REL_F32, (name, rel)
    assert torch.equal(got[0], k5)


@pytest.mark.parametrize("entry", ["mhada_decoder_tail",
                                   "mhada_decoder_tail_res"])
def test_decoder_tail_f32_rejects_unaligned(gen, entry):
    """The float32 tail copies and stores 16 bytes at a time: the wrappers
    of K5 and K8 raise on a float32 x one element into its buffer, and the
    C entry points refuse a misaligned x, weight, output, y1 scratch or
    residual; nothing launches."""
    b, h, w = 1, 6, 10

    def off(*shape):
        buf = torch.zeros(torch.Size(shape).numel() + 1, device="cuda")
        return buf[1:].view(shape)

    ws = _tail_weights(gen, torch.float32)
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match="16-byte aligned"):
        if entry == "mhada_decoder_tail":
            decoder_tail(off(b, h, w, 128), *ws)
        else:
            decoder_tail_train(off(b, h, w, 128), *ws)
    hwio = [t.permute(2, 3, 1, 0).contiguous() for t in ws[::2]]
    shapes = {"x": (b, h, w, 128), "w_up": (3, 3, 128, 64),
              "w5": (3, 3, 64, 64), "w6": (3, 3, 64, 3),
              "out": (b, 2 * h, 2 * w, 3), "y1": (b, h, w, 64)}
    if entry == "mhada_decoder_tail_res":
        shapes["c5"] = (b, 2 * h, 2 * w, 64)

    def args(t):
        return [t["x"], t["w_up"], ws[1], t["w5"], ws[3], t["w6"], ws[5],
                t["out"], t["y1"], *([t["c5"]] if "c5" in t else []),
                b, h, w, 0]

    good = {"x": torch.zeros(shapes["x"], device="cuda"),
            "w_up": hwio[0], "w5": hwio[1], "w6": hwio[2],
            **{k: torch.zeros(shapes[k], device="cuda")
               for k in ("out", "y1", "c5") if k in shapes}}
    for name in shapes:
        t = dict(good, **{name: off(*shapes[name])})
        with pytest.raises(RuntimeError, match="CUDA error"):
            _build.launch(entry, good["x"].device, *args(t))
    assert _build.LAUNCHES == before
    _build.launch(entry, good["x"].device, *args(good))   # aligned: launches
    assert _build.LAUNCHES[entry] == before[entry] + 1


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(1, 2, 3, 64), (2, 17, 33, 64),
                                   (1, 512, 512, 64), (1, 2, 2, 64),
                                   (3, 5, 2, 64), (2, 19, 70, 64),
                                   (1, 264, 488, 64), (8, 256, 512, 64)])
def test_decoder_c6_kernel(gen, dtype, shape):
    """K13 against its twin: a 2 x 2 and a 2-wide image, strips and column
    blocks that do not divide H or W, the video CLI's B = 8 batch."""
    y = _rnd(gen, dtype, *shape).abs()
    w6 = _rnd(gen, dtype, 3, 64, 3, 3, scale=1 / 24)
    b6 = (torch.rand(3, generator=gen) / 24).cuda()
    _check("mhada_decoder_c6",
           lambda be, dt: c6_conv(y.to(dt), w6, b6, backend=be), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(1, 2, 3, 128), (2, 9, 20, 128),
                                   (2, 19, 37, 128), (2, 19, 37, 256),
                                   (1, 128, 128, 256)])
def test_decoder_mid_kernel(gen, dtype, shape):
    """K14 against its twin, three launches; ragged tiles at C = 128 and
    256 (two channel blocks, four input-channel chunks at bf16)."""
    c = shape[-1]
    x = _rnd(gen, dtype, *shape)
    params = [t for _ in range(3)
              for t in (_rnd(gen, dtype, c, c, 3, 3, scale=0.5 / c ** 0.5),
                        _rnd(gen, dtype, c, scale=0.1))]
    _check("mhada_decoder_mid_conv",
           lambda be, dt: mid3_fused(x.to(dt), *params, backend=be), dtype,
           launches=3)


@pytest.mark.parametrize("m,k,n", [(64, 64, 64), (128, 2048, 192)])
def test_mm_probe_kernel(gen, m, k, n):
    a = _rnd(gen, torch.bfloat16, m, k, scale=0.1).to(torch.bfloat16)
    b = _rnd(gen, torch.bfloat16, k, n, scale=0.1).to(torch.bfloat16)
    before = _build.LAUNCHES["mhada_mm_probe"]
    got = mm(a, b, reps=3).float()
    assert _build.LAUNCHES["mhada_mm_probe"] == before + 1
    ref = mm_plain(a, b).float()
    torch.cuda.synchronize()
    # both round one float32 sum to bf16: at most one bf16 step apart
    assert ((got - ref).abs() <= ref.abs() * 2 ** -7
            + 1e-3 * ref.abs().max()).all()


@pytest.mark.parametrize("block_tile", mm_probe.BLOCK_TILES)
def test_mm_probe_block_tiles(gen, block_tile):
    """Every block tile P1's kernel is built with, at two blocks a side
    and three k stages, within one bf16 step of the plain product."""
    bm, bn = block_tile
    a = _rnd(gen, torch.bfloat16, 2 * bm, 192, scale=0.1).to(torch.bfloat16)
    b = _rnd(gen, torch.bfloat16, 192, 2 * bn, scale=0.1).to(torch.bfloat16)
    got = mm_probe._launch(a, b, 2, block_tile).float()
    ref = mm_plain(a, b).float()
    torch.cuda.synchronize()
    assert ((got - ref).abs() <= ref.abs() * 2 ** -7
            + 1e-3 * ref.abs().max()).all()


def test_f32_mid_rejects_unaligned(gen):
    """K14's float32 conv copies 16 bytes of weights at a time and stores 16
    bytes of y: a float32 x one element into its buffer raises in the
    wrapper before any launch; aligned, it launches three times."""
    buf = torch.zeros(4 * 4 * 128 + 1, device="cuda")
    w, b = torch.zeros(128, 128, 3, 3, device="cuda"), torch.zeros(
        128, device="cuda")
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match="16-byte aligned"):
        mid3_fused(buf[1:].view(1, 4, 4, 128), w, b, w, b, w, b)
    assert _build.LAUNCHES == before
    mid3_fused(buf[:-1].view(1, 4, 4, 128), w, b, w, b, w, b)
    assert _build.LAUNCHES["mhada_decoder_mid_conv"] == before[
        "mhada_decoder_mid_conv"] + 3


@pytest.mark.parametrize("entry", ["mhada_mhada_fwd", "mhada_mhada_prologue",
                                   "mhada_mhada_prologue_pipe"])
def test_f32_mhada_rejects_unaligned(gen, entry):
    """The float32 MHAda tile (K4, K3, P2) copies 16 bytes at a time: a
    float32 operand one element into its buffer raises in the wrapper
    (every operand in turn), and the C entry point itself refuses channels
    that are no multiple of 4 (the wrappers refuse them as heads that are
    not 64 wide); nothing launches."""
    b, n, m, c = 1, 16, 24, 128

    def off(*shape):
        buf = torch.zeros(torch.Size(shape).numel() + 1, device="cuda")
        return buf[1:].view(shape)

    def tensors(c):
        ones = torch.ones(b, 4, c, device="cuda")
        return {"q": torch.zeros(b, n, c, device="cuda"),
                "k": torch.zeros(b, m, c, device="cuda"),
                "v": torch.zeros(b, m, c, device="cuda"),
                "f": torch.zeros(b, n, c, device="cuda"), "stats": ones,
                "wf": torch.zeros(2, 64, 64, device="cuda"),
                "fb": torch.zeros(2, 64, device="cuda")}

    fn = {"mhada_mhada_prologue": mhada_fused_prologue,
          "mhada_mhada_prologue_pipe": mhada_fused_prologue_pipe}.get(entry)

    def call(t):
        if fn is None:
            return mhada_tm(t["q"], t["k"], t["v"], t["f"], 2)
        return fn(t["q"], t["f"], t["stats"], t["wf"], t["fb"], t["k"],
                  t["v"])

    before = dict(_build.LAUNCHES)
    names = "qkvf" if fn is None else ["q", "f", "stats", "wf", "fb", "k",
                                       "v"]
    for name in names:
        t = tensors(c)
        t[name] = off(*t[name].shape)
        with pytest.raises(ValueError, match="16-byte aligned"):
            call(t)
    with pytest.raises(ValueError, match="head"):
        call(tensors(130))
    t = tensors(130)
    out = torch.zeros(b, n, 130, device="cuda")
    args = ([t["q"], t["k"], t["v"], t["f"], out] if fn is None else
            [t["q"], t["f"], t["stats"], t["wf"], t["fb"], t["k"], t["v"],
             out])
    with pytest.raises(RuntimeError, match="CUDA error"):   # unsplit
        _build.launch(entry, out.device, *args, None, b, n, m, 130, 2, 1, 0)
    assert _build.LAUNCHES == before
    call(tensors(c))   # aligned: launches
    assert _build.LAUNCHES[entry] == before[entry] + 1


@pytest.mark.parametrize("kind", ["attention", "mhada"])
def test_f32_train_bwd_rejects_unaligned(gen, kind):
    """The float32 flash backward (K6's and K7's) copies 16 bytes at a
    time: its C entry points refuse a float32 operand one element into its
    buffer (every operand in turn), which the wrappers raise; nothing
    launches."""
    b, n, m, heads = 1, 70, 90, 2
    c = 64 * heads

    def off(*shape):
        buf = torch.zeros(torch.Size(shape).numel() + 1, device="cuda")
        return buf[1:].view(shape)

    lse = torch.zeros(b, heads, n, device="cuda")
    delta = torch.zeros(b, heads, n, device="cuda")
    if kind == "attention":
        shapes = {"qkv": (b, n, 3 * c), "g": (b, n, c)}
    else:
        shapes = {"q": (b, n, c), "k": (b, m, c), "v": (b, m, c),
                  "dm1": (b, n, c), "de2": (b, n, c)}
    before = dict(_build.LAUNCHES)
    for name in shapes:
        t = {key: torch.zeros(shape, device="cuda")
             for key, shape in shapes.items()}
        t[name] = off(*shapes[name])
        with pytest.raises(RuntimeError, match="CUDA error"):
            if kind == "attention":
                attention_train_ops._bwd_kernel(t["qkv"], lse, delta, t["g"],
                                                heads, 0.125)
            else:
                mhada_train_ops._bwd_kernel(t["q"], t["k"], t["v"], t["dm1"],
                                            t["de2"], lse, delta, heads)
    assert _build.LAUNCHES == before


def test_k7_bf16_splits_and_repeat(gen):
    """K7 at bf16 on the wgmma tiles at (2, 200, 700), 2 heads, V = 3 +
    0.3 N(0, 1): its forward's out bit for bit K4's at every forced split
    count (one tile; K7 also stores M1, E2 and the lse, which match the
    plain version's), one launch a call; its backward within the bf16
    gradient bound of the plain backward, twice bitwise equal."""
    b, n, m, heads = 2, 200, 700, 2
    c = 64 * heads
    bf = torch.bfloat16
    q, k = (_rnd(gen, bf, b, t, c, scale=0.35).to(bf) for t in (n, m))
    v = _v(gen, bf, b, m, 3.0).to(bf)
    f, g = (_rnd(gen, bf, b, n, c).to(bf) for _ in range(2))
    ref = mhada_train_ops.mhada_train_fwd_plain(q, k, v, f, heads)
    for splits in range(1, MAX_SPLITS + 1):
        before = _build.LAUNCHES["mhada_mhada_train_fwd"]
        *got, _ = mhada_train_ops.fwd_launch(q, k, v, f, heads, splits)
        assert _build.LAUNCHES["mhada_mhada_train_fwd"] == before + 1
        assert torch.equal(got[0], _mhada_launch(q, k, v, f, heads,
                                                 splits)[0])
        for x, r in zip(got[1:], ref[1:]):
            assert _rel(x, r) <= 1e-2, (splits, _rel(x, r))
    _, m1, e2, lse = ref
    dm1, de2, delta, _ = mhada_train_ops.mhada_train_prologue(
        g, f, m1, e2, heads, bf)
    args = (q, k, v, dm1, de2, lse, delta, heads)
    got = mhada_train_ops._bwd_kernel(*args)
    want = mhada_train_ops.mhada_train_bwd_plain(*args)
    for x, y, r in zip(got, mhada_train_ops._bwd_kernel(*args), want):
        assert torch.equal(x, y)
        assert _rel(x.float(), r.float()) <= 5e-2


# (batch, queries, keys, V's offset) of the float32 forwards at the full
# width (C = 512, 8 heads): lengths past and below the attention kernel's
# 256-query blocks, the MHAda kernel's 128 and the 64-key tiles, N = 1
# against 63 keys, N != M for MHAda; V = 3 + 0.3 N(0, 1) where E2 - M1^2
# cancels.  Self-attention runs at L = N.
F32_FWD_SHAPES = [(2, 300, 300, 0.0), (1, 1, 63, 0.0), (1, 257, 1000, 3.0),
                  (3, 513, 130, 0.0)]


def _rel(got, ref):
    return (got - ref).abs().max().item() / ref.abs().max().item()


@pytest.mark.parametrize("b,n,m,shift", F32_FWD_SHAPES)
def test_f32_forwards_full_width(gen, b, n, m, shift):
    """K1, K6's forward and K7's forward at float32, on the float32 flash
    tile, at C = 512 against their plain versions: out, lse, M1 and E2,
    each against its own scale.  K1's out repeats K6's forward out bit for
    bit (one kernel; K6 also stores lse), and K7's forward out repeats K4's
    (one tile; K7 also stores M1, E2 and lse).  Each entry point launches
    once."""
    c, heads = 512, 8
    entries = ["mhada_attention_fwd", "mhada_attention_train_fwd",
               "mhada_mhada_train_fwd", "mhada_mhada_fwd"]
    before = [_build.LAUNCHES[e] for e in entries]
    qkv = _rnd(gen, torch.float32, b, n, 3 * c)
    k1 = attention_tm(qkv, heads)
    k6 = attention_train_ops.fwd_launch(qkv, heads, 0.125)[:2]
    q = _rnd(gen, torch.float32, b, n, c, scale=0.35)
    k = _rnd(gen, torch.float32, b, m, c, scale=0.35)
    v = _rnd(gen, torch.float32, b, m, c, scale=0.3 if shift else 1.0) + shift
    f = _rnd(gen, torch.float32, b, n, c)
    k7 = mhada_train_ops.fwd_launch(q, k, v, f, heads)[:4]
    k4 = mhada_tm(q, k, v, f, heads)
    assert [_build.LAUNCHES[e] for e in entries] == [x + 1 for x in before]
    ref6 = attention_train_ops.attention_train_fwd_plain(qkv, heads, 0.125)
    ref7 = mhada_train_ops.mhada_train_fwd_plain(q, k, v, f, heads)
    torch.cuda.synchronize()
    for i, (got, ref) in enumerate(zip((k1, *k6, *k7), (ref6[0], *ref6,
                                                         *ref7))):
        assert torch.isfinite(got).all(), i
        assert _rel(got, ref) <= REL_F32, (i, _rel(got, ref))
    assert torch.equal(k1, k6[0])
    assert torch.equal(k7[0], k4)


@pytest.mark.parametrize("entry", ["mhada_attention_fwd",
                                   "mhada_attention_train_fwd",
                                   "mhada_mhada_train_fwd"])
def test_f32_forwards_reject_unaligned(gen, entry):
    """The float32 flash tile copies 16 bytes at a time: the wrappers of
    K1, K6's forward and K7's forward raise on a float32 operand one
    element into its buffer (every operand in turn), and the C entry points
    refuse channels that are no multiple of 4; nothing launches."""
    b, n, m, heads = 1, 70, 90, 2
    c = 64 * heads

    def off(*shape):
        buf = torch.zeros(torch.Size(shape).numel() + 1, device="cuda")
        return buf[1:].view(shape)

    if entry == "mhada_mhada_train_fwd":
        shapes = {"q": (b, n, c), "k": (b, m, c), "v": (b, m, c),
                  "f": (b, n, c)}

        def call(t):
            return mhada_train_ops.fwd_launch(t["q"], t["k"], t["v"],
                                              t["f"], heads)
    else:
        shapes = {"qkv": (b, n, 3 * c)}

        def call(t):
            if entry == "mhada_attention_fwd":
                return attention_tm(t["qkv"], heads)
            return attention_train_ops.fwd_launch(t["qkv"], heads, 0.125)

    before = dict(_build.LAUNCHES)
    for name in shapes:
        t = {key: torch.zeros(shape, device="cuda")
             for key, shape in shapes.items()}
        t[name] = off(*shapes[name])
        with pytest.raises(ValueError, match="16-byte aligned"):
            call(t)
    c = 130
    out = torch.zeros(b, n, c, device="cuda")
    lse = torch.zeros(b, heads, n, device="cuda")
    if entry == "mhada_mhada_train_fwd":
        q, kv = torch.zeros(b, n, c, device="cuda"), torch.zeros(
            b, m, c, device="cuda")
        args = [q, kv, kv, q, out, out.clone(), out.clone(), lse, None, b,
                n, m]
    else:   # (qkv, out[, lse], part, b, n), then C, heads, splits, scale
        args = [torch.zeros(b, n, 3 * c, device="cuda"), out]
        args += [lse] if entry == "mhada_attention_train_fwd" else []
        args += [None, b, n]
    with pytest.raises(RuntimeError, match="CUDA error"):
        _build.launch(entry, out.device, *args, c, heads,
                      *([1] if entry == "mhada_mhada_train_fwd"
                        else [1, 0.125]), 0)
    assert _build.LAUNCHES == before
    call({key: torch.zeros(shape, device="cuda")
          for key, shape in shapes.items()})   # aligned: launches
    assert _build.LAUNCHES[entry] == before[entry] + 1


def test_kernel_rejects_bad_input(gen):
    """Bad shapes, strides and dtypes raise; so does a bfloat16 input of
    K1, K6, K3, K4, K7, the decoder tail or K2 (qkv, dO, fc, v, k, dE2,
    x) that does not start on a 16-byte boundary (a contiguous view one
    element into a buffer), and a bfloat16 K2 input whose E is no multiple
    of 8, before any launch."""
    b, l, c = 1, 16, 128

    def off(*shape):
        buf = torch.zeros(torch.Size(shape).numel() + 1, device="cuda",
                          dtype=torch.bfloat16)
        return buf[1:].view(shape)

    qkv, g = off(b, l, 3 * c), off(b, l, c)
    good = torch.zeros(b, l, 3 * c, device="cuda", dtype=torch.bfloat16)
    stats = torch.zeros(b, 2, l, device="cuda")
    x = torch.zeros(b, l, c, device="cuda", dtype=torch.bfloat16)
    wf = torch.zeros(2, 64, 64, device="cuda")
    fb, st4 = torch.zeros(2, 64, device="cuda"), torch.ones(b, 4, c).cuda()
    xt = off(1, 4, 4, 128)
    tail_w = [torch.zeros(shape, device="cuda") for shape in (
        (64, 128, 3, 3), (64,), (64, 64, 3, 3), (64,), (3, 64, 3, 3), (3,))]
    before = dict(_build.LAUNCHES)
    for call in (lambda: attention_tm(qkv, 2),
                 lambda: attention_train(qkv, 2),
                 lambda: attention_train_ops._bwd_kernel(
                     good, stats, stats, g, 2, 0.125),
                 lambda: mhada_fused_prologue(g, x, st4, wf, fb, x, x),
                 lambda: mhada_fused_prologue(x, x, st4, wf, fb, x, g),
                 lambda: mhada_train(x, g, x, x, 2),
                 lambda: mhada_train_ops._bwd_kernel(
                     x, x, x, x, g, stats, stats, 2),
                 lambda: mhada_tm(x, x, g, x, 2),
                 lambda: decoder_tail(xt, *tail_w),
                 lambda: decoder_tail_train(xt, *tail_w),
                 lambda: ln_matmul(g, x[0, 0], x[0, 0], x[0], x[0, 0, :l]),
                 lambda: mhada_fused_prologue_pipe(g, x, st4, wf, fb, x, x),
                 lambda: mhada_fused_prologue_pipe(x, x, st4, wf, fb, g, x),
                 lambda: mid3_fused(xt, *[torch.zeros(
                     shape, device="cuda") for shape in (
                         (128, 128, 3, 3), (128,))] * 3)):
        with pytest.raises(ValueError, match="16-byte aligned"):
            call()
    # K2 at bf16: E a multiple of 8 (16-byte rows)
    xe = torch.zeros(1, 4, 36, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 8"):
        ln_matmul(xe, xe[0, 0], xe[0, 0], xe[0], xe[0, 0, :4])
    assert _build.LAUNCHES == before
    qkv = _rnd(gen, torch.float32, 1, 16, 384)
    with pytest.raises(ValueError, match="head dim"):
        attention_tm(qkv, 4)
    with pytest.raises(ValueError, match="contiguous"):
        attention_tm(qkv[:, ::2], 2)
    with pytest.raises(TypeError):
        attention_tm(qkv.half(), 2)
    y = _rnd(gen, torch.float32, 1, 8, 8, 64)
    w6, b6 = torch.zeros(3, 64, 3, 3, device="cuda"), torch.zeros(3).cuda()
    with pytest.raises(ValueError, match="contiguous"):
        c6_conv(y.transpose(1, 2), w6, b6)
    with pytest.raises(TypeError):
        c6_conv(y.half(), w6, b6)
    x = _rnd(gen, torch.float32, 1, 4, 4, 128)
    w, b = torch.zeros(128, 128, 3, 3, device="cuda"), torch.zeros(128).cuda()
    with pytest.raises(TypeError):
        mid3_fused(x.half(), w, b, w, b, w, b)
    xh = torch.zeros(1, 16, 128, device="cuda", dtype=torch.half)
    with pytest.raises(TypeError):
        mhada_fused_prologue_pipe(xh, xh, st4, wf, fb, xh, xh)
    a = torch.zeros(65, 32, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiples"):
        mm(a, torch.zeros(32, 64, device="cuda", dtype=torch.bfloat16))
    with pytest.raises(TypeError):
        mm(a.float(), torch.zeros(32, 64, device="cuda"))


def _fwd_bwd(run, backend, dtype, inputs, cot):
    """[output, d input for each input] of run(backend, *inputs in dtype),
    back-propagated from the cotangent ``cot``; all float32."""
    leaves = [t.to(dtype).detach().requires_grad_() for t in inputs]
    out = run(backend, *leaves)
    out.backward(cot.to(out.dtype))
    return [out.detach().float()] + [t.grad.float() for t in leaves]


def _check_train(entries, run, dtype, inputs, cot, plain=None):
    """A training kernel pair against its plain versions, forward and
    backward, with each C entry point launched exactly once.  ``plain``:
    dtype -> the plain [output, d input for each input], in place of
    ``_fwd_bwd(run, "plain", ...)``."""
    if plain is None:
        def plain(dt):
            return _fwd_bwd(run, "plain", dt, inputs, cot)
    before = [_build.LAUNCHES[e] for e in entries]
    got = _fwd_bwd(run, "kernel", dtype, inputs, cot)
    assert [_build.LAUNCHES[e] for e in entries] == [n + 1 for n in before]
    ref = plain(dtype)
    ref32 = plain(torch.float32)
    assert [_build.LAUNCHES[e] for e in entries] == [n + 1 for n in before]
    torch.cuda.synchronize()
    for i, (g, r, r32) in enumerate(zip(got, ref, ref32)):
        assert torch.isfinite(g).all(), i
        if dtype == torch.float32:
            rel = (g - r).abs().max().item() / r.abs().max().item()
            assert rel <= (REL_F32 if i == 0 else REL_F32_GRAD), (i, rel)
        else:
            err = (g - r32).abs().max().item()
            err_plain = (r - r32).abs().max().item()
            assert err <= 2 * err_plain + 1e-6 * r32.abs().max().item(), (
                i, err, err_plain)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,l,heads", ATTN_SHAPES + [(1, 130, 2),
                                                     (1, 4100, 2),
                                                     (3, 200, 2), (2, 129, 1),
                                                     (2, 63, 2), (4, 384, 2),
                                                     (2, 2048, 8),
                                                     (2, 1024, 8)])
def test_attention_train_kernels(gen, dtype, b, l, heads):
    """K6 forward and backward against the twins; a second call repeats the
    output and all three gradients bit for bit (no atomics).  The float32
    backward's blocks hold 128 rows and stream 64-row tiles: lengths past,
    below and at those, with B > 1 on the packed qkv.  (2, 2048, 8) and
    (2, 1024, 8) are the video step's frames and styles at full width."""
    qkv = _rnd(gen, dtype, b, l, 3 * 64 * heads, scale=0.5)
    cot = _rnd(gen, dtype, b, l, 64 * heads)

    def run(be, x):
        return attention_train(x, heads, backend=be)

    _check_train(["mhada_attention_train_fwd", "mhada_attention_train_bwd"],
                 run, dtype, [qkv], cot)
    first, again = (_fwd_bwd(run, "kernel", dtype, [qkv], cot)
                    for _ in range(2))
    for i, (x, y) in enumerate(zip(first, again)):
        assert torch.equal(x, y), i


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,n,m,shift", [
    (2, 70, 130, 0.0), (1, 1, 200, 0.0), (1, 64, 64, 0.0), (1, 150, 33, 0.0),
    (1, 2100, 4100, 0.0), (1, 2048, 1024, 0.0), (2, 70, 130, 3.0),
    (1, 2048, 1024, 3.0), (3, 129, 63, 0.0), (2, 300, 260, 0.0),
    (2, 256, 128, 0.0), (1, 257, 129, 3.0)])
def test_mhada_train_kernels(gen, dtype, b, n, m, shift):
    """K7 forward and backward against the twins (N = 2048, M = 1024: video
    training's frames against one style); a second call repeats the output
    and all four gradients bit for bit (no atomics).  The float32
    backward's blocks hold 128 rows and stream 64-row tiles: N and M past,
    below and at those, B > 1."""
    q = _rnd(gen, dtype, b, n, 128, scale=0.35)
    k = _rnd(gen, dtype, b, m, 128, scale=0.35)
    v, f = _v(gen, dtype, b, m, shift), _rnd(gen, dtype, b, n, 128)
    cot = _rnd(gen, dtype, b, n, 128)

    def run(be, *a):
        return mhada_train(*a, 2, backend=be)

    _check_train(["mhada_mhada_train_fwd", "mhada_mhada_train_bwd"], run,
                 dtype, [q, k, v, f], cot)
    first, again = (_fwd_bwd(run, "kernel", dtype, [q, k, v, f], cot)
                    for _ in range(2))
    for i, (x, y) in enumerate(zip(first, again)):
        assert torch.equal(x, y), i


@pytest.mark.parametrize("n,m", [(2048, 1024), (2048, 2048), (1024, 1024)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_mhada_train_kernels_video_shapes(gen, dtype, n, m):
    """K7 forward and backward at the video step's full width (8 heads of
    64, B = 2): frames against a style (cs1, cs2), frames against
    themselves (cc1, cc2) and the style against itself (ss)."""
    q = _rnd(gen, dtype, 2, n, 512, scale=0.35)
    k = _rnd(gen, dtype, 2, m, 512, scale=0.35)
    v, f = _rnd(gen, dtype, 2, m, 512), _rnd(gen, dtype, 2, n, 512)
    cot = _rnd(gen, dtype, 2, n, 512)

    def run(be, *a):
        return mhada_train(*a, 8, backend=be)

    _check_train(["mhada_mhada_train_fwd", "mhada_mhada_train_bwd"], run,
                 dtype, [q, k, v, f], cot)


@pytest.mark.parametrize("dtype", DTYPES)
def test_train_kernels_inversion_shape(gen, dtype):
    """K6 at B = 1, L = 1024, 8 heads of 64 and K7 at B = 1, N = M = 1024,
    forward and input gradients: feature inversion's shapes at 256^2
    (analysis.visualize, the image's gradient through the training
    build)."""
    qkv = _rnd(gen, dtype, 1, 1024, 3 * 512, scale=0.5)

    def attend(be, x):
        return attention_train(x, 8, backend=be)

    _check_train(["mhada_attention_train_fwd", "mhada_attention_train_bwd"],
                 attend, dtype, [qkv], _rnd(gen, dtype, 1, 1024, 512))
    q, k = (_rnd(gen, dtype, 1, 1024, 512, scale=0.35) for _ in range(2))
    v, f = (_rnd(gen, dtype, 1, 1024, 512) for _ in range(2))

    def mhada(be, *a):
        return mhada_train(*a, 8, backend=be)

    _check_train(["mhada_mhada_train_fwd", "mhada_mhada_train_bwd"], mhada,
                 dtype, [q, k, v, f], _rnd(gen, dtype, 1, 1024, 512))


def test_vit_inversion_step_against_cpu(gen):
    """One feature-inversion step at full width and 256^2 on the card's
    training build (K6 forward and backward, float32) against the plain
    build on the CPU, same weights, target and first image: the loss to
    1e-4 and the image's gradient to 1e-3 of its scale; one Adam step of
    ``invert_vit_features`` launches K6 3 x 2 times forward and 3 times
    backward, and moves each pixel within 2 x lr of the CPU's step (a
    gradient within rounding of 0 may take the other sign)."""
    from mhada_tpu_torch.analysis import visualize
    from mhada_tpu_torch.config import ModelConfig
    from mhada_tpu_torch.models import build_models

    g = torch.Generator().manual_seed(3)
    target = torch.rand(1, 256, 256, 3, generator=g) * 255
    img0 = torch.rand(1, 256, 256, 3, generator=g) * 255
    vits = {}
    for dev in ("cpu", "cuda"):
        vits[dev] = build_models(ModelConfig(), dev, for_training=True)[
            "vit_c"].requires_grad_(False)
    out = {}
    for dev, vit in vits.items():
        t = visualize._targets(vit, target.to(dev))
        x = img0.to(dev, copy=True).requires_grad_()
        loss = visualize.feature_loss(vit, t)(x)
        loss.backward()
        before = dict(_build.LAUNCHES)
        img = visualize.invert_vit_features(vit, target.to(dev), iters=1,
                                            img0=img0, log_every=0)
        moved = {k: v - before[k] for k, v in _build.LAUNCHES.items()
                 if v != before[k]}
        out[dev] = (loss.item(), x.grad.cpu(), img, moved)
    (l_cpu, g_cpu, img_cpu, moved_cpu), (l, gr, img, moved) = out.values()
    assert moved_cpu == {}
    assert moved == {"mhada_attention_train_fwd": 6,
                     "mhada_attention_train_bwd": 3}
    assert abs(l - l_cpu) <= 1e-4 * abs(l_cpu)
    assert (gr - g_cpu).abs().max() <= 1e-3 * g_cpu.abs().max()
    assert abs(img - img_cpu).max() <= 2 * 0.5


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(1, 8, 12, 128), (2, 6, 10, 128),
                                   (1, 2, 3, 128), (2, 128, 256, 128),
                                   (2, 128, 128, 128)])
def test_decoder_tail_train_kernel(gen, dtype, shape):
    """K8 forward and input gradients against the plain versions on the
    kernel forward's ReLU masks; (2, 128, 256, 128) and (2, 128, 128, 128)
    are the video step's frame and style tails at full size."""
    x = _rnd(gen, dtype, *shape).abs()

    def conv(co, ci):
        bound = 1 / (ci * 9) ** 0.5
        w = (torch.rand(co, ci, 3, 3, generator=gen) * 2 - 1) * bound
        b = (torch.rand(co, generator=gen) * 2 - 1) * bound + bound
        return w.to("cuda", dtype).float(), b.to("cuda", dtype).float()

    (wu, bu), (w5, b5), (w6, b6) = conv(64, 128), conv(64, 64), conv(3, 64)
    cot = _rnd(gen, dtype, shape[0], 2 * shape[1], 2 * shape[2], 3)
    inputs = [x, wu, bu, w5, b5, w6, b6]
    args = [t.to(dtype) for t in inputs]
    kernel_fwd = decoder_tail_ops._launch_tail("mhada_decoder_tail_res",
                                               *args)
    masks = [t > 0 for t in kernel_fwd]
    plain_masks = [t > 0 for t in decoder_tail_ops.decoder_tail_res_plain(
        *args)]
    # A pre-activation within rounding of 0 may take the other side of a
    # ReLU in the kernel than in the plain forward (the convs sum in
    # another order), and a flip moves a bias gradient by a whole cotangent
    # (one rgb flip at (1, 8, 12, 128), bf16, on an H100: db6 0.151 off).
    # As chip_smoke.py's K8 gate does, the plain references take the
    # kernel forward's masks, and the share of flips is bounded apart.
    flips = sum(int((m != pm).sum()) for m, pm in zip(masks, plain_masks))
    assert flips <= TAIL_FLIPS[dtype] * sum(m.numel() for m in masks), flips

    def plain(dt):
        a = [t.to(dt) for t in inputs]
        outs = decoder_tail_ops.decoder_tail_res_plain(*a)
        aligned = [torch.where(m, o.clamp_min(torch.finfo(dt).tiny), 0)
                   for m, o in zip(masks, outs)]
        grads = decoder_tail_ops.decoder_tail_bwd(
            cot.to(dt), a[0], a[1], a[3], a[5], *aligned)
        return [aligned[0].float()] + [g.float() for g in grads]

    _check_train(["mhada_decoder_tail_res"],
                 lambda be, *a: decoder_tail_train(*a, backend=be), dtype,
                 inputs, cot, plain)
    # the forward and its residuals repeat bit for bit
    again = decoder_tail_ops._launch_tail("mhada_decoder_tail_res", *args)
    for i, (a, b) in enumerate(zip(kernel_fwd, again)):
        assert torch.equal(a, b), i


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,f", [((2, 100, 128), 200), ((3, 5, 40), 7)])
def test_ln_matmul_vjp(gen, dtype, shape, f):
    """K2 under autograd: the kernel forward and the closed-form backward
    against autograd of the unfused plain LayerNorm and F.linear, all five
    input gradients."""
    e = shape[-1]
    inputs = [_rnd(gen, dtype, *shape),
              (1 + 0.1 * torch.randn(e, generator=gen)).to("cuda", dtype)
              .float(),
              (0.1 * torch.randn(e, generator=gen)).to("cuda", dtype).float(),
              _rnd(gen, dtype, f, e, scale=e ** -0.5),
              _rnd(gen, dtype, f, scale=0.1)]
    cot = _rnd(gen, dtype, *shape[:-1], f)

    def run(backend, x, lw, lb, w, b):
        if backend == "kernel":
            return ln_matmul(x, lw, lb, w, b, backend=backend)
        return F.linear(layer_norm(x, lw.to(x.dtype), lb.to(x.dtype)), w, b)

    _check_train(["mhada_ln_matmul"], run, dtype, inputs, cot)


def test_forward_only_wrappers_refuse_grad(gen):
    """K1, K4, K5, K13, K14 and the probe P2 launch no kernel for an input
    that requires grad while grad mode is on, and name their training route
    (P2: none, it is a probe); under no_grad they run."""
    qkv = _rnd(gen, torch.float32, 1, 16, 384).requires_grad_()
    q = _rnd(gen, torch.float32, 1, 16, 128).requires_grad_()
    x = _rnd(gen, torch.float32, 1, 4, 4, 128)
    w_up = torch.zeros(64, 128, 3, 3, device="cuda", requires_grad=True)
    tail = (x, w_up, torch.zeros(64, device="cuda"),
            torch.zeros(64, 64, 3, 3, device="cuda"),
            torch.zeros(64, device="cuda"),
            torch.zeros(3, 64, 3, 3, device="cuda"),
            torch.zeros(3, device="cuda"))
    y = _rnd(gen, torch.float32, 1, 4, 4, 64)
    w6 = torch.zeros(3, 64, 3, 3, device="cuda", requires_grad=True)
    xm = _rnd(gen, torch.float32, 1, 4, 4, 128)
    wm = torch.zeros(128, 128, 3, 3, device="cuda", requires_grad=True)
    bm = torch.zeros(128, device="cuda")
    calls = [(lambda: attention_tm(qkv, 2), "K6"),
             (lambda: mhada_tm(q, q, q, q, 2), "K7"),
             (lambda: decoder_tail(*tail), "K8"),
             (lambda: c6_conv(y, w6, torch.zeros(3, device="cuda")), "K8"),
             (lambda: mid3_fused(xm, wm, bm, wm, bm, wm, bm), "ConvReLU"),
             (lambda: mhada_fused_prologue_pipe(
                 q, q, torch.ones(1, 4, 128, device="cuda"),
                 torch.zeros(2, 64, 64, device="cuda"),
                 torch.zeros(2, 64, device="cuda"), q, q), "probe")]
    before = dict(_build.LAUNCHES)
    for call, route in calls:
        with pytest.raises(RuntimeError, match=f"forward-only.*{route}"):
            call()
    assert _build.LAUNCHES == before
    with torch.no_grad():
        for call, _ in calls:
            call()
