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
forward-only wrappers must refuse tensors that require grad.  K13 (c6)
and K14 (c1 -> c3) are held at small and path shapes, the probes P1 (a
tensor-core matmul) and P2 (K3 with a cp.async ring, also against K3).

Marked ``cuda``: each test skips without a card.  On a machine with one (the
repo conftest imports jax, which that machine need not have):
``python -m pytest tests/test_torch_cuda.py --noconftest -q``.
"""

import pytest
import torch
import torch.nn.functional as F

from mhada_tpu_torch import _build
from mhada_tpu_torch.ops import attention_train as attention_train_ops
from mhada_tpu_torch.ops.attention_kernel import attention_tm
from mhada_tpu_torch.ops.attention_train import attention_train
from mhada_tpu_torch.ops.decoder_c6 import c6_conv
from mhada_tpu_torch.ops.decoder_mid import mid3_fused
from mhada_tpu_torch.ops.decoder_tail import decoder_tail, decoder_tail_train
from mhada_tpu_torch.ops.ln_matmul import layer_norm, ln_matmul
from mhada_tpu_torch.ops.mhada_kernel import mhada_tm
from mhada_tpu_torch.ops.mhada_train import mhada_train
from mhada_tpu_torch.ops.instance_norm import instance_norm_stats
from mhada_tpu_torch.ops.mhada_prologue import mhada_fused_prologue
from mhada_tpu_torch.probes.mhada_pipe_probe import mhada_fused_prologue_pipe
from mhada_tpu_torch.probes.mm_probe import mm, mm_plain

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


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,n,m", [(2, 70, 130), (1, 1, 200), (1, 64, 64),
                                   (1, 300, 4100)])
@pytest.mark.parametrize("entry", ["mhada_mhada_prologue",
                                   "mhada_mhada_prologue_pipe"])
def test_mhada_prologue_kernel(gen, dtype, b, n, m, entry):
    """K3, and the probe P2 of the same function, against the plain
    version; P2 also against K3: the same float32 arithmetic in the same
    order, so equal up to the output's rounding."""
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
    v = _rnd(gen, dtype, b, m, 128)

    def args(dt):
        return fc.to(dt), fcs.to(dt), stats, wf, fb, k.to(dt), v.to(dt)

    _check(entry, lambda be, dt: fn(*args(dt), backend=be), dtype)
    if entry == "mhada_mhada_prologue_pipe":
        pipe = fn(*args(dtype)).float()
        k3 = mhada_fused_prologue(*args(dtype)).float()
        rel = (pipe - k3).abs().max().item() / k3.abs().max().item()
        assert rel <= (1e-6 if dtype == torch.float32 else 2 ** -7), rel


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,f", [((2, 100, 128), 200), ((1, 64, 96), 64),
                                     ((3, 5, 40), 7)])
def test_ln_matmul_kernel(gen, dtype, shape, f):
    e = shape[-1]
    x = _rnd(gen, dtype, *shape)
    lw = (1 + 0.1 * torch.randn(e, generator=gen)).cuda()
    lb = (0.1 * torch.randn(e, generator=gen)).cuda()
    w = _rnd(gen, dtype, f, e, scale=e ** -0.5)
    bias = _rnd(gen, dtype, f, scale=0.1)
    _check("mhada_ln_matmul",
           lambda be, dt: ln_matmul(x.to(dt), lw, lb, w, bias, backend=be),
           dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(1, 8, 12, 128), (2, 6, 10, 128),
                                   (1, 2, 3, 128), (1, 16, 16, 128)])
def test_decoder_tail_kernel(gen, dtype, shape):
    x = _rnd(gen, dtype, *shape).abs()

    def conv(co, ci):
        bound = 1 / (ci * 9) ** 0.5
        w = (torch.rand(co, ci, 3, 3, generator=gen) * 2 - 1) * bound
        b = (torch.rand(co, generator=gen) * 2 - 1) * bound
        return w.to("cuda", dtype).float(), b.to("cuda", dtype).float()

    (wu, bu), (w5, b5), (w6, b6) = conv(64, 128), conv(64, 64), conv(3, 64)
    _check("mhada_decoder_tail",
           lambda be, dt: decoder_tail(x.to(dt), wu, bu, w5, b5, w6, b6,
                                       backend=be), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(1, 2, 3, 64), (2, 17, 33, 64),
                                   (1, 512, 512, 64)])
def test_decoder_c6_kernel(gen, dtype, shape):
    y = _rnd(gen, dtype, *shape).abs()
    w6 = _rnd(gen, dtype, 3, 64, 3, 3, scale=1 / 24)
    b6 = (torch.rand(3, generator=gen) / 24).cuda()
    _check("mhada_decoder_c6",
           lambda be, dt: c6_conv(y.to(dt), w6, b6, backend=be), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(1, 2, 3, 128), (2, 9, 20, 128),
                                   (1, 128, 128, 256)])
def test_decoder_mid_kernel(gen, dtype, shape):
    c = shape[-1]
    x = _rnd(gen, dtype, *shape)
    params = [t for _ in range(3)
              for t in (_rnd(gen, dtype, c, c, 3, 3, scale=0.5 / c ** 0.5),
                        _rnd(gen, dtype, c, scale=0.1))]
    _check("mhada_decoder_mid_conv",
           lambda be, dt: mid3_fused(x.to(dt), *params, backend=be), dtype,
           launches=3)


@pytest.mark.parametrize("m,k,n", [(64, 32, 64), (128, 2048, 192)])
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


def test_kernel_rejects_bad_input(gen):
    """Bad shapes, strides and dtypes raise; so does a bfloat16 qkv or dO
    that does not start on a 16-byte boundary (a contiguous view one element
    into a buffer), before any launch."""
    b, l, c = 1, 16, 128

    def off(*shape):
        buf = torch.zeros(torch.Size(shape).numel() + 1, device="cuda",
                          dtype=torch.bfloat16)
        return buf[1:].view(shape)

    qkv, g = off(b, l, 3 * c), off(b, l, c)
    good = torch.zeros(b, l, 3 * c, device="cuda", dtype=torch.bfloat16)
    stats = torch.zeros(b, 2, l, device="cuda")
    before = dict(_build.LAUNCHES)
    for call in (lambda: attention_tm(qkv, 2),
                 lambda: attention_train(qkv, 2),
                 lambda: attention_train_ops._bwd_kernel(
                     good, stats, stats, g, 2, 0.125)):
        with pytest.raises(ValueError, match="16-byte aligned"):
            call()
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


def _check_train(entries, run, dtype, inputs, cot):
    """A training kernel pair against its plain versions, forward and
    backward, with each C entry point launched exactly once."""
    before = [_build.LAUNCHES[e] for e in entries]
    got = _fwd_bwd(run, "kernel", dtype, inputs, cot)
    assert [_build.LAUNCHES[e] for e in entries] == [n + 1 for n in before]
    ref = _fwd_bwd(run, "plain", dtype, inputs, cot)
    ref32 = _fwd_bwd(run, "plain", torch.float32, inputs, cot)
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
                                                     (1, 4100, 2)])
def test_attention_train_kernels(gen, dtype, b, l, heads):
    """K6 forward and backward against the twins; a second call repeats the
    output and all three gradients bit for bit (no atomics)."""
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
@pytest.mark.parametrize("b,n,m", [(2, 70, 130), (1, 1, 200), (1, 64, 64),
                                   (1, 150, 33), (1, 2100, 4100)])
def test_mhada_train_kernels(gen, dtype, b, n, m):
    q = _rnd(gen, dtype, b, n, 128, scale=0.35)
    k = _rnd(gen, dtype, b, m, 128, scale=0.35)
    v, f = _rnd(gen, dtype, b, m, 128), _rnd(gen, dtype, b, n, 128)
    cot = _rnd(gen, dtype, b, n, 128)
    _check_train(["mhada_mhada_train_fwd", "mhada_mhada_train_bwd"],
                 lambda be, *a: mhada_train(*a, 2, backend=be), dtype,
                 [q, k, v, f], cot)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(1, 8, 12, 128), (2, 6, 10, 128),
                                   (1, 2, 3, 128)])
def test_decoder_tail_train_kernel(gen, dtype, shape):
    x = _rnd(gen, dtype, *shape).abs()

    def conv(co, ci):
        bound = 1 / (ci * 9) ** 0.5
        w = (torch.rand(co, ci, 3, 3, generator=gen) * 2 - 1) * bound
        b = (torch.rand(co, generator=gen) * 2 - 1) * bound + bound
        return w.to("cuda", dtype).float(), b.to("cuda", dtype).float()

    (wu, bu), (w5, b5), (w6, b6) = conv(64, 128), conv(64, 64), conv(3, 64)
    cot = _rnd(gen, dtype, shape[0], 2 * shape[1], 2 * shape[2], 3)
    _check_train(["mhada_decoder_tail_res"],
                 lambda be, *a: decoder_tail_train(*a, backend=be), dtype,
                 [x, wu, bu, w5, b5, w6, b6], cot)


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
    """K1, K4, K5, K13 and K14 launch no kernel for an input that requires
    grad while grad mode is on, and name their training route; under
    no_grad they run."""
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
             (lambda: mid3_fused(xm, wm, bm, wm, bm, wm, bm), "ConvReLU")]
    before = dict(_build.LAUNCHES)
    for call, route in calls:
        with pytest.raises(RuntimeError, match=f"forward-only.*{route}"):
            call()
    assert _build.LAUNCHES == before
    with torch.no_grad():
        for call, _ in calls:
            call()
