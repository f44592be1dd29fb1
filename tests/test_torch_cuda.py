"""The port's CUDA kernels against their plain twins on the card, at small
and ragged shapes (partial query/key tiles, partial decoder tiles, tiny
images) that the 512^2 path never produces, and K1 / K4 just past the TPU
kernels' single-pass limit of 4096 keys.  The training kernels K6, K7 and
K8 are held forward and backward (outputs and input gradients), and the
forward-only wrappers must refuse tensors that require grad.

Marked ``cuda``: each test skips without a card.  On a machine with one (the
repo conftest imports jax, which that machine need not have):
``python -m pytest tests/test_torch_cuda.py --noconftest -q``.
"""

import pytest
import torch

from mhada_tpu_torch import _build
from mhada_tpu_torch.ops.attention_kernel import attention_tm
from mhada_tpu_torch.ops.attention_train import attention_train
from mhada_tpu_torch.ops.decoder_tail import decoder_tail, decoder_tail_train
from mhada_tpu_torch.ops.ln_matmul import ln_matmul
from mhada_tpu_torch.ops.mhada_kernel import mhada_tm
from mhada_tpu_torch.ops.mhada_train import mhada_train
from mhada_tpu_torch.ops.instance_norm import instance_norm_stats
from mhada_tpu_torch.ops.mhada_prologue import mhada_fused_prologue

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


def _check(entry, run, dtype):
    """run(backend, dtype) -> output; the inputs it closes over are float32."""
    before = _build.LAUNCHES[entry]
    got = run("kernel", dtype).float()
    assert _build.LAUNCHES[entry] == before + 1
    ref = run("plain", dtype).float()
    ref32 = run("plain", torch.float32)
    assert _build.LAUNCHES[entry] == before + 1  # the twin launches nothing
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    if dtype == torch.float32:
        rel = (got - ref).abs().max().item() / ref.abs().max().item()
        assert rel <= REL_F32, rel
    else:
        err = (got - ref32).abs().max().item()
        err_plain = (ref - ref32).abs().max().item()
        assert err <= 2 * err_plain, (err, err_plain)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,l", [(2, 100), (1, 64), (1, 7), (1, 4160)])
def test_attention_kernel(gen, dtype, b, l):
    qkv = _rnd(gen, dtype, b, l, 384)
    _check("mhada_attention_fwd",
           lambda be, dt: attention_tm(qkv.to(dt), 2, backend=be), dtype)


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
@pytest.mark.parametrize("b,n,m", [(2, 70, 130), (1, 1, 200), (1, 64, 64)])
def test_mhada_prologue_kernel(gen, dtype, b, n, m):
    fc = _rnd(gen, dtype, b, n, 128, scale=2.0) + 1
    fcs = _rnd(gen, dtype, b, n, 128, scale=3.0) - 1
    mc, rc = instance_norm_stats(fc)
    ms, rs = instance_norm_stats(fcs)
    stats = torch.stack([mc, rc, ms, rs], 1)
    wf = _rnd(gen, dtype, 2, 64, 64, scale=1 / 8)
    fb = _rnd(gen, dtype, 2, 64, scale=1 / 8)
    k = _rnd(gen, dtype, b, m, 128, scale=0.35)
    v = _rnd(gen, dtype, b, m, 128)
    _check("mhada_mhada_prologue",
           lambda be, dt: mhada_fused_prologue(
               fc.to(dt), fcs.to(dt), stats, wf, fb, k.to(dt), v.to(dt),
               backend=be), dtype)


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


def test_kernel_rejects_bad_input(gen):
    qkv = _rnd(gen, torch.float32, 1, 16, 384)
    with pytest.raises(ValueError, match="head dim"):
        attention_tm(qkv, 4)
    with pytest.raises(ValueError, match="contiguous"):
        attention_tm(qkv[:, ::2], 2)
    with pytest.raises(TypeError):
        attention_tm(qkv.half(), 2)


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
@pytest.mark.parametrize("b,l,heads", [(2, 100, 2), (1, 7, 1), (1, 130, 2)])
def test_attention_train_kernels(gen, dtype, b, l, heads):
    qkv = _rnd(gen, dtype, b, l, 3 * 64 * heads, scale=0.5)
    cot = _rnd(gen, dtype, b, l, 64 * heads)
    _check_train(["mhada_attention_train_fwd", "mhada_attention_train_bwd"],
                 lambda be, x: attention_train(x, heads, backend=be), dtype,
                 [qkv], cot)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,n,m", [(2, 70, 130), (1, 1, 200), (1, 64, 64),
                                   (1, 150, 33)])
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


def test_forward_only_wrappers_refuse_grad(gen):
    """K1, K4 and K5 launch no kernel for an input that requires grad while
    grad mode is on, and name their training route; under no_grad they
    run."""
    qkv = _rnd(gen, torch.float32, 1, 16, 384).requires_grad_()
    q = _rnd(gen, torch.float32, 1, 16, 128).requires_grad_()
    x = _rnd(gen, torch.float32, 1, 4, 4, 128)
    w_up = torch.zeros(64, 128, 3, 3, device="cuda", requires_grad=True)
    tail = (x, w_up, torch.zeros(64, device="cuda"),
            torch.zeros(64, 64, 3, 3, device="cuda"),
            torch.zeros(64, device="cuda"),
            torch.zeros(3, 64, 3, 3, device="cuda"),
            torch.zeros(3, device="cuda"))
    calls = [(lambda: attention_tm(qkv, 2), "K6"),
             (lambda: mhada_tm(q, q, q, q, 2), "K7"),
             (lambda: decoder_tail(*tail), "K8")]
    before = dict(_build.LAUNCHES)
    for call, route in calls:
        with pytest.raises(RuntimeError, match=f"forward-only.*{route}"):
            call()
    assert _build.LAUNCHES == before
    with torch.no_grad():
        for call, _ in calls:
            call()
