"""The port's CUDA kernels against their plain twins on the card, at small
and ragged shapes (partial query/key tiles, partial decoder tiles, tiny
images) that the 512^2 path never produces, and K1 / K4 just past the TPU
kernels' single-pass limit of 4096 keys.

Marked ``cuda``: each test skips without a card.  On a machine with one (the
repo conftest imports jax, which that machine need not have):
``python -m pytest tests/test_torch_cuda.py --noconftest -q``.
"""

import pytest
import torch

from mhada_tpu_torch import _build
from mhada_tpu_torch.ops.attention_kernel import attention_tm
from mhada_tpu_torch.ops.decoder_tail import decoder_tail
from mhada_tpu_torch.ops.ln_matmul import ln_matmul
from mhada_tpu_torch.ops.mhada_kernel import mhada_tm
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
