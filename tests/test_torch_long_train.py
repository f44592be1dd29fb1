"""Training above the token-major kernels' windows, CPU: the port's K6 and K7
(plain versions, which the card holds the kernels to) against the JAX
package's head-major kernels that training takes above 2048 tokens (K12's
streaming forward and flash backward; K10's streaming forward with its
M1/E2/lse residuals and K11's backward), the modules on that route, and
K2's VJP for the fused-LN training build.  Pallas runs in interpret mode.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from mhada_tpu.models.adaformer import AdaAttnMultiHead as JaxAdaAttn
from mhada_tpu.models.vit import EncoderBlock as JaxEncoderBlock
from mhada_tpu.ops.attention_pallas import attention_pallas
from mhada_tpu.ops.ln_matmul_pallas import ln_matmul as jax_ln_matmul
from mhada_tpu.ops.mhada_pallas import (_mhada_stream_fwd_impl,
                                        mhada_attention_pallas)
from mhada_tpu_torch.config import ModelConfig
from mhada_tpu_torch.interop import params_from_jax
from mhada_tpu_torch.models import build_models, layers, vit
from mhada_tpu_torch.models.adaformer import AdaAttnMultiHead
from mhada_tpu_torch.models.vit import EncoderBlock
from mhada_tpu_torch.ops.attention_train import attention_train
from mhada_tpu_torch.ops.ln_matmul import ln_matmul
from mhada_tpu_torch.ops.mhada_train import mhada_train, mhada_train_fwd_plain

# Six test workers share the CPU: cap torch's intra-op threads.
torch.set_num_threads(2)

# the JAX streaming tiles of tests/test_mhada_pallas.py:296-320: 640 keys
# are three 256-key blocks with a masked tail, so the backward runs its two
# passes (dQ; dK and dV)
STREAM = dict(block_n=128, block_m=256, streaming=True)


def _tm(a: np.ndarray) -> torch.Tensor:
    """Head-major (B, H, L, d) -> token-major (B, L, H * d)."""
    b, h, n, d = a.shape
    return torch.from_numpy(
        np.ascontiguousarray(a.transpose(0, 2, 1, 3).reshape(b, n, h * d)))


def _sin_grads(fn, *args):
    """(fn(*args), d sum(sin(fn)) / d args) through torch autograd."""
    leaves = [t.detach().clone().requires_grad_() for t in args]
    out = fn(*leaves)
    torch.sin(out).sum().backward()
    return out.detach(), [t.grad for t in leaves]


@pytest.mark.parametrize("n", [640, 200])
def test_attention_train_matches_k12_streaming(n):
    """K12's route (attention_pallas under jax.grad: the streaming forward
    with lse, the flash backward) against the port's attention_train: n =
    640 streams three key blocks with a masked tail, n = 200 is one key
    block (the combined backward).  Tolerances as
    tests/test_mhada_pallas.py:296-320."""
    rng = np.random.default_rng((52, n))
    q, k, v = (rng.standard_normal((1, 2, n, 64)).astype(np.float32)
               for _ in range(3))
    scale = 0.125

    def jax_fn(args):
        return attention_pallas(*args, scale, **STREAM)

    jargs = tuple(map(jnp.asarray, (q, k, v)))
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jax_fn(jargs))
        g_ref = jax.grad(lambda a: jnp.sum(jnp.sin(jax_fn(a))))(jargs)
    qkv = torch.cat([_tm(a) for a in (q, k, v)], dim=-1)
    got, (g_got,) = _sin_grads(lambda x: attention_train(x, 2, scale), qkv)
    np.testing.assert_allclose(got.numpy(), _tm(ref).numpy(), atol=5e-5,
                               rtol=1e-2)
    for g, r in zip(g_got.chunk(3, dim=-1), g_ref):
        np.testing.assert_allclose(g.numpy(), _tm(np.asarray(r)).numpy(),
                                   atol=2e-3, rtol=1e-2)


def test_mhada_train_matches_k10_residuals_and_k11():
    """K10's streaming forward with residuals and K11's two-pass backward
    (mhada_attention_pallas under jax.grad, 640 keys in three blocks)
    against the port's mhada_train at input scale 0.5: the output, M1, E2
    and lse, and the gradients of q, k, v and fcs_n."""
    rng = np.random.default_rng(53)
    n, m = 300, 640
    q, f = (rng.standard_normal((1, 2, n, 64)).astype(np.float32) * 0.5
            for _ in range(2))
    k, v = (rng.standard_normal((1, 2, m, 64)).astype(np.float32) * 0.5
            for _ in range(2))
    jargs = tuple(map(jnp.asarray, (q, k, v, f)))
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(mhada_attention_pallas(*jargs, **STREAM))
        g_ref = jax.grad(lambda a: jnp.sum(jnp.sin(mhada_attention_pallas(
            *a, **STREAM))))(jargs)
        _, m1e2, lse = _mhada_stream_fwd_impl(*jargs, 128, 256,
                                              with_res=True)
    targs = [_tm(a) for a in (q, k, v, f)]
    got, g_got = _sin_grads(lambda *a: mhada_train(*a, 2), *targs)
    np.testing.assert_allclose(got.numpy(), _tm(ref).numpy(), atol=5e-5,
                               rtol=1e-3)
    for g, r in zip(g_got, g_ref):
        np.testing.assert_allclose(g.numpy(), _tm(np.asarray(r)).numpy(),
                                   atol=3e-3, rtol=1e-2)
    _, m1, e2, lse_got = mhada_train_fwd_plain(*targs, 2)
    m1e2 = np.asarray(m1e2)
    np.testing.assert_allclose(m1.numpy(), _tm(m1e2[..., :64]).numpy(),
                               atol=5e-5, rtol=1e-4)
    np.testing.assert_allclose(e2.numpy(), _tm(m1e2[..., 64:]).numpy(),
                               atol=5e-5, rtol=1e-4)
    np.testing.assert_allclose(lse_got.numpy(), np.asarray(lse), atol=1e-5,
                               rtol=1e-5)


def _assert_close_each(got: dict, want: dict, rel: float):
    """Each tensor within ``rel`` of its own largest value; tensors that are
    zero in exact arithmetic (the key bias: softmax is shift-invariant) are
    held to ``rel`` of the largest gradient of all."""
    assert got.keys() == want.keys()
    top = max(float(np.abs(w).max()) for w in want.values())
    for key, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-3 * top)
        err = float(np.abs(np.asarray(got[key]) - w).max())
        assert err <= rel * scale, (key, err, scale)


def _module_route(monkeypatch, jmod, mod, inputs):
    """A JAX module with use_pallas=True, its token-major training kernels
    switched off (MHADA_TM_TRAIN=0, read at trace time), against the port's
    module in training mode from the same weights: the output and every
    parameter and input gradient of sum(sin(out))."""
    monkeypatch.setenv("MHADA_TM_TRAIN", "0")
    jin = tuple(map(jnp.asarray, inputs))

    def loss(p, xs):
        return jnp.sum(jnp.sin(jmod.apply({"params": p}, *xs)))

    with pltpu.force_tpu_interpret_mode():
        params = jmod.init(jax.random.PRNGKey(4), *jin)["params"]
        ref = np.asarray(jmod.apply({"params": params}, *jin))
        g_params, g_in = jax.grad(loss, argnums=(0, 1))(params, jin)
    mod.load_state_dict(params_from_jax(params), strict=True)
    mod.train()
    leaves = [torch.from_numpy(a).requires_grad_() for a in inputs]
    out = mod(*leaves)
    torch.sin(out).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=1e-4,
                               rtol=1e-4)
    want = {k: v.numpy() for k, v in params_from_jax(g_params).items()}
    want.update({f"input{i}": np.asarray(g) for i, g in enumerate(g_in)})
    got = {k: p.grad for k, p in mod.named_parameters()}
    got.update({f"input{i}": t.grad for i, t in enumerate(leaves)})
    _assert_close_each(got, want, 1e-3)


def test_encoder_block_on_the_k12_route(monkeypatch):
    """One ViT block at L = 512: the JAX block sends its attention to the
    head-major attention_pallas (K12), the port's to K6's plain version."""
    x = np.random.default_rng(54).standard_normal((1, 512, 128)).astype(
        np.float32)
    _module_route(monkeypatch,
                  JaxEncoderBlock(num_heads=2, mlp_dim=256, use_pallas=True),
                  EncoderBlock(128, 2, 256), [x])


def test_mhada_block_on_the_k10_k11_route(monkeypatch):
    """One MHAda block at N = M = 512: the JAX block sends its core to the
    head-major mhada_attention_pallas (K10 with residuals, K11), the port's
    to K7's plain version."""
    rng = np.random.default_rng(55)
    fc, fs, fcs = (rng.standard_normal((1, 512, 128)).astype(np.float32)
                   for _ in range(3))
    _module_route(monkeypatch, JaxAdaAttn(num_heads=2, use_pallas=True),
                  AdaAttnMultiHead(128, num_heads=2), [fc, fs, fcs])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ln_matmul_vjp_matches_jax(dtype):
    """K2's VJP: the port's ln_matmul gradients of all five inputs against
    the JAX ln_matmul's custom VJP (tests/test_ln_matmul.py:49-73's shapes).
    bfloat16: every input cast as the bf16 training step casts its
    parameters; each gradient comes back in its input's dtype.  The
    backward saves the inputs alone, never the normalised tensor."""
    rng = np.random.default_rng(56)
    b, n, e, f = 1, 512, 128, 256
    x = rng.standard_normal((b, n, e)).astype(np.float32)
    s = (rng.standard_normal(e) * 0.1 + 1.0).astype(np.float32)
    sb = (rng.standard_normal(e) * 0.1).astype(np.float32)
    w = (rng.standard_normal((e, f)) / np.sqrt(e)).astype(np.float32)
    bias = (rng.standard_normal(f) * 0.1).astype(np.float32)
    jdt = jnp.dtype(dtype)
    jargs = tuple(jnp.asarray(a, jdt) for a in (x, s, sb, w, bias))
    with pltpu.force_tpu_interpret_mode():
        ref = jax_ln_matmul(*jargs)
        g_ref = jax.grad(lambda a: jnp.sum(jnp.sin(
            jax_ln_matmul(*a).astype(jnp.float32))))(jargs)
    tdt = getattr(torch, dtype)
    targs = [torch.from_numpy(a).to(tdt)
             for a in (x, s, sb, np.ascontiguousarray(w.T), bias)]
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t

    leaves = [t.requires_grad_() for t in targs]
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = ln_matmul(*leaves)
    torch.sin(out.float()).sum().backward()
    assert sorted(saved) == sorted([(b, n, e), (e,), (e,), (f, e)])
    names = ["dx", "dscale", "dbias", "dw", "db"]
    got = [t.grad for t in leaves]
    got[3] = got[3].T
    rel = 1e-4 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(
        out.float().detach().numpy(), np.asarray(ref, np.float32),
        atol=rel * float(jnp.abs(ref.astype(jnp.float32)).max()))
    for name, g, r in zip(names, got, g_ref):
        assert g.dtype == tdt, name
        r = np.array(r, np.float32)
        err = float((g.float() - torch.from_numpy(r)).abs().max())
        assert err <= rel * float(np.abs(r).max()), (name, err)


SMALL = dict(num_layers=2, hidden_dim=128, num_heads=2, mlp_dim=256)


@pytest.mark.parametrize("fuse_ln,for_training,fused", [
    ("auto", False, True), ("auto", True, False), (True, False, True),
    (True, True, True), (False, False, False), (False, True, False)])
def test_fuse_ln_resolution(monkeypatch, fuse_ln, for_training, fused):
    """fuse_ln picks the fused route in the builds the JAX package picks it
    in (mhada_tpu/train/train_image.py:51-53): each ViT block then calls
    ln_matmul twice, and both LNs run unfused otherwise."""
    calls = []

    def counted(*args, **kwargs):
        calls.append(args[0].shape)
        return ln_matmul(*args, **kwargs)

    monkeypatch.setattr(vit, "ln_matmul", counted)
    monkeypatch.setattr(layers, "ln_matmul", counted)
    models = build_models(ModelConfig(fuse_ln=fuse_ln, **SMALL), "cpu",
                          for_training=for_training)
    img = torch.from_numpy(np.random.default_rng(57).uniform(
        0, 255, (1, 32, 32, 3)).astype(np.float32))
    feats = models["vit_c"](img)
    assert all(getattr(models[net], f"block{i}").fuse_ln == fused
               for net in ("vit_c", "vit_s") for i in range(2))
    assert len(calls) == (2 * SMALL["num_layers"] if fused else 0)
    if for_training:    # the fused route is differentiable
        feats[-1].sum().backward()
        assert models["vit_c"].block0.ln1.weight.grad is not None


def test_fuse_ln_rejects_unknown_values():
    with pytest.raises(ValueError, match="fuse_ln"):
        ModelConfig(fuse_ln="yes")
