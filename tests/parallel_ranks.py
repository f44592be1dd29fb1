"""Rank functions of the multi-rank CPU tests (tests/test_torch_parallel_*.py),
run by ``mhada_tpu_torch.parallel.launch.run_ranks`` in spawned gloo
processes.  This module imports no JAX, so the ranks start quickly; the
test files compare what the ranks return with the JAX package.

Each rank builds the same seeded port models; a picture that is not all at
the decoder's ReLU needs ``treat_decoder``."""

import numpy as np
import torch

# c6 is conv + ReLU: this gain scales the random decoder's small output into
# a picture, and the offset lifts every channel off the ReLU's 0 (0-255)
C6_GAIN, C6_OFFSET = 3000.0, 50.0
# the decoder convs in the JAX tree's (sorted) order, as (in, out) channels
# for a trunk of width c
DECODER_CONVS = ("c1", "c2", "c3", "c4", "c5", "c6", "up1", "up2", "up3")


def decoder_channels(c: int) -> dict:
    return {"up1": (c, 256), "c1": (256, 256), "c2": (256, 256),
            "c3": (256, 256), "up2": (256, 128), "c4": (128, 128),
            "up3": (128, 64), "c5": (64, 64), "c6": (64, 3)}


def treat_decoder(models: dict) -> None:
    """Scale c6 by C6_GAIN and raise its bias by C6_OFFSET."""
    c6 = models["adaFormer"].decoder.c6.conv
    with torch.no_grad():
        c6.weight.mul_(C6_GAIN)
        c6.bias.mul_(C6_GAIN).add_(C6_OFFSET)


def mix_decoder(models: dict) -> None:
    """tests/test_sp.py's ``_mixing_decoder_params`` on the port's decoder,
    draw for draw: every conv an identity centre tap plus small spatial
    mixing noise, biases 0.05, so every conv mixes rows (a slab-boundary
    fault propagates) and the picture stays mid-range."""
    dec = models["adaFormer"].decoder
    chans = decoder_channels(dec.up1.conv.weight.shape[1])
    rng = np.random.default_rng(7)
    with torch.no_grad():
        for name in DECODER_CONVS:
            ci, co = chans[name]
            amp = 1.0 / (3.0 * np.sqrt(ci))
            k = rng.uniform(-amp, amp, (3, 3, ci, co)).astype(np.float32)
            for o in range(co):
                k[1, 1, o % ci, o] += 1.0
            conv = getattr(dec, name).conv
            conv.weight.copy_(torch.from_numpy(k.transpose(3, 2, 0, 1)))
            conv.bias.fill_(0.05)


def build(cfg: dict, device, seed: int = 0, decoder: str = "treat"):
    from mhada_tpu_torch.config import ModelConfig
    from mhada_tpu_torch.models import build_models

    models = build_models(ModelConfig(**cfg), device,
                          torch.Generator().manual_seed(seed))
    (treat_decoder if decoder == "treat" else mix_decoder)(models)
    return models


def style_kv(models, style):
    from mhada_tpu_torch.infer.image import (make_encode_style_fn,
                                             precompute_style_kv)

    return precompute_style_kv(models, make_encode_style_fn(models)(style))


def sub_group(group, n: int):
    """A group of ranks 0 .. n - 1 (every rank must call this), or None on
    the ranks outside it."""
    import torch.distributed as dist

    from mhada_tpu_torch.parallel import Group

    if n == group.size:
        return group
    pg = dist.new_group(list(range(n)))
    return Group(pg, group.device) if group.rank < n else None


def _bytes(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().reshape(-1).view(torch.uint8).numpy().copy()


def collective_values(rank: int) -> dict:
    """Rank ``rank``'s inputs of the collectives test: float32 and bf16
    values with a signed zero, a NaN and infinities planted."""
    g = torch.Generator().manual_seed(100 + rank)
    out = {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        x = torch.randn(2, 3, 5, generator=g).to(dtype)
        x[0, 0, :4] = torch.tensor([-0.0, float("nan"), float("inf"),
                                    -float("inf")]).to(dtype)
        out[name] = x
    return out


def sp_inputs() -> dict:
    """The SP tests' inputs, made from one seed (in the test and in every
    rank alike): SMALL's 128 x 64 frame (16 token rows, 4 a rank at 4
    ranks), the narrow 512 x 64 frame (64 token rows, 16 a rank: a slab of
    16 + 2 x 5 rows is genuinely local), their styles, and the instance
    norm's tokens."""
    rng = np.random.default_rng(11)
    return dict(
        content=rng.uniform(0, 255, (1, 128, 64, 3)).astype(np.float32),
        style=rng.uniform(0, 255, (1, 64, 64, 3)).astype(np.float32),
        frame=rng.uniform(0, 255, (1, 512, 64, 3)).astype(np.float32),
        style_narrow=rng.uniform(0, 255, (1, 64, 64, 3)).astype(np.float32),
        stats_x=(rng.standard_normal((2, 64, 8)) * 3 + 1).astype(np.float32))


def sp_ranks(group, small: dict, narrow: dict, margins) -> dict:
    """Everything test_torch_parallel_sp.py needs from 4 ranks: the
    collectives on both paths, the group instance norm, the port's SP
    frame over 4 and over 2 ranks, and the narrow frame over 4 ranks at
    each of ``margins`` with rank 0's single-rank frames."""
    from mhada_tpu_torch.infer.image import make_stylize_with_kv_fn
    from mhada_tpu_torch.ops.instance_norm import (instance_norm_stats,
                                                   instance_norm_tokens)
    from mhada_tpu_torch.parallel import Group, make_sp_stylize_fn

    out = {}
    forced = Group(device=group.device, via_all_reduce=True)
    vals = collective_values(group.rank)
    for name, x in vals.items():
        for path, grp in (("native", group), ("all_reduce", forced)):
            out[f"gather_{name}_{path}"] = _bytes(grp.all_gather(x))
            out[f"rows_{name}_{path}"] = _bytes(grp.gather_rows(x, dim=1))
            out[f"shift_{name}_{path}"] = _bytes(grp.ring_shift(x))
    out["sum"] = group.all_reduce_sum(torch.full((3,), float(group.rank)))

    data = {k: torch.from_numpy(v) for k, v in sp_inputs().items()}
    x = data["stats_x"]
    n = x.shape[1] // group.size
    xl = x[:, group.rank * n:(group.rank + 1) * n]
    out["in_stats"] = instance_norm_stats(xl, group=group)
    out["in_tokens"] = instance_norm_tokens(xl, group=group)

    models = build(small, "cpu")
    kv = style_kv(models, data["style"])
    c = data["content"]
    out["sp4"] = make_sp_stylize_fn(models, group)(c, kv)
    two = sub_group(group, 2)
    if two is not None:
        out["sp2"] = make_sp_stylize_fn(models, two)(c, kv)
    if group.rank == 0:
        out["single"] = make_stylize_with_kv_fn(models)(c, kv)

    models = build(narrow, "cpu", decoder="mix")
    kv = style_kv(models, data["style_narrow"])
    f = data["frame"]
    for m in margins:
        out[f"narrow_m{m}"] = make_sp_stylize_fn(
            models, group, decode_margin=m)(f, kv)
    if group.rank == 0:
        out["narrow_single"] = make_stylize_with_kv_fn(models)(f, kv)
    return out


def pp_inputs() -> dict:
    """The PP and DP tests' inputs, made from one seed: 3 frames of 64^2 and
    a style for PP, 8 pairs at 32^2 for DP."""
    rng = np.random.default_rng(13)
    return dict(
        contents=rng.uniform(0, 255, (3, 1, 64, 64, 3)).astype(np.float32),
        style=rng.uniform(0, 255, (1, 64, 64, 3)).astype(np.float32),
        dp_contents=rng.uniform(0, 255, (8, 32, 32, 3)).astype(np.float32),
        dp_styles=rng.uniform(0, 255, (8, 32, 32, 3)).astype(np.float32))


def pp_ranks(group, cfg: dict) -> dict:
    """Everything test_torch_parallel_pp.py needs from 4 ranks: PP over 2
    and 3 ranks (frames on the last stage; the calls of vit_c and of the
    decoder on each rank, counted by forward hooks) and DP over 4 ranks
    (models from a seed per rank, replicated from rank 0) with rank 0's
    B = 8 frames."""
    from mhada_tpu_torch.infer.image import (make_stylize_fn,
                                             make_stylize_with_kv_fn)
    from mhada_tpu_torch.parallel import (gather_batch, make_pp_stylize_fn,
                                          replicate, shard_batch)

    out = {}
    data = {k: torch.from_numpy(v) for k, v in pp_inputs().items()}
    models = build(cfg, "cpu")
    kv = style_kv(models, data["style"])
    frames = data["contents"]
    calls = {"vit_c": 0, "decoder": 0}
    hooked = {"vit_c": models["vit_c"],
              "decoder": models["adaFormer"].decoder}
    for n in (2, 3):
        grp = sub_group(group, n)
        if grp is None:
            continue
        fn = make_pp_stylize_fn(models, grp)
        for k in calls:
            calls[k] = 0
        handles = [mod.register_forward_hook(
            lambda *_, k=k: calls.__setitem__(k, calls[k] + 1))
            for k, mod in hooked.items()]
        try:
            cs = fn(frames, kv)
        finally:
            for h in handles:
                h.remove()
        out[f"pp{n}_calls"] = dict(calls)
        if cs is not None:
            out[f"pp{n}"] = cs
    if group.rank == 0:
        single = make_stylize_with_kv_fn(models)
        out["pp_single"] = torch.stack([single(f, kv) for f in frames])

    models = build(cfg, "cpu", seed=group.rank)
    replicate(group, models)
    c, s = data["dp_contents"], data["dp_styles"]
    full = make_stylize_fn(models)
    out["dp_full"] = gather_batch(group, full(*shard_batch(group, c, s)))
    kv = style_kv(models, s[:1])
    tiled = [(k.expand(c.shape[0], -1, -1).contiguous(),
              v.expand(c.shape[0], -1, -1).contiguous()) for k, v in kv]
    stream = make_stylize_with_kv_fn(models)
    out["dp_stream"] = gather_batch(group, stream(
        shard_batch(group, c), [shard_batch(group, k, v) for k, v in tiled]))
    if group.rank == 0:
        out["dp_full_ref"] = full(c, s)
        out["dp_stream_ref"] = stream(c, tiled)
    return out


# The training tests' model (tests/test_torch_train_step.py's TINY) and the
# meshes they run on: (n_data, n_model) over 4 ranks.
TRAIN_TINY = dict(hidden_dim=64, mlp_dim=128, num_heads=4)
MESHES = ((4, 1), (2, 2))
# (case, recipe, mesh, fuse_ln, planted fault): the steps held against the
# JAX step, then the controls that must fail that hold.  "copy":
# copy_to_model's backward without its sum over the model group; "ln": K2's
# LN-affine gradient without it; "nnz": each rank's temporal losses over its
# own mask (the single-rank masked mean on the rank's shard).
TRAIN_CASES = (
    ("image 4x1", "image", (4, 1), False, None),
    ("image 2x2", "image", (2, 2), False, None),
    ("fused 2x2", "image", (2, 2), True, None),
    ("video 2x2", "video", (2, 2), False, None),
    ("control copy", "image", (2, 2), False, "copy"),
    ("control ln", "image", (2, 2), True, "ln"),
    ("control nnz", "video", (2, 2), False, "nnz"),
)


def train_configs(fuse_ln: bool = False) -> dict:
    """{recipe: config} at the CPU tests' sizes: the image step at B = 4,
    32^2; the video step at B = 2, 32 x 64 frames against 32^2 styles."""
    from mhada_tpu_torch.config import (ImageTrainConfig, ModelConfig,
                                        VideoTrainConfig)

    model = ModelConfig(fuse_ln=fuse_ln, **TRAIN_TINY)
    return {"image": ImageTrainConfig(model=model, batch_size=4,
                                      image_size=(32, 32)),
            "video": VideoTrainConfig(model=model, batch_size=2,
                                      style_size=(32, 32),
                                      content_size=(32, 64))}


def train_inputs() -> dict:
    """The global batches, made from one seed: the image step's (content,
    style) and the video step's (style, c1, c2, flow, mask), flow 2 N(0, 1)
    and a U > 0.5 mask with sample 1 fully occluded
    (tests/test_train_step.py:180): at 2 data ranks it is the second
    rank's whole shard."""
    rng = np.random.default_rng(21)

    def px(*shape):
        return rng.uniform(0, 255, shape).astype(np.float32)

    mask = (rng.uniform(size=(2, 32, 64)) > 0.5).astype(np.float32)
    mask[1] = 0.0
    return {"image": [px(4, 32, 32, 3), px(4, 32, 32, 3)],
            "video": [px(2, 32, 32, 3), px(2, 32, 64, 3), px(2, 32, 64, 3),
                      (rng.standard_normal((2, 32, 64, 2)) * 2).astype(
                          np.float32), mask]}


def train_models(cfg, device="cpu"):
    """The seeded training build every rank and the test start from, its
    decoder treated (``treat_decoder``): untreated, the random decoder's
    output sits at c6's ReLU, where the masks of two correct roundings
    differ and move every gradient by their share (0.17 % between the
    single-rank port and JAX steps on these weights)."""
    from mhada_tpu_torch.train.train_image import init_params

    models = init_params(cfg, device, torch.Generator().manual_seed(0))
    treat_decoder(models)
    return models


def planted(fault: str | None):
    """A context that plants ``fault`` (see TRAIN_CASES) in this
    process."""
    import contextlib

    from mhada_tpu_torch.parallel import tp
    from mhada_tpu_torch.train import losses

    if fault is None:
        return contextlib.nullcontext()
    target, name, fake = {
        "copy": (tp, "_copy_grad", lambda group, g: g),
        "ln": (tp, "ln_affine_to_model", lambda group, *params: params),
        "nnz": (losses, "_masked_mean",
                lambda per_elem, nnz, group=None: real(per_elem, nnz)),
    }[fault]
    real = getattr(target, name)

    @contextlib.contextmanager
    def patch():
        setattr(target, name, fake)
        try:
            yield
        finally:
            setattr(target, name, real)

    return patch()


def train_ranks(group) -> dict:
    """Every case of TRAIN_CASES on this rank: one step of the tensor- and
    data-parallel build from the seeded weights on this rank's shard of
    the global batch -> on rank 0 {case: (metrics, gathered gradients,
    gathered new parameters)}; on every rank {case "replicas": whether the
    replicated parameters stayed bitwise equal across its model group,
    "round trip": whether ``gather_params`` of ``shard_params`` on (2 x 2)
    gave every tensor back bitwise}."""
    from mhada_tpu_torch.parallel.mesh import (gather_params, make_mesh,
                                               replicas_equal, shard_batch,
                                               shard_params)
    from mhada_tpu_torch.train.recipes import recipe
    from mhada_tpu_torch.train.train_image import TRAINABLE, make_optimizers

    meshes = {shape: make_mesh(*shape, group.device) for shape in MESHES}
    data = {k: [torch.from_numpy(a) for a in v]
            for k, v in train_inputs().items()}
    whole = train_models(train_configs()["image"])
    back = gather_params(shard_params(whole, meshes[2, 2].model),
                         meshes[2, 2].model)
    out = {"round trip": all(
        torch.equal(t, back[k][name]) for k in TRAINABLE
        for name, t in whole[k].state_dict().items())}
    for case, kind, shape, fuse_ln, fault in TRAIN_CASES:
        mesh = meshes[shape]
        cfg = train_configs(fuse_ln)[kind]
        local = shard_params(train_models(cfg), mesh.model)
        step = recipe(cfg).make_step(cfg, local,
                                     make_optimizers(local, cfg), mesh.data,
                                     mesh.model)
        with planted(fault):
            metrics = step(*shard_batch(mesh.data, *data[kind]))
        trained = {k: local[k] for k in TRAINABLE}
        grads = gather_params(trained, mesh.model, grads=True)
        new = gather_params(trained, mesh.model)
        out[f"{case} replicas"] = replicas_equal(trained, mesh.model)
        if group.rank == 0:
            out[case] = ({k: float(v) for k, v in metrics.items()}, grads,
                         new)
    return out
