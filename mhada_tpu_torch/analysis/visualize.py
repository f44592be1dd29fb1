"""Feature-inversion visualisations (mhada_tpu/analysis/visualize.py:1-286;
reference visual_vit.py, visual_mhada.py, visual_cnn.py).

Optimise an image so that its features match a target's, by gradient
descent through frozen networks with respect to the input.  Reference
recipes: ViT, Adam lr 0.5, 3000 iterations, MSE over the 3 block outputs
(visual_vit.py:88-120); MHAda, the same against the pre-decoder fcs
(visual_mhada.py:111-137, ``AdaFormer.transform``); VGG, progressive LBFGS
reconstruction over relu1..k prefixes (visual_cnn.py:69-97), with
``torch.optim.LBFGS`` and its strong-Wolfe line search in place of
``optax.lbfgs`` and its zoom line search (the same conditions, not the
same iterates), and an Adam variant in ``invert_vgg_features``.

The networks run their training build, so the ViT's attention is K6 and
AdaFormer's MHAda core K7, forward and backward, on a CUDA image.  Each
loop keeps its losses on the device and reads them once at the end, as
the JAX package's single ``lax.scan`` does.  Float32 only, without TF32.

    python -m mhada_tpu_torch.analysis.visualize --mode vit --target t.jpg \\
        [--ada A.pth --vitc C.pth --vits S.pth] [--iters 3000] [--device cpu]
"""

import os
from typing import Callable

import numpy as np
import torch

from ..ops.pad_conv import no_tf32


def normalize_per_channel(img) -> np.ndarray:
    """Per-channel min-max -> [0, 255] uint8 (visual_vit.py:104-113)."""
    x = (img.detach().cpu().numpy() if isinstance(img, torch.Tensor)
         else np.asarray(img))
    out = np.zeros_like(x)
    for c in range(x.shape[-1]):
        ch = x[..., c]
        lo, hi = ch.min(), ch.max()
        out[..., c] = (ch - lo) / (hi - lo + 1e-8) * 255.0
    return out.astype(np.uint8)


def feature_loss(feature_fn: Callable, target_feats) -> Callable:
    """img -> sum over the matched features of mean((f - t)^2)."""

    def loss_fn(img):
        loss = 0.0
        for f, t in zip(feature_fn(img), target_feats):
            loss = loss + torch.mean(torch.square(f - t))
        return loss

    return loss_fn


def _start(shape, device, seed: int, img0, draw) -> torch.Tensor:
    """The initial image: ``img0``, else ``draw(shape, generator)`` from a
    CPU generator seeded with ``seed`` (the same image on every device)."""
    if img0 is None:
        img0 = draw(tuple(shape), torch.Generator().manual_seed(seed))
    if not isinstance(img0, torch.Tensor):
        img0 = torch.from_numpy(np.array(img0, np.float32))
    return img0.detach().float().to(device).clone().requires_grad_()


def _invert(feature_fn: Callable, target_feats, shape, lr: float, iters: int,
            seed: int = 0, log_every: int = 500, img0=None,
            return_losses: bool = False):
    """Adam on an image whose features match ``target_feats`` -> the image
    as numpy (and the per-iteration losses with ``return_losses``).

    Starts from U(0, 255) drawn with ``seed``, or from ``img0``."""
    device = target_feats[0].device
    img = _start(shape, device, seed, img0,
                 lambda s, g: torch.rand(s, generator=g) * 255.0)
    loss_fn = feature_loss(feature_fn, target_feats)
    opt = torch.optim.Adam([img], lr=lr)
    losses = torch.empty(iters, device=device)
    with no_tf32():
        for i in range(iters):
            opt.zero_grad(set_to_none=True)
            loss = loss_fn(img)
            loss.backward()
            opt.step()
            losses[i] = loss.detach()
    ls = losses.cpu().numpy()
    if log_every:
        for i in range(0, iters, log_every):
            print(f"  iter {i}: loss {ls[i]:.6g}")
    out = img.detach().cpu().numpy()
    return (out, ls) if return_losses else out


def _targets(feature_fn, target_img) -> list[torch.Tensor]:
    with torch.no_grad(), no_tf32():
        return [f.detach() for f in feature_fn(target_img)]


def invert_vit_features(vit_apply: Callable, target_img: torch.Tensor,
                        lr: float = 0.5, iters: int = 3000, **kw):
    """visual_vit.py: match all 3 ViT block outputs of ``target_img``.
    ``kw``: ``_invert``'s seed, log_every, img0, return_losses."""
    target = _targets(vit_apply, target_img)
    return _invert(vit_apply, target, target_img.shape, lr, iters, **kw)


def invert_mhada_features(fcs_fn: Callable, content: torch.Tensor,
                          style: torch.Tensor, lr: float = 0.5,
                          iters: int = 3000, **kw):
    """visual_mhada.py: match the pre-decoder fcs of (content, style).

    ``fcs_fn(img)`` returns the fcs map for ``img`` as content against the
    fixed style (``AdaFormer.transform``, visual_mhada.py:43-75)."""
    del style   # fixed inside fcs_fn, as in the JAX signature
    target = _targets(lambda im: [fcs_fn(im)], content)
    return _invert(lambda im: [fcs_fn(im)], target, content.shape, lr,
                   iters, **kw)


def invert_vgg_features(vgg_apply: Callable, target_img: torch.Tensor,
                        last_layer: int, lr: float = 1.0, iters: int = 1000,
                        **kw):
    """visual_cnn.py: reconstruct from VGG relu1..k prefix features."""
    names = [f"relu{i}_1" for i in range(1, last_layer + 1)]

    def feats(img):
        d = vgg_apply(img)
        return [d[n] for n in names]

    target = _targets(feats, target_img)
    return _invert(feats, target, target_img.shape, lr, iters, **kw)


def _invert_lbfgs(feature_fn, target_feats, shape, iters: int, seed: int = 0,
                  img0=None):
    """LBFGS feature inversion (visual_cnn.py:77-91: noise init, MSE sum
    over the matched layers) -> (image, per-iteration losses) as numpy.

    ``torch.optim.LBFGS(lr=1, line_search_fn="strong_wolfe")`` taking one
    iteration a ``step`` call, so that each iteration records the loss at
    its start, as optax's loop does; starts from N(0, 1) drawn with
    ``seed``, or from ``img0``."""
    device = target_feats[0].device
    img = _start(shape, device, seed, img0,
                 lambda s, g: torch.randn(s, generator=g))
    loss_fn = feature_loss(feature_fn, target_feats)
    opt = torch.optim.LBFGS([img], lr=1.0, max_iter=1, max_eval=25,
                            line_search_fn="strong_wolfe")

    def closure():
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(img)
        loss.backward()
        return loss

    with no_tf32():
        losses = torch.stack([opt.step(closure).detach()
                              for _ in range(iters)])
    return img.detach().cpu().numpy(), losses.cpu().numpy()


def progressive_vgg_reconstruction(vgg_apply, target_img01: torch.Tensor,
                                   iters: int = 150):
    """visual_cnn.py:69-97: for k = 1..5 reconstruct a fresh noise image
    (seed k) so that its relu1_1..relu{k}_1 features match the target's.

    ``vgg_apply`` maps a [0, 1]-domain image to the 5-tap feature dict (the
    reference's local VGG19 normalises without /255, visual_cnn.py:9-15);
    target_img01: (1, H, W, 3) in [0, 1].  Yields (name, image01, losses):
    the prefix name, the image clamped to [0, 1] (visual_cnn.py:53-58) and
    the ``iters`` losses."""
    all_layers = [f"relu{i}_1" for i in range(1, 6)]
    with torch.no_grad(), no_tf32():
        target = {k: v.detach() for k, v in vgg_apply(target_img01).items()}
    for k in range(1, len(all_layers) + 1):
        layers = all_layers[:k]

        def feats(img, layers=layers):
            d = vgg_apply(img)
            return [d[n] for n in layers]

        img, losses = _invert_lbfgs(feats, [target[n] for n in layers],
                                    target_img01.shape, iters, seed=k)
        yield "_".join(layers), np.clip(img, 0.0, 1.0), losses


def main(argv=None):
    """CLI for the feature-inversion tools (reference visual_vit.py /
    visual_mhada.py / visual_cnn.py as one driver)."""
    import argparse

    from ..config import ModelConfig, resolve_device
    from ..infer.image import default_attn_mode
    from ..interop import load_params, load_pth_params, load_vgg19
    from ..models import VGG19Features, build_models
    from ..utils.image_io import load_image, save_image

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--mode", required=True,
                    choices=["vit", "mhada", "vgg", "vgg_progressive"])
    ap.add_argument("--target", required=True, help="target image")
    ap.add_argument("--style", help="style image (mhada mode)")
    ap.add_argument("--out", default="./results/inversion.png")
    ap.add_argument("--size", type=int, nargs=2, default=(256, 256))
    ap.add_argument("--iters", type=int, default=3000)
    ap.add_argument("--lr", type=float, default=0.5)
    ap.add_argument("--last-layer", type=int, default=3,
                    help="vgg mode: reconstruct from relu1..k")
    ap.add_argument("--log-every", type=int, default=500,
                    help="print every N-th loss (read once, at the end)")
    ap.add_argument("--ada")
    ap.add_argument("--vitc")
    ap.add_argument("--vits")
    ap.add_argument("--vgg19", help="torchvision VGG19 .pth (vgg modes)")
    ap.add_argument("--device", default="cuda",
                    help="default: cuda; without a card pass --device cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    def image(path):
        return torch.from_numpy(load_image(path, tuple(args.size)))[None].to(
            device)

    target = image(args.target)
    if args.mode in ("vit", "mhada"):
        if args.mode == "mhada" and not args.style:
            ap.error("--style is required in mhada mode")
        # the training build: K6 and K7 carry the input's gradient
        models = build_models(
            ModelConfig(attn_mode=default_attn_mode(args.ada)), device,
            for_training=True)
        if args.ada:
            load_params(models, load_pth_params(args.ada, args.vitc,
                                                args.vits))
        else:
            print("WARNING: random weights (smoke mode)")
        for net in models.values():
            net.requires_grad_(False)
        if args.mode == "vit":
            img = invert_vit_features(models["vit_c"], target, args.lr,
                                      args.iters, log_every=args.log_every)
        else:
            style = image(args.style)
            with torch.no_grad(), no_tf32():
                fs = models["vit_s"](style)

            def fcs_fn(img):
                return models["adaFormer"].transform(models["vit_c"](img), fs)

            img = invert_mhada_features(fcs_fn, target, style, args.lr,
                                        args.iters, log_every=args.log_every)
    else:
        vgg = VGG19Features()
        if args.vgg19:
            vgg.load_state_dict(load_vgg19(args.vgg19), strict=True)
        else:
            print("WARNING: random VGG weights")
            vgg.reset_parameters(torch.Generator().manual_seed(0))
        vgg = vgg.requires_grad_(False).to(device).eval()
        if args.mode == "vgg_progressive":
            # the reference recipe: 224^2, [0, 1] domain (its local VGG19
            # normalises without /255; x 255 cancels this module's /255),
            # LBFGS, 150 steps a prefix
            out_dir = os.path.dirname(args.out) or "./results"
            os.makedirs(out_dir, exist_ok=True)
            for name, img01, losses in progressive_vgg_reconstruction(
                    lambda x: vgg(x * 255.0), target / 255.0,
                    iters=min(args.iters, 150)):
                path = os.path.join(out_dir, f"reconstructed_{name}.jpg")
                save_image(path, (img01[0] * 255.0).astype(np.uint8))
                print(f"saved {path} (loss {losses[0]:.6g} -> "
                      f"{losses[-1]:.6g})")
            return
        img = invert_vgg_features(vgg, target, args.last_layer, args.lr,
                                  args.iters, log_every=args.log_every)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    save_image(args.out, normalize_per_channel(img[0]))
    print(f"saved {args.out}")


if __name__ == "__main__":
    main()
