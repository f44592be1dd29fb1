"""Image stylization (mhada_tpu/infer/image.py:83-220, 286-337; reference
infer_image.py:47-94).

- ``make_stylize_fn``: the full path, style re-encoded on every call;
- the streaming path: ``make_encode_style_fn`` and ``precompute_style_kv``
  once per style, then ``make_stylize_with_kv_fn`` per frame (every
  style-only computation hoisted, reference infer_video.py:58-61), or
  ``make_stylize_with_fs_fn`` with the style features alone.

Weights live in the modules, so each function takes the models dict from
``models.build_models``; the dict also carries the decoder's tail, so
``build_models(..., decoder_tail="c6")`` gives every function here the c6
tail (K13) with no change to it.  The CLI runs vit_c / vit_s / AdaFormer on one
content and style pair, clamps to [0, 255] and saves a PNG.  Weights: a
reference ``.pth`` triple (``--ada/--vitc/--vits``), or random weights
from seed 0 (smoke mode).
"""

import argparse

import numpy as np
import torch

from ..config import ModelConfig
from ..utils.image_io import load_image, save_image

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def default_attn_mode(ada_path) -> str:
    """Reference .pth triples were trained with the batch-coupled quirk;
    random weights are spatial."""
    return "batch_coupled" if (
        ada_path and str(ada_path).endswith(".pth")) else "spatial"


def make_stylize_fn(models: dict, dtype: torch.dtype = torch.float32):
    """``fn(content, style) -> cs`` on (B, H, W, 3) tensors in [0, 255]
    lying on the models' device; returns float32 clamped to [0, 255].

    ``dtype`` is the compute dtype: weights stay float32 and are cast at
    use, the output is clamped in float32.
    """

    @torch.inference_mode()
    def fn(content: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
        fc = models["vit_c"](content.to(dtype))
        fs = models["vit_s"](style.to(dtype))
        _, cs = models["adaFormer"](fc, fs)
        return cs.float().clamp(0, 255)

    return fn


def make_encode_style_fn(models: dict, dtype: torch.dtype = torch.float32):
    """``fn(style) -> fs``: the style encoder, run once per style."""

    @torch.inference_mode()
    def fn(style: torch.Tensor) -> list[torch.Tensor]:
        return models["vit_s"](style.to(dtype))

    return fn


def make_stylize_with_fs_fn(models: dict, dtype: torch.dtype = torch.float32):
    """``fn(content, fs) -> cs`` with precomputed style features."""

    @torch.inference_mode()
    def fn(content: torch.Tensor, fs: list[torch.Tensor]) -> torch.Tensor:
        fc = models["vit_c"](content.to(dtype))
        _, cs = models["adaFormer"](fc, fs)
        return cs.float().clamp(0, 255)

    return fn


@torch.inference_mode()
def precompute_style_kv(models: dict, fs: list[torch.Tensor]) -> list:
    """Every style-only MHAda computation, hoisted out of the frame loop.

    Block j (layer i = j // 2) gets K = g_j(IN(fs_i)) and V = h_j(fs_i),
    token-major (B, M, C) with channel h * d + e for head h, the layout K3
    reads.  Returns the 2 * num_layers (k, v) pairs for
    ``AdaFormer(..., style_kv=...)``.
    """
    ada = models["adaFormer"]
    kv = []
    for i in range(ada.num_layers):
        tok = fs[i].reshape(fs[i].shape[0], -1, fs[i].shape[-1])
        for j in (2 * i, 2 * i + 1):
            kv.append(getattr(ada, f"ada{j}").style_kv(tok))
    return kv


def make_stylize_with_kv_fn(models: dict, dtype: torch.dtype = torch.float32):
    """``fn(content, style_kv) -> cs``: the streaming forward, vit_c, the
    MHAda blocks on cached K/V (K3) and the decoder.  ``style_kv`` comes
    from ``precompute_style_kv`` at the same dtype; its batch matches the
    content's (tile it for a batch of frames)."""

    @torch.inference_mode()
    def fn(content: torch.Tensor, style_kv: list) -> torch.Tensor:
        fc = models["vit_c"](content.to(dtype))
        _, cs = models["adaFormer"](fc, None, style_kv)
        return cs.float().clamp(0, 255)

    return fn


def stylize_image(models: dict, content: np.ndarray, style: np.ndarray,
                  dtype: torch.dtype = torch.float32) -> np.ndarray:
    """content/style: HWC float32 0-255 -> stylized HWC float32 0-255."""
    device = next(models["vit_c"].parameters()).device
    fn = make_stylize_fn(models, dtype)

    def batch(a):
        return torch.from_numpy(np.asarray(a, np.float32))[None].to(device)

    out = fn(batch(content), batch(style))
    return out[0].cpu().numpy()


def add_model_args(ap: argparse.ArgumentParser) -> None:
    """Weights, dtype and device: the options every inference CLI shares."""
    ap.add_argument("--ada", help="reference .pth AdaFormer checkpoint")
    ap.add_argument("--vitc")
    ap.add_argument("--vits")
    ap.add_argument("--dtype", default="float32", choices=sorted(DTYPES))
    ap.add_argument("--attn-mode", default=None,
                    choices=["spatial", "batch_coupled"],
                    help="default: batch_coupled when loading .pth weights")
    ap.add_argument("--device", default="cuda",
                    help="default: cuda; without a card pass --device cpu")


def models_from_args(ap: argparse.ArgumentParser, args) -> dict:
    """Build the models on ``--device`` (raises without a card unless it is
    the CPU) and load the ``.pth`` triple, or warn of random weights."""
    from ..interop import load_params, load_pth_params
    from ..models import build_models

    if args.ada and not (args.ada.endswith(".pth") and args.vitc
                         and args.vits):
        ap.error("--ada/--vitc/--vits must name a reference .pth triple "
                 "(orbax directories are not supported by this port)")
    attn_mode = args.attn_mode or default_attn_mode(args.ada)
    models = build_models(ModelConfig(attn_mode=attn_mode), args.device)
    if args.ada:
        load_params(models, load_pth_params(args.ada, args.vitc, args.vits))
    else:
        print("WARNING: no checkpoint given — random weights (smoke mode)")
    return models


def main(argv=None):
    import os

    ap = argparse.ArgumentParser(
        description=__doc__,
        epilog="Checkpoints: reference .pth triples only; the JAX package's "
               "orbax weight directories are not read by this port.")
    ap.add_argument("--content", required=True)
    ap.add_argument("--style", required=True)
    ap.add_argument("--out", default="./results/stylized.png")
    ap.add_argument("--size", type=int, nargs=2, default=(512, 512))
    add_model_args(ap)
    args = ap.parse_args(argv)

    models = models_from_args(ap, args)
    c = load_image(args.content, tuple(args.size))
    s = load_image(args.style, tuple(args.size))
    out = stylize_image(models, c, s, DTYPES[args.dtype])
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    save_image(args.out, out)
    print(f"saved {args.out}  range=[{out.min():.1f}, {out.max():.1f}]")


if __name__ == "__main__":
    main()
