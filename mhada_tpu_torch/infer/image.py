"""Single-pair image stylization (mhada_tpu/infer/image.py:83-123, 210-220,
286-337; reference infer_image.py:47-94).

Runs vit_c / vit_s / AdaFormer on content and style images, clamps to
[0, 255] and saves a PNG.  Weights: a reference ``.pth`` triple
(``--ada/--vitc/--vits``), or random weights from seed 0 (smoke mode).
"""

import argparse

import numpy as np
import torch

from ..config import ModelConfig

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


def stylize_image(models: dict, content: np.ndarray, style: np.ndarray,
                  dtype: torch.dtype = torch.float32) -> np.ndarray:
    """content/style: HWC float32 0-255 -> stylized HWC float32 0-255."""
    device = next(models["vit_c"].parameters()).device
    fn = make_stylize_fn(models, dtype)

    def batch(a):
        return torch.from_numpy(np.asarray(a, np.float32))[None].to(device)

    out = fn(batch(content), batch(style))
    return out[0].cpu().numpy()


def _load_image(path: str, size_hw) -> np.ndarray:
    """RGB float32 0-255, PIL-bilinear resized to (H, W) (reference
    infer_image.py:69-77)."""
    from PIL import Image

    img = Image.open(path).convert("RGB")
    img = img.resize((size_hw[1], size_hw[0]), Image.BILINEAR)
    return np.asarray(img, dtype=np.float32)


def _save_image(path: str, arr: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(np.asarray(arr).astype(np.uint8)).save(path)


def main(argv=None):
    import os

    from ..interop import load_params, load_pth_params
    from ..models import build_models

    ap = argparse.ArgumentParser(
        description=__doc__,
        epilog="Checkpoints: reference .pth triples only; the JAX package's "
               "orbax weight directories are not read by this port.")
    ap.add_argument("--content", required=True)
    ap.add_argument("--style", required=True)
    ap.add_argument("--out", default="./results/stylized.png")
    ap.add_argument("--size", type=int, nargs=2, default=(512, 512))
    ap.add_argument("--ada", help="reference .pth AdaFormer checkpoint")
    ap.add_argument("--vitc")
    ap.add_argument("--vits")
    ap.add_argument("--dtype", default="float32", choices=sorted(DTYPES))
    ap.add_argument("--attn-mode", default=None,
                    choices=["spatial", "batch_coupled"],
                    help="default: batch_coupled when loading .pth weights")
    ap.add_argument("--device", default=None,
                    help="default: cuda when available, else cpu")
    args = ap.parse_args(argv)

    if args.ada and not (args.ada.endswith(".pth") and args.vitc
                         and args.vits):
        ap.error("--ada/--vitc/--vits must name a reference .pth triple "
                 "(orbax directories are not supported by this port)")
    device = args.device or ("cuda" if torch.cuda.is_available() else "cpu")
    attn_mode = args.attn_mode or default_attn_mode(args.ada)
    models = build_models(ModelConfig(attn_mode=attn_mode), device)
    if args.ada:
        load_params(models, load_pth_params(args.ada, args.vitc, args.vits))
    else:
        print("WARNING: no checkpoint given — random weights (smoke mode)")

    c = _load_image(args.content, tuple(args.size))
    s = _load_image(args.style, tuple(args.size))
    out = stylize_image(models, c, s, DTYPES[args.dtype])
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    _save_image(args.out, out)
    print(f"saved {args.out}  range=[{out.min():.1f}, {out.max():.1f}]")


if __name__ == "__main__":
    main()
