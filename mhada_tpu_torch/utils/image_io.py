"""Host-side image I/O in the reference's pixel conventions (the port's own
copy of mhada_tpu/utils/image_io.py:35-88; importing that package pulls in
jax).  Pixels are float32 RGB HWC in [0, 255]."""

import numpy as np


def load_image(path: str, size_hw=None) -> np.ndarray:
    """RGB float32 0-255, optionally PIL-bilinear resized to (H, W)
    (reference infer_image.py:69-77)."""
    from PIL import Image

    img = Image.open(path).convert("RGB")
    if size_hw is not None:
        img = img.resize((size_hw[1], size_hw[0]), Image.BILINEAR)
    return np.asarray(img, dtype=np.float32)


def save_image(path: str, arr) -> None:
    """Save an HWC (or 1HWC) float array, already clamped to 0-255."""
    from PIL import Image

    a = np.asarray(arr)
    if a.ndim == 4:
        a = a[0]
    Image.fromarray(a.astype(np.uint8)).save(path)
