"""Host-side image I/O in the reference's pixel conventions (the port's own
copy of mhada_tpu/utils/image_io.py:35-88; importing that package pulls in
jax).  Pixels are float32 RGB HWC in [0, 255]; video frames may stay uint8.
cv2 and PIL are imported where they are used."""

import os

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


def cv2_to_tensor(img: np.ndarray, resize=None,
                  keep_uint8: bool = False) -> np.ndarray:
    """BGR frame (cv2) -> RGB HWC, float32 0-255 unless ``keep_uint8``,
    optionally INTER_AREA-resized to (width, height) (reference
    utilities.py:43-52).  The video CLI keeps frames uint8 until they are
    on the device."""
    import cv2

    img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    if resize is not None:
        img = cv2.resize(img, resize, interpolation=cv2.INTER_AREA)
    return img if keep_uint8 else img.astype(np.float32)


def list_files(directory: str) -> list[str]:
    return sorted(f.path for f in os.scandir(directory) if f.is_file())


def list_folders(directory: str) -> list[str]:
    return sorted(f.path for f in os.scandir(directory) if f.is_dir())


def mkdir(directory: str, delete_existing_files: bool = False) -> None:
    os.makedirs(directory, exist_ok=True)
    if delete_existing_files:
        for f in list_files(directory):
            os.remove(f)
