"""Optical-flow file I/O: .flo (Middlebury PIEH), .pfm (SceneFlow) and
.float3 (the port's own copy of mhada_tpu/data/flowlib.py:16-134, numpy
only; reference flowlib.py:14-32).

PFM rows are stored bottom-up and a negative scale means little-endian.
"""

import re
import numpy as np

_PIEH_MAGIC = 202021.25


def read(path: str) -> np.ndarray:
    """Dispatch by extension (reference flowlib.py:14-22)."""
    if path.endswith(".float3"):
        return read_float(path)
    if path.endswith((".flo", ".FLO")):
        return read_flow(path)
    if path.endswith((".pfm", ".PFM")):
        return read_pfm(path)[0]
    if path.endswith((".ppm", ".pgm", ".png", ".jpg")):
        from PIL import Image

        return np.asarray(Image.open(path))
    raise ValueError(f"don't know how to read {path}")


def write(path: str, data: np.ndarray) -> None:
    if path.endswith(".float3"):
        return write_float(path, data)
    if path.endswith((".flo", ".FLO")):
        return write_flow(path, data)
    if path.endswith((".pfm", ".PFM")):
        return write_pfm(path, data)
    if path.endswith((".ppm", ".pgm", ".png", ".jpg")):
        from PIL import Image

        Image.fromarray(data).save(path)
        return
    raise ValueError(f"don't know how to write {path}")


def read_flow(path: str) -> np.ndarray:
    """.flo -> (H, W, 2) float32; a PFM flow file gives its first 2
    channels."""
    if path.endswith((".pfm", ".PFM")):
        return read_pfm(path)[0][:, :, :2]
    with open(path, "rb") as f:
        magic = np.frombuffer(f.read(4), np.float32)[0]
        if magic != _PIEH_MAGIC:
            raise ValueError(f"{path}: bad .flo magic {magic}")
        w, h = np.frombuffer(f.read(8), np.int32)
        data = np.frombuffer(f.read(int(w) * int(h) * 8), np.float32)
    return data.reshape(int(h), int(w), 2).copy()


def write_flow(path: str, flow: np.ndarray) -> None:
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        np.asarray([_PIEH_MAGIC], np.float32).tofile(f)
        np.asarray([w, h], np.int32).tofile(f)
        flow.astype(np.float32).tofile(f)


def read_pfm(path: str) -> tuple[np.ndarray, float]:
    """PFM -> (data, scale). Rows are stored bottom-up; negative scale means
    little-endian. Returns top-down (H, W[, 3]) float array."""
    with open(path, "rb") as f:
        header = f.readline().rstrip().decode("ascii")
        if header == "PF":
            channels = 3
        elif header == "Pf":
            channels = 1
        else:
            raise ValueError(f"{path}: not a PFM file")
        dims = re.match(r"^(\d+)\s+(\d+)\s*$", f.readline().decode("ascii"))
        if not dims:
            raise ValueError(f"{path}: malformed PFM header")
        w, h = map(int, dims.groups())
        scale = float(f.readline().decode("ascii").rstrip())
        endian = "<" if scale < 0 else ">"
        data = np.frombuffer(
            f.read(w * h * channels * 4), dtype=endian + "f4"
        )
    shape = (h, w, 3) if channels == 3 else (h, w)
    return np.flipud(data.reshape(shape)).copy(), abs(scale)


def write_pfm(path: str, image: np.ndarray, scale: float = 1.0) -> None:
    if image.dtype != np.float32:
        raise ValueError("PFM requires float32")
    color = image.ndim == 3 and image.shape[2] == 3
    if not color and not (image.ndim == 2 or image.shape[2] == 1):
        raise ValueError("PFM image must be HxW, HxWx1 or HxWx3")
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{image.shape[1]} {image.shape[0]}\n".encode("ascii"))
        f.write(f"{-scale}\n".encode("ascii"))  # little-endian host
        np.flipud(image).astype("<f4").tofile(f)


def read_float(path: str) -> np.ndarray:
    """Freiburg .float3 format (reference flowlib.py:140-162)."""
    with open(path, "rb") as f:
        if f.readline().decode("utf-8") != "float\n":
            raise ValueError(f"{path}: missing float keyword")
        dim = int(f.readline())
        dims = [int(f.readline()) for _ in range(dim)]
        count = int(np.prod(dims))
        data = np.fromfile(f, np.float32, count).reshape(list(reversed(dims)))
    if dim > 2:
        data = np.transpose(data, (2, 1, 0))
        data = np.transpose(data, (1, 0, 2))
    return data


def write_float(path: str, data: np.ndarray) -> None:
    dim = data.ndim
    if dim > 3:
        raise ValueError(f"bad float file dimension: {dim}")
    with open(path, "wb") as f:
        f.write(b"float\n")
        f.write(f"{dim}\n".encode("ascii"))
        if dim == 1:
            f.write(f"{data.shape[0]}\n".encode("ascii"))
        else:
            f.write(f"{data.shape[1]}\n".encode("ascii"))
            f.write(f"{data.shape[0]}\n".encode("ascii"))
            for i in range(2, dim):
                f.write(f"{data.shape[i]}\n".encode("ascii"))
        arr = data.astype(np.float32)
        (arr if dim == 2 else np.transpose(arr, (2, 0, 1))).tofile(f)
