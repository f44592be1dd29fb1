"""Build, load and launch the CUDA kernels in ``csrc/``.

The sources are compiled with ``nvcc`` into one shared library with a plain
C interface at first use, and bound with ``ctypes`` (no PyTorch headers, so
the build takes seconds, not minutes).  The library lands in ``_build/``
beside this file, named by a hash of the sources and flags, so an edited
source rebuilds and an unchanged one is reused.

``launch`` is the only place a kernel is launched from: it counts the
launch in ``LAUNCHES`` and raises if the C entry point returns a CUDA error.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry point -> argument types (pointers and the stream as c_void_p).
SIGNATURES = {
    "mhada_attention_fwd": [_P, _P, _I, _I, _I, _I, _F, _I, _P],
    "mhada_mhada_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "mhada_ln_matmul": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P],
    "mhada_decoder_tail": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                           _P],
}
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Launches per C entry point since the last reset_launches().
LAUNCHES = dict.fromkeys(SIGNATURES, 0)

_lib = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "are built from mhada_tpu_torch/csrc at first use")
    return found


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libmhada_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/*.cu into the shared library unless it is already built.

    The compiler's output (with ptxas' register and spill report) is kept
    in ``<library>.log``.
    """
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(s) for s in sorted(CSRC.glob("*.cu"))]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = (f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
           f"\n# {time.perf_counter() - t0:.1f} s, exit {proc.returncode}\n")
    out.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed (exit {proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, out)  # atomic: a concurrent build never sees a partial .so
    return out


def library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.mhada_error_string.argtypes = [ctypes.c_int]
        lib.mhada_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def dtype_code(t: torch.Tensor) -> int:
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"kernels take float32 or bfloat16, got {t.dtype}")
    return DTYPE_CODES[t.dtype]


def launch(name: str, device: torch.device, *args) -> None:
    """Call C entry point ``name`` on ``device``'s current stream.

    ``args`` are the entry point's arguments without the trailing stream;
    tensors are passed as their data pointers.  Raises on a CUDA error.
    """
    lib = library()
    conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, name)(*conv, stream)
    if err != 0:
        msg = lib.mhada_error_string(err).decode()
        raise RuntimeError(f"{name} failed: CUDA error {err} ({msg})")
    LAUNCHES[name] += 1


def check_cuda_inputs(name: str, *tensors: torch.Tensor) -> None:
    """The wrappers' common checks: one CUDA device, one dtype the kernels
    take, contiguous memory."""
    dev, dt = tensors[0].device, tensors[0].dtype
    dtype_code(tensors[0])
    for t in tensors:
        if t.device != dev or not t.is_cuda:
            raise ValueError(f"{name}: all tensors must be on one CUDA device")
        if t.dtype != dt:
            raise TypeError(f"{name}: mixed dtypes {t.dtype} and {dt}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
