"""Build, load and launch the CUDA kernels in ``csrc/``.

The sources are compiled with ``nvcc`` into one shared library with a plain
C interface at first use, and bound with ``ctypes`` (no PyTorch headers, so
the build takes seconds, not minutes): one ``nvcc -c`` per source, all
started together, then one link.  The library lands in ``_build/``
beside this file, named by a hash of the sources and flags, so an edited
source rebuilds and an unchanged one is reused.

``launch`` is the only place a kernel is launched from: it counts the
launch in ``LAUNCHES`` and raises if the C entry point returns a CUDA error.
``check_forward_only`` is the guard of the forward-only wrappers (K1, K3,
K4, K5, K13, K14): their outputs carry no ``grad_fn``.
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
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas",
              "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry point -> argument types (pointers and the stream as c_void_p).
SIGNATURES = {
    "mhada_attention_fwd": [_P] * 3 + [_I] * 5 + [_F, _I, _P],
    "mhada_attention_cross_fwd": [_P] * 4 + [_I] * 8 + [_F, _I, _P],
    "mhada_mhada_fwd": [_P] * 6 + [_I] * 7 + [_P],
    "mhada_mhada_prologue": [_P] * 9 + [_I] * 7 + [_P],
    "mhada_ln_matmul": [_P] * 6 + [_I] * 3 + [_F] + [_I] * 4 + [_P],
    "mhada_decoder_tail": [_P] * 9 + [_I] * 4 + [_P],
    "mhada_attention_train_fwd": [_P] * 4 + [_I] * 5 + [_F, _I, _P],
    "mhada_attention_train_bwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I,
                                  _P],
    "mhada_mhada_train_fwd": [_P] * 9 + [_I] * 7 + [_P],
    "mhada_mhada_train_bwd": [_P] * 10 + [_I] * 6 + [_P],
    "mhada_decoder_tail_res": [_P] * 10 + [_I] * 4 + [_P],
    "mhada_decoder_c6": [_P] * 4 + [_I] * 4 + [_P],
    "mhada_decoder_mid_conv": [_P] * 4 + [_I] * 5 + [_P],
    "mhada_mm_probe": [_P] * 3 + [_I] * 6 + [_P],
    "mhada_mhada_prologue_pipe": [_P] * 9 + [_I] * 7 + [_P],
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


def _run(cmds: list[list[str]]) -> tuple[list, str]:
    """Run the commands concurrently -> (return codes, their joined log)."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    log = "".join(f"$ {' '.join(c)}\n{o}" for c, o in zip(cmds, outs))
    return [p.returncode for p in procs], log


def build() -> Path:
    """Compile csrc/*.cu into the shared library unless it is already built.

    The compiler's output (with ptxas' register and spill report) is kept
    in ``<library>.log``.
    """
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{out.stem}.{os.getpid()}"
    tmp.mkdir(exist_ok=True)
    nvcc = _nvcc()
    srcs = sorted(CSRC.glob("*.cu"))
    objs = [tmp / f"{src.stem}.o" for src in srcs]
    t0 = time.perf_counter()
    rcs, log = _run([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
                     for src, o in zip(srcs, objs)])
    if not any(rcs):
        link_rcs, link_log = _run([[nvcc, *ARCH, "-shared", "-o",
                                    str(tmp / out.name), *map(str, objs)]])
        rcs, log = rcs + link_rcs, log + link_log
    log += f"\n# {time.perf_counter() - t0:.1f} s, exit codes {rcs}\n"
    out.with_suffix(".log").write_text(log)
    if any(rcs):
        shutil.rmtree(tmp, ignore_errors=True)
        errors = "\n".join(ln for ln in log.splitlines() if "error" in ln)
        raise RuntimeError(f"nvcc failed (exit codes {rcs}):\n"
                           f"{errors[:4000]}\n...\n{log[-2000:]}")
    # atomic: a concurrent build never sees a partial .so
    os.replace(tmp / out.name, out)
    shutil.rmtree(tmp, ignore_errors=True)
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


def check_aligned(name: str, *tensors: torch.Tensor,
                  dtypes=(torch.bfloat16,)) -> None:
    """The tensor-core kernels (and the float32 kernels whose wrappers pass
    ``dtypes`` with float32) copy 16 bytes at a time: raise unless each
    CUDA tensor of one of ``dtypes`` starts on a 16-byte boundary (None
    stands for a pointer the kernel does not take)."""
    for t in tensors:
        if t is not None and t.is_cuda and t.dtype in dtypes \
                and t.data_ptr() % 16:
            raise ValueError(f"{name}: {t.dtype} tensors must be 16-byte "
                             f"aligned, got data_ptr {t.data_ptr():#x}")


def check_forward_only(name: str, training_route: str,
                       *tensors: torch.Tensor) -> None:
    """Raise before a forward-only kernel launches on a CUDA tensor while
    grad mode is on and an input requires grad: the kernel's output would
    silently lose its link to the parameters upstream."""
    if torch.is_grad_enabled() and any(
            t.is_cuda and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} is forward-only: its kernel output carries no grad_fn, "
            f"so gradients would be lost; {training_route}")
