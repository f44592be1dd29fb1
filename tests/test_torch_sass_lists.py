"""chip_smoke.py's phase 2 ("tensor cores") checks the SASS of the kernels
it lists: every ``__global__`` kernel of the tensor-core headers
(csrc/*_mma.cuh, and csrc/*wgmma*.cuh for wgmma + TMA) must be in
MMA_KERNELS or WGMMA_KERNELS, and every one of the float32 MHAda tile
(csrc/mhada_f32_tile.cuh), of the float32 flash backward
(csrc/flash_bwd_f32.cuh), of the float32 tail (csrc/decoder_tail_f32.cuh),
of K14's float32 conv (csrc/decoder_mid_f32.cuh) and of K13's
(csrc/decoder_c6_f32.cuh) in F32_KERNELS (no tensor-core instruction, no
spills), so that no kernel skips the check; each listed kernel exists,
each instantiation required of a path is listed, and K13's replaced
kernel is refused and gone.
CPU: reads the sources and chip_smoke.py's constants (it imports torch only
inside main)."""

import importlib.util
import re
from pathlib import Path

import pytest
import torch

# Six test workers share the CPU: cap torch's intra-op threads.
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "mhada_tpu_torch" / "csrc"
KERNEL = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _kernels(pattern):
    return {name: src.name for src in sorted(CSRC.glob(pattern))
            for name in KERNEL.findall(src.read_text())}


@pytest.mark.parametrize("pattern,listed", [("*_mma.cuh", "MMA_KERNELS"),
                                            ("*wgmma*.cuh", "WGMMA_KERNELS"),
                                            ("mhada_f32_tile.cuh",
                                             "F32_KERNELS"),
                                            ("flash_bwd_f32.cuh",
                                             "F32_KERNELS"),
                                            ("decoder_tail_f32.cuh",
                                             "F32_KERNELS"),
                                            ("decoder_mid_f32.cuh",
                                             "F32_KERNELS"),
                                            ("decoder_c6_f32.cuh",
                                             "F32_KERNELS")])
def test_tensor_core_kernels_are_listed(pattern, listed):
    kernels = _kernels(pattern)
    assert kernels, f"no __global__ kernel found in csrc/{pattern}"
    names = getattr(_chip_smoke(), listed)
    missing = {k: f for k, f in kernels.items()
               if not any(n in k for n in names)}
    assert not missing, f"kernels absent from chip_smoke.{listed}: {missing}"


def test_listed_kernels_exist():
    smoke = _chip_smoke()
    every = set(_kernels("*.cuh")) | set(_kernels("*.cu"))
    for name in (*smoke.MMA_KERNELS, *smoke.WGMMA_KERNELS, *smoke.F32_KERNELS):
        assert any(name in k for k in every), name
    # a required instantiation names a listed kernel
    for req in smoke.MMA_REQUIRED:
        assert any(n in req for n in smoke.MMA_KERNELS), req
    for req in smoke.F32_REQUIRED:
        assert any(n in req for n in smoke.F32_KERNELS), req
    # no required instantiation is one that phase 2 refuses as replaced
    for req in (*smoke.MMA_REQUIRED, *smoke.F32_REQUIRED):
        assert not re.search(smoke.OLD_BF16, req), req


def test_replaced_c6_kernel_is_refused():
    """K13's first kernel (decoder_c6_kernel<T>, both dtypes) is refused by
    phase 2 and defined nowhere; its two builds are listed, not refused."""
    smoke = _chip_smoke()
    for mangled in ("_ZN12_GLOBAL__N_117decoder_c6_kernelIfEEvPKT_S3_PKfPS1_ii",
                    "_ZN12_GLOBAL__N_117decoder_c6_kernelI13__nv_bfloat16E"):
        assert re.search(smoke.OLD_BF16, mangled), mangled
    every = set(_kernels("*.cuh")) | set(_kernels("*.cu"))
    assert "decoder_c6_kernel" not in every
    for name in ("decoder_c6_f32_kernel", "decoder_c6_mma_kernel"):
        assert name in every and not re.search(smoke.OLD_BF16, name)
    assert "decoder_c6_f32_kernel" in smoke.F32_REQUIRED
    assert "decoder_c6_mma_kernel" in smoke.MMA_REQUIRED
