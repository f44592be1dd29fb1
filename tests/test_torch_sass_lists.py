"""chip_smoke.py's phase 2 ("tensor cores") checks the SASS of the kernels
it lists: every ``__global__`` kernel of the tensor-core headers
(csrc/*_mma.cuh, and csrc/*wgmma*.cuh for wgmma + TMA) must be in
MMA_KERNELS or WGMMA_KERNELS, and every one of the float32 MHAda tile
(csrc/mhada_f32_tile.cuh), of the float32 flash backward
(csrc/flash_bwd_f32.cuh), of the float32 tail (csrc/decoder_tail_f32.cuh),
of K14's float32 conv (csrc/decoder_mid_f32.cuh), of K13's
(csrc/decoder_c6_f32.cuh) and the combines of K1's split cross form
(csrc/attention_combine.cuh) and of the split MHAda tile of K3, K4 and
K7's forward (csrc/mhada_combine.cuh) in F32_KERNELS (no tensor-core
instruction, no spills), so that no kernel skips the check; each listed
kernel exists, each instantiation required of a path is listed, and K13's,
K1's cross form's, K1's and K6's forward's, K3's, K4's, K7's and the
decoder tail's (K5, K8) replaced kernels are refused and gone.
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
                                             "F32_KERNELS"),
                                            ("attention_combine.cuh",
                                             "F32_KERNELS"),
                                            ("mhada_combine.cuh",
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
    for req in smoke.WGMMA_REQUIRED:
        assert any(n in req for n in smoke.WGMMA_KERNELS), req
    for req in smoke.F32_REQUIRED:
        assert any(n in req for n in smoke.F32_KERNELS), req
    # no required instantiation is one that phase 2 refuses as replaced
    for req in (*smoke.MMA_REQUIRED, *smoke.WGMMA_REQUIRED,
                *smoke.F32_REQUIRED):
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


def test_replaced_cross_kernel_is_refused():
    """K1's cross form on the mma.sync tile (attention_mma_fwd_kernel<false,
    true>) is refused by phase 2 and instantiable nowhere: the mma.sync
    attention forward is gone with its header (K1 and K6's forward moved to
    the wgmma tile too).  Its redesign, the wgmma kernel, is listed and the
    float32 split's instantiation and its combine are required."""
    smoke = _chip_smoke()
    old = ("_ZN5mhada24attention_mma_fwd_kernelILb0ELb1EEEvNS_11"
           "AttnMmaArgsE")
    assert re.search(smoke.OLD_BF16, old)
    assert not (CSRC / "attention_mma.cuh").exists()
    every = set(_kernels("*.cuh")) | set(_kernels("*.cu"))
    assert "attention_mma_fwd_kernel" not in every
    for src in CSRC.glob("*.cu*"):
        assert "kCross" not in src.read_text(), src.name
        assert "make_mma_cross_args" not in src.read_text(), src.name
    assert "attention_wgmma_kernel" in every
    assert "attention_wgmma_kernel" in smoke.WGMMA_KERNELS
    for req in ("attention_f32_kernelILb0ELb0E",
                "attention_f32_kernelILb1ELb0E",
                "attention_f32_kernelILb0ELb1E", "attention_combine_kernelIfE",
                "attention_combine_kernelI13__nv_bfloat16E"):
        assert req in smoke.F32_REQUIRED and not re.search(smoke.OLD_BF16, req)


def test_replaced_attention_forward_is_refused():
    """K1 and K6's forward at bf16 left the mma.sync tile for the wgmma +
    TMA attention tile, and K6's backward left its mma.sync pair
    (attention_mma_dq_kernel, attention_mma_dkv_kernel) for the wgmma + TMA
    pair: every instantiation of attention_mma_fwd_kernel (K1 <false>, K6's
    forward <true>) and of the old pair is refused by phase 2 and no source
    defines or launches them; both C entries launch the self form of the
    tile, whose <split> instantiations are required, and the training
    entry the new pair, whose kernels are listed and required; no
    attention kernel is left on the mma.sync list."""
    smoke = _chip_smoke()
    for old in ("_ZN5mhada24attention_mma_fwd_kernelILb0EEEvNS_11"
                "AttnMmaArgsE",
                "_ZN5mhada24attention_mma_fwd_kernelILb1EEEvNS_11"
                "AttnMmaArgsE"):
        assert re.search(smoke.OLD_BF16, old), old
    for src in CSRC.glob("*.cu*"):
        text = src.read_text()
        assert "launch_attention_mma_fwd" not in text, src.name
        assert "kMmaFwdSmemBytes" not in text, src.name
    for entry in ("attention_fwd.cu", "attention_train.cu"):
        assert "launch_self_attention_wgmma" in (CSRC / entry).read_text()
    assert not any("attention" in k for k in smoke.MMA_KERNELS)
    for old in ("_ZN5mhada24attention_mma_dkv_kernelENS_11AttnMmaArgsE",
                "_ZN5mhada23attention_mma_dq_kernelENS_11AttnMmaArgsE"):
        assert re.search(smoke.OLD_BF16, old), old
    assert not (CSRC / "attention_bwd_mma.cuh").exists()
    every = set(_kernels("*.cuh")) | set(_kernels("*.cu"))
    for src in CSRC.glob("*.cu*"):
        text = src.read_text()
        for gone in ("attention_mma_dkv_kernel", "attention_mma_dq_kernel",
                     "launch_attention_mma_bwd", "load_tile_async"):
            assert gone not in text, (src.name, gone)
    assert "launch_attention_wgmma_bwd" in (
        CSRC / "attention_train.cu").read_text()
    for name in ("attention_wgmma_dq_kernel", "attention_wgmma_dkv_kernel"):
        assert name in every and name in smoke.WGMMA_KERNELS
        assert name in smoke.WGMMA_REQUIRED
        assert not re.search(smoke.OLD_BF16, name)
    mangled = ("_ZN5mhada3xbw25attention_wgmma_dq_kernelE14CUtensorMap_stS1_"
               "S1_S1_NS0_11AttnBwdArgsE")
    assert not re.search(smoke.OLD_BF16, mangled)
    for req in ("flash_bwd_f32_dkv_kernelILb0E",
                "flash_bwd_f32_dq_kernelILb0E"):
        assert req in smoke.F32_REQUIRED
    for req in ("attention_wgmma_kernelILb0E", "attention_wgmma_kernelILb1E"):
        assert req in smoke.WGMMA_REQUIRED
        assert not re.search(smoke.OLD_BF16, req)
    mangled = ("_ZN5mhada3xwg22attention_wgmma_kernelILb0EEEv14CUtensorMap_st"
               "S2_NS0_5XArgsENS_6xsplit8PartialsE")
    assert "attention_wgmma_kernelILb0E" in mangled
    assert not re.search(smoke.OLD_BF16, mangled)


def test_replaced_mhada_instantiations_are_refused():
    """Every instantiation of the mma.sync MHAda tile (mhada_mma_fwd_kernel:
    K3 and K4 <true, false> and <false, false> of its old <kPrologue, kRes>
    template, <false> of its <kRes> template, and K7's forward <true>) is
    refused by phase 2, and its header is gone.  Their redesign, the wgmma
    tile's five <prologue, split, residuals> instantiations (K7's forward
    the unsplit <false, false, true>; split, K4's <false, true, false>), is
    required, and the split's combine (both epilogues, K7's residuals in
    K4's) is a listed float32 kernel."""
    smoke = _chip_smoke()
    for old in ("_ZN5mhada20mhada_mma_fwd_kernelILb1ELb0EEEvNS_12"
                "MhadaMmaArgsE",
                "_ZN5mhada20mhada_mma_fwd_kernelILb0ELb0EEEvNS_12"
                "MhadaMmaArgsE",
                "_ZN5mhada20mhada_mma_fwd_kernelILb0EEEvNS_12MhadaMmaArgsE",
                "_ZN5mhada20mhada_mma_fwd_kernelILb1EEEvNS_12MhadaMmaArgsE"):
        assert re.search(smoke.OLD_BF16, old), old
    assert not (CSRC / "mhada_mma.cuh").exists()
    assert not any("mhada_mma" in k for k in smoke.MMA_KERNELS)
    for entry in ("mhada_prologue.cu", "mhada_fwd.cu", "mhada_train.cu"):
        text = (CSRC / entry).read_text()
        assert "launch_mhada_mma_fwd" not in text
        assert "launch_mhada_wgmma" in text
    assert {r for r in smoke.WGMMA_REQUIRED
            if r.startswith("mhada_wgmma_kernel")} == {
        f"mhada_wgmma_kernelILb{p}ELb{s}ELb{r}E"
        for p, s, r in ((1, 0, 0), (1, 1, 0), (0, 0, 0), (0, 1, 0),
                        (0, 0, 1))}
    mangled = ("_ZN5mhada2wg18mhada_wgmma_kernelILb0ELb0ELb1EEEv14CUtensorMap"
               "_stS2_NS0_6WgArgsENS_6xsplit8PartialsE")
    assert "mhada_wgmma_kernelILb0ELb0ELb1E" in mangled
    assert not re.search(smoke.OLD_BF16, mangled)
    for req in ("mhada_combine_kernelILb1E", "mhada_combine_kernelILb0E"):
        assert req in smoke.F32_REQUIRED
    assert "mhada_combine_kernel" in smoke.F32_KERNELS


def test_replaced_mhada_backward_is_refused():
    """K7's mma.sync backward (mhada_mma_dq_kernel, mhada_mma_dkv_kernel)
    is refused by phase 2 and its header is gone; its bf16 entry launches
    the wgmma + TMA dQ and dK/dV kernels, which phase 2 lists and requires
    and does not refuse; its float32 kernels (the flash backward's <true>)
    stay required."""
    smoke = _chip_smoke()
    for old in ("_ZN5mhada20mhada_mma_dkv_kernelENS_12MhadaBwdArgsE",
                "_ZN5mhada19mhada_mma_dq_kernelENS_12MhadaBwdArgsE"):
        assert re.search(smoke.OLD_BF16, old), old
    assert not (CSRC / "mhada_bwd_mma.cuh").exists()
    every = set(_kernels("*.cuh")) | set(_kernels("*.cu"))
    for name in ("mhada_wgmma_dq_kernel", "mhada_wgmma_dkv_kernel"):
        assert name in every and name in smoke.WGMMA_KERNELS
        assert name in smoke.WGMMA_REQUIRED
        assert not re.search(smoke.OLD_BF16, name)
    text = (CSRC / "mhada_train.cu").read_text()
    assert "launch_mhada_wgmma_bwd" in text
    assert "launch_mhada_mma_bwd" not in text
    for req in ("flash_bwd_f32_dkv_kernelILb1E",
                "flash_bwd_f32_dq_kernelILb1E",
                "mhada_f32_kernelILb0ELi2ELb1E"):
        assert req in smoke.F32_REQUIRED


def test_replaced_tail_kernel_is_refused():
    """K5's and K8's mma.sync tail (decoder_tail_mma_kernel<bool>) is
    refused by phase 2 and its header is gone; the tail's entry launches
    the two wgmma + TMA kernels, which phase 2 lists and requires (both
    instantiations of the second) and does not refuse, and times apart at
    bf16; the float32 tail's kernels stay required; no tail kernel is left
    on the mma.sync lists."""
    smoke = _chip_smoke()
    for old in ("_ZN5mhada4tail23decoder_tail_mma_kernelILb0EEEvNS0_8TailArgsE",
                "_ZN5mhada4tail23decoder_tail_mma_kernelILb1EEEvNS0_8TailArgsE"):
        assert re.search(smoke.OLD_BF16, old), old
    assert not (CSRC / "decoder_tail_mma.cuh").exists()
    assert not any("tail" in k
                   for k in (*smoke.MMA_KERNELS, *smoke.MMA_REQUIRED))
    text = (CSRC / "decoder_tail.cu").read_text()
    assert "launch_decoder_tail_wgmma" in text
    assert "decoder_tail_mma" not in text
    every = set(_kernels("*.cuh")) | set(_kernels("*.cu"))
    assert "decoder_tail_mma_kernel" not in every
    stages = ("tail_up3_wgmma_kernel", "tail_c5c6_wgmma_kernel")
    for name in stages:
        assert name in every and name in smoke.WGMMA_KERNELS
        assert not re.search(smoke.OLD_BF16, name)
    for req in ("tail_up3_wgmma_kernel", "tail_c5c6_wgmma_kernelILb0E",
                "tail_c5c6_wgmma_kernelILb1E"):
        assert req in smoke.WGMMA_REQUIRED
    mangled = ("_ZN5mhada6tailwg22tail_c5c6_wgmma_kernelILb1EEEv14CUtensorMap"
               "_stNS0_8TailArgsE")
    assert "tail_c5c6_wgmma_kernelILb1E" in mangled
    assert not re.search(smoke.OLD_BF16, mangled)
    for req in ("tail_up3_f32_kernel", "tail_c5c6_f32_kernelILb0E",
                "tail_c5c6_f32_kernelILb1E"):
        assert req in smoke.F32_REQUIRED
    assert smoke.TAIL_STAGES["bfloat16"] == stages
